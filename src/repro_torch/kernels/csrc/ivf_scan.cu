// IVF probed-cluster scan over fp32 tiles, scheduled by cluster.
//
// out[b*bq + i, s*L + l] = mask[p, l] > 0 ? <q[b*bq + i], store[p, l]> : MASKED_SCORE,
//                          p = probe_blocks[b, s]  (a p outside [0, kc): the whole strip masked)
//
// Replaces the TPU kernel src/repro/kernels/ivf_scan.py::cluster_scan (body
// _scan_kernel): grid (query block, probe slot), the probed cluster's tile
// gathered by a scalar-prefetched BlockSpec index map, an MXU dot of the
// 8-row query block against the [L, d] tile, padding lanes set to -1e30.
//
// What bounds it on an H100: the work the data asks for.  A (block, slot)
// grid streams every probed [L, d] tile once per prober, padding included:
// at the main path's shape (32 blocks x 64 slots over 256 tiles of 7040 x
// 384) that is 22 GB, ~8 reads of each tile.  Read once, the valid rows of
// the probed clusters are ~1.5 GB and the [256, 64*7040] plane 0.46 GB;
// their dot products, 2*d per (query, valid row) pair, are ~49 GFLOP of
// IEEE fp32, which at the SIMT rate outlasts the bytes.  So the design reads
// each valid row once and spends the rest on a GEMM:
//
// * The wrapper inverts probe_blocks on the device (kernels/ivf_scan.py,
//   probe_lists): `order` lists the (block, slot) pairs by cluster, stably
//   (so by block within a cluster), `starts[p]..starts[p+1]` is cluster p's
//   range, and bucket kc holds the ids outside [0, kc).
// * One CTA of 128 threads per (cluster, 128-row chunk of L), clusters
//   kc + 1 deep, four CTAs an SM.  A CTA whose cluster nobody probed exits;
//   one whose chunk the mask leaves empty (padding) or whose bucket is kc
//   writes MASKED_SCORE strips without reading the tile.
// * Otherwise the chunk's rows are B of a simt_gemm.cuh GEMM (masked rows
//   are zero-filled, not read; any d streams through the ring) and A is the
//   queries of up to 64 / bq distinct probing blocks at a time: a block
//   that probed the cluster from several slots is scored once and its strip
//   written to each slot.  Warps whose 16-row band holds no query skip the
//   FMAs.  Later groups of a heavily probed cluster re-read the chunk from
//   L2.
// * The epilogue writes each prober's [bq, 128] strip with 16-byte
//   streaming stores when L % 4 == 0, applying the mask lane by lane.
// Each score is one thread's ascending-k fp32 sum: no atomics, and a
// prober's scores do not depend on its group, so two calls give the same
// bits.
#include "simt_gemm.cuh"

namespace {

using namespace repro_gemm;
using G = Gemm<64, 16, 4>;   // 64 x 128 tiles, 128 threads, 4 stages of 16: four CTAs an SM

constexpr float kMaskedScore = -1e30f;
constexpr int kWindow = G::THREADS;   // prober ids staged per group formation
static_assert(G::THREADS == BN, "one thread per row of a chunk");

template <bool NORM>
__global__ void __launch_bounds__(G::THREADS, 4)
cluster_scan_kernel(const float* __restrict__ queries, const float* __restrict__ store,
                    const float* __restrict__ mask, const int32_t* __restrict__ order,
                    const int32_t* __restrict__ starts, float* __restrict__ out,
                    int bq, int kc, int L, int d, int slots, int nchunks) {
  extern __shared__ __align__(16) float smem[];
  float* sinv = smem + G::RING_FLOATS;               // [BM] 1/|q| of the group's rows
  float* smask = sinv + G::BM;                       // [BN] mask of the chunk's rows
  const float** rows = reinterpret_cast<const float**>(smask + BN);   // [ROWS]
  int* swin = reinterpret_cast<int*>(rows + G::ROWS);   // [kWindow] prober ids
  int* gb = swin + kWindow;                          // [BM] block of each group entry
  int* gfirst = gb + G::BM;                          // [BM + 1] its first prober
  int* gmeta = gfirst + G::BM + 1;                   // [2] entries, next prober

  const int tid = threadIdx.x;                       // THREADS == BN: one chunk row each
  const int p = blockIdx.x / nchunks;
  const int l0 = (blockIdx.x % nchunks) * BN;
  const int start = __ldg(starts + p), end = __ldg(starts + p + 1);
  if (start == end) return;                          // nobody probed this cluster
  const int nrows = min(BN, L - l0);
  const long long ld = static_cast<long long>(slots) * L;
  const bool vec_out = (L & 3) == 0;

  const float m = p < kc && tid < nrows ? __ldg(mask + static_cast<long long>(p) * L + l0 + tid)
                                        : 0.f;
  smask[tid] = m;
  rows[G::BM + tid] = m > 0.f ? store + (static_cast<long long>(p) * L + l0 + tid) * d
                              : nullptr;
  if (!__syncthreads_or(m > 0.f)) {
    // padding, or ids outside the store: every prober's strip is masked
    const int per = bq * nrows;
    for (int w0 = start; w0 < end; w0 += kWindow) {
      const int wn = min(kWindow, end - w0);
      if (tid < wn) swin[tid] = __ldg(order + w0 + tid);
      __syncthreads();
      for (int w = 0; w < wn; ++w) {
        const int b = swin[w] / slots, s = swin[w] % slots;
        float* dst = out + static_cast<long long>(b) * bq * ld + static_cast<long long>(s) * L + l0;
        if (vec_out) {
          const float4 m4 = make_float4(kMaskedScore, kMaskedScore, kMaskedScore, kMaskedScore);
          for (int t = tid; t < per / 4; t += G::THREADS)
            __stcs(reinterpret_cast<float4*>(dst + (4 * t / nrows) * ld + 4 * t % nrows), m4);
        } else {
          for (int t = tid; t < per; t += G::THREADS)
            __stcs(dst + (t / nrows) * ld + t % nrows, kMaskedScore);
        }
      }
      __syncthreads();
    }
    return;
  }

  const G g;
  const int kt = (d + G::BK - 1) / G::BK;
  const int max_blocks = G::BM / bq;
  auto row_ptr = [&](int r) -> const float* { return rows[r]; };

  for (int cursor = start; cursor < end;) {
    // 1. the next group: up to max_blocks distinct probing blocks
    const int wn = min(kWindow, end - cursor);
    if (tid < wn) swin[tid] = __ldg(order + cursor + tid);
    __syncthreads();
    if (tid == 0) {
      int n = 0, last = -1, w = 0;
      for (; w < wn; ++w) {
        const int b = swin[w] / slots;
        if (b != last) {
          if (n == max_blocks) break;
          gb[n] = b;
          gfirst[n++] = w;
          last = b;
        }
      }
      gfirst[n] = w;
      gmeta[0] = n;
      gmeta[1] = w;
    }
    __syncthreads();
    const int nq = gmeta[0] * bq;                    // live A rows
    if (tid < G::BM)
      rows[tid] = tid < nq ? queries + (static_cast<long long>(gb[tid / bq]) * bq + tid % bq) * d
                           : nullptr;
    __syncthreads();

    // 2. the GEMM over d through the ring
    const bool band_live = g.band0 < nq;
    float acc[TM][TN];
    G::zero(acc);
    float ss = 0.f;
    int loaded = 0;
    for (; loaded < G::STAGES - 1; ++loaded) {
      if (loaded < kt)
        G::load_stage(smem + loaded * G::STAGE_FLOATS, row_ptr, loaded * G::BK, d, queries);
      cp_async_commit();
    }
    for (int k = 0; k < kt; ++k) {
      cp_async_wait<G::STAGES - 2>();
      __syncthreads();             // this chunk landed; the previous stage is free
      if (loaded < kt)
        G::load_stage(smem + (loaded % G::STAGES) * G::STAGE_FLOATS, row_ptr, loaded * G::BK, d,
                      queries);
      cp_async_commit();
      ++loaded;
      const float* st = smem + (k % G::STAGES) * G::STAGE_FLOATS;
      if (NORM && tid < G::BM) ss = G::row_sumsq(st, tid, ss);
      if (band_live) g.mma_stage(st, acc);
    }
    cp_async_wait<0>();
    if (NORM) {
      if (tid < G::BM) sinv[tid] = inv_norm(ss);
      __syncthreads();
    }

    // 3. each group row's strip, to every slot its block probed from
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = g.arow0 + i;
      if (r >= nq) continue;
      const int j = r / bq;
      const float iq = NORM ? sinv[r] : 1.f;
      const long long orow = (static_cast<long long>(gb[j]) * bq + r % bq) * ld + l0;
      float v[TN];
#pragma unroll
      for (int e = 0; e < TN; ++e) {
        const int l = g.col(e);
        v[e] = l < nrows && smask[l] > 0.f ? acc[i][e] * iq : kMaskedScore;
      }
      for (int w = gfirst[j]; w < gfirst[j + 1]; ++w) {
        float* dst = out + orow + static_cast<long long>(swin[w] % slots) * L;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int l = g.col(4 * jj);
          if (vec_out) {
            if (l < nrows)
              __stcs(reinterpret_cast<float4*>(dst + l),
                     make_float4(v[4 * jj], v[4 * jj + 1], v[4 * jj + 2], v[4 * jj + 3]));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (l + e < nrows) __stcs(dst + l + e, v[4 * jj + e]);
          }
        }
      }
    }
    cursor += gmeta[1];
    __syncthreads();   // the ring, rows, swin and the group are reused next
  }
}

template <bool NORM>
cudaError_t launch(const float* q, const float* store, const float* mask,
                   const int32_t* order, const int32_t* starts, float* out, int bq, int kc,
                   int L, int d, int slots, int device, cudaStream_t stream) {
  auto kern = cluster_scan_kernel<NORM>;
  const size_t smem = (G::RING_FLOATS + G::BM + BN) * sizeof(float) +
                      G::ROWS * sizeof(float*) + (kWindow + 2 * G::BM + 3) * sizeof(int);
  static int resident[64] = {0};      // per device
  const cudaError_t e = prepare(kern, G::THREADS, smem, device, resident[device & 63]);
  if (e != cudaSuccess) return e;
  const int nchunks = (L + BN - 1) / BN;
  const long long grid = static_cast<long long>(kc + 1) * nchunks;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<static_cast<unsigned>(grid), G::THREADS, smem, stream>>>(
      q, store, mask, order, starts, out, bq, kc, L, d, slots, nchunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// queries [nb*bq, d] f32, store [kc, L, d] f32, mask [kc, L] f32,
// order [nb*slots] int32 and starts [kc+2] int32 (the probe lists of
// probe_blocks [nb, slots], kernels/ivf_scan.py), out [nb*bq, slots*L] f32;
// all contiguous on `device`, launched on `stream`.  Returns the CUDA error
// code (0 = ok).
int repro_cluster_scan(const void* queries, const void* store, const void* mask,
                       const void* order, const void* starts, void* out, long long nb,
                       int bq, long long kc, long long L, long long d, long long slots,
                       int normalize, int device, void* stream) {
  cudaGetLastError();  // clear a stale error so the code returned is this launch's
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (nb <= 0 || slots <= 0 || L <= 0) return cudaSuccess;
  if (bq <= 0 || bq > G::BM || G::BM % bq != 0 || d <= 0 || d > 0x7fffffffLL ||
      kc >= 0x7fffffffLL || L > 0x7fffffffLL || nb * slots > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(queries);
  const auto* st = static_cast<const float*>(store);
  const auto* mk = static_cast<const float*>(mask);
  const auto* od = static_cast<const int32_t*>(order);
  const auto* sp = static_cast<const int32_t*>(starts);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int args[5] = {bq, static_cast<int>(kc), static_cast<int>(L), static_cast<int>(d),
                       static_cast<int>(slots)};
  return normalize ? launch<true>(qf, st, mk, od, sp, o, args[0], args[1], args[2], args[3],
                                  args[4], device, s)
                   : launch<false>(qf, st, mk, od, sp, o, args[0], args[1], args[2], args[3],
                                   args[4], device, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
