// IVF probed-cluster scan over int8 tiles with per-vector scales, scheduled
// by cluster.
//
// out[b*bq + i, s*L + l] = mask[p, l] > 0 ? <q[b*bq + i], float(store_q[p, l])> * scales[p, l]
//                                         : MASKED_SCORE,   p = probe_blocks[b, s]
// (a p outside [0, kc): the whole strip masked)
//
// Replaces the TPU kernel src/repro/kernels/ivf_scan_q.py::cluster_scan_q
// (body _scan_kernel_q): the cluster_scan grid over symmetric per-vector int8
// tiles; the tile is upcast for the dot and the score multiplied by the
// vector's f32 scale afterwards (the scale factors out of the dot product).
//
// What bounds it on an H100: the fp32 operations.  Each valid row of the
// probed clusters read once is d + 4 bytes of row and scale (~0.4 GB at the
// main path's shape) and the [256, 64*7040] plane 0.46 GB, but the dot
// products are the fp32 scan's, ~49 GFLOP of IEEE fp32 SIMT: no query is
// quantized, and neither dp4a, IMMA nor TF32 would keep the top-k ids of
// the plain version.  So it runs the fp32 scan's cluster-major schedule
// (cluster_major.cuh: one CTA per (cluster, 128-row chunk), four CTAs an
// SM, A the queries of a group of probing blocks, B the chunk's rows, each
// valid row read once per group) and its simt_gemm.cuh micro-tiles, and
// stages the int8 rows so that they cost fewer instructions than fp32 rows:
//
// * A (the group's query rows, fp32, 16-byte aligned: the wrapper pads a
//   row to a multiple of 4 floats where the caller's rows are not aligned)
//   lands m-major in a ring of 16-byte copies, 2 a thread a stage instead
//   of the fp32 scan's 8 transposing 4-byte copies; 16-byte chunks are
//   XOR-swizzled by row so the transposing reads below do not conflict.
// * B: a 16-k stage of a chunk is 16 contiguous bytes of each row.  Thread
//   t copies row t's 16 bytes with one 16-byte cp.async (128 copies a stage,
//   against the fp32 scan's 2048) into a landing ring, or with four 4-byte
//   copies when d % 16 != 0 or the store is not 16-byte aligned, or reads
//   them byte by byte when d % 4 != 0 or it is not 4-byte aligned (three
//   instantiations, chosen on the host).  Masked rows and bytes past d are
//   zero-filled, not read.
// * One conversion pass a stage, one stage ahead of the FMAs: thread t turns
//   its row's 16 bytes into fp32 (exact for every int8) and writes them into
//   column t of a k-major [16][128] region, double-buffered, so consecutive
//   threads write consecutive floats; each value is converted once and not
//   in the FMA loop, where it would be converted for each of the 8 threads
//   whose micro-tiles read it.  The same pass transposes A's landed chunks
//   into a k-major [16][64] region.  One barrier a stage, as in the fp32
//   scan.
// * The epilogue multiplies each finished dot product by its row's scale.
#include "cluster_major.cuh"

namespace {

using namespace repro_scan;
constexpr int kStages = 4;                          // landing ring depth (A and B)
using G = Gemm<kGroupRows, 16, kStages>;           // 64 x 128 tiles, 128 threads
static_assert(G::THREADS == BN && G::BK == 16, "one thread per chunk row, 16 bytes a stage");
constexpr int A_LAND = G::BM * G::BK;               // floats of an A landing stage, m-major
constexpr int A_STAGE = G::BK * G::BM;              // floats of a converted A stage
constexpr int B_LAND = BN * G::BK / 4;              // floats of a B landing stage: 16 B a row
constexpr int B_STAGE = G::BK * BN;                 // floats of a converted B stage
constexpr size_t kSmem =
    (kStages * (A_LAND + B_LAND) + 2 * (A_STAGE + B_STAGE)) * sizeof(float) +
    (G::BM + BN) * sizeof(void*) + sizeof(Book);
static_assert(kSmem <= 56 * 1024, "four CTAs an SM");

enum BPath { kCopy16, kCopy4, kBytes };   // how B's bytes reach shared memory

template <bool NORM, int BPATH>
__global__ void __launch_bounds__(G::THREADS, 4)
cluster_scan_q_kernel(const float* __restrict__ queries, const int8_t* __restrict__ store,
                      const float* __restrict__ scales, const float* __restrict__ mask,
                      const int32_t* __restrict__ order, const int32_t* __restrict__ starts,
                      float* __restrict__ out, int bq, int kc, int L, int d, int lda,
                      int slots, int nchunks) {
  extern __shared__ __align__(16) float smem[];
  float* aland = smem;                                  // [kStages][BM][BK], swizzled
  float* bland = aland + kStages * A_LAND;              // [kStages][BN][16 B]
  float* aconv = bland + kStages * B_LAND;              // [2][BK][BM]
  float* bconv = aconv + 2 * A_STAGE;                   // [2][BK][BN]
  const float** arows = reinterpret_cast<const float**>(bconv + 2 * B_STAGE);   // [BM]
  const int8_t** brows = reinterpret_cast<const int8_t**>(arows + G::BM);      // [BN]
  Book& bk = *reinterpret_cast<Book*>(brows + BN);

  const int tid = threadIdx.x;                       // THREADS == BN: one chunk row each
  const int p = blockIdx.x / nchunks;
  const int l0 = (blockIdx.x % nchunks) * BN;
  const int start = __ldg(starts + p), end = __ldg(starts + p + 1);
  if (start == end) return;                          // nobody probed this cluster
  const int nrows = min(BN, L - l0);

  const float m = load_row<true>(bk, mask, scales, p, kc, L, l0, nrows);
  const int8_t* brow = m > 0.f ? store + (static_cast<long long>(p) * L + l0 + tid) * d
                               : nullptr;
  brows[tid] = brow;
  if (!__syncthreads_or(m > 0.f)) {
    masked_strips(bk, order, start, end, out, bq, slots, L, l0, nrows);
    return;
  }

  const G g;
  const int kt = (d + G::BK - 1) / G::BK;
  // the float offset of 16-byte chunk c of A's row r in a landing stage
  auto a_at = [](int r, int c) { return 16 * r + 4 * (c ^ ((r >> 1) & 3)); };

  // stage s's copies: A's and B's rows into the landing rings
  auto issue = [&](int s) {
    const int k0 = s * G::BK;
    float* as = aland + (s % kStages) * A_LAND;
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // a warp copies 8 rows x 64 bytes an instruction
      const int r = 32 * i + (tid >> 2), c = tid & 3;
      const float* src = arows[r];
      const bool ok = src != nullptr && k0 + 4 * c < lda;
      cp_async16(as + a_at(r, c), ok ? src + k0 + 4 * c : queries, ok);
    }
    int8_t* ls = reinterpret_cast<int8_t*>(bland + (s % kStages) * B_LAND);
    if (BPATH == kCopy16) {
      cp_async16(ls + 16 * tid, brow != nullptr ? brow + k0 : store, brow != nullptr);
    } else if (BPATH == kCopy4) {
      // a warp copies 8 rows x 16 bytes an instruction
      const int warp = tid >> 5, lane = tid & 31, w = 4 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 32 * warp + 8 * i + (lane >> 2);
        const int8_t* src = brows[r];
        const bool ok = src != nullptr && k0 + w < d;
        cp_async4(ls + 16 * r + w, ok ? src + k0 + w : store, ok);
      }
    }
  };
  // stage s into its k-major buffers: A's chunks transposed, and the bytes
  // of row tid, as fp32, into column tid of B's
  auto convert = [&](int s) {
    const float* as = aland + (s % kStages) * A_LAND;
    float* da = aconv + (s & 1) * A_STAGE + (tid & 63);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {   // thread t: row t % 64, chunks 2 (t / 64) + cc
      const int c = 2 * (tid >> 6) + cc;
      const float4 v = *reinterpret_cast<const float4*>(as + a_at(tid & 63, c));
      da[(4 * c) * G::BM] = v.x;
      da[(4 * c + 1) * G::BM] = v.y;
      da[(4 * c + 2) * G::BM] = v.z;
      da[(4 * c + 3) * G::BM] = v.w;
    }
    float* dst = bconv + (s & 1) * B_STAGE + tid;
    if (BPATH == kBytes) {
      const int k0 = s * G::BK;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const bool ok = brow != nullptr && k0 + j < d;
        dst[j * BN] = ok ? static_cast<float>(__ldg(brow + k0 + j)) : 0.f;
      }
    } else {
      const int4 v = *reinterpret_cast<const int4*>(bland + (s % kStages) * B_LAND + 4 * tid);
      const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j * BN] = static_cast<float>(static_cast<int8_t>(w[j >> 2] >> (8 * (j & 3))));
    }
  };

  for (int cursor = start; cursor < end;) {
    // 1. the next group: up to 64 / bq distinct probing blocks
    const int nq = next_group(bk, order, cursor, end, slots, bq);
    if (tid < G::BM)
      arows[tid] = tid < nq
                       ? queries + (static_cast<long long>(bk.blk[tid / bq]) * bq + tid % bq) * lda
                       : nullptr;
    __syncthreads();

    // 2. the GEMM over d: copies kStages - 1 stages ahead, conversion one
    const bool band_live = g.band0 < nq;
    float acc[TM][TN];
    G::zero(acc);
    float ss = 0.f;
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < kt) issue(s);
      cp_async_commit();
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();               // stage 0 landed
    convert(0);
    for (int k = 0; k < kt; ++k) {
      cp_async_wait<kStages - 3>();
      __syncthreads();             // stage k + 1 landed, stage k converted, stage k - 1 read
      if (k + kStages - 1 < kt) issue(k + kStages - 1);
      cp_async_commit();
      if (k + 1 < kt) convert(k + 1);
      const float* sa = aconv + (k & 1) * A_STAGE;
      if (NORM && tid < G::BM) ss = G::template row_sumsq<G::BM>(sa, tid, ss);
      if (band_live) g.template mma_stage<G::BM, BN>(sa, bconv + (k & 1) * B_STAGE, acc);
    }
    cp_async_wait<0>();
    if (NORM) {
      if (tid < G::BM) bk.inv[tid] = inv_norm(ss);
      __syncthreads();
    }

    // 3. each group row's strip, scaled, to every slot its block probed from
    write_strips<NORM, true>(g, bk, acc, nq, bq, out, slots, L, l0, nrows);
    cursor += bk.used;
    __syncthreads();   // the rings, rows and the group are reused next
  }
}

template <bool NORM, int BPATH>
cudaError_t launch(const float* q, const int8_t* store, const float* scales, const float* mask,
                   const int32_t* order, const int32_t* starts, float* out, int bq, int kc,
                   int L, int d, int lda, int slots, unsigned grid, int nchunks, int device,
                   cudaStream_t stream) {
  auto kern = cluster_scan_q_kernel<NORM, BPATH>;
  static int resident[64] = {0};      // per device
  const cudaError_t e = prepare(kern, G::THREADS, kSmem, device, resident[device & 63]);
  if (e != cudaSuccess) return e;
  kern<<<grid, G::THREADS, kSmem, stream>>>(q, store, scales, mask, order, starts, out, bq, kc,
                                            L, d, lda, slots, nchunks);
  return cudaGetLastError();
}

template <bool NORM>
cudaError_t launch_path(int path, const float* q, const int8_t* store, const float* scales,
                        const float* mask, const int32_t* order, const int32_t* starts,
                        float* out, int bq, int kc, int L, int d, int lda, int slots,
                        unsigned grid, int nchunks, int device, cudaStream_t stream) {
  switch (path) {
    case kCopy16:
      return launch<NORM, kCopy16>(q, store, scales, mask, order, starts, out, bq, kc, L, d,
                                   lda, slots, grid, nchunks, device, stream);
    case kCopy4:
      return launch<NORM, kCopy4>(q, store, scales, mask, order, starts, out, bq, kc, L, d,
                                  lda, slots, grid, nchunks, device, stream);
    default:
      return launch<NORM, kBytes>(q, store, scales, mask, order, starts, out, bq, kc, L, d,
                                  lda, slots, grid, nchunks, device, stream);
  }
}

}  // namespace

extern "C" {

// queries [nb*bq, lda] f32 (row k's first d values; lda >= d a multiple of
// 4, 16-byte aligned), store_q [kc, L, d] int8, scales [kc, L] f32,
// mask [kc, L] f32, order [nb*slots] int32 and starts [kc+2] int32 (the
// probe lists of probe_blocks [nb, slots], kernels/ivf_scan.py),
// out [nb*bq, slots*L] f32; all contiguous on `device`, launched on
// `stream`.  Returns the CUDA error code (0 = ok).
int repro_cluster_scan_q(const void* queries, const void* store_q, const void* scales,
                         const void* mask, const void* order, const void* starts, void* out,
                         long long nb, int bq, long long kc, long long L, long long d,
                         long long lda, long long slots, int normalize, int device,
                         void* stream) {
  cudaGetLastError();  // clear a stale error so the code returned is this launch's
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  unsigned grid = 0;
  int nchunks = 0;
  e = plan_grid(nb, bq, kc, L, d, slots, &grid, &nchunks);
  if (e != cudaSuccess || grid == 0) return e;
  if (lda < d || lda % 4 != 0 || lda > 0x7fffffffLL || reinterpret_cast<uintptr_t>(queries) % 16)
    return cudaErrorInvalidValue;
  const auto base = reinterpret_cast<uintptr_t>(store_q);
  const int path = d % 16 == 0 && base % 16 == 0 ? kCopy16
                   : d % 4 == 0 && base % 4 == 0 ? kCopy4 : kBytes;
  const auto* qf = static_cast<const float*>(queries);
  const auto* st = static_cast<const int8_t*>(store_q);
  const auto* sc = static_cast<const float*>(scales);
  const auto* mk = static_cast<const float*>(mask);
  const auto* od = static_cast<const int32_t*>(order);
  const auto* sp = static_cast<const int32_t*>(starts);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int args[6] = {bq, static_cast<int>(kc), static_cast<int>(L), static_cast<int>(d),
                       static_cast<int>(lda), static_cast<int>(slots)};
  return normalize
             ? launch_path<true>(path, qf, st, sc, mk, od, sp, o, args[0], args[1], args[2],
                                 args[3], args[4], args[5], grid, nchunks, device, s)
             : launch_path<false>(path, qf, st, sc, mk, od, sp, o, args[0], args[1], args[2],
                                  args[3], args[4], args[5], grid, nchunks, device, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
