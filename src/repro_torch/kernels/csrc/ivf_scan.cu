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
// each valid row once and spends the rest on a GEMM, on the cluster-major
// schedule of cluster_major.cuh: one CTA per (cluster, 128-row chunk), four
// CTAs an SM, A the queries of a group of probing blocks, B the chunk's rows.
// Here both go through one simt_gemm.cuh ring (masked rows are zero-filled,
// not read; any d streams through it), and warps whose 16-row band holds no
// query skip the FMAs.
#include "cluster_major.cuh"

namespace {

using namespace repro_scan;
using G = Gemm<kGroupRows, 16, 4>;   // 64 x 128 tiles, 128 threads, 4 stages of 16: four CTAs an SM
static_assert(G::THREADS == BN, "one thread per row of a chunk");

template <bool NORM>
__global__ void __launch_bounds__(G::THREADS, 4)
cluster_scan_kernel(const float* __restrict__ queries, const float* __restrict__ store,
                    const float* __restrict__ mask, const int32_t* __restrict__ order,
                    const int32_t* __restrict__ starts, float* __restrict__ out,
                    int bq, int kc, int L, int d, int slots, int nchunks) {
  extern __shared__ __align__(16) float smem[];
  const float** rows = reinterpret_cast<const float**>(smem + G::RING_FLOATS);   // [ROWS]
  Book& bk = *reinterpret_cast<Book*>(rows + G::ROWS);

  const int tid = threadIdx.x;                       // THREADS == BN: one chunk row each
  const int p = blockIdx.x / nchunks;
  const int l0 = (blockIdx.x % nchunks) * BN;
  const int start = __ldg(starts + p), end = __ldg(starts + p + 1);
  if (start == end) return;                          // nobody probed this cluster
  const int nrows = min(BN, L - l0);

  const float m = load_row<false>(bk, mask, nullptr, p, kc, L, l0, nrows);
  rows[G::BM + tid] = m > 0.f ? store + (static_cast<long long>(p) * L + l0 + tid) * d
                              : nullptr;
  if (!__syncthreads_or(m > 0.f)) {
    masked_strips(bk, order, start, end, out, bq, slots, L, l0, nrows);
    return;
  }

  const G g;
  const int kt = (d + G::BK - 1) / G::BK;
  auto row_ptr = [&](int r) -> const float* { return rows[r]; };

  for (int cursor = start; cursor < end;) {
    // 1. the next group: up to 64 / bq distinct probing blocks
    const int nq = next_group(bk, order, cursor, end, slots, bq);
    if (tid < G::BM)
      rows[tid] = tid < nq
                      ? queries + (static_cast<long long>(bk.blk[tid / bq]) * bq + tid % bq) * d
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
      if (tid < G::BM) bk.inv[tid] = inv_norm(ss);
      __syncthreads();
    }

    // 3. each group row's strip, to every slot its block probed from
    write_strips<NORM, false>(g, bk, acc, nq, bq, out, slots, L, l0, nrows);
    cursor += bk.used;
    __syncthreads();   // the ring, rows and the group are reused next
  }
}

template <bool NORM>
cudaError_t launch(const float* q, const float* store, const float* mask,
                   const int32_t* order, const int32_t* starts, float* out, int bq, int kc,
                   int L, int d, int slots, unsigned grid, int nchunks, int device,
                   cudaStream_t stream) {
  auto kern = cluster_scan_kernel<NORM>;
  const size_t smem = G::RING_FLOATS * sizeof(float) + G::ROWS * sizeof(float*) + sizeof(Book);
  static int resident[64] = {0};      // per device
  const cudaError_t e = prepare(kern, G::THREADS, smem, device, resident[device & 63]);
  if (e != cudaSuccess) return e;
  kern<<<grid, G::THREADS, smem, stream>>>(q, store, mask, order, starts, out, bq, kc, L, d,
                                           slots, nchunks);
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
  unsigned grid = 0;
  int nchunks = 0;
  e = plan_grid(nb, bq, kc, L, d, slots, &grid, &nchunks);
  if (e != cudaSuccess || grid == 0) return e;
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
                                  args[4], grid, nchunks, device, s)
                   : launch<false>(qf, st, mk, od, sp, o, args[0], args[1], args[2], args[3],
                                   args[4], grid, nchunks, device, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
