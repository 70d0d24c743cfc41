// Fused L2-normalize + inner-product scores: out[i, j] = <q_i, c_j> / (|q_i| |c_j|).
//
// Replaces the TPU kernel src/repro/kernels/similarity.py::similarity (body
// _kernel): one Pallas grid step per 256x256 output tile with the whole
// feature dim d in VMEM, rows scaled by rsqrt(max(sum x^2, 1e-18)) before an
// MXU dot.
//
// What bounds it on an H100: it is a GEMM.  At the main path's shape (256
// queries x 1M corpus rows x d=384) it does 2*nq*nc*d = 197 GFLOP on
// 4*d*(nq+nc) + 4*nq*nc = 2.6 GB, ~77 FLOP/B, far above the fp32 ridge
// point, so it is bound by fp32 operations.  The contract is IEEE fp32
// (top-k ids must match the reference), which rules out TF32 tensor cores;
// this kernel is a SIMT fp32 GEMM and its ceiling is the non-tensor fp32 rate.
//
// Design (the core is simt_gemm.cuh: 128x128 tiles, 8x8 micro-tiles, a
// 3-stage cp.async ring of 32-value chunks of d staged k-major; a search of
// at most 64 queries takes 64-row tiles, so it does half the wasted work):
// * persistent: one CTA per resident slot (two an SM; four of the narrow
//   tiles), each walking tiles t = blockIdx.x, + gridDim.x, ... with the
//   query-tile index fastest, so the query tiles of one corpus tile run
//   side by side and the corpus streams from device memory once; the ring
//   runs on across tiles, so the next tile's first chunks load while this
//   tile's last ones multiply;
// * the normalization costs no pass over memory: the threads sum the
//   squares of the staged rows (query rows and corpus rows) as their chunks
//   pass through the ring, and the tile's accumulators are scaled once by
//   rsqrt(max(sum q^2,1e-18)) * rsqrt(max(sum c^2,1e-18));
// * the 1 GB score plane is written with 16-byte streaming stores where
//   nc % 4 == 0, masked scalar stores otherwise; ragged nq, nc and d are
//   zero-filled on load, and the 4-byte copies take any d and alignment.
#include "simt_gemm.cuh"

namespace {

using namespace repro_gemm;
using Wide = Gemm<128, 32, 3>;   // 128 x 128 tiles, 256 threads, two CTAs an SM
using Narrow = Gemm<64, 16, 4>;  // nq <= 64 (a search): 64 x 128 tiles, 128 threads, four

template <class G, bool NORM>
__global__ void __launch_bounds__(G::THREADS, G::THREADS == 256 ? 2 : 4)
similarity_kernel(const float* __restrict__ q, const float* __restrict__ c,
                  float* __restrict__ out, int nq, int nc, int d, int mtiles,
                  long long tiles) {
  extern __shared__ __align__(16) float smem[];
  float* sinv = smem + G::RING_FLOATS;         // [ROWS] 1/|row| of the tile's rows

  const int tid = threadIdx.x;
  const G g;
  const int kt = (d + G::BK - 1) / G::BK;
  const bool vec_out = (nc & 3) == 0;

  // the load side of the ring runs STAGES - 1 chunks ahead: (tile, k step)
  long long ld_tile = blockIdx.x;
  int ld_k = 0, ld_stage = 0;
  auto load_next = [&]() {
    if (ld_tile < tiles) {
      const int m0 = static_cast<int>(ld_tile % mtiles) * G::BM;
      const long long n0 = (ld_tile / mtiles) * BN;
      G::load_stage(smem + ld_stage * G::STAGE_FLOATS, [&](int r) -> const float* {
        if (r < G::BM) return m0 + r < nq ? q + static_cast<long long>(m0 + r) * d : nullptr;
        const long long n = n0 + r - G::BM;
        return n < nc ? c + n * d : nullptr;
      }, ld_k * G::BK, d, q);
      ld_stage = ld_stage + 1 == G::STAGES ? 0 : ld_stage + 1;
      if (++ld_k == kt) {
        ld_k = 0;
        ld_tile += gridDim.x;
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < G::STAGES - 1; ++s) load_next();

  int stage = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[TM][TN];
    G::zero(acc);
    constexpr int kRowsEach = (G::ROWS + G::THREADS - 1) / G::THREADS;
    float ss[kRowsEach] = {};    // sums of squares of stage rows tid + THREADS h
    for (int k = 0; k < kt; ++k) {
      cp_async_wait<G::STAGES - 2>();
      __syncthreads();           // this chunk landed; the previous stage is free
      load_next();
      const float* st = smem + stage * G::STAGE_FLOATS;
      if (NORM) {
#pragma unroll
        for (int h = 0; h < kRowsEach; ++h)
          if (G::ROWS % G::THREADS == 0 || tid + G::THREADS * h < G::ROWS)
            ss[h] = G::row_sumsq(st, tid + G::THREADS * h, ss[h]);
      }
      g.mma_stage(st, acc);
      stage = stage + 1 == G::STAGES ? 0 : stage + 1;
    }

    // the tile is complete: scale and store it
    if (NORM) {
#pragma unroll
      for (int h = 0; h < kRowsEach; ++h)
        if (G::ROWS % G::THREADS == 0 || tid + G::THREADS * h < G::ROWS)
          sinv[tid + G::THREADS * h] = inv_norm(ss[h]);
      __syncthreads();
    }
    const int m0 = static_cast<int>(tile % mtiles) * G::BM;
    const long long n0 = (tile / mtiles) * BN;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + g.arow0 + i;
      if (row >= nq) continue;
      const float iq = NORM ? sinv[g.arow0 + i] : 1.f;
      float* orow = out + static_cast<long long>(row) * nc;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int cl = g.col(4 * jj);
        const long long col = n0 + cl;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = acc[i][4 * jj + e] * (NORM ? iq * sinv[G::BM + cl + e] : 1.f);
        if (vec_out && col + 3 < nc) {
          __stcs(reinterpret_cast<float4*>(orow + col), make_float4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < nc) __stcs(orow + col + e, v[e]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <class G, bool NORM>
cudaError_t launch(const float* q, const float* c, float* out, int nq, int nc, int d,
                   int device, cudaStream_t stream) {
  auto kern = similarity_kernel<G, NORM>;
  const size_t smem = (G::RING_FLOATS + G::ROWS) * sizeof(float);
  static int resident[64] = {0};      // per device
  int& cap = resident[device & 63];
  const cudaError_t e = prepare(kern, G::THREADS, smem, device, cap);
  if (e != cudaSuccess) return e;
  const int mtiles = (nq + G::BM - 1) / G::BM;
  const long long tiles = static_cast<long long>(mtiles) * ((nc + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  kern<<<grid, G::THREADS, smem, stream>>>(q, c, out, nq, nc, d, mtiles, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// queries [nq, d] f32, corpus [nc, d] f32, out [nq, nc] f32, all contiguous
// on `device`; launches on `stream`.  Returns the CUDA error code (0 = ok).
int repro_similarity(const void* queries, const void* corpus, void* out,
                     long long nq, long long nc, long long d, int normalize,
                     int device, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is this launch's
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (nq <= 0 || nc <= 0) return cudaSuccess;
  if (nq > 0x7fffffffLL || nc > 0x7fffffffLL || d > 0x7fffffffLL || d <= 0)
    return cudaErrorInvalidConfiguration;
  const auto* qf = static_cast<const float*>(queries);
  const auto* cf = static_cast<const float*>(corpus);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(nq), m = static_cast<int>(nc), k = static_cast<int>(d);
  if (n <= Narrow::BM)
    return normalize ? launch<Narrow, true>(qf, cf, o, n, m, k, device, s)
                     : launch<Narrow, false>(qf, cf, o, n, m, k, device, s);
  return normalize ? launch<Wide, true>(qf, cf, o, n, m, k, device, s)
                   : launch<Wide, false>(qf, cf, o, n, m, k, device, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
