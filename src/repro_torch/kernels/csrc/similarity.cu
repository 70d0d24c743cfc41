// Fused L2-normalize + inner-product scores: out[i, j] = <q_i, c_j> / (|q_i| |c_j|).
//
// Replaces the TPU kernel src/repro/kernels/similarity.py::similarity (body
// _kernel): one Pallas grid step per 256x256 output tile with the whole
// feature dim d in VMEM, rows scaled by rsqrt(max(sum x^2, 1e-18)) before an
// MXU dot.
//
// What bounds it on an H100: it is a GEMM.  At the main path's shape (256
// queries x 1M corpus rows x d=384) it does 2*nq*nc*d = 201 GFLOP on
// 4*d*(nq+nc) + 4*nq*nc = 2.6 GB, ~78 FLOP/B, far above the fp32 ridge
// point, so it is bound by fp32 operations.  The contract is IEEE fp32
// (top-k ids must match the reference), which rules out TF32 tensor cores;
// this kernel is a SIMT fp32 GEMM and its ceiling is the non-tensor fp32 rate.
//
// Design: 64x64 output tiles, 256 threads, a 4x4 register micro-tile per
// thread, d streamed in chunks of 16 through shared memory (stored k-major
// so each thread reads its 4 rows / 4 columns as one 16-byte load).  The
// normalization costs no extra pass over memory: while a chunk is staged,
// threads 0..63 accumulate sum(q^2) of the tile's query rows and threads
// 64..127 sum(c^2) of its corpus rows from the same shared-memory chunk, and
// the accumulator is scaled once at the end by
// rsqrt(max(sum q^2,1e-18)) * rsqrt(max(sum c^2,1e-18)).  Ragged nq, nc and
// d are masked on load and store; nothing is padded in device memory.
// Faster forms (3xTF32 on wgmma, TMA-fed pipelines) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // query rows per tile
constexpr int BN = 64;       // corpus rows per tile
constexpr int BK = 16;       // feature chunk staged per step
constexpr int TM = 4;        // micro-tile rows per thread
constexpr int TN = 4;        // micro-tile columns per thread
constexpr int THREADS = 256; // (BM/TM) x (BN/TN)

__global__ void __launch_bounds__(THREADS)
similarity_kernel(const float* __restrict__ q, const float* __restrict__ c,
                  float* __restrict__ out, int nq, int nc, int d, int normalize) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  __shared__ float inv_q[BM];
  __shared__ float inv_c[BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // micro-tile column
  const int ty = tid / (BN / TN);   // micro-tile row
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int lk = tid % BK;          // load mapping: 16 lanes along d ...
  const int lr = tid / BK;          // ... x 16 rows per pass, 4 passes

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float sumsq = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    const int k = k0 + lk;
#pragma unroll
    for (int p = 0; p < BM / 16; ++p) {
      const int r = lr + 16 * p;
      const int gq = row0 + r, gc = col0 + r;
      As[lk][r] = (gq < nq && k < d) ? q[(long long)gq * d + k] : 0.f;
      Bs[lk][r] = (gc < nc && k < d) ? c[(long long)gc * d + k] : 0.f;
    }
    __syncthreads();
    if (normalize) {
      if (tid < BM) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) sumsq = fmaf(As[kk][tid], As[kk][tid], sumsq);
      } else if (tid < BM + BN) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk)
          sumsq = fmaf(Bs[kk][tid - BM], Bs[kk][tid - BM], sumsq);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (normalize) {
    if (tid < BM) inv_q[tid] = 1.0f / sqrtf(fmaxf(sumsq, 1e-18f));
    else if (tid < BM + BN) inv_c[tid - BM] = 1.0f / sqrtf(fmaxf(sumsq, 1e-18f));
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= nq) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx * TN + j;
      if (col >= nc) continue;
      float v = acc[i][j];
      if (normalize) v *= inv_q[ty * TM + i] * inv_c[tx * TN + j];
      out[(long long)r * nc + col] = v;
    }
  }
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
  const long long gx = (nc + BN - 1) / BN, gy = (nq + BM - 1) / BM;
  if (gx > 0x7fffffffLL || gy > 65535 || d > 0x7fffffffLL || d <= 0)
    return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)gx, (unsigned)gy);
  similarity_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(corpus),
      static_cast<float*>(out), (int)nq, (int)nc, (int)d, normalize);
  return cudaGetLastError();
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
