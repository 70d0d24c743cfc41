// The IEEE fp32 SIMT GEMM core shared by similarity.cu, ivf_scan.cu and
// ivf_scan_q.cu.
//
// The kernels compute tiles of C[m, n] = sum_k A[m, k] * B[n, k], where A's
// rows are query vectors and B's rows are corpus (or cluster-tile) vectors,
// both with d contiguous.  Their contract is IEEE fp32 (the top-k ids must
// match the reference), which rules out TF32 tensor cores, so the ceiling
// is the non-tensor fp32 rate (67 TFLOP/s on an H100 SXM) and the core is
// built to keep the FMA pipes busy:
//
// * a CTA tile is BM x BN, BN = 128 and BM = 128 (similarity) or 64 (the
//   IVF scan); 2 * BM threads, each with an 8 x 8 register micro-tile, so
//   one k step costs two float4 shared loads of A and two of B for 64 FMAs,
//   and the operands of a step fit in 16 registers (128 in all, so two
//   256-thread or four 128-thread CTAs an SM);
// * d streams through a ring of STAGES shared-memory stages of BK values
//   (32 x 3 for similarity, 16 x 4 for the scan, whose loads weigh more
//   against its FMAs), filled by cp.async and stored k-major: a stage is BK
//   rows of BM + BN floats, the tile's A rows then its B rows at each k.
//   The copies are 4 bytes each, which transposes on the way in and takes
//   any d and any alignment; values outside the data are zero-filled by the
//   copy (src-size 0) without a read.  The int8 scan lands its rows
//   m-major with 16-byte copies instead and converts them into k-major
//   regions of its own, which the two-region mma_stage reads;
// * a k row is padded by 4 floats (its length is 4 mod 32): the micro-tile's
//   float4 loads and the row sums of squares read consecutive floats of one
//   k row, and the copies (a warp writes 4 rows x 8 k) land in 32 different
//   banks, so nothing conflicts, and every shared address is a thread's
//   base plus an immediate offset.
//
// Thread layout: warp w owns the 16-row "band" 16 w .. +16 and all 128
// columns; lane (ty, tx) = (lane / 16, lane % 16) owns rows 16 w + 8 ty + i
// (i < 8) and columns 4 tx + 64 jj + e (jj < 2, e < 4): four consecutive
// columns, so stores can be float4.  A kernel whose A rows end early (the
// IVF scan) skips the FMAs of bands past its last row.  Every accumulator,
// and every row's sum of squares, sums its k terms in ascending order: no
// atomics, and no result depends on where in a tile its row or column sat.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_gemm {

constexpr int BN = 128;                  // B rows (corpus vectors) per tile
constexpr int TM = 8, TN = 8;            // micro-tile
constexpr int JSTRIDE = 64;              // column step between a lane's float4s

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
// 16 bytes, bypassing L1: src and dst 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float inv_norm(float ss) {
  return 1.0f / sqrtf(fmaxf(ss, 1e-18f));
}

template <int BM_, int BK_, int STAGES_>
struct Gemm {
  static constexpr int BM = BM_;                  // A rows (queries) per tile
  static constexpr int BK = BK_;                  // floats of d per stage
  static constexpr int STAGES = STAGES_;          // cp.async ring depth
  static constexpr int THREADS = 2 * BM;          // one 16-row band a warp
  static constexpr int WARPS = THREADS / 32;
  static constexpr int ROWS = BM + BN;            // rows of one stage
  static constexpr int KROW = ROWS + 4;           // floats of one k row, padded
  static constexpr int STAGE_FLOATS = BK * KROW;
  static constexpr int RING_FLOATS = STAGES * STAGE_FLOATS;
  static_assert(KROW % 32 == 4 && (ROWS / 4) % WARPS == 0 && BK % 8 == 0, "copy layout");

  // the calling thread's place in the tile
  int band0, arow0, bcol0;
  __device__ __forceinline__ Gemm() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    band0 = 16 * warp;
    arow0 = band0 + (lane >> 4) * 8;
    bcol0 = (lane & 15) * 4;
  }
  // tile column of micro-tile column j (0..7)
  __device__ __forceinline__ int col(int j) const {
    return bcol0 + (j >> 2) * JSTRIDE + (j & 3);
  }

  // Fill one stage with d-columns k0 .. k0 + BK of the ROWS tile rows that
  // row_ptr(r) names (nullptr: a zero row).  A warp copies 4 rows x 8 k per
  // instruction; a thread covers rows 4 (warp + WARPS i) + lane / 8 at
  // k = 8 g + lane % 8 (g < 4).  `any` is a valid global address, passed
  // for copies that read nothing.
  template <typename RowPtr>
  static __device__ __forceinline__ void load_stage(float* st, RowPtr row_ptr, int k0, int d,
                                                    const float* any) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int kk = lane & 7, rr = lane >> 3;
#pragma unroll
    for (int i = 0; i < ROWS / 4 / WARPS; ++i) {
      const int r = 4 * (warp + WARPS * i) + rr;
      const float* src = row_ptr(r);
#pragma unroll
      for (int g = 0; g < BK / 8; ++g) {
        const int k = 8 * g + kk;
        const bool ok = src != nullptr && k0 + k < d;
        cp_async4(st + k * KROW + r, ok ? src + k0 + k : any, ok);
      }
    }
  }

  // acc[i][j] += A[arow0 + i] . B[col(j)] over one stage's BK columns, k
  // ascending.
  __device__ __forceinline__ void mma_stage(const float* st, float (&acc)[TM][TN]) const {
    mma_stage<KROW, KROW>(st, st + BM, acc);
  }

  // The same with A's k rows KA floats apart from sa and B's KB apart from sb.
  template <int KA, int KB>
  __device__ __forceinline__ void mma_stage(const float* sa, const float* sb,
                                            float (&acc)[TM][TN]) const {
    const float* pa = sa + arow0;
    const float* pb = sb + bcol0;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(pa + k * KA);
      const float4 a1 = *reinterpret_cast<const float4*>(pa + k * KA + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(pb + k * KB);
      const float4 b1 = *reinterpret_cast<const float4*>(pb + k * KB + JSTRIDE);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // Sum of squares of tile row r's BK values in a stage whose k rows are KS
  // floats apart, k ascending, added to ss.
  template <int KS = KROW>
  static __device__ __forceinline__ float row_sumsq(const float* st, int r, float ss) {
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float v = st[k * KS + r];
      ss = fmaf(v, v, ss);
    }
    return ss;
  }

  static __device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
};

// Once per kernel instance and device (`resident` starts at 0): allow the
// kernel `smem` bytes of dynamic shared memory, and set `resident` to the
// CTAs of `threads` threads the device holds at once (SMs x CTAs an SM).
template <typename Kernel>
cudaError_t prepare(Kernel kern, int threads, size_t smem, int device, int& resident) {
  if (resident > 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  resident = sms * per_sm;
  return cudaSuccess;
}

}  // namespace repro_gemm
