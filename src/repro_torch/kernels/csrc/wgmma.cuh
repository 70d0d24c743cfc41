// The bf16 tensor-core helpers shared by the attention kernels
// (flash_attention.cu's forward, flash_attention_bwd.cu's backward): wgmma
// products with f32 accumulators, the 128-byte swizzled tile layout and its
// descriptors, a cp.async ring's copies, TMA stores and the bf16 packing of
// accumulators into A fragments.
//
// One warpgroup (WG_THREADS = 128 threads) issues each product; tiles are
// TILE_ROWS = 64 rows (one wgmma M, or a 64-wide N / K step of 4 k16 steps).
// Thread t of the warpgroup (warp w = t / 32, lane) holds, of an m64nN f32
// accumulator, rows R0 = 16 w + lane / 4 and R1 = R0 + 8 at columns 8 j + 2
// (lane % 4) + {0, 1}: d[4 j + {0, 1}] in row R0, d[4 j + {2, 3}] in row R1.
// Its A fragment of a k16 step kk is rows R0, R1 at columns 16 kk + 2 (lane
// % 4) + {0, 1, 8, 9}: the packed pairs (d[8 kk], d[8 kk + 1]), (d[8 kk + 2],
// d[8 kk + 3]), (d[8 kk + 4], d[8 kk + 5]), (d[8 kk + 6], d[8 kk + 7]) of an
// m64n64 accumulator, so a product's result feeds the next product as its A
// operand without leaving registers (pack_frags).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int TILE_ROWS = 64;   // rows of a staged tile: one wgmma M
constexpr int WG_THREADS = 128; // one warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 64-row tile of HDP bf16 columns is held in wgmma's 128-byte swizzled
// layout: HDP / 64 panels of 64 columns (8 KB each), row r of a panel at byte
// 128 * r, its 16-byte chunk c at chunk c ^ (r % 8).  A descriptor names the
// start address, LBO and SBO (in 16-byte units) and the swizzle mode.  For a
// K-major operand (the product's K = hd runs along a row: Q and K in S = Q
// K^T) SBO = 1024 steps 8 rows, a k16 step advances the start by 32 bytes
// inside a panel (8192 to the next panel), and LBO is not read (a step never
// leaves a 128-byte row).  For an MN-major B operand, read through the
// transpose bit (K = the tile's rows, N = hd: V in O += P V), a k16 step
// advances the start by 2048 bytes (16 rows), SBO = 1024 steps 8 rows and
// LBO = 8192 the next 64 columns of hd.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  // ok == false writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// this thread's generic-proxy writes to shared memory become visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// pins registers that an asynchronous wgmma reads or writes in place, so the
// compiler moves no access of them across the fence / wait around it
template <int N> __device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N> __device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(d, i) F4(d, i), F4(d, i + 4), F4(d, i + 8), F4(d, i + 12)

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B MN-major in shared
// memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], as above
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F16
#undef F4

// Rows [0, rows) of a 64-row tile whose row r starts at src + r * stride, its
// first hd of HDP columns, into the swizzled layout at dst; the rest of the
// tile is zero.  Eight neighbouring threads move one row's 128 bytes of a
// panel.  VEC: hd % 8 == 0 and 16-byte aligned rows, copied asynchronously;
// else scalar loads, stored at once.
template <int HDP, bool VEC>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          long long stride, int rows, int hd) {
  // chunk i: 16-byte column chunk c of row r in panel i / (8 * TILE_ROWS)
  auto place = [&](int i, int& r, int& col) {
    const int c = i % 8;
    r = i / 8 % TILE_ROWS;
    col = i / (8 * TILE_ROWS) * 64 + 8 * c;
    return dst + (i / (8 * TILE_ROWS)) * (TILE_ROWS * 64) + r * 64 + 8 * (c ^ (r % 8));
  };
  if constexpr (VEC) {
#pragma unroll
    for (int it = 0; it < TILE_ROWS * HDP / 8 / WG_THREADS; ++it) {
      int r, col;
      bf16* d = place(threadIdx.x + it * WG_THREADS, r, col);
      const bool ok = r < rows && col < hd;
      cp_async16(smem_addr(d), ok ? src + r * stride + col : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < TILE_ROWS * HDP / 8; i += WG_THREADS) {
      int r, col;
      bf16* d = place(i, r, col);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = col + 2 * e;
        const bf16 zero = __float2bfloat16(0.f);
        const bf16 lo = r < rows && x < hd ? src[r * stride + x] : zero;
        const bf16 hi = r < rows && x + 1 < hd ? src[r * stride + x + 1] : zero;
        w[e] = (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// the output tile: a TMA store of one 64 x 64 panel from shared memory (in
// the 128-byte swizzle) to out at (column c, head h, row r, batch b), and
// waits for the stores' reads of shared memory / for the stores
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c, int h,
                                          int r, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(h), "r"(r), "r"(b), "r"(src)
      : "memory");
}
__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// the m64n64 accumulator d as the bf16 A fragments of 4 k16 steps (layout
// above), rounded to nearest
__device__ __forceinline__ void pack_frags(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

}  // namespace wg
