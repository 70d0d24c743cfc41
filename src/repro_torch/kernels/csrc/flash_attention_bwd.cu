// The gradient of GQA flash attention, causal and/or sliding window: dq, dk
// and dv from q, k, v, the forward's output and its gradient.
//
// Replaces no TPU kernel.  The reference's Pallas flash_attention
// (src/repro/kernels/flash_attention.py:64) has no gradient: jax.grad through
// it raises, and the reference trains through its jnp attention.  The port's
// model runs its CUDA forward (csrc/flash_attention.cu) under attn_impl
// "auto" on the card, so training there needs this kernel beneath the
// forward (kernels/flash_attention.py, FlashAttention).
//
// Contract: the gradient of kernels/ref.py::flash_attention_ref, whose plain
// version is ref.flash_attention_bwd_ref (torch.autograd through the
// contract).  Scores s = (q . k) * scale in f32; a masked score is the finite
// NEG_INF and gets no gradient; P = exp(s - m) / l over the Sk keys that
// exist; dP = dO . V; D = rowsum(dO * O); dS = P * (dP - D) on the unmasked
// scores; dQ = scale * dS K, dK = scale * dS^T Q, dV = P^T dO with P rounded
// to the input type first, as the forward's PV product rounds it.  A row that
// no key may see (window > 0 and row >= Sk + window - 1) has m = NEG_INF and
// l = Sk, so its uniform P reaches dV and nothing reaches dQ or dK.  dK and
// dV sum over the H / Hk q-heads of each kv-head.  Everything is f32 inside;
// each output is rounded once to the input type.
//
// What bounds it on an H100: the backward is five products (S, dP, dV, dK,
// dQ) over the unmasked (q, k) pairs, 10 * B * H * hd * pairs FLOPs; at the
// training shape (q [2,512,24,128], k/v [2,512,8,128] bf16, causal) 8.1
// GFLOP, 0.0082 ms on the bf16 tensor cores, against 33.6 MB of inputs and
// outputs, 0.0100 ms at 3.35 TB/s: bytes bound it, by a little.  Both
// kernels below recompute S (seven products in all: 0.0114 ms at 989
// TFLOP/s), so the products must run on the tensor cores to come near it.
//
// bf16, on the tensor cores (wgmma, f32 accumulators; helpers in wgmma.cuh):
// - No statistics pass: the forward launched by FlashAttention saves each
//   row's max m and sum l (flash_attention.cu), and the backward reads them.
// - Kernel 1 (flash_attention_bwd_dq_wgmma_bf16), one block of one
//   warpgroup per (64-row q tile, q-head, batch row), the heaviest causal q
//   tiles first: D = rowsum(dO * O) and each row's record {m in log2 units,
//   1 / l, D} for kernel 2, then over the key tiles that some row of the
//   tile may see: S = Q K^T and dP = dO V^T (m64n64k16, both operands in
//   shared memory), P and dS = P * (dP - D) in registers, and dQ += dS K
//   (m64n{64,128}k16, dS rounded to bf16 as the A fragments straight from
//   the accumulators, K read through the transpose bit).
// - Kernel 2 (flash_attention_bwd_dkdv_wgmma_bf16), one block per (64-key
//   tile, q-head, batch row), the first key tiles (seen by the most causal
//   rows) first: the K and V tiles stay in shared memory while the q tiles
//   that see a key of the tile (and those of rows that no key may see, whose
//   uniform P reaches dV) stream through; S^T = K Q^T and dP^T = V dO^T, then
//   P^T and dS^T in registers become the A fragments of dV += P^T dO and dK
//   += dS^T Q (dO and Q through the transpose bit).  P^T is rounded to bf16
//   there, which is the contract's rounding.  One block a q-head balances
//   the causal work (1 to 8 q tiles a block at the training shape, 384
//   blocks) where one block a kv-head looped over its group (3 to 24).
// - The group sum: the blocks of one key tile and kv-head run as a thread
//   block cluster (up to 8 blocks, a cluster's portable size; past 8 q-heads
//   a kv-head, each block takes group / cluster of them in turn).  Each
//   block leaves its f32 dK and dV in its own shared memory, and the
//   cluster's blocks sum them over distributed shared memory in rank order,
//   each block its share of the rows, rounding once.  No atomics and no
//   partial sums in device memory, so two calls give the same bits.
// - Tiles wholly masked are skipped, unless they hold a row that no key may
//   see; masks apply only on tiles that straddle the diagonal, the window's
//   edge or Sk.  Loads overlap the products: the streamed tiles go through a
//   two-stage ring of 16-byte cp.async copies in wgmma's 128-byte swizzle
//   (scalar loads where a row is not 16-byte aligned, e.g. hd 100 or a
//   sliced tensor); hd is zero-padded to 64 or 128.  99 KB of shared memory
//   a block at hd 128, two blocks an SM.
// - dS is rounded to bf16 as an operand of dQ and dK (the plain version
//   keeps it in f32): phase 19 of chip_smoke.py holds the result to the
//   plain version within the same limit.
//
// f32 stays on the SIMT pipes (flash_attention_bwd_dq / _dkdv below): the
// contract demands IEEE f32 products, and the tensor cores have no such
// mode.  It recomputes m and l itself.  Dispatch is by dtype alone.
//
// f32 design, simple and deterministic:
// - Kernel 1 (flash_attention_bwd_dq) takes one 64-row q tile of one q-head:
//   it computes D from dO and O, recomputes each row's max m and sum l over
//   the visible key tiles (online, as the forward), then walks the key tiles
//   again for dS and dQ.  It writes m, l and D for kernel 2.
// - Kernel 2 (flash_attention_bwd_dkdv) takes one 64-key tile of one
//   kv-head: it loops over the group's q-heads and the q tiles that see a
//   key of the tile (or hold rows that see none), accumulating dK and dV in
//   registers.  So the group sum needs no atomics, and two calls give the
//   same bits.
// - Tiles live in shared memory as f32 (row stride HDP + 1: conflict-free
//   column walks); 256 threads as 16 x 16, each owning 4 rows x 4 columns of
//   a 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j) and 4 rows x
//   HDP / 16 columns of its accumulators; a row's max and sum reduce over its
//   16 threads with warp shuffles.  hd is zero-padded to 32, 64 or 128.
//   Loads are scalar, so any alignment and any row stride of the
//   [B, S, H, hd] layout is taken.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>

#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// f32: SIMT pipes
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int LDS = BK + 1;     // row stride of the P and dS tiles

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to T and back: the contract rounds P to the input type before
// the PV product
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ bool visible(int row, int col, int Sk, int causal, int window) {
  return col < Sk && (!causal || row >= col) && (window == 0 || row - col < window);
}

// Rows row0 .. row0 + 64 of a [S, stride] view into dst[64][HDP + 1] as f32,
// zeros past S and past hd.
template <typename T, int HDP>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int row0,
                                          int S, long long stride, int hd) {
  for (int i = threadIdx.x; i < 64 * HDP; i += THREADS) {
    const int r = i / HDP, d = i % HDP;
    const int pos = row0 + r;
    dst[r * (HDP + 1) + d] = (pos < S && d < hd) ? to_f32(src[pos * stride + d]) : 0.f;
  }
}

// acc[i][j] = A[ty + 16 i] . B[tx + 16 j] over HDP columns of two tiles
template <int HDP>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, float acc[4][4]) {
  constexpr int LD = HDP + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HDP>
constexpr size_t smem_dq() {
  return sizeof(float) * (4 * 64 * (HDP + 1) + BQ * LDS);
}

template <int HDP>
constexpr size_t smem_dkdv() {
  return sizeof(float) * (4 * 64 * (HDP + 1) + 2 * BQ * LDS);
}

// Kernel 1: one block per (64-row q tile, q-head, batch row).  stats holds
// m, l and D, each [B, H, Sq] f32, one after the other.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
flash_attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ o,
                       const T* __restrict__ dout, T* __restrict__ dq,
                       float* __restrict__ stats, int B, int Sq, int Sk, int H, int Hk,
                       int hd, float scale, int causal, int window) {
  constexpr int LD = HDP + 1, NJ = HDP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* dOs = Qs + BQ * LD;     // [BQ][LD]
  float* Ks = dOs + BQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* dSs = Vs + BK * LD;     // [BQ][LDS]
  __shared__ float Dsh[BQ];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hkv = h / (H / Hk);
  const long long q_stride = (long long)H * hd, k_stride = (long long)Hk * hd;
  const long long qoff = ((long long)b * Sq * H + h) * hd;
  const long long koff = ((long long)b * Sk * Hk + hkv) * hd;
  const long long n_rows = (long long)B * H * Sq;
  const long long srow = ((long long)b * H + h) * Sq;

  load_rows<T, HDP>(Qs, q + qoff, q0, Sq, q_stride, hd);
  load_rows<T, HDP>(dOs, dout + qoff, q0, Sq, q_stride, hd);
  {  // D = rowsum(dO * O), four threads a row
    const int r = tid / 4, part = tid % 4, pos = q0 + r;
    float acc = 0.f;
    if (pos < Sq) {
      const T* orow = o + qoff + pos * q_stride;
      const T* grow = dout + qoff + pos * q_stride;
      for (int d = part; d < hd; d += 4) acc = fmaf(to_f32(grow[d]), to_f32(orow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) Dsh[r] = acc;
  }

  // the key tiles that hold a key some row of this tile may see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int kt_lo = k_lo / BK;
  const int kt_hi = k_lo < k_hi ? (k_hi + BK - 1) / BK : kt_lo;

  // pass 1: each row's max and sum, online over the tiles
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    __syncthreads();
    load_rows<T, HDP>(Ks, k + koff, kt * BK, Sk, k_stride, hd);
    __syncthreads();
    float s[4][4];
    tile_dot<HDP>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * BK + tx + 16 * j;
        s[i][j] = visible(row, col, Sk, causal, window) ? s[i][j] * scale : NEG_INF;
        if (col < Sk) mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kt * BK + tx + 16 * j < Sk) rs += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(rs);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (window > 0 && row >= Sk + window - 1) {   // no key may see it: uniform P
      m[i] = NEG_INF;
      l[i] = (float)Sk;
    }
    if (tx == 0 && row < Sq) {
      stats[srow + row] = m[i];
      stats[n_rows + srow + row] = l[i];
      stats[2 * n_rows + srow + row] = Dsh[ty + 16 * i];
    }
  }

  // pass 2: dS and dQ = dS K
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    __syncthreads();
    load_rows<T, HDP>(Ks, k + koff, kt * BK, Sk, k_stride, hd);
    load_rows<T, HDP>(Vs, v + koff, kt * BK, Sk, k_stride, hd);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HDP>(Qs, Ks, s);
    tile_dot<HDP>(dOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * BK + tx + 16 * j;
        float ds = 0.f;
        if (row < Sq && visible(row, col, Sk, causal, window)) {
          const float p = expf(s[i][j] * scale - m[i]) / l[i];
          ds = p * (dp[i][j] - Dsh[ty + 16 * i]);
        }
        dSs[(ty + 16 * i) * LDS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float kv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty + 16 * i) * LDS + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dq[qoff + row * q_stride + d] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

// Kernel 2: one block per (64-key tile, kv-head, batch row), over the
// group's q-heads; reads kernel 1's m, l and D.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
flash_attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         T* __restrict__ dk, T* __restrict__ dv,
                         const float* __restrict__ stats, int B, int Sq, int Sk, int H,
                         int Hk, int hd, float scale, int causal, int window) {
  constexpr int LD = HDP + 1, NJ = HDP / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* Qs = Vs + BK * LD;      // [BQ][LD]
  float* dOs = Qs + BQ * LD;     // [BQ][LD]
  float* Ps = dOs + BQ * LD;     // [BQ][LDS]
  float* dSs = Ps + BQ * LDS;    // [BQ][LDS]
  __shared__ float msh[BQ], lsh[BQ], Dsh[BQ];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BK, hkv = blockIdx.y, b = blockIdx.z;
  const int group = H / Hk;
  const long long q_stride = (long long)H * hd, k_stride = (long long)Hk * hd;
  const long long koff = ((long long)b * Sk * Hk + hkv) * hd;
  const long long n_rows = (long long)B * H * Sq;

  load_rows<T, HDP>(Ks, k + koff, k0, Sk, k_stride, hd);
  load_rows<T, HDP>(Vs, v + koff, k0, Sk, k_stride, hd);

  // the q rows that may see a key of this tile, and the rows that see none
  const int k_last = min(k0 + BK, Sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  const int dead_lo = window > 0 ? Sk + window - 1 : Sq;
  const int nq = (Sq + BQ - 1) / BQ;

  float adk[4][NJ], adv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hkv * group + g;
    const long long qoff = ((long long)b * Sq * H + h) * hd;
    const long long srow = ((long long)b * H + h) * Sq;
    for (int qt = 0; qt < nq; ++qt) {
      const int r0 = qt * BQ;
      const bool live = r0 < q_hi && r0 + BQ > q_lo;
      const bool dead = r0 + BQ > dead_lo;
      if (!live && !dead) continue;
      __syncthreads();
      load_rows<T, HDP>(Qs, q + qoff, r0, Sq, q_stride, hd);
      load_rows<T, HDP>(dOs, dout + qoff, r0, Sq, q_stride, hd);
      if (tid < BQ) {
        const int row = r0 + tid;
        const bool ok = row < Sq;
        msh[tid] = ok ? stats[srow + row] : 0.f;
        lsh[tid] = ok ? stats[n_rows + srow + row] : 1.f;
        Dsh[tid] = ok ? stats[2 * n_rows + srow + row] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<HDP>(Qs, Ks, s);     // [q row ty + 16 i][key tx + 16 j]
      tile_dot<HDP>(dOs, Vs, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, row = r0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx + 16 * j;
          float p = 0.f, ds = 0.f;
          if (row < Sq && col < Sk) {
            const bool vis = visible(row, col, Sk, causal, window);
            p = expf((vis ? s[i][j] * scale : NEG_INF) - msh[r]) / lsh[r];
            if (vis) ds = p * (dp[i][j] - Dsh[r]);
          }
          Ps[r * LDS + tx + 16 * j] = round_to<T>(p);
          dSs[r * LDS + tx + 16 * j] = ds;
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * LDS + ty + 16 * i];
          dsv[i] = dSs[r * LDS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float gv = dOs[r * LD + tx + 16 * j];
          const float qv = Qs[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][j] = fmaf(pv[i], gv, adv[i][j]);
            adk[i][j] = fmaf(dsv[i], qv, adk[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        dk[koff + key * k_stride + d] = from_f32<T>(adk[i][j] * scale);
        dv[koff + key * k_stride + d] = from_f32<T>(adv[i][j]);
      }
    }
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, void* dq, void* dk, void* dv, float* stats, int B,
                   int Sq, int Sk, int H, int Hk, int hd, float scale, int causal, int window,
                   cudaStream_t stream) {
  auto k1 = flash_attention_bwd_dq<T, HDP>;
  auto k2 = flash_attention_bwd_dkdv<T, HDP>;
  constexpr size_t s1 = smem_dq<HDP>(), s2 = smem_dkdv<HDP>();
  cudaError_t e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (e != cudaSuccess) return e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  k1<<<dim3((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B), THREADS, s1, stream>>>(
      qt, kt, vt, static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<T*>(dq),
      stats, B, Sq, Sk, H, Hk, hd, scale, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k2<<<dim3((unsigned)((Sk + BK - 1) / BK), (unsigned)Hk, (unsigned)B), THREADS, s2, stream>>>(
      qt, kt, vt, static_cast<const T*>(dout), static_cast<T*>(dk), static_cast<T*>(dv), stats,
      B, Sq, Sk, H, Hk, hd, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* out,
                     const void* dout, void* dq, void* dk, void* dv, float* stats, int B,
                     int Sq, int Sk, int H, int Hk, int hd, float scale, int causal, int window,
                     cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, dout, dq, dk, dv, stats, B, Sq, Sk, H, Hk, hd, scale,
                         causal, window, s);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, dout, dq, dk, dv, stats, B, Sq, Sk, H, Hk, hd, scale,
                         causal, window, s);
  return launch<T, 128>(q, k, v, out, dout, dq, dk, dv, stats, B, Sq, Sk, H, Hk, hd, scale,
                        causal, window, s);
}


}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------
namespace tc {

using namespace wg;

constexpr int BQ = TILE_ROWS;   // q rows per tile
constexpr int BK = TILE_ROWS;   // keys per tile
constexpr int THREADS = WG_THREADS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_CLUSTER = 8;   // blocks in a portable thread block cluster

// Either kernel: two tiles that stay, a two-stage ring of two streamed tiles,
// and (kernel 2) a two-stage ring of the streamed q tile's row records; the
// two tile rings hold kernel 2's f32 dK and dV at the end.
template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * 6 * BQ * HDP + 2 * BQ * sizeof(float4) + 1024;   // slack to align
}

__device__ __forceinline__ bf16* align1024(unsigned char* p) {
  return reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// acc + the dot product of 8 bf16 pairs
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[e]));
    const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y[e]));
    acc = fmaf(fa.x, fb.x, acc);
    acc = fmaf(fa.y, fb.y, acc);
  }
  return acc;
}

// columns col, col + 1 of a bf16 row (VEC: hd % 8 == 0 and aligned rows)
template <bool VEC>
__device__ __forceinline__ void store_pair(bf16* row, int col, int hd, float a, float b) {
  if (VEC) {
    if (col < hd) *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(a, b);
  } else {
    if (col < hd) row[col] = __float2bfloat16_rn(a);
    if (col + 1 < hd) row[col + 1] = __float2bfloat16_rn(b);
  }
}

// d (+)= A B^T over HDP columns, A and B K-major 64-row tiles in shared memory
template <int HDP>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t off = 8192 * (kk / 4) + 32 * (kk % 4);
    wgmma_ss_n64(d, make_desc(a_addr + off, 16, 1024), make_desc(b_addr + off, 16, 1024),
                 kk > 0);
  }
}

// d += A B over 64 rows of B: A's fragments from registers, B a 64-row tile
// in shared memory read through the transpose bit
template <int NO>
__device__ __forceinline__ void product_rs(float (&d)[NO], const uint32_t (&a)[4][4],
                                           uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, a[kk], make_desc(b_addr + 2048 * kk, 8192, 1024));
}

__device__ __forceinline__ void pin_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) pin(a[kk]);
}

// Kernel 1: one block per (64-row q tile, q-head, batch row), the heaviest
// causal q tiles first.  stats holds the forward's m and l ([B, H, Sq]
// each); rows receives each row's record {m * log2(e), 1 / l, D, 0} for
// kernel 2 (NEG_INF stays NEG_INF: a row that no key may see).
template <int HDP, bool VEC>
__global__ void __launch_bounds__(THREADS)
flash_attention_bwd_dq_wgmma_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                                  const bf16* __restrict__ dout, bf16* __restrict__ dq,
                                  const float* __restrict__ stats, float4* __restrict__ rows,
                                  int B, int Sq, int Sk, int H, int Hk, int hd, float scale,
                                  float scale_log2, int causal, int window) {
  constexpr int TILE = BQ * HDP;   // elements of a staged tile
  constexpr int NO = HDP / 2;      // dQ accumulator floats a thread
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = align1024(smem_raw);
  bf16* dOs = Qs + TILE;
  bf16* Ks = dOs + TILE;           // [2][TILE]
  bf16* Vs = Ks + 2 * TILE;        // [2][TILE]
  __shared__ float Msh[BQ], Lsh[BQ], Dsh[BQ];

  const int n_qt = (Sq + BQ - 1) / BQ, per_qt = H * B;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / per_qt) * BQ;
  const int h = blockIdx.x % per_qt % H, b = blockIdx.x % per_qt / H;
  const long long q_stride = (long long)H * hd, k_stride = (long long)Hk * hd;
  const long long qoff = ((long long)b * Sq * H + h) * hd + q0 * q_stride;
  const long long koff = ((long long)b * Sk * Hk + h / (H / Hk)) * hd;
  const long long srow = ((long long)b * H + h) * Sq + q0;   // the tile's first row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lr0 = 16 * warp + lane / 4, lr1 = lr0 + 8;     // tile rows of this thread
  const int c0 = 2 * (lane % 4);                           // its first column in each 8

  // the key tiles that hold a key some row of this tile may see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int kv_lo = k_lo / BK * BK;
  const int n_tiles = k_lo < k_hi ? (k_hi - kv_lo + BK - 1) / BK : 0;

  auto load_kv = [&](int j) {     // K_j and V_j into stage j % 2
    const int k0 = kv_lo + j * BK;
    const long long off = koff + k0 * k_stride;
    load_tile<HDP, VEC>(Ks + (j & 1) * TILE, k + off, k_stride, Sk - k0, hd);
    load_tile<HDP, VEC>(Vs + (j & 1) * TILE, v + off, k_stride, Sk - k0, hd);
  };
  // D = rowsum(dO * O) and the rows' records, two threads a row; their
  // loads go out ahead of the tiles' copies
  {
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    const bool live = q0 + r < Sq;
    const bf16* orow = o + qoff + r * q_stride;
    const bf16* grow = dout + qoff + r * q_stride;
    float d = 0.f, m = 0.f, l = 1.f;
    uint4 ov[HDP / 16], gv[HDP / 16];   // this thread's half of the row (VEC)
    if (live) {
      m = stats[srow + r];
      l = stats[(long long)B * H * Sq + srow + r];
      if constexpr (VEC) {
#pragma unroll
        for (int cc = 0; cc < HDP / 16; ++cc) {
          const int c = 8 * (half * HDP / 16 + cc);
          ov[cc] = c < hd ? *reinterpret_cast<const uint4*>(orow + c) : make_uint4(0, 0, 0, 0);
          gv[cc] = c < hd ? *reinterpret_cast<const uint4*>(grow + c) : make_uint4(0, 0, 0, 0);
        }
      }
    }
    // cp.async groups: Q, dO, K_0, V_0; K_1, V_1; then K_{j+1}, V_{j+1} in
    // step j >= 1, once the products of step j - 1 are done with that stage
    load_tile<HDP, VEC>(Qs, q + qoff, q_stride, Sq - q0, hd);
    load_tile<HDP, VEC>(dOs, dout + qoff, q_stride, Sq - q0, hd);
    if (n_tiles > 0) load_kv(0);
    cp_commit();
    if (n_tiles > 1) load_kv(1);
    cp_commit();
    if (live) {
      if constexpr (VEC) {
#pragma unroll
        for (int cc = 0; cc < HDP / 16; ++cc) d = dot8(ov[cc], gv[cc], d);
      } else {
        for (int c = half; c < hd; c += 2)
          d = fmaf(__bfloat162float(orow[c]), __bfloat162float(grow[c]), d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      float m2 = 0.f, inv_l = 0.f;   // rows past Sq get no weight
      if (q0 + r < Sq) {
        m2 = m <= NEG_INF ? NEG_INF : m * LOG2E;
        inv_l = 1.f / l;
        rows[srow + r] = make_float4(m2, inv_l, d, 0.f);
      }
      Msh[r] = m2;
      Lsh[r] = inv_l;
      Dsh[r] = d;
    }
  }
  __syncthreads();
  const float m2_0 = Msh[lr0], m2_1 = Msh[lr1], il0 = Lsh[lr0], il1 = Lsh[lr1];
  const float d_0 = Dsh[lr0], d_1 = Dsh[lr1];
  const int r0 = q0 + lr0, r1 = q0 + lr1;     // absolute rows of this thread

  float acc[NO], s[32], dp[32];
  uint32_t a[4][4];                // dS in bf16: the A fragments of dQ's 4 k16 steps
#pragma unroll
  for (int x = 0; x < NO; ++x) acc[x] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) a[kk][0] = a[kk][1] = a[kk][2] = a[kk][3] = 0u;
  const uint32_t q_addr = smem_addr(Qs), do_addr = smem_addr(dOs);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kv_lo + j * BK;
    wg_wait<0>();        // dQ += dS_{j-1} K_{j-1} is done
    pin(acc);
    pin_frags(a);
    __syncthreads();     // ... in every warp: stage (j + 1) % 2 is free
    if (j >= 1) {
      if (j + 1 < n_tiles) load_kv(j + 1);
      cp_commit();
    }
    cp_wait<1>();        // K_j and V_j have landed
    fence_async_smem();
    __syncthreads();
    const uint32_t k_addr = smem_addr(Ks + (j & 1) * TILE);
    const uint32_t v_addr = smem_addr(Vs + (j & 1) * TILE);
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
    pin(s);
    pin(dp);
    wg_fence();
    product_ss<HDP>(s, q_addr, k_addr);      // S = Q K^T
    product_ss<HDP>(dp, do_addr, v_addr);    // dP = dO V^T
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);

    // dS = P * (dP - D) where the score is kept, P = 2^(s log2(e) - m) / l;
    // mask only a tile that straddles an edge
    const bool edge = (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q0 + BQ - 1 - k0 >= window) || k0 + BK > Sk;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const bool second = x & 2;   // row r1
      const float p = fast_exp2(s[x] * scale_log2 - (second ? m2_1 : m2_0)) *
                      (second ? il1 : il0);
      const float ds = p * (dp[x] - (second ? d_1 : d_0));
      if (edge) {
        const int key = k0 + 8 * (x / 4) + (x & 1) + c0, row = second ? r1 : r0;
        const bool keep = key < Sk && (!causal || row >= key) &&
                          (window == 0 || row - key < window);
        dp[x] = keep ? ds : 0.f;
      } else {
        dp[x] = ds;
      }
    }
    pack_frags(dp, a);
    pin(acc);
    pin_frags(a);
    wg_fence();
    product_rs(acc, a, k_addr);              // dQ += dS K
    wg_commit();
  }
  wg_wait<0>();
  pin(acc);
  cp_wait<0>();

  bf16* row0 = dq + qoff + lr0 * q_stride;
  bf16* row1 = dq + qoff + lr1 * q_stride;
#pragma unroll
  for (int x = 0; x < NO; x += 4) {
    const int col = 8 * (x / 4) + c0;
    if (r0 < Sq) store_pair<VEC>(row0, col, hd, acc[x] * scale, acc[x + 1] * scale);
    if (r1 < Sq) store_pair<VEC>(row1, col, hd, acc[x + 2] * scale, acc[x + 3] * scale);
  }
}

// Kernel 2: one block per (64-key tile, heads q-heads, batch row), the first
// key tiles first, launched as clusters of the H / Hk / heads blocks of one
// key tile and kv-head; reads kernel 1's row records.  A cluster of one
// block writes its dk and dv; a larger one sums its blocks' dK and dV.
template <int HDP, bool VEC>
__global__ void __launch_bounds__(THREADS)
flash_attention_bwd_dkdv_wgmma_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                    bf16* __restrict__ dk, bf16* __restrict__ dv,
                                    const float4* __restrict__ rows, int B, int Sq, int Sk,
                                    int H, int Hk, int hd, float scale, float scale_log2,
                                    int causal, int window, int heads) {
  constexpr int TILE = BQ * HDP;
  constexpr int NO = HDP / 2;
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = align1024(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;            // [2][TILE]
  bf16* dOs = Qs + 2 * TILE;       // [2][TILE]
  float4* Rs = reinterpret_cast<float4*>(dOs + 2 * TILE);   // [2][BQ] row records

  const int n_qt = (Sq + BQ - 1) / BQ, per_kt = H / heads * B;
  const int k0 = (int)blockIdx.x / per_kt * BK;
  const int hb = blockIdx.x % per_kt % (H / heads), b = blockIdx.x % per_kt / (H / heads);
  const int cluster = H / Hk / heads, hkv = hb / cluster;   // blocks a cluster; its kv-head
  const long long q_stride = (long long)H * hd, k_stride = (long long)Hk * hd;
  const long long koff = ((long long)b * Sk * Hk + hkv) * hd + k0 * k_stride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lr0 = 16 * warp + lane / 4, lr1 = lr0 + 8;     // keys k0 + lr0, k0 + lr1
  const int c0 = 2 * (lane % 4);

  // the q tiles that hold a row that may see a key of this tile, then those
  // that hold a row that no key may see (its uniform P reaches every key)
  const int k_last = min(k0 + BK, Sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  const int a0 = q_lo / BQ;
  const int n_live = q_lo < q_hi ? (q_hi + BQ - 1) / BQ - a0 : 0;
  const int dead_lo = window > 0 ? Sk + window - 1 : Sq;
  const int d0 = dead_lo < Sq ? max(dead_lo / BQ, a0 + n_live) : n_qt;
  const int per_head = n_live + n_qt - d0, n_steps = heads * per_head;
  // step j: q-head hb * heads + j / per_head, at this q tile
  auto q0_of = [&](int j) {
    const int i = j % per_head;
    return (i < n_live ? a0 + i : d0 + i - n_live) * BQ;
  };

  auto load_q = [&](int j) {      // Q, dO and the row records of step j into stage j % 2
    const int q0 = q0_of(j), h = hb * heads + j / per_head;
    const long long off = ((long long)b * Sq * H + h) * hd + q0 * q_stride;
    const long long srow = ((long long)b * H + h) * Sq + q0;
    load_tile<HDP, VEC>(Qs + (j & 1) * TILE, q + off, q_stride, Sq - q0, hd);
    load_tile<HDP, VEC>(dOs + (j & 1) * TILE, dout + off, q_stride, Sq - q0, hd);
    if (threadIdx.x < BQ) {
      const bool ok = q0 + (int)threadIdx.x < Sq;   // rows past Sq: zeros, no weight
      cp_async16(smem_addr(Rs + (j & 1) * BQ + threadIdx.x),
                 ok ? rows + srow + threadIdx.x : rows, ok);
    }
  };
  // cp.async groups: K, V, step 0's tiles; step 1's; then step j + 1's in
  // step j >= 1, once the products of step j - 1 are done with that stage
  load_tile<HDP, VEC>(Ks, k + koff, k_stride, Sk - k0, hd);
  load_tile<HDP, VEC>(Vs, v + koff, k_stride, Sk - k0, hd);
  if (n_steps > 0) load_q(0);
  cp_commit();
  if (n_steps > 1) load_q(1);
  cp_commit();

  float adk[NO], adv[NO], s[32], dp[32];
  uint32_t pa[4][4], da[4][4];     // P^T and dS^T in bf16: A fragments of 4 k16 steps
#pragma unroll
  for (int x = 0; x < NO; ++x) adk[x] = adv[x] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kk][e] = da[kk][e] = 0u;
  const uint32_t k_addr = smem_addr(Ks), v_addr = smem_addr(Vs);
  const int key0 = k0 + lr0, key1 = k0 + lr1;

  for (int j = 0; j < n_steps; ++j) {
    const int q0 = q0_of(j);
    wg_wait<0>();        // the dV and dK products of step j - 1 are done
    pin(adk);
    pin(adv);
    pin_frags(pa);
    pin_frags(da);
    __syncthreads();     // ... in every warp: stage (j + 1) % 2 is free
    if (j >= 1) {
      if (j + 1 < n_steps) load_q(j + 1);
      cp_commit();
    }
    cp_wait<1>();        // step j's tiles have landed
    fence_async_smem();
    __syncthreads();
    const uint32_t q_addr = smem_addr(Qs + (j & 1) * TILE);
    const uint32_t do_addr = smem_addr(dOs + (j & 1) * TILE);
    const float4* R = Rs + (j & 1) * BQ;
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
    pin(s);
    pin(dp);
    wg_fence();
    product_ss<HDP>(s, k_addr, q_addr);      // S^T = K Q^T
    product_ss<HDP>(dp, v_addr, do_addr);    // dP^T = V dO^T
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);

    // P^T = 2^(s log2(e) - m) / l and dS^T = P^T * (dP^T - D), column c of
    // the tile being q row q0 + c; mask only a tile that straddles an edge
    const bool edge = (causal && q0 < k0 + BK - 1) ||
                      (window > 0 && q0 + BQ - 1 - k0 >= window) || k0 + BK > Sk;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int c = 8 * (x / 4) + (x & 1) + c0;
      const float4 rec = R[c];                  // m log2(e), 1 / l, D
      float sc = s[x] * scale_log2;
      bool keep = true;
      if (edge) {
        // a masked score is NEG_INF: no weight, except in a row that no key
        // may see (m = NEG_INF), where every key < Sk weighs 1 / l
        const int key = (x & 2) ? key1 : key0, row = q0 + c;
        keep = key < Sk && (!causal || row >= key) && (window == 0 || row - key < window);
        sc = key >= Sk ? -__int_as_float(0x7f800000) : keep ? sc : NEG_INF;
      }
      const float p = fast_exp2(sc - rec.x) * rec.y;
      s[x] = p;
      dp[x] = keep ? p * (dp[x] - rec.z) : 0.f;
    }
    pack_frags(s, pa);
    pack_frags(dp, da);
    pin(adk);
    pin(adv);
    pin_frags(pa);
    pin_frags(da);
    wg_fence();
    product_rs(adv, pa, do_addr);            // dV += P^T dO
    product_rs(adk, da, q_addr);             // dK += dS^T Q
    wg_commit();
  }
  wg_wait<0>();
  pin(adk);
  pin(adv);
  cp_wait<0>();

  if (cluster > 1) {
    // this block's dK (scaled) and dV, f32 [2][BK][HDP], into the ring
    // (every copy has landed and every product is done); column c of row r
    // at c ^ 8 (r % 4), so that a half-warp's 8-byte stores (4 rows x 8
    // columns) meet 32 different banks
    float* red = reinterpret_cast<float*>(Qs);
    auto at = [](int r, int c) { return r * HDP + (c ^ (8 * (r % 4))); };
    __syncthreads();
#pragma unroll
    for (int x = 0; x < NO; x += 4) {
      const int col = 8 * (x / 4) + c0;
      *reinterpret_cast<float2*>(red + at(lr0, col)) = make_float2(adk[x] * scale,
                                                                   adk[x + 1] * scale);
      *reinterpret_cast<float2*>(red + at(lr1, col)) = make_float2(adk[x + 2] * scale,
                                                                   adk[x + 3] * scale);
      *reinterpret_cast<float2*>(red + at(BK + lr0, col)) = make_float2(adv[x], adv[x + 1]);
      *reinterpret_cast<float2*>(red + at(BK + lr1, col)) = make_float2(adv[x + 2], adv[x + 3]);
    }
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();           // every q-head's share is in its block's shared memory
    // this block's rows (rank, rank + cluster, ...) of both tiles, summed
    // over the cluster's blocks in rank order, four columns a thread
    const int rank = (int)cl.block_rank();
    const int nr = (BK - rank + cluster - 1) / cluster;
    for (int i = threadIdx.x; i < 2 * nr * (HDP / 4); i += THREADS) {
      const int t = i / (nr * (HDP / 4)), e = i % (nr * (HDP / 4));
      const int row = rank + cluster * (e / (HDP / 4)), col = 4 * (e % (HDP / 4));
      if (k0 + row >= Sk || col >= hd) continue;
      const int off = at(t * BK + row, col);   // four columns stay side by side
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int g = 0; g < cluster; ++g) {
        const float4 p = *reinterpret_cast<const float4*>(cl.map_shared_rank(red, g) + off);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      bf16* dst = (t ? dv : dk) + koff + row * k_stride;
      store_pair<VEC>(dst, col, hd, sum.x, sum.y);
      store_pair<VEC>(dst, col + 2, hd, sum.z, sum.w);
    }
    cl.sync();           // no block leaves while another reads its shared memory
  } else {
    bf16* k_row0 = dk + koff + lr0 * k_stride;
    bf16* k_row1 = dk + koff + lr1 * k_stride;
    bf16* v_row0 = dv + koff + lr0 * k_stride;
    bf16* v_row1 = dv + koff + lr1 * k_stride;
#pragma unroll
    for (int x = 0; x < NO; x += 4) {
      const int col = 8 * (x / 4) + c0;
      if (key0 < Sk) {
        store_pair<VEC>(k_row0, col, hd, adk[x] * scale, adk[x + 1] * scale);
        store_pair<VEC>(v_row0, col, hd, adv[x], adv[x + 1]);
      }
      if (key1 < Sk) {
        store_pair<VEC>(k_row1, col, hd, adk[x + 2] * scale, adk[x + 3] * scale);
        store_pair<VEC>(v_row1, col, hd, adv[x + 2], adv[x + 3]);
      }
    }
  }
}

template <int HDP, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, void* dq, void* dk, void* dv, const float* stats,
                   float* scratch, int B, int Sq, int Sk, int H, int Hk, int hd, float scale,
                   int causal, int window, int device, cudaStream_t stream) {
  auto k1 = flash_attention_bwd_dq_wgmma_bf16<HDP, VEC>;
  auto k2 = flash_attention_bwd_dkdv_wgmma_bf16<HDP, VEC>;
  constexpr size_t smem = smem_bytes<HDP>();
  // the kernels' shared-memory limit, set once a device
  static std::atomic<bool> ready[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaError_t e = cudaSuccess;
  if (!ready[device].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    ready[device].store(true, std::memory_order_relaxed);
  }
  // kernel 2's clusters: the largest divisor of the group up to MAX_CLUSTER
  // blocks, each taking group / cluster q-heads
  const int group = H / Hk;
  int cluster = std::min(group, MAX_CLUSTER);
  while (group % cluster) --cluster;
  const int heads = group / cluster;
  const long long blocks1 = (long long)((Sq + BQ - 1) / BQ) * H * B;
  const long long blocks2 = (long long)((Sk + BK - 1) / BK) * (H / heads) * B;
  if (blocks1 > 0x7fffffffLL || blocks2 > 0x7fffffffLL) return cudaErrorInvalidValue;
  float4* rows = reinterpret_cast<float4*>(scratch);          // [B, H, Sq]
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const float scale_log2 = scale * LOG2E;
  k1<<<(unsigned)blocks1, THREADS, smem, stream>>>(
      qb, kb, vb, static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), stats, rows, B, Sq, Sk, H, Hk, hd, scale, scale_log2, causal,
      window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks2);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k2, qb, kb, vb, static_cast<const bf16*>(dout),
                         static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                         static_cast<const float4*>(rows), B, Sq, Sk, H, Hk, hd, scale,
                         scale_log2, causal, window, heads);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* out,
                     const void* dout, void* dq, void* dk, void* dv, const float* stats,
                     float* scratch, int B, int Sq, int Sk, int H, int Hk, int hd, float scale,
                     int causal, int window, int device, cudaStream_t s) {
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  const bool vec = hd % 8 == 0 && addr_bits % 16 == 0;
  if (hd <= 64)
    return vec ? launch<64, true>(q, k, v, out, dout, dq, dk, dv, stats, scratch, B, Sq, Sk,
                                  H, Hk, hd, scale, causal, window, device, s)
               : launch<64, false>(q, k, v, out, dout, dq, dk, dv, stats, scratch, B, Sq, Sk,
                                   H, Hk, hd, scale, causal, window, device, s);
  return vec ? launch<128, true>(q, k, v, out, dout, dq, dk, dv, stats, scratch, B, Sq, Sk,
                                 H, Hk, hd, scale, causal, window, device, s)
             : launch<128, false>(q, k, v, out, dout, dq, dk, dv, stats, scratch, B, Sq, Sk,
                                  H, Hk, hd, scale, causal, window, device, s);
}

}  // namespace tc

}  // namespace

extern "C" {

// q/out/dout/dq [B, Sq, H, hd], k/v/dk/dv [B, Sk, Hk, hd], all contiguous, of
// one type, on `device`; two launches on `stream`.  dtype 0 = f32 (SIMT):
// stats null, scratch 3 * B * H * Sq f32.  dtype 1 = bf16 (tensor cores):
// stats the forward's m and l (2 * B * H * Sq f32, flash_attention.cu),
// scratch 4 * B * H * Sq f32.  Needs 1 <= hd <= 128, H % Hk == 0.  Returns
// the CUDA error code (0 = ok).
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, void* dq, void* dk, void* dv,
                              const void* stats, void* scratch, int dtype, long long B,
                              long long Sq, long long Sk, long long H, long long Hk,
                              long long hd, float scale, int causal, int window, int device,
                              void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is this call's
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || Sq <= 0) return cudaSuccess;
  if (Sk <= 0 || Sq > 0x7fffffffLL || Sk > 0x7fffffffLL || hd <= 0 || hd > 128 || Hk <= 0 ||
      H % Hk != 0 || H > 65535 || Hk > 65535 || B > 65535 || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0 && stats == nullptr)
    return simt::dispatch<float>(q, k, v, out, dout, dq, dk, dv, sc, (int)B, (int)Sq, (int)Sk,
                                 (int)H, (int)Hk, (int)hd, scale, causal, window, s);
  if (dtype == 1 && stats != nullptr)
    return tc::dispatch(q, k, v, out, dout, dq, dk, dv, static_cast<const float*>(stats), sc,
                        (int)B, (int)Sq, (int)Sk, (int)H, (int)Hk, (int)hd, scale, causal,
                        window, device, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
