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
// outputs, 0.0100 ms at 3.35 TB/s: bytes bound it, by a little.  This first
// kernel keeps every product on the SIMT f32 pipes (67 TFLOP/s peak, and
// here less: the products read both operands from shared memory), plus the
// recomputed scores of the statistics pass, so it is far from that bound.
// Making it fast (mma.sync or wgmma on bf16 operands) is later work.
//
// Design, simple and deterministic:
// - The forward saves only q, k, v and out.  Kernel 1 (flash_attention_bwd_dq)
//   takes one 64-row q tile of one q-head: it computes D from dO and O,
//   recomputes each row's max m and sum l over the visible key tiles (online,
//   as the forward), then walks the key tiles again for dS and dQ.  It
//   writes m, l and D for kernel 2.
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

namespace {

constexpr float NEG_INF = -1e30f;
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

}  // namespace

extern "C" {

// q/out/dout/dq [B, Sq, H, hd], k/v/dk/dv [B, Sk, Hk, hd], all contiguous, of
// one type (dtype 0 = f32, 1 = bf16), on `device`; stats is 3 * B * H * Sq f32
// scratch.  Two launches on `stream`.  Needs 1 <= hd <= 128, H % Hk == 0.
// Returns the CUDA error code (0 = ok).
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, void* dq, void* dk, void* dv, void* stats,
                              int dtype, long long B, long long Sq, long long Sk, long long H,
                              long long Hk, long long hd, float scale, int causal, int window,
                              int device, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is this call's
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || Sq <= 0) return cudaSuccess;
  if (Sk <= 0 || Sq > 0x7fffffffLL || Sk > 0x7fffffffLL || hd <= 0 || hd > 128 || Hk <= 0 ||
      H % Hk != 0 || H > 65535 || Hk > 65535 || B > 65535 || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, dout, dq, dk, dv, st, (int)B, (int)Sq, (int)Sk,
                           (int)H, (int)Hk, (int)hd, scale, causal, window, s);
  if (dtype == 1)
    return dispatch<bf16>(q, k, v, out, dout, dq, dk, dv, st, (int)B, (int)Sq, (int)Sk,
                          (int)H, (int)Hk, (int)hd, scale, causal, window, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
