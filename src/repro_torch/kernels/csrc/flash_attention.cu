// GQA flash attention with an online softmax, causal and/or sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _kernel): a sequential (batch, q-head, q-block, kv-block) grid whose
// innermost kv-block steps carry the row max m, row sum l and the f32
// accumulator in VMEM scratch; q-head h reads kv-head h // (H/Hk) through the
// BlockSpec index maps, so the repeated KV is never materialised.
//
// Contract (kernels/ref.py::flash_attention_ref): scores q.k * scale in f32;
// masks compare absolute positions from 0 on both axes (q_pos >= k_pos when
// causal, q_pos - k_pos < window when windowed); a masked score is the finite
// NEG_INF = -1e30, never -inf; probabilities are rounded to the input type
// before the PV product; out = acc / max(l, 1e-30), rounded to the input type.
// f32 inputs stay IEEE f32 throughout (no TF32).
//
// What bounds it on an H100: at the oracle's shape (q [32,512,24,128], kv
// heads 8, causal) it does ~2*2*B*H*Sq*Sk*hd/2 = 52 GFLOP on 0.2 GB, so it is
// bound by operations.  This first kernel computes both products on the SIMT
// f32 pipes (its ceiling is the non-tensor f32 rate, not the bf16 tensor
// cores); an mma/wgmma form is later work.
//
// Design: one block of 256 threads per (64-row q tile, q-head, batch).  The
// Q tile is staged once in shared memory (transposed, f32).  The K and V
// tiles of kv-head h / group, 32 rows at a time, are staged in f32 from the
// strided [B, S, Hk, hd] layout: no repeated or padded copy exists in device
// memory.  Each thread owns 4 q rows x 2 key columns of the score tile and 4
// q rows x HDP/16 output columns of the accumulator; a row's max and sum
// reduce over the 16 threads that share it with warp shuffles.  Tiles that
// lie wholly above the causal diagonal or before the window are skipped,
// unless the q tile holds a row that no key may see (only when Sq >= Sk +
// window): then every tile is visited so that such a row gets the
// reference's uniform softmax over the masked scores.  Ragged Sq, Sk and hd
// are masked on load; keys at k_pos >= Sk get no weight at all.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 32;          // key rows per staged tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int LDQ = BQ + 4;     // Qs row stride: float4 reads of 4 q rows
constexpr int LDK = BK + 1;     // Ks row stride: conflict-free transposed stores
constexpr int LDP = BQ + 4;     // Ps row stride
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// p rounded to the input type, as the reference casts p before the PV product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (HDP * LDQ + HDP * LDK + BK * HDP + BK * LDP);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int Sq, int Sk, int H, int Hk, int hd, float scale,
                       int causal, int window) {
  constexpr int CN = HDP / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [HDP][LDQ]  Q tile, transposed
  float* Ks = Qs + HDP * LDQ;    // [HDP][LDK]  K tile, transposed
  float* Vs = Ks + HDP * LDK;    // [BK][HDP]
  float* Ps = Vs + BK * HDP;     // [BK][LDP]   P tile, transposed

  const int tid = threadIdx.x;
  const int tx = tid % 16;       // key column / output column group
  const int ty = tid / 16;       // q row group: rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h / (H / Hk);
  const long long q_stride = (long long)H * hd;    // between sequence positions
  const long long k_stride = (long long)Hk * hd;
  const T* qb = q + ((long long)b * Sq * H + h) * hd;
  const T* kb = k + ((long long)b * Sk * Hk + hkv) * hd;
  const T* vb = v + ((long long)b * Sk * Hk + hkv) * hd;
  T* ob = out + ((long long)b * Sq * H + h) * hd;

  for (int i = tid; i < BQ * HDP; i += THREADS) {
    const int r = i / HDP, d = i % HDP;
    const int pos = q0 + r;
    Qs[d * LDQ + r] = (pos < Sq && d < hd) ? to_f(qb[pos * q_stride + d]) : 0.f;
  }

  // the key tiles this q tile must visit
  const int q_last = min(q0 + BQ, Sq) - 1;
  const bool empty_row = window > 0 && q_last >= Sk + window - 1;
  int kv_lo = 0, kv_hi = Sk;
  if (!empty_row) {
    if (window > 0) kv_lo = max(0, q0 - window + 1) / BK * BK;
    if (causal) kv_hi = min(Sk, q_last + 1);
  }

  float m[4], l[4], acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();   // the previous tile's Ks/Vs/Ps reads are done
    for (int i = tid; i < BK * HDP; i += THREADS) {
      const int r = i / HDP, d = i % HDP;
      const int pos = k0 + r;
      const bool ok = pos < Sk && d < hd;
      Ks[d * LDK + r] = ok ? to_f(kb[pos * k_stride + d]) : 0.f;
      Vs[r * HDP + d] = ok ? to_f(vb[pos * k_stride + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty*4+i, key columns tx and tx+16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < HDP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * LDQ + ty * 4]);
      const float b0 = Ks[d * LDK + tx], b1 = Ks[d * LDK + tx + 16];
      s[0][0] = fmaf(a.x, b0, s[0][0]); s[0][1] = fmaf(a.x, b1, s[0][1]);
      s[1][0] = fmaf(a.y, b0, s[1][0]); s[1][1] = fmaf(a.y, b1, s[1][1]);
      s[2][0] = fmaf(a.z, b0, s[2][0]); s[2][1] = fmaf(a.z, b1, s[2][1]);
      s[3][0] = fmaf(a.w, b0, s[3][0]); s[3][1] = fmaf(a.w, b1, s[3][1]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool in_range[2];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + tx + 16 * j;
        in_range[j] = kp < Sk;
        bool keep = true;
        if (causal) keep = qp >= kp;
        if (window > 0) keep = keep && (qp - kp < window);
        s[i][j] = keep ? s[i][j] * scale : NEG_INF;
        if (in_range[j]) mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = in_range[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(tx + 16 * j) * LDP + ty * 4 + i] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[c * LDP + ty * 4]);
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float vv = Vs[c * HDP + tx + 16 * j];
        acc[0][j] = fmaf(p.x, vv, acc[0][j]);
        acc[1][j] = fmaf(p.y, vv, acc[1][j]);
        acc[2][j] = fmaf(p.z, vv, acc[2][j]);
        acc[3][j] = fmaf(p.w, vv, acc[3][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) ob[qp * q_stride + d] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int Sq, int Sk, int H, int Hk, int hd, float scale, int causal,
                   int window, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, HDP>;
  constexpr size_t smem = smem_bytes<HDP>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, Hk, hd, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* out, int B,
                        int Sq, int Sk, int H, int Hk, int hd, float scale, int causal,
                        int window, cudaStream_t stream) {
  if (hd <= 16)
    return launch<T, 16>(q, k, v, out, B, Sq, Sk, H, Hk, hd, scale, causal, window, stream);
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, Hk, hd, scale, causal, window, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, Hk, hd, scale, causal, window, stream);
  return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, Hk, hd, scale, causal, window, stream);
}

}  // namespace

extern "C" {

// q [B, Sq, H, hd], k/v [B, Sk, Hk, hd], out [B, Sq, H, hd], all contiguous,
// of one type (dtype 0 = f32, 1 = bf16), on `device`; launches on `stream`.
// Needs 1 <= hd <= 128, H % Hk == 0.  Returns the CUDA error code (0 = ok).
int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                          int dtype, long long B, long long Sq, long long Sk,
                          long long H, long long Hk, long long hd, float scale,
                          int causal, int window, int device, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is this launch's
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || Sq <= 0) return cudaSuccess;
  if (Sk <= 0 || Sq > 0x7fffffffLL || Sk > 0x7fffffffLL || hd <= 0 || hd > 128 ||
      Hk <= 0 || H % Hk != 0 || H > 65535 || B > 65535 || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, (int)B, (int)Sq, (int)Sk, (int)H, (int)Hk,
                              (int)hd, scale, causal, window, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, (int)B, (int)Sq, (int)Sk, (int)H,
                                      (int)Hk, (int)hd, scale, causal, window, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
