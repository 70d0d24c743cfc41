// Flash-decoding: one new query token per sequence against its KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _kernel): a sequential (batch, q-head, kv-block)
// grid that carries the row max m, row sum l and the f32 accumulator in VMEM
// scratch across kv-blocks and masks k_pos <= lens[b].  That grid streams
// each kv-head's cache once per q-head that reads it, H / Hk times.
//
// Contract (kernels/ref.py::decode_attention_ref): row b attends to cache
// positions 0..lens[b] among the S that exist (lens[b] >= S means all S);
// window > 0 also requires lens[b] - k_pos < window.  Scores q.k * scale in
// f32, masked ones at the finite NEG_INF = -1e30; p rounded to the input type
// before the PV product, l summing the unrounded p; out = acc / max(l,
// 1e-30), rounded to the input type.  A row that no key may see (only with a
// window, or lens[b] < 0) gets the contract's uniform average over all S
// positions.  f32 inputs stay IEEE f32 throughout.
//
// What bounds it on an H100: it reads each attended K/V row once and does 4
// flops per (q-head, key, dim): at q [32,1,24,128], k/v [32,1024,8,128] bf16
// that is ~134 MB against ~0.1 GFLOP, so it is bound by bytes.
//
// Design: one block of 128 threads per (split of the sequence, kv-head, up
// to GMAX <= 8 q-heads of that kv-head, batch row), so each K/V row crosses device
// memory once per step for all the q-heads that read it.  A block walks
// 128-row tiles of its split: the rows it must visit (those in
// [lo, hi] = [max(0, lens - window + 1), min(lens, S - 1)]) are staged in
// shared memory with 16-byte loads straight from the strided [B, S, Hk, hd]
// layout, never a padded copy (V by cp.async, landing while the QK step
// runs); a tile wholly outside [lo, hi] is never read.
// Thread r owns key row r of the tile for the QK products (K rows padded by
// one 32-bit word, so the 32 lanes of a warp hit 32 banks), the block reduces
// the tile's max and sum per q-head, and then each thread owns GMAX * HDP /
// 128 output columns of the PV product.  When the batch rows and kv-heads
// alone give an SM fewer than three blocks (the most that fit beside each
// other in shared memory in bf16 at hd 128), the wrapper splits each row's
// visited tiles over `splits` blocks; a second small kernel merges their
// (m, l, acc).  The
// products run on the SIMT f32 pipes: at one query row per head there is no
// tile shape the tensor cores would fill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;    // = BK: one key row per thread in the QK step
constexpr int BK = THREADS;     // key rows per staged tile
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOWEST = -3.0e38f;   // below NEG_INF: a row the tile does not visit

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

// elements d, d+1 of a K row in shared memory, as f32
__device__ __forceinline__ float2 pair(const float* row, int d) {
  return make_float2(row[d], row[d + 1]);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* row, int d) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + d));
}

template <typename T, int HDP>
struct Layout {
  static constexpr int KS = HDP + 4 / (int)sizeof(T);   // K row stride: one word of pad
  static constexpr int CH = 16 / (int)sizeof(T);        // elements per 16-byte chunk
  static constexpr size_t k_bytes = sizeof(T) * BK * KS;
  static constexpr size_t v_bytes = sizeof(T) * BK * HDP;
};

template <int GMAX, int HDP>
constexpr size_t f32_smem_floats() {
  return GMAX * HDP          // q
         + GMAX * BK         // p of the tile
         + 2 * GMAX * WARPS; // per-warp max and sum
}

template <typename T, int GMAX, int HDP>
constexpr size_t smem_bytes() {
  return Layout<T, HDP>::k_bytes + Layout<T, HDP>::v_bytes +
         sizeof(float) * f32_smem_floats<GMAX, HDP>();
}

// a[g] for a g known only at run time, without sending `a` to local memory
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int g) {
  float x = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (i == g) x = a[i];
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Stage rows [r0, r1] of the tile starting at key k0 (K padded, V dense);
// columns hd..HDP-1 are zero so the fixed-length loops below stay exact.
// With 16-byte loads, V goes by cp.async (complete only after
// cp_async_wait_all, so it lands while the QK step runs) and K through
// registers, UNROLL chunks in flight per thread: its padded rows are not
// 16-byte aligned in shared memory, which cp.async needs.
template <typename T, int HDP>
__device__ __forceinline__ void stage(T* Ks, T* Vs, const T* kb, const T* vb,
                                      long long row_stride, int k0, int r0, int r1,
                                      int hd, bool vec) {
  using Lay = Layout<T, HDP>;
  const int nrows = r1 - r0 + 1;
  if (vec) {
    constexpr int CPR = HDP / Lay::CH;   // chunks per padded row
    constexpr int UNROLL = 8;
    const int n = nrows * CPR;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int r = r0 + i / CPR, c = (i % CPR) * Lay::CH;
      T* dst = Vs + r * HDP + c;
      if (c < hd)
        cp_async16(dst, vb + (long long)(k0 + r) * row_stride + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    for (int base = threadIdx.x; base < n; base += THREADS * UNROLL) {
      uint4 kx[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        const int r = r0 + i / CPR, c = (i % CPR) * Lay::CH;
        kx[u] = make_uint4(0, 0, 0, 0);
        if (i < n && c < hd)
          kx[u] = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * row_stride + c);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i >= n) break;
        const int r = r0 + i / CPR, c = (i % CPR) * Lay::CH;
        uint32_t* kw = reinterpret_cast<uint32_t*>(Ks + r * Lay::KS + c);
        kw[0] = kx[u].x; kw[1] = kx[u].y; kw[2] = kx[u].z; kw[3] = kx[u].w;
      }
    }
  } else {
    for (int i = threadIdx.x; i < nrows * HDP; i += THREADS) {
      const int r = r0 + i / HDP, d = i % HDP;
      T kx = from_f<T>(0.f), vx = from_f<T>(0.f);
      if (d < hd) {
        const long long off = (long long)(k0 + r) * row_stride + d;
        kx = kb[off];
        vx = vb[off];
      }
      Ks[r * Lay::KS + d] = kx;
      Vs[r * HDP + d] = vx;
    }
  }
}

template <typename T, int GMAX, int HDP>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lens,
                        T* __restrict__ out, float* __restrict__ part,
                        int S, int H, int Hk, int hd, int G, int hchunks, float scale,
                        int window, int splits, bool vec) {
  using Lay = Layout<T, HDP>;
  constexpr int OUT = (GMAX * HDP + THREADS - 1) / THREADS;   // outputs per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);                           // [BK][KS]
  T* Vs = reinterpret_cast<T*>(smem_raw + Lay::k_bytes);            // [BK][HDP]
  float* Qs = reinterpret_cast<float*>(smem_raw + Lay::k_bytes + Lay::v_bytes);  // [GMAX][HDP]
  float* Ps = Qs + GMAX * HDP;                                      // [GMAX][BK]
  float* red_m = Ps + GMAX * BK;                                    // [GMAX][WARPS]
  float* red_l = red_m + GMAX * WARPS;                              // [GMAX][WARPS]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x;
  const int hkv = blockIdx.y / hchunks;
  const int g0 = (blockIdx.y % hchunks) * GMAX;        // first q-head of this block
  const int gc = min(GMAX, G - g0);                    // q-heads this block owns
  const int b = blockIdx.z;
  const int h0 = hkv * G + g0;
  const long long row_stride = (long long)Hk * hd;     // between sequence positions
  const T* kb = k + ((long long)b * S * Hk + hkv) * hd;
  const T* vb = v + ((long long)b * S * Hk + hkv) * hd;

  // the rows this batch row visits; none visible -> all S, every score masked
  const int len = lens[b];
  int lo = window > 0 ? max(0, len - window + 1) : 0;
  int hi = min(len, S - 1);
  const bool empty = lo > hi;
  if (empty) { lo = 0; hi = S - 1; }
  const int t_lo = lo / BK, n_t = hi / BK - t_lo + 1;
  const int per = (n_t + splits - 1) / splits;
  const int ts = t_lo + split * per, te = min(t_lo + n_t, ts + per);   // [ts, te)

  for (int i = tid; i < GMAX * HDP; i += THREADS) {
    const int g = i / HDP, d = i % HDP;
    Qs[i] = (g < gc && d < hd) ? to_f(q[((long long)b * H + h0 + g) * hd + d]) : 0.f;
  }

  float m[GMAX], l[GMAX], acc[OUT];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) { m[g] = NEG_INF; l[g] = 0.f; }
#pragma unroll
  for (int o = 0; o < OUT; ++o) acc[o] = 0.f;

  for (int t = ts; t < te; ++t) {
    const int k0 = t * BK;
    const int r0 = max(lo, k0) - k0, r1 = min(hi, k0 + BK - 1) - k0;   // rows to visit
    __syncthreads();   // the previous tile's reads of Ks/Vs/Ps are done (and Qs is set)
    stage<T, HDP>(Ks, Vs, kb, vb, row_stride, k0, r0, r1, hd, vec);
    __syncthreads();

    const bool vis = tid >= r0 && tid <= r1;
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    if (vis) {
      const T* kr = Ks + tid * Lay::KS;
      float s1[GMAX];   // odd columns: two chains of FMAs per head, not one
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s1[g] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HDP; d += 2) {
        const float2 kk = pair(kr, d);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          const float2 qq = *reinterpret_cast<const float2*>(&Qs[g * HDP + d]);
          s[g] = fmaf(qq.x, kk.x, s[g]);
          s1[g] = fmaf(qq.y, kk.y, s1[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] += s1[g];
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      s[g] = empty ? NEG_INF : s[g] * scale;
      float mt = vis ? s[g] : LOWEST;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      if (lane == 0) red_m[g * WARPS + warp] = mt;
    }
    __syncthreads();

    float alpha[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float mt = red_m[g * WARPS];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) mt = fmaxf(mt, red_m[g * WARPS + w]);
      const float m_new = fmaxf(m[g], mt);   // finite: every tile visits a row
      alpha[g] = expf(m[g] - m_new);
      m[g] = m_new;
      const float p = vis ? expf(s[g] - m_new) : 0.f;
      Ps[g * BK + tid] = round_to<T>(p);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      if (lane == 0) red_l[g * WARPS + warp] = ps;
    }
    cp_async_wait_all();   // this thread's V copies; the barrier publishes all
    __syncthreads();

#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float lt = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) lt += red_l[g * WARPS + w];
      l[g] = l[g] * alpha[g] + lt;
    }
    // rows outer, this thread's outputs inner, two partial sums each: the
    // FMAs of one output form two interleaved chains, not one of 128 links
    float a0[OUT], a1[OUT];
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
      const int j = tid + o * THREADS;
      a0[o] = j < GMAX * HDP ? acc[o] * pick(alpha, j / HDP) : 0.f;
      a1[o] = 0.f;
    }
    int r = r0;
    for (; r + 1 <= r1; r += 2) {
#pragma unroll
      for (int o = 0; o < OUT; ++o) {
        const int j = tid + o * THREADS;
        if (j >= GMAX * HDP) break;
        const float* pp = Ps + (j / HDP) * BK + r;
        const T* vv = Vs + r * HDP + j % HDP;
        a0[o] = fmaf(pp[0], to_f(vv[0]), a0[o]);
        a1[o] = fmaf(pp[1], to_f(vv[HDP]), a1[o]);
      }
    }
    if (r <= r1) {
#pragma unroll
      for (int o = 0; o < OUT; ++o) {
        const int j = tid + o * THREADS;
        if (j >= GMAX * HDP) break;
        a0[o] = fmaf(Ps[(j / HDP) * BK + r], to_f(Vs[r * HDP + j % HDP]), a0[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < OUT; ++o) acc[o] = a0[o] + a1[o];
  }

#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    const int j = tid + o * THREADS;
    if (j >= GMAX * HDP) break;
    const int g = j / HDP, d = j % HDP;
    if (g >= gc || d >= hd) continue;
    const float lg = pick(l, g), mg = pick(m, g);
    const long long row = (long long)b * H + h0 + g;   // [B, 1, H] flattened
    if (splits == 1) {
      out[row * hd + d] = from_f<T>(acc[o] / fmaxf(lg, 1e-30f));
    } else {
      float* pr = part + (row * splits + split) * (hd + 2);
      pr[2 + d] = acc[o];
      if (d == 0) { pr[0] = mg; pr[1] = lg; }
    }
  }
}

// Merge the splits' (m, l, acc) of one (batch row, q-head) per block.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                               int hd, int splits) {
  const long long row = blockIdx.x;
  const float* pr = part + row * splits * (hd + 2);
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, pr[s * (hd + 2)]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float l = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ps = pr + s * (hd + 2);
      const float w = expf(ps[0] - mx);
      l = fmaf(w, ps[1], l);
      a = fmaf(w, ps[2 + d], a);
    }
    out[row * hd + d] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int GMAX, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lens, void* out,
                   float* part, int B, int S, int H, int Hk, int hd, float scale,
                   int window, int splits, bool vec, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, GMAX, HDP>;
  constexpr size_t smem = smem_bytes<T, GMAX, HDP>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int G = H / Hk;
  const int hchunks = (G + GMAX - 1) / GMAX;
  dim3 grid((unsigned)splits, (unsigned)(Hk * hchunks), (unsigned)B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens,
      static_cast<T*>(out), part, S, H, Hk, hd, G, hchunks, scale, window, splits, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  combine_kernel<T><<<(unsigned)(B * H), 128, 0, stream>>>(part, static_cast<T*>(out),
                                                         hd, splits);
  return cudaGetLastError();
}

template <typename T, int GMAX>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const int* lens,
                        void* out, float* part, int B, int S, int H, int Hk, int hd,
                        float scale, int window, int splits, bool vec, cudaStream_t s) {
  if (hd <= 16)
    return launch<T, GMAX, 16>(q, k, v, lens, out, part, B, S, H, Hk, hd, scale, window,
                               splits, vec, s);
  if (hd <= 64)   // hd 17..64 in one variant: fewer instantiations, a shorter build
    return launch<T, GMAX, 64>(q, k, v, lens, out, part, B, S, H, Hk, hd, scale, window,
                               splits, vec, s);
  return launch<T, GMAX, 128>(q, k, v, lens, out, part, B, S, H, Hk, hd, scale, window,
                              splits, vec, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int* lens,
                     void* out, float* part, int B, int S, int H, int Hk, int hd,
                     float scale, int window, int splits, bool vec, cudaStream_t s) {
  const int G = H / Hk;   // q-heads per kv-head; a block takes up to 8 of them
  if (G == 1)
    return dispatch_hd<T, 1>(q, k, v, lens, out, part, B, S, H, Hk, hd, scale, window,
                             splits, vec, s);
  if (G == 2)
    return dispatch_hd<T, 2>(q, k, v, lens, out, part, B, S, H, Hk, hd, scale, window,
                             splits, vec, s);
  if (G == 3)   // llama3.2-3b: 24 q-heads over 8 kv-heads
    return dispatch_hd<T, 3>(q, k, v, lens, out, part, B, S, H, Hk, hd, scale, window,
                             splits, vec, s);
  if (G <= 4)
    return dispatch_hd<T, 4>(q, k, v, lens, out, part, B, S, H, Hk, hd, scale, window,
                             splits, vec, s);
  return dispatch_hd<T, 8>(q, k, v, lens, out, part, B, S, H, Hk, hd, scale, window,
                           splits, vec, s);
}

}  // namespace

extern "C" {

// q [B, 1, H, hd], k/v [B, S, Hk, hd], out [B, 1, H, hd], all contiguous and
// of one type (dtype 0 = f32, 1 = bf16); lens [B] int32; part: f32 scratch
// of B * H * splits * (hd + 2) floats when splits > 1 (else unused); all on
// `device`; launches on `stream`.  vec = 1 when hd * element size is a
// multiple of 16 bytes and k, v are 16-byte aligned.  Needs 1 <= hd <= 128,
// H % Hk == 0, S >= 1, window >= 0, splits >= 1.  Returns the CUDA error
// code (0 = ok).
int repro_decode_attention(const void* q, const void* k, const void* v, const void* lens,
                           void* out, void* part, int dtype, long long B, long long S,
                           long long H, long long Hk, long long hd, float scale,
                           int window, int splits, int vec, int device, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is this launch's
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0) return cudaSuccess;
  if (S <= 0 || S > 0x7fffffffLL || hd <= 0 || hd > 128 || Hk <= 0 || H % Hk != 0 ||
      Hk * ((H / Hk + 7) / 8) > 65535 || B > 65535 || window < 0 || splits < 1 ||
      splits > 65535 || (splits > 1 && part == nullptr) || B * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  float* pt = static_cast<float*>(part);
  if (dtype == 0)
    return dispatch<float>(q, k, v, ln, out, pt, (int)B, (int)S, (int)H, (int)Hk, (int)hd,
                           scale, window, splits, vec != 0, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, ln, out, pt, (int)B, (int)S, (int)H, (int)Hk,
                                   (int)hd, scale, window, splits, vec != 0, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
