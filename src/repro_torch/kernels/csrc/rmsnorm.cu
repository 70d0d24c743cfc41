// Fused RMSNorm: out = x * rsqrt(mean(x^2) + eps) * scale, in f32, rounded
// to the type of x.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm (body
// _kernel): 256-row blocks with the whole feature dim in VMEM, the square /
// mean / rsqrt / scale fused into one pass over HBM.
//
// Contract (kernels/ref.py::rmsnorm_ref): xf = f32(x); var = mean(xf^2);
// out = (xf * rsqrt(var + eps)) * f32(scale), rounded to the type of x.
//
// What bounds it on an H100: one read of x and one write of out at ~2
// operations per byte, so bytes: at x [16384, 3072] bf16, 201 MB.
//
// Design, where a row's 16-byte chunks fit in the registers of one block
// (d a multiple of 8 bf16 / 4 f32 values, at most 128 threads x MAX_NC
// chunks: 8192 bf16 or 4096 f32 values) and x and out are 16-byte aligned:
// - Persistent blocks of 128 threads, a few per SM, each walking rows
//   blockIdx.x, + gridDim.x, ...  A block reads scale once, by 16-byte loads,
//   into shared memory, in halves of 4 values per chunk so that the lanes
//   read it back conflict-free.
// - A thread holds NC chunks of a row in registers: it issues every load of
//   the next row before it reduces the current one, so two rows are in
//   flight and device memory sees x exactly once.  The sum of squares
//   reduces over the warp with shuffles and over the 4 warps through shared
//   memory behind one barrier a row (two slots, by row parity, so that a warp
//   that runs ahead never overwrites a sum still being read).
// - Wider or unaligned rows take the two-pass fallback: one warp per row,
//   16-byte loads where the row allows, else one value at a time; its
//   second pass re-reads the row from L1/L2.
// - The grid's size (SMs x blocks an SM) is worked out once a device.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int RT = 128;              // threads of a row block
constexpr int RWARPS = RT / 32;
constexpr int MAX_NC = 8;            // 16-byte chunks a thread holds of one row
constexpr int BLOCKS_PER_SM = 8;     // at most, of the register path (4 read 7% slower)
constexpr int MAX_DEVICES = 64;
constexpr int WARPS = 8;             // rows of a fallback block, one a warp
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// ---------------------------------------------------------------------------
// the register path
// ---------------------------------------------------------------------------

// a 16-byte chunk as f32 values, and back
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int NC>
__device__ __forceinline__ void load_row(const T* x, long long row, int d, int nch,
                                         uint4 (&buf)[NC]) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int i = threadIdx.x + j * RT;
    if (i < nch) buf[j] = __ldcs(xr + i);   // read once: stream it through L2
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(RT)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ out, long long n, int d, float eps, bool scale_vec) {
  constexpr int CH = 16 / (int)sizeof(T);   // values per chunk
  constexpr int HALVES = CH / 4;            // float4s of scale per chunk
  extern __shared__ float4 sc[];            // [HALVES][nch] float4s of scale
  __shared__ float red[2][RWARPS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nch = d / CH;

  if (scale_vec) {
    const float4* s4 = reinterpret_cast<const float4*>(scale);
    for (int i = tid; i < d / 4; i += RT) sc[(i % HALVES) * nch + i / HALVES] = s4[i];
  } else {
    float* s = reinterpret_cast<float*>(sc);
    for (int e = tid; e < d; e += RT) {
      const int w = e % CH;
      s[((w / 4) * nch + e / CH) * 4 + w % 4] = scale[e];
    }
  }

  long long row = blockIdx.x;               // the grid never exceeds n
  uint4 cur[NC], nxt[NC];
  load_row<T, NC>(x, row, d, nch, cur);
  for (int par = 0; row < n; row += gridDim.x, par ^= 1) {
    const long long next = row + gridDim.x;
    if (next < n) load_row<T, NC>(x, next, d, nch, nxt);   // in flight while this row reduces

    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (tid + j * RT < nch) {
        float f[CH];
        unpack(cur[j], f);
#pragma unroll
        for (int e = 0; e < CH; ++e) ss = fmaf(f[e], f[e], ss);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) red[par][warp] = ss;
    __syncthreads();   // also publishes scale, before the first row uses it
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < RWARPS; ++w) tot += red[par][w];
    const float r = 1.f / sqrtf(tot / (float)d + eps);

    uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int i = tid + j * RT;
      if (i < nch) {
        float f[CH], s[CH];
        unpack(cur[j], f);
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
          const float4 s4 = sc[h * nch + i];
          s[4 * h] = s4.x; s[4 * h + 1] = s4.y; s[4 * h + 2] = s4.z; s[4 * h + 3] = s4.w;
        }
#pragma unroll
        for (int e = 0; e < CH; ++e) f[e] = f[e] * r * s[e];
        __stcs(orow + i, pack(f));
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) cur[j] = nxt[j];
  }
}

// ---------------------------------------------------------------------------
// the two-pass fallback: one warp per row
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
rmsnorm_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ out, long long n, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n) return;
  const Pack<T, VEC>* xr = reinterpret_cast<const Pack<T, VEC>*>(x + row * d);
  Pack<T, VEC>* orow = reinterpret_cast<Pack<T, VEC>*>(out + row * d);
  const int nv = d / VEC;

  float ss = 0.f;
  for (int i = lane; i < nv; i += 32) {
    const Pack<T, VEC> a = xr[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f(a.v[e]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = 1.f / sqrtf(ss / (float)d + eps);

  for (int i = lane; i < nv; i += 32) {
    const Pack<T, VEC> a = xr[i];
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.v[e] = from_f<T>(to_f(a.v[e]) * r * scale[i * VEC + e]);
    orow[i] = o;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Blocks of the register path for NC chunks a thread that fit on one SM at
// once, worked out once a device (0 until then).
template <typename T, int NC>
cudaError_t resident_per_sm(int device, int* per_sm, int* sms) {
  static std::atomic<int> cached_per_sm[MAX_DEVICES], cached_sms[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  *per_sm = cached_per_sm[device].load(std::memory_order_relaxed);
  *sms = cached_sms[device].load(std::memory_order_relaxed);
  if (*per_sm > 0 && *sms > 0) return cudaSuccess;
  const size_t smem = sizeof(float) * NC * RT * (16 / sizeof(T));   // scale at the widest d
  cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, rmsnorm_rows_kernel<T, NC>, RT,
                                                      smem);
  if (e != cudaSuccess) return e;
  *per_sm = std::max(1, *per_sm);
  cached_per_sm[device].store(*per_sm, std::memory_order_relaxed);
  cached_sms[device].store(*sms, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename T, int NC>
cudaError_t launch_rows(const T* x, const float* scale, T* out, long long n, int d,
                        float eps, int device, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t e = resident_per_sm<T, NC>(device, &per_sm, &sms);
  if (e != cudaSuccess) return e;
  const long long blocks = std::min(n, (long long)sms * std::min(per_sm, BLOCKS_PER_SM));
  const bool scale_vec = reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  rmsnorm_rows_kernel<T, NC><<<(unsigned)blocks, RT, sizeof(float) * d, stream>>>(
      x, scale, out, n, d, eps, scale_vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xv, const float* scale, void* outv, long long n, int d,
                   float eps, int device, cudaStream_t stream) {
  constexpr int CH = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int nc = (d / CH + RT - 1) / RT;   // chunks a thread holds
  if (aligned && d % CH == 0 && nc <= MAX_NC) {
    switch (nc) {
      case 1: return launch_rows<T, 1>(x, scale, out, n, d, eps, device, stream);
      case 2: return launch_rows<T, 2>(x, scale, out, n, d, eps, device, stream);
      case 3: return launch_rows<T, 3>(x, scale, out, n, d, eps, device, stream);
      case 4: return launch_rows<T, 4>(x, scale, out, n, d, eps, device, stream);
      case 5: return launch_rows<T, 5>(x, scale, out, n, d, eps, device, stream);
      case 6: return launch_rows<T, 6>(x, scale, out, n, d, eps, device, stream);
      case 7: return launch_rows<T, 7>(x, scale, out, n, d, eps, device, stream);
      default: return launch_rows<T, 8>(x, scale, out, n, d, eps, device, stream);
    }
  }
  const unsigned grid = (unsigned)((n + WARPS - 1) / WARPS);
  if (d % CH == 0 && aligned)
    rmsnorm_warp_kernel<T, CH><<<grid, THREADS, 0, stream>>>(x, scale, out, n, d, eps);
  else
    rmsnorm_warp_kernel<T, 1><<<grid, THREADS, 0, stream>>>(x, scale, out, n, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, d] and out [n, d] contiguous, of one type (dtype 0 = f32, 1 = bf16),
// scale [d] f32, all on `device`; launches on `stream`.  Returns the CUDA
// error code (0 = ok).
int repro_rmsnorm(const void* x, const void* scale, void* out, int dtype, long long n,
                  long long d, float eps, int device, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is this launch's
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n <= 0) return cudaSuccess;
  if (d <= 0 || d > 0x7fffffffLL || (n + WARPS - 1) / WARPS > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0) return launch<float>(x, sc, out, n, (int)d, eps, device, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, sc, out, n, (int)d, eps, device, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
