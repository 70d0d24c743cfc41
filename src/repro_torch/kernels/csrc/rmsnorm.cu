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
// operations per byte, so bytes.  Design: one warp per row, 8 rows per
// block.  A lane reads 16 bytes at a time (8 bf16 or 4 f32 values) when the
// row width and the pointers allow it, else one value; neighbouring lanes
// read neighbouring addresses.  The sum of squares reduces over the warp with shuffles; the
// second pass re-reads the row, which the first pass has just brought into
// L1/L2, so device memory sees x about once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
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

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
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

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* out, long long n, int d,
                   float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const unsigned grid = (unsigned)((n + WARPS - 1) / WARPS);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (d % VEC == 0 && aligned)
    rmsnorm_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(out), n, d, eps);
  else
    rmsnorm_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(out), n, d, eps);
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
  if (dtype == 0) return launch<float>(x, sc, out, n, (int)d, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, sc, out, n, (int)d, eps, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
