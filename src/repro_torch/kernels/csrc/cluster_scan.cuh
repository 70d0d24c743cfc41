// Masked gather-scan over the probed clusters of an IVF store, shared by
// ivf_scan.cu (fp32 tiles) and ivf_scan_q.cu (int8 tiles + per-vector scale).
//
// out[b*BQ + i, s*L + l] = mask[p, l] > 0 ? <q[b*BQ + i], store[p, l]> (* scales[p, l])
//                                         : MASKED_SCORE,   p = probe_blocks[b, s]
//
// One CTA per (query block b, probe slot s).  The CTA reads its cluster id
// from probe_blocks itself (the TPU kernel had it scalar-prefetched), stages
// the block's BQ query rows in shared memory (BQ*d*4 bytes), and streams the
// cluster's [L, d] tile from device memory with coalesced 16-byte (fp32) or
// 4-byte (int8) loads per lane, each lane owning a fixed stripe of d.
//
// A warp scores R = 32/BQ tile rows against the BQ queries per step, so it
// holds exactly 32 partial dot products; a transposing butterfly reduction
// (31 shuffles) leaves lane t with the full sum for row t/BQ, query t%BQ.
// The CTA's 256 sums per step go through shared memory so each query's
// output row is written as one contiguous run, where the mask is applied
// (and, for int8, the scale multiplies the finished dot product).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_scan {

constexpr float kMaskedScore = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStepSums = kThreads;  // BQ * rows-per-CTA-step == 256 for every BQ

__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load_vec(const int8_t* p, float (&x)[4]) {
  const char4 v = __ldg(reinterpret_cast<const char4*>(p));
  x[0] = static_cast<float>(v.x); x[1] = static_cast<float>(v.y);
  x[2] = static_cast<float>(v.z); x[3] = static_cast<float>(v.w);
}
__device__ __forceinline__ void load_vec(const float* p, float (&x)[1]) { x[0] = __ldg(p); }
__device__ __forceinline__ void load_vec(const int8_t* p, float (&x)[1]) {
  x[0] = static_cast<float>(__ldg(reinterpret_cast<const signed char*>(p)));
}
__device__ __forceinline__ void load_query(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load_query(const float* p, float (&x)[1]) { x[0] = *p; }

// One butterfly step of the transposing reduction: 2*O live values become O,
// lanes with bit O set keep the upper half.
template <int O>
__device__ __forceinline__ void reduce_step(float (&v)[32], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// 32 values per lane in, lane t returns the warp-wide sum of value t.
__device__ __forceinline__ float transpose_reduce(float (&v)[32], int lane) {
  reduce_step<16>(v, lane);
  reduce_step<8>(v, lane);
  reduce_step<4>(v, lane);
  reduce_step<2>(v, lane);
  reduce_step<1>(v, lane);
  return v[0];
}

template <typename T, int BQ, int VEC, bool QUANT>
__global__ void __launch_bounds__(kThreads)
cluster_scan_kernel(const float* __restrict__ queries, const T* __restrict__ store,
                    const float* __restrict__ scales, const float* __restrict__ mask,
                    const int32_t* __restrict__ probe_blocks, float* __restrict__ out,
                    int kc, int L, int d, int slots, int normalize) {
  constexpr int R = 32 / BQ;        // tile rows per warp step
  constexpr int CH = kWarps * R;    // tile rows per CTA step
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                 // [BQ][d] query block
  float* sres = smem + BQ * d;      // [BQ][CH] finished sums of one step

  const int s = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = probe_blocks[(long long)b * slots + s];
  const long long ld = (long long)slots * L;
  float* dst = out + (long long)b * BQ * ld + (long long)s * L;

  const float* qsrc = queries + (long long)b * BQ * d;
  for (int i = threadIdx.x; i < BQ * d; i += kThreads) sq[i] = qsrc[i];
  __syncthreads();
  if (normalize) {
    for (int i = warp; i < BQ; i += kWarps) {
      float ss = 0.f;
      for (int j = lane; j < d; j += 32) ss = fmaf(sq[i * d + j], sq[i * d + j], ss);
#pragma unroll
      for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float inv = 1.0f / sqrtf(fmaxf(ss, 1e-18f));
      for (int j = lane; j < d; j += 32) sq[i * d + j] *= inv;
    }
    __syncthreads();
  }

  if (p < 0 || p >= kc) {  // an id outside the store scores nothing
    for (int t = threadIdx.x; t < BQ * L; t += kThreads)
      dst[(long long)(t / L) * ld + t % L] = kMaskedScore;
    return;
  }
  const T* tile = store + (long long)p * L * d;
  const float* mrow = mask + (long long)p * L;

  for (int l0 = 0; l0 < L; l0 += CH) {
    const int r0 = l0 + warp * R;
    float acc[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) acc[t] = 0.f;

#pragma unroll 2
    for (int j = lane * VEC; j < d; j += 32 * VEC) {
      float v[R][VEC];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r0 + r < L) {
          load_vec(tile + (long long)(r0 + r) * d + j, v[r]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[r][e] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < BQ; ++i) {
        float qv[VEC];
        load_query(sq + i * d + j, qv);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[r * BQ + i] = fmaf(qv[e], v[r][e], acc[r * BQ + i]);
      }
    }
    const float sum = transpose_reduce(acc, lane);   // row r0 + lane/BQ, query lane%BQ
    sres[(lane % BQ) * CH + warp * R + lane / BQ] = sum;
    __syncthreads();
    for (int t = threadIdx.x; t < kStepSums; t += kThreads) {
      const int i = t / CH, c = t % CH, l = l0 + c;
      if (l < L) {
        float x = sres[t];
        if (QUANT) x *= __ldg(scales + (long long)p * L + l);  // dequantize after the dot
        dst[(long long)i * ld + l] = __ldg(mrow + l) > 0.f ? x : kMaskedScore;
      }
    }
    __syncthreads();
  }
}

// Host side: picks the vector width from d and the pointers' alignment and
// the instantiation from BQ, then launches on `stream`.
template <typename T, int BQ, bool QUANT>
cudaError_t launch_bq(const float* q, const T* store, const float* scales,
                      const float* mask, const int32_t* probes, float* out,
                      int nb, int kc, int L, int d, int slots, int normalize,
                      cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(BQ) * d + kStepSums) * sizeof(float);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(store) % (4 * sizeof(T)) == 0;
  void (*kern)(const float*, const T*, const float*, const float*, const int32_t*,
               float*, int, int, int, int, int) =
      vec ? cluster_scan_kernel<T, BQ, 4, QUANT> : cluster_scan_kernel<T, BQ, 1, QUANT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(slots, nb);
  kern<<<grid, kThreads, smem, stream>>>(q, store, scales, mask, probes, out,
                                         kc, L, d, slots, normalize);
  return cudaGetLastError();
}

template <typename T, bool QUANT>
int launch(const void* q, const void* store, const void* scales, const void* mask,
           const void* probes, void* out, long long nb, int bq, long long kc,
           long long L, long long d, long long slots, int normalize, int device,
           void* stream) {
  cudaGetLastError();  // clear a stale error so the code returned is this launch's
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (nb <= 0 || slots <= 0 || L <= 0) return cudaSuccess;
  if (nb > 65535 || slots > 0x7fffffffLL || d <= 0 || L * d > 0x7fffffffLL ||
      kc > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const auto* qf = static_cast<const float*>(q);
  const auto* st = static_cast<const T*>(store);
  const auto* sc = static_cast<const float*>(scales);
  const auto* mk = static_cast<const float*>(mask);
  const auto* pb = static_cast<const int32_t*>(probes);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int args[5] = {(int)nb, (int)kc, (int)L, (int)d, (int)slots};
  switch (bq) {
    case 1: e = launch_bq<T, 1, QUANT>(qf, st, sc, mk, pb, o, args[0], args[1], args[2], args[3], args[4], normalize, s); break;
    case 2: e = launch_bq<T, 2, QUANT>(qf, st, sc, mk, pb, o, args[0], args[1], args[2], args[3], args[4], normalize, s); break;
    case 4: e = launch_bq<T, 4, QUANT>(qf, st, sc, mk, pb, o, args[0], args[1], args[2], args[3], args[4], normalize, s); break;
    case 8: e = launch_bq<T, 8, QUANT>(qf, st, sc, mk, pb, o, args[0], args[1], args[2], args[3], args[4], normalize, s); break;
    case 16: e = launch_bq<T, 16, QUANT>(qf, st, sc, mk, pb, o, args[0], args[1], args[2], args[3], args[4], normalize, s); break;
    default: return cudaErrorInvalidValue;
  }
  return e;
}

}  // namespace repro_scan
