// The cluster-major schedule shared by the IVF cluster scans, ivf_scan.cu
// (fp32 tiles) and ivf_scan_q.cu (int8 tiles with per-vector scales).
//
// out[b*bq + i, s*L + l] = mask[p, l] > 0 ? <q[b*bq + i], store[p, l]> (* scales[p, l])
//                                         : MASKED_SCORE,   p = probe_blocks[b, s]
// (a p outside [0, kc): the whole strip masked).
//
// * The wrapper inverts probe_blocks on the device (kernels/ivf_scan.py,
//   probe_lists): `order` lists the (block, slot) pairs by cluster, stably
//   (so by block within a cluster), `starts[p]..starts[p+1]` is cluster p's
//   range, and bucket kc holds the ids outside [0, kc).
// * One CTA of BN = 128 threads per (cluster, 128-row chunk of L), clusters
//   kc + 1 deep; thread t owns row t of the chunk.  A CTA whose cluster
//   nobody probed exits; one whose chunk the mask leaves empty (padding) or
//   whose bucket is kc writes MASKED_SCORE strips without reading the tile
//   (masked_strips).
// * Otherwise the chunk's rows are B of a simt_gemm.cuh GEMM and A is the
//   queries of up to 64 / bq distinct probing blocks at a time (a group,
//   next_group): a block that probed the cluster from several slots is
//   scored once and its strip written to each slot (write_strips).  Later
//   groups of a heavily probed cluster re-read the chunk from L2.
// * The epilogue writes each prober's [bq, 128] strip with 16-byte
//   streaming stores when L % 4 == 0, applying the mask lane by lane (and,
//   for the int8 scan, the row's scale to the finished dot product).
// Each score is one thread's ascending-k fp32 sum: no atomics, and a
// prober's scores do not depend on its group, so two calls give the same
// bits.
#pragma once

#include "simt_gemm.cuh"

namespace repro_scan {

using namespace repro_gemm;

constexpr float kMaskedScore = -1e30f;
constexpr int kGroupRows = 64;   // A rows of a group: the scans' Gemm<64, ...>
constexpr int kWindow = BN;      // prober ids staged per group formation

// What a CTA keeps in shared memory besides its stages.
struct Book {
  float inv[kGroupRows];       // 1/|q| of the group's rows
  float mask[BN];              // the mask of the chunk's rows
  float scale[BN];             // their scales (the int8 scan)
  int win[kWindow];            // prober ids in hand
  int blk[kGroupRows];         // the block of each group entry
  int first[kGroupRows + 1];   // its first prober in win
  int entries, used;           // group entries, probers the group consumed
};

// This thread's chunk row: its mask (0 past L and in the bucket of ids
// outside the store) into bk.mask and, with SCALE, its scale into bk.scale.
// -> the mask.
template <bool SCALE>
__device__ __forceinline__ float load_row(Book& bk, const float* __restrict__ mask,
                                          const float* __restrict__ scales, int p, int kc,
                                          int L, int l0, int nrows) {
  const int tid = threadIdx.x;
  const bool in = p < kc && tid < nrows;
  const long long at = static_cast<long long>(p) * L + l0 + tid;
  const float m = in ? __ldg(mask + at) : 0.f;
  bk.mask[tid] = m;
  if (SCALE) bk.scale[tid] = in ? __ldg(scales + at) : 0.f;
  return m;
}

// Padding, or ids outside the store: every prober's strip of the chunk is
// MASKED_SCORE.
__device__ __forceinline__ void masked_strips(Book& bk, const int32_t* __restrict__ order,
                                              int start, int end, float* __restrict__ out,
                                              int bq, int slots, int L, int l0, int nrows) {
  const int tid = threadIdx.x;
  const long long ld = static_cast<long long>(slots) * L;
  const int per = bq * nrows;
  for (int w0 = start; w0 < end; w0 += kWindow) {
    const int wn = min(kWindow, end - w0);
    if (tid < wn) bk.win[tid] = __ldg(order + w0 + tid);
    __syncthreads();
    for (int w = 0; w < wn; ++w) {
      const int b = bk.win[w] / slots, s = bk.win[w] % slots;
      float* dst = out + static_cast<long long>(b) * bq * ld + static_cast<long long>(s) * L + l0;
      if ((L & 3) == 0) {
        const float4 m4 = make_float4(kMaskedScore, kMaskedScore, kMaskedScore, kMaskedScore);
        for (int t = tid; t < per / 4; t += BN)
          __stcs(reinterpret_cast<float4*>(dst + (4 * t / nrows) * ld + 4 * t % nrows), m4);
      } else {
        for (int t = tid; t < per; t += BN)
          __stcs(dst + (t / nrows) * ld + t % nrows, kMaskedScore);
      }
    }
    __syncthreads();
  }
}

// The next group from probers order[cursor..end): up to max_blocks distinct
// probing blocks, into bk.blk / bk.first / bk.win; bk.used probers taken.
// -> the group's live A rows.  Called by every thread.
__device__ __forceinline__ int next_group(Book& bk, const int32_t* __restrict__ order,
                                          int cursor, int end, int slots, int bq) {
  const int tid = threadIdx.x;
  const int wn = min(kWindow, end - cursor);
  if (tid < wn) bk.win[tid] = __ldg(order + cursor + tid);
  __syncthreads();
  if (tid == 0) {
    const int max_blocks = kGroupRows / bq;
    int n = 0, last = -1, w = 0;
    for (; w < wn; ++w) {
      const int b = bk.win[w] / slots;
      if (b != last) {
        if (n == max_blocks) break;
        bk.blk[n] = b;
        bk.first[n++] = w;
        last = b;
      }
    }
    bk.first[n] = w;
    bk.entries = n;
    bk.used = w;
  }
  __syncthreads();
  return bk.entries * bq;
}

// Each live group row's strip of the chunk, to every slot its block probed
// from: acc * 1/|q| (NORM) * the row's scale (SCALE), MASKED_SCORE where the
// mask is 0.
template <bool NORM, bool SCALE, typename G>
__device__ __forceinline__ void write_strips(const G& g, const Book& bk,
                                             const float (&acc)[TM][TN], int nq, int bq,
                                             float* __restrict__ out, int slots, int L, int l0,
                                             int nrows) {
  const long long ld = static_cast<long long>(slots) * L;
  const bool vec_out = (L & 3) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = g.arow0 + i;
    if (r >= nq) continue;
    const int j = r / bq;
    const float iq = NORM ? bk.inv[r] : 1.f;
    const long long orow = (static_cast<long long>(bk.blk[j]) * bq + r % bq) * ld + l0;
    float v[TN];
#pragma unroll
    for (int e = 0; e < TN; ++e) {
      const int l = g.col(e);
      const float x = acc[i][e] * iq;
      v[e] = l < nrows && bk.mask[l] > 0.f ? (SCALE ? x * bk.scale[l] : x) : kMaskedScore;
    }
    for (int w = bk.first[j]; w < bk.first[j + 1]; ++w) {
      float* dst = out + orow + static_cast<long long>(bk.win[w] % slots) * L;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int l = g.col(4 * jj);
        if (vec_out) {
          if (l < nrows)
            __stcs(reinterpret_cast<float4*>(dst + l),
                   make_float4(v[4 * jj], v[4 * jj + 1], v[4 * jj + 2], v[4 * jj + 3]));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (l + e < nrows) __stcs(dst + l + e, v[4 * jj + e]);
        }
      }
    }
  }
}

// The entry points' argument checks and grid: -> cudaSuccess with *grid the
// CTAs to launch (0: nothing to do) and *nchunks the chunks of a cluster, or
// the error.  The wrappers check the same limits before any CUDA call
// (kernels/ivf_scan.py, check_launch).
inline cudaError_t plan_grid(long long nb, int bq, long long kc, long long L, long long d,
                             long long slots, unsigned* grid, int* nchunks) {
  *grid = 0;
  if (nb <= 0 || slots <= 0 || L <= 0) return cudaSuccess;
  if (bq <= 0 || bq > kGroupRows || kGroupRows % bq != 0 || d <= 0 || d > 0x7fffffffLL ||
      kc < 0 || kc >= 0x7fffffffLL || L > 0x7fffffffLL || nb * slots > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long chunks = (L + BN - 1) / BN;
  if ((kc + 1) * chunks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *grid = static_cast<unsigned>((kc + 1) * chunks);
  *nchunks = static_cast<int>(chunks);
  return cudaSuccess;
}

}  // namespace repro_scan
