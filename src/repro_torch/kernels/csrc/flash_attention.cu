// GQA flash attention with an online softmax, causal and/or sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:64
// (flash_attention, body _kernel): a sequential (batch, q-head, q-block,
// kv-block) grid whose innermost kv-block steps carry the row max m, row sum
// l and the f32 accumulator in VMEM scratch; q-head h reads kv-head
// h // (H/Hk) through the BlockSpec index maps, so the repeated KV is never
// materialised.
//
// Contract (kernels/ref.py::flash_attention_ref): scores q.k * scale in f32;
// masks compare absolute positions from 0 on both axes (q_pos >= k_pos when
// causal, q_pos - k_pos < window when windowed); a masked score is the finite
// NEG_INF = -1e30, never -inf; keys at k_pos >= Sk get no weight; the
// probabilities are rounded to the input type before the PV product, which
// sums in f32; out = acc / max(l, 1e-30), rounded once to the input type.
// A row that no key may see (only when Sq >= Sk + window) gets the uniform
// softmax over its masked scores.
//
// What bounds it on an H100: at the oracle's shape (q [32,512,24,128], k/v
// [32,512,8,128] bf16, causal) the unmasked products are 4*B*H*hd*S(S+1)/2 =
// 51.6 GFLOP and the inputs and output 268 MB: 0.080 ms by bytes at 3.35
// TB/s, 0.052 ms by operations at the 989 TFLOP/s of the bf16 tensor cores.
// So it is bound by bytes, but only if both products run on the tensor
// cores: on the 67 TFLOP/s of the SIMT f32 pipes the products alone take
// 0.77 ms.
//
// bf16 (flash_attention_wgmma_bf16), how the design meets that bound:
// - Both products are wgmma on bf16 operands with f32 accumulators: S = Q
//   K^T is m64n64k16 with both operands in shared memory; O += P V is
//   m64n{64,128}k16 with P from registers and V read through wgmma's
//   transpose bit from its [key, hd] rows.  P is rounded to bf16 in
//   registers, which is the contract's rounding and the operand type at
//   once: the S accumulators become the A fragments without a trip through
//   shared memory.
// - Each input byte crosses from device memory about once: the work is
//   items of (64-row q tile, q-head, batch), each staging its Q tile once;
//   q-head h reads kv-head h / (H/Hk) straight from [B, S, Hk, hd] (no
//   repeated KV), and the items of one q tile's heads and batch rows run
//   side by side, so a group's K/V tiles come from L2.  The heaviest causal
//   q tiles go first, so that the tail of the work is light.
// - Persistent blocks of one warpgroup (128 threads), as many as fit on the
//   card (two an SM at hd 128), each walking items i, i + blocks, ...: the
//   next item's Q and first K/V tiles are copied while this item's last
//   PV product and its output run.
// - Loads overlap the products: K and V tiles of 64 keys stream through a
//   two-stage ring of 16-byte cp.async copies (scalar loads where a row is
//   not 16-byte aligned, e.g. hd 20), in wgmma's 128-byte swizzled layout
//   (conflict-free for the copies and the tensor cores), hd zero-padded to
//   64 or 128.  80 KB of shared memory a block at hd 128.
// - Step j issues S_j, then O += P_{j-1} V_{j-1}, and starts S_j's online
//   softmax (f32, in registers, 2^x on the special-function unit) while the
//   second product runs.  ptxas places the wait for that product right after
//   the masking, before the row maxima and exponentials, whatever the source
//   order (seen in cuobjdump -sass), so only the masking overlaps it.  Masks
//   apply only on tiles that straddle the diagonal, the window's edge or Sk;
//   tiles wholly masked are skipped, unless the q tile holds a row that no
//   key may see: then every tile is visited so that such a row gets the
//   uniform softmax.
// - The output tile is staged in shared memory (in the V stage its last
//   product read) and leaves through TMA stores, which run on while the
//   next item computes (the map drops columns >= hd and rows >= Sq; rows
//   not 16-byte aligned, e.g. hd 20 or a sliced tensor, take scalar stores).
// - The launch's fixed set-up (the shared-memory limit, the blocks that fit
//   on the card) is done once a device; a launch builds only its tensor map.
// - Given a stats pointer (the training path's forward), each item also
//   writes its rows' max m and sum l for the backward
//   (flash_attention_bwd.cu), which then needs no statistics pass of its
//   own; inference passes null.  The wgmma, swizzle, cp.async and TMA
//   helpers are in wgmma.cuh, shared with the backward.
//
// f32 (flash_attention_simt_f32) stays on the SIMT pipes: the contract
// demands IEEE f32 products, and the tensor cores have no such mode (TF32
// keeps 10 mantissa bits).  Dispatch is by dtype alone: every bf16 call
// reaches the tensor-core kernel.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// f32: SIMT pipes
// ---------------------------------------------------------------------------
//
// One block of 256 threads per (64-row q tile, q-head, batch).  The Q tile is
// staged once in shared memory (transposed, f32), K and V tiles of 32 keys in
// f32 from the strided [B, S, Hk, hd] layout.  Each thread owns 4 q rows x 2
// key columns of the score tile and 4 q rows x HDP/16 output columns of the
// accumulator; a row's max and sum reduce over the 16 threads that share it
// with warp shuffles.  Tiles wholly above the causal diagonal or before the
// window are skipped, unless the q tile holds a row that no key may see: then
// every tile is visited so that such a row gets the uniform softmax.
namespace simt {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 32;          // key rows per staged tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int LDQ = BQ + 4;     // Qs row stride: float4 reads of 4 q rows
constexpr int LDK = BK + 1;     // Ks row stride: conflict-free transposed stores
constexpr int LDP = BQ + 4;     // Ps row stride

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (HDP * LDQ + HDP * LDK + BK * HDP + BK * LDP);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS)
flash_attention_simt_f32(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
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
  const float* qb = q + ((long long)b * Sq * H + h) * hd;
  const float* kb = k + ((long long)b * Sk * Hk + hkv) * hd;
  const float* vb = v + ((long long)b * Sk * Hk + hkv) * hd;
  float* ob = out + ((long long)b * Sq * H + h) * hd;

  for (int i = tid; i < BQ * HDP; i += THREADS) {
    const int r = i / HDP, d = i % HDP;
    const int pos = q0 + r;
    Qs[d * LDQ + r] = (pos < Sq && d < hd) ? qb[pos * q_stride + d] : 0.f;
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
      Ks[d * LDK + r] = ok ? kb[pos * k_stride + d] : 0.f;
      Vs[r * HDP + d] = ok ? vb[pos * k_stride + d] : 0.f;
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
        Ps[(tx + 16 * j) * LDP + ty * 4 + i] = p;
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
      if (d < hd) ob[qp * q_stride + d] = acc[i][j] * inv;
    }
  }
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int Sq, int Sk, int H, int Hk, int hd, float scale, int causal,
                   int window, cudaStream_t stream) {
  auto kern = flash_attention_simt_f32<HDP>;
  constexpr size_t smem = smem_bytes<HDP>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, Hk, hd, scale,
      causal, window);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int B,
                     int Sq, int Sk, int H, int Hk, int hd, float scale, int causal,
                     int window, cudaStream_t stream) {
  if (H > 65535 || B > 65535) return cudaErrorInvalidValue;   // grid y and z
  if (hd <= 16)
    return launch<16>(q, k, v, out, B, Sq, Sk, H, Hk, hd, scale, causal, window, stream);
  if (hd <= 32)
    return launch<32>(q, k, v, out, B, Sq, Sk, H, Hk, hd, scale, causal, window, stream);
  if (hd <= 64)
    return launch<64>(q, k, v, out, B, Sq, Sk, H, Hk, hd, scale, causal, window, stream);
  return launch<128>(q, k, v, out, B, Sq, Sk, H, Hk, hd, scale, causal, window, stream);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------
namespace tc {

using namespace wg;

constexpr int BQ = 64;          // q rows per block: one wgmma M
constexpr int BK = 64;          // keys per tile: the S product's N
constexpr int THREADS = 128;    // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * 5 * BQ * HDP + 1024;   // Q, K[2], V[2]; slack to align
}

// One unit of work: a 64-row q tile of one q-head and batch row, and the key
// tiles it must visit.
struct Item {
  int q0, h, b, kv_lo, n_tiles;
};

// Item i of n_qt * H * B: the heaviest causal q tiles first, a q tile's heads
// and batch rows side by side (so a kv-head's tiles are shared through L2).
__device__ __forceinline__ Item make_item(int i, int n_qt, int H, int B, int Sq, int Sk,
                                          int causal, int window) {
  Item it;
  const int per_qt = H * B;
  it.q0 = (n_qt - 1 - i / per_qt) * BQ;
  it.h = i % per_qt % H;
  it.b = i % per_qt / H;
  // a row that no key may see (only when Sq >= Sk + window) needs every tile
  const int q_last = min(it.q0 + BQ, Sq) - 1;
  const bool empty_row = window > 0 && q_last >= Sk + window - 1;
  int kv_hi = Sk;
  it.kv_lo = 0;
  if (!empty_row) {
    if (window > 0) it.kv_lo = max(0, it.q0 - window + 1) / BK * BK;
    if (causal) kv_hi = min(Sk, q_last + 1);
  }
  it.n_tiles = (kv_hi - it.kv_lo + BK - 1) / BK;
  return it;
}

// Thread t of the warpgroup (warp w = t / 32, lane) holds, of the m64nN f32
// accumulators, rows R0 = 16 w + lane / 4 and R1 = R0 + 8 at columns 8 j + 2
// (lane % 4) + {0, 1}: d[4 j + {0, 1}] in row R0, d[4 j + {2, 3}] in row R1.
// The same thread's A fragment of a k16 step kk is rows R0, R1 at columns 16
// kk + 2 (lane % 4) + {0, 1, 8, 9}: four packed pairs of S's columns, so P
// goes from the S accumulators to the PV product without leaving registers.
//
// Persistent: block i takes items i, i + gridDim.x, ...  K and V tiles are
// numbered across a block's items (tile g in stage g % 2), so the next item's
// Q, K_0, K_1 and V_0 are in flight while this item's last PV product and its
// output run.
template <int HDP, bool VEC>
__global__ void __launch_bounds__(THREADS)
flash_attention_wgmma_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ stats,
                           int B, int Sq, int Sk, int H, int Hk, int hd, float scale_log2,
                           int causal, int window, int n_qt,
                           const __grid_constant__ CUtensorMap out_map) {
  constexpr int TILE = BQ * HDP;               // elements of a staged tile
  constexpr int NO = HDP / 2;                  // accumulator floats a thread
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Ks = Qs + TILE;                        // [2][TILE]
  bf16* Vs = Ks + 2 * TILE;                    // [2][TILE]

  const int n_items = n_qt * H * B;
  const int group = H / Hk;
  const long long q_stride = (long long)H * hd;
  const long long k_stride = (long long)Hk * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lr0 = 16 * warp + lane / 4;        // tile rows of this thread
  const int lr1 = lr0 + 8;
  const int c0 = 2 * (lane % 4);               // its first column in each 8
  const uint32_t q_addr = smem_addr(Qs);

  auto q_base = [&](const Item& it) {
    return q + ((long long)it.b * Sq * H + it.h) * hd + it.q0 * q_stride;
  };
  auto k_base = [&](const bf16* x, const Item& it) {
    return x + ((long long)it.b * Sk * Hk + it.h / group) * hd;
  };
  // cp.async groups of an item, in order: Q + K_0, K_1, V_0, then K_{j+1} and
  // V_j in step j; a K stage is refilled once S is done with it, a V stage
  // once the PV product two steps back is
  auto issue_prologue = [&](const Item& it, int kg, int vg) {
    const bf16* kb = k_base(k, it) + it.kv_lo * k_stride;
    load_tile<HDP, VEC>(Qs, q_base(it), q_stride, Sq - it.q0, hd);
    load_tile<HDP, VEC>(Ks + (kg & 1) * TILE, kb, k_stride, Sk - it.kv_lo, hd);
    cp_commit();
    if (it.n_tiles > 1)
      load_tile<HDP, VEC>(Ks + ((kg + 1) & 1) * TILE, kb + BK * k_stride, k_stride,
                          Sk - it.kv_lo - BK, hd);
    cp_commit();
    load_tile<HDP, VEC>(Vs + (vg & 1) * TILE, k_base(v, it) + it.kv_lo * k_stride,
                        k_stride, Sk - it.kv_lo, hd);
    cp_commit();
  };

  int item = blockIdx.x;
  if (item >= n_items) return;
  Item it = make_item(item, n_qt, H, B, Sq, Sk, causal, window);
  int kg = 0, vg = 0;                          // this item's K_0, V_0 tile numbers
  issue_prologue(it, kg, vg);

  float o[NO], s[32];
  uint32_t p[4][4];              // P in bf16: the A fragments of 4 k16 steps
  for (;;) {
    const int q0 = it.q0, kv_lo = it.kv_lo, n_tiles = it.n_tiles;
    const int r0 = q0 + lr0, r1 = q0 + lr1;    // absolute rows of this thread
    const bf16* kb = k_base(k, it);
    const bf16* vb = k_base(v, it);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) p[kk][0] = p[kk][1] = p[kk][2] = p[kk][3] = 0u;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, alpha0 = 1.f, alpha1 = 1.f;

    // S = Q K^T for K tile g (issued, not waited)
    auto issue_s = [&](int g) {
      const uint32_t k_addr = smem_addr(Ks + (g & 1) * TILE);
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        wgmma_ss_n64(s, make_desc(q_addr + 8192 * (kk / 4) + 32 * (kk % 4), 16, 1024),
                     make_desc(k_addr + 8192 * (kk / 4) + 32 * (kk % 4), 16, 1024), kk > 0);
      wg_commit();
    };
    // O += P V for V tile g (issued, not waited)
    auto issue_pv = [&](int g) {
      const uint32_t v_addr = smem_addr(Vs + (g & 1) * TILE);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o, p[kk], make_desc(v_addr + 2048 * kk, 8192, 1024));
      wg_commit();
    };
    // the online softmax of the scores of keys k0 .. k0 + 63 in s: s becomes
    // p = 2^(s - m), alpha the factor of the rows' earlier sums
    auto softmax = [&](int k0) {
      // scale into log2 units; mask only a tile that straddles an edge
      const bool edge = (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && q0 + BQ - 1 - k0 >= window) || k0 + BK > Sk;
      if (edge) {
        // column kc of the tile is kept in row r while lo < kc <= hi, and has
        // no weight at all (-inf, never the row's max) from kc = Sk - k0 on
        const int nk = Sk - k0;
        const int hi0 = causal ? r0 - k0 : BK, hi1 = causal ? r1 - k0 : BK;
        const int lo0 = window > 0 ? r0 - k0 - window : -1;
        const int lo1 = window > 0 ? r1 - k0 - window : -1;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kc = 8 * (i / 4) + (i & 1) + c0;
          const bool keep = (i & 2) ? kc <= hi1 && kc > lo1 : kc <= hi0 && kc > lo0;
          s[i] = kc >= nk ? -__int_as_float(0x7f800000) : keep ? s[i] * scale_log2 : NEG_INF;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
      }
      // row maxima over the 4 threads that share a row
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      alpha0 = fast_exp2(m0 - mx0);
      alpha1 = fast_exp2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        s[i] = fast_exp2(s[i] - mx0);
        s[i + 1] = fast_exp2(s[i + 1] - mx0);
        s[i + 2] = fast_exp2(s[i + 2] - mx1);
        s[i + 3] = fast_exp2(s[i + 3] - mx1);
        sum0 += s[i] + s[i + 1];
        sum1 += s[i + 2] + s[i + 3];
      }
      l0 = l0 * alpha0 + sum0;     // this thread's share of the row sums
      l1 = l1 * alpha1 + sum1;
    };
    // O to the new row maxima, and P in bf16 (the contract's rounding)
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int i = 0; i < NO; i += 4) {
        o[i] *= alpha0;
        o[i + 1] *= alpha0;
        o[i + 2] *= alpha1;
        o[i + 3] *= alpha1;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // step 0: S_0 and its softmax
    cp_wait<2>();      // Q and K_0 have landed
    fence_async_smem();
    __syncthreads();
    pin(s);
    wg_fence();
    issue_s(kg);
    wg_wait<0>();
    pin(s);
    softmax(kv_lo);
    rescale_and_pack();

    // step j: S_j on the tensor cores, then O += P_{j-1} V_{j-1}, which runs
    // while this warpgroup does S_j's softmax
    for (int j = 1; j < n_tiles; ++j) {
      const int k0 = kv_lo + j * BK;
      if (VEC && threadIdx.x == 0) store_wait_read();   // the last output's reads
      __syncthreads();   // every warp is done with K_{j-1} and V_{j-2}
      if (j + 1 < n_tiles)
        load_tile<HDP, VEC>(Ks + ((kg + j + 1) & 1) * TILE,
                            kb + (long long)(k0 + BK) * k_stride, k_stride,
                            Sk - k0 - BK, hd);
      cp_commit();
      load_tile<HDP, VEC>(Vs + ((vg + j) & 1) * TILE, vb + (long long)k0 * k_stride,
                          k_stride, Sk - k0, hd);
      cp_commit();
      cp_wait<2>();    // K_j and V_{j-1} have landed
      fence_async_smem();
      __syncthreads();
      pin(s);
      pin(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pin(p[kk]);
      wg_fence();
      issue_s(kg + j);
      wg_fence();
      issue_pv(vg + j - 1);
      wg_wait<1>();    // S_j is done
      pin(s);
      softmax(k0);
      wg_wait<0>();    // O += P_{j-1} V_{j-1} is done
      pin(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pin(p[kk]);
      rescale_and_pack();
    }

    // the last product, O += P_{n-1} V_{n-1}, and the next item's first tiles
    // while it runs (every S of this item is done: Q and both K stages are
    // free, and so is the V stage that the product does not read)
    cp_wait<0>();
    fence_async_smem();
    if (VEC && threadIdx.x == 0) store_wait_read();
    __syncthreads();
    pin(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(p[kk]);
    wg_fence();
    const int v_last = vg + n_tiles - 1;
    issue_pv(v_last);
    kg += n_tiles;
    vg += n_tiles;
    const Item cur = it;
    const int next = item + gridDim.x;
    if (next < n_items) {
      it = make_item(next, n_qt, H, B, Sq, Sk, causal, window);
      issue_prologue(it, kg, vg);
    }
    wg_wait<0>();
    pin(o);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    if (stats != nullptr && lane % 4 == 0) {
      // each row's max m (in the scores' units: NEG_INF stays NEG_INF for a
      // row that no key may see) and sum l, for the backward
      const long long row = ((long long)cur.b * H + cur.h) * Sq + cur.q0;
      const long long plane = (long long)B * H * Sq;
      if (cur.q0 + lr0 < Sq) {
        stats[row + lr0] = m0 <= NEG_INF ? NEG_INF : m0 * LN2;
        stats[plane + row + lr0] = l0;
      }
      if (cur.q0 + lr1 < Sq) {
        stats[row + lr1] = m1 <= NEG_INF ? NEG_INF : m1 * LN2;
        stats[plane + row + lr1] = l1;
      }
    }

    bf16* Os = Vs + (v_last & 1) * TILE;       // the V stage the product just read
    __syncthreads();   // every warp's share of the product is done
    // in the copies' layout (64-column panels, the 128-byte swizzle)
    auto at = [](int r, int col) {
      return col / 64 * (BQ * 64) + r * 64 + ((col % 64 / 8) ^ (r % 8)) * 8 + col % 8;
    };
#pragma unroll
    for (int i = 0; i < NO; i += 4) {
      const int col = 8 * (i / 4) + c0;
      *reinterpret_cast<uint32_t*>(&Os[at(lr0, col)]) = pack_bf16(o[i] * inv0, o[i + 1] * inv0);
      *reinterpret_cast<uint32_t*>(&Os[at(lr1, col)]) =
          pack_bf16(o[i + 2] * inv1, o[i + 3] * inv1);
    }
    if constexpr (VEC) {
      // one TMA store a panel, which writes only columns < hd and rows < Sq
      fence_async_smem();
      __syncthreads();
      if (threadIdx.x == 0) {
#pragma unroll
        for (int panel = 0; panel < HDP / 64; ++panel)
          tma_store(&out_map, smem_addr(Os + panel * BQ * 64), 64 * panel, cur.h, cur.q0, cur.b);
        store_commit();
      }
    } else {
      __syncthreads();
      bf16* ob = out + ((long long)cur.b * Sq * H + cur.h) * hd + cur.q0 * q_stride;
      const int rows = min(BQ, Sq - cur.q0);
      for (int i = threadIdx.x; i < BQ * HDP; i += THREADS) {
        const int r = i / HDP, d = i % HDP;
        if (r < rows && d < hd) ob[r * q_stride + d] = Os[at(r, d)];
      }
    }
    if (next >= n_items) break;
    item = next;
  }
  if (VEC && threadIdx.x == 0) store_wait();
}

// cuTensorMapEncodeTiled from the driver, found at run time (the library
// links only the runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The map of out [B, Sq, H, hd] for 64 x 64 panels in the 128-byte swizzle
cudaError_t out_map(CUtensorMap* map, void* out, int B, int Sq, int H, int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * hd * H, 2ull * hd * H * Sq};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)BQ, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, dims, strides, box,
                            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The kernel's shared-memory limit, set once a device, and the number of its
// blocks that fit on that device at once (0 until then)
constexpr int MAX_DEVICES = 64;

template <int HDP, bool VEC>
cudaError_t resident_blocks(int device, int* blocks) {
  static std::atomic<int> cached[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  *blocks = cached[device].load(std::memory_order_relaxed);
  if (*blocks > 0) return cudaSuccess;
  auto kern = flash_attention_wgmma_bf16<HDP, VEC>;
  constexpr size_t smem = smem_bytes<HDP>();
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (e != cudaSuccess) return e;
  *blocks = std::max(1, per_sm) * sms;
  cached[device].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

template <int HDP, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* stats,
                   int B, int Sq, int Sk, int H, int Hk, int hd, float scale, int causal,
                   int window, int device, cudaStream_t stream) {
  const int n_qt = (Sq + BQ - 1) / BQ;
  const long long items = (long long)n_qt * H * B;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  // as many blocks as fit on the card at once, each walking the items
  int resident = 0;
  cudaError_t e = resident_blocks<HDP, VEC>(device, &resident);
  if (e != cudaSuccess) return e;
  const long long blocks = std::min(items, (long long)resident);
  // 16-byte aligned rows (hd % 8 == 0) leave through TMA stores
  CUtensorMap map = {};
  if constexpr (VEC) {
    e = out_map(&map, out, B, Sq, H, hd);
    if (e != cudaSuccess) return e;
  }
  flash_attention_wgmma_bf16<HDP, VEC><<<(unsigned)blocks, THREADS, smem_bytes<HDP>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), stats, B, Sq, Sk, H, Hk, hd, scale * LOG2E, causal, window, n_qt,
      map);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, float* stats,
                     int B, int Sq, int Sk, int H, int Hk, int hd, float scale, int causal,
                     int window, int device, cudaStream_t stream) {
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  const bool vec = hd % 8 == 0 && addr_bits % 16 == 0;
  if (hd <= 64)
    return vec ? launch<64, true>(q, k, v, out, stats, B, Sq, Sk, H, Hk, hd, scale, causal,
                                  window, device, stream)
               : launch<64, false>(q, k, v, out, stats, B, Sq, Sk, H, Hk, hd, scale, causal,
                                   window, device, stream);
  return vec ? launch<128, true>(q, k, v, out, stats, B, Sq, Sk, H, Hk, hd, scale, causal,
                                 window, device, stream)
             : launch<128, false>(q, k, v, out, stats, B, Sq, Sk, H, Hk, hd, scale, causal,
                                  window, device, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

// q [B, Sq, H, hd], k/v [B, Sk, Hk, hd], out [B, Sq, H, hd], all contiguous,
// of one type (dtype 0 = f32 on the SIMT pipes, 1 = bf16 on the tensor
// cores), on `device`; launches on `stream`.  stats is null, or (bf16 only)
// 2 * B * H * Sq f32 into which the launch also writes each row's max m and
// sum l ([B, H, Sq] each: the backward's statistics).  Needs 1 <= hd <= 128,
// H % Hk == 0.  Returns the CUDA error code (0 = ok).
int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                          void* stats, int dtype, long long B, long long Sq, long long Sk,
                          long long H, long long Hk, long long hd, float scale,
                          int causal, int window, int device, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is this launch's
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || Sq <= 0) return cudaSuccess;
  if (Sk <= 0 || Sq > 0x7fffffffLL || Sk > 0x7fffffffLL || hd <= 0 || hd > 128 ||
      Hk <= 0 || H % Hk != 0 || H > 0x7fffffffLL || B > 0x7fffffffLL || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && stats == nullptr)
    return simt::dispatch(q, k, v, out, (int)B, (int)Sq, (int)Sk, (int)H, (int)Hk,
                          (int)hd, scale, causal, window, s);
  if (dtype == 1)
    return tc::dispatch(q, k, v, out, static_cast<float*>(stats), (int)B, (int)Sq, (int)Sk,
                        (int)H, (int)Hk, (int)hd, scale, causal, window, device, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
