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
// with random lens that is 63.5 MB against 0.19 GFLOP, so bytes bound it.
//
// Design: the work is divided by keys, on the device, so that the blocks
// that run carry about the same bytes whatever lens holds.
// - The grid is (kv-head x group of up to 8 of its q-heads, key chunk,
//   batch row); the host sizes the chunks from S alone and never reads lens.
//   A block reads lens[b] and returns at once when its chunk lies outside
//   the visited rows [lo, hi] = [max(0, lens - window + 1), min(lens, S -
//   1)].  Each K/V row crosses device memory once per step for all the
//   q-heads of its kv-head, and rows outside [lo, hi] are not read.  The
//   kv-heads of a chunk launch side by side, so the neighbouring 256-byte
//   pieces of a cache row are read at about the same time (1% faster than
//   chunk-major order on the H100).
// - Each of a block's 4 warps takes every 4th tile of KT keys (16 in bf16, 8
//   in f32: 8 KB of K and V at hd 128) and streams them through its own ring
//   of 3 stages in shared memory by 16-byte cp.async copies, which zero-fill
//   rows outside [lo, hi] and columns past hd without reading them.  While a
//   warp scores one tile its next two are in flight: with two blocks an SM,
//   128 KB in flight per SM, against the ~25 KB that HBM's latency asks for.
//   K and V rows are swizzled by 16-byte chunk (chunk ^ row % 8), so the
//   lanes read them conflict-free.
// - A warp keeps its own running max, sum and accumulator, so a tile costs
//   only warp barriers; the block merges its warps once, in warp order.
// - bf16 scores and sums on the tensor cores (mma.sync m16n8k16, f32
//   accumulators): the block's q-heads are the rows of one 16-row tile (8
//   used), Q's fragments stay in registers, K and V come by ldmatrix, and p
//   goes from the score accumulators to the PV operand in registers, rounded
//   to bf16: ~60 instructions a warp for the products of a 16-key tile,
//   where the SIMT form of this kernel took ~800 and read 7% slower on the
//   H100.  f32 stays IEEE f32 on the SIMT pipes: 4 lanes a key row for q.k
//   (q broadcast from shared memory), then each lane owns hd / 32 output
//   columns of every q-head.
// - A chunk that shares its row with others writes its (m, l, acc) to a
//   scratch buffer; the last block of the row to finish, found by an atomic
//   ticket that it resets to 0, merges the chunks that ran in chunk order,
//   so two calls on the same inputs give identical bits.  A row whose keys
//   fit in one chunk writes its output directly: one launch either way.
// - hd * element size not a multiple of 16 bytes, or k/v not 16-byte
//   aligned, takes scalar loads into the same layout: correct, not fast.
// - The kernel's shared-memory limit is set once a device per instance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 3;            // K/V tiles of a warp's ring
constexpr int CHUNK_ALIGN = 64;      // chunks are a multiple of WARPS x KT keys
constexpr int MMA_ROWS = 8;          // q-heads of a bf16 block (of the 16-row tile)
constexpr int MAX_DEVICES = 64;
constexpr float NEG_INF = -1e30f;
constexpr float LOWEST = -3.0e38f;   // below NEG_INF: nothing seen yet

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// The tiles of a warp's ring for element type T and hd padded to HDP.
template <typename T, int HDP>
struct Tile {
  static constexpr int CH = 16 / (int)sizeof(T);            // elements per 16-byte chunk
  static constexpr int CPR = HDP / CH;                      // chunks per row
  static constexpr int KT = sizeof(T) == 2 ? 16 : 8;        // keys per tile
  static constexpr int SWM = (CPR < 8 ? CPR : 8) - 1;       // swizzle mask
  static constexpr int STAGE = 2 * KT * HDP;                // K then V, elements
  static constexpr int PART = HDP + 2;                      // floats of a head's (m, l, acc)
  static_assert(CHUNK_ALIGN % (WARPS * KT) == 0 && KT * CPR % 32 == 0, "tile shape");
  // element offset of chunk ch of row r in a K or V tile
  __device__ static __forceinline__ int at(int r, int ch) {
    return (r * CPR + (ch ^ (r & SWM))) * CH;
  }
};

template <typename T, int HDP>
__host__ __device__ constexpr size_t ring_bytes() {
  return sizeof(T) * WARPS * STAGES * Tile<T, HDP>::STAGE;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool on) {
  // src-size 0 reads nothing and fills the 16 bytes with zeros
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(on ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What a block visits: the row's keys [lo, hi] (all S, every score masked,
// when none is visible), its chunk's part [a, z] of them, and the chunks
// [c_lo, c_hi] that hold any.
struct Visit {
  int lo, hi, a, z, c_lo, c_hi;
  bool empty, any;
  __device__ Visit(int len, int S, int window, int chunk, int c) {
    lo = window > 0 ? (int)max(0LL, (long long)len - window + 1) : 0;
    hi = min(len, S - 1);
    empty = lo > hi;
    if (empty) { lo = 0; hi = S - 1; }
    c_lo = lo / chunk;
    c_hi = hi / chunk;
    any = c >= c_lo && c <= c_hi;
    a = max(lo, c * chunk);
    z = min(hi, c * chunk + chunk - 1);
  }
};

// One warp stages the tile of keys k0 .. k0 + KT - 1 into `slot`; rows
// outside [lo, hi] and columns past hd are zeros, and only the rows inside
// are read.
template <typename T, int HDP>
__device__ __forceinline__ void stage(T* slot, const T* kb, const T* vb, long long rs,
                                      int k0, int lo, int hi, int hd, bool vec, int lane) {
  using L = Tile<T, HDP>;
  T* Ks = slot;
  T* Vs = slot + L::KT * HDP;
  if (vec) {
#pragma unroll
    for (int j = 0; j < L::KT * L::CPR / 32; ++j) {
      const int i = lane + 32 * j;
      const int r = i / L::CPR, ch = i % L::CPR, key = k0 + r;
      const bool on = key >= lo && key <= hi && ch * L::CH < hd;
      const long long off = on ? (long long)key * rs + ch * L::CH : 0;
      cp_async16(Ks + L::at(r, ch), kb + off, on);
      cp_async16(Vs + L::at(r, ch), vb + off, on);
    }
  } else {
    for (int i = lane; i < L::KT * HDP; i += 32) {
      const int r = i / HDP, d = i % HDP, key = k0 + r;
      T kx = from_f<T>(0.f), vx = kx;
      if (key >= lo && key <= hi && d < hd) {
        const long long off = (long long)key * rs + d;
        kx = kb[off];
        vx = vb[off];
      }
      Ks[L::at(r, d / L::CH) + d % L::CH] = kx;
      Vs[L::at(r, d / L::CH) + d % L::CH] = vx;
    }
  }
}

// After each warp has left its (m, l, acc) for heads 0..GMAX-1 at the start
// of its ring ([GMAX][m, l, acc[HDP]] floats) and the block has passed a
// barrier: merge the warps in warp order; a row whose keys fit one chunk
// writes its output, else the chunk's result goes to `part` and the row's
// last block merges the chunks in chunk order and resets the row's ticket.
template <typename T, int GMAX, int HDP>
__device__ __forceinline__ void finish(const unsigned char* smem, int* verdict, T* out,
                                       float* part, int* tickets, const Visit& vis,
                                       long long row0, int gc, int hd) {
  using L = Tile<T, HDP>;
  constexpr int WSTRIDE = STAGES * L::STAGE * (int)sizeof(T) / (int)sizeof(float);
  const int tid = threadIdx.x, c = blockIdx.y, nchunks = gridDim.y;
  const bool single = vis.c_lo == vis.c_hi;
  const float* wp0 = reinterpret_cast<const float*>(smem);
  for (int i = tid; i < gc * hd; i += THREADS) {
    const int g = i / hd, d = i % hd;
    const float* wp = wp0 + g * L::PART;
    float mx = LOWEST;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wp[w * WSTRIDE]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* p = wp + w * WSTRIDE;
      const float f = expf(p[0] - mx);   // 0 for a warp that saw nothing
      ls = fmaf(f, p[1], ls);
      as = fmaf(f, p[2 + d], as);
    }
    if (single) {
      out[(row0 + g) * hd + d] = from_f<T>(as / fmaxf(ls, 1e-30f));
    } else {
      float* pr = part + ((row0 + g) * nchunks + c) * (hd + 2);
      pr[2 + d] = as;
      if (d == 0) { pr[0] = mx; pr[1] = ls; }
    }
  }
  if (single) return;

  __threadfence();
  __syncthreads();
  int* ticket = tickets + (long long)blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) *verdict = atomicAdd(ticket, 1) == vis.c_hi - vis.c_lo;
  __syncthreads();
  if (!*verdict) return;
  __threadfence();
  for (int i = tid; i < gc * hd; i += THREADS) {
    const int g = i / hd, d = i % hd;
    const float* pr = part + (row0 + g) * nchunks * (hd + 2);
    float mx = LOWEST;
    for (int cc = vis.c_lo; cc <= vis.c_hi; ++cc) mx = fmaxf(mx, __ldcg(pr + cc * (hd + 2)));
    float ls = 0.f, as = 0.f;
    for (int cc = vis.c_lo; cc <= vis.c_hi; ++cc) {
      const float* p = pr + cc * (hd + 2);
      const float f = expf(__ldcg(p) - mx);
      ls = fmaf(f, __ldcg(p + 1), ls);
      as = fmaf(f, __ldcg(p + 2 + d), as);
    }
    out[(row0 + g) * hd + d] = from_f<T>(as / fmaxf(ls, 1e-30f));
  }
  if (tid == 0) *ticket = 0;   // ready for the next launch
}

// ---------------------------------------------------------------------------
// bf16: the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
// d += A B, m16n8k16, for an A whose rows 8..15 are zero (a1 = a3 = 0)
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS)
decode_attention_mma_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const int* __restrict__ lens,
                          bf16* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ tickets, int S, int H, int Hk, int hd, int G,
                          int hchunks, int chunk, float scale, int window, bool vec) {
  using L = Tile<bf16, HDP>;
  static_assert(L::KT == 16, "one k16 step of the PV product a tile");
  constexpr int KS = HDP / 16;   // k16 steps of q.k; pairs of n8 tiles of PV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);                    // [WARPS][STAGES][STAGE]
  int* verdict = reinterpret_cast<int*>(smem_raw + ring_bytes<bf16, HDP>());

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;            // mma fragment row, column pair
  const int hkv = blockIdx.x / hchunks;
  const int g0 = (blockIdx.x % hchunks) * MMA_ROWS;    // first q-head of this block
  const int gc = min(MMA_ROWS, G - g0);                // q-heads this block owns
  const int b = blockIdx.z;
  const long long row0 = (long long)b * H + hkv * G + g0;   // [B, 1, H] flattened

  const Visit vis(lens[b], S, window, chunk, blockIdx.y);
  if (!vis.any) return;                                // no visited key in this chunk

  // this warp's tiles: t0, t0 + WARPS, ... up to the one holding key z
  const int t0 = vis.a / L::KT + warp, t_last = vis.z / L::KT;
  const int ntiles = t0 <= t_last ? (t_last - t0) / WARPS + 1 : 0;
  const long long rs = (long long)Hk * hd;             // between sequence positions
  const bf16* kb = k + ((long long)b * S * Hk + hkv) * hd;
  const bf16* vb = v + ((long long)b * S * Hk + hkv) * hd;
  bf16* wring = ring + warp * STAGES * L::STAGE;
  auto issue = [&](int i) {
    if (i < ntiles)
      stage<bf16, HDP>(wring + (i % STAGES) * L::STAGE, kb, vb, rs, (t0 + i * WARPS) * L::KT,
                       vis.lo, vis.hi, hd, vec, lane);
    cp_async_commit();   // an empty group past the last tile keeps the count
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  // Q's A fragments: row gid = q-head g0 + gid, columns 16 ks + 2 tig (+1)
  // and 8 more (rows 8..15 of the tile are zero)
  uint32_t qa[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 16 * ks + 8 * h + 2 * tig + e;
        x[e] = gid < gc && d < hd ? __bfloat162float(q[(row0 + gid) * hd + d]) : 0.f;
      }
      qa[ks][h] = pack_bf16(x[0], x[1]);   // bf16 values: exact
    }

  float m = LOWEST, l = 0.f;                 // of row gid
  float o[2 * KS][4];                        // n8 tiles of the output; [2], [3] stay 0
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int mat = lane / 8, mr = lane % 8;   // ldmatrix: this lane's matrix and row

  for (int i = 0; i < ntiles; ++i) {
    issue(i + STAGES - 1);          // into the slot the previous tile left
    cp_async_wait<STAGES - 1>();    // this lane's copies of tile i have landed
    __syncwarp();                   // ... and every lane's
    const bf16* Kt = wring + (i % STAGES) * L::STAGE;
    const bf16* Vt = Kt + L::KT * HDP;

    // s[n] (keys 8 n .. 8 n + 7): [0], [1] = row gid, keys 8 n + 2 tig (+1)
    float s[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kf[4];   // matrices: keys 0-7 / 8-15 x chunks 2 ks / 2 ks + 1
      ldmatrix_x4(kf, Kt + L::at((mat / 2) * 8 + mr, 2 * ks + mat % 2));
      mma16816(s[0], qa[ks][0], qa[ks][1], kf[0], kf[1]);
      mma16816(s[1], qa[ks][0], qa[ks][1], kf[2], kf[3]);
    }

    // the tile's online softmax for row gid, over the quad's 16 keys
    const int k0 = (t0 + i * WARPS) * L::KT;
    float sv[4], mt = LOWEST;
    bool on[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + 8 * (j / 2) + 2 * tig + j % 2;
      on[j] = key >= vis.lo && key <= vis.hi;
      sv[j] = vis.empty ? NEG_INF : s[j / 2][j % 2] * scale;
      if (on[j]) mt = fmaxf(mt, sv[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float mn = fmaxf(m, mt);             // finite: the tile visits a key
    const float alpha = expf(m - mn);
    m = mn;
    float p[4], ps = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[j] = on[j] ? expf(sv[j] - mn) : 0.f;
      ps += p[j];
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = l * alpha + ps;
    // p as the PV product's A fragment, rounded to bf16; keys outside [lo,
    // hi] add p = 0 times V = 0
    const uint32_t pa0 = pack_bf16(p[0], p[1]), pa2 = pack_bf16(p[2], p[3]);
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < KS; ++c) {
      uint32_t vf[4];   // matrices: keys 0-7 / 8-15 x chunks 2 c / 2 c + 1, transposed
      ldmatrix_x4_trans(vf, Vt + L::at((mat % 2) * 8 + mr, 2 * c + mat / 2));
      mma16816(o[2 * c], pa0, pa2, vf[0], vf[1]);
      mma16816(o[2 * c + 1], pa0, pa2, vf[2], vf[3]);
    }
    __syncwarp();                   // the slot is free for the next tile
  }
  cp_async_wait<0>();

  // this warp's (m, l, acc) of rows 0..7 into the start of its ring
  float* wpart = reinterpret_cast<float*>(wring);
  static_assert(sizeof(float) * MMA_ROWS * L::PART <= sizeof(bf16) * STAGES * L::STAGE,
                "a warp's partial fits in its ring");
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    wpart[gid * L::PART + 2 + 8 * n + 2 * tig] = o[n][0];
    wpart[gid * L::PART + 3 + 8 * n + 2 * tig] = o[n][1];
  }
  if (tig == 0) {
    wpart[gid * L::PART] = m;
    wpart[gid * L::PART + 1] = l;
  }
  __syncthreads();
  finish<bf16, MMA_ROWS, HDP>(smem_raw, verdict, out, part, tickets, vis, row0, gc, hd);
}

// ---------------------------------------------------------------------------
// f32: the SIMT pipes, IEEE f32
// ---------------------------------------------------------------------------

// E consecutive floats of shared memory, aligned to their size
template <int E>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[E]) {
  if constexpr (E == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  } else if constexpr (E == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    f[0] = x.x; f[1] = x.y;
  } else {
    f[0] = p[0];
  }
}

template <int GMAX, int HDP>
__global__ void __launch_bounds__(THREADS)
decode_attention_simt_f32(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ lens,
                          float* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ tickets, int S, int H, int Hk, int hd, int G,
                          int hchunks, int chunk, float scale, int window, bool vec) {
  using L = Tile<float, HDP>;
  constexpr int LPR = 32 / L::KT;            // lanes per key row (q.k)
  constexpr int CPL = L::CPR / LPR;          // chunks per lane (q.k)
  constexpr int E = HDP / 32;                // output columns per lane (PV)
  static_assert(CPL >= 1 && E >= 1 && E <= L::CH, "lane shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);                  // [WARPS][STAGES][STAGE]
  float* Qs = reinterpret_cast<float*>(smem_raw + ring_bytes<float, HDP>());   // [GMAX][HDP]
  float* Ps = Qs + GMAX * HDP;                                       // [WARPS][GMAX][KT]
  int* verdict = reinterpret_cast<int*>(Ps + WARPS * GMAX * L::KT);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hkv = blockIdx.x / hchunks;
  const int g0 = (blockIdx.x % hchunks) * GMAX;        // first q-head of this block
  const int gc = min(GMAX, G - g0);                    // q-heads this block owns
  const int b = blockIdx.z;
  const long long row0 = (long long)b * H + hkv * G + g0;   // [B, 1, H] flattened

  const Visit vis(lens[b], S, window, chunk, blockIdx.y);
  if (!vis.any) return;                                // no visited key in this chunk

  const int t0 = vis.a / L::KT + warp, t_last = vis.z / L::KT;
  const int ntiles = t0 <= t_last ? (t_last - t0) / WARPS + 1 : 0;
  const long long rs = (long long)Hk * hd;
  const float* kb = k + ((long long)b * S * Hk + hkv) * hd;
  const float* vb = v + ((long long)b * S * Hk + hkv) * hd;
  float* wring = ring + warp * STAGES * L::STAGE;
  auto issue = [&](int i) {
    if (i < ntiles)
      stage<float, HDP>(wring + (i % STAGES) * L::STAGE, kb, vb, rs, (t0 + i * WARPS) * L::KT,
                        vis.lo, vis.hi, hd, vec, lane);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  for (int i = tid; i < GMAX * HDP; i += THREADS) {
    const int g = i / HDP, d = i % HDP;
    Qs[i] = (g < gc && d < hd) ? q[(row0 + g) * hd + d] : 0.f;
  }
  __syncthreads();

  const int r = lane % L::KT, sub = lane / L::KT;      // q.k: key row r, chunks sub + j * LPR
  float* wps = Ps + warp * GMAX * L::KT;
  float m[GMAX], l[GMAX], acc[GMAX][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = LOWEST;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < ntiles; ++i) {
    issue(i + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const float* Kt = wring + (i % STAGES) * L::STAGE;
    const float* Vt = Kt + L::KT * HDP;
    const int key = (t0 + i * WARPS) * L::KT + r;
    const bool on = key >= vis.lo && key <= vis.hi;

    // s = q . k for each q-head, LPR lanes per key row, two FMA chains each
    float s[GMAX], s1[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = s1[g] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int ch = sub + j * LPR;
      const float4 kk = *reinterpret_cast<const float4*>(Kt + L::at(r, ch));
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + g * HDP + ch * L::CH);
        s[g] = fmaf(qq.x, kk.x, s[g]);
        s1[g] = fmaf(qq.y, kk.y, s1[g]);
        s[g] = fmaf(qq.z, kk.z, s[g]);
        s1[g] = fmaf(qq.w, kk.w, s1[g]);
      }
    }

    // the tile's online softmax, per q-head, over the KT rows
    float alpha[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float x = s[g] + s1[g];
#pragma unroll
      for (int off = L::KT; off < 32; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      const float sv = vis.empty ? NEG_INF : x * scale;
      float mt = on ? sv : LOWEST;
#pragma unroll
      for (int off = 1; off < L::KT; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[g], mt);                // finite: the tile visits a row
      alpha[g] = expf(m[g] - mn);
      m[g] = mn;
      const float p = on ? expf(sv - mn) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 1; off < L::KT; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[g] = l[g] * alpha[g] + ps;
      if (sub == 0) wps[g * L::KT + r] = p;
    }
    __syncwarp();

    // acc = acc * alpha + p V; rows outside [lo, hi] add p = 0 times V = 0
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha[g];
    const int d0 = lane * E;   // this lane's first output column
#pragma unroll
    for (int rr = 0; rr < L::KT; rr += 4) {
      float4 pg[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) pg[g] = *reinterpret_cast<const float4*>(wps + g * L::KT + rr);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vf[E];
        load_f32(Vt + L::at(rr + u, d0 / L::CH) + d0 % L::CH, vf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          const float pu = u == 0 ? pg[g].x : u == 1 ? pg[g].y : u == 2 ? pg[g].z : pg[g].w;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pu, vf[e], acc[g][e]);
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();

  float* wpart = wring;      // [GMAX][m, l, acc[HDP]]
  static_assert(GMAX * L::PART <= STAGES * L::STAGE, "a warp's partial fits in its ring");
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) wpart[g * L::PART + 2 + lane * E + e] = acc[g][e];
    if (lane == 0) {
      wpart[g * L::PART] = m[g];
      wpart[g * L::PART + 1] = l[g];
    }
  }
  __syncthreads();
  finish<float, GMAX, HDP>(smem_raw, verdict, out, part, tickets, vis, row0, gc, hd);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const int* lens;
  void* out;
  float* part;
  int* tickets;
  int B, S, H, Hk, hd, window, chunk;
  float scale;
  bool vec;
};

// The shared-memory limit of a kernel instance, set once a device.
template <typename Kern>
cudaError_t smem_limit(std::atomic<bool>* ready, Kern kern, size_t smem, int device) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (ready[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) ready[device].store(true, std::memory_order_release);
  return e;
}

dim3 grid_of(const Args& a, int heads_per_block, int* hchunks) {
  *hchunks = (a.H / a.Hk + heads_per_block - 1) / heads_per_block;
  const int nchunks = (int)((a.S + (long long)a.chunk - 1) / a.chunk);
  return dim3((unsigned)(a.Hk * *hchunks), (unsigned)nchunks, (unsigned)a.B);
}

template <int HDP>
cudaError_t launch_bf16(const Args& a, int device, cudaStream_t stream) {
  static std::atomic<bool> ready[MAX_DEVICES];
  constexpr size_t smem = ring_bytes<bf16, HDP>() + 16;
  cudaError_t e = smem_limit(ready, decode_attention_mma_bf16<HDP>, smem, device);
  if (e != cudaSuccess) return e;
  int hchunks = 0;
  const dim3 grid = grid_of(a, MMA_ROWS, &hchunks);
  decode_attention_mma_bf16<HDP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.lens, static_cast<bf16*>(a.out), a.part, a.tickets,
      a.S, a.H, a.Hk, a.hd, a.H / a.Hk, hchunks, a.chunk, a.scale, a.window, a.vec);
  return cudaGetLastError();
}

template <int GMAX, int HDP>
cudaError_t launch_f32(const Args& a, int device, cudaStream_t stream) {
  static std::atomic<bool> ready[MAX_DEVICES];
  constexpr size_t smem = ring_bytes<float, HDP>() +
                          sizeof(float) * (GMAX * HDP + WARPS * GMAX * Tile<float, HDP>::KT) +
                          16;
  cudaError_t e = smem_limit(ready, decode_attention_simt_f32<GMAX, HDP>, smem, device);
  if (e != cudaSuccess) return e;
  int hchunks = 0;
  const dim3 grid = grid_of(a, GMAX, &hchunks);
  decode_attention_simt_f32<GMAX, HDP><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.lens, static_cast<float*>(a.out), a.part, a.tickets,
      a.S, a.H, a.Hk, a.hd, a.H / a.Hk, hchunks, a.chunk, a.scale, a.window, a.vec);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t dispatch_f32(const Args& a, int device, cudaStream_t s) {
  const int G = a.H / a.Hk;   // q-heads per kv-head; a block takes up to 8 of them
  if (G == 1) return launch_f32<1, HDP>(a, device, s);
  if (G == 2) return launch_f32<2, HDP>(a, device, s);
  if (G == 3) return launch_f32<3, HDP>(a, device, s);   // llama3.2-3b: 24 over 8
  if (G == 4) return launch_f32<4, HDP>(a, device, s);
  return launch_f32<8, HDP>(a, device, s);
}

cudaError_t dispatch(const Args& a, int dtype, int device, cudaStream_t s) {
  if (dtype == 1) {
    if (a.hd <= 32) return launch_bf16<32>(a, device, s);
    if (a.hd <= 64) return launch_bf16<64>(a, device, s);
    return launch_bf16<128>(a, device, s);
  }
  if (a.hd <= 32) return dispatch_f32<32>(a, device, s);
  if (a.hd <= 64) return dispatch_f32<64>(a, device, s);
  return dispatch_f32<128>(a, device, s);
}

}  // namespace

extern "C" {

// q [B, 1, H, hd], k/v [B, S, Hk, hd], out [B, 1, H, hd], all contiguous and
// of one type (dtype 0 = f32, 1 = bf16); lens [B] int32; all on `device`;
// launches on `stream`.  The grid has ceil(S / chunk) chunks of keys a row;
// when it has more than one, part is f32 scratch of B * H * ceil(S / chunk)
// * (hd + 2) floats and tickets int32 of B * Hk * ceil(H / Hk / 8), zeros
// before the launch and again after it (else both are unused).  vec = 1
// when hd * element size is a multiple of 16 bytes and k, v are 16-byte
// aligned.  Needs 1 <= hd <= 128, H % Hk == 0, S >= 1, window >= 0, chunk a
// positive multiple of 64.  Returns the CUDA error code (0 = ok).
int repro_decode_attention(const void* q, const void* k, const void* v, const void* lens,
                           void* out, void* part, void* tickets, int dtype, long long B,
                           long long S, long long H, long long Hk, long long hd, float scale,
                           int window, int chunk, int vec, int device, void* stream) {
  cudaGetLastError();  // clear a stale error so the code below is this launch's
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0) return cudaSuccess;
  if (S <= 0 || chunk <= 0 || chunk % CHUNK_ALIGN != 0 || S + chunk > 0x7fffffffLL ||
      hd <= 0 || hd > 128 || Hk <= 0 || H % Hk != 0 || Hk * ((H / Hk + 7) / 8) > 65535 ||
      B > 65535 || window < 0 || B * H > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if ((S + chunk - 1) / chunk > 1 && (part == nullptr || tickets == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(lens), out, static_cast<float*>(part),
               static_cast<int*>(tickets), (int)B, (int)S, (int)H, (int)Hk, (int)hd, window,
               chunk, scale, vec != 0};
  return dispatch(a, dtype, device, static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
