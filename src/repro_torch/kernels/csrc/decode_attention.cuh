// Device code shared by K3 (decode_attention.cu, a contiguous KV cache),
// K4 (paged_decode_attention.cu, a pool of KV blocks walked through a
// block table) and K7 (paged_decode_attention_q.cu, K4 over int8 pools
// with one float32 scale per row): one query token per sequence against
// the rows of its cache.  They differ only in where row p of sequence b
// and KV head kh lives, which the kernels take as a Rows functor,
// row(b, kh, p) -> the index of that row (in units of D elements), and in
// how a cache element becomes a float, a Scale policy: NoScale for K3 and
// K4, whose cache holds the values, RowScale for K7, which multiplies the
// int8 element by its row's scale (float(q8) * s, one float32 rounding).
// Everything else is one code, so at the same valid rows K4 computes K3's
// values step for step, and K7 on int8 rows computes K4's values on the
// float32 rows that hold float(q8) * s.
//
// q (B,H,D), lengths (B,) int32 read on the device.  Position p of
// sequence b is valid when p < lengths[b] and, with a window W,
// p >= lengths[b] - W.  All G = H/KH query heads of one KV head share
// each K/V tile (GQA; K/V are never repeated in memory).  A row with no
// valid key outputs 0.  q is float32 or bfloat16, the cache float32,
// bfloat16 or (K7) int8; all math is float32 (expf, no TF32), the output
// has q's type.  With an lse buffer (B,H) float32 a launch also writes
// each head's log-sum-exp of its scaled scores over the valid keys, m +
// log(l) from the block that writes the output, and -inf for a row with
// no valid key: what merges partial attentions over parts of the rows
// (a rank's rows of a sequence-sharded cache).  Without one (nullptr)
// the kernels run as they did before it existed: the same code path,
// the same arithmetic, one branch on the pointer where the output is
// written.
//
// What bounds it on the H100: the bytes of the valid K/V rows (7.3 MB at
// Yi-6B's decode step with lengths 1/37/1500/2048, 2.2 us at 3.35 TB/s).
// At B*KH = 16 (b, kv head) pairs what is left above that is latency: of
// getting the bytes in flight, of the arithmetic on them, and of
// combining per-block partials.  The design:
//  - one launch, one 256-thread block per (run of RUN = 128 positions, kv
//    head, b); the grid depends only on the shapes.  A block whose run
//    holds no valid position exits at once and writes nothing.
//  - tile t (32 rows) of the run belongs to warps 2t and 2t + 1, which
//    look up and copy its K and V rows to shared memory by 16-byte
//    cp.async (zero-filled outside the valid range) and then compute it on
//    their own, with no wait for the other tiles.  All four tiles' copies
//    are in flight at once.  Rows are an odd number of 16-byte chunks
//    apart, so lanes reading (or ldmatrix addressing) one chunk of eight
//    rows hit eight bank groups.
//  - bfloat16 q and cache (the serving path), G <= 16, D % 16 == 0: tensor
//    cores.  S = q.K^T by mma.sync m16n8k16 (bf16 products are exact,
//    float32 sums), the softmax on the fragments, and P.V with the
//    float32 P split into two bf16 operands, hi = bf16(P) and lo =
//    bf16(P - hi), each multiplied exactly and summed in float32 (P kept
//    to 16 bits, about 8e-6 relative).  Each warp of the pair takes 16 of
//    the tile's keys: their scores, softmax and P.V over every column.
//  - otherwise (float32; int8 (K7); bf16 off those shapes) CUDA cores:
//    each warp of the pair takes every other head, four at a time; lane j
//    scores key j from 16-byte chunks of its row, converted to float32
//    where read (int8: exactly, by a byte permute, times the row's scale),
//    against broadcast float4 reads of q, four FMA chains by d % 4; the
//    tile's softmax by shuffles; P.V with lane c summing columns
//    [4c, 4c + 4) of its four heads over the tile's keys in order.
//  - the parts' (m, l, acc) (tiles, or half tiles on tensor cores)
//    combine in key order.  Partials go to global memory only from runs
//    that hold valid positions, and not at all when one run holds them all
//    (that block writes the output).  Otherwise the last block of a
//    (b, kv head) to arrive, known by an arrival counter that it resets to
//    0, copies the partials into shared memory at once and combines them
//    in run order.  No float atomics: the result is the same bits on every
//    launch.
// The split of a sequence's positions and the choice of path depend only
// on S, the types, G and D, never on B, the slot or the other rows'
// lengths, so a row's output is the same alone or inside any batch.

#pragma once

#include <math.h>

#include "async_copy.cuh"

namespace decode_attn {

using bf16 = __nv_bfloat16;

constexpr int TILE = 32;               // K/V rows per tile, one key a lane
constexpr int TILES = 4;               // tiles of a run, all in flight
constexpr int RUN = TILE * TILES;      // cache positions per block (128)
constexpr int THREADS = 64 * TILES;    // two warps a tile
constexpr int MMA_MAX_G = 16;          // heads in one m16 fragment
constexpr int MAX_D = 128;
constexpr size_t MAX_SMEM = 232448;    // H100: 227 KB per block, opted in
constexpr float NEG_BIG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// K3, K4: the cache holds the values themselves
struct NoScale {
  static constexpr bool kScaled = false;
  __device__ __forceinline__ float2 row(long long) const {
    return make_float2(1.f, 1.f);
  }
};

// K7: one float32 scale per cache row (index r in units of D elements),
// read once per row; an element dequantizes as float(q8) * s
struct RowScale {
  static constexpr bool kScaled = true;
  const float* k_scale;
  const float* v_scale;
  __device__ __forceinline__ float2 row(long long r) const {
    return make_float2(__ldg(k_scale + r), __ldg(v_scale + r));
  }
};

// row p of (b, kv head) in a (P, KH, BS, D) pool through (B, T) tables
struct PagedRows {
  const int* tables;
  int KH, T, BS;
  __device__ __forceinline__ long long operator()(int b, int kvh,
                                                  int p) const {
    const long long block = tables[(long long)b * T + p / BS];
    return (block * KH + kvh) * BS + p % BS;
  }
};

inline int n_runs(int S) { return (S + RUN - 1) / RUN; }

// floats of workspace a call with these shapes needs: acc[D], m and l per
// (b, h, run)
inline long long workspace_floats(int B, int H, int S, int D) {
  return (long long)B * H * n_runs(S) * (D + 2);
}

template <typename TQ, typename TKV>
__host__ __device__ inline bool use_mma(int G, int D) {
  return sizeof(TQ) == 2 && sizeof(TKV) == 2 && G <= MMA_MAX_G &&
         D % 16 == 0;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// a K/V row of T in shared memory: nc 16-byte chunks, stored rb bytes
// apart (an odd number of chunks)
template <typename T>
struct RowShape {
  int nc, rb, qd;                       // qd: elements of nc chunks
  __host__ __device__ explicit RowShape(int D) {
    constexpr int N = async_copy::Chunk<T>::N;
    nc = (D + N - 1) / N;
    rb = 16 * (nc % 2 == 0 ? nc + 1 : nc);
    qd = nc * N;
  }
};

// byte offsets of one block's shared memory; both paths have the same
// regions, sized for the path
struct Layout {
  size_t k, v;      // the run's K and V rows as copied
  size_t q;         // MMA: 16 bf16 rows D + 8 apart; CUDA cores: float32
  size_t acc;       // each part's acc, [parts][G][lda] float32; a part is
                    // a tile (CUDA cores) or half a tile (tensor cores)
  size_t m, l, wgt; // each part's m, l and combining weight, [parts][G]
  size_t rm, rl;    // the run's m, l, [G]
  size_t p;         // CUDA cores: each warp's P, [warps][TILE][4]
  size_t sk, sv;    // K7: each row's scales, [RUN]
  size_t rows, flag, total;
  int lda;          // acc row stride, floats
};

// the last block stages the partials of up to FEW runs (acc, m, l, and
// the weights) in the regions from k to m, free once the run is done
constexpr int FEW = 16;

template <typename TQ, typename TKV>
__host__ __device__ inline Layout layout(int G, int D) {
  const bool mma = use_mma<TQ, TKV>(G, D);
  const RowShape<TKV> raw(D);
  const int qd4 = RowShape<float>(D).qd;
  Layout L;
  L.lda = qd4 + 8;
  size_t o = 0;
  L.k = o;     o += static_cast<size_t>(RUN) * raw.rb;
  L.v = o;     o += static_cast<size_t>(RUN) * raw.rb;
  L.q = o;     o += mma ? align16(sizeof(bf16) * MMA_MAX_G * (D + 8))
                        : align16(sizeof(float) * G * qd4);
  const int parts = mma ? 2 * TILES : TILES;
  L.acc = o;   o += align16(sizeof(float) * parts * G * L.lda);
  const size_t few = align16(sizeof(float) * G * (FEW * (D + 3) + 1));
  o = o > few ? o : few;
  L.m = o;     o += align16(sizeof(float) * parts * G);
  L.l = o;     o += align16(sizeof(float) * parts * G);
  L.wgt = o;   o += align16(sizeof(float) * parts * G);
  L.rm = o;    o += align16(sizeof(float) * G);
  L.rl = o;    o += align16(sizeof(float) * G);
  L.p = o;     o += mma ? 0 : sizeof(float) * (THREADS / 32) * TILE * 4;
  L.sk = o;    o += sizeof(float) * RUN;
  L.sv = o;    o += sizeof(float) * RUN;
  L.rows = o;  o += sizeof(long long) * RUN;
  L.flag = o;  o += 16;
  L.total = o;
  return L;
}

// the positions a block works on
struct Span {
  int lo, hi;                 // valid positions of the run
  int r_first, r_last;        // runs that hold valid positions
};

// the log-sum-exp of a head's scores from its (m, l): -inf without keys
__device__ __forceinline__ float lse_of(float m, float l) {
  return l == 0.f ? -INFINITY : m + logf(l);
}

// the block's span, or false when it has nothing to do; a sequence with no
// valid position gets its output of 0 (and lse of -inf) from run 0
template <typename TQ>
__device__ __forceinline__ bool block_span(const int* lengths, int b,
                                           int run, int S, int has_window,
                                           int window, TQ* o, int GD,
                                           float* lse, int G,
                                           int nthreads, Span& sp) {
  const int len = lengths[b];
  const int hi_all = min(len, S);
  int lo_all = 0;
  if (has_window)                       // 64-bit: len - window may overflow
    lo_all = static_cast<int>(
        min(max((long long)len - window, 0LL), (long long)S));
  if (lo_all >= hi_all) {
    if (run == 0) {
      for (int i = threadIdx.x; i < GD; i += nthreads) store(o + i, 0.f);
      if (lse)
        for (int g = threadIdx.x; g < G; g += nthreads) lse[g] = -INFINITY;
    }
    return false;
  }
  sp.r_first = lo_all / RUN;
  sp.r_last = (hi_all - 1) / RUN;
  if (run < sp.r_first || run > sp.r_last) return false;
  sp.lo = max(lo_all, run * RUN);
  sp.hi = min(hi_all, run * RUN + RUN);
  return true;
}

// copy run rows [r0, r0 + nrows) of K and V into staging by 16-byte
// cp.async (vec) or element by element; rows outside the span are zero
// (P = 0 there must meet V = 0, not whatever the buffer held) and read
// nothing.  nthreads threads, this one tix.
template <typename TKV>
__device__ __forceinline__ void copy_rows(
    const TKV* __restrict__ k, const TKV* __restrict__ v,
    unsigned char* ks, unsigned char* vs, const long long* row_at, int base,
    const Span& sp, int r0, int nrows, int D, int vec, int tix,
    int nthreads) {
  const RowShape<TKV> rs(D);
  constexpr int N = async_copy::Chunk<TKV>::N;
  if (vec) {
    const int per = max(1, nthreads / rs.nc);          // rows a pass
    const int sub = tix / rs.nc, c = tix % rs.nc;
    if (sub >= per) return;
    for (int j = r0 + sub; j < r0 + nrows; j += per) {
      const bool in = base + j >= sp.lo && base + j < sp.hi;
      const long long off = (in ? row_at[j] * D : 0) + c * N;
      const size_t at = static_cast<size_t>(j) * rs.rb + 16 * c;
      async_copy::cp16(ks + at, k + off, in);
      async_copy::cp16(vs + at, v + off, in);
    }
  } else {
    using Bits = async_copy::Bits<TKV>;
    for (int i = tix; i < nrows * rs.qd; i += nthreads) {
      const int j = r0 + i / rs.qd, e = i % rs.qd;
      const bool in = base + j >= sp.lo && base + j < sp.hi && e < D;
      const long long off = in ? row_at[j] * D + e : 0;
      const size_t at = static_cast<size_t>(j) * rs.rb;
      reinterpret_cast<Bits*>(ks + at)[e] =
          in ? reinterpret_cast<const Bits*>(k)[off] : Bits(0);
      reinterpret_cast<Bits*>(vs + at)[e] =
          in ? reinterpret_cast<const Bits*>(v)[off] : Bits(0);
    }
  }
}

// (row g, column d) of element i of a G x D array, for i = start, start +
// nt, ...: two divisions at the start, none a step
struct Walk {
  int g, d, dg, dd, D;
  __device__ __forceinline__ Walk(int start, int nt, int D_)
      : g(start / D_), d(start % D_), dg(nt / D_), dd(nt % D_), D(D_) {}
  __device__ __forceinline__ void next() {
    d += dd;
    g += dg;
    if (d >= D) {
      d -= D;
      ++g;
    }
  }
};

// the end of a block: racc (G rows ldr floats apart), rm, rl in shared
// memory hold the run's (acc, m, l).  One run: the output.  Otherwise the
// run's partial, and the last block to arrive combines all of them in run
// order; it stages them in `scratch` (the K/V rows' shared memory, free by
// now) by 16-byte cp.async, all in flight at once, when they fit, and
// reads them from L2 otherwise (the same arithmetic either way).  lse: the
// G heads' log-sum-exp slots, or nullptr.
// Workspace: acc [B*H*nrun][D], then m and l [B*H*nrun].
template <typename TQ>
__device__ __forceinline__ void finish(const float* racc, int ldr,
                                       const float* rm, const float* rl,
                                       TQ* __restrict__ o,
                                       float* __restrict__ lse, float* ws,
                                       int* counters, int* flag,
                                       unsigned char* scratch,
                                       const Span& sp, long long bh0, int b,
                                       int kvh, int KH, int H, int G, int D) {
  constexpr int NT = THREADS;
  const int tid = threadIdx.x;
  if (sp.r_first == sp.r_last) {        // one run holds every valid key
    Walk w(tid, NT, D);
    for (int i = tid; i < G * D; i += NT, w.next()) {
      const float l = rl[w.g];
      store(o + i, l == 0.f ? 0.f : racc[w.g * ldr + w.d] / l);
    }
    if (lse)
      for (int g = tid; g < G; g += NT) lse[g] = lse_of(rm[g], rl[g]);
    return;
  }
  // partials of head h at row (b * H + h) * nrun + run
  const int run = blockIdx.x, nrun = gridDim.x;
  const long long nrows = (long long)gridDim.z * H * nrun;
  float* part_acc = ws;
  float* part_m = ws + nrows * D;
  float* part_l = part_m + nrows;
  {
    Walk w(tid, NT, D);
    for (int i = tid; i < G * D; i += NT, w.next())
      part_acc[((bh0 + w.g) * nrun + run) * D + w.d] = racc[w.g * ldr + w.d];
  }
  for (int g = tid; g < G; g += NT) {
    part_m[(bh0 + g) * nrun + run] = rm[g];
    part_l[(bh0 + g) * nrun + run] = rl[g];
  }
  __threadfence();                      // partials visible before arrival
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + (long long)b * KH + kvh;
    const int last = atomicAdd(ctr, 1) == sp.r_last - sp.r_first;
    if (last) atomicExch(ctr, 0);       // every run arrived: reset
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // the last block combines the runs in run order
  const int n = sp.r_last - sp.r_first + 1;
  if (n <= FEW && D % 4 == 0) {          // [G][n][D], m, l, weights, l
    float* sa = reinterpret_cast<float*>(scratch);   // [G][n][D]
    float* sm = sa + (size_t)G * n * D;              // [G][n]
    float* sl = sm + G * n;
    // thread (row group, 16-byte chunk c) copies chunk c of every rpp-th
    // (head, run) row
    const int c4 = D / 4, rpp = NT / c4, c = tid % c4;
    if (tid / c4 < rpp) {
      Walk w(tid / c4, rpp, n);                      // (head w.g, run w.d)
      for (int gr = tid / c4; gr < G * n; gr += rpp, w.next())
        async_copy::cp16(
            sa + (size_t)gr * D + 4 * c,
            part_acc + ((bh0 + w.g) * nrun + sp.r_first + w.d) * D + 4 * c,
            true);
    }
    async_copy::commit();
    for (int i = tid; i < G * n; i += NT) {
      const long long at = (bh0 + i / n) * nrun + sp.r_first + i % n;
      sm[i] = __ldcg(part_m + at);
      sl[i] = __ldcg(part_l + at);
    }
    async_copy::wait<0>();
    __syncthreads();
    // the weights exp(m_r - m), one a thread, then each head's l; loops
    // over the runs unrolled, their loads issued together
    float* sw = sl + G * n;                          // [G][n], then l [G]
    for (int i = tid; i < G * n; i += NT) {
      const float* mg = sm + i / n * n;
      float m = NEG_BIG;
#pragma unroll
      for (int r = 0; r < FEW; ++r)
        if (r < n) m = fmaxf(m, mg[r]);
      sw[i] = expf(sm[i] - m);
    }
    __syncthreads();
    for (int g = tid; g < G; g += NT) {
      float l = 0.f;
#pragma unroll
      for (int r = 0; r < FEW; ++r)
        if (r < n) l = fmaf(sl[g * n + r], sw[g * n + r], l);
      sw[G * n + g] = l;
      if (lse) {
        float m = NEG_BIG;
#pragma unroll
        for (int r = 0; r < FEW; ++r)
          if (r < n) m = fmaxf(m, sm[g * n + r]);
        lse[g] = lse_of(m, l);
      }
    }
    __syncthreads();
    // four consecutive columns of one head a thread, each summed over the
    // runs in order, one float4 a run
    for (int u = tid; u < G * c4; u += NT) {
      const int g = u / c4, d0 = 4 * (u % c4);
      const float* src = sa + (size_t)g * n * D + d0;
      const float* wg = sw + g * n;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < FEW; ++r)
        if (r < n) {
          const float4 x = *reinterpret_cast<const float4*>(src + (size_t)r * D);
          const float w = wg[r];
          a.x = fmaf(x.x, w, a.x);
          a.y = fmaf(x.y, w, a.y);
          a.z = fmaf(x.z, w, a.z);
          a.w = fmaf(x.w, w, a.w);
        }
      const float l = sw[G * n + g];
      const float sum[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(o + g * D + d0 + e, l == 0.f ? 0.f : sum[e] / l);
    }
    return;
  }
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    const long long row0 = (bh0 + g) * nrun + sp.r_first;
    float m = NEG_BIG, l = 0.f, a = 0.f;
#pragma unroll 8
    for (int r = 0; r < n; ++r) m = fmaxf(m, __ldcg(part_m + row0 + r));
#pragma unroll 8
    for (int r = 0; r < n; ++r) {
      const float w = expf(__ldcg(part_m + row0 + r) - m);
      l = fmaf(__ldcg(part_l + row0 + r), w, l);
      a = fmaf(__ldcg(part_acc + (row0 + r) * D + d), w, a);
    }
    store(o + i, l == 0.f ? 0.f : a / l);
    if (lse && d == 0) lse[g] = lse_of(m, l);
  }
}

// the run's (acc, m, l) from its parts' in key order: weights
// exp(m_p - m), then l and acc; acc into part 0's rows
__device__ __forceinline__ void combine_parts(float* wacc, int lda,
                                              const float* wm, const float* wl,
                                              float* wgt, float* rm, float* rl,
                                              int parts, int G, int D) {
  constexpr int NT = THREADS;
  const int tid = threadIdx.x;
  for (int g = tid; g < G; g += NT) {
    float m = NEG_BIG;
#pragma unroll
    for (int p = 0; p < 2 * TILES; ++p)
      if (p < parts) m = fmaxf(m, wm[p * G + g]);
    float l = 0.f;
#pragma unroll
    for (int p = 0; p < 2 * TILES; ++p)
      if (p < parts) {
        const float x = expf(wm[p * G + g] - m);   // 0 for a part without keys
        wgt[p * G + g] = x;
        l = fmaf(wl[p * G + g], x, l);
      }
    rm[g] = m;
    rl[g] = l;
  }
  __syncthreads();
  // four columns of one head a thread, one float4 a part (lda is a
  // multiple of 4; columns past D are the rows' padding)
  const int d4 = (D + 3) / 4;
  for (int u = tid; u < G * d4; u += NT) {
    const int g = u / d4, at = g * lda + 4 * (u % d4);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < 2 * TILES; ++p)
      if (p < parts) {
        const float4 x =
            *reinterpret_cast<const float4*>(wacc + p * G * lda + at);
        const float w = wgt[p * G + g];
        a.x = fmaf(x.x, w, a.x);
        a.y = fmaf(x.y, w, a.y);
        a.z = fmaf(x.z, w, a.z);
        a.w = fmaf(x.w, w, a.w);
      }
    *reinterpret_cast<float4*>(wacc + at) = a;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the CUDA-core path
// ---------------------------------------------------------------------------

// four consecutive elements at p as float32
__device__ __forceinline__ void quad_f32(const unsigned char* p, float* f,
                                         float) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void quad_f32(const unsigned char* p, float* f,
                                         bf16) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(x.x << 16);
  f[1] = __uint_as_float(x.x & 0xffff0000u);
  f[2] = __uint_as_float(x.y << 16);
  f[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void quad_f32(const unsigned char* p, float* f,
                                         int8_t) {
  async_copy::i8x4_to_f32(*reinterpret_cast<const unsigned*>(p), f);
}

// 8 warps; warp w takes tile w / 2 of the run and the heads g = w % 2,
// w % 2 + 2, ..., four at a time.  Scores: lane j scores key j of the
// tile from 16-byte chunks of its K row (converted to float32 once a
// head group; K7: times the row's scale) and broadcast float4 reads of q,
// four FMA chains a head by d % 4.  The tile's softmax by shuffles.  P.V:
// lane c sums columns [4c, 4c + 4) of the four heads over the tile's 32
// keys, one float4 of P and one 4-element read of V a key.
template <typename TQ, typename TKV, typename Scale, typename Rows>
__global__ void __launch_bounds__(THREADS)
decode_simt_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, Scale scl, Rows rows,
                   const int* __restrict__ lengths, TQ* __restrict__ out,
                   float* __restrict__ lse_out, float* __restrict__ ws,
                   int* __restrict__ counters, int H, int KH, int S, int D,
                   float scale, int has_window, int window, int vec) {
  constexpr int NT = THREADS;
  constexpr int HG = 4;                 // heads a warp takes at once
  using Chunk = async_copy::Chunk<TKV>;
  constexpr int N = Chunk::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KH;
  const Layout L = layout<TQ, TKV>(G, D);
  const RowShape<TKV> raw(D);
  const int qd4 = RowShape<float>(D).qd;
  unsigned char* ks = smem + L.k;
  unsigned char* vs = smem + L.v;
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* wacc = reinterpret_cast<float*>(smem + L.acc);
  float* wm = reinterpret_cast<float*>(smem + L.m);
  float* wl = reinterpret_cast<float*>(smem + L.l);
  float* sk = reinterpret_cast<float*>(smem + L.sk);
  float* sv = reinterpret_cast<float*>(smem + L.sv);
  long long* row_at = reinterpret_cast<long long*>(smem + L.rows);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int run = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh0 = (long long)b * H + (long long)kvh * G;
  TQ* o = out + bh0 * D;                // the G heads' rows, contiguous
  float* lse = lse_out ? lse_out + bh0 : nullptr;
  Span sp;
  if (!block_span(lengths, b, run, S, has_window, window, o, G * D, lse, G,
                  NT, sp))
    return;
  const int base = run * RUN;

  // the warp pair of tile t looks up and copies its 32 rows (for K4 a
  // table load a row; rows outside the span are never addressed)
  const int t = warp >> 1, hh = warp & 1, pi = 32 * hh + lane;
  const int r0 = t * TILE, t0 = base + r0;
  const bool live = t0 < sp.hi && t0 + TILE > sp.lo;   // uniform in the pair
  if (hh == 0) {
    const int p = t0 + lane;
    row_at[r0 + lane] = p >= sp.lo && p < sp.hi ? rows(b, kvh, p) : 0;
  }
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + t) : "memory");
  if (live) copy_rows(k, v, ks, vs, row_at, base, sp, r0, TILE, D, vec, pi, 64);
  async_copy::commit();
  // while the copies fly: the rows' scales (K7), q as float32 (zero past D)
  if (Scale::kScaled && hh == 0) {
    const int p = t0 + lane;
    const float2 s = p >= sp.lo && p < sp.hi ? scl.row(row_at[r0 + lane])
                                             : make_float2(0.f, 0.f);
    sk[r0 + lane] = s.x;
    sv[r0 + lane] = s.y;
  }
#pragma unroll 4
  for (int i = tid; i < G * qd4; i += NT) {
    const int g = i / qd4, d = i % qd4;
    qs[i] = d < D ? to_f32(q[bh0 * D + g * D + d]) : 0.f;
  }
  __syncthreads();
  async_copy::wait<0>();
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + t) : "memory");

  const int jr = r0 + lane;             // this lane's key row
  const bool ok = t0 + lane >= sp.lo && t0 + lane < sp.hi;
  float* pw = reinterpret_cast<float*>(smem + L.p) + warp * TILE * 4;
  for (int g0 = hh; g0 < G; g0 += 2 * HG) {
    const int nh = min(HG, (G - g0 + 1) / 2);   // heads g0, g0 + 2, ...
    float dot[HG] = {0.f, 0.f, 0.f, 0.f};
    float mx[HG], l[HG];
    if (live) {
      float a[HG][4];
#pragma unroll
      for (int h = 0; h < HG; ++h) a[h][0] = a[h][1] = a[h][2] = a[h][3] = 0.f;
      const unsigned char* kr = ks + (size_t)jr * raw.rb;
      for (int c = 0; c < raw.nc; ++c) {
        float kf[N];
        Chunk::to_f32(async_copy::lds128(kr + 16 * c), kf);
        if (Scale::kScaled) {
          const float s = sk[jr];
#pragma unroll
          for (int e = 0; e < N; ++e) kf[e] *= s;
        }
#pragma unroll
        for (int e = 0; e < N; e += 4)
          if (c * N + e < qd4)
#pragma unroll
            for (int h = 0; h < HG; ++h)
              if (h < nh) {
                const float4 x = *reinterpret_cast<const float4*>(
                    qs + (g0 + 2 * h) * qd4 + c * N + e);
                a[h][0] = fmaf(x.x, kf[e], a[h][0]);
                a[h][1] = fmaf(x.y, kf[e + 1], a[h][1]);
                a[h][2] = fmaf(x.z, kf[e + 2], a[h][2]);
                a[h][3] = fmaf(x.w, kf[e + 3], a[h][3]);
              }
      }
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        const float s = ok ? ((a[h][0] + a[h][1]) + (a[h][2] + a[h][3])) * scale
                           : NEG_BIG;
        float m = s;
#pragma unroll
        for (int w = 16; w > 0; w >>= 1)
          m = fmaxf(m, __shfl_xor_sync(FULL, m, w));
        const float p = ok ? expf(s - m) : 0.f;
        float sum = p;
#pragma unroll
        for (int w = 16; w > 0; w >>= 1)
          sum += __shfl_xor_sync(FULL, sum, w);
        dot[h] = p;
        mx[h] = m;
        l[h] = sum;
      }
    } else {
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        mx[h] = NEG_BIG;
        l[h] = 0.f;
      }
    }
    *reinterpret_cast<float4*>(pw + 4 * lane) =
        make_float4(dot[0], dot[1], dot[2], dot[3]);
    __syncwarp();
    // P.V: lane c, columns [4c, 4c + 4), over the tile's keys in order
    for (int c = lane; 4 * c < qd4; c += 32) {
      float acc[HG][4];
#pragma unroll
      for (int h = 0; h < HG; ++h)
        acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;
      if (live)
#pragma unroll 4
        for (int j = 0; j < TILE; ++j) {
          const float4 p4 = *reinterpret_cast<const float4*>(pw + 4 * j);
          float x[4];
          quad_f32(vs + (size_t)(r0 + j) * raw.rb + 4 * c * sizeof(TKV), x,
                   TKV());
          if (Scale::kScaled) {
            const float s = sv[r0 + j];
#pragma unroll
            for (int e = 0; e < 4; ++e) x[e] *= s;
          }
          const float pj[HG] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int h = 0; h < HG; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[h][e] = fmaf(pj[h], x[e], acc[h][e]);
        }
#pragma unroll
      for (int h = 0; h < HG; ++h)
        if (h < nh)
          *reinterpret_cast<float4*>(wacc + (t * G + g0 + 2 * h) * L.lda +
                                     4 * c) =
              make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
    }
    if (lane == 0)
#pragma unroll
      for (int h = 0; h < HG; ++h)
        if (h < nh) {
          wm[t * G + g0 + 2 * h] = mx[h];
          wl[t * G + g0 + 2 * h] = l[h];
        }
    __syncwarp();                       // pw is rewritten by the next group
  }
  __syncthreads();
  float* rm = reinterpret_cast<float*>(smem + L.rm);
  float* rl = reinterpret_cast<float*>(smem + L.rl);
  combine_parts(wacc, L.lda, wm, wl, reinterpret_cast<float*>(smem + L.wgt),
                rm, rl, TILES, G, D);
  finish(wacc, L.lda, rm, rl, o, lse, ws, counters,
         reinterpret_cast<int*>(smem + L.flag), smem, sp, bh0, b, kvh, KH, H,
         G, D);
}

// ---------------------------------------------------------------------------
// the tensor-core path (bfloat16 q and cache)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);   // x in the low half
  return *reinterpret_cast<const unsigned*>(&h);
}

// 8 warps, the pair 2t, 2t + 1 copies tile t and computes it on its own
// (see the note at the top): both warps the tile's scores and softmax,
// each half of the columns of P.V; the tiles combine in tile order
template <typename Rows>
__global__ void __launch_bounds__(THREADS)
decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, Rows rows,
                  const int* __restrict__ lengths, bf16* __restrict__ out,
                  float* __restrict__ lse_out, float* __restrict__ ws,
                  int* __restrict__ counters, int H, int KH, int S, int D,
                  float scale, int has_window, int window, int vec) {
  constexpr int NT = THREADS;
  constexpr int KSTEPS = MAX_D / 16;    // 16-wide steps of D, at most
  constexpr int DTILES = MAX_D / 8;     // 8-wide output tiles, at most
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KH;
  const Layout L = layout<bf16, bf16>(G, D);
  const RowShape<bf16> raw(D);
  unsigned char* ks = smem + L.k;
  unsigned char* vs = smem + L.v;
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);    // 16 rows, D + 8 apart
  float* wacc = reinterpret_cast<float*>(smem + L.acc);
  float* wm = reinterpret_cast<float*>(smem + L.m);
  float* wl = reinterpret_cast<float*>(smem + L.l);
  long long* row_at = reinterpret_cast<long long*>(smem + L.rows);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int run = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh0 = (long long)b * H + (long long)kvh * G;
  bf16* o = out + bh0 * D;
  float* lse = lse_out ? lse_out + bh0 : nullptr;
  Span sp;
  if (!block_span(lengths, b, run, S, has_window, window, o, G * D, lse, G,
                  NT, sp))
    return;
  const int base = run * RUN;
  const int ldq = D + 8;

  // tile t: rows [32 t, 32 t + 32) of the run, looked up and copied by its
  // warp pair, which then waits for nobody else; warp 2t + h computes keys
  // [16 h, 16 h + 16) of it
  const int t = warp >> 1, dh = warp & 1;
  const int r0 = t * TILE;
  const int t0 = base + r0;
  const bool live = t0 < sp.hi && t0 + TILE > sp.lo;   // uniform in the pair
  if (dh == 0) {
    const int p = t0 + lane;
    row_at[r0 + lane] = (p >= sp.lo && p < sp.hi) ? rows(b, kvh, p) : 0;
  }
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + t) : "memory");
  if (live)
    copy_rows(k, v, ks, vs, row_at, base, sp, r0, TILE, D, vec,
              32 * dh + lane, 64);
  async_copy::commit();
  // q as 16 bf16 rows, zero past G, read by every warp: 16-byte loads
  // (element by element where q is not 16-byte aligned), all at once
  const int qc = D / 8;
#pragma unroll 2
  for (int i = tid; i < MMA_MAX_G * qc; i += NT) {
    const int g = i / qc, c = i % qc;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (g < G) {
      const bf16* src = q + (bh0 + g) * D + 8 * c;
      if (vec) {
        x = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        unsigned short e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = reinterpret_cast<const unsigned short*>(src)[j];
        x = make_uint4(e[0] | (unsigned)e[1] << 16, e[2] | (unsigned)e[3] << 16,
                       e[4] | (unsigned)e[5] << 16, e[6] | (unsigned)e[7] << 16);
      }
    }
    *reinterpret_cast<uint4*>(qs + g * ldq + 8 * c) = x;
  }
  __syncthreads();

  const int nk = D / 16;
  const int nd = D / 8;                 // 8-wide output column tiles
  const int lrow = lane >> 2;           // fragment row: head lrow, lrow + 8
  const int lcol = 2 * (lane & 3);      // fragment column pair
  const int mi = lane >> 3;             // which 8x8 matrix this lane addresses
  // this warp's part: keys [16 kh, 16 kh + 16) of the tile, part 2 t + kh
  const int kh = dh, part = 2 * t + kh;
  const int k0 = t0 + 16 * kh;
  const bool mine = k0 < sp.hi && k0 + 16 > sp.lo;     // uniform in the warp
  float m_a = NEG_BIG, m_b = NEG_BIG, l_a = 0.f, l_b = 0.f;
  float oc[DTILES][4];
#pragma unroll
  for (int n = 0; n < DTILES; ++n)
    oc[n][0] = oc[n][1] = oc[n][2] = oc[n][3] = 0.f;

  if (live) {
    async_copy::wait<0>();
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + t) : "memory");  // rows in
  }
  if (mine) {
    // q's A fragments: rows lane % 16, columns 16 kk + 8 (lane / 16)
    unsigned qa[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      if (kk < nk)
        ldsm_x4(qa[kk], qs + (lane & 15) * ldq + 16 * kk + 8 * (lane >> 4));

    // S = q K^T over the part's 16 keys: two 8-key n-tiles from one load
    // a step of D, every load before the products
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    unsigned bk[KSTEPS][4];
    const int key = r0 + 16 * kh + 8 * (mi >> 1) + (lane & 7);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      if (kk < nk)
        ldsm_x4(bk[kk], ks + static_cast<size_t>(key) * raw.rb +
                            2 * (16 * kk + 8 * (mi & 1)));
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      if (kk < nk) {
        mma_bf16(sc[0], qa[kk], bk[kk][0], bk[kk][1]);
        mma_bf16(sc[1], qa[kk], bk[kk][2], bk[kk][3]);
      }

    // the part's softmax, rows lrow (c0, c1) and lrow + 8 (c2, c3); every
    // exp taken (a masked score is NEG_BIG), then selected: no branch
    float mx_a = NEG_BIG, mx_b = NEG_BIG;
    bool ok[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = k0 + 8 * j + lcol + e;
        ok[j][e] = p >= sp.lo && p < sp.hi;
        sc[j][e] = ok[j][e] ? sc[j][e] * scale : NEG_BIG;
        sc[j][2 + e] = ok[j][e] ? sc[j][2 + e] * scale : NEG_BIG;
        mx_a = fmaxf(mx_a, sc[j][e]);
        mx_b = fmaxf(mx_b, sc[j][2 + e]);
      }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, w));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, w));
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ea = expf(sc[j][e] - mx_a);
        const float eb = expf(sc[j][2 + e] - mx_b);
        sc[j][e] = ok[j][e] ? ea : 0.f;
        sc[j][2 + e] = ok[j][e] ? eb : 0.f;
        l_a += sc[j][e];
        l_b += sc[j][2 + e];
      }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      l_a += __shfl_xor_sync(FULL, l_a, w);
      l_b += __shfl_xor_sync(FULL, l_b, w);
    }
    m_a = mx_a;
    m_b = mx_b;

    // acc = P.V over the part's keys and every column: P as A fragments,
    // split into hi = bf16(P) and lo = bf16(P - hi); V's B fragments by
    // ldmatrix.trans, two 8-column tiles a load; each tile hi, then lo
    unsigned hi[4], lo[4];
    const float x[4][2] = {{sc[0][0], sc[0][1]}, {sc[0][2], sc[0][3]},
                           {sc[1][0], sc[1][1]}, {sc[1][2], sc[1][3]}};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      hi[r] = pack_bf16(x[r][0], x[r][1]);
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[r]);
      lo[r] = pack_bf16(x[r][0] - __low2float(h), x[r][1] - __high2float(h));
    }
    const int vkey = r0 + 16 * kh + 8 * (mi & 1) + (lane & 7);
#pragma unroll
    for (int n = 0; n < DTILES; n += 2)
      if (n < nd) {
        unsigned bv[4];
        ldsm_x4_t(bv, vs + static_cast<size_t>(vkey) * raw.rb +
                          2 * (8 * n + 8 * (mi >> 1)));
        mma_bf16(oc[n], hi, bv[0], bv[1]);
        mma_bf16(oc[n + 1], hi, bv[2], bv[3]);
        mma_bf16(oc[n], lo, bv[0], bv[1]);
        mma_bf16(oc[n + 1], lo, bv[2], bv[3]);
      }
  }

  // each part's (m, l, acc) for the heads < G; lda = D + 8 puts the four
  // rows of a half-warp's float2 stores in distinct banks
  const int ga = lrow, gb = lrow + 8;
  if ((lane & 3) == 0) {
    if (ga < G) { wm[part * G + ga] = m_a; wl[part * G + ga] = l_a; }
    if (gb < G) { wm[part * G + gb] = m_b; wl[part * G + gb] = l_b; }
  }
#pragma unroll
  for (int n = 0; n < DTILES; ++n)
    if (n < nd) {
      const int d = 8 * n + lcol;
      if (ga < G)
        *reinterpret_cast<float2*>(wacc + (part * G + ga) * L.lda + d) =
            make_float2(oc[n][0], oc[n][1]);
      if (gb < G)
        *reinterpret_cast<float2*>(wacc + (part * G + gb) * L.lda + d) =
            make_float2(oc[n][2], oc[n][3]);
    }
  __syncthreads();
  float* rm = reinterpret_cast<float*>(smem + L.rm);
  float* rl = reinterpret_cast<float*>(smem + L.rl);
  combine_parts(wacc, L.lda, wm, wl, reinterpret_cast<float*>(smem + L.wgt),
                rm, rl, 2 * TILES, G, D);
  finish(wacc, L.lda, rm, rl, o, lse, ws, counters,
         reinterpret_cast<int*>(smem + L.flag), smem, sp, bh0, b, kvh, KH, H,
         G, D);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// the kernel a launch with these types and shapes runs
template <typename TQ, typename TKV, typename Scale, typename Rows>
const void* pick(int G, int D) {
  if constexpr (sizeof(TQ) == 2 && sizeof(TKV) == 2) {
    if (use_mma<TQ, TKV>(G, D))
      return reinterpret_cast<const void*>(decode_mma_kernel<Rows>);
  }
  return reinterpret_cast<const void*>(
      decode_simt_kernel<TQ, TKV, Scale, Rows>);
}

// One launch on ``stream``; returns cudaGetLastError().  S is the number
// of logical positions each sequence has; q and the output are TQ, the
// cache TKV.  ws holds workspace_floats(B, H, S, D) floats; counters
// B*KH ints that are 0 on entry and are left 0; lse B*H floats for the
// heads' log-sum-exp, or nullptr for none.
template <typename TQ, typename TKV, typename Scale, typename Rows>
int launch(const void* q, const void* k, const void* v, Scale scl, Rows rows,
           const int* lengths, void* out, float* ws, int* counters, int B,
           int H, int KH, int S, int D, float scale, int has_window,
           int window, cudaStream_t stream, float* lse = nullptr) {
  // opt in to more than 48 KB of shared memory once per device, type and
  // size, so steady-state launches (and CUDA-graph captures) make no call
  constexpr int MAX_DEVICES = 64;
  static size_t smem_opted_in[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  const int G = H / KH;
  const size_t smem = layout<TQ, TKV>(G, D).total;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = pick<TQ, TKV, Scale, Rows>(G, D);
  if (smem > smem_opted_in[device]) {
    // both kernels at once: either may run at this size next
    const void* fns[2] = {
        reinterpret_cast<const void*>(decode_simt_kernel<TQ, TKV, Scale, Rows>),
        fn};
    for (const void* f : fns) {
      err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    smem_opted_in[device] = smem;
  }
  // 16-byte copies need 16-byte rows at 16-byte addresses
  const int vec = (static_cast<size_t>(D) * sizeof(TKV)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const dim3 grid(n_runs(S), KH, B);
  if constexpr (sizeof(TQ) == 2 && sizeof(TKV) == 2) {
    if (use_mma<TQ, TKV>(G, D)) {
      decode_mma_kernel<Rows><<<grid, THREADS, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), rows, lengths, static_cast<bf16*>(out),
          lse, ws, counters, H, KH, S, D, scale, has_window, window, vec);
      return static_cast<int>(cudaGetLastError());
    }
  }
  decode_simt_kernel<TQ, TKV, Scale, Rows><<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), scl, rows, lengths, static_cast<TQ*>(out),
      lse, ws, counters, H, KH, S, D, scale, has_window, window, vec);
  return static_cast<int>(cudaGetLastError());
}

// the attributes of the kernel a launch with these types, G and D runs
template <typename TQ, typename TKV, typename Scale, typename Rows>
int attributes(int G, int D, int* regs, int* smem) {
  const void* fn = pick<TQ, TKV, Scale, Rows>(G, D);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *smem = static_cast<int>(layout<TQ, TKV>(G, D).total + a.sharedSizeBytes);
  return 0;
}

}  // namespace decode_attn
