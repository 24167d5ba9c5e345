// K8 — the Mamba-2 SSD chunked scan (state-space duality), for Hopper.
//
// Replaces the Pallas TPU kernel ``ssd_scan_pallas``
// (src/repro/kernels/ssd_scan.py).  Inputs x (B,S,H,P), B and C (B,S,G,N)
// in float32 or bfloat16 (one type for the three), dt (B,S,H), A (H,), D
// (H,) or none and the initial state h0 (B,H,P,N) or none, all float32;
// head h reads group h / (H/G).  Outputs y (B,S,H,P) in x's type and the
// final state (B,H,P,N) in float32.  For each chunk c of L rows:
//
//   cum   = cumsum(dt * A)
//   Δ_c   = (x·dt·exp(cum_L − cum))ᵀ · B               (the chunk's state)
//   s_c   = exp(cum_L) · s_{c−1} + Δ_c,   s_{−1} = h0
//   y     = (C·Bᵀ ∘ exp(cum_i − cum_j))_{j<=i} · (x·dt)
//         + exp(cum) ∘ (C · s_{c−1}ᵀ)  (+ D·x)
//
// The masked entries (j > i) are 0 and their exp is never taken.  A row
// with dt = 0 (the padded tail of a prompt chunk) adds nothing and decays
// nothing.
//
// Bound on the H100: at Mamba2-780m's one-shot prefill of 512 tokens (x
// (1,512,48,64) bf16, B/C (1,512,1,128)) the least work — C·Bᵀ once per
// group and chunk, the causal halves of the two L x L products, C·sᵀ and
// the state update — is about 1.0 GFLOP: 15 µs on the CUDA cores in
// float32, 1.0 µs on the tensor cores, where the 8.2 MB of operands (2.4
// µs) bound it instead.  What holds this kernel well above that is
// latency: each block's phases (copies, the scan of dt, products, stores)
// run one after another, and the causal rows of a chunk give its last
// warp eight times the first one's work.
//
// Design.  On the TPU the chunk axis is a sequential grid dimension and
// the state lives in VMEM between grid steps.  Here only a short pass
// carries the state; the rest runs across chunks at once, as Mamba-2's own
// GPU kernels split it (arXiv:2405.21060).  One call of the C entry makes
// three launches on one stream (no arrival counters, so no float atomics
// and the same bits every run):
//
//  1. chunk_state: a block of 4 warps per (b, chunk, head, 64 state rows
//     p, 64 columns of N) computes Δ_c for its tile and exp(cum_L).
//  2. state_pass: one thread per 4 state entries walks the chunks in order
//     (the loads for 8 chunks issued before the first store), writes the
//     state entering each chunk as bf16 terms, and the final state.
//  3. chunk_output: a block per (b, chunk, head, a tile of 128 y rows (64
//     for float32 inputs, or 64 where a batch row would get fewer than 66
//     blocks), 64 p) computes C·Bᵀ for its rows once — shared by every p
//     — 32 columns at a time (four independent MMA chains), the
//     decay-masked scores in registers as the A operand of scores·x, and
//     C·sᵀ; its tiles of C, B and x arrive by 16-byte cp.async, the state
//     over B's tile (a region of its own, copied during the intra-chunk
//     term, where two blocks still fit on an SM); y leaves through shared
//     memory in 16-byte rows.
//
// The wrapper picks the tiles from the shape, never from the batch, so a
// row's bits do not depend on the batch around it.  Larger tiles won on
// the card over more blocks: every row tile re-reads B, x and the state.
//
// Products run on the tensor cores (mma.sync m16n8k16, bf16 in, float32
// sums), every operand as bf16 planes in shared memory read by ldmatrix.
// bfloat16 x, B and C enter exactly as one term; a float32 operand (the
// scores scaled by dt, x·dt·exp(cum_L − cum), the state) is split into
// bf16 terms whose sum is it (2 terms with bf16 inputs, 16 significant
// bits), and float32 inputs into 3 terms (24 bits, all of float32); each
// product takes every pair of terms above float32's precision.  The sums
// over k are at most 8 MMAs of 16 deep, so the truncating accumulation of
// the tensor cores stays near float32's.
//
// The C entry launches on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_L = 128;     // the longest chunk
constexpr int MAX_N = 128;     // the widest state
constexpr int PT = 64;         // state rows p a block takes
constexpr int XS = PT + 8;     // row stride of an x plane
constexpr int CS_THREADS = 128;    // chunk_state: 4 warps of 16 p rows
constexpr int SP_THREADS = 256;    // state_pass
constexpr int SP_BATCH = 8;        // chunks whose loads state_pass issues
                                   // at once
constexpr int LOADS = 16;          // global loads in flight per thread

// the operand terms: IN for x, B and C as they come; MIX for a float32
// operand formed in the kernel; ROWS the most y rows a chunk_output block
// takes (its shared memory: float32 inputs take three planes)
template <typename T> struct Kind;
template <> struct Kind<float> {
  static constexpr int IN = 3, MIX = 3, ROWS = 64;
};
template <> struct Kind<bf16> {
  static constexpr int IN = 1, MIX = 2, ROWS = 128;
};

// Every operand of a product lies in shared memory as bf16 planes (one per
// term), rows padded by 8 elements: with a row of 16k elements the 8 rows
// an ldmatrix phase reads fall in distinct banks.
__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ constexpr int nk_of(int N) {   // 16-deep steps over N
  return round16(N) <= 64 ? 4 : 8;
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;      // may be null
  const float* h0;     // may be null
  void* y;
  float* state;
  float* ws;           // (batch, chunks, H, P, N): Δ_c
  bf16* sp;            // (batch, chunks, H, MIX, P, N): s_{c−1} in terms
  float* dec;          // (batch, chunks, H): exp(cum_L)
  int batch, seqlen, heads, P, groups, N, chunk;
  int row_tile;        // chunk_output's rows a block
  int n_cols;          // chunk_state's state columns a block (16, 32 or 64)
  bool vec;            // 16-byte copies of x, B and C are aligned
  bool own_state;      // chunk_output's state planes have their own region
};

// shared-memory bytes of chunk_state blocks: the operand planes (after
// the products, the staged Δ), then raw x, dt, cum and w
template <typename T>
__host__ __device__ inline size_t state_region(int L, int n_cols) {
  const int LP = round16(L);
  const size_t planes = ((size_t)Kind<T>::MIX * LP * XS +
                         (size_t)Kind<T>::IN * LP * (n_cols + 8)) *
                        sizeof(bf16);
  const size_t staged = (size_t)PT * (n_cols + 4) * sizeof(float);
  return planes > staged ? planes : staged;
}
template <typename T>
__host__ __device__ inline size_t state_smem(int L, int n_cols) {
  const int LP = round16(L);
  return state_region<T>(L, n_cols) + (size_t)LP * XS * sizeof(T) +
         3 * (size_t)LP * sizeof(float);
}
// chunk_output: C's planes and B's (later the state's; after the products
// the staged y), x's planes, dt and cum; B, x, dt and cum over rows
// rounded to 32 (two 16-column blocks at a time)
__host__ __device__ constexpr int round32(int v) { return (v + 31) & ~31; }
template <typename T>
__host__ __device__ inline size_t output_region(int L, int N, int row_tile) {
  using K = Kind<T>;
  const int LR = round32(L), CS = nk_of(N) * 16 + 8;
  const size_t planes = ((size_t)K::IN * row_tile * CS +
                         (size_t)imax(K::IN * LR, K::MIX * PT) * CS) *
                        sizeof(bf16);
  const size_t staged = (size_t)row_tile * (PT + 4) * sizeof(float);
  return planes > staged ? planes : staged;
}
// the state's planes in a region of their own (``own``), copied while the
// intra-chunk term runs, or over B's
template <typename T>
__host__ __device__ inline size_t state_planes(int N, bool own) {
  return own ? (size_t)Kind<T>::MIX * PT * (nk_of(N) * 16 + 8) * sizeof(bf16)
             : 0;
}
template <typename T>
__host__ __device__ inline size_t output_smem(int L, int N, int row_tile,
                                              bool own) {
  const int LR = round32(L);
  return output_region<T>(L, N, row_tile) + state_planes<T>(N, own) +
         (size_t)Kind<T>::IN * LR * XS * sizeof(bf16) +
         2 * (size_t)LR * sizeof(float);
}
// the most shared memory a block may take while two fit on an SM
constexpr size_t TWO_PER_SM = 113 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of T from 16 / sizeof(T) floats
template <typename T> __device__ __forceinline__ uint4 pack16(const float* v);
template <> __device__ __forceinline__ uint4 pack16<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <> __device__ __forceinline__ uint4 pack16<bf16>(const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[2 * i + 1]))
            << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// a and b (neighbours in a row) as K bf16 pairs whose sum is (a, b): term
// 0 the nearest bf16 pair (one cvt for both, a in the low half), each next
// term the nearest to what is left
template <int K>
__device__ __forceinline__ void split(float a, float b, uint32_t (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r[i]) : "f"(b), "f"(a));
    a = __fsub_rn(a, __uint_as_float(r[i] << 16));
    b = __fsub_rn(b, __uint_as_float(r[i] & 0xffff0000u));
  }
}

// four 8x8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans hands each lane a column pair instead
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The fragments of an m16n8k16 product, one term per plane (planes
// ``plane`` elements apart, rows ``s`` apart), from the tile at p:
// A 16x16 stored [m][k]; A stored [k][m]; B for two 8-column tiles stored
// [n][k]; B for two tiles stored [k][n].
template <int K>
__device__ __forceinline__ void frag_a(uint32_t (&a)[K][4], const bf16* p,
                                       int s, int plane, int lane) {
  p += (lane & 15) * s + 8 * (lane >> 4);
#pragma unroll
  for (int t = 0; t < K; ++t) ldsm(a[t], p + t * plane);
}
template <int K>
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[K][4], const bf16* p,
                                         int s, int plane, int lane) {
  const int q = lane >> 3;
  p += ((lane & 7) + 8 * (q >> 1)) * s + 8 * (q & 1);
#pragma unroll
  for (int t = 0; t < K; ++t) ldsm_t(a[t], p + t * plane);
}
template <int K>
__device__ __forceinline__ void frag_b2(uint32_t (&b)[2][K][2],
                                        const bf16* p, int s, int plane,
                                        int lane) {
  const int q = lane >> 3;
  p += ((lane & 7) + 8 * (q >> 1)) * s + 8 * (q & 1);
#pragma unroll
  for (int t = 0; t < K; ++t) {
    uint32_t r[4];
    ldsm(r, p + t * plane);
    b[0][t][0] = r[0];
    b[0][t][1] = r[1];
    b[1][t][0] = r[2];
    b[1][t][1] = r[3];
  }
}
template <int K>
__device__ __forceinline__ void frag_b2_t(uint32_t (&b)[2][K][2],
                                          const bf16* p, int s, int plane,
                                          int lane) {
  const int q = lane >> 3;
  p += ((lane & 7) + 8 * (q & 1)) * s + 8 * (q >> 1);
#pragma unroll
  for (int t = 0; t < K; ++t) {
    uint32_t r[4];
    ldsm_t(r, p + t * plane);
    b[0][t][0] = r[0];
    b[0][t][1] = r[1];
    b[1][t][0] = r[2];
    b[1][t][1] = r[3];
  }
}

// d += a·b, one m16n8k16 tile: a row-major 16x16, b 16x8 by columns
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b for an a of TA terms and a b of TB terms: every pair of terms
// whose indices sum below max(TA, TB) (the rest lie below float32's
// precision), the smallest first
template <int TA, int TB>
__device__ __forceinline__ void mma_terms(float (&d)[4],
                                          const uint32_t (&a)[TA][4],
                                          const uint32_t (&b)[TB][2]) {
  constexpr int T = TA > TB ? TA : TB;
#pragma unroll
  for (int i = TA - 1; i >= 0; --i)
#pragma unroll
    for (int j = TB - 1; j >= 0; --j)
      if (i + j < T) mma(d, a[i], b[j]);
}

// dst[r·ds + c] (r < rows, c < COLS, COLS a multiple of 16 bytes) =
// src[r·ss + c] where r < vr and c < vc, else 0: 16-byte cp.async copies
// the caller commits and waits for where ``vec`` (src rows 16-byte aligned,
// vc a multiple of 16 bytes), else plain loads
template <int COLS, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ds, const T* src,
                                           size_t ss, int rows, int vr,
                                           int vc, bool vec, int tid,
                                           int nthr) {
  constexpr int E = 16 / sizeof(T), q = COLS / E;
  for (int e = tid; e < rows * q; e += nthr) {
    const int r = e / q, c = (e - r * q) * E;
    T* d = dst + r * ds + c;
    if (vec) {
      const bool ok = r < vr && c < vc;
      async_copy::cp16(d, ok ? src + r * ss + c : src, ok);
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k)
        d[k] = r < vr && c + k < vc ? src[r * ss + c + k] : from_f<T>(0.f);
    }
  }
}

// four elements src[0..3] as float (the first ``valid`` of them, the rest
// 0): one 16- or 8-byte load when ``vec``
__device__ __forceinline__ float4 load4(const float* p, int valid, bool vec) {
  if (vec && valid >= 4) return *reinterpret_cast<const float4*>(p);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) v.x = p[0];
  if (valid > 1) v.y = p[1];
  if (valid > 2) v.z = p[2];
  if (valid > 3) v.w = p[3];
  return v;
}
__device__ __forceinline__ float4 load4(const bf16* p, int valid, bool vec) {
  if (vec && valid >= 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) v.x = to_f(p[0]);
  if (valid > 1) v.y = to_f(p[1]);
  if (valid > 2) v.z = to_f(p[2]);
  if (valid > 3) v.w = to_f(p[3]);
  return v;
}

// K planes (``plane`` elements apart) of dst[r·ds + c] (r < rows, c < COLS,
// COLS a multiple of 4): the terms of src[r·ss + c]·scale[r] (scale null:
// 1) where r < vr and c < vc, else 0.  Each thread keeps LOADS loads of
// four elements in flight; ``vec``: src rows aligned to four elements.
template <int K, int COLS, typename T>
__device__ __forceinline__ void split_rows(bf16* dst, int ds, int plane,
                                           const T* src, size_t ss, int rows,
                                           int vr, int vc, const float* scale,
                                           bool vec, int tid, int nthr) {
  constexpr int q = COLS / 4;
  const int total = rows * q;
  for (int base = tid; base < total; base += nthr * LOADS) {
    float4 v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = base + u * nthr, r = e / q, c = (e - r * q) * 4;
      v[u] = e < total && r < vr ? load4(src + r * ss + c, vc - c, vec)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = base + u * nthr, r = e / q, c = (e - r * q) * 4;
      if (e >= total) break;
      if (scale) {
        const float sc = r < vr ? scale[r] : 0.f;
        v[u] = make_float4(__fmul_rn(v[u].x, sc), __fmul_rn(v[u].y, sc),
                           __fmul_rn(v[u].z, sc), __fmul_rn(v[u].w, sc));
      }
      uint32_t lo[K], hi[K];
      split<K>(v[u].x, v[u].y, lo);
      split<K>(v[u].z, v[u].w, hi);
#pragma unroll
      for (int t = 0; t < K; ++t)
        *reinterpret_cast<uint2*>(dst + t * plane + r * ds + c) =
            make_uint2(lo[t], hi[t]);
    }
  }
}

// rows x COLS of T src into its IN planes: cp.async for bf16 (the caller
// commits and waits), split loads for float32
template <int COLS>
__device__ __forceinline__ void fill_in(bf16* dst, int ds, int plane,
                                       const bf16* src, size_t ss, int rows,
                                       int vr, int vc, bool vec, int tid,
                                       int nthr) {
  stage_rows<COLS>(dst, ds, src, ss, rows, vr, vc, vec, tid, nthr);
}
template <int COLS>
__device__ __forceinline__ void fill_in(bf16* dst, int ds, int plane,
                                       const float* src, size_t ss, int rows,
                                       int vr, int vc, bool vec, int tid,
                                       int nthr) {
  split_rows<3, COLS>(dst, ds, plane, src, ss, rows, vr, vc, nullptr, vec,
                      tid, nthr);
}


// the chunk's dt (0 past its L rows): 4-byte cp.async copies the caller
// commits and waits for; then cum = cumsum(dt·A)·scale over LP <= 128 rows
// by one warp (the caller syncs after)
__device__ __forceinline__ void load_dt(float* dts, const float* dtc, int H,
                                        int L, int LP, int tid, int nthr) {
  for (int i = tid; i < LP; i += nthr)
    async_copy::cp4(dts + i, i < L ? dtc + (size_t)i * H : dtc, i < L);
}
__device__ __forceinline__ void chunk_cumsum(const float* dts, float A_h,
                                             float* cum, int LP, int lane,
                                             float scale = 1.f) {
  float v[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {       // lane holds rows 4·lane + k
    const int i = 4 * lane + k;
    run = __fadd_rn(run, i < LP ? __fmul_rn(dts[i], A_h) : 0.f);
    v[k] = run;
  }
  float incl = run;                   // the lanes' totals, scanned
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = __fadd_rn(incl, t);
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (4 * lane + k < LP)
      cum[4 * lane + k] = __fmul_rn(__fadd_rn(before, v[k]), scale);
}

// the state entering the chunk into its MIX planes: rows pt0.. of the
// terms state_pass wrote (16-byte cp.async the caller commits), or, in a
// one-chunk launch (ONE), h0 itself split here
template <int MIX, int COLS, bool ONE>
__device__ __forceinline__ void fill_state(const Args& a, bf16* ss, int ds,
                                           const bf16* sg, int b, int h,
                                           int pt0, int tid, int nthr) {
  const int P = a.P, N = a.N;
  if (ONE) {
    split_rows<MIX, COLS>(ss, ds, PT * ds,
                          a.h0 + (((size_t)b * a.heads + h) * P + pt0) * N,
                          (size_t)N, PT, P - pt0, N, nullptr, N % 4 == 0, tid,
                          nthr);
    return;
  }
#pragma unroll
  for (int t = 0; t < MIX; ++t)
    stage_rows<COLS>(ss + t * PT * ds, ds, sg + (size_t)t * P * N, (size_t)N,
                    PT, P - pt0, N, N % 8 == 0, tid, nthr);
}

// ---------------------------------------------------------------------------
// 1. chunk_state: Δ_c[p, n] = Σ_j x[j, p]·w[j]·B[j, n], w = dt·exp(cum_L −
//    cum).  Grid (chunks·H, p tiles · column ranges, batch); warp w takes
//    16 state rows of the tile and every one of the 8·NT columns.  dt, x
//    and (bf16) B arrive by cp.async while the block scans dt; x·w goes
//    into its planes from shared memory; Δ leaves through shared memory in
//    16-byte rows.
// ---------------------------------------------------------------------------
template <typename T, int NT, bool ONE>
__device__ __forceinline__ void chunk_state(const Args& a,
                                            unsigned char* smem, int bx,
                                            int by, int b) {
  using K = Kind<T>;
  constexpr int NC = 8 * NT, BS = NC + 8, OS = NC + 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = a.heads, P = a.P, N = a.N, L = a.chunk, S = a.seqlen;
  const int G = a.groups, nc = S / L, LP = round16(L);
  const int c = bx / H, h = bx - c * H;
  const int npt = (P + PT - 1) / PT;
  const int pt0 = (by % npt) * PT, n0 = (by / npt) * NC;
  const int g = h / (H / G);
  bf16* xp = reinterpret_cast<bf16*>(smem);     // MIX planes LP x XS: x·w
  bf16* bp = xp + K::MIX * LP * XS;             // IN planes LP x BS: B
  float* ds = reinterpret_cast<float*>(smem);   // after the products: Δ,
                                                // PT x OS
  T* xr = reinterpret_cast<T*>(smem + state_region<T>(L, NC));  // LP x XS
  float* dts = reinterpret_cast<float*>(xr + LP * XS);
  float* cum = dts + LP;
  float* w = cum + LP;

  const float A_h = a.A[h];                     // in flight with the copies
  const size_t row0 = (size_t)b * S + (size_t)c * L;
  load_dt(dts, a.dt + row0 * H + h, H, L, LP, tid, CS_THREADS);
  async_copy::commit();
  stage_rows<PT>(xr, XS, static_cast<const T*>(a.x) + (row0 * H + h) * P +
                 pt0, (size_t)H * P, LP, L, P - pt0, a.vec, tid, CS_THREADS);
  fill_in<NC>(bp, BS, LP * BS, static_cast<const T*>(a.B) +
              (row0 * G + g) * N + n0, (size_t)G * N, LP, L, N - n0, a.vec,
              tid, CS_THREADS);
  async_copy::commit();
  async_copy::wait<1>();
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, A_h, cum, LP, lane);
  __syncthreads();
  const float total = cum[LP - 1];
  for (int i = tid; i < LP; i += CS_THREADS)
    w[i] = __fmul_rn(dts[i], expf(__fsub_rn(total, cum[i])));
  if (tid == 0 && by == 0 && !ONE)
    a.dec[((size_t)b * nc + c) * H + h] = expf(total);
  async_copy::wait<0>();
  __syncthreads();
  split_rows<K::MIX, PT>(xp, XS, LP * XS, static_cast<const T*>(xr),
                         (size_t)XS, LP, LP, PT, w, true, tid, CS_THREADS);
  __syncthreads();

  const int m0 = 16 * warp;                     // the warp's state rows
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  for (int kk = 0; kk < LP; kk += 16) {
    uint32_t af[K::MIX][4];                     // A[p][j] = (x·w)[j][p]
    frag_a_t<K::MIX>(af, xp + kk * XS + m0, XS, LP * XS, lane);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[2][K::IN][2];                 // B[k = j][n]
      frag_b2_t<K::IN>(bf, bp + kk * BS + nt * 8, BS, LP * BS, lane);
      mma_terms<K::MIX, K::IN>(acc[nt], af, bf[0]);
      mma_terms<K::MIX, K::IN>(acc[nt + 1], af, bf[1]);
    }
  }
  __syncthreads();                              // the planes are free
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(ds + (m0 + gid + 8 * hf) * OS + nt * 8 +
                                 2 * tig) =
          make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
  __syncthreads();
  // Δ_c to the workspace; with one chunk, the final state exp(cum_L)·h0
  // + Δ_0 instead
  constexpr bool fin = ONE;
  const size_t at = (((size_t)b * (fin ? 1 : nc) + c) * H + h) * P * N +
                    (size_t)pt0 * N + n0;
  float* out = (fin ? a.state : a.ws) + at;
  const float* h0 = fin && a.h0 ? a.h0 + at : nullptr;
  const float et = fin ? expf(total) : 0.f;
  const int vr = min(PT, P - pt0), vc = min(NC, N - n0);
  if (N % 4 == 0) {                             // 16-byte rows
    for (int e = tid; e < vr * (NC / 4); e += CS_THREADS) {
      const int r = e / (NC / 4), q = 4 * (e - r * (NC / 4));
      if (q >= vc) continue;
      float4 v = *reinterpret_cast<const float4*>(ds + r * OS + q);
      if (h0) {
        const float4 s0 = *reinterpret_cast<const float4*>(
            h0 + (size_t)r * N + q);
        v = make_float4(__fadd_rn(__fmul_rn(et, s0.x), v.x),
                        __fadd_rn(__fmul_rn(et, s0.y), v.y),
                        __fadd_rn(__fmul_rn(et, s0.z), v.z),
                        __fadd_rn(__fmul_rn(et, s0.w), v.w));
      }
      *reinterpret_cast<float4*>(out + (size_t)r * N + q) = v;
    }
  } else {
    for (int e = tid; e < vr * NC; e += CS_THREADS) {
      const int r = e / NC, q = e - r * NC;
      if (q >= vc) continue;
      float v = ds[r * OS + q];
      if (h0) v = __fadd_rn(__fmul_rn(et, h0[(size_t)r * N + q]), v);
      out[(size_t)r * N + q] = v;
    }
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(CS_THREADS) chunk_state_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  chunk_state<T, NT, false>(a, smem, blockIdx.x, blockIdx.y, blockIdx.z);
}

// ---------------------------------------------------------------------------
// 2. state_pass: s = h0; per chunk c in order, sp[c] <- the terms of s (when
//    a chunk_output block reads it), s <- dec_c·s + Δ_c; the final s is the
//    state out.  Grid (entries of a head / (V·SP_THREADS), batch·H); each
//    thread takes V neighbouring entries.
// ---------------------------------------------------------------------------
template <int V, int MIX>
__global__ void __launch_bounds__(SP_THREADS)
state_pass_kernel(const float* ws, const float* dec, const float* h0,
                  bf16* sp, float* state, int nc, int H, int PN) {
  const int e = (blockIdx.x * SP_THREADS + threadIdx.x) * V;
  if (e >= PN) return;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const size_t hpn = (size_t)H * PN;
  const float* wp = ws + (size_t)b * nc * hpn + (size_t)h * PN + e;
  bf16* spp = sp + ((size_t)b * nc * H + h) * MIX * PN + e;
  const float* dp = dec + (size_t)b * nc * H + h;
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = h0 ? h0[(size_t)bh * PN + e + v] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += SP_BATCH) {
    float t[SP_BATCH][V], d[SP_BATCH];
#pragma unroll
    for (int u = 0; u < SP_BATCH; ++u) {
      if (c0 + u >= nc) break;
      const float* src = wp + (size_t)(c0 + u) * hpn;
      if (V == 4) {
        const float4 f = *reinterpret_cast<const float4*>(src);
        t[u][0] = f.x;
        t[u][V > 1 ? 1 : 0] = f.y;
        t[u][V > 2 ? 2 : 0] = f.z;
        t[u][V > 3 ? 3 : 0] = f.w;
      } else {
        t[u][0] = src[0];
      }
      d[u] = dp[(size_t)(c0 + u) * H];
    }
#pragma unroll
    for (int u = 0; u < SP_BATCH; ++u) {
      const int c = c0 + u;
      if (c >= nc) break;
      if (c > 0 || h0) {          // chunk 0 without h0 reads no state
        bf16* dst = spp + (size_t)c * H * MIX * PN;
        if (V == 4) {
          uint32_t lo[MIX], hi[MIX];
          split<MIX>(s[0], s[V > 1 ? 1 : 0], lo);
          split<MIX>(s[V > 2 ? 2 : 0], s[V > 3 ? 3 : 0], hi);
#pragma unroll
          for (int k = 0; k < MIX; ++k)
            *reinterpret_cast<uint2*>(dst + (size_t)k * PN) =
                make_uint2(lo[k], hi[k]);
        } else {
          uint32_t r[MIX];
          split<MIX>(s[0], 0.f, r);
#pragma unroll
          for (int k = 0; k < MIX; ++k)
            dst[(size_t)k * PN] = __ushort_as_bfloat16((unsigned short)r[k]);
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v)
        s[v] = __fadd_rn(__fmul_rn(d[u], s[v]), t[u][v]);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) state[(size_t)bh * PN + e + v] = s[v];
}

// ---------------------------------------------------------------------------
// 3. chunk_output: y for rows r0..r0 + row_tile of chunk c and 64 p of head
//    h.  Grid (chunks·H, row tiles · p tiles, batch); warp w takes rows
//    r0 + 16w..+15: per 32 columns j <= its rows, G = C·Bᵀ (four 8-column
//    tiles over NK 16-deep steps of N), the scores G·exp(cum_i − cum_j)·dt_j
//    in registers as the A operand of scores·x; then, with the state's
//    terms copied over B's planes, C·sᵀ; y leaves through shared memory in
//    16-byte rows.
// ---------------------------------------------------------------------------
template <typename T, int NK, bool ONE>
__device__ __forceinline__ void chunk_output(const Args& a,
                                             unsigned char* smem, int bx,
                                             int by, int b) {
  using K = Kind<T>;
  constexpr int CS = NK * 16 + 8, YS = PT + 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthr = blockDim.x;
  const int gid = lane >> 2, tig = lane & 3;
  const int H = a.heads, P = a.P, N = a.N, L = a.chunk, S = a.seqlen;
  const int G = a.groups, nc = S / L, LR = round32(L), RT = a.row_tile;
  const int c = bx / H, h = bx - c * H;
  const int npt = (P + PT - 1) / PT;
  const int pt0 = (by % npt) * PT, r0 = (by / npt) * RT;
  const int jn = min(LR, round32(r0 + RT));      // B and x rows needed
  const int g = h / (H / G);
  bf16* cs = reinterpret_cast<bf16*>(smem);      // IN planes RT x CS: C
  bf16* bs = cs + K::IN * RT * CS;               // IN planes LR x CS: B,
                                                 // then MIX PT x CS: s
  float* ys = reinterpret_cast<float*>(smem);    // at the end: y, RT x YS
  bf16* ss = a.own_state ? reinterpret_cast<bf16*>(
                               smem + output_region<T>(L, N, RT))
                         : bs;                   // MIX planes PT x CS: s
  bf16* xs = reinterpret_cast<bf16*>(smem + output_region<T>(L, N, RT) +
                                     state_planes<T>(N, a.own_state));
  float* dts = reinterpret_cast<float*>(xs + K::IN * LR * XS);
  float* cum = dts + LR;
  const bool has_state = a.h0 != nullptr || c > 0;

  const float A_h = a.A[h];                      // in flight with the copies
  const float D_h = a.D ? a.D[h] : 0.f;
  const size_t row0 = (size_t)b * S + (size_t)c * L;
  const bf16* sg =                               // the state's terms
      ONE ? nullptr
          : a.sp + (((size_t)b * nc + c) * H + h) * K::MIX * P * N +
                (size_t)pt0 * N;
  const T* Cg = static_cast<const T*>(a.C) + (row0 * G + g) * N;
  const T* Bg = static_cast<const T*>(a.B) + (row0 * G + g) * N;
  const T* xg = static_cast<const T*>(a.x) + (row0 * H + h) * P + pt0;
  load_dt(dts, a.dt + row0 * H + h, H, L, LR, tid, nthr);
  async_copy::commit();
  fill_in<NK * 16>(cs, CS, RT * CS, Cg + (size_t)r0 * G * N, (size_t)G * N,
                   RT, L - r0, N, a.vec, tid, nthr);
  fill_in<NK * 16>(bs, CS, LR * CS, Bg, (size_t)G * N, jn, L, N, a.vec, tid,
                   nthr);
  fill_in<PT>(xs, XS, LR * XS, xg, (size_t)H * P, jn, L, P - pt0, a.vec, tid,
              nthr);
  async_copy::commit();
  if (a.own_state && has_state)
    fill_state<K::MIX, NK * 16, ONE>(a, ss, CS, sg, b, h, pt0, tid, nthr);
  async_copy::commit();
  async_copy::wait<2>();
  __syncthreads();
  if (warp == 0)               // in base 2: the decays are exp2 of sums
    chunk_cumsum(dts, A_h, cum, LR, lane, 1.4426950408889634f);
  async_copy::wait<1>();
  __syncthreads();

  const int i0 = r0 + 16 * warp;                 // the warp's first row
  const bool live = i0 < L;                      // warp-uniform
  const bf16* crow = cs + 16 * warp * CS;
  float acc[PT / 8][4];
#pragma unroll
  for (int t = 0; t < PT / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  if (live) {
    for (int j0 = 0; j0 <= i0 && j0 < L; j0 += 32) {
      const bool two = j0 + 16 <= i0 && j0 + 16 < L;   // warp-uniform
      float gacc[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t af[K::IN][4];                   // C[i][n]
        frag_a<K::IN>(af, crow + kk * 16, CS, RT * CS, lane);
        uint32_t bf[2][K::IN][2];                // B[k = n][j]
        frag_b2<K::IN>(bf, bs + j0 * CS + kk * 16, CS, LR * CS, lane);
        mma_terms<K::IN, K::IN>(gacc[0], af, bf[0]);
        mma_terms<K::IN, K::IN>(gacc[1], af, bf[1]);
        if (two) {
          frag_b2<K::IN>(bf, bs + (j0 + 16) * CS + kk * 16, CS, LR * CS,
                         lane);
          mma_terms<K::IN, K::IN>(gacc[2], af, bf[0]);
          mma_terms<K::IN, K::IN>(gacc[3], af, bf[1]);
        }
      }
      // the scores as the A operand over k = j0 + 16·hb..+15: register q
      // is row gid + 8(q & 1), columns 8(q >> 1) + 2·tig and the next
      uint32_t mf[2][K::MIX][4];
#pragma unroll
      for (int hb = 0; hb < 2; ++hb)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + gid + 8 * (q & 1);
          const int j = j0 + 16 * hb + 8 * (q >> 1) + 2 * tig;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = j + e <= i
                       ? __fmul_rn(
                             __fmul_rn(gacc[2 * hb + (q >> 1)][2 * (q & 1) + e],
                                       exp2f(cum[i] - cum[j + e])),
                             dts[j + e])
                       : 0.f;
          uint32_t t[K::MIX];
          split<K::MIX>(v[0], v[1], t);
#pragma unroll
          for (int i2 = 0; i2 < K::MIX; ++i2) mf[hb][i2][q] = t[i2];
        }
#pragma unroll
      for (int pn = 0; pn < PT / 8; pn += 2) {
        uint32_t bf[2][K::IN][2];                // x[k = j][p]
        frag_b2_t<K::IN>(bf, xs + j0 * XS + pn * 8, XS, LR * XS, lane);
        mma_terms<K::MIX, K::IN>(acc[pn], mf[0], bf[0]);
        mma_terms<K::MIX, K::IN>(acc[pn + 1], mf[0], bf[1]);
        if (two) {
          frag_b2_t<K::IN>(bf, xs + (j0 + 16) * XS + pn * 8, XS, LR * XS,
                           lane);
          mma_terms<K::MIX, K::IN>(acc[pn], mf[1], bf[0]);
          mma_terms<K::MIX, K::IN>(acc[pn + 1], mf[1], bf[1]);
        }
      }
    }
  }
  float inter[PT / 8][4];
#pragma unroll
  for (int t = 0; t < PT / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) inter[t][e] = 0.f;
  if (has_state) {                               // block-uniform
    if (!a.own_state) {
      __syncthreads();                           // B's planes are free
      fill_state<K::MIX, NK * 16, ONE>(a, ss, CS, sg, b, h, pt0, tid, nthr);
      async_copy::commit();
    }
    async_copy::wait<0>();
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t af[K::IN][4];                   // C[i][n]
        frag_a<K::IN>(af, crow + kk * 16, CS, RT * CS, lane);
#pragma unroll
        for (int pn = 0; pn < PT / 8; pn += 2) {
          uint32_t bf[2][K::MIX][2];             // s[p][k = n]
          frag_b2<K::MIX>(bf, ss + pn * 8 * CS + kk * 16, CS, PT * CS, lane);
          mma_terms<K::IN, K::MIX>(inter[pn], af, bf[0]);
          mma_terms<K::IN, K::MIX>(inter[pn + 1], af, bf[1]);
        }
      }
    }
  }
  __syncthreads();                               // every plane is free
  if (live) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = i0 + gid + 8 * hf;
      const float decay = has_state ? exp2f(cum[i]) : 0.f;
#pragma unroll
      for (int pn = 0; pn < PT / 8; ++pn) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[pn][2 * hf + e];
          if (has_state)
            v[e] = __fadd_rn(v[e], __fmul_rn(decay, inter[pn][2 * hf + e]));
        }
        *reinterpret_cast<float2*>(ys + (i - r0) * YS + pn * 8 + 2 * tig) =
            make_float2(v[0], v[1]);
      }
    }
  }
  __syncthreads();
  // y = staged + D·x, rows r0.. of the chunk, in rows of E elements
  constexpr int E = 16 / sizeof(T);
  const int vr = min(RT, L - r0), vc = min(PT, P - pt0);
  T* yg = static_cast<T*>(a.y) + ((row0 + r0) * H + h) * P + pt0;
  const T* xrow = xg + (size_t)r0 * H * P;
  for (int e = tid; e < vr * (PT / E); e += nthr) {
    const int r = e / (PT / E), q = E * (e - r * (PT / E));
    if (q >= vc) continue;
    const size_t off = (size_t)r * H * P + q;
    float v[E];
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = ys[r * YS + q + k];
    if (a.vec) {
      if (a.D) {
        const uint4 u = *reinterpret_cast<const uint4*>(xrow + off);
        float xf[E];
        async_copy::Chunk<T>::to_f32(u, xf);
#pragma unroll
        for (int k = 0; k < E; ++k)
          v[k] = __fadd_rn(v[k], __fmul_rn(D_h, xf[k]));
      }
      *reinterpret_cast<uint4*>(yg + off) = pack16<T>(v);
    } else {
      for (int k = 0; k < E && q + k < vc; ++k) {
        float o = v[k];
        if (a.D) o = __fadd_rn(o, __fmul_rn(D_h, to_f(xrow[off + k])));
        yg[off + k] = from_f<T>(o);
      }
    }
  }
}

template <typename T, int NK>
__global__ void __launch_bounds__(Kind<T>::ROWS / 16 * 32)
chunk_output_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  chunk_output<T, NK, false>(a, smem, blockIdx.x, blockIdx.y, blockIdx.z);
}

// a one-chunk call in one launch: blocks 0..n_state - 1 are chunk_state's
// (64 columns each), the rest chunk_output's (64 rows each), both 4 warps
template <typename T, int NK>
__global__ void __launch_bounds__(CS_THREADS) one_chunk_kernel(Args a,
                                                               int n_state) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npt = (a.P + PT - 1) / PT;
  if ((int)blockIdx.x < n_state) {
    const int per = a.heads * npt * ((a.N + 63) / 64);
    const int b = blockIdx.x / per, r = blockIdx.x - b * per;
    chunk_state<T, 8, true>(a, smem, r % a.heads, r / a.heads, b);
  } else {
    const int i = blockIdx.x - n_state;
    const int per = a.heads * npt * ((round16(a.chunk) + 63) / 64);
    const int b = i / per, r = i - b * per;
    chunk_output<T, NK, true>(a, smem, r % a.heads, r / a.heads, b);
  }
}

// the largest block's shared memory of a kernel, allowed once (a stream
// capture of a later launch then records the launches alone)
template <typename F>
cudaError_t allow_smem(F* fn, bool& allowed) {
  if (allowed) return cudaSuccess;
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  allowed = err == cudaSuccess;
  return err;
}

template <typename T, int NT>
cudaError_t launch_state(const Args& a, dim3 grid, cudaStream_t stream) {
  static bool allowed = false;
  const cudaError_t err = allow_smem(chunk_state_kernel<T, NT>, allowed);
  if (err != cudaSuccess) return err;
  chunk_state_kernel<T, NT><<<grid, CS_THREADS,
                              state_smem<T>(a.chunk, 8 * NT), stream>>>(a);
  return cudaSuccess;
}

template <typename T, int NK>
cudaError_t launch_output(const Args& a, dim3 grid, cudaStream_t stream) {
  static bool allowed = false;
  const cudaError_t err = allow_smem(chunk_output_kernel<T, NK>, allowed);
  if (err != cudaSuccess) return err;
  chunk_output_kernel<T, NK><<<grid, a.row_tile / 16 * 32,
                               output_smem<T>(a.chunk, a.N, a.row_tile,
                                              a.own_state),
                               stream>>>(a);
  return cudaSuccess;
}

template <typename T, int NK>
cudaError_t launch_one_chunk(const Args& a, int n_state, int n_out,
                             cudaStream_t stream) {
  static bool allowed = false;
  const cudaError_t err = allow_smem(one_chunk_kernel<T, NK>, allowed);
  if (err != cudaSuccess) return err;
  const size_t st = state_smem<T>(a.chunk, 64);
  const size_t out = output_smem<T>(a.chunk, a.N, 64, a.own_state);
  one_chunk_kernel<T, NK><<<n_state + n_out, CS_THREADS,
                            st > out ? st : out, stream>>>(a, n_state);
  return cudaSuccess;
}

// a one-chunk call at 64-row and 64-column tiles takes one launch (the
// wrapper's one_launch, which then allocates no workspaces)
inline bool one_launch(int seqlen, int chunk, int row_tile, int n_cols) {
  return seqlen == chunk && row_tile == 64 && n_cols == 64;
}

template <typename T>
int launch(Args a, cudaStream_t stream) {
  a.own_state =
      output_smem<T>(a.chunk, a.N, a.row_tile, true) <= TWO_PER_SM;
  const int nc = a.seqlen / a.chunk, LP = round16(a.chunk);
  const int npt = (a.P + PT - 1) / PT;
  const int nsplit = (a.N + a.n_cols - 1) / a.n_cols;
  const int rtiles = (LP + a.row_tile - 1) / a.row_tile;
  if (one_launch(a.seqlen, a.chunk, a.row_tile, a.n_cols)) {
    const int n_state = a.batch * a.heads * npt * nsplit;
    const int n_out = a.batch * a.heads * npt * rtiles;
    const cudaError_t err =
        nk_of(a.N) == 4 ? launch_one_chunk<T, 4>(a, n_state, n_out, stream)
                        : launch_one_chunk<T, 8>(a, n_state, n_out, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const dim3 sgrid(nc * a.heads, npt * nsplit, a.batch);
  cudaError_t err;
  switch (a.n_cols) {
    case 16: err = launch_state<T, 2>(a, sgrid, stream); break;
    case 32: err = launch_state<T, 4>(a, sgrid, stream); break;
    default: err = launch_state<T, 8>(a, sgrid, stream); break;
  }
  if (err != cudaSuccess) return (int)err;
  const int PN = a.P * a.N;
  constexpr int MIX = Kind<T>::MIX;
  if (PN % 4 == 0 && a.N % 4 == 0)
    state_pass_kernel<4, MIX>
        <<<dim3((PN / 4 + SP_THREADS - 1) / SP_THREADS, a.batch * a.heads),
           SP_THREADS, 0, stream>>>(a.ws, a.dec, a.h0, a.sp, a.state, nc,
                                    a.heads, PN);
  else
    state_pass_kernel<1, MIX>
        <<<dim3((PN + SP_THREADS - 1) / SP_THREADS, a.batch * a.heads),
           SP_THREADS, 0, stream>>>(a.ws, a.dec, a.h0, a.sp, a.state, nc,
                                    a.heads, PN);
  const dim3 ogrid(nc * a.heads, npt * rtiles, a.batch);
  err = nk_of(a.N) == 4 ? launch_output<T, 4>(a, ogrid, stream)
                        : launch_output<T, 8>(a, ogrid, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
bool valid_tiles(int row_tile, int n_cols) {
  return (row_tile == 16 || row_tile == 32 || row_tile == 64 ||
          row_tile == 128) && row_tile <= Kind<T>::ROWS &&
         (n_cols == 16 || n_cols == 32 || n_cols == 64);
}

template <typename T>
int attributes(int which, int chunk, int N, int row_tile, int n_cols,
               int* regs, int* smem) {
  cudaFuncAttributes fa;
  cudaError_t err;
  size_t dyn = 0;
  if (which == 0) {
    dyn = state_smem<T>(chunk, n_cols);
    err = n_cols == 16   ? cudaFuncGetAttributes(&fa, chunk_state_kernel<T, 2>)
          : n_cols == 32 ? cudaFuncGetAttributes(&fa, chunk_state_kernel<T, 4>)
                         : cudaFuncGetAttributes(&fa, chunk_state_kernel<T, 8>);
  } else if (which == 1) {
    err = cudaFuncGetAttributes(&fa, state_pass_kernel<4, Kind<T>::MIX>);
  } else if (which == 3) {
    const bool own = output_smem<T>(chunk, N, 64, true) <= TWO_PER_SM;
    const size_t st = state_smem<T>(chunk, 64);
    const size_t out = output_smem<T>(chunk, N, 64, own);
    dyn = st > out ? st : out;
    err = nk_of(N) == 4 ? cudaFuncGetAttributes(&fa, one_chunk_kernel<T, 4>)
                        : cudaFuncGetAttributes(&fa, one_chunk_kernel<T, 8>);
  } else {
    dyn = output_smem<T>(chunk, N, row_tile,
                         output_smem<T>(chunk, N, row_tile, true) <=
                             TWO_PER_SM);
    err = nk_of(N) == 4
              ? cudaFuncGetAttributes(&fa, chunk_output_kernel<T, 4>)
              : cudaFuncGetAttributes(&fa, chunk_output_kernel<T, 8>);
  }
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *smem = (int)(fa.sharedSizeBytes + dyn);
  return 0;
}

}  // namespace

// registers a thread and shared-memory bytes a block of chunk_state
// (which 0), state_pass (1), chunk_output (2) and one_chunk (3) at the
// given shape
extern "C" int ssd_scan_attributes(int is_bf16, int which, int chunk, int N,
                                   int row_tile, int n_cols, int* regs,
                                   int* smem) {
  return is_bf16 ? attributes<bf16>(which, chunk, N, row_tile, n_cols, regs,
                                    smem)
                 : attributes<float>(which, chunk, N, row_tile, n_cols, regs,
                                     smem);
}

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* D,
                               const void* h0, void* y, void* state,
                               void* ws, void* sp, void* dec, int batch,
                               int seqlen, int heads, int P, int groups,
                               int N, int chunk, int is_bf16, int row_tile,
                               int n_cols, void* stream) {
  if (chunk < 1 || chunk > MAX_L || N < 1 || N > MAX_N || seqlen % chunk ||
      !(is_bf16 ? valid_tiles<bf16>(row_tile, n_cols)
                : valid_tiles<float>(row_tile, n_cols)) ||
      reinterpret_cast<size_t>(sp) % 16 || reinterpret_cast<size_t>(ws) % 16)
    return (int)cudaErrorInvalidValue;
  // the workspaces, which a one-launch call does without
  if (!one_launch(seqlen, chunk, row_tile, n_cols) && !(ws && sp && dec))
    return (int)cudaErrorInvalidValue;
  const int E = is_bf16 ? 8 : 4;               // elements in 16 bytes
  const auto aligned = [](const void* p) {
    return reinterpret_cast<size_t>(p) % 16 == 0;
  };
  const bool vec = N % E == 0 && P % E == 0 && aligned(x) && aligned(B) &&
                   aligned(C);
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B,
         C, static_cast<const float*>(D), static_cast<const float*>(h0), y,
         static_cast<float*>(state), static_cast<float*>(ws),
         static_cast<bf16*>(sp), static_cast<float*>(dec), batch, seqlen,
         heads, P, groups, N, chunk, row_tile, n_cols, vec, false};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(a, s) : launch<float>(a, s);
}
