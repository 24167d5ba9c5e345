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
// p >= lengths[b] - W.  All H/KH query heads of one KV head share each
// K/V tile (GQA; K/V are never repeated in memory).  A row with no valid
// key outputs 0.  q is float32 or bfloat16, the cache float32, bfloat16
// or (K7) int8; all math is float32 (expf, no TF32), the output has q's
// type.
//
// B*KH is small at decode (16 for Yi-6B at 4 slots), so one block per
// (b, kv head) would leave most of the 132 SMs idle: pass 1 splits the S
// logical positions into chunks of SPLIT, one 128-thread block per
// (chunk, kv head, b), each running the online softmax over its chunk
// (K/V staged TILE rows at a time in shared memory as float32, scores one
// key per lane, P.V one (head, column) pair per thread, each dot product
// as four interleaved FMA chains so shared-memory latency overlaps) and
// writing its partial (m, l, acc) to a float32 workspace.  Pass 2
// combines the partials of each (b, h) in chunk order, so the result does
// not depend on block scheduling (no atomics: the kernel is
// deterministic).  Chunks outside a row's valid range exit at once, and
// no row (nor, for K4, table entry) past the valid range is read; the
// grid depends only on the shapes.  Tensor cores, vector loads, TMA and a
// load pipeline are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_attn {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SPLIT = 32;              // cache positions per pass-1 block
constexpr int TILE = 32;               // K/V rows in shared memory at once
constexpr int MAX_D = 128;
constexpr int COLS = MAX_D / 32;       // columns of a K/V row per lane
constexpr size_t MAX_SMEM = 232448;    // H100: 227 KB per block, opted in
constexpr float NEG_BIG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// K3, K4: the cache holds the values themselves
struct NoScale {
  struct Row {};
  __device__ __forceinline__ Row row(long long) const { return {}; }
  __device__ __forceinline__ float key(Row, float x) const { return x; }
  __device__ __forceinline__ float value(Row, float x) const { return x; }
};

// K7: one float32 scale per cache row (index r in units of D elements),
// read once per row; an element dequantizes as float(q8) * s
struct RowScale {
  const float* k_scale;
  const float* v_scale;
  struct Row { float k, v; };
  __device__ __forceinline__ Row row(long long r) const {
    return {__ldg(k_scale + r), __ldg(v_scale + r)};
  }
  __device__ __forceinline__ float key(Row s, float x) const {
    return x * s.k;
  }
  __device__ __forceinline__ float value(Row s, float x) const {
    return x * s.v;
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

inline int n_splits(int S) { return (S + SPLIT - 1) / SPLIT; }

// floats of workspace a call with these shapes needs: (m, l, acc[D]) per
// (b, h, chunk)
inline long long workspace_floats(int B, int H, int S, int D) {
  return (long long)B * H * n_splits(S) * (D + 2);
}

inline size_t smem_bytes(int G, int D) {
  // q, acc: G x D; K tile: TILE x (D + 1); V tile: TILE x D;
  // P: G x TILE; running max, running sum, rescale: G each
  return sizeof(float) *
         (static_cast<size_t>(2 * G) * D + static_cast<size_t>(TILE) * (D + 1) +
          static_cast<size_t>(TILE) * D + static_cast<size_t>(G) * TILE +
          3 * static_cast<size_t>(G));
}

template <typename TQ, typename TKV, typename Scale, typename Rows>
__global__ void __launch_bounds__(THREADS)
decode_partial_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                      const TKV* __restrict__ v, Scale scl, Rows rows,
                      const int* __restrict__ lengths,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int H, int KH, int S,
                      int D, float scale, int has_window, int window) {
  extern __shared__ float smem[];
  const int G = H / KH;
  const int ld = D + 1;                 // odd stride: no bank conflicts
  float* qs = smem;                     // G x D
  float* acc = qs + G * D;              // G x D
  float* ks = acc + G * D;              // TILE x ld
  float* vs = ks + TILE * ld;           // TILE x D
  float* ps = vs + TILE * D;            // G x TILE
  float* ms = ps + G * TILE;            // G
  float* ls = ms + G;                   // G
  float* als = ls + G;                  // G

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int nsplit = gridDim.x;

  // this block's positions: its chunk, cut to the row's valid range
  const int len = lengths[b];
  int lo = split * SPLIT;
  if (has_window)                       // 64-bit: len - window may overflow
    lo = static_cast<int>(
        min(max((long long)lo, (long long)len - window), (long long)S));
  const int hi = min(min(split * SPLIT + SPLIT, S), len);

  // where each valid row of the chunk lives, looked up once per block
  // (for K4 a table load) while the other warps load q; only rows inside
  // [lo, hi) are looked up
  __shared__ long long row_at[SPLIT];
  const int c0 = split * SPLIT;
  for (int j = tid; j < SPLIT; j += THREADS)
    if (c0 + j >= lo && c0 + j < hi) row_at[j] = rows(b, kvh, c0 + j);
  const long long q_base = ((long long)b * H + (long long)kvh * G) * D;
#pragma unroll 4
  for (int i = tid; i < G * D; i += THREADS) {
    qs[i] = to_f32(q[q_base + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG_BIG;
    ls[g] = 0.f;
  }

  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int nt = min(TILE, hi - t0);
    __syncthreads();                    // q loaded / last tile consumed
    // lanes along a row, warps down the rows; every load of the tile is
    // issued before the first store, so their latencies overlap.  Only
    // rows inside [t0, hi) are addressed at all.
    float kreg[TILE / WARPS][COLS], vreg[TILE / WARPS][COLS];
#pragma unroll
    for (int i = 0; i < TILE / WARPS; ++i) {
      const int r = warp + i * WARPS;
      const bool rin = r < nt;
      const long long at = rin ? row_at[t0 + r - c0] : 0;
      const long long row = at * D;
      const typename Scale::Row sr = scl.row(at);
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = lane + 32 * j;
        const bool in = rin && c < D;
        kreg[i][j] = in ? scl.key(sr, to_f32(k[row + c])) : 0.f;
        vreg[i][j] = in ? scl.value(sr, to_f32(v[row + c])) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < TILE / WARPS; ++i) {
      const int r = warp + i * WARPS;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = lane + 32 * j;
        if (c < D) {
          ks[r * ld + c] = kreg[i][j];
          vs[r * D + c] = vreg[i][j];
        }
      }
    }
    __syncthreads();

    // scores and the online-softmax update: warp w takes heads w,
    // w + WARPS, ...; lane j scores key t0 + j
    for (int g = warp; g < G; g += WARPS) {
      const float* qg = qs + g * D;
      const float* kr = ks + lane * ld;
      // four partial sums: four independent FMA chains in flight
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
      int d = 0;
      for (; d + 4 <= D; d += 4) {
        d0 = fmaf(qg[d], kr[d], d0);
        d1 = fmaf(qg[d + 1], kr[d + 1], d1);
        d2 = fmaf(qg[d + 2], kr[d + 2], d2);
        d3 = fmaf(qg[d + 3], kr[d + 3], d3);
      }
      for (; d < D; ++d) d0 = fmaf(qg[d], kr[d], d0);
      const float dot = (d0 + d1) + (d2 + d3);
      const bool ok = lane < nt;
      const float s = ok ? dot * scale : NEG_BIG;
      float tmax = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, o));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, tmax);
      const float p = ok ? expf(s - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(FULL, psum, o);
      ps[g * TILE + lane] = p;
      __syncwarp();                     // every lane read ms[g] above
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        als[g] = alpha;
        ls[g] = ls[g] * alpha + psum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V, one (head, column) pair per thread
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      const float* pg = ps + g * TILE;
      const float* vd = vs + d;
      // rows past nt hold P = 0 and V = 0: the full tile adds nothing
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int j = 0; j < TILE; j += 4) {
        a0 = fmaf(pg[j], vd[j * D], a0);
        a1 = fmaf(pg[j + 1], vd[(j + 1) * D], a1);
        a2 = fmaf(pg[j + 2], vd[(j + 2) * D], a2);
        a3 = fmaf(pg[j + 3], vd[(j + 3) * D], a3);
      }
      acc[i] = fmaf(acc[i], als[g], (a0 + a1) + (a2 + a3));
    }
  }
  __syncthreads();

  // partials of head h at [(b * H + h) * nsplit + split]
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    const long long row = ((long long)b * H + kvh * G + g) * nsplit + split;
    part_acc[row * D + d] = acc[i];
  }
  for (int g = tid; g < G; g += THREADS) {
    const long long row = ((long long)b * H + kvh * G + g) * nsplit + split;
    part_m[row] = ms[g];
    part_l[row] = ls[g];
  }
}

// one block per (b, h), thread d: combine the chunks in chunk order
template <typename T>
__global__ void __launch_bounds__(MAX_D)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      T* __restrict__ out, int nsplit, int D) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + bh * nsplit;
  const float* pl = part_l + bh * nsplit;
  float m = NEG_BIG;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, pm[s]);
  float l = 0.f, a = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(pm[s] - m);    // 0 for an empty chunk
    l = fmaf(pl[s], w, l);
    if (d < D) a = fmaf(part_acc[(bh * nsplit + s) * D + d], w, a);
  }
  if (d < D) store(&out[bh * D + d], l == 0.f ? 0.f : a / l);
}

// Both passes on ``stream``; returns cudaGetLastError() of the launches.
// S is the number of logical positions each sequence has; q and the
// output are TQ, the cache TKV.
template <typename TQ, typename TKV, typename Scale, typename Rows>
int launch(const void* q, const void* k, const void* v, Scale scl, Rows rows,
           const int* lengths, void* out, float* ws, int B, int H, int KH,
           int S, int D, float scale, int has_window, int window,
           cudaStream_t stream) {
  // opt in to more than 48 KB of shared memory once per device, type and
  // size, so steady-state launches (and CUDA-graph captures) make no call
  constexpr int MAX_DEVICES = 64;
  static size_t smem_opted_in[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  const size_t smem = smem_bytes(H / KH, D);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > smem_opted_in[device]) {
    err = cudaFuncSetAttribute(decode_partial_kernel<TQ, TKV, Scale, Rows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opted_in[device] = smem;
  }
  const int nsplit = n_splits(S);
  const long long nrows = (long long)B * H * nsplit;
  float* part_m = ws;
  float* part_l = ws + nrows;
  float* part_acc = ws + 2 * nrows;
  const dim3 grid(nsplit, KH, B);
  decode_partial_kernel<TQ, TKV, Scale, Rows><<<grid, THREADS, smem,
                                                 stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), scl, rows, lengths, part_m, part_l,
      part_acc, H, KH, S, D, scale, has_window, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<TQ><<<B * H, MAX_D, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<TQ*>(out), nsplit, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode_attn
