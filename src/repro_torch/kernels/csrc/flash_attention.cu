// K2 flash_attention: online-softmax attention over q (B,H,S,D) and
// k, v (B,KH,S,D), with causal masking, an optional sliding window
// (key j valid for query i when j > i - window) and GQA (the KV head of
// query head h is h / (H / KH); K/V are never repeated in memory).  A
// row with no valid key outputs 0.  Inputs are float32 or bfloat16; all
// math is float32 (expf, no TF32), the output has the input's type.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py).
//
// Bound on the H100: 4*B*H*S*S*D operations (halved by the causal mask)
// against reading q, k, v and writing o once; at the micro path's shape
// (2,4,256,64) that is a few microseconds of either, so launch latency
// and occupancy bound it.  This first version is the simple one: one
// 256-thread block per (b, h, 64-row q tile); a loop over 64-row K/V
// tiles staged in shared memory (converted to f32 there) carries the
// online-softmax state (m, l, acc) in registers, four threads per query
// row.  Tiles that the causal or window mask empties for the whole q
// tile are never loaded.  Scores and P.V run on CUDA cores in f32;
// tensor-core MMA and a K/V load pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;                  // query rows per block
constexpr int BKV = 64;                 // key rows per tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;       // threads per query row (4)
constexpr int COLS = BKV / TPR;         // score columns per thread (16)
constexpr int MAX_D = 128;
constexpr int DCOLS = MAX_D / TPR;      // output columns per thread (<=32)
constexpr float NEG_BIG = -1e30f;       // the reference's mask value

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

size_t smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BKV) * ld +
                          static_cast<size_t>(BQ) * (BKV + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int H, int KH, int S, int D, float scale, int causal,
                       int has_window, int window) {
  extern __shared__ float smem[];
  const int ld = D + 1;                 // odd stride: no bank conflicts
  const int lp = BKV + 1;
  float* qs = smem;                     // BQ  x ld
  float* ks = qs + BQ * ld;             // BKV x ld
  float* vs = ks + BKV * ld;            // BKV x ld
  float* ps = vs + BKV * ld;            // BQ  x lp

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;            // lanes sub..sub+3 share a row
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const long long q_base = ((long long)b * H + h) * S * D;
  const long long kv_base = ((long long)b * KH + kvh) * S * D;
  const int qpos = q0 + row;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    qs[r * ld + c] =
        (q0 + r < S) ? to_f32(q[q_base + (long long)(q0 + r) * D + c]) : 0.f;
  }

  // key tiles that can hold a valid key for some row of this q tile
  int kt_end = (S + BKV - 1) / BKV;
  if (causal) kt_end = min(kt_end, (min(q0 + BQ, S) - 1) / BKV + 1);
  int kt_begin = 0;
  if (has_window) {
    const long long first_key = (long long)q0 - window + 1;
    if (first_key > 0)
      kt_begin = first_key < S ? static_cast<int>(first_key / BKV) : kt_end;
  }

  float m = NEG_BIG;
  float l = 0.f;
  float acc[DCOLS];
#pragma unroll
  for (int j = 0; j < DCOLS; ++j) acc[j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();                    // q loaded / last tile consumed
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < S;
      const long long off = kv_base + (long long)(k0 + r) * D + c;
      ks[r * ld + c] = in ? to_f32(k[off]) : 0.f;
      vs[r * ld + c] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float s[COLS];
    unsigned valid = 0;
    float tile_max = NEG_BIG;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = sub + TPR * j;
      const int kpos = k0 + c;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qs[row * ld + d], ks[c * ld + d], dot);
      bool ok = kpos < S;
      if (causal) ok = ok && kpos <= qpos;
      if (has_window) ok = ok && (long long)kpos > (long long)qpos - window;
      s[j] = ok ? dot * scale : NEG_BIG;
      valid |= static_cast<unsigned>(ok) << j;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const float p = ((valid >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      ps[row * lp + sub + TPR * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();                       // the row's P is written by its warp

#pragma unroll
    for (int jj = 0; jj < DCOLS; ++jj) {
      const int d = sub + TPR * jj;
      if (d < D) {
        float a = acc[jj] * alpha;
        for (int c = 0; c < BKV; ++c) a = fmaf(ps[row * lp + c], vs[c * ld + d], a);
        acc[jj] = a;
      }
    }
  }

  if (qpos < S) {
    const float denom = (l == 0.f) ? 1.f : l;   // fully masked row -> 0
#pragma unroll
    for (int jj = 0; jj < DCOLS; ++jj) {
      const int d = sub + TPR * jj;
      if (d < D) store(&o[q_base + (long long)qpos * D + d], acc[jj] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KH, int S, int D, float scale, int causal,
           int has_window, int window, cudaStream_t stream) {
  // opt in to more than 48 KB of shared memory once per device, type and
  // size, so steady-state launches (and CUDA-graph captures) make no call
  constexpr int MAX_DEVICES = 64;
  static size_t smem_opted_in[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  const size_t smem = smem_bytes(D);
  if (smem > smem_opted_in[device]) {
    err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opted_in[device] = smem;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, S, D, scale,
      causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KH, int S, int D, float scale,
                                      int causal, int has_window, int window,
                                      int is_bf16, void* stream) {
  if (D < 1 || D > MAX_D || KH < 1 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, KH, S, D, scale, causal,
                                 has_window, window, st);
  return launch<float>(q, k, v, o, B, H, KH, S, D, scale, causal,
                       has_window, window, st);
}
