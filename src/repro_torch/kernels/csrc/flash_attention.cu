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
// Bound on the H100: 4*B*H*S*S*D operations (about half under the causal
// mask) against reading q, k, v and writing o once.  At the micro path's
// float32 (2,4,256,64), causal, that is 67 MFLOP on the CUDA cores, 1.0 us
// at 67 TFLOP/s; the bytes are 0.5 us.  The float32 FMAs, and the shared-
// memory reads that feed them, are the work.  The design:
//  - one 512-thread block per (16-row q tile, h, b): 128 blocks at the
//    path shape, about one per SM, 16 warps on it.
//  - K/V tiles of 64 rows go to shared memory by 16-byte cp.async into a
//    ring of two stages: tile t+1's copy is in flight while tile t is
//    computed.  Rows are an odd number of 16-byte chunks apart, so lanes
//    reading one chunk of eight rows hit eight bank groups.
//  - each tile in three steps.  Scores: warp (key half, two q rows), lane
//    = key; one 16-byte K chunk a lane feeds both rows, q read by
//    broadcast, four FMA chains a row.  Softmax: row r's warp takes its
//    online max and sum and writes P^T.  P.V: thread (key group of 8, four
//    rows, column quads c and c + 16) reads one float4 of P and one
//    4-element V chunk a key for 16 (D <= 64) or 32 FMAs; the eight key
//    groups' partial acc add in group order at the end.
//  - the causal/window/end-of-sequence mask is applied only on the tiles
//    that cross it, and keys of the diagonal tile past the q tile's last
//    row are neither scored nor summed.  Tiles that the mask empties for
//    the whole q tile are never loaded.

#include <math.h>

#include "async_copy.cuh"

namespace {

constexpr int BQ = 16;                  // query rows per block
constexpr int BKV = 64;                 // key rows per tile
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int R1 = BQ / (WARPS / 2);    // q rows a warp scores (2)
constexpr int TPR = THREADS / BQ;       // threads per query row (32)
constexpr int COLS = BKV / TPR;         // keys per thread in the softmax (2)
constexpr int RQ = 4;                   // query rows per thread in P.V
constexpr int CQ = 16;                  // column-quad lanes in P.V
constexpr int KG = THREADS / (BQ / RQ) / CQ;   // key groups of P.V (8)
constexpr int MAX_D = 128;
constexpr int QUADS = MAX_D / 4 / CQ;   // column quads a thread in P.V (2)
constexpr int OQ = MAX_D / 4 / TPR;     // column quads a thread at the end
constexpr int LDS = BKV + 4;            // score row stride (floats)
constexpr int LDP = BQ + 4;             // P^T row stride (floats)
constexpr float NEG_BIG = -1e30f;       // the running max's start

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four consecutive elements at p (16-byte aligned in float32, 8 in bf16)
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(x.x << 16);
  f[1] = __uint_as_float(x.x & 0xffff0000u);
  f[2] = __uint_as_float(x.y << 16);
  f[3] = __uint_as_float(x.y & 0xffff0000u);
}

// byte offsets of one block's shared memory
struct Layout {
  int nc;        // 16-byte chunks of a K/V row
  int rb;        // bytes of a K/V row in shared memory (odd chunks)
  int qd;        // q row floats used (nc chunks' elements, zero past D)
  int ldq;       // q row stride in floats
  size_t q, kv, s, p, alpha, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int D) {
  constexpr int N = async_copy::Chunk<T>::N;
  Layout L;
  L.nc = (D + N - 1) / N;
  L.rb = 16 * (L.nc % 2 == 0 ? L.nc + 1 : L.nc);
  L.qd = L.nc * N;
  L.ldq = L.qd + 4;
  L.q = 0;
  L.kv = sizeof(float) * BQ * L.ldq;    // then K, V of stage 0, K, V of 1
  // at the end the same bytes hold the key groups' partial acc
  const size_t kv = static_cast<size_t>(4) * BKV * L.rb;
  const size_t part = sizeof(float) * KG * BQ * (4 * ((D + 3) / 4));
  L.s = L.kv + (kv > part ? kv : part);
  L.p = L.s + sizeof(float) * BQ * LDS;
  L.alpha = L.p + sizeof(float) * BKV * LDP;
  L.total = L.alpha + sizeof(float) * BQ;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int H, int KH, int S, int D, float scale, int causal,
                       int has_window, int window, int vec) {
  using Chunk = async_copy::Chunk<T>;
  constexpr int N = Chunk::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(D);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ss = reinterpret_cast<float*>(smem + L.s);   // scores [row][key]
  float* pt = reinterpret_cast<float*>(smem + L.p);   // P^T: [key][row]
  float* alph = reinterpret_cast<float*>(smem + L.alpha);

  const int tid = threadIdx.x;
  const int row = tid / TPR;             // a warp's lanes share a row
  const int cq = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const long long q_base = ((long long)b * H + h) * S * D;
  const long long kv_base = ((long long)b * KH + kvh) * S * D;
  const int qpos = q0 + row;
  const int q_hi = min(q0 + BQ, S) - 1; // the tile's last valid row

  // key tiles that can hold a valid key for some row of this q tile
  int kt_end = (S + BKV - 1) / BKV;
  if (causal) kt_end = min(kt_end, q_hi / BKV + 1);
  int kt_begin = 0;
  if (has_window) {
    const long long first_key = (long long)q0 - window + 1;
    if (first_key > 0)
      kt_begin = first_key < S ? static_cast<int>(first_key / BKV) : kt_end;
  }

  // copy K/V tile kt into ring stage st: 16-byte cp.async, rows past S
  // zero-filled, thread (copy_sub, copy_c) chunk copy_c of every
  // copy_rows-th row; or element by element where rows are not 16-byte
  // aligned
  const int copy_rows = THREADS / L.nc;
  const int copy_sub = tid / L.nc < copy_rows ? tid / L.nc : BKV;
  const int copy_c = tid % L.nc;
  auto issue = [&](int kt, int st) {
    const int k0 = kt * BKV;
    unsigned char* ks = smem + L.kv + static_cast<size_t>(2 * st) * BKV * L.rb;
    unsigned char* vs = ks + static_cast<size_t>(BKV) * L.rb;
    if (vec) {
      for (int r = copy_sub; r < BKV; r += copy_rows) {
        const bool in = k0 + r < S;
        const long long off =
            kv_base + (in ? (long long)(k0 + r) * D : 0) + copy_c * N;
        const size_t at = (size_t)r * L.rb + 16 * copy_c;
        async_copy::cp16(ks + at, k + off, in);
        async_copy::cp16(vs + at, v + off, in);
      }
    } else {
      using Bits = async_copy::Bits<T>;
      for (int i = tid; i < 2 * BKV * L.qd; i += THREADS) {
        const int which = i / (BKV * L.qd);
        const int r = (i / L.qd) % BKV, e = i % L.qd;
        const bool in = k0 + r < S && e < D;
        const Bits* src = reinterpret_cast<const Bits*>(which ? v : k);
        reinterpret_cast<Bits*>((which ? vs : ks) + (size_t)r * L.rb)[e] =
            in ? src[kv_base + (long long)(k0 + r) * D + e] : Bits(0);
      }
    }
  };

  if (kt_begin < kt_end) issue(kt_begin, 0);
  async_copy::commit();
  // q as float32, zero past D and past S, while the first tile lands
#pragma unroll 4
  for (int i = tid; i < BQ * L.qd; i += THREADS) {
    const int r = i / L.qd, d = i % L.qd;
    qs[r * L.ldq + d] = (q0 + r < S && d < D)
                            ? to_f32(q[q_base + (long long)(q0 + r) * D + d])
                            : 0.f;
  }

  const int n_quads = (D + 3) / 4;
  const int lane = tid & 31, warp = tid >> 5;
  // P.V: thread (key group kg, rows 4 rq .. 4 rq + 3, column quads c3,
  // c3 + 16); each key group's partial acc is added in group order at the
  // end
  const int kg = tid / (THREADS / KG), rq = (tid / CQ) % (BQ / RQ);
  const int c3 = tid % CQ;
  float m = NEG_BIG;                    // row `row`'s running max and sum
  float l = 0.f;
  float acc[RQ][QUADS][4];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int i = 0; i < QUADS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][i][e] = 0.f;

  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    if (kt + 1 < kt_end) issue(kt + 1, (it + 1) & 1);
    async_copy::commit();
    async_copy::wait<1>();              // tile kt is in
    __syncthreads();
    const unsigned char* ks =
        smem + L.kv + static_cast<size_t>(2 * (it & 1)) * BKV * L.rb;
    const unsigned char* vs = ks + static_cast<size_t>(BKV) * L.rb;
    const int k0 = kt * BKV;
    // keys past this bound are invalid for every row of the tile
    const int n_keys = min(BKV, (causal ? q_hi + 1 : S) - k0);
    const bool masked =
        k0 + BKV > S || (causal && k0 + BKV - 1 > q0) ||
        (has_window && (long long)k0 <= (long long)q_hi - window);

    // scores: warp (key half kh, rows R1 wr .. R1 wr + R1 - 1), lane key
    // 32 kh + lane; one 16-byte K chunk feeds R1 rows, q read by
    // broadcast; -inf where masked
    {
      const int kh = warp & 1, wr = warp >> 1;
      const int key = 32 * kh + lane;
      if (32 * kh < n_keys) {           // uniform in the warp
        float a[R1][4];                 // four FMA chains a row, by d % 4
#pragma unroll
        for (int r = 0; r < R1; ++r) a[r][0] = a[r][1] = a[r][2] = a[r][3] = 0.f;
        const unsigned char* kr = ks + (size_t)key * L.rb;
        const float* qr = qs + R1 * wr * L.ldq;
#pragma unroll 2
        for (int c = 0; c < L.nc; ++c) {
          float kf[N];
          Chunk::to_f32(async_copy::lds128(kr + 16 * c), kf);
#pragma unroll
          for (int e = 0; e < N; e += 4)
#pragma unroll
            for (int r = 0; r < R1; ++r) {
              const float4 x =
                  *reinterpret_cast<const float4*>(qr + r * L.ldq + c * N + e);
              a[r][0] = fmaf(x.x, kf[e], a[r][0]);
              a[r][1] = fmaf(x.y, kf[e + 1], a[r][1]);
              a[r][2] = fmaf(x.z, kf[e + 2], a[r][2]);
              a[r][3] = fmaf(x.w, kf[e + 3], a[r][3]);
            }
        }
        const int kpos = k0 + key;
#pragma unroll
        for (int r = 0; r < R1; ++r) {
          const float dot = (a[r][0] + a[r][1]) + (a[r][2] + a[r][3]);
          const int qp = q0 + R1 * wr + r;
          bool ok = key < n_keys;
          if (masked) {
            if (causal) ok = ok && kpos <= qp;
            if (has_window) ok = ok && (long long)kpos > (long long)qp - window;
          }
          ss[(R1 * wr + r) * LDS + key] = ok ? dot * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // the online softmax of row `row` over keys cq + 32 j: P^T and alpha
    {
      float sv[COLS];
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int key = cq + TPR * j;
        sv[j] = key < n_keys ? ss[row * LDS + key] : -INFINITY;
        tile_max = fmaxf(tile_max, sv[j]);
      }
#pragma unroll
      for (int w = 1; w < TPR; w <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, w));
      const float m_new = fmaxf(m, tile_max);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int key = cq + TPR * j;
        const float e = expf(sv[j] - m_new);   // taken always, then selected
        const float p = sv[j] == -INFINITY ? 0.f : e;
        if (key < n_keys) pt[key * LDP + row] = p;
        psum += p;
      }
#pragma unroll
      for (int w = 1; w < TPR; w <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, w);
      l = l * alpha + psum;
      m = m_new;
      if (cq == 0) alph[row] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P.V over this key group's keys of the tile
    {
      float al[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) al[r] = alph[RQ * rq + r];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int i = 0; i < QUADS; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][i][e] *= al[r];
      const int j_end = min(BKV / KG * (kg + 1), n_keys);
#pragma unroll 4
      for (int j = BKV / KG * kg; j < j_end; ++j) {
        const float4 p4 = *reinterpret_cast<const float4*>(pt + j * LDP + RQ * rq);
        const float pr[RQ] = {p4.x, p4.y, p4.z, p4.w};
        const T* vr = reinterpret_cast<const T*>(vs + (size_t)j * L.rb);
#pragma unroll
        for (int i = 0; i < QUADS; ++i) {
          const int dq = c3 + CQ * i;
          if (dq < n_quads) {
            float vf[4];
            load4(vr + 4 * dq, vf);
#pragma unroll
            for (int r = 0; r < RQ; ++r)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[r][i][e] = fmaf(pr[r], vf[e], acc[r][i][e]);
          }
        }
      }
    }
    __syncthreads();                    // the stage may be refilled
  }

  // the key groups' partials, added in group order, over the row's sum
  const int pq = 4 * n_quads;            // partial row stride (floats)
  float* part = reinterpret_cast<float*>(smem + L.kv);   // [KG][BQ][pq]
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int i = 0; i < QUADS; ++i) {
      const int dq = c3 + CQ * i;
      if (dq < n_quads)
        *reinterpret_cast<float4*>(part + ((size_t)kg * BQ + RQ * rq + r) *
                                              pq + 4 * dq) =
            make_float4(acc[r][i][0], acc[r][i][1], acc[r][i][2],
                        acc[r][i][3]);
    }
  __syncthreads();
  if (qpos < S) {
    const float denom = (l == 0.f) ? 1.f : l;   // fully masked row -> 0
#pragma unroll
    for (int i = 0; i < OQ; ++i) {
      const int dq = cq + TPR * i;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * dq + e;
        if (d < D) {
          float a = 0.f;
#pragma unroll
          for (int g = 0; g < KG; ++g)
            a += part[((size_t)g * BQ + row) * pq + d];
          store(&o[q_base + (long long)qpos * D + d], a / denom);
        }
      }
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
  const size_t smem = layout<T>(D).total;
  if (smem > smem_opted_in[device]) {
    err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opted_in[device] = smem;
  }
  // 16-byte copies need 16-byte rows at 16-byte addresses
  const int vec = (static_cast<size_t>(D) * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, S, D, scale,
      causal, has_window, window, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attributes(int D, int* regs, int* smem) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, flash_attention_kernel<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *smem = static_cast<int>(layout<T>(D).total + a.sharedSizeBytes);
  return 0;
}

}  // namespace

// (registers a thread, shared-memory bytes a block) at head dim D
extern "C" int flash_attention_attributes(int is_bf16, int D, int* regs,
                                          int* smem) {
  if (is_bf16) return attributes<__nv_bfloat16>(D, regs, smem);
  return attributes<float>(D, regs, smem);
}

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
