// K8 — the Mamba-2 SSD chunked scan (state-space duality), for Hopper.
//
// Replaces the Pallas TPU kernel ``ssd_scan_pallas``
// (src/repro/kernels/ssd_scan.py).  Inputs x (B,S,H,P), B and C (B,S,G,N)
// in float32 or bfloat16 (one type for the three), dt (B,S,H), A (H,), D
// (H,) or none and the initial state h0 (B,H,P,N) or none, all float32;
// head h reads group h / (H/G).  Outputs y (B,S,H,P) in x's type and the
// final state (B,H,P,N) in float32.  For each chunk of L rows, in order:
//
//   cum   = cumsum(dt * A)
//   y     = (C·Bᵀ ∘ exp(cum_i − cum_j))_{j<=i} · (x·dt)
//         + exp(cum) ∘ (C · stateᵀ)  (+ D·x)
//   state = exp(cum_L) · state + (x·dt·exp(cum_L − cum))ᵀ · B
//
// The masked entries (j > i) are 0 and their exp is never taken: the
// unmasked differences there are positive.  A row with dt = 0 (the padded
// tail of a prompt chunk) adds nothing and decays nothing.
//
// Design.  On the TPU the chunk axis is a sequential grid dimension and
// the state lives in VMEM scratch between grid steps; here one block owns
// (b, h, a tile of 32 state rows p) and loops over the chunks itself,
// keeping its (32, N) slice of the state in shared memory.  The P rows of
// the state are independent, so the P tiles are separate blocks (96
// blocks for Mamba2-780m at batch 1, 128 for Zamba2-1.2B), of 16 warps
// each to hide the latency of one block per SM.  Per chunk the block
// copies B and C (L x N) and x·dt (L x 32) into shared memory as float32
// (vector loads of four elements, eight in flight per thread), scans
// dt·A with one warp, and builds the decay-masked score tile 64 rows at
// a time: warp w takes 4 rows, each lane 4 columns 32 apart (B's rows at
// a padded stride, free of bank conflicts; C's rows a broadcast), and
// skips the column blocks past its rows.  L = 128, N = 128 take 203 KB.
// Everything is float32 FMAs on the CUDA cores.  The C·Bᵀ tile is
// recomputed by every head of a group and every P tile; tensor cores for
// it, a pipelined copy of the next chunk, and more blocks per head are
// for a later change.
//
// Bound on the H100: at Mamba2-780m's one-shot prefill of 512 tokens (x
// (1,512,48,64) bf16, B/C (1,512,1,128)) the least work — C·Bᵀ once per
// group and chunk, the causal halves of the two L x L products, C·stateᵀ
// and the state update — is about 1.0 GFLOP, 15 µs at 67 TFLOP/s
// (float32); the bytes, about 8.2 MB, take 2.4 µs.  So operations bound
// it.  This kernel does about twice that work (C·Bᵀ per head and P tile).
//
// The C entry launches on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_L = 128;  // the longest chunk
constexpr int MAX_N = 128;  // the widest state: a state-update column per
                            // thread of 128
constexpr int PT = 32;      // state rows p per block (one per lane)
constexpr int RT = 64;      // score-tile rows per pass (4 per warp)
constexpr int LOADS = 8;    // global loads in flight per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
  int batch, seqlen, heads, P, groups, N, chunk;
  bool vec;  // four-element vector loads of x, B and C are aligned
};

// shared-memory floats for one block (all offsets multiples of 4 floats)
__host__ __device__ inline size_t smem_floats(int L, int N) {
  const int NS = ((N + 3) & ~3) + 4;  // padded row stride of B, C, state
  const int LP = (L + 3) & ~3;
  const int SS = LP + 4;              // row stride of the score tile
  const int LB = (L + 31) & ~31;        // B's rows, whole column blocks
  const int LC = (L + RT - 1) / RT * RT;  // C's rows, whole row tiles
  return (size_t)(LB + LC) * NS + (size_t)PT * NS + (size_t)LP * PT +
         (size_t)RT * SS + 2 * (size_t)LP;
}

// four consecutive elements as float: one 16-byte load of float32, one
// 8-byte load of bfloat16 (the address aligned to four elements)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// dst[j·W + n] (j < rows, n < W, W a multiple of 4) = src[j·stride + n],
// times scale[j·sstride] when a scale is given, where j < valid and n <
// cols, else 0.  Each thread moves four elements at a time (one vector
// load when ``vec``: cols, stride and src aligned to four elements) and
// keeps LOADS of them in flight; the (row, slot) it walks advances
// without a division per element.
template <typename T>
__device__ __forceinline__ void fill_rows(float* dst, int rows, int W,
                                          const T* src, size_t stride,
                                          int valid, int cols,
                                          const float* scale,
                                          size_t sstride, bool vec) {
  const int Q = W / 4, total = rows * Q, dj = THREADS / Q, dq = THREADS % Q;
  int j = threadIdx.x / Q, q = threadIdx.x % Q;
  for (int base = threadIdx.x; base < total; base += THREADS * LOADS) {
    float4 v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int n = 4 * q;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (base + u * THREADS < total && j < valid && n < cols) {
        const T* p = src + j * stride + n;
        if (vec) {
          v[u] = load4(p);
        } else {
          v[u].x = to_f(p[0]);
          if (n + 1 < cols) v[u].y = to_f(p[1]);
          if (n + 2 < cols) v[u].z = to_f(p[2]);
          if (n + 3 < cols) v[u].w = to_f(p[3]);
        }
        if (scale) {
          const float sc = scale[j * sstride];
          v[u] = make_float4(__fmul_rn(v[u].x, sc), __fmul_rn(v[u].y, sc),
                             __fmul_rn(v[u].z, sc), __fmul_rn(v[u].w, sc));
        }
      }
      j += dj;
      q += dq;
      if (q >= Q) {
        q -= Q;
        ++j;
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      if (base + u * THREADS < total)
        reinterpret_cast<float4*>(dst)[base + u * THREADS] = v[u];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int pt0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int H = a.heads, P = a.P, G = a.groups, N = a.N, L = a.chunk;
  const int S = a.seqlen;
  const int g = h / (H / G);
  const int NP = (N + 3) & ~3, NS = NP + 4;
  const int LP = (L + 3) & ~3, SS = LP + 4;
  const int LB = (L + 31) & ~31, LC = (L + RT - 1) / RT * RT;
  float* Bs = reinterpret_cast<float*>(smem4);  // LB x NS, rows past L 0
  float* Cs = Bs + (size_t)LB * NS;             // LC x NS, rows past L 0
  float* st = Cs + (size_t)LC * NS;             // PT x NS, the state slice
  float* xs = st + PT * NS;                     // LP x PT, x·dt
  float* Ss = xs + LP * PT;                     // RT x SS, the score tile
  float* cum = Ss + RT * SS;                    // LP
  float* dec = cum + LP;                        // LP: dt, then exp(cum_L − cum)
  const T* x = static_cast<const T*>(a.x);
  const T* Bg = static_cast<const T*>(a.B);
  const T* Cg = static_cast<const T*>(a.C);
  T* y = static_cast<T*>(a.y);
  const float A_h = a.A[h];
  const float D_h = a.D ? a.D[h] : 0.f;

  for (int e = tid; e < PT * NS; e += THREADS) {
    const int p = e / NS, n = e % NS;
    float v = 0.f;
    if (a.h0 && n < N && pt0 + p < P)
      v = a.h0[(((size_t)b * H + h) * P + pt0 + p) * N + n];
    st[e] = v;
  }

  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();  // the previous chunk's readers are done
    const size_t row0 = (size_t)b * S + c0;   // the chunk's first position
    const float* dtc = a.dt + row0 * H + h;   // dt of row j at dtc[j·H]
    for (int i = tid; i < LP; i += THREADS)
      dec[i] = i < L ? dtc[(size_t)i * H] : 0.f;
    fill_rows(Bs, LB, NS, Bg + (row0 * G + g) * N, (size_t)G * N, L, N,
              nullptr, 0, a.vec);
    fill_rows(Cs, LC, NS, Cg + (row0 * G + g) * N, (size_t)G * N, L, N,
              nullptr, 0, a.vec);
    fill_rows(xs, LP, PT, x + (row0 * H + h) * P + pt0, (size_t)H * P, L,
              min(PT, P - pt0), dtc, (size_t)H, a.vec);
    __syncthreads();
    if (tid < 32) {  // the cumulative log-decay: a scan over rows by warp 0
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {       // lane holds rows 4·lane + k
        const int i = 4 * tid + k;
        run = __fadd_rn(run, i < L ? __fmul_rn(dec[i], A_h) : 0.f);
        v[k] = run;
      }
      float incl = run;                   // the lanes' totals, scanned
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl = __fadd_rn(incl, t);
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) before = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * tid + k < LP) cum[4 * tid + k] = __fadd_rn(before, v[k]);
    }
    __syncthreads();

    for (int r0 = 0; r0 < L; r0 += RT) {
      const float* Ct = Cs + (size_t)r0 * NS;   // the tile's C rows
      {  // score tile: warp w takes rows 4w..4w+3 of the tile, the lane
         // columns lane + 32c; column block c is needed where 32c <= the
         // warp's last row (the same for the whole warp)
        const int lane = tid & 31, i0 = (tid >> 5) * 4;
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
        const int cmax = min(r0 + i0 + 3, L - 1) >> 5;
        for (int n4 = 0; n4 < NP / 4; ++n4) {
          float4 cv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = reinterpret_cast<const float4*>(Ct + (i0 + r) * NS)[n4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c > cmax) break;
            const float4 bv = reinterpret_cast<const float4*>(
                Bs + (lane + 32 * c) * NS)[n4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[r][c] = fmaf(cv[r].x, bv.x, acc[r][c]);
              acc[r][c] = fmaf(cv[r].y, bv.y, acc[r][c]);
              acc[r][c] = fmaf(cv[r].z, bv.z, acc[r][c]);
              acc[r][c] = fmaf(cv[r].w, bv.w, acc[r][c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = lane + 32 * c;
          if (j >= LP) break;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = r0 + i0 + r;
            float v = 0.f;
            if (j < L && i < L && j <= i)
              v = __fmul_rn(acc[r][c], expf(cum[i] - cum[j]));
            Ss[(i0 + r) * SS + j] = v;
          }
        }
      }
      __syncthreads();
      {  // y for rows il0..il0+3 of the tile, state row p = lane
        const int p = tid & 31, il0 = (tid >> 5) * 4;
        float intra[4] = {0.f, 0.f, 0.f, 0.f};
        float inter[4] = {0.f, 0.f, 0.f, 0.f};
        const int jend = (min(r0 + il0 + 4, L) + 3) & ~3;
        for (int j = 0; j < jend; j += 4) {
          const float x0 = xs[(j + 0) * PT + p], x1 = xs[(j + 1) * PT + p];
          const float x2 = xs[(j + 2) * PT + p], x3 = xs[(j + 3) * PT + p];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 s4 =
                *reinterpret_cast<const float4*>(Ss + (il0 + r) * SS + j);
            intra[r] = fmaf(s4.x, x0, intra[r]);
            intra[r] = fmaf(s4.y, x1, intra[r]);
            intra[r] = fmaf(s4.z, x2, intra[r]);
            intra[r] = fmaf(s4.w, x3, intra[r]);
          }
        }
        const float4* s4p = reinterpret_cast<const float4*>(st + p * NS);
        for (int n4 = 0; n4 < NP / 4; ++n4) {
          const float4 sv = s4p[n4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 cv =
                reinterpret_cast<const float4*>(Ct + (il0 + r) * NS)[n4];
            inter[r] = fmaf(cv.x, sv.x, inter[r]);
            inter[r] = fmaf(cv.y, sv.y, inter[r]);
            inter[r] = fmaf(cv.z, sv.z, inter[r]);
            inter[r] = fmaf(cv.w, sv.w, inter[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = r0 + il0 + r;
          if (i < L && pt0 + p < P) {
            const size_t off = (((size_t)b * S + c0 + i) * H + h) * P + pt0 + p;
            float v = __fadd_rn(intra[r], __fmul_rn(expf(cum[i]), inter[r]));
            if (a.D) v = __fadd_rn(v, __fmul_rn(D_h, to_f(x[off])));
            y[off] = from_f<T>(v);
          }
        }
      }
      __syncthreads();  // Ss is rewritten by the next row tile
    }

    // state update: column n, state rows pb..pb+7
    const float total = cum[L - 1];
    for (int i = tid; i < L; i += THREADS) dec[i] = expf(total - cum[i]);
    __syncthreads();
    {
      const int n = tid & (MAX_N - 1), pb = (tid >> 7) * 8;
      if (n < NP) {
        float acc[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = 0.f;
        for (int j = 0; j < L; ++j) {
          const float wb = __fmul_rn(dec[j], Bs[j * NS + n]);
          const float4* x4 = reinterpret_cast<const float4*>(xs + j * PT + pb);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float4 xv = x4[q];
            acc[4 * q + 0] = fmaf(xv.x, wb, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(xv.y, wb, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(xv.z, wb, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(xv.w, wb, acc[4 * q + 3]);
          }
        }
        const float et = expf(total);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float* s = st + (pb + k) * NS + n;
          *s = __fadd_rn(__fmul_rn(et, *s), acc[k]);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < PT * N; e += THREADS) {
    const int p = e / N, n = e % N;
    if (pt0 + p < P)
      a.state[(((size_t)b * H + h) * P + pt0 + p) * N + n] = st[p * NS + n];
  }
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* D,
                               const void* h0, void* y, void* state,
                               int batch, int seqlen, int heads, int P,
                               int groups, int N, int chunk, int bf16,
                               void* stream) {
  if (chunk < 1 || chunk > MAX_L || N < 1 || N > MAX_N || seqlen % chunk)
    return (int)cudaErrorInvalidValue;
  const size_t align = 4 * (bf16 ? 2 : 4);   // four elements, in bytes
  const bool vec = N % 4 == 0 && P % 4 == 0 &&
                   reinterpret_cast<size_t>(x) % align == 0 &&
                   reinterpret_cast<size_t>(B) % align == 0 &&
                   reinterpret_cast<size_t>(C) % align == 0;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B,
         C, static_cast<const float*>(D), static_cast<const float*>(h0), y,
         static_cast<float*>(state), batch, seqlen, heads, P, groups, N,
         chunk, vec};
  const size_t smem = smem_floats(chunk, N) * sizeof(float);
  void (*kernel)(Args) = bf16 ? ssd_scan_kernel<__nv_bfloat16>
                              : ssd_scan_kernel<float>;
  // the largest block's shared memory, allowed once per instantiation (a
  // stream capture of a later launch then records the launch alone)
  static bool allowed[2] = {false, false};
  if (!allowed[bf16 ? 1 : 0]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(MAX_L, MAX_N) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    allowed[bf16 ? 1 : 0] = true;
  }
  const dim3 grid((P + PT - 1) / PT, heads, batch);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
