// K1 quant_matmul: int8 (M,K) x int8 (K,N) -> int8 (M,N) with int32
// accumulation and per-output-channel float32 requantization.
//
// Replaces the Pallas TPU kernel quant_matmul_pallas
// (src/repro/kernels/quant_matmul.py).  Same arithmetic, bit for bit:
//   acc = sum_k x[m,k] * w[k,n] - x_zp * wsum[n] + bias[n]     (int32)
//   out = clamp(rintf(float(acc) * scale[n]) + out_zp, -128, 127)
// rintf rounds half to even like jnp.round, and __fmul_rn keeps nvcc from
// contracting the scale multiply into anything else.  int32 sums wrap the
// same way in any order, so every path gives the same bits.
//
// Bound on the H100: at the interpreter's shapes (one row, K and N of a
// few hundred) the work is a few thousand bytes, so launch latency and
// the dependent loads after it bound it; at large shapes max(bytes / 3.35
// TB/s, 2MNK / 1979 TOPS).  Two paths, chosen by the wrapper:
//
// - rows (M <= 16 with K contiguous in the weight), the interpreter's
//   FULLY_CONNECTED, whose (N,K) weight reaches the kernel as its
//   transposed view: no shared tiles and no __syncthreads per K step.  One
//   warp takes one column: 16-byte loads of x and of the column, __dp4a, a
//   warp-shuffle sum and the epilogue in the warp.
// - tiles (larger M, or any other weight): one 256-thread block per 64x64
//   output tile, K walked in 32-deep tiles staged in shared memory (the
//   next tile's loads in flight while one computes), plain int32
//   multiply-adds (4x4 outputs per thread).
//
// The ragged M/K/N edges are masked in the loads, so the wrapper makes no
// padded copies (zero padding adds nothing to acc or to wsum).  w is read
// through its two strides, so a transposed view needs no copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_M = 16;        // the rows path's largest M
constexpr int ROW_WARPS = 8;     // warps of a rows-path block
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int LOADS = BM * BK / THREADS;         // bytes per thread per tile
static_assert(BM * BK == BK * BN && BM * BK % THREADS == 0,
              "the x and w tiles split evenly over the threads");

__device__ __forceinline__ int8_t requant(int acc, int n, int x_zp,
                                         int out_zp,
                                         const int32_t* __restrict__ bias,
                                         const int32_t* __restrict__ wsum,
                                         const float* __restrict__ scale) {
  const int a = acc - x_zp * wsum[n] + bias[n];
  const float r = rintf(__fmul_rn(__int2float_rn(a), scale[n]));
  const float o = fminf(fmaxf(r + static_cast<float>(out_zp), -128.0f),
                        127.0f);
  return static_cast<int8_t>(static_cast<int>(o));
}

// rows path, the weight's K contiguous per column (w_sk == 1): warp w of
// block b takes column b * ROW_WARPS + w; with ``vec`` (K and w_sn multiples
// of 16, both bases 16-byte aligned) each lane takes 16 bytes of K at a
// time, else one byte.
__global__ void __launch_bounds__(ROW_WARPS * 32)
quant_matmul_rows(const int8_t* __restrict__ x,
                  const int8_t* __restrict__ w,
                  const int32_t* __restrict__ bias,
                  const int32_t* __restrict__ wsum,
                  const float* __restrict__ scale,
                  int8_t* __restrict__ out, int M, int K, int N,
                  long long w_sn, int x_zp, int out_zp, bool vec) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (n >= N) return;                              // warp-uniform
  const int8_t* col = w + n * w_sn;
  int acc[ROW_M];
#pragma unroll
  for (int m = 0; m < ROW_M; ++m) acc[m] = 0;
  if (vec) {
    for (int k = 16 * lane; k < K; k += 16 * 32) {
      const int4 wv = *reinterpret_cast<const int4*>(col + k);
#pragma unroll
      for (int m = 0; m < ROW_M; ++m) {
        if (m >= M) break;
        const int4 xv =
            *reinterpret_cast<const int4*>(x + (long long)m * K + k);
        acc[m] = __dp4a(xv.x, wv.x, acc[m]);
        acc[m] = __dp4a(xv.y, wv.y, acc[m]);
        acc[m] = __dp4a(xv.z, wv.z, acc[m]);
        acc[m] = __dp4a(xv.w, wv.w, acc[m]);
      }
    }
  } else {
    for (int k = lane; k < K; k += 32) {
      const int wv = col[k];
#pragma unroll
      for (int m = 0; m < ROW_M; ++m) {
        if (m >= M) break;
        acc[m] += x[(long long)m * K + k] * wv;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < ROW_M; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
    if (lane == m)
      out[(long long)m * N + n] =
          requant(acc[m], n, x_zp, out_zp, bias, wsum, scale);
  }
}

__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const int32_t* __restrict__ bias,
                    const int32_t* __restrict__ wsum,
                    const float* __restrict__ scale,
                    int8_t* __restrict__ out,
                    int M, int K, int N, long long w_sk, long long w_sn,
                    int x_zp, int out_zp) {
  __shared__ int8_t xs[BM][BK];
  __shared__ int8_t ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  // neighbouring threads load neighbouring bytes of w's contiguous axis
  const bool n_contiguous = (w_sn == 1);

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  // A tile's global loads are all issued into registers before any is
  // stored (and the next tile's while this one computes), so a K tile
  // costs about one memory latency, not one per load.
  int8_t xr[LOADS], wr[LOADS];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int i = tid + l * THREADS;
      const int gm = row0 + i / BK, gk = k0 + i % BK;
      xr[l] = (gm < M && gk < K) ? x[(long long)gm * K + gk]
                                 : static_cast<int8_t>(0);
      const int wk = k0 + (n_contiguous ? i / BN : i % BK);
      const int wn = col0 + (n_contiguous ? i % BN : i / BK);
      wr[l] = (wk < K && wn < N) ? w[wk * w_sk + wn * w_sn]
                                 : static_cast<int8_t>(0);
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int i = tid + l * THREADS;
      xs[i / BK][i % BK] = xr[l];
      if (n_contiguous)
        ws[i / BN][i % BN] = wr[l];
      else
        ws[i % BK][i / BK] = wr[l];
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty * TM + i][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx * TN + j;
      if (gn >= N) continue;
      out[(long long)gm * N + gn] =
          requant(acc[i][j], gn, x_zp, out_zp, bias, wsum, scale);
    }
  }
}

}  // namespace

// the paths the wrapper picks (kernels.quant_matmul.PATHS)
enum Path { TILES = 0, ROWS = 1 };

// registers a thread and shared-memory bytes a block of a path's kernel
extern "C" int quant_matmul_attributes(int path, int* regs, int* smem) {
  cudaFuncAttributes a;
  const cudaError_t err =
      path == ROWS ? cudaFuncGetAttributes(&a, quant_matmul_rows)
                   : cudaFuncGetAttributes(&a, quant_matmul_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *smem = static_cast<int>(a.sharedSizeBytes);
  return 0;
}

extern "C" int quant_matmul_launch(const void* x, const void* w,
                                   const void* bias, const void* wsum,
                                   const void* scale, void* out,
                                   int M, int K, int N,
                                   long long w_sk, long long w_sn,
                                   int x_zp, int out_zp, int path,
                                   void* stream) {
  const auto xq = static_cast<const int8_t*>(x);
  const auto wq = static_cast<const int8_t*>(w);
  const auto bq = static_cast<const int32_t*>(bias);
  const auto ws = static_cast<const int32_t*>(wsum);
  const auto sc = static_cast<const float*>(scale);
  const auto oq = static_cast<int8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == ROWS) {
    if (M > ROW_M || w_sk != 1) return (int)cudaErrorInvalidValue;
    const bool vec = K % 16 == 0 && w_sn % 16 == 0 &&
                     reinterpret_cast<size_t>(x) % 16 == 0 &&
                     reinterpret_cast<size_t>(w) % 16 == 0;
    quant_matmul_rows<<<(N + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                        s>>>(xq, wq, bq, ws, sc, oq, M, K, N, w_sn, x_zp,
                             out_zp, vec);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    quant_matmul_kernel<<<grid, THREADS, 0, s>>>(xq, wq, bq, ws, sc, oq, M,
                                                 K, N, w_sk, w_sn, x_zp,
                                                 out_zp);
  }
  return static_cast<int>(cudaGetLastError());
}
