// K1 quant_matmul: int8 (M,K) x int8 (K,N) -> int8 (M,N) with int32
// accumulation and per-output-channel float32 requantization.
//
// Replaces the Pallas TPU kernel quant_matmul_pallas
// (src/repro/kernels/quant_matmul.py).  Same arithmetic, bit for bit:
//   acc = sum_k x[m,k] * w[k,n] - x_zp * wsum[n] + bias[n]     (int32)
//   out = clamp(rintf(float(acc) * scale[n]) + out_zp, -128, 127)
// rintf rounds half to even like jnp.round, and __fmul_rn keeps nvcc from
// contracting the scale multiply into anything else.
//
// Bound on the H100: at the interpreter's shapes (one row, K and N of a
// few hundred) the work is a few thousand bytes, so launch latency bounds
// it; at large shapes max(bytes / 3.35 TB/s, 2MNK / 1979 TOPS).  This
// first version is the simple one: one 256-thread block per 64x64 output
// tile, K walked in 32-deep tiles staged in shared memory (the next
// tile's loads in flight while one computes), plain int32 multiply-adds
// (4x4 outputs per thread).  The ragged M/K/N edges are
// masked while tiles load, so the wrapper makes no padded copies (zero
// padding adds nothing to acc or to wsum).  w is read through its two
// strides, so a transposed view (the FC weight, stored (N,K)) needs no
// copy.  Tensor-core int8 MMA is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int LOADS = BM * BK / THREADS;         // bytes per thread per tile
static_assert(BM * BK == BK * BN && BM * BK % THREADS == 0,
              "the x and w tiles split evenly over the threads");

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
      const int a = acc[i][j] - x_zp * wsum[gn] + bias[gn];
      const float r = rintf(__fmul_rn(__int2float_rn(a), scale[gn]));
      const float o = fminf(fmaxf(r + static_cast<float>(out_zp), -128.0f),
                            127.0f);
      out[(long long)gm * N + gn] = static_cast<int8_t>(static_cast<int>(o));
    }
  }
}

}  // namespace

extern "C" int quant_matmul_launch(const void* x, const void* w,
                                   const void* bias, const void* wsum,
                                   const void* scale, void* out,
                                   int M, int K, int N,
                                   long long w_sk, long long w_sn,
                                   int x_zp, int out_zp, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const int32_t*>(wsum),
      static_cast<const float*>(scale), static_cast<int8_t*>(out),
      M, K, N, w_sk, w_sn, x_zp, out_zp);
  return static_cast<int>(cudaGetLastError());
}
