// K5 dequant_matmul and K6 dequant_matmul_i4: float32 x (M,K) times a
// quantized weight (K,N) with one float32 scale per output column.
//   K5: int8 weight, row-major (K,N).
//   K6: packed int4 weight (K,N/2): byte j of a row holds column 2j in its
//       low nibble and column 2j+1 in its high nibble, sign-extended by
//       arithmetic shifts ((b << 4) >> 4 and b >> 4 in int8), as
//       repro_torch.core.quantize.pack_int4 packs it.
// Each weight element is cast to float32 right after its load, the
// products accumulate in float32 FMAs on the CUDA cores (no TF32, no
// tensor cores), and each output is multiplied by its column's scale once,
// after the whole sum over K:  out[m,n] = scale[n] * sum_k x[m,k] * w[k,n].
//
// Replaces the Pallas TPU kernels dequant_matmul_pallas and
// dequant_matmul_i4_pallas (src/repro/kernels/dequant_matmul.py), which
// stream (128,128) weight tiles into VMEM and accumulate over a
// sequential K grid axis in a VMEM scratch.
//
// Bound on the H100: the weight's bytes, read once.  On the serving path
// M is the number of decode slots (4) and the operations are 2*M*K*N, far
// below what the card does in the time it reads K*N bytes, so the kernel
// is a matrix-vector product bound by memory: Yi-6B's MLP weight of
// 4096 x 11008 is 45.1 MB in int8 (13.5 us at 3.35 TB/s) and 22.5 MB in
// int4 (6.7 us).
//
// Design for that bound: each thread owns 8 columns of the block's
// column tile and loads them from a weight row with one vector load (8
// bytes of an int8 row, 4 of a packed int4 one), so a warp reads 256 or
// 128 contiguous bytes of the row; a block of 8 warps walks the rows of
// its K chunk, warp w taking rows w, w+8, ..., in groups of 64 bytes a
// thread (8 int8 rows, 16 int4 ones), and loads the next group while it
// computes the current one, so the loads' latency overlaps the FMAs.  At
// M = 4 the four FMAs per weight are as many instructions as the card
// issues in the time it reads the byte, so the conversion must be cheap:
// a biased byte (b + 128, or a nibble + 8) placed under the exponent of
// 2^23 by one byte permute (prmt) or mask is the float 2^23 + b + 128
// exactly, and one float subtraction leaves b, exactly (no I2F).  x's
// rows for the block (at most 4 of them, MT) sit in shared memory as
// float32 and are read as broadcasts, once per 8 columns.  The grid is
// (column tiles of 256, K chunks, row tiles of 4); K is cut into chunks
// so that the grid has at least one block for each of the 132 SMs (but
// no chunk below 64 rows; two blocks per SM measured slower), and the
// chunks' partial sums are added in
// chunk order by a second pass that also applies the scale (no
// atomics).  The 8 warps' sums are added in warp order.  Every order
// depends only on (K, N), never on M or on a row's place in the batch,
// so a row's result does not depend on the other rows: a request moved
// to another decode slot computes the same values.  Any M, K and N: rows
// past M and columns past N are masked; rows whose bytes are not a
// multiple of the vector width (or a weight not aligned to it) are read
// byte by byte.  Tensor cores (x is float32 and must stay so: no TF32)
// and a TMA pipeline are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MT = 4;                    // rows of x per block
constexpr int KC_MAX = 1024;             // weight rows per block at most
constexpr int KC_MIN = 64;               // and at least, where K allows
constexpr int COLS = 8;                  // columns per thread
constexpr int TILE_COLS = 32 * COLS;     // a block's column tile
constexpr int GROUP_BYTES = 64;          // bytes a thread loads at once
constexpr int TARGET_BLOCKS = 132;       // one per SM on the H100
constexpr int COMBINE_THREADS = 256;
constexpr float TWO23 = 8388608.f;       // 2^23

// four int8 values of a word -> floats: (b + 128) under 2^23's exponent,
// minus 2^23 + 128
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) -
           (TWO23 + 128.f);
}

// eight int4 values of a word (nibble k is column k: byte j holds column
// 2j low and 2j+1 high) -> floats: (n + 8) under 2^23's exponent, minus
// 2^23 + 8; the signed nibble is (b << 4) >> 4 or b >> 4 in int8
__device__ __forceinline__ void int4x8_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x88888888u;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    f[k] = __uint_as_float(0x4B000000u | ((u >> (4 * k)) & 0xFu)) -
           (TWO23 + 8.f);
}

struct Int8W {
  static constexpr int BYTES = 8;        // bytes of a row per thread
  static constexpr int PER_BYTE = 1;     // columns per byte
  __device__ __forceinline__ static void unpack(const uint32_t* w,
                                                float* f) {
    int8x4_to_f32(w[0], f);
    int8x4_to_f32(w[1], f + 4);
  }
};

struct Int4W {
  static constexpr int BYTES = 4;
  static constexpr int PER_BYTE = 2;
  __device__ __forceinline__ static void unpack(const uint32_t* w,
                                                float* f) {
    int4x8_to_f32(w[0], f);
  }
};

// splits of K: enough blocks for the card, chunks of KC_MIN to KC_MAX
// rows, none empty; depends on (K, N) only
inline int n_splits(int K, int tiles) {
  int s = (TARGET_BLOCKS + tiles - 1) / tiles;
  const int most = (K + KC_MIN - 1) / KC_MIN;
  const int least = (K + KC_MAX - 1) / KC_MAX;
  if (s > most) s = most;
  if (s < least) s = least;
  const int kc = (K + s - 1) / s;
  return (K + kc - 1) / kc;
}

inline int chunk_rows(int K, int splits) { return (K + splits - 1) / splits; }

inline int tiles_of(int N) { return (N + TILE_COLS - 1) / TILE_COLS; }

// this thread's W::BYTES bytes of one weight row at p, as 32-bit words;
// past the row's end (``left`` bytes remain) they read as 0
template <typename W, bool VEC>
__device__ __forceinline__ void load_row(const int8_t* p, int left,
                                         uint32_t (&w)[W::BYTES / 4]) {
  if constexpr (VEC) {
    if constexpr (W::BYTES == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x, w[1] = v.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
    }
  } else {
#pragma unroll
    for (int i = 0; i < W::BYTES / 4; ++i) w[i] = 0;
#pragma unroll
    for (int i = 0; i < W::BYTES; ++i)
      if (i < left)
        w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + i)))
                    << (8 * (i % 4));
  }
}

// acc[m][j] += x[m, row kk] * w[row kk, column j] for the block's MT rows
template <typename W>
__device__ __forceinline__ void fma_row(float (&acc)[MT][COLS],
                                        const uint32_t (&w)[W::BYTES / 4],
                                        const float (&xs)[MT][KC_MAX],
                                        int kk) {
  float wf[COLS];
  W::unpack(w, wf);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const float xv = xs[mi][kk];
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[mi][j] = fmaf(xv, wf[j], acc[mi][j]);
  }
}

template <typename W, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
dequant_partial_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       float* __restrict__ out, float* __restrict__ part,
                       int M, int K, int N, int row_bytes, int kc) {
  constexpr int WORDS = W::BYTES / 4;
  constexpr int G = GROUP_BYTES / W::BYTES;  // rows of a group
  __shared__ float xs[MT][KC_MAX];
  __shared__ float red[MT][TILE_COLS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k0 = split * kc;
  const int nk = min(k0 + kc, K) - k0;

  for (int i = tid; i < MT * kc; i += THREADS) {
    const int mi = i / kc, kk = i - mi * kc;
    const int m = m0 + mi;
    xs[mi][kk] = (m < M && kk < nk) ? x[(long long)m * K + k0 + kk] : 0.f;
  }
  __syncthreads();

  const int byte0 = (tile * TILE_COLS + lane * COLS) / W::PER_BYTE;
  const bool has_cols = byte0 < row_bytes;
  const int left = row_bytes - byte0;
  const int8_t* wp = w + (long long)k0 * row_bytes + byte0;
  float acc[MT][COLS];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[mi][j] = 0.f;

  if (has_cols) {
    // group g holds this warp's rows kk, kk + 8, ..., kk + 8 (G - 1);
    // the next group's loads are issued before the current one's FMAs
    uint32_t cur[G][WORDS], nxt[G][WORDS];
    auto load_group = [&](int kk, uint32_t (&g)[G][WORDS]) {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int r = kk + u * WARPS;
        if (r < nk) {
          load_row<W, VEC>(wp + (long long)r * row_bytes, left, g[u]);
        } else {
#pragma unroll
          for (int i = 0; i < WORDS; ++i) g[u][i] = 0;
        }
      }
    };
    load_group(warp, cur);
    for (int kk = warp; kk < nk; kk += G * WARPS) {
      if (kk + G * WARPS < nk) load_group(kk + G * WARPS, nxt);
#pragma unroll
      for (int u = 0; u < G; ++u)
        if (kk + u * WARPS < nk) fma_row<W>(acc, cur[u], xs, kk + u * WARPS);
#pragma unroll
      for (int u = 0; u < G; ++u)
#pragma unroll
        for (int i = 0; i < WORDS; ++i) cur[u][i] = nxt[u][i];
    }
  }

  // the warps' sums, added in warp order
  for (int w2 = 0; w2 < WARPS; ++w2) {
    if (warp == w2 && has_cols) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          float* r = &red[mi][lane * COLS + j];
          *r = w2 == 0 ? acc[mi][j] : *r + acc[mi][j];
        }
    }
    __syncthreads();
  }

  const int n0 = tile * TILE_COLS;
  for (int i = tid; i < MT * TILE_COLS; i += THREADS) {
    const int mi = i / TILE_COLS, cl = i - mi * TILE_COLS;
    const int m = m0 + mi, n = n0 + cl;
    if (m >= M || n >= N) continue;
    const long long o = (long long)m * N + n;
    if (gridDim.y == 1)
      out[o] = red[mi][cl] * scale[n];
    else
      part[(long long)split * M * N + o] = red[mi][cl];
  }
}

// one thread per output: the K chunks' partial sums in chunk order, times
// the column's scale
__global__ void __launch_bounds__(COMBINE_THREADS)
dequant_combine_kernel(const float* __restrict__ part,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int M, int N, int splits) {
  const long long i = (long long)blockIdx.x * COMBINE_THREADS + threadIdx.x;
  const long long mn = (long long)M * N;
  if (i >= mn) return;
  float acc = part[i];
  for (int s = 1; s < splits; ++s) acc += part[s * mn + i];
  out[i] = acc * scale[i % N];
}

template <typename W>
int launch(const void* x, const void* w, const void* scale, void* out,
           void* ws, int M, int K, int N, cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1 || N % W::PER_BYTE != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = N / W::PER_BYTE;
  const int tiles = tiles_of(N);
  const int splits = n_splits(K, tiles);
  const int kc = chunk_rows(K, splits);
  const dim3 grid(tiles, splits, (M + MT - 1) / MT);
  const bool vec = row_bytes % W::BYTES == 0 &&
                   reinterpret_cast<uintptr_t>(w) % W::BYTES == 0;
  const float* xf = static_cast<const float*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(ws);
  if (vec)
    dequant_partial_kernel<W, true><<<grid, THREADS, 0, stream>>>(
        xf, wq, sc, o, part, M, K, N, row_bytes, kc);
  else
    dequant_partial_kernel<W, false><<<grid, THREADS, 0, stream>>>(
        xf, wq, sc, o, part, M, K, N, row_bytes, kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long mn = (long long)M * N;
  dequant_combine_kernel<<<static_cast<unsigned>(
                               (mn + COMBINE_THREADS - 1) / COMBINE_THREADS),
                           COMBINE_THREADS, 0, stream>>>(part, sc, o, M, N,
                                                         splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
long long workspace_floats(int M, int K, int N) {
  if (M < 1 || K < 1 || N < 1) return 0;
  const int splits = n_splits(K, tiles_of(N));
  return splits == 1 ? 0 : (long long)splits * M * N;
}

}  // namespace

// floats of workspace a call with these shapes needs (0: none)
extern "C" long long dequant_matmul_workspace_floats(int M, int K, int N,
                                                     int int4) {
  return int4 ? workspace_floats<Int4W>(M, K, N)
              : workspace_floats<Int8W>(M, K, N);
}

// K5: x (M,K) float32, w (K,N) int8, scale (N,) float32 -> out (M,N)
extern "C" int dequant_matmul_launch(const void* x, const void* w,
                                     const void* scale, void* out, void* ws,
                                     int M, int K, int N, void* stream) {
  return launch<Int8W>(x, w, scale, out, ws, M, K, N,
                       static_cast<cudaStream_t>(stream));
}

// K6: x (M,K) float32, w (K,N/2) packed int4, scale (N,) -> out (M,N)
extern "C" int dequant_matmul_i4_launch(const void* x, const void* w,
                                        const void* scale, void* out,
                                        void* ws, int M, int K, int N,
                                        void* stream) {
  return launch<Int4W>(x, w, scale, out, ws, M, K, N,
                       static_cast<cudaStream_t>(stream));
}
