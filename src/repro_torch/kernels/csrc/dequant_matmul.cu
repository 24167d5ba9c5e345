// K5 dequant_matmul and K6 dequant_matmul_i4: float32 x (M,K) times a
// quantized weight (K,N) with one float32 scale per output column,
//   out[m,n] = scale[n] * sum_k x[m,k] * w[k,n]   (float32, scaled once).
//   K5: int8 weight, row-major (K,N).
//   K6: packed int4 weight (K,N/2): byte j of a row holds column 2j in its
//       low nibble and column 2j+1 in its high nibble, sign-extended by
//       arithmetic shifts ((b << 4) >> 4 and b >> 4 in int8), as
//       repro_torch.core.quantize.pack_int4 packs it.
//
// Replaces the Pallas TPU kernels dequant_matmul_pallas and
// dequant_matmul_i4_pallas (src/repro/kernels/dequant_matmul.py), which
// stream (128,128) weight tiles into VMEM and accumulate over a
// sequential K grid axis in a VMEM scratch.
//
// Bound on the H100: the weight's bytes, read once.  On the serving path
// M is the number of decode slots (4): Yi-6B's MLP weight of 4096 x 11008
// is 45.1 MB in int8 (13.5 us at 3.35 TB/s) and 22.5 MB in int4 (6.7 us).
// Two things stand between a kernel and that bound.  (1) The stream: every
// SM has to keep tens of KB of the weight in flight all the time, and
// every SM has to read the same share.  (2) The arithmetic: at M = 4 each
// weight element costs the CUDA cores four FMAs and its conversion, which
// at int4's rate is about as long as the bytes take (5 x 45.1 M / (132 x
// 128 lanes x 1.98 GHz) ~ 6.7 us of issue alone).
//
// (1) A persistent grid of min(132, S) blocks (132: the H100's SMs, a
// constant, never read from the device).  The weight is cut into S units
// of 128 rows by a column tile of 128 columns (16 KB in int8, 8 KB in
// int4), ordered tile by tile and along K within a tile, and block b takes
// the contiguous share [b S / G, (b+1) S / G): stream-K, so the busiest
// block reads one unit more than the least busy at most.  It reads them in
// stages of up to TPW units of one tile (2 in int8, 4 in int4: 32 KB)
// through a ring of shared-memory buffers (4 in int8, 3 in int4: 96 KB or
// 64 KB in flight) filled by 16-byte cp.async copies (.cg: through L2
// only), x's floats of the same rows in the same copy groups (4 bytes
// each), so no copy of x waits for a prologue.  Rows of a buffer are 16
// bytes longer than the tile (a row pitch of 16 mod 64 bytes), so the
// fragments' reads have no bank conflict.
//
// (2) The products run on the tensor cores, exactly: mma.sync m16n8k16,
// bfloat16 in, float32 sums.  x splits into three bfloat16 terms, hi =
// bf16(x), mid = bf16(x - hi), lo = x - hi - mid (exact: 8 + 8 + 8
// significand bits are float32's 24), once a stage by the whole block into
// the A fragments in shared memory: hi for x's 4 rows in A's rows 0-3, mid
// in 4-7, lo in 8-11, so one MMA serves the three terms and each term's sum
// stays in its own rows of the accumulator.  A transposed ldmatrix reads
// the weight's bytes as 16-bit elements, which puts rows k and k+1 of a
// column in the two halves of a register: the pairing the B fragment
// takes, so the stored layout is read as it is.  The weight converts to
// bfloat16 exactly: an int8 b is (128 + (b & 127)), its low 7 bits placed
// under 128.0's exponent by one logic op, plus -128 or -256 by its sign
// bit (a second logic op and one bf16x2 FMA for two elements); an int4
// nibble n is (n ^ 8) under 128.0's exponent, less 136 (one logic op, one
// FMA).  Every product is exact.  The tensor cores' float32 sums align and
// truncate rather than round, so a warp's run of MMAs is at most 32
// k-steps (512 rows) before its sums are added into float32 registers,
// the three terms as (lo + mid) + hi.
//
// The 16 warps of a block take a stage's k-steps of 16 rows, 8 of them a
// unit, and the tile's two halves of 64 columns.  At the end of a block's
// segment of a column tile the k-steps' sums add in k-step order.  A tile
// held by one segment is scaled and written at once; otherwise the segment
// writes its partial (4 x 128 floats), and after its stream the block
// arrives at the tiles it shares -- at most its first and its last -- on
// arrival counters; the last block to arrive at a tile (it resets the
// counter to 0) adds the segments in K order and applies the scale.  One
// launch, no float atomics.  The split depends on (K, N) only, never on
// M: rows of x come 4 to a block along the grid's y, so a row's result
// does not depend on the other rows of the batch, and a request moved to
// another decode slot computes the same bits.  Any M, K and N: rows past
// M or K and columns past N read as 0 and are not written; weights whose
// rows are not a multiple of 16 bytes, or whose pointer is not 16-byte
// aligned, are read byte by byte into the same buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int SMS = 132;               // the H100's SMs: the grid's width
constexpr int MT = 4;                  // rows of x a block
constexpr int WK = 8;                  // warps along K, a k-step each
constexpr int WC = 2;                  // warps along a column tile
constexpr int WARPS = WK * WC;
constexpr int THREADS = 32 * WARPS;
constexpr int KSTEP = 16;              // rows of K an MMA takes
constexpr int UNIT = KSTEP * WK;       // rows of K of a share's unit
constexpr int NT = 8;                  // n8 MMA tiles a warp
constexpr int WARP_COLS = 8 * NT;      // its output columns
constexpr int TILE_COLS = WC * WARP_COLS;   // a column tile's
constexpr int CHAIN = 32;              // a warp's k-steps between folds
constexpr int RED_PITCH = WARP_COLS + 4;    // floats of a warp's row of sums
constexpr uint32_t BF16X2_ONE = 0x3F803F80u;
constexpr int MAX_DEVICES = 64;

struct Int8W {
  static constexpr int PER_BYTE = 1;   // columns per byte
  static constexpr int TPW = 2;        // units a stage (a warp's k-steps)
  static constexpr int STAGES = 4;     // ring buffers
};

struct Int4W {
  static constexpr int PER_BYTE = 2;
  static constexpr int TPW = 4;
  static constexpr int STAGES = 3;
};

template <typename W>
struct Layout {
  static constexpr int TB = TILE_COLS / W::PER_BYTE;  // bytes of a tile row
  static constexpr int NPM = 2 * W::PER_BYTE;  // MMA tiles of a 16-byte
                                               // column of the weight
  static constexpr int PITCH = TB + 16;     // 16 mod 64: no bank conflict
  static constexpr int CPR = TB / 16;       // 16-byte copies of a tile row
  static constexpr int TPW = W::TPW;
  static constexpr int KBLK = UNIT * TPW;   // rows of K a stage at most
  static constexpr int X_PITCH = KBLK + 8;  // floats of a row of x
  static constexpr int COPIES = KBLK * CPR / THREADS;  // a thread's, a stage
  static constexpr int W_BYTES = KBLK * PITCH;
  static constexpr int STAGE_BYTES = W_BYTES + 4 * MT * X_PITCH;
  // the A fragments of a stage's KBLK / 16 k-steps: 16 bytes a lane
  static constexpr int AFR_BYTES = KBLK / KSTEP * 32 * 16;
  static constexpr int SMEM = W::STAGES * STAGE_BYTES + AFR_BYTES +
                              4 * WK * MT * WC * RED_PITCH;
  static constexpr int XCOPIES = MT * KBLK / THREADS;  // x's, a stage
  static constexpr int XPAIRS = XCOPIES / 2;  // pairs of x a thread splits
  static constexpr int FOLD = CHAIN / TPW;  // stages between folds
  static_assert(KBLK * CPR % THREADS == 0 && MT * KBLK % THREADS == 0 &&
                MT * TILE_COLS == THREADS && X_PITCH % 32 == 8 &&
                CHAIN % TPW == 0 && XCOPIES % 2 == 0,
                "whole rounds of copies, one output a thread");
};

// how a (K, N) weight is cut; a function of (K, N) and the constants only
struct Plan {
  int row_bytes;     // bytes of a weight row
  int tiles;         // column tiles of TILE_COLS
  int kb;            // units along K of a tile
  long long S;       // units in all: tiles * kb
  int G;             // blocks of a row tile: min(SMS, S)
  int maxseg;        // most blocks that share a column tile
};

template <typename W>
Plan plan_of(int K, int N) {
  Plan p;
  p.row_bytes = N / W::PER_BYTE;
  p.tiles = (p.row_bytes + Layout<W>::TB - 1) / Layout<W>::TB;
  p.kb = (K + UNIT - 1) / UNIT;
  p.S = static_cast<long long>(p.tiles) * p.kb;
  p.G = static_cast<int>(p.S < SMS ? p.S : SMS);
  // an interval of kb units meets at most ceil(kb / q) + 1 shares of at
  // least q = S / G units
  const long long q = p.S / p.G;
  const long long most = (p.kb + q - 1) / q + 1;
  p.maxseg = static_cast<int>(most < p.kb ? most : p.kb);
  return p;
}

// the first unit of block b's share
__host__ __device__ __forceinline__ long long first_unit(const Plan& p,
                                                         long long b) {
  return b * p.S / p.G;
}

// the block whose share holds stage s
__device__ __forceinline__ int owner(const Plan& p, long long s) {
  return static_cast<int>(((s + 1) * p.G - 1) / p.S);
}

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// one logic op of three operands (0xEA: (a & b) | c; 0x6A: (a & b) ^ c);
// written out because the compiler splits such an op on two constants
// into two
template <int LUT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;\n"
      : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(LUT));
  return d;
}

// two int8 (the low bytes of p's halves) -> bf16x2, exactly
__device__ __forceinline__ uint32_t i8_bf16x2(uint32_t p) {
  const uint32_t v = lop3<0xEA>(p, 0x007F007Fu, 0x43004300u);  // 128 + b & 127
  const uint32_t off = lop3<0xEA>(p, 0x00800080u, 0xC300C300u);  // -128, -256
  return bf16x2_fma(v, BF16X2_ONE, off);
}

// two int4 (the low nibbles of p's halves) -> bf16x2, exactly
__device__ __forceinline__ uint32_t i4_bf16x2(uint32_t p) {
  return bf16x2_fma(lop3<0x6A>(p, 0x000F000Fu, 0x43084308u), BF16X2_ONE,
                    0xC308C308u);                       // 128 + (n ^ 8) - 136
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// two values of x in three bf16x2 terms, hi + mid + lo == x exactly
__device__ __forceinline__ void split(float2 v, uint32_t& hi, uint32_t& mid,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float r0 = __fsub_rn(v.x, __low2float(h));
  const float r1 = __fsub_rn(v.y, __high2float(h));
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      __fsub_rn(r0, __low2float(m)), __fsub_rn(r1, __high2float(m)));
  hi = bits(h), mid = bits(m), lo = bits(l);
}

// four 8 x 8 matrices of 16-bit elements, transposed: this thread gets
// elements (2t, g) and (2t + 1, g) of each; thread l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

// the NT MMAs of one warp's k-step.  Read as 16-bit elements, a 16-byte
// column c of rows 0-7 and of rows 8-15 of the k-step come in by one
// transposed ldmatrix each: this thread's register holds bytes 2g, 2g + 1
// of row 2t, then of row 2t + 1 -- two weight columns (int8) or four
// (int4) at rows 2t, 2t + 1, each a byte (or nibble) apart, which is the
// pairing of k the B fragment takes.  Tile i = NPM c + s (s the column
// within the pair or four) feeds warp column 16 c + 2 g + s (int8) or
// 32 c + 4 g + s (int4).  `lm` is this thread's ldmatrix row address.
template <typename W>
__device__ __forceinline__ void mma_kstep(const unsigned char* lm,
                                          const uint32_t (&a)[4],
                                          float (&d)[NT][4]) {
  if constexpr (W::PER_BYTE == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {       // columns 0-1 of 16 bytes, then 2-3
      uint32_t r[4];
      ldsm_x4_t(r, lm + 32 * h);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t top = r[2 * c], bottom = r[2 * c + 1];
        mma(d[4 * h + 2 * c], a, i8_bf16x2(top), i8_bf16x2(bottom));
        mma(d[4 * h + 2 * c + 1], a, i8_bf16x2(top >> 8),
            i8_bf16x2(bottom >> 8));
      }
    }
  } else {
    uint32_t r[4];
    ldsm_x4_t(r, lm);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t top = r[2 * c], bottom = r[2 * c + 1];
#pragma unroll
      for (int s = 0; s < 4; ++s)
        mma(d[4 * c + s], a, i4_bf16x2(top >> (4 * s)),
            i4_bf16x2(bottom >> (4 * s)));
    }
  }
}

template <typename W, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
dequant_matmul_kernel(const float* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale,
                      float* __restrict__ out, float* __restrict__ ws,
                      int* __restrict__ counters, int M, int K, int N,
                      Plan p) {
  using L = Layout<W>;
  extern __shared__ __align__(16) unsigned char smem[];
  // afr: the current stage's A fragments, lane l of k-step s at
  // (32 s + l) 16 bytes: rows g and g + 8 of the MMA's A for k 2t, 2t + 1,
  // then for k 2t + 8, 2t + 9; A's rows 0-3 hold hi of x's rows 0-3, 4-7
  // mid, 8-11 lo, 12-15 zeros
  __nv_bfloat16* afr = reinterpret_cast<__nv_bfloat16*>(
      smem + W::STAGES * L::STAGE_BYTES);
  float* red = reinterpret_cast<float*>(smem + W::STAGES * L::STAGE_BYTES +
                                        L::AFR_BYTES);
  __shared__ int last_flag[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ks = warp % WK, half = warp / WK;   // k-step, column half
  const int rt = blockIdx.y;
  const int m0 = rt * MT;
  // x's rows start 16-byte aligned: copy 4 floats at a time
  const bool x16 = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long s0 = first_unit(p, blockIdx.x);
  const int share = static_cast<int>(first_unit(p, blockIdx.x + 1) - s0);
  // the share's units in stages of up to TPW units of one column tile:
  // tile j, unit q of it, n units, ring buffer; the next to load and the
  // next to compute
  struct Cursor {
    int j, q, left, buf;
    __device__ int units(int kb) const {
      return min(W::TPW, min(kb - q, left));
    }
    __device__ void next(int kb) {
      const int n = units(kb);
      q += n, left -= n;
      if (q == kb) q = 0, ++j;
      if (++buf == W::STAGES) buf = 0;
    }
  };
  const Cursor first{static_cast<int>(s0 / p.kb),
                     static_cast<int>(s0 % p.kb), share, 0};
  Cursor ld = first, cs = first;

  // this thread's copies of a stage's weight: 16 bytes of rows r0 + u
  // THREADS / CPR, at byte 16 cc of the tile's row
  const int cc = tid % L::CPR, r0 = tid / L::CPR;
  const int8_t* wt = w + static_cast<long long>(r0) * p.row_bytes + 16 * cc;

  // stage ld into its buffer: its units' rows of the weight, TB bytes
  // each, and x's MT floats of each of those rows of K
  auto load = [&]() {
    const int k0 = ld.q * UNIT, rows = ld.units(p.kb) * UNIT;
    const int byte = ld.j * L::TB + 16 * cc;
    unsigned char* buf = smem + ld.buf * L::STAGE_BYTES;
    const int8_t* src = wt + static_cast<long long>(k0) * p.row_bytes +
                        ld.j * L::TB;
#pragma unroll
    for (int u = 0; u < L::COPIES; ++u) {
      constexpr int RS = THREADS / L::CPR;   // rows between two copies
      const int k = k0 + r0 + RS * u;
      const int8_t* su = src + static_cast<long long>(RS * u) * p.row_bytes;
      unsigned char* dst = buf + (r0 + RS * u) * L::PITCH + 16 * cc;
      if constexpr (VEC) {
        const bool in = r0 + RS * u < rows && k < K && byte < p.row_bytes;
        async_copy::cp16(dst, in ? su : w, in);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (r0 + RS * u < rows && k < K) {
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (byte + e < p.row_bytes)
              v[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                              __ldg(su + e))) << (8 * (e % 4));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    if (x16) {                          // 4 floats a copy
      for (int e = tid; e < MT * L::KBLK / 4; e += THREADS) {
        const int mi = e / (L::KBLK / 4), kk = 4 * (e % (L::KBLK / 4));
        const bool in = m0 + mi < M && kk < rows && k0 + kk < K;
        async_copy::cp16(
            buf + L::W_BYTES + 4 * (mi * L::X_PITCH + kk),
            in ? x + static_cast<long long>(m0 + mi) * K + k0 + kk : x, in);
      }
    } else {
#pragma unroll
      for (int u = 0; u < L::XCOPIES; ++u) {
        const int e = tid + THREADS * u;
        const int mi = e / L::KBLK, kk = e % L::KBLK;
        const bool in = m0 + mi < M && kk < rows && k0 + kk < K;
        async_copy::cp4(
            buf + L::W_BYTES + 4 * (mi * L::X_PITCH + kk),
            in ? x + static_cast<long long>(m0 + mi) * K + k0 + kk : x, in);
      }
    }
    ld.next(p.kb);
  };

  float d[NT][4];      // this warp's run of MMAs
  float acc[NT][2];    // its folded sums (rows of x for groups 0-3)
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
    acc[i][0] = acc[i][1] = 0.f;
  }
  // the terms' sums into float32: lo + mid, then hi; mid is in the
  // accumulator rows of the group 4 above
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float mid0 = __shfl_xor_sync(0xffffffffu, d[i][0], 16);
      const float mid1 = __shfl_xor_sync(0xffffffffu, d[i][1], 16);
      acc[i][0] = __fadd_rn(acc[i][0],
                            __fadd_rn(__fadd_rn(d[i][2], mid0), d[i][0]));
      acc[i][1] = __fadd_rn(acc[i][1],
                            __fadd_rn(__fadd_rn(d[i][3], mid1), d[i][1]));
      d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
    }
  };

  // this thread's output of a tile: row orow, column ocol; the sums in
  // red of warp (k-step, column half) at ((k-step MT + row) WC + half)
  // RED_PITCH, MMA tile i's column n at i * 8 + n (mma_kstep says which
  // of the warp's columns that is)
  const int orow = tid / TILE_COLS, ocol = tid % TILE_COLS;
  const int oc = ocol % WARP_COLS, om = oc / (8 * L::NPM);
  const int on = oc % (8 * L::NPM) / L::NPM, os = oc % L::NPM;
  const float* rsum = red + (orow * WC + ocol / WARP_COLS) * RED_PITCH +
                      (L::NPM * om + os) * 8 + on;
  // this thread's ldmatrix row: row l % 8 of rows 0-7 or 8-15 (by l / 8
  // odd), 16-byte column l / 16 of the warp's half of the tile row
  const int lm_row = 8 * ((lane >> 3) & 1) + (lane & 7);
  const int lm_col = half * (L::TB / WC) + 16 * (lane >> 4);
  // this output's scale in tile j, read before the sums need it
  auto scale_of = [&](int j) {
    const int n = j * TILE_COLS + ocol;
    return n < N ? __ldg(scale + n) : 0.f;
  };
  auto store = [&](int j, float s, float sc) {
    const int m = m0 + orow, n = j * TILE_COLS + ocol;
    if (m < M && n < N)
      out[static_cast<long long>(m) * N + n] = __fmul_rn(s, sc);
  };
  // the column tiles this block shares with others: at most its first and
  // its last segment; their arrivals wait for the end of the stream
  int shared_j[2], shared_n[2], n_shared = 0;

  // the end of this block's segment `seg` of `nseg` of column tile j
  auto finish = [&](int j, int seg, int nseg) {
    const float sc = nseg == 1 ? scale_of(j) : 0.f;
    fold();
    if (g < 4) {
      float* r = red + ((ks * MT + g) * WC + half) * RED_PITCH + 2 * t;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        *reinterpret_cast<float2*>(r + i * 8) =
            make_float2(acc[i][0], acc[i][1]);
        acc[i][0] = acc[i][1] = 0.f;
      }
    }
    __syncthreads();
    float v = rsum[0];                  // the k-steps' sums in order
#pragma unroll
    for (int k2 = 1; k2 < WK; ++k2)
      v = __fadd_rn(v, rsum[k2 * MT * WC * RED_PITCH]);
    if (nseg == 1) {
      store(j, v, sc);
      return;
    }
    const long long tile = static_cast<long long>(rt) * p.tiles + j;
    ws[(tile * p.maxseg + seg) * (MT * TILE_COLS) + tid] = v;
    shared_j[n_shared] = j;
    shared_n[n_shared++] = nseg;
  };

  // A's rows 12-15 stay 0
  for (int e = tid; e < L::AFR_BYTES / 16; e += THREADS)
    if ((e & 31) >= 16) {               // lanes of groups 4-7
      uint32_t* f = reinterpret_cast<uint32_t*>(afr) + 4 * e;
      f[1] = f[3] = 0u;
    }
  // x's values of the stage in buffer b as bf16 terms in afr
  auto split_x = [&](int b) {
    const float* xs = reinterpret_cast<const float*>(
        smem + b * L::STAGE_BYTES + L::W_BYTES);
    uint32_t* f32 = reinterpret_cast<uint32_t*>(afr);
#pragma unroll
    for (int u = 0; u < L::XPAIRS; ++u) {
      const int e = tid + THREADS * u;
      const int mi = e / (L::KBLK / 2), kk = 2 * (e % (L::KBLK / 2));
      uint32_t hi, mid, lo;
      split(*reinterpret_cast<const float2*>(xs + mi * L::X_PITCH + kk), hi,
            mid, lo);
      // registers of lanes (group, tt) of k-step kk / 16
      const int kr = kk % KSTEP, tt = (kr % 8) / 2, reg = kr < 8 ? 0 : 2;
      uint32_t* f = f32 + (kk / KSTEP) * 32 * 4;
      f[(mi * 4 + tt) * 4 + reg] = hi;
      f[((mi + 4) * 4 + tt) * 4 + reg] = mid;
      f[(mi * 4 + tt) * 4 + reg + 1] = lo;
    }
  };

  constexpr int S_ = W::STAGES;
#pragma unroll
  for (int i = 0; i < S_ - 1; ++i) {
    if (ld.left > 0) load();
    async_copy::commit();
  }
  int chain = 0;
  while (cs.left > 0) {
    async_copy::wait<S_ - 2>();         // this stage is in (this thread's)
    __syncthreads();                    // all of it; the last one is done
    if (ld.left > 0) load();
    async_copy::commit();

    const int j = cs.j, q = cs.q, n = cs.units(p.kb);
    const unsigned char* buf = smem + cs.buf * L::STAGE_BYTES;
    split_x(cs.buf);
    __syncthreads();                    // the stage's A fragments
#pragma unroll
    for (int u = 0; u < L::TPW; ++u) {
      const int kk0 = UNIT * u + KSTEP * ks;
      if (u < n && q * UNIT + kk0 < K) {  // the k-step holds rows
        const uint4 f = async_copy::lds128(afr + ((kk0 / KSTEP) * 32 + lane) *
                                                     8);
        const uint32_t a[4] = {f.x, f.y, f.z, f.w};
        mma_kstep<W>(buf + (kk0 + lm_row) * L::PITCH + lm_col, a, d);
      }
    }
    if (n == cs.left || q + n == p.kb) {
      const int first = owner(p, static_cast<long long>(j) * p.kb);
      const int nseg =
          owner(p, static_cast<long long>(j + 1) * p.kb - 1) - first + 1;
      finish(j, static_cast<int>(blockIdx.x) - first, nseg);
      chain = 0;
    } else if (++chain == L::FOLD) {
      fold();
      chain = 0;
    }
    cs.next(p.kb);
  }
  if (n_shared == 0) return;

  // the shared tiles: the last block to arrive at one adds its segments
  // in K order and applies the scale
  float sc[2];
  for (int e = 0; e < n_shared; ++e) sc[e] = scale_of(shared_j[e]);
  __syncthreads();                      // every partial written
  if (tid == 0) {
    __threadfence();                    // ... and visible before arrival
    for (int e = 0; e < n_shared; ++e) {
      int* ctr = counters + static_cast<long long>(rt) * p.tiles +
                 shared_j[e];
      const int last = atomicAdd(ctr, 1) == shared_n[e] - 1;
      if (last) atomicExch(ctr, 0);     // every segment arrived: reset
      last_flag[e] = last;
    }
    __threadfence();
  }
  __syncthreads();
  for (int e = 0; e < n_shared; ++e) {
    if (!last_flag[e]) continue;
    const long long tile = static_cast<long long>(rt) * p.tiles + shared_j[e];
    const float* q = ws + tile * p.maxseg * (MT * TILE_COLS) + tid;
    float s = __ldcg(q);
#pragma unroll 4
    for (int sg = 1; sg < shared_n[e]; ++sg)
      s = __fadd_rn(s, __ldcg(q + sg * (MT * TILE_COLS)));
    store(shared_j[e], s, sc[e]);
  }
}

template <typename W, bool VEC>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(dequant_matmul_kernel<W, VEC>);
}

template <typename W>
int launch(const void* x, const void* w, const void* scale, void* out,
           void* ws, void* counters, int M, int K, int N,
           cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1 || N % W::PER_BYTE != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // opt in to more than 48 KB of shared memory once per device, so
  // steady-state launches (and CUDA-graph captures) make no call
  static bool opted_in[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  constexpr int smem = Layout<W>::SMEM;
  if (!opted_in[device]) {
    const void* fns[2] = {kernel_fn<W, true>(), kernel_fn<W, false>()};
    for (const void* f : fns) {
      err = cudaFuncSetAttribute(
          f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    opted_in[device] = true;
  }
  const Plan p = plan_of<W>(K, N);
  const dim3 grid(p.G, (M + MT - 1) / MT);
  const bool vec = p.row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const float* xf = static_cast<const float*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(ws);
  int* ctr = static_cast<int*>(counters);
  if (vec)
    dequant_matmul_kernel<W, true><<<grid, THREADS, smem, stream>>>(
        xf, wq, sc, o, part, ctr, M, K, N, p);
  else
    dequant_matmul_kernel<W, false><<<grid, THREADS, smem, stream>>>(
        xf, wq, sc, o, part, ctr, M, K, N, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
long long workspace_floats(int M, int K, int N) {
  if (M < 1 || K < 1 || N < 1) return 0;
  const Plan p = plan_of<W>(K, N);
  if (p.maxseg == 1) return 0;
  return static_cast<long long>((M + MT - 1) / MT) * p.tiles * p.maxseg *
         MT * TILE_COLS;
}

template <typename W>
long long counter_ints(int M, int K, int N) {
  if (M < 1 || K < 1 || N < 1) return 0;
  return static_cast<long long>((M + MT - 1) / MT) * plan_of<W>(K, N).tiles;
}

}  // namespace

// floats of workspace a call with these shapes needs (0: none)
extern "C" long long dequant_matmul_workspace_floats(int M, int K, int N,
                                                     int int4) {
  return int4 ? workspace_floats<Int4W>(M, K, N)
              : workspace_floats<Int8W>(M, K, N);
}

// int32 arrival counters a call with these shapes uses: 0 on entry, and
// left 0
extern "C" long long dequant_matmul_counter_ints(int M, int K, int N,
                                                 int int4) {
  return int4 ? counter_ints<Int4W>(M, K, N) : counter_ints<Int8W>(M, K, N);
}

// registers a thread and shared-memory bytes a block of the kernel a
// launch on 16-byte rows runs
extern "C" int dequant_matmul_attributes(int int4, int* regs, int* smem) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, int4 ? kernel_fn<Int4W, true>() : kernel_fn<Int8W, true>());
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *smem = static_cast<int>(a.sharedSizeBytes) +
          (int4 ? Layout<Int4W>::SMEM : Layout<Int8W>::SMEM);
  return 0;
}

// K5: x (M,K) float32, w (K,N) int8, scale (N,) float32 -> out (M,N)
extern "C" int dequant_matmul_launch(const void* x, const void* w,
                                     const void* scale, void* out, void* ws,
                                     void* counters, int M, int K, int N,
                                     void* stream) {
  return launch<Int8W>(x, w, scale, out, ws, counters, M, K, N,
                       static_cast<cudaStream_t>(stream));
}

// K6: x (M,K) float32, w (K,N/2) packed int4, scale (N,) -> out (M,N)
extern "C" int dequant_matmul_i4_launch(const void* x, const void* w,
                                        const void* scale, void* out,
                                        void* ws, void* counters, int M,
                                        int K, int N, void* stream) {
  return launch<Int4W>(x, w, scale, out, ws, counters, M, K, N,
                       static_cast<cudaStream_t>(stream));
}
