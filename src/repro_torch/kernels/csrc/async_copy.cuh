// Asynchronous copies from device memory to shared memory (cp.async,
// sm_80 and later: 16-byte ones, and 4-byte ones for small operands) and
// the conversion of a 16-byte chunk of float32, bfloat16 or int8 elements
// to float32, shared by the attention kernels (flash_attention.cu,
// decode_attention.cuh) and, for the copies, by dequant_matmul.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace async_copy {

// copy 16 bytes, or write 16 zero bytes and read nothing when !fill; both
// addresses 16-byte aligned.  .cg: through L2 only, the row is read once
__device__ __forceinline__ void cp16(void* smem, const void* gmem,
                                     bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = fill ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

// copy 4 bytes (or write 4 zero bytes when !fill); both addresses 4-byte
// aligned.  .ca: through L1, for small operands every block reads
__device__ __forceinline__ void cp4(void* smem, const void* gmem, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = fill ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the raw bits of one element, for copies that do not go 16 bytes at once
template <int BYTES> struct BitsOf;
template <> struct BitsOf<1> { using type = uint8_t; };
template <> struct BitsOf<2> { using type = uint16_t; };
template <> struct BitsOf<4> { using type = uint32_t; };
template <typename T> using Bits = typename BitsOf<sizeof(T)>::type;

// a 16-byte chunk of T as N float32 values, element e of the chunk in f[e]
template <typename T> struct Chunk;

template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void to_f32(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void to_f32(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {             // little endian: low half first
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// four int8 in w (byte 0 first) as float32, exactly: byte x + 128 is the
// low mantissa byte of 2^23 + (x + 128), less 2^23 + 128; a byte permute
// and a subtraction an element instead of an int-to-float conversion
__device__ __forceinline__ void i8x4_to_f32(unsigned w, float* f) {
  const unsigned u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) -
           8388736.f;
}

template <> struct Chunk<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void to_f32(const uint4& u, float* f) {
    i8x4_to_f32(u.x, f);
    i8x4_to_f32(u.y, f + 4);
    i8x4_to_f32(u.z, f + 8);
    i8x4_to_f32(u.w, f + 12);
  }
};

__device__ __forceinline__ uint4 lds128(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

}  // namespace async_copy
