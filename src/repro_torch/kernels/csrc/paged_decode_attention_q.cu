// K7 paged_decode_attention_q: K4 over an int8 KV cache.  q (B,H,D)
// float32 or bfloat16, k/v pools (P,KH,BS,D) int8 with one float32 scale
// per row, k/v scales (P,KH,BS), tables (B,T) int32 and lengths (B,)
// int32, both read on the device.  Each cache element is dequantized in
// the kernel as float(q8) * s, right after its load; the float math after
// that is K4's (decode_attention.cuh with the RowScale policy), so on the
// float32 pools that hold float(q8) * s K7 gives K4's values bit for bit.
// The output has q's type.
//
// Replaces the Pallas TPU kernel paged_decode_attention_q_pallas
// (src/repro/kernels/decode_attention.py), which streams each physical
// block's int8 rows and their scales through the same scalar-prefetch
// index maps and dequantizes in VMEM.
//
// Bound on the H100: the bytes of the valid K/V rows and their scales
// (D + 4 bytes per row and head), each read once.  At Yi-6B's path shape
// (B 4, H 32, KH 4, D 128, blocks of 16) with lengths 1/37/1500/2048
// that is 3.8 MB, about 1.13 us at 3.35 TB/s, half of K4's 2.21 us on a
// bfloat16 pool.  The design does nothing more about that bound than
// K4's: the int8 row is half the bytes of a bfloat16 one and goes to
// shared memory by K4's 16-byte cp.async copies, each row's scale is read
// once, and the element is dequantized where the arithmetic reads it.

#include "decode_attention.cuh"

extern "C" long long paged_decode_attention_q_workspace_floats(int B, int H,
                                                               int S, int D) {
  return decode_attn::workspace_floats(B, H, S, D);
}

extern "C" int paged_decode_attention_q_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lengths, void* out, void* workspace, void* counters, int B,
    int H, int KH, int T, int BS, int D, float scale, int has_window,
    int window, int is_bf16, void* stream) {
  if (B < 1 || T < 1 || BS < 1 || D < 1 || D > decode_attn::MAX_D ||
      KH < 1 || H % KH != 0 ||
      (decode_attn::TILE % BS != 0 && BS % decode_attn::TILE != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* ws = static_cast<float*>(workspace);
  int* ctr = static_cast<int*>(counters);
  const decode_attn::PagedRows rows{static_cast<const int*>(tables), KH, T,
                                    BS};
  const decode_attn::RowScale scl{static_cast<const float*>(k_scales),
                                  static_cast<const float*>(v_scales)};
  const int S = T * BS;
  if (is_bf16)
    return decode_attn::launch<__nv_bfloat16, int8_t>(
        q, k_pool, v_pool, scl, rows, len, out, ws, ctr, B, H, KH, S, D,
        scale, has_window, window, st);
  return decode_attn::launch<float, int8_t>(q, k_pool, v_pool, scl, rows,
                                            len, out, ws, ctr, B, H, KH, S, D,
                                            scale, has_window, window, st);
}
