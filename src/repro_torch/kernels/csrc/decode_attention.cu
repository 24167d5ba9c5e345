// K3 decode_attention: one query token per sequence against a contiguous
// KV cache.  q (B,H,D), k/v caches (B,KH,S,D), lengths (B,) int32 read on
// the device; the kernel and its design are in decode_attention.cuh,
// shared with K4 and K7.
//
// Replaces the Pallas TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention.py).
//
// Bound on the H100: the bytes of the valid K/V rows (each read once), far
// above the 4*H*D operations per valid position.  At Yi-6B's decode shape
// (B 4, H 32, KH 4, S 2048, D 128) in bfloat16 with every row full that is
// about 16.8 MB per call, about 5.0 us at 3.35 TB/s; with lengths
// 1/37/1500/2048 7.3 MB, 2.2 us.  One launch: 128-position runs copied by
// cp.async four 32-row stages at once, partials only where a run holds
// rows, combined in run order by the last block to arrive.
//
// lse (B,H) float32 or null: each head's log-sum-exp over its valid rows
// (-inf for none), for merging the attentions over a rank's rows of a
// sequence-sharded cache; a rank passes its cache rows [r*S, (r+1)*S)
// and its lengths clamped to them, clamp(n - r*S, 0, S).

#include "decode_attention.cuh"

namespace {

// row p of (b, kv head) in a (B, KH, S, D) cache
struct ContiguousRows {
  int KH, S;
  __device__ __forceinline__ long long operator()(int b, int kvh,
                                                  int p) const {
    return ((long long)b * KH + kvh) * S + p;
  }
};

}  // namespace

extern "C" long long decode_attention_workspace_floats(int B, int H, int S,
                                                       int D) {
  return decode_attn::workspace_floats(B, H, S, D);
}

extern "C" int decode_attention_attributes(int is_bf16, int G, int D,
                                           int* regs, int* smem) {
  using decode_attn::NoScale;
  if (is_bf16)
    return decode_attn::attributes<__nv_bfloat16, __nv_bfloat16, NoScale,
                                   ContiguousRows>(G, D, regs, smem);
  return decode_attn::attributes<float, float, NoScale, ContiguousRows>(
      G, D, regs, smem);
}

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* workspace,
                                       void* counters, int B, int H,
                                       int KH, int S, int D,
                                       float scale, int has_window,
                                       int window, int is_bf16,
                                       void* stream, void* lse) {
  if (B < 1 || S < 1 || D < 1 || D > decode_attn::MAX_D || KH < 1 ||
      H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* ws = static_cast<float*>(workspace);
  int* ctr = static_cast<int*>(counters);
  const ContiguousRows rows{KH, S};
  const decode_attn::NoScale none{};
  float* lse_out = static_cast<float*>(lse);
  if (is_bf16)
    return decode_attn::launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, none, rows, len, out, ws, ctr, B, H, KH, S, D, scale,
        has_window, window, st, lse_out);
  return decode_attn::launch<float, float>(q, k, v, none, rows, len, out, ws,
                                           ctr, B, H, KH, S, D, scale,
                                           has_window, window, st, lse_out);
}
