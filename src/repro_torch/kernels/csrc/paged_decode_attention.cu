// K4 paged_decode_attention: K3 reading its rows through a block table.
// q (B,H,D), k/v pools (P,KH,BS,D) of q's type, tables (B,T) int32 and
// lengths (B,) int32, both read on the device.  Logical position p of
// sequence b lives in physical block tables[b, p / BS] at row p % BS; the
// sequence has S = T*BS logical positions.  Masking, GQA sharing, empty
// rows (0) and the arithmetic are K3's (decode_attention.cuh): at the same
// valid rows K4 gives K3's values bit for bit.  Table entries past a
// row's valid range are never read, so unmapped entries (block 0, the
// pool's garbage block) are never weighted.
//
// Replaces the Pallas TPU kernel paged_decode_attention_pallas
// (src/repro/kernels/decode_attention.py), which picks each tile's
// physical block in its BlockSpec index map (scalar prefetch); here each
// row's address is computed from the table inside the block.
//
// Bound on the H100: the bytes of the valid K/V rows, as for K3 (7.4 MB,
// 2.2 us at 3.35 TB/s at Yi-6B's path shape with lengths 1/37/1500/2048);
// the table adds 4 bytes per block.  Each block looks up the table entry
// of each of its valid rows once, before its copies; BS divides the
// 32-row tile or is a multiple of it, the contract K4 has had since it
// was written.
//
// lse (B,H) float32 or null, as K3's.  A rank of a sequence-sharded pool
// holds rows [r*BS, (r+1)*BS) of every block of the full pool's size
// m*BS: it passes its pool, whose block size is BS, the same tables, and
// the count of its rows below each length n, (n / (m*BS))*BS +
// clamp(n % (m*BS) - r*BS, 0, BS).  Local row j of table entry t is
// global position t*m*BS + r*BS + j, a monotone map, so the first count
// local rows are exactly the rank's valid ones.

#include "decode_attention.cuh"

extern "C" long long paged_decode_attention_workspace_floats(int B, int H,
                                                             int S, int D) {
  return decode_attn::workspace_floats(B, H, S, D);
}

extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, void* workspace, void* counters, int B,
    int H, int KH, int T, int BS, int D, float scale, int has_window,
    int window, int is_bf16, void* stream, void* lse) {
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
  const decode_attn::NoScale none{};
  const int S = T * BS;
  float* lse_out = static_cast<float*>(lse);
  if (is_bf16)
    return decode_attn::launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, none, rows, len, out, ws, ctr, B, H, KH, S, D,
        scale, has_window, window, st, lse_out);
  return decode_attn::launch<float, float>(q, k_pool, v_pool, none, rows,
                                           len, out, ws, ctr, B, H, KH, S, D,
                                           scale, has_window, window, st,
                                           lse_out);
}
