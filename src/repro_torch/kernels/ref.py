"""Plain PyTorch versions of the ported kernels.

These are the "reference kernels" in the paper's sense (§4.7: readable,
portable, correctness-first), the counterparts of ``repro.kernels.ref``.
Each kernel's wrapper uses the function here for a tensor on the CPU,
and the checks on the card hold the CUDA kernel against it on the same
inputs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.quantize import unpack_int4

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# quantized matmul (the CMSIS-NN FC/conv-core analogue)
# ---------------------------------------------------------------------------

def quant_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                     bias_q: Optional[torch.Tensor], x_zp: int,
                     scale: torch.Tensor, out_zp: int) -> torch.Tensor:
    """int8 (M,K) @ int8 (K,N) -> int8 (M,N).

    acc = sum_k (x - x_zp) * w + bias;  out = clip(round(acc*scale)+zp).
    ``scale`` is f32 per output channel (s_x*s_w[n]/s_out).  The integer
    product is taken in float64 (exact for any K below 2^38 here) because
    torch has no int32 matmul on the card; round is half-to-even.
    """
    acc = torch.matmul(x_q.to(torch.float64) - x_zp, w_q.to(torch.float64))
    acc = acc.to(torch.int32)
    if bias_q is not None:
        acc = acc + bias_q.to(torch.int32)[None, :]
    out = torch.round(acc.to(torch.float32) * scale[None, :]) + out_zp
    return out.clamp(-128, 127).to(torch.int8)


# ---------------------------------------------------------------------------
# weight-dequant matmul (quantized serving's MLP)
# ---------------------------------------------------------------------------

def dequant_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """float32 (M,K) · int8 (K,N), per-output-channel float32 ``scale``
    (N or (1,N)) -> float32 (M,N).  The weight is cast to float32, the
    product accumulates in float32 and the scale multiplies each output
    once after the sum over K (symmetric per-channel scales commute with
    it)."""
    acc = x.float() @ w_q.float()
    return acc * scale.reshape(1, -1).float()


def dequant_matmul_i4_ref(x: torch.Tensor, w_p: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """:func:`dequant_matmul_ref` over packed int4 (K, N/2) bytes: column
    2j is byte j's low nibble, column 2j+1 its high nibble."""
    return dequant_matmul_ref(x, unpack_int4(w_p), scale)


# ---------------------------------------------------------------------------
# flash attention (prefill) — causal, GQA, optional sliding window
# ---------------------------------------------------------------------------

def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, KH, S, D) with H % KH == 0 (GQA).

    window=W restricts key j to q position i: i - W < j <= i.  Math is
    f32 and the result has q's dtype.  A row with no valid key outputs 0,
    as the flash kernels do (a plain softmax would give NaN there).
    """
    b, h, s, d = q.shape
    group = h // k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kx = k.repeat_interleave(group, dim=1).to(torch.float32)
    vx = v.repeat_interleave(group, dim=1).to(torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kx) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    logits = logits.masked_fill(~mask, -math.inf)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(mask.any(dim=-1)[:, None], w, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", w, vx).to(q.dtype)


# ---------------------------------------------------------------------------
# decode attention — one new token against a KV cache
# ---------------------------------------------------------------------------

def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """q: (B, H, D); caches: (B, KH, S, D) with H % KH == 0 (GQA);
    lengths: (B,) valid entries.  Returns (B, H, D).

    With window=W only the last W valid positions attend.  Math is f32
    and the result has q's dtype.  A row with no valid key outputs 0, as
    the decode kernels do (a plain softmax would give NaN there).
    ``return_lse``: also the float32 log-sum-exp (B, H) of each head's
    scaled scores over its valid keys, -inf for a row with none — what
    combines partial attentions over parts of the rows.
    """
    b, h, d = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kh, h // kh, d).to(torch.float32)
    logits = (qg @ k_cache.to(torch.float32).transpose(-1, -2)) * scale
    pos = torch.arange(s, device=q.device)[None, :]
    valid = pos < lengths[:, None]
    if window is not None:
        valid &= pos >= lengths[:, None] - window
    logits = logits.masked_fill(~valid[:, None, None, :], -math.inf)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(valid.any(dim=-1)[:, None, None, None], w, 0.0)
    out = w @ v_cache.to(torch.float32)                  # (B, KH, G, D)
    out = out.reshape(b, h, d).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1).reshape(b, h)
    return out


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, tables: torch.Tensor,
                               lengths: torch.Tensor,
                               window: Optional[int] = None,
                               scale: Optional[float] = None,
                               return_lse: bool = False):
    """Paged twin of :func:`decode_attention_ref` (``return_lse`` as
    there).

    q: (B, H, D); pools: (P, KH, BS, D), the shared physical block pool;
    tables: (B, T) int32 physical block ids in logical order (unmapped
    tail entries point at the pool's garbage block 0); lengths: (B,)
    valid entries.  Gathers each row's blocks into a contiguous
    (B, KH, T*BS, D) cache and delegates to the contiguous version, so a
    paged cache whose gathered view equals a contiguous one gives
    bit-identical output.
    """
    _, kh, bs, d = k_pool.shape
    b, t = tables.shape
    idx = tables.long()
    kc = k_pool[idx].transpose(1, 2).reshape(b, kh, t * bs, d)
    vc = v_pool[idx].transpose(1, 2).reshape(b, kh, t * bs, d)
    return decode_attention_ref(q, kc, vc, lengths, window=window,
                                scale=scale, return_lse=return_lse)


def paged_decode_attention_q_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, k_scales: torch.Tensor,
                                 v_scales: torch.Tensor, tables: torch.Tensor,
                                 lengths: torch.Tensor,
                                 window: Optional[int] = None,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Int8-KV twin of :func:`paged_decode_attention_ref`: pools (P, KH,
    BS, D) int8 with one float32 scale per row (P, KH, BS).  Gathers each
    row's blocks, dequantizes them as ``float(q8) · s`` and runs the
    float math of the contiguous version, so it equals
    :func:`paged_decode_attention_ref` on the dequantized pools bit for
    bit; q's dtype out."""
    _, kh, bs, d = k_pool.shape
    b, t = tables.shape
    idx = tables.long()

    def gather(pool, scales):
        rows = pool[idx].transpose(1, 2).reshape(b, kh, t * bs, d)
        s = scales[idx].transpose(1, 2).reshape(b, kh, t * bs)
        return rows.float() * s[..., None].float()
    return decode_attention_ref(q, gather(k_pool, k_scales),
                                gather(v_pool, v_scales), lengths,
                                window=window, scale=scale)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality) scan
# ---------------------------------------------------------------------------

def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: Optional[torch.Tensor] = None,
            h0: Optional[torch.Tensor] = None):
    """The selective state-space recurrence, one position at a time — the
    sequential oracle of ``repro.kernels.ref.ssd_ref``:

      h_t = exp(dt_t A_h) * h_{t-1} + dt_t * x_t ⊗ B_t
      y_t = C_t · h_t (+ D_h x_t)

    x (B,S,H,P); dt (B,S,H); A (H,) negative; B, C (B,S,G,N) with H % G
    == 0 (head h reads group h // (H/G)); D (H,) or None; h0 (B,H,P,N) or
    None (zeros).  Returns y (B,S,H,P) in x's dtype and the final state
    (B,H,P,N) in float32."""
    b, s, h, p = x.shape
    n = B.shape[3]
    group = h // B.shape[2]
    bh = B.float().repeat_interleave(group, dim=2)           # (B,S,H,N)
    ch = C.float().repeat_interleave(group, dim=2)
    xf, dtf, af = x.float(), dt.float(), A.float()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af[None, :])           # (B,H)
        upd = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]
               * bh[:, t, :, None, :])                       # (B,H,P,N)
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros_like(xf))
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), state


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor,
                 D: Optional[torch.Tensor] = None, *, chunk: int = 128,
                 h0: Optional[torch.Tensor] = None):
    """The chunked scan K8 computes, as ``ssd_scan_pallas`` computes it,
    for every (b, h) at once: per chunk of ``chunk`` rows (S % chunk ==
    0), in order, ``cum = cumsum(dt·A)``;
    ``y = (C·Bᵀ ∘ exp(cum_i − cum_j))_{j<=i}·(x·dt) + exp(cum)·(C·stateᵀ)
    (+ D·x)``, the difference masked to -1e30 for j > i before the exp,
    y cast to x's dtype; ``state ← exp(cum_L)·state +
    (x·dt·exp(cum_L − cum))ᵀ·B``.  The state (B,H,P,N) is float32 and
    starts from ``h0`` (zeros when None).  Shapes as ``ssd_ref``."""
    b, s, h, p = x.shape
    n = B.shape[3]
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan: sequence {s} is not a multiple of the "
                         f"chunk {chunk}")
    group = h // B.shape[2]
    bh = B.float().repeat_interleave(group, dim=2).transpose(1, 2)
    ch = C.float().repeat_interleave(group, dim=2).transpose(1, 2)
    xf = x.float().transpose(1, 2)                           # (B,H,S,P)
    dtf = dt.float().transpose(1, 2)                         # (B,H,S)
    af = A.float()[None, :, None]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    idx = torch.arange(chunk, device=x.device)
    causal = idx[None, :] <= idx[:, None]                    # j <= i
    ys = []
    for c0 in range(0, s, chunk):
        xc, dtc = xf[:, :, c0:c0 + chunk], dtf[:, :, c0:c0 + chunk]
        bc, cc = bh[:, :, c0:c0 + chunk], ch[:, :, c0:c0 + chunk]
        cum = torch.cumsum(dtc * af, dim=-1)                 # (B,H,L)
        expo = (cum[..., :, None] - cum[..., None, :]).masked_fill(
            ~causal, NEG_INF)
        m = (cc @ bc.transpose(-1, -2)) * torch.exp(expo)    # (B,H,L,L)
        y = m @ (xc * dtc[..., None])
        y = y + torch.exp(cum)[..., None] * (cc @ state.transpose(-1, -2))
        if D is not None:
            y = y + D.float()[None, :, None, None] * xc
        ys.append(y.transpose(1, 2).to(x.dtype))
        total = cum[..., -1:]                                # (B,H,1)
        w = dtc * torch.exp(total - cum)
        state = (torch.exp(total)[..., None] * state
                 + (xc * w[..., None]).transpose(-1, -2) @ bc)
    y = torch.cat(ys, dim=1) if ys else torch.empty_like(x)
    return y, state
