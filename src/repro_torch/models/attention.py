"""GQA attention (RoPE, qk_norm, sliding window, prefix-LM) on a
parameter module — the port's counterpart of ``repro.models.attention``.

The JAX module is the reference attention of one layer on a dict of
weights: the model families (``models.lm`` and the others) carry their
own attention, and this module is what a caller reaches for one layer's
prefill or decode on its own.  Here the weights are ``lm.Attention``
(``wq`` (D,H,dh), ``wk``/``wv`` (D,KH,dh), ``wo`` (H,dh,D), the q/k norms
for ``qk_norm``), and the functions take ``backend``:

  * ``"reference"`` — plain PyTorch: float32 logits masked to -1e30, as
    in JAX, so a fully masked row gives the uniform mean of its values,
    not NaN; the softmax weights are cast to the input's dtype before
    P·V;
  * ``"cuda"`` — the port's vendor tag in place of ``"pallas"``: causal
    self-attention prefill on K2 (``kernels.flash_attention``) and decode
    on K3 (``kernels.decode_attention``), where the JAX function runs its
    Pallas kernels.  A CPU tensor raises there (no fallback), as does a
    ``prefix_len`` prefill (the JAX function asserts it) and a
    differentiated input (a launch has no backward).  Cross-attention
    runs the reference math under either backend, as in JAX.

As in the JAX function, decode's ``window`` reaches only the kernel: the
reference decode attends every valid row of the cache (whose length is
the window when the caller rings it), and ``prefill_kv`` keeps the last
``cache_len`` positions of a longer prompt in slots 0.. in order.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ops import _no_backward

from .common import ModelConfig, apply_rope, dense_init, rms_norm, \
    rope_cos_sin
from .lm import NEG_INF, Attention, _from_numpy

BACKENDS = ("reference", "cuda")


def _backend(backend: str, x: torch.Tensor) -> bool:
    """Whether ``backend`` runs the kernels; raises on an unknown one, or
    on ``"cuda"`` with a tensor off the card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "cuda" and x.device.type != "cuda":
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got "
                         f"{x.device}")
    return backend == "cuda"


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> Attention:
    """One layer's attention weights drawn from ``gen`` (on ``device``,
    the generator's by default) by the JAX ``init_attention``'s rule:
    N(0, 1/sqrt(D)) for ``wq``/``wk``/``wv``, N(0, 1/sqrt(H·dh)) for
    ``wo``, norms of ones."""
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    p = Attention(cfg, dtype, gen.device)
    with torch.no_grad():
        p.wq.copy_(dense_init(gen, (d, h, dh), dtype=dtype))
        p.wk.copy_(dense_init(gen, (d, kh, dh), dtype=dtype))
        p.wv.copy_(dense_init(gen, (d, kh, dh), dtype=dtype))
        p.wo.copy_(dense_init(gen, (h, dh, d), scale=1.0 / math.sqrt(h * dh),
                              dtype=dtype))
        if cfg.qk_norm:
            p.q_norm.fill_(1.0)
            p.k_norm.fill_(1.0)
    return p if device is None else p.to(device)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Attention:
    """``lm.Attention`` holding the JAX ``init_attention`` dict's arrays
    (numpy, or anything ``np.asarray`` takes), leaf for leaf, in the
    arrays' dtype (bfloat16 where they are)."""
    name = np.asarray(tree["wq"]).dtype.name
    dtype = torch.bfloat16 if name == "bfloat16" else torch.float32
    p = Attention(cfg, dtype, device)
    with torch.no_grad():
        for key, param in p.named_parameters():
            param.copy_(_from_numpy(tree[key], dtype))
    return p


def _einsum_q(p: Attention, x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ p.wq.reshape(d, -1)).view(
        b, s, *p.wq.shape[1:])


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,H,dh), k/v (B,S,KH,dh), RoPE applied."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    q = _einsum_q(p, x)
    k = (flat @ p.wk.reshape(d, -1)).view(b, s, *p.wk.shape[1:])
    v = (flat @ p.wv.reshape(d, -1)).view(b, s, *p.wv.shape[1:])
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if cfg.rope_base:
        cos, sin = rope_cos_sin(positions, cfg.dh, cfg.rope_base)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _out(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """(..., H, dh) · wo (H,dh,D) -> (..., D)."""
    lead = out.shape[:-2]
    return (out.reshape(-1, p.wo.shape[0] * p.wo.shape[1])
            @ p.wo.reshape(-1, p.wo.shape[-1])).view(*lead, -1)


def _softmax_pv(logits: torch.Tensor, vx: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """softmax over the last axis of float32 logits, cast to ``dtype``,
    times the values (a matmul over that axis)."""
    return torch.softmax(logits, dim=-1).to(dtype) @ vx


def attention_prefill(p: Attention, cfg: ModelConfig, x: torch.Tensor, *,
                      prefix_len: int = 0, window: Optional[int] = None,
                      cross_kv: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None,
                      backend: str = "reference") -> torch.Tensor:
    """Full-sequence attention of x (B,S,D) -> (B,S,D).  ``prefix_len``
    > 0 gives PaliGemma's prefix-LM mask (the first ``prefix_len``
    positions visible to every query); ``cross_kv`` = (k, v), each
    (B,T,KH,dh), switches to cross-attention (no mask, no RoPE on the
    loaded K/V).  ``backend="cuda"`` runs causal self-attention on K2."""
    b, s, d = x.shape
    group = cfg.n_heads // cfg.n_kv_heads
    positions = torch.arange(s, device=x.device)
    kernel = _backend(backend, x)
    if cross_kv is not None:
        q = _einsum_q(p, x)
        if cfg.qk_norm:
            q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k, v = cross_kv
        mask = None
    else:
        q, k, v = _project_qkv(p, cfg, x, positions)
        mask = positions[None, :] <= positions[:, None]
        if prefix_len:
            mask = mask | (positions[None, :] < prefix_len)
        if window is not None:
            mask = mask & (positions[None, :] > positions[:, None] - window)
    if kernel and cross_kv is None:
        if prefix_len:
            raise ValueError("the cuda prefill path is pure-causal: "
                             "prefix_len must be 0")
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        _no_backward("flash_attention", qh, kh, vh)
        out = flash_attention_cuda(qh, kh, vh, causal=True,
                                   window=window).transpose(1, 2)
    else:
        kx = k.repeat_interleave(group, dim=2) if group > 1 else k
        vx = v.repeat_interleave(group, dim=2) if group > 1 else v
        scale = 1.0 / math.sqrt(cfg.dh)
        logits = (q.float().transpose(1, 2)
                  @ kx.float().permute(0, 2, 3, 1)) * scale   # (B,H,S,T)
        if mask is not None:
            logits = logits.masked_fill(~mask, NEG_INF)
        out = _softmax_pv(logits, vx.transpose(1, 2), x.dtype
                          ).transpose(1, 2)                   # (B,S,H,dh)
    return _out(p, out)


def prefill_kv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
               cache_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V of the whole prompt x (B,S,D) placed in a fresh cache of
    ``cache_len`` rows, (B,KH,cache_len,dh) each: the last
    min(S, cache_len) positions in slots 0.. in order, the rest zeros."""
    b, s, _ = x.shape
    _, k, v = _project_qkv(p, cfg, x, torch.arange(s, device=x.device))
    take = min(s, cache_len)
    out = []
    for t in (k, v):
        c = torch.zeros((b, cfg.n_kv_heads, cache_len, cfg.dh),
                        dtype=x.dtype, device=x.device)
        c[:, :, :take] = t[:, s - take:].transpose(1, 2)
        out.append(c)
    return out[0], out[1]


def attention_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
                     *, window: Optional[int] = None,
                     cross_kv: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                     cross_len: Optional[int] = None,
                     backend: str = "reference"
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x (B,1,D); cache {k, v}: (B,KH,C,dh), C the
    full context or a ring of the window; ``lengths`` (B,) the tokens so
    far (the new token's absolute position).  The new K/V go to ring
    slot ``lengths % C`` by the JAX function's one-hot blend, into a new
    cache; returns (out (B,1,D), that cache).  ``cross_kv`` = (k, v),
    each (B,KH,T,dh), attends over them instead (the first ``cross_len``
    rows where given), and returns the cache as it is.
    ``backend="cuda"`` runs the self-attention on K3 with ``window``."""
    b = x.shape[0]
    group = cfg.n_heads // cfg.n_kv_heads
    scale = 1.0 / math.sqrt(cfg.dh)
    kernel = _backend(backend, x)
    if cross_kv is not None:
        q = _einsum_q(p, x)[:, 0]
        if cfg.qk_norm:
            q = rms_norm(q, p.q_norm, cfg.norm_eps)
        kx, vx = cross_kv
        kx = kx.repeat_interleave(group, dim=1) if group > 1 else kx
        vx = vx.repeat_interleave(group, dim=1) if group > 1 else vx
        logits = (q.float()[:, :, None] @ kx.float().transpose(-1, -2)
                  )[:, :, 0] * scale                            # (B,H,T)
        if cross_len is not None:
            pos = torch.arange(kx.shape[2], device=x.device)
            logits = logits.masked_fill(pos >= cross_len, NEG_INF)
        out = _softmax_pv(logits[:, :, None], vx, x.dtype)[:, :, 0]
        return _out(p, out)[:, None], cache
    q, k, v = _project_qkv(p, cfg, x, lengths[:, None])
    q = q[:, 0]                                                 # (B,H,dh)
    c = cache["k"].shape[2]
    slot = lengths.long() % c
    onehot = torch.nn.functional.one_hot(slot, c).to(x.dtype)   # (B,C)
    keep = (1 - onehot)[:, None, :, None]
    put = onehot[:, None, :, None]
    kc = cache["k"] * keep + k[:, 0][:, :, None, :] * put
    vc = cache["v"] * keep + v[:, 0][:, :, None, :] * put
    n_valid = torch.clamp(lengths + 1, max=c)
    if kernel:
        _no_backward("decode_attention", q, kc, vc)
        out = decode_attention_cuda(q.contiguous(), kc, vc,
                                    n_valid.to(torch.int32).contiguous(),
                                    window=window)
    else:
        kx = kc.repeat_interleave(group, dim=1) if group > 1 else kc
        vx = vc.repeat_interleave(group, dim=1) if group > 1 else vc
        logits = (q.float()[:, :, None] @ kx.float().transpose(-1, -2)
                  )[:, :, 0] * scale                            # (B,H,C)
        pos = torch.arange(c, device=x.device)
        logits = logits.masked_fill(pos >= n_valid[:, None, None], NEG_INF)
        out = _softmax_pv(logits[:, :, None], vx, x.dtype)[:, :, 0]
    return _out(p, out)[:, None], {"k": kc, "v": vc}
