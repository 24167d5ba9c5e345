"""Decoder-only LM, dense family — the pod-path model.

The port's counterpart of the dense path of ``repro.models.lm``: Yi-6B,
Phi-3-mini, Phi-4-mini and Qwen3 (``qk_norm``).  Parameters keep the JAX
package's layouts (``wq`` (D,H,dh), ``wo`` (H,dh,D), ``wi`` (D,F), …) so
``params_from_jax`` copies them leaf for leaf; they live in one
``DenseLM`` module holding one ``DenseBlock`` per layer where the JAX
package stacks a leading ``L`` dim and scans.  The steps are plain
functions on tensors, as in the JAX package:

  * ``lm_prefill`` — a prompt through every layer, causal (+window)
    query-chunked attention, emitting last-token logits and a KV cache
    ``{k, v}`` of (L, B, KH, C, dh) ring-indexed by absolute position;
  * ``lm_decode`` — one token per sequence against that cache.  The
    cache is updated IN PLACE (an index write at ring slot
    ``lengths % C``), which gives exactly the values of the JAX
    package's one-hot blend (it multiplies by exact 0 and 1) without a
    copy of the cache per step; ``attn_impl`` is the vendor-kernel hook
    (§4.8) that replaces only the attention math;
  * ``lm_decode_paged`` — the same step over a shared pool of KV blocks
    (L, P, KH, BS, dh) with a block table per slot, written in place;
  * ``lm_prefill_chunk`` / ``lm_prefill_chunk_paged`` — one prompt
    chunk at a host start offset into a slot's cache or its blocks,
    written in place.

The decode steps read ``lengths`` (and the block tables) on the device
and take no branch on a device value, so they never wait for the device.
MoE comes with a later slice.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.executor import resolve_device

from .common import (ModelConfig, apply_rope, dense_init, rms_norm,
                     rope_cos_sin)

Cache = Dict[str, torch.Tensor]

# the JAX package pads the vocab to a multiple of 2048 (16 model shards
# x 128 lanes); the port keeps the padding so logits have the same shape
VOCAB_PAD = 2048
GATED_ACTS = ("silu", "geglu")
NEG_INF = -1e30


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // VOCAB_PAD) * VOCAB_PAD


# ---------------------------------------------------------------------------
# the model: parameters only, in the JAX package's layouts
# ---------------------------------------------------------------------------

def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    """wq (D,H,dh), wk/wv (D,KH,dh), wo (H,dh,D); q/k norms for qk_norm."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
        self.wq = _param((d, h, dh), dtype, device)
        self.wk = _param((d, kh, dh), dtype, device)
        self.wv = _param((d, kh, dh), dtype, device)
        self.wo = _param((h, dh, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = _param((dh,), dtype, device)
            self.k_norm = _param((dh,), dtype, device)


class MLP(nn.Module):
    """wi (D,F), wg (D,F) for gated activations, wo (F,D)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wi = _param((d, f), dtype, device)
        if cfg.act in GATED_ACTS:
            self.wg = _param((d, f), dtype, device)
        self.wo = _param((f, d), dtype, device)


class DenseBlock(nn.Module):
    """One pre-norm transformer layer: ln1 → attention, ln2 → MLP."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)


class DenseLM(nn.Module):
    """The dense LM's parameters: embedding (V_pad, D), one DenseBlock
    per layer, final norm and (untied) head (D, V_pad).  Built empty
    on ``device`` (the card by default; raises without one — pass
    ``"cpu"`` for the CPU); ``init_lm`` or ``params_from_jax`` fills
    it."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.n_experts or cfg.first_layer_dense_ff:
            raise ValueError(f"{cfg.arch_id}: DenseLM holds the dense "
                             f"family only")
        device = resolve_device(device)
        dtype, vp, d = cfg.torch_dtype(), padded_vocab(cfg), cfg.d_model
        self.cfg = cfg
        self.embed = _param((vp, d), dtype, device)
        self.final_norm = _param((d,), dtype, device)
        self.layers = nn.ModuleList(DenseBlock(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.lm_head = _param((d, vp), dtype, device)


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> DenseLM:
    """Seeded random weights on ``gen.device``, following the JAX
    ``init_lm``'s rules leaf by leaf: ``dense_init``'s 1/sqrt(fan-in)
    with fan-in = shape[0], and the explicit scales of ``wo`` and the
    embeddings.  The JAX package applies the rule to leaves stacked as
    (L, …), so its fan-in there is L and its attention nearly one-hot
    (ROADMAP queue 3); the port draws each layer's leaf on its own, so
    its fan-in is the leaf's input width."""
    dtype = cfg.torch_dtype()
    model = DenseLM(cfg, gen.device)
    with torch.no_grad():
        model.embed.copy_(dense_init(gen, model.embed.shape, 0.02, dtype))
        model.final_norm.fill_(1)
        for blk in model.layers:
            init_dense_block(gen, blk, cfg)
        if not cfg.tie_embeddings:
            model.lm_head.copy_(dense_init(gen, model.lm_head.shape, 0.02,
                                           dtype))
    return model


def init_dense_block(gen: torch.Generator, blk: DenseBlock,
                     cfg: ModelConfig) -> None:
    """One layer's seeded weights by ``init_lm``'s rules (the hybrid
    family's shared block is drawn by them too)."""
    dtype = blk.ln1.dtype
    h, dh, f = cfg.n_heads, cfg.dh, cfg.d_ff
    blk.ln1.fill_(1)
    blk.ln2.fill_(1)
    a = blk.attn
    for w in (a.wq, a.wk, a.wv):
        w.copy_(dense_init(gen, w.shape, dtype=dtype))
    a.wo.copy_(dense_init(gen, a.wo.shape, 1.0 / math.sqrt(h * dh), dtype))
    if cfg.qk_norm:
        a.q_norm.fill_(1)
        a.k_norm.fill_(1)
    m = blk.mlp
    m.wi.copy_(dense_init(gen, m.wi.shape, dtype=dtype))
    m.wo.copy_(dense_init(gen, m.wo.shape, 1.0 / math.sqrt(f), dtype))
    if cfg.act in GATED_ACTS:
        m.wg.copy_(dense_init(gen, m.wg.shape, dtype=dtype))


def _from_numpy(a: Any, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: widen exactly
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(dtype)      # a writable copy


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> DenseLM:
    """The JAX ``init_lm`` tree (leaves as numpy arrays, per-layer leaves
    stacked on a leading L dim) as the port's ``DenseLM`` on ``device``
    (the card by default, as ``DenseLM``), leaf for leaf, so both
    packages compute with the same weights."""
    dtype = cfg.torch_dtype()
    model = DenseLM(cfg, device)
    blocks = tree["blocks"]

    def put(param: nn.Parameter, value) -> None:
        value = _from_numpy(value, dtype)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"shape {tuple(value.shape)} != "
                             f"{tuple(param.shape)}")
        param.copy_(value)

    with torch.no_grad():
        put(model.embed, tree["embed"])
        put(model.final_norm, tree["final_norm"])
        if not cfg.tie_embeddings:
            put(model.lm_head, tree["lm_head"])
        for i, blk in enumerate(model.layers):
            put(blk.ln1, blocks["ln1"][i])
            put(blk.ln2, blocks["ln2"][i])
            for name, param in blk.attn.named_parameters():
                put(param, blocks["attn"][name][i])
            for name, param in blk.mlp.named_parameters():
                put(param, blocks["mlp"][name][i])
    return model


# ---------------------------------------------------------------------------
# attention — query-chunked causal/windowed (prefill)
# ---------------------------------------------------------------------------

def _proj_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,H,dh), k/v (B,S,KH,dh) with qk_norm + RoPE."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    q = (flat @ p.wq.reshape(d, -1)).view(b, s, *p.wq.shape[1:])
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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg: ModelConfig, *, window: Optional[int] = None,
                      chunk: int = 512) -> torch.Tensor:
    """Causal (+sliding-window) attention, O(S·chunk) logits.

    q (B,S,H,dh); k,v (B,S,KH,dh).  Returns (B,S,H,dh).  Logits are
    float32, masked to -1e30, and the softmax weights are cast to v's
    dtype before P·V, as the JAX package does.  S must be a multiple of
    the chunk (min(chunk, S)), as there."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the "
                         f"attention chunk {chunk}")
    scale = 1.0 / math.sqrt(dh)
    kx = (k.repeat_interleave(g, dim=2) if g > 1 else k).transpose(1, 2)
    vx = (v.repeat_interleave(g, dim=2) if g > 1 else v).transpose(1, 2)
    kxf = kx.float()
    kpos = torch.arange(s, device=q.device)
    outs = []
    for start in range(0, s, chunk):
        qc = q[:, start:start + chunk].transpose(1, 2)     # (B,H,c,dh)
        logits = (qc.float() @ kxf.transpose(-1, -2)) * scale
        qpos = start + torch.arange(chunk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        logits = logits.masked_fill(~mask, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append((w @ vx).transpose(1, 2))             # (B,c,H,dh)
    return torch.cat(outs, dim=1)


def _out_proj(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """(B,S,H,dh) · wo (H,dh,D) -> (B,S,D)."""
    b, s = out.shape[:2]
    return (out.reshape(b * s, -1) @ p.wo.reshape(-1, p.wo.shape[-1])
            ).view(b, s, -1)


# ---------------------------------------------------------------------------
# decode attention (one token, ring KV cache)
# ---------------------------------------------------------------------------

def decode_attention_block(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                           cache_k: torch.Tensor, cache_v: torch.Tensor,
                           lengths: torch.Tensor, attn_impl=None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """x (B,1,D); cache_k/v (B,KH,C,dh); lengths (B,) = tokens already in
    context (the new token's absolute position).  Ring-buffer update, in
    place.  Returns (out (B,1,D), cache_k, cache_v).

    ``attn_impl`` replaces only the attention math — called as
    ``attn_impl(q (B,H,dh), kc, vc, n_valid) -> (B,H,dh)`` over the
    already-updated cache; the ring update and output projection stay
    those of the reference path."""
    b = x.shape[0]
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    g = h // kh
    c = cache_k.shape[2]
    q, k, v = _proj_qkv(p, cfg, x, lengths[:, None])
    rows = torch.arange(b, device=x.device)
    slot = lengths % c
    # the JAX package blends with a one-hot (cache*(1-oh) + k*oh); the
    # index write stores exactly the same values
    cache_k[rows, :, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, :, slot] = v[:, 0].to(cache_v.dtype)
    n_valid = torch.clamp(lengths + 1, max=c)
    if attn_impl is not None:
        out = attn_impl(q[:, 0], cache_k, cache_v, n_valid)
    else:
        out = _decode_attend(q[:, 0], cache_k, cache_v, n_valid)
    y = _out_proj(p, out.reshape(b, 1, h, dh))
    return y, cache_k, cache_v


def _decode_attend(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                   n_valid: torch.Tensor) -> torch.Tensor:
    """The reference decode attention: q (B,H,dh) over caches (B,KH,C,dh),
    the first ``n_valid`` positions of each row valid.  Float32 logits
    masked to -1e30, softmax weights cast to q's dtype before P·V, as
    the JAX package does.  Returns (B,KH,H/KH,dh)."""
    b, h, dh = q.shape
    kh, c = kc.shape[1], kc.shape[2]
    qg = q.reshape(b, kh, h // kh, dh)
    scale = 1.0 / math.sqrt(dh)
    logits = (qg.float() @ kc.float().transpose(-1, -2)) * scale
    valid = (torch.arange(c, device=q.device)[None, None, None, :]
             < n_valid[:, None, None, None])
    logits = logits.masked_fill(~valid, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return w @ vc                                          # (B,KH,g,dh)


# ---------------------------------------------------------------------------
# decode attention — paged KV (block pool + per-slot block table)
# ---------------------------------------------------------------------------

def paged_decode_attention_block(p: Attention, cfg: ModelConfig,
                                 x: torch.Tensor, pool_k: torch.Tensor,
                                 pool_v: torch.Tensor, tables: torch.Tensor,
                                 lengths: torch.Tensor, attn_impl=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Paged twin of ``decode_attention_block``: the slot's KV rows live
    scattered across a shared pool of physical blocks.

    x (B,1,D); pool_k/v (P,KH,BS,dh), ONE layer's blocks; tables (B,T)
    int32 physical block ids in logical order (T·BS = the slot's ring
    capacity, unmapped tail entries = the garbage block 0); lengths (B,)
    absolute positions.  The new token's K/V land at ring position
    ``pos = lengths % (T·BS)``, i.e. at row ``pos % BS`` of block
    ``tables[b, pos // BS]``, written in place.  Slots that are inactive
    or mid-chunk keep their table row on block 0, so their writes may
    collide there (any one wins); nothing reads block 0 under a positive
    weight.  The reference attention gathers the table back to a
    contiguous (B,KH,C,dh) view and runs the contiguous block's math, so
    decoded values are the contiguous path's; ``attn_impl`` (the
    vendor-kernel hook) instead takes the pool and table:
    ``attn_impl(q (B,H,dh), pool_k, pool_v, tables, n_valid)``."""
    b = x.shape[0]
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    bs, t = pool_k.shape[2], tables.shape[1]
    c = t * bs
    q, k, v = _proj_qkv(p, cfg, x, lengths[:, None])
    pos = (lengths % c).long()
    phys = tables.gather(1, (pos // bs)[:, None])[:, 0].long()
    off = pos % bs
    pool_k[phys, :, off] = k[:, 0].to(pool_k.dtype)
    pool_v[phys, :, off] = v[:, 0].to(pool_v.dtype)
    n_valid = torch.clamp(lengths + 1, max=c)
    if attn_impl is not None:
        out = attn_impl(q[:, 0], pool_k, pool_v, tables, n_valid)
    else:
        idx = tables.long()
        kc = pool_k[idx].transpose(1, 2).reshape(b, kh, c, dh)
        vc = pool_v[idx].transpose(1, 2).reshape(b, kh, c, dh)
        out = _decode_attend(q[:, 0], kc, vc, n_valid)
    y = _out_proj(p, out.reshape(b, 1, h, dh))
    return y, pool_k, pool_v


# ---------------------------------------------------------------------------
# FFN — dense (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def _gate(act: str, g: torch.Tensor) -> torch.Tensor:
    return F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")


def mlp_block(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    hidden = x @ p.wi
    if cfg.act in GATED_ACTS:
        hidden = _gate(cfg.act, x @ p.wg) * hidden
    else:
        # jax.nn.gelu defaults to the tanh approximation
        hidden = F.gelu(hidden, approximate="tanh")
    return hidden @ p.wo


# ---------------------------------------------------------------------------
# embedding and head
# ---------------------------------------------------------------------------

def embed_tokens(model: DenseLM, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, model.embed)


def lm_logits(model: DenseLM, cfg: ModelConfig,
              h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, model.final_norm, cfg.norm_eps)
    head = model.embed.t() if cfg.tie_embeddings else model.lm_head
    return h @ head


# ---------------------------------------------------------------------------
# public steps
# ---------------------------------------------------------------------------

def empty_cache(cfg: ModelConfig, batch: int, cache_len: int,
                dtype: torch.dtype, device) -> Cache:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cache_len, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _to_cache(dst: torch.Tensor, k: torch.Tensor) -> None:
    """Write prefill K or V (B,S,KH,dh) into one layer's cache
    (B,KH,C,dh): in order when C >= S, else the last C tokens at ring
    slots pos % C."""
    s, c = k.shape[1], dst.shape[2]
    take = min(s, c)
    src = k[:, s - take:].transpose(1, 2)
    if c >= s:
        dst[:, :, :take] = src
    else:
        pos = torch.arange(s - take, s, device=k.device) % c
        dst[:, :, pos] = src


def lm_prefill(model: DenseLM, cfg: ModelConfig, tokens: torch.Tensor,
               cache_len: Optional[int] = None, *,
               window: Optional[int] = None
               ) -> Tuple[torch.Tensor, Cache]:
    """tokens (B,S) -> (last-token logits (B,V_pad), cache dict).

    cache layout: k/v (L, B, KH, C, dh) ring-indexed by absolute pos,
    C = ``cache_len`` or S."""
    x = embed_tokens(model, cfg, tokens)
    b, s = x.shape[:2]
    cache = empty_cache(cfg, b, cache_len or s, x.dtype, x.device)
    for i, blk in enumerate(model.layers):
        x = prefill_layer(blk, cfg, x, cache["k"][i], cache["v"][i],
                          window=window)
    logits = lm_logits(model, cfg, x[:, -1:])[:, 0]
    return logits, cache


def prefill_layer(blk: DenseBlock, cfg: ModelConfig, x: torch.Tensor,
                  ck: torch.Tensor, cv: torch.Tensor, *,
                  window: Optional[int] = None) -> torch.Tensor:
    """One transformer layer over a whole prompt x (B,S,D) at positions
    0..S-1, its K/V written into ck/cv (B,KH,C,dh) (``_to_cache``).
    Returns x after the layer."""
    positions = torch.arange(x.shape[1], device=x.device)
    xin = rms_norm(x, blk.ln1, cfg.norm_eps)
    q, k, v = _proj_qkv(blk.attn, cfg, xin, positions)
    out = chunked_attention(q, k, v, cfg, window=window)
    h = x + _out_proj(blk.attn, out)
    _to_cache(ck, k)
    _to_cache(cv, v)
    return h + mlp_block(blk.mlp, cfg, rms_norm(h, blk.ln2, cfg.norm_eps))


def check_chunk_fits(start: int, s: int, capacity: int) -> None:
    """The chunk ``[start, start + s)`` must fit ``capacity`` positions
    without wrapping; raises otherwise.  The host-side bounds check of
    every chunk step (the serving engine's, and ``chunk_offset``'s)."""
    if not 0 <= start <= capacity - s:
        raise ValueError(f"chunk [{start}, {start + s}) does not fit the "
                         f"{capacity}-position cache without wrapping")


def chunk_offset(start, s: int, capacity: int,
                 device) -> torch.Tensor:
    """A chunk step's ``start`` as the int32 scalar tensor the step
    computes with.  The engine passes a tensor (it checked the host
    int); a host int is checked (``check_chunk_fits``) and converted."""
    if isinstance(start, torch.Tensor):
        return start
    check_chunk_fits(start, s, capacity)
    return torch.tensor(start, dtype=torch.int32, device=device)


def lm_prefill_chunk(model: DenseLM, cfg: ModelConfig, cache: Cache,
                     tokens: torch.Tensor, start, *,
                     window: Optional[int] = None) -> Cache:
    """One prompt CHUNK through the backbone: tokens (B,S) take absolute
    positions ``start .. start+S`` of a cache {k,v} (L,B,KH,C,dh) that
    already holds every earlier position.  Each layer writes the chunk's
    K/V at those positions, in place, then attends the chunk's queries
    over the whole cache with the mask ``kpos <= position`` (and the
    window): positions past the chunk weigh exactly 0.  Returns the
    cache; no logits (the engine hands the last prompt token to decode).
    ``start`` is an int32 scalar tensor, as in the JAX package, so one
    program serves every chunk (a host int is checked and converted,
    ``chunk_offset``); ``start + S <= C`` (no ring wrap)."""
    x = embed_tokens(model, cfg, tokens)
    s, c = x.shape[1], cache["k"].shape[3]
    start = chunk_offset(start, s, c, x.device)
    positions = start + torch.arange(s, device=x.device)
    for i, blk in enumerate(model.layers):
        x, _, _ = _chunk_layer(blk, cfg, x, cache["k"][i], cache["v"][i],
                               positions, window)
    return cache


def lm_prefill_chunk_paged(model: DenseLM, cfg: ModelConfig, pool: Cache,
                           table_row: torch.Tensor, tokens: torch.Tensor,
                           start, *,
                           window: Optional[int] = None) -> Cache:
    """Paged twin of ``lm_prefill_chunk`` for one slot: pool {k,v}
    (L,P,KH,BS,dh), table_row (T,) its block ids in logical order.  The
    JAX package gathers the whole slot (all layers) to a contiguous
    batch=1 cache, runs ``lm_prefill_chunk`` and scatters the whole slot
    back; here each layer gathers its own (1,KH,T·BS,dh) view, runs the
    same layer math on it, and writes only the chunk's rows back into
    the pool, in place.  The values are the JAX function's: the rest of
    the slot is written back unchanged there.  ``start`` as in
    ``lm_prefill_chunk``."""
    x = embed_tokens(model, cfg, tokens)
    s = x.shape[1]
    bs, t = pool["k"].shape[3], table_row.shape[0]
    start = chunk_offset(start, s, t * bs, x.device)
    positions = start + torch.arange(s, device=x.device)
    idx = table_row.long()
    phys, off = idx[positions // bs], positions % bs
    for i, blk in enumerate(model.layers):
        pk, pv = pool["k"][i], pool["v"][i]
        kh, dh = pk.shape[1], pk.shape[3]
        ck = pk[idx].transpose(0, 1).reshape(1, kh, t * bs, dh)
        cv = pv[idx].transpose(0, 1).reshape(1, kh, t * bs, dh)
        x, k, v = _chunk_layer(blk, cfg, x, ck, cv, positions, window)
        pk[phys, :, off] = k[0].to(pk.dtype)
        pv[phys, :, off] = v[0].to(pv.dtype)
    return pool


def _chunk_layer(blk: DenseBlock, cfg: ModelConfig, x: torch.Tensor,
                 ck: torch.Tensor, cv: torch.Tensor, positions: torch.Tensor,
                 window: Optional[int]):
    """One layer of a prompt chunk: x (B,S,D) at ``positions`` (S,), a
    device tensor; writes the chunk's K/V into ck/cv (B,KH,C,dh) at those
    positions in place, then attends over the whole of ck/cv, as the JAX
    ``lm_prefill_chunk`` does.  Returns (x after the layer, k, v
    (B,S,KH,dh))."""
    c = ck.shape[2]
    g = cfg.n_heads // cfg.n_kv_heads
    p = blk.attn
    q, k, v = _proj_qkv(p, cfg, rms_norm(x, blk.ln1, cfg.norm_eps),
                        positions)
    ck.index_copy_(2, positions, k.transpose(1, 2).to(ck.dtype))
    cv.index_copy_(2, positions, v.transpose(1, 2).to(cv.dtype))
    kx = ck.repeat_interleave(g, dim=1) if g > 1 else ck     # (B,H,C,dh)
    vx = cv.repeat_interleave(g, dim=1) if g > 1 else cv
    logits = (q.transpose(1, 2).float()
              @ kx.float().transpose(-1, -2)) * (1.0 / math.sqrt(cfg.dh))
    kpos = torch.arange(c, device=x.device)
    mask = kpos[None, :] <= positions[:, None]
    if window is not None:
        mask = mask & (kpos[None, :] > positions[:, None] - window)
    logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(vx.dtype)
    h = x + _out_proj(p, (w @ vx).transpose(1, 2))
    x = h + mlp_block(blk.mlp, cfg, rms_norm(h, blk.ln2, cfg.norm_eps))
    return x, k, v


def lm_decode(model: DenseLM, cfg: ModelConfig, cache: Cache,
              tokens: torch.Tensor, lengths: torch.Tensor, *,
              attn_impl=None) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  tokens (B,1); lengths (B,) absolute positions;
    cache {k,v}: (L,B,KH,C,dh), updated in place.  Returns (logits
    (B,V_pad), cache).  ``attn_impl`` plumbs a vendor attention kernel
    into every layer's decode_attention_block (§4.8)."""
    x = embed_tokens(model, cfg, tokens)
    for i, blk in enumerate(model.layers):
        x = decode_layer(blk, cfg, x, cache["k"][i], cache["v"][i], lengths,
                         attn_impl=attn_impl)
    return lm_logits(model, cfg, x)[:, 0], cache


def decode_layer(blk: DenseBlock, cfg: ModelConfig, x: torch.Tensor,
                 ck: torch.Tensor, cv: torch.Tensor, lengths: torch.Tensor,
                 *, attn_impl=None) -> torch.Tensor:
    """One transformer layer of a decode step: x (B,1,D), its K/V ring
    written in place into ck/cv (B,KH,C,dh).  Returns x after the
    layer."""
    xin = rms_norm(x, blk.ln1, cfg.norm_eps)
    att, _, _ = decode_attention_block(blk.attn, cfg, xin, ck, cv, lengths,
                                       attn_impl=attn_impl)
    h = x + att
    return h + mlp_block(blk.mlp, cfg, rms_norm(h, blk.ln2, cfg.norm_eps))


def lm_decode_paged(model: DenseLM, cfg: ModelConfig, pool: Cache,
                    tables: torch.Tensor, tokens: torch.Tensor,
                    lengths: torch.Tensor, *,
                    attn_impl=None) -> Tuple[torch.Tensor, Cache]:
    """One decode step over the paged KV pool.  tokens (B,1); lengths
    (B,); tables (B,T) int32; pool {k,v}: (L,P,KH,BS,dh), updated in
    place.  Returns (logits (B,V_pad), pool).  The tables and lengths are
    read on the device, so mapping blocks between steps changes values
    only, and the step never waits for the device."""
    x = embed_tokens(model, cfg, tokens)
    for i, blk in enumerate(model.layers):
        xin = rms_norm(x, blk.ln1, cfg.norm_eps)
        att, _, _ = paged_decode_attention_block(
            blk.attn, cfg, xin, pool["k"][i], pool["v"][i], tables, lengths,
            attn_impl=attn_impl)
        h = x + att
        x = h + mlp_block(blk.mlp, cfg, rms_norm(h, blk.ln2, cfg.norm_eps))
    return lm_logits(model, cfg, x)[:, 0], pool
