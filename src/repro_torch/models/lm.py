"""Decoder-only LM, dense and MoE families — the pod-path model.

The port's counterpart of ``repro.models.lm``: Yi-6B, Phi-3-mini,
Phi-4-mini and Qwen3 (``qk_norm``), the MoE models DeepSeek-MoE-16B (a
dense first block, shared experts) and Qwen3-MoE-30B-A3B, and PaliGemma's
Gemma decoder (``models.vlm``).  Parameters keep the JAX package's
layouts (``wq`` (D,H,dh), ``wo`` (H,dh,D), ``wi`` (D,F), the experts'
``wi`` (E,D,F), …) so ``registry.params_from_jax`` copies them leaf for
leaf; they live in one ``DenseLM`` module holding one ``DenseBlock`` or
``MoEBlock`` per layer (and DeepSeek's ``first_block``) where the JAX
package stacks a leading ``L`` dim and scans.  The steps are plain functions on
tensors, as in the JAX package:

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

The MoE block (``moe_block``) is the JAX package's single-device
capacity dispatch: top-k routing, a per-expert queue of ``moe_capacity``
slots, every expert's matmuls over its slots (so a step reads every
expert's weights), and the combine back to tokens.  Inside a training
context where the experts divide over ``model`` (``moe_ep.ep_applicable``)
it delegates to ``moe_ep.moe_block_ep``, the expert-parallel dispatch
with an all-to-all each way, as the JAX function does.

The decode steps read ``lengths`` (and the block tables) on the device
and take no branch on a device value, so they never wait for the device.

On a mesh (``distributed.sharding.shard_params``) the same steps run on
one rank's shards: each module's ``tp`` (a ``collectives.Shard``) says
how its weights lie, and the step meets the other ranks where GSPMD
would insert a collective — the masked embedding lookup and the
row-parallel ``wo`` / MLP ``wo`` / MoE combine end in an ``all_reduce``,
the column-parallel head's logits are ``all_gather``ed.  Attention in
``heads`` mode runs on the rank's query heads (and, where ``wk``/``wv``
stay whole, every KV head); with the cache's rows split over the ranks
(``seq_kv``, the policy's ``sequence`` mode), each rank attends over
its rows with their log-sum-exp, the partials merge flash-decoding
style, and only the rank that holds a new row writes it.

Training: ``lm_loss`` runs ``lm_backbone`` (``_layer_fwd`` per layer,
each one rematerialized under ``remat=True`` through
``torch.utils.checkpoint``, as the JAX package checkpoints its scan
body) into the float32 cross-entropy; ``chunked_attention``
rematerializes each query chunk whenever it is differentiated, as the
JAX function checkpoints its chunk body, so backward never holds the
(B,H,S,S) softmax weights.  No kernel wrapper is on this path: a
kernel launch has no backward.

Sharded training (inside ``distributed.act_sharding.activation_sharding``,
on ``shard_params(..., fsdp=True)``'s slices) runs the same functions,
every collective differentiable (``distributed.collectives``): each
layer's FSDP-sharded weights are gathered over the data axes as the
layer starts (``act_sharding.gathered``, inside the rematerialized
region, so a recomputed layer gathers again), tensor-parallel regions
are entered through the copy-in and left through the all_reduce, or,
under sequence parallelism, through an all-gather and a reduce-scatter
of the positions (``act_sharding.enter``/``leave``); the embedding and
the head are vocab-parallel; a replicated weight that feeds a rank's
own heads (``wk``/``wv`` kept whole, the q/k norms) takes the copy-in.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.executor import resolve_device
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import collectives as C

from .common import (ModelConfig, apply_rope, cross_entropy_loss, dense_init,
                     rms_norm, rope_cos_sin)

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
    """wi (D,F), wg (D,F) for gated activations, wo (F,D); F is
    ``d_ff`` (the config's by default), and ``lead`` dims go in front
    (the experts' (E,D,F))."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 d_ff: Optional[int] = None, lead: Tuple[int, ...] = ()):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.wi = _param((*lead, d, f), dtype, device)
        if cfg.act in GATED_ACTS:
            self.wg = _param((*lead, d, f), dtype, device)
        self.wo = _param((*lead, f, d), dtype, device)


class DenseBlock(nn.Module):
    """One pre-norm transformer layer: ln1 → attention, ln2 → MLP (of
    width ``d_ff``, the config's by default)."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 d_ff: Optional[int] = None):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device, d_ff)


class MoE(nn.Module):
    """The MoE feed-forward: ``router`` (D,E) float32, ``experts`` an
    MLP of (E,D,F)/(E,F,D) at F = moe_d_ff, and, with shared experts,
    ``shared`` one MLP of width n_shared_experts · moe_d_ff."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        e, f = cfg.n_experts, cfg.moe_d_ff
        self.router = _param((cfg.d_model, e), torch.float32, device)
        self.experts = MLP(cfg, dtype, device, f, lead=(e,))
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, dtype, device, cfg.n_shared_experts * f)


class MoEBlock(nn.Module):
    """One pre-norm MoE layer: ln1 → attention, ln2 → MoE."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.moe = MoE(cfg, dtype, device)


class DenseLM(nn.Module):
    """The LM's parameters: embedding (V_pad, D), one layer per
    ``layers`` entry (DenseBlock, or MoEBlock for a config with experts),
    final norm and (untied) head (D, V_pad); with
    ``first_layer_dense_ff`` (DeepSeek) a ``first_block`` DenseBlock of
    that MLP width runs before ``layers`` (which then hold n_layers - 1
    MoE layers); for the vlm family the vision ``projector`` (d_vision,
    D).  Built empty on ``device`` (the card by default; raises without
    one — pass ``"cpu"`` for the CPU); ``init_lm`` or
    ``registry.params_from_jax`` fills it."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        dtype, vp, d = cfg.torch_dtype(), padded_vocab(cfg), cfg.d_model
        self.cfg = cfg
        self.embed = _param((vp, d), dtype, device)
        self.final_norm = _param((d,), dtype, device)
        n_moe = cfg.n_layers - (1 if cfg.first_layer_dense_ff else 0)
        if cfg.n_experts:
            self.layers = nn.ModuleList(MoEBlock(cfg, dtype, device)
                                        for _ in range(n_moe))
        else:
            self.layers = nn.ModuleList(DenseBlock(cfg, dtype, device)
                                        for _ in range(cfg.n_layers))
        if cfg.first_layer_dense_ff:
            self.first_block = DenseBlock(cfg, dtype, device,
                                          cfg.first_layer_dense_ff)
        if not cfg.tie_embeddings:
            self.lm_head = _param((d, vp), dtype, device)
        if cfg.family == "vlm":
            self.projector = _param((cfg.d_vision, d), dtype, device)


def blocks(model):
    """The model's layers in cache order: DeepSeek's ``first_block``
    (cache layer 0), then ``layers``.  A generator, so a dequantizing
    view (``lm_quant.dequant_params``) holds one layer's float weights at
    a time."""
    first = getattr(model, "first_block", None)
    if first is not None:
        yield first
    yield from model.layers


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> DenseLM:
    """Seeded random weights on ``gen.device``, following the JAX
    ``init_lm``'s rules leaf by leaf: ``dense_init``'s 1/sqrt(fan-in),
    and the explicit scales of ``wo``, the router and the embeddings.
    The JAX package applies the rule to leaves stacked as (L, …) with
    fan-in = shape[0], so its fan-in there is L and its attention nearly
    one-hot (ROADMAP queue 3); the port draws each layer's leaf on its
    own, with the leaf's input width as its fan-in (D for the experts'
    (E,D,F))."""
    dtype = cfg.torch_dtype()
    model = DenseLM(cfg, gen.device)
    with torch.no_grad():
        model.embed.copy_(dense_init(gen, model.embed.shape, 0.02, dtype))
        model.final_norm.fill_(1)
        for blk in blocks(model):
            init_dense_block(gen, blk, cfg)
        if not cfg.tie_embeddings:
            model.lm_head.copy_(dense_init(gen, model.lm_head.shape, 0.02,
                                           dtype))
        if cfg.family == "vlm":
            model.projector.copy_(dense_init(
                gen, model.projector.shape, 1.0 / math.sqrt(cfg.d_vision),
                dtype))
    return model


def _init_mlp(gen: torch.Generator, m: MLP, cfg: ModelConfig) -> None:
    dtype = m.wi.dtype
    d, f = m.wi.shape[-2:]
    m.wi.copy_(dense_init(gen, m.wi.shape, 1.0 / math.sqrt(d), dtype))
    m.wo.copy_(dense_init(gen, m.wo.shape, 1.0 / math.sqrt(f), dtype))
    if cfg.act in GATED_ACTS:
        m.wg.copy_(dense_init(gen, m.wg.shape, 1.0 / math.sqrt(d), dtype))


def init_dense_block(gen: torch.Generator, blk: nn.Module,
                     cfg: ModelConfig) -> None:
    """One layer's seeded weights (a DenseBlock or a MoEBlock) by
    ``init_lm``'s rules (the hybrid family's shared block is drawn by
    them too)."""
    dtype = blk.ln1.dtype
    h, dh = cfg.n_heads, cfg.dh
    blk.ln1.fill_(1)
    blk.ln2.fill_(1)
    a = blk.attn
    for w in (a.wq, a.wk, a.wv):
        w.copy_(dense_init(gen, w.shape, dtype=dtype))
    a.wo.copy_(dense_init(gen, a.wo.shape, 1.0 / math.sqrt(h * dh), dtype))
    if cfg.qk_norm:
        a.q_norm.fill_(1)
        a.k_norm.fill_(1)
    if isinstance(blk, MoEBlock):
        blk.moe.router.copy_(dense_init(gen, blk.moe.router.shape, 0.02))
        _init_mlp(gen, blk.moe.experts, cfg)
        if cfg.n_shared_experts:
            _init_mlp(gen, blk.moe.shared, cfg)
    else:
        _init_mlp(gen, blk.mlp, cfg)


def _from_numpy(a: Any, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: widen exactly
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(dtype)      # a writable copy


# the port's per-layer ModuleList -> the JAX tree's stacked subtree
_STACKS = {"layers": "blocks"}


def jax_key(name: str) -> Tuple[str, Optional[int]]:
    """(flat key, index): where the port's parameter ``name`` sits in a
    JAX parameter tree whose per-layer leaves are stacked on a leading L
    dim — ``layers.3.attn.wq`` is ``blocks/attn/wq`` at index 3,
    ``decoder.1.xattn.wq`` is ``decoder/xattn/wq`` at 1,
    ``first_block.mlp.wi`` is ``first_block/mlp/wi`` at 0 (a stack of
    one), ``embed`` is ``embed`` (index None).  The flat key is the JAX
    checkpoint's key path of the leaf."""
    parts = name.split(".")
    index = None
    if len(parts) > 1 and parts[1].isdigit():
        index = int(parts[1])
        parts = [_STACKS.get(parts[0], parts[0])] + parts[2:]
    elif parts[0] == "first_block":
        index = 0
    return "/".join(parts), index


def jax_leaf(tree: Dict[str, Any], name: str):
    """(node, index): the port's parameter ``name`` in a nested JAX
    parameter tree (``jax_key``).  The node may be a quantized leaf's
    dict (``lm_quant``)."""
    key, index = jax_key(name)
    node = tree
    for part in key.split("/"):
        node = node[part]
    return node, index


def jax_layout(named: Iterable[Tuple[str, torch.Tensor]]
               ) -> Dict[str, Tuple[List[torch.Tensor], bool]]:
    """The inverse of ``jax_key`` over named tensors (a model's
    parameters, or anything keyed by their names): each JAX flat key
    with its tensors in layer order and whether the JAX leaf stacks them
    on a leading L dim."""
    out: Dict[str, Tuple[Dict[int, torch.Tensor], bool]] = {}
    for name, t in named:
        key, index = jax_key(name)
        parts, stacked = out.setdefault(key, ({}, index is not None))
        parts[0 if index is None else index] = t
    return {key: ([parts[i] for i in sorted(parts)], stacked)
            for key, (parts, stacked) in out.items()}


def load_jax_tree(model: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Copy a JAX parameter tree (leaves as numpy arrays, per-layer
    leaves stacked on a leading L dim) into ``model``'s parameters, leaf
    for leaf (``jax_leaf``), each in its parameter's dtype; shapes must
    match.  Returns the model."""
    with torch.no_grad():
        for name, param in model.named_parameters():
            node, i = jax_leaf(tree, name)
            value = _from_numpy(node if i is None else np.asarray(node)[i],
                                param.dtype)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                                 f"{tuple(param.shape)}")
            param.copy_(value)
    return model


# ---------------------------------------------------------------------------
# attention — query-chunked causal/windowed (prefill)
# ---------------------------------------------------------------------------

def _proj_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,H,dh), k/v (B,S,KH,dh) with qk_norm + RoPE.
    With the query heads split over ``model``, the whole ``wk``/``wv``
    (KV heads not split) and the q/k norms feed this rank's heads: they
    take the copy-in (a no-op without a gradient)."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    wk, wv = p.wk, p.wv
    norms = (p.q_norm, p.k_norm) if cfg.qk_norm else ()
    tp = getattr(p, "tp", None)
    if tp is not None and tp.split:
        if not tp.kv_split:
            wk, wv = C.copy_in(tp.comm, wk, wv)
        if norms:
            norms = C.copy_in(tp.comm, *norms)
    q = (flat @ p.wq.reshape(d, -1)).view(b, s, *p.wq.shape[1:])
    k = (flat @ wk.reshape(d, -1)).view(b, s, *wk.shape[1:])
    v = (flat @ wv.reshape(d, -1)).view(b, s, *wv.shape[1:])
    if cfg.qk_norm:
        q = rms_norm(q, norms[0], cfg.norm_eps)
        k = rms_norm(k, norms[1], cfg.norm_eps)
    if cfg.rope_base:
        cos, sin = rope_cos_sin(positions, cfg.dh, cfg.rope_base)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def checkpointed(fn, *args):
    """``fn(*args)`` with its activations recomputed in backward
    (``jax.checkpoint``): non-reentrant, so gradients reach the tensors
    ``fn`` closes over, and without saving RNG state (nothing on the
    training path draws random numbers, and a CUDA-graph capture may not
    read the generator).  The recompute runs in the activation-sharding
    context of the forward (``act_sharding.using``): on the card
    backward runs on autograd's own thread, which has none."""
    ctx = acts.current()
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          acts.using(ctx)))


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg: ModelConfig, *, prefix_len: int = 0,
                      window: Optional[int] = None,
                      chunk: int = 512) -> torch.Tensor:
    """Causal (+prefix, +sliding-window) attention, O(S·chunk) logits.

    q (B,S,H,dh); k,v (B,S,KH,dh).  Returns (B,S,H,dh).  The first
    ``prefix_len`` positions (a VLM's vision prefix) are visible to every
    query.  Logits are float32, masked to -1e30, and the softmax weights
    are cast to v's dtype before P·V, as the JAX package does.  S must be
    a multiple of the chunk (min(chunk, S)), as there.  When q is
    differentiated each chunk is rematerialized (``checkpointed``), as
    the JAX function checkpoints its chunk body: backward keeps no
    chunk's float32 logits.

    Inside a sharded step that splits K/V by sequence
    (``act_sharding.shard_kv``: the heads do not divide over ``model``)
    a rank attends every query over its block of S/m key positions, at
    their absolute positions, and the ranks' partials merge by their
    log-sum-exp (``collectives.combine``); a block fully masked for a
    query weighs 0 there.  The K/V blocks are taken before the GQA
    repeat (the same result; the gradients gathered in backward are
    KH, not H, heads wide)."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the "
                         f"attention chunk {chunk}")
    scale = 1.0 / math.sqrt(dh)
    comm = acts.kv_split()
    q = acts.kv_query(q)
    k, v = acts.shard_kv(k), acts.shard_kv(v)
    kx = (k.repeat_interleave(g, dim=2) if g > 1 else k).transpose(1, 2)
    vx = (v.repeat_interleave(g, dim=2) if g > 1 else v).transpose(1, 2)
    kxf = kx.float()
    n = kx.shape[2]
    first = comm.rank * n if comm is not None else 0
    kpos = first + torch.arange(n, device=q.device)

    def attend(qc, start):                                 # (B,H,c,dh)
        logits = (qc.float() @ kxf.transpose(-1, -2)) * scale
        qpos = start + torch.arange(chunk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if prefix_len:
            mask = mask | (kpos[None, :] < prefix_len)
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        logits = logits.masked_fill(~mask, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (w @ vx).transpose(1, 2)                     # (B,c,H,dh)
        if comm is None:
            return out
        return out, torch.logsumexp(logits, dim=-1).transpose(1, 2)

    grad = torch.is_grad_enabled() and q.requires_grad
    outs = []
    for start in range(0, s, chunk):
        qc = q[:, start:start + chunk].transpose(1, 2)
        outs.append(checkpointed(attend, qc, start) if grad
                    else attend(qc, start))
    if comm is None:
        return torch.cat(outs, dim=1)
    return C.combine(comm, torch.cat([o for o, _ in outs], dim=1),
                     torch.cat([lse for _, lse in outs], dim=1))


def _out_proj(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """(B,S,H,dh) · wo (H,dh,D) -> (B,S,D); summed over the ranks where
    the heads are split (row-parallel ``wo``; ``act_sharding.leave``)."""
    b, s = out.shape[:2]
    y = (out.reshape(b * s, -1) @ p.wo.reshape(-1, p.wo.shape[-1])
         ).view(b, s, -1)
    return acts.leave(y, getattr(p, "tp", None))


def _rank_kv(p: Attention, cfg: ModelConfig, k: torch.Tensor,
             v: torch.Tensor):
    """k/v (B,S,KH,dh) of every KV head -> those of this rank's query
    heads, one per head (B,S,H/m,dh), where the query heads are split
    and the KV heads are not; else k/v as they are."""
    tp = getattr(p, "tp", None)
    if tp is None or not tp.split or tp.kv_split:
        return k, v
    h = p.wq.shape[1]
    idx = (tp.comm.rank * h + torch.arange(h, device=k.device)) \
        // (cfg.n_heads // cfg.n_kv_heads)
    return k.index_select(2, idx), v.index_select(2, idx)


def _sharded_attend(p: Attention, attend, q: torch.Tensor,
                    seq: bool) -> torch.Tensor:
    """Attention of this rank's query heads q (B,H,...,dh) through
    ``attend(q, return_lse)`` over this rank's cache.  Where the heads
    are split but the cache holds every KV head, the queries of every
    head are gathered first and the rank keeps its own outputs; where
    the cache's rows are split (``seq``), ``attend`` gives partials with
    their log-sum-exp and the ranks merge them (``Comm.combine``)."""
    tp = getattr(p, "tp", None)
    if tp is None or (not seq and (tp.kv_split or not tp.split)):
        return attend(q, False)
    comm = tp.comm
    gather = tp.split and not tp.kv_split
    qa = comm.all_gather(q, dim=1) if gather else q
    out = comm.combine(*attend(qa, True)) if seq else attend(qa, False)
    return comm.own(out, 1) if gather else out


# ---------------------------------------------------------------------------
# decode attention (one token, ring KV cache)
# ---------------------------------------------------------------------------

def decode_attention_block(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                           cache_k: torch.Tensor, cache_v: torch.Tensor,
                           lengths: torch.Tensor, attn_impl=None,
                           seq_kv: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """x (B,1,D); cache_k/v (B,KH,C,dh); lengths (B,) = tokens already in
    context (the new token's absolute position).  Ring-buffer update, in
    place.  Returns (out (B,1,D), cache_k, cache_v).

    ``attn_impl`` replaces only the attention math — called as
    ``attn_impl(q (B,H,dh), kc, vc, n_valid) -> (B,H,dh)`` over the
    already-updated cache (with ``return_lse=True`` where a partial's
    log-sum-exp is needed); the ring update and output projection stay
    those of the reference path.

    ``seq_kv``: the caches hold this rank's rows [r·C, (r+1)·C) of a
    ring of m·C positions; the rank that holds the new row writes it
    (the others write a row's own value back), attends over its rows up
    to its clamped length, and the ranks merge their partials."""
    b = x.shape[0]
    dh = cfg.dh
    c = cache_k.shape[2]
    q, k, v = _proj_qkv(p, cfg, x, lengths[:, None])
    rows = torch.arange(b, device=x.device)
    if seq_kv:
        comm = p.tp.comm
        ring, lo = c * comm.size, comm.rank * c
        slot = lengths % ring
        own = ((slot >= lo) & (slot < lo + c))[:, None, None]
        at = (slot - lo).clamp(0, c - 1)
        cache_k[rows, :, at] = torch.where(own, k[:, 0].to(cache_k.dtype),
                                           cache_k[rows, :, at])
        cache_v[rows, :, at] = torch.where(own, v[:, 0].to(cache_v.dtype),
                                           cache_v[rows, :, at])
        n_valid = (torch.clamp(lengths + 1, max=ring) - lo).clamp(0, c)
    else:
        slot = lengths % c
        # the JAX package blends with a one-hot (cache*(1-oh) + k*oh); the
        # index write stores exactly the same values
        cache_k[rows, :, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, :, slot] = v[:, 0].to(cache_v.dtype)
        n_valid = torch.clamp(lengths + 1, max=c)

    def attend(qh, lse):
        if attn_impl is not None:
            return (attn_impl(qh, cache_k, cache_v, n_valid, return_lse=True)
                    if lse else attn_impl(qh, cache_k, cache_v, n_valid))
        return _decode_attend(qh, cache_k, cache_v, n_valid, lse)

    out = _sharded_attend(p, attend, q[:, 0], seq_kv)
    y = _out_proj(p, out.reshape(b, 1, -1, dh))
    return y, cache_k, cache_v


def _decode_attend(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                   n_valid: torch.Tensor, return_lse: bool = False):
    """The reference decode attention: q (B,H,dh) over caches (B,KH,C,dh),
    the first ``n_valid`` positions of each row valid.  Float32 logits
    masked to -1e30, softmax weights cast to q's dtype before P·V, as
    the JAX package does.  Returns (B,H,dh); with ``return_lse`` also the
    float32 log-sum-exp (B,H) of the valid scaled scores, and a row with
    no valid position gives 0 and -inf (a partial over a rank's rows)."""
    b, h, dh = q.shape
    kh, c = kc.shape[1], kc.shape[2]
    qg = q.reshape(b, kh, h // kh, dh)
    scale = 1.0 / math.sqrt(dh)
    logits = (qg.float() @ kc.float().transpose(-1, -2)) * scale
    valid = (torch.arange(c, device=q.device)[None, None, None, :]
             < n_valid[:, None, None, None])
    logits = logits.masked_fill(~valid, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = (w @ vc).reshape(b, h, dh)
    if not return_lse:
        return out
    empty = (n_valid == 0)[:, None]
    lse = torch.logsumexp(logits, dim=-1).reshape(b, h)
    return (out.masked_fill(empty[..., None], 0),
            lse.masked_fill(empty, -math.inf))


# ---------------------------------------------------------------------------
# decode attention — paged KV (block pool + per-slot block table)
# ---------------------------------------------------------------------------

def paged_decode_attention_block(p: Attention, cfg: ModelConfig,
                                 x: torch.Tensor, pool_k: torch.Tensor,
                                 pool_v: torch.Tensor, tables: torch.Tensor,
                                 lengths: torch.Tensor, attn_impl=None,
                                 seq_kv: bool = False
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
    ``attn_impl(q (B,H,dh), pool_k, pool_v, tables, n_valid)``.

    ``seq_kv``: the pools hold this rank's rows [r·BS, (r+1)·BS) of
    every block of m·BS rows; a row another rank holds is written to the
    garbage block instead, and the rank attends over its rows of the
    slot's blocks, counting those below the length (in table order they
    are the first ones)."""
    b = x.shape[0]
    dh = cfg.dh
    bs, t = pool_k.shape[2], tables.shape[1]
    q, k, v = _proj_qkv(p, cfg, x, lengths[:, None])
    if seq_kv:
        comm = p.tp.comm
        full = bs * comm.size
        c = t * full
        pos = (lengths % c).long()
        off = pos % full - comm.rank * bs
        own = (off >= 0) & (off < bs)
        phys = torch.where(own, tables.gather(1, (pos // full)[:, None])[:, 0]
                           .long(), 0)
        off = torch.where(own, off, 0)
        n = torch.clamp(lengths + 1, max=c)
        n_valid = (n // full) * bs + (n % full - comm.rank * bs).clamp(0, bs)
    else:
        c = t * bs
        pos = (lengths % c).long()
        phys = tables.gather(1, (pos // bs)[:, None])[:, 0].long()
        off = pos % bs
        n_valid = torch.clamp(lengths + 1, max=c)
    pool_k[phys, :, off] = k[:, 0].to(pool_k.dtype)
    pool_v[phys, :, off] = v[:, 0].to(pool_v.dtype)

    def attend(qh, lse):
        if attn_impl is not None:
            return (attn_impl(qh, pool_k, pool_v, tables, n_valid,
                              return_lse=True) if lse
                    else attn_impl(qh, pool_k, pool_v, tables, n_valid))
        idx = tables.long()
        kh = pool_k.shape[1]
        kc = pool_k[idx].transpose(1, 2).reshape(b, kh, t * bs, dh)
        vc = pool_v[idx].transpose(1, 2).reshape(b, kh, t * bs, dh)
        return _decode_attend(qh, kc, vc, n_valid, lse)

    out = _sharded_attend(p, attend, q[:, 0], seq_kv)
    y = _out_proj(p, out.reshape(b, 1, -1, dh))
    return y, pool_k, pool_v


# ---------------------------------------------------------------------------
# FFN — dense (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def _gate(act: str, g: torch.Tensor) -> torch.Tensor:
    return F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")


def mlp_block(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (..., D) through wi/wg/wo; the experts' (E,D,F) weights take x
    (G,E,C,D), one matmul per expert, as the JAX package's ``gecd,edf``.
    Where the hidden width is split over the ranks (column-parallel
    wi/wg, row-parallel wo) the output is summed over them
    (``act_sharding.enter``/``leave``)."""
    tp = getattr(p, "tp", None)
    x = acts.enter(x, tp)
    hidden = x @ p.wi
    if cfg.act in GATED_ACTS:
        hidden = _gate(cfg.act, x @ p.wg) * hidden
    else:
        # jax.nn.gelu defaults to the tanh approximation
        hidden = F.gelu(hidden, approximate="tanh")
    return acts.leave(hidden @ p.wo, tp)


# ---------------------------------------------------------------------------
# FFN — MoE (per-group capacity dispatch, Switch-style)
# ---------------------------------------------------------------------------

def moe_groups(n_tokens: int, data_shards: int = 16) -> int:
    """Group count for capacity dispatch: one group per data shard when
    groups stay usefully large, else a single global group.  The default
    is the JAX package's mesh layout; the trainer passes 1, the host
    mesh's."""
    if n_tokens >= 16 * 1024:
        return data_shards
    return 1


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(4, -(-c // 4) * 4)          # >=4, multiple of 4


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values.  A stable descending sort, sliced: ``torch.topk``
    promises no order among ties on the card."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router_logits: torch.Tensor, cfg: ModelConfig, capacity: int,
           n_valid=None, eff_capacity=None, *, span=None, stats=()):
    """``moe_dispatch``'s work, plus each (token, k) pair's slot (G,T·K):
    its expert·C + queue position, or E·C (the overflow bin) where it is
    dropped.  On a mesh a group's tokens may lie on several ranks, the
    same count on each: ``stats`` are the ``Comm``s over whose ranks the
    aux loss's density and mean probability are summed (so the aux loss
    is the whole group's), and ``span`` the ``Comm`` over whose ranks,
    in rank order, the group's token order continues (so the queue
    positions continue: this rank's tokens queue after the earlier
    ranks')."""
    g, t, e = router_logits.shape
    k = cfg.top_k
    experts = torch.arange(e, device=router_logits.device)
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_w, top_ids = top_k(probs, k)                          # (G,T,K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # load-balance auxiliary loss (Switch):  E * sum_e f_e * p_e
    top1 = (top_ids[..., :1] == experts).float()                  # (G,T,E)
    stats = [c for c in stats if c is not None and c.size > 1]
    if stats:
        n, density, pmean = t, top1.sum(dim=1), probs.sum(dim=1)
        for c in stats:
            density = C.all_reduce(c, density)
            pmean = C.all_reduce(c, pmean)
            n *= c.size
        density, pmean = density / n, pmean / n
    else:
        density, pmean = top1.mean(dim=1), probs.mean(dim=1)      # (G,E)
    aux = (density * pmean).sum(-1).mean() * e
    flat_ids = top_ids.reshape(g, t * k)
    flat_w = top_w.reshape(g, t * k)
    # position of each (token, k) within its expert's queue
    onehot = (flat_ids[..., None] == experts).int()               # (G,TK,E)
    pos = (onehot.cumsum(dim=1) - 1).gather(-1, flat_ids[..., None])[..., 0]
    if span is not None and span.size > 1:
        every = span.all_gather(onehot.sum(dim=1)[None], 0)       # (R,G,E)
        before = every[:span.rank].sum(dim=0)
        pos = pos + before.gather(-1, flat_ids)
    token_of = torch.arange(t * k, device=router_logits.device) // k
    if n_valid is not None:
        cap_eff = capacity if eff_capacity is None else eff_capacity
        keep = (pos < cap_eff) & (token_of[None, :] < n_valid)
    else:
        keep = pos < capacity
    slot = torch.where(keep, flat_ids * capacity + pos, e * capacity)
    # token ids into slots (default T = the dummy token), the overflow
    # bin last and sliced off, as in the JAX package
    dispatch = torch.full((g, e * capacity + 1), t, dtype=torch.int64,
                          device=router_logits.device)
    dispatch.scatter_(1, slot, token_of.expand(g, -1))
    combine = torch.zeros((g, e * capacity + 1), dtype=torch.float32,
                          device=router_logits.device)
    combine.scatter_(1, slot, flat_w)
    return dispatch[:, :-1], combine[:, :-1], aux, slot


def moe_dispatch(router_logits: torch.Tensor, cfg: ModelConfig,
                 capacity: int, n_valid=None, eff_capacity=None):
    """router_logits (G,T,E) -> (dispatch (G,E·C) int64 token ids [T =
    none], combine (G,E·C) float32 weights, aux_loss scalar), the JAX
    ``moe_dispatch``'s values (its ids are int32).

    Capacity-stable masked mode (bucketed MoE prefill): with ``n_valid``
    / ``eff_capacity`` (int32 scalar tensors), T is a right-padded token
    count and ``capacity`` the bucket's: tokens at positions >=
    ``n_valid`` are dropped and real ones keep only queue positions <
    ``eff_capacity``, so the kept set and every kept token's position are
    those of the unpadded dispatch at the true length.  One program per
    bucket, the routing of the true length."""
    dispatch, combine, aux, _ = _route(router_logits, cfg, capacity,
                                       n_valid, eff_capacity)
    return dispatch, combine, aux


def moe_layout(n_tokens: int, data, data_shards: int):
    """(groups on this rank, the ``Comm`` one group's tokens span or
    None, groups in the batch) for ``n_tokens`` tokens on this rank and
    ``data`` the data axes' ``Comm`` (None: one data rank).  The batch
    is grouped as on one device (``moe_groups`` of the whole batch's
    tokens): one group spanning the data ranks, or groups that are each
    a data rank's own (the JAX package's rows over (pod, data))."""
    if data is None:
        g = moe_groups(n_tokens, data_shards)
        return g, None, g
    total = moe_groups(n_tokens * data.size, data_shards)
    if total == 1:
        return 1, data, 1
    if total % data.size:
        raise ValueError(f"{total} MoE groups do not divide over the "
                         f"{data.size} data ranks")
    return total // data.size, None, total


def moe_block(p: MoE, cfg: ModelConfig, x: torch.Tensor,
              data_shards: int = 16, n_valid=None,
              eff_capacity=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (y (B,S,D), aux_loss): the single-device capacity
    dispatch of the JAX ``moe_block``.  Each expert's matmuls run over
    its C slots, the empty ones on a zero row; every expert's weights are
    read, whatever the routing.

    The combine is the JAX package's scatter-add of the weighted slot
    rows onto their tokens, made deterministic: each token gathers its K
    slot rows in ascending slot order (the dropped ones from a zero row
    last) and sums them one by one, the order in which a serial
    scatter-add visits them.  No atomics, so a run on the card repeats
    bit for bit.  ``data_shards``: ``moe_groups``'.  ``n_valid`` /
    ``eff_capacity``: the masked mode of ``moe_dispatch`` (single group
    only).

    With the experts split over the ranks every rank routes every token
    (the router is whole), runs its own experts' slots, gathers each
    token's rows among them (the others' from the zero row) in the same
    order, and the ranks' sums are summed by an ``all_reduce``.

    Inside a training context: where ``moe_ep.ep_applicable``, the
    expert-parallel block (as the JAX function delegates); else the
    positions of a sequence-parallel input are gathered, the groups
    follow ``moe_layout`` (a group spanning the data ranks queues each
    rank's tokens after the earlier ranks' and sums its aux statistics
    over them; a rank's own groups average their aux over the data
    ranks), and a rank's experts take their tokens and combine weights
    through the copy-in."""
    ctx = acts.current()
    b, s, d = x.shape
    if n_valid is None and ctx is not None:
        from .moe_ep import ep_applicable, moe_block_ep
        positions = s * (ctx.model.size if ctx.seq_divisible else 1)
        if ep_applicable(cfg, b * ctx.data_size, positions):
            return moe_block_ep(p, cfg, x, data_shards=data_shards)
    seq = ctx is not None and ctx.seq_divisible
    x_in = x
    if seq:
        x = C.all_gather(ctx.model, x, 1)
        s = x.shape[1]
    data = ctx.data if ctx is not None else None
    g, span, n_groups = moe_layout(b * s, data, data_shards)
    if n_valid is not None and n_groups != 1:
        raise ValueError("capacity-stable masked dispatch requires the "
                         "single-group layout (got %d groups)" % n_groups)
    t, e, k = b * s // g, cfg.n_experts, cfg.top_k
    xg = x.reshape(g, t, d)
    cap = moe_capacity(cfg, t * (span.size if span is not None else 1))
    logits = xg.float() @ p.router
    dispatch, combine, aux, slot = _route(logits, cfg, cap, n_valid,
                                          eff_capacity, span=span,
                                          stats=(span,))
    if n_groups > g:
        aux = C.all_reduce(data, aux * g) / n_groups
    tp = getattr(p, "tp", None)
    split = tp is not None and tp.split
    rows = slot.view(g, t, k).sort(dim=-1).values.view(g, t * k)
    if split:
        # this rank's experts' slots [lo, lo + e·C); a row outside them
        # reads the zero row
        xg, combine = C.copy_in(tp.comm, xg, combine)
        e = p.experts.wi.shape[0]
        lo = tp.comm.rank * e * cap
        dispatch = dispatch[:, lo:lo + e * cap]
        combine = combine[:, lo:lo + e * cap]
        mine = (rows >= lo) & (rows < lo + e * cap)
        rows = torch.where(mine, rows - lo, e * cap)
    # a zero token row for the empty slots
    xpad = torch.cat([xg, xg.new_zeros(g, 1, d)], dim=1)
    xe = xpad.gather(1, dispatch[..., None].expand(-1, -1, d))
    ye = mlp_block(p.experts, cfg, xe.view(g, e, cap, d))
    ye = ye.reshape(g, e * cap, d) * combine[..., None].to(ye.dtype)
    # each token's slot rows, ascending; the overflow bin is a zero row
    yz = torch.cat([ye, ye.new_zeros(g, 1, d)], dim=1)
    parts = yz.gather(1, rows[..., None].expand(-1, -1, d)).view(g, t, k, d)
    y = parts[:, :, 0]
    for j in range(1, k):
        y = y + parts[:, :, j]
    if split:
        y = C.all_reduce(tp.comm, y)
    y = y.reshape(b, s, d)
    if seq:
        y = C.split(ctx.model, y, 1)
    if cfg.n_shared_experts:
        y = y + mlp_block(p.shared, cfg, x_in)
    return y, aux


def ffn(blk: nn.Module, cfg: ModelConfig, x: torch.Tensor, *,
        n_valid=None, moe_cap=None) -> torch.Tensor:
    """A layer's feed-forward on x (B,S,D): its MoE block (the aux loss
    dropped; ``n_valid`` / ``moe_cap`` the masked dispatch) or its MLP."""
    moe = getattr(blk, "moe", None)
    if moe is not None:
        return moe_block(moe, cfg, x, n_valid=n_valid,
                         eff_capacity=moe_cap)[0]
    return mlp_block(blk.mlp, cfg, x)


# ---------------------------------------------------------------------------
# embedding and head
# ---------------------------------------------------------------------------

def embed_tokens(model: DenseLM, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embedding rows; with the vocabulary split over the
    ranks each looks up the ids in its block (zeros for the others') and
    the rows are summed over the ranks."""
    model = acts.gathered(model)
    tp = getattr(model, "tp", None)
    if tp is None or not tp.split:
        return F.embedding(tokens, model.embed)
    n = model.embed.shape[0]
    local = tokens - tp.comm.rank * n
    mine = (local >= 0) & (local < n)
    x = F.embedding(local.clamp(0, n - 1), model.embed)
    return C.all_reduce(tp.comm, x.masked_fill(~mine[..., None], 0))


def scale_embed(x: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    """x times the embedding scale (Gemma's sqrt(d_model)) rounded to
    x's dtype first, as the JAX package's ``x * jnp.asarray(scale,
    x.dtype)``; None leaves x as it is."""
    if scale is None:
        return x
    return x * float(torch.tensor(scale, dtype=x.dtype))


def lm_logits(model: DenseLM, cfg: ModelConfig,
              h: torch.Tensor) -> torch.Tensor:
    """The (padded) vocabulary's logits of h; a column-parallel head's
    blocks are gathered from the ranks in vocabulary order, so the
    argmax's first maximum is the single device's.  In training every
    rank computes the loss from the whole logits: the hidden state takes
    the copy-in into this rank's vocabulary block, and the gather's
    gradient is this rank's block."""
    model = acts.gathered(model)
    h = rms_norm(h, model.final_norm, cfg.norm_eps)
    head = model.embed.t() if cfg.tie_embeddings else model.lm_head
    tp = getattr(model, "tp", None)
    if tp is None or not tp.split:
        return h @ head
    return C.all_gather(tp.comm, C.copy_in(tp.comm, h) @ head, -1)


# ---------------------------------------------------------------------------
# public steps
# ---------------------------------------------------------------------------

def empty_cache(cfg: ModelConfig, batch: int, cache_len: int,
                dtype: torch.dtype, device,
                kv_heads: Optional[int] = None) -> Cache:
    """The zeroed {k, v} cache (L, batch, KH, cache_len, dh); ``kv_heads``
    a rank's KV heads in place of the config's."""
    shape = (cfg.n_layers, batch, kv_heads or cfg.n_kv_heads, cache_len,
             cfg.dh)
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
               window: Optional[int] = None, prefix_len: int = 0,
               prefix_embed: Optional[torch.Tensor] = None,
               embed_scale: Optional[float] = None,
               n_valid=None, moe_cap=None) -> Tuple[torch.Tensor, Cache]:
    """tokens (B,S) -> (last-token logits (B,V_pad), cache dict).

    cache layout: k/v (L, B, KH, C, dh) ring-indexed by absolute pos,
    C = ``cache_len`` or S (on a mesh: every row, this rank's KV heads).  ``prefix_embed`` (B,P,D) goes in front of
    the (``embed_scale``-scaled) token embeddings — a VLM's vision prefix
    — and ``prefix_len`` positions attend bidirectionally.
    ``n_valid`` / ``moe_cap`` (int32 scalar tensors) are the
    capacity-stable bucketed-MoE mode: S is a right-padded bucket,
    ``n_valid`` the true token count and ``moe_cap`` its expert capacity
    (``moe_dispatch``), so one program serves a bucket."""
    x = scale_embed(embed_tokens(model, cfg, tokens), embed_scale)
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(x.dtype), x], dim=1)
    b, s = x.shape[:2]
    kv = (next(blocks(model)).attn.wk.shape[1]
          if getattr(model, "tp", None) is not None else None)
    cache = empty_cache(cfg, b, cache_len or s, x.dtype, x.device,
                        kv_heads=kv)
    for i, blk in enumerate(blocks(model)):
        x = prefill_layer(blk, cfg, x, cache["k"][i], cache["v"][i],
                          window=window, prefix_len=prefix_len,
                          n_valid=n_valid, moe_cap=moe_cap)
    logits = lm_logits(model, cfg, x[:, -1:])[:, 0]
    return logits, cache


def prefill_layer(blk: nn.Module, cfg: ModelConfig, x: torch.Tensor,
                  ck: torch.Tensor, cv: torch.Tensor, *,
                  window: Optional[int] = None, prefix_len: int = 0,
                  n_valid=None, moe_cap=None) -> torch.Tensor:
    """One transformer layer over a whole prompt x (B,S,D) at positions
    0..S-1, its K/V written into ck/cv (B,KH,C,dh) (``_to_cache``).
    Returns x after the layer."""
    h = prefill_attention(blk, cfg, x, ck, cv, window=window,
                          prefix_len=prefix_len)
    return h + ffn(blk, cfg, rms_norm(h, blk.ln2, cfg.norm_eps),
                   n_valid=n_valid, moe_cap=moe_cap)


def prefill_attention(blk: nn.Module, cfg: ModelConfig, x: torch.Tensor,
                      ck: torch.Tensor, cv: torch.Tensor, *,
                      window: Optional[int] = None,
                      prefix_len: int = 0) -> torch.Tensor:
    """``prefill_layer``'s attention half: x plus the attention output
    (the residual stream that goes into the layer's feed-forward)."""
    h, k, v = _self_attention(blk, cfg, x, window=window,
                              prefix_len=prefix_len)
    _to_cache(ck, k)
    _to_cache(cv, v)
    return h


def _self_attention(blk: nn.Module, cfg: ModelConfig, x: torch.Tensor, *,
                    window: Optional[int] = None, prefix_len: int = 0):
    """ln1 → causal (+prefix, +window) attention over x (B,S,D) at
    positions 0..S-1.  Returns (x + the attention output, k, v
    (B,S,KH,dh)).  Under sequence parallelism x holds this rank's
    positions, and the attention every position (``act_sharding``)."""
    xin = rms_norm(x, acts.seq_param(blk.ln1), cfg.norm_eps)
    xin = acts.enter(xin, getattr(blk.attn, "tp", None))
    positions = torch.arange(xin.shape[1], device=x.device)
    q, k, v = _proj_qkv(blk.attn, cfg, xin, positions)
    ka, va = _rank_kv(blk.attn, cfg, k, v)
    out = chunked_attention(q, ka, va, cfg, prefix_len=prefix_len,
                            window=window)
    return x + _out_proj(blk.attn, out), k, v


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
                     window: Optional[int] = None,
                     embed_scale: Optional[float] = None,
                     seq_kv: bool = False) -> Cache:
    """One prompt CHUNK through the backbone: tokens (B,S) take absolute
    positions ``start .. start+S`` of a cache {k,v} (L,B,KH,C,dh) that
    already holds every earlier position.  Each layer writes the chunk's
    K/V at those positions, in place, then attends the chunk's queries
    over the whole cache with the mask ``kpos <= position`` (and the
    window): positions past the chunk weigh exactly 0.  Returns the
    cache; no logits (the engine hands the last prompt token to decode).
    ``start`` is an int32 scalar tensor, as in the JAX package, so one
    program serves every chunk (a host int is checked and converted,
    ``chunk_offset``); ``start + S <= C`` (no ring wrap).
    ``embed_scale``: the vlm family's (the first chunk, through the
    ordinary prefill, carried its vision prefix).  ``seq_kv``: the cache
    holds this rank's rows [r·C, (r+1)·C) of m·C (``chunk_rows``)."""
    x = scale_embed(embed_tokens(model, cfg, tokens), embed_scale)
    s, c = x.shape[1], cache["k"].shape[3]
    comm = model.tp.comm if seq_kv else None
    start = chunk_offset(start, s, c * (comm.size if comm else 1), x.device)
    positions = start + torch.arange(s, device=x.device)
    rows = chunk_rows(comm, c, positions) if seq_kv else None
    for i, blk in enumerate(blocks(model)):
        x, _, _ = _chunk_layer(blk, cfg, x, cache["k"][i], cache["v"][i],
                               positions, window, rows)
    return cache


def chunk_rows(comm, c: int, positions: torch.Tensor):
    """(global position of each of this rank's C cache rows, the local
    row of each chunk position or C where another rank holds it): this
    rank holds rows [r·C, (r+1)·C) of a sequence-sharded contiguous
    cache."""
    lo = comm.rank * c
    kpos = lo + torch.arange(c, device=positions.device)
    mine = (positions >= lo) & (positions < lo + c)
    return kpos, torch.where(mine, positions - lo, c)


def lm_prefill_chunk_paged(model: DenseLM, cfg: ModelConfig, pool: Cache,
                           table_row: torch.Tensor, tokens: torch.Tensor,
                           start, *, window: Optional[int] = None,
                           embed_scale: Optional[float] = None,
                           seq_kv: bool = False) -> Cache:
    """Paged twin of ``lm_prefill_chunk`` for one slot: pool {k,v}
    (L,P,KH,BS,dh), table_row (T,) its block ids in logical order.  The
    JAX package gathers the whole slot (all layers) to a contiguous
    batch=1 cache, runs ``lm_prefill_chunk`` and scatters the whole slot
    back; here each layer gathers its own (1,KH,T·BS,dh) view, runs the
    same layer math on it, and writes only the chunk's rows back into
    the pool, in place.  The values are the JAX function's: the rest of
    the slot is written back unchanged there.  ``start`` and
    ``embed_scale`` as in ``lm_prefill_chunk``.  ``seq_kv``: the pool
    holds this rank's rows [r·BS, (r+1)·BS) of every block of m·BS; the
    view is those rows in table order, and a chunk row another rank
    holds is written to the garbage block."""
    x = scale_embed(embed_tokens(model, cfg, tokens), embed_scale)
    s = x.shape[1]
    bs, t = pool["k"].shape[3], table_row.shape[0]
    m, r = (model.tp.comm.size, model.tp.comm.rank) if seq_kv else (1, 0)
    full = bs * m
    start = chunk_offset(start, s, t * full, x.device)
    positions = start + torch.arange(s, device=x.device)
    idx = table_row.long()
    off = positions % full - r * bs
    mine = (off >= 0) & (off < bs)
    phys = torch.where(mine, idx[positions // full], 0)
    off = torch.where(mine, off, 0)
    rows = None
    if seq_kv:
        j = torch.arange(t * bs, device=x.device)
        rows = ((j // bs) * full + r * bs + j % bs,
                torch.where(mine, (positions // full) * bs + off, t * bs))
    for i, blk in enumerate(blocks(model)):
        pk, pv = pool["k"][i], pool["v"][i]
        kh, dh = pk.shape[1], pk.shape[3]
        ck = pk[idx].transpose(0, 1).reshape(1, kh, t * bs, dh)
        cv = pv[idx].transpose(0, 1).reshape(1, kh, t * bs, dh)
        x, k, v = _chunk_layer(blk, cfg, x, ck, cv, positions, window, rows)
        pk[phys, :, off] = k[0].to(pk.dtype)
        pv[phys, :, off] = v[0].to(pv.dtype)
    return pool


def _chunk_layer(blk: nn.Module, cfg: ModelConfig, x: torch.Tensor,
                 ck: torch.Tensor, cv: torch.Tensor, positions: torch.Tensor,
                 window: Optional[int], rows=None):
    """One layer of a prompt chunk: x (B,S,D) at ``positions`` (S,), a
    device tensor; writes the chunk's K/V into ck/cv (B,KH,C,dh) at those
    positions in place, then attends over the whole of ck/cv, as the JAX
    ``lm_prefill_chunk`` does.  Returns (x after the layer, k, v
    (B,S,KH,dh)).  ``rows`` (a sequence-sharded cache): (the global
    position of each cache row, each chunk position's row or C where
    another rank holds it); the rank attends over its rows and the
    ranks merge their partials."""
    c = ck.shape[2]
    p = blk.attn
    q, k, v = _proj_qkv(p, cfg, rms_norm(x, blk.ln1, cfg.norm_eps),
                        positions)
    if rows is None:
        kpos = torch.arange(c, device=x.device)
        ck.index_copy_(2, positions, k.transpose(1, 2).to(ck.dtype))
        cv.index_copy_(2, positions, v.transpose(1, 2).to(cv.dtype))
    else:
        kpos, at = rows
        _write_rows(ck, at, k)
        _write_rows(cv, at, v)
    mask = kpos[None, :] <= positions[:, None]
    if window is not None:
        mask = mask & (kpos[None, :] > positions[:, None] - window)

    def attend(qh, lse):                                # qh (B,H,S,dh)
        g = qh.shape[1] // ck.shape[1]
        kx = ck.repeat_interleave(g, dim=1) if g > 1 else ck  # (B,H,C,dh)
        vx = cv.repeat_interleave(g, dim=1) if g > 1 else cv
        logits = (qh.float()
                  @ kx.float().transpose(-1, -2)) * (1.0 / math.sqrt(cfg.dh))
        logits = logits.masked_fill(~mask, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(vx.dtype)
        out = w @ vx
        if not lse:
            return out
        empty = ~mask.any(dim=-1)[:, None]              # (S,1)
        return (out.masked_fill(empty, 0),
                torch.logsumexp(logits, dim=-1).masked_fill(
                    empty[:, 0], -math.inf))

    out = _sharded_attend(p, attend, q.transpose(1, 2), rows is not None)
    h = x + _out_proj(p, out.transpose(1, 2))
    x = h + ffn(blk, cfg, rms_norm(h, blk.ln2, cfg.norm_eps))
    return x, k, v


def _write_rows(cache: torch.Tensor, at: torch.Tensor,
                new: torch.Tensor) -> None:
    """new (B,S,KH,dh) into cache (B,KH,C,dh) at rows ``at`` (S,), in
    place; an entry of C (a row another rank holds) is dropped, through
    a scratch row past the end."""
    b, kh, c, dh = cache.shape
    ext = torch.cat([cache, cache.new_zeros(b, kh, 1, dh)], dim=2)
    ext.index_copy_(2, at, new.transpose(1, 2).to(cache.dtype))
    cache.copy_(ext[:, :, :c])


def lm_decode(model: DenseLM, cfg: ModelConfig, cache: Cache,
              tokens: torch.Tensor, lengths: torch.Tensor, *,
              embed_scale: Optional[float] = None,
              attn_impl=None, seq_kv: bool = False
              ) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  tokens (B,1); lengths (B,) absolute positions;
    cache {k,v}: (L,B,KH,C,dh), updated in place.  Returns (logits
    (B,V_pad), cache).  ``attn_impl`` plumbs a vendor attention kernel
    into every layer's decode_attention_block (§4.8); ``seq_kv`` as
    there."""
    x = scale_embed(embed_tokens(model, cfg, tokens), embed_scale)
    for i, blk in enumerate(blocks(model)):
        x = decode_layer(blk, cfg, x, cache["k"][i], cache["v"][i], lengths,
                         attn_impl=attn_impl, seq_kv=seq_kv)
    return lm_logits(model, cfg, x)[:, 0], cache


def decode_layer(blk: nn.Module, cfg: ModelConfig, x: torch.Tensor,
                 ck: torch.Tensor, cv: torch.Tensor, lengths: torch.Tensor,
                 *, attn_impl=None, seq_kv: bool = False) -> torch.Tensor:
    """One transformer layer of a decode step: x (B,1,D), its K/V ring
    written in place into ck/cv (B,KH,C,dh).  Returns x after the
    layer."""
    xin = rms_norm(x, blk.ln1, cfg.norm_eps)
    att, _, _ = decode_attention_block(blk.attn, cfg, xin, ck, cv, lengths,
                                       attn_impl=attn_impl, seq_kv=seq_kv)
    h = x + att
    return h + ffn(blk, cfg, rms_norm(h, blk.ln2, cfg.norm_eps))


def lm_decode_paged(model: DenseLM, cfg: ModelConfig, pool: Cache,
                    tables: torch.Tensor, tokens: torch.Tensor,
                    lengths: torch.Tensor, *,
                    embed_scale: Optional[float] = None,
                    attn_impl=None, seq_kv: bool = False
                    ) -> Tuple[torch.Tensor, Cache]:
    """One decode step over the paged KV pool.  tokens (B,1); lengths
    (B,); tables (B,T) int32; pool {k,v}: (L,P,KH,BS,dh), updated in
    place.  Returns (logits (B,V_pad), pool).  The tables and lengths are
    read on the device, so mapping blocks between steps changes values
    only, and the step never waits for the device.  ``seq_kv`` as in
    ``paged_decode_attention_block``."""
    x = scale_embed(embed_tokens(model, cfg, tokens), embed_scale)
    for i, blk in enumerate(blocks(model)):
        xin = rms_norm(x, blk.ln1, cfg.norm_eps)
        att, _, _ = paged_decode_attention_block(
            blk.attn, cfg, xin, pool["k"][i], pool["v"][i], tables, lengths,
            attn_impl=attn_impl, seq_kv=seq_kv)
        h = x + att
        x = h + ffn(blk, cfg, rms_norm(h, blk.ln2, cfg.norm_eps))
    return lm_logits(model, cfg, x)[:, 0], pool


# ---------------------------------------------------------------------------
# training: the loss
# ---------------------------------------------------------------------------

def _layer_fwd(blk: nn.Module, cfg: ModelConfig, x: torch.Tensor, *,
               prefix_len: int = 0, window: Optional[int] = None,
               data_shards: int = 16):
    """One layer over a whole sequence x (B,S,D), no cache.  Returns (x
    after the layer, its MoE aux loss or None).  In a sharded step the
    layer's weights are gathered here (``act_sharding.gathered``)."""
    blk = acts.gathered(blk)
    h = _self_attention(blk, cfg, x, window=window, prefix_len=prefix_len)[0]
    hin = rms_norm(h, acts.seq_param(blk.ln2), cfg.norm_eps)
    moe = getattr(blk, "moe", None)
    if moe is not None:
        y, aux = moe_block(moe, cfg, hin, data_shards)
        return h + y, aux
    return h + mlp_block(blk.mlp, cfg, hin), None


def lm_backbone(model: DenseLM, cfg: ModelConfig, x: torch.Tensor, *,
                prefix_len: int = 0, window: Optional[int] = None,
                remat: bool = False, data_shards: int = 16):
    """Embedded input x (B,S,D) -> (hidden (B,S,D), aux loss: the MoE
    layers' sum, float32).  ``remat`` rematerializes each of ``layers``
    (the JAX package's scan body; DeepSeek's first block runs before the
    scan, plain).  Under sequence parallelism the layers run on this
    rank's positions (``act_sharding.shard_seq``) and the output is
    gathered for the head."""
    x = acts.shard_seq(x)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in blocks(model):
        fn = functools.partial(_layer_fwd, blk, cfg, prefix_len=prefix_len,
                               window=window, data_shards=data_shards)
        scanned = blk is not getattr(model, "first_block", None)
        x, aux = checkpointed(fn, x) if remat and scanned else fn(x)
        if aux is not None:
            aux_total = aux_total + aux
    return acts.unshard_seq(x), aux_total


def masked_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The families' loss: cross-entropy over the positions whose label
    is >= 0 (label -1 masks a pad or the position after an EOS)."""
    mask = (labels >= 0).float()
    return cross_entropy_loss(logits, torch.clamp(labels, min=0), mask)


def lm_loss(model: DenseLM, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, remat: bool = True, data_shards: int = 16):
    """batch: tokens (B,S) int, labels (B,S) int (-1 = masked).  Returns
    (loss, {"ce_loss", "aux_loss"}); with experts the loss adds 0.01 ×
    the aux loss, as the JAX ``lm_loss`` does."""
    x = embed_tokens(model, cfg, batch["tokens"])
    h, aux = lm_backbone(model, cfg, x, remat=remat,
                         data_shards=data_shards)
    loss = masked_ce(lm_logits(model, cfg, h), batch["labels"])
    metrics = {"ce_loss": loss, "aux_loss": aux}
    if cfg.n_experts:
        loss = loss + 0.01 * aux
    return loss, metrics
