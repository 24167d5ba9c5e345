"""Zamba2 hybrid family [arXiv:2411.15242]: a Mamba-2 backbone with ONE
weight-tied shared attention+MLP block applied after every
``shared_attn_every`` Mamba layers.

The port's counterpart of ``repro.models.hybrid``: Zamba2-1.2B.  The
shared block has a dense transformer layer's parameters (``ln1``,
``ln2``, ``attn``, ``mlp``), so it is an ``lm.DenseBlock`` and runs the
dense layer's steps; its parameters exist once, but each application
point keeps its own KV cache (the activations differ with depth), so the
cache carries ``attn_k``/``attn_v`` (apps, B, KH, C, dh) beside the
Mamba layers' ``conv`` and ``state``, batch on axis 1 everywhere.

Layer schedule for n_layers=38, every=6:
  [6 mamba] attn [6 mamba] attn ... (6 groups of 6) ... [2 mamba tail]

The prefill steps take ``ssd_impl=`` (the scan hook, see
``models.ssm``); decode keeps the reference attention, as the JAX
package's vendor decode does for this family.  ``hybrid_loss`` trains on
the plain scan, with each Mamba layer rematerialized under ``remat``
(the JAX package's inner checkpoint; the shared block is not).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.executor import resolve_device

from . import lm, ssm
from .common import ModelConfig, dense_init

Cache = Dict[str, torch.Tensor]


def n_shared_apps(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every


class HybridLM(nn.Module):
    """Zamba2's parameters: embedding (V_pad, D), one MambaBlock per
    layer, the shared ``lm.DenseBlock``, final norm and (untied) head.
    Built empty on ``device`` (the card by default); ``init_hybrid_lm``
    or ``registry.params_from_jax`` fills it."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        dtype, vp, d = cfg.torch_dtype(), lm.padded_vocab(cfg), cfg.d_model
        self.cfg = cfg
        self.embed = lm._param((vp, d), dtype, device)
        self.final_norm = lm._param((d,), dtype, device)
        self.layers = nn.ModuleList(ssm.MambaBlock(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.shared = lm.DenseBlock(cfg, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = lm._param((d, vp), dtype, device)


def init_hybrid_lm(gen: torch.Generator, cfg: ModelConfig) -> HybridLM:
    """Seeded random weights on ``gen.device``: the Mamba layers by
    ``ssm.init_mamba_block``'s rules, the shared block by ``init_lm``'s,
    each leaf with its own fan-in (the JAX package draws the shared
    block's leaves with a leading dim of 1, so its fan-in there is 1)."""
    dtype = cfg.torch_dtype()
    model = HybridLM(cfg, gen.device)
    dt_bias = ssm._dt_bias(cfg, cfg.n_layers)
    with torch.no_grad():
        model.embed.copy_(dense_init(gen, model.embed.shape, 0.02, dtype))
        model.final_norm.fill_(1)
        for i, blk in enumerate(model.layers):
            ssm.init_mamba_block(gen, blk, cfg, dt_bias[i])
        lm.init_dense_block(gen, model.shared, cfg)
        if not cfg.tie_embeddings:
            model.lm_head.copy_(dense_init(gen, model.lm_head.shape, 0.02,
                                           dtype))
    return model


def hybrid_empty_cache(cfg: ModelConfig, batch: int, cache_len: int,
                       dtype: torch.dtype, device,
                       model: Optional[HybridLM] = None) -> Cache:
    """The zeroed cache; with a sharded ``model``, of its rank's SSD and
    KV heads (every row)."""
    heads = kv = None
    if getattr(model, "tp", None) is not None:
        lo, hi = ssm.state_heads(model, cfg)
        heads, kv = hi - lo, model.shared.attn.wk.shape[1]
    cache = ssm.ssm_empty_cache(cfg, batch, dtype, device, heads)
    shape = (n_shared_apps(cfg), batch, kv or cfg.n_kv_heads, cache_len,
             cfg.dh)
    cache["attn_k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["attn_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def _shared_after(cfg: ModelConfig, i: int) -> Optional[int]:
    """The shared block's application index after Mamba layer ``i``, or
    None where none follows."""
    every = cfg.shared_attn_every
    return (i + 1) // every - 1 if (i + 1) % every == 0 else None


def hybrid_prefill(model: HybridLM, cfg: ModelConfig, tokens: torch.Tensor,
                   cache_len: Optional[int] = None, *,
                   window: Optional[int] = None,
                   ssd_impl=None) -> Tuple[torch.Tensor, Cache]:
    """tokens (B,S) -> (last-token logits (B,V_pad), cache {conv, state,
    attn_k, attn_v}); the shared block's K/V land in a C = ``cache_len``
    (or S) ring at each application point."""
    x = lm.embed_tokens(model, cfg, tokens)
    b, s = x.shape[:2]
    cache = hybrid_empty_cache(cfg, b, cache_len or s, x.dtype, x.device,
                               model)
    for i, blk in enumerate(model.layers):
        x, cache["conv"][i], cache["state"][i] = ssm.mamba_block(
            blk, cfg, x, ssd_impl=ssd_impl)
        app = _shared_after(cfg, i)
        if app is not None:
            x = lm.prefill_layer(model.shared, cfg, x, cache["attn_k"][app],
                                 cache["attn_v"][app], window=window)
    return lm.lm_logits(model, cfg, x[:, -1:])[:, 0], cache


def hybrid_prefill_chunk(model: HybridLM, cfg: ModelConfig, cache: Cache,
                         tokens: torch.Tensor, start, n_real, *,
                         window: Optional[int] = None,
                         ssd_impl=None, seq_kv: bool = False) -> Cache:
    """Advance a batch=1 hybrid cache by one right-padded chunk, in place.
    The Mamba layers carry (conv, state) through ``mamba_chunk_block``
    with the padded tail an exact no-op; the shared block is the dense
    chunk layer (``lm._chunk_layer``): the chunk's K/V land at absolute
    positions ``start .. start+S`` and its queries attend causally over
    the cache.  The padded rows write K/V past the prompt, which the
    length-masked decode never attends to before the ring overwrites
    them.  ``start`` and ``n_real`` are int32 scalar tensors, as in the
    JAX package, so one program serves every chunk (host ints are
    converted; ``start`` is checked, ``lm.chunk_offset``); ``start + S``
    must fit the cache (no ring wrap).  ``seq_kv``: the shared block's
    cache holds this rank's rows (``lm.lm_prefill_chunk``)."""
    x = lm.embed_tokens(model, cfg, tokens)
    s, c = x.shape[1], cache["attn_k"].shape[3]
    comm = model.tp.comm if seq_kv else None
    start = lm.chunk_offset(start, s, c * (comm.size if comm else 1),
                            x.device)
    positions = start + torch.arange(s, device=x.device)
    rows = lm.chunk_rows(comm, c, positions) if seq_kv else None
    for i, blk in enumerate(model.layers):
        x, cache["conv"][i], cache["state"][i] = ssm.mamba_chunk_block(
            blk, cfg, x, cache["conv"][i], cache["state"][i], n_real,
            ssd_impl=ssd_impl)
        app = _shared_after(cfg, i)
        if app is not None:
            x, _, _ = lm._chunk_layer(model.shared, cfg, x,
                                      cache["attn_k"][app],
                                      cache["attn_v"][app], positions,
                                      window, rows)
    return cache


def hybrid_decode(model: HybridLM, cfg: ModelConfig, cache: Cache,
                  tokens: torch.Tensor, lengths: torch.Tensor, *,
                  seq_kv: bool = False) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  tokens (B,1); lengths (B,) absolute positions
    (the shared block's ring slot); the cache is updated in place.
    Returns (logits (B,V_pad), cache).  ``seq_kv`` as in
    ``lm.decode_attention_block``."""
    x = lm.embed_tokens(model, cfg, tokens)
    for i, blk in enumerate(model.layers):
        x, cache["conv"][i], cache["state"][i] = ssm.mamba_decode_block(
            blk, cfg, x, cache["conv"][i], cache["state"][i])
        app = _shared_after(cfg, i)
        if app is not None:
            x = lm.decode_layer(model.shared, cfg, x, cache["attn_k"][app],
                                cache["attn_v"][app], lengths, seq_kv=seq_kv)
    return lm.lm_logits(model, cfg, x)[:, 0], cache


def hybrid_backbone(model: HybridLM, cfg: ModelConfig, x: torch.Tensor, *,
                    remat: bool = False,
                    window: Optional[int] = None) -> torch.Tensor:
    """Embedded input x (B,S,D) through the Mamba layers, the shared
    block after every ``shared_attn_every`` of them."""
    for i, blk in enumerate(model.layers):
        x = ssm.mamba_layer(blk, cfg, x, remat=remat)
        if _shared_after(cfg, i) is not None:
            x = lm._layer_fwd(model.shared, cfg, x, window=window)[0]
    return x


def hybrid_loss(model: HybridLM, cfg: ModelConfig,
                batch: Dict[str, torch.Tensor], *, remat: bool = True,
                data_shards: int = 16):
    """batch: tokens, labels (B,S).  Returns (loss, {"ce_loss"})."""
    x = lm.embed_tokens(model, cfg, batch["tokens"])
    h = hybrid_backbone(model, cfg, x, remat=remat)
    loss = lm.masked_ce(lm.lm_logits(model, cfg, h), batch["labels"])
    return loss, {"ce_loss": loss}
