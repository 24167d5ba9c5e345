"""Whisper-large-v3 backbone [arXiv:2212.04356]: an encoder-decoder
transformer with LayerNorm, GELU MLPs, sinusoidal encoder positions,
learned decoder positions and cross-attention in every decoder layer.

The port's counterpart of ``repro.models.encdec``.  The mel spectrogram
and the conv frontend are a stub, as there: a request carries
precomputed frame embeddings (B, n_audio_ctx, d_model).  No RoPE; the
attention projections have biases on q, v and out (not k).

Prefill encodes the frames once and stages every decoder layer's cross
K/V in the cache beside the self-attention rings, ``{k, v}`` (L, B, KH,
C, dh) and ``{cross_k, cross_v}`` (L, B, KH, T, dh), batch on axis 1 —
so a slot checkpoint carries the cross K/V with the rings.  Decode
writes the rings in place (the values of the JAX package's one-hot
blend) and reads the staged cross K/V.  ``encdec_loss`` is the training
loss over the decoder's token labels.

The frames are cast to the model's dtype, as PaliGemma's patches are:
the JAX package runs them in their own dtype, and float32 frames on a
bfloat16 model stop its decoder scan with a carry-dtype error, so where
the JAX package runs (frames in the model's dtype) the two agree.

Sharded training (``distributed.sharding.shard_params(..., fsdp=True)``
inside ``act_sharding.activation_sharding``; the JAX ``encdec.py`` pins
only ``shard_act`` / ``shard_logits``, so no sequence parallelism) runs
the same functions on a rank's slices, as ``models.lm`` does: each
layer's FSDP views are taken inside its rematerialized region
(``act_sharding.gathered``); the normalized input of an attention or MLP
whose weights are split over ``model`` takes the copy-in
(``act_sharding.enter``) and its row-parallel output the all_reduce
(``act_sharding.leave``), and only then the replicated ``bo``, so it is
added once.  The policy keeps ``bq`` / ``bv`` whole while ``wq`` / ``wv``
split by heads: a rank adds its heads' block (``collectives.split``,
whose backward gathers the whole leaf's gradient on every rank);
``bi`` follows ``wi``'s split.  The encoder output, whole on every rank,
feeds every layer's cross K/V of the rank's heads, so it takes the
copy-in once, before the decoder.  The embedding lookup and the tied
head are vocab-parallel (``lm.embed_tokens``; the head's logits
gathered); ``dec_pos`` and the norms are replicated.  Where the heads do
not divide over ``model`` every attention runs whole on each rank, the
decoder's self-attention with K/V split by sequence
(``lm.chunked_attention``); the encoder's 1,500 frames and the
cross-attention are not split.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.executor import resolve_device
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import collectives as C

from . import lm
from .common import ModelConfig, dense_init, layer_norm

Cache = Dict[str, torch.Tensor]

DEC_MAX_POS = 8192          # learned decoder positions (ring past this)


class BiasedAttention(nn.Module):
    """wq (D,H,dh) + bq (H,dh), wk (D,KH,dh), wv (D,KH,dh) + bv (KH,dh),
    wo (H,dh,D) + bo (D)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
        self.wq = lm._param((d, h, dh), dtype, device)
        self.bq = lm._param((h, dh), dtype, device)
        self.wk = lm._param((d, kh, dh), dtype, device)
        self.wv = lm._param((d, kh, dh), dtype, device)
        self.bv = lm._param((kh, dh), dtype, device)
        self.wo = lm._param((h, dh, d), dtype, device)
        self.bo = lm._param((d,), dtype, device)


class BiasedMLP(nn.Module):
    """wi (D,F) + bi (F), wo (F,D) + bo (D), GELU between."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wi = lm._param((d, f), dtype, device)
        self.bi = lm._param((f,), dtype, device)
        self.wo = lm._param((f, d), dtype, device)
        self.bo = lm._param((d,), dtype, device)


def _norm_pair(module: nn.Module, name: str, d: int, dtype, device) -> None:
    setattr(module, f"{name}_g", lm._param((d,), dtype, device))
    setattr(module, f"{name}_b", lm._param((d,), dtype, device))


class EncoderLayer(nn.Module):
    """ln1 → self-attention (bidirectional), ln2 → MLP."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.attn = BiasedAttention(cfg, dtype, device)
        self.mlp = BiasedMLP(cfg, dtype, device)
        for name in ("ln1", "ln2"):
            _norm_pair(self, name, cfg.d_model, dtype, device)


class DecoderLayer(nn.Module):
    """ln1 → causal self-attention, lnx → cross-attention, ln2 → MLP."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.attn = BiasedAttention(cfg, dtype, device)
        self.xattn = BiasedAttention(cfg, dtype, device)
        self.mlp = BiasedMLP(cfg, dtype, device)
        for name in ("ln1", "lnx", "ln2"):
            _norm_pair(self, name, cfg.d_model, dtype, device)


class EncDecLM(nn.Module):
    """Whisper's parameters: token embedding (V_pad, D) (tied to the
    head), learned decoder positions (DEC_MAX_POS, D), the encoder and
    decoder layers and their final norms.  Built empty on ``device``
    (the card by default); ``init_encdec`` or ``registry.params_from_jax``
    fills it."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        dtype, d = cfg.torch_dtype(), cfg.d_model
        self.cfg = cfg
        self.embed = lm._param((lm.padded_vocab(cfg), d), dtype, device)
        self.dec_pos = lm._param((DEC_MAX_POS, d), dtype, device)
        self.encoder = nn.ModuleList(EncoderLayer(cfg, dtype, device)
                                     for _ in range(cfg.n_encoder_layers))
        self.decoder = nn.ModuleList(DecoderLayer(cfg, dtype, device)
                                     for _ in range(cfg.n_layers))
        _norm_pair(self, "enc_final", d, dtype, device)
        _norm_pair(self, "final", d, dtype, device)


def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> EncDecLM:
    """Seeded random weights on ``gen.device`` by the JAX
    ``init_encdec``'s rules, each layer's leaf drawn on its own with its
    input width as fan-in (as ``lm.init_lm``); biases 0, norm gains 1."""
    model = EncDecLM(cfg, gen.device)
    dtype = cfg.torch_dtype()
    h, dh = cfg.n_heads, cfg.dh
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("_g"):
                p.fill_(1)
            elif leaf.startswith("b") or leaf.endswith("_b"):
                p.zero_()
            elif leaf == "embed":
                p.copy_(dense_init(gen, p.shape, 0.02, dtype))
            elif leaf == "dec_pos":
                p.copy_(dense_init(gen, p.shape, 0.01, dtype))
            elif leaf == "wo" and ".mlp." in name:
                p.copy_(dense_init(gen, p.shape, 1.0 / math.sqrt(cfg.d_ff),
                                   dtype))
            elif leaf == "wo":
                p.copy_(dense_init(gen, p.shape, 1.0 / math.sqrt(h * dh),
                                   dtype))
            else:
                p.copy_(dense_init(gen, p.shape, dtype=dtype))
    return model


def encdec_empty_cache(cfg: ModelConfig, batch: int, cache_len: int,
                       dtype: torch.dtype, device) -> Cache:
    ring = (cfg.n_layers, batch, cfg.n_kv_heads, cache_len, cfg.dh)
    cross = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.n_audio_ctx, cfg.dh)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in (("k", ring), ("v", ring),
                                ("cross_k", cross), ("cross_v", cross))}


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def sinusoids(length: int, channels: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    lt = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-lt * torch.arange(channels // 2, dtype=torch.float32,
                                       device=device))
    ang = torch.arange(length, dtype=torch.float32,
                       device=device)[:, None] * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).to(dtype)


def _head_bias(p: BiasedAttention, name: str) -> torch.Tensor:
    """``bq`` (H,dh) or ``bv`` (KH,dh) as this rank's heads add it: the
    policy keeps the bias whole while ``wq`` / ``wv`` split by heads, so
    a rank takes its heads' block (``collectives.split``: in backward
    every rank gathers the whole leaf's gradient)."""
    bias = getattr(p, name)
    tp = getattr(p, "tp", None)
    return C.split(tp.comm, bias, 0) if tp is not None and tp.split \
        else bias


def _qkv(p: BiasedAttention, x: torch.Tensor):
    """x (B,S,D) -> q (B,S,H,dh), k/v (B,S,KH,dh) of this rank's heads;
    x takes the copy-in where the heads are split."""
    x = acts.enter(x, getattr(p, "tp", None))
    q = torch.einsum("bsd,dhk->bshk", x, p.wq) + _head_bias(p, "bq")
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv) + _head_bias(p, "bv")
    return q, k, v


def _out(p: BiasedAttention, out: torch.Tensor) -> torch.Tensor:
    """(B,S,H,dh) · wo -> (B,S,D), summed over the ranks where the heads
    are split, then + ``bo``."""
    y = torch.einsum("bqhk,hkd->bqd", out, p.wo)
    return acts.leave(y, getattr(p, "tp", None)) + p.bo


def _mlp(p: BiasedMLP, x: torch.Tensor) -> torch.Tensor:
    tp = getattr(p, "tp", None)
    h = F.gelu(torch.einsum("bsd,df->bsf", acts.enter(x, tp), p.wi) + p.bi,
               approximate="tanh")
    return acts.leave(torch.einsum("bsf,fd->bsd", h, p.wo), tp) + p.bo


def _encoder_attn(p: BiasedAttention, cfg: ModelConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """Bidirectional self-attention over all frames, one einsum."""
    q, k, v = _qkv(p, x)
    b, s, h, dh = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    w = torch.softmax(logits / math.sqrt(dh), dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v).reshape(b, s, h, dh)
    return _out(p, out)


def _cross_attn(p: BiasedAttention, cfg: ModelConfig, x: torch.Tensor,
                enc_k: torch.Tensor, enc_v: torch.Tensor, *,
                chunk: int = 512) -> torch.Tensor:
    """x (B,S,D) over the staged enc_k/v (B,KH,T,dh); queries in chunks
    of ``chunk`` when S is a multiple of it (each query row's softmax is
    its own, so the chunking only bounds the (chunk,T) logits)."""
    b, s, _ = x.shape
    h, kh, dh = p.wq.shape[1], enc_k.shape[1], cfg.dh
    x = acts.enter(x, getattr(p, "tp", None))
    q = (torch.einsum("bsd,dhk->bshk", x, p.wq)
         + _head_bias(p, "bq")).reshape(b, s, kh, h // kh, dh)

    def attend(qc):
        logits = torch.einsum("bqkgd,bktd->bkgqt", qc.float(),
                              enc_k.float())
        w = torch.softmax(logits / math.sqrt(dh), dim=-1).to(x.dtype)
        return torch.einsum("bkgqt,bktd->bqkgd", w, enc_v)

    step = chunk if s > chunk and s % chunk == 0 else s
    # differentiated, each chunk is rematerialized, as the JAX function
    # checkpoints its chunk scan
    remat = step < s and torch.is_grad_enabled() and q.requires_grad
    out = torch.cat([lm.checkpointed(attend, q[:, i:i + step]) if remat
                     else attend(q[:, i:i + step]) for i in range(0, s, step)],
                    dim=1).reshape(b, s, h, dh)
    return _out(p, out)


def _ln(x: torch.Tensor, module: nn.Module, name: str) -> torch.Tensor:
    return layer_norm(x, getattr(module, f"{name}_g"),
                      getattr(module, f"{name}_b"))


def encode(model: EncDecLM, cfg: ModelConfig, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """frames (B,T,D), the stub frontend's output -> (B,T,D); ``remat``
    rematerializes each encoder layer."""
    frames = frames.to(cfg.torch_dtype())
    t, d = frames.shape[1:]
    x = frames + sinusoids(t, d, frames.dtype, frames.device)[None]
    for layer in model.encoder:
        fn = functools.partial(_encoder_layer, layer, cfg)
        x = lm.checkpointed(fn, x) if remat else fn(x)
    return _ln(x, acts.gathered(model), "enc_final")


def _encoder_layer(layer: EncoderLayer, cfg: ModelConfig,
                   x: torch.Tensor) -> torch.Tensor:
    layer = acts.gathered(layer)
    x = x + _encoder_attn(layer.attn, cfg, _ln(x, layer, "ln1"))
    return x + _mlp(layer.mlp, _ln(x, layer, "ln2"))


def _enc_kv(xa: BiasedAttention, enc: torch.Tensor):
    """One decoder layer's cross K/V (B,KH,T,dh) of this rank's heads
    from the encoder output (which takes the copy-in in a sharded step,
    ``_decoder_fwd``)."""
    ek = torch.einsum("btd,dhk->bhtk", enc, xa.wk)
    ev = (torch.einsum("btd,dhk->bhtk", enc, xa.wv)
          + _head_bias(xa, "bv")[None, :, None])
    return ek, ev


def _decoder_layer(layer: DecoderLayer, cfg: ModelConfig, x: torch.Tensor,
                   ek: torch.Tensor, ev: torch.Tensor, *,
                   window: Optional[int] = None):
    """One decoder layer over a whole sequence x (B,S,D) at positions
    0..S-1: causal self-attention, cross-attention over ek/ev, MLP.
    Returns (x after the layer, its self-attention k, v (B,S,KH,dh)).  In
    a sharded step the layer's weights are gathered here
    (``act_sharding.gathered``)."""
    layer = acts.gathered(layer)
    q, k, v = _qkv(layer.attn, _ln(x, layer, "ln1"))
    x = x + _out(layer.attn, lm.chunked_attention(q, k, v, cfg,
                                                  window=window))
    x = x + _cross_attn(layer.xattn, cfg, _ln(x, layer, "lnx"), ek, ev)
    return x + _mlp(layer.mlp, _ln(x, layer, "ln2")), k, v


def _decoder_fwd(model: EncDecLM, cfg: ModelConfig, x: torch.Tensor,
                 enc: torch.Tensor, *, window: Optional[int] = None,
                 remat: bool = False) -> torch.Tensor:
    """The decoder over a whole sequence x (B,S,D) against the encoder
    output; ``remat`` rematerializes each layer.  Returns the hidden
    states before the final norm.  In a sharded step the encoder output
    takes the copy-in once for every layer's cross K/V of this rank's
    heads, and each layer's are projected outside its rematerialized
    region (as the JAX function projects them before its scan)."""
    if len(model.decoder):
        enc = acts.enter(enc, getattr(model.decoder[0].xattn, "tp", None))
    for layer in model.decoder:
        ek, ev = _enc_kv(acts.gathered(layer.xattn), enc)

        def fn(h, layer=layer, ek=ek, ev=ev):
            return _decoder_layer(layer, cfg, h, ek, ev, window=window)[0]
        x = lm.checkpointed(fn, x) if remat else fn(x)
    return x


def _embed_dec(model: EncDecLM, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Token rows (vocab-parallel on a mesh, ``lm.embed_tokens``) plus
    the learned positions."""
    return (lm.embed_tokens(model, model.cfg, tokens)
            + F.embedding(positions % DEC_MAX_POS,
                          acts.gathered(model).dec_pos))


def _logits(model: EncDecLM, x: torch.Tensor) -> torch.Tensor:
    """The tied head's (padded) vocabulary logits; on a mesh each rank's
    block, gathered in vocabulary order (as ``lm.lm_logits``)."""
    model = acts.gathered(model)
    h = _ln(x, model, "final")
    tp = getattr(model, "tp", None)
    if tp is None or not tp.split:
        return torch.einsum("bsd,vd->bsv", h, model.embed)
    return C.all_gather(tp.comm, torch.einsum(
        "bsd,vd->bsv", C.copy_in(tp.comm, h), model.embed), -1)


def encdec_prefill(model: EncDecLM, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor],
                   cache_len: Optional[int] = None, *,
                   window: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    """batch: ``frames`` (B,T,D) + ``tokens`` (B,S) -> (last-token logits,
    cache {k, v, cross_k, cross_v}): the self-attention rings of C =
    ``cache_len`` (or S) positions and every decoder layer's cross
    K/V."""
    frames, tokens = batch["frames"], batch["tokens"]
    enc = encode(model, cfg, frames)
    b, s = tokens.shape
    c = cache_len or s
    x = _embed_dec(model, tokens, torch.arange(s, device=tokens.device)[None])
    ring = (cfg.n_layers, b, cfg.n_kv_heads, c, cfg.dh)
    ks, vs, xks, xvs = [], [], [], []
    for layer in model.decoder:
        ek, ev = _enc_kv(layer.xattn, enc)
        x, k, v = _decoder_layer(layer, cfg, x, ek, ev, window=window)
        for dst, src in ((ks, k), (vs, v)):
            one = src.new_zeros(ring[1:])
            lm._to_cache(one, src)
            dst.append(one)
        xks.append(ek)
        xvs.append(ev)
    logits = _logits(model, x[:, -1:])[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "cross_k": torch.stack(xks),
                    "cross_v": torch.stack(xvs)}


def _decode_self_attn(p: BiasedAttention, cfg: ModelConfig, x: torch.Tensor,
                      ck: torch.Tensor, cv: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """The biased twin of ``lm.decode_attention_block``: the new token's
    K/V written at ring slot ``lengths % C``, in place, then attention
    over the first ``min(lengths + 1, C)`` positions."""
    b = x.shape[0]
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    c = ck.shape[2]
    q, k, v = _qkv(p, x)
    rows = torch.arange(b, device=x.device)
    slot = lengths % c
    ck[rows, :, slot] = k[:, 0].to(ck.dtype)
    cv[rows, :, slot] = v[:, 0].to(cv.dtype)
    n_valid = torch.clamp(lengths + 1, max=c)
    qg = q[:, 0].reshape(b, kh, h // kh, dh)
    logits = (torch.einsum("bkgd,bkcd->bkgc", qg.float(), ck.float())
              / math.sqrt(dh))
    valid = (torch.arange(c, device=x.device)[None, None, None, :]
             < n_valid[:, None, None, None])
    logits = logits.masked_fill(~valid, lm.NEG_INF)
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgc,bkcd->bkgd", w, cv).reshape(b, 1, h, dh)
    return _out(p, out)


def encdec_decode(model: EncDecLM, cfg: ModelConfig, cache: Cache,
                  tokens: torch.Tensor, lengths: torch.Tensor
                  ) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  tokens (B,1); lengths (B,) absolute positions;
    the rings are updated in place, the cross K/V only read.  Returns
    (logits (B,V_pad), cache)."""
    x = _embed_dec(model, tokens, lengths[:, None])
    for i, layer in enumerate(model.decoder):
        x = x + _decode_self_attn(layer.attn, cfg, _ln(x, layer, "ln1"),
                                  cache["k"][i], cache["v"][i], lengths)
        x = x + _cross_attn(layer.xattn, cfg, _ln(x, layer, "lnx"),
                            cache["cross_k"][i], cache["cross_v"][i])
        x = x + _mlp(layer.mlp, _ln(x, layer, "ln2"))
    return _logits(model, x)[:, 0], cache


def encdec_loss(model: EncDecLM, cfg: ModelConfig,
                batch: Dict[str, torch.Tensor], *, remat: bool = True,
                data_shards: int = 16):
    """batch: frames (B,T,D), tokens (B,S), labels (B,S).  Returns (loss,
    {"ce_loss"}); ``remat`` rematerializes each encoder and decoder
    layer, as the JAX ``encdec_loss`` does."""
    enc = encode(model, cfg, batch["frames"], remat=remat)
    tokens = batch["tokens"]
    x = _embed_dec(model, tokens,
                   torch.arange(tokens.shape[1], device=tokens.device)[None])
    h = _decoder_fwd(model, cfg, x, enc, remat=remat)
    loss = lm.masked_ce(_logits(model, h), batch["labels"])
    return loss, {"ce_loss": loss}
