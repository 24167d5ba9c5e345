"""Quantized serving twins of the LM decode path.

The port's counterpart of ``repro.models.lm_quant``.  Weight
quantization is symmetric per channel, int8 or packed int4
(``core.quantize``): every weight matrix of ``QUANT_KEYS`` becomes a
``QWeight`` module holding ``q8`` (or packed ``q4``) and float32 scales
``qs`` as buffers, in place of its ``nn.Parameter``, so the quantized
model keeps ``DenseLM``'s layout (``blk.mlp.wi`` is the JAX tree's
``blocks["mlp"]["wi"][i]``).  Scales reduce over the second-to-last axis,
the same axis of the JAX package's stacked (L, …) leaf and of the port's
per-layer leaf, so they are constant along the contraction and the
dequant matmul (K5, K6) scales each output once after its sum.  The
model resident on the device is the quantized one: a decode step
dequantizes one layer's attention weights at a time, and the MLP either
dequantizes likewise or runs on the kernels through ``mlp_impl``.

KV quantization is symmetric int8 with one float32 scale per head
vector (``quantize_kv_heads``): the cache grows two scale leaves
(``k_scale``/``v_scale``, the cache's shape without the head dim) and
only the new token's K/V are quantized each step, written in place, so
a cache round trip (checkpoint and restore, paged scatter) is exact.

Every family but audio quantizes its weights (the JAX package's
``WEIGHT_QUANT_FAMILIES``): ``quantize_lm_params`` walks any model.  The
MoE experts' (E,D,F) leaves quantize per expert and output channel; the
router stays float32 (routing is discrete, and quantizing it would flip
choices for no memory).  A Mamba layer's projections are not in
``QUANT_KEYS``, so the recurrent families quantize their embedding (and
Zamba2 its shared block), as in the JAX package, and decode on the float
steps over ``dequant_params``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.executor import resolve_device
from repro_torch.core.quantize import (INT4_MAX, INT4_MIN, INT8_MAX, INT8_MIN,
                                       dequantize_kv_heads, pack_int4,
                                       quantize_kv_heads, unpack_int4)

from .common import ModelConfig, rms_norm
from .lm import (GATED_ACTS, Cache, DenseLM, _decode_attend, _from_numpy,
                 _gate, _out_proj, _proj_qkv, blocks, decode_attention_block,
                 embed_tokens, jax_leaf, mlp_block, moe_block,
                 paged_decode_attention_block, scale_embed)
from .registry import empty_model

# The weight matrices worth quantizing; norm gains stay float
QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "wi", "wg",
                        "lm_head", "embed"})
WEIGHT_DTYPES = ("int8", "int4")
KV_DTYPES = ("int8",)


class QWeight(nn.Module):
    """A quantized weight in place of an ``nn.Parameter``: int8 values
    ``q8``, or packed int4 bytes ``q4`` (the last axis halved), and the
    float32 scales ``qs`` (the weight's shape with the second-to-last
    axis 1), all buffers."""

    def __init__(self, q: torch.Tensor, qs: torch.Tensor, int4: bool):
        super().__init__()
        self.int4 = int4
        self.register_buffer("q4" if int4 else "q8", q)
        self.register_buffer("qs", qs)


def is_qleaf(x) -> bool:
    """Whether ``x`` is a quantized weight."""
    return isinstance(x, QWeight)


def _quantize_leaf(w: torch.Tensor, bits: int) -> QWeight:
    w = w.float()
    axis = max(w.dim() - 2, 0)
    amax = w.abs().amax(dim=axis, keepdim=True)
    qmax, qmin = (INT8_MAX, INT8_MIN) if bits == 8 else (INT4_MAX, INT4_MIN)
    scales = torch.where(amax > 0, amax / qmax, 1.0)
    q = torch.round(w / scales).clamp(qmin, qmax).to(torch.int8)
    if bits == 4:
        return QWeight(pack_int4(q), scales, int4=True)
    return QWeight(q, scales, int4=False)


def _leaves(model: nn.Module):
    """(owning module, name, qualified name, parameter) of every weight."""
    for prefix, mod in list(model.named_modules()):
        for name, p in list(mod.named_parameters(recurse=False)):
            yield mod, name, f"{prefix}.{name}" if prefix else name, p


def _put(mod: nn.Module, name: str, value) -> None:
    """Set weight ``name`` of ``mod`` to a tensor (as a parameter) or a
    ``QWeight``, in place of the parameter there."""
    delattr(mod, name)
    if isinstance(value, QWeight):
        setattr(mod, name, value)
    else:
        setattr(mod, name, nn.Parameter(value, requires_grad=False))


def quantize_lm_params(model: nn.Module, cfg: ModelConfig,
                       weight_dtype: str) -> nn.Module:
    """``model`` (any family's but audio's) -> a new model of its class
    on the same device with every ``QUANT_KEYS`` matrix replaced by its
    ``QWeight`` (the others copied), one leaf at a time.  An odd
    output-channel count falls back to int8 for that leaf (int4 packs
    channel pairs).  ``model`` is left as it was."""
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(
            f"weight_dtype {weight_dtype!r} not in {WEIGHT_DTYPES}")
    bits = 8 if weight_dtype == "int8" else 4
    src = dict(model.named_parameters())
    out = type(model)(cfg, device="meta")
    with torch.no_grad():
        for mod, name, full, _ in _leaves(out):
            val = src[full]
            if name in QUANT_KEYS and val.dim() >= 2:
                b = 8 if (bits == 4 and val.shape[-1] % 2) else bits
                _put(mod, name, _quantize_leaf(val, b))
            else:
                _put(mod, name, val.detach().clone())
    return out


def qparams_from_jax(tree: Dict, cfg: ModelConfig,
                     device="cuda") -> nn.Module:
    """The JAX ``quantize_lm_params`` tree of any family but audio
    (leaves as numpy arrays, per-layer leaves stacked on a leading L dim,
    quantized leaves as ``{"q8"|"q4", "qs"}`` dicts) as the port's
    quantized model on ``device`` (the card by default), leaf for leaf
    (``lm.jax_leaf``)."""
    device = resolve_device(device)
    out = empty_model(cfg, device="meta")
    for mod, name, full, p in _leaves(out):
        node, i = jax_leaf(tree, full)
        pick = (lambda a: np.asarray(a)) if i is None else \
            (lambda a: np.asarray(a)[i])
        if isinstance(node, dict):
            int4 = "q4" in node
            q = torch.from_numpy(np.array(pick(node["q4" if int4 else "q8"]),
                                          np.int8))
            qs = torch.from_numpy(np.array(pick(node["qs"]), np.float32))
            want = (*p.shape[:-1], p.shape[-1] // 2) if int4 else p.shape
            if tuple(q.shape) != tuple(want):
                raise ValueError(f"{full}: quantized shape {tuple(q.shape)} "
                                 f"!= {tuple(want)}")
            _put(mod, name, QWeight(q.to(device), qs.to(device), int4))
        else:
            value = _from_numpy(pick(node), p.dtype)
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{full}: shape {tuple(value.shape)} != "
                                 f"{tuple(p.shape)}")
            _put(mod, name, value.to(device))
    return out


def dequant_leaf(leaf: QWeight, dtype=torch.float32) -> torch.Tensor:
    q = unpack_int4(leaf.q4) if leaf.int4 else leaf.q8
    return (q.float() * leaf.qs).to(dtype)


class _FloatView:
    """``module`` seen with float weights, for the float steps: making
    the view of a module dequantizes its own quantized weights
    (``dequant_leaf``); a sub-module's view is made when first reached
    and kept, and the views of a ``ModuleList`` (the layers) one by one
    as a loop reaches them, so the float weights of about one layer
    exist at a time.  Non-quantized weights are the module's own."""

    def __init__(self, module: nn.Module, dtype: torch.dtype):
        self._module, self._dtype = module, dtype
        for name, child in module.named_children():
            if is_qleaf(child):
                self.__dict__[name] = dequant_leaf(child, dtype)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        value = getattr(self._module, name)
        if isinstance(value, nn.ModuleList):
            return (_FloatView(m, self._dtype) for m in value)
        if isinstance(value, nn.Module):
            value = self.__dict__[name] = _FloatView(value, self._dtype)
        return value


def dequant_params(module: nn.Module, dtype=torch.float32):
    """``module`` (the model, a block, its attention or MLP) with float
    weights of ``dtype``: a read-only view that the float steps
    (``lm.lm_prefill``, ``mlp_block``, …) take in place of the module.
    It dequantizes as it is read, one layer at a time; the values are
    those of dequantizing every leaf at once."""
    return _FloatView(module, dtype)


# ---------------------------------------------------------------------------
# int8 KV cache (contiguous ring and paged pool share the layout)
# ---------------------------------------------------------------------------

def quantize_cache(cache: Cache) -> Cache:
    """float {k, v} -> {k, v int8, k_scale, v_scale float32} with one
    scale per head vector (last axis dropped), for the contiguous
    (L,B,KH,C,dh) ring and the paged (L,P,KH,BS,dh) pool alike; all-zero
    rows quantize to (0, scale 1.0), so an empty cache stays exact."""
    kq, ks = quantize_kv_heads(cache["k"])
    vq, vs = quantize_kv_heads(cache["v"])
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def decode_attention_block_q(p, cfg: ModelConfig, x: torch.Tensor,
                             ck: torch.Tensor, cv: torch.Tensor,
                             cks: torch.Tensor, cvs: torch.Tensor,
                             lengths: torch.Tensor, attn_impl=None
                             ) -> Tuple[torch.Tensor, ...]:
    """Int8-KV twin of ``lm.decode_attention_block``: only the new
    token's K/V are quantized and written, in place, into the int8 ring
    (B,KH,C,dh) and its scale ring (B,KH,C); attention reads the
    dequantized float32 cache.  ``attn_impl`` keeps the contiguous
    kernel's signature and receives q and that float32 cache; the
    reference math casts V to x's dtype, as the JAX package does.
    Returns (out, ck, cv, cks, cvs)."""
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.dh
    c = ck.shape[2]
    q, k, v = _proj_qkv(p, cfg, x, lengths[:, None])
    kq, ks = quantize_kv_heads(k[:, 0])            # (B,KH,dh) / (B,KH)
    vq, vs = quantize_kv_heads(v[:, 0])
    rows = torch.arange(b, device=x.device)
    slot = lengths % c
    ck[rows, :, slot] = kq
    cv[rows, :, slot] = vq
    cks[rows, :, slot] = ks
    cvs[rows, :, slot] = vs
    n_valid = torch.clamp(lengths + 1, max=c)
    kc = dequantize_kv_heads(ck, cks)
    vc = dequantize_kv_heads(cv, cvs)
    if attn_impl is not None:
        out = attn_impl(q[:, 0], kc, vc, n_valid)
    else:
        out = _decode_attend(q[:, 0], kc, vc.to(x.dtype), n_valid)
    y = _out_proj(p, out.reshape(b, 1, h, dh))
    return y, ck, cv, cks, cvs


def paged_decode_attention_block_q(p, cfg: ModelConfig, x: torch.Tensor,
                                   pk: torch.Tensor, pv: torch.Tensor,
                                   pks: torch.Tensor, pvs: torch.Tensor,
                                   tables: torch.Tensor,
                                   lengths: torch.Tensor, attn_impl=None
                                   ) -> Tuple[torch.Tensor, ...]:
    """Int8-KV twin of ``lm.paged_decode_attention_block``: the pool
    (P,KH,BS,dh) int8 and its row scales (P,KH,BS) stay quantized on the
    device; the new token's row lands at block ``tables[b, pos // BS]``,
    row ``pos % BS``, in place.  ``attn_impl`` (K7) takes the raw pool,
    ``attn_impl(q, pk, pv, pks, pvs, tables, n_valid)``, and dequantizes
    inside; the reference gathers and dequantizes the slot's rows and
    runs the contiguous reference math.  Returns (out, pk, pv, pks,
    pvs)."""
    b = x.shape[0]
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    bs, t = pk.shape[2], tables.shape[1]
    c = t * bs
    q, k, v = _proj_qkv(p, cfg, x, lengths[:, None])
    kq, ks = quantize_kv_heads(k[:, 0])
    vq, vs = quantize_kv_heads(v[:, 0])
    pos = (lengths % c).long()
    phys = tables.gather(1, (pos // bs)[:, None])[:, 0].long()
    off = pos % bs
    pk[phys, :, off] = kq
    pv[phys, :, off] = vq
    pks[phys, :, off] = ks
    pvs[phys, :, off] = vs
    n_valid = torch.clamp(lengths + 1, max=c)
    if attn_impl is not None:
        out = attn_impl(q[:, 0], pk, pv, pks, pvs, tables, n_valid)
    else:
        idx = tables.long()

        def gather(pool, scales):
            return dequantize_kv_heads(
                pool[idx].transpose(1, 2).reshape(b, kh, c, dh),
                scales[idx].transpose(1, 2).reshape(b, kh, c))
        out = _decode_attend(q[:, 0], gather(pk, pks),
                             gather(pv, pvs).to(x.dtype), n_valid)
    y = _out_proj(p, out.reshape(b, 1, h, dh))
    return y, pk, pv, pks, pvs


# ---------------------------------------------------------------------------
# quantized decode steps (mirror lm_decode / lm_decode_paged)
# ---------------------------------------------------------------------------

def embed_tokens_q(model: nn.Module, cfg: ModelConfig,
                   tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embedding rows, each dequantized on its own."""
    e = model.embed
    if not is_qleaf(e):
        return embed_tokens(model, cfg, tokens)
    rows = unpack_int4(e.q4[tokens]) if e.int4 else e.q8[tokens]
    return (rows.float() * e.qs).to(cfg.torch_dtype())


def lm_logits_q(model: DenseLM, cfg: ModelConfig,
                h: torch.Tensor) -> torch.Tensor:
    hn = rms_norm(h, model.final_norm, cfg.norm_eps)
    w = model.embed if cfg.tie_embeddings else model.lm_head
    if is_qleaf(w):
        w = dequant_leaf(w, hn.dtype)
    return hn @ (w.t() if cfg.tie_embeddings else w)


def mlp_block_q(p: nn.Module, cfg: ModelConfig, x: torch.Tensor,
                mm=None) -> torch.Tensor:
    """Quantized MLP.  ``mm(x2d, qweight) -> float32`` is the
    weight-dequant matmul hook (K5/K6 through ``kernels.ops``): x goes in
    as it is, the activation and the gated product are float32, the
    hidden state is cast to x's dtype before ``wo`` and the float32
    result after it, as the JAX package does.  Without ``mm`` the
    weights dequantize to x's dtype and the float MLP runs."""
    if mm is None:
        return mlp_block(dequant_params(p, x.dtype), cfg, x)
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    hidden = mm(x2, p.wi)
    if cfg.act in GATED_ACTS:
        hidden = _gate(cfg.act, mm(x2, p.wg)) * hidden
    else:
        hidden = F.gelu(hidden, approximate="tanh")
    out = mm(hidden.to(x.dtype), p.wo)
    return out.reshape(b, s, -1).to(x.dtype)


def _decode_q(model: DenseLM, cfg: ModelConfig, x: torch.Tensor, kv,
              attend, mlp_impl) -> torch.Tensor:
    """The layer loop of both quantized decode steps: ``kv(i)`` is layer
    i's cache leaves, ``attend(p, xin, leaves)`` its attention.  A dense
    layer's MLP (DeepSeek's first block included) goes through
    ``mlp_block_q``; a MoE layer's block runs on its dequantized weights,
    as in the JAX package."""
    dt = cfg.torch_dtype()
    for i, blk in enumerate(blocks(model)):
        xin = rms_norm(x, blk.ln1, cfg.norm_eps)
        h = x + attend(dequant_params(blk.attn, dt), xin, kv(i))[0]
        hin = rms_norm(h, blk.ln2, cfg.norm_eps)
        moe = getattr(blk, "moe", None)
        if moe is not None:
            x = h + moe_block(dequant_params(moe, dt), cfg, hin)[0]
        else:
            x = h + mlp_block_q(blk.mlp, cfg, hin, mm=mlp_impl)
    return lm_logits_q(model, cfg, x)[:, 0]


def _kv_keys(kv_q: bool):
    return ("k", "v", "k_scale", "v_scale") if kv_q else ("k", "v")


def lm_decode_q(model: DenseLM, cfg: ModelConfig, cache: Cache,
                tokens: torch.Tensor, lengths: torch.Tensor, *,
                embed_scale=None, attn_impl=None, mlp_impl=None,
                kv_q: bool = False) -> Tuple[torch.Tensor, Cache]:
    """Quantized twin of ``lm.lm_decode``: ``model`` is the quantized
    model (or a float one, for an int8-KV-only engine); each layer's
    attention weights dequantize inside the loop.  With ``kv_q`` the
    cache is the 4-leaf int8 layout of ``quantize_cache`` and
    ``attn_impl`` gets the contiguous signature over the dequantized
    float32 cache.  The cache is updated in place.  ``embed_scale``:
    the vlm family's, as in ``lm.lm_decode``."""
    x = scale_embed(embed_tokens_q(model, cfg, tokens), embed_scale)
    block = decode_attention_block_q if kv_q else decode_attention_block

    def attend(p, xin, leaves):
        return block(p, cfg, xin, *leaves, lengths, attn_impl=attn_impl)
    keys = _kv_keys(kv_q)
    logits = _decode_q(model, cfg, x, lambda i: [cache[k][i] for k in keys],
                       attend, mlp_impl)
    return logits, cache


def lm_decode_paged_q(model: DenseLM, cfg: ModelConfig, pool: Cache,
                      tables: torch.Tensor, tokens: torch.Tensor,
                      lengths: torch.Tensor, *, embed_scale=None,
                      attn_impl=None, mlp_impl=None, kv_q: bool = False
                      ) -> Tuple[torch.Tensor, Cache]:
    """Quantized twin of ``lm.lm_decode_paged``.  With ``kv_q`` the pool
    is the 4-leaf int8 layout and ``attn_impl`` is the int8 block-table
    kernel (raw pool and scales, dequantized inside).  The pool is
    updated in place."""
    x = scale_embed(embed_tokens_q(model, cfg, tokens), embed_scale)
    block = (paged_decode_attention_block_q if kv_q
             else paged_decode_attention_block)

    def attend(p, xin, leaves):
        return block(p, cfg, xin, *leaves, tables, lengths,
                     attn_impl=attn_impl)
    keys = _kv_keys(kv_q)
    logits = _decode_q(model, cfg, x, lambda i: [pool[k][i] for k in keys],
                       attend, mlp_impl)
    return logits, pool
