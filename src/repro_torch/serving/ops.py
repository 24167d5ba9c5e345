"""Serving macro-kernels: prefill and decode as registry ops.

The port's counterpart of ``repro.serving.ops``.  It registers the
*reference* implementations of the serving macro-ops with the port's op
registry:

  * ``OpCode.SERVING_PREFILL`` — one prompt through the model, emitting
    the last-token logits and a populated KV cache;
  * ``OpCode.SERVING_DECODE``  — one fused decode step advancing every
    slot;
  * ``OpCode.SERVING_PREFILL_CHUNK`` — one prompt chunk at a start
    offset (an int32 scalar tensor) into a slot's contiguous batch=1
    cache;
  * ``OpCode.SERVING_DECODE_PAGED`` / ``SERVING_PREFILL_CHUNK_PAGED`` —
    the same two steps over the shared pool of KV blocks, each slot's
    placement given by its block-table row;
  * ``OpCode.SERVING_PREFILL_CHUNK_STATE`` — one right-padded prompt
    chunk of a recurrent family (ssm, hybrid), carrying the batch=1
    recurrent cache (conv window and SSD state, plus hybrid's shared
    attention KV) in place;
  * ``OpCode.SERVING_PREFILL_Q`` / ``SERVING_DECODE_Q`` — quantized
    serving: int8 or packed-int4 weights and/or an int8 KV cache, the
    layout (paged or not, KV quantized or not, weight dtype) riding the
    op's params.

They run the family's plain-PyTorch steps — the readable path, the
serving analogue of the paper's reference kernels.  The kernel library
(``repro_torch.kernels.ops``) registers ``tag="cuda"`` ``SERVING_PREFILL``,
``SERVING_PREFILL_CHUNK_STATE``, ``SERVING_DECODE``,
``SERVING_DECODE_PAGED`` and ``SERVING_DECODE_Q`` whose SSD scan,
attention (and quantized MLP) run on the kernels; ``ServingEngine``
resolves through the tag priority chain (``("cuda", "reference")``), so
a kernel shadows the reference per op — the ``TAGS="cmsis-nn"`` build
mechanism at pod scale (§4.7–4.8).  Every family is served; each op
refuses, with ``UnsupportedFamilyError``, exactly the families the JAX
package's refuses.

The contract mirrors the micro C-API: ``prepare(ctx, op)`` runs once at
engine init (it may inspect the model family and bake decisions into
``op_data``); ``eval(ctx, op, inputs)`` runs at every step.

On a mesh the engine binds the ops to this rank's model
(``distributed.sharding.shard_params``) and, where its KV cache's rows
are split over the ranks, sets ``seq_kv`` in the decode and chunk ops'
params, which they pass on to the model steps (``seq_kv_kw``).
"""

from __future__ import annotations

import math
from typing import Any, Optional

from repro_torch.core.op_resolver import PrepareResult, register_op
from repro_torch.core.schema import OpCode
from repro_torch.models import hybrid, lm, lm_quant, ssm

from .errors import UnsupportedFamilyError

# families each fast path supports (the engine mirrors these), the JAX
# package's.  CHUNKED: dense/vlm through the KV-offset chunk op, ssm/
# hybrid through the recurrent-state one; not moe, whose expert capacity
# depends on the tokens integrated so far.  PAGED and the int8 KV cache
# need the dense (KH, C, dh) ring.  Weight quantization takes every
# family but audio.
CHUNKED_FAMILIES = ("dense", "vlm", "ssm", "hybrid")
RECURRENT_FAMILIES = ("ssm", "hybrid")
PAGED_FAMILIES = ("dense", "moe", "vlm")
KV_QUANT_FAMILIES = ("dense", "moe", "vlm")
WEIGHT_QUANT_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")
# the families whose KV-offset chunks are token-identical to one-shot
# prefill (the chunk ops' gate)
KV_CHUNK_FAMILIES = ("dense", "vlm")


def seq_kv_kw(op) -> dict:
    """``{"seq_kv": True}`` where the engine split its KV cache's rows
    over a mesh's ranks (the op's params say so), else nothing: the
    families without a KV cache take no such keyword."""
    return {"seq_kv": True} if op.params.get("seq_kv") else {}


class ServingContext:
    """Pod-scale Prepare/EvalContext analogue: hands the kernel the model
    bundle (family, config, reference step functions) instead of tensor
    specs, plus the ``op_data`` its prepare() baked at init."""

    def __init__(self, bundle: Any, op_data: Any = None):
        self.bundle = bundle
        self.op_data = op_data


@register_op(OpCode.SERVING_PREFILL, tag="reference")
class RefServingPrefill:
    """Reference prefill macro-kernel: one prompt through the family
    bundle's ``prefill``, emitting last-token logits + cache."""

    @staticmethod
    def prepare(ctx: ServingContext, op) -> PrepareResult:
        return PrepareResult(output_specs=[])

    @staticmethod
    def eval(ctx: ServingContext, op, inputs):
        params, batch = inputs
        return ctx.bundle.prefill(params, batch,
                                  cache_len=op.params["cache_len"],
                                  window=op.params.get("window"))


@register_op(OpCode.SERVING_DECODE, tag="reference")
class RefServingDecode:
    """Reference decode macro-kernel: one fused step advancing every
    slot via the family bundle's ``decode``."""

    @staticmethod
    def prepare(ctx: ServingContext, op) -> PrepareResult:
        return PrepareResult(output_specs=[])

    @staticmethod
    def eval(ctx: ServingContext, op, inputs):
        params, cache, tokens, lengths = inputs
        return ctx.bundle.decode(params, cache, tokens, lengths,
                                 window=op.params.get("window"),
                                 **seq_kv_kw(op))


def family_gate(cfg, feature: str, supported) -> Optional[float]:
    """The prepare() gate of an op serving ``supported`` families only:
    raises ``UnsupportedFamilyError`` for the others, and returns the
    token-embedding scale the family's LM steps take: Gemma's
    sqrt(d_model) for vlm, else None."""
    if cfg.family not in supported:
        raise UnsupportedFamilyError(cfg.family, feature,
                                     supported=supported)
    return math.sqrt(cfg.d_model) if cfg.family == "vlm" else None


PAGED_FEATURE = "paged KV (requires a dense (KH, C, dh) cache layout)"


@register_op(OpCode.SERVING_PREFILL_CHUNK, tag="reference")
class RefServingPrefillChunk:
    """Reference chunked-prefill macro-kernel: one prompt CHUNK at a start
    offset through ``lm_prefill_chunk``, updating the request's batch=1
    cache in place (no logits: the engine hands the last prompt token to
    decode).  The offset is an int32 scalar tensor, passed through, so
    one captured program serves every chunk.  dense and vlm (its
    embedding scale baked at prepare; the first chunk, through the
    ordinary prefill, carried the vision prefix); moe cannot chunk
    (expert capacity depends on the tokens integrated so far) and the
    recurrent families chunk through SERVING_PREFILL_CHUNK_STATE."""

    @staticmethod
    def prepare(ctx: ServingContext, op) -> PrepareResult:
        scale = family_gate(ctx.bundle.cfg, "KV-offset chunked prefill "
                            "(SERVING_PREFILL_CHUNK)", KV_CHUNK_FAMILIES)
        return PrepareResult(output_specs=[], op_data={"scale": scale})

    @staticmethod
    def eval(ctx: ServingContext, op, inputs):
        params, cache, tokens, start = inputs
        return lm.lm_prefill_chunk(params, ctx.bundle.cfg, cache, tokens,
                                   start, window=op.params.get("window"),
                                   embed_scale=ctx.op_data["scale"],
                                   **seq_kv_kw(op))


@register_op(OpCode.SERVING_DECODE_PAGED, tag="reference")
class RefServingDecodePaged:
    """Reference paged decode macro-kernel: one fused step over the
    shared block pool through ``lm_decode_paged``, whose attention
    gathers each slot's blocks back to a contiguous view and runs the
    contiguous reference math — the oracle for the cuda-tagged twin.
    dense, moe and vlm (its embedding scale baked at prepare)."""

    @staticmethod
    def prepare(ctx: ServingContext, op) -> PrepareResult:
        scale = family_gate(ctx.bundle.cfg, PAGED_FEATURE, PAGED_FAMILIES)
        return PrepareResult(output_specs=[], op_data={"scale": scale})

    @staticmethod
    def eval(ctx: ServingContext, op, inputs):
        params, pool, tables, tokens, lengths = inputs
        return lm.lm_decode_paged(params, ctx.bundle.cfg, pool, tables,
                                  tokens, lengths,
                                  embed_scale=ctx.op_data["scale"],
                                  **seq_kv_kw(op))


@register_op(OpCode.SERVING_PREFILL_CHUNK_PAGED, tag="reference")
class RefServingPrefillChunkPaged:
    """Reference paged chunked-prefill macro-kernel: one prompt chunk of
    ONE slot straight into the pool through ``lm_prefill_chunk_paged``,
    token-identical to the contiguous chunked path; the table row and
    the int32 start offset are device tensors, passed through.  The
    contiguous chunk op's families (moe's cache pages, but its routing
    cannot chunk)."""

    @staticmethod
    def prepare(ctx: ServingContext, op) -> PrepareResult:
        scale = family_gate(ctx.bundle.cfg, "paged chunked prefill "
                            "(SERVING_PREFILL_CHUNK_PAGED)",
                            KV_CHUNK_FAMILIES)
        return PrepareResult(output_specs=[], op_data={"scale": scale})

    @staticmethod
    def eval(ctx: ServingContext, op, inputs):
        params, pool, table_row, tokens, start = inputs
        return lm.lm_prefill_chunk_paged(params, ctx.bundle.cfg, pool,
                                         table_row, tokens, start,
                                         window=op.params.get("window"),
                                         embed_scale=ctx.op_data["scale"],
                                         **seq_kv_kw(op))


@register_op(OpCode.SERVING_PREFILL_CHUNK_STATE, tag="reference")
class RefServingPrefillChunkState:
    """Reference recurrent-state chunked-prefill macro-kernel: one
    right-padded prompt chunk through ``ssm_prefill_chunk`` /
    ``hybrid_prefill_chunk``, carrying the batch=1 recurrent cache in
    place — a chunk boundary is just a state checkpoint.  Inputs are
    ``(params, cache, tokens, start, n_real)``: ``start`` the chunk's
    absolute position (hybrid's shared attention only) and ``n_real``
    its true token count (the padded tail is an exact state no-op), both
    int32 scalar tensors, passed through.
    Only the recurrent families resolve here; dense keeps the KV-offset
    SERVING_PREFILL_CHUNK op."""

    @staticmethod
    def prepare(ctx: ServingContext, op) -> PrepareResult:
        family = ctx.bundle.cfg.family
        if family not in RECURRENT_FAMILIES:
            raise UnsupportedFamilyError(
                family, "recurrent-state chunked prefill "
                        "(SERVING_PREFILL_CHUNK_STATE)",
                supported=RECURRENT_FAMILIES)
        return PrepareResult(output_specs=[], op_data={"family": family})

    @staticmethod
    def eval(ctx: ServingContext, op, inputs):
        return prefill_chunk_state(ctx, op, inputs)


def prefill_chunk_state(ctx: ServingContext, op, inputs, ssd_impl=None):
    """The body of SERVING_PREFILL_CHUNK_STATE with the scan hook
    ``ssd_impl`` (None: the plain ``ssd_chunked``)."""
    params, cache, tokens, start, n_real = inputs
    cfg = ctx.bundle.cfg
    if ctx.op_data["family"] == "hybrid":
        return hybrid.hybrid_prefill_chunk(params, cfg, cache, tokens, start,
                                           n_real,
                                           window=op.params.get("window"),
                                           ssd_impl=ssd_impl,
                                           **seq_kv_kw(op))
    return ssm.ssm_prefill_chunk(params, cfg, cache, tokens, n_real,
                                 ssd_impl=ssd_impl)


# ---------------------------------------------------------------------------
# quantized serving macro-ops
# ---------------------------------------------------------------------------

def _quant_family_gate(cfg, op) -> dict:
    """The prepare() gate of the quantized serving ops: refuses audio,
    an int8 KV cache without a (KH, C, dh) ring and paging where the
    float paged ops refuse it, and bakes the layout into op_data:
    ``lm_path`` (dense, moe, vlm: the quantized LM steps) or not (ssm,
    hybrid: the float steps over the dequantized model), and the vlm
    embedding scale."""
    kv_q, paged = bool(op.params.get("kv_q")), bool(op.params.get("paged"))
    scale = family_gate(cfg, "quantized serving (SERVING_*_Q)",
                        WEIGHT_QUANT_FAMILIES)
    if kv_q:
        family_gate(cfg, "int8 KV cache (requires a dense (KH, C, dh) "
                         "cache layout)", KV_QUANT_FAMILIES)
    if paged:
        family_gate(cfg, PAGED_FEATURE, PAGED_FAMILIES)
    return {"kv_q": kv_q, "paged": paged, "scale": scale,
            "lm_path": cfg.family in KV_QUANT_FAMILIES,
            "weight_dtype": op.params.get("weight_dtype")}


@register_op(OpCode.SERVING_PREFILL_Q, tag="reference")
class RefServingPrefillQ:
    """Reference quantized prefill: the float prefill over the quantized
    weights read through ``lm_quant.dequant_params`` (one layer's float
    weights at a time, the values of dequantizing the whole tree), then,
    for an int8 KV cache, ``quantize_cache`` on the way out — the same
    ``quantize_kv_heads`` the decode step applies to each new token."""

    @staticmethod
    def prepare(ctx: ServingContext, op) -> PrepareResult:
        return PrepareResult(output_specs=[],
                             op_data=_quant_family_gate(ctx.bundle.cfg, op))

    @staticmethod
    def eval(ctx: ServingContext, op, inputs):
        return prefill_q(ctx, op, inputs)


def prefill_q(ctx: ServingContext, op, inputs, **kw):
    """The body of SERVING_PREFILL_Q; ``kw`` goes to the bundle's
    prefill (the ``"cuda"`` op passes the recurrent families' scan
    hook)."""
    params, batch = inputs
    fp = lm_quant.dequant_params(params, ctx.bundle.cfg.torch_dtype())
    logits, cache = ctx.bundle.prefill(fp, batch,
                                       cache_len=op.params["cache_len"],
                                       window=op.params.get("window"), **kw)
    if ctx.op_data["kv_q"]:
        cache = lm_quant.quantize_cache(cache)
    return logits, cache


@register_op(OpCode.SERVING_DECODE_Q, tag="reference")
class RefServingDecodeQ:
    """Reference quantized decode: one step over the quantized model
    through ``lm_decode_q`` or, paged, ``lm_decode_paged_q`` (each
    layer's weights dequantized inside the loop), contiguous or paged
    and with or without the int8 KV cache as op_data says; the recurrent
    families (weight-only) run the bundle's float decode over
    ``dequant_params``."""

    @staticmethod
    def prepare(ctx: ServingContext, op) -> PrepareResult:
        return PrepareResult(output_specs=[],
                             op_data=_quant_family_gate(ctx.bundle.cfg, op))

    @staticmethod
    def eval(ctx: ServingContext, op, inputs):
        return decode_q(ctx, op, inputs)


def decode_q(ctx: ServingContext, op, inputs, attn_impl=None,
             mlp_impl=None):
    """The body of SERVING_DECODE_Q with the kernel hooks (None: the
    plain math): ``attn_impl`` the attention of the step's layout,
    ``mlp_impl`` the dequant matmul."""
    cfg, od = ctx.bundle.cfg, ctx.op_data
    if od["paged"]:
        params, pool, tables, tokens, lengths = inputs
        return lm_quant.lm_decode_paged_q(
            params, cfg, pool, tables, tokens, lengths,
            embed_scale=od["scale"], kv_q=od["kv_q"], attn_impl=attn_impl,
            mlp_impl=mlp_impl)
    params, cache, tokens, lengths = inputs
    if od["lm_path"]:
        return lm_quant.lm_decode_q(params, cfg, cache, tokens, lengths,
                                    embed_scale=od["scale"], kv_q=od["kv_q"],
                                    attn_impl=attn_impl, mlp_impl=mlp_impl)
    fp = lm_quant.dequant_params(params, cfg.torch_dtype())
    return ctx.bundle.decode(fp, cache, tokens, lengths,
                             window=op.params.get("window"))
