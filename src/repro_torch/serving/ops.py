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
mechanism at pod scale (§4.7–4.8).  The dense, ssm and hybrid families
are ported; the KV-offset chunk and the paged ops take the dense family
only and refuse the others with ``UnsupportedFamilyError`` where the
JAX package refuses them (ssm, hybrid) or the port lacks them (vlm,
moe).

The contract mirrors the micro C-API: ``prepare(ctx, op)`` runs once at
engine init (it may inspect the model family and bake decisions into
``op_data``); ``eval(ctx, op, inputs)`` runs at every step.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.op_resolver import PrepareResult, register_op
from repro_torch.core.schema import OpCode
from repro_torch.models import hybrid, lm, lm_quant, ssm

from .errors import UnsupportedFamilyError

# families each fast path supports (the engine mirrors these).  The JAX
# package also chunks vlm and pages vlm and moe, which the port does not
# have yet.  CHUNKED: dense through the KV-offset chunk op, ssm/hybrid
# through the recurrent-state one; PAGED needs the dense (KH, C, dh) ring.
CHUNKED_FAMILIES = ("dense", "ssm", "hybrid")
RECURRENT_FAMILIES = ("ssm", "hybrid")
PAGED_FAMILIES = ("dense",)
KV_QUANT_FAMILIES = ("dense",)


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
                                 window=op.params.get("window"))


def _dense_only(cfg, feature: str) -> None:
    """The family gate of the KV-offset chunk and the paged ops: a dense
    (KH, C, dh) ring cache (the JAX package also chunks vlm and pages vlm
    and moe, which come with a later slice)."""
    if cfg.family != "dense":
        raise UnsupportedFamilyError(cfg.family, feature,
                                     supported=("dense",))


PAGED_FEATURE = "paged KV (requires a dense (KH, C, dh) cache layout)"


@register_op(OpCode.SERVING_PREFILL_CHUNK, tag="reference")
class RefServingPrefillChunk:
    """Reference chunked-prefill macro-kernel: one prompt CHUNK at a start
    offset through ``lm_prefill_chunk``, updating the request's batch=1
    cache in place (no logits: the engine hands the last prompt token to
    decode).  The offset is an int32 scalar tensor, passed through, so
    one captured program serves every chunk."""

    @staticmethod
    def prepare(ctx: ServingContext, op) -> PrepareResult:
        _dense_only(ctx.bundle.cfg,
                    "KV-offset chunked prefill (SERVING_PREFILL_CHUNK)")
        return PrepareResult(output_specs=[])

    @staticmethod
    def eval(ctx: ServingContext, op, inputs):
        params, cache, tokens, start = inputs
        return lm.lm_prefill_chunk(params, ctx.bundle.cfg, cache, tokens,
                                   start, window=op.params.get("window"))


@register_op(OpCode.SERVING_DECODE_PAGED, tag="reference")
class RefServingDecodePaged:
    """Reference paged decode macro-kernel: one fused step over the
    shared block pool through ``lm_decode_paged``, whose attention
    gathers each slot's blocks back to a contiguous view and runs the
    contiguous reference math — the oracle for the cuda-tagged twin."""

    @staticmethod
    def prepare(ctx: ServingContext, op) -> PrepareResult:
        _dense_only(ctx.bundle.cfg, PAGED_FEATURE)
        return PrepareResult(output_specs=[])

    @staticmethod
    def eval(ctx: ServingContext, op, inputs):
        params, pool, tables, tokens, lengths = inputs
        return lm.lm_decode_paged(params, ctx.bundle.cfg, pool, tables,
                                  tokens, lengths)


@register_op(OpCode.SERVING_PREFILL_CHUNK_PAGED, tag="reference")
class RefServingPrefillChunkPaged:
    """Reference paged chunked-prefill macro-kernel: one prompt chunk of
    ONE slot straight into the pool through ``lm_prefill_chunk_paged``,
    token-identical to the contiguous chunked path; the table row and
    the int32 start offset are device tensors, passed through."""

    @staticmethod
    def prepare(ctx: ServingContext, op) -> PrepareResult:
        _dense_only(ctx.bundle.cfg,
                    "paged chunked prefill (SERVING_PREFILL_CHUNK_PAGED)")
        return PrepareResult(output_specs=[])

    @staticmethod
    def eval(ctx: ServingContext, op, inputs):
        params, pool, table_row, tokens, start = inputs
        return lm.lm_prefill_chunk_paged(params, ctx.bundle.cfg, pool,
                                         table_row, tokens, start,
                                         window=op.params.get("window"))


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
                                           ssd_impl=ssd_impl)
    return ssm.ssm_prefill_chunk(params, cfg, cache, tokens, n_real,
                                 ssd_impl=ssd_impl)


# ---------------------------------------------------------------------------
# quantized serving macro-ops
# ---------------------------------------------------------------------------

def _quant_family_gate(cfg, op) -> dict:
    """The prepare() gate of the quantized serving ops: refuses the
    families the port does not quantize (all but dense; the JAX package
    also quantizes moe, vlm, ssm and hybrid) and bakes the layout into
    op_data."""
    _dense_only(cfg, "quantized serving (SERVING_*_Q)")
    return {"kv_q": bool(op.params.get("kv_q")),
            "paged": bool(op.params.get("paged")),
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
        params, batch = inputs
        fp = lm_quant.dequant_params(params, ctx.bundle.cfg.torch_dtype())
        logits, cache = ctx.bundle.prefill(fp, batch,
                                           cache_len=op.params["cache_len"],
                                           window=op.params.get("window"))
        if ctx.op_data["kv_q"]:
            cache = lm_quant.quantize_cache(cache)
        return logits, cache


@register_op(OpCode.SERVING_DECODE_Q, tag="reference")
class RefServingDecodeQ:
    """Reference quantized decode: one step over the quantized model
    through ``lm_decode_q`` or, paged, ``lm_decode_paged_q`` (each
    layer's weights dequantized inside the loop), contiguous or paged
    and with or without the int8 KV cache as op_data says."""

    @staticmethod
    def prepare(ctx: ServingContext, op) -> PrepareResult:
        return PrepareResult(output_specs=[],
                             op_data=_quant_family_gate(ctx.bundle.cfg, op))

    @staticmethod
    def eval(ctx: ServingContext, op, inputs):
        cfg, kv_q = ctx.bundle.cfg, ctx.op_data["kv_q"]
        if ctx.op_data["paged"]:
            params, pool, tables, tokens, lengths = inputs
            return lm_quant.lm_decode_paged_q(params, cfg, pool, tables,
                                              tokens, lengths, kv_q=kv_q)
        params, cache, tokens, lengths = inputs
        return lm_quant.lm_decode_q(params, cfg, cache, tokens, lengths,
                                    kv_q=kv_q)
