"""Serving macro-kernels: prefill and decode as registry ops.

The port's counterpart of ``repro.serving.ops``.  It registers the
*reference* implementations of two macro-ops with the port's op
registry:

  * ``OpCode.SERVING_PREFILL`` — one prompt through the model, emitting
    the last-token logits and a populated KV cache;
  * ``OpCode.SERVING_DECODE``  — one fused decode step advancing every
    slot.

Both delegate to the family bundle's ``prefill``/``decode`` — the
readable plain-PyTorch path, the serving analogue of the paper's
reference kernels.  The kernel library (``repro_torch.kernels.ops``)
registers a ``tag="cuda"`` ``SERVING_DECODE`` whose attention runs on
the decode_attention kernel; ``ServingEngine`` resolves through the tag
priority chain (``("cuda", "reference")``), so the kernel shadows the
reference per op — the ``TAGS="cmsis-nn"`` build mechanism at pod
scale (§4.7–4.8).

The contract mirrors the micro C-API: ``prepare(ctx, op)`` runs once at
engine init (it may inspect the model family and bake decisions into
``op_data``); ``eval(ctx, op, inputs)`` runs at every step.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.op_resolver import PrepareResult, register_op
from repro_torch.core.schema import OpCode


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
