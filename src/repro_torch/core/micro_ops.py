"""Reference kernels (paper §4.7 — "simple operator-kernel implementations
designed for readability rather than performance"), in plain PyTorch.

Every micro opcode the JAX package registers, each a (prepare, eval)
pair registered under the ``"reference"`` tag with the same contract as
``repro.core.micro_ops``: ``prepare`` runs once at init (shapes, output
specs, requant constants, scratch and persistent byte counts identical
to the JAX package, so arena sizes match exactly); ``eval`` runs inside
invoke on the interpreter's device.  Constants an int8 eval needs as
tensors (the fixed-point multipliers) are made on that device in
``prepare``, so a CUDA-graph capture of invoke copies nothing from the
host.

Quantized (INT8) paths follow the TFLM reference kernels: integer
accumulation, gemmlowp fixed-point requantization, quantized activation
clamps.  Torch has no int32 convolution or matmul on the card, so the
integer products are taken in float64, which is exact for every sum
below 2^53 — far beyond any accumulator an int8 layer forms — and then
converted back to int32 before the requant.

Conventions (TFLite layouts, kept at every op boundary; ops permute to
PyTorch's NCHW only inside):
  CONV_2D            x: NHWC,  w: (O, KH, KW, I),    bias: (O,)
  DEPTHWISE_CONV_2D  x: NHWC,  w: (1, KH, KW, C*M),  bias: (C*M,)
  FULLY_CONNECTED    x: (..., K), w: (N, K),          bias: (N,)
  SVDF               x: (B, F), w_feat: (NF, F), w_time: (NF, T),
                     bias: (U,), state (variable): (B, NF*T)
  ATTENTION          q, k, v: (B, H, S, D)
  ROPE               x: (B, S, H, D), positions 0..S-1
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import quantize as Q
from .op_resolver import PrepareResult, TensorSpec, register_op
from .schema import OpCode

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _apply_activation_f32(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return x.clamp(min=0.0)
    if activation == "relu6":
        return x.clamp(0.0, 6.0)
    if activation != "none":
        raise ValueError(f"unknown activation {activation!r}")
    return x


def _quantized_activation_range(activation: str, scale: float,
                                zero_point: int) -> Tuple[int, int]:
    """TFLM CalculateActivationRangeQuantized."""
    qmin, qmax = Q.INT8_MIN, Q.INT8_MAX
    if activation == "relu":
        qmin = max(qmin, zero_point + int(round(0.0 / scale)))
    elif activation == "relu6":
        qmin = max(qmin, zero_point + int(round(0.0 / scale)))
        qmax = min(qmax, zero_point + int(round(6.0 / scale)))
    return qmin, qmax


def _conv_padding(padding: str, in_size: int, k: int, stride: int,
                  dilation: int = 1) -> Tuple[int, int, int]:
    """Returns (pad_lo, pad_hi, out_size), TFLite SAME/VALID semantics.
    SAME with an even total pads one more at the end (TF-asymmetric)."""
    eff_k = (k - 1) * dilation + 1
    if padding == "VALID":
        out = (in_size - eff_k) // stride + 1
        return 0, 0, out
    out = -(-in_size // stride)                     # ceil div
    total = max(0, (out - 1) * stride + eff_k - in_size)
    return total // 2, total - total // 2, out


def _spec(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(int(d) for d in shape), dtype)


def _int8_requant_data(ctx, op, op_data: Dict[str, Any]) -> int:
    """Bake the per-channel requant constants of an int8 conv/FC into
    ``op_data``; returns their persistent byte count."""
    xq, wq = ctx.quant(op.inputs[0]), ctx.quant(op.inputs[1])
    oq = ctx.quant(op.outputs[0])
    wscales = (wq.channel_scales if wq.is_per_channel
               else np.array([wq.scale], np.float32))
    rs = Q.RequantSpec.build(xq.scale, wscales, oq.scale,
                             xq.zero_point, oq.zero_point)
    qmin, qmax = _quantized_activation_range(
        op_data["act"], oq.scale, oq.zero_point)
    op_data.update(requant=rs, requant_t=rs.on(ctx.device),
                   qmin=qmin, qmax=qmax)
    return rs.nbytes()


def _int_acc_to_int8(acc: torch.Tensor, bias, d) -> torch.Tensor:
    """Exact float64 accumulator (NHWC or (..., N)) -> int8 through int32
    bias add and the gemmlowp requant."""
    acc = acc.to(torch.int32)
    if bias is not None:
        acc = acc + bias.to(torch.int32)
    rs: Q.RequantSpec = d["requant"]
    mult, shift = d["requant_t"]
    return Q.requantize(acc, mult, shift, rs.output_zero_point,
                        d["qmin"], d["qmax"])


def _conv_nhwc(x, w_ohwi, d, groups: int = 1) -> torch.Tensor:
    """NHWC x OHWI convolution with explicit (possibly asymmetric)
    padding, result in NHWC."""
    top, bottom, left, right = d["pad"]
    xn = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    out = F.conv2d(xn, w_ohwi.permute(0, 3, 1, 2), stride=d["stride"],
                   dilation=d["dilation"], groups=groups)
    return out.permute(0, 2, 3, 1)


def _conv_eval(x, w_ohwi, bias, d, groups: int = 1):
    if x.dtype == torch.int8:
        rs: Q.RequantSpec = d["requant"]
        xs = x.to(torch.float64) - rs.input_zero_point
        acc = _conv_nhwc(xs, w_ohwi.to(torch.float64), d, groups)
        return [_int_acc_to_int8(acc, bias, d)]
    acc = _conv_nhwc(x, w_ohwi, d, groups)
    if bias is not None:
        acc = acc + bias
    return [_apply_activation_f32(acc, d["act"])]


def _optional(inputs, k):
    return inputs[k] if len(inputs) > k else None


# ---------------------------------------------------------------------------
# CONV_2D
# ---------------------------------------------------------------------------

@register_op(OpCode.CONV_2D)
class Conv2D:
    """Standard 2-D convolution (NHWC x OHWI), float or per-channel int8
    with fused bias/activation — paper Table 1's flagship kernel.
    """

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        w = ctx.tensor_spec(op.inputs[1])
        p = op.params
        sh, sw = p.get("stride_h", 1), p.get("stride_w", 1)
        dh, dw = p.get("dilation_h", 1), p.get("dilation_w", 1)
        pad = p.get("padding", "VALID")
        n, ih, iw, ic = x.shape
        oc, kh, kw, wic = w.shape
        if wic != ic:
            raise ValueError(f"conv channel mismatch {wic} != {ic}")
        top, bottom, oh = _conv_padding(pad, ih, kh, sh, dh)
        left, right, ow = _conv_padding(pad, iw, kw, sw, dw)
        out_spec = _spec((n, oh, ow, oc), x.dtype)
        op_data: Dict[str, Any] = {"act": p.get("activation", "none"),
                                   "pad": (top, bottom, left, right),
                                   "stride": (sh, sw), "dilation": (dh, dw)}
        persistent = 0
        if x.dtype == "int8":
            persistent = _int8_requant_data(ctx, op, op_data)
        # im2col scratch, the TFLM conv scratch analogue
        scratch = [kh * kw * ic * oh * ow * 4]
        return PrepareResult([out_spec], scratch_nbytes=scratch,
                             persistent_nbytes=persistent, op_data=op_data)

    @staticmethod
    def eval(ctx, op, inputs):
        return _conv_eval(inputs[0], inputs[1], _optional(inputs, 2),
                          ctx.op_data)


# ---------------------------------------------------------------------------
# DEPTHWISE_CONV_2D
# ---------------------------------------------------------------------------

@register_op(OpCode.DEPTHWISE_CONV_2D)
class DepthwiseConv2D:
    """Depthwise 2-D convolution (channel multiplier layout), the
    MobileNet/VWW workhorse; float or per-channel int8.
    """

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        w = ctx.tensor_spec(op.inputs[1])
        p = op.params
        sh, sw = p.get("stride_h", 1), p.get("stride_w", 1)
        pad = p.get("padding", "VALID")
        n, ih, iw, ic = x.shape
        one, kh, kw, oc = w.shape
        mult = p.get("depth_multiplier", oc // ic)
        if oc != ic * mult:
            raise ValueError(f"depthwise channels {oc} != {ic} * {mult}")
        top, bottom, oh = _conv_padding(pad, ih, kh, sh)
        left, right, ow = _conv_padding(pad, iw, kw, sw)
        out_spec = _spec((n, oh, ow, oc), x.dtype)
        op_data: Dict[str, Any] = {"act": p.get("activation", "none"),
                                   "mult": mult,
                                   "pad": (top, bottom, left, right),
                                   "stride": (sh, sw), "dilation": (1, 1)}
        persistent = 0
        if x.dtype == "int8":
            persistent = _int8_requant_data(ctx, op, op_data)
        return PrepareResult([out_spec], persistent_nbytes=persistent,
                             op_data=op_data)

    @staticmethod
    def eval(ctx, op, inputs):
        x, w = inputs[0], inputs[1]
        d = ctx.op_data
        ic, mult = x.shape[-1], d["mult"]
        kh, kw = w.shape[1], w.shape[2]
        # the reference's grouped-conv weight: (1,KH,KW,C*M) reshaped to
        # (KH,KW,C,M), moved to (M,KH,KW,C) and read back row-major as
        # OHWI (C*M,KH,KW,1) — the same reinterpretation, step for step,
        # so both packages apply the same taps to the same channels
        w_ohwi = w.reshape(kh, kw, ic, mult).permute(3, 0, 1, 2)
        w_ohwi = w_ohwi.reshape(ic * mult, kh, kw, 1)
        return _conv_eval(x, w_ohwi, _optional(inputs, 2), d, groups=ic)


# ---------------------------------------------------------------------------
# FULLY_CONNECTED
# ---------------------------------------------------------------------------

@register_op(OpCode.FULLY_CONNECTED)
class FullyConnected:
    """Dense layer y = xW^T + b with optional fused activation; int8 path
    requantizes through the TFLite fixed-point scheme.
    """

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        w = ctx.tensor_spec(op.inputs[1])
        n_out, k = w.shape
        if x.shape[-1] != k:
            raise ValueError(f"FC dim mismatch {x.shape} @ {w.shape}")
        out_spec = _spec(x.shape[:-1] + (n_out,), x.dtype)
        op_data: Dict[str, Any] = {"act": op.params.get("activation",
                                                        "none")}
        persistent = 0
        if x.dtype == "int8":
            persistent = _int8_requant_data(ctx, op, op_data)
        return PrepareResult([out_spec], persistent_nbytes=persistent,
                             op_data=op_data)

    @staticmethod
    def eval(ctx, op, inputs):
        x, w = inputs[0], inputs[1]
        bias = _optional(inputs, 2)
        d = ctx.op_data
        if x.dtype == torch.int8:
            rs: Q.RequantSpec = d["requant"]
            xs = x.to(torch.float64) - rs.input_zero_point
            acc = torch.matmul(xs, w.to(torch.float64).T)
            return [_int_acc_to_int8(acc, bias, d)]
        acc = torch.matmul(x, w.T)
        if bias is not None:
            acc = acc + bias
        return [_apply_activation_f32(acc, d["act"])]


# ---------------------------------------------------------------------------
# elementwise binary (ADD / SUB / MUL / MIN / MAX / SQUARED_DIFFERENCE)
# ---------------------------------------------------------------------------

def _multiplier_on(ctx, multiplier: int, shift: int):
    """A fixed-point (multiplier, shift) pair as tensors on the device."""
    return (torch.tensor(multiplier, dtype=torch.int32, device=ctx.device),
            torch.tensor(shift, dtype=torch.int64, device=ctx.device))


def _binary_prepare(ctx, op):
    a = ctx.tensor_spec(op.inputs[0])
    b = ctx.tensor_spec(op.inputs[1])
    shape = np.broadcast_shapes(tuple(a.shape), tuple(b.shape))
    op_data: Dict[str, Any] = {"act": op.params.get("activation", "none")}
    persistent = 0
    if a.dtype == "int8":
        q1, q2 = ctx.quant(op.inputs[0]), ctx.quant(op.inputs[1])
        oq = ctx.quant(op.outputs[0])
        op_data.update(q1=(q1.scale, q1.zero_point),
                       q2=(q2.scale, q2.zero_point),
                       qo=(oq.scale, oq.zero_point))
        if op.opcode in (OpCode.ADD, OpCode.SUB):
            # TFLM quantized add: align on twice_max_input_scale, ls=20
            ls = 20
            twice_max = 2.0 * max(q1.scale, q2.scale)
            m1, s1 = Q.quantize_multiplier(q1.scale / twice_max)
            m2, s2 = Q.quantize_multiplier(q2.scale / twice_max)
            mo, so = Q.quantize_multiplier(
                twice_max / ((1 << ls) * oq.scale))
            op_data.update(ls=ls, r1=_multiplier_on(ctx, m1, s1),
                           r2=_multiplier_on(ctx, m2, s2),
                           ro=_multiplier_on(ctx, mo, so))
            persistent = 48
        elif op.opcode == OpCode.MUL:
            mo, so = Q.quantize_multiplier(q1.scale * q2.scale / oq.scale)
            op_data.update(ro=_multiplier_on(ctx, mo, so))
            persistent = 16
        qmin, qmax = _quantized_activation_range(
            op_data["act"], oq.scale, oq.zero_point)
        op_data.update(qmin=qmin, qmax=qmax)
    return PrepareResult([_spec(shape, a.dtype)],
                         persistent_nbytes=persistent, op_data=op_data)


def _make_binary(opcode, f32_fn, int8_kind):
    class _Bin:
        @staticmethod
        def prepare(ctx, op):
            return _binary_prepare(ctx, op)

        @staticmethod
        def eval(ctx, op, inputs):
            a, b = inputs
            d = ctx.op_data
            if a.dtype == torch.int8 and int8_kind == "addsub":
                x1 = (a.to(torch.int32) - d["q1"][1]) << d["ls"]
                x2 = (b.to(torch.int32) - d["q2"][1]) << d["ls"]
                x1 = Q.multiply_by_quantized_multiplier(x1, *d["r1"])
                x2 = Q.multiply_by_quantized_multiplier(x2, *d["r2"])
                raw = x1 - x2 if op.opcode == OpCode.SUB else x1 + x2
                out = Q.multiply_by_quantized_multiplier(
                    raw, *d["ro"]) + d["qo"][1]
                return [out.clamp(d["qmin"], d["qmax"]).to(torch.int8)]
            if a.dtype == torch.int8 and int8_kind == "mul":
                raw = ((a.to(torch.int32) - d["q1"][1])
                       * (b.to(torch.int32) - d["q2"][1]))
                out = Q.multiply_by_quantized_multiplier(
                    raw, *d["ro"]) + d["qo"][1]
                return [out.clamp(d["qmin"], d["qmax"]).to(torch.int8)]
            if a.dtype == torch.int8:
                # dequantize, the float32 function, requantize; like the
                # reference, this route ignores the fused activation
                (s1, z1), (s2, z2), (so_, zo) = d["q1"], d["q2"], d["qo"]
                fa = (a.to(torch.float32) - z1) * s1
                fb = (b.to(torch.float32) - z2) * s2
                out = torch.round(f32_fn(fa, fb) / so_) + zo
                return [out.clamp(Q.INT8_MIN, Q.INT8_MAX).to(torch.int8)]
            return [_apply_activation_f32(f32_fn(a, b), d["act"])]
    _Bin.__name__ = f"Bin_{opcode}"
    register_op(opcode)(_Bin)
    return _Bin


_make_binary(OpCode.ADD, lambda a, b: a + b, "addsub")
_make_binary(OpCode.SUB, lambda a, b: a - b, "addsub")
_make_binary(OpCode.MUL, lambda a, b: a * b, "mul")
_make_binary(OpCode.MINIMUM, torch.minimum, "float")
_make_binary(OpCode.MAXIMUM, torch.maximum, "float")
_make_binary(OpCode.SQUARED_DIFFERENCE, lambda a, b: (a - b) ** 2, "float")


# ---------------------------------------------------------------------------
# pooling / shape / reduction
# ---------------------------------------------------------------------------

def _pool_prepare(ctx, op):
    x = ctx.tensor_spec(op.inputs[0])
    p = op.params
    kh, kw = p.get("filter_h", 2), p.get("filter_w", 2)
    sh, sw = p.get("stride_h", kh), p.get("stride_w", kw)
    pad = p.get("padding", "VALID")
    n, ih, iw, c = x.shape
    top, bottom, oh = _conv_padding(pad, ih, kh, sh)
    left, right, ow = _conv_padding(pad, iw, kw, sw)
    return PrepareResult([_spec((n, oh, ow, c), x.dtype)],
                         op_data={"k": (kh, kw), "s": (sh, sw),
                                  "pad": (top, bottom, left, right)})


def _windows(x: torch.Tensor, d, value) -> torch.Tensor:
    """NHWC -> (N, OH, OW, C, kh, kw) pooling windows, the padding filled
    with ``value``."""
    (kh, kw), (sh, sw) = d["k"], d["s"]
    top, bottom, left, right = d["pad"]
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom), value=value)
    return x.unfold(1, kh, sh).unfold(2, kw, sw)

@register_op(OpCode.MAX_POOL_2D)
class MaxPool2D:
    """Max pooling over NHWC windows; int8-safe (padding is the int8
    minimum, comparisons are exact).
    """

    prepare = staticmethod(_pool_prepare)

    @staticmethod
    def eval(ctx, op, inputs):
        (x,) = inputs
        init = Q.INT8_MIN if x.dtype == torch.int8 else -math.inf
        return [_windows(x, ctx.op_data, init).amax(dim=(-2, -1))]


@register_op(OpCode.AVERAGE_POOL_2D)
class AvgPool2D:
    """Average pooling over NHWC windows; int8 accumulates in int32 and
    rounds back to the shared input/output scale.  A window's count is
    its valid (unpadded) elements, as in the reference's reduce_window of
    ones.
    """

    @staticmethod
    def prepare(ctx, op):
        prep = _pool_prepare(ctx, op)
        d = prep.op_data
        _, ih, iw, _ = ctx.tensor_spec(op.inputs[0]).shape
        ones = torch.ones((1, ih, iw, 1), dtype=torch.int32)
        cnt = _windows(ones, d, 0).sum(dim=(-2, -1), dtype=torch.int32)
        d["count"] = cnt.to(ctx.device)
        d["count_f"] = cnt.to(torch.float32).to(ctx.device)
        return prep

    @staticmethod
    def eval(ctx, op, inputs):
        (x,) = inputs
        d = ctx.op_data
        if x.dtype == torch.int8:
            acc = _windows(x.to(torch.int32), d, 0).sum(
                dim=(-2, -1), dtype=torch.int32)
            cnt = d["count"]
            # rounding divide (TFLM: round half away from zero), the
            # reference's floor division on each side
            half = torch.div(cnt, 2, rounding_mode="floor")
            pos = torch.div(acc + half, cnt, rounding_mode="floor")
            neg = -torch.div(-acc + half, cnt, rounding_mode="floor")
            out = torch.where(acc >= 0, pos, neg)
            return [out.clamp(Q.INT8_MIN, Q.INT8_MAX).to(torch.int8)]
        acc = _windows(x, d, 0.0).sum(dim=(-2, -1))
        return [acc / d["count_f"].to(x.dtype)]


@register_op(OpCode.RESHAPE)
class Reshape:
    """Shape-only view change (supports one -1 wildcard)."""

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        new_shape = list(op.params["new_shape"])
        n = int(np.prod(x.shape))
        if -1 in new_shape:
            i = new_shape.index(-1)
            rest = int(np.prod([d for d in new_shape if d != -1]))
            new_shape[i] = n // rest
        if int(np.prod(new_shape)) != n:
            raise ValueError(f"cannot reshape {x.shape} to {new_shape}")
        return PrepareResult([_spec(new_shape, x.dtype)])

    @staticmethod
    def eval(ctx, op, inputs):
        return [inputs[0].reshape(ctx.output_shape(0))]


@register_op(OpCode.TRANSPOSE)
class Transpose:
    """Axis permutation by the serialized perm parameter."""

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        perm = op.params["perm"]
        return PrepareResult([_spec([x.shape[p] for p in perm], x.dtype)])

    @staticmethod
    def eval(ctx, op, inputs):
        return [inputs[0].permute(*op.params["perm"])]


@register_op(OpCode.CONCATENATION)
class Concatenation:
    """Concatenate inputs along one axis; output spec sums that axis
    across the input specs.
    """

    @staticmethod
    def prepare(ctx, op):
        axis = op.params.get("axis", -1)
        specs = [ctx.tensor_spec(i) for i in op.inputs]
        shape = list(specs[0].shape)
        ax = axis % len(shape)
        shape[ax] = sum(s.shape[ax] for s in specs)
        return PrepareResult([_spec(shape, specs[0].dtype)])

    @staticmethod
    def eval(ctx, op, inputs):
        return [torch.cat(list(inputs), dim=op.params.get("axis", -1))]


@register_op(OpCode.PAD)
class Pad:
    """Constant padding by per-axis (lo, hi) amounts from the serialized
    paddings parameter: zeros in float, the output zero point in int8.
    """

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        pads = op.params["paddings"]
        shape = [d + lo + hi for d, (lo, hi) in zip(x.shape, pads)]
        return PrepareResult([_spec(shape, x.dtype)])

    @staticmethod
    def eval(ctx, op, inputs):
        (x,) = inputs
        value = (ctx.quant_of_output(0).zero_point
                 if x.dtype == torch.int8 else 0)
        # F.pad takes (lo, hi) pairs from the last axis back
        flat = [n for lo_hi in reversed(op.params["paddings"])
                for n in lo_hi]
        return [F.pad(x, flat, value=value)]


@register_op(OpCode.STRIDED_SLICE)
class StridedSlice:
    """Strided slicing with serialized begin/end/strides, shape computed
    at prepare time.
    """

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        begin, end = op.params["begin"], op.params["end"]
        strides = op.params.get("strides", [1] * len(begin))
        shape = [max(0, -(-(e - b) // s))
                 for b, e, s in zip(begin, end, strides)]
        return PrepareResult([_spec(shape, x.dtype)])

    @staticmethod
    def eval(ctx, op, inputs):
        begin, end = op.params["begin"], op.params["end"]
        strides = op.params.get("strides", [1] * len(begin))
        return [inputs[0][tuple(slice(b, e, s)
                                for b, e, s in zip(begin, end, strides))]]


@register_op(OpCode.SPLIT)
class Split:
    """Even split along one axis into len(op.outputs) equal parts."""

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        axis = op.params.get("axis", -1) % len(x.shape)
        n = len(op.outputs)
        if x.shape[axis] % n:
            raise ValueError(f"SPLIT: axis {axis} of {x.shape} is not a "
                             f"multiple of {n}")
        shape = list(x.shape)
        shape[axis] //= n
        return PrepareResult([_spec(shape, x.dtype) for _ in range(n)])

    @staticmethod
    def eval(ctx, op, inputs):
        axis = op.params.get("axis", -1)
        (x,) = inputs
        return list(torch.split(x, x.shape[axis] // len(op.outputs),
                                dim=axis))


@register_op(OpCode.MEAN)
class Mean:
    """Mean reduction over the serialized axes (optionally keepdims);
    int8 reduces in float and requantizes to the output scale.
    """

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        axes = tuple(a % len(x.shape) for a in op.params["axes"])
        keep = op.params.get("keepdims", False)
        shape = [d if i not in axes else 1
                 for i, d in enumerate(x.shape)]
        if not keep:
            shape = [d for i, d in enumerate(shape) if i not in axes]
        op_data: Dict[str, Any] = {"axes": axes, "keep": keep}
        if x.dtype == "int8":
            xq, oq = ctx.quant(op.inputs[0]), ctx.quant(op.outputs[0])
            op_data.update(xq=(xq.scale, xq.zero_point),
                           oq=(oq.scale, oq.zero_point))
        return PrepareResult([_spec(shape, x.dtype)], op_data=op_data)

    @staticmethod
    def eval(ctx, op, inputs):
        (x,) = inputs
        d = ctx.op_data
        if x.dtype == torch.int8:
            (xs, xz), (os_, oz) = d["xq"], d["oq"]
            f = (x.to(torch.float32) - xz) * xs
            m = f.mean(dim=d["axes"], keepdim=d["keep"])
            q = torch.round(m / os_) + oz
            return [q.clamp(Q.INT8_MIN, Q.INT8_MAX).to(torch.int8)]
        return [x.mean(dim=d["axes"], keepdim=d["keep"])]


# ---------------------------------------------------------------------------
# unary / activations
# ---------------------------------------------------------------------------

def _unary_prepare(ctx, op):
    x = ctx.tensor_spec(op.inputs[0])
    op_data = {}
    if x.dtype == "int8":
        xq, oq = ctx.quant(op.inputs[0]), ctx.quant(op.outputs[0])
        op_data = {"xq": (xq.scale, xq.zero_point),
                   "oq": (oq.scale, oq.zero_point)}
    return PrepareResult([_spec(x.shape, x.dtype)], op_data=op_data)


def _make_unary(opcode, f32_fn):
    class _Un:
        @staticmethod
        def prepare(ctx, op):
            return _unary_prepare(ctx, op)

        @staticmethod
        def eval(ctx, op, inputs):
            (x,) = inputs
            if x.dtype == torch.int8:
                (xs, xz), (os_, oz) = ctx.op_data["xq"], ctx.op_data["oq"]
                f = (x.to(torch.float32) - xz) * xs
                out = torch.round(f32_fn(f) / os_) + oz
                return [out.clamp(Q.INT8_MIN, Q.INT8_MAX).to(torch.int8)]
            return [f32_fn(x)]
    _Un.__name__ = f"Unary_{opcode}"
    register_op(opcode)(_Un)
    return _Un


_make_unary(OpCode.RELU, lambda x: x.clamp(min=0))
_make_unary(OpCode.RELU6, lambda x: x.clamp(0, 6))
_make_unary(OpCode.LOGISTIC, torch.sigmoid)
_make_unary(OpCode.TANH, torch.tanh)
_make_unary(OpCode.SILU, F.silu)
# jax.nn.gelu's default is the tanh approximation, not torch's erf form
_make_unary(OpCode.GELU, lambda x: F.gelu(x, approximate="tanh"))
_make_unary(OpCode.RSQRT, torch.rsqrt)
_make_unary(OpCode.EXP, torch.exp)
_make_unary(OpCode.NEG, torch.neg)
_make_unary(OpCode.LEAKY_RELU, lambda x: torch.where(x >= 0, x, 0.01 * x))


# ---------------------------------------------------------------------------
# SOFTMAX / QUANTIZE / DEQUANTIZE
# ---------------------------------------------------------------------------

@register_op(OpCode.SOFTMAX)
class Softmax:
    """Softmax along the last axis; int8 follows the TFLite convention
    (output scale 1/256, zero point -128).
    """

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        op_data = {}
        if x.dtype == "int8":
            xq = ctx.quant(op.inputs[0])
            oq = ctx.quant(op.outputs[0])
            op_data = {"xq": (xq.scale, xq.zero_point),
                       "oq": (oq.scale, oq.zero_point)}
        return PrepareResult([_spec(x.shape, x.dtype)], op_data=op_data)

    @staticmethod
    def eval(ctx, op, inputs):
        (x,) = inputs
        beta = op.params.get("beta", 1.0)
        if x.dtype == torch.int8:
            (xs, xz), (os_, oz) = ctx.op_data["xq"], ctx.op_data["oq"]
            f = (x.to(torch.float32) - xz) * xs
            s = torch.softmax(beta * f, dim=-1)
            out = torch.round(s / os_) + oz
            return [out.clamp(Q.INT8_MIN, Q.INT8_MAX).to(torch.int8)]
        return [torch.softmax(beta * x, dim=-1)]


@register_op(OpCode.IDENTITY)
class Identity:
    """Pass-through op (shape/dtype preserved) — the exporter's
    placeholder for folded or no-op nodes.
    """

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        return PrepareResult([_spec(x.shape, x.dtype)])

    @staticmethod
    def eval(ctx, op, inputs):
        return [inputs[0]]


@register_op(OpCode.DROPOUT)
class Dropout(Identity):
    """Training-only op; the exporter strips it (§3.3).  If a model reaches
    the interpreter with DROPOUT intact, inference-mode semantics apply
    (identity)."""


@register_op(OpCode.QUANTIZE)
class QuantizeOp:
    """float32 -> int8 affine quantization to the output tensor's (scale,
    zero_point), baked at prepare time.
    """

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        oq = ctx.quant(op.outputs[0])
        return PrepareResult([_spec(x.shape, "int8")],
                             op_data={"oq": (oq.scale, oq.zero_point)})

    @staticmethod
    def eval(ctx, op, inputs):
        (x,) = inputs
        (s, z) = ctx.op_data["oq"]
        q = torch.round(x / s) + z
        return [q.clamp(Q.INT8_MIN, Q.INT8_MAX).to(torch.int8)]


@register_op(OpCode.DEQUANTIZE)
class DequantizeOp:
    """int8 -> float32 affine dequantization from the input tensor's
    (scale, zero_point), baked at prepare time.
    """

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        xq = ctx.quant(op.inputs[0])
        return PrepareResult([_spec(x.shape, "float32")],
                             op_data={"xq": (xq.scale, xq.zero_point)})

    @staticmethod
    def eval(ctx, op, inputs):
        (x,) = inputs
        (s, z) = ctx.op_data["xq"]
        return [(x.to(torch.float32) - z) * s]


# ---------------------------------------------------------------------------
# SVDF (the Google Hotword workhorse op)
# ---------------------------------------------------------------------------

@register_op(OpCode.SVDF)
class SVDF:
    """TFLite SVDF: rank-factored time-convolutional layer.

    inputs: x (B, F), w_feature (NF, F), w_time (NF, T), bias (U,) or -1,
            state variable (B, NF*T)
    params: rank; units = NF // rank; activation.
    """

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        wf = ctx.tensor_spec(op.inputs[1])
        wt = ctx.tensor_spec(op.inputs[2])
        rank = op.params.get("rank", 1)
        nf, f = wf.shape
        _, t = wt.shape
        units = nf // rank
        if x.shape[-1] != f:
            raise ValueError(f"SVDF features {x.shape[-1]} != {f}")
        out_spec = _spec((x.shape[0], units), x.dtype)
        return PrepareResult(
            [out_spec],
            op_data={"rank": rank, "units": units, "nf": nf, "t": t},
            variable_updates=[op.inputs[4]])

    @staticmethod
    def eval(ctx, op, inputs):
        x, wf, wt, bias, state = inputs
        d = ctx.op_data
        b = x.shape[0]
        nf, t, rank, units = d["nf"], d["t"], d["rank"], d["units"]
        st = state.reshape(b, nf, t)
        feat = x @ wf.T                         # (B, NF)
        st = torch.cat([st[:, :, 1:], feat[:, :, None]], dim=2)
        out = torch.einsum("bnt,nt->bn", st, wt)
        out = out.reshape(b, units, rank).sum(dim=2)
        if bias is not None:
            out = out + bias
        out = _apply_activation_f32(out, op.params.get("activation", "relu"))
        return [out, st.reshape(b, nf * t)]


# ---------------------------------------------------------------------------
# transformer micro-path ops
# ---------------------------------------------------------------------------

@register_op(OpCode.MATMUL)
class MatMul:
    """General (optionally batched) matmul with broadcastable batch dims
    and a transpose_b flag — the pod-model building block.
    """

    @staticmethod
    def prepare(ctx, op):
        a = ctx.tensor_spec(op.inputs[0])
        b = ctx.tensor_spec(op.inputs[1])
        tb = op.params.get("transpose_b", False)
        n = b.shape[-2] if tb else b.shape[-1]
        k_b = b.shape[-1] if tb else b.shape[-2]
        if a.shape[-1] != k_b:
            raise ValueError(f"matmul mismatch {a.shape} x {b.shape}")
        if len(b.shape) == 2:
            shape = a.shape[:-1] + (n,)
        else:
            batch = np.broadcast_shapes(tuple(a.shape[:-2]),
                                        tuple(b.shape[:-2]))
            shape = tuple(batch) + (a.shape[-2], n)
        return PrepareResult([_spec(shape, a.dtype)])

    @staticmethod
    def eval(ctx, op, inputs):
        a, b = inputs
        if op.params.get("transpose_b", False):
            b = b.transpose(-1, -2)
        return [torch.matmul(a, b)]


@register_op(OpCode.BATCH_MATMUL)
class BatchMatMul(MatMul):
    """Alias of MatMul: explicitly batched contraction, same prepare/eval."""


@register_op(OpCode.RMS_NORM)
class RMSNorm:
    """Root-mean-square normalization with learned gain, computed in
    float32 and cast back.
    """

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        return PrepareResult([_spec(x.shape, x.dtype)])

    @staticmethod
    def eval(ctx, op, inputs):
        x, gamma = inputs
        eps = op.params.get("eps", 1e-6)
        ms = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + eps).to(x.dtype)
        return [y * gamma]


@register_op(OpCode.LAYER_NORM)
class LayerNorm:
    """Layer normalization with learned gain and bias, computed in
    float32 and cast back.
    """

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])
        return PrepareResult([_spec(x.shape, x.dtype)])

    @staticmethod
    def eval(ctx, op, inputs):
        x, gamma, beta = inputs
        eps = op.params.get("eps", 1e-5)
        xf = x.to(torch.float32)
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
        return [y * gamma + beta]


@register_op(OpCode.ROPE)
class RoPE:
    """Rotary position embedding over (B, S, H, D) activations, positions
    0..S-1, the rotated halves concatenated."""

    @staticmethod
    def prepare(ctx, op):
        x = ctx.tensor_spec(op.inputs[0])        # (B, S, H, D)
        return PrepareResult([_spec(x.shape, x.dtype)])

    @staticmethod
    def eval(ctx, op, inputs):
        (x,) = inputs
        base = op.params.get("base", 10000.0)
        b, s, h, dim = x.shape
        half = dim // 2
        pos = torch.arange(s, dtype=torch.float32, device=x.device)[:, None]
        inv = base ** (-torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
        ang = pos * inv                            # (S, half)
        cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
        sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
        x1, x2 = x[..., :half], x[..., half:]
        return [torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1)]



@register_op(OpCode.ATTENTION)
class Attention:
    """Fused SDPA for the micro path: q,k,v (B, H, S, D) -> (B, H, S, D)."""

    @staticmethod
    def prepare(ctx, op):
        q = ctx.tensor_spec(op.inputs[0])
        return PrepareResult([_spec(q.shape, q.dtype)],
                             scratch_nbytes=[q.shape[1] * q.shape[2] ** 2 * 4])

    @staticmethod
    def eval(ctx, op, inputs):
        q, k, v = inputs
        scale = 1.0 / math.sqrt(q.shape[-1])
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        if op.params.get("causal", True):
            s = q.shape[2]
            mask = torch.ones((s, s), dtype=torch.bool,
                              device=q.device).tril()
            logits = logits.masked_fill(~mask, -1e30)
        w = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
        return [torch.einsum("bhqk,bhkd->bhqd", w, v)]


@register_op(OpCode.EMBEDDING_LOOKUP)
class EmbeddingLookup:
    """Row gather from an embedding table: (ids) -> (ids.shape, d_model).

    Ids follow the reference's ``jnp.take``: -V <= id < 0 counts from
    the end, and any other id out of range gives a row of the fill value
    (NaN for a float table, the type's least value for a signed one, its
    greatest for an unsigned one) instead of an error, so the op never
    faults on the card."""

    @staticmethod
    def prepare(ctx, op):
        ids = ctx.tensor_spec(op.inputs[0])
        table = ctx.tensor_spec(op.inputs[1])
        return PrepareResult([_spec(ids.shape + (table.shape[1],),
                                    table.dtype)])

    @staticmethod
    def eval(ctx, op, inputs):
        ids, table = inputs
        v = table.shape[0]
        ids = ids.to(torch.int64)
        valid = (ids >= -v) & (ids < v)
        rows = torch.where(ids < 0, ids + v, ids).clamp(0, v - 1)
        out = table.index_select(0, rows.reshape(-1)).reshape(
            *ids.shape, table.shape[1])
        if table.dtype.is_floating_point:
            fill = math.nan
        else:
            info = torch.iinfo(table.dtype)
            fill = info.min if table.dtype.is_signed else info.max
        return [torch.where(valid[..., None], out, fill)]
