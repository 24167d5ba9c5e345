"""Reference kernels (paper §4.7 — "simple operator-kernel implementations
designed for readability rather than performance"), in plain PyTorch.

The eleven ops the §5 models and the micro ATTENTION graph reach, each a
(prepare, eval) pair registered under the ``"reference"`` tag with the
same contract as ``repro.core.micro_ops``: ``prepare`` runs once at init
(shapes, output specs, requant constants, scratch and persistent byte
counts identical to the JAX package, so arena sizes match exactly);
``eval`` runs inside invoke on the interpreter's device.

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
# pooling / shape / reduction
# ---------------------------------------------------------------------------

@register_op(OpCode.MAX_POOL_2D)
class MaxPool2D:
    """Max pooling over NHWC windows; int8-safe (padding is the int8
    minimum, comparisons are exact).
    """

    @staticmethod
    def prepare(ctx, op):
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

    @staticmethod
    def eval(ctx, op, inputs):
        (x,) = inputs
        (kh, kw), (sh, sw) = ctx.op_data["k"], ctx.op_data["s"]
        top, bottom, left, right = ctx.op_data["pad"]
        if top or bottom or left or right:
            init = Q.INT8_MIN if x.dtype == torch.int8 else -math.inf
            x = F.pad(x, (0, 0, left, right, top, bottom), value=init)
        windows = x.unfold(1, kh, sh).unfold(2, kw, sw)   # N,OH,OW,C,kh,kw
        return [windows.amax(dim=(-2, -1))]


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
# ATTENTION (micro-path transformer demo)
# ---------------------------------------------------------------------------

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
