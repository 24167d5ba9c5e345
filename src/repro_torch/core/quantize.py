"""INT8 quantization, bit-faithful to TFLite / TF Micro (paper §3.3).

Scheme (Krishnamoorthi 2018, as adopted by TFLite):

* activations: asymmetric per-tensor int8, real = scale * (q - zero_point)
* weights:     symmetric per-channel int8 (zero_point == 0)
* bias:        int32 with scale = input_scale * weight_scale
* requantization of int32 accumulators back to int8 uses a fixed-point
  multiplier: the real multiplier M = s_in * s_w / s_out is decomposed as
  M = M0 * 2^shift with M0 in [0.5, 1) stored as a Q31 int32, applied with
  gemmlowp's SaturatingRoundingDoublingHighMul + rounding right shift.

The micro subset of ``repro.core.quantize`` plus its serving half
(packed int4 weights, the per-head int8 KV cache): the numpy twins run
at export time, and the torch twins run inside invoke on any device.  Torch
has int64 everywhere, so the 64-bit product needs no scoped mode; the
int32 steps are cast explicitly so wrap-around matches the int32 math of
the reference bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np
import torch

INT8_MIN, INT8_MAX = -128, 127
INT4_MIN, INT4_MAX = -8, 7
INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1


# ---------------------------------------------------------------------------
# Scale / zero-point selection
# ---------------------------------------------------------------------------

def choose_quant_params(rmin: float, rmax: float,
                        narrow_range: bool = False) -> Tuple[float, int]:
    """Asymmetric int8 params covering [rmin, rmax] (must straddle 0)."""
    rmin, rmax = float(min(rmin, 0.0)), float(max(rmax, 0.0))
    qmin = INT8_MIN + (1 if narrow_range else 0)
    qmax = INT8_MAX
    if rmax == rmin:
        return 1.0, 0
    scale = (rmax - rmin) / (qmax - qmin)
    zp_real = qmin - rmin / scale
    zero_point = int(np.clip(round(zp_real), qmin, qmax))
    return scale, zero_point


def quantize_array(data: np.ndarray, scale: float, zero_point: int,
                   dtype=np.int8) -> np.ndarray:
    q = np.round(data / scale) + zero_point
    info = np.iinfo(dtype)
    return np.clip(q, info.min, info.max).astype(dtype)


def quantize_weights_per_channel(
        w: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 weights; returns (q, scales[C])."""
    moved = np.moveaxis(w, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    amax = np.max(np.abs(flat), axis=1)
    scales = np.where(amax > 0, amax / INT8_MAX, 1.0).astype(np.float32)
    q = np.clip(np.round(flat / scales[:, None]), INT8_MIN, INT8_MAX)
    q = q.astype(np.int8).reshape(moved.shape)
    return np.moveaxis(q, 0, axis), scales


def quantize_bias(b: np.ndarray, input_scale: float,
                  weight_scales: np.ndarray) -> np.ndarray:
    s = np.asarray(input_scale, np.float64) * np.asarray(weight_scales,
                                                         np.float64)
    q = np.round(b.astype(np.float64) / s)
    return np.clip(q, INT32_MIN, INT32_MAX).astype(np.int32)


# ---------------------------------------------------------------------------
# Fixed-point requantization (gemmlowp semantics, as in TFLM)
# ---------------------------------------------------------------------------

def quantize_multiplier(real_multiplier: float) -> Tuple[int, int]:
    """Decompose M = M0 * 2^shift, M0 Q31 in [2^30, 2^31)."""
    if real_multiplier == 0.0:
        return 0, 0
    if real_multiplier < 0:
        raise ValueError("negative requant multiplier")
    m, shift = math.frexp(real_multiplier)     # m in [0.5, 1)
    q = int(round(m * (1 << 31)))
    if q == (1 << 31):                          # rounding overflow
        q //= 2
        shift += 1
    if shift < -31:                             # underflow to zero
        return 0, 0
    if shift > 30:
        raise ValueError(f"requant multiplier too large: {real_multiplier}")
    return q, shift


def _srdhm_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """SaturatingRoundingDoublingHighMul, numpy int64 emulation."""
    a = a.astype(np.int64)
    b = np.asarray(b, np.int64)
    overflow = np.logical_and(a == INT32_MIN, b == INT32_MIN)
    ab = a * b
    nudge = np.where(ab >= 0, (1 << 30), 1 - (1 << 30))
    q = ab + nudge
    # gemmlowp divides by 2^31 with C++ semantics (truncation toward
    # zero); an arithmetic shift would floor
    result = np.sign(q) * (np.abs(q) >> 31)
    return np.where(overflow, INT32_MAX, result).astype(np.int32)


def _rdpot_np(x: np.ndarray, exponent: np.ndarray) -> np.ndarray:
    """RoundingDivideByPOT (round-half-away-from-zero), numpy."""
    x = x.astype(np.int64)
    exponent = np.asarray(exponent, np.int64)
    mask = (np.int64(1) << exponent) - 1
    remainder = x & mask
    threshold = (mask >> 1) + np.where(x < 0, 1, 0)
    return ((x >> exponent) + np.where(remainder > threshold, 1, 0)
            ).astype(np.int32)


def multiply_by_quantized_multiplier_np(x: np.ndarray, multiplier,
                                        shift) -> np.ndarray:
    """TFLM MultiplyByQuantizedMultiplier: x * M0 * 2^shift (numpy).

    ``multiplier``/``shift`` may be scalars or per-channel arrays that
    broadcast against ``x``.  The left shift happens in int32 (C wrapping
    semantics), exactly like the TFLM reference kernels.
    """
    shift = np.asarray(shift, np.int64)
    left = np.maximum(shift, 0)
    right = np.maximum(-shift, 0)
    xl = (x.astype(np.int64) << left).astype(np.int32)
    return _rdpot_np(_srdhm_np(xl, np.asarray(multiplier, np.int32)), right)


def requantize_np(acc: np.ndarray, multiplier: int, shift: int,
                  output_zero_point: int) -> np.ndarray:
    scaled = multiply_by_quantized_multiplier_np(acc, multiplier, shift)
    return np.clip(scaled + output_zero_point, INT8_MIN, INT8_MAX
                   ).astype(np.int8)


def _srdhm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ab = a.to(torch.int64) * b.to(torch.int64)
    q = ab + torch.where(ab >= 0, 1 << 30, 1 - (1 << 30))
    # truncate toward zero (gemmlowp C++ division), not floor
    result = torch.sign(q) * (q.abs() >> 31)
    overflow = (a == INT32_MIN) & (b == INT32_MIN)
    return torch.where(overflow, INT32_MAX, result).to(torch.int32)


def _rdpot(x: torch.Tensor, exponent: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64)
    mask = (1 << exponent) - 1
    remainder = x & mask
    threshold = (mask >> 1) + (x < 0).to(torch.int64)
    return ((x >> exponent) + (remainder > threshold).to(torch.int64)
            ).to(torch.int32)


def multiply_by_quantized_multiplier(x: torch.Tensor, multiplier,
                                     shift) -> torch.Tensor:
    """torch twin of the fixed-point requant, bit-identical to the numpy
    twin.  ``multiplier``/``shift`` broadcast (scalar per-tensor or [C]
    per-channel); pass them as tensors on ``x``'s device to avoid a copy
    per call."""
    multiplier = torch.as_tensor(multiplier, dtype=torch.int32,
                                 device=x.device)
    shift = torch.as_tensor(shift, dtype=torch.int64, device=x.device)
    left = shift.clamp(min=0)
    right = (-shift).clamp(min=0)
    xl = (x.to(torch.int64) << left).to(torch.int32)
    return _rdpot(_srdhm(xl, multiplier), right)


def requantize(acc: torch.Tensor, multiplier, shift, output_zero_point: int,
               qmin: int = INT8_MIN, qmax: int = INT8_MAX) -> torch.Tensor:
    """int32 accumulator -> int8 output, TFLM semantics (torch)."""
    scaled = multiply_by_quantized_multiplier(acc, multiplier, shift)
    out = scaled + output_zero_point          # int32, wraps like the C code
    return out.clamp(qmin, qmax).to(torch.int8)


# ---------------------------------------------------------------------------
# Packed int4 (two nibbles per int8 byte, packed along the LAST axis)
# ---------------------------------------------------------------------------

def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack signed int4 values (range [-8, 7], held in int8) two per byte
    along the LAST axis: ``byte = (hi << 4) | (lo & 0xF)`` with
    ``lo = q[..., 2i]`` and ``hi = q[..., 2i+1]``.  The last axis must
    be even."""
    q = q.to(torch.int8)
    if q.shape[-1] % 2:
        raise ValueError(
            f"pack_int4 needs an even last axis, got {tuple(q.shape)}")
    return (q[..., 1::2] << 4) | (q[..., 0::2] & 0xF)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: bytes back to signed int4 values (as
    int8), doubling the last axis.  Sign extension is arithmetic in int8:
    ``(b << 4) >> 4`` is the low nibble, ``b >> 4`` the high."""
    b = packed.to(torch.int8)
    out = torch.stack([(b << 4) >> 4, b >> 4], dim=-1)
    return out.reshape(*b.shape[:-1], b.shape[-1] * 2)


def pack_int4_np(q: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`pack_int4` (export-time use)."""
    q = np.asarray(q, np.int8)
    if q.shape[-1] % 2:
        raise ValueError(
            f"pack_int4 needs an even last axis, got {q.shape}")
    return ((q[..., 1::2] << 4) | (q[..., 0::2] & np.int8(0xF))).astype(
        np.int8)


def unpack_int4_np(packed: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`unpack_int4`."""
    b = np.asarray(packed, np.int8)
    out = np.stack([((b << 4) >> 4).astype(np.int8),
                    (b >> 4).astype(np.int8)], axis=-1)
    return out.reshape(*b.shape[:-1], b.shape[-1] * 2)


# ---------------------------------------------------------------------------
# Symmetric per-head KV quantization (the serving KV cache)
# ---------------------------------------------------------------------------

def quantize_kv_heads(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one float32 scale per head vector
    (the LAST axis): ``scale = amax / 127`` (1.0 for an all-zero vector,
    so it dequantizes exactly), ``q = round(x / scale)`` half to even,
    all in float32 as the JAX package computes it.  Returns ``(q int8,
    scales f32)`` with ``scales.shape == x.shape[:-1]``."""
    x = x.float()
    amax = x.abs().amax(dim=-1)
    scales = torch.where(amax > 0, amax / INT8_MAX, 1.0)
    q = torch.round(x / scales[..., None]).clamp(INT8_MIN, INT8_MAX)
    return q.to(torch.int8), scales


def dequantize_kv_heads(q: torch.Tensor, scales: torch.Tensor
                        ) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_heads` (up to rounding), float32."""
    return q.float() * scales[..., None].float()


# ---------------------------------------------------------------------------
# Convenience record used by op prepare() functions
# ---------------------------------------------------------------------------

@dataclass
class RequantSpec:
    """Precomputed per-op requantization constants (persistent-arena data
    in TFLM: computed once at prepare time, paper §4.1)."""
    multiplier: np.ndarray      # int32, scalar or per-channel [C]
    shift: np.ndarray           # int32, scalar or per-channel [C]
    input_zero_point: int
    output_zero_point: int
    input_scale: float
    output_scale: float

    @staticmethod
    def build(input_scale: float, weight_scales: Union[float, np.ndarray],
              output_scale: float, input_zp: int, output_zp: int
              ) -> "RequantSpec":
        ws = np.atleast_1d(np.asarray(weight_scales, np.float64))
        mults, shifts = [], []
        for s in ws:
            m, sh = quantize_multiplier(float(input_scale) * float(s)
                                        / float(output_scale))
            mults.append(m)
            shifts.append(sh)
        return RequantSpec(
            multiplier=np.asarray(mults, np.int32),
            shift=np.asarray(shifts, np.int32),
            input_zero_point=int(input_zp),
            output_zero_point=int(output_zp),
            input_scale=float(input_scale),
            output_scale=float(output_scale),
        )

    def nbytes(self) -> int:
        return int(self.multiplier.nbytes + self.shift.nbytes + 16)

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(multiplier, shift) as tensors on ``device``, made once at
        prepare time so invoke copies nothing from the host."""
        return (torch.as_tensor(self.multiplier, dtype=torch.int32,
                                device=device),
                torch.as_tensor(self.shift, dtype=torch.int64,
                                device=device))
