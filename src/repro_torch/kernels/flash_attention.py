"""K2 — the flash-attention CUDA kernel (prefill; causal, GQA, window).

Replaces the Pallas TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py``): online-softmax attention over
q (B,H,S,D) and k, v (B,KH,S,D), causal mask, optional sliding window
(key j valid for query i when ``j > i - window``), GQA through the head
index ``h // (H // KH)`` with no repeated K/V, and 0 for a row with no
valid key.  float32 or bfloat16 in, float32 math, the input's type out.

Bound on the H100: ``4·B·H·S²·D`` operations (about half under the
causal mask) against reading q, k, v and writing o once; at the micro
path's float32 (2,4,256,64), causal, the FMAs on the CUDA cores bound it
(about 1 µs).  The kernel (``csrc/flash_attention.cu``) gives one
512-thread block to each (16-row q tile, h, b), 128 blocks at that shape;
K/V tiles of 64 rows arrive by ``cp.async`` into a ring of two stages, the
next tile's copy overlapping this tile's arithmetic; scores are computed
a key a lane against two q rows, P·V as four-row by four-column register
tiles in eight key groups added in order at the end; the mask is applied
only on tiles that cross it, and tiles it empties are never loaded.  It
takes any S and D <= 128.

``launches`` counts the kernel launches of this process; only
``flash_attention_cuda`` adds to it, and a CUDA-graph replay
adds the launches its capture recorded (``_build.launches``).  The plain
version is
``repro_torch.kernels.ref.mha_ref``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

MAX_D = 128

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = _ARGTYPES
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_attributes.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.flash_attention_attributes.restype = ctypes.c_int
    return lib


def kernel_attributes(dtype: torch.dtype, d: int):
    """(registers a thread, shared-memory bytes a block) of the kernel
    instantiated for ``dtype`` at head dim ``d`` (needs a card)."""
    regs, smem = ctypes.c_int(), ctypes.c_int()
    rc = _lib().flash_attention_attributes(
        int(dtype == torch.bfloat16), d, ctypes.byref(regs),
        ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"flash_attention attributes: CUDA error {rc}")
    return regs.value, smem.value


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,S,D), k/v (B,KH,S,D) -> (B,H,S,D) on the card.  Raises on
    anything the kernel does not take, and when the launch fails."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: dtype {q.dtype} is not float32 "
                         f"or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be a 4-D "
                             f"{q.dtype} tensor on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    b, h, s, d = q.shape
    kh = k.shape[1]
    if (tuple(k.shape) != (b, kh, s, d) or tuple(v.shape) != tuple(k.shape)
            or kh < 1 or h % kh):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"form (B,H,S,D), (B,KH,S,D) with H % KH == 0")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"flash_attention: head dim {d} not in 1..{MAX_D}")
    if window is not None and not -2 ** 31 < window < 2 ** 31:
        raise ValueError(f"flash_attention: window {window} out of range")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kh, s, d, float(scale), int(causal),
            int(window is not None), int(window or 0),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    _build.launches["flash_attention"] += 1
    return out


def __getattr__(attr: str) -> int:     # ``launches``, in ``_build``
    return _build.count_of(__name__, attr)
