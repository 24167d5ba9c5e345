"""K1 — the int8 matmul CUDA kernel (the CMSIS-NN analogue, §4.7–4.8).

Replaces the Pallas TPU kernel ``quant_matmul_pallas``
(``src/repro/kernels/quant_matmul.py``): int8 (M,K) x int8 (K,N) with
int32 accumulation, zero-point correction from precomputed column sums
(``acc - x_zp * wsum + bias``), per-channel float32 scale, round half to
even, ``+ out_zp``, clamp to int8 — bit for bit.

Bound on the H100: at the interpreter's shapes (M = 1, K and N of a few
hundred) launch latency and the loads after it; at large shapes
``max(bytes / 3.35 TB/s, 2MNK / 1979 TOPS)``.  ``path`` picks one of the
kernel's (``csrc/quant_matmul.cu``) two paths: for M <= 16 with K
contiguous in the weight (the FC layer's (N,K) weight as a transposed
view) the rows path — one warp a column with 16-byte loads and
``__dp4a``, no shared tiles and no barrier per K step — and otherwise one
block per 64x64 output tile with shared-memory K tiles.  Both mask ragged
edges themselves, so no padded copies are made, and read the weight
through its strides.

``launches`` counts the kernel launches of this process; only
``quant_matmul_cuda`` adds to it, and a CUDA-graph replay
adds the launches its capture recorded (``_build.launches``).  The plain
version is
``repro_torch.kernels.ref.quant_matmul_ref``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

# the kernel's paths, by the code its C entry takes
PATHS = {"tiles": 0, "rows": 1}
ROW_M = 16                 # the rows path's largest M

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("quant_matmul")
    lib.quant_matmul_launch.argtypes = _ARGTYPES
    lib.quant_matmul_launch.restype = ctypes.c_int
    lib.quant_matmul_attributes.argtypes = (
        [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.quant_matmul_attributes.restype = ctypes.c_int
    return lib


def path(m: int, k: int, w_strides) -> str:
    """The kernel path for x (m, k) and a weight of these (k, n) strides:
    ``"rows"`` for m <= 16 with K contiguous in the weight, else
    ``"tiles"``."""
    return "rows" if m <= ROW_M and w_strides[0] == 1 else "tiles"


def kernel_attributes(name: str):
    """(registers a thread, static shared-memory bytes a block) of one
    path's kernel (needs a card)."""
    regs, smem = ctypes.c_int(), ctypes.c_int()
    rc = _lib().quant_matmul_attributes(PATHS[name], ctypes.byref(regs),
                                        ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"quant_matmul attributes: CUDA error {rc}")
    return regs.value, smem.value


def _check(name, t, dtype, ndim, device, contiguous=True):
    if t.device != device or t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"quant_matmul: {name} must be a {ndim}-D {dtype} "
                         f"tensor on {device}, got {t.dim()}-D {t.dtype} "
                         f"on {t.device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"quant_matmul: {name} must be contiguous")


def quant_matmul_cuda(x_q: torch.Tensor, w_q: torch.Tensor,
                      bias_q: torch.Tensor, wsum: torch.Tensor,
                      scale: torch.Tensor, *, x_zp: int,
                      out_zp: int) -> torch.Tensor:
    """x_q (M,K) int8 · w_q (K,N) int8 → int8 (M,N) on the card.

    bias_q and wsum (= Σ_k w_q) are (N,) int32, scale (N,) float32; w_q
    may be any strided view.  Raises on anything the kernel does not take,
    and when the launch fails."""
    out, launched = _quant_matmul(x_q, w_q, bias_q, wsum, scale, x_zp,
                                  out_zp)
    _build.launches["quant_matmul"] += launched
    return out


def _quant_matmul(x_q, w_q, bias_q, wsum, scale, x_zp: int, out_zp: int,
                  kernel_path: Optional[str] = None):
    """(out, whether the kernel launched) of ``quant_matmul_cuda``, on
    ``kernel_path`` (by default ``path``'s choice) and left out of
    ``launches``: ``chip_smoke.py`` and the card tests check and time the
    tiled path at M <= 16 through it."""
    if x_q.device.type != "cuda":
        raise ValueError(f"quant_matmul_cuda needs CUDA tensors, got "
                         f"{x_q.device}")
    dev = x_q.device
    _check("x_q", x_q, torch.int8, 2, dev)
    _check("w_q", w_q, torch.int8, 2, dev, contiguous=False)
    m, k = x_q.shape
    k2, n = w_q.shape
    if k2 != k:
        raise ValueError(f"quant_matmul: {tuple(x_q.shape)} @ "
                         f"{tuple(w_q.shape)}")
    for name, t, dt in (("bias_q", bias_q, torch.int32),
                        ("wsum", wsum, torch.int32),
                        ("scale", scale, torch.float32)):
        _check(name, t, dt, 1, dev)
        if t.shape[0] != n:
            raise ValueError(f"quant_matmul: {name} has {t.shape[0]} "
                             f"entries for N={n}")
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    if m == 0 or n == 0:
        return out, False
    with torch.cuda.device(dev):
        rc = _lib().quant_matmul_launch(
            x_q.data_ptr(), w_q.data_ptr(), bias_q.data_ptr(),
            wsum.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k, n,
            w_q.stride(0), w_q.stride(1), int(x_zp), int(out_zp),
            PATHS[kernel_path or path(m, k, w_q.stride())],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    return out, True


def __getattr__(attr: str) -> int:     # ``launches``, in ``_build``
    return _build.count_of(__name__, attr)
