"""K8 — the Mamba-2 SSD chunked-scan CUDA kernel.

Replaces the Pallas TPU kernel ``ssd_scan_pallas``
(``src/repro/kernels/ssd_scan.py``): x (B,S,H,P), dt (B,S,H), A (H,), B
and C (B,S,G,N), D (H,) or None, and — beyond the Pallas kernel, as
``ssd_ref`` takes it — an initial state ``h0`` (B,H,P,N) or None (zeros).
Returns y (B,S,H,P) in x's dtype and the final state (B,H,P,N) in
float32.  x, B and C are float32 or bfloat16 (one dtype), the rest
float32; S must be a multiple of ``chunk`` (at most 128), N at most 128.

Bound on the H100: operations.  At Mamba2-780m's one-shot prefill of 512
tokens the least work is about 1.0 GFLOP of float32 (15 µs at 67
TFLOP/s) against 8.2 MB of bytes (2.4 µs).  The kernel
(``csrc/ssd_scan.cu``) runs one block of 16 warps per (b, h, 32 state
rows), loops over the chunks in order with its slice of the state in
shared memory, and does its products as float32 FMAs on the CUDA
cores.

``launches`` counts the calls of this process that launched the kernel;
only ``ssd_scan_cuda`` adds to it.  The plain version is
``repro_torch.kernels.ref.ssd_scan_ref``; only ``kernels.ops`` calls
this wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

launches = 0
MAX_CHUNK = 128
MAX_STATE = 128

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = _ARGTYPES
    lib.ssd_scan_launch.restype = ctypes.c_int
    return lib


def check_chunk(chunk: int) -> None:
    """The chunk lengths the kernel takes; refused on either device so
    the two agree on what they accept."""
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} not in 1..{MAX_CHUNK}")


def _f32(name: str, t: Optional[torch.Tensor], shape, device) -> None:
    if t is None:
        return
    if (t.device != device or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"ssd_scan: {name} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor,
                  D: Optional[torch.Tensor] = None, *, chunk: int,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B,S,H,P), state (B,H,P,N)) on the card.  Raises on anything the
    kernel does not take, and when the launch fails."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssd_scan: dtype {x.dtype} is not float32 or "
                         f"bfloat16")
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B,S,H,P) and B, C "
                         f"(B,S,G,N), got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.device != x.device or t.dtype != x.dtype \
                or not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous {x.dtype} "
                             f"on {x.device}")
    if tuple(B.shape[:2]) != (b, s) or tuple(C.shape) != tuple(B.shape) \
            or g < 1 or h % g:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, B {tuple(B.shape)},"
                         f" C {tuple(C.shape)} do not form (B,S,H,P), "
                         f"(B,S,G,N) with H % G == 0")
    _f32("dt", dt, (b, s, h), x.device)
    _f32("A", A, (h,), x.device)
    _f32("D", D, (h,), x.device)
    _f32("h0", h0, (b, h, p, n), x.device)
    check_chunk(chunk)
    if s % chunk:
        raise ValueError(f"ssd_scan: sequence {s} is not a multiple of the "
                         f"chunk {chunk}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan: state width {n} not in 1..{MAX_STATE}")
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:                  # no rows: the state is h0's
        if h0 is None:
            state.zero_()
        else:
            state.copy_(h0)
        return y, state
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        rc = _lib().ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), ptr(D), ptr(h0), y.data_ptr(), state.data_ptr(),
            b, s, h, p, g, n, chunk, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return y, state
