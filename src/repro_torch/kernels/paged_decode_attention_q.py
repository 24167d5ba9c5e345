"""K7 — the paged decode-attention CUDA kernel over an int8 KV cache.

Replaces the Pallas TPU kernel ``paged_decode_attention_q_pallas``
(``src/repro/kernels/decode_attention.py``): K4 with int8 pools k, v
(P,KH,BS,D) and one float32 scale per row, k_scales and v_scales
(P,KH,BS).  Each cache element is dequantized inside the kernel as
``float(q8) · s`` where the arithmetic reads it; the float math after
that is K4's step for step (``csrc/decode_attention.cuh``), so on the
float32 pools that hold ``float(q8) · s`` K7 gives K4's values bit for
bit.
q is float32 or bfloat16 and the output has q's type; D <= 128; BS
divides 32 or is a multiple of it.

Bound on the H100: the bytes of the valid K/V rows and their scales,
D + 4 bytes per row and head, half K4's on a bfloat16 pool (about
1.13 µs at Yi-6B's path shape with lengths 1/37/1500/2048, against
K4's 2.21).  One launch, with K3's arrival counters.

``launches`` counts the calls of this process that launched the kernel;
only ``paged_decode_attention_q_cuda`` adds to it, and a CUDA-graph replay
adds the launches its capture recorded (``_build.launches``).  The plain
version is
``repro_torch.kernels.ref.paged_decode_attention_q_ref``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build
from .decode_attention import arrival_counters
from .paged_decode_attention import MAX_D, check_block_size


_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
             + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("paged_decode_attention_q")
    lib.paged_decode_attention_q_launch.argtypes = _ARGTYPES
    lib.paged_decode_attention_q_launch.restype = ctypes.c_int
    lib.paged_decode_attention_q_workspace_floats.argtypes = \
        [ctypes.c_int] * 4
    lib.paged_decode_attention_q_workspace_floats.restype = ctypes.c_longlong
    return lib


def paged_decode_attention_q_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  k_scales: torch.Tensor,
                                  v_scales: torch.Tensor,
                                  tables: torch.Tensor, lengths: torch.Tensor,
                                  *, window: Optional[int] = None,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """q (B,H,D), int8 pools (P,KH,BS,D), float32 scales (P,KH,BS),
    tables (B,T) int32, lengths (B,) int32 -> (B,H,D) in q's dtype on the
    card.  Raises on anything the kernel does not take, and when the
    launch fails.  Table entries are not range-checked (that would read
    them on the host): the caller keeps every entry a row can reach
    below P."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_q_cuda needs CUDA tensors, "
                         f"got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_decode_attention_q: dtype {q.dtype} is not "
                         f"float32 or bfloat16")
    if q.dim() != 3:
        raise ValueError(f"paged_decode_attention_q: q must be (B,H,D), got "
                         f"{tuple(q.shape)}")
    for name, t, dt, nd in (("k_pool", k_pool, torch.int8, 4),
                            ("v_pool", v_pool, torch.int8, 4),
                            ("k_scales", k_scales, torch.float32, 3),
                            ("v_scales", v_scales, torch.float32, 3)):
        if t.device != q.device or t.dtype != dt or t.dim() != nd:
            raise ValueError(f"paged_decode_attention_q: {name} must be a "
                             f"{nd}-D {dt} tensor on {q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("k_scales", k_scales), ("v_scales", v_scales),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention_q: {name} must be "
                             f"contiguous")
    b, h, d = q.shape
    p, kh, bs = k_pool.shape[:3]
    if (tuple(k_pool.shape) != (p, kh, bs, d)
            or tuple(v_pool.shape) != tuple(k_pool.shape)
            or tuple(k_scales.shape) != (p, kh, bs)
            or tuple(v_scales.shape) != (p, kh, bs)
            or kh < 1 or h % kh or p < 1):
        raise ValueError(f"paged_decode_attention_q: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}, scales "
                         f"{tuple(k_scales.shape)}, {tuple(v_scales.shape)} "
                         f"do not form (B,H,D), (P,KH,BS,D), (P,KH,BS) with "
                         f"H % KH == 0")
    check_block_size(bs)
    for name, t, nd in (("tables", tables, 2), ("lengths", lengths, 1)):
        if (t.device != q.device or t.dtype != torch.int32 or t.dim() != nd
                or t.shape[0] != b):
            raise ValueError(f"paged_decode_attention_q: {name} must be "
                             f"{'(B,T)' if nd == 2 else '(B,)'} int32 on "
                             f"{q.device} with B = {b}")
    t_len = tables.shape[1]
    if t_len < 1:
        raise ValueError("paged_decode_attention_q: tables has no entries")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"paged_decode_attention_q: head dim {d} not in "
                         f"1..{MAX_D}")
    if window is not None and not -2 ** 31 < window < 2 ** 31:
        raise ValueError(f"paged_decode_attention_q: window {window} out of "
                         f"range")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if b == 0 or h == 0:
        return out
    lib = _lib()
    ws = torch.empty(lib.paged_decode_attention_q_workspace_floats(
        b, h, t_len * bs, d), dtype=torch.float32, device=q.device)
    counters = arrival_counters(q.device, b * kh)
    with torch.cuda.device(q.device):
        rc = lib.paged_decode_attention_q_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), b, h, kh, t_len, bs, d, float(scale),
            int(window is not None), int(window or 0),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention_q kernel launch failed: "
                           f"CUDA error {rc}")
    _build.launches["paged_decode_attention_q"] += 1
    return out


def __getattr__(attr: str) -> int:     # ``launches``, in ``_build``
    return _build.count_of(__name__, attr)
