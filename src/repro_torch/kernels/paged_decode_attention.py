"""K4 — the paged decode-attention CUDA kernel (K3 through a block table).

Replaces the Pallas TPU kernel ``paged_decode_attention_pallas``
(``src/repro/kernels/decode_attention.py``): q (B,H,D) against the shared
physical block pools k, v (P,KH,BS,D), each sequence's blocks listed in
logical order in its row of ``tables`` (B,T) int32; ``lengths`` (B,)
int32 and ``tables`` are read on the device.  Logical position p lies in
block ``tables[b, p // BS]`` at row ``p % BS``; it is valid when
``p < lengths[b]`` (and ``p >= lengths[b] - window`` with a window).  A
row with no valid key outputs 0.  float32 or bfloat16 in, float32 math,
q's type out; D <= 128; BS divides 32 or is a multiple of 32.  With
``return_lse`` it also gives K3's log-sum-exp, and a rank of a
sequence-sharded pool runs it on its rows of every block: its pool of
block size BS/m, the same tables, and the count of its rows below each
length (``csrc/paged_decode_attention.cu``).

The kernel (``csrc/paged_decode_attention.cu``) is K3's code
(``csrc/decode_attention.cuh``) with the row address taken from the
table, so at the same valid rows its values are K3's bit for bit; the
grid depends only on (B, KH, T·BS/128), so a decode step never waits on
the host.  Bound on the H100: the bytes of the valid K/V rows, as K3.
One launch, with K3's arrival counters (``arrival_counters``).

``launches`` counts the calls of this process that launched the kernel;
only ``paged_decode_attention_cuda`` adds to it, and a CUDA-graph replay
adds the launches its capture recorded (``_build.launches``).  The plain
version is
``repro_torch.kernels.ref.paged_decode_attention_ref``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build
from .decode_attention import arrival_counters

MAX_D = 128
CHUNK = 32          # the kernel's K/V rows per pipeline stage

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p]
             + [ctypes.c_void_p])     # the stream, then lse (None: no lse)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("paged_decode_attention")
    lib.paged_decode_attention_launch.argtypes = _ARGTYPES
    lib.paged_decode_attention_launch.restype = ctypes.c_int
    lib.paged_decode_attention_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.paged_decode_attention_workspace_floats.restype = ctypes.c_longlong
    return lib


def check_block_size(bs: int) -> None:
    """Raise ``ValueError`` unless the kernel takes blocks of ``bs`` rows:
    a divisor of its 32-row tile or a multiple of it."""
    if bs < 1 or (CHUNK % bs and bs % CHUNK):
        raise ValueError(f"paged_decode_attention: block size {bs} neither "
                         f"divides {CHUNK} nor is a multiple of it")


def paged_decode_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, tables: torch.Tensor,
                                lengths: torch.Tensor, *,
                                window: Optional[int] = None,
                                scale: Optional[float] = None,
                                return_lse: bool = False):
    """q (B,H,D), pools (P,KH,BS,D), tables (B,T) int32, lengths (B,)
    int32 -> (B,H,D) on the card; with ``return_lse`` also the heads'
    log-sum-exp (B,H), as ``decode_attention_cuda``'s.  Raises on
    anything the kernel does not take, and when the launch fails.  Table
    entries are not range-checked (that would read them on the host):
    the caller keeps every entry a row can reach below P."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_cuda needs CUDA tensors, "
                         f"got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_decode_attention: dtype {q.dtype} is not "
                         f"float32 or bfloat16")
    if q.dim() != 3:
        raise ValueError(f"paged_decode_attention: q must be (B,H,D), got "
                         f"{tuple(q.shape)}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 4:
            raise ValueError(f"paged_decode_attention: {name} must be a 4-D "
                             f"{q.dtype} tensor on {q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"contiguous")
    b, h, d = q.shape
    p, kh, bs = k_pool.shape[:3]
    if (tuple(k_pool.shape) != (p, kh, bs, d)
            or tuple(v_pool.shape) != tuple(k_pool.shape)
            or kh < 1 or h % kh or p < 1):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)} do not "
                         f"form (B,H,D), (P,KH,BS,D) with H % KH == 0")
    check_block_size(bs)
    for name, t, shape in (("tables", tables, (b, -1)),
                           ("lengths", lengths, (b,))):
        if (t.device != q.device or t.dtype != torch.int32
                or t.dim() != len(shape) or t.shape[0] != b):
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"{'(B,T)' if len(shape) == 2 else '(B,)'} "
                             f"int32 on {q.device} with B = {b}")
    t_len = tables.shape[1]
    if t_len < 1:
        raise ValueError("paged_decode_attention: tables has no entries")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"paged_decode_attention: head dim {d} not in "
                         f"1..{MAX_D}")
    if window is not None and not -2 ** 31 < window < 2 ** 31:
        raise ValueError(f"paged_decode_attention: window {window} out of "
                         f"range")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0 or h == 0:
        return (out, lse) if return_lse else out
    lib = _lib()
    ws = torch.empty(lib.paged_decode_attention_workspace_floats(
        b, h, t_len * bs, d), dtype=torch.float32, device=q.device)
    counters = arrival_counters(q.device, b * kh)
    with torch.cuda.device(q.device):
        rc = lib.paged_decode_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr(), counters.data_ptr(), b, h, kh, t_len, bs, d,
            float(scale), int(window is not None), int(window or 0),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
            None if lse is None else lse.data_ptr())
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {rc}")
    _build.launches["paged_decode_attention"] += 1
    return (out, lse) if return_lse else out


def __getattr__(attr: str) -> int:     # ``launches``, in ``_build``
    return _build.count_of(__name__, attr)
