"""K3 — the decode-attention CUDA kernel (one new token vs a KV cache).

Replaces the Pallas TPU kernel ``decode_attention_pallas``
(``src/repro/kernels/decode_attention.py``): q (B,H,D) against contiguous
caches k, v (B,KH,S,D) with per-sequence ``lengths`` (B,) int32 read on
the device; position p is valid when ``p < lengths[b]`` (and
``p >= lengths[b] - window`` with a window).  All H/KH query heads of one
KV head share each K/V tile; a row with no valid key outputs 0.  float32
or bfloat16 in, float32 math, q's type out; any S and D <= 128.

Bound on the H100: the bytes of the valid K/V rows, about 16.8 MB per
call at Yi-6B's (4, 32, 4, 2048, 128) bfloat16 with full rows, about
5.0 µs at 3.35 TB/s.  B·KH is 16 there, so the kernel
(``csrc/decode_attention.cu``) gives each block a run of 128 positions of
one (KV head, b): two warps a 32-row tile, its rows copied to shared
memory by 16-byte ``cp.async`` (all four tiles' copies in flight at
once), q·Kᵀ and P·V on tensor cores for a bfloat16 cache (P split into
two exact bf16 halves) and on the CUDA cores otherwise.  Only runs that
hold valid positions write partial (m, l, acc); the last block of a
(b, KV head) to arrive — an arrival counter tells it — combines them in
run order, so the result is deterministic (no float atomics) and takes
one launch.  The split depends only on S, so a row's values do not
depend on the batch.  With ``return_lse`` the writing block also stores
each head's log-sum-exp m + log(l) (-inf for a row with no valid key):
a rank of a sequence-sharded cache runs it on its rows with its lengths
clamped to them, and the ranks' partials merge into the attention over
every row (``distributed.collectives.Comm.combine``).

``launches`` counts the calls of this process that launched the kernel;
only ``decode_attention_cuda`` adds to it, and a CUDA-graph replay
adds the launches its capture recorded (``_build.launches``).  The plain
version is
``repro_torch.kernels.ref.decode_attention_ref``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional

import torch

from . import _build

MAX_D = 128
RUN = 128           # cache positions per block (csrc/decode_attention.cuh)

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p]
             + [ctypes.c_void_p])     # the stream, then lse (None: no lse)
# the combining blocks' arrival counters, one int32 per (b, KV head) on
# each device: allocated zeroed at the first launch there (grown only when
# B·KH grows) and left at 0 by every launch, so steady-state decode
# allocates nothing for them and a CUDA-graph capture stays valid.
# Launches that share them run one after another on one stream.  A
# buffer a growth replaces is kept: graphs captured on it still read it.
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
_REPLACED: List[torch.Tensor] = []


def arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 arrival counters on ``device``, shared
    by K3, K4, K5, K6 and K7."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _REPLACED.append(buf)
        buf = _COUNTERS[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                              device=device)
    return buf


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("decode_attention")
    lib.decode_attention_launch.argtypes = _ARGTYPES
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.decode_attention_workspace_floats.restype = ctypes.c_longlong
    lib.decode_attention_attributes.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.decode_attention_attributes.restype = ctypes.c_int
    return lib


def kernel_attributes(dtype: torch.dtype, group: int, d: int):
    """(registers a thread, shared-memory bytes a block) of the kernel a
    launch in ``dtype`` at group size ``group`` and head dim ``d`` runs
    (needs a card)."""
    regs, smem = ctypes.c_int(), ctypes.c_int()
    rc = _lib().decode_attention_attributes(
        int(dtype == torch.bfloat16), group, d, ctypes.byref(regs),
        ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"decode_attention attributes: CUDA error {rc}")
    return regs.value, smem.value


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, lengths: torch.Tensor, *,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """q (B,H,D), caches (B,KH,S,D), lengths (B,) int32 -> (B,H,D) on the
    card; with ``return_lse`` also each head's float32 log-sum-exp (B,H)
    of its scaled scores over the valid rows (-inf for none).  Raises on
    anything the kernel does not take, and when the launch fails."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attention: dtype {q.dtype} is not "
                         f"float32 or bfloat16")
    if q.dim() != 3:
        raise ValueError(f"decode_attention: q must be (B,H,D), got "
                         f"{tuple(q.shape)}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 4:
            raise ValueError(f"decode_attention: {name} must be a 4-D "
                             f"{q.dtype} tensor on {q.device}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    b, h, d = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    if (tuple(k_cache.shape) != (b, kh, s, d)
            or tuple(v_cache.shape) != tuple(k_cache.shape)
            or kh < 1 or h % kh or s < 1):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)} "
                         f"do not form (B,H,D), (B,KH,S,D) with H % KH == 0")
    if lengths.device != q.device or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"decode_attention: lengths must be ({b},) int32 "
                         f"on {q.device}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"decode_attention: head dim {d} not in 1..{MAX_D}")
    if window is not None and not -2 ** 31 < window < 2 ** 31:
        raise ValueError(f"decode_attention: window {window} out of range")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0 or h == 0:
        return (out, lse) if return_lse else out
    lib = _lib()
    ws = torch.empty(lib.decode_attention_workspace_floats(b, h, s, d),
                     dtype=torch.float32, device=q.device)
    counters = arrival_counters(q.device, b * kh)
    with torch.cuda.device(q.device):
        rc = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), b, h, kh, s, d, float(scale),
            int(window is not None), int(window or 0),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
            None if lse is None else lse.data_ptr())
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    _build.launches["decode_attention"] += 1
    return (out, lse) if return_lse else out


def __getattr__(attr: str) -> int:     # ``launches``, in ``_build``
    return _build.count_of(__name__, attr)
