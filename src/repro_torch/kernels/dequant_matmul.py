"""K5 and K6 — the weight-dequant matmul CUDA kernels (int8 and packed
int4 weights, float32 activations).

Replace the Pallas TPU kernels ``dequant_matmul_pallas`` and
``dequant_matmul_i4_pallas`` (``src/repro/kernels/dequant_matmul.py``):
x (M,K) float32 times a weight (K,N) held as int8, or as packed int4
bytes (K,N/2) whose byte j carries column 2j in its low nibble and 2j+1
in its high nibble, with one float32 scale per output column.  Every
product of x and the weight is exact, the sum over K accumulates in
float32 (no TF32) and each output is scaled once after it.  Any M, K and
N; the JAX wrapper pads to (128,128) tiles instead.

Bound on the H100: the weight's bytes, read once (45.1 MB in int8,
13.5 µs at 3.35 TB/s, for Yi-6B's 4096 x 11008 MLP weight; half that in
int4).  Two things keep a kernel from it: a stream of the weight that
leaves SMs idle or short of bytes in flight, and, at int4's rate, the
CUDA cores' four FMAs and conversion per weight element at M = 4.  The
kernel (``csrc/dequant_matmul.cu``) runs a persistent grid of at most
132 blocks, each taking an equal contiguous share of the weight's units
of 128 rows by 128 columns (stream-K) through a ring of shared-memory
buffers filled by 16-byte ``cp.async`` copies, x's rows in the same
copies.  The products run on the tensor cores (``mma.sync`` bf16,
float32 sums) with x split exactly into three bf16 terms and the weight
converted to bf16 exactly, so every product is exact.  A column tile
shared by several blocks is added up, in K order, by the last of them to
arrive, through arrival counters (``decode_attention.arrival_counters``,
allocated once per device and left at 0) — one launch.  The split
depends on (K, N) only, so the result is deterministic and a row's
values do not depend on the other rows of the batch.

``launches`` counts the calls of this process that launched K5 and
``launches_i4`` those that launched K6; only ``dequant_matmul_cuda`` and
``dequant_matmul_i4_cuda`` add to them, and a CUDA-graph replay
adds the launches its capture recorded (``_build.launches``).  The plain
versions are
``repro_torch.kernels.ref.dequant_matmul_ref`` and
``dequant_matmul_i4_ref``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .decode_attention import arrival_counters

MAX_M = 4 * 65535       # the grid's row tiles of 4 in its y dimension
# the kernel's cut of a weight (csrc/dequant_matmul.cu): units of
# UNIT_ROWS rows of K by 128 columns, shared out among at most 132 blocks,
# each taking an equal contiguous run (read in stages of 2 units in int8,
# 4 in int4)
UNIT_ROWS = 128

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("dequant_matmul")
    for fn in (lib.dequant_matmul_launch, lib.dequant_matmul_i4_launch):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    for fn in (lib.dequant_matmul_workspace_floats,
               lib.dequant_matmul_counter_ints):
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
    lib.dequant_matmul_attributes.argtypes = (
        [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.dequant_matmul_attributes.restype = ctypes.c_int
    return lib


def kernel_attributes(int4: bool):
    """(registers a thread, shared-memory bytes a block) of K5 (K6 with
    ``int4``) on weights of 16-byte rows (needs a card)."""
    regs, smem = ctypes.c_int(), ctypes.c_int()
    rc = _lib().dequant_matmul_attributes(int(int4), ctypes.byref(regs),
                                          ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"dequant_matmul attributes: CUDA error {rc}")
    return regs.value, smem.value


def _launch(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
            int4: bool):
    """Check the operands, launch K5 (or K6 with ``int4``) and return
    the float32 (M, N) output and whether the kernel was launched (an
    empty product launches nothing)."""
    name = "dequant_matmul_i4" if int4 else "dequant_matmul"
    if x.device.type != "cuda":
        raise ValueError(f"{name}_cuda needs CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"{name}: x must be a 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if w.device != x.device or w.dtype != torch.int8 or w.dim() != 2:
        raise ValueError(f"{name}: the weight must be a 2-D int8 tensor on "
                         f"{x.device}")
    m, k = x.shape
    n = w.shape[1] * (2 if int4 else 1)
    if w.shape[0] != k:
        raise ValueError(f"{name}: x {tuple(x.shape)} and weight "
                         f"{tuple(w.shape)} do not contract")
    if (scale.device != x.device or scale.dtype != torch.float32
            or scale.numel() != n):
        raise ValueError(f"{name}: scale must hold {n} float32 values on "
                         f"{x.device}")
    for label, t in (("x", x), ("weight", w), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if max(k, n) >= 2 ** 31 or m > MAX_M:
        raise ValueError(f"{name}: dimensions {(m, k, n)} too large (M at "
                         f"most {MAX_M}, K and N below 2^31)")
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_(), False
    lib = _lib()
    ws = torch.empty(lib.dequant_matmul_workspace_floats(m, k, n, int(int4)),
                     dtype=torch.float32, device=x.device)
    counters = arrival_counters(
        x.device, lib.dequant_matmul_counter_ints(m, k, n, int(int4)))
    fn = lib.dequant_matmul_i4_launch if int4 else lib.dequant_matmul_launch
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
                ws.data_ptr(), counters.data_ptr(), m, k, n,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out, True


def dequant_matmul_cuda(x: torch.Tensor, w_q: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """K5: x (M,K) float32 · w_q (K,N) int8, scale N float32 -> float32
    (M,N) on the card.  Raises on anything the kernel does not take, and
    when the launch fails."""
    out, launched = _launch(x, w_q, scale, int4=False)
    _build.launches["dequant_matmul"] += launched
    return out


def dequant_matmul_i4_cuda(x: torch.Tensor, w_p: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """K6: x (M,K) float32 · packed int4 w_p (K,N/2) int8, scale N
    float32 -> float32 (M,N) on the card.  Raises on anything the kernel
    does not take, and when the launch fails."""
    out, launched = _launch(x, w_p, scale, int4=True)
    _build.launches["dequant_matmul_i4"] += launched
    return out


def __getattr__(attr: str) -> int:     # ``launches``, in ``_build``
    return _build.count_of(__name__, attr)
