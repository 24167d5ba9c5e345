"""K8 — the Mamba-2 SSD chunked-scan CUDA kernel.

Replaces the Pallas TPU kernel ``ssd_scan_pallas``
(``src/repro/kernels/ssd_scan.py``): x (B,S,H,P), dt (B,S,H), A (H,), B
and C (B,S,G,N), D (H,) or None, and — beyond the Pallas kernel, as
``ssd_ref`` takes it — an initial state ``h0`` (B,H,P,N) or None (zeros).
Returns y (B,S,H,P) in x's dtype and the final state (B,H,P,N) in
float32.  x, B and C are float32 or bfloat16 (one dtype), the rest
float32; S must be a multiple of ``chunk`` (at most 128), N at most 128.

Bound on the H100: at Mamba2-780m's one-shot prefill of 512 tokens the
least work is about 1.0 GFLOP (15 µs on the CUDA cores in float32, 1.0
µs on the tensor cores) against 8.2 MB of operands (2.4 µs), so on the
tensor cores the bytes bound it.  The kernel (``csrc/ssd_scan.cu``)
splits the scan as Mamba-2's GPU kernels do: each chunk's own state
contribution and its output rows run in parallel across chunks, and only
a short pass over the chunks carries the state; its products run on the
tensor cores, float32 operands split exactly into bf16 terms.  One call
makes three launches on the current stream, or one where it covers a
single chunk at 64-row and 64-column tiles (the chunked-prefill step);
``tiling`` picks the blocks' tiles from the shape alone, so each batch
row gets the same bits alone and in any batch.

``launches`` counts the calls of this process that launched the kernel;
only ``ssd_scan_cuda`` adds to it, and a CUDA-graph replay
adds the launches its capture recorded (``_build.launches``).  The plain
version is
``repro_torch.kernels.ref.ssd_scan_ref``; only ``kernels.ops`` calls
this wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

MAX_CHUNK = 128
MAX_STATE = 128
# the H100's streaming multiprocessors (``tiling`` halves a row tile that
# would give a batch row fewer than half this many blocks)
SMS = 132
P_TILE = 64        # state rows p a block of either parallel kernel takes
# the device kernels a call launches, in order (as profilers name them);
# a one-chunk call at 64-row and 64-column tiles launches the last alone
KERNEL_NAMES = ("chunk_state_kernel", "state_pass_kernel",
                "chunk_output_kernel", "one_chunk_kernel")

# float32 operands formed in the kernel go to the tensor cores as this many
# bf16 terms: two with bfloat16 inputs, three (all of float32) with float32
MIX_TERMS = {torch.bfloat16: 2, torch.float32: 3}
# the most y rows an output block takes (float32 inputs take three
# shared-memory planes each)
MAX_ROW_TILE = {torch.bfloat16: 128, torch.float32: 64}

_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
             + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = _ARGTYPES
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_attributes.argtypes = (
        [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.ssd_scan_attributes.restype = ctypes.c_int
    return lib


def _up16(v: int) -> int:
    return -(-v // 16) * 16


def tiling(s: int, h: int, p: int, n: int, chunk: int,
           dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """(row_tile, n_cols): the y rows a block of the output kernel takes
    (16, 32, 64 or 128) and the state columns a block of the chunk-state
    kernel takes (16, 32 or 64).  Every block of a row tile loads B and x
    up to its last row and the whole state, so the largest tile wins
    (``MAX_ROW_TILE``, the chunk's rows rounded up to a power of two),
    halved once, not below 64, when a batch row would get fewer than
    ``SMS // 2`` blocks; 64 columns, or N's rounded up to a power of two.
    A function of the shape without the batch, so a row's tiles, and so
    its bits, are the same alone and in any batch."""
    rows = _up16(chunk)
    per_row = (s // chunk) * h * -(-p // P_TILE)
    tiles = [t for t in (128, 64, 32, 16)
             if t <= MAX_ROW_TILE[dtype] and (t < 2 * rows or t == 16)]
    row_tile = tiles[0]
    if (per_row * -(-rows // row_tile) < SMS // 2 and len(tiles) > 1
            and tiles[1] >= 64):
        row_tile = tiles[1]
    n_cols = next(w for w in (16, 32, 64) if w >= n or w == 64)
    return row_tile, n_cols


def one_launch(s: int, chunk: int, row_tile: int, n_cols: int) -> bool:
    """Whether a call makes one launch (``one_chunk_kernel``) and so needs
    no workspaces: a single chunk at 64-row and 64-column tiles."""
    return s == chunk and row_tile == 64 and n_cols == 64


def kernel_attributes(dtype: torch.dtype, which: int, s: int, h: int,
                      p: int, n: int, chunk: int) -> Tuple[int, int]:
    """(registers a thread, shared-memory bytes a block) of the chunk-state
    (``which`` 0), state-pass (1), output (2) or one-chunk (3) kernel at
    this shape (needs a card)."""
    row_tile, n_cols = tiling(s, h, p, n, chunk, dtype)
    regs, smem = ctypes.c_int(), ctypes.c_int()
    rc = _lib().ssd_scan_attributes(int(dtype == torch.bfloat16), which,
                                    chunk, n, row_tile, n_cols,
                                    ctypes.byref(regs), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"ssd_scan attributes: CUDA error {rc}")
    return regs.value, smem.value


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
    row_tile, n_cols = tiling(s, h, p, n, chunk, x.dtype)
    ws = sp = dec = None
    if not one_launch(s, chunk, row_tile, n_cols):
        # each chunk's state contribution, the state entering it as bf16
        # terms, and its decay exp(cum_L)
        nc = s // chunk
        ws = torch.empty((b, nc, h, p, n), dtype=torch.float32,
                         device=x.device)
        sp = torch.empty((b, nc, h, MIX_TERMS[x.dtype], p, n),
                         dtype=torch.bfloat16, device=x.device)
        dec = torch.empty((b, nc, h), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        rc = _lib().ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), ptr(D), ptr(h0), y.data_ptr(), state.data_ptr(),
            ptr(ws), ptr(sp), ptr(dec), b, s, h, p, g, n, chunk,
            int(x.dtype == torch.bfloat16), row_tile, n_cols,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    _build.launches["ssd_scan"] += 1
    return y, state


def __getattr__(attr: str) -> int:     # ``launches``, in ``_build``
    return _build.count_of(__name__, attr)
