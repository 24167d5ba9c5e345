"""The launch choices the port's kernel wrappers make in Python, on the CPU:
K8's tiles (``kernels.ssd_scan.tiling``) and K1's path
(``kernels.quant_matmul.path``).  The kernels themselves run only on the
card (tests/test_torch_cuda.py)."""

import pytest
import torch

from repro_torch.kernels import quant_matmul as K1
from repro_torch.kernels import ssd_scan as K8


def _blocks(s, h, p, n, chunk, dtype):
    """Blocks per batch row of K8's chunk-state and output kernels."""
    row_tile, n_cols = K8.tiling(s, h, p, n, chunk, dtype)
    per_row = (s // chunk) * h * -(-p // K8.P_TILE)
    rows = -(-chunk // 16) * 16
    return per_row * -(-n // n_cols), per_row * -(-rows // row_tile)


# Mamba2-780m's one-shot prefill of 512 and its chunk step of 128;
# Zamba2-1.2B's prefill of 512; in both input types
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,p,n", [(512, 48, 64, 128), (128, 48, 64, 128),
                                     (512, 64, 64, 64)])
def test_ssd_tiling_gives_half_the_card_at_the_path_shapes(s, h, p, n, dtype):
    state_blocks, output_blocks = _blocks(s, h, p, n, 128, dtype)
    assert state_blocks >= K8.SMS // 2 and output_blocks >= K8.SMS // 2


def test_ssd_tiling_takes_the_largest_tiles():
    """A whole chunk's rows a block where four chunks of Mamba2-780m give
    192 blocks; half of them where one chunk gives 48; float32 inputs at
    most 64 rows; 64 state columns, or N's rounded up."""
    assert K8.tiling(512, 48, 64, 128, 128) == (128, 64)
    assert K8.tiling(128, 48, 64, 128, 128) == (64, 64)
    assert K8.tiling(512, 64, 64, 64, 128) == (128, 64)
    assert K8.tiling(512, 48, 64, 128, 128, torch.float32) == (64, 64)
    assert K8.tiling(256, 8, 64, 64, 128, torch.float32) == (64, 64)
    assert K8.tiling(26, 3, 24, 20, 13) == (16, 32)
    assert K8.tiling(192, 8, 64, 128, 64) == (64, 64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,p,n,chunk", [
    (26, 3, 24, 20, 13), (256, 4, 32, 64, 128), (192, 8, 64, 128, 64),
    (1024, 48, 64, 128, 128), (128, 1, 128, 128, 128), (16, 2, 8, 1, 16),
    (7, 1, 4, 4, 7), (256, 2, 64, 48, 128), (240, 4, 64, 64, 48)])
def test_ssd_tiling_is_within_the_kernels_limits(s, h, p, n, chunk, dtype):
    row_tile, n_cols = K8.tiling(s, h, p, n, chunk, dtype)
    rows = -(-chunk // 16) * 16
    assert row_tile in (16, 32, 64, 128)
    assert row_tile <= K8.MAX_ROW_TILE[dtype]
    assert row_tile == 16 or row_tile < 2 * rows     # no tile past the chunk
    assert n_cols in (16, 32, 64) and (n_cols == 16 or n_cols < 2 * n)


@pytest.mark.parametrize("s,h,p,n,chunk,dtype,want", [
    (128, 48, 64, 128, 128, torch.bfloat16, True),   # Mamba2's chunk step
    (128, 48, 64, 128, 128, torch.float32, True),
    (512, 48, 64, 128, 128, torch.bfloat16, False),  # four chunks
    (512, 64, 64, 64, 128, torch.bfloat16, False),     # Zamba2's prefill
    (64, 4, 32, 16, 64, torch.bfloat16, False),      # 16 state columns
])
def test_ssd_one_launch_only_for_one_chunk_at_64_tiles(s, h, p, n, chunk,
                                                       dtype, want):
    """The calls that make one launch, and so allocate no workspaces."""
    assert K8.one_launch(s, chunk, *K8.tiling(s, h, p, n, chunk, dtype)) \
        == want


@pytest.mark.parametrize("m,k,strides,want", [
    (1, 256, (1, 256), "rows"),          # vww's FC weight, (N,K).T
    (1, 256, (2, 1), "tiles"),           # the same as a (K,N) tensor
    (16, 2048, (1, 2048), "rows"),       # K contiguous: any K
    (16, 2048, (64, 1), "tiles"),
    (16, 37, (1, 40), "rows"),           # a strided column
    (17, 64, (1, 64), "tiles"),          # past the rows path's M
    (300, 1000, (520, 1), "tiles"),
    (1, 5, (1, 1), "rows"),              # a single column
])
def test_quant_matmul_path_choice(m, k, strides, want):
    assert K1.path(m, k, strides) == want
