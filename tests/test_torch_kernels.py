"""The ported kernels on the CPU: each wrapper runs its plain PyTorch
version there, which is held against the JAX package's oracle
(``repro.kernels.ref``) and its Pallas kernel in interpret mode.  The
CUDA kernels themselves are held against the plain versions in
test_torch_cuda.py, which needs a card."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref

from repro.kernels.decode_attention import decode_attention_pallas

from repro_torch.kernels import decode_attention as K3
from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quant_matmul as K1

# f32 attention: the plain version and the JAX oracle differ only in
# summation order (softmax then P.V in f32) — 2e-6 on O(1) outputs
ATTN_TOL = 2e-6


def _qmm_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w = rng.integers(-128, 128, (k, n), dtype=np.int8)
    bias = rng.integers(-500, 500, (n,), dtype=np.int32)
    scale = rng.uniform(1e-4, 5e-3, (n,)).astype(np.float32)
    x_zp, out_zp = int(rng.integers(-10, 10)), int(rng.integers(-10, 10))
    return x, w, bias, scale, x_zp, out_zp


# the interpreter's FC shapes (vww, fc_stack, conv_reference), a bigger
# block and ragged edges in every dimension
QMM_SHAPES = [(1, 256, 2), (1, 64, 32), (1, 32, 8), (1, 16, 10),
              (8, 64, 32), (100, 96, 40), (3, 300, 7)]


@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
def test_quant_matmul_plain_matches_jax_ref_and_pallas(m, k, n):
    x, w, bias, scale, x_zp, out_zp = _qmm_case(m, k, n, m * 1000 + k + n)
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(bias), x_zp,
                           torch.from_numpy(scale), out_zp).numpy()
    jargs = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), x_zp,
             jnp.asarray(scale), out_zp)
    np.testing.assert_array_equal(got, np.asarray(jax_ref.quant_matmul_ref(
        *jargs)))
    np.testing.assert_array_equal(got, np.asarray(jax_ops.quant_matmul(
        *jargs, interpret=True)))


def test_quant_matmul_plain_no_bias_and_transposed_weight():
    x, w, _, scale, x_zp, out_zp = _qmm_case(16, 32, 16, 0)
    want = np.asarray(jax_ref.quant_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), None, x_zp, jnp.asarray(scale),
        out_zp))
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).T      # strided view
    got = ops.quant_matmul(torch.from_numpy(x), wt, None, x_zp,
                           torch.from_numpy(scale), out_zp)
    np.testing.assert_array_equal(got.numpy(), want)


def _attn_case(b, h, kh, s, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, shape).astype(dtype)
                 for shape in ((b, h, s, d), (b, kh, s, d), (b, kh, s, d)))


def _valid_rows(s, causal, window):
    qi, kj = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    return mask.any(axis=1)


# (b, h, kh, s, d, causal, window): causal and not, GQA, sliding
# windows, and windows that leave rows with no valid key at all
ATTN_CASES = [
    (1, 2, 2, 128, 32, True, None),
    (2, 4, 2, 128, 64, True, None),
    (1, 4, 1, 64, 16, False, None),
    (1, 2, 2, 128, 32, True, 32),
    (1, 2, 1, 128, 16, False, 40),
    (1, 2, 2, 64, 16, True, 0),           # every row fully masked
    (1, 2, 1, 64, 16, False, -3),         # the last 4 rows fully masked
]


@pytest.mark.parametrize("b,h,kh,s,d,causal,window", ATTN_CASES)
def test_flash_attention_plain_matches_jax(b, h, kh, s, d, causal, window):
    q, k, v = _attn_case(b, h, kh, s, d, seed=s + d + h)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window).numpy()
    jq = tuple(map(jnp.asarray, (q, k, v)))
    pallas = np.asarray(jax_ops.flash_attention(
        *jq, causal=causal, window=window, interpret=True))
    oracle = np.asarray(jax_ref.mha_ref(*jq, causal=causal, window=window))
    rows = _valid_rows(s, causal, window)
    # rows with no valid key: 0 from the plain version and the Pallas
    # kernel (the JAX oracle's plain softmax gives NaN there)
    np.testing.assert_array_equal(got[:, :, ~rows], 0.0)
    np.testing.assert_allclose(got, pallas, atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(got[:, :, rows], oracle[:, :, rows],
                               atol=ATTN_TOL, rtol=ATTN_TOL)


def test_flash_attention_plain_bf16_keeps_dtype():
    q, k, v = _attn_case(1, 2, 1, 64, 32, seed=3)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ops.flash_attention(*t, causal=True)
    assert got.dtype == torch.bfloat16
    want = ref.mha_ref(*[a.float() for a in t], causal=True)
    # one bfloat16 rounding of an f32 result: half an ulp, 2^-8 relative
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=2 ** -8, atol=1e-6)


def test_flash_attention_plain_explicit_scale():
    q, k, v = _attn_case(1, 2, 2, 64, 16, seed=9)
    jq = tuple(map(jnp.asarray, (q, k, v)))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              scale=0.5 / math.sqrt(16)).numpy()
    want = np.asarray(jax_ref.mha_ref(*jq, scale=0.5 / math.sqrt(16)))
    np.testing.assert_allclose(got, want, atol=ATTN_TOL, rtol=ATTN_TOL)


def test_cuda_launchers_refuse_cpu_tensors():
    """The kernel launchers never run a plain version: a CPU tensor is an
    error, and no launch is counted."""
    x, w, bias, scale, x_zp, out_zp = _qmm_case(4, 16, 8, 1)
    before = (K1.launches, K2.launches)
    with pytest.raises(ValueError):
        K1.quant_matmul_cuda(*map(torch.from_numpy, (x, w, bias,
                                                      bias, scale)),
                             x_zp=x_zp, out_zp=out_zp)
    q = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError):
        K2.flash_attention_cuda(q, q, q)
    before3 = K3.launches
    with pytest.raises(ValueError):
        K3.decode_attention_cuda(q[:, :, 0], q, q,
                                 torch.ones(1, dtype=torch.int32))
    assert (K1.launches, K2.launches, K3.launches) == before + (before3,)


# ---------------------------------------------------------------------------
# decode attention (K3)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pallas_memory_space_alias():
    """Alias ``pltpu.TPUMemorySpace`` (renamed ``pltpu.MemorySpace`` in
    newer jax) for this module's Pallas decode-attention calls only, and
    drop the kernel's jit cache afterwards so no program traced under
    the alias outlives the module."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUMemorySpace"):
            mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                       raising=False)
        yield
    decode_attention_pallas.clear_cache()


# f32 decode attention: one softmax over S and one P·V in f32 on each
# side, summed in different orders
DECODE_TOL = 1e-5

# (b, h, kh, s, d, window): tests/test_kernels.py's sweep, then head dim
# 96 (Phi-3-mini), GQA 8 (Yi-6B), and windows wider than the rows
DECODE_CASES = [
    (1, 4, 1, 256, 64, None), (2, 8, 2, 512, 64, None),
    (4, 4, 4, 128, 32, None), (1, 4, 1, 256, 64, 64),
    (2, 8, 2, 512, 64, 64), (4, 4, 4, 128, 32, 64),
    (3, 4, 4, 256, 96, None), (4, 16, 2, 128, 128, None),
    (2, 8, 1, 128, 64, 1000),
]


def _decode_case(b, h, kh, s, d, window, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, kh, s, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, kh, s, d)).astype(np.float32)
    lengths = rng.integers(min(window or 1, s), s + 1, (b,)).astype(
        np.int32)
    lengths[-1] = s                     # every row valid (a full ring)
    lengths[0] = 1                      # a single valid entry
    return q, k, v, lengths


@pytest.mark.parametrize("b,h,kh,s,d,window", DECODE_CASES)
def test_decode_attention_plain_matches_jax(pallas_memory_space_alias, b, h,
                                            kh, s, d, window):
    q, k, v, lengths = _decode_case(b, h, kh, s, d, window, b * 10 + h + d)
    got = ops.decode_attention(*map(torch.from_numpy, (q, k, v, lengths)),
                               window=window).numpy()
    jq = tuple(map(jnp.asarray, (q, k, v, lengths)))
    pallas = np.asarray(jax_ops.decode_attention(*jq, window=window,
                                                 interpret=True))
    oracle = np.asarray(jax_ref.decode_attention_ref(*jq, window=window))
    np.testing.assert_allclose(got, pallas, atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    np.testing.assert_allclose(got, oracle, atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    # one valid entry: the output is that row of V, exactly
    np.testing.assert_array_equal(
        got[0], np.repeat(v[0, :, 0], h // kh, axis=0))


def test_decode_attention_plain_empty_rows_are_zero(
        pallas_memory_space_alias):
    """A row with no valid key (length 0, or a window of 0) outputs 0, as
    the Pallas kernel does; the JAX oracle's plain softmax gives NaN."""
    q, k, v, lengths = _decode_case(3, 4, 2, 128, 32, None, 7)
    lengths[1] = 0
    got = ops.decode_attention(*map(torch.from_numpy, (q, k, v, lengths))
                               ).numpy()
    jq = tuple(map(jnp.asarray, (q, k, v, lengths)))
    pallas = np.asarray(jax_ops.decode_attention(*jq, interpret=True))
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_allclose(got, pallas, atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    assert np.isnan(np.asarray(jax_ref.decode_attention_ref(*jq))[1]).all()
    windowed = ops.decode_attention(*map(torch.from_numpy,
                                         (q, k, v, lengths)), window=0)
    np.testing.assert_array_equal(windowed.numpy(), 0.0)


def test_decode_attention_plain_bf16_keeps_dtype():
    q, k, v, lengths = _decode_case(2, 8, 2, 256, 64, None, 5)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ops.decode_attention(*t, torch.from_numpy(lengths))
    assert got.dtype == torch.bfloat16
    want = ref.decode_attention_ref(*[a.float() for a in t],
                                    torch.from_numpy(lengths))
    # one bfloat16 rounding of an f32 result: half an ulp, 2^-8 relative
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=2 ** -8, atol=1e-6)


# ---------------------------------------------------------------------------
# K3 and K4 on a rank's rows: the log-sum-exp, split and merged
# ---------------------------------------------------------------------------

# merged partials against the unsplit plain version, float32: each
# partial's softmax over its rows, then the exp(lse - max) weights
SPLIT_TOL = 1e-6


def _merge(outs, lses):
    """Partial attentions over disjoint rows, each with its log-sum-exp,
    merged as the ranks merge them (``Comm.combine``): (out, lse)."""
    lse = torch.stack(lses)
    top = lse.max(dim=0).values
    w = torch.exp(lse - top)
    num = (torch.stack(outs).float() * w[..., None]).sum(dim=0)
    den = w.sum(dim=0)
    return num / den[..., None], top + torch.log(den)


def _check_parts(outs, lses, counts, whole, whole_lse):
    merged, lse = _merge(outs, lses)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(),
                               atol=SPLIT_TOL, rtol=SPLIT_TOL)
    np.testing.assert_allclose(lse.numpy(), whole_lse.numpy(),
                               atol=SPLIT_TOL, rtol=SPLIT_TOL)
    empty = 0
    for out, part_lse, n in zip(outs, lses, counts):
        none = n == 0
        empty += int(none.sum())
        assert torch.equal(out[none], torch.zeros_like(out[none]))
        assert torch.isneginf(part_lse[none]).all()
        assert torch.isfinite(part_lse[~none]).all()
    assert empty                # some rank held no valid row of some row


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("b,h,kh,s,d", [(4, 8, 2, 256, 64),
                                        (3, 4, 1, 128, 32),
                                        (4, 16, 2, 512, 128)])
def test_decode_attention_plain_split_over_rows(pallas_memory_space_alias,
                                                b, h, kh, s, d, m):
    """A rank of m holds cache rows [r·S/m, (r+1)·S/m) and its lengths
    clamped to them, clamp(n - r·S/m, 0, S/m): its partial and lse, the
    m of them merged, give the unsplit plain version (itself the JAX
    oracle's and the Pallas kernel's in interpret mode); a rank with no
    valid row gives 0 and -inf."""
    q, k, v, lengths = _decode_case(b, h, kh, s, d, None, b + h + s + m)
    lengths[1] = s // m + 1         # one row past the first rank's rows
    t = lambda a: torch.from_numpy(a)
    whole, whole_lse = ops.decode_attention(t(q), t(k), t(v), t(lengths),
                                            return_lse=True)
    assert torch.equal(whole, ops.decode_attention(t(q), t(k), t(v),
                                                   t(lengths)))
    jq = tuple(map(jnp.asarray, (q, k, v, lengths)))
    np.testing.assert_allclose(
        whole.numpy(), np.asarray(jax_ref.decode_attention_ref(*jq)),
        atol=DECODE_TOL, rtol=DECODE_TOL)
    np.testing.assert_allclose(
        whole.numpy(), np.asarray(jax_ops.decode_attention(*jq,
                                                           interpret=True)),
        atol=DECODE_TOL, rtol=DECODE_TOL)
    c = s // m
    outs, lses, counts = [], [], []
    for r in range(m):
        n = torch.clamp(t(lengths) - r * c, 0, c).to(torch.int32)
        rows = slice(r * c, (r + 1) * c)
        out, lse = ops.decode_attention(
            t(q), t(k)[:, :, rows].contiguous(),
            t(v)[:, :, rows].contiguous(), n, return_lse=True)
        outs.append(out)
        lses.append(lse)
        counts.append(n)
    _check_parts(outs, lses, counts, whole, whole_lse)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("b,h,kh,t,bs,d", [(3, 4, 2, 4, 16, 32),
                                           (2, 8, 1, 2, 32, 64),
                                           (4, 4, 4, 8, 8, 16)])
def test_paged_decode_attention_plain_split_over_block_rows(b, h, kh, t, bs,
                                                            d, m):
    """A rank of m holds rows [r·BS/m, (r+1)·BS/m) of every block: K4's
    plain version on that pool (block size BS/m, which the kernel takes),
    the same permuted table and the rank's count of rows below each
    length, (n // BS)·BS/m + clamp(n % BS - r·BS/m, 0, BS/m), gives
    partials whose merge is the unsplit paged plain version (itself the
    JAX oracle's and the Pallas kernel's); empty ranks give 0 and
    -inf."""
    rng = np.random.default_rng(b * t + bs + m)
    p = b * t + 1
    q = rng.normal(0, 1, (b, h, d)).astype(np.float32)
    k_pool = rng.normal(0, 1, (p, kh, bs, d)).astype(np.float32)
    v_pool = rng.normal(0, 1, (p, kh, bs, d)).astype(np.float32)
    tables = (1 + rng.permutation(b * t)).reshape(b, t).astype(np.int32)
    lengths = rng.integers(1, t * bs + 1, b).astype(np.int32)
    lengths[0] = 1
    lengths[-1] = t * bs
    tt = lambda a: torch.from_numpy(a)
    whole, whole_lse = ops.paged_decode_attention(
        *map(tt, (q, k_pool, v_pool, tables, lengths)), return_lse=True)
    jq = tuple(map(jnp.asarray, (q, k_pool, v_pool, tables, lengths)))
    np.testing.assert_allclose(
        whole.numpy(), np.asarray(jax_ref.paged_decode_attention_ref(*jq)),
        atol=DECODE_TOL, rtol=DECODE_TOL)
    np.testing.assert_allclose(
        whole.numpy(), np.asarray(jax_ops.paged_decode_attention(
            *jq, interpret=True)), atol=DECODE_TOL, rtol=DECODE_TOL)
    held = bs // m
    outs, lses, counts = [], [], []
    for r in range(m):
        n = tt(lengths)
        n = ((n // bs) * held
             + torch.clamp(n % bs - r * held, 0, held)).to(torch.int32)
        rows = slice(r * held, (r + 1) * held)
        out, lse = ops.paged_decode_attention(
            tt(q), tt(k_pool)[:, :, rows].contiguous(),
            tt(v_pool)[:, :, rows].contiguous(), tt(tables), n,
            return_lse=True)
        outs.append(out)
        lses.append(lse)
        counts.append(n)
    _check_parts(outs, lses, counts, whole, whole_lse)
