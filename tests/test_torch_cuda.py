"""The port's CUDA kernels on the card, each held against its plain
PyTorch version on the same inputs, and the interpreter and the serving
engine (contiguous, paged, chunked, quantized, and the recurrent
families) on the card held against the CPU reference, and the programs'
CUDA-graph replays held bit-equal to eager runs.  Every test here is
marked ``cuda`` and skips without a card; this module imports no jax, so
it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import gc

import numpy as np
import pytest
import torch

from repro_torch.apps.models import (build_fc_stack, build_vww,
                                     representative_dataset)
from repro_torch.core import (AllOpsResolver, ArenaPool, CapturedProgram,
                              MicroInterpreter, MicroModel, capture_count,
                              disable_capture, export)
from repro_torch.configs import get_config
from repro_torch.core.quantize import dequantize_kv_heads, quantize_kv_heads
from repro_torch.kernels import decode_attention as K3
from repro_torch.kernels import dequant_matmul as K56
from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as K4
from repro_torch.kernels import paged_decode_attention_q as K7
from repro_torch.kernels import quant_matmul as K1
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as K8
from repro_torch.models import get_model, lm_quant
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import PREFILL_PROGRAMS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(1, 256, 2), (1, 64, 32), (1, 16, 10),
                                   (8, 64, 32), (3, 300, 7), (64, 128, 96),
                                   (300, 1000, 520)])
def test_quant_matmul_kernel_equals_plain(cuda, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
    bias = torch.from_numpy(rng.integers(-500, 500, n, dtype=np.int32))
    scale = torch.from_numpy(rng.uniform(1e-4, 5e-3, n).astype(np.float32))
    x_zp, out_zp = (int(v) for v in rng.integers(-128, 128, 2))
    want = ref.quant_matmul_ref(x, w, bias, x_zp, scale, out_zp)
    before = K1.launches
    got = ops.quant_matmul(x.to(cuda), w.to(cuda), bias.to(cuda), x_zp,
                           scale.to(cuda), out_zp)
    wt = w.t().contiguous().to(cuda).t()            # a strided weight
    got_t = ops.quant_matmul(x.to(cuda), wt, bias.to(cuda), x_zp,
                             scale.to(cuda), out_zp)
    torch.cuda.synchronize()
    assert K1.launches == before + 2
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    torch.testing.assert_close(got_t.cpu(), want, rtol=0, atol=0)


@pytest.mark.parametrize("m", [16, 17])
@pytest.mark.parametrize("k,n", [(200, 1), (37, 45), (256, 2)])
def test_quant_matmul_kernel_on_both_sides_of_the_rows_path(cuda, m, k, n):
    """M = 16 takes the rows path on the FC layer's (N,K).T weight and the
    tiles on a (K,N) one, M = 17 the tiles on both; with K off 16 and N = 1
    every path, and the tiled path forced on the same call, is bit-equal
    to the plain version."""
    rng = np.random.default_rng(m * k + n)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
    bias = torch.from_numpy(rng.integers(-500, 500, n, dtype=np.int32))
    scale = torch.from_numpy(rng.uniform(1e-4, 5e-3, n).astype(np.float32))
    x_zp, out_zp = (int(v) for v in rng.integers(-128, 128, 2))
    want = ref.quant_matmul_ref(x, w, bias, x_zp, scale, out_zp)
    wsum = w.sum(dim=0, dtype=torch.int32).to(cuda)
    paths = []
    for wl in (w.t().contiguous().to(cuda).t(), w.to(cuda)):
        paths.append(K1.path(m, k, wl.stride()))
        before = K1.launches
        got = K1.quant_matmul_cuda(x.to(cuda), wl, bias.to(cuda), wsum,
                                   scale.to(cuda), x_zp=x_zp, out_zp=out_zp)
        tiled, _ = K1._quant_matmul(x.to(cuda), wl, bias.to(cuda), wsum,
                                    scale.to(cuda), x_zp, out_zp, "tiles")
        torch.cuda.synchronize()
        assert K1.launches == before + 1
        assert torch.equal(got.cpu(), want) and torch.equal(tiled.cpu(), want)
    # a (K,1) weight has K contiguous in either layout
    assert paths == (["rows", "rows"] if m <= 16 and n == 1
                     else ["rows", "tiles"] if m <= 16
                     else ["tiles", "tiles"])


@pytest.mark.parametrize("b,h,kh,s,d,causal,window", [
    (2, 4, 4, 256, 64, True, None), (2, 4, 4, 256, 64, False, None),
    (1, 8, 2, 256, 64, True, None), (1, 2, 2, 128, 32, True, 32),
    (1, 2, 1, 128, 16, False, 40), (1, 2, 2, 64, 16, True, 0),
    (1, 2, 1, 64, 16, False, -3), (1, 2, 1, 100, 128, True, None),
    (1, 1, 1, 7, 8, False, None)])
def test_flash_attention_kernel_matches_plain(cuda, b, h, kh, s, d, causal,
                                              window):
    g = torch.Generator().manual_seed(s + d)
    q, k, v = (torch.randn(*shape, generator=g).to(cuda) for shape in
               ((b, h, s, d), (b, kh, s, d), (b, kh, s, d)))
    want = ref.mha_ref(q, k, v, causal=causal, window=window)
    before = K2.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_flash_attention_kernel_bf16(cuda):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 4, 256, 64, generator=g).to(cuda,
                                                          torch.bfloat16)
               for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.mha_ref(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    # both round an f32 result to bfloat16 once: at most one ulp apart
    torch.testing.assert_close(got.float(), want.float(), atol=2.0 ** -6,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [12, 16, 64, 96, 128])
@pytest.mark.parametrize("s", [7, 100, 257])
def test_flash_attention_kernel_across_q_tiles(cuda, s, d, dtype):
    """Sequence lengths that end inside a 16-row q tile and a 64-row K/V
    tile, GQA (4 heads on 2 KV heads), causal and with a window, float32
    within 1e-5 and bfloat16 within one ulp of the plain version; D 12
    has rows that are not 16-byte multiples in bfloat16 (element-wise
    copies)."""
    g = torch.Generator().manual_seed(s * d)
    q, k, v = (torch.randn(*shape, generator=g).to(cuda, dtype) for shape in
               ((2, 4, s, d), (2, 2, s, d), (2, 2, s, d)))
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    for causal, window in ((True, None), (True, 50), (False, None)):
        want = ref.mha_ref(q, k, v, causal=causal, window=window)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=0)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 16, 256, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    x = torch.zeros(4, 8, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        K1.quant_matmul_cuda(x, x.t(), torch.zeros(4, dtype=torch.int32,
                                                   device=cuda),
                             torch.zeros(3, dtype=torch.int32, device=cuda),
                             torch.zeros(4, device=cuda), x_zp=0, out_zp=0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("build", [build_fc_stack, build_vww])
def test_interpreter_on_card_matches_cpu_reference(cuda, build, int8):
    gb = build()
    blob = (export(gb, representative_dataset(gb), quantize_int8=True)
            if int8 else export(gb))
    model = MicroModel(blob)
    res = AllOpsResolver(tags=("cuda", "reference"))
    size = MicroInterpreter.required_arena_size(model, res)
    card = MicroInterpreter(model, res, size)
    cpu = MicroInterpreter(model, AllOpsResolver(), size, device="cpu")
    rng = np.random.default_rng(0)
    before = K1.launches
    for _ in range(3):
        x = rng.normal(0, 1, card.input_spec(0).shape).astype(np.float32)
        for it in (card, cpu):
            it.set_input(0, x)
            it.invoke()
        np.testing.assert_allclose(card.output(0), cpu.output(0),
                                   atol=1.5 / 256 if int8 else 1e-5)
    assert card.shared.alloc_count == 1
    fc = sum(op.opcode == 2 for op in model.operators)
    assert K1.launches - before == (3 * fc if int8 else 0)


# (b, h, kh, s, d, window, dtype): Yi-6B's GQA 8 at head dim 128,
# Phi-3-mini's head dim 96, a cache length that is no multiple of the
# kernel's 32-row tile, a window, and bfloat16
@pytest.mark.parametrize("b,h,kh,s,d,window,dtype", [
    (4, 32, 4, 512, 128, None, torch.float32),
    (4, 8, 8, 256, 96, None, torch.float32),
    (3, 8, 2, 300, 64, None, torch.float32),
    (2, 8, 2, 512, 64, 100, torch.float32),
    (2, 4, 1, 37, 16, None, torch.float32),
    (4, 32, 4, 512, 128, None, torch.bfloat16),
    (4, 8, 8, 256, 96, 64, torch.bfloat16)])
def test_decode_attention_kernel_matches_plain(cuda, b, h, kh, s, d, window,
                                               dtype):
    g = torch.Generator().manual_seed(s + d)
    q = torch.randn(b, h, d, generator=g).to(cuda, dtype)
    k, v = (torch.randn(b, kh, s, d, generator=g).to(cuda, dtype)
            for _ in range(2))
    # one valid entry, a full (wrapped) ring, and lengths in between
    lengths = torch.tensor([1, s, s // 3, 2 * s // 3][:b],
                           dtype=torch.int32, device=cuda)
    want = ref.decode_attention_ref(q, k, v, lengths, window=window)
    before = K3.launches
    got = ops.decode_attention(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert K3.launches == before + 1
    assert got.dtype == dtype
    # f32: the online softmax and the plain softmax differ in rounding
    # only; bf16: both round an f32 result once, at most one ulp apart
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    # deterministic: the chunks combine in a fixed order
    assert torch.equal(ops.decode_attention(q, k, v, lengths, window=window),
                       got)


def test_decode_attention_kernel_empty_rows_are_zero(cuda):
    q = torch.randn(2, 4, 32, device=cuda)
    k = torch.randn(2, 2, 64, 32, device=cuda)
    lengths = torch.tensor([0, 64], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, k, lengths)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(ops.decode_attention(q, k, k, lengths, window=0),
                       torch.zeros_like(got))


@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_is_batch_invariant(cuda, dtype, window):
    """A row's output is the same bits alone (B = 1) and inside a batch
    of 4 whose other rows have other lengths: the split of a sequence's
    positions depends only on S."""
    g = torch.Generator().manual_seed(7)
    b, h, kh, s, d = 4, 32, 4, 640, 128
    q = torch.randn(b, h, d, generator=g).to(cuda, dtype)
    k, v = (torch.randn(b, kh, s, d, generator=g).to(cuda, dtype)
            for _ in range(2))
    lens = [500, 1, 640, 129]
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    batch = ops.decode_attention(q, k, v, lengths, window=window)
    for i, n in enumerate(lens):
        alone = ops.decode_attention(
            q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
            v[i:i + 1].contiguous(),
            torch.tensor([n], dtype=torch.int32, device=cuda), window=window)
        assert torch.equal(alone[0], batch[i]), f"row {i} (length {n})"
    # the arrival counters are left at 0 for the next launch
    assert not K3.arrival_counters(cuda, b * kh).any()


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("runs,d", [(3, 64), (18, 30)])
def test_decode_attention_kernel_at_run_edges(cuda, dtype, window, runs, d):
    """Lengths 0, run - 1, run, run + 1 and S (a full ring), with and
    without a window that crosses a run's edge, against the plain
    version; the result is the same bits on a second launch.  The second
    shape has more runs than the last block stages in shared memory and a
    head dim whose rows are not 16-byte multiples (element-wise copies,
    and the CUDA-core path in bfloat16)."""
    run = K3.RUN
    g = torch.Generator().manual_seed(run + d)
    b, h, kh, s = 5, 16, 2, runs * run + 17
    q = torch.randn(b, h, d, generator=g).to(cuda, dtype)
    k, v = (torch.randn(b, kh, s, d, generator=g).to(cuda, dtype)
            for _ in range(2))
    lengths = torch.tensor([0, run - 1, run, run + 1, s], dtype=torch.int32,
                           device=cuda)
    want = ref.decode_attention_ref(q, k, v, lengths, window=window)
    got = ops.decode_attention(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(ops.decode_attention(q, k, v, lengths, window=window),
                       got)


def test_decode_attention_kernel_refuses(cuda):
    q = torch.zeros(2, 4, 32, device=cuda)
    k = torch.zeros(2, 2, 64, 32, device=cuda)
    n = torch.full((2,), 5, dtype=torch.int32, device=cuda)
    before = K3.launches
    with pytest.raises(ValueError, match="CUDA"):
        K3.decode_attention_cuda(q.cpu(), k.cpu(), k.cpu(), n.cpu())
    with pytest.raises(ValueError, match="int32"):
        K3.decode_attention_cuda(q, k, k, n.long())
    with pytest.raises(ValueError, match="H % KH"):
        K3.decode_attention_cuda(torch.zeros(2, 3, 32, device=cuda), k, k, n)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(2, 2, 8, 256, device=cuda)
        K3.decode_attention_cuda(torch.zeros(2, 4, 256, device=cuda), big,
                                 big, n)
    with pytest.raises(ValueError, match="contiguous"):
        K3.decode_attention_cuda(q, k.transpose(2, 3), k, n)
    assert K3.launches == before


def test_reduced_engine_on_card_matches_cpu(cuda):
    """yi-6b reduced (float32): the engine on the card, its decode
    attention on K3, emits the CPU engine's greedy tokens, and launches
    K3 once per layer per decode step."""
    cfg = get_config("yi-6b", reduced=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab - 2, n).astype(np.int32)
               for n in (5, 30, 1, 70, 12)]
    outs, steps = [], 0
    before = K3.launches
    for dev in ("cpu", cuda):
        eng = ServingEngine(bundle, model.to(dev), max_slots=4,
                            cache_len=64, device=dev)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, tokens=p, max_new_tokens=40))
        while True:
            more = eng.step()
            steps += eng.last_step["decoded"] and dev != "cpu"
            if not more:
                break
        outs.append({u: r.output for u, r in eng.results.items()})
    assert outs[0] == outs[1]
    assert K3.launches - before == cfg.n_layers * steps


def _paged_layout(cuda, b, kh, s, bs, d, dtype, mapped, seed):
    """A contiguous (B,KH,S,D) cache and the same rows in a permuted
    (P,KH,BS,D) pool; row i maps ``mapped[i]`` blocks, its unmapped
    tail on block 0 (zeros, as the contiguous rows past it)."""
    g = torch.Generator().manual_seed(seed)
    t = s // bs
    k, v = (torch.randn(b, kh, s, d, generator=g) for _ in range(2))
    n_blocks = sum(mapped) + 1
    ids = (torch.randperm(n_blocks - 1, generator=g) + 1).tolist()
    tables = torch.zeros(b, t, dtype=torch.int32)
    k_pool, v_pool = (torch.zeros(n_blocks, kh, bs, d) for _ in range(2))
    for i in range(b):
        k[i, :, mapped[i] * bs:] = 0
        v[i, :, mapped[i] * bs:] = 0
        for j in range(mapped[i]):
            tables[i, j] = ids.pop()
            k_pool[tables[i, j]] = k[i, :, j * bs:(j + 1) * bs]
            v_pool[tables[i, j]] = v[i, :, j * bs:(j + 1) * bs]
    return [x.to(cuda, dtype) for x in (k, v, k_pool, v_pool)] + [
        tables.to(cuda)]


# (b, h, kh, s, bs, d, window): Yi-6B's GQA 8 at head dim 128 and block
# sizes 8 to 64, Phi-3-mini's head dim 96, a window
PAGED_CASES = [(4, 32, 4, 512, 8, 128, None), (4, 32, 4, 512, 16, 128, None),
               (4, 32, 4, 512, 32, 128, None), (4, 32, 4, 512, 64, 128, None),
               (4, 8, 8, 256, 16, 96, None), (3, 8, 2, 256, 16, 64, 100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,s,bs,d,window", PAGED_CASES)
def test_paged_decode_attention_kernel_matches_plain_and_k3(
        cuda, b, h, kh, s, bs, d, window, dtype):
    """K4 against its plain version on a permuted table with unmapped
    tails (f32 within 1e-5, bf16 within one ulp, 2^-6), and bit-equal to
    K3 on the equal contiguous cache; block 0 is never read."""
    t = s // bs
    mapped = [t, max(1, t // 3), max(1, 2 * t // 3), t][:b]
    k, v, k_pool, v_pool, tables = _paged_layout(cuda, b, kh, s, bs, d,
                                                 dtype, mapped, s + bs + d)
    q = torch.randn(b, h, d, generator=torch.Generator().manual_seed(d)
                    ).to(cuda, dtype)
    lengths = torch.tensor([1, mapped[1] * bs, mapped[2] * bs - 3, s][:b],
                           dtype=torch.int32, device=cuda)
    want = ref.paged_decode_attention_ref(q, k_pool, v_pool, tables, lengths,
                                          window=window)
    before3, before4 = K3.launches, K4.launches
    got = ops.paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                                     window=window)
    contiguous = ops.decode_attention(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert (K3.launches - before3, K4.launches - before4) == (1, 1)
    assert got.dtype == dtype
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert torch.equal(got, contiguous)
    k_pool[0], v_pool[0] = float("nan"), float("nan")
    assert torch.equal(ops.paged_decode_attention(
        q, k_pool, v_pool, tables, lengths, window=window), got)


def test_paged_decode_attention_kernel_empty_rows_are_zero(cuda):
    q = torch.randn(2, 4, 32, device=cuda)
    pool = torch.randn(5, 2, 16, 32, device=cuda)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([0, 32], dtype=torch.int32, device=cuda)
    got = ops.paged_decode_attention(q, pool, pool, tables, lengths)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(ops.paged_decode_attention(q, pool, pool, tables,
                                                  lengths, window=0),
                       torch.zeros_like(got))


def _merge(outs, lses):
    """Partials over disjoint rows with their log-sum-exp, merged as the
    ranks of a mesh merge them (``Comm.combine``), in float32."""
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.max(dim=0).values)
    num = (torch.stack(outs).float() * w[..., None]).sum(dim=0)
    return num / w.sum(dim=0)[..., None]


def _check_split(outs, lses, counts, whole, plain_parts, dtype):
    """Each part against its plain version (f32 within 1e-5, bf16 within
    one ulp, 2^-6; lse within 1e-5 + 1e-5 relative: f32 sums of the
    scores in another order), empty parts 0 and -inf, and the
    merge against the unsplit kernel (f32 within 1e-5, bf16 within
    2^-6)."""
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    for out, lse, n, (want, want_lse) in zip(outs, lses, counts,
                                             plain_parts):
        torch.testing.assert_close(out.float(), want.float(), atol=atol,
                                   rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
        none = n == 0
        assert torch.equal(out[none], torch.zeros_like(out[none]))
        assert torch.isneginf(lse[none]).all()
    torch.testing.assert_close(_merge(outs, lses), whole.float(), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [2, 4])
def test_decode_attention_kernel_split_over_rows(cuda, dtype, m):
    """K3 on a rank's rows of Yi-6B's cache (4, 32, 4, 2048, 128) with
    its clamped lengths and ``return_lse``: each part against the plain
    version, the merge against the unsplit kernel; the lse launch's
    output bit-equal to the argument-free launch's (the same code path
    and arithmetic; ``tools/decode_attention_bits.py`` holds the
    argument-free launch bit-equal to the parent checkout's kernel)."""
    b, h, kh, s, d = 4, 32, 4, 2048, 128
    g = torch.Generator().manual_seed(m)
    q = torch.randn(b, h, d, generator=g).to(cuda, dtype)
    k, v = (torch.randn(b, kh, s, d, generator=g).to(cuda, dtype)
            for _ in range(2))
    lengths = torch.tensor([1, 37, 1500, 2048], dtype=torch.int32,
                           device=cuda)
    whole = ops.decode_attention(q, k, v, lengths)
    out, lse = ops.decode_attention(q, k, v, lengths, return_lse=True)
    assert torch.equal(out, whole)
    c = s // m
    outs, lses, counts, plain = [], [], [], []
    for r in range(m):
        n = torch.clamp(lengths - r * c, 0, c).to(torch.int32)
        kr, vr = (x[:, :, r * c:(r + 1) * c].contiguous() for x in (k, v))
        o, l_ = ops.decode_attention(q, kr, vr, n, return_lse=True)
        outs.append(o)
        lses.append(l_)
        counts.append(n)
        plain.append(ref.decode_attention_ref(q, kr, vr, n, return_lse=True))
    torch.cuda.synchronize()
    _check_split(outs, lses, counts, whole, plain, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [2, 4])
def test_paged_decode_attention_kernel_split_over_block_rows(cuda, dtype, m):
    """K4 on a rank's rows of every 16-row block (block size 16/m) of a
    permuted table, each rank counting its rows below each length: parts
    against the plain version, the merge against the unsplit kernel; the
    lse launch's output bit-equal to the argument-free one's."""
    b, h, kh, s, bs, d = 4, 32, 4, 2048, 16, 128
    t = s // bs
    _, _, k_pool, v_pool, tables = _paged_layout(cuda, b, kh, s, bs, d,
                                                 dtype, [t] * b, 11 + m)
    q = torch.randn(b, h, d, generator=torch.Generator().manual_seed(m)
                    ).to(cuda, dtype)
    lengths = torch.tensor([1, 37, 1500, 2048], dtype=torch.int32,
                           device=cuda)
    whole = ops.paged_decode_attention(q, k_pool, v_pool, tables, lengths)
    out, _ = ops.paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                                        return_lse=True)
    assert torch.equal(out, whole)
    held = bs // m
    outs, lses, counts, plain = [], [], [], []
    for r in range(m):
        n = ((lengths // bs) * held
             + torch.clamp(lengths % bs - r * held, 0, held)).to(torch.int32)
        kr, vr = (x[:, :, r * held:(r + 1) * held].contiguous()
                  for x in (k_pool, v_pool))
        o, l_ = ops.paged_decode_attention(q, kr, vr, tables, n,
                                           return_lse=True)
        outs.append(o)
        lses.append(l_)
        counts.append(n)
        plain.append(ref.paged_decode_attention_ref(q, kr, vr, tables, n,
                                                    return_lse=True))
    torch.cuda.synchronize()
    _check_split(outs, lses, counts, whole, plain, dtype)


def test_paged_decode_attention_kernel_refuses(cuda):
    q = torch.zeros(2, 4, 32, device=cuda)
    pool = torch.zeros(5, 2, 16, 32, device=cuda)
    tables = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    n = torch.full((2,), 5, dtype=torch.int32, device=cuda)
    before = K4.launches
    with pytest.raises(ValueError, match="CUDA"):
        K4.paged_decode_attention_cuda(q.cpu(), pool.cpu(), pool.cpu(),
                                       tables.cpu(), n.cpu())
    with pytest.raises(ValueError, match="int32"):
        K4.paged_decode_attention_cuda(q, pool, pool, tables.long(), n)
    with pytest.raises(ValueError, match="tables"):
        K4.paged_decode_attention_cuda(q, pool, pool, tables[:1], n)
    with pytest.raises(ValueError, match="H % KH"):
        K4.paged_decode_attention_cuda(torch.zeros(2, 3, 32, device=cuda),
                                       pool, pool, tables, n)
    with pytest.raises(ValueError, match="block size 24"):
        bad = torch.zeros(5, 2, 24, 32, device=cuda)
        K4.paged_decode_attention_cuda(q, bad, bad, tables, n)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(5, 2, 16, 256, device=cuda)
        K4.paged_decode_attention_cuda(torch.zeros(2, 4, 256, device=cuda),
                                       big, big, tables, n)
    with pytest.raises(ValueError, match="contiguous"):
        K4.paged_decode_attention_cuda(q, pool.transpose(2, 3), pool,
                                       tables, n)
    assert K4.launches == before


def test_reduced_paged_chunked_engine_on_card_matches_cpu(cuda):
    """yi-6b reduced (float32) with kv_block=8 and prefill_chunk=8: the
    card's tokens equal the paged CPU engine's and the contiguous CPU
    engine's; K4 runs once per layer per decode step, K3 never."""
    cfg = get_config("yi-6b", reduced=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab - 2, n).astype(np.int32)
               for n in (5, 30, 1, 70, 12, 41)]
    outs, steps = [], 0
    before3, before4 = K3.launches, K4.launches
    for dev, kw in (("cpu", {}), ("cpu", {"kv_block": 8,
                                           "prefill_chunk": 8}),
                    (cuda, {"kv_block": 8, "prefill_chunk": 8})):
        eng = ServingEngine(bundle, model.to(dev), max_slots=4,
                            cache_len=64, device=dev, **kw)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, tokens=p, max_new_tokens=40))
        while True:
            more = eng.step()
            steps += eng.last_step["decoded"] and dev != "cpu"
            if not more:
                break
        outs.append({u: r.output for u, r in eng.results.items()})
        if kw:
            assert eng.pool.free_blocks() == eng.pool.usable_blocks
    assert outs[0] == outs[1] == outs[2]
    assert K4.launches - before4 == cfg.n_layers * steps
    assert K3.launches == before3


# (m, k, n): a decode batch at Yi-6B's MLP widths, one row, and shapes
# off the kernels' tiles (rows of bytes not a multiple of 4 read byte by
# byte)
MM_CASES = [(4, 4096, 11008), (1, 11008, 4096), (3, 1000, 522),
            (5, 300, 96), (9, 17, 6), (1, 64, 130)]


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("m,k,n", MM_CASES)
def test_dequant_matmul_kernels_match_plain(cuda, m, k, n, int4):
    """K5 (int8) and K6 (int4) against their plain versions on the same
    quantized weight: within 1e-5 of the largest output (another float32
    summation order); a row's values do not depend on the other rows."""
    g = torch.Generator().manual_seed(m + k + n)
    leaf = lm_quant._quantize_leaf(torch.randn(k, n, generator=g).to(cuda),
                                   4 if int4 else 8)
    x = torch.randn(m, k, generator=g).to(cuda)
    w = leaf.q4 if int4 else leaf.q8
    plain = ref.dequant_matmul_i4_ref if int4 else ref.dequant_matmul_ref
    want = plain(x, w, leaf.qs)
    before = (K56.launches, K56.launches_i4)
    got = ops.dequant_matmul(x, leaf)
    torch.cuda.synchronize()
    assert (K56.launches - before[0], K56.launches_i4 - before[1]) == \
        ((0, 1) if int4 else (1, 0))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(ops.dequant_matmul(x[-1:], leaf), got[-1:])


def _dequant_case(cuda, k, n, int4, seed):
    """A quantized (k, n) weight's leaf, its kernel operand and scales, and
    a generator for x, made from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    leaf = lm_quant._quantize_leaf(torch.randn(k, n, generator=g).to(cuda),
                                   4 if int4 else 8)
    return leaf, (leaf.q4 if int4 else leaf.q8), leaf.qs.reshape(-1), g


def _dequant_kernel(int4):
    return K56.dequant_matmul_i4_cuda if int4 else K56.dequant_matmul_cuda


# (m, k, n): K below 16 and off 16; at and around a unit (UNIT_ROWS rows),
# a stage of int8 (2 units) and of int4 (4 units) and each ring's depth
# (4 x 2 and 3 x 4 units); unit counts below, at and above the grid's
# width (132 blocks) and twice it, so shares of one and two units; one
# column tile shared by 129 and by 132 blocks; a partial column tile on
# 16-byte rows
_U = K56.UNIT_ROWS
DEQUANT_EDGE_CASES = [
    (4, 1, 1024), (4, 7, 1024), (4, 15, 1024), (4, 16, 1024), (4, 17, 1024),
    (3, _U - 1, 1024), (3, _U, 1024), (3, _U + 1, 1024),
    (4, 2 * _U - 1, 1024), (4, 2 * _U + 1, 1024),
    (4, 4 * _U - 1, 1024), (4, 4 * _U + 1, 1024),
    (4, 8 * _U - 1, 1024), (4, 8 * _U + 1, 1024),
    (4, 12 * _U - 1, 1024), (4, 12 * _U + 1, 1024),
    (2, 16 * _U, 1024), (2, 16 * _U + 1, 1024),
    (4, 33 * _U, 1024), (4, 33 * _U + 1, 1024),
    (4, 129 * _U - 1, 128), (4, 20000, 128), (4, 300, 96)]


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("m,k,n", DEQUANT_EDGE_CASES)
def test_dequant_matmul_kernels_at_stage_and_share_edges(cuda, m, k, n,
                                                          int4):
    """K5 and K6 where the stream-K cut of the weight and its stages change
    shape: within 1e-5 of the largest output of the plain version, the
    same bits on a second call, and the arrival counters left at 0."""
    leaf, w, scale, g = _dequant_case(cuda, k, n, int4, 11 * k + n)
    x = torch.randn(m, k, generator=g).to(cuda)
    plain = ref.dequant_matmul_i4_ref if int4 else ref.dequant_matmul_ref
    want = plain(x, w, scale)
    got = _dequant_kernel(int4)(x, w, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(_dequant_kernel(int4)(x, w, scale), got)
    assert not K3.arrival_counters(cuda, 1).any()


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("m,k,n", [(4, 4096, 11008), (4, 11008, 4096),
                                   (3, 1000, 522)])
def test_dequant_matmul_kernels_are_deterministic(cuda, m, k, n, int4):
    """Two calls on the same operands give the same bits: at the decode
    step's shapes and on the byte-by-byte path."""
    _, w, scale, g = _dequant_case(cuda, k, n, int4, k + n)
    x = torch.randn(m, k, generator=g).to(cuda)
    first = _dequant_kernel(int4)(x, w, scale)
    assert torch.equal(_dequant_kernel(int4)(x, w, scale), first)


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("m", range(1, 10))
def test_dequant_matmul_kernels_are_batch_invariant(cuda, m, int4):
    """Each row of a batch of m (past 4, a second and third row tile) is
    the same bits alone: the cut of the weight and every order of
    summation depend on (K, N) only.  K 2000 and N 1536 make 192 units,
    shares of one and two units and tiles shared by several blocks."""
    k, n = 2000, 1536
    leaf, w, scale, g = _dequant_case(cuda, k, n, int4, 100 + m)
    x = torch.randn(m, k, generator=g).to(cuda)
    plain = ref.dequant_matmul_i4_ref if int4 else ref.dequant_matmul_ref
    want = plain(x, w, scale)
    batch = _dequant_kernel(int4)(x, w, scale)
    torch.testing.assert_close(batch, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    for i in range(m):
        alone = _dequant_kernel(int4)(x[i:i + 1].clone(), w, scale)
        assert torch.equal(alone[0], batch[i]), f"row {i} of {m}"


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_dequant_matmul_kernels_on_an_unaligned_weight(cuda, int4):
    """A weight whose pointer is not 16-byte aligned is read byte by byte
    into the same buffers: the same bits as the aligned weight."""
    _, w, scale, g = _dequant_case(cuda, 3000, 2048, int4, 7)
    x = torch.randn(4, 3000, generator=g).to(cuda)
    buf = torch.empty(w.numel() + 16, dtype=torch.int8, device=cuda)
    odd = buf[1:1 + w.numel()].view(w.shape)
    odd.copy_(w)
    assert odd.is_contiguous() and odd.data_ptr() % 16 != 0
    before = (K56.launches, K56.launches_i4)
    aligned = _dequant_kernel(int4)(x, w, scale)
    assert torch.equal(_dequant_kernel(int4)(x, odd, scale), aligned)
    assert (K56.launches - before[0], K56.launches_i4 - before[1]) == \
        ((0, 2) if int4 else (2, 0))
    assert not K3.arrival_counters(cuda, 1).any()


def test_dequant_matmul_kernels_refuse(cuda):
    x = torch.zeros(2, 8, device=cuda)
    w = torch.zeros(8, 4, dtype=torch.int8, device=cuda)
    s = torch.ones(4, device=cuda)
    before = (K56.launches, K56.launches_i4)
    with pytest.raises(ValueError, match="float32"):
        K56.dequant_matmul_cuda(x.half(), w, s)
    with pytest.raises(ValueError, match="int8"):
        K56.dequant_matmul_cuda(x, w.float(), s)
    with pytest.raises(ValueError, match="contract"):
        K56.dequant_matmul_cuda(x, w[:6], s)
    with pytest.raises(ValueError, match="scale"):
        K56.dequant_matmul_i4_cuda(x, w, s)
    with pytest.raises(ValueError, match="contiguous"):
        K56.dequant_matmul_cuda(x, w.t().contiguous().t(), s)
    assert (K56.launches, K56.launches_i4) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,s,bs,d,window", PAGED_CASES)
def test_paged_decode_attention_q_kernel_matches_plain_and_k4(
        cuda, b, h, kh, s, bs, d, window, dtype):
    """K7 on int8 pools with row scales against its plain version (f32
    within 1e-5, bf16 within one ulp, 2^-6), and bit-equal to K4 on the
    float32 pools that hold float(q8) * s (with q in float32, rounded to
    q's dtype after)."""
    t = s // bs
    mapped = [t, max(1, t // 3), max(1, 2 * t // 3), t][:b]
    _, _, k_pool, v_pool, tables = _paged_layout(cuda, b, kh, s, bs, d,
                                                 torch.float32, mapped,
                                                 s + bs + d)
    (kq, ks), (vq, vs) = quantize_kv_heads(k_pool), quantize_kv_heads(v_pool)
    q = torch.randn(b, h, d, generator=torch.Generator().manual_seed(d)
                    ).to(cuda, dtype)
    lengths = torch.tensor([1, mapped[1] * bs, mapped[2] * bs - 3, s][:b],
                           dtype=torch.int32, device=cuda)
    want = ref.paged_decode_attention_q_ref(q, kq, vq, ks, vs, tables,
                                            lengths, window=window)
    before = K7.launches
    got = ops.quant_paged_decode_attention(q, kq, vq, ks, vs, tables,
                                           lengths, window=window)
    k4 = ops.paged_decode_attention(q.float(), dequantize_kv_heads(kq, ks),
                                    dequantize_kv_heads(vq, vs), tables,
                                    lengths, window=window).to(dtype)
    torch.cuda.synchronize()
    assert K7.launches == before + 1
    assert got.dtype == dtype
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert torch.equal(got, k4)


def test_paged_decode_attention_q_kernel_refuses(cuda):
    q = torch.zeros(2, 4, 32, device=cuda)
    pool = torch.zeros(5, 2, 16, 32, dtype=torch.int8, device=cuda)
    sc = torch.ones(5, 2, 16, device=cuda)
    tables = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    n = torch.full((2,), 5, dtype=torch.int32, device=cuda)
    before = K7.launches
    with pytest.raises(ValueError, match="int8"):
        K7.paged_decode_attention_q_cuda(q, pool.float(), pool, sc, sc,
                                         tables, n)
    with pytest.raises(ValueError, match="float32"):
        K7.paged_decode_attention_q_cuda(q, pool, pool, sc.half(), sc,
                                         tables, n)
    with pytest.raises(ValueError, match="do not form"):
        K7.paged_decode_attention_q_cuda(q, pool, pool,
                                         sc[:, :, :8].contiguous(), sc,
                                         tables, n)
    with pytest.raises(ValueError, match="block size 24"):
        bad = torch.zeros(5, 2, 24, 32, dtype=torch.int8, device=cuda)
        K7.paged_decode_attention_q_cuda(q, bad, bad,
                                         torch.ones(5, 2, 24, device=cuda),
                                         torch.ones(5, 2, 24, device=cuda),
                                         tables, n)
    assert K7.launches == before


@pytest.mark.parametrize("wd,kd,bs", [("int8", "int8", None),
                                      ("int4", "int8", 8),
                                      ("int8", None, 16),
                                      (None, "int8", None)])
def test_reduced_quantized_engine_on_card_matches_cpu(cuda, wd, kd, bs):
    """yi-6b reduced (float32), quantized: the card's greedy tokens equal
    the CPU engine's, and each kernel of the path runs where it should —
    K5 or K6 three times per layer per decode step with quantized
    weights, K7 once per layer with a paged int8 KV, K4 with a paged
    float KV, K3 (over the dequantized cache) contiguous."""
    cfg = get_config("yi-6b", reduced=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab - 2, n).astype(np.int32)
               for n in (5, 30, 1, 70, 12)]
    kw = {"weight_dtype": wd, "kv_dtype": kd, "kv_block": bs}
    outs = []
    for dev in ("cpu", cuda):
        counts = [K3.launches, K4.launches, K7.launches, K56.launches,
                  K56.launches_i4]
        eng = ServingEngine(bundle, model.to(dev), max_slots=4,
                            cache_len=64, device=dev, **kw)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, tokens=p, max_new_tokens=40))
        steps = 0
        while True:
            more = eng.step()
            steps += eng.last_step["decoded"]
            if not more:
                break
        outs.append({u: r.output for u, r in eng.results.items()})
        counts = [now - was for now, was in zip(
            [K3.launches, K4.launches, K7.launches, K56.launches,
             K56.launches_i4], counts)]
    per = cfg.n_layers * steps
    attn = [0, 0, 0]
    attn[2 if (bs and kd) else 1 if bs else 0] = per
    mlp = [0, 0]
    if wd:
        mlp[wd == "int4"] = 3 * per
    assert counts == attn + mlp
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# K8: the SSD chunked scan
# ---------------------------------------------------------------------------

# tests/test_kernels.py's bound for the SSD scan against its oracle
SSD_ATOL, SSD_RTOL = 5e-4, 1e-3


def _ssd_inputs(cuda, b, s, h, p, g, n, dtype, seed, h0=False, d=False,
                tail=0):
    """Seeded scan inputs on the card: x, B, C in ``dtype``; dt, A, D and
    h0 float32; the last ``tail`` rows with dt = 0 (a padded chunk)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (b, s, h, p)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (b, s, h)).astype(
        np.float32))
    if tail:
        dt[:, s - tail:] = 0
    a = torch.from_numpy(-rng.uniform(0.5, 2.0, h).astype(np.float32))
    bm, cm = (torch.from_numpy(rng.normal(0, 1, (b, s, g, n)).astype(
        np.float32)) for _ in range(2))
    dd = torch.from_numpy(rng.normal(0, 1, h).astype(np.float32)) if d \
        else None
    st = (torch.from_numpy(rng.normal(0, 1, (b, h, p, n)).astype(np.float32))
          if h0 else None)
    on = lambda t, dt_=torch.float32: None if t is None else t.to(cuda, dt_)
    return (on(x, dtype), on(dt), on(a), on(bm, dtype), on(cm, dtype),
            on(dd), on(st))


# (b, s, h, p, g, n, chunk, dtype, h0, D, tail): Mamba2-780m's prefill
# shapes (48 heads of 64, N 128) at one and four chunks, with a carried
# state; Zamba2-1.2B's (64 heads, N 64); float32 at both; groups of 2
# with D; a length off 128 with the wrapper's chunk (64); a chunk of 13
# with P and N off the tiles; a padded tail of dt = 0 rows; then the
# chunk-step shape (one chunk with a carried state), 8 chunks, 3 chunks of
# 64, a carried state across several chunks in a batch of 2, and
# Zamba2-1.2B's one-shot prefill of 512 with a carried state
SSD_CASES = [
    (1, 128, 48, 64, 1, 128, None, torch.bfloat16, False, False, 0),
    (1, 512, 48, 64, 1, 128, None, torch.bfloat16, True, False, 0),
    (1, 256, 48, 64, 1, 128, None, torch.float32, True, False, 0),
    (1, 256, 64, 64, 1, 64, None, torch.bfloat16, False, False, 0),
    (1, 256, 64, 64, 1, 64, None, torch.float32, True, False, 0),
    (2, 256, 4, 32, 2, 64, None, torch.float32, False, True, 0),
    (1, 192, 8, 64, 1, 128, None, torch.float32, True, True, 0),
    (2, 26, 3, 24, 1, 20, 13, torch.float32, True, True, 0),
    (1, 128, 48, 64, 1, 128, None, torch.float32, True, False, 28),
    (1, 128, 48, 64, 1, 128, None, torch.bfloat16, True, False, 0),
    (1, 1024, 48, 64, 1, 128, None, torch.bfloat16, False, False, 0),
    (2, 192, 8, 64, 1, 128, 64, torch.bfloat16, False, True, 0),
    (2, 384, 16, 64, 2, 64, None, torch.float32, True, False, 0),
    (1, 512, 64, 64, 1, 64, None, torch.bfloat16, True, False, 0),
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype,h0,d,tail", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(cuda, b, s, h, p, g, n, chunk, dtype,
                                       h0, d, tail):
    args = _ssd_inputs(cuda, b, s, h, p, g, n, dtype, s + h + n, h0, d,
                       tail)
    x, dt, a, bm, cm, dd, st = args
    before = K8.launches
    y, state = ops.ssd_scan(x, dt, a, bm, cm, dd, chunk=chunk, h0=st)
    used = chunk or ops._pick_block(s)
    want_y, want_s = ref.ssd_scan_ref(x, dt, a, bm, cm, dd, chunk=used, h0=st)
    torch.cuda.synchronize()
    assert K8.launches == before + 1
    assert y.dtype == dtype and state.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    # bfloat16 y: each side rounds its float32 sum once, so the two may
    # differ by one bfloat16 ulp
    y_rtol = SSD_RTOL if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(y.float(), want_y.float(), atol=SSD_ATOL,
                               rtol=y_rtol)
    torch.testing.assert_close(state, want_s, atol=SSD_ATOL, rtol=SSD_RTOL)
    if dtype == torch.float32 and s <= 256:      # and the sequential oracle
        oy, os_ = ref.ssd_ref(x, dt, a, bm, cm, dd, h0=st)
        torch.testing.assert_close(y, oy, atol=SSD_ATOL, rtol=SSD_RTOL)
        torch.testing.assert_close(state, os_, atol=SSD_ATOL, rtol=SSD_RTOL)
    if tail:        # the padded rows neither decay nor add to the state
        _, real = ref.ssd_ref(x[:, :s - tail], dt[:, :s - tail], a,
                              bm[:, :s - tail], cm[:, :s - tail], dd, h0=st)
        torch.testing.assert_close(state, real, atol=SSD_ATOL, rtol=SSD_RTOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_kernel_is_deterministic(cuda, dtype):
    """Two calls on the same inputs give the same bits (no atomics), so a
    preempted and restored prefill repeats itself exactly."""
    x, dt, a, bm, cm, dd, st = _ssd_inputs(cuda, 1, 512, 48, 64, 1, 128,
                                           dtype, 7, h0=True, d=True)
    y1, s1 = K8.ssd_scan_cuda(x, dt, a, bm, cm, dd, chunk=128, h0=st)
    y2, s2 = K8.ssd_scan_cuda(x, dt, a, bm, cm, dd, chunk=128, h0=st)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.parametrize("s,dtype", [(512, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (256, torch.float32)])
def test_ssd_scan_kernel_is_batch_invariant(cuda, s, dtype):
    """Each row of a batch of 2 gets the bits it gets alone: the tiles
    depend on the shape, not on the batch."""
    x, dt, a, bm, cm, dd, st = _ssd_inputs(cuda, 2, s, 48, 64, 1, 128,
                                           dtype, 9, h0=True, d=True)
    y, state = K8.ssd_scan_cuda(x, dt, a, bm, cm, dd, chunk=128, h0=st)
    for r in range(2):
        one = lambda t: t[r:r + 1].contiguous()
        yr, sr = K8.ssd_scan_cuda(one(x), one(dt), a, one(bm), one(cm), dd,
                                  chunk=128, h0=one(st))
        torch.cuda.synchronize()
        assert torch.equal(y[r:r + 1], yr) and torch.equal(state[r:r + 1],
                                                           sr)


def test_ssd_scan_kernel_never_reaches_the_plain_version(cuda, monkeypatch):
    """A CUDA tensor launches K8 or raises: the wrapper's plain version is
    for CPU tensors only, and the model hook goes through the kernel."""
    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached ssd_scan_ref")
    monkeypatch.setattr(ops, "ssd_scan_ref", refuse)
    x, dt, a, bm, cm, _, st = _ssd_inputs(cuda, 1, 256, 8, 64, 1, 64,
                                          torch.bfloat16, 0, h0=True)
    before = K8.launches
    ops.ssd_scan(x, dt, a, bm, cm, h0=st)
    y, state = ops.ssd_chunked_kernel(x, dt, a, bm, cm,
                                      init_state=st.view(1, 1, 8, 64, 64))
    torch.cuda.synchronize()
    assert K8.launches == before + 2
    assert state.shape == (1, 1, 8, 64, 64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_chunked_kernel(x[:, :200], dt[:, :200], a, bm[:, :200],
                               cm[:, :200])
    assert K8.launches == before + 2


def test_ssd_scan_kernel_refuses(cuda):
    x, dt, a, bm, cm, _, st = _ssd_inputs(cuda, 1, 128, 4, 16, 1, 16,
                                          torch.float32, 1, h0=True)
    before = K8.launches
    bad = [dict(x=x.bfloat16()), dict(dt=dt.double()),
           dict(bm=bm[:, :, :, :8]), dict(x=x.transpose(2, 3)),
           dict(st=st[:, :2]), dict(chunk=256), dict(chunk=48)]
    for change in bad:
        kw = dict(x=x, dt=dt, a=a, bm=bm, cm=cm, st=st, chunk=128)
        kw.update(change)
        with pytest.raises(ValueError):
            K8.ssd_scan_cuda(kw["x"], kw["dt"], kw["a"], kw["bm"], kw["cm"],
                             chunk=kw["chunk"], h0=kw["st"])
    wide = torch.zeros(1, 128, 1, 132, device=cuda)
    with pytest.raises(ValueError, match="state width"):
        K8.ssd_scan_cuda(x, dt, a, wide, wide, chunk=128)
    assert K8.launches == before


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_reduced_recurrent_engines_on_card_match_cpu(cuda, arch):
    """mamba2 and zamba2 reduced (float32): the engine on the card, its
    prefill and prefill-chunk scans on K8, emits the CPU engine's greedy
    tokens, exact and chunked, and launches K8 once per layer per
    prefill or chunk."""
    cfg = get_config(arch, reduced=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab - 2, n).astype(np.int32)
               for n in (21, 13, 30, 1, 9)]
    for kw in ({}, {"prefill_chunk": 8}):
        outs = []
        for dev in ("cpu", cuda):
            before, runs = K8.launches, 0
            eng = ServingEngine(bundle, model.to(dev), max_slots=2,
                                cache_len=64, device=dev, **kw)
            for uid, p in enumerate(prompts):
                eng.submit(Request(uid=uid, tokens=p, max_new_tokens=12))
            while True:
                more = eng.step()
                runs += (len(eng.last_step["prefill_tokens"])
                         + eng.last_step["chunks"])
                if not more:
                    break
            outs.append({u: r.output for u, r in eng.results.items()})
        assert outs[0] == outs[1], kw
        assert K8.launches - before == cfg.n_layers * runs


# ---------------------------------------------------------------------------
# compile once: CUDA-graph replays against eager runs
# ---------------------------------------------------------------------------

def _state(tensors):
    return [t.clone() for t in tensors]


def _replay_equals_eager(program, args, written):
    """Call ``program`` on ``args`` (captured, then a replay), then, from
    the same starting values of the tensors it writes in place
    (``written``), once eagerly: outputs and written tensors bit-equal."""
    start = _state(written)
    program(*args)                          # captured after a warm-up
    for t, s in zip(written, start):
        t.copy_(s)
    got = program(*args)                    # a replay
    got = [t.clone() for t in torch.utils._pytree.tree_leaves(got)
           if isinstance(t, torch.Tensor)]
    got_written = _state(written)
    for t, s in zip(written, start):
        t.copy_(s)
    with disable_capture():
        want = [t for t in torch.utils._pytree.tree_leaves(program(*args))
                if isinstance(t, torch.Tensor)]
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got + got_written, want + list(written)):
        assert torch.equal(g, w)


def _reduced(arch):
    cfg = get_config(arch, reduced=True)
    bundle = get_model(cfg)
    return bundle, bundle.init(torch.Generator().manual_seed(0))


def test_micro_invoke_replay_equals_eager(cuda):
    for int8 in (False, True):
        gb = build_fc_stack()
        blob = (export(gb, representative_dataset(gb), quantize_int8=True)
                if int8 else export(gb))
        model = MicroModel(blob)
        res = AllOpsResolver(tags=("cuda", "reference"))
        it = MicroInterpreter(model, res,
                              MicroInterpreter.required_arena_size(model, res),
                              device=cuda)
        x = np.random.default_rng(1).normal(0, 1, it.input_spec(0).shape)
        it.set_input(0, x.astype(np.float32))
        buf = it.shared.take()
        _replay_equals_eager(it.compiled.execute,
                             (buf, it._variables, it._inputs), [buf])
        it.shared.put(buf)
        assert capture_count(it.compiled.program) == 1


ENGINE_CASES = {"contiguous": ("yi-6b", {}),
                "paged-chunked": ("yi-6b", {"kv_block": 8,
                                            "prefill_chunk": 8}),
                "int8": ("yi-6b", {"weight_dtype": "int8",
                                   "kv_dtype": "int8"}),
                "int4-paged": ("yi-6b", {"weight_dtype": "int4",
                                         "kv_dtype": "int8", "kv_block": 8}),
                "mamba2-chunked": ("mamba2-780m", {"prefill_chunk": 8}),
                "zamba2-chunked": ("zamba2-1.2b", {"prefill_chunk": 8})}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_programs_replay_equal_eager(cuda, case):
    """Each program of a reduced engine on the card — decode, prefill and
    (chunking) the chunk step — replayed is bit-equal to the same call
    run eagerly; the engine's tokens equal an eager engine's, with one
    decode program, one chunk program and one prefill program per
    prompt length."""
    arch, kw = ENGINE_CASES[case]
    bundle, model = _reduced(arch)
    model = model.to(cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, bundle.cfg.vocab - 2, n).astype(np.int32)
               for n in (21, 13, 30, 9)]
    outs = []
    for eager in (True, False):
        eng = ServingEngine(bundle, model, max_slots=2, cache_len=64,
                            prefill_buckets=False, device=cuda, **kw)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, tokens=p, max_new_tokens=8))
        if eager:
            with disable_capture():
                res = eng.run()
        else:
            res = eng.run()
        outs.append({u: r.output for u, r in res.items()})
    assert outs[0] == outs[1]
    assert capture_count(eng._decode) == 1
    assert eng.chunk_compiles() == (1 if "prefill_chunk" in kw else 0)
    state = (list(eng.kv_pool.values()) + [eng.block_tables] if eng.paged
             else list(eng.cache.values()))
    state += [eng.cur_tokens, eng.lengths]
    eng.lengths.copy_(torch.tensor([20, 40], dtype=torch.int32))
    if eng.paged:
        eng.block_tables.copy_(torch.arange(1, 17, dtype=torch.int32)
                               .reshape(2, 8))
    kv = ((eng.kv_pool, eng.block_tables) if eng.paged else (eng.cache,))
    args = ((eng.params, *kv, eng.cur_tokens, eng.lengths),)
    _replay_equals_eager(eng._decode, args, state)
    toks = eng._prefill_tokens[:, :8]       # the 9-token prompt's prefill
    _replay_equals_eager(eng._prefill, ((eng.params, {"tokens": toks}),),
                         [])
    if eng.chunk_tokens:
        eng._chunk_start.fill_(16)
        eng._chunk_real.fill_(5)
        if eng.paged:
            eng._chunk_row.copy_(torch.arange(1, 9, dtype=torch.int32))
            args = (eng.params, eng.kv_pool, eng._chunk_row,
                    eng._chunk_tokens, eng._chunk_start)
            written = list(eng.kv_pool.values())
        else:
            args = (eng.params, eng._chunk_cache, eng._chunk_tokens,
                    eng._chunk_start) + ((eng._chunk_real,)
                                         if eng._recurrent_chunk else ())
            written = list(eng._chunk_cache.values())
        _replay_equals_eager(eng._prefill_chunk, (args,), written)


def test_arena_rebinding_recaptures_the_first_tenant(cuda):
    """A second tenant grows the shared arena pool; the first tenant's
    next invoke drops its graph on the old buffer, captures on the new
    one and answers as before."""
    res = AllOpsResolver(tags=("cuda", "reference"))
    small = MicroModel(export(build_fc_stack()))
    large = MicroModel(export(build_vww()))
    pool = ArenaPool(cuda)
    a = MicroInterpreter(small, res,
                         MicroInterpreter.required_arena_size(small, res),
                         shared=pool, device=cuda)
    x = np.random.default_rng(2).normal(0, 1, a.input_spec(0).shape
                                        ).astype(np.float32)
    outs = []
    for _ in range(3):
        a.set_input(0, x)
        a.invoke()
        outs.append(a.output(0))
    assert a.compiled.program.captures == 1
    b = MicroInterpreter(large, res,
                         MicroInterpreter.required_arena_size(large, res),
                         shared=pool, device=cuda)
    b.set_input(0, np.zeros(b.input_spec(0).shape, np.float32))
    b.invoke()
    assert pool.alloc_count == 2
    a.set_input(0, x)
    a.invoke()
    assert a.compiled.program.captures == 2
    assert capture_count(a.compiled.program) == 1
    for out in outs[1:] + [a.output(0)]:
        np.testing.assert_array_equal(out, outs[0])


def test_device_memory_flat_over_replayed_steps(cuda):
    """After the decode program is captured, 32 replayed decode steps
    allocate nothing."""
    bundle, model = _reduced("yi-6b")
    eng = ServingEngine(bundle, model.to(cuda), max_slots=2, cache_len=64,
                        device=cuda)
    rng = np.random.default_rng(4)
    for uid in range(2):
        eng.submit(Request(uid=uid, tokens=rng.integers(
            0, bundle.cfg.vocab - 2, 6).astype(np.int32),
            max_new_tokens=40))
    for _ in range(3):
        eng.step()
    # free what earlier tests left in reference cycles first: a collection
    # during the loop would move the count by memory not this engine's
    gc.collect()
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    captures = eng._decode.captures
    for _ in range(32):
        eng.step()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == mem
    assert eng._decode.captures == captures == 1


def test_new_prompt_lengths_add_no_device_memory(cuda):
    """An engine without buckets (Mamba2: one prefill program a prompt
    length) serves 24 prompts of distinct lengths one after another:
    after the first, device memory never grows (the prefill programs
    share their outputs and the engine's one graph pool), and the
    engine holds at most ``PREFILL_PROGRAMS`` prefill programs."""
    bundle, model = _reduced("mamba2-780m")
    eng = ServingEngine(bundle, model.to(cuda), max_slots=2, cache_len=64,
                        device=cuda)
    rng = np.random.default_rng(5)
    lengths = range(2, 2 + PREFILL_PROGRAMS + 8)
    gc.collect()                # what earlier tests left in cycles
    mem = None
    for n in lengths:
        eng.submit(Request(uid=n, tokens=rng.integers(
            0, bundle.cfg.vocab - 2, n).astype(np.int32), max_new_tokens=3))
        eng.run()
        torch.cuda.synchronize()
        if mem is None:
            mem = torch.cuda.memory_allocated()
        assert torch.cuda.memory_allocated() == mem
    assert eng.prefill_compiles() == PREFILL_PROGRAMS
    assert eng._prefill.evictions == len(lengths) - PREFILL_PROGRAMS
    assert all(p.pool is eng.graph_pool for p in eng.programs().values())


def test_a_capture_that_fails_raises(cuda):
    """A program that reads a device value on the host cannot be
    captured: the call raises, nothing runs eagerly in its place and no
    signature is kept."""
    prog = CapturedProgram(lambda x: (x * 2).cpu(), name="host read")
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        prog(x)
    assert capture_count(prog) == 0
    torch.cuda.synchronize()
    assert torch.equal((x + 1).cpu(), torch.full((4,), 2.0))


# ---------------------------------------------------------------------------
# the micro interpreter complete: K1 and K2 at their new path shapes, the
# ragged pool on the card
# ---------------------------------------------------------------------------

def test_quant_matmul_rows_path_is_row_independent(cuda):
    """The 16 lanes of the batched int8 FC reach K1 as one call of M = 16
    (rows path): each row's output is bit-equal to that row alone, M = 1,
    and to the plain version."""
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.integers(-128, 128, (16, 64), dtype=np.int8))
    w_nk = torch.from_numpy(rng.integers(-128, 128, (32, 64), dtype=np.int8))
    bias = torch.from_numpy(rng.integers(-500, 500, 32, dtype=np.int32))
    scale = torch.from_numpy(rng.uniform(1e-4, 5e-3, 32).astype(np.float32))
    w = w_nk.to(cuda).t()                          # the FC layer's view
    assert K1.path(16, 64, w.stride()) == "rows"
    args = (bias.to(cuda), 3, scale.to(cuda), -7)
    rows = ops.quant_matmul(x.to(cuda), w, *args)
    alone = torch.cat([ops.quant_matmul(x[i:i + 1].to(cuda), w, *args)
                       for i in range(16)])
    want = ref.quant_matmul_ref(x, w_nk.t(), bias, 3, scale, -7)
    torch.testing.assert_close(rows.cpu(), want, rtol=0, atol=0)
    torch.testing.assert_close(alone.cpu(), want, rtol=0, atol=0)


def test_flash_attention_kernel_at_yi_6b_heads(cuda):
    """K2 at the decoder block's shape, (1, 32, 256, 128) causal float32,
    within 1e-5 of the plain version."""
    g = torch.Generator().manual_seed(128)
    q, k, v = (torch.randn(1, 32, 256, 128, generator=g).to(cuda)
               for _ in range(3))
    got = K2.flash_attention_cuda(q, k, v, causal=True)
    want = ref.mha_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


def test_ragged_pool_on_card_bit_equal_and_memory_flat(cuda):
    """A ragged pool of the int8 FC stack (K1 at M = 16) and the float
    hotword (exact) on the card: 50 waves of churning occupancy, every
    active lane bit-equal to its request alone through a MicroInterpreter
    on the card, one masked program per bucket, device memory exact from
    the second wave on."""
    from repro_torch.apps.models import build_hotword
    from repro_torch.core import RaggedInterpreterPool

    res = AllOpsResolver(tags=("cuda", "reference"))
    gb = build_fc_stack()
    fc = MicroModel(export(gb, representative_dataset(gb),
                           quantize_int8=True))
    hw = MicroModel(export(build_hotword(n_layers=1)))
    alone = {name: MicroInterpreter(m, res,
                                    MicroInterpreter.required_arena_size(
                                        m, res), device=cuda)
             for name, m in (("fc", fc), ("hw", hw))}
    pool = RaggedInterpreterPool(device=cuda)
    pool.add_bucket("fc", fc, res, lanes=16)
    pool.add_bucket("hw", hw, res, lanes=4, exact=True)
    rng = np.random.default_rng(50)
    hw_lane = pool.admit("hw", uid=0)
    gc.collect()                # what earlier tests left in cycles
    frames = []
    base = None
    for wave in range(50):
        n = 1 + wave % 16
        slots = [pool.admit("fc") for _ in range(n)]
        xs = [rng.normal(0, 1, (1, 64)).astype(np.float32) for _ in slots]
        for slot, x in zip(slots, xs):
            pool.set_input("fc", slot, 0, x)
        frames.append(rng.normal(0, 1, (1, 40)).astype(np.float32))
        pool.set_input("hw", hw_lane, 0, frames[-1])
        pool.dispatch()
        got = pool.outputs("fc", 0)
        for slot, x in zip(slots, xs):
            alone["fc"].set_input(0, x)
            alone["fc"].invoke()
            np.testing.assert_array_equal(got[slot], alone["fc"].output(0))
            pool.retire("fc", slot)
        alone["hw"].set_input(0, frames[-1])
        alone["hw"].invoke()
        np.testing.assert_array_equal(pool.output("hw", hw_lane, 0),
                                      alone["hw"].output(0))
        torch.cuda.synchronize()
        # the first wave's outputs are its eager warm-up's, freed at the
        # second; from then on nothing may move
        if wave == 1:
            base = torch.cuda.memory_allocated(cuda)
        assert base is None or torch.cuda.memory_allocated(cuda) == base
    assert capture_count(pool.program("fc")) == 1
    assert capture_count(pool.program("hw")) == 1
    assert pool.program("fc").captures == pool.program("hw").captures == 1


# ---------------------------------------------------------------------------
# the moe, vlm and audio families, and quantized recurrent serving
# ---------------------------------------------------------------------------

def test_moe_block_on_card_matches_cpu_and_repeats(cuda):
    """DeepSeek-MoE-16B reduced (float32): the MoE block on the card
    within 1e-5 of the CPU's largest output, and two calls bit-equal (the
    combine gathers and sums in a fixed order, no atomics)."""
    from repro_torch.models import lm
    cfg = get_config("deepseek-moe-16b", reduced=True)
    model = get_model(cfg).init(torch.Generator().manual_seed(0))
    x = torch.randn(4, 33, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    moe = model.layers[0].moe
    want, _ = lm.moe_block(moe, cfg, x)
    moe.to(cuda)
    got, _ = lm.moe_block(moe, cfg, x.to(cuda))
    again, _ = lm.moe_block(moe, cfg, x.to(cuda))
    assert torch.equal(got, again)
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err <= 1e-5


def _family_extras(cfg, uid):
    rng = np.random.default_rng(100 + uid)
    if cfg.family == "vlm":
        return {"vision": rng.normal(0, 1, (cfg.n_vision_tokens,
                                            cfg.d_vision)).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.normal(0, 1, (cfg.n_audio_ctx,
                                            cfg.d_model)).astype(np.float32)}
    return None


# arch -> engine keywords; the kernel each decode step launches per layer
FAMILY_CASES = {
    "deepseek-moe-16b": [({}, "decode_attention"),
                         ({"prefill_buckets": False, "kv_block": 8},
                          "paged_decode_attention"),
                         ({"weight_dtype": "int8", "kv_dtype": "int8",
                           "kv_block": 8}, "paged_decode_attention_q")],
    "qwen3-moe-30b-a3b": [({}, "decode_attention")],
    "paligemma-3b": [({}, None), ({"prefill_chunk": 8}, None)],
    "whisper-large-v3": [({}, None)],
    "mamba2-780m": [({"weight_dtype": "int4"}, None)],
}


@pytest.mark.parametrize("arch", list(FAMILY_CASES))
def test_reduced_family_engines_on_card_match_cpu(cuda, arch):
    """The moe, vlm and audio families and quantized Mamba-2 reduced
    (float32): the engine on the card emits the CPU engine's greedy
    tokens; moe's decode steps launch their attention kernel once per
    layer, vlm's and Whisper's launch none (reference attention, as in
    the JAX package), quantized Mamba-2's prefill runs its scan on K8."""
    from repro_torch.kernels import _build
    cfg = get_config(arch, reduced=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab - 2, n).astype(np.int32)
               for n in (21, 13, 30, 1, 9)]
    cache_len = 64 + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    for kw, kernel in FAMILY_CASES[arch]:
        outs = []
        for dev in ("cpu", cuda):
            before = dict(_build.launches)
            eng = ServingEngine(bundle, model.to(dev), max_slots=2,
                                cache_len=cache_len, device=dev, **kw)
            for uid, p in enumerate(prompts):
                eng.submit(Request(uid=uid, tokens=p, max_new_tokens=12,
                                   extras=_family_extras(cfg, uid)))
            steps = prefills = 0
            while True:
                more = eng.step()
                steps += eng.last_step["decoded"]
                prefills += len(eng.last_step["prefill_tokens"])
                if not more:
                    break
            outs.append({u: r.output for u, r in eng.results.items()})
        assert outs[0] == outs[1], kw
        new = {k: n - before[k] for k, n in _build.launches.items()
               if n != before[k]}
        if kernel is not None:
            assert new.get(kernel) == cfg.n_layers * steps, (kw, new)
        elif cfg.family == "ssm":
            assert new == {"ssd_scan": cfg.n_layers * prefills}, new
        else:
            assert new == {}, (kw, new)


@pytest.mark.parametrize("kv_block", [None, 16], ids=["contiguous", "paged"])
def test_overlap_two_pinned_buffers_equal_sync(cuda, kv_block):
    """The overlapped loop on the card over 64+ decode steps, with budgets
    that retire slots one step late and more requests than slots, so
    freed slots are admitted again while a step is in flight: the tokens
    are the sync engine's, request for request, and the two pinned
    readback buffers alternate (a single shared one would let step i+1's
    copy overwrite step i's tokens before they are read)."""
    bundle, model = _reduced("yi-6b")
    model = model.to(cuda)
    rng = np.random.default_rng(22)
    reqs = [(rng.integers(0, bundle.cfg.vocab - 2, int(n)).astype(np.int32),
             int(k))
            for n, k in zip(rng.integers(2, 40, 16), rng.integers(1, 32, 16))]

    late = []

    def run(**kw):
        eng = ServingEngine(bundle, model, max_slots=3, cache_len=64,
                            kv_block=kv_block, device=cuda, **kw)
        admit = eng._admit

        def watched(req, slot):
            # an admission into a slot whose retired request the step in
            # flight was dispatched with
            step = eng._inflight
            late.append(step is not None and any(
                s == slot and res.done for s, res, _ in step.slots))
            admit(req, slot)
        eng._admit = watched
        for uid, (toks, new) in enumerate(reqs):
            eng.submit(Request(uid=uid, tokens=toks, max_new_tokens=new))
        steps = 0
        while eng.step():
            steps += eng.last_step["decoded"]
        return eng, steps, {u: r.output for u, r in eng.results.items()}

    _, _, want = run()
    eng, steps, got = run(overlap=True)
    assert steps >= 64 and any(late)
    assert got == want
    assert capture_count(eng._decode) == capture_count(eng._argmax) == 1
    hosts = eng._readback._host
    assert len(hosts) == 2 and all(h.is_pinned() for h in hosts)
    assert hosts[0].data_ptr() != hosts[1].data_ptr()
    if kv_block:
        assert eng.pool.free_blocks() == eng.pool.usable_blocks


def test_streaming_server_captures_on_the_loop_thread(cuda):
    """A StreamingServer's engine is captured on the server's loop thread
    (the only thread that touches CUDA while it runs) and streams the
    sync engine's tokens; shutdown() ends an unfinished stream."""
    import threading

    from repro_torch.launch.serve import StreamingServer

    bundle, model = _reduced("qwen3-32b")
    model = model.to(cuda)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, bundle.cfg.vocab - 2, int(n)).astype(np.int32)
               for n in rng.integers(4, 20, 4)]
    sync = ServingEngine(bundle, model, max_slots=2, cache_len=64,
                         device=cuda)
    for uid, p in enumerate(prompts):
        sync.submit(Request(uid=uid, tokens=p, max_new_tokens=6))
    want = {u: r.output for u, r in sync.run().items()}

    eng = ServingEngine(bundle, model, max_slots=2, cache_len=64,
                        overlap=True, device=cuda)
    threads = set()
    decode = eng._decode.fn

    def traced_decode(*args):
        threads.add(threading.current_thread().name)
        return decode(*args)
    eng._decode.fn = traced_decode
    server = StreamingServer(eng).start()
    try:
        for uid, p in enumerate(prompts):
            server.submit(p, max_new_tokens=6, uid=uid)
        got = {uid: [ev.token for ev in server.stream(uid, timeout=120)]
               for uid in range(len(prompts))}
        cut = server.submit(prompts[0], max_new_tokens=2000)
    finally:
        server.shutdown()
    assert got == want
    assert threads == {"serving-loop"}
    assert eng._decode.captures == capture_count(eng._argmax) == 1
    res = server.result(cut)
    if res is None or not res.done:
        with pytest.raises(RuntimeError, match="shut down"):
            list(server.stream(cut, timeout=5.0))


def test_capture_with_a_program_cycle_pending(cuda):
    """A captured program that only a reference cycle holds (as an engine
    whose program is its bound method is) is freed by the cyclic
    collector, never in the middle of another program's capture, which
    freeing a graph would invalidate: with the collector at its most
    eager, every new capture still succeeds and replays."""
    x = torch.arange(8, dtype=torch.float32, device=cuda)
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        for i in range(3):
            holder = {}
            holder["self"] = holder
            holder["program"] = CapturedProgram(lambda t: t * 2, name="cycle")
            holder["program"](x)
            assert holder["program"].captures == 1
            del holder                      # only the cycle holds it now
            fresh = CapturedProgram(lambda t, i=i: t + i, name="fresh")
            assert torch.equal(fresh(x), x + i)     # eager run + capture
            assert torch.equal(fresh(x), x + i)     # replay
            assert fresh.captures == 1
    finally:
        gc.set_threshold(*thresholds)


def _calibrated(cuda, **kw):
    """(bundle, model on the card, profile) of the reduced qwen3-32b
    calibrated on the card through the real programs."""
    from repro_torch.core import calibrate

    bundle = get_model(get_config("qwen3-32b", reduced=True))
    model = bundle.init(torch.Generator(cuda).manual_seed(0))
    lengths = [5] * 6 + [7] * 4 + [9] * 4 + [41] * 2
    prof = calibrate(bundle, model, lengths, cache_len=64, seed=0,
                     candidate_levels=(8, 16, 40, 64),
                     chunk_candidates=(0, 8), iters=3, device=cuda, **kw)
    return bundle, model, prof, lengths


def test_calibration_on_card_adds_one_capture_per_measurement(cuda):
    """The card's measurer times every program through the engine's bound
    buffers: each measurement is exactly one new capture of the program
    it times (a second measurement of a captured shape adds none and
    raises), the engines share the weight module, and the profile is the
    card's."""
    from repro_torch.core import EngineMeasurer

    bundle = get_model(get_config("qwen3-32b", reduced=True))
    model = bundle.init(torch.Generator(cuda).manual_seed(0))
    m = EngineMeasurer(bundle, model, 64, seed=0, iters=3, device=cuda)
    for L in (8, 16, 40):
        m("prefill", L)
    eng = m._engine(0)
    assert capture_count(eng._prefill) == 3 and eng._prefill.captures == 3
    with pytest.raises(RuntimeError, match="added 0 captures"):
        m("prefill", 16)
    for kind, size in (("chunk", 8), ("decode", 2), ("decode_paged", 16),
                       ("decode_q:int8:int8", 2)):
        t = m(kind, size)
        assert t.compile_us > t.step_us > 0
    assert m._engine(8)._prefill_chunk.captures == 1
    for key in (("decode", 2), ("decode_paged", 16),
                ("decode_q:int8:int8", 2)):
        assert m._aux(*key)._decode.captures == 1
    assert m._aux("decode", 2).params is model
    m.close()
    _, _, prof, _ = _calibrated(cuda)
    assert prof.meta["device"] == "cuda"
    assert prof.meta["device_name"] == torch.cuda.get_device_name(cuda)
    assert prof.matches_device(cuda) and not prof.matches_device("cpu")


def test_from_profile_on_card_equals_hand_configured(cuda):
    """The engine built from a card profile is bit-equal to one configured
    by hand with the same table and chunk, and captures exactly the
    predicted prefill programs."""
    from repro_torch.core import BucketTable

    bundle, model, prof, lengths = _calibrated(cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, bundle.cfg.vocab - 2, L).astype(np.int32)
               for L in lengths]

    def run(eng):
        for uid, toks in enumerate(prompts):
            eng.submit(Request(uid=uid, tokens=toks, max_new_tokens=3))
        eng.run()
        return {u: r.output for u, r in eng.results.items()}

    tuned = ServingEngine.from_profile(bundle, model, prof, max_slots=2,
                                       device=cuda)
    hand = ServingEngine(bundle, model, max_slots=2, cache_len=64,
                         prefill_buckets=BucketTable.from_levels(
                             prof.bucket_levels),
                         prefill_chunk=prof.prefill_chunk or None,
                         device=cuda)
    assert run(tuned) == run(hand)
    assert tuned.prefill_compiles() == prof.predicted_compiles \
        == hand.prefill_compiles()


def test_card_profile_is_refused_by_a_cpu_engine(cuda):
    """A profile measured on the card never configures a CPU engine, and
    a CPU profile never configures a card engine."""
    from repro_torch.core import calibrate

    bundle, model, prof, lengths = _calibrated(cuda)
    cpu_model = bundle.init(torch.Generator("cpu").manual_seed(0))
    with pytest.raises(ValueError, match="measured on"):
        ServingEngine.from_profile(bundle, cpu_model, prof, max_slots=2,
                                   device="cpu")
    cpu_prof = calibrate(bundle, cpu_model, lengths, cache_len=64,
                         candidate_levels=(8, 64), chunk_candidates=(),
                         iters=1, device="cpu")
    with pytest.raises(ValueError, match="measured on"):
        ServingEngine.from_profile(bundle, model, cpu_prof, max_slots=2,
                                   device=cuda)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        with pytest.raises(RuntimeError, match="untraced"):
            calibrate(bundle, model, lengths, cache_len=64,
                      candidate_levels=(8,), chunk_candidates=(),
                      device=cuda)


@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-moe-16b",
                                  "mamba2-780m", "whisper-large-v3"])
def test_train_step_replay_equals_eager(cuda, arch):
    """A reduced float32 train step, captured (one CUDA graph, replayed
    from the second call) against the same step eager under
    ``disable_capture()``, 3 steps from the same weights and batches:
    metrics within 1e-5 relative, every parameter within 1e-5 of its
    leaf's largest entry + lr / 2 and no more than 1% of a leaf's
    elements (at least 1) beyond 1e-5 of it (Adam's step of an element
    whose gradient is within rounding of 0 is a fraction of lr that the
    rounding sets, as in tests/test_torch_training.py)."""
    import copy

    from repro_torch.data import make_batches
    from repro_torch.training import init_train_state, make_train_step

    lr = 1e-3
    cfg = get_config(arch, reduced=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator(cuda).manual_seed(0))
    states = [init_train_state(model),
              init_train_state(copy.deepcopy(model))]
    steps = [make_train_step(bundle.loss, lr=lr, remat=True, data_shards=1)
             for _ in states]
    for batch in make_batches(cfg, 4, 32, 3, seed=0):
        _, got = steps[0](states[0], batch)
        with disable_capture():
            _, want = steps[1](states[1], batch)
        for k, w in want.items():
            assert abs(float(got[k]) - float(w)) <= \
                1e-5 * max(abs(float(w)), 1e-30), k
    assert capture_count(steps[0].program) == 1
    assert capture_count(steps[1].program) == 0
    for (n, p), (_, q) in zip(states[0].params.named_parameters(),
                              states[1].params.named_parameters()):
        d = (p - q).abs()
        top = float(q.abs().max()) or 1.0
        assert float(d.max()) <= 1e-5 * top + lr / 2, n
        assert int((d > 1e-5 * top).sum()) <= max(1e-2 * d.numel(), 1), n


def test_kernel_wrapper_refuses_a_differentiated_cuda_input(cuda):
    """A kernel launch has no backward: with grad enabled, a CUDA input
    that requires grad is refused before the launch; detached, it
    launches."""
    q = torch.randn(2, 8, 64, device=cuda, requires_grad=True)
    kc = torch.randn(2, 2, 128, 64, device=cuda)
    lengths = torch.tensor([5, 100], dtype=torch.int32, device=cuda)
    before = K3.launches
    with pytest.raises(ops.NoBackwardError, match="decode_attention"):
        ops.decode_attention(q, kc, kc, lengths)
    assert K3.launches == before
    with torch.no_grad():
        out = ops.decode_attention(q, kc, kc, lengths)
    torch.cuda.synchronize()
    assert K3.launches == before + 1 and out.shape == (2, 8, 64)
