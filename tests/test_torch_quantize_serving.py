"""Quantized serving's primitives and kernels in the port against the JAX
package: packed int4 and the per-head int8 KV quantization (bit-equal),
``quantize_lm_params`` on the four reduced dense configs (bit-equal,
and ``qparams_from_jax`` carrying the JAX quantized tree leaf for leaf),
and the plain versions of K5, K6 (``dequant_matmul_ref``,
``dequant_matmul_i4_ref``) and K7 (``paged_decode_attention_q_ref``)
against the JAX wrappers, whose Pallas kernels run in interpret mode.
Inputs come from numpy seeds; each check states its tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as jax_get_config
from repro.core import quantize as jax_quantize
from repro.kernels import ops as jax_ops
from repro.kernels.decode_attention import paged_decode_attention_q_pallas
from repro.kernels.dequant_matmul import (dequant_matmul_i4_pallas,
                                          dequant_matmul_pallas)
from repro.models import lm as jax_lm
from repro.models import lm_quant as jax_lm_quant

from repro_torch.configs import get_config
from repro_torch.core import quantize as Q
from repro_torch.kernels import dequant_matmul as K56
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_decode_attention_q as K7
from repro_torch.models import lm_quant, params_from_jax

ARCHS = ["yi-6b", "phi3-mini-3.8b", "phi4-mini-3.8b", "qwen3-32b"]
# float32 plain versions against the JAX wrappers: another summation
# order only (relative to the largest output)
MM_RTOL = 1e-5
ATTN_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module's torch work on one intra-op thread: its tensors are
    small, and with the suite's parallel workers on a shared CPU every
    extra OpenMP thread only waits for a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _pallas_memory_space_alias():
    """Alias ``pltpu.TPUMemorySpace`` (renamed ``pltpu.MemorySpace`` in
    newer jax) for this module's JAX calls only, and drop the Pallas
    kernels' jit caches afterwards so no program traced under the alias
    outlives the module."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUMemorySpace"):
            mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                       raising=False)
        yield
    for fn in (dequant_matmul_pallas, dequant_matmul_i4_pallas,
               paged_decode_attention_q_pallas):
        fn.clear_cache()


# ---------------------------------------------------------------------------
# packed int4 and the per-head KV quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2,), (4, 6), (3, 2, 8), (16, 16)])
def test_int4_pack_unpack_bit_equal_to_jax(shape):
    """Packing int4 values and unpacking every byte value: the torch and
    numpy twins give the JAX package's bytes and values."""
    rng = np.random.default_rng(len(shape))
    q = rng.integers(-8, 8, shape).astype(np.int8)
    packed = Q.pack_int4(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(packed, np.asarray(jax_quantize.pack_int4(q)))
    np.testing.assert_array_equal(Q.pack_int4_np(q), packed)
    np.testing.assert_array_equal(
        Q.unpack_int4(torch.from_numpy(packed)).numpy(), q)
    b = rng.integers(-128, 128, shape).astype(np.int8)
    want = np.asarray(jax_quantize.unpack_int4(b))
    np.testing.assert_array_equal(Q.unpack_int4(torch.from_numpy(b)).numpy(),
                                  want)
    np.testing.assert_array_equal(Q.unpack_int4_np(b), want)


def test_int4_every_pair_and_odd_axis():
    q = np.array([[v, w] for v in range(-8, 8) for w in range(-8, 8)],
                 np.int8)
    packed = Q.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jax_quantize.pack_int4(q)))
    np.testing.assert_array_equal(Q.unpack_int4(packed).numpy(), q)
    with pytest.raises(ValueError, match="even last axis"):
        Q.pack_int4(torch.zeros(2, 3, dtype=torch.int8))
    with pytest.raises(ValueError, match="even last axis"):
        Q.pack_int4_np(np.zeros((2, 3), np.int8))


@pytest.mark.parametrize("shape", [(4,), (2, 3, 8), (2, 1, 2, 4, 16),
                                   (3, 5, 128)])
def test_kv_head_quant_bit_equal_to_jax(shape):
    """Values and scales bit-equal to the JAX package's, with all-zero
    head vectors (scale 1.0) and wide ranges among them; dequantization
    equal too."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(0, 2, shape) * np.exp(rng.normal(0, 3, shape[:-1] + (1,)))
         ).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0
    q, s = Q.quantize_kv_heads(torch.from_numpy(x))
    jq, js = jax_quantize.quantize_kv_heads(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s.reshape(-1)[0] == 1.0
    np.testing.assert_array_equal(
        Q.dequantize_kv_heads(q, s).numpy(),
        np.asarray(jax_quantize.dequantize_kv_heads(jq, js)))


# ---------------------------------------------------------------------------
# the weights: quantize_lm_params and qparams_from_jax
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """arch -> (JAX config, JAX params, port config, port model)."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_get_config(arch, reduced=True)
        params = jax_lm.init_lm(jax.random.PRNGKey(0), jcfg)
        cfg = get_config(arch, reduced=True)
        out[arch] = (jcfg, params, cfg, params_from_jax(
            jax.tree.map(np.asarray, params), cfg, device="cpu"))
    return out


def _port_leaf(qmodel, name, i=None):
    mod = qmodel
    parts = name.split("/")
    if i is not None:
        mod = qmodel.layers[i]
    for key in parts:
        mod = getattr(mod, key)
    return mod


def _check_against_tree(qmodel, qtree, cfg):
    """Every weight of the port's quantized model equals the JAX quantized
    tree's leaf (per layer: the stacked leaf's row) bit for bit."""
    top = ["embed", "final_norm"] + ([] if cfg.tie_embeddings
                                     else ["lm_head"])
    n_q = sum(_equal_leaf(_port_leaf(qmodel, name), qtree[name])
              for name in top)
    blocks = qtree["blocks"]
    for i in range(cfg.n_layers):
        for group in ("attn", "mlp"):
            for key, val in blocks[group].items():
                n_q += _equal_leaf(_port_leaf(qmodel, f"{group}/{key}", i),
                                   val, i)
        for key in ("ln1", "ln2"):
            n_q += _equal_leaf(_port_leaf(qmodel, key, i), blocks[key], i)
    return n_q


def _equal_leaf(ours, theirs, i=None):
    pick = (lambda a: np.asarray(a)) if i is None else \
        (lambda a: np.asarray(a)[i])
    if isinstance(theirs, dict):
        assert lm_quant.is_qleaf(ours)
        key = "q4" if "q4" in theirs else "q8"
        assert ours.int4 == (key == "q4")
        np.testing.assert_array_equal(getattr(ours, key).numpy(),
                                      pick(theirs[key]))
        np.testing.assert_array_equal(ours.qs.numpy(), pick(theirs["qs"]))
        return 1
    assert not lm_quant.is_qleaf(ours)
    np.testing.assert_array_equal(ours.detach().numpy(), pick(theirs))
    return 0


@pytest.mark.parametrize("wd", ["int8", "int4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_lm_params_bit_equal_to_jax(models, arch, wd):
    """q8/q4 bytes and scales bit-equal to the JAX package's on the same
    weights (scales over the same axis of the per-layer and the stacked
    leaf), and ``qparams_from_jax`` of the JAX quantized tree equal to
    the port's own quantization; the float model is left as it was."""
    jcfg, params, cfg, model = models[arch]
    before = {n: p.clone() for n, p in model.named_parameters()}
    ours = lm_quant.quantize_lm_params(model, cfg, wd)
    qtree = jax.tree.map(np.asarray,
                         jax_lm_quant.quantize_lm_params(params, jcfg, wd))
    n_q = _check_against_tree(ours, qtree, cfg)
    # every matrix: embed, lm_head and 7 per layer (wq wk wv wo wi wg wo)
    assert n_q == 1 + (not cfg.tie_embeddings) + 7 * cfg.n_layers
    carried = lm_quant.qparams_from_jax(qtree, cfg, device="cpu")
    assert _check_against_tree(carried, qtree, cfg) == n_q
    for a, b in zip(carried.state_dict().items(),
                    ours.state_dict().items()):
        assert a[0] == b[0] and torch.equal(a[1], b[1])
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n])


def test_odd_channels_fall_back_to_int8():
    """int4 packs channel pairs: a leaf with an odd last axis quantizes
    to int8, as in the JAX package (bit-equal)."""
    jcfg = dataclasses.replace(jax_get_config("yi-6b", reduced=True),
                               d_ff=45)
    cfg = dataclasses.replace(get_config("yi-6b", reduced=True), d_ff=45)
    params = jax_lm.init_lm(jax.random.PRNGKey(1), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                               device="cpu")
    ours = lm_quant.quantize_lm_params(model, cfg, "int4")
    blk = ours.layers[0]
    assert not blk.mlp.wi.int4 and not blk.mlp.wg.int4 and blk.mlp.wo.int4
    qtree = jax.tree.map(np.asarray,
                         jax_lm_quant.quantize_lm_params(params, jcfg, "int4"))
    _check_against_tree(ours, qtree, cfg)
    with pytest.raises(ValueError, match="weight_dtype"):
        lm_quant.quantize_lm_params(model, cfg, "int2")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_leaf_and_params_view(models, dtype):
    """``dequant_leaf`` equals the JAX one; ``dequant_params`` reads a
    quantized module as float weights of those values, layer by layer,
    and passes float weights through."""
    jcfg, params, cfg, model = models["phi3-mini-3.8b"]
    ours = lm_quant.quantize_lm_params(model, cfg, "int4")
    qtree = jax_lm_quant.quantize_lm_params(params, jcfg, "int4")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_lm_quant.dequant_leaf(
        jax.tree.map(lambda a: a[1], qtree["blocks"]["attn"]["wq"]),
        jdt).astype(jnp.float32))
    got = lm_quant.dequant_leaf(ours.layers[1].attn.wq, dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    view = lm_quant.dequant_params(ours, dtype)
    for i, blk in enumerate(view.layers):
        assert torch.equal(blk.attn.wq, lm_quant.dequant_leaf(
            ours.layers[i].attn.wq, dtype))
        assert blk.ln1 is ours.layers[i].ln1
    assert torch.equal(view.embed, lm_quant.dequant_leaf(ours.embed, dtype))
    assert lm_quant.dequant_params(model, dtype).embed is model.embed


def test_qparams_from_jax_defaults_to_the_card(models):
    jcfg, params, cfg, _ = models["yi-6b"]
    qtree = jax.tree.map(np.asarray,
                         jax_lm_quant.quantize_lm_params(params, jcfg, "int8"))
    if torch.cuda.is_available():
        assert lm_quant.qparams_from_jax(qtree, cfg).embed.q8.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm_quant.qparams_from_jax(qtree, cfg)


# ---------------------------------------------------------------------------
# K5 and K6's plain versions
# ---------------------------------------------------------------------------

# (m, k, n): a decode batch, one row, and K and N off any tile size
MM_CASES = [(4, 256, 128), (1, 64, 96), (3, 100, 70), (5, 300, 130)]


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("m,k,n", MM_CASES)
def test_dequant_matmul_plain_matches_jax(m, k, n, int4):
    """``ops.dequant_matmul`` on the CPU (the plain version) against the
    JAX ``dequant_matmul`` (its Pallas kernel in interpret mode) on the
    same quantized leaf: within ``MM_RTOL`` of the largest output."""
    rng = np.random.default_rng(m * k + n)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 0.5, (k, n)).astype(np.float32)
    jleaf = jax_lm_quant._quantize_leaf(w, 4 if int4 else 8)
    want = np.asarray(jax_ops.dequant_matmul(jnp.asarray(x), jleaf,
                                             interpret=True))
    leaf = lm_quant._quantize_leaf(torch.from_numpy(w), 4 if int4 else 8)
    got = ops.dequant_matmul(torch.from_numpy(x), leaf)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=MM_RTOL * np.abs(want).max())
    # the oracle the JAX package names: a matmul over dequant_leaf
    oracle = x @ np.asarray(jax_lm_quant.dequant_leaf(jleaf))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0,
                               atol=MM_RTOL * np.abs(oracle).max())


def test_dequant_matmul_takes_bf16_x_and_refuses_cpu_launch():
    """x of any float dtype is taken in float32; the CUDA launchers
    refuse CPU tensors and count no launch."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(0, 1, (32, 16)).astype(np.float32))
    leaf = lm_quant._quantize_leaf(w, 8)
    x = torch.from_numpy(rng.normal(0, 1, (2, 32)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    assert torch.equal(ops.dequant_matmul(xb, leaf),
                       ref.dequant_matmul_ref(xb.float(), leaf.q8, leaf.qs))
    before = (K56.launches, K56.launches_i4)
    with pytest.raises(ValueError, match="CUDA"):
        K56.dequant_matmul_cuda(x, leaf.q8, leaf.qs.reshape(-1))
    with pytest.raises(ValueError, match="CUDA"):
        K56.dequant_matmul_i4_cuda(x, Q.pack_int4(leaf.q8.clamp(-8, 7)),
                                   leaf.qs.reshape(-1))
    assert (K56.launches, K56.launches_i4) == before


# ---------------------------------------------------------------------------
# K7's plain version
# ---------------------------------------------------------------------------

def _quant_pools(rng, b, kh, t, bs, d, mapped):
    """int8 pools with row scales, a permuted table with unmapped tails on
    block 0, and the pools' float32 dequantization."""
    n_blocks = sum(mapped) + 1
    k = rng.normal(0, 1, (n_blocks, kh, bs, d)).astype(np.float32)
    v = rng.normal(0, 1, (n_blocks, kh, bs, d)).astype(np.float32)
    kq, ks = jax_quantize.quantize_kv_heads(k)
    vq, vs = jax_quantize.quantize_kv_heads(v)
    ids = iter(rng.permutation(np.arange(1, n_blocks)))
    tables = np.zeros((b, t), np.int32)
    for i in range(b):
        for j in range(mapped[i]):
            tables[i, j] = next(ids)
    return [np.array(a) for a in (kq, vq, ks, vs)] + [tables]


# (b, h, kh, t, bs, d, window)
QPAGED_CASES = [(3, 4, 2, 4, 16, 32, None), (3, 4, 2, 8, 8, 32, None),
                (2, 8, 1, 4, 32, 64, None), (2, 4, 4, 2, 64, 16, None),
                (3, 4, 2, 4, 16, 32, 20), (2, 6, 3, 12, 8, 96, 33)]


@pytest.mark.parametrize("b,h,kh,t,bs,d,window", QPAGED_CASES)
def test_quant_paged_plain_matches_jax(b, h, kh, t, bs, d, window):
    """``ops.quant_paged_decode_attention`` on the CPU against the JAX
    ``quant_paged_decode_attention`` (its Pallas kernel in interpret
    mode): within ``ATTN_TOL`` (float32); and bit-equal to K4's plain
    version on the dequantized pools."""
    rng = np.random.default_rng(t * bs + d)
    mapped = [max(1, t - i) for i in range(b)]
    kq, vq, ks, vs, tables = _quant_pools(rng, b, kh, t, bs, d, mapped)
    q = rng.normal(0, 1, (b, h, d)).astype(np.float32)
    lengths = np.array([min(int(rng.integers(1, t * bs + 1)), m * bs)
                        for m in mapped], np.int32)
    lengths[0] = 1
    args = (q, kq, vq, ks, vs, tables, lengths)
    got = ops.quant_paged_decode_attention(*map(torch.from_numpy, args),
                                           window=window)
    want = np.asarray(jax_ops.quant_paged_decode_attention(
        *map(jnp.asarray, args), window=window, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    t_ = torch.from_numpy
    kf = Q.dequantize_kv_heads(t_(kq), t_(ks))
    vf = Q.dequantize_kv_heads(t_(vq), t_(vs))
    k4 = ref.paged_decode_attention_ref(t_(q), kf, vf, t_(tables),
                                        t_(lengths), window=window)
    assert torch.equal(got, k4)


def test_quant_paged_plain_bf16_empty_rows_and_refusals():
    """q's dtype out; a row with no valid key outputs 0; block sizes K7
    does not take are refused on the CPU too, and the launcher refuses
    CPU tensors without counting a launch."""
    rng = np.random.default_rng(3)
    kq, vq, ks, vs, tables = _quant_pools(rng, 2, 2, 4, 16, 32, [4, 2])
    q = torch.from_numpy(rng.normal(0, 1, (2, 4, 32)).astype(np.float32))
    pools = [torch.from_numpy(a) for a in (kq, vq, ks, vs, tables)]
    lengths = torch.tensor([0, 20], dtype=torch.int32)
    got = ops.quant_paged_decode_attention(q.to(torch.bfloat16), *pools,
                                           lengths)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.isfinite(got.float()).all()
    before = K7.launches
    bad = [torch.zeros(3, 2, 24, 32, dtype=torch.int8)] * 2 + \
        [torch.ones(3, 2, 24)] * 2
    with pytest.raises(ValueError, match="block size 24"):
        ops.quant_paged_decode_attention(q, *bad, pools[4], lengths)
    with pytest.raises(ValueError, match="CUDA"):
        K7.paged_decode_attention_q_cuda(q, *pools, lengths)
    assert K7.launches == before
