"""The MoE family in the port against the JAX package, at the reduced
DeepSeek-MoE-16B (shared experts, a dense first block) and
Qwen3-MoE-30B-A3B (qk-norm, GQA) configs, float32, the same weights in
both (``params_from_jax``) and numpy-seeded inputs.

``moe_dispatch``: dispatch ids identical to the JAX function's, tied
router logits and the capacity-stable masked mode included; combine
weights within one float32 ulp (XLA's ``exp`` and torch's differ by one
ulp on some inputs, so the softmax behind the weights can too).
``moe_block``, prefill and decode within the stated tolerances.  The
serving engine (DeepSeek) emits the JAX engine's greedy tokens under
both tag chains — exact, bucketed (one prefill program per bucket, as
the JAX engine's ``jit_cache_size``), checkpointed, paged, int8 weights
with an int8 KV cache, and int4 weights with an int8 KV cache, paged —
and refuses chunked prefill as the JAX engine does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as jax_get_config
from repro.core.executor import jit_cache_size
from repro.kernels.decode_attention import (decode_attention_pallas,
                                            paged_decode_attention_pallas,
                                            paged_decode_attention_q_pallas)
from repro.kernels.dequant_matmul import (dequant_matmul_i4_pallas,
                                          dequant_matmul_pallas)
from repro.models import get_model as jax_get_model
from repro.models import lm as jax_lm
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import UnsupportedFamilyError as JaxUnsupportedFamilyError

from repro_torch.configs import get_config
from repro_torch.core.executor import capture_count
from repro_torch.core.schema import OpCode
from repro_torch.models import get_model, lm, params_from_jax
from repro_torch.serving import (Request, ServingEngine,
                                 UnsupportedFamilyError)

ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]
ENGINE_ARCH = "deepseek-moe-16b"
TAG_CHAINS = {("cuda", "reference"): ("pallas", "reference"),
              ("reference",): ("reference",)}
SLOTS, CACHE_LEN, N_NEW = 2, 64, 6
PROMPT_LENS = (21, 13, 30, 9, 1)
# float32; the JAX init's fan-in-L draws make the reduced models' MoE
# outputs reach ~900, where float32 summation orders differ by ~3e-7 of
# the largest entry (measured)
BLOCK_RTOL = 1e-5
# logits and caches relative to their largest entry, as in
# tests/test_torch_lm.py
LOGIT_RTOL = 1e-4
# the engine modes: the port's keywords, and the JAX run whose tokens
# they must equal (bucketed, checkpointed and paged give the exact
# run's tokens in the JAX engine, its conformance matrix)
MODES = {
    "exact": ({"prefill_buckets": False}, "exact"),
    "bucketed": ({"prefill_buckets": True}, "bucketed"),
    "checkpointed": ({"prefill_buckets": False}, "exact"),
    "paged": ({"prefill_buckets": False, "kv_block": 8}, "exact"),
    "int8": ({"prefill_buckets": False, "weight_dtype": "int8",
              "kv_dtype": "int8"}, "int8"),
    "int4-paged": ({"prefill_buckets": False, "weight_dtype": "int4",
                    "kv_dtype": "int8", "kv_block": 8}, "int4-paged"),
}


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
    newer jax) for this module's JAX engines only, and drop the Pallas
    kernels' jit caches afterwards so no program traced under the alias
    outlives the module."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUMemorySpace"):
            mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                       raising=False)
        yield
    for kernel in (decode_attention_pallas, paged_decode_attention_pallas,
                   paged_decode_attention_q_pallas, dequant_matmul_pallas,
                   dequant_matmul_i4_pallas):
        kernel.clear_cache()


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX bundle, JAX params, port bundle, port model)."""
    out = {}
    for arch in ARCHS:
        jbundle = jax_get_model(jax_get_config(arch, reduced=True))
        params = jbundle.init(jax.random.PRNGKey(0))
        cfg = get_config(arch, reduced=True)
        out[arch] = (jbundle, params, get_model(cfg), params_from_jax(
            jax.tree.map(np.asarray, params), cfg, device="cpu"))
    return out


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _logits(rng, cfg, shape):
    x = rng.normal(size=shape).astype(np.float32)
    # ties: a token whose experts all score alike, one whose top two tie
    x[0, 3, :] = 0.5
    x[0, 5, 1:3] = x[0, 5].max() + 1.0
    return x


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dispatch_matches_jax(models, arch, masked):
    jbundle = models[arch][0]
    jcfg, cfg = jbundle.cfg, models[arch][2].cfg
    rng = np.random.default_rng(11)
    t = 24
    logits = _logits(rng, cfg, (1, t, cfg.n_experts))
    cap = jax_lm.moe_capacity(jcfg, t)
    assert cap == lm.moe_capacity(cfg, t)
    jkw, kw = {}, {}
    if masked:
        n = 17
        jkw = {"n_valid": jnp.int32(n),
               "eff_capacity": jnp.int32(jax_lm.moe_capacity(jcfg, n))}
        kw = {name: torch.tensor(int(v), dtype=torch.int32)
              for name, v in jkw.items()}
    jd, jc, jaux = jax_lm.moe_dispatch(jnp.asarray(logits), jcfg, cap, **jkw)
    d, c, aux = lm.moe_dispatch(torch.from_numpy(logits), cfg, cap, **kw)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0,
                               atol=2.0 ** -23)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    if masked:
        # the padded tokens route nowhere
        assert not np.isin(np.arange(17, t), d.numpy()).any()


def test_top_k_takes_the_lower_index_on_ties():
    x = torch.tensor([[0.5, 0.5, 0.5, 0.5], [0.1, 0.7, 0.7, 0.2]])
    vals, idx = lm.top_k(x, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x.numpy()), 2)
    assert idx.tolist() == [[0, 1], [1, 2]] == np.asarray(jidx).tolist()
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(models, arch):
    jbundle, params, _, model = models[arch]
    cfg = model.cfg
    x = np.random.default_rng(12).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
    jy, jaux = jax_lm.moe_block(jp, jbundle.cfg, jnp.asarray(x))
    y, aux = lm.moe_block(model.layers[0].moe, cfg, torch.from_numpy(x))
    assert _rel(y.numpy(), jy) <= BLOCK_RTOL
    assert abs(float(aux) - float(jaux)) <= 1e-6
    # the masked mode over a right-padded batch gives the true length's
    # outputs (the expert products run at another capacity, so float32
    # rounding may differ)
    n = 7
    xs = torch.from_numpy(x[:1])
    y_all, _ = lm.moe_block(model.layers[0].moe, cfg, xs[:, :n])
    y_pad, _ = lm.moe_block(
        model.layers[0].moe, cfg, xs, n_valid=torch.tensor(n),
        eff_capacity=torch.tensor(lm.moe_capacity(cfg, n)))
    assert _rel(y_pad[:, :n].numpy(), y_all.numpy()) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_and_decode_match_jax(models, arch):
    jbundle, params, bundle, model = models[arch]
    jcfg, cfg = jbundle.cfg, model.cfg
    assert hasattr(model, "first_block") == bool(cfg.first_layer_dense_ff)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, cfg.vocab - 2, (2, 20))
    jl, jcache = jax_lm.lm_prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                                   32)
    tl, cache = lm.lm_prefill(model, cfg, torch.from_numpy(toks), 32)
    assert _rel(tl.numpy(), jl) <= LOGIT_RTOL
    for name in ("k", "v"):
        assert _rel(cache[name].numpy(), jcache[name]) <= LOGIT_RTOL
    lengths = np.array([20, 20], np.int32)
    nxt = rng.integers(0, cfg.vocab - 2, (2, 1))
    jl2, _ = jax_lm.lm_decode(params, jcfg, jcache,
                              jnp.asarray(nxt, jnp.int32),
                              jnp.asarray(lengths))
    tl2, _ = lm.lm_decode(model, cfg, cache, torch.from_numpy(nxt),
                          torch.from_numpy(lengths))
    assert _rel(tl2.numpy(), jl2) <= LOGIT_RTOL


def _requests(cfg):
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab - 2, n).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(engine, request, prompts, evict=False):
    for uid, toks in enumerate(prompts):
        engine.submit(request(uid=uid, tokens=toks, max_new_tokens=N_NEW))
    steps, evicted = 0, False
    while engine.step():
        steps += 1
        if evict and not evicted and steps >= 3:
            victim = next(s for s in range(engine.max_slots)
                          if engine.active[s])
            engine._evict(victim)
            evicted = True
    assert evicted == evict
    return {uid: engine.results[uid].output for uid in range(len(prompts))}


@pytest.fixture(scope="module")
def jax_runs(models):
    """(JAX mode, JAX tags) -> (JAX engine, its tokens), run once."""
    jbundle, params, _, _ = models[ENGINE_ARCH]
    cache = {}

    def get(mode, tags):
        if (mode, tags) not in cache:
            eng = JaxServingEngine(jbundle, params, max_slots=SLOTS,
                                   cache_len=CACHE_LEN, tags=tags,
                                   **MODES[mode][0])
            cache[mode, tags] = eng, _serve(eng, JaxRequest,
                                            _requests(jbundle.cfg))
        return cache[mode, tags]
    return get


@pytest.mark.parametrize("tags", list(TAG_CHAINS), ids=["cuda", "reference"])
@pytest.mark.parametrize("mode", list(MODES))
def test_moe_engine_tokens_match_jax(models, jax_runs, mode, tags):
    kw, jmode = MODES[mode]
    jeng, want = jax_runs(jmode, TAG_CHAINS[tags])
    _, _, bundle, model = models[ENGINE_ARCH]
    eng = ServingEngine(bundle, model, max_slots=SLOTS, cache_len=CACHE_LEN,
                        tags=tags, device="cpu", **kw)
    got = _serve(eng, Request, _requests(bundle.cfg),
                 evict=mode == "checkpointed")
    assert got == want
    # every request decodes (up to its budget, or EOS)
    assert all(1 <= len(t) <= N_NEW for t in got.values())
    # the tag chain's first entry serves the decode step
    code = (OpCode.SERVING_DECODE_Q if eng.quantized
            else OpCode.SERVING_DECODE_PAGED if eng.paged
            else OpCode.SERVING_DECODE)
    assert eng.resolver.resolve(code).tag == tags[0]
    # compile once: one decode program, and prefill programs as many as
    # the JAX engine's (one per bucket when bucketed)
    assert capture_count(eng._decode) == jit_cache_size(jeng._decode) == 1
    if jmode == mode:
        assert eng.prefill_compiles() == jeng.prefill_compiles()
    if mode == "bucketed":
        hit = {eng.bucket_table.fit(n - 1) for n in PROMPT_LENS if n > 1}
        assert eng.prefill_compiles() == len(hit) < len(PROMPT_LENS) - 1
    if eng.paged:
        assert eng.pool.free_blocks() == eng.pool.usable_blocks


def test_moe_chunked_prefill_refused_as_in_jax(models):
    """moe cannot chunk (its capacity depends on the tokens integrated
    so far): the same typed error as the JAX engine, contiguous and
    paged."""
    jbundle, params, bundle, model = models[ENGINE_ARCH]
    for kw in ({"prefill_chunk": 8}, {"prefill_chunk": 8, "kv_block": 8}):
        with pytest.raises(JaxUnsupportedFamilyError) as jerr:
            JaxServingEngine(jbundle, params, max_slots=1,
                             cache_len=CACHE_LEN, **kw)
        with pytest.raises(UnsupportedFamilyError) as err:
            ServingEngine(bundle, model, max_slots=1, cache_len=CACHE_LEN,
                          device="cpu", **kw)
        assert (err.value.family, err.value.feature, err.value.supported) \
            == (jerr.value.family, jerr.value.feature, jerr.value.supported)


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_moe_quantized_tree_from_jax(models, weight_dtype):
    """The JAX ``quantize_lm_params`` tree of DeepSeek (router float,
    experts (E,D,F) and the first block quantized) carried across by
    ``qparams_from_jax`` equals the port quantizing the same weights:
    the same leaves, the same integers, the same scales."""
    from repro.models import lm_quant as jax_lm_quant

    from repro_torch.models import lm_quant
    _, params, _, model = models[ENGINE_ARCH]
    cfg = model.cfg
    tree = jax.tree.map(np.asarray, jax_lm_quant.quantize_lm_params(
        params, jax_get_config(ENGINE_ARCH, reduced=True), weight_dtype))
    got = lm_quant.qparams_from_jax(tree, cfg, device="cpu")
    want = lm_quant.quantize_lm_params(model, cfg, weight_dtype)
    got_t = dict(got.named_parameters()) | dict(got.named_buffers())
    want_t = dict(want.named_parameters()) | dict(want.named_buffers())
    assert sorted(got_t) == sorted(want_t)
    assert any(name.endswith("experts.wi.qs") for name in got_t)
    assert not lm_quant.is_qleaf(got.layers[0].moe.router)
    for name, t in want_t.items():
        if t.dtype == torch.int8:
            assert torch.equal(got_t[name], t), name
        else:
            assert torch.equal(got_t[name], t), name
