"""Quantized serving in the port against the JAX package, and the port's
own contracts for it (mirroring ``tests/test_quant_serving.py``).

Against JAX, on the same quantized weights (``qparams_from_jax``) and
numpy-seeded inputs: the quantized decode steps ``lm_decode_q`` and
``lm_decode_paged_q`` (with the kernel hooks on both sides — the port's
plain versions, the JAX Pallas kernels in interpret mode — and without),
and the quantized ``ServingEngine`` on the four reduced dense configs,
one quantization per architecture (int8 weights and KV contiguous, int4
weights and int8 KV paged, int8 weights only, int8 KV only), under both
tag chains: greedy tokens identical, footprints equal to the byte.

The port's own: a quantized engine is token-identical to itself across
a forced evict and restore, paged equals contiguous, its logits track
the float engine within the documented per-dtype tolerance, quantization
shrinks the weights and the KV, and the typed refusals."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels.decode_attention import (decode_attention_pallas,
                                            paged_decode_attention_pallas,
                                            paged_decode_attention_q_pallas)
from repro.kernels.dequant_matmul import (dequant_matmul_i4_pallas,
                                          dequant_matmul_pallas)
from repro.models import get_model as jax_get_model
from repro.models import lm as jax_lm
from repro.models import lm_quant as jax_lm_quant
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

from repro_torch.configs import get_config
from repro_torch.core.schema import OpCode, OpDef
from repro_torch.kernels import ops
from repro_torch.models import get_model, lm_quant, params_from_jax
from repro_torch.serving import (Request, ServingEngine,
                                 UnsupportedFamilyError)
from repro_torch.serving import ops as serving_ops

ARCHS = ["yi-6b", "phi3-mini-3.8b", "phi4-mini-3.8b", "qwen3-32b"]
TAG_CHAINS = {("cuda", "reference"): ("pallas", "reference"),
              ("reference",): ("reference",)}
SLOTS, CACHE_LEN = 4, 64
# (prompt length, new tokens): a single-token prompt, one that decodes
# past the 64-position ring (58 + 12), one longer than the ring
WORKLOAD = [(5, 8), (12, 8), (58, 12), (1, 8), (9, 8), (70, 8), (7, 5)]
# (arch, weight_dtype, kv_dtype, kv_block) of the engine comparisons:
# together every quantization axis, contiguous and paged; one per
# architecture keeps the JAX engines' compile time in bounds
ENGINE_CASES = [("yi-6b", "int8", "int8", None),
                ("phi3-mini-3.8b", "int4", "int8", 8),
                ("phi4-mini-3.8b", "int8", None, None),
                ("qwen3-32b", None, "int8", 16)]
# the LM step, float32: relative to the largest logit (the JAX init's
# near one-hot attention amplifies summation-order differences, see
# tests/test_torch_lm.py)
LM_RTOL = 1e-4
# the documented max-abs logit tolerance of a quantized dense engine
# against the float one (tests/test_quant_serving.py)
TOLERANCE = {"int8": 0.5, "int4": 2.0}


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
    for fn in (decode_attention_pallas, paged_decode_attention_pallas,
               paged_decode_attention_q_pallas, dequant_matmul_pallas,
               dequant_matmul_i4_pallas):
        fn.clear_cache()


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX config, JAX params, port config, port float model)."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_get_config(arch, reduced=True)
        params = jax_lm.init_lm(jax.random.PRNGKey(0), jcfg)
        cfg = get_config(arch, reduced=True)
        out[arch] = (jcfg, params, cfg, params_from_jax(
            jax.tree.map(np.asarray, params), cfg, device="cpu"))
    return out


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LM_RTOL * np.abs(want).max(),
                               err_msg=what)


# ---------------------------------------------------------------------------
# the quantized decode steps, against the JAX package's
# ---------------------------------------------------------------------------

def _paged(rng, cache, bs, mapped):
    """The 4-leaf contiguous cache (L,B,KH,C,…) scattered into a permuted
    pool of blocks of ``bs`` (L,P,KH,BS,…); row i maps ``mapped[i]``
    blocks, its tail on block 0."""
    b, c = cache["k"].shape[1], cache["k"].shape[3]
    t = c // bs
    n_blocks = sum(mapped) + 1
    ids = iter(rng.permutation(np.arange(1, n_blocks)))
    tables = np.zeros((b, t), np.int32)
    pool = {n: np.zeros((a.shape[0], n_blocks, a.shape[2], bs, *a.shape[4:]),
                        a.dtype) for n, a in cache.items()}
    for n in ("k_scale", "v_scale"):
        pool[n][:] = 1.0
    for i in range(b):
        for j in range(mapped[i]):
            tables[i, j] = next(ids)
            for n, a in cache.items():
                pool[n][:, tables[i, j]] = a[:, i, :, j * bs:(j + 1) * bs]
    return pool, tables


# (arch, weight_dtype, paged, hook): both weight dtypes, contiguous and
# paged, kernels and reference (the engine cases below cover every
# architecture)
STEP_CASES = [("yi-6b", "int8", False, True),
              ("phi3-mini-3.8b", "int4", True, True),
              ("qwen3-32b", "int4", True, False)]


@pytest.mark.parametrize("arch,wd,paged,hook", STEP_CASES)
def test_lm_decode_q_matches_jax(models, arch, wd, paged, hook):
    """Four quantized decode steps, each from the JAX step's int8 KV
    cache (the first from the JAX quantized prefill's), at lengths 40, 17
    and 62 (wrapping the ring), on the JAX quantized tree carried over by
    ``qparams_from_jax``.  With
    ``hook`` both sides run the kernel hooks (MLP on the dequant matmul,
    attention on K3 over the dequantized cache or on K7): the port's
    plain versions, the JAX Pallas kernels in interpret mode.  Logits
    and KV scales within ``LM_RTOL`` of the largest; the int8 KV within
    one LSB."""
    jcfg, params, cfg, _ = models[arch]
    qtree = jax_lm_quant.quantize_lm_params(params, jcfg, wd)
    qmodel = lm_quant.qparams_from_jax(jax.tree.map(np.asarray, qtree), cfg,
                                       device="cpu")
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab - 2, (3, 40))
    fp = jax_lm_quant.dequant_params(qtree, jnp.float32)
    jcache = jax_lm_quant.quantize_cache(jax_lm.lm_prefill(
        fp, jcfg, jnp.asarray(toks, jnp.int32), CACHE_LEN)[1])
    jcache = {n: np.asarray(a) for n, a in jcache.items()}
    lengths = np.array([40, 17, 62], np.int32)
    if paged:
        bs = 8
        jcache, tables = _paged(rng, jcache, bs, [8, -(-21 // bs), 8])
        jattn = jax_ops.quant_paged_decode_attention if hook else None
        attn = ops.quant_paged_decode_attention if hook else None
    else:
        jattn = jax_ops.decode_attention if hook else None
        attn = ops.decode_attention_f32_cache if hook else None
    jmm = jax_ops.dequant_matmul if hook else None
    mm = ops.dequant_matmul if hook else None
    if paged:
        jstep = jax.jit(lambda c, tk, ln: jax_lm_quant.lm_decode_paged_q(
            qtree, jcfg, c, jnp.asarray(tables), tk, ln, kv_q=True,
            attn_impl=jattn, mlp_impl=jmm))
    else:
        jstep = jax.jit(lambda c, tk, ln: jax_lm_quant.lm_decode_q(
            qtree, jcfg, c, tk, ln, kv_q=True, attn_impl=jattn,
            mlp_impl=jmm))
    jc = {n: jnp.asarray(a) for n, a in jcache.items()}
    for step in range(4):
        # each step starts from the JAX cache: an int8 value one LSB
        # apart (below) would otherwise shift every later step's inputs
        tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
        tk = rng.integers(0, cfg.vocab - 2, (3, 1))
        want, jc = jstep(jc, jnp.asarray(tk, jnp.int32), jnp.asarray(lengths))
        kw = {"kv_q": True, "attn_impl": attn, "mlp_impl": mm}
        if paged:
            got, tc = lm_quant.lm_decode_paged_q(
                qmodel, cfg, tc, torch.from_numpy(tables),
                torch.from_numpy(tk), torch.from_numpy(lengths), **kw)
        else:
            got, tc = lm_quant.lm_decode_q(qmodel, cfg, tc,
                                           torch.from_numpy(tk),
                                           torch.from_numpy(lengths), **kw)
        _close(got.numpy(), want, f"logits, step {step}")
        for n in ("k", "v"):
            # the new rows' int8 values: K and V agree to float32
            # summation order, so a value on a rounding boundary may land
            # one LSB apart; at most one in 1000 does
            d = np.abs(tc[n].numpy().astype(np.int32)
                       - np.asarray(jc[n]).astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (n, step)
        for n in ("k_scale", "v_scale"):
            _close(tc[n].numpy(), jc[n], f"{n}, step {step}")
        lengths += 1


# ---------------------------------------------------------------------------
# the quantized engine, against the JAX engine
# ---------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab - 2, n).astype(np.int32)
            for n, _ in WORKLOAD]


def _submit(eng, req_cls, vocab):
    for uid, (toks, (_, new)) in enumerate(zip(_prompts(vocab), WORKLOAD)):
        eng.submit(req_cls(uid=uid, tokens=toks, max_new_tokens=new))


def _outputs(results):
    return {uid: r.output for uid, r in results.items()}


@pytest.mark.parametrize("tags", list(TAG_CHAINS), ids=["cuda", "reference"])
@pytest.mark.parametrize("arch,wd,kd,bs", ENGINE_CASES)
def test_quant_engine_tokens_match_jax(models, arch, wd, kd, bs, tags):
    """The quantized engine's greedy tokens equal the JAX quantized
    engine's (its ``("pallas", "reference")`` chain runs the dequant
    matmul and decode-attention Pallas kernels in interpret mode); the
    weights' and the KV's bytes are the JAX engine's to the byte."""
    jcfg, params, cfg, model = models[arch]
    kw = {"weight_dtype": wd, "kv_dtype": kd, "kv_block": bs}
    jeng = JaxServingEngine(jax_get_model(jcfg), params, max_slots=SLOTS,
                            cache_len=CACHE_LEN, tags=TAG_CHAINS[tags], **kw)
    _submit(jeng, JaxRequest, cfg.vocab)
    want = _outputs(jeng.run())
    eng = ServingEngine(get_model(cfg), model, max_slots=SLOTS,
                        cache_len=CACHE_LEN, tags=tags, device="cpu", **kw)
    assert eng.resolver.resolve(OpCode.SERVING_DECODE_Q).tag == tags[0]
    # the "cuda" quantized prefill is the reference one for dense: its
    # scan hook serves the recurrent families only
    assert eng.resolver.resolve(OpCode.SERVING_PREFILL_Q).tag == tags[0]
    assert eng._prefill.fn.args[0].op_data.get("kw", {}) == {}
    _submit(eng, Request, cfg.vocab)
    got = eng.run()
    assert _outputs(got) == want
    assert all(r.done for r in got.values())
    if bs:
        assert eng.pool.free_blocks() == eng.pool.usable_blocks
    assert (eng.param_bytes, eng.kv_bytes) == (jeng.param_bytes,
                                               jeng.kv_bytes)


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def _serve(models, wd, kd, *, evict=False, arch="qwen3-32b", **kw):
    """Four seeded requests through a quantized engine on the kernel tag
    chain, optionally evicting a running request at step 3 (it restores
    when a slot frees).  Returns ({uid: tokens}, engine)."""
    _, _, cfg, model = models[arch]
    eng = ServingEngine(get_model(cfg), model, max_slots=2, cache_len=32,
                        prefill_buckets=False, weight_dtype=wd, kv_dtype=kd,
                        device="cpu", **kw)
    rng = np.random.default_rng(5)
    for uid in range(4):
        eng.submit(Request(uid=uid, tokens=rng.integers(
            0, cfg.vocab - 2, 6).astype(np.int32), max_new_tokens=6))
    steps, more, evicted = 0, True, False
    while more:
        more = eng.step()
        steps += 1
        assert steps < 400
        if evict and not evicted and steps >= 3:
            victim = next(s for s in range(eng.max_slots) if eng.active[s])
            eng._evict(victim)
            evicted = True
    assert evicted == evict
    return _outputs(eng.results), eng


@pytest.mark.parametrize("wd,kd,bs", [("int8", "int8", None),
                                      ("int4", "int8", 8),
                                      ("int8", None, None),
                                      (None, "int8", None)])
def test_quantized_preempt_restore_identity(models, wd, kd, bs):
    """Each quantization axis, alone and combined: the engine's tokens
    through a forced mid-run eviction and restore equal its
    uninterrupted ones, and the cache leaves (scales too) never move."""
    base, eng = _serve(models, wd, kd, kv_block=bs)
    kv = eng.kv_pool if bs else eng.cache
    assert set(kv) == ({"k", "v", "k_scale", "v_scale"} if kd else {"k", "v"})
    again, eng = _serve(models, wd, kd, evict=True, kv_block=bs)
    assert sum(r.preemptions for r in eng.results.values()) == 1
    assert again == base
    if bs:
        assert eng.pool.free_blocks() == eng.pool.usable_blocks


def test_paged_quantized_matches_contiguous(models):
    """Paging stays a layout change under quantization: the paged
    int8/int8 engine, through an eviction, decodes the contiguous
    engine's tokens; the checkpoint carried block ids, no KV."""
    contig, _ = _serve(models, "int8", "int8")
    paged, eng = _serve(models, "int8", "int8", evict=True, kv_block=8,
                        kv_pool_blocks=2 * 4 + 1)
    assert paged == contig
    assert eng.pool.free_blocks() == eng.pool.usable_blocks


@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_dense_logit_tolerance(models, wd):
    """Quantized (int8 KV) against the float engine on the same weights:
    the largest |logit| difference over a prefill and four decode steps
    fed the float engine's greedy tokens is above 0 and within the
    documented tolerance."""
    _, _, cfg, model = models["qwen3-32b"]

    def engine(**kw):
        return ServingEngine(get_model(cfg), model, max_slots=1,
                             cache_len=32, prefill_buckets=False,
                             device="cpu", **kw)
    feng, qeng = engine(), engine(weight_dtype=wd, kv_dtype="int8")
    toks = np.random.default_rng(9).integers(0, cfg.vocab - 2, 6)
    batch = {"tokens": torch.as_tensor(toks[:-1][None])}
    with torch.no_grad():
        lf, cf = feng._prefill((feng.params, batch))
        lq, cq = qeng._prefill((qeng.params, batch))
        v = cfg.vocab
        err = (lf[..., :v] - lq[..., :v]).abs().max().item()
        pos, cur = len(toks) - 1, int(toks[-1])
        for _ in range(4):
            curs = torch.tensor([[cur]])
            lens = torch.tensor([pos], dtype=torch.int32)
            lf, cf = feng._decode((feng.params, cf, curs, lens))
            lq, cq = qeng._decode((qeng.params, cq, curs, lens))
            err = max(err, (lf[:, :v] - lq[:, :v]).abs().max().item())
            cur = int(lf[0, :v].argmax())
            pos += 1
    assert 0 < err <= TOLERANCE[wd], (wd, err)


def test_quantization_shrinks_the_footprint(models):
    """Resident weights and KV at least 1.5x smaller than the float
    engine's; the float model passed in is left as it was."""
    _, eq = _serve(models, "int8", "int8")
    _, ef = _serve(models, None, None)
    assert ef.param_bytes / eq.param_bytes >= 1.5
    assert ef.kv_bytes / eq.kv_bytes >= 1.5
    _, _, _, model = models["qwen3-32b"]
    assert eq.params is not model and ef.params is model
    assert all(not lm_quant.is_qleaf(m) for m in model.modules())


def test_quantized_refusals(models):
    """Unknown dtypes and chunked prefill with quantization raise
    ValueError; mesh stays unported (overlap composes with quantized
    serving, as in the JAX engine); the quantized ops refuse
    the families the port does not quantize, and the cuda decode a block
    size its kernels do not take."""
    _, _, cfg, model = models["yi-6b"]
    bundle = get_model(cfg)

    def engine(**kw):
        kw.setdefault("cache_len", 32)
        return ServingEngine(bundle, model, device="cpu", **kw)
    with pytest.raises(ValueError, match="weight_dtype"):
        engine(weight_dtype="int2")
    with pytest.raises(ValueError, match="kv_dtype"):
        engine(kv_dtype="int4")
    with pytest.raises(ValueError, match="prefill_chunk"):
        engine(weight_dtype="int8", prefill_chunk=8)
    with pytest.raises(ValueError, match="prefill_chunk"):
        engine(kv_dtype="int8", prefill_chunk=8)
    # quantized serving with a mesh is refused before the mesh is read,
    # as in the JAX engine
    with pytest.raises(ValueError, match="quantized serving"):
        engine(weight_dtype="int8", mesh=object())
    assert engine(weight_dtype="int8", overlap=True).overlap
    op = OpDef(OpCode.SERVING_DECODE_Q, (), (),
               params={"paged": True, "kv_q": True, "kv_block": 24})
    with pytest.raises(UnsupportedFamilyError, match="quantized"):
        serving_ops._quant_family_gate(
            dataclasses.replace(cfg, family="audio"), op)
    with pytest.raises(ValueError, match="block size 24"):
        engine(kv_dtype="int8", kv_block=24, cache_len=48)
    with pytest.raises(ValueError, match="block size 24"):
        ops.CudaServingDecodeQ.prepare(serving_ops.ServingContext(bundle),
                                       op)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(bundle, model, weight_dtype="int8")


def test_engine_refuses_a_buffer_off_its_device(models):
    """The engine's device check covers buffers as well as parameters
    (a quantized model keeps its weights in buffers)."""
    _, _, cfg, model = models["yi-6b"]
    qmodel = lm_quant.quantize_lm_params(model, cfg, "int8")
    qmodel.layers[1].mlp.wi.qs = torch.ones(1, cfg.d_ff, device="meta")
    with pytest.raises(ValueError, match=r"layers\.1\.mlp\.wi\.qs is on "
                                         r"meta"):
        ServingEngine(get_model(cfg), qmodel, cache_len=32, device="cpu")
