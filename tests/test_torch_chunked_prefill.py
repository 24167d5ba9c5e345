"""Chunked prefill in the port against the JAX package: the dense
``lm_prefill_chunk`` and ``lm_prefill_chunk_paged`` on the four reduced
configs, and the chunked (contiguous and paged) ``ServingEngine`` against
the JAX engine under both tag chains; then the port's own identities
(chunked equals one-shot, an eviction mid-chunk resumes, a slot mid-chunk
keeps its decode row on the garbage block) and the argument guards.
Inputs come from numpy seeds; each check states its tolerance."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import repro.kernels  # noqa: F401  (registers the "pallas" tag)
from repro.configs import get_config as jax_get_config
from repro.core.op_resolver import MicroMutableOpResolver as JaxResolver
from repro.core.schema import OpDef as JaxOpDef
from repro.kernels.decode_attention import (decode_attention_pallas,
                                            paged_decode_attention_pallas)
from repro.models import get_model as jax_get_model
from repro.models import lm as jax_lm
from repro.models.common import ModelConfig as JaxModelConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import UnsupportedFamilyError as JaxUnsupportedFamilyError
from repro.serving import ops as jax_serving_ops

import repro_torch.kernels  # noqa: F401  (registers the "cuda" tag)
from repro_torch.configs import get_config
from repro_torch.core.op_resolver import MicroMutableOpResolver
from repro_torch.core.schema import OpCode, OpDef
from repro_torch.models import get_model, lm, params_from_jax
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import ModelBundle
from repro_torch.serving import (Request, ServingEngine,
                                 UnsupportedFamilyError)
from repro_torch.serving import ops as serving_ops

ARCHS = ["yi-6b", "phi3-mini-3.8b", "phi4-mini-3.8b", "qwen3-32b"]
TAG_CHAINS = {("cuda", "reference"): ("pallas", "reference"),
              ("reference",): ("reference",)}
SLOTS, CACHE_LEN = 4, 64
# (prompt length, new tokens): prompts of one to eight chunks, one too
# long for the ring (70: one-shot, exact length), and 58 + 12, chunked
# to the end of the ring and then decoding past it
WORKLOAD = [(5, 8), (12, 8), (58, 12), (1, 8), (9, 8), (70, 8), (7, 5),
            (41, 6)]
# (arch, prefill_chunk, kv_block) of the engine comparisons: chunks of 8
# and 16, contiguous and paged, one per architecture (keeping the JAX
# engines' compile time in bounds)
ENGINE_CASES = [("yi-6b", 8, None), ("phi3-mini-3.8b", 16, None),
                ("phi4-mini-3.8b", 8, 16), ("qwen3-32b", 16, 8)]
# float32, relative to the largest cache value (the JAX init's near
# one-hot attention amplifies summation-order differences, see
# tests/test_torch_lm.py)
LM_RTOL = 1e-4


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
    kernels' jit caches afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUMemorySpace"):
            mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                       raising=False)
        yield
    decode_attention_pallas.clear_cache()
    paged_decode_attention_pallas.clear_cache()


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


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LM_RTOL * np.abs(want).max(),
                               err_msg=what)


# ---------------------------------------------------------------------------
# the LM's chunk steps, against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_chunk_matches_jax(models, arch, chunk):
    """A 40-token prompt for two sequences: the first chunk through the
    ordinary prefill, the rest chunk by chunk at their offsets (the last
    one right-padded).  The cache after every chunk within ``LM_RTOL``
    of its largest value."""
    jcfg, params, cfg, model = models[arch]
    toks = np.random.default_rng(chunk).integers(0, cfg.vocab - 2, (2, 40))
    toks = np.concatenate([toks, np.zeros((2, -40 % chunk), toks.dtype)], 1)
    jcache = jax_lm.lm_prefill(params, jcfg,
                               jnp.asarray(toks[:, :chunk], jnp.int32),
                               CACHE_LEN, window=jcfg.sliding_window)[1]
    cache = lm.lm_prefill(model, cfg, torch.from_numpy(toks[:, :chunk]),
                          CACHE_LEN, window=cfg.sliding_window)[1]
    jchunk = jax.jit(lambda p, c, t, s: jax_lm.lm_prefill_chunk(
        p, jcfg, c, t, s, window=jcfg.sliding_window))
    for start in range(chunk, toks.shape[1], chunk):
        part = toks[:, start:start + chunk]
        jcache = jchunk(params, jcache, jnp.asarray(part, jnp.int32),
                        jnp.int32(start))
        out = lm.lm_prefill_chunk(model, cfg, cache, torch.from_numpy(part),
                                  start, window=cfg.sliding_window)
        assert out is cache                 # written in place
        for name in ("k", "v"):
            _close(cache[name].numpy(), jcache[name],
                   f"{name} after the chunk at {start}")


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_chunk_paged_matches_jax(models, arch, bs):
    """One slot's chunks straight into a permuted pool whose table maps
    only the blocks the prompt reaches (the tail on block 0), beside a
    second slot's blocks, which must not change.  Pools within
    ``LM_RTOL`` of their largest value after every chunk."""
    jcfg, params, cfg, model = models[arch]
    chunk = 8
    rng = np.random.default_rng(bs + 1)
    toks = rng.integers(0, cfg.vocab - 2, 27)
    toks = np.concatenate([toks, np.zeros(-27 % chunk, toks.dtype)])
    t = CACHE_LEN // bs
    n_blocks = 2 * t + 1
    perm = rng.permutation(np.arange(1, n_blocks))
    row = np.zeros(t, np.int32)
    mapped = -(-len(toks) // bs)
    row[:mapped] = perm[:mapped]
    pool = {n: rng.normal(0, 1, (cfg.n_layers, n_blocks, cfg.n_kv_heads,
                                 bs, cfg.dh)).astype(np.float32)
            for n in ("k", "v")}
    jpool = {n: jnp.asarray(a) for n, a in pool.items()}
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    jchunk = jax.jit(lambda p, pl, r, tk, s: jax_lm.lm_prefill_chunk_paged(
        p, jcfg, pl, r, tk, s, window=jcfg.sliding_window))
    for start in range(0, len(toks), chunk):
        part = toks[None, start:start + chunk]
        jpool = jchunk(params, jpool, jnp.asarray(row),
                       jnp.asarray(part, jnp.int32), jnp.int32(start))
        out = lm.lm_prefill_chunk_paged(model, cfg, tpool,
                                        torch.from_numpy(row),
                                        torch.from_numpy(part), start,
                                        window=cfg.sliding_window)
        assert out is tpool
        for name in ("k", "v"):
            _close(tpool[name].numpy(), jpool[name],
                   f"{name} pool after the chunk at {start}")
    others = [b for b in range(1, n_blocks) if b not in row[:mapped]]
    for name in ("k", "v"):
        assert np.array_equal(tpool[name].numpy()[:, others],
                              pool[name][:, others])


def test_chunk_must_not_wrap(models):
    _, _, cfg, model = models["yi-6b"]
    cache = lm.empty_cache(cfg, 1, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="wrap"):
        lm.lm_prefill_chunk(model, cfg, cache,
                            torch.zeros(1, 8, dtype=torch.int64), 12)


# ---------------------------------------------------------------------------
# the chunked engine, against the JAX engine
# ---------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab - 2, n).astype(np.int32)
            for n, _ in WORKLOAD]


def _submit(eng, req_cls, vocab, skip=()):
    for uid, (toks, (_, new)) in enumerate(zip(_prompts(vocab), WORKLOAD)):
        if uid not in skip:
            eng.submit(req_cls(uid=uid, tokens=toks, max_new_tokens=new))


def _outputs(results):
    return {uid: r.output for uid, r in results.items()}


@pytest.mark.parametrize("tags", list(TAG_CHAINS), ids=["cuda", "reference"])
@pytest.mark.parametrize("arch,chunk,bs", ENGINE_CASES)
def test_chunked_engine_tokens_match_jax(models, arch, chunk, bs, tags):
    """Greedy tokens equal to the JAX engine's with the same
    ``prefill_chunk`` (and ``kv_block``), the same prompt tokens
    integrated chunk by chunk, and the same chunk dispatches."""
    jcfg, params, cfg, model = models[arch]
    jeng = JaxServingEngine(jax_get_model(jcfg), params, max_slots=SLOTS,
                            cache_len=CACHE_LEN, tags=TAG_CHAINS[tags],
                            prefill_chunk=chunk, kv_block=bs)
    eng = ServingEngine(get_model(cfg), model, max_slots=SLOTS,
                        cache_len=CACHE_LEN, tags=tags, prefill_chunk=chunk,
                        kv_block=bs, device="cpu")
    chunks = []
    for e, req_cls in ((jeng, JaxRequest), (eng, Request)):
        _submit(e, req_cls, cfg.vocab)
        n = 0
        while e.step():
            n += e.last_step["chunks"]
        chunks.append(n)
    assert _outputs(eng.results) == _outputs(jeng.results)
    assert chunks[0] == chunks[1] > 0
    if bs:
        assert eng.pool.free_blocks() == eng.pool.usable_blocks


# ---------------------------------------------------------------------------
# the port's own identities
# ---------------------------------------------------------------------------

def _engine(models, arch="yi-6b", **kw):
    _, _, cfg, model = models[arch]
    kw.setdefault("max_slots", SLOTS)
    return ServingEngine(get_model(cfg), model, cache_len=CACHE_LEN,
                         device="cpu", **kw)


@pytest.fixture(scope="module")
def oneshot_tokens(models):
    eng = _engine(models)
    _submit(eng, Request, eng.cfg.vocab)
    return _outputs(eng.run())


@pytest.mark.parametrize("conf", [(8, None), (16, None), (True, None),
                                  (8, 8), (16, 16)],
                         ids=["chunk8", "chunk16", "auto", "chunk8-paged8",
                              "chunk16-paged16"])
def test_chunked_equals_oneshot(models, oneshot_tokens, conf):
    """Chunked prefill (with or without paging) emits the one-shot
    tokens; a slot mid-chunk keeps its decode row on the garbage block,
    so the other slots' decode writes never reach its blocks."""
    chunk, bs = conf
    eng = _engine(models, prefill_chunk=chunk, kv_block=bs)
    _submit(eng, Request, eng.cfg.vocab)
    seen = 0
    while eng.step():
        for slot in eng._chunking:
            seen += 1
            assert not eng.active[slot]
            if bs:
                assert not eng.block_tables[slot].any()
                assert eng._slot_blocks[slot]
    assert seen
    assert _outputs(eng.results) == oneshot_tokens


@pytest.mark.parametrize("bs", [None, 16], ids=["contiguous", "paged"])
def test_eviction_mid_chunk_resumes(models, oneshot_tokens, bs):
    """A tight deadline displaces a slot that is still prefilling chunk
    by chunk: its checkpoint is a prefill-phase one (paged: block ids,
    no KV), and it later resumes at the chunk it stopped at and emits
    its uninterrupted tokens, as does every other request."""
    eng = _engine(models, max_slots=1, prefill_chunk=8, kv_block=bs,
                  policy="edf", preempt="edf-displace", clock=lambda: 0)
    prompts = _prompts(eng.cfg.vocab)
    long_uid, urgent = 7, 0
    eng.submit(Request(uid=long_uid, tokens=prompts[long_uid],
                       max_new_tokens=WORKLOAD[long_uid][1]))
    eng.step()                          # admitted: the first chunk
    eng.step()                          # the second
    assert eng._chunking[0].done == 16
    eng.submit(Request(uid=urgent, tokens=prompts[urgent],
                       max_new_tokens=WORKLOAD[urgent][1], deadline_us=100))
    eng.step()                          # the third, then displaced
    ckpt = eng._ckpt[long_uid]
    assert ckpt.phase == "prefill" and ckpt.done_tokens == 24
    if bs:
        assert ckpt.cache is None and ckpt.blocks
    else:
        assert ckpt.blocks is None and ckpt.cache["k"].device.type == "cpu"
    res = eng.run()
    assert res[long_uid].preemptions == 1 and res[urgent].preemptions == 0
    for uid in (long_uid, urgent):
        assert res[uid].output == oneshot_tokens[uid]
    if bs:
        assert eng.pool.free_blocks() == eng.pool.usable_blocks


@pytest.mark.parametrize("chunk,bs,prompt", [(16, 8, 18), (32, 8, 40)])
def test_padded_final_chunk_stays_inside_the_reservation(models, chunk, bs,
                                                         prompt):
    """A final chunk's padding is not in the request's reservation
    (prompt + budget): the port maps blocks for the chunk's real rows
    only, its padded rows past them land on the garbage block, and the
    request emits its one-shot tokens.  The JAX engine also maps blocks
    for the padding and overdraws the reservation (ROADMAP queue 3)."""
    jcfg, params, cfg, model = models["yi-6b"]
    toks = np.arange(1, prompt + 1, dtype=np.int32)
    outs = []
    for kw in ({}, {"kv_block": bs, "prefill_chunk": chunk}):
        eng = _engine(models, max_slots=1, **kw)
        eng.submit(Request(uid=0, tokens=toks, max_new_tokens=1))
        outs.append(eng.run()[0].output)
    assert outs[0] == outs[1]
    assert eng.pool.alloc_count == -(-prompt // bs)
    assert eng.pool.free_blocks() == eng.pool.usable_blocks
    jeng = JaxServingEngine(jax_get_model(jcfg), params, max_slots=1,
                            cache_len=CACHE_LEN, tags=("reference",),
                            kv_block=bs, prefill_chunk=chunk)
    jeng.submit(JaxRequest(uid=0, tokens=toks, max_new_tokens=1))
    with pytest.raises(RuntimeError, match="without a reservation"):
        jeng.run()


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_prefill_chunk_argument_validation(models):
    assert _engine(models, max_slots=1, prefill_chunk=True).chunk_tokens == 8
    assert _engine(models, max_slots=1, prefill_chunk=True,
                   prefill_buckets=False).chunk_tokens == 8
    assert _engine(models, max_slots=1).chunk_tokens == 0
    assert _engine(models, max_slots=1, prefill_chunk=0).chunk_tokens == 0
    with pytest.raises(ValueError, match="prefill_chunk"):
        _engine(models, max_slots=1, prefill_chunk=-4)
    # over-cap prompts fall back to one-shot exact prefill
    eng = _engine(models, max_slots=1, prefill_chunk=8)
    toks = np.arange(70, dtype=np.int32)
    assert not eng._chunk_eligible(Request(uid=0, tokens=toks))
    assert eng._chunk_eligible(Request(uid=0, tokens=toks[:41]))
    assert not eng._chunk_eligible(Request(uid=0, tokens=toks[:9]))


@pytest.mark.parametrize("tag,code", [
    ("reference", OpCode.SERVING_PREFILL_CHUNK),
    ("reference", OpCode.SERVING_DECODE_PAGED),
    ("reference", OpCode.SERVING_PREFILL_CHUNK_PAGED),
    ("cuda", OpCode.SERVING_DECODE_PAGED)])
@pytest.mark.parametrize("family", ["vlm", "moe"])
def test_chunk_and_paged_ops_refuse_other_families(tag, code, family):
    """The chunk and paged ops take vlm and moe exactly where the JAX
    package's (reference, or Pallas for ``"cuda"``) take them: both page
    vlm and moe and chunk vlm; moe's chunks are refused at prepare with
    ``UnsupportedFamilyError`` naming the same feature and supported
    families."""
    cfg = ModelConfig(arch_id="x", family=family, n_layers=1, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=128)
    bundle = ModelBundle(cfg, None, None, None, None)
    params = {"window": None, "kv_block": 16}
    reg = MicroMutableOpResolver((tag,)).add_many([code]).resolve(code)
    assert reg.tag == tag
    jtag = {"cuda": "pallas"}.get(tag, tag)
    # the two packages number their opcodes alike
    jcode = code
    jreg = JaxResolver((jtag,)).add_many([jcode]).resolve(jcode)
    assert jreg.tag == jtag
    jctx = jax_serving_ops.ServingContext(
        SimpleNamespace(cfg=JaxModelConfig(**dataclasses.asdict(cfg))))
    try:
        jreg.prepare(jctx, JaxOpDef(jcode, (), (), params=params))
    except JaxUnsupportedFamilyError as jerr:
        with pytest.raises(UnsupportedFamilyError, match=family) as err:
            reg.prepare(serving_ops.ServingContext(bundle),
                        OpDef(code, (), (), params=params))
        assert (err.value.feature, err.value.supported) == \
            (jerr.feature, jerr.supported)
        assert (family, code) in {("moe", OpCode.SERVING_PREFILL_CHUNK),
                                  ("moe",
                                   OpCode.SERVING_PREFILL_CHUNK_PAGED)}
    else:
        reg.prepare(serving_ops.ServingContext(bundle),
                    OpDef(code, (), (), params=params))