"""The serving engine on the families this port serves besides dense and
moe, against the JAX engine on the same weights (``params_from_jax``)
and numpy-seeded requests, under both tag chains, at the reduced
configs (float32), one configuration per architecture:

  * vlm (PaliGemma-3B): exact, bucketed, chunked, checkpointed, paged,
    and int8 weights with an int8 KV cache — the vision patch
    embeddings ride ``Request.extras`` and take the first cache rows;
  * audio (Whisper-large-v3): exact and checkpointed — the cross K/V
    the prefill staged ride the checkpoint;
  * ssm (Mamba2-780m) int8 and hybrid (Zamba2-1.2B) int4 weight-only.

Greedy tokens equal the JAX engine's (one JAX run a case: for these
families both of its tag chains run the reference math, checked); the
decode, prefill and chunk programs are as many as the JAX engine's
``jit_cache_size``; every combination the JAX engine refuses is refused
with the same typed error and supported set."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as jax_get_config
from repro.core.executor import BucketTable as JaxBucketTable
from repro.core.executor import jit_cache_size
from repro.kernels.decode_attention import decode_attention_pallas
from repro.models import get_model as jax_get_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import UnsupportedFamilyError as JaxUnsupportedFamilyError

from repro_torch.configs import get_config
from repro_torch.core.executor import BucketTable, capture_count
from repro_torch.models import get_model, params_from_jax
from repro_torch.serving import (Request, ServingEngine,
                                 UnsupportedFamilyError)

ARCHS = {"vlm": "paligemma-3b", "audio": "whisper-large-v3",
         "ssm": "mamba2-780m", "hybrid": "zamba2-1.2b"}
TAG_CHAINS = [("cuda", "reference"), ("reference",)]
SLOTS, N_NEW = 2, 6
PROMPT_LENS = (21, 13, 30, 9)
# (family, mode) -> the engine keywords of both engines; checkpointed
# runs exact with a forced evict and restore, and must give the JAX
# engine's uninterrupted tokens; paged must give its exact tokens (the
# JAX engine's conformance matrix holds the two equal)
CASES = {
    ("vlm", "exact"): {"prefill_buckets": False},
    ("vlm", "bucketed"): {"prefill_buckets": True},
    ("vlm", "chunked"): {"prefill_buckets": False, "prefill_chunk": 8},
    ("vlm", "checkpointed"): {"prefill_buckets": False},
    ("vlm", "paged"): {"prefill_buckets": False, "kv_block": 8},
    ("vlm", "int8"): {"prefill_buckets": False, "weight_dtype": "int8",
                      "kv_dtype": "int8"},
    ("audio", "exact"): {"prefill_buckets": False},
    ("audio", "checkpointed"): {"prefill_buckets": False},
    ("ssm", "int8"): {"weight_dtype": "int8"},
    ("hybrid", "int4"): {"weight_dtype": "int4"},
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
    kernel's jit cache afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUMemorySpace"):
            mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                       raising=False)
        yield
    decode_attention_pallas.clear_cache()


@pytest.fixture(scope="module")
def models():
    """family -> (JAX bundle, JAX params, port bundle, port model,
    requests (uid, tokens, extras))."""
    out = {}
    for family, arch in ARCHS.items():
        jbundle = jax_get_model(jax_get_config(arch, reduced=True))
        params = jbundle.init(jax.random.PRNGKey(0))
        cfg = get_config(arch, reduced=True)
        rng = np.random.default_rng(5)
        reqs = []
        for uid, n in enumerate(PROMPT_LENS):
            toks = rng.integers(0, cfg.vocab - 2, n).astype(np.int32)
            extras = None
            if family == "vlm":
                extras = {"vision": rng.normal(
                    0, 1, (cfg.n_vision_tokens, cfg.d_vision)
                ).astype(np.float32)}
            elif family == "audio":
                extras = {"frames": rng.normal(
                    0, 1, (cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)}
            reqs.append((uid, toks, extras))
        out[family] = (jbundle, params, get_model(cfg), params_from_jax(
            jax.tree.map(np.asarray, params), cfg, device="cpu"), reqs)
    return out


def _cache_len(cfg):
    # the vision prefix takes cache rows in front of the prompt
    return 64 + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)


def _serve(engine, request, reqs, evict=False):
    for uid, toks, extras in reqs:
        engine.submit(request(uid=uid, tokens=toks, max_new_tokens=N_NEW,
                              extras=extras))
    steps, evicted = 0, False
    while engine.step():
        steps += 1
        if evict and not evicted and steps >= 3:
            victim = next(s for s in range(engine.max_slots)
                          if engine.active[s] or s in engine._chunking)
            engine._evict(victim)
            evicted = True
    assert evicted == evict
    return {uid: engine.results[uid].output for uid, _, _ in reqs}


@pytest.fixture(scope="module")
def jax_runs(models):
    """(family, mode) -> (JAX engine, its tokens), run once on the JAX
    engine's ``("reference",)`` chain; checkpointed and paged share the
    exact run.  For these families the JAX engine's ``"pallas"`` serving
    ops run the reference math (no Pallas kernel:
    ``test_jax_pallas_ops_run_the_reference_here``), so one JAX run
    stands for both of its chains."""
    cache = {}

    def get(family, mode):
        mode = "exact" if mode in ("checkpointed", "paged") else mode
        tags = ("reference",)
        if (family, mode, tags) not in cache:
            jbundle, params, _, _, reqs = models[family]
            eng = JaxServingEngine(jbundle, params, max_slots=SLOTS,
                                   cache_len=_cache_len(jbundle.cfg),
                                   tags=tags, **CASES[family, mode])
            cache[family, mode, tags] = eng, _serve(eng, JaxRequest, reqs)
        return cache[family, mode, tags]
    return get


@pytest.mark.parametrize("tags", TAG_CHAINS, ids=["cuda", "reference"])
@pytest.mark.parametrize("family,mode", list(CASES),
                         ids=[f"{f}-{m}" for f, m in CASES])
def test_family_engine_tokens_match_jax(models, jax_runs, family, mode,
                                        tags):
    jeng, want = jax_runs(family, mode)
    _, _, bundle, model, reqs = models[family]
    eng = ServingEngine(bundle, model, max_slots=SLOTS,
                        cache_len=_cache_len(bundle.cfg), tags=tags,
                        device="cpu", **CASES[family, mode])
    got = _serve(eng, Request, reqs, evict=mode == "checkpointed")
    assert got == want
    assert all(1 <= len(t) <= N_NEW for t in got.values())
    # compile once, as the JAX engine: one decode program, its prefill
    # and chunk program counts
    assert capture_count(eng._decode) == jit_cache_size(jeng._decode) == 1
    # the exact run's programs stand for paged's: both prefill each
    # prompt length once
    assert eng.prefill_compiles() == jeng.prefill_compiles()
    assert eng.chunk_compiles() == jeng.chunk_compiles()
    if mode == "bucketed":
        assert eng.prefill_compiles() < len(PROMPT_LENS)
    if eng.paged:
        assert eng.pool.free_blocks() == eng.pool.usable_blocks
    if mode == "checkpointed":
        assert sum(r.preemptions for r in eng.results.values()) == 1


@pytest.mark.parametrize("family,mode", list(CASES),
                         ids=[f"{f}-{m}" for f, m in CASES])
def test_jax_pallas_ops_run_the_reference_here(models, family, mode):
    """The JAX engine's ``"pallas"`` decode op for each case resolves
    with its kernel off (``use_kernel`` False, and no dequant matmul),
    so its ``("pallas", "reference")`` chain computes what its
    ``("reference",)`` chain does; the port's ``"cuda"`` op likewise
    keeps reference attention for these families."""
    import repro.kernels  # noqa: F401  (registers the "pallas" tag)
    from repro.core.op_resolver import MicroMutableOpResolver as JaxResolver
    from repro.core.schema import OpDef as JaxOpDef
    from repro.serving import ops as jax_serving_ops

    from repro_torch.core.op_resolver import MicroMutableOpResolver
    from repro_torch.core.schema import OpCode, OpDef
    from repro_torch.serving import ops as serving_ops
    jbundle, _, bundle, _, _ = models[family]
    kw = CASES[family, mode]
    quant = bool(kw.get("weight_dtype") or kw.get("kv_dtype"))
    paged = bool(kw.get("kv_block"))
    code = (OpCode.SERVING_DECODE_Q if quant
            else OpCode.SERVING_DECODE_PAGED if paged
            else OpCode.SERVING_DECODE)
    params = {"window": None, "kv_block": kw.get("kv_block"),
              "paged": paged, "kv_q": bool(kw.get("kv_dtype")),
              "weight_dtype": kw.get("weight_dtype")}
    jreg = JaxResolver(("pallas",)).add_many([code]).resolve(code)
    jdata = jreg.prepare(jax_serving_ops.ServingContext(jbundle),
                         JaxOpDef(code, (), (), params=params)).op_data
    reg = MicroMutableOpResolver(("cuda",)).add_many([code]).resolve(code)
    data = reg.prepare(serving_ops.ServingContext(bundle),
                       OpDef(code, (), (), params=params)).op_data
    for op_data in (jdata, data):
        assert not (op_data or {}).get("use_kernel")
        assert not (op_data or {}).get("use_mm")


def test_audio_checkpoint_carries_the_cross_kv(models):
    """A decoding Whisper slot's checkpoint holds its rings and the cross
    K/V its prefill staged, and restores them into another slot leaf
    for leaf."""
    _, _, bundle, model, reqs = models["audio"]
    eng = ServingEngine(bundle, model, max_slots=SLOTS,
                        cache_len=_cache_len(bundle.cfg), device="cpu")
    uid, toks, extras = reqs[0]
    eng.submit(Request(uid=uid, tokens=toks, max_new_tokens=N_NEW,
                       extras=extras))
    for _ in range(2):
        eng.step()
    state = eng.extract_slot_state(0)
    assert set(state) == {"k", "v", "cross_k", "cross_v"}
    assert state["cross_k"].abs().max() > 0
    eng.insert_slot_state(1, state)
    back = eng.extract_slot_state(1)
    for name, t in state.items():
        assert torch.equal(back[name], t), name


# (family, engine keywords, the feature the refusal names): every hole
# of the JAX engine's family matrix on one device
REFUSALS = [
    ("ssm", {"prefill_buckets": "table"}, "bucketed prefill"),
    ("hybrid", {"prefill_buckets": "table"}, "bucketed prefill"),
    ("audio", {"prefill_buckets": "table"}, "bucketed prefill"),
    ("audio", {"prefill_chunk": 8}, "chunked prefill"),
    ("ssm", {"kv_block": 8}, "paged KV"),
    ("hybrid", {"kv_block": 8}, "paged KV"),
    ("audio", {"kv_block": 8}, "paged KV"),
    ("audio", {"weight_dtype": "int8"}, "quantized serving"),
    ("ssm", {"kv_dtype": "int8"}, "int8 KV cache"),
    ("hybrid", {"weight_dtype": "int8", "kv_dtype": "int8"},
     "int8 KV cache"),
]


@pytest.mark.parametrize("family,kw,feature", REFUSALS,
                         ids=[f"{f}-{'-'.join(kw)}" for f, kw, _ in REFUSALS])
def test_unsupported_combinations_raise_as_in_jax(models, family, kw,
                                                  feature):
    jbundle, params, bundle, model, _ = models[family]
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("prefill_buckets") == "table":
        jkw["prefill_buckets"] = JaxBucketTable()
        pkw["prefill_buckets"] = BucketTable()
    cache_len = _cache_len(bundle.cfg)
    with pytest.raises(JaxUnsupportedFamilyError) as jerr:
        JaxServingEngine(jbundle, params, max_slots=1, cache_len=cache_len,
                         **jkw)
    with pytest.raises(UnsupportedFamilyError) as err:
        ServingEngine(bundle, model, max_slots=1, cache_len=cache_len,
                      device="cpu", **pkw)
    assert feature in err.value.feature
    assert (err.value.family, err.value.feature, err.value.supported) == \
        (jerr.value.family, jerr.value.feature, jerr.value.supported)
