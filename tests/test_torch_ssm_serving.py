"""The slice as a whole: the port's ServingEngine serving the recurrent
families on the CPU against the JAX package's engine, on the same weights
(``params_from_jax``) and the same numpy-seeded requests, for Mamba2-780m
and Zamba2-1.2B at their reduced widths.  The port's engine runs both of its tag chains — ``("cuda",
"reference")``, whose prefill and prefill-chunk steps go through the SSD
scan kernel's wrapper (its plain version on the CPU), and
``("reference",)`` — against the JAX engine's ``("pallas", "reference")``
and ``("reference",)``.  Greedy tokens must be identical, exact-length,
chunked (the carried-state chunk op) and through a forced mid-run
preempt/restore; the typed refusals must be the reference's."""

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.executor import BucketTable as JaxBucketTable
from repro.models import get_model as jax_get_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import UnsupportedFamilyError as JaxUnsupportedFamilyError
from repro.serving import ops as jax_serving_ops

from repro_torch.configs import get_config
from repro_torch.core.executor import BucketTable
from repro_torch.core.op_resolver import MicroMutableOpResolver
from repro_torch.core.schema import OpCode, OpDef
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ssd_scan as K8
from repro_torch.launch import serve
from repro_torch.models import get_model, params_from_jax
from repro_torch.serving import (RECURRENT_FAMILIES, Request, ServingEngine,
                                 UnsupportedFamilyError)
from repro_torch.serving import ops as serving_ops

ARCHS = ["mamba2-780m", "zamba2-1.2b"]
TAG_CHAINS = {("cuda", "reference"): ("pallas", "reference"),
              ("reference",): ("reference",)}
# tests/test_family_parity.py's workload: four prompts, six new tokens,
# two slots, chunks of 8 (every prompt but the shortest is chunked)
PROMPT_LENS = (21, 13, 30, 9)
N_NEW, SLOTS, CACHE_LEN, CHUNK = 6, 2, 64, 8
MODES = {"exact": {}, "chunked": {"prefill_chunk": CHUNK},
         "checkpointed": {}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module's torch work on one intra-op thread (the suite's
    parallel workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX bundle, JAX params, port bundle, port model)."""
    out = {}
    for arch in ARCHS:
        jbundle = jax_get_model(jax_get_config(arch, reduced=True))
        params = jbundle.init(jax.random.PRNGKey(0))
        cfg = get_config(arch, reduced=True)
        out[arch] = (jbundle, params, get_model(cfg),
                     params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu"))
    return out


def _requests(vocab, req_cls):
    rng = np.random.default_rng(5)
    return [req_cls(uid=uid, tokens=rng.integers(0, vocab - 2, n).astype(
        np.int32), max_new_tokens=N_NEW) for uid, n in enumerate(PROMPT_LENS)]


def _serve(eng, reqs, evict: bool):
    """Run ``reqs`` through ``eng``; with ``evict``, checkpoint whichever
    slot is busy at the third step and re-queue it (the conformance
    matrix's forced preemption).  Returns {uid: tokens}."""
    for r in reqs:
        eng.submit(r)
    steps, evicted = 0, False
    while eng.step():
        steps += 1
        assert steps < 500
        if evict and not evicted and steps >= 3:
            victim = next((s for s in range(eng.max_slots)
                           if eng.active[s] or s in eng._chunking), None)
            if victim is not None:
                eng._evict(victim)
                evicted = True
    assert evicted or not evict
    return {uid: r.output for uid, r in eng.results.items()}


@pytest.fixture(scope="module")
def jax_runs(models):
    """(arch, JAX tags, mode) -> the JAX engine's tokens, run once per
    module; the checkpointed mode's reference is the exact run (the JAX
    conformance matrix holds them equal)."""
    cache = {}

    def get(arch, tags, mode):
        mode = "exact" if mode == "checkpointed" else mode
        if (arch, tags, mode) not in cache:
            jbundle, params, _, _ = models[arch]
            eng = JaxServingEngine(jbundle, params, max_slots=SLOTS,
                                   cache_len=CACHE_LEN, tags=tags,
                                   prefill_buckets=False, **MODES[mode])
            cache[arch, tags, mode] = _serve(
                eng, _requests(jbundle.cfg.vocab, JaxRequest), False)
        return cache[arch, tags, mode]
    return get


def _engine(models, arch, tags=("cuda", "reference"), **kw):
    _, _, bundle, model = models[arch]
    return ServingEngine(bundle, model, max_slots=SLOTS, cache_len=CACHE_LEN,
                         tags=tags, device="cpu", **kw)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("tags", list(TAG_CHAINS), ids=["cuda", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(models, jax_runs, arch, tags, mode):
    want = jax_runs(arch, TAG_CHAINS[tags], mode)
    eng = _engine(models, arch, tags, **MODES[mode])
    assert eng.bucket_table is None             # recurrent: exact length
    for code in (OpCode.SERVING_PREFILL,) + (
            (OpCode.SERVING_PREFILL_CHUNK_STATE,) if mode == "chunked"
            else ()):
        # the tag chain's first entry serves the prefill steps
        assert eng.resolver.resolve(code).tag == tags[0]
    got = _serve(eng, _requests(eng.cfg.vocab, Request),
                 mode == "checkpointed")
    assert got == want
    assert all(len(t) == N_NEW for t in got.values())
    if mode == "checkpointed":
        assert sum(r.preemptions for r in eng.results.values()) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_accounting_matches_jax(models, arch):
    """The recurrent cache and the weights take the JAX engine's bytes."""
    jbundle, params, _, _ = models[arch]
    jeng = JaxServingEngine(jbundle, params, max_slots=SLOTS,
                            cache_len=CACHE_LEN)
    eng = _engine(models, arch)
    assert (eng.kv_bytes, eng.param_bytes, eng.arena.usage().persistent) \
        == (jeng.kv_bytes, jeng.param_bytes, jeng.arena.usage().persistent)
    assert sorted(eng.cache) == sorted(jeng.cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_state_roundtrip_and_in_place(models, arch):
    """The slot cache keeps its addresses through admissions, chunking and
    decode; a decoding slot's state extracts and inserts into another
    slot leaf for leaf (conv window, SSD state, shared-attention KV)."""
    eng = _engine(models, arch, prefill_chunk=CHUNK)
    ptrs = [t.data_ptr() for t in eng.cache.values()]
    for r in _requests(eng.cfg.vocab, Request)[:2]:
        eng.submit(r)
    for _ in range(5):
        eng.step()
        assert [t.data_ptr() for t in eng.cache.values()] == ptrs
    slot = int(np.flatnonzero(eng.active)[0])
    state = eng.extract_slot_state(slot)
    eng.insert_slot_state(1 - slot, state)
    back = eng.extract_slot_state(1 - slot)
    assert sorted(state) == sorted(eng.cache)
    for name, t in state.items():
        assert t.shape[1] == 1 and t.dtype == back[name].dtype
        assert torch.equal(t, back[name])


def test_typed_refusals_match_jax(models):
    """Where the reference refuses a recurrent family, the port refuses
    with the same typed error naming the family and the feature; the
    quantized recurrent engine is not ported yet and says so."""
    cases = [({"prefill_buckets": True}, None),
             ({"prefill_buckets": "table"}, "bucketed prefill"),
             ({"kv_block": 8}, "paged KV"),
             ({"kv_dtype": "int8"}, "int8 KV cache")]
    for arch in ARCHS:
        jbundle, params, _, _ = models[arch]
        family = jbundle.cfg.family
        for kw, feature in cases:
            if kw.get("prefill_buckets") == "table":
                jkw, pkw = ({"prefill_buckets": JaxBucketTable()},
                            {"prefill_buckets": BucketTable()})
            else:
                jkw = pkw = kw
            if feature is None:         # auto buckets: off for recurrent
                assert _engine(models, arch, **pkw).bucket_table is None
                continue
            with pytest.raises(JaxUnsupportedFamilyError) as jerr:
                JaxServingEngine(jbundle, params, max_slots=1,
                                 cache_len=CACHE_LEN, **jkw)
            with pytest.raises(UnsupportedFamilyError) as perr:
                _engine(models, arch, **pkw)
            for err in (jerr.value, perr.value):
                assert (err.family, feature in err.feature) == (family,
                                                                True)
            assert perr.value.feature == jerr.value.feature
        # the KV-offset chunk op refuses the recurrent families at prepare
        op = OpDef(OpCode.SERVING_PREFILL_CHUNK, (), (),
                   params={"window": None})
        with pytest.raises(JaxUnsupportedFamilyError, match=family):
            jax_serving_ops.RefServingPrefillChunk.prepare(
                jax_serving_ops.ServingContext(jbundle), op)
        with pytest.raises(UnsupportedFamilyError, match=family):
            serving_ops.RefServingPrefillChunk.prepare(
                serving_ops.ServingContext(models[arch][2]), op)
        # quantized weights are served (weight-only, as in the JAX
        # engine): the quantized ops resolve at construction
        eng = _engine(models, arch, weight_dtype="int8")
        assert eng.resolver.resolve(OpCode.SERVING_DECODE_Q).tag == "cuda"


@pytest.mark.parametrize("tag", ["reference", "cuda"])
def test_chunk_state_op_refuses_dense(tag):
    """The recurrent-state chunk op serves ssm and hybrid only, in both
    tags, as the reference's does."""
    bundle = get_model(get_config("yi-6b", reduced=True))
    code = OpCode.SERVING_PREFILL_CHUNK_STATE
    reg = MicroMutableOpResolver((tag,)).add_many([code]).resolve(code)
    assert reg.tag == tag
    with pytest.raises(UnsupportedFamilyError, match="dense") as err:
        reg.prepare(serving_ops.ServingContext(bundle),
                    OpDef(code, (), (), params={"window": None}))
    assert err.value.supported == RECURRENT_FAMILIES


def test_cuda_prefill_bakes_the_scan_kernel_for_recurrent_families():
    """The ``"cuda"`` SERVING_PREFILL puts K8's hook under the recurrent
    families' scan at prepare and leaves dense prefill as it is; on the
    CPU the hook runs the plain version and launches nothing."""
    code = OpCode.SERVING_PREFILL
    reg = MicroMutableOpResolver(("cuda",)).add_many([code]).resolve(code)
    op = OpDef(code, (), (), params={"cache_len": 32, "window": None})
    for arch, hooked in (("yi-6b", False), ("mamba2-780m", True),
                         ("zamba2-1.2b", True)):
        bundle = get_model(get_config(arch, reduced=True))
        od = reg.prepare(serving_ops.ServingContext(bundle), op).op_data
        assert (od["kw"].get("ssd_impl") is kernel_ops.ssd_chunked_kernel) \
            == hooked
        if hooked:
            model = bundle.init(torch.Generator().manual_seed(0))
            before = K8.launches
            toks = torch.arange(1, 20)[None]
            logits, cache = reg.eval(serving_ops.ServingContext(bundle, od),
                                     op, (model, {"tokens": toks}))
            want, want_cache = bundle.prefill(model, {"tokens": toks},
                                              cache_len=32)
            assert K8.launches == before
            torch.testing.assert_close(logits, want, rtol=0, atol=1e-5)
            torch.testing.assert_close(cache["state"], want_cache["state"],
                                       rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_the_cpu(capsys, arch):
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--cache-len", "32"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith(f"arch={arch}-smoke")
    assert sum(line.startswith("  req ") for line in out) == 3
    assert json.loads(out[-1])["tokens_generated"] >= 3
