"""The overlapped decode loop of the port's ServingEngine (``overlap=True``)
against the JAX engine on the same weights (``params_from_jax``) and
numpy-seeded requests, at the reduced configs, one JAX engine
configuration per architecture (its synchronous run; dense also runs the
JAX overlapped engine, whose program counts the port's are held to):

  * overlapped tokens equal the JAX synchronous engine's on dense
    (contiguous and paged), moe, ssm, hybrid and vlm, under both of the
    port's tag chains;
  * the StreamEvent contract: per uid, indices 0, 1, ... with no gap or
    repeat, the tokens its output, one final, the last;
  * a drain and a forced evict mid-stream, then the restore, emit no
    duplicate and drop no token;
  * a slot that retires one step late is admitted again while the next
    step is in flight, and its new request's tokens are still right;
  * audio refuses overlap with the JAX engine's typed error;
  * ``capture_count`` of ``_decode`` and ``_argmax`` equals the JAX
    engine's ``jit_cache_size`` in both modes.

On the CPU the readback is a plain copy; the card's two pinned buffers
and event are held in tests/test_torch_cuda.py."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as jax_get_config
from repro.core.executor import jit_cache_size
from repro.kernels.decode_attention import decode_attention_pallas
from repro.models import get_model as jax_get_model
from repro.serving import STREAMING_FAMILIES as JAX_STREAMING_FAMILIES
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

from repro_torch.configs import get_config
from repro_torch.core import capture_count
from repro_torch.models import get_model, params_from_jax
from repro_torch.serving import (STREAMING_FAMILIES, Request, ServingEngine,
                                 UnsupportedFamilyError)

ARCHS = {"dense": "yi-6b", "moe": "deepseek-moe-16b", "ssm": "mamba2-780m",
         "hybrid": "zamba2-1.2b", "vlm": "paligemma-3b"}
TAG_CHAINS = [("cuda", "reference"), ("reference",)]
SLOTS = 2
# (prompt length, new tokens): more requests than slots, budgets that
# retire slots at different steps, so freed slots are admitted again
# while a step is in flight
WORKLOAD = [(21, 6), (13, 2), (30, 7), (9, 3), (5, 5)]
# (family, mode) -> engine keywords of both engines (paged is held to the
# JAX engine's contiguous run, which its conformance matrix holds equal)
CASES = {("dense", "contiguous"): {}, ("dense", "paged"): {"kv_block": 8},
         ("moe", "contiguous"): {}, ("ssm", "contiguous"): {},
         ("hybrid", "contiguous"): {}, ("vlm", "contiguous"): {}}


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
    requests (uid, tokens, new, extras))."""
    out = {}
    for family, arch in ARCHS.items():
        jbundle = jax_get_model(jax_get_config(arch, reduced=True))
        params = jbundle.init(jax.random.PRNGKey(0))
        cfg = get_config(arch, reduced=True)
        rng = np.random.default_rng(11)
        reqs = []
        for uid, (n, new) in enumerate(WORKLOAD):
            toks = rng.integers(0, cfg.vocab - 2, n).astype(np.int32)
            extras = ({"vision": rng.normal(
                0, 1, (cfg.n_vision_tokens, cfg.d_vision)).astype(np.float32)}
                if family == "vlm" else None)
            reqs.append((uid, toks, new, extras))
        out[family] = (jbundle, params, get_model(cfg), params_from_jax(
            jax.tree.map(np.asarray, params), cfg, device="cpu"), reqs)
    return out


def _cache_len(cfg):
    # the vision prefix takes cache rows in front of the prompt
    return 64 + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)


def _submit(engine, request, reqs):
    for uid, toks, new, extras in reqs:
        engine.submit(request(uid=uid, tokens=toks, max_new_tokens=new,
                              extras=extras))


def _outputs(engine, reqs):
    return {uid: engine.results[uid].output for uid, *_ in reqs}


@pytest.fixture(scope="module")
def jax_runs(models):
    """family -> (JAX engine, its tokens): the synchronous JAX engine on
    its ``("reference",)`` chain, once per module; ``"dense-overlap"``
    is the JAX overlapped engine on the dense workload."""
    cache = {}

    def get(family, overlap=False):
        key = f"{family}-overlap" if overlap else family
        if key not in cache:
            jbundle, params, _, _, reqs = models[family]
            eng = JaxServingEngine(jbundle, params, max_slots=SLOTS,
                                   cache_len=_cache_len(jbundle.cfg),
                                   prefill_buckets=False,
                                   tags=("reference",), overlap=overlap)
            _submit(eng, JaxRequest, reqs)
            eng.run()
            cache[key] = eng, _outputs(eng, reqs)
        return cache[key]
    return get


def _engine(models, family, tags=("cuda", "reference"), **kw):
    _, _, bundle, model, _ = models[family]
    return ServingEngine(bundle, model, max_slots=SLOTS,
                         cache_len=_cache_len(bundle.cfg),
                         prefill_buckets=False, tags=tags, device="cpu",
                         **kw)


def _check_events(events, outputs):
    """The StreamEvent contract for every request of ``outputs``."""
    per = {}
    for ev in events:
        per.setdefault(ev.uid, []).append(ev)
    assert sorted(per) == sorted(outputs)
    for uid, evs in per.items():
        n = len(outputs[uid])
        assert [e.index for e in evs] == list(range(n)), uid
        assert [e.token for e in evs] == outputs[uid], uid
        assert [e.final for e in evs] == [False] * (n - 1) + [True], uid
        ts = [e.t_us for e in evs]
        assert ts == sorted(ts), uid


@pytest.mark.parametrize("tags", TAG_CHAINS, ids=["cuda", "reference"])
@pytest.mark.parametrize("family,mode", list(CASES),
                         ids=[f"{f}-{m}" for f, m in CASES])
def test_overlap_tokens_match_jax_sync(models, jax_runs, family, mode, tags):
    _, want = jax_runs(family)
    events = []
    eng = _engine(models, family, tags, overlap=True,
                  on_token=events.append, **CASES[family, mode])
    reqs = models[family][4]
    _submit(eng, Request, reqs)
    eng.run()
    got = _outputs(eng, reqs)
    assert got == want
    _check_events(events, got)
    assert eng._inflight is None
    assert capture_count(eng._decode) == capture_count(eng._argmax) == 1
    if eng.paged:
        assert eng.pool.free_blocks() == eng.pool.usable_blocks


def test_capture_counts_match_jax(models, jax_runs):
    """Both modes' decode and argmax programs: one decode program; the
    argmax program once on an overlapped engine and never on a sync one,
    as the JAX engine's ``jit_cache_size``."""
    jsync, want = jax_runs("dense")
    jover, jtoks = jax_runs("dense", overlap=True)
    assert jtoks == want
    reqs = models["dense"][4]
    for overlap, jeng in ((False, jsync), (True, jover)):
        eng = _engine(models, "dense", overlap=overlap)
        _submit(eng, Request, reqs)
        eng.run()
        assert _outputs(eng, reqs) == want
        assert (capture_count(eng._decode), capture_count(eng._argmax)) \
            == (jit_cache_size(jeng._decode), jit_cache_size(jeng._argmax)) \
            == (1, int(overlap))
        assert ("argmax" in eng.programs()) == overlap
        assert eng.prefill_compiles() == jeng.prefill_compiles()


@pytest.mark.parametrize("kv_block", [None, 8], ids=["contiguous", "paged"])
def test_drain_evict_restore_no_dup_no_drop(models, jax_runs, kv_block):
    """Three ticks in, a drain and a forced evict of a decoding request,
    which later restores (into whichever slot frees): every request emits
    the JAX engine's uninterrupted tokens, each event once, in order."""
    _, want = jax_runs("dense")
    events = []
    eng = _engine(models, "dense", overlap=True, on_token=events.append,
                  kv_block=kv_block)
    reqs = models["dense"][4]
    _submit(eng, Request, reqs)
    for _ in range(3):
        eng.step()
    assert eng._inflight is not None
    eng.drain()
    assert eng._inflight is None
    victim = next(s for s in range(SLOTS) if eng.active[s])
    uid = eng.slot_meta[victim].uid
    before = list(eng.results[uid].output)
    eng._evict(victim)
    assert eng.results[uid].output == before      # nothing emitted twice
    eng.run()
    got = _outputs(eng, reqs)
    assert got == want
    assert eng.results[uid].preemptions == 1
    _check_events(events, got)
    assert capture_count(eng._decode) == capture_count(eng._argmax) == 1


@pytest.mark.parametrize("kv_block", [None, 8], ids=["contiguous", "paged"])
def test_late_retired_slot_readmitted_in_flight(models, jax_runs, kv_block):
    """A request's last token is learned one step late, after the next
    step was dispatched with its slot still in it; that slot is then
    admitted again while that step is in flight (its wasted ring write
    for the retired request lands before the new prefill's rows, in
    stream order).  Every request still emits the JAX engine's tokens."""
    _, want = jax_runs("dense")
    eng = _engine(models, "dense", overlap=True, kv_block=kv_block)
    admitted = []
    admit = eng._admit

    def watched(req, slot):
        inflight = eng._inflight
        admitted.append((req.uid, slot, inflight is not None and any(
            s == slot and res.done for s, res, _ in inflight.slots)))
        admit(req, slot)
    eng._admit = watched
    reqs = models["dense"][4]
    _submit(eng, Request, reqs)
    eng.run()
    assert _outputs(eng, reqs) == want
    # some admission went into a slot whose retired request the step in
    # flight was dispatched with
    assert any(late for _, _, late in admitted), admitted


def test_audio_refuses_overlap(models):
    assert STREAMING_FAMILIES == JAX_STREAMING_FAMILIES
    cfg = get_config("whisper-large-v3", reduced=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    with pytest.raises(UnsupportedFamilyError, match="overlapped") as err:
        ServingEngine(bundle, model, max_slots=SLOTS, cache_len=32,
                      overlap=True, device="cpu")
    assert tuple(err.value.supported) == JAX_STREAMING_FAMILIES
    # the sync engine serves audio as before
    assert not ServingEngine(bundle, model, max_slots=SLOTS, cache_len=32,
                             device="cpu").overlap


def test_last_step_counts_processed_tokens(models):
    """``last_step["processed"]`` counts the tokens a step emitted: one a
    live slot on a sync engine; on an overlapped engine the previous
    step's, so the first dispatch emits none."""
    reqs = models["dense"][4][:SLOTS]
    for overlap in (False, True):
        eng = _engine(models, "dense", overlap=overlap)
        _submit(eng, Request, reqs)
        eng.step()
        assert eng.last_step["processed"] == (0 if overlap else SLOTS)
        total = eng.last_step["processed"]
        while eng.step():
            total += eng.last_step["processed"]
        total += eng.last_step["processed"]
        assert total == sum(len(r.output) for r in eng.results.values())
