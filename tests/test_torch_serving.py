"""The slice as a whole: the port's ServingEngine on the CPU against the
JAX package's, on the same weights (``params_from_jax``) and the same
numpy-seeded requests, for the four dense architectures at their reduced
widths.  The port's engine runs both of its tag chains — ``("cuda",
"reference")``, whose decode goes through the decode-attention wrapper
(its plain version on the CPU), and ``("reference",)`` — against the JAX
engine's ``("pallas", "reference")`` (the Pallas kernel in interpret
mode) and ``("reference",)``.  Greedy tokens must be identical, bucketed
and exact, through a ring wrap and a preempt/restore; the arena
accounting must be the JAX engine's to the byte."""

import json

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import repro.core.executor as jax_executor
import repro.serving.scheduling as jax_scheduling
from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attention import decode_attention_pallas
from repro.models import get_model as jax_get_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

from repro_torch.configs import get_config
from repro_torch.core.executor import BucketTable
from repro_torch.core.schema import OpCode
from repro_torch.launch import serve
from repro_torch.models import get_model, params_from_jax
from repro_torch.serving import (Request, ServingEngine, StreamEvent,
                                 scheduling)

ARCHS = ["yi-6b", "phi3-mini-3.8b", "phi4-mini-3.8b", "qwen3-32b"]
# port tag chain -> the JAX engine's counterpart
TAG_CHAINS = {("cuda", "reference"): ("pallas", "reference"),
              ("reference",): ("reference",)}
SLOTS, CACHE_LEN = 4, 64
# (prompt length, new tokens): a single-token prompt, one that decodes
# past the 64-position ring (30 + 40), and one longer than the ring
# (prefilled at exact length, its last 64 positions kept); uid 6 is the
# tight-deadline request of the preemption test
WORKLOAD = [(5, 8), (12, 8), (30, 40), (1, 8), (9, 8), (70, 8), (7, 5)]
URGENT = 6


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
    kernel's jit cache afterwards so no program traced under the alias
    outlives the module."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUMemorySpace"):
            mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                       raising=False)
        yield
    decode_attention_pallas.clear_cache()


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab - 2, n).astype(np.int32)
            for n, _ in WORKLOAD]


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


@pytest.fixture(scope="module")
def jax_runs(models):
    """(arch, JAX tags) -> (the JAX engine, its results) over the whole
    workload, run once per module."""
    cache = {}

    def get(arch, tags):
        if (arch, tags) not in cache:
            jbundle, params, _, _ = models[arch]
            eng = JaxServingEngine(jbundle, params, max_slots=SLOTS,
                                   cache_len=CACHE_LEN, tags=tags)
            for uid, (toks, (_, new)) in enumerate(zip(
                    _prompts(jbundle.cfg.vocab), WORKLOAD)):
                eng.submit(JaxRequest(uid=uid, tokens=toks,
                                      max_new_tokens=new))
            cache[arch, tags] = eng, eng.run()
        return cache[arch, tags]
    return get


def _engine(models, arch, tags, **kw):
    _, _, bundle, model = models[arch]
    return ServingEngine(bundle, model, max_slots=SLOTS,
                         cache_len=CACHE_LEN, tags=tags, device="cpu", **kw)


def _outputs(results):
    return {uid: r.output for uid, r in results.items()}


@pytest.mark.parametrize("buckets", [True, False],
                         ids=["bucketed", "exact"])
@pytest.mark.parametrize("tags", list(TAG_CHAINS), ids=["cuda", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(models, jax_runs, arch, tags, buckets):
    jeng, want = jax_runs(arch, TAG_CHAINS[tags])
    eng = _engine(models, arch, tags, prefill_buckets=buckets)
    for uid, (toks, (_, new)) in enumerate(zip(
            _prompts(eng.cfg.vocab), WORKLOAD)):
        eng.submit(Request(uid=uid, tokens=toks, max_new_tokens=new))
    # the tag chain's first entry serves the decode step
    assert eng.resolver.resolve(OpCode.SERVING_DECODE).tag == tags[0]
    got = eng.run()
    assert _outputs(got) == _outputs(want)
    assert all(r.done for r in got.values())
    # the ring-wrapping request really decoded past the cache
    assert WORKLOAD[2][0] + len(got[2].output) > CACHE_LEN
    assert (eng.kv_bytes, eng.param_bytes, eng.arena.usage().persistent) \
        == (jeng.kv_bytes, jeng.param_bytes, jeng.arena.usage().persistent)
    if buckets:
        assert eng.bucket_table.hits == jeng.bucket_table.hits
    else:
        assert eng.bucket_table is None


@pytest.mark.parametrize("tags", list(TAG_CHAINS), ids=["cuda", "reference"])
@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-32b"])
def test_preempt_restore_tokens_match_jax(models, jax_runs, arch, tags):
    """A tight-deadline request arrives with every slot decoding: EDF
    displacement evicts a running request to host memory, and it later
    resumes (in whichever slot frees) with the tokens of the JAX
    engine's uninterrupted run — as does every other request."""
    _, want = jax_runs(arch, TAG_CHAINS[tags])
    eng = _engine(models, arch, tags, policy="edf",
                  preempt="edf-displace", clock=lambda: 0)
    prompts = _prompts(eng.cfg.vocab)
    for uid, (toks, (_, new)) in enumerate(zip(prompts, WORKLOAD)):
        if uid != URGENT:
            eng.submit(Request(uid=uid, tokens=toks, max_new_tokens=new))
    for _ in range(3):
        eng.step()
    assert eng.active.all() and all(
        eng.results[uid].output for uid in range(SLOTS))
    eng.submit(Request(uid=URGENT, tokens=prompts[URGENT],
                       max_new_tokens=WORKLOAD[URGENT][1], deadline_us=100))
    eng.step()
    assert sum(r.preemptions for r in eng.results.values()) == 1
    assert eng.results[URGENT].preemptions == 0
    assert _outputs(eng.run()) == _outputs(want)


def test_engine_state_stays_in_place():
    """The KV cache and slot bookkeeping are allocated once: a decode
    step writes them in place, across admissions and retirements."""
    cfg = get_config("yi-6b", reduced=True)
    bundle = get_model(cfg)
    eng = ServingEngine(bundle, bundle.init(torch.Generator().manual_seed(0)),
                        max_slots=2, cache_len=32, device="cpu")
    ptrs = lambda: [t.data_ptr() for t in (eng.cache["k"], eng.cache["v"],
                                           eng.lengths, eng.cur_tokens)]
    before = ptrs()
    for uid, n in enumerate((6, 3, 9)):
        eng.submit(Request(uid=uid, tokens=np.arange(1, n + 1, dtype=np.int32),
                           max_new_tokens=4))
    while eng.step():
        assert ptrs() == before
    assert all(r.done and len(r.output) >= 1 for r in eng.results.values())


def test_on_token_streams_every_token_in_order():
    cfg = get_config("qwen3-32b", reduced=True)
    bundle = get_model(cfg)
    events = []
    eng = ServingEngine(bundle, bundle.init(torch.Generator().manual_seed(1)),
                        max_slots=2, cache_len=32, device="cpu",
                        on_token=events.append)
    for uid in range(3):
        eng.submit(Request(uid=uid, tokens=np.full(4 + uid, 7, np.int32),
                           max_new_tokens=3))
    res = eng.run()
    assert all(isinstance(e, StreamEvent) for e in events)
    for uid, r in res.items():
        mine = [e for e in events if e.uid == uid]
        assert [e.index for e in mine] == list(range(len(r.output)))
        assert [e.token for e in mine] == r.output
        assert [e.final for e in mine] == [False] * (len(mine) - 1) + [True]
        assert r.first_token_us is not None


@pytest.mark.parametrize("option,value", [
    ("mesh", object()), ("overlap", True)])
def test_unported_options_raise(option, value):
    """Both options are ported: ``mesh=`` takes a serving mesh of this
    process's ranks (``launch.mesh``; ``tests/test_torch_sharded_serving.py``
    serves on one), and anything else is refused with ``TypeError``.
    ``overlap=`` constructs alone, and with a bogus ``mesh=`` the mesh
    refusal still stands."""
    cfg = get_config("yi-6b", reduced=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    kw = {option: value}
    if option == "overlap":
        assert ServingEngine(bundle, model, device="cpu", **kw).overlap
        kw["mesh"] = object()
    with pytest.raises(TypeError, match="make_serving_mesh"):
        ServingEngine(bundle, model, device="cpu", **kw)


def test_engine_device_checks():
    cfg = get_config("yi-6b", reduced=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    with pytest.raises(TypeError):
        ServingEngine(bundle, model, device="cpu", prefill_buckets=16)
    if not torch.cuda.is_available():
        # the default device is the card; without one the engine raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(bundle, model)


@pytest.mark.parametrize("levels", [None, (3, 10, 40)])
def test_bucket_table_matches_jax(levels):
    kw = ({"levels": levels} if levels
          else {"min_bucket": 8, "max_bucket": 64})
    ours, theirs = BucketTable(**kw), jax_executor.BucketTable(**kw)
    assert ours.levels == theirs.levels
    for n in range(1, 70):
        assert ours.fit(n) == theirs.fit(n)
        if theirs.fit(n) is not None:
            assert ours.bucket(n) == theirs.bucket(n)
    assert ours.hits == theirs.hits


@pytest.mark.parametrize("name", ["fifo", "priority", "edf", "wfq"])
def test_scheduling_copy_orders_like_jax(name):
    """The port's copy of the policies admits in the JAX package's order
    (and displaces the same victims) on a seeded random queue."""
    rng = np.random.default_rng(4)
    reqs = [dict(uid=i, tokens=np.zeros(3, np.int32),
                 priority=int(rng.integers(0, 3)),
                 deadline_us=(None if rng.random() < 0.3
                              else int(rng.integers(0, 1000))),
                 arrival_us=int(rng.integers(0, 100)),
                 tenant=str(rng.integers(0, 3))) for i in range(12)]
    orders = []
    for mod, req_cls in ((scheduling, Request), (jax_scheduling,
                                                 JaxRequest)):
        policy = mod.get_policy(name)
        displace = mod.get_preemption("edf-displace")
        queue = [req_cls(**r) for r in reqs]
        order = []
        while queue:
            nxt = policy.pop(queue, 500)
            policy.charge(nxt.tenant, 1.0)
            order.append((nxt.uid, displace.victim(queue, nxt, 500)))
        orders.append(order)
    assert orders[0] == orders[1]


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", "yi-6b", "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--cache-len", "32"])
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["device"] == "cpu"
    assert summary["tokens_generated"] >= 3
    assert sum(line.startswith("  req ") for line in out) == 3
