"""The port's ReplicaRouter (serving/router.py) and routing policies
(serving/scheduling.py): the JAX package's tests/test_replica_router.py
in the port's terms, and tests/test_streaming.py's churn sweep over two
overlapped port replicas behind a rebalancing router.

The structural properties run against a fake replica with exactly the
engine surface the router touches (queue, results, active, slot_budget,
_chunking, _ckpt, max_slots, submit, step), so churn sweeps are cheap:

  * no request lost or duplicated — every uid finishes with one
    ``RequestResult`` at one replica, and ``routed`` agrees;
  * locality stickiness — checkpointed work routes home and is never
    migrated;
  * work conservation — no replica has capacity it cannot fill while
    another queues movable surplus;
  * policy swaps never capture — real reduced engines keep one decode
    program each, and routed tokens equal one unrouted engine's.

The streaming sweep (hypothesis, at most 25 examples) churns submits,
ticks and forced preemptions over two overlapped replicas and holds every
request's events and tokens to the port's own synchronous engine; one
deterministic case holds that engine to the JAX engine's tokens."""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attention import decode_attention_pallas
from repro.models import get_model as jax_get_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

from repro_torch.configs import get_config
from repro_torch.core import capture_count
from repro_torch.models import get_model, params_from_jax
from repro_torch.serving import (LocalityRouting, ReplicaLoad, ReplicaRouter,
                                 Request, RequestResult, ServingEngine,
                                 get_routing)

ARCH = "qwen3-32b"
CACHE_LEN = 64


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
    newer jax) for this module's JAX engine only, and drop the Pallas
    kernel's jit cache afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUMemorySpace"):
            mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                       raising=False)
        yield
    decode_attention_pallas.clear_cache()


# ---------------------------------------------------------------------
# fake replica: the exact engine surface ReplicaRouter touches
# ---------------------------------------------------------------------

class FakeReplica:
    """Engine stand-in with the router-facing surface of ServingEngine:
    FIFO admission into ``max_slots`` slots, one token per active slot
    per step.  ``output`` records which replica emitted each token so
    stickiness violations show up as mixed-provenance outputs."""

    def __init__(self, rid, max_slots=2):
        self.rid = rid
        self.max_slots = max_slots
        self.queue = []
        self.results = {}
        self.active = np.zeros((max_slots,), bool)
        self.slot_budget = np.zeros((max_slots,), np.int64)
        self._chunking = {}
        self._ckpt = {}
        self._slot = {}          # slot -> [uid, tokens_remaining]

    def submit(self, req):
        self.queue.append(req)
        self.results[req.uid] = RequestResult(uid=req.uid,
                                              prompt_len=len(req.tokens))

    def step(self):
        for s in range(self.max_slots):
            if not self.active[s] and self.queue:
                req = self.queue.pop(0)
                self.active[s] = True
                self._slot[s] = [req.uid, req.max_new_tokens]
                self.slot_budget[s] = req.max_new_tokens
        for s, ent in list(self._slot.items()):
            uid, _ = ent
            self.results[uid].output.append(self.rid)
            ent[1] -= 1
            self.slot_budget[s] = ent[1]
            if ent[1] == 0:
                self.results[uid].done = True
                self.active[s] = False
                del self._slot[s]
        return bool(self.queue) or bool(self._slot)


def _req(uid, n_new=3):
    return Request(uid=uid, tokens=np.zeros((4,), np.int32),
                   max_new_tokens=n_new)


def _churn(n_replicas, ops):
    """Drive a router through a submit/step op sequence, drain it, and
    assert the no-loss/no-duplication and bookkeeping invariants."""
    router = ReplicaRouter([FakeReplica(i) for i in range(n_replicas)],
                           routing="least-loaded")
    uid = 0
    submitted = set()
    for op in ops:
        if op == 0:
            router.step()
        else:
            for _ in range(op):
                router.submit(_req(uid))
                submitted.add(uid)
                uid += 1
    router.run()
    res = router.results
    assert set(res) == submitted
    assert all(res[u].done for u in submitted)
    total = sum(len(r.results) for r in router.replicas)
    assert total == len(submitted), "a uid is duplicated across replicas"
    for u in submitted:
        assert u in router.replicas[router.routed[u]].results
    # once a request starts at a replica, every token comes from it
    for u in submitted:
        assert len(set(res[u].output)) == 1, (u, res[u].output)
    return router


def _assert_conserved(router):
    """No replica needs work while another has movable surplus."""
    loads = router.loads()
    free = [max(0, l.slots - l.active) for l in loads]
    need = [max(0, f - l.queued) for f, l in zip(free, loads)]
    surplus = []
    for i, (f, l) in enumerate(zip(free, loads)):
        movable = sum(1 for q in router.replicas[i].queue
                      if q.uid not in router.replicas[i]._ckpt)
        surplus.append(max(0, min(l.queued, movable) - f))
    assert not (any(need) and any(surplus)), (need, surplus)


def test_no_request_lost_or_duplicated_deterministic():
    rng = np.random.default_rng(11)
    for n in (1, 2, 3, 4):
        for _ in range(5):
            ops = rng.integers(0, 4, rng.integers(3, 20)).tolist()
            router = _churn(n, ops)
            assert router.migrations >= 0


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 4),
       ops=st.lists(st.integers(0, 4), min_size=1, max_size=25))
def test_no_request_lost_or_duplicated_hypothesis(n, ops):
    _churn(n, ops)


@settings(max_examples=60, deadline=None)
@given(queues=st.lists(st.integers(0, 6), min_size=2, max_size=5),
       busy=st.lists(st.integers(0, 2), min_size=2, max_size=5))
def test_work_conservation_hypothesis(queues, busy):
    n = min(len(queues), len(busy))
    reps = [FakeReplica(i) for i in range(n)]
    uid = 0
    for i, r in enumerate(reps):
        for _ in range(min(busy[i], r.max_slots)):
            r.submit(_req(uid))
            uid += 1
        r.step()                     # admit the busy ones
        for _ in range(queues[i]):
            r.submit(_req(uid))
            uid += 1
    router = ReplicaRouter(reps)
    for r in reps:                   # adopt pre-submitted uids
        for q in list(r.results):
            router.routed[q] = r.rid
    router._rebalance()
    _assert_conserved(router)


def test_work_conservation_deterministic():
    a, b = FakeReplica(0), FakeReplica(1)
    router = ReplicaRouter([a, b], routing="round-robin")
    for uid in range(6):
        a.submit(_req(uid))
        router.routed[uid] = 0
    router.step()
    _assert_conserved(router)
    assert router.migrations >= 1
    assert len(b.results) >= 1
    res = router.run()
    assert set(res) == set(range(6))
    assert all(r.done for r in res.values())
    assert sum(len(r.results) for r in router.replicas) == 6


def test_locality_routing_sends_continuations_home():
    a, b = FakeReplica(0), FakeReplica(1)
    router = ReplicaRouter([a, b], routing="locality")
    b._ckpt[7] = object()            # continuation state parked at 1
    for uid in range(4):             # replica 1 is also the busier one
        b.submit(_req(uid))
        router.routed[uid] = 1
    assert router.submit(_req(7)) == 1
    assert router.submit(_req(8)) == 0


def test_rebalancer_never_migrates_checkpointed_work():
    a, b = FakeReplica(0), FakeReplica(1)
    router = ReplicaRouter([a, b])
    for uid in range(5):
        a.submit(_req(uid))
        router.routed[uid] = 0
    a._ckpt[3] = object()
    a._ckpt[4] = object()
    router._rebalance()
    assert 3 in a.results and 4 in a.results
    assert router.routed[3] == 0 and router.routed[4] == 0
    assert router.migrations >= 1


def test_routing_registry_and_errors():
    assert get_routing(None).name == "round-robin"
    pol = LocalityRouting()
    assert get_routing(pol) is pol
    assert get_routing("least-loaded").name == "least-loaded"
    with pytest.raises(ValueError, match="least-loaded"):
        get_routing("nope")
    with pytest.raises(ValueError):
        ReplicaRouter([])
    router = ReplicaRouter([FakeReplica(0)])
    router.submit(_req(1))
    with pytest.raises(ValueError, match="already routed"):
        router.submit(_req(1))


def test_replica_load_snapshot_shape():
    a = FakeReplica(0)
    for uid in range(3):
        a.submit(_req(uid))     # 3 tokens each
    a.step()                    # 2 admitted, each emitted 1 of 3
    (load,) = ReplicaRouter([a]).loads()
    assert load == ReplicaLoad(queued=1, active=2, slots=2, backlog=7)
    assert load.depth == 3


def test_least_loaded_routes_by_token_backlog_not_count():
    a, b = FakeReplica(0), FakeReplica(1)
    router = ReplicaRouter([a, b], routing="least-loaded")
    a.submit(_req(0, n_new=16))          # depth 1, backlog 16
    b.submit(_req(1))
    b.submit(_req(2))                    # depth 2, backlog 6
    router.routed.update({0: 0, 1: 1, 2: 1})
    assert router.submit(_req(3)) == 1


# ---------------------------------------------------------------------
# real engines: token parity across policies, swap never captures
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """(JAX bundle, JAX params, port bundle, port model, requests) at the
    reduced dense config, the port's weights converted from the JAX
    init."""
    jbundle = jax_get_model(jax_get_config(ARCH, reduced=True))
    params = jbundle.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, reduced=True)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    rng = np.random.default_rng(3)
    reqs = [(i, rng.integers(0, cfg.vocab - 2, 5 + (i % 3) * 7)
             .astype(np.int32)) for i in range(6)]
    return jbundle, params, get_model(cfg), model, reqs


def _engine(setup, **kw):
    _, _, bundle, model, _ = setup
    return ServingEngine(bundle, model, max_slots=2, cache_len=CACHE_LEN,
                         prefill_buckets=False, device="cpu", **kw)


def _base(setup):
    eng = _engine(setup)
    for uid, toks in setup[4]:
        eng.submit(Request(uid=uid, tokens=toks, max_new_tokens=4))
    return {u: tuple(r.output) for u, r in eng.run().items()}


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_routed_tokens_match_single_engine_every_policy(setup, overlap):
    base = _base(setup)
    for routing in ("round-robin", "least-loaded", "locality"):
        engs = [_engine(setup, overlap=overlap) for _ in range(2)]
        router = ReplicaRouter(engs, routing=routing)
        for uid, toks in setup[4]:
            router.submit(Request(uid=uid, tokens=toks, max_new_tokens=4))
        res = router.run()
        assert {u: tuple(x.output) for u, x in res.items()} == base, \
            routing
        for e in engs:
            assert capture_count(e._decode) == 1, routing


def test_policy_swap_mid_serve_never_captures(setup):
    base = _base(setup)
    reqs = setup[4]
    engs = [_engine(setup, overlap=True) for _ in range(2)]
    router = ReplicaRouter(engs, routing="round-robin")
    for uid, toks in reqs[:3]:
        router.submit(Request(uid=uid, tokens=toks, max_new_tokens=4))
    for _ in range(2):
        router.step()
    programs = lambda: [(capture_count(e._decode), capture_count(e._argmax))
                        for e in engs]
    before = programs()
    router.set_routing("least-loaded")
    for uid, toks in reqs[3:5]:
        router.submit(Request(uid=uid, tokens=toks, max_new_tokens=4))
    for _ in range(2):
        router.step()
    router.set_routing(LocalityRouting())
    router.submit(Request(uid=reqs[5][0], tokens=reqs[5][1],
                          max_new_tokens=4))
    res = router.run()
    assert before == programs() == [(1, 1), (1, 1)]
    assert {u: tuple(x.output) for u, x in res.items()} == base


# ---------------------------------------------------------------------
# streaming under churn: two overlapped replicas, one event sink
# ---------------------------------------------------------------------

N_NEW = 3


def _force_preempt(router):
    """Evict one busy slot somewhere in the fleet (drain first — the
    quiesce-before-surgery contract)."""
    for eng in router.replicas:
        eng.drain()
        victim = next((s for s in range(eng.max_slots)
                       if eng.active[s]), None)
        if victim is not None:
            eng._evict(victim)
            return True
    return False


def _stream_churn(setup, ops):
    """Drive two overlapped replicas through a submit/tick/preempt op
    sequence (0 = router tick, 3 = forced preempt, else submit that many
    requests), drain, and hold every request's StreamEvents and tokens
    to the port's synchronous engine on the same prompts."""
    _, _, bundle, _, _ = setup
    engs = [_engine(setup, overlap=True) for _ in range(2)]
    router = ReplicaRouter(engs, routing="least-loaded", rebalance=True)
    events = []
    router.set_on_token(events.append)
    rng = np.random.default_rng(13)
    prompts = {}
    preempted = False
    for op in ops:
        if op == 0:
            router.step()
        elif op == 3:
            preempted = _force_preempt(router) or preempted
        else:
            for _ in range(min(op, 2)):
                uid = len(prompts)
                prompts[uid] = rng.integers(0, bundle.cfg.vocab - 2, int(
                    rng.integers(5, 12))).astype(np.int32)
                router.submit(Request(uid=uid, tokens=prompts[uid],
                                      max_new_tokens=N_NEW))
    res = router.run()
    router.drain()
    sync = _engine(setup)
    for uid, toks in prompts.items():
        sync.submit(Request(uid=uid, tokens=toks, max_new_tokens=N_NEW))
    want = {u: r.output for u, r in sync.run().items()}
    assert set(res) == set(prompts)
    per = {}
    for ev in events:
        per.setdefault(ev.uid, []).append(ev)
    for u, r in res.items():
        assert r.done and r.output == want[u], u
        evs = per.get(u, [])
        assert [e.index for e in evs] == list(range(len(r.output))), u
        assert [e.token for e in evs] == r.output, u
        ts = [e.t_us for e in evs]
        assert ts == sorted(ts) and r.first_token_us == ts[0], u
        assert [e.final for e in evs] == \
            [False] * (len(evs) - 1) + [True], u
    for eng in engs:        # one decode program, on a replica that served
        assert capture_count(eng._decode) == int(bool(eng.results))
    return preempted, router, res


def test_streaming_invariants_deterministic(setup):
    """A hand-picked churn (burst, tick, preempt, refill) keeps the
    exactly-once ordered emission, and the port's synchronous engine it
    is held to emits the JAX engine's tokens on the same prompts."""
    preempted, router, res = _stream_churn(setup, [2, 0, 0, 3, 2, 0, 1, 3,
                                                   0])
    assert preempted
    assert sum(r.preemptions for r in router.results.values()) >= 1
    jbundle, params, _, _, _ = setup
    rng = np.random.default_rng(13)
    jeng = JaxServingEngine(jbundle, params, max_slots=2,
                            cache_len=CACHE_LEN, prefill_buckets=False,
                            tags=("reference",))
    for uid in range(len(res)):
        jeng.submit(JaxRequest(uid=uid, tokens=rng.integers(
            0, jbundle.cfg.vocab - 2, int(rng.integers(5, 12))).astype(
            np.int32), max_new_tokens=N_NEW))
    assert {u: r.output for u, r in jeng.run().items()} == \
        {u: r.output for u, r in res.items()}


@settings(max_examples=12, deadline=None)
@given(ops=st.lists(st.integers(0, 3), min_size=2, max_size=9))
def test_streaming_invariants_hypothesis(setup, ops):
    """Arbitrary admit/tick/preempt interleavings keep the contract."""
    _stream_churn(setup, ops)
