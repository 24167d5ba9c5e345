"""The port's MultiTenantHost (serving/host.py) on the CPU against the JAX
package's, on the same exported blobs, the same weights
(``params_from_jax``) and the same seeded requests — the host cases of
tests/test_ragged.py (:285, :320), tests/test_executor.py (:249, :286),
tests/test_serving.py (:83), tests/test_scheduling.py (:111) and
tests/test_preemption.py (:196, :282).  Each holds the port's results to
the JAX host's (int8 and tokens equal, float within FLOAT_TOL) and its
``usage()`` to the JAX host's byte for byte."""

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import repro.apps.models as jax_apps
import repro.core as jax_core
import repro.serving as jax_serving
from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attention import decode_attention_pallas
from repro.models import get_model as jax_get_model

import repro_torch.kernels  # noqa: F401  (registers the "cuda" tag)
from repro_torch.configs import get_config
from repro_torch.core import (AllOpsResolver, CalibrationProfile,
                              MicroInterpreter, MicroModel,
                              capture_count)
from repro_torch.models import get_model, params_from_jax
from repro_torch.serving import (MultiTenantHost, Request, ServingEngine,
                                 WFQPolicy)

# float32 sums of one model in the two frameworks' orders
FLOAT_TOL = 1e-5
CPU = {"device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_aliases():
    """Alias ``jax.experimental.enable_x64`` (moved to ``jax.enable_x64``)
    and ``pltpu.TPUMemorySpace`` (renamed ``pltpu.MemorySpace``) in newer
    jax, for this module's JAX hosts only; drop the Pallas kernel's jit
    cache afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        if not hasattr(pltpu, "TPUMemorySpace"):
            mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                       raising=False)
        yield
    decode_attention_pallas.clear_cache()


def _blob(name, int8, **kw):
    gb = getattr(jax_apps, name)(**kw)
    if not int8:
        return jax_core.export(gb)
    return jax_core.export(gb, jax_apps.representative_dataset(gb),
                           quantize_int8=True)


@pytest.fixture(scope="module")
def blobs():
    return {"conv": _blob("build_conv_reference", False),
            "fc_int8": _blob("build_fc_stack", True),
            "hotword": _blob("build_hotword", False, n_layers=1)}


@pytest.fixture(scope="module")
def lms():
    """arch -> (JAX bundle, JAX params, port bundle, port model)."""
    out = {}
    for arch in ("qwen3-32b", "mamba2-780m"):
        jbundle = jax_get_model(jax_get_config(arch, reduced=True))
        params = jbundle.init(jax.random.PRNGKey(0))
        cfg = get_config(arch, reduced=True)
        out[arch] = (jbundle, params, get_model(cfg), params_from_jax(
            jax.tree.map(np.asarray, params), cfg, **CPU))
    return out


def _hosts(arena_bytes, **kw):
    """(JAX host, port host) with the same arguments."""
    return (jax_serving.MultiTenantHost(arena_bytes, **kw),
            MultiTenantHost(arena_bytes, **kw, **CPU))


def _models(blob):
    """(JAX model and resolver, port model and resolver) of one blob."""
    return ((jax_core.MicroModel(blob), jax_core.AllOpsResolver()),
            (MicroModel(blob), AllOpsResolver()))


def _alone(blob, frames):
    """Each frame in turn through one fresh port MicroInterpreter."""
    model, res = MicroModel(blob), AllOpsResolver()
    it = MicroInterpreter(model, res, MicroInterpreter.required_arena_size(
        model, res), **CPU)
    outs = []
    for f in frames:
        it.set_input(0, f)
        it.invoke()
        outs.append(it.output(0).copy())
    return outs


def _same_usage(jhost, host):
    assert dataclasses.astuple(host.usage()) == \
        dataclasses.astuple(jhost.usage())
    assert [(a.offset, a.nbytes) for a in host.arena.tail_allocs] == \
        [(a.offset, a.nbytes) for a in jhost.arena.tail_allocs]


def _same_micro(jhost, host, name, int8):
    for uid, want in jhost.micro_results[name].items():
        got = host.micro_results[name][uid]
        assert (got.done, got.steps, got.preemptions) == \
            (want.done, want.steps, want.preemptions), uid
        assert len(got.outputs) == len(want.outputs), uid
        for g, w in zip(got.outputs, want.outputs):
            if int8:
                np.testing.assert_array_equal(g, np.asarray(w))
            else:
                np.testing.assert_allclose(g, np.asarray(w), atol=FLOAT_TOL,
                                           rtol=FLOAT_TOL)


def test_host_ragged_micro_bit_identity(blobs):
    """tests/test_ragged.py:285 — int8-FC and streaming-SVDF ragged
    tenants drain through run_all with more requests than lanes: every
    result bit-identical to the request alone (port) and to the JAX
    host's (int8; float within FLOAT_TOL); the arena's usage the JAX
    host's."""
    rng = np.random.default_rng(6)
    fc_reqs = {i: [rng.normal(0, 1, (1, 64)).astype(np.float32)]
               for i in range(5)}
    hw_reqs = {i: [rng.normal(0, 1, (1, 40)).astype(np.float32)
                   for _ in range(n)]
               for i, n in enumerate((2, 1, 3))}
    hosts = _hosts(64 << 20)
    for host, (fc, hw) in zip(hosts, zip(_models(blobs["fc_int8"]),
                                         _models(blobs["hotword"]))):
        host.add_ragged_micro("fc", *fc, lanes=2)
        host.add_ragged_micro("hw", *hw, lanes=2, exact=True)
        for uid, frames in fc_reqs.items():
            host.submit_micro("fc", uid, [[f] for f in frames])
        for uid, frames in hw_reqs.items():
            host.submit_micro("hw", uid, [[f] for f in frames])
        host.run_all()
    jhost, host = hosts
    for uid, frames in fc_reqs.items():
        res = host.micro_results["fc"][uid]
        assert res.done and res.steps == len(frames)
        np.testing.assert_array_equal(res.outputs[-1],
                                      _alone(blobs["fc_int8"], frames)[-1])
    for uid, frames in hw_reqs.items():
        res = host.micro_results["hw"][uid]
        assert res.done and res.steps == len(frames)
        for got, want in zip(res.outputs, _alone(blobs["hotword"], frames)):
            np.testing.assert_array_equal(got, want)
    _same_micro(jhost, host, "fc", int8=True)
    _same_micro(jhost, host, "hw", int8=False)
    _same_usage(jhost, host)


def test_host_mixed_micro_pod_one_scheduler(blobs, lms):
    """tests/test_ragged.py:320 — an int8 FC micro tenant and a pod
    engine tenant in ONE host, drained by ONE run_all: the engine's
    tokens are a solo engine's and the JAX host's, the micro results
    bit-identical, the usage the JAX host's."""
    jbundle, params, bundle, model = lms["qwen3-32b"]
    prompt = np.arange(1, 6, dtype=np.int32)
    solo = ServingEngine(bundle, model, max_slots=1, cache_len=32, **CPU)
    solo.submit(Request(uid=1, tokens=prompt, max_new_tokens=3))
    want_tokens = solo.run()[1].output
    rng = np.random.default_rng(7)
    xs = [rng.normal(0, 1, (1, 64)).astype(np.float32) for _ in range(3)]
    hosts = _hosts(256 << 20)
    results = []
    for host, fc, (b, p), req in zip(
            hosts, _models(blobs["fc_int8"]),
            ((jbundle, params), (bundle, model)),
            (jax_serving.Request, Request)):
        host.add_model("lm", b, p, max_slots=1, cache_len=32)
        host.add_ragged_micro("fc", *fc, lanes=2)
        for uid, x in enumerate(xs):
            host.submit_micro("fc", uid, [[x]])
        host.submit("lm", req(uid=1, tokens=prompt, max_new_tokens=3))
        results.append(host.run_all())
    jres, res = results
    assert res["lm"][1].output == want_tokens == jres["lm"][1].output
    jhost, host = hosts
    for uid, x in enumerate(xs):
        got = host.micro_results["fc"][uid]
        assert got.done
        np.testing.assert_array_equal(got.outputs[0],
                                      _alone(blobs["fc_int8"], [x])[0])
    _same_micro(jhost, host, "fc", int8=True)
    _same_usage(jhost, host)


def test_host_micro_requests_are_independent(blobs):
    """tests/test_executor.py:249 — a stateful micro model (SVDF) through
    run_micro: every request starts from fresh variable state, later
    chunks included; outputs the fresh interpreters' and the JAX
    host's."""
    rng = np.random.default_rng(21)
    xs = [rng.normal(0, 1, (1, 40)).astype(np.float32) for _ in range(5)]
    want = [_alone(blobs["hotword"], [x])[0] for x in xs]
    hosts = _hosts(64 << 20)
    got = []
    for host, hw in zip(hosts, _models(blobs["hotword"])):
        host.add_micro_model("hw", *hw, batch=2)        # 3 chunks
        got.append(host.run_micro("hw", [[x] for x in xs]))
    for g, jg, w in zip(got[1], got[0], want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(g, np.asarray(jg), atol=FLOAT_TOL,
                                   rtol=FLOAT_TOL)
    _same_usage(*hosts)


def test_host_micro_model_tenancy(blobs):
    """tests/test_executor.py:286 — a batch-4 conv tenant: its
    persistents stack in the host arena, run_micro serves 6 requests in
    two chunks equal to one invoke each and to the JAX host's."""
    rng = np.random.default_rng(13)
    xs = [rng.normal(0, 1, (1, 16, 16, 1)).astype(np.float32)
          for _ in range(6)]
    hosts = _hosts(64 << 20)
    got = []
    for host, conv in zip(hosts, _models(blobs["conv"])):
        tail0 = len(host.arena.tail_allocs)
        pool = host.add_micro_model("conv", *conv, batch=4)
        assert len(host.arena.tail_allocs) > tail0   # persistents stacked
        got.append(host.run_micro("conv", [[x] for x in xs]))
    assert len(got[1]) == 6
    for g, jg, x in zip(got[1], got[0], xs):
        np.testing.assert_allclose(g, _alone(blobs["conv"], [x])[0],
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(g, np.asarray(jg), atol=FLOAT_TOL,
                                   rtol=FLOAT_TOL)
    assert capture_count(pool.program) == 1
    _same_usage(*hosts)


def test_multitenant_host_arena_accounting(lms):
    """tests/test_serving.py:83 — a dense and an ssm engine tenant on one
    arena: both KV persistents stacked, the usage the JAX host's to the
    byte, each tenant's tokens the JAX host's."""
    hosts = _hosts(256 << 20)
    results = []
    for k, host in enumerate(hosts):
        for name, arch in (("lm", "qwen3-32b"), ("ssm", "mamba2-780m")):
            jbundle, params, bundle, model = lms[arch]
            b, p = (jbundle, params) if k == 0 else (bundle, model)
            req = jax_serving.Request if k == 0 else Request
            host.add_model(name, b, p, max_slots=1, cache_len=32)
            prompt = np.random.default_rng(3).integers(
                0, b.cfg.vocab - 2, 6).astype(np.int32)
            host.submit(name, req(uid=1, tokens=prompt, max_new_tokens=3))
        results.append(host.run_all())
    jres, res = results
    for name in ("lm", "ssm"):
        assert res[name][1].output == jres[name][1].output
        assert len(res[name][1].output) == 3
    jhost, host = hosts
    assert host.usage().persistent > 0
    assert len(host.arena.tail_allocs) >= 2
    _same_usage(jhost, host)


def test_micro_edf_admission_order_under_contention(blobs):
    """tests/test_scheduling.py:111 — four same-instant requests, two
    lanes, EDF: the two earliest deadlines served in wave 1, the others
    in wave 2, as on the JAX host."""
    waves_of = []
    for host, fc in zip(_hosts(64 << 20, policy="edf", clock=lambda: 0),
                        _models(blobs["fc_int8"])):
        rng = np.random.default_rng(0)
        host.add_ragged_micro("fc", *fc, lanes=2)
        for uid, d in {0: 400, 1: 100, 2: 300, 3: 200}.items():
            host.submit_micro(
                "fc", uid, [[rng.normal(0, 1, (1, 64)).astype(np.float32)]],
                deadline_us=d, arrival_us=0)
        waves, seen = [], set()
        while True:
            pending = host.micro_step()
            done = {uid for uid, r in host.micro_results["fc"].items()
                    if r.done}
            if done - seen:
                waves.append(done - seen)
                seen |= done
            if not pending:
                break
        waves_of.append(waves)
    assert waves_of[1][0] == {1, 3}         # deadlines 100 and 200 first
    assert waves_of[1] == waves_of[0]


def test_host_preempts_monopolizer_for_tight_deadline(blobs):
    """tests/test_preemption.py:196 — both lanes held by 6-frame
    monopolizers; a 1-frame deadline request displaces one (snapshot and
    retire), finishes next tick, and the victim restores and completes:
    the same preemption history and outputs as the JAX host, one masked
    program throughout."""
    hosts = _hosts(64 << 20, policy="edf", preempt="edf-displace",
                   clock=lambda: 0)
    for host, fc in zip(hosts, _models(blobs["fc_int8"])):
        rng = np.random.default_rng(3)
        frame = lambda: [rng.normal(0, 1, (1, 64)).astype(np.float32)]
        host.add_ragged_micro("fc", *fc, lanes=2, bucket_lanes=False)
        for uid in (0, 1):
            host.submit_micro("fc", uid, [frame() for _ in range(6)],
                              arrival_us=0)
        host.micro_step()
        host.submit_micro("fc", 2, [frame()], deadline_us=50, arrival_us=0)
        host.micro_step()
        res = host.micro_results["fc"]
        assert res[2].done and res[2].steps == 1
        assert res[0].preemptions + res[1].preemptions == 1
        while host.micro_step():
            pass
        assert all(r.done for r in res.values())
        assert res[0].steps == 6 and res[1].steps == 6
    jhost, host = hosts
    _same_micro(jhost, host, "fc", int8=True)
    assert capture_count(host.ragged.program("fc")) == 1
    _same_usage(jhost, host)


def test_wfq_shares_converge_to_weights(blobs):
    """tests/test_preemption.py:282 — two tenants of weights 1:3 with
    saturated queues: the delivered service converges to 1:3, exactly as
    the JAX host's; an idle tenant's share spills over."""
    services = []
    for host_cls, (model, res) in ((jax_serving.MultiTenantHost,
                                    _models(blobs["fc_int8"])[0]),
                                   (MultiTenantHost,
                                    _models(blobs["fc_int8"])[1])):
        rng = np.random.default_rng(4)
        frame = lambda: [rng.normal(0, 1, (1, 64)).astype(np.float32)]
        kw = CPU if host_cls is MultiTenantHost else {}
        wfq = (jax_serving.WFQPolicy if host_cls is not MultiTenantHost
               else WFQPolicy)
        pol = wfq(weights={"a": 1.0, "b": 3.0})
        host = host_cls(64 << 20, policy=pol, clock=lambda: 0, **kw)
        host.add_ragged_micro("fc", model, res, lanes=2, bucket_lanes=False)
        uid = 0
        for _ in range(200):
            for t in ("a", "b"):
                host.submit_micro("fc", uid, [frame()], tenant=t,
                                  arrival_us=0)
                uid += 1
        for _ in range(40):
            host.micro_step()
        a, b = pol.service["a"], pol.service["b"]
        assert a + b == pytest.approx(80)
        assert b / a == pytest.approx(3.0, rel=0.15)
        host2 = host_cls(64 << 20, policy=wfq(weights={"a": 1.0, "b": 3.0}),
                         clock=lambda: 0, **kw)
        host2.add_ragged_micro("fc", model, res, lanes=2, bucket_lanes=False)
        for i in range(6):
            host2.submit_micro("fc", i, [frame()], tenant="a", arrival_us=0)
        ticks = 0
        while host2.micro_step():
            ticks += 1
        assert ticks <= 4
        services.append((dict(pol.service), ticks))
    assert services[1] == services[0]


def test_host_refusals_and_replicas(lms):
    """``profile=`` is refused when it was measured on another device
    than the host's (here a card's profile on a CPU host), ``mesh=``
    reaches the engine, which refuses anything but a serving mesh
    (``tests/test_torch_sharded_serving.py`` serves a host on one); a
    replicated tenant is a router
    over engines sharing one weight module, each with its own KV in the
    shared arena."""
    card = CalibrationProfile(
        model_key="dense/qwen3-32b-smoke/L32", seed=0, cache_len=32,
        bucket_levels=[8, 32], prefill_chunk=0, expected_us=0.0,
        default_expected_us=0.0, max_dispatch_us=0.0, predicted_compiles=1,
        feasible=True, prompt_lengths=[5], bucket_costs=[], chunk_costs=[],
        meta={"torch": torch.__version__, "device": "cuda",
              "device_name": "NVIDIA H100 80GB HBM3"})
    with pytest.raises(ValueError, match="measured on"):
        MultiTenantHost(1 << 20, profile=card, **CPU)
    _, _, bundle, model = lms["qwen3-32b"]
    host = MultiTenantHost(256 << 20, **CPU)
    with pytest.raises(TypeError, match="make_serving_mesh"):
        host.add_model("lm", bundle, model, mesh=object())
    router = host.add_replicated_model("lm", bundle, model, replicas=2,
                                       max_slots=1, cache_len=32,
                                       overlap=True)
    assert all(e.params is model and e.overlap and e.arena is host.arena
               for e in router.replicas)
    assert len({id(e.cache["k"]) for e in router.replicas}) == 2
    for uid in range(3):
        host.submit("lm", Request(uid=uid, tokens=np.arange(
            1, 6 + uid, dtype=np.int32), max_new_tokens=3))
    out = host.run_all()["lm"]
    assert sorted(out) == [0, 1, 2] and all(r.done for r in out.values())
    with pytest.raises(ValueError, match="already exists"):
        host.add_model("lm", bundle, model)
