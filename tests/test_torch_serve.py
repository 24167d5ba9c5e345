"""The port's StreamingServer (launch/serve.py) and ``--stream`` mode on
the CPU: tests/test_serve.py's six cases in the port's terms.  The server
wraps ONE overlapped engine on a loop thread: start -> submit/stream ->
shutdown, every misuse refused; streamed tokens, and the exactly-once
emission through a forced evict and through EDF displacement under the
live loop, are held to the JAX engine's synchronous tokens on the same
weights (``params_from_jax``) and prompts."""

import json
import queue

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attention import decode_attention_pallas
from repro.models import get_model as jax_get_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

from repro_torch.configs import get_config
from repro_torch.core import capture_count
from repro_torch.launch import serve
from repro_torch.launch.serve import StreamingServer
from repro_torch.models import get_model, params_from_jax
from repro_torch.serving import Request, ServingEngine

ARCH = "qwen3-32b"
CACHE_LEN = 64
N_NEW = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
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
def setup():
    """(JAX bundle, JAX params, port bundle, port model)."""
    jbundle = jax_get_model(jax_get_config(ARCH, reduced=True))
    params = jbundle.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, reduced=True)
    return jbundle, params, get_model(cfg), params_from_jax(
        jax.tree.map(np.asarray, params), cfg, device="cpu")


def _prompts(vocab, n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab - 2, int(rng.integers(6, 14)))
            .astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_tokens(setup):
    """The JAX synchronous engine's tokens for the first four prompts."""
    jbundle, params, _, _ = setup
    eng = JaxServingEngine(jbundle, params, max_slots=2,
                           cache_len=CACHE_LEN, prefill_buckets=False,
                           tags=("reference",))
    for uid, toks in enumerate(_prompts(jbundle.cfg.vocab, 4)):
        eng.submit(JaxRequest(uid=uid, tokens=toks, max_new_tokens=N_NEW))
    return {uid: r.output for uid, r in eng.run().items()}


def _engine(setup, **kw):
    _, _, bundle, model = setup
    kw.setdefault("max_slots", 2)
    return ServingEngine(bundle, model, cache_len=CACHE_LEN,
                         prefill_buckets=False, device="cpu", **kw)


def _events_by_uid(events):
    per = {}
    for ev in events:
        per.setdefault(ev.uid, []).append(ev)
    return per


def _assert_exactly_once(evs, expect_tokens, uid):
    """The callback ordering contract for one request's event list."""
    assert [e.index for e in evs] == list(range(len(evs))), uid
    assert [e.token for e in evs] == list(expect_tokens), uid
    assert [e.final for e in evs] == [False] * (len(evs) - 1) + [True], uid
    ts = [e.t_us for e in evs]
    assert ts == sorted(ts), uid


def test_server_lifecycle(setup):
    """start -> submit -> stream -> shutdown, with every misuse refused:
    double start, duplicate uid, submit after shutdown."""
    server = StreamingServer(_engine(setup, overlap=True)).start()
    assert server.running
    with pytest.raises(RuntimeError):
        server.start()
    prompt = _prompts(setup[2].cfg.vocab, 1)[0]
    uid = server.submit(prompt, max_new_tokens=N_NEW)
    with pytest.raises(ValueError):
        server.submit(prompt, max_new_tokens=N_NEW, uid=uid)
    evs = list(server.stream(uid))
    assert len(evs) == N_NEW
    _assert_exactly_once(evs, server.result(uid).output, uid)
    assert server.result(uid).done
    server.shutdown()
    assert not server.running
    with pytest.raises(RuntimeError):
        server.submit(prompt)
    server.shutdown()  # idempotent


def test_streamed_tokens_match_sync_batch(setup, jax_tokens):
    """The overlapped server streams the JAX synchronous engine's tokens
    for the same workload, its decode still one program."""
    eng = _engine(setup, overlap=True)
    server = StreamingServer(eng).start()
    uids = [server.submit(toks, max_new_tokens=N_NEW, uid=uid)
            for uid, toks in enumerate(_prompts(setup[2].cfg.vocab, 4))]
    streamed = {uid: [ev.token for ev in server.stream(uid)]
                for uid in uids}
    server.shutdown()
    assert streamed == jax_tokens
    assert capture_count(eng._decode) == capture_count(eng._argmax) == 1


def test_shutdown_unblocks_unfinished_stream(setup):
    """A consumer waiting on a request the server will never finish gets
    a RuntimeError at shutdown, not a hang."""
    server = StreamingServer(_engine(setup, overlap=True)).start()
    uid = server.submit(_prompts(setup[2].cfg.vocab, 1)[0],
                        max_new_tokens=500)
    server.shutdown()
    res = server.result(uid)
    assert res is None or not res.done
    with pytest.raises(RuntimeError, match="shut down"):
        list(server.stream(uid, timeout=5.0))


def test_stream_timeout_raises_empty(setup):
    """stream() surfaces a stalled request as queue.Empty after its
    timeout instead of blocking forever."""
    server = StreamingServer(_engine(setup, overlap=True)).start()
    with server._lock:
        server._streams[99] = queue.Queue()  # uid the engine never saw
    with pytest.raises(queue.Empty):
        next(iter(server.stream(99, timeout=0.05)))
    server.shutdown()


def test_midstream_forced_evict_no_dup_no_drop(setup, jax_tokens):
    """A request evicted and restored while its stream is live emits every
    token exactly once — no re-emission of the pre-evict prefix, no
    dropped tail — and the JAX engine's never-preempted tokens."""
    events = []
    eng = _engine(setup, overlap=True, on_token=events.append)
    for uid, toks in enumerate(_prompts(setup[2].cfg.vocab, 4)):
        eng.submit(Request(uid=uid, tokens=toks, max_new_tokens=N_NEW))
    evicted = False
    steps = 0
    while eng.step():
        steps += 1
        assert steps < 500
        if not evicted and steps >= 3:
            eng.drain()  # quiesce before checkpoint surgery
            victim = next((s for s in range(eng.max_slots)
                           if eng.active[s]), None)
            if victim is not None:
                eng._evict(victim)
                evicted = True
    assert evicted
    assert sum(r.preemptions for r in eng.results.values()) == 1
    outs = {uid: res.output for uid, res in eng.results.items()}
    assert outs == jax_tokens
    per = _events_by_uid(events)
    assert sorted(per) == sorted(outs)
    for uid, evs in per.items():
        _assert_exactly_once(evs, outs[uid], uid)
    assert capture_count(eng._decode) == 1


def test_midstream_displacement_under_live_server(setup):
    """A tight-deadline arrival displaces the lone running request
    mid-stream under the live loop: both streams see contiguous indices
    and their full budgets, and each emits its tokens of a solo run."""
    _, _, bundle, _ = setup
    p0, p1 = _prompts(bundle.cfg.vocab, 2)
    solo = {}
    for uid, p, new in ((0, p0, 10), (101, p1, 4)):
        eng = _engine(setup, max_slots=1)
        eng.submit(Request(uid=uid, tokens=p, max_new_tokens=new))
        solo[uid] = eng.run()[uid].output
    events = []
    eng = _engine(setup, overlap=True, max_slots=1, policy="edf",
                  preempt="edf-displace")
    server = StreamingServer(eng)
    fanout = eng.on_token
    eng.on_token = lambda ev: (events.append(ev), fanout(ev))
    server.start()
    uid0 = server.submit(p0, max_new_tokens=10)  # no deadline
    g0 = server.stream(uid0)
    next(g0)  # wait until uid0 is decoding mid-stream
    uid1 = server.submit(p1, max_new_tokens=4, uid=101, deadline_us=1)
    t1 = [ev.token for ev in server.stream(uid1)]
    t0_rest = [ev.token for ev in g0]
    server.shutdown()
    res0, res1 = server.result(uid0), server.result(uid1)
    assert res0.done and res1.done
    assert res0.preemptions >= 1, "displacement never fired"
    assert len(t1) == 4 and t1 == res1.output == solo[101]
    assert len(t0_rest) == 9 and res0.output == solo[0]
    per = _events_by_uid(events)
    _assert_exactly_once(per[uid0], res0.output, uid0)
    _assert_exactly_once(per[uid1], res1.output, uid1)


def test_cli_stream_mode(capsys):
    """``python -m repro_torch.launch.serve --arch yi-6b --stream --device
    cpu``: one line a request with its TTFT and mean inter-token latency,
    then the summary, overlapped with one decode and one argmax
    program."""
    serve.main(["--arch", "yi-6b", "--stream", "--device", "cpu",
                "--requests", "3", "--max-new", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "mode=stream" in lines[0]
    reqs = [ln for ln in lines if ln.strip().startswith("req ")]
    assert len(reqs) == 3 and all("ttft=" in ln and "itl_mean=" in ln
                                  for ln in reqs)
    summary = json.loads(lines[-1])
    assert summary["mode"] == "stream" and summary["overlap"] is True
    assert summary["tokens_generated"] == 12
    assert summary["captures"]["decode"] == summary["captures"]["argmax"] \
        == 1
