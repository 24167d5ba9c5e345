"""The metric readers on synthetic records: a stall inside the window
moves every end-to-end metric the wrong way, and a share of a peak or a
roofline reads 100% where the work ran exactly at its least time, and
not more."""

import copy
import json

import pytest

from portbench import work
from portbench.spec import HERE, Bench
from portbench.trace import TraceData

BENCH = Bench()


def read(name, rec, ctx):
    return BENCH.reader(name)(rec, ctx)


def conf(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def serving(stall_s=0.0, slow=False):
    """20 requests due every 0.5 s over a 10 s window, each with a first
    token 50 ms after its due time and 9 more 20 ms apart.  A stall holds
    every token due in [5 s, 5 s + stall) until its end and delays those
    after it as much; with ``slow`` the loop stalls 80 ms before each
    token instead (a p95 moves only when over 5% of its samples do)."""
    reqs = []
    for i in range(20):
        due = int(i * 0.5e6)
        gap = 100_000 if slow and due >= 5_000_000 else 20_000
        times = [due + 50_000 + gap * k for k in range(10)]
        if stall_s:
            s0, s1 = 5_000_000, 5_000_000 + int(stall_s * 1e6)
            times = [t if t < s0 else t + (s1 - s0) for t in times]
        reqs.append({"uid": i, "due_us": due, "prompt": [1] * 100,
                     "times": times, "tokens": [0] * 10, "done": True,
                     "prefill_s": 0.01, "first_token_us": times[0]})
    return {"w0_us": 0, "w1_us": 10_000_000, "end_us": 20_000_000,
            "requests": reqs}


def ctx(loop="open", name="yi6b", **mix):
    return {"conf": conf(name), "mix": dict(loop=loop, **mix)}


@pytest.mark.parametrize("metric,worse,stall", [
    ("ttft_p95_ms", 1, {"stall_s": 2.0}), ("itl_p95_ms", 1, {"slow": True}),
    ("tokens_per_s", -1, {"stall_s": 2.0}),
    ("tokens_per_s", -1, {"slow": True}),
    ("queue_wait_p50_ms", 1, {"stall_s": 2.0})])
def test_a_stall_in_the_window_moves_the_metric(metric, worse, stall):
    c = ctx()
    base = read(metric, serving(), c)
    stalled = read(metric, serving(**stall), c)
    assert (stalled - base) * worse > 0, (base, stalled)


def test_a_stall_slows_training():
    c = ctx("train", "yi6b_pp2", batch=2, seq=4096)
    rec = {"steps": 10, "tokens": 10 * 8192, "w0": 0.0, "w1": 20.0}
    base = read("train_tokens_per_s", rec, c)
    stalled = read("train_tokens_per_s", dict(rec, w1=22.0), c)
    assert stalled < base
    assert read("train_mfu", rec, c) > read("train_mfu", dict(rec, w1=22.0),
                                            c)


def test_train_mfu_reads_100_at_the_peak():
    c = ctx("train", "yi6b_pp2", batch=2, seq=4096)
    flops, _ = work.train_step(c["conf"], 2, 4096)
    rec = {"steps": 7, "tokens": 7 * 8192, "w0": 1.0,
           "w1": 1.0 + 7 * flops / work.PEAK_BF16_FLOPS}
    assert read("train_mfu", rec, c) == pytest.approx(100.0)


@pytest.mark.parametrize("name", ["yi6b", "dsmoe16b"])
def test_serve_mfu_reads_100_at_the_least_time(name):
    """8 sequences decoded together, one token each a step, the steps
    back to back at their least time: the window is all least time."""
    c = ctx(name=name)
    t, spans, reqs = 0.0, [], []
    for k in range(50):
        step = work.least_s(*work.decode_step(c["conf"], 8,
                                              8 * (100 + k)))
        spans.append((int(t * 1e9), step, 8))
        t += step
    for i in range(8):
        times = [int(s[0] / 1e3) for s in spans]
        reqs.append({"uid": i, "due_us": 0, "prompt": [1] * 100,
                     "times": times, "done": True})
    rec = {"w0_us": 0, "w1_us": int(t * 1e6) + 1, "requests": reqs,
           "decode_spans": spans, "prefill_spans": [], "submitted": []}
    share = read("serve_mfu.chat", rec, c)
    assert 99.9 < share <= 100.0 + 1e-6
    assert read("decode_step_ms.chat", rec, c) == pytest.approx(
        1e3 * t / 50)


def test_k4_roofline_and_idle_from_a_trace():
    c = ctx()
    data = TraceData()
    data.host_window = (0, 10 ** 9)
    reqs = [{"uid": 0, "prompt": [1] * 300, "times": [10, 20, 30]}]
    need = sum(work.k4_bytes(c["conf"], 1, 300 + i) for i in range(3))
    data.by_kernel["paged_decode_attention"] = need / work.PEAK_BYTES_PER_S
    rec = {"requests": reqs, "trace": data}
    assert read("k4_roofline.chat", rec, c) == pytest.approx(100.0)
    slower = copy.deepcopy(data)
    slower.by_kernel["paged_decode_attention"] *= 2
    assert read("k4_roofline.chat", dict(rec, trace=slower), c) == \
        pytest.approx(50.0)
    data.busy_s, data.window_s = 3.0, 4.0
    assert read("device_idle_pct.chat", rec, c) == pytest.approx(25.0)
    assert read("k4_roofline.chat", dict(rec, trace=None), c) is None
    assert read("device_idle_pct.chat", dict(rec, trace=None), c) is None
