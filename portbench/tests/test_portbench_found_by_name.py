"""A configuration, a traffic mix and a per-layer metric added as files
of their own are found by name and run, with no edit to the harness."""

import pytest

from portbench.tests.tiny import make_bench, run_cell

METRIC = '''
def read(rec, ctx):
    """The window's requests that finished: a new reader."""
    return float(sum(r["done"] for r in rec["requests"]))
'''


def test_new_config_mix_and_metric_found_by_name(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "finished.chat.py").write_text(METRIC)
    bench = make_bench(tmp_path, per_layer=[
        {"name": "finished.chat", "unit": "requests", "better": "higher",
         "source": "host_clock", "layer": "engine admission and scheduling",
         "moves": "ttft_p95_ms", "workloads": ["tiny.chat"]},
        {"name": "decode_step_ms.tiny", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "model step decode",
         "moves": "ttft_p95_ms", "workloads": ["tiny.chat"]}])
    plain = run_cell(bench, "tiny.chat")
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"ttft_p95_ms", "setup_s"}
    traced = run_cell(bench, "tiny.chat", trace=True)
    assert traced["correct"], traced["checks"]
    # the new file, and an existing reader under a new cell's suffix
    assert traced["metrics"]["finished.chat"]["value"] > 0
    assert traced["metrics"]["decode_step_ms.tiny"]["value"] > 0
    assert list(traced)[-1] == "checks"


def test_cell_without_limits_is_not_correct(tmp_path):
    bench = make_bench(tmp_path)
    (tmp_path / "checks" / "tiny.chat.json").unlink()
    assert not run_cell(bench, "tiny.chat")["correct"]


def test_a_traced_serving_run_sends_its_load_from_a_client_thread(
        tmp_path, monkeypatch):
    """The profile runs in the serving driver's thread, the load in another;
    the stretch's trace reaches the device metrics (a stand-in for the
    profiler here, which needs the card)."""
    import time

    from portbench import trace
    from portbench.trace import TraceData

    class Stand:
        def __init__(self, torch, device):
            self.calls = []

        def start(self):
            self.calls.append("start")

        def lead(self):
            self.calls.append("lead")

        def trail(self):
            self.calls.append("trail")

        def finish(self):
            self.calls.append("finish")

        def read(self):
            data = TraceData()
            data.busy_s, data.window_s = 0.25, 0.5
            return data

    monkeypatch.setattr(trace, "Traced", Stand)
    bench = make_bench(tmp_path, per_layer=[
        {"name": "device_idle_pct.tiny", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "ttft_p95_ms", "workloads": ["tiny.chat"]}])
    cell = bench.cell("tiny.chat")
    conf = bench.config(cell["config"])
    ctx = {"bench": bench, "cell": cell, "conf": conf,
           "mix": bench.traffic(cell["traffic"]), "seed": 11,
           "seconds": 1.0, "trace": True, "device": "cpu",
           "t0": time.monotonic(), "trace_s": 0.3}
    rec = bench.driver("serve").run(ctx)
    assert rec["trace"].busy_s == 0.25 and rec["failed"] == 0
    assert bench.reader("device_idle_pct.tiny")(rec, ctx) == 50.0


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.batch"])
def test_a_traced_run_pauses_its_server_only_after_the_window(
        tmp_path, monkeypatch, cell):
    """The profile starts and ends with the server's loop paused, and both
    pauses come once the window has closed and each request due in it has
    its first token; the traced stretch starts ``SETTLE_S`` after the
    first pause, under the load that goes on meanwhile."""
    import time

    from portbench import trace
    from portbench.trace import TraceData

    bench = make_bench(tmp_path)
    serve = bench.driver("serve")
    at = {}

    class Stand:
        def __init__(self, torch, device):
            pass

        def start(self):
            at["start"] = serve._now_us()

        def lead(self):
            at["lead"] = serve._now_us()

        def trail(self):
            at["trail"] = serve._now_us()

        def finish(self):
            pass

        def read(self):
            data = TraceData()
            data.busy_s, data.window_s = 0.25, 0.5
            return data

    pauses = []
    real_pause = serve.ServeSession.pause

    def pause(self):
        pauses.append(serve._now_us())
        real_pause(self)

    monkeypatch.setattr(trace, "Traced", Stand)
    monkeypatch.setattr(serve, "SETTLE_S", 0.2)
    monkeypatch.setattr(serve.ServeSession, "pause", pause)
    c = bench.cell(cell)
    ctx = {"bench": bench, "cell": c, "conf": bench.config(c["config"]),
           "mix": bench.traffic(c["traffic"]), "seed": 13,
           "seconds": 1.0, "trace": True, "device": "cpu",
           "t0": time.monotonic(), "trace_s": 0.3}
    rec = serve.run(ctx)
    assert len(pauses) == 2 and rec["failed"] == 0
    assert min(pauses) >= rec["w1_us"]
    assert at["lead"] - pauses[0] >= 0.2e6
    assert at["trail"] - at["lead"] >= 0.3e6
    firsts = [r["times"][0] for r in rec["requests"]
              if rec["w0_us"] <= r["due_us"] < rec["w1_us"]]
    assert firsts and max(firsts) <= pauses[0]
