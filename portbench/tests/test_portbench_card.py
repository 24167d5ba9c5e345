"""On the card only: a traced run of a tiny cell reads its trace (the
device's busy and window seconds, the breakdown, the idle share)."""

import pytest
import torch

from portbench.harness import execute
from portbench.tests.tiny import make_bench


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_traced_tiny_cell_on_the_card(card, tmp_path):
    bench = make_bench(tmp_path, per_layer=[
        {"name": "device_idle_pct.tiny", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device", "moves": "ttft_p95_ms",
         "workloads": ["tiny.chat"]}])
    out = execute(bench, bench.cell("tiny.chat"), 5, 4.0, True, "cuda", 0.0,
                  trace_s=1.0)
    dev = out["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert 0 <= out["metrics"]["device_idle_pct.tiny"]["value"] < 100
    assert out["breakdown"]["device_ops"]
