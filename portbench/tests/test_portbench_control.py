"""The control, kept at a size a test run holds: the reference in float8
products in the program's place comes out not correct where the program
(float32 on the CPU here) is, on the cells' numbers; ``control.py`` reads
the same on the card at each cell's own size."""

import time

import pytest

from portbench import compare
from portbench.tests.tiny import LIMITS, make_bench


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.batch", "tiny.train"])
def test_the_control_fails_where_the_program_passes(tmp_path, cell):
    bench = make_bench(tmp_path)
    c = bench.cell(cell)
    conf = bench.config(c["config"])
    ctx = {"bench": bench, "cell": c, "conf": conf,
           "mix": bench.traffic(c["traffic"]), "seed": 2 ** 31 + 99,
           "seconds": 1.0, "trace": False, "device": "cpu",
           "t0": time.monotonic(), "control": True}
    rec = bench.driver(conf["kind"]).run(ctx)
    ok, _ = compare.judge(rec["numbers"], LIMITS[cell])
    assert ok
    bad, shown = compare.judge(rec["control_numbers"]["fp8"], LIMITS[cell])
    assert not bad, shown
    if "half_batch" in rec["control_numbers"]:
        assert not compare.judge(rec["control_numbers"]["half_batch"],
                                 LIMITS[cell])[0]
