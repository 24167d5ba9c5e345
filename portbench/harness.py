"""One run of one cell, as a dict: what ``run.py`` prints.

The cell's configuration picks its driver (``drivers/<kind>.py``), which
sets up, drives the window and returns its records with the numbers it
compared; each metric of the cell is then read from the records by its
reader (``metrics/<name>.py``).  A run with ``trace`` reports the cell's
per-layer metrics, with the device's busy and window seconds and the
trace's breakdown; a run without, its end-to-end metrics.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench import compare, trace as tr
from portbench.spec import Bench

# seconds a traced serving run profiles, after its window
TRACE_S = 4.0


def execute(bench: Bench, cell: Dict, seed: int, seconds: float,
            trace: bool, device: str, t0: float,
            trace_s: Optional[float] = None) -> Dict:
    conf = bench.config(cell["config"])
    ctx = {"bench": bench, "cell": cell, "conf": conf,
           "mix": bench.traffic(cell["traffic"]), "seed": int(seed),
           "seconds": float(seconds), "trace": bool(trace),
           "device": device, "t0": t0,
           "trace_s": (min(TRACE_S, seconds / 2) if trace_s is None
                       else trace_s)
           if torch.device(device).type == "cuda" else 0.0}
    rec = bench.driver(conf["kind"]).run(ctx)
    correct, shown = compare.judge(rec.get("numbers", {}),
                                   bench.limits(cell["name"]))
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(cell, section):
        value = bench.reader(m["name"])(rec, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": bool(correct) and rec["failed"] == 0,
           "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics, "device": info}
    data = rec.get("trace")
    if trace and data is not None:
        info["busy_s"], info["window_s"] = data.busy_s, data.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(data),
                            "idle_gaps": data.gaps[:10]}
    out["records"] = {"captures_in_window": rec.get("captures_in_window"),
                      "compared_tokens": rec.get("compared_tokens"),
                      "numbers": rec.get("numbers"),
                      "setup_s": rec.get("setup_s")}
    out["checks"] = shown
    return out
