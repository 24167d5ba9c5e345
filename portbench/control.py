"""The control of a cell and its faults, read on the chip at the cell's
own size: what the limits in ``checks/<cell>.json`` are set from.

    python -m portbench.control --workload <cell> --seeds a,b,c \
        --seconds <s>

For each seed, one run of the cell as ``run.py`` makes it (its own
process's set-up, a window of ``--seconds``), which also computes the
control in the program's place: for a served model the reference in
float8 products, read as the reference's gap of the token it puts first
at each served position; for training the reference trained in float8
products, and the fault of half of each batch left out.  It prints one
JSON line a seed: the program's numbers and the control's.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from portbench.spec import Bench

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    bench = Bench()
    cell = bench.cell(args.workload)
    conf = bench.config(cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = {"bench": bench, "cell": cell, "conf": conf,
               "mix": bench.traffic(cell["traffic"]), "seed": seed,
               "seconds": args.seconds, "trace": False, "device": "cuda",
               "t0": time.monotonic(), "control": True}
        rec = bench.driver(conf["kind"]).run(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": rec["numbers"],
                          "control": rec["control_numbers"],
                          "compared_tokens": rec.get("compared_tokens")}),
              flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
