#!/usr/bin/env python3
"""Some of ``chip_smoke.py``'s phases alone, for several checkouts, in one
run on the card(s): a change and its parent compared on one machine.

    python3 tools/chip_phases.py --phases 26b,27b build/parent .

Each checkout root given runs in a process of its own that imports that
checkout's ``chip_smoke.py`` and ``repro_torch`` (its kernels built from
its own sources), in the order given.  The phases:

  * ``26b`` — ``mesh_two_ranks``: phase 26 (b)'s four float32 models
    served on two ranks (NCCL a card a rank where two cards show, else
    gloo on one), each against one device's tokens;
  * ``27b`` — ``train_mesh_world(..., "perf")``: phase 27 (b)'s captured
    bf16 steps of Yi-6B (8 layers) and Whisper (8 + 8) on ``(2, 1)`` and
    ``(1, 2)`` over NCCL (two cards needed);
  * ``28`` — ``dry_runs``: phase 28, the production-mesh dry runs and
    (b) one rank's steps for real on the card;
  * ``29`` — ``attention_module``: phase 29 (a checkout that has it);
  * ``examples`` — each of ``examples/torch/*.py`` on the card (its
    default), a process each: its wall time, exit code and last lines.

Prints the card's name and power limit, each phase's own lines, and one
JSON line a root (``PHASES <root> {...}``) with each phase's rows.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("26b", "27b", "28", "29", "examples")
EXAMPLES = ("quickstart", "export_and_quantize", "serve_multitenant",
            "streaming_client", "train_small_lm")
EXAMPLE_S = 300


def run_example(root: Path, name: str) -> dict:
    """``examples/torch/<name>.py`` of ``root`` on the card, timed from
    its start to its exit; prints its wall time and last lines."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable,
                           str(root / "examples" / "torch" / f"{name}.py")],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=EXAMPLE_S)
    wall = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-4:]
    print(f"  example {name}: exit {proc.returncode}, {wall:.2f} s wall",
          flush=True)
    for line in tail:
        print(f"    {line}", flush=True)
    if proc.returncode:
        print(proc.stderr[-3000:], flush=True)
    return {"rc": proc.returncode, "wall_s": wall, "tail": tail}


def run_root(root: Path, phases) -> int:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(root))
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    _build.build_all()
    out = {}
    for name in phases:
        chip_smoke.phase(f"{root}: phase {name}")
        if name == "26b":
            rows, launches = chip_smoke.mesh_two_ranks(torch, np, dev)
            out[name] = {"rows": rows, "launches": launches}
        elif name == "27b":
            if torch.cuda.device_count() < 2:
                raise SystemExit("phase 27 (b) needs two cards")
            ranks = chip_smoke.train_mesh_world(torch, np, 2, "nccl", "perf")
            for per in zip(*ranks):
                chip_smoke.log(
                    f"  (b) {per[0]['model']}: median step "
                    + ", ".join(f"{r['median_step_ms']:.2f}" for r in per)
                    + " ms a rank; peak "
                    + ", ".join(f"{r['peak_memory_bytes'] / 1e9:.2f}"
                                for r in per)
                    + " GB a rank; NCCL device "
                    + ", ".join(f"{r['nccl_device_ms_per_step']:.2f}"
                                for r in per)
                    + " ms a step; loss "
                    + " ".join(f"{x:.3f}" for x in per[0]["losses"]))
            out[name] = {"ranks": ranks}
        elif name == "28":
            if hasattr(chip_smoke, "start_dry_mesh"):   # (a) in a process
                rows, info = chip_smoke.dry_runs(
                    torch, np, dev, chip_smoke.start_dry_mesh())
            else:
                rows, info = chip_smoke.dry_runs(torch, np, dev)
            out[name] = {"rows": rows, "info": info}
        elif name == "29":
            row, launches = chip_smoke.attention_module(torch, np, dev)
            out[name] = {"row": row, "launches": launches}
        elif name == "examples":
            out[name] = {ex: run_example(root, ex) for ex in EXAMPLES}
    print(f"PHASES {root} " + json.dumps(out, default=str), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", required=True,
                    help=f"comma-separated, of {', '.join(PHASES)}")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    if args.child:
        return run_root(Path(args.roots[0]).resolve(), phases)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--child",
                               "--phases", args.phases, root],
                              env=dict(os.environ))
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
