#!/usr/bin/env python3
"""K8 (``ssd_scan``) of several checkouts on ``chip_smoke.py``'s phase-2
shapes, timed in one run on the card.

Each checkout root given is timed in a process of its own that imports
that checkout's ``repro_torch`` (so its kernel is built from its own
sources), in the order given, so that two versions are compared on one
card within one call, e.g. a parent unpacked under ``build/``:

    python3 tools/ssd_scan_compare.py build/parent . . build/parent

Every shape of ``chip_smoke.K8_CASES`` is checked against the root's
plain version (``ssd_scan_ref``) within phase 2's tolerances
and timed by CUDA-graph replay (``chip_smoke.time_ms``).  Prints the
card's name and power limit, one line per root run, then each shape's
time per root, the mean of that root's runs.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_one(root: Path) -> int:
    """Time every case with ``root``'s kernel; print one JSON line."""
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    dev = torch.device("cuda")
    times = []
    for i, case in enumerate(chip_smoke.K8_CASES):
        x, dt, a, bm, cm, dd, st = chip_smoke.k8_inputs(torch, np, dev, i)
        chunk = ops._pick_block(x.shape[1])
        y, state = ssd_scan_cuda(x, dt, a, bm, cm, dd, chunk=chunk, h0=st)
        want_y, want_s = ref.ssd_scan_ref(x, dt, a, bm, cm, dd, chunk=chunk,
                                          h0=st)
        rtol = chip_smoke.SSD_RTOL if x.dtype == torch.float32 else 2.0 ** -7
        atol = chip_smoke.SSD_ATOL
        if not (torch.allclose(y.float(), want_y.float(), atol=atol,
                               rtol=rtol)
                and torch.allclose(state, want_s, atol=atol,
                                   rtol=chip_smoke.SSD_RTOL)):
            raise AssertionError(f"{root}: K8 case {case} disagrees with "
                                 f"the plain version")
        ms, _ = chip_smoke.time_ms(torch, lambda: ssd_scan_cuda(
            x, dt, a, bm, cm, dd, chunk=chunk, h0=st))
        times.append(ms)
    print(json.dumps({"root": str(root), "ms": times}), flush=True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        return run_one(Path(argv[1]).resolve())
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    runs = {}
    for root in argv:
        out = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True, check=True)
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs.setdefault(root, []).append(line["ms"])
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    for i, case in enumerate(chip_smoke.K8_CASES):
        print(f"{case}: " + ", ".join(
            f"{root} {sum(r[i] for r in rs) / len(rs) * 1e3:.2f} us"
            for root, rs in runs.items()))
    print("(µs a call, CUDA-graph replay, mean of each root's runs)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
