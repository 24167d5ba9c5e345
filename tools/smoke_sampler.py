#!/usr/bin/env python3
"""``chip_smoke.py`` run whole under a stack sampler: where its time goes.

    python3 tools/smoke_sampler.py        # from the repository's root

Runs ``chip_smoke.main()`` as ``python3 chip_smoke.py`` would, with a
thread that reads the main thread's stack every ``DT`` seconds, and
starts phase 26's and 27's rank processes through this script too, so
that each is sampled the same way.  Each process writes
``chiprun_out/sample_<main|rankR_TASK>.json``: its wall seconds and, in
seconds, each ``chip_smoke`` function's inclusive time (``incl``), the
innermost ``repro_torch`` function's (``leaf``), and each chain of the
three innermost ``chip_smoke`` frames (``paths``).  Phase 28 (a)'s and
(b)'s processes run unsampled.  The script's own output is
``chip_smoke.py``'s.
"""

import collections
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

DT = 0.1
HERE = os.path.abspath(__file__)


def mesh_launch(first, world, port, backend, out, task):
    """``chip_smoke.mesh_launch`` with each rank run by this script."""
    return [subprocess.Popen(
        [sys.executable, HERE, "--mesh-rank", str(r),
         "--mesh-world", str(world), "--mesh-port", str(port),
         "--mesh-backend", backend, "--mesh-out", str(out),
         "--mesh-task", task]) for r in range(first, world)]


def sample(stop, counts):
    """Until ``stop`` is set, add one to each count the main thread's
    stack shows, every ``DT`` seconds."""
    incl, leaf, paths = counts
    main_id = threading.main_thread().ident
    while not stop.wait(DT):
        frame = sys._current_frames().get(main_id)
        chain, innermost = [], None
        while frame is not None:
            code = frame.f_code
            if code.co_filename.endswith("chip_smoke.py"):
                if code.co_name not in chain:
                    incl[code.co_name] += 1
                chain.append(code.co_name)
            elif innermost is None and "repro_torch" in code.co_filename:
                innermost = (code.co_filename.split("repro_torch/")[-1]
                             + ":" + code.co_name)
            frame = frame.f_back
        if innermost:
            leaf[innermost] += 1
        if chain:
            paths[" < ".join(chain[:3])] += 1


def main() -> int:
    chip_smoke.mesh_launch = mesh_launch
    tag = "main"
    if "--mesh-rank" in sys.argv:
        opts = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        tag = f"rank{opts['--mesh-rank']}_{opts['--mesh-task']}"
    counts = tuple(collections.Counter() for _ in range(3))
    stop = threading.Event()
    thread = threading.Thread(target=sample, args=(stop, counts),
                              daemon=True)
    thread.start()
    t0 = time.perf_counter()
    rc = 1
    try:
        rc = chip_smoke.main()
    finally:
        for bg in chip_smoke.BACKGROUND:
            if bg.poll() is None:
                bg.kill()
                bg.wait()
        stop.set()
        thread.join()
        out = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"sample_{tag}.json"), "w") as f:
            json.dump({"wall": time.perf_counter() - t0, "rc": rc,
                       **{name: {k: n * DT for k, n in c.most_common(200)}
                          for name, c in zip(("incl", "leaf", "paths"),
                                             counts)}}, f, indent=0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
