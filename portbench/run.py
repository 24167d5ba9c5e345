"""Run one cell of the benchmark once:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It needs the cards the cell asks for and
never runs on the CPU.  The last line of standard output is the run's
JSON result; the numbers compared for ``correct`` are the last lines of
standard error too.  Build and kernel caches stay under ``build/`` in
the checkout.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names the process may not hold once the window has
# closed: JAX and the JAX package (the port, repro_torch, is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a run must end within 360 s: past this, every thread's stack goes to
# standard error and the process exits with an error
WATCHDOG_S = 330


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _environment() -> None:
    """The program and its caches: ``src`` on the path; every build
    cache at a fixed directory inside the checkout (the port's own
    kernels build into ``build/repro_torch_kernels``)."""
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    _environment()
    import torch

    from portbench.harness import execute
    from portbench.spec import Bench

    bench = Bench()
    cell = bench.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), this machine has {have}", file=sys.stderr)
        return 2
    result = execute(bench, cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found} after the window",
              file=sys.stderr)
        return 3
    records = result.pop("records")
    print(f"records: {json.dumps(records)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
