#!/usr/bin/env python3
"""Times gloo's collectives between two processes on one card: its
all_reduce and list all_gather against the all-to-all exchange that
``distributed.collectives.Comm`` routes gloo's reduce-scatter and
training's gathers (``Comm.gather_blocks``) through, on a float32
tensor of ``MIB`` MiB.

    python3 tools/gloo_exchange.py [MIB]

Starts its two ranks itself (a localhost TCP rendezvous); prints the
card's name and power limit, then ms a call and the tensor's GB/s for
each collective.  Needs one CUDA card.
"""

import datetime
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

REPS = 3


def rank_main(rank: int, mib: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.collectives import Comm

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=300))
    dev = torch.device("cuda", 0)
    n = (mib << 20) // 4
    x = torch.randn(n, device=dev)
    comm = Comm(dist.group.WORLD, rank, 2)
    runs = {
        "all_reduce (gloo)": lambda: dist.all_reduce(x.clone()),
        "all_gather, list (gloo)": lambda: dist.all_gather(
            [torch.empty_like(x), torch.empty_like(x)], x),
        "all_to_all_single (gloo)": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "Comm.gather_blocks (exchange)": lambda: comm.gather_blocks(x, 0),
        "Comm.reduce_scatter (exchange)": lambda: comm.reduce_scatter(x, 0),
    }
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / REPS * 1e3
        if rank == 0:
            print(f"{name}: {ms:.1f} ms ({n * 4 / ms / 1e6:.2f} GB/s of "
                  f"the tensor)", flush=True)
    dist.destroy_process_group()


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
        return 0
    import socket

    mib = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               str(mib), str(port)]) for r in range(2)]
    rcs = [p.wait(timeout=600) for p in procs]
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
