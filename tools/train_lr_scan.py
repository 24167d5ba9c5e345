#!/usr/bin/env python3
"""Learning-rate schedules for ``chip_smoke.py`` phase 25, on the card.

Trains phase 25's model (Yi-6B at full width with 8 of its 32 layers,
bfloat16, seeded weights) for 30 captured steps of 4 x 2048 tokens on the
packed Markov source (seed 0), once per schedule given, each from the
same seed-0 weights, and prints each run's losses and gradient norms
(before clipping), its first and median step and its peak device
memory.  A schedule is ``PEAK,WARMUP,FLOOR[,MAX_GRAD_NORM]``
(``cosine_schedule``'s arguments; the clip defaults to the trainer's
1.0).

Run from the root of a checkout on a machine with one card:

    python3 tools/train_lr_scan.py 3e-4,0,0.1 4e-4,0,0.3 4e-4,0,0.3,1e9
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("schedules", nargs="+",
                    help="PEAK,WARMUP,FLOOR[,MAX_GRAD_NORM]")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("train_lr_scan.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import PackedLMDataset
    from repro_torch.models import get_model
    from repro_torch.training import (cosine_schedule, init_train_state,
                                      make_train_step)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(cs.LM_ARCH),
                              n_layers=cs.TRAIN_LAYERS)
    bundle = get_model(cfg)
    ds = PackedLMDataset(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, seed=0)
    batches = [ds.next_batch() for _ in range(cs.TRAIN_STEPS)]
    for spec in args.schedules:
        peak, warmup, floor, *clip = (float(x) for x in spec.split(","))
        state = init_train_state(bundle.init(
            torch.Generator(dev).manual_seed(0)))
        step = make_train_step(
            bundle.loss, lr=cosine_schedule(peak, int(warmup),
                                            cs.TRAIN_STEPS, floor),
            max_grad_norm=clip[0] if clip else 1.0, remat=True,
            data_shards=1)
        torch.cuda.reset_peak_memory_stats()
        losses, ms, gnorms = [], [], []
        for batch in batches:
            t = time.perf_counter()
            _, m = step(state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        print(f"{spec}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (drop "
              f"{losses[0] - losses[-1]:.4f}); first step {ms[0]:.0f} ms, "
              f"median {statistics.median(ms[1:]):.1f} ms; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
              f"losses " + " ".join(f"{x:.3f}" for x in losses)
              + "; grad norms " + " ".join(f"{x:.2f}" for x in gnorms),
              flush=True)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
