"""Training entry point of the port: ``python -m repro_torch.launch.train
--arch yi-6b --steps 50`` on the card, ``--device cpu`` on the CPU
(reduced widths are the default, ``--full`` the published ones).

The JAX package's ``launch/train.py`` on one device: seeded random
weights, the packed Markov data source, the captured train step
(``remat`` at full widths, one MoE group as on the host mesh), a line
every 10 steps and a JSON summary (``final_loss``, ``steps``,
``wall_s``); ``--ckpt-dir``/``--ckpt-every`` write checkpoints in the
JAX package's layout.  Training on the production meshes is the second
half of ROADMAP item 15 (the port serves on a mesh, ``launch.mesh``, but
does not train on one yet): ``--production-mesh`` and ``--multi-pod``
are refused.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, list_archs
from repro_torch.core.executor import resolve_device, setup_device
from repro_torch.data import PackedLMDataset
from repro_torch.models import get_model
from repro_torch.training.trainer import (init_train_state, make_train_step,
                                          train_state_sharding)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="yi-6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the card by default; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    if args.production_mesh or args.multi_pod:
        train_state_sharding(None, "multi-pod" if args.multi_pod
                             else "production")
    cfg = get_config(args.arch, reduced=args.reduced)
    bundle = get_model(cfg)
    device = resolve_device(args.device)
    setup_device(device)
    params = bundle.init(torch.Generator(device).manual_seed(args.seed))
    state = init_train_state(params)
    ds = PackedLMDataset(cfg, args.batch, args.seq, seed=args.seed)
    step_fn = make_train_step(bundle.loss, lr=args.lr,
                              grad_accum=args.grad_accum,
                              remat=not args.reduced, data_shards=1)

    t0 = time.time()
    for i in range(args.steps):
        state, metrics = step_fn(state, ds.next_batch())
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss={float(metrics['loss']):.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.3f}  "
                  f"({time.time() - t0:.1f}s)")
        if args.ckpt_dir and args.ckpt_every \
                and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1, state)
    print(json.dumps({"final_loss": float(metrics["loss"]),
                      "steps": args.steps,
                      "wall_s": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()
