"""Training entry point of the port: ``python -m repro_torch.launch.train
--arch yi-6b --steps 50`` on the card, ``--device cpu`` on the CPU
(reduced widths are the default, ``--full`` the published ones).

The JAX package's ``launch/train.py``: seeded random weights, the
packed Markov data source, the captured train step (``remat`` at full
widths, one MoE group as on the host mesh), a line every 10 steps and a
JSON summary (``final_loss``, ``steps``, ``wall_s``);
``--ckpt-dir``/``--ckpt-every`` write checkpoints in the JAX package's
layout.

On a mesh, one process a rank under ``torchrun`` (NCCL on the card, a
card a rank; gloo with ``--device cpu``): ``--production-mesh`` (16, 16)
on a world of 256 ranks, ``--multi-pod`` (2, 16, 16) on 512, or
``--mesh DATA,MODEL`` on a world of DATA x MODEL; any other world size
raises ``ValueError`` naming the size the mesh needs.  Each rank holds
its slices (``shard_params(..., fsdp=True)``) and trains its share of
every step (``make_train_step(..., mesh=)``); rank 0 prints, and a
checkpoint is written whole by rank 0.  Every family trains on a mesh,
Whisper (``--arch whisper-large-v3``) too; where the heads do not divide
over ``model`` the attention splits K/V by sequence.  A ``model`` axis
the padded vocabulary does not divide raises ``ValueError`` naming it
(Whisper's 51,866 entries pad to 53,248 rows, 2^12 x 13).  For example,
on the CPU:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --device cpu --mesh 1,2
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch whisper-large-v3 --device cpu --mesh 2,2
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, list_archs
from repro_torch.core.executor import resolve_device, setup_device
from repro_torch.data import PackedLMDataset
from repro_torch.distributed.sharding import shard_params
from repro_torch.launch import mesh as meshes
from repro_torch.models import get_model
from repro_torch.training.trainer import init_train_state, make_train_step


@contextlib.contextmanager
def _world(device):
    """The ``torch.distributed`` world this process is a rank of:
    torchrun's (``RANK``/``WORLD_SIZE`` in the environment), or a world
    of one started here (NCCL on the card, gloo on the CPU) and torn down
    on the way out."""
    if dist.is_initialized():
        yield
        return
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                timeout=meshes.TIMEOUT)
    else:
        meshes._start_world(device)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(args):
    if args.production_mesh or args.multi_pod:
        return meshes.make_production_mesh(multi_pod=args.multi_pod,
                                           abstract=False)
    shape = tuple(int(n) for n in args.mesh.split(","))
    if len(shape) != 2:
        raise ValueError(f"--mesh {args.mesh}: give DATA,MODEL")
    return meshes.make_mesh(shape)


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
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL: a mesh of the torchrun world")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the card by default; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    bundle = get_model(cfg)
    on_mesh = args.production_mesh or args.multi_pod or args.mesh
    if not on_mesh and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise ValueError("a torchrun world of several ranks trains on a "
                         "mesh: pass --mesh DATA,MODEL or --production-mesh")
    device = args.device
    if on_mesh and device == "cuda" and "LOCAL_RANK" in os.environ:
        device = f"cuda:{os.environ['LOCAL_RANK']}"
    device = resolve_device(device)
    setup_device(device)
    with _world(device) if on_mesh else contextlib.nullcontext():
        mesh = _mesh(args) if on_mesh else None
        dsz = mesh.size // mesh.shape["model"] if mesh else 1
        rank0 = mesh is None or dist.get_rank() == 0
        params = bundle.init(torch.Generator(device).manual_seed(args.seed))
        if mesh is not None:
            params = shard_params(params, mesh, fsdp=True)
        state = init_train_state(params)
        ds = PackedLMDataset(cfg, args.batch, args.seq, seed=args.seed)
        step_fn = make_train_step(bundle.loss, lr=args.lr,
                                  grad_accum=args.grad_accum,
                                  remat=not args.reduced, data_shards=dsz,
                                  mesh=mesh)

        t0 = time.time()
        for i in range(args.steps):
            state, metrics = step_fn(state, ds.next_batch())
            if rank0 and (i % 10 == 0 or i == args.steps - 1):
                print(f"step {i:4d}  loss={float(metrics['loss']):.4f}  "
                      f"gnorm={float(metrics['grad_norm']):.3f}  "
                      f"({time.time() - t0:.1f}s)", flush=True)
            if args.ckpt_dir and args.ckpt_every \
                    and (i + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, i + 1, state)
        summary = {"final_loss": float(metrics["loss"]),
                   "steps": args.steps,
                   "wall_s": round(time.time() - t0, 1)}
        if rank0:
            print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
