"""Multi-pod dry run (the JAX package's deliverable (e)) — the port's twin
of ``repro.launch.dryrun``.

For every (architecture x input shape x production mesh) it runs the
real train, prefill or decode step and records:

  * the bytes a device holds (its arguments, outputs and peak
    temporaries, the outputs not among them as in XLA's
    ``memory_analysis``: it fits or it does not; ``peak_bytes`` is the
    peak of what the step creates, outputs included, so that arguments +
    it is the step's own peak),
  * the FLOPs and bytes a device's step costs, and its collective bytes
    (all-gather / all-reduce / reduce-scatter / all-to-all),
  * the three roofline terms and which of them dominates.

The port has no XLA: it does not compile for 256 placeholder devices.
It runs ONE rank's step — every rank's shapes are the same under the
sharding policy's even splits — on ``meta`` tensors at that rank's
shapes of the production mesh (``launch.mesh.dry_mesh``): the same
per-rank step a real world runs, the parameters ``shard_params``'
slices (FSDP over the data axes by default), the batch and the cache
this rank's blocks.  Each collective goes to a ``collectives.DryComm``,
which returns a tensor of the real result's shape and tallies its bytes;
``launch.op_analysis`` counts FLOPs, bytes and live memory op by op
while it runs, backward and rematerialized recomputes included.  Nothing
is allocated, and no JAX is needed: it runs on the CPU, or on a machine
with a card (the card is not used).

The roofline uses the NVIDIA H100 SXM's data-sheet rates
(``launch.mesh``): 989 TFLOP/s dense bf16, 3.35 TB/s of HBM3 and 450 GB/s
of NVLink each way.  A 256-card mesh spans nodes, whose links are
slower than NVLink, so ``collective_s`` is a LOWER bound; the memory
term counts every op's operands and results unfused
(``op_analysis``), an UPPER bound.

Results are JSON files under ``build/dryrun/`` (gitignored), one per
combination, a ``.err`` file with the traceback for one that fails.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k [--multi-pod] [--all] [--no-fsdp] \\
      [--grad-accum N] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.executor import disable_capture
from repro_torch.distributed.act_sharding import activation_sharding
from repro_torch.distributed.sharding import (KV_LEAVES, batch_sharding,
                                              cache_sharding, shard_params)
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     dry_mesh, make_production_mesh)
from repro_torch.launch.op_analysis import analyze
from repro_torch.launch.shapes import SHAPES, InputShape, cache_len_for, \
    input_specs
from repro_torch.models import get_model
from repro_torch.models.registry import ModelBundle, empty_model
from repro_torch.training.trainer import init_train_state, make_train_step

DEVICE = "NVIDIA H100 SXM (data sheet)"
META = torch.device("meta")


def _data_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh.data_axes)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _local_batch(cfg, mesh, specs, global_batch) -> Dict[str, torch.Tensor]:
    """This rank's rows of each batch leaf (whole where the batch does not
    divide over the data axes), as meta tensors."""
    shard = batch_sharding(cfg, mesh, specs, global_batch)
    return {k: _meta(shard[k].local_shape(v.shape), v.dtype)
            for k, v in specs.items()}


def step_flags(cfg, shape: InputShape, mesh) -> Dict[str, bool]:
    """The JAX dry run's ``activation_sharding`` decisions for one
    (arch, shape, mesh): whether the batch divides over the data axes,
    the query heads, the positions (train and prefill) and the experts
    over ``model``."""
    msz = mesh.shape.get("model", 1)
    return {"batch_divisible": shape.global_batch % _data_size(mesh) == 0,
            "heads_divisible": bool(cfg.n_heads) and cfg.n_heads % msz == 0,
            "seq_divisible": (shape.mode in ("train", "prefill")
                              and shape.seq_len % msz == 0),
            "experts_divisible": (bool(cfg.n_experts)
                                  and cfg.n_experts % msz == 0)}


def build_step(bundle: ModelBundle, shape: InputShape, mesh, *,
               fsdp: bool = True, grad_accum: int = 1
               ) -> Tuple[Callable, Tuple[Any, ...]]:
    """(fn, args) on meta tensors: one rank's step of ``shape`` on
    ``mesh`` (a ``launch.mesh.dry_mesh``, or a mesh over a real world),
    ``fn(*args)`` running it.

      * train: ``make_train_step(bundle.loss, lr=1e-4, remat=True,
        grad_accum=, data_shards=, mesh=)`` on ``shard_params`` of an
        empty model and ``init_train_state``, called uncaptured; args
        (state, the global batch), of which the step stages this rank's
        rows (``sharding.shard_batch``), as every rank of a world does;
      * prefill: the bundle's ``prefill`` at ``cache_len_for``, with the
        sliding window and ``data_shards``, on this rank's rows, inside
        ``activation_sharding`` with the JAX dry run's decisions (K/V
        split by sequence where the heads do not divide and the
        positions do; no sequence parallelism: the prefill step has no
        layer-boundary split in either package);
      * decode: the bundle's ``decode`` on ``cache_sharding``'s local
        cache (``seq_kv`` where the KV rows are split) and this rank's
        tokens and lengths.

    ``data_shards`` is the data axes' size, the MoE groups the JAX dry
    run passes."""
    cfg = bundle.cfg
    flags = step_flags(cfg, shape, mesh)
    dsz = _data_size(mesh)
    specs = input_specs(bundle, shape)
    model = shard_params(empty_model(cfg, META), mesh, fsdp=fsdp)

    if shape.mode == "train":
        state = init_train_state(model)
        step = make_train_step(bundle.loss, lr=1e-4, remat=True,
                               grad_accum=grad_accum, data_shards=dsz,
                               mesh=mesh)
        batch = {k: _meta(v.shape, v.dtype)
                 for k, v in specs["batch"].items()}

        def train_step(state, batch):
            with disable_capture():
                return step(state, batch)
        return train_step, (state, batch)

    ctx = dict(batch_divisible=flags["batch_divisible"],
               experts_divisible=flags["experts_divisible"])
    if shape.mode == "prefill":
        cl = cache_len_for(cfg, shape)
        kv_seq = not flags["heads_divisible"] and flags["seq_divisible"]
        batch = _local_batch(cfg, mesh, specs["batch"], shape.global_batch)

        def prefill_step(params, batch):
            with activation_sharding(mesh, kv_seq=kv_seq, **ctx):
                return bundle.prefill(params, batch, cache_len=cl,
                                      window=cfg.sliding_window,
                                      data_shards=dsz)
        return prefill_step, (model, batch)

    shard = cache_sharding(cfg, mesh, specs["cache"], shape.global_batch)
    cache = {k: _meta(shard[k].local_shape(v.shape), v.dtype)
             for k, v in specs["cache"].items()}
    toks = _local_batch(cfg, mesh, {"tokens": specs["tokens"],
                                    "lengths": specs["lengths"]},
                        shape.global_batch)
    seq_kv = mesh.shape.get("model", 1) > 1 and any(
        len(shard[k].spec) > 3 and shard[k].spec[3] == "model"
        for k in KV_LEAVES if k in shard)
    extra = {"seq_kv": True} if seq_kv else {}

    def serve_step(params, cache, tokens, lengths):
        with activation_sharding(mesh, **ctx):
            return bundle.decode(params, cache, tokens, lengths,
                                 window=cfg.sliding_window,
                                 data_shards=dsz, **extra)
    return serve_step, (model, cache, toks["tokens"], toks["lengths"])


def measure(bundle: ModelBundle, shape: InputShape, mesh, *,
            fsdp: bool = True, grad_accum: int = 1) -> Dict[str, Any]:
    """Build and run one rank's step of ``shape`` on ``mesh`` (a
    ``dry_mesh``) under ``op_analysis``: the JAX result dict's
    ``mode``, ``trace_s``, ``memory``, ``cost``, ``collectives`` and
    ``roofline`` (``run_one`` adds the names)."""
    cfg = bundle.cfg
    fn, args = build_step(bundle, shape, mesh, fsdp=fsdp,
                          grad_accum=grad_accum)
    t0 = time.perf_counter()
    _, cost = analyze(fn, *args, tally=mesh.tally)
    trace_s = time.perf_counter() - t0
    arg_bytes = cost.argument_bytes
    if shape.mode == "train":
        # a device holds its rows of the batch, as the sharded jit's
        # arguments are (the step is given the global batch to stage its
        # rows from)
        batch = args[1]
        local = _local_batch(cfg, mesh, batch, shape.global_batch)
        arg_bytes += sum(_bytes(v) for v in local.values()) \
            - sum(_bytes(v) for v in batch.values())
    flops_dev = float(cost.flops)
    bytes_dev = float(cost.bytes_accessed)
    coll_dev = float(cost.total_collective_bytes)
    terms = {"compute_s": flops_dev / PEAK_FLOPS_BF16,
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": coll_dev / NVLINK_BW}
    dominant = max(terms, key=terms.get)
    # MODEL_FLOPS: 6·N·D for train; 2·N·D for a forward pass (prefill);
    # 2·N_active per generated token for decode
    n_chips = mesh.size
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    model_flops = (6 if shape.mode == "train" else 2) \
        * cfg.n_active_params() * tokens
    model_flops_dev = model_flops / n_chips
    return {
        "mode": shape.mode, "n_chips": n_chips, "fsdp": fsdp,
        "grad_accum": grad_accum, "trace_s": round(trace_s, 2),
        "memory": {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(cost.output_bytes),
                   "temp_bytes": int(cost.temp_bytes),
                   "peak_bytes": int(cost.peak_temp_bytes)},
        "cost": {"flops_per_device": flops_dev,
                 "bytes_per_device": bytes_dev},
        "collectives": {"bytes": cost.collective_bytes,
                        "counts": cost.collective_counts,
                        "total_bytes_per_device": coll_dev},
        "roofline": dict(terms, dominant=dominant, device=DEVICE,
                         model_flops=model_flops,
                         model_flops_per_device=model_flops_dev,
                         useful_flops_fraction=(model_flops_dev / flops_dev
                                                if flops_dev else 0.0)),
    }


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def run_one(arch: str, shape_name: str, multi_pod: bool, *,
            fsdp: bool = True, grad_accum: int = 1,
            verbose: bool = True) -> Dict[str, Any]:
    """One combination on the production mesh ((16, 16), or (2, 16, 16)
    multi-pod): the JAX ``run_one``'s keys, ``trace_s`` in place of
    ``lower_s`` / ``compile_s`` and no ``code_bytes``."""
    mesh = dry_mesh(make_production_mesh(multi_pod=multi_pod))
    result = {"arch": arch, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16"}
    result.update(measure(get_model(get_config(arch)), SHAPES[shape_name],
                          mesh, fsdp=fsdp, grad_accum=grad_accum))
    if verbose:
        print(json.dumps(result, indent=1))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) for the chosen mesh")
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in list_archs() for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("need --arch and --shape (or --all)")
        combos = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in combos:
        tag = f"{arch}__{shape}__{'2x16x16' if args.multi_pod else '16x16'}"
        if not args.fsdp:
            tag += "__nofsdp"
        if args.grad_accum > 1:
            tag += f"__ga{args.grad_accum}"
        path = os.path.join(args.out, tag + ".json")
        try:
            res = run_one(arch, shape, args.multi_pod, fsdp=args.fsdp,
                          grad_accum=args.grad_accum, verbose=False)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            print(f"[ok] {tag}: trace={res['trace_s']}s "
                  f"dominant={res['roofline']['dominant']}", flush=True)
        except Exception as e:                          # noqa: BLE001
            failures.append((tag, repr(e)))
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())
            print(f"[FAIL] {tag}: {e!r}", flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
