"""Sharded npz checkpoints in the JAX package's layout, the port's
counterpart of ``repro.checkpoint.checkpoint``.

Layout: <dir>/<step>/
  manifest.json      — flat key -> {shape, dtype, file, entry}
  shard_<i>.npz      — the leaves, a new file once one passes 1 GiB

A leaf's flat key is the JAX package's key path of the same leaf
(``.params/blocks/attn/wq``, ``.opt/.step``, ``.opt/.mu/embed``; a bare
parameter module's keys have no ``.params/``), and per-layer parameters
are stacked on a leading L dim as the JAX tree stacks them
(``models.lm.jax_layout``), so a checkpoint written by either package
restores in the other.  bfloat16 is stored as ``uint16`` with dtype
``"bfloat16"``.  A sharded tree (a state of ``shard_params``' slices on
a mesh) is written whole, in the same layout, so it restores on one
device: every rank gathers each leaf in turn and only rank 0 keeps it,
while it is written.  A checkpoint restores onto a mesh like a sharded
tree: each rank reads one leaf at a time and keeps its slices, so no
rank holds more of the state than its share and a leaf.  Restore is by
key, so leaf order does not matter and ``strict=False`` tolerates
missing leaves; it builds a new state on an explicit device.  Leaves
are written and read by ``_IO_THREADS`` threads (numpy's zip writes and
reads release the interpreter lock), at most that many shards or
leaves in flight.
"""

from __future__ import annotations

import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple, Union)

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core.executor import resolve_device
from repro_torch.models import lm
from repro_torch.models.registry import empty_model
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.trainer import TrainState

_SHARD_BYTES = 1 << 30
_IO_THREADS = 4

Tree = Union[TrainState, nn.Module]
# one leaf: its flat key, its tensors in layer order, whether the JAX leaf
# stacks them, and each tensor's spec on the mesh (None: whole)
Leaf = Tuple[str, List[torch.Tensor], bool, List[Optional[tuple]]]


def _params(tree: Tree) -> nn.Module:
    return tree.params if isinstance(tree, TrainState) else tree


def _groups(tree: Tree) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    """(key prefix, tensors by the port's parameter names) for each part
    of ``tree``: the parameters, then the moments of a TrainState."""
    if isinstance(tree, TrainState):
        yield ".params/", dict(tree.params.named_parameters())
        yield ".opt/.mu/", tree.opt.mu
        yield ".opt/.nu/", tree.opt.nu
    else:
        yield "", dict(tree.named_parameters())


def _leaves(tree: Tree) -> List[Leaf]:
    """Every leaf of ``tree`` in the JAX package's flatten order (the
    parameters, the step, mu, nu; keys sorted); a moment lies as its
    parameter, the step whole."""
    specs = getattr(_params(tree), "specs", None) or {}
    out: List[Leaf] = []
    for prefix, named in _groups(tree):
        layout = lm.jax_layout(named.items())
        lies = lm.jax_layout((n, specs.get(n)) for n in named)
        out += [(prefix + k, *layout[k], lies[k][0]) for k in sorted(layout)]
        if prefix == ".params/":
            out.append((".opt/.step", [tree.opt.step], False, [None]))
    return out


def _host(parts: Iterable[Optional[torch.Tensor]], n: int, stacked: bool
          ) -> Optional[Tuple[np.ndarray, str]]:
    """The leaf on the host, stacked on a leading L dim when ``stacked``:
    each of its ``n`` parts copied once, into its slice, as it comes
    (None, on a rank that does not keep the leaf, for every part)."""
    out = None
    for i, part in enumerate(parts):
        if part is None:
            continue
        if out is None:
            out = torch.empty(((n,) if stacked else ()) + tuple(part.shape),
                              dtype=part.dtype)
        (out[i] if stacked else out).copy_(part.detach())
    if out is None:
        return None
    if out.dtype == torch.bfloat16:
        return out.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = out.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.require(arr, requirements=["C", "W"])
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def gather_tree(tree: Tree, device="cpu") -> Tree:
    """A sharded tree's whole leaves on ``device``, on every rank (a
    collective over the mesh: every rank calls it)."""
    from repro_torch.distributed.sharding import gather_params, unshard
    params = _params(tree)
    whole = gather_params(params, device)
    if not isinstance(tree, TrainState):
        return whole

    def moments(m):
        return {n: unshard(t, params.specs[n], params.mesh).to(device)
                for n, t in m.items()}
    return TrainState(whole, AdamWState(step=tree.opt.step.to(device),
                                        mu=moments(tree.opt.mu),
                                        nu=moments(tree.opt.nu)))


def _bounded(pool: ThreadPoolExecutor, fn: Callable, items: List,
             ahead: int) -> Iterator:
    """``pool.map(fn, items)`` with at most ``ahead`` results read ahead
    of the consumer."""
    pending = []
    for item in items:
        if len(pending) >= ahead:
            yield pending.pop(0).result()
        pending.append(pool.submit(fn, item))
    for f in pending:
        yield f.result()


def save_checkpoint(ckpt_dir: str, step: int, tree: Tree) -> str:
    """Write ``tree`` (a TrainState or a parameter module) to
    ``<ckpt_dir>/<step>``; returns that directory.  A sharded tree is
    written whole by rank 0: every rank calls this and gathers each leaf
    with the others, one part at a time, and only rank 0 keeps it until
    its shard is written."""
    from repro_torch.distributed.sharding import unshard
    out = os.path.join(ckpt_dir, str(step))
    mesh = getattr(_params(tree), "mesh", None)
    write = mesh is None or dist.get_rank() == 0

    def whole(parts, specs):
        for part, spec in zip(parts, specs):
            if mesh is not None and spec is not None:
                part = unshard(part, spec, mesh)
            yield part if write else None

    if write:
        os.makedirs(out, exist_ok=True)
    manifest, shard, shard_bytes, shard_idx = {}, {}, 0, 0
    pending = []
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        def flush():
            nonlocal shard, shard_bytes, shard_idx
            if shard:
                if len(pending) >= _IO_THREADS:
                    pending.pop(0).result()
                pending.append(pool.submit(
                    np.savez, os.path.join(out, f"shard_{shard_idx}.npz"),
                    **shard))
                shard, shard_bytes = {}, 0
                shard_idx += 1

        for key, parts, stacked, specs in _leaves(tree):
            host = _host(whole(parts, specs), len(parts), stacked)
            if host is None:
                continue
            arr, dtype = host
            safe = re.sub(r"[^A-Za-z0-9_]", "__", key)
            manifest[key] = {"shape": list(arr.shape), "dtype": dtype,
                             "file": f"shard_{shard_idx}.npz", "entry": safe}
            shard[safe] = arr
            shard_bytes += arr.nbytes
            if shard_bytes >= _SHARD_BYTES:
                flush()
        flush()
        for f in pending:
            f.result()
    if write:
        with open(os.path.join(out, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
    if mesh is not None:
        dist.barrier()
    return out


def restore_checkpoint(ckpt_dir: str, step: int, like: Tree, *,
                       device="cuda", strict: bool = True) -> Tree:
    """A new tree of ``like``'s structure on ``device`` (the card by
    default) with the leaves of ``<ckpt_dir>/<step>``.  A leaf missing
    from the checkpoint raises ``KeyError`` unless ``strict=False``,
    which keeps ``like``'s value; a leaf of another shape or dtype than
    ``like``'s whole leaf raises ``ValueError``.  With a sharded ``like``
    the new tree is sharded as it is, and each rank reads the leaves one
    at a time (the next read while this one is sliced) and keeps its
    slices."""
    from repro_torch.distributed.sharding import (local_shape, shard_local,
                                                  shard_params)
    device = resolve_device(device)
    src = os.path.join(ckpt_dir, str(step))
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)

    params = _params(like)
    mesh = getattr(params, "mesh", None)
    if mesh is None:
        model = empty_model(params.cfg, device)
    else:
        model = shard_params(empty_model(params.cfg, "meta"), mesh,
                             fsdp=params.fsdp).to_empty(device=device)
    new: Tree = model
    if isinstance(like, TrainState):
        new = TrainState(model, AdamWState(
            step=torch.empty_like(like.opt.step, device=device),
            mu={n: torch.empty_like(t, device=device)
                for n, t in like.opt.mu.items()},
            nu={n: torch.empty_like(t, device=device)
                for n, t in like.opt.nu.items()}))
    sources = {leaf[0]: leaf[1] for leaf in _leaves(like)}
    targets = []
    for key, parts, stacked, specs in _leaves(new):
        if key in manifest:
            targets.append((key, parts, stacked, specs))
        elif strict:
            raise KeyError(f"checkpoint missing {key}")
        else:
            with torch.no_grad():
                for dst, old in zip(parts, sources[key]):
                    dst.copy_(old)

    def read(target):
        entry = manifest[target[0]]
        with np.load(os.path.join(src, entry["file"])) as npz:
            return npz[entry["entry"]].reshape(entry["shape"])

    # on a mesh every rank of the host reads every leaf: one at a time
    ahead = _IO_THREADS if mesh is None else 1
    with ThreadPoolExecutor(_IO_THREADS) as pool, torch.no_grad():
        for (key, parts, stacked, specs), arr in zip(
                targets, _bounded(pool, read, targets, ahead)):
            for i, (dst, spec) in enumerate(zip(parts, specs)):
                value = _from_numpy(arr[i] if stacked else arr,
                                    manifest[key]["dtype"])
                sliced = spec is not None and mesh is not None
                want = (local_shape(value.shape, spec, mesh) if sliced
                        else tuple(value.shape))
                if tuple(want) != tuple(dst.shape) or value.dtype != dst.dtype:
                    raise ValueError(
                        f"{key}: checkpoint {tuple(value.shape)} "
                        f"{value.dtype}, expected {tuple(dst.shape)} "
                        f"{dst.dtype}" + (" a rank" if sliced else ""))
                dst.copy_(shard_local(value, spec, mesh) if sliced else value)
            del arr
    return new
