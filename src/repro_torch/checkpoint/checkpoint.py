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
``"bfloat16"``.  Restore is by key, so leaf order does not matter and
``strict=False`` tolerates missing leaves; it builds a new state on an
explicit device.  Shards are written and read by ``_IO_THREADS``
threads (numpy's zip writes and reads release the interpreter lock), at
most that many shards in flight.
"""

from __future__ import annotations

import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.core.executor import resolve_device
from repro_torch.models import lm
from repro_torch.models.registry import empty_model
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.trainer import TrainState

_SHARD_BYTES = 1 << 30
_IO_THREADS = 4

Tree = Union[TrainState, nn.Module]


def _groups(tree: Tree) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    """(key prefix, tensors by the port's parameter names) for each part
    of ``tree``: the parameters, then the moments of a TrainState."""
    if isinstance(tree, TrainState):
        yield ".params/", dict(tree.params.named_parameters())
        yield ".opt/.mu/", tree.opt.mu
        yield ".opt/.nu/", tree.opt.nu
    else:
        yield "", dict(tree.named_parameters())


def _leaves(tree: Tree) -> List[Tuple[str, List[torch.Tensor], bool]]:
    """(flat key, tensors in layer order, stacked?) for every leaf, in
    the JAX package's flatten order (the parameters, the step, mu, nu;
    keys sorted)."""
    out = []
    for prefix, named in _groups(tree):
        layout = lm.jax_layout(named.items())
        out += [(prefix + k, *layout[k]) for k in sorted(layout)]
        if prefix == ".params/":
            out.append((".opt/.step", [tree.opt.step], False))
    return out


def _to_numpy(parts: List[torch.Tensor], stacked: bool
              ) -> Tuple[np.ndarray, str]:
    """The leaf on the host, stacked on a leading L dim when ``stacked``:
    each part copied once, into its slice."""
    first = parts[0]
    out = torch.empty(((len(parts),) if stacked else ()) + tuple(first.shape),
                      dtype=first.dtype)
    for i, part in enumerate(parts):
        (out[i] if stacked else out).copy_(part.detach())
    if out.dtype == torch.bfloat16:
        return out.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = out.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.require(arr, requirements=["C", "W"])
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(ckpt_dir: str, step: int, tree: Tree) -> str:
    """Write ``tree`` (a TrainState or a parameter module) to
    ``<ckpt_dir>/<step>``; returns that directory."""
    out = os.path.join(ckpt_dir, str(step))
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

        for key, parts, stacked in _leaves(tree):
            arr, dtype = _to_numpy(parts, stacked)
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
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return out


def restore_checkpoint(ckpt_dir: str, step: int, like: Tree, *,
                       device="cuda", strict: bool = True) -> Tree:
    """A new tree of ``like``'s structure on ``device`` (the card by
    default) with the leaves of ``<ckpt_dir>/<step>``.  A leaf missing
    from the checkpoint raises ``KeyError`` unless ``strict=False``,
    which keeps ``like``'s value; a leaf of another shape or dtype than
    ``like``'s raises ``ValueError``."""
    device = resolve_device(device)
    src = os.path.join(ckpt_dir, str(step))
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)

    params = like.params if isinstance(like, TrainState) else like
    model = empty_model(params.cfg, device)
    new: Tree = model
    if isinstance(like, TrainState):
        new = TrainState(model, AdamWState(
            step=torch.empty_like(like.opt.step, device=device),
            mu={n: torch.empty_like(t, device=device)
                for n, t in like.opt.mu.items()},
            nu={n: torch.empty_like(t, device=device)
                for n, t in like.opt.nu.items()}))
    sources = {k: parts for k, parts, _ in _leaves(like)}
    targets = {}
    for key, parts, stacked in _leaves(new):
        if key in manifest:
            targets.setdefault(manifest[key]["file"], []).append(
                (key, parts, stacked))
        elif strict:
            raise KeyError(f"checkpoint missing {key}")
        else:
            with torch.no_grad():
                for dst, old in zip(parts, sources[key]):
                    dst.copy_(old)

    def read(fn):
        with np.load(os.path.join(src, fn)) as npz:
            return {key: npz[manifest[key]["entry"]].reshape(
                manifest[key]["shape"]) for key, _, _ in targets[fn]}

    with ThreadPoolExecutor(_IO_THREADS) as pool, torch.no_grad():
        for fn, arrays in zip(targets, pool.map(read, targets)):
            for key, parts, stacked in targets[fn]:
                arr = arrays.pop(key)
                for i, dst in enumerate(parts):
                    value = _from_numpy(arr[i] if stacked else arr,
                                        manifest[key]["dtype"])
                    if (tuple(value.shape) != tuple(dst.shape)
                            or value.dtype != dst.dtype):
                        raise ValueError(
                            f"{key}: checkpoint {tuple(value.shape)} "
                            f"{value.dtype}, expected {tuple(dst.shape)} "
                            f"{dst.dtype}")
                    dst.copy_(value)
    return new
