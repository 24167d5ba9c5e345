"""Static cost of one step, counted op by op as it runs — the port's twin
of ``repro.launch.hlo_analysis``.

The JAX package lowers a step for the production mesh and reads its
post-SPMD HLO.  The port has no XLA and so no HLO (hence the other
name): the dry run (``launch.dryrun``) runs one rank's step itself, on
``meta`` tensors at that rank's shapes, and this module counts what each
ATen op of it would cost, under a ``TorchDispatchMode`` that stays
active through ``torch.autograd.grad`` — the backward pass and every
rematerialized recompute (``models.lm.checkpointed``) are counted as
they run.  Eager execution runs every layer, so there are no loop trip
counts to multiply (the HLO analysis's reason to exist).

  * FLOPs: the dots and convolutions only, the HLO analysis's rule —
    ``torch.utils.flop_counter``'s formulas for ``mm``, ``addmm``,
    ``bmm``, ``baddbmm``, the convolutions and scaled-dot-product
    attention;
  * bytes: each op's tensor operands plus its results, XLA's "bytes
    accessed" convention — but op by op, where XLA counts a fusion's
    operands and results once.  Nothing here fuses, so the memory term
    is an UPPER bound of the fused program's.  Views and metadata ops
    (``view``, ``reshape``, ``transpose``, ``expand``, ``slice``,
    ``select``, ``as_strided``, ``detach``, ...) cost nothing; an
    in-place write into part of a larger buffer (``index_put_``,
    ``index_copy_``, ``scatter_``, ``copy_`` into a cache slot's view)
    costs the slice read and written, not the buffer (the HLO
    analysis's dynamic-update-slice rule);
  * temporary bytes: the peak of the live bytes of the storages the
    step creates — a storage's bytes are counted when an op first
    returns it and released when it dies (``weakref.finalize`` on the
    storage), so a tensor that autograd saves stays counted until
    backward frees it; the arguments' storages are not counted.  Two
    peaks: ``temp_bytes`` leaves out the storages the step returns, as
    XLA's ``temp_size_in_bytes`` leaves out its outputs (arguments +
    outputs + temporaries bound the step's memory from above, as the
    JAX dry run's three sizes do); ``peak_temp_bytes`` counts them too
    (arguments + it is the step's own peak);
  * collectives: the result bytes and calls a ``collectives.DryComm``
    tallies while the step runs (the ops a ``DryComm`` runs to make its
    results are skipped by the FLOP and byte counts, as the HLO
    analysis counts no bytes for a collective instruction).

Everything is per DEVICE: the step is one rank's.
"""

from __future__ import annotations

import dataclasses
import weakref
from array import array
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.distributed.collectives import (COLLECTIVE_KINDS,
                                                 in_collective)

aten = torch.ops.aten

# ops that cost no bytes: views, metadata, allocation without a write
_FREE = {"view", "_unsafe_view", "reshape", "transpose", "t", "permute",
         "expand", "slice", "select", "as_strided", "detach", "alias",
         "unsqueeze", "squeeze", "unbind", "split", "split_with_sizes",
         "chunk", "narrow", "movedim", "view_as", "lift_fresh", "unfold",
         "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_reshape_alias", "diagonal", "real",
         "_local_scalar_dense", "resize_", "set_"}
# in-place ops that write part of their first operand: the values
# written (their last tensor operand) are read and written
_PART_WRITES = {"index_put_", "_index_put_impl_", "index_copy_",
                "scatter_", "scatter_add_", "scatter_reduce_",
                "index_add_", "masked_scatter_", "index_fill_"}
# in-place ops that write their first operand without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_",
               "random_", "bernoulli_", "exponential_"}


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _mutates_first(func) -> bool:
    args = func._schema.arguments
    return bool(args) and args[0].alias_info is not None \
        and args[0].alias_info.is_write


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one ATen op accesses under the module's rules."""
    name = func.overloadpacket.__name__
    if name in _FREE or getattr(func, "is_view", False):
        return 0
    ins = list(_tensors((args, kwargs)))
    if _mutates_first(func) and ins:
        rest = ins[1:]
        if name in _PART_WRITES:
            return sum(_nbytes(t) for t in rest) + (_nbytes(rest[-1])
                                                    if rest else 0)
        own = _nbytes(ins[0]) * (1 if name in _WRITE_ONLY else 2)
        return own + sum(_nbytes(t) for t in rest)
    return sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                              for t in _tensors(out))


@dataclasses.dataclass
class OpCost:
    """One step's per-device cost: ``HloCost``'s fields (``flops``,
    ``bytes_accessed``, ``collective_bytes`` and ``collective_counts`` by
    kind, ``total_collective_bytes``) plus ``peak_temp_bytes`` (the peak
    of the live bytes the step created, its results included),
    ``temp_bytes`` (that peak without the storages it returns, XLA's
    ``temp_size_in_bytes``), ``argument_bytes`` (its arguments'
    storages) and ``output_bytes`` (its results' storages that are not
    an argument's)."""
    flops: float
    bytes_accessed: float
    collective_bytes: Dict[str, float]
    collective_counts: Dict[str, float]
    peak_temp_bytes: float = 0.0
    temp_bytes: float = 0.0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _storages(tree) -> Dict[int, Any]:
    """id -> storage of every tensor reachable from ``tree`` (modules'
    parameters and buffers, dicts, lists, tuples, named tuples)."""
    found: Dict[int, Any] = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            found.setdefault(id(st), st)
        elif isinstance(x, nn.Module):
            for t in x.parameters():
                walk(t)
            for t in x.buffers():
                walk(t)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(tree)
    return found


class _Counter(TorchDispatchMode):
    def __init__(self, exclude: Dict[int, Any]):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.exclude = set(exclude)
        # id(storage) -> (serial, bytes) while it lives; every creation
        # and release in order, by serial (ids are reused, serials not)
        self.held: Dict[int, Tuple[int, int]] = {}
        self.serials = array("q")
        self.deltas = array("q")
        from torch.utils.flop_counter import flop_registry
        self.formulas = flop_registry

    def _release(self, key: int) -> None:
        serial, n = self.held.pop(key, (0, 0))
        if n:
            self.live -= n
            self.serials.append(serial)
            self.deltas.append(-n)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self.exclude or key in self.held:
                continue
            n = st.nbytes()
            serial = len(self.serials)
            self.held[key] = (serial, n)
            self.live += n
            self.serials.append(serial)
            self.deltas.append(n)
            weakref.finalize(st, self._release, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not in_collective():
            formula = self.formulas.get(func.overloadpacket)
            if formula is not None:
                self.flops += float(formula(*args, **kwargs, out_val=out))
            self.bytes += op_bytes(func, args, kwargs, out)
        self._track(out)
        return out

    def peak_without(self, keys: Iterable[int]) -> int:
        """The peak of the live bytes with the storages ``keys`` (ids of
        storages still alive) left out."""
        skip = {self.held[k][0] for k in keys if k in self.held}
        live = top = 0
        for serial, n in zip(self.serials, self.deltas):
            if serial not in skip:
                live += n
                top = max(top, live)
        return top


def analyze(fn: Callable, *args, tally: Optional[Dict] = None
            ) -> Tuple[Any, OpCost]:
    """Run ``fn(*args)`` once under the counting mode; returns (its
    result, ``OpCost``).  ``tally``: the ``DryComm`` tallies the step's
    collectives land in (a ``launch.mesh.DryMesh``'s ``.tally``); its
    increase over the run is the step's."""
    before = {k: dict(v) for k, v in tally.items()} if tally else None
    arg_storages = _storages(args)
    counter = _Counter(arg_storages)
    with counter:
        result = fn(*args)
    coll_b = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
    coll_n = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
    if tally:
        for k in COLLECTIVE_KINDS:
            coll_b[k] = tally["bytes"][k] - before["bytes"][k]
            coll_n[k] = tally["counts"][k] - before["counts"][k]
    outs = {k: st for k, st in _storages(result).items()
            if k not in arg_storages}
    cost = OpCost(
        flops=counter.flops, bytes_accessed=counter.bytes,
        collective_bytes=coll_b, collective_counts=coll_n,
        peak_temp_bytes=float(counter.peak),
        temp_bytes=float(counter.peak_without(outs)),
        argument_bytes=float(sum(st.nbytes()
                                 for st in arg_storages.values())),
        output_bytes=float(sum(st.nbytes() for st in outs.values())))
    return result, cost
