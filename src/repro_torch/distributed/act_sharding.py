"""Activation sharding: the schedule of a sharded train step — the port's
counterpart of ``repro.distributed.act_sharding``, with its names.

In the JAX package these functions are ``with_sharding_constraint``
hints that steer GSPMD, active only inside ``activation_sharding(mesh,
...)``.  The port has no partitioner: a rank runs the model steps on its
own slices, so the same context says where the per-rank step gathers and
scatters (``distributed.collectives``, each collective differentiable),
and without a context every function here is the identity, as there:

  * the batch rows lie over the data axes: the train step stages this
    rank's rows (``sharding.shard_batch``), so the rows every activation
    carries are its own and ``shard_act`` / ``shard_group`` hold by
    construction; the loss's sums meet over the data axes
    (``models.common.cross_entropy_loss``);
  * ``gathered`` — a layer's FSDP-sharded weights gathered over the data
    axes just before use (a reduce-scatter of their gradients in
    backward), a weight every data rank holds whole entering through the
    copy-in (its gradient summed over the data ranks);
    ``gather_expert_weights`` is that gather for the experts' (E, D, F)
    weights;
  * ``shard_seq`` (``seq_divisible``) — sequence parallelism: the
    layer-boundary activations (B, S/m, D) hold this rank's positions on
    ``model``; ``enter`` all-gathers them before a layer's projections
    and ``leave`` reduce-scatters after them, in place of the row-parallel
    all_reduce; ``unshard_seq`` gathers the last layer's output for the
    head;
  * ``enter`` / ``leave`` without sequence parallelism — Megatron's
    tensor parallelism: the copy-in before the column-parallel
    projections, the all_reduce after the row-parallel one; a region
    whose weights the policy replicates over ``model`` (attention whose
    heads do not divide) runs whole on every rank;
  * ``shard_heads``, ``shard_logits``, ``shard_expert`` — the column-
    parallel projections, the vocab-parallel head and the experts split
    over ``model`` already give a rank its heads, vocabulary block and
    experts (``distributed.sharding.shard_params``), so these hold by
    construction; whether attention is split by heads and whether the
    head is vocab-parallel is the sharding policy's choice (``tp.split``),
    not the context's, so the context takes no ``heads_divisible`` or
    ``logit_axis``;
  * ``shard_kv`` (``kv_seq``) — where the heads do not divide over
    ``model`` (the policy replicates attention there) and the attended
    positions do, K/V (B, S, KH, dh) are split by sequence: a rank holds
    its block of S/m positions (their gradients gathered in backward),
    attends every query over it at the block's absolute positions (the
    causal mask, the window and a vision prefix are the whole
    attention's) and keeps the log-sum-exp; the ranks' partials merge
    through ``collectives.combine``, whose backward gives each partial
    its share.  The queries, whole on every rank, feed every rank's
    partial, so they take the copy-in (``kv_query``).  A rank holds a
    1/m block of the logits and does 1/m of the attention's work;
    ``models.lm.chunked_attention`` runs it, for every family whose
    training reaches it (Whisper's decoder too; its encoder's 1,500
    frames and the cross-attention run whole).

This module imports nothing of ``repro_torch.models`` (no cycles).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch
from torch import nn

from . import collectives as C

_STATE = threading.local()


def current() -> Optional["ActivationCtx"]:
    """The innermost active context of this thread, or None."""
    return getattr(_STATE, "ctx", None)


class ActivationCtx:
    """One sharded step's decisions on ``mesh`` that the model steps read
    — whether the batch rows divide over the data axes (the EP dispatch's
    groups), whether the layers run under sequence parallelism, whether
    the experts divide over ``model``, whether attention splits K/V by
    sequence (``kv_seq``) — and the ``Comm``s it meets: ``model``, and
    ``data`` over the data axes together (None when they hold one
    rank)."""

    def __init__(self, mesh, *, batch_divisible: bool,
                 seq_divisible: bool = False,
                 experts_divisible: bool = False, kv_seq: bool = False):
        self.mesh = mesh
        self.batch_divisible = batch_divisible
        has_model = "model" in mesh.axis_names
        self.seq_divisible = seq_divisible and has_model
        self.experts_divisible = experts_divisible and has_model
        self.kv_seq = kv_seq and has_model and mesh.shape["model"] > 1
        self.model = mesh.comm("model")
        data = mesh.comm(mesh.data_axes)
        self.data = data if data.size > 1 else None

    @property
    def data_size(self) -> int:
        return self.data.size if self.data is not None else 1


@contextlib.contextmanager
def activation_sharding(mesh, *, batch_divisible: bool,
                        seq_divisible: bool = False,
                        experts_divisible: bool = False,
                        kv_seq: bool = False):
    """Run the model steps inside as this rank's share of a step on
    ``mesh``; yields the ``ActivationCtx``."""
    prev = current()
    _STATE.ctx = ActivationCtx(mesh, batch_divisible=batch_divisible,
                               seq_divisible=seq_divisible,
                               experts_divisible=experts_divisible,
                               kv_seq=kv_seq)
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


@contextlib.contextmanager
def using(ctx: Optional[ActivationCtx]):
    """Make ``ctx`` (an ``ActivationCtx`` or None) this thread's context
    inside the block: a rematerialized region's recompute runs where
    backward runs — on the card, autograd's own thread — and must see
    the context its forward saw (``models.lm.checkpointed``)."""
    prev = current()
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev


# ---------------------------------------------------------------------------
# the JAX names
# ---------------------------------------------------------------------------

def shard_act(x, *trailing):
    """A (B, ...) activation with the batch on the data axes: this rank's
    rows already (the step stages them), so ``x`` itself."""
    return x


def shard_logits(x):
    """(B, S, V) logits with V on ``model``: the vocab-parallel head's
    output is this rank's vocabulary block already, so ``x`` itself
    (the loss runs on the blocks, ``lm.masked_ce``)."""
    return x


def shard_seq(x):
    """Sequence parallelism: a (B, S, D) activation every rank holds
    whole -> this rank's block of the positions (S/m) on ``model``
    (gradient: the blocks' gradients gathered).  Identity without a
    context or when the sequence does not divide (``seq_divisible``)."""
    ctx = current()
    if ctx is None or not ctx.seq_divisible:
        return x
    return C.split(ctx.model, x, 1)


def unshard_seq(x):
    """``shard_seq``'s inverse at the end of the layers: every rank's
    positions gathered, consumed alike by the head on every rank."""
    ctx = current()
    if ctx is None or not ctx.seq_divisible:
        return x
    return C.all_gather(ctx.model, x, 1)


def shard_expert(x):
    """An expert-parallel (G, E, C, ...) tensor with the experts on
    ``model``: a rank's experts are its own (``shard_params`` splits their
    weights, and the dispatch keeps their slots), so ``x`` itself."""
    return x


def gather_expert_weights(w, dim: int, dp: Optional[C.DataShard] = None):
    """An expert weight (E/m, D, F) or (E/m, F, D) with its FSDP-sharded
    d_model dimension ``dim`` gathered over the data axes (``dp``'s
    ``comm``) before the expert matmuls — the weight gather, not a
    partial sum of activations; its gradient is reduce-scattered.
    Identity without a context or a data split."""
    if current() is None or dp is None:
        return w
    return C.gather_local(dp.comm, w, dim)


def shard_group(x):
    """A (G, T, ...) grouped-token tensor with the groups on the data
    axes: a data rank holds its own groups, so ``x`` itself."""
    return x


def shard_heads(x, head_axis_index: int = 2):
    """An attention activation with its heads on ``model``: the column-
    parallel projections give a rank its heads already, so ``x``
    itself."""
    return x


def kv_split() -> Optional[C.Comm]:
    """The ``model`` axis's ``Comm`` where attention splits K/V by
    sequence (the context's ``kv_seq``), else None."""
    ctx = current()
    return ctx.model if ctx is not None and ctx.kv_seq else None


def shard_kv(x):
    """K/V (B, S, KH, dh) inside attention: heads on ``model`` where they
    divide (a rank's own already, as ``shard_heads``); where they do not
    and the context splits K/V by sequence (``kv_seq``), this rank's
    block of the S positions (gradient: the blocks' gradients gathered);
    else ``x`` itself."""
    comm = kv_split()
    if comm is None:
        return x
    if x.shape[1] % comm.size:
        raise ValueError(f"K/V of {x.shape[1]} positions do not split "
                         f"over model={comm.size}")
    return C.split(comm, x, 1)


def kv_query(q):
    """The queries of attention whose K/V are split by sequence: whole on
    every rank and feeding every rank's partial, so they take the
    copy-in (their gradient summed over ``model``); ``q`` itself when
    K/V are not split."""
    comm = kv_split()
    return q if comm is None else C.copy_in(comm, q)


# ---------------------------------------------------------------------------
# the schedule the port adds: regions, boundary weights, FSDP views
# ---------------------------------------------------------------------------

def enter(x: torch.Tensor, tp) -> torch.Tensor:
    """A layer-boundary activation (B, S, D) -> the input of a region
    whose weights lie as ``tp`` (a ``collectives.Shard``; None: whole on
    this rank).  Under sequence parallelism the positions are gathered —
    feeding this rank's heads or hidden block (reduce-scatter in
    backward), or a region that runs whole on every rank (its slice in
    backward); otherwise a split region takes the copy-in."""
    if tp is None:
        return x
    ctx = current()
    if ctx is not None and ctx.seq_divisible:
        gather = C.gather_local if tp.split else C.all_gather
        return gather(ctx.model, x, 1)
    return C.copy_in(tp.comm, x) if tp.split else x


def leave(y: torch.Tensor, tp) -> torch.Tensor:
    """A region's output -> the layer boundary: the row-parallel partial
    sums all-reduced (reduce-scattered to this rank's positions under
    sequence parallelism); a whole region's output as it is (this rank's
    positions of it under sequence parallelism)."""
    if tp is None:
        return y
    ctx = current()
    if ctx is not None and ctx.seq_divisible:
        scatter = C.reduce_scatter if tp.split else C.split
        return scatter(ctx.model, y, 1)
    return C.all_reduce(tp.comm, y) if tp.split else y


def seq_param(w: torch.Tensor) -> torch.Tensor:
    """A weight applied at the layer boundary (a norm's gain): under
    sequence parallelism each rank applies it to its own positions, so
    it takes the copy-in on ``model``."""
    ctx = current()
    if ctx is None or not ctx.seq_divisible:
        return w
    return C.copy_in(ctx.model, w)


class _Gathered:
    """A module's parameters as this rank's step uses them (``gathered``):
    FSDP-sharded ones gathered over the data axes, whole ones through
    the copy-in, each once per view; submodules are views too, and every
    other attribute (``tp``, ``cfg``) is the module's."""

    __slots__ = ("_mod", "_memo")

    def __init__(self, mod: nn.Module):
        object.__setattr__(self, "_mod", mod)
        object.__setattr__(self, "_memo", {})

    def __getattr__(self, name):
        memo: Dict[str, object] = self._memo
        if name in memo:
            return memo[name]
        mod = self._mod
        value = getattr(mod, name)
        if isinstance(value, nn.Module):
            value = _Gathered(value)
        elif name in mod._parameters:
            dp = getattr(mod, "dp", None)
            dim = dp.dims.get(name) if dp is not None else None
            if dp is None:
                pass
            elif dim is None:
                value = C.copy_in(dp.comm, value)
            elif dp.experts:
                value = gather_expert_weights(value, dim, dp)
            else:
                value = C.gather_local(dp.comm, value, dim)
        memo[name] = value
        return value


def gathered(mod: nn.Module):
    """``mod`` as this rank's step uses it inside a context whose data
    axes hold more than one rank (``_Gathered``); ``mod`` itself
    otherwise.  Take the view inside a rematerialized region, so that
    backward gathers again instead of keeping the whole weights."""
    ctx = current()
    if ctx is None or ctx.data is None:
        return mod
    return _Gathered(mod)
