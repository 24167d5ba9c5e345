"""The collectives of a sharded model step, on one mesh axis.

Where GSPMD inserts a collective into the JAX package's sharded
programs, the port's per-rank model steps (``models.lm``, ``models.ssm``,
``models.encdec``, ``models.moe_ep``) call one of these explicitly, on
plain local tensors.
``Comm`` holds the raw collectives of one axis:

  * ``all_reduce`` — the sum over ranks (row-parallel projections, the
    masked embedding lookup, the MoE combine), in place;
  * ``all_gather`` — this rank's slice of a dimension to the whole one
    (the column-parallel head's logits, the queries of every head);
  * ``reduce_scatter`` — the sum over ranks, each keeping its slice;
  * ``all_to_all`` — each rank's slices of one dimension sent to their
    ranks and concatenated along another (the expert-parallel dispatch);
  * ``combine`` — flash-decoding: partial attentions over each rank's
    KV rows (serving's sequence-split cache, training's sequence split of
    K/V), with their log-sum-exp, merged into the attention over all
    rows (one ``all_reduce`` of the max, one of the rescaled sums).

All of them go through ``torch.distributed`` on the axis's group, so on
the card they are NCCL calls on the current stream, which a CUDA-graph
capture records with the rest of the step.  ``Shard`` tells a model
module how its weights lie on the ``model`` axis, ``DataShard`` on the
data axes.

Training differentiates through them.  The module functions below are
the collectives a training step calls (without gradients they are the
raw ``Comm`` calls, so serving runs exactly as before); each is an
``autograd.Function`` whose backward is the transpose of its forward
*for what runs downstream of it on the axis*:

  ============== ==================== ===================================
  function       forward              backward
  ============== ==================== ===================================
  all_reduce     partial -> whole     identity (every rank computes the
                                      same loss from the whole tensor)
  copy_in        identity             all_reduce (the whole tensor feeds
                                      rank-local work: each rank's
                                      gradient is its share; Megatron's
                                      *f*)
  all_gather     slices -> whole      this rank's slice (the whole tensor
                                      is consumed alike on every rank:
                                      the vocab-parallel head's logits)
  gather_local   slices -> whole      reduce_scatter (the whole tensor
                                      feeds rank-local work: the FSDP
                                      weight gather, the sequence-
                                      parallel gather before the
                                      projections)
  reduce_scatter partial -> slices    all_gather
  split          whole -> slice       all_gather
  all_to_all     dim a -> dim b       all_to_all dim b -> dim a
  combine        partials, lse ->     this rank's share, no collective:
                 merged               a_r g to its partial, a_r <g,
                                      o_r - y> to its lse (a_r its
                                      weight; the merged y is consumed
                                      alike on every rank)
  ============== ==================== ===================================

On the ``model`` axis every rank computes the same loss, so a reduce-
scatter is *not* the transpose of the logits' all_gather (it would give
m times the gradient); on the data axes the ranks see different rows,
so the FSDP gather's transpose is the reduce-scatter (``gather_local``).
An axis of one rank needs no collective in training: each function
returns its input there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist


class Comm:
    """One mesh axis as the model steps see it: this rank's index
    ``rank`` of ``size`` and the axis's process ``group``."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size
        # gloo stages CUDA tensors through the host for all_reduce and
        # the list form of all_gather; NCCL gathers into one tensor
        self.nccl = group is not None and dist.get_backend(group) == "nccl"

    def __repr__(self) -> str:
        return f"Comm(rank {self.rank} of {self.size})"

    def all_reduce(self, x: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The reduction of ``x`` over the axis (a sum by default),
        computed in place when ``x`` is contiguous; returns it."""
        x = x.contiguous()
        if self.group is not None:
            dist.all_reduce(x, op=op, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        x = x.contiguous()
        if self.group is None:
            return x
        if self.nccl:
            flat = x.new_empty(self.size * x.numel())
            dist.all_gather_into_tensor(flat, x.view(-1), group=self.group)
            parts = flat.view(self.size, *x.shape).unbind(0)
        else:
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def gather_blocks(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``all_gather`` for training's gathers into rank-local work (the
        FSDP weights, the sequence-parallel positions: ``gather_local``);
        over gloo through its all-to-all (``_exchange``)."""
        if self.nccl or self.group is None:
            return self.all_gather(x, dim)
        x = x.contiguous()
        got = self._exchange(x.expand(self.size, *x.shape))
        return torch.cat(got.unbind(0), dim=dim)

    def _exchange(self, blocks: torch.Tensor) -> torch.Tensor:
        """(size, ...) blocks, block r sent to rank r -> the blocks every
        rank sent this one, in rank order: one ``all_to_all_single``.
        Besides the all-to-all itself, gloo's reduce-scatter and
        training's gathers (``gather_blocks``) go through it for
        ``chip_smoke.py``'s time limit alone: its one-card phase trains
        with FSDP over gloo, two ranks on one card, where gloo's
        all-to-all moves 1.70 GB/s against 0.49 for its list all_gather
        and 0.92 for its all_reduce (``tools/gloo_exchange.py``, NVIDIA
        H100 80GB HBM3, 700 W).  Serving keeps ``all_gather``."""
        blocks = blocks.contiguous()
        got = torch.empty_like(blocks)
        dist.all_to_all_single(got, blocks, group=self.group)
        return got

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum of every rank's ``x``, this rank's block of ``size``
        equal blocks of ``dim`` (a new tensor); over gloo each rank's
        block is exchanged (``_exchange``) and summed in rank order."""
        if self.size == 1:
            return x.contiguous()
        front = x.movedim(dim, 0).contiguous()
        if self.nccl:
            out = front.new_empty((front.shape[0] // self.size,
                                   *front.shape[1:]))
            dist.reduce_scatter_tensor(out, front, group=self.group)
        else:
            got = self._exchange(front.view(self.size, -1,
                                            *front.shape[1:]))
            out = got[0]
            for part in got[1:]:
                out = out + part
        return out.movedim(0, dim).contiguous()

    def all_to_all(self, x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``x``'s ``size`` equal blocks of ``split_dim``, block r sent to
        rank r; the blocks this rank receives concatenated along
        ``concat_dim`` in rank order."""
        if self.size == 1:
            return x.contiguous()
        got = self._exchange(torch.stack(x.chunk(self.size, dim=split_dim)))
        return torch.cat(got.unbind(0), dim=concat_dim)

    def own(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``size`` equal blocks of ``dim``."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def combine(self, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """Partial attentions ``out`` (..., D), each over this rank's
        rows and normalized over them, with their float32 log-sum-exp
        ``lse`` (...) of the scaled scores (-inf where a rank holds no
        valid row, its ``out`` 0): the attention over every rank's rows,
        in ``out``'s dtype.  exp(lse_r - max) weighs each partial."""
        return self.merge(out, lse)[0].to(out.dtype)

    def merge(self, out: torch.Tensor, lse: torch.Tensor):
        """``combine``'s float32 result and this rank's weight in it,
        exp(lse_r) / sum_r exp(lse_r) (...): one ``all_reduce`` of the
        max, one of the rescaled sums."""
        top = self.all_reduce(lse.clone(), dist.ReduceOp.MAX)
        w = torch.exp(lse - top)
        packed = torch.cat([(out.float() * w[..., None]).flatten(),
                            w.flatten()])
        packed = self.all_reduce(packed)
        n = out.numel()
        num = packed[:n].view(out.shape)
        den = packed[n:].view(w.shape)
        return num / den[..., None], w / den


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """How one module's weights lie on the ``model`` axis (set on the
    module as ``tp`` by ``distributed.sharding.shard_params``).
    ``split``: they are split over the ranks — the attention's query
    heads (then ``wo`` is row-parallel), an MLP's hidden width, the
    experts, the vocabulary, a Mamba block's ``d_inner`` (its norm and
    ``out_proj``); ``kv_split``: the attention's ``wk``/``wv`` are split
    by KV heads too."""

    comm: Comm
    split: bool
    kv_split: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class DataShard:
    """How one module's own parameters lie on the data axes (set on the
    module as ``dp`` by ``shard_params(..., fsdp=True)`` when the data
    axes hold more than one rank): ``dims`` maps each parameter name to
    the dimension FSDP splits over ``comm``, or to None for a parameter
    every data rank holds whole.  ``experts``: the module is the MoE's
    expert MLP (its weights are gathered by
    ``act_sharding.gather_expert_weights``)."""

    comm: Comm
    dims: Dict[str, Optional[int]]
    experts: bool = False


# ---------------------------------------------------------------------------
# differentiable collectives (training)
# ---------------------------------------------------------------------------

def _grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, *xs):
        ctx.comm = comm
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        # one all_reduce per dtype over the flattened gradients
        out = list(gs)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, g in enumerate(gs):
            if g is not None:
                by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = ctx.comm.all_reduce(torch.cat([gs[i].reshape(-1)
                                                  for i in idx]))
            for i, part in zip(idx, flat.split([gs[i].numel()
                                                for i in idx])):
                out[i] = part.view_as(gs[i])
        return (None, *out)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.own(g, ctx.dim).contiguous(), None, None


class _GatherLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.gather_blocks(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.own(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim), None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, lse, comm):
        y, a = comm.merge(out, lse)
        ctx.save_for_backward(out, a, y)
        return y.to(out.dtype)

    @staticmethod
    def backward(ctx, g):
        # y = sum_r a_r o_r with a_r = softmax_r(lse_r): dy/do_r = a_r,
        # dy/dlse_r = a_r (o_r - y)
        out, a, y = ctx.saved_tensors
        g = g.float()
        d_out = (g * a[..., None]).to(out.dtype)
        d_lse = a * (g * (out.float() - y)).sum(-1)
        return d_out, d_lse, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_dim, concat_dim):
        ctx.comm, ctx.dims = comm, (split_dim, concat_dim)
        return comm.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return ctx.comm.all_to_all(g, concat_dim, split_dim), None, None, \
            None


def all_reduce(comm: Comm, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the axis; its gradient passes through
    unchanged (the sum is consumed alike on every rank).  Without a
    gradient, ``comm.all_reduce`` in place."""
    if not _grad(x):
        return comm.all_reduce(x)
    return x if comm.size == 1 else _AllReduce.apply(x, comm)


def copy_in(comm: Comm, *xs: torch.Tensor):
    """The tensors as they are, entering work that is this rank's own
    (its heads, experts, rows or positions): their gradients are summed
    over the axis in one ``all_reduce`` per dtype.  Returns one tensor
    for one argument, else a tuple."""
    if comm.size > 1 and _grad(*xs):
        xs = _CopyIn.apply(comm, *xs)
    return xs[0] if len(xs) == 1 else tuple(xs)


def all_gather(comm: Comm, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, consumed alike on
    every rank (its gradient: this rank's slice)."""
    if not _grad(x):
        return comm.all_gather(x, dim)
    return x if comm.size == 1 else _AllGather.apply(x, comm, dim)


def gather_local(comm: Comm, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, feeding this rank's
    own work (its gradient: the ranks' gradients summed, this rank's
    slice kept — a reduce-scatter)."""
    if comm.size == 1:
        return x
    if not _grad(x):
        return comm.gather_blocks(x, dim)
    return _GatherLocal.apply(x, comm, dim)


def reduce_scatter(comm: Comm, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum of every rank's ``x``, this rank's block of ``dim`` kept
    (its gradient: every rank's gradient gathered)."""
    if comm.size == 1:
        return x
    if not _grad(x):
        return comm.reduce_scatter(x, dim)
    return _ReduceScatter.apply(x, comm, dim)


def split(comm: Comm, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` of a tensor every rank holds whole
    (its gradient: every rank's gradient gathered)."""
    if comm.size == 1:
        return x
    if not _grad(x):
        return comm.own(x, dim)
    return _Split.apply(x, comm, dim)


def all_to_all(comm: Comm, x: torch.Tensor, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``Comm.all_to_all``; its gradient goes back the other way."""
    if comm.size == 1:
        return x
    if not _grad(x):
        return comm.all_to_all(x, split_dim, concat_dim)
    return _AllToAll.apply(x, comm, split_dim, concat_dim)


def combine(comm: Comm, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """``Comm.combine``: each rank's partial attention ``out`` over its
    block of keys and their float32 log-sum-exp ``lse`` merged into the
    attention over every rank's keys (a partial whose block is fully
    masked weighs 0).  Its gradient is this rank's share of the merged
    one's, for its partial and its lse."""
    if comm.size == 1:
        return out
    if not _grad(out, lse):
        return comm.combine(out, lse)
    return _Combine.apply(out, lse, comm)
