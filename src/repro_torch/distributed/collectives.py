"""The collectives of a sharded model step, on one mesh axis.

Where GSPMD inserts a collective into the JAX package's sharded
programs, the port's per-rank model steps (``models.lm``, ``models.ssm``)
call one of these explicitly, on plain local tensors:

  * ``all_reduce`` — the sum over ranks (row-parallel projections, the
    masked embedding lookup, the MoE combine), in place;
  * ``all_gather`` — this rank's slice of a dimension to the whole one
    (the column-parallel head's logits, the queries of every head);
  * ``combine`` — flash-decoding: partial attentions over each rank's
    KV rows, with their log-sum-exp, merged into the attention over all
    rows (one ``all_reduce`` of the max, one of the rescaled sums).

All of them go through ``torch.distributed`` on the axis's group, so on
the card they are NCCL calls on the current stream, which a CUDA-graph
capture records with the rest of the step.  ``Shard`` tells a model
module how its weights lie on the axis.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


class Comm:
    """One mesh axis as the model steps see it: this rank's index
    ``rank`` of ``size`` and the axis's process ``group``."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size
        # gloo stages CUDA tensors through the host for all_reduce and
        # the list form of all_gather; NCCL gathers into one tensor
        self.nccl = dist.get_backend(group) == "nccl"

    def __repr__(self) -> str:
        return f"Comm(rank {self.rank} of {self.size})"

    def all_reduce(self, x: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The reduction of ``x`` over the axis (a sum by default),
        computed in place when ``x`` is contiguous; returns it."""
        x = x.contiguous()
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        x = x.contiguous()
        if self.nccl:
            flat = x.new_empty(self.size * x.numel())
            dist.all_gather_into_tensor(flat, x.view(-1), group=self.group)
            parts = flat.view(self.size, *x.shape).unbind(0)
        else:
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

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
        top = self.all_reduce(lse.clone(), dist.ReduceOp.MAX)
        w = torch.exp(lse - top)
        packed = torch.cat([(out.float() * w[..., None]).flatten(),
                            w.flatten()])
        packed = self.all_reduce(packed)
        n = out.numel()
        num = packed[:n].view(out.shape)
        den = packed[n:].view(w.shape)
        return (num / den[..., None]).to(out.dtype)


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
