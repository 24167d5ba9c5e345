"""Expert-parallel MoE with an explicit all-to-all each way — the port's
counterpart of ``repro.models.moe_ep``.

The JAX package states the schedule with ``shard_map``; the port's
per-rank step runs it on its own tokens (a block of the batch rows on
the data axes, a block of the positions on ``model``):

  tokens (B/d, S/m, D) of this rank
    -> local top-k routing and capacity dispatch     (no communication)
    -> all_to_all over ``model``: (E, C, D) -> (E/m, m·C, D)
    -> this rank's experts' FFN (their d_model dimension gathered over
       the data axes first: the FSDP weight gather)
    -> all_to_all back: (E/m, m·C, D) -> (E, C, D)
    -> local combine (each token's slot rows summed in ascending slot
       order, as ``lm.moe_block``)

Every collective is differentiable (``distributed.collectives``): the
all-to-all's gradient goes back the other way, and the router, whole on
every rank but routing this rank's tokens, takes the copy-in.  The
capacity is a rank's own (the JAX ``_local_dispatch``'s), so with a
dropless ``capacity_factor`` the outputs are ``lm.moe_block``'s.  The
aux loss is the batch's, as on one device (the JAX block averages each
device's own estimate instead): the density and mean probability are
summed over the ranks a group's tokens lie on (``lm._route``'s
``stats``), so the sharded step's loss and router gradient equal one
device's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import collectives as C

from . import lm
from .common import ModelConfig


def ep_applicable(cfg: ModelConfig, b: int, s: int) -> bool:
    """Whether the expert-parallel block serves a call of the whole
    batch's shape (b, s) in the active training context: the experts and
    the positions divide over ``model`` (more than one rank), the batch
    over the data axes, and a rank's tokens fill at least one expert
    slot each (the JAX function's test)."""
    ctx = acts.current()
    if ctx is None or not ctx.experts_divisible:
        return False
    msz, dsz = ctx.model.size, ctx.data_size
    if msz <= 1:
        return False
    if not ctx.batch_divisible or b % dsz:
        return False
    if s % msz:
        return False
    if cfg.n_experts % msz:
        return False
    t_loc = (b // dsz) * (s // msz)
    return t_loc * cfg.top_k >= cfg.n_experts


def _local_dispatch(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor,
                    stats=()):
    """x (T,D) this rank's tokens -> (xe (E,C,D), combine (E·C,) float32,
    each token's K slot rows in ascending order (T·K,), aux, C).  The
    capacity is the JAX function's: a multiple of 4, at least 4, from
    T·K·capacity_factor/E."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(4, -(-int(t * k * cfg.capacity_factor / e) // 4) * 4)
    logits = (x.float() @ router)[None]
    dispatch, combine, aux, slot = lm._route(logits, cfg, cap, stats=stats)
    xpad = torch.cat([x, x.new_zeros(1, d)], dim=0)
    xe = xpad.index_select(0, dispatch[0]).view(e, cap, d)
    rows = slot.view(t, k).sort(dim=-1).values.view(t * k)
    return xe, combine[0], rows, aux, cap


def moe_block_ep(p: lm.MoE, cfg: ModelConfig, x: torch.Tensor,
                 n_valid=None, eff_capacity=None, *,
                 data_shards: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lm.moe_block`` where ``ep_applicable``: x (B/d, S/m, D) of this
    rank under sequence parallelism (or (B/d, S, D), whose positions are
    split here and gathered back after) -> (y like x, aux loss).
    ``data_shards``: the batch's MoE groups (``lm.moe_layout``) — one
    group, or a data rank's tokens each.

    The capacity-stable masked dispatch (``n_valid``/``eff_capacity``,
    serving's bucketed MoE prefill) is refused: queue positions are a
    rank's own, and a right-padded bucket would place real tokens across
    the ranks otherwise than the unpadded run; ``lm.moe_block`` keeps
    masked calls off this path, and this is the backstop."""
    if n_valid is not None or eff_capacity is not None:
        raise NotImplementedError(
            "capacity-stable masked MoE dispatch is single-device only "
            "(lm.moe_block routes it off the EP path)")
    ctx = acts.current()
    comm = ctx.model
    xl = x if ctx.seq_divisible else C.split(comm, x, 1)
    bl, sl, d = xl.shape
    e, k = cfg.n_experts, cfg.top_k
    groups = lm.moe_groups(bl * sl * comm.size * ctx.data_size, data_shards)
    if groups == 1:
        stats = (comm, ctx.data)
    elif groups == ctx.data_size:
        stats = (comm,)
    else:
        raise ValueError(f"{groups} MoE groups over {ctx.data_size} data "
                         f"ranks: the expert-parallel block takes one "
                         f"group or a data rank's tokens each")
    router = C.copy_in(comm, p.router)
    xe, combine, rows, aux, cap = _local_dispatch(
        cfg, xl.reshape(bl * sl, d), router, stats)
    if groups > 1:
        aux = C.all_reduce(ctx.data, aux) / groups
    # experts to the ranks that own them: (E, C, D) -> (E/m, m·C, D)
    xe = C.all_to_all(comm, xe, 0, 1)
    ye = lm.mlp_block(p.experts, cfg, xe)
    # and back: (E/m, m·C, D) -> (E, C, D)
    ye = C.all_to_all(comm, ye, 1, 0)
    ye = ye.reshape(e * cap, d) * combine[:, None].to(ye.dtype)
    yz = torch.cat([ye, ye.new_zeros(1, d)], dim=0)
    parts = yz.index_select(0, rows).view(bl * sl, k, d)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]
    y = y.reshape(bl, sl, d)
    if not ctx.seq_divisible:
        y = C.all_gather(comm, y, 1)
    if cfg.n_shared_experts:
        y = y + lm.mlp_block(p.shared, cfg, x)
    return y, aux
