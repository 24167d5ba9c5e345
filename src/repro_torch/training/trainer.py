"""TrainState and the train-step factory, the port's counterpart of
``repro.training.trainer``.

``make_train_step`` builds ``step(state, batch) -> (state, metrics)``:
the loss and its gradients (``torch.autograd.grad`` over the model's
parameters), optional gradient accumulation, clipping by the global
norm and AdamW.  The whole step is ONE ``CapturedProgram`` per batch
signature (``core/executor.py``, the port's ``jax.jit``): on the card
its first call runs eagerly and is captured as a CUDA graph, and every
later call replays forward, backward and update as one graph;
``capture_count(step.program)`` is the JAX ``jit`` cache size.  The
batch is copied into staging tensors the step owns (one set per batch
shape), so the program's inputs keep their addresses.  Parameters and
moments are updated in place; the state returned is the state given.

The parameters are ``nn.Parameter``s held without ``requires_grad``
(the port's serving convention); the step marks them for the gradient
only while it runs.  No kernel wrapper runs on this path: a ``ctypes``
launch has no backward, and the wrappers refuse a differentiated input
(``kernels.ops``).

On a mesh (``make_train_step(..., mesh=)``, the JAX package's
``jax.jit(step, in_shardings=(train_state_sharding(...),
batch_sharding(...)))``): the state holds this rank's slices
(``shard_params(model, mesh, fsdp=True)``, then ``init_train_state``,
whose moments mirror them), every rank passes the same global batch and
the step stages this rank's rows (``sharding.shard_batch``), and the
forward and backward run inside the step's ``activation_sharding``
context, which turns the model steps into this rank's share with their
differentiable collectives; the clip sums the squared norms over the
axes each leaf is split on.  The sharded step is one ``CapturedProgram``
per batch shape too: over NCCL its collectives are captured with the
forward, backward and update; over gloo on the card (gloo stages CUDA
tensors through the host, which a capture cannot record) it runs
eagerly and records nothing.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.core.executor import CapturedProgram, disable_capture

from .optimizer import (AdamWState, adamw_init, adamw_update,
                        clip_by_global_norm)


class TrainState(NamedTuple):
    params: nn.Module
    opt: AdamWState


def init_train_state(params: nn.Module) -> TrainState:
    return TrainState(params=params, opt=adamw_init(params.named_parameters()))


# the families whose layers run under sequence parallelism on a mesh:
# those of ``lm.lm_backbone`` (the recurrent layers take every position)
SEQ_PARALLEL_FAMILIES = ("dense", "moe", "vlm")


def step_context(cfg, mesh, batch: Dict[str, Any]):
    """The ``activation_sharding`` context of a sharded step on ``mesh``
    for this rank's ``batch`` (the JAX dry run's decisions): experts
    where they divide over ``model``, sequence parallelism where the
    layers' positions (the vision prefix included) do, and K/V split by
    sequence (``kv_seq``) where the heads do not divide over ``model``
    and the attended positions do (the dry run's ``not heads_divisible
    and seq_divisible``); a null context without a mesh.  Attention's
    split by heads is the sharding policy's (``tp.split``)."""
    if mesh is None:
        return contextlib.nullcontext()
    from repro_torch.distributed.act_sharding import activation_sharding
    m = mesh.shape["model"]
    s = batch["tokens"].shape[1] + (cfg.n_vision_tokens
                                     if cfg.family == "vlm" else 0)
    seq_divisible = m > 1 and s % m == 0
    return activation_sharding(
        mesh, batch_divisible=True,
        seq_divisible=seq_divisible and cfg.family in SEQ_PARALLEL_FAMILIES,
        experts_divisible=bool(cfg.n_experts) and cfg.n_experts % m == 0,
        kv_seq=(seq_divisible and bool(cfg.n_heads)
                and cfg.n_heads % m != 0))


def loss_and_grads(loss_fn: Callable, model: nn.Module,
                   batch: Dict[str, torch.Tensor], *, mesh=None,
                   **loss_kwargs):
    """(loss, metrics, gradients by parameter name) of ``loss_fn(model,
    batch, **loss_kwargs)``, all detached; on a ``mesh`` ``model`` is this
    rank's slices, ``batch`` its rows, and the gradients its slices of
    the whole batch's (the loss and metrics are the whole batch's, on
    every rank)."""
    named = dict(model.named_parameters())
    params = list(named.values())
    for p in params:
        p.requires_grad_(True)
    try:
        with torch.enable_grad(), step_context(model.cfg, mesh, batch):
            loss, metrics = loss_fn(model, batch, **loss_kwargs)
            grads = torch.autograd.grad(loss, params, materialize_grads=True)
    finally:
        for p in params:
            p.requires_grad_(False)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(named, grads)))


def make_train_step(loss_fn: Callable, *, lr=3e-4, max_grad_norm=1.0,
                    grad_accum: int = 1, weight_decay: float = 0.1,
                    mesh=None, **loss_kwargs) -> Callable:
    """loss_fn(params, batch, **loss_kwargs) -> (loss, metrics), as a
    bundle's ``loss``.  Returns ``step(state, batch) -> (state,
    metrics)``: ``batch`` a dict of arrays or tensors (copied to the
    state's device), ``metrics`` the loss function's plus ``loss``,
    ``grad_norm`` and ``step``, device scalars valid until the next call
    (with ``grad_accum > 1`` the loss function's metrics reduce to
    ``ce_loss``, the mean loss, as in the JAX package).  ``step.program``
    is the step's ``CapturedProgram``.  With ``mesh`` (a ``launch.mesh``
    mesh over this process's world) the state is this rank's
    (``shard_params(..., fsdp=True)``), ``batch`` the global batch every
    rank passes alike, and the step this rank's share (module
    docstring); pass ``data_shards`` = the data axes' size, as the JAX
    launcher does."""

    def train_step(model: nn.Module, opt: AdamWState,
                   batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        named = dict(model.named_parameters())
        if grad_accum > 1:
            n = next(iter(batch.values())).shape[0] // grad_accum
            loss = torch.zeros((), dtype=torch.float32, device=opt.step.device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for k, p in named.items()}
            for i in range(grad_accum):
                micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l_i, _, g_i = loss_and_grads(loss_fn, model, micro,
                                             mesh=mesh, **loss_kwargs)
                loss = loss + l_i
                grads = {k: g + g_i[k] for k, g in grads.items()}
            loss = loss / grad_accum
            grads = {k: g / grad_accum for k, g in grads.items()}
            metrics = {"ce_loss": loss}
        else:
            loss, metrics, grads = loss_and_grads(loss_fn, model, batch,
                                                  mesh=mesh, **loss_kwargs)
        grads, gnorm = clip_by_global_norm(
            grads, max_grad_norm, mesh=mesh,
            specs=getattr(model, "specs", None))
        adamw_update(grads, opt, named, lr=lr, weight_decay=weight_decay)
        return dict(metrics, loss=loss, grad_norm=gnorm, step=opt.step.clone())

    program = CapturedProgram(train_step, name="train_step")
    staging: Dict[Any, torch.Tensor] = {}

    def stage(name, value, device) -> torch.Tensor:
        value = torch.as_tensor(value)
        key = (name, tuple(value.shape), value.dtype, device)
        if key not in staging:
            staging[key] = torch.empty(value.shape, dtype=value.dtype,
                                       device=device)
        return staging[key].copy_(value)

    def step(state: TrainState, batch) -> tuple:
        device = state.opt.step.device
        if mesh is not None:
            from repro_torch.distributed.sharding import shard_batch
            batch = shard_batch(batch, mesh, grad_accum)
        staged = {k: stage(k, v, device) for k, v in batch.items()}
        eager = (mesh is not None and mesh.backend == "gloo"
                 and device.type == "cuda")
        with disable_capture() if eager else contextlib.nullcontext():
            return state, program(state.params, state.opt, staged)

    step.program = program
    return step


def train_state_sharding(param_sharding: Any, mesh) -> TrainState:
    """The TrainState sharding tree (the JAX package's): the moments
    mirror ``param_sharding`` (parameter name -> ``Sharding``,
    ``sharding.param_sharding``) and the step is replicated.
    ``shard_params`` and ``init_train_state`` lay a state out so."""
    from repro_torch.distributed.sharding import replicated
    return TrainState(params=param_sharding,
                      opt=AdamWState(step=replicated(mesh),
                                     mu=param_sharding, nu=param_sharding))
