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
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch
from torch import nn

from repro_torch.core.executor import CapturedProgram

from .optimizer import (AdamWState, adamw_init, adamw_update,
                        clip_by_global_norm)


class TrainState(NamedTuple):
    params: nn.Module
    opt: AdamWState


def init_train_state(params: nn.Module) -> TrainState:
    return TrainState(params=params, opt=adamw_init(params.named_parameters()))


def make_train_step(loss_fn: Callable, *, lr=3e-4, max_grad_norm=1.0,
                    grad_accum: int = 1, weight_decay: float = 0.1,
                    **loss_kwargs) -> Callable:
    """loss_fn(params, batch, **loss_kwargs) -> (loss, metrics), as a
    bundle's ``loss``.  Returns ``step(state, batch) -> (state,
    metrics)``: ``batch`` a dict of arrays or tensors (copied to the
    state's device), ``metrics`` the loss function's plus ``loss``,
    ``grad_norm`` and ``step``, device scalars valid until the next call
    (with ``grad_accum > 1`` the loss function's metrics reduce to
    ``ce_loss``, the mean loss, as in the JAX package).  ``step.program``
    is the step's ``CapturedProgram``."""

    def single(model, named, batch):
        params = list(named.values())
        for p in params:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = loss_fn(model, batch, **loss_kwargs)
                grads = torch.autograd.grad(loss, params,
                                            materialize_grads=True)
        finally:
            for p in params:
                p.requires_grad_(False)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(named, grads)))

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
                l_i, _, g_i = single(model, named, micro)
                loss = loss + l_i
                grads = {k: g + g_i[k] for k, g in grads.items()}
            loss = loss / grad_accum
            grads = {k: g / grad_accum for k, g in grads.items()}
            metrics = {"ce_loss": loss}
        else:
            loss, metrics, grads = single(model, named, batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
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
        staged = {k: stage(k, v, device) for k, v in batch.items()}
        return state, program(state.params, state.opt, staged)

    step.program = program
    return step


def train_state_sharding(param_sharding: Any, mesh) -> Any:
    """The JAX package's TrainState sharding tree.  Mesh-sharded training
    is the second half of ROADMAP item 15 (the port serves on a mesh, it
    does not train on one yet): refused, naming that slice."""
    raise NotImplementedError(
        f"train_state_sharding(mesh={mesh!r}): mesh-sharded training "
        f"(act_sharding, moe_ep, the sharded train step), the second half "
        f"of ROADMAP queue 1, item 15, is not in the PyTorch port yet")
