"""AdamW and the cosine schedule, the port's counterpart of
``repro.training.optimizer``.

The moments are float32 whatever the parameter's dtype (bf16-safe); the
update is computed in float32 and cast back.  Parameters and moments
are updated IN PLACE (the JAX function returns new trees), and the step
is an int32 tensor on the parameters' device: the learning rate and the
bias corrections are computed from it on the device, so the whole update
takes no branch on a device value and can be captured in a CUDA graph
(``training.trainer``).  Parameters and moments are keyed by the model's
parameter names (``named_parameters()``).

Weight decay follows the JAX package's rule, "leaves of two or more
dims", on the JAX package's leaves: there a layer's parameters are
stacked on a leading L dim (``models.lm.jax_key``), so a per-layer norm
gain or bias is decayed and the final norm is not (ROADMAP queue 3).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, NamedTuple, Tuple, Union

import torch

from repro_torch.models.lm import jax_key

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32, on the parameters' device
    mu: Tensors                 # float32, like the parameters
    nu: Tensors                 # float32, like the parameters


def adamw_init(params: Iterable[Tuple[str, torch.Tensor]]) -> AdamWState:
    """Zero moments (float32) for each named parameter, on its device;
    step 0 on the first parameter's device."""
    params = dict(params)
    mu = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for n, p in params.items()}
    nu = {n: torch.zeros_like(m) for n, m in mu.items()}
    device = next(iter(params.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=mu, nu=nu)


def clip_by_global_norm(grads: Tensors, max_norm: float, *, mesh=None,
                        specs=None) -> Tuple[Tensors, torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), the global float32 l2
    norm); the scale is cast to each gradient's dtype before the
    product, as in the JAX function.

    On a ``mesh`` the gradients are this rank's slices, laid out as
    ``specs`` (parameter name -> spec, ``sharding.param_specs``): the
    squared sums of the leaves split over the same axes are summed over
    those axes' ranks (one ``all_reduce`` per set of axes), and a leaf
    every rank holds whole counts once, so every rank gets the norm of
    the whole gradient."""
    if mesh is None:
        gnorm = torch.sqrt(torch.stack([g.float().square().sum()
                                        for g in grads.values()]).sum())
    else:
        from repro_torch.distributed import collectives
        sums: Dict[Tuple[str, ...], torch.Tensor] = {}
        for n, g in grads.items():
            axes = tuple(a for a in mesh.axis_names
                         if any(a == e or (isinstance(e, tuple) and a in e)
                                for e in specs[n]))
            if math.prod(mesh.shape[a] for a in axes) == 1:
                axes = ()
            part = g.float().square().sum()
            sums[axes] = sums[axes] + part if axes in sums else part
        total = sums.pop((), None)
        for axes, part in sums.items():
            part = collectives.all_reduce(mesh.comm(axes), part)
            total = part if total is None else total + part
        gnorm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, gnorm


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays the parameter ``name``: its JAX leaf has two or
    more dims (a per-layer leaf is stacked on a leading L dim there)."""
    return p.dim() + (jax_key(name)[1] is not None) >= 2


LearningRate = Union[float, Callable[[torch.Tensor], torch.Tensor]]


@torch.no_grad()
def adamw_update(grads: Tensors, state: AdamWState, params: Tensors, *,
                 lr: LearningRate, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1) -> AdamWState:
    """One AdamW step, in place: ``params`` and the moments take their new
    values, ``state.step`` advances by one.  ``lr`` is a scalar or a
    callable (the new step, a device tensor) -> scalar tensor.  Weight
    decay applies to leaves of two or more dims in the JAX layout only
    (``decays``).  Returns ``state``."""
    state.step.add_(1)
    step = state.step.float()
    lr_t = lr(state.step) if callable(lr) else lr
    bc1 = 1 - torch.pow(b1, step)
    bc2 = 1 - torch.pow(b2, step)
    for name, p in params.items():
        g32 = grads[name].float()
        m, v = state.mu[name], state.nu[name]
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32.square())
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if decays(name, p):
            delta = delta + weight_decay * p.float()
        p.copy_(p.float() - lr_t * delta)
    return state


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[torch.Tensor],
                                                    torch.Tensor]:
    """step (int tensor) -> learning rate (float32 tensor): linear warm-up
    to ``peak_lr`` over ``warmup`` steps, then a cosine to ``floor`` ×
    peak at ``total``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)
    return lr
