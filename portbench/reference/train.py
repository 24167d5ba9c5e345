"""The plain reference of the dense LM's training steps, float32.

The loss is the mean cross-entropy of the next tokens over the positions
whose label is not -1 (a position after an end of sequence), taken over
the head's held columns (``weights.vocab_rows``: the vocabulary padded
as the configuration holds it); the update is AdamW as the
configuration's ``trainer`` block states it, after clipping the
gradient's global norm, decaying every leaf but ``final_norm``.  Each
layer, and each chunk of queries inside its attention, is recomputed in
backward, so the steps fit beside nothing else on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from portbench import weights
from portbench.reference.lm import fp8, layer, mm, rms_norm, set_precision


def loss_of(conf: Dict, params: Dict[str, torch.Tensor], tokens, labels,
            lowp: Optional[str] = None) -> torch.Tensor:
    m = conf["model"]
    x = params["embed"][tokens]
    for p, is_moe in weights.layer_prefixes(conf):
        w = {n: t for n, t in params.items() if n.startswith(p + ".")}
        x = checkpoint(layer, x, w, p, is_moe, m, lowp, True,
                       use_reentrant=False)
    h = rms_norm(x, params["final_norm"], m["rms_norm_eps"])
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].t()
    logits = mm(h, head, lowp)
    keep = labels >= 0
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return ((logz - gold) * keep).sum() / keep.sum().clamp(min=1)


def held(x: torch.Tensor, lowp: Optional[str]) -> torch.Tensor:
    """A parameter as it is held: float32, or under ``lowp="fp8"`` float8
    e4m3 with one scale for the leaf."""
    if lowp is None:
        return x
    return fp8(x.reshape(1, -1), -1).view(x.shape).detach()


def decays(name: str) -> bool:
    return name != "final_norm"


def train(conf: Dict, seed: int, batches: List[Dict[str, np.ndarray]],
          device, lowp: Optional[str] = None, rows: Optional[slice] = None
          ) -> Dict:
    """``len(batches)`` steps from the seed's weights: each step's loss,
    each leaf's first gradient as AdamW gets it (after the clip) and each
    leaf's change over all the steps (norms, float).  ``rows`` takes a
    part of each batch (a fault: part of the batch left out).  Under
    ``lowp="fp8"`` (the control) the products take float8 operands and
    the parameters are held in float8 (a scale a leaf), as the program
    holds them in bfloat16: rounded when made and after each update."""
    set_precision()
    t = conf["trainer"]
    params = {}
    for _, _, tensors in weights.all_groups(conf, seed, device):
        for n, v in tensors.items():
            params[n] = held(v.float(), lowp).requires_grad_(True)
        del tensors
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], {}
    names = list(params)
    for step, batch in enumerate(batches, start=1):
        tok = torch.as_tensor(batch["tokens"], device=device).long()
        lab = torch.as_tensor(batch["labels"], device=device).long()
        if rows is not None:
            tok, lab = tok[rows], lab[rows]
        loss = loss_of(conf, params, tok, lab, lowp)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(t["max_grad_norm"] / gnorm.clamp(min=1e-9),
                                max=1.0)
            bc1 = 1 - t["b1"] ** step
            bc2 = 1 - t["b2"] ** step
            for n, g in zip(names, grads):
                g = g * scale
                if step == 1:
                    first[n] = float(g.norm())
                mu[n].mul_(t["b1"]).add_((1 - t["b1"]) * g)
                nu[n].mul_(t["b2"]).add_((1 - t["b2"]) * g.square())
                delta = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + t["eps"])
                if decays(n):
                    delta = delta + t["weight_decay"] * params[n]
                params[n].copy_(held(params[n] - t["lr"] * delta, lowp))
        del grads
    del mu, nu
    change = {}
    with torch.no_grad():
        for _, _, tensors in weights.all_groups(conf, seed, device):
            for n, v in tensors.items():
                change[n] = float((params[n] - v.float()).norm())
            del tensors
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1]
                                                    + v[len(v) // 2])


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep=None) -> float:
    """The worst leaf's gap between two norms: |program - reference| over
    the larger of the reference's norm of that leaf and the median
    leaf's; ``keep`` the leaves that count."""
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return math.nan
    floor = median([ref[n] for n in names])
    return max(abs(prog[n] - ref[n]) / max(ref[n], floor) for n in names)
