"""What decides ``correct``: the program's outputs held against the plain
reference (``portbench.reference``), each number beside its limit.

The limits of a cell are data, ``checks/<cell>.json``: for each number
its ``limit`` and the two readings it was set from (``lower``, the
largest that sound runs of the program gave; ``upper``, the smallest
that the control or a fault gave).

Serving: once the window has closed and the engine is freed, a sample
of the window's finished requests, drawn from the seed with the longest
of them in it, is run through the reference once each (the prompt and
its served tokens); ``max_logit_gap`` is the widest gap by which a
served token's logit lies below the reference's best at its position.
The control, for ``control.py``: the reference in float8 products in the
program's place, read as the gap of the token it puts first.

Training: the steps' losses, each leaf's first gradient as AdamW got it
and each leaf's change over the checked steps, against the reference's
(``reference/train.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def sample(requests: List[Dict], w0: int, w1: int, seed: int,
           tokens: int, most: int) -> List[Dict]:
    """The window's finished requests to check (due in it, or served in
    it: a closed loop's): the longest (prompt and output), then others in
    an order drawn from the seed until the sample holds ``tokens`` served
    tokens or ``most`` requests."""
    done = [r for r in requests if r["done"] and r["times"]
            and (w0 <= r["due_us"] < w1
                 or any(w0 <= t < w1 for t in r["times"]))]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r["prompt"]) + len(r["tokens"]))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng(seed).permutation(len(rest))
    out, n = [longest], len(longest["tokens"])
    for i in order:
        if n >= tokens or len(out) >= most:
            break
        out.append(rest[i])
        n += len(rest[i]["tokens"])
    return out


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's reference logit lies below the
    reference's best at its position."""
    return ref.max(dim=-1).values - ref.gather(-1, chosen[:, None])[:, 0]


def serve(ctx: Dict, rec: Dict, control: bool = False) -> Dict:
    """The serving check of one run: ``numbers`` (``max_logit_gap`` and,
    with ``control``, ``control_logit_gap``), ``compared_tokens``."""
    from portbench.reference import lm as ref_lm

    check = ctx["mix"].get("check", {})
    picked = sample(rec["requests"], rec["w0_us"], rec["w1_us"],
                    ctx["seed"], int(check.get("tokens", 400)),
                    int(check.get("requests", 8)))
    if not picked:
        return {"numbers": {}, "compared_tokens": 0}
    seqs, starts, served = [], [], []
    for r in picked:
        out = np.asarray(r["tokens"], np.int64)
        seqs.append(torch.as_tensor(np.concatenate(
            [np.asarray(r["prompt"], np.int64), out[:-1]])))
        starts.append(len(r["prompt"]) - 1)
        served.append(torch.as_tensor(out))
    device = torch.device(ctx["device"])
    ref = ref_lm.logits_at(ctx["conf"], ctx["seed"], seqs, starts, device)
    out = {"numbers": gap_numbers(torch.cat(
        [gaps(lg, s.to(device)) for lg, s in zip(ref, served)])),
        "compared_tokens": int(sum(len(s) for s in served))}
    if control:
        low = ref_lm.logits_at(ctx["conf"], ctx["seed"], seqs, starts,
                               device, lowp="fp8")
        out["control_numbers"] = {"fp8": gap_numbers(torch.cat(
            [gaps(lg, lw.argmax(dim=-1)) for lg, lw in zip(ref, low)]))}
    return out


def gap_numbers(g: torch.Tensor) -> Dict[str, float]:
    """``max_logit_gap``, the widest gap, and ``mean_logit_gap``, the mean
    over every compared position (0 where the chosen token is the
    reference's best): the widest swings with one near tie, the mean is
    steady from seed to seed."""
    return {"max_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.float().mean())}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``loss_gap`` (the worst step's |loss - reference| over the
    reference's), ``grad_gap`` (the worst leaf's first gradient norm)
    and ``change_gap`` (the worst leaf's change over the checked steps,
    leaving out the leaves whose reference gradient is under a
    thousandth of the median leaf's: they move by round-off alone)."""
    from portbench.reference.train import leaf_gap, median

    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                    ref["losses"]))
    g = ref["grad_norms"]
    floor = 1e-3 * median(list(g.values()))
    keep = {n for n, v in g.items() if v >= floor}
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(prog["grad_norms"], g),
            "change_gap": leaf_gap(prog["change_norms"],
                                   ref["change_norms"], keep)}


def judge(numbers: Dict[str, float], limits: Dict[str, Dict]
          ) -> (bool, Dict[str, Dict]):
    """(every number with a limit within it, each such number beside its
    limit).  A limit without a number fails, and so does a cell without
    limits; a number without a limit is judged by nothing."""
    shown = {}
    ok = bool(limits)
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim["limit"]
        ok = ok and good
        shown[name] = {"value": v, "limit": lim["limit"]}
    return ok, shown
