"""The training driver: a configuration of ``kind`` train through the
port's captured train step (``training/trainer.py`` ``make_train_step``
with the configuration's ``trainer`` settings, AdamW, remat).

Set-up builds one train state on the seed's weights and drives it
through the mix's ``check_steps`` first steps, through the same call and
feed as the window, on rows that all differ; their losses, each leaf's
first gradient as AdamW got it (read from its first moment: m = (1 - b1)
g after one step) and each leaf's change over them (against the seed's
weights drawn again) are kept.  The window then runs steps on that same
state until ``--seconds`` have passed, and ends at the last step's end.
Once the state is freed, the reference trains the checked steps in
float32 and the numbers are compared.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from portbench import traffic, weights
from portbench.model import model_config

# batches made for a run: the checked steps' and the window's, which
# cycles through them
POOL = 64


def leaf_norms(model, conf: Dict, seed: int, device) -> Dict[str, float]:
    """Each parameter's distance from the seed's weights."""
    params = dict(model.named_parameters())
    out = {}
    with torch.no_grad():
        for _, _, tensors in weights.all_groups(conf, seed, device):
            for n, t in tensors.items():
                out[n] = float((params[n].float() - t.float()).norm())
    return out


def run(ctx: Dict) -> Dict:
    from portbench import compare
    from portbench import trace as tr
    from portbench.reference import train as ref_train
    from repro_torch.models import get_model
    from repro_torch.models.registry import empty_model
    from repro_torch.training import init_train_state, make_train_step

    conf, mix, seed = ctx["conf"], ctx["mix"], ctx["seed"]
    device = torch.device(ctx["device"])
    t = conf["trainer"]
    cfg = model_config(conf)
    bundle = get_model(cfg)
    model = weights.fill_module(empty_model(cfg, "meta"), conf, seed,
                                device)
    state = init_train_state(model)
    step = make_train_step(bundle.loss, lr=t["lr"],
                           max_grad_norm=t["max_grad_norm"],
                           weight_decay=t["weight_decay"], remat=t["remat"],
                           data_shards=1)
    batches = traffic.train_batches(mix, seed, cfg.vocab, POOL)
    n_check = int(mix["check_steps"])
    prog = {"losses": []}
    for i in range(n_check):
        metrics = step(state, batches[i])[1]
        # kept as the window keeps its losses (the copy's kernel loads now)
        prog["losses"].append(float(metrics["loss"].clone()))
        if i == 0:
            prog["grad_norms"] = {
                n: float(m.norm()) / (1 - t["b1"])
                for n, m in state.opt.mu.items()}
    prog["change_norms"] = leaf_norms(model, conf, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    captures = step.program.capture_s
    seconds = float(ctx["seconds"])
    # a traced run profiles the whole window, its markers outside it (a
    # marker thread would wait out the steps that hold the device)
    traced = (tr.Traced(torch, device)
              if ctx["trace"] and device.type == "cuda" else None)
    if traced is not None:
        traced.begin()
    w0 = time.monotonic()
    steps, losses = 0, []
    while True:
        metrics = step(state, batches[(n_check + steps) % POOL])[1]
        losses.append(metrics["loss"].clone())
        steps += 1
        if time.monotonic() - w0 >= seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize()
    w1 = time.monotonic()
    if traced is not None:
        traced.stop()
    rec = {"setup_s": w0 - ctx["t0"], "w0": w0, "w1": w1, "steps": steps,
           "tokens": steps * int(mix["batch"]) * int(mix["seq"]),
           "attempted": steps,
           "failed": int((~torch.isfinite(torch.stack(losses))).sum()),
           "captures_in_window": ({"train_step": 1}
                                  if step.program.capture_s != captures
                                  else {}),
           "trace": traced.read() if traced is not None else None,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    del state, model, step, metrics
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = ref_train.train(conf, seed, batches[:n_check], device)
    rec["numbers"] = compare.train_numbers(prog, ref)
    rec["program"], rec["reference"] = prog, ref
    if ctx.get("control"):
        # the control (float8 products) and a fault (half of each batch
        # left out), each in the program's place; a state left unchanged
        # reads 1 on change_gap by its definition
        rows = slice(0, int(mix["batch"]) // 2)
        rec["control_numbers"] = {
            "fp8": compare.train_numbers(ref_train.train(
                conf, seed, batches[:n_check], device, lowp="fp8"), ref),
            "half_batch": compare.train_numbers(ref_train.train(
                conf, seed, batches[:n_check], device, rows=rows), ref)}
    return rec
