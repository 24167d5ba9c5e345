"""Tiny cells for the CPU tests: a dense and a MoE configuration of the
port's smoke-test sizes, a chat, a closed-loop and a training mix, their
limits, and a ``BENCHMARK.json`` naming them, all written under a
directory the test owns and found there by name."""

from __future__ import annotations

import json
import time
from pathlib import Path

from portbench.harness import execute
from portbench.spec import HERE, Bench

DENSE = {
    "hidden_act": "silu", "hidden_size": 256, "intermediate_size": 512,
    "max_position_embeddings": 4096, "num_attention_heads": 4,
    "num_hidden_layers": 2, "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
    "rope_scaling": None, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float32",
    "vocab_size": 512}
MOE = dict(DENSE, intermediate_size=512, moe_intermediate_size=128,
           moe_layer_freq=1, n_routed_experts=4, n_shared_experts=1,
           norm_topk_prob=True, num_experts_per_tok=2,
           num_key_value_heads=4, first_k_dense_replace=1,
           scoring_func="softmax", rms_norm_eps=1e-6)
ENGINE = {"kv_block": 16, "overlap": True, "prefill_buckets": True}
TRAINER = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "max_grad_norm": 1.0, "remat": True}
CONFIGS = {
    "tiny_dense": {"kind": "serve", "arch": "yi-6b-smoke", "model": DENSE,
                   "engine": ENGINE},
    # capacity 2.0: every expert's capacity holds the step's tokens
    "tiny_moe": {"kind": "serve", "arch": "deepseek-moe-16b-smoke",
                 "model": MOE, "engine": ENGINE,
                 "assumed": {"capacity_factor": 2.0}},
    "tiny_train": {"kind": "train", "arch": "yi-6b-smoke", "model": DENSE,
                   "trainer": TRAINER},
}
MIXES = {
    "tinychat": {"loop": "open", "rate_per_s": 20, "slots": 4,
                 "prompt": {"dist": "lognormal", "median": 20, "sigma": 0.5,
                            "min": 8, "max": 48},
                 "output": {"dist": "uniform", "min": 4, "max": 16},
                 "lead_in_s": 0.3, "check": {"tokens": 40, "requests": 3}},
    "tinybatch": {"loop": "closed", "clients": 6, "slots": 4, "pool": 300,
                  "prompt": {"dist": "uniform", "min": 8, "max": 40},
                  "output": {"dist": "uniform", "min": 4, "max": 12},
                  "lead_in_s": 0.3, "check": {"tokens": 40, "requests": 3}},
    "tinytrain": {"loop": "train", "batch": 2, "seq": 64, "doc_min": 16,
                  "doc_max": 64, "branching": 8, "check_steps": 3},
}
# float32 on the CPU against float32: the gaps are round-off
LIMITS = {
    "tiny.chat": {"max_logit_gap": {"limit": 1e-3}},
    "tiny.batch": {"max_logit_gap": {"limit": 1e-3}},
    "tiny.train": {"loss_gap": {"limit": 1e-4}, "grad_gap": {"limit": 1e-3},
                   "change_gap": {"limit": 1e-2}},
}
CELLS = [("tiny.chat", "tiny_dense", "tinychat"),
         ("tiny.batch", "tiny_moe", "tinybatch"),
         ("tiny.train", "tiny_train", "tinytrain")]


def _write(path: Path, doc) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc))


def make_bench(root: Path, per_layer=()) -> Bench:
    """The tiny cells under ``root``; ``per_layer`` metric entries added
    to their ``BENCHMARK.json``."""
    for name, conf in CONFIGS.items():
        _write(root / "configs" / f"{name}.json",
               dict(conf, name=name, source="test", reduced=[]))
    for name, mix in MIXES.items():
        _write(root / "traffic" / f"{name}.json", dict(mix, name=name))
    for cell, lim in LIMITS.items():
        _write(root / "checks" / f"{cell}.json", lim)
    doc = {"command": ["python3", "-m", "portbench.run"],
           "paths": ["portbench"], "run_seconds": 1,
           "configs": [], "workloads": [
               {"name": c, "config": k, "traffic": t, "chips": 1, "why": "t"}
               for c, k, t in CELLS],
           "end_to_end": [
               {"name": "ttft_p95_ms", "unit": "ms", "better": "lower",
                "bound": 0.1, "source": "host_clock",
                "workloads": ["tiny.chat"]},
               {"name": "tokens_per_s", "unit": "tokens/s",
                "better": "higher", "bound": 0.1, "source": "host_clock",
                "workloads": ["tiny.batch"]},
               {"name": "train_tokens_per_s", "unit": "tokens/s",
                "better": "higher", "bound": 0.1, "source": "host_clock",
                "workloads": ["tiny.train"]},
               {"name": "setup_s", "unit": "s", "better": "lower",
                "bound": 0.25, "source": "host_clock"}],
           "per_layer": list(per_layer)}
    _write(root / "BENCHMARK.json", doc)
    return Bench(root / "BENCHMARK.json", roots=(root, HERE))


def run_cell(bench: Bench, cell: str, trace: bool = False,
             seed: int = 2 ** 33 + 5, seconds: float = 1.0):
    return execute(bench, bench.cell(cell), seed, seconds, trace, "cpu",
                   time.monotonic())
