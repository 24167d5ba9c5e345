"""Serving entry point of the port: ``python -m repro_torch.launch.serve
--arch yi-6b --full`` on the card, ``--device cpu`` for the plain
reference path on the CPU (reduced widths are the default).

Batched-request serving through the ``ServingEngine`` (continuous
batching, arena-budgeted KV or recurrent state): build the model of any
of the six families (dense, ``--arch deepseek-moe-16b`` for moe,
``mamba2-780m`` for ssm, ``zamba2-1.2b`` for hybrid, ``paligemma-3b``
for vlm, ``whisper-large-v3`` for audio) from seeded random weights,
submit a workload of prompts (with seeded patch or frame embeddings for
vlm and audio), run the engine to completion, and print per-request
latency and the throughput summary (with the engine's program counts).  The
per-token streaming front-end (``--stream`` in the JAX package) comes
with the overlapped decode loop (ROADMAP queue 1, slice 6).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.executor import capture_count, resolve_device
from repro_torch.models import get_model
from repro_torch.serving import Request, ServingEngine


def _build_engine(args) -> ServingEngine:
    """One engine from the CLI knobs, its weights drawn on the device
    from a generator seeded with ``--seed``."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator(device).manual_seed(args.seed))
    return ServingEngine(bundle, params, max_slots=args.slots,
                         cache_len=args.cache_len, device=device)


def _workload(cfg, args) -> List[Dict[str, Any]]:
    """The demo prompt mix: random prompts from ``--seed`` (plus the
    vision or audio extras the multimodal families need), as the JAX
    package's."""
    rng = np.random.default_rng(args.seed)
    reqs = []
    for uid in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2,
                                args.prompt_len + 1))
        extras = None
        if cfg.family == "vlm":
            extras = {"vision": rng.normal(
                0, 1, (cfg.n_vision_tokens, cfg.d_vision)
            ).astype(np.float32)}
        elif cfg.family == "audio":
            extras = {"frames": rng.normal(
                0, 0.1, (cfg.n_audio_ctx, cfg.d_model)
            ).astype(np.float32)}
        reqs.append(dict(
            uid=uid,
            tokens=rng.integers(0, cfg.vocab - 2, plen).astype(np.int32),
            max_new_tokens=args.max_new, extras=extras))
    return reqs


def _serve_batch(eng: ServingEngine, cfg, args) -> None:
    """Submit everything, run to completion, print the per-request table
    and throughput summary."""
    t0 = time.time()
    for r in _workload(cfg, args):
        eng.submit(Request(**r))
    results = eng.run()
    wall = time.time() - t0

    total_new = sum(len(r.output) for r in results.values())
    for uid in sorted(results):
        r = results[uid]
        print(f"  req {uid}: prompt={r.prompt_len}  new={len(r.output)}  "
              f"prefill={r.prefill_s * 1e3:.1f}ms  "
              f"decode={r.decode_s * 1e3:.1f}ms  "
              f"tokens={r.output[:8]}{'...' if len(r.output) > 8 else ''}")
    print(json.dumps({
        "device": str(eng.device),
        "wall_s": round(wall, 3),
        "tokens_generated": total_new,
        "tok_per_s": round(total_new / wall, 2),
        "arena_persistent_bytes": eng.arena.usage().persistent,
        # programs captured (on the card) or signatures run (on the CPU):
        # decode 1, prefill one per bucket or prompt length hit
        "captures": {"decode": capture_count(eng._decode),
                     "prefill": eng.prefill_compiles(),
                     "chunk": eng.chunk_compiles()},
    }))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-32b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; needs a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    eng = _build_engine(args)
    print(f"arch={cfg.arch_id}  requests={args.requests}  "
          f"slots={args.slots}  device={eng.device}")
    _serve_batch(eng, cfg, args)


if __name__ == "__main__":
    main()
