"""End-to-end serving walkthrough on the PyTorch port — the twin of
``examples/serve_multitenant.py``: host THREE models of different
families — a dense GQA transformer, a Mamba2 SSM and a Zamba2 hybrid —
in ONE shared arena (paper §4.5), stream a batched request workload
through continuous-batching engines, and report per-request latency plus
the arena accounting.

Run: PYTHONPATH=src python examples/torch/serve_multitenant.py
[--device cpu] (the card by default).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.serving import MultiTenantHost, Request

TENANTS = (("chat-lm", "qwen3-32b"),
           ("draft-ssm", "mamba2-780m"),
           ("hybrid", "zamba2-1.2b"))

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

host = MultiTenantHost(arena_bytes=512 << 20, device=args.device)
rng = np.random.default_rng(0)

print("=== admitting tenants (persistent KV sections stack) ===")
for name, arch in TENANTS:
    cfg = get_config(arch, reduced=True)
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator(host.device).manual_seed(
        hash(name) % 2**31))
    host.add_model(name, bundle, params, max_slots=2, cache_len=96)
    u = host.usage()
    # the persistent section is the tenants' KV caches, stacked
    assert u.persistent == sum(e.kv_bytes for e in host.engines.values())
    print(f"  + {name:10s} ({arch}): persistent={u.persistent >> 10} KiB")

print("\n=== submitting workload (4 requests x 3 tenants) ===")
uid = 0
for name, arch in TENANTS:
    cfg = get_config(arch, reduced=True)
    for _ in range(4):
        plen = int(rng.integers(4, 14))
        host.submit(name, Request(
            uid=uid,
            tokens=rng.integers(0, cfg.vocab - 2, plen).astype(np.int32),
            max_new_tokens=8))
        uid += 1

t0 = time.time()
results = host.run_all()
wall = time.time() - t0

total = 0
for name, _ in TENANTS:
    for u, res in sorted(results[name].items()):
        total += len(res.output)
        print(f"  {name:10s} req {u:2d}: prompt={res.prompt_len:2d} "
              f"-> {len(res.output)} tokens "
              f"(prefill {res.prefill_s * 1e3:6.1f} ms, "
              f"decode {res.decode_s * 1e3:6.1f} ms)")

u = host.usage()
print(f"\n{total} tokens in {wall:.2f}s ({total / wall:.1f} tok/s)  |  "
      f"arena: persistent={u.persistent >> 10} KiB (stacked), "
      f"capacity={u.capacity >> 20} MiB")
print("serve_multitenant OK")
