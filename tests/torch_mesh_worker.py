"""One rank of a CPU serving mesh, for ``tests/test_torch_sharded_*.py``.

    python tests/torch_mesh_worker.py SPEC RANK

``SPEC`` is a pickle written by the test: the world size, a FileStore
path for the rendezvous, and the cases to serve; each case names a
reduced architecture (optionally with config fields replaced), its
weights as a JAX-layout numpy tree, the requests and the engine's
keywords.  The rank joins a gloo world (one torch thread, collectives
time out), builds ``make_serving_mesh(world)``, serves every case on it
and appends each case's result — tokens, program counts, resident bytes —
to ``SPEC.RANK.out`` as it finishes, so a failure leaves what came
before.  A case that raises writes its traceback there and ends the
rank with exit code 1.  This module imports no jax.
"""

import dataclasses
import datetime
import pickle
import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.executor import capture_count  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models import get_model, params_from_jax  # noqa: E402
from repro_torch.serving import (MultiTenantHost, Request,  # noqa: E402
                                 ServingEngine)

# seconds a collective may wait for the other ranks before it raises
COLLECTIVE_TIMEOUT_S = 60


def _model(case):
    cfg = get_config(case["arch"], reduced=True)
    if case.get("replace"):
        cfg = dataclasses.replace(cfg, **case["replace"])
    return cfg, get_model(cfg), params_from_jax(case["tree"], cfg,
                                                device="cpu")


def _requests(case, uid0=0):
    return [Request(uid=uid0 + uid, tokens=toks, max_new_tokens=case["new"],
                    extras=extras, priority=case.get("priority", {}).get(
                        uid, 0))
            for uid, toks, extras in case["reqs"]]


def _skewed_clock(rank):
    """Rank 0's clock ticks 1 µs a read; every other rank's starts 10^12
    µs later and ticks 10 ms a read: clocks that would order the queue
    differently under an aging policy."""
    reads = [0]

    def clock():
        reads[0] += 1
        return reads[0] if rank == 0 else 10 ** 12 + reads[0] * 10 ** 4
    return clock


def _serve_engine(case, mesh, rank):
    cfg, bundle, model = _model(case)
    kw = dict(case["kw"])
    if case.get("skew"):
        kw["clock"] = _skewed_clock(rank)
    eng = ServingEngine(bundle, model, max_slots=case["slots"],
                        cache_len=case["cache_len"], device="cpu",
                        mesh=mesh, **kw)
    admitted = []
    admit = eng._admit

    def logged(req, slot):
        admitted.append((req.uid, slot))
        admit(req, slot)
    eng._admit = logged
    for req in _requests(case):
        eng.submit(req)
    steps, evicted = 0, False
    while eng.step():
        steps += 1
        if case.get("evict") and not evicted and steps >= 3:
            eng.drain()
            victim = next(s for s in range(eng.max_slots)
                          if eng.active[s] or s in eng._chunking)
            eng._evict(victim)
            evicted = True
    out = {"tokens": {u: r.output for u, r in eng.results.items()},
           "decode": capture_count(eng._decode),
           "prefill": eng.prefill_compiles(),
           "chunk": eng.chunk_compiles(),
           "preemptions": sum(r.preemptions for r in eng.results.values()),
           "admitted": admitted, "seq_kv": eng._seq_kv,
           "param_bytes": eng.param_bytes, "kv_bytes": eng.kv_bytes,
           "evicted": evicted}
    if eng.overlap:
        out["argmax"] = capture_count(eng._argmax)
    if eng.paged:
        out["blocks_back"] = eng.pool.free_blocks() == eng.pool.usable_blocks
    return out


def _serve_host(case, mesh):
    """One MultiTenantHost: ``case``'s model as a sharded tenant and as a
    routed tenant of two replicas (uids from 100), both on ``mesh``."""
    cfg, bundle, model = _model(case)
    host = MultiTenantHost(64 << 20, device="cpu")
    host.add_model("one", bundle, model, max_slots=case["slots"],
                   cache_len=case["cache_len"], mesh=mesh)
    router = host.add_replicated_model(
        "two", bundle, model, replicas=2, max_slots=case["slots"],
        cache_len=case["cache_len"], mesh=mesh)
    for req in _requests(case):
        host.submit("one", req)
    for req in _requests(case, uid0=100):
        host.submit("two", req)
    res = host.run_all()
    engines = [host.engines["one"], *router.replicas]
    return {"tokens": {u: r.output for name in ("one", "two")
                       for u, r in res[name].items()},
            "decode": [capture_count(e._decode) for e in engines],
            "shared_weights": router.replicas[0].params is
            router.replicas[1].params}


def main(spec_path, rank):
    spec = pickle.loads(Path(spec_path).read_bytes())
    out_path = Path(f"{spec_path}.{rank}.out")
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], spec["world"]),
        rank=rank, world_size=spec["world"],
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    mesh = make_serving_mesh(spec["world"], device="cpu")
    results = {}
    for case in spec["cases"]:
        try:
            results[case["name"]] = (_serve_host(case, mesh)
                                     if case.get("host") else
                                     _serve_engine(case, mesh, rank))
        except Exception:
            results[case["name"]] = {"error": traceback.format_exc()}
            out_path.write_bytes(pickle.dumps(results))
            return 1
        out_path.write_bytes(pickle.dumps(results))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
