"""Mesh-sharded serving on the CPU: ``ServingEngine(mesh=
make_serving_mesh(N))`` on gloo worlds of 2 and 4 ranks, one process a
rank (``tests/torch_mesh_worker.py``), against the JAX engine's
single-device tokens on the same weights (``params_from_jax``) at the
reduced configs, float32 — the ``sharded`` column of
``tests/test_family_parity.py``, whose JAX side needs two XLA devices
and skips here, so the JAX single-device engine is the reference.

  * 2 ranks: every family of ``SHARDED_FAMILIES`` through a forced
    evict/restore (dense, moe and hybrid in ``heads``/``kv_heads`` mode,
    vlm's one KV head in ``heads``/``sequence``, ssm and hybrid on half
    the SSD heads), paged (dense, moe, vlm), chunked (dense, vlm, ssm,
    hybrid) and overlapped (dense); a ``MultiTenantHost`` with one
    sharded tenant and a routed tenant of two replicas; two ranks whose
    clocks disagree, under an aging policy.
  * 4 ranks: the reduced Yi-6B (4 heads, 2 KV heads: ``heads``/
    ``sequence``) and the same with 6 heads (``replicated``/
    ``sequence``), contiguous, paged, chunked and overlapped, each with
    its cache rows split four ways.

The JAX engine runs once per model, on its ``("reference",)`` chain with
its default keywords; every sharded run gives its tokens, and the
sharded run with the same keywords holds its program counts against the
JAX engine's ``jit_cache_size``.  Each group of ranks is spawned once for
all its cases, meets at a FileStore under ``tmp_path``, and is killed if
it does not finish within ``GROUP_S``; a collective waits at most
``torch_mesh_worker.COLLECTIVE_TIMEOUT_S``.  Audio and quantized
serving are refused on a mesh as in the JAX engine."""

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.core.executor import jit_cache_size
from repro.models import get_model as jax_get_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import get_model, params_from_jax
from repro_torch.serving import (SHARDED_FAMILIES, ServingEngine,
                                 UnsupportedFamilyError)

WORKER = Path(__file__).resolve().parent / "torch_mesh_worker.py"
SRC = Path(__file__).resolve().parents[1] / "src"
# model key -> (arch, config fields replaced): the families, and the
# reduced Yi-6B with 6 heads, which only ``replicated`` attention takes
# over 4 ranks
MODELS = {"dense": ("yi-6b", {}), "moe": ("deepseek-moe-16b", {}),
          "ssm": ("mamba2-780m", {}), "hybrid": ("zamba2-1.2b", {}),
          "vlm": ("paligemma-3b", {}), "dense6": ("yi-6b", {"n_heads": 6})}
SLOTS, N_NEW = 2, 6
PROMPT_LENS = (21, 13, 30, 9)
# a group of ranks, all its cases, start to finish
GROUP_S = 240

# (name, model, engine keywords, forced evict/restore); the first case of
# a model has the JAX run's keywords
TWO_RANKS = [
    ("dense", "dense", {}, True),
    ("dense-paged", "dense", {"kv_block": 8}, False),
    ("dense-chunked", "dense", {"prefill_chunk": 8}, True),
    ("dense-overlap", "dense", {"overlap": True}, True),
    ("dense-reference-tags", "dense", {"tags": ("reference",)}, False),
    ("moe", "moe", {}, True),
    ("moe-paged", "moe", {"kv_block": 8}, True),
    ("ssm", "ssm", {}, True),
    ("ssm-chunked", "ssm", {"prefill_chunk": 8}, True),
    ("hybrid", "hybrid", {}, True),
    ("hybrid-chunked", "hybrid", {"prefill_chunk": 8}, False),
    ("vlm", "vlm", {}, True),
    ("vlm-paged", "vlm", {"kv_block": 8}, True),
    ("vlm-chunked", "vlm", {"prefill_chunk": 8}, True),
]
FOUR_RANKS = [
    ("dense", "dense", {}, True),
    ("dense-paged", "dense", {"kv_block": 8}, False),
    ("dense-chunked", "dense", {"prefill_chunk": 8}, False),
    ("dense6", "dense6", {}, True),
    ("dense6-paged", "dense6", {"kv_block": 8}, True),
    ("dense6-chunked", "dense6", {"prefill_chunk": 8}, True),
    ("dense6-overlap", "dense6", {"overlap": True}, False),
]
# the skewed-clock case: an aging priority policy orders the queue by
# how long each request waited, which the ranks' clocks disagree on
SKEW_PRIORITY = {0: 3, 1: 0, 2: 2, 3: 1}


def _cache_len(cfg):
    # the vision prefix takes cache rows in front of the prompt; both
    # lengths divide over 2 and 4 ranks, so sequence mode splits rows
    return 64 + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)


@pytest.fixture(scope="module")
def models():
    """key -> (JAX bundle, JAX params, numpy tree, port config,
    requests (uid, tokens, extras))."""
    out = {}
    for key, (arch, replace) in MODELS.items():
        jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                                   **replace)
        jbundle = jax_get_model(jcfg)
        params = jbundle.init(jax.random.PRNGKey(0))
        cfg = dataclasses.replace(get_config(arch, reduced=True), **replace)
        rng = np.random.default_rng(5)
        reqs = []
        # the dense models also take a one-token prompt (its slot starts
        # from an empty cache, paged too)
        lens = PROMPT_LENS + ((1,) if cfg.family == "dense" else ())
        for uid, n in enumerate(lens):
            toks = rng.integers(0, cfg.vocab - 2, n).astype(np.int32)
            extras = None
            if cfg.family == "vlm":
                extras = {"vision": rng.normal(
                    0, 1, (cfg.n_vision_tokens, cfg.d_vision)
                ).astype(np.float32)}
            reqs.append((uid, toks, extras))
        out[key] = (jbundle, params, jax.tree.map(np.asarray, params), cfg,
                    reqs)
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    """key -> (JAX engine, its tokens): one single-device run a model, on
    the ``("reference",)`` chain with the engine's default keywords."""
    out = {}
    for key, (jbundle, params, _, cfg, reqs) in models.items():
        eng = JaxServingEngine(jbundle, params, max_slots=SLOTS,
                               cache_len=_cache_len(cfg),
                               tags=("reference",))
        for uid, toks, extras in reqs:
            eng.submit(JaxRequest(uid=uid, tokens=toks,
                                  max_new_tokens=N_NEW, extras=extras))
        eng.run()
        out[key] = eng, {uid: eng.results[uid].output for uid, _, _ in reqs}
    return out


def _case(models, name, key, kw, evict, **extra):
    _, _, tree, cfg, reqs = models[key]
    arch, replace = MODELS[key]
    return {"name": name, "arch": arch, "replace": replace, "tree": tree,
            "reqs": reqs, "new": N_NEW, "slots": SLOTS,
            "cache_len": _cache_len(cfg), "kw": kw, "evict": evict, **extra}


def run_group(path: Path, world: int, cases):
    """Serve ``cases`` on a gloo world of ``world`` ranks, one process a
    rank; returns each rank's results, case name -> result.  A group that
    does not finish within ``GROUP_S`` is killed and fails the test."""
    spec = path / "spec.pkl"
    spec.write_bytes(pickle.dumps({"world": world, "cases": cases,
                                   "store": str(path / "store")}))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(spec),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + GROUP_S
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace")[-3000:])
    results = []
    for r, p in enumerate(procs):
        done = Path(f"{spec}.{r}.out")
        res = pickle.loads(done.read_bytes()) if done.exists() else {}
        errors = [v["error"] for v in res.values() if "error" in v]
        if p.returncode != 0 or errors:
            pytest.fail(f"rank {r} of {world} exited {p.returncode}:\n"
                        + "\n".join(errors) + "\n" + logs[r])
        results.append(res)
    return results


@pytest.fixture(scope="module")
def two_ranks(models, tmp_path_factory):
    cases = [_case(models, *c) for c in TWO_RANKS]
    cases.append(_case(models, "host", "dense", {}, False, host=True))
    cases.append(_case(models, "skew", "dense",
                       {"policy": "priority", "prefill_buckets": False},
                       False, skew=True, priority=SKEW_PRIORITY))
    return run_group(tmp_path_factory.mktemp("mesh2"), 2, cases)


@pytest.fixture(scope="module")
def four_ranks(models, tmp_path_factory):
    return run_group(tmp_path_factory.mktemp("mesh4"), 4,
                     [_case(models, *c) for c in FOUR_RANKS])


def _check_case(ranks, jax_runs, name, key, kw, evict):
    jeng, want = jax_runs[key]
    first = ranks[0][name]
    for res in ranks:
        assert res[name]["tokens"] == want, (name, res[name]["tokens"])
        assert res[name]["admitted"] == first["admitted"], name
    assert all(1 <= len(t) <= N_NEW for t in want.values())
    # compile once on a mesh, as on one device
    assert first["decode"] == jit_cache_size(jeng._decode) == 1
    if not kw:          # the JAX run's keywords: its prefill programs
        assert first["prefill"] == jeng.prefill_compiles()
    assert first["chunk"] == (1 if kw.get("prefill_chunk") else 0)
    if kw.get("overlap"):
        assert first["argmax"] == 1
    if kw.get("kv_block"):
        assert first["blocks_back"]
    assert first["evicted"] == evict
    assert first["preemptions"] == int(evict)
    return first


@pytest.mark.parametrize("name,key,kw,evict", TWO_RANKS,
                         ids=[c[0] for c in TWO_RANKS])
def test_two_ranks_give_jax_tokens(two_ranks, jax_runs, name, key, kw,
                                   evict):
    first = _check_case(two_ranks, jax_runs, name, key, kw, evict)
    # reduced vlm has one KV head: its cache rows split over the ranks
    assert first["seq_kv"] == (key == "vlm")


@pytest.mark.parametrize("name,key,kw,evict", FOUR_RANKS,
                         ids=[c[0] for c in FOUR_RANKS])
def test_four_ranks_give_jax_tokens(four_ranks, jax_runs, name, key, kw,
                                    evict):
    first = _check_case(four_ranks, jax_runs, name, key, kw, evict)
    assert first["seq_kv"]          # 2 KV heads over 4 ranks


def test_modes_cover_the_three_combinations(models):
    """The cases above reach heads/kv_heads, heads/sequence and
    replicated/sequence (the policy's decisions at these meshes)."""
    from repro_torch.distributed.sharding import make_policy
    from repro_torch.launch.mesh import Mesh

    def modes(key, m):
        pol = make_policy(models[key][3], Mesh((1, m), ("data", "model")))
        return pol.attn_mode, pol.kv_cache_mode
    assert modes("dense", 2) == ("heads", "kv_heads")
    assert modes("vlm", 2) == ("heads", "sequence")
    assert modes("dense", 4) == ("heads", "sequence")
    assert modes("dense6", 4) == ("replicated", "sequence")


def test_resident_bytes_split(two_ranks, four_ranks, models):
    """A rank holds its share: the KV arena exactly halved (dense's KV
    heads, vlm's rows) or quartered (rows over 4 ranks), and well under
    the single device's weights."""
    for ranks, m, names in ((two_ranks, 2, ("dense", "vlm", "moe")),
                            (four_ranks, 4, ("dense", "dense6"))):
        for name in names:
            cfg = models[name][3]
            bundle = get_model(cfg)
            full_kv = sum(t.numel() * t.element_size() for t in
                          bundle.empty_cache(SLOTS, _cache_len(cfg),
                                             cfg.torch_dtype(),
                                             "meta").values())
            full_w = sum(t.numel() * t.element_size() for t in
                         params_from_jax(models[name][2], cfg,
                                         device="cpu").parameters())
            for res in ranks:
                assert res[name]["kv_bytes"] * m == full_kv, name
                assert res[name]["param_bytes"] < 0.7 * full_w, name


def test_host_on_a_mesh(two_ranks, jax_runs):
    """One MultiTenantHost on the 2-rank group: a sharded tenant and a
    routed tenant of two replicas sharing its shards give the JAX
    engine's tokens, one decode program each."""
    _, want = jax_runs["dense"]
    want = {**want, **{100 + u: t for u, t in want.items()}}
    for res in two_ranks:
        assert res["host"]["tokens"] == want
        assert res["host"]["decode"] == [1, 1, 1]
        assert res["host"]["shared_weights"]


def test_skewed_clocks_decide_alike(two_ranks, jax_runs):
    """Ranks whose clocks disagree by 10^12 µs and tick at rates 10^4
    apart take the same admissions, in the same slots, and give the JAX
    engine's tokens: every decision reads rank 0's clock."""
    _, want = jax_runs["dense"]
    logs = [res["skew"]["admitted"] for res in two_ranks]
    assert logs[0] == logs[1] and len(logs[0]) == len(want)
    for res in two_ranks:
        assert res["skew"]["tokens"] == want


def test_mesh_refusals(models):
    """On a one-rank mesh (a gloo world of one in this process, torn down
    after): audio is refused with the typed error before any sharding is
    computed, and quantized serving with ``ValueError``, as in the JAX
    engine; a world of one holds no 2-rank mesh."""
    assert SHARDED_FAMILIES == ("dense", "moe", "ssm", "hybrid", "vlm")
    if dist.is_initialized():
        pytest.skip("a torch.distributed world is already up here")
    mesh = make_serving_mesh(1, device="cpu")
    try:
        with pytest.raises(ValueError, match="holds 1 ranks"):
            make_serving_mesh(2, device="cpu")
        acfg = get_config("whisper-large-v3", reduced=True)
        abundle = get_model(acfg)
        amodel = abundle.init(torch.Generator("cpu").manual_seed(0))
        with pytest.raises(UnsupportedFamilyError) as ei:
            ServingEngine(abundle, amodel, max_slots=1, cache_len=64,
                          mesh=mesh, device="cpu")
        assert "mesh-sharded serving" in str(ei.value)
        assert ei.value.supported == SHARDED_FAMILIES
        cfg = models["dense"][3]
        bundle = get_model(cfg)
        model = params_from_jax(models["dense"][2], cfg, device="cpu")
        for kw in ({"weight_dtype": "int8"}, {"kv_dtype": "int8"}):
            with pytest.raises(ValueError, match="quantized"):
                ServingEngine(bundle, model, max_slots=1, cache_len=64,
                              mesh=mesh, device="cpu", **kw)
    finally:
        dist.destroy_process_group()
