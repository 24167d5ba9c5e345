"""Mesh-sharded training on the CPU: ``make_train_step(..., mesh=)`` on
gloo worlds of 2 ranks, as ``(data=2, model=1)`` and ``(1, 2)``, and of 4,
as ``(2, 2)``, one process a rank (``tests/torch_train_worker.py``),
against the single-device port on the same weights, for every family
(dense, moe, ssm, hybrid, vlm and audio) at their reduced
configurations, float32.

  * every differentiable collective's gradient (``distributed.
    collectives``) against one device's derivative of the same whole
    tensors, and a missing copy-in giving the replicated leaf a wrong
    gradient; the clip's norm with a leaf split over ``model`` and a
    whole one counted once;
  * each family on each mesh: the loss, metrics and every gradient leaf
    (this rank's slice) of the first batch equal the single-device
    port's, and over ``STEPS`` steps, each from the single-device state
    sliced onto the ranks (``tests/test_torch_training.py``'s parity:
    Adam turns rounding of a near-zero gradient into up to lr), the
    metrics, the moments (linear in the gradient) and the parameters
    after the step; one capture per batch shape, as on one device; DeepSeek on ``model=2`` through
    ``moe_block_ep`` with an all-to-all each way;
  * a world's checkpoint restores on one device bit-equal to the
    gathered state, and one device's restores onto the world; saving
    adds no whole state to a rank that does not write, and restoring
    onto the world adds a rank's share and a leaf or two;
  * the sharded loss on the JAX package's weights equals the JAX
    single-device ``jax.value_and_grad`` loss (``data_shards`` the world's
    data size, so MoE groups line up with the data ranks);
  * the expert-parallel block against the port's and the JAX package's
    ``moe_block(data_shards=1)``, dropless;
  * K/V split by sequence where the heads do not divide over ``model``
    (variants of reduced Yi-6B, PaliGemma, Zamba2 and Whisper with 2 or
    3 heads, with and without sequence parallelism, with a vision
    prefix): the merges ran, and the loss and gradients equal one
    device's; the queries' copy-in dropped gives a wrong gradient;
  * ``launch/train.py --arch whisper-large-v3 --mesh D,M`` on each world
    against the same command on one device; ``ServingEngine(mesh=)``
    still refuses Whisper, and ``shard_params`` a ``model`` axis the
    vocabulary does not divide.

Tolerances are ``tests/test_torch_training.py``'s: losses and
metrics within 1e-5 relative, gradients and moments within 1e-4 of each
leaf's largest entry, parameters within 1e-5 of it but for at most 1% of
a leaf's elements and every element within that + lr / 2.  The port's
init is compared (the JAX init's gradients are ill-conditioned, ROADMAP
queue 3); the JAX weights hold the loss only.

Each world is spawned once for all its cases (both at once), meets at a
FileStore under ``tmp_path``, and is killed if it does not finish within
``GROUP_S``; a collective waits at most
``torch_train_worker.COLLECTIVE_TIMEOUT_S``."""

import contextlib
import io
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models import lm as jax_lm

from repro_torch.configs import get_config
from repro_torch.data import make_batches
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train as train_cli
from repro_torch.models import get_model, params_to_jax

WORKER = Path(__file__).resolve().parent / "torch_train_worker.py"
SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ["yi-6b", "deepseek-moe-16b", "mamba2-780m", "zamba2-1.2b",
         "paligemma-3b", "whisper-large-v3"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4            # of each gradient leaf's largest entry
METRIC_RTOL = 1e-5
PARAM_TOL, PARAM_OUTLIERS = 1e-5, 1e-2
LR = 1e-3
BATCH, SEQ, STEPS = 4, 32, 5
# the expert-parallel block's batch (B, S): 16 tokens a rank at (2, 2)
EP_BATCH, EP_SEQ = 4, 16
# a group of ranks, all its cases, start to finish
GROUP_S = 240
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
# the checkpoint memory case's Yi-6B: 29 M parameters, a state of
# 352 MB whole, no leaf above 1/20 of it
CKPT_MEMORY_CFG = {"n_layers": 4, "d_model": 1024, "d_ff": 1024}
COLLECTIVES = ["all_reduce", "copy_in", "all_gather", "gather_local",
               "reduce_scatter", "split", "all_to_all", "combine"]
# K/V split by sequence: (arch, mesh) -> the reduced config's heads
# replaced so that they do not divide over model (no published config has
# such heads on model <= 4); Yi-6B's and PaliGemma's layers run under
# sequence parallelism, PaliGemma's with its 16-token vision prefix
SPLITS = {
    ("yi-6b", (1, 2)): {"n_heads": 3, "n_kv_heads": 1, "head_dim": 64},
    ("yi-6b", (2, 2)): {"n_heads": 3, "n_kv_heads": 1, "head_dim": 64},
    ("paligemma-3b", (1, 2)): {"n_heads": 3, "n_kv_heads": 1},
    ("zamba2-1.2b", (1, 2)): {"n_heads": 3, "n_kv_heads": 3, "head_dim": 64},
    ("whisper-large-v3", (1, 2)): {"n_heads": 3, "n_kv_heads": 3,
                                   "head_dim": 32},
    ("whisper-large-v3", (1, 4)): {"n_heads": 2, "n_kv_heads": 2,
                                   "head_dim": 64},
}
# the case whose gradients are taken again with the queries' copy-in
# dropped
DROP_Q_COPY_IN = ("yi-6b", (1, 2))
# launch/train.py on each world, against the same command on one device
LAUNCH_ARGV = ["--arch", "whisper-large-v3", "--device", "cpu", "--steps",
               "3", "--batch", "4", "--seq", "32"]


def _random_biases(tree, rng):
    """``tree`` with every bias leaf (``bq``, ``bv``, ``bo``, ``bi`` and
    the LayerNorms' ``*_b``), which Whisper's init zeroes, drawn from
    N(0, 0.1): a bias added once a rank too many, or a rank's block of a
    whole one taken wrongly, then shows in the first step's loss."""
    return {k: _random_biases(v, rng) if isinstance(v, dict)
            else (rng.normal(0, 0.1, v.shape).astype(v.dtype)
                  if k in ("bq", "bv", "bo", "bi") or k.endswith("_b")
                  else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def models():
    """arch -> (port cfg, the port's seed-0 weights as a JAX numpy tree
    (Whisper's biases drawn, ``_random_biases``), the JAX init's weights,
    the batches)."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        bundle = get_model(cfg)
        tree = params_to_jax(bundle.init(torch.Generator().manual_seed(0)),
                             cfg)
        if cfg.family == "audio":
            tree = _random_biases(tree, np.random.default_rng(1))
        jtree = jax.tree.map(np.asarray, jax.jit(jax_get_model(
            jax_get_config(arch, reduced=True)).init)(jax.random.PRNGKey(0)))
        out[arch] = (cfg, tree, jtree, make_batches(cfg, BATCH, SEQ, STEPS,
                                                    seed=0))
    return out


def _ep_input():
    return np.random.default_rng(3).normal(
        0, 1, (EP_BATCH, EP_SEQ, get_config("deepseek-moe-16b",
                                            reduced=True).d_model)
    ).astype(np.float32)


def run_groups(path: Path, groups):
    """Run each group's cases (world size -> cases) on a gloo world of
    that many ranks, one process a rank, every group at once; returns
    world size -> each rank's results, case name -> result.  Groups that
    do not finish within ``GROUP_S`` are killed and fail the test."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = {}
    for world, cases in groups.items():
        spec = path / f"spec{world}.pkl"
        spec.write_bytes(pickle.dumps({
            "world": world, "cases": cases, "store": str(path / f"store{world}"),
            "ckpt": str(path / f"ckpt{world}")}))
        procs[world] = (spec, [subprocess.Popen(
            [sys.executable, str(WORKER), str(spec), str(r)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)])
    deadline = time.monotonic() + GROUP_S
    every = [p for _, ps in procs.values() for p in ps]
    logs = {}
    for p in every:
        try:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in every:
                q.kill()
            out, _ = p.communicate()
        logs[p] = out.decode(errors="replace")[-3000:]
    results = {}
    for world, (spec, ps) in procs.items():
        results[world] = []
        for r, p in enumerate(ps):
            done = Path(f"{spec}.{r}.out")
            res = pickle.loads(done.read_bytes()) if done.exists() else {}
            errors = [v["error"] for v in res.values() if "error" in v]
            if p.returncode != 0 or errors:
                pytest.fail(f"rank {r} of {world} exited {p.returncode}:\n"
                            + "\n".join(errors) + "\n" + logs[p])
            results[world].append(res)
    return results


def _cases(models, world):
    cases = []
    if world == 2:
        cases.append({"name": "collectives", "kind": "collectives",
                      "mesh": (1, 2)})
        cases.append({"name": "ckpt memory", "kind": "ckpt_memory",
                      "mesh": (2, 1), "arch": "yi-6b",
                      "replace": CKPT_MEMORY_CFG})
    for mesh in MESHES[world]:
        for arch in ARCHS:
            cfg, tree, jtree, batches = models[arch]
            cases.append({"name": f"{arch} {mesh}", "kind": "train",
                          "mesh": mesh, "arch": arch, "tree": tree,
                          "jax_tree": jtree, "batches": batches, "lr": LR,
                          "param_tol": PARAM_TOL})
    ep_mesh = MESHES[world][-1]
    cases.append({"name": f"ep {ep_mesh}", "kind": "ep", "mesh": ep_mesh,
                  "arch": "deepseek-moe-16b",
                  "tree": models["deepseek-moe-16b"][1], "x": _ep_input()})
    for (arch, mesh), heads in SPLITS.items():
        if mesh[0] * mesh[1] == world:
            cases.append({"name": f"split {arch} {mesh}", "kind": "split",
                          "mesh": mesh, "arch": arch, "replace": heads,
                          "drop_q_copy_in": (arch, mesh) == DROP_Q_COPY_IN})
    for mesh in MESHES[world]:
        cases.append({"name": f"launch {mesh}", "kind": "launch",
                      "mesh": mesh, "argv": LAUNCH_ARGV + [
                          "--mesh", f"{mesh[0]},{mesh[1]}"]})
    return cases


@pytest.fixture(scope="module")
def worlds(models, tmp_path_factory):
    return run_groups(tmp_path_factory.mktemp("train"),
                      {world: _cases(models, world) for world in MESHES})


@pytest.fixture(scope="module")
def two_ranks(worlds):
    return worlds[2]


@pytest.fixture(scope="module")
def four_ranks(worlds):
    return worlds[4]


def _ranks(request, mesh):
    return request.getfixturevalue(
        "two_ranks" if mesh[0] * mesh[1] == 2 else "four_ranks")


TRAIN = [(arch, mesh) for world in MESHES for mesh in MESHES[world]
         for arch in ARCHS]
TRAIN_IDS = [f"{arch}-{mesh[0]}x{mesh[1]}" for arch, mesh in TRAIN]


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_gradient_is_one_devices(two_ranks, name):
    """Each differentiable collective's backward on a gloo world of 2
    equals one device's derivative of the same global loss (the replicated
    loss's ``all_gather``: its slice, not a reduce-scatter)."""
    for res in two_ranks:
        assert res["collectives"][name] <= 1e-6, (name, res["collectives"])


def test_missing_copy_in_gives_a_wrong_gradient(two_ranks):
    """A whole tensor feeding each rank's own work without the copy-in
    keeps this rank's share of its gradient."""
    for res in two_ranks:
        assert res["collectives"]["missing_copy_in"] > 0.1


def test_clip_counts_a_replicated_leaf_once(two_ranks):
    for res in two_ranks:
        got, want = (res["collectives"]["clip_norm"],
                     res["collectives"]["clip_want"])
        assert abs(got - want) <= 1e-6 * want, (got, want)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh", TRAIN, ids=TRAIN_IDS)
def test_sharded_step_matches_one_device(request, arch, mesh):
    """Loss, metrics and every gradient leaf of the first batch, then the
    metrics, moments (linear in the gradient) and parameters after each
    of ``STEPS`` steps, on every rank; the step is one program per batch
    shape, as on one device; a rank holds its share of the weights."""
    for r, res in enumerate(_ranks(request, mesh)):
        got = res[f"{arch} {mesh}"]
        label = (arch, mesh, r)
        assert got["loss_rel"] <= LOSS_RTOL, (label, got["loss_rel"])
        assert max(got["metric_rel"]) <= METRIC_RTOL, label
        assert got["grad"] <= GRAD_TOL, (label, got["grad"])
        assert max(got["moment"]) <= GRAD_TOL, (label, got["moment"])
        assert max(got["param_abs"]) <= LR / 2, (label, got["param_abs"])
        assert max(got["param_share"]) <= PARAM_OUTLIERS, label
        assert got["steps"] == len(got["moment"]) == STEPS
        assert got["captures"] == got["ref_captures"] == 1
        if arch == "whisper-large-v3":
            # its 8,192 learned decoder positions, over half the reduced
            # model, stay whole on every rank (the JAX policy's spec): a
            # rank holds its share of the leaves the policy splits
            assert got["split_local_bytes"] < 0.75 * \
                got["split_whole_bytes"], label
        else:
            assert got["local_bytes"] < 0.75 * got["whole_bytes"], label


def test_moe_takes_the_expert_parallel_block(two_ranks, four_ranks):
    """DeepSeek on ``model=2``: each MoE layer's forward, its recompute
    and its backward run ``moe_block_ep`` and an all-to-all each way; on
    ``model=1`` neither."""
    for ranks, mesh in ((two_ranks, (1, 2)), (four_ranks, (2, 2))):
        for res in ranks:
            calls = res[f"deepseek-moe-16b {mesh}"]["calls"]
            # one MoE layer: forward + recompute, 2 all-to-alls each, and
            # 2 in backward
            assert calls["moe_block_ep"] == 2, calls
            assert calls["all_to_all"] == 6, calls
    for res in two_ranks:
        calls = res["deepseek-moe-16b (2, 1)"]["calls"]
        assert "moe_block_ep" not in calls and "all_to_all" not in calls


def test_a_recomputed_layer_gathers_again(two_ranks):
    """FSDP on (2, 1): Yi-6B's 2 layers each gather their 7 sharded
    matrices as they start, and again when remat recomputes them in
    backward; without remat the gradients are the same and the layers
    gather once."""
    for res in two_ranks:
        got = res["yi-6b (2, 1)"]
        gathers = got["calls"]["gather_blocks"]
        assert gathers == got["calls_no_remat"]["gather_blocks"] + 2 * 7, \
            got
        assert got["calls"]["reduce_scatter"] == \
            got["calls_no_remat"]["reduce_scatter"]


@pytest.mark.parametrize("arch,mesh", TRAIN, ids=TRAIN_IDS)
def test_checkpoints_cross_between_world_and_one_device(request, arch,
                                                        mesh):
    for res in _ranks(request, mesh):
        got = res[f"{arch} {mesh}"]
        assert got["one_to_world"]
    assert _ranks(request, mesh)[0][f"{arch} {mesh}"]["world_to_one"]


def test_checkpoints_hold_a_ranks_share_and_a_leaf(two_ranks):
    """On (2, 1), FSDP, the resident set a rank adds: saving a sharded
    state adds less than half the whole state to the rank that does not
    write (it gathers one leaf at a time and keeps none; rank 0 holds
    what it writes), and restoring onto the world adds less than the
    rank's share and half the whole state on every rank (no whole
    template, one leaf read at a time); the restored state is bit-equal
    to the saved one.  Gathering the whole state adds all of it (and
    restoring through a whole template twice)."""
    for r, res in enumerate(two_ranks):
        got = res["ckpt memory"]
        assert got["bit_equal"], r
        if r:
            assert got["save_added"] < 0.5 * got["whole_bytes"], got
        assert got["restore_added"] < (got["share_bytes"]
                                       + 0.5 * got["whole_bytes"]), got


@pytest.fixture(scope="module")
def jax_losses(models):
    """(arch, data size) -> the JAX single-device ``value_and_grad``
    loss on the JAX init's weights and the first batch."""
    out = {}
    for arch in ARCHS:
        jbundle = jax_get_model(jax_get_config(arch, reduced=True))
        _, _, jtree, batches = models[arch]
        batch = {k: jnp.asarray(v) for k, v in batches[0].items()}
        params = jax.tree.map(jnp.asarray, jtree)
        for dsz in sorted({m[0] for w in MESHES for m in MESHES[w]}):
            # data_shards reaches the MoE groups only
            if dsz > 1 and not jbundle.cfg.n_experts:
                out[arch, dsz] = out[arch, 1]
                continue
            value_and_grad = jax.jit(jax.value_and_grad(
                lambda p: jbundle.loss(p, batch, remat=False,
                                       data_shards=dsz), has_aux=True))
            (loss, _), _ = value_and_grad(params)
            out[arch, dsz] = float(loss)
    return out


@pytest.mark.parametrize("arch,mesh", TRAIN, ids=TRAIN_IDS)
def test_sharded_loss_on_jax_weights_equals_jax(request, jax_losses, arch,
                                                mesh):
    want = jax_losses[arch, mesh[0]]
    for res in _ranks(request, mesh):
        got = res[f"{arch} {mesh}"]["jax_weights_loss"]
        assert abs(got - want) <= LOSS_RTOL * abs(want), (arch, mesh, got,
                                                          want)


# ---------------------------------------------------------------------------
# the expert-parallel block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_ep_block_matches_moe_block(request, models, mesh):
    """Dropless, ``moe_block_ep`` gathered from the ranks equals the
    port's and the JAX package's ``moe_block(data_shards=1)`` within 1e-4
    relative; its aux loss is the whole batch's (one device's), which the
    mean of each rank's own estimate (the JAX block's) is not."""
    x = _ep_input()
    cfg = get_config("deepseek-moe-16b", reduced=True)
    jcfg = jax_get_config("deepseek-moe-16b", reduced=True)
    assert cfg.capacity_factor * cfg.top_k >= cfg.n_experts    # dropless
    moe = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       models["deepseek-moe-16b"][1]["blocks"]["moe"])
    jy, jaux = jax_lm.moe_block(moe, jcfg, jnp.asarray(x), data_shards=1)
    jy = np.asarray(jy)
    for res in _ranks(request, mesh):
        got = res[f"ep {mesh}"]
        assert got["applicable"]
        top = np.abs(got["want"]).max()
        assert np.abs(got["y"] - got["want"]).max() <= 1e-4 * top
        assert np.abs(got["y"] - jy).max() <= 1e-4 * np.abs(jy).max()
        assert abs(got["aux"] - got["want_aux"]) <= 1e-5 * got["want_aux"]
        assert abs(got["aux"] - float(jaux)) <= 1e-5 * float(jaux)
        assert abs(got["mean_own_aux"] - got["aux"]) > 1e-4


# ---------------------------------------------------------------------------
# K/V split by sequence
# ---------------------------------------------------------------------------

SPLIT_IDS = [f"{arch}-{mesh[0]}x{mesh[1]}" for arch, mesh in SPLITS]


@pytest.mark.parametrize("arch,mesh", list(SPLITS), ids=SPLIT_IDS)
def test_kv_sequence_split_matches_one_device(request, arch, mesh):
    """Heads that do not divide over ``model``: the step's context splits
    K/V by sequence, every attention layer's forward and its recompute
    merge their partials (``collectives.combine``), and the loss and
    every gradient leaf equal one device's."""
    for r, res in enumerate(_ranks(request, mesh)):
        got = res[f"split {arch} {mesh}"]
        label = (arch, mesh, r)
        assert got["kv_seq"], label
        assert got["seq_parallel"] == (arch in ("yi-6b", "paligemma-3b"))
        assert got["combines"] >= 2, (label, got["combines"])
        assert got["loss_rel"] <= LOSS_RTOL, (label, got["loss_rel"])
        assert got["grad"] <= GRAD_TOL, (label, got["grad"])


def test_heads_that_divide_take_no_split(two_ranks, four_ranks):
    """On the reduced configurations every head count divides over
    ``model`` <= 2: attention is split by heads and nothing merges."""
    for ranks in (two_ranks, four_ranks):
        for res in ranks:
            for name, got in res.items():
                if "calls" in got:
                    assert "combine" not in got["calls"], name


def test_missing_q_copy_in_gives_a_wrong_gradient(request):
    """Under the split the queries, whole on every rank, feed every
    rank's partial: without their copy-in a rank keeps only its own
    partial's share of their gradient."""
    arch, mesh = DROP_Q_COPY_IN
    for res in _ranks(request, mesh):
        got = res[f"split {arch} {mesh}"]
        assert got["grad"] <= GRAD_TOL
        assert got["grad_no_q_copy_in"] > 0.1, got["grad_no_q_copy_in"]


# ---------------------------------------------------------------------------
# Whisper through the command line; what a mesh refuses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def launch_one_device():
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        train_cli.main(LAUNCH_ARGV)
    return json.loads(printed.getvalue().splitlines()[-1])


@pytest.mark.parametrize("mesh", [m for w in MESHES for m in MESHES[w]],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_train_command_line_trains_whisper_on_a_mesh(request,
                                                     launch_one_device,
                                                     mesh):
    """``launch/train.py --arch whisper-large-v3 --mesh D,M`` on a gloo
    world, one process a rank: every rank runs its steps, and rank 0's
    final loss after 3 steps is one device's."""
    ranks = _ranks(request, mesh)
    assert all(res[f"launch {mesh}"]["done"] for res in ranks)
    got = ranks[0][f"launch {mesh}"]["summary"]
    want = launch_one_device
    assert got["steps"] == want["steps"] == 3
    assert np.isfinite(got["final_loss"])
    assert abs(got["final_loss"] - want["final_loss"]) <= \
        LOSS_RTOL * abs(want["final_loss"]), (got, want)


def test_whisper_shards_for_training_but_not_for_serving():
    """On a one-rank mesh (a gloo world of one in this process, torn down
    after): ``shard_params`` shards Whisper, ``ServingEngine(mesh=)``
    still refuses it with the typed error; a ``model`` axis the padded
    vocabulary does not divide is refused with a ``ValueError`` naming
    the vocabulary."""
    from repro_torch.serving import (SHARDED_FAMILIES, ServingEngine,
                                     UnsupportedFamilyError)
    if torch.distributed.is_initialized():
        pytest.skip("a torch.distributed world is already up here")
    cfg = get_config("whisper-large-v3", reduced=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    three = port_mesh.Mesh((1, 3), ("data", "model"),
                           coords={"data": 0, "model": 0},
                           groups={"model": None})
    with pytest.raises(ValueError, match="vocabulary of 512 .padded to "
                                         "2048 rows. does not divide over "
                                         "model=3"):
        sharding.shard_params(model, three)
    mesh = port_mesh.make_serving_mesh(1, device="cpu")
    try:
        local = sharding.shard_params(model, mesh, fsdp=True)
        assert local.tp.split and local.decoder[0].xattn.tp.split
        assert "audio" not in SHARDED_FAMILIES
        with pytest.raises(UnsupportedFamilyError) as ei:
            ServingEngine(bundle, model, max_slots=1, cache_len=64,
                          mesh=mesh, device="cpu")
        assert "mesh-sharded serving" in str(ei.value)
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# without processes
# ---------------------------------------------------------------------------

def test_activation_functions_are_the_identity_without_a_context():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert acts.current() is None
    for fn in (acts.shard_act, acts.shard_logits, acts.shard_seq,
               acts.unshard_seq, acts.shard_expert, acts.shard_group,
               acts.shard_heads, acts.shard_kv):
        assert fn(x) is x
    assert acts.gather_expert_weights(x, 1) is x
    assert acts.seq_param(x) is x
    assert acts.enter(x, None) is x and acts.leave(x, None) is x
    block = torch.nn.Linear(2, 2)
    assert acts.gathered(block) is block


def test_recompute_sees_the_forwards_context_on_another_thread():
    """On the card autograd runs backward, and so a rematerialized
    layer's recompute, on a thread of its own: ``lm.checkpointed`` hands
    the recompute the forward's activation-sharding context."""
    import threading

    from repro_torch.models import lm
    mesh = port_mesh.Mesh((1, 1), ("data", "model"),
                          coords={"data": 0, "model": 0},
                          groups={"model": None})
    seen = []

    def fn(x):
        seen.append(acts.current())
        return x * x

    x = torch.ones(3, requires_grad=True)
    with acts.activation_sharding(mesh, batch_divisible=True) as ctx:
        y = lm.checkpointed(fn, x).sum()
    grads = []
    worker = threading.Thread(target=lambda: grads.append(
        torch.autograd.grad(y, x)[0]))
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive() and grads[0].tolist() == [2.0] * 3
    assert seen == [ctx, ctx] and acts.current() is None


def test_shard_batch_takes_each_micro_batchs_rows():
    """Micro-batch i of a rank's rows is its block of the global batch's
    micro-batch i (the JAX step's reshape of a data-sharded batch)."""
    rows = np.arange(8)[:, None] * np.ones((1, 3), np.int64)
    for rank in range(2):
        mesh = port_mesh.Mesh((2, 1), ("data", "model"),
                              coords={"data": rank, "model": 0},
                              groups={})
        got = sharding.shard_batch({"tokens": rows}, mesh, grad_accum=2)
        assert got["tokens"][:, 0].tolist() == (
            [0, 1, 4, 5] if rank == 0 else [2, 3, 6, 7])
        one = sharding.shard_batch({"tokens": torch.from_numpy(rows)}, mesh)
        assert one["tokens"][:, 0].tolist() == list(range(4 * rank,
                                                          4 * rank + 4))
        with pytest.raises(ValueError, match="do not divide"):
            sharding.shard_batch({"tokens": rows[:6]}, mesh, grad_accum=2)


def test_make_mesh_needs_the_world():
    if torch.distributed.is_initialized():
        pytest.skip("a torch.distributed world is already up here")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        port_mesh.make_mesh((2, 2))
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        port_mesh.make_production_mesh(multi_pod=True, abstract=False)
    assert port_mesh.make_production_mesh().abstract
