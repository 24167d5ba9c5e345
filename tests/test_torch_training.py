"""The port's training path on the CPU, held against the JAX package on
the same numpy-seeded inputs.

  * ``adamw_update``, ``clip_by_global_norm`` and ``cosine_schedule``
    against the JAX functions over several steps, float32 and bfloat16
    leaves and a 1-D one (no decay), rtol 1e-6;
  * each family's ``loss`` and its gradients (one reduced configuration
    per family) against ``jax.value_and_grad`` of the JAX loss, and
    ``remat=True`` against ``remat=False`` in the port;
  * ``make_train_step`` against JAX's jitted step over 5 steps (with
    ``grad_accum=2``, and on MoE with its aux loss), its capture count
    against the jit cache size;
  * ``PackedLMDataset`` batches bit-identical to the JAX package's;
  * checkpoints: a port round trip, and each package restoring the
    other's;
  * ``launch/train.py --device cpu``, and the kernel wrappers' refusal of
    a differentiated input.

Tolerances.  The losses agree within 1e-5 relative and each gradient leaf
within 1e-4 of its largest entry on the port's initial weights carried to
the JAX package (``params_to_jax``).  The JAX init draws the stacked
(L, ...) leaves with fan-in L (ROADMAP queue 3), which makes its
attention nearly one-hot: on those weights a 1e-7 relative change of the
weights moves the JAX gradients by more than 1e-4 of their largest entry,
on the port's per-leaf fan-in weights by less than 1e-5
(``test_jax_init_gradients_are_ill_conditioned``), so the gradients are
compared on the port's weights and the JAX weights hold the loss only.  Adam divides
by sqrt(v) + 1e-8: an element whose gradient is within float32 rounding
of that scale takes a step that is a fraction of lr set by the rounding,
so after a step the parameters agree within 1e-5 of each leaf's largest
entry but for at most 1% of its elements (at least 1), and every
element within that + lr / 2; the moments, linear in the gradient, are
held like gradients.  Each step starts both packages from the same state
(the JAX state carried into the port), so no rounding compounds.
"""

import dataclasses
import io
import json
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.data import PackedLMDataset as JaxPackedLMDataset
from repro.models import get_model as jax_get_model
from repro.models import lm as jax_lm
from repro.training import (adamw_init as jax_adamw_init,
                            adamw_update as jax_adamw_update,
                            clip_by_global_norm as jax_clip,
                            cosine_schedule as jax_cosine)
from repro.training.trainer import init_train_state as jax_init_state
from repro.training.trainer import make_train_step as jax_make_step

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import capture_count
from repro_torch.data import PackedLMDataset, make_batches
from repro_torch.distributed.sharding import param_sharding
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import (get_model, lm, params_from_jax,
                                params_to_jax)
from repro_torch.models.registry import jax_tree
from repro_torch.training import (adamw_init, adamw_update,
                                  clip_by_global_norm, cosine_schedule,
                                  init_train_state, make_train_step,
                                  train_state_sharding)

FAMILY_ARCHS = ["yi-6b", "deepseek-moe-16b", "mamba2-780m", "zamba2-1.2b",
                "paligemma-3b", "whisper-large-v3"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4            # of each gradient leaf's largest entry
METRIC_RTOL = 1e-5
PARAM_TOL, PARAM_OUTLIERS = 1e-5, 1e-2
OPT_RTOL = 1e-6
LR = 1e-3
BATCH, SEQ = 4, 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module's torch work on one intra-op thread (the suite's
    parallel workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_weights(arch):
    """(port cfg, bundle, the port's seed-0 weights as a JAX numpy tree)."""
    cfg = get_config(arch, reduced=True)
    bundle = get_model(cfg)
    return cfg, bundle, params_to_jax(bundle.init(
        torch.Generator().manual_seed(0)), cfg)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _walk(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _leaf_pairs(got_tree, want_tree):
    """(key path, port numpy leaf, JAX numpy leaf) over the JAX tree."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
        yield (jax.tree_util.keystr(path), np.asarray(_walk(got_tree, path),
                                                      np.float32),
               np.asarray(leaf, np.float32))


def _port_grads(bundle, model, batch, remat):
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss, metrics = bundle.loss(model, _t(batch), remat=remat, data_shards=1)
    grads = torch.autograd.grad(loss, list(named.values()))
    for p in named.values():
        p.requires_grad_(False)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(named, grads)))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def test_adamw_matches_jax_over_steps():
    """Float32 and bfloat16 matrices and a 1-D leaf (no decay), a scalar
    and a scheduled learning rate, 4 steps from the same gradients."""
    rng = np.random.default_rng(0)
    shapes = {"w": ((6, 5), np.float32), "h": ((4, 8), "bfloat16"),
              "b": ((7,), np.float32)}
    init = {n: rng.normal(0, 0.5, s).astype(np.float32)
            for n, (s, _) in shapes.items()}
    grads = [{n: rng.normal(0, 1e-2, s).astype(np.float32)
              for n, (s, _) in shapes.items()} for _ in range(4)]
    for lr in (2e-2, "cosine"):
        jp = {n: jnp.asarray(v, jnp.bfloat16 if shapes[n][1] == "bfloat16"
                             else jnp.float32) for n, v in init.items()}
        tp = {n: torch.from_numpy(v).to(torch.bfloat16 if shapes[n][1] ==
                                        "bfloat16" else torch.float32)
              for n, v in init.items()}
        jstate, tstate = jax_adamw_init(jp), adamw_init(tp.items())
        jlr = jax_cosine(2e-2, 2, 4) if lr == "cosine" else lr
        tlr = cosine_schedule(2e-2, 2, 4) if lr == "cosine" else lr
        for g in grads:
            jg = {n: jnp.asarray(v, jp[n].dtype) for n, v in g.items()}
            tg = {n: torch.from_numpy(v).to(tp[n].dtype) for n, v in g.items()}
            jp, jstate = jax_adamw_update(jg, jstate, jp, lr=jlr)
            adamw_update(tg, tstate, tp, lr=tlr)
            assert int(tstate.step) == int(jstate.step)
            for n in shapes:
                np.testing.assert_allclose(tp[n].float().numpy(),
                                           np.asarray(jp[n], np.float32),
                                           rtol=OPT_RTOL)
                np.testing.assert_allclose(tstate.mu[n].numpy(),
                                           np.asarray(jstate.mu[n]),
                                           rtol=OPT_RTOL)
                np.testing.assert_allclose(tstate.nu[n].numpy(),
                                           np.asarray(jstate.nu[n]),
                                           rtol=OPT_RTOL)
        assert tstate.mu["h"].dtype == torch.float32


def test_decay_follows_the_jax_leaves():
    """A layer's norm gain is stacked (L, D) in the JAX tree, so it is
    decayed there; the final norm and the hybrid's shared block's gains
    are 1-D and are not."""
    from repro_torch.training.optimizer import decays
    v = torch.zeros(8)
    assert decays("layers.0.ln1", v) and decays("first_block.ln2", v)
    assert decays("decoder.1.attn.bo", v)
    assert not decays("final_norm", v) and not decays("shared.ln1", v)
    assert decays("embed", torch.zeros(4, 8))


def test_clip_and_cosine_schedule_match_jax():
    rng = np.random.default_rng(1)
    g = {"a": rng.normal(0, 3, (5, 4)).astype(np.float32),
         "b": rng.normal(0, 3, (9,)).astype(np.float32)}
    for max_norm in (1.0, 100.0):
        jc, jn = jax_clip({k: jnp.asarray(v) for k, v in g.items()},
                          max_norm)
        tc, tn = clip_by_global_norm({k: torch.from_numpy(v)
                                      for k, v in g.items()}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_RTOL)
        for k in g:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=OPT_RTOL)
    jlr, tlr = jax_cosine(1e-3, 10, 100), cosine_schedule(1e-3, 10, 100)
    for s in range(0, 101):
        np.testing.assert_allclose(
            float(tlr(torch.tensor(s, dtype=torch.int32))),
            float(jlr(jnp.asarray(s, jnp.int32))), rtol=OPT_RTOL)


# ---------------------------------------------------------------------------
# each family's loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jcfg = jax_get_config(arch, reduced=True)
    jbundle = jax_get_model(jcfg)
    cfg, bundle, tree = _port_weights(arch)
    batch = JaxPackedLMDataset(jcfg, 2, SEQ, seed=0).next_batch()

    def jloss(p):
        return jbundle.loss(p, _j(batch), remat=False, data_shards=1)
    value_and_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    (jl, jm), jg = value_and_grad(jax.tree.map(jnp.asarray, tree))
    model = params_from_jax(tree, cfg, device="cpu")
    loss, metrics, grads = _port_grads(bundle, model, batch, remat=False)
    assert sorted(metrics) == sorted(jm)
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for k in jm:
        assert abs(float(metrics[k]) - float(jm[k])) <= \
            LOSS_RTOL * max(abs(float(jm[k])), 1e-30)
    got = jax_tree(grads.items())
    for name, g, w in _leaf_pairs(got, jg):
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), name
    # the port's remat recomputes the same operations
    loss_r, _, grads_r = _port_grads(bundle, model, batch, remat=True)
    assert torch.equal(loss_r, loss)
    for n, g in grads.items():
        assert torch.equal(grads_r[n], g), n
    # the JAX package's own weights (ill-conditioned gradients): the loss
    jtree = jax.jit(jbundle.init)(jax.random.PRNGKey(0))
    (jl2, _), _ = value_and_grad(jtree)
    l2, _ = bundle.loss(params_from_jax(jax.tree.map(np.asarray, jtree), cfg,
                                        device="cpu"), _t(batch),
                        remat=True, data_shards=1)
    assert abs(float(l2) - float(jl2)) <= LOSS_RTOL * abs(float(jl2))


def test_jax_init_gradients_are_ill_conditioned():
    """Why the gradients are compared on the port's weights: a 1e-7
    relative change of the JAX init's weights moves the JAX gradients by
    more than 1e-4 of a leaf's largest entry (the comparison's bar), and
    of the port's per-leaf fan-in weights by less than 1e-5."""
    arch = "yi-6b"
    jbundle = jax_get_model(jax_get_config(arch, reduced=True))
    _, _, tree = _port_weights(arch)
    batch = _j(JaxPackedLMDataset(jax_get_config(arch, reduced=True), 2,
                                  SEQ, seed=0).next_batch())
    grad = jax.jit(jax.grad(lambda p: jbundle.loss(
        p, batch, remat=False, data_shards=1)[0]))
    rng = np.random.default_rng(1)

    def moved(params):
        noisy = jax.tree.map(lambda a: a * (1 + 1e-7 * rng.standard_normal(
            a.shape).astype(np.float32)), params)
        return max(float(jnp.abs(a - b).max() / jnp.abs(a).max())
                   for a, b in zip(jax.tree.leaves(grad(params)),
                                   jax.tree.leaves(grad(noisy))))

    assert moved(jax.jit(jbundle.init)(jax.random.PRNGKey(0))) > GRAD_TOL
    assert moved(jax.tree.map(jnp.asarray, tree)) < GRAD_TOL / 10


def test_cross_entropy_matches_jax():
    from repro.models.common import cross_entropy_loss as jax_ce

    from repro_torch.models.common import cross_entropy_loss
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 4, (3, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = (rng.uniform(size=(3, 5)) > 0.3).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                      None if m is None else jnp.asarray(m))
        got = cross_entropy_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_moe_groups_take_data_shards():
    for n in (1024, 16 * 1024):
        for shards in (1, 4, 16):
            assert lm.moe_groups(n, shards) == jax_lm.moe_groups(n, shards)
    assert lm.moe_groups(16 * 1024) == jax_lm.moe_groups(16 * 1024) == 16


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _carry(state, jstate):
    """The JAX TrainState's values into the port's tensors, in place."""
    with torch.no_grad():
        lm.load_jax_tree(state.params, jax.tree.map(np.asarray,
                                                    jstate.params))
        for tree, dst in ((jstate.opt.mu, state.opt.mu),
                          (jstate.opt.nu, state.opt.nu)):
            for n, t in dst.items():
                node, i = lm.jax_leaf(tree, n)
                t.copy_(torch.from_numpy(np.array(
                    np.asarray(node if i is None else node[i]))))
        state.opt.step.fill_(int(jstate.opt.step))


def _check_leaves(label, got_tree, want_tree, tol, slack=0.0, outliers=None):
    for name, g, w in _leaf_pairs(got_tree, want_tree):
        top = np.abs(w).max() or 1.0
        d = np.abs(g - w)
        assert d.max() <= tol * top + slack, (label, name, d.max(), top)
        if outliers is not None:
            assert (d > tol * top).sum() <= max(outliers * d.size, 1), \
                (label, name, int((d > tol * top).sum()), d.size)


@pytest.mark.parametrize("arch,grad_accum", [("yi-6b", 1), ("yi-6b", 2),
                                             ("deepseek-moe-16b", 1)])
def test_train_step_matches_jax(arch, grad_accum):
    """5 steps on the same batches, each from the JAX state carried into
    the port; the capture count equals the jit cache size."""
    jbundle = jax_get_model(jax_get_config(arch, reduced=True))
    cfg, bundle, tree = _port_weights(arch)
    jstate = jax_init_state(jax.tree.map(jnp.asarray, tree))
    jstep = jax.jit(jax_make_step(jbundle.loss, lr=LR, grad_accum=grad_accum,
                                  remat=False, data_shards=1))
    state = init_train_state(params_from_jax(tree, cfg, device="cpu"))
    step = make_train_step(bundle.loss, lr=LR, grad_accum=grad_accum,
                           remat=True, data_shards=1)
    for i, batch in enumerate(make_batches(cfg, BATCH, SEQ, 5, seed=0)):
        _carry(state, jstate)
        jstate, jm = jstep(jstate, _j(batch))
        same, m = step(state, batch)
        assert same is state and sorted(m) == sorted(jm)
        for k in jm:
            assert abs(float(m[k]) - float(jm[k])) <= \
                METRIC_RTOL * max(abs(float(jm[k])), 1e-30), (i, k)
        for mom in ("mu", "nu"):
            _check_leaves(f"step {i} {mom}",
                          jax_tree(getattr(state.opt, mom).items()),
                          getattr(jstate.opt, mom), GRAD_TOL)
        _check_leaves(f"step {i}", params_to_jax(state.params, cfg),
                      jstate.params, PARAM_TOL, slack=LR / 2,
                      outliers=PARAM_OUTLIERS)
    assert "aux_loss" in m or grad_accum > 1
    assert capture_count(step.program) == jstep._cache_size() == 1


def test_capture_count_follows_batch_shapes():
    cfg = get_config("yi-6b", reduced=True)
    bundle = get_model(cfg)
    jbundle = jax_get_model(jax_get_config("yi-6b", reduced=True))
    jstep = jax.jit(jax_make_step(jbundle.loss, lr=LR, remat=False,
                                  data_shards=1))
    jstate = jax_init_state(jax.jit(jbundle.init)(jax.random.PRNGKey(0)))
    state = init_train_state(bundle.init(torch.Generator().manual_seed(0)))
    step = make_train_step(bundle.loss, lr=LR, remat=False, data_shards=1)
    for seq in (16, 16, 16, 8, 8, 16):
        batch = make_batches(cfg, 2, seq, 1)[0]
        state, _ = step(state, batch)
        jstate, _ = jstep(jstate, _j(batch))
        assert capture_count(step.program) == jstep._cache_size()
    assert capture_count(step.program) == 2
    assert int(state.opt.step) == 6
    # the TrainState sharding tree: moments mirror the parameters, the
    # step replicated (the JAX package's train_state_sharding)
    mesh = make_production_mesh()
    p_shard = param_sharding(cfg, mesh, state.params)
    s_shard = train_state_sharding(p_shard, mesh)
    assert s_shard.params is p_shard
    assert s_shard.opt.mu is p_shard and s_shard.opt.nu is p_shard
    assert s_shard.opt.step.spec == () and s_shard.opt.step.mesh is mesh


# ---------------------------------------------------------------------------
# data, batches, parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "paligemma-3b",
                                  "whisper-large-v3"])
def test_packed_batches_bit_identical(arch):
    ours = PackedLMDataset(get_config(arch, reduced=True), 3, 48, seed=5)
    theirs = JaxPackedLMDataset(jax_get_config(arch, reduced=True), 3, 48,
                                seed=5)
    for _ in range(3):
        a, b = ours.next_batch(), theirs.next_batch()
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    np.testing.assert_array_equal(ours.source.successors,
                                  theirs.source.successors)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batch_shapes_make_batch_and_trees_match_jax(arch):
    """``batch_shapes``/``make_batch`` against the JAX bundle's; and
    ``params_to_jax`` the exact inverse of ``params_from_jax``, in the
    JAX init's tree structure and shapes."""
    jbundle = jax_get_model(jax_get_config(arch, reduced=True))
    cfg = get_config(arch, reduced=True)
    bundle = get_model(cfg)
    for mode in ("train", "prefill", "decode"):
        want = jbundle.batch_shapes(mode, 2, 40)
        got = bundle.batch_shapes(mode, 2, 40)
        assert sorted(got) == sorted(want)
        for k, spec in got.items():
            assert spec.shape == want[k].shape, (mode, k)
            assert str(spec.dtype).split(".")[-1] == str(want[k].dtype)
        a = bundle.make_batch(np.random.default_rng(3), mode, 2, 40,
                              device="cpu")
        b = jbundle.make_batch(np.random.default_rng(3), mode, 2, 40)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    model = bundle.init(torch.Generator().manual_seed(1))
    tree = params_to_jax(model, cfg)
    shapes = jax.eval_shape(jbundle.init, jax.random.PRNGKey(0))
    assert (jax.tree.structure(tree) == jax.tree.structure(shapes))
    for (_, x), (_, s) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                              jax.tree_util.tree_flatten_with_path(shapes)[0]):
        assert x.shape == s.shape
    back = params_from_jax(tree, cfg, device="cpu")
    for (n, p), (_, q) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(ValueError):
        params_to_jax(model, get_config("qwen3-32b", reduced=True))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _bits(t):
    return t.view({torch.bfloat16: torch.int16,
                   torch.float32: torch.int32}.get(t.dtype, t.dtype))


def _trained_state(cfg, bundle, steps=2):
    state = init_train_state(bundle.init(torch.Generator().manual_seed(0)))
    step = make_train_step(bundle.loss, lr=LR, remat=False, data_shards=1)
    for batch in make_batches(cfg, 2, 16, steps, seed=1):
        step(state, batch)
    return state


def test_checkpoint_round_trip(tmp_path):
    """A bf16 TrainState: every leaf bit-equal after save and restore;
    strict refuses a missing leaf, strict=False keeps the given one."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b", reduced=True),
                              dtype="bfloat16")
    bundle = get_model(cfg)
    state = _trained_state(cfg, bundle)
    out = save_checkpoint(str(tmp_path), 7, state)
    manifest = json.loads((tmp_path / "7" / "manifest.json").read_text())
    assert manifest[".params/embed"]["dtype"] == "bfloat16"
    assert manifest[".opt/.step"] == {"shape": [], "dtype": "int32",
                                      "file": "shard_0.npz",
                                      "entry": "__opt____step"}
    assert manifest[".params/blocks/moe/experts/wi"]["shape"][0] == \
        cfg.n_layers - 1
    back = restore_checkpoint(str(tmp_path), 7, state, device="cpu")
    pairs = list(zip(state.params.parameters(), back.params.parameters()))
    pairs += [(state.opt.mu[n], back.opt.mu[n]) for n in state.opt.mu]
    pairs += [(state.opt.nu[n], back.opt.nu[n]) for n in state.opt.nu]
    pairs.append((state.opt.step, back.opt.step))
    for a, b in pairs:
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    del manifest[".opt/.mu/embed"]
    (tmp_path / "7" / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(KeyError, match="embed"):
        restore_checkpoint(str(tmp_path), 7, state, device="cpu")
    loose = restore_checkpoint(str(tmp_path), 7, state, device="cpu",
                               strict=False)
    assert torch.equal(loose.opt.mu["embed"], state.opt.mu["embed"])
    assert out.endswith("7")


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A JAX-written TrainState (after one step) restored in the port:
    leaves bit-equal, and the port's loss on it is the JAX loss."""
    arch = "yi-6b"
    jbundle = jax_get_model(jax_get_config(arch, reduced=True))
    cfg, bundle, tree = _port_weights(arch)
    jstate = jax_init_state(jax.tree.map(jnp.asarray, tree))
    batches = make_batches(cfg, 2, 16, 2, seed=2)
    jstate, _ = jax.jit(jax_make_step(jbundle.loss, lr=LR, remat=False,
                                      data_shards=1))(jstate, _j(batches[0]))
    jax_save(str(tmp_path), 1, jstate)
    like = init_train_state(bundle.init(torch.Generator().manual_seed(5)))
    state = restore_checkpoint(str(tmp_path), 1, like, device="cpu")
    assert int(state.opt.step) == 1
    _check_leaves("params", params_to_jax(state.params, cfg),
                  jstate.params, 0.0)
    _check_leaves("mu", jax_tree(state.opt.mu.items()), jstate.opt.mu, 0.0)
    want, _ = jbundle.loss(jstate.params, _j(batches[1]), remat=False,
                           data_shards=1)
    got, _ = bundle.loss(state.params, _t(batches[1]), remat=False,
                         data_shards=1)
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A port-written bf16 TrainState restored by the JAX
    ``restore_checkpoint``: every leaf bit-equal."""
    arch = "mamba2-780m"
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="bfloat16")
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               dtype="bfloat16")
    bundle = get_model(cfg)
    state = _trained_state(cfg, bundle)
    save_checkpoint(str(tmp_path), 2, state)
    like = jax_init_state(jax.jit(jax_get_model(jcfg).init)(
        jax.random.PRNGKey(0)))
    back = jax_restore(str(tmp_path), 2, like)
    assert int(back.opt.step) == 2
    for got_tree, jtree in ((state.params.named_parameters(), back.params),
                            (state.opt.mu.items(), back.opt.mu),
                            (state.opt.nu.items(), back.opt.nu)):
        named = dict(got_tree)
        for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
            parts = lm.jax_layout(named.items())["/".join(
                k.key for k in path)]
            want = torch.stack(parts[0]) if parts[1] else parts[0][0]
            arr = np.asarray(leaf)
            if want.dtype == torch.bfloat16:
                assert arr.dtype.name == "bfloat16"
            arr = arr.view({2: np.int16, 4: np.int32}[arr.itemsize])
            np.testing.assert_array_equal(arr, _bits(want).numpy())


# ---------------------------------------------------------------------------
# the command line and the kernel guard
# ---------------------------------------------------------------------------

def test_train_command_line_learns_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli.main(["--device", "cpu", "--steps", "30"])
    lines = out.getvalue().splitlines()
    first = float(lines[0].split("loss=")[1].split()[0])
    summary = json.loads(lines[-1])
    assert sorted(summary) == ["final_loss", "steps", "wall_s"]
    assert summary["steps"] == 30
    assert summary["final_loss"] <= first - 0.5, (first, summary)
    # the production meshes need their worlds: 256 ranks, 512 multi-pod
    for flag, ranks in (("--production-mesh", 256), ("--multi-pod", 512)):
        with pytest.raises(ValueError, match=f"world of {ranks} ranks"):
            train_cli.main(["--device", "cpu", flag])
    assert not torch.distributed.is_initialized()


def _meta(*shape, grad=False, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype).requires_grad_(grad)


@pytest.mark.parametrize("wrapper", ["flash_attention", "decode_attention",
                                     "paged_decode_attention", "ssd_scan"])
def test_kernel_wrappers_refuse_a_differentiated_input(wrapper):
    """A non-CPU tensor that requires grad, with grad enabled, is refused
    before any launch (the meta device stands in for the card here)."""
    calls = {
        "flash_attention": lambda g: ops.flash_attention(
            _meta(1, 2, 8, 4, grad=g), _meta(1, 2, 8, 4), _meta(1, 2, 8, 4)),
        "decode_attention": lambda g: ops.decode_attention(
            _meta(1, 2, 4, grad=g), _meta(1, 2, 8, 4), _meta(1, 2, 8, 4),
            _meta(1, dtype=torch.int32)),
        "paged_decode_attention": lambda g: ops.paged_decode_attention(
            _meta(1, 2, 4, grad=g), _meta(3, 2, 16, 4), _meta(3, 2, 16, 4),
            _meta(1, 2, dtype=torch.int32), _meta(1, dtype=torch.int32)),
        "ssd_scan": lambda g: ops.ssd_scan(
            _meta(1, 8, 2, 4, grad=g), _meta(1, 8, 2), _meta(2),
            _meta(1, 8, 1, 4), _meta(1, 8, 1, 4), chunk=8),
    }
    with pytest.raises(ops.NoBackwardError, match=wrapper):
        calls[wrapper](True)
    # without grad the same call passes the guard and reaches the
    # kernel's own check, which wants the card
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="needs CUDA tensors"):
        calls[wrapper](True)
