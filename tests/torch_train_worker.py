"""One rank of a CPU training mesh, for ``tests/test_torch_sharded_training.py``.

    python tests/torch_train_worker.py SPEC RANK

``SPEC`` is a pickle written by the test: the world size, a FileStore
path for the rendezvous, a directory for checkpoints, and the cases to
run, each on a mesh of the world: ``collectives`` (each differentiable
collective's gradient against one device's derivative of the same
whole tensors, and the clip's norm), ``train`` (a reduced architecture's
sharded loss, metrics and gradients against the single-device port's,
the steps' parameters, the capture counts, the checkpoints both ways and
the loss on the JAX package's weights), ``split`` (a variant whose heads
do not divide over ``model``: K/V split by sequence, the loss and
gradients against the single-device port's, the merges counted, and the
gradients with the queries' copy-in dropped), ``launch``
(``launch/train.py --mesh`` on this world), ``ep`` (``moe_block_ep``
against ``moe_block(data_shards=1)``) and ``ckpt_memory`` (the host
memory a rank adds while a sharded state is saved and restored onto
the world).  The single-device references run
in the rank's own process on the same weights.  The rank joins a gloo
world (one torch thread, collectives time out) and appends each case's
numbers to ``SPEC.RANK.out`` as it finishes; a case that raises writes
its traceback there and ends the rank with exit code 1.  This module
imports no jax.
"""

import contextlib
import copy
import dataclasses
import datetime
import gc
import io
import json
import os
import pickle
import sys
import threading
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import (gather_tree,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import capture_count  # noqa: E402
from repro_torch.data import make_batches  # noqa: E402
from repro_torch.distributed import act_sharding as acts  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed.sharding import (shard_batch,  # noqa: E402
                                              shard_local, shard_params)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import get_model, lm, params_from_jax  # noqa: E402
from repro_torch.models import moe_ep  # noqa: E402
from repro_torch.models.registry import empty_model  # noqa: E402
from repro_torch.training import (clip_by_global_norm,  # noqa: E402
                                  init_train_state, make_train_step)
from repro_torch.training.trainer import (loss_and_grads,  # noqa: E402
                                          step_context)

# seconds a collective may wait for the other ranks before it raises
COLLECTIVE_TIMEOUT_S = 60

# calls of the expert-parallel block, of the raw collectives and of the
# differentiable merge of K/V-split partial attentions, counted
CALLS = {}


def _counted(owner, name):
    fn = getattr(owner, name)

    def wrapped(*a, **k):
        CALLS[name] = CALLS.get(name, 0) + 1
        return fn(*a, **k)
    setattr(owner, name, wrapped)


_counted(moe_ep, "moe_block_ep")
_counted(C, "combine")
for _name in ("all_to_all", "all_gather", "gather_blocks", "reduce_scatter",
              "all_reduce"):
    _counted(C.Comm, _name)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _cfg(case):
    cfg = get_config(case["arch"], reduced=True)
    return dataclasses.replace(cfg, **case.get("replace", {}))


def _leaf_err(got, want, mesh, spec):
    """max |got - want's slice| over want's largest |entry| (whole)."""
    top = float(want.abs().max()) or 1.0
    d = (got - shard_local(want, spec, mesh)).abs()
    return float(d.max()) / top


def _param_check(local, ref, mesh, tol):
    """(largest difference over the leaf's largest entry, largest share
    of a leaf's elements beyond ``tol`` of it, the largest difference
    over lr-free slack) of this rank's parameters against the
    single-device state's slices."""
    worst, share, absolute = 0.0, 0.0, 0.0
    specs = local.specs
    for (n, p), (_, w) in zip(local.named_parameters(),
                              ref.named_parameters()):
        top = float(w.abs().max()) or 1.0
        d = (p - shard_local(w, specs[n], mesh)).abs()
        worst = max(worst, float(d.max()) / top)
        absolute = max(absolute, float(d.max()) - tol * top)
        share = max(share, float((d > tol * top).sum()) / d.numel())
    return worst, share, absolute


def _carry(state, ref, mesh):
    """The single-device state's slices into this rank's tensors."""
    specs = state.params.specs
    with torch.no_grad():
        for (n, p), (_, w) in zip(state.params.named_parameters(),
                                  ref.params.named_parameters()):
            p.copy_(shard_local(w, specs[n], mesh))
        for mom in ("mu", "nu"):
            for n, t in getattr(state.opt, mom).items():
                t.copy_(shard_local(getattr(ref.opt, mom)[n], specs[n],
                                    mesh))
        state.opt.step.copy_(ref.opt.step)


def _bit_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


def _tree_bit_equal(x, y):
    pairs = list(zip(x.params.named_parameters(),
                     y.params.named_parameters()))
    ok = all(n == m and _bit_equal(a.detach(), b.detach())
             for (n, a), (m, b) in pairs)
    for mom in ("mu", "nu"):
        ok &= all(_bit_equal(t, getattr(y.opt, mom)[n])
                  for n, t in getattr(x.opt, mom).items())
    return ok and _bit_equal(x.opt.step, y.opt.step)


def train_case(case, mesh, rank, ckpt_root):
    cfg = _cfg(case)
    bundle = get_model(cfg)
    dsz = mesh.size // mesh.shape["model"]
    kw = dict(remat=True, data_shards=dsz)
    full = params_from_jax(case["tree"], cfg, device="cpu")
    ref = init_train_state(copy.deepcopy(full))
    state = init_train_state(shard_params(full, mesh, fsdp=True))
    specs = state.params.specs
    ref_step = make_train_step(bundle.loss, lr=case["lr"], **kw)
    step = make_train_step(bundle.loss, lr=case["lr"], mesh=mesh, **kw)
    out = {"param": [], "param_share": [], "param_abs": [], "moment": []}
    # the gradients of the first batch, this rank's slices against one
    # device's (the moments after each step hold the later ones)
    batch = case["batches"][0]
    l0, m0, g0 = loss_and_grads(bundle.loss, ref.params, _t(batch), **kw)
    CALLS.clear()
    l1, m1, g1 = loss_and_grads(bundle.loss, state.params,
                                _t(shard_batch(batch, mesh)), mesh=mesh,
                                **kw)
    out["calls"] = dict(CALLS)
    # without remat: the recomputed layers' collectives are not run again
    CALLS.clear()
    loss_and_grads(bundle.loss, state.params, _t(shard_batch(batch, mesh)),
                   mesh=mesh, **dict(kw, remat=False))
    out["calls_no_remat"] = dict(CALLS)
    out["loss_rel"] = abs(float(l1) - float(l0)) / abs(float(l0))
    out["metric_rel"] = [max(abs(float(m1[k]) - float(m0[k]))
                             / max(abs(float(m0[k])), 1e-30) for k in m0)]
    out["grad"] = max(_leaf_err(g1[n], g0[n], mesh, specs[n]) for n in g0)
    for batch in case["batches"]:
        _carry(state, ref, mesh)
        # the steps from the same state: metrics, moments, parameters
        _, mr = ref_step(ref, batch)
        _, ms = step(state, batch)
        assert sorted(mr) == sorted(ms)
        out["metric_rel"].append(max(
            abs(float(ms[k]) - float(mr[k])) / max(abs(float(mr[k])), 1e-30)
            for k in mr))
        out["moment"].append(max(
            _leaf_err(getattr(state.opt, mom)[n], getattr(ref.opt, mom)[n],
                      mesh, specs[n])
            for mom in ("mu", "nu") for n in specs))
        worst, share, absolute = _param_check(state.params, ref.params, mesh,
                                              case["param_tol"])
        out["param"].append(worst)
        out["param_share"].append(share)
        out["param_abs"].append(absolute)
    out["steps"] = len(case["batches"])
    out["captures"] = capture_count(step.program)
    out["ref_captures"] = capture_count(ref_step.program)
    out["local_bytes"] = sum(p.numel() for p in state.params.parameters())
    out["whole_bytes"] = sum(p.numel() for p in full.parameters())
    # the same over the leaves the policy splits on this mesh
    pairs = [(p.numel(), w.numel()) for p, w in
             zip(state.params.parameters(), full.parameters())
             if p.numel() < w.numel()]
    out["split_local_bytes"] = sum(a for a, _ in pairs)
    out["split_whole_bytes"] = sum(b for _, b in pairs)
    # checkpoints: the world's, restored on one device; one device's,
    # restored onto the world
    ckpt = str(Path(ckpt_root) / f"{case['name']}")
    save_checkpoint(ckpt + "-world", 5, state)
    whole = gather_tree(state)
    if rank == 0:
        back = restore_checkpoint(ckpt + "-world", 5, ref, device="cpu")
        out["world_to_one"] = _tree_bit_equal(back, whole)
        save_checkpoint(ckpt + "-one", 5, ref)
    dist.barrier()
    onto = restore_checkpoint(ckpt + "-one", 5, state, device="cpu")
    out["one_to_world"] = _slices_bit_equal(onto, ref, mesh)
    # the loss on the JAX package's weights
    jfull = params_from_jax(case["jax_tree"], cfg, device="cpu")
    jlocal = shard_params(jfull, mesh, fsdp=True)
    batch = _t(shard_batch(case["batches"][0], mesh))
    with torch.no_grad(), step_context(cfg, mesh, batch):
        out["jax_weights_loss"] = float(bundle.loss(jlocal, batch, **kw)[0])
    return out


def split_case(case, mesh, rank):
    """A variant of a reduced architecture whose heads do not divide over
    ``model`` (``case["replace"]``), from the port's seed-0 init: whether
    the step's context splits K/V by sequence, the merges
    (``collectives.combine``) its loss and gradients ran, its loss and
    every gradient leaf (this rank's slice) of the first batch against
    the single-device port's, and with ``drop_q_copy_in`` the gradients
    again with the queries' copy-in (``act_sharding.kv_query``)
    dropped."""
    cfg = _cfg(case)
    bundle = get_model(cfg)
    kw = dict(remat=True, data_shards=mesh.size // mesh.shape["model"])
    full = bundle.init(torch.Generator().manual_seed(0))
    if cfg.family == "audio":
        # Whisper's init zeroes its biases; draw them, so that a bias
        # taken wrongly on a rank shows
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for n, p in full.named_parameters():
                leaf = n.rsplit(".", 1)[-1]
                if leaf in ("bq", "bv", "bo", "bi") or leaf.endswith("_b"):
                    p.normal_(0, 0.1, generator=gen)
    local = shard_params(full, mesh, fsdp=True)
    specs = local.specs
    batch = make_batches(cfg, 4, 32, 1, seed=0)[0]
    l0, _, g0 = loss_and_grads(bundle.loss, full, _t(batch), **kw)
    mine = _t(shard_batch(batch, mesh))
    with step_context(cfg, mesh, mine) as ctx:
        out = {"kv_seq": ctx.kv_seq, "seq_parallel": ctx.seq_divisible}
    CALLS.clear()
    l1, _, g1 = loss_and_grads(bundle.loss, local, mine, mesh=mesh, **kw)
    out["combines"] = CALLS.get("combine", 0)
    out["loss_rel"] = abs(float(l1) - float(l0)) / abs(float(l0))
    out["grad"] = max(_leaf_err(g1[n], g0[n], mesh, specs[n]) for n in g0)
    if case.get("drop_q_copy_in"):
        kv_query = acts.kv_query
        acts.kv_query = lambda q: q
        try:
            _, _, g2 = loss_and_grads(bundle.loss, local, mine, mesh=mesh,
                                      **kw)
        finally:
            acts.kv_query = kv_query
        out["grad_no_q_copy_in"] = max(
            _leaf_err(g2[n], g0[n], mesh, specs[n]) for n in g0)
    return out


def launch_case(case, mesh, rank):
    """``launch/train.py`` with ``case["argv"]`` on this world (its own
    mesh of it): rank 0's JSON summary, and whether every rank ran to
    the end."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        train_cli.main(case["argv"])
    lines = printed.getvalue().splitlines()
    return {"summary": json.loads(lines[-1]) if rank == 0 else None,
            "done": True}


def _slices_bit_equal(local, whole, mesh):
    """Every leaf of the sharded state ``local`` bit-equal to ``whole``'s
    slice of it."""
    specs = local.params.specs
    ok = all(_bit_equal(p.detach(), shard_local(w.detach(), specs[n], mesh))
             for (n, p), (_, w) in zip(local.params.named_parameters(),
                                       whole.params.named_parameters()))
    for mom in ("mu", "nu"):
        ok &= all(_bit_equal(t, shard_local(getattr(whole.opt, mom)[n],
                                            specs[n], mesh))
                  for n, t in getattr(local.opt, mom).items())
    return ok and _bit_equal(local.opt.step, whole.opt.step)


def _rss_bytes():
    """This process's resident set now."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _added_rss(fn):
    """(``fn()``, the most this process's resident set rose above its
    size before the call while ``fn`` ran), the resident set sampled
    every millisecond by a thread of its own."""
    gc.collect()
    before = _rss_bytes()
    top = [before]
    done = threading.Event()

    def sample():
        while not done.wait(1e-3):
            top[0] = max(top[0], _rss_bytes())
    watcher = threading.Thread(target=sample)
    watcher.start()
    try:
        out = fn()
    finally:
        done.set()
        watcher.join()
    return out, max(top[0], _rss_bytes()) - before


def ckpt_memory_case(case, mesh, rank, ckpt_root):
    """A sharded state built on this rank alone (random slices, no whole
    model ever held), saved and restored onto the world: the resident
    set each adds (``_added_rss``), the whole state's and this rank's
    share's bytes, and the restored state bit-equal to the saved one."""
    cfg = _cfg(case)
    local = shard_params(empty_model(cfg, "meta"), mesh,
                         fsdp=True).to_empty(device="cpu")
    # one seed on every rank: the leaves FSDP keeps whole are equal
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in local.parameters():
            p.normal_(generator=gen)
    state = init_train_state(local)
    whole = sum(p.numel() * p.element_size()
                for p in empty_model(cfg, "meta").parameters())
    share = sum(p.numel() * p.element_size() for p in local.parameters())
    ckpt = str(Path(ckpt_root) / "memory")
    out = {"whole_bytes": 3 * whole, "share_bytes": 3 * share}
    _, out["save_added"] = _added_rss(lambda: save_checkpoint(ckpt, 1,
                                                              state))
    back, out["restore_added"] = _added_rss(lambda: restore_checkpoint(
        ckpt, 1, state, device="cpu"))
    out["bit_equal"] = _tree_bit_equal(back, state)
    return out


def ep_case(case, mesh, rank):
    """The expert-parallel block on this rank's rows and positions of a
    seeded batch, gathered, against ``moe_block(data_shards=1)`` on the
    whole batch; the aux loss against it and against the mean of each
    rank's own estimate (the JAX block's)."""
    cfg = _cfg(case)
    full = params_from_jax(case["tree"], cfg, device="cpu")
    local = shard_params(full, mesh, fsdp=True)
    x = torch.from_numpy(case["x"])
    want, want_aux = lm.moe_block(full.layers[0].moe, cfg, x, data_shards=1)
    m = mesh.shape["model"]
    d = mesh.size // m
    data = mesh.comm(mesh.data_axes)
    xl = shard_local(x, (mesh.data_axes, "model"), mesh)
    with acts.activation_sharding(mesh, batch_divisible=True,
                                  seq_divisible=True,
                                  experts_divisible=True), torch.no_grad():
        applicable = moe_ep.ep_applicable(cfg, x.shape[0], x.shape[1])
        moe = acts.gathered(local.layers[0]).moe
        y, aux = moe_ep.moe_block_ep(moe, cfg, xl, data_shards=1)
        # this rank's own estimate: its tokens' statistics alone
        wi = moe.router
        _, _, own_aux, _ = lm._route((xl.reshape(-1, x.shape[-1]).float()
                                      @ wi)[None], cfg, 4)
    own = [torch.empty(()) for _ in range(mesh.size)]
    dist.all_gather(own, own_aux.reshape(()))
    y = mesh.comm("model").all_gather(y, 1)
    y = data.all_gather(y, 0) if d > 1 else y
    return {"applicable": applicable, "y": y.numpy(), "want": want.numpy(),
            "aux": float(aux), "want_aux": float(want_aux),
            "mean_own_aux": float(torch.stack(own).mean())}


def collectives_case(case, mesh, rank):
    """Each differentiable collective on ``mesh``'s ``model`` axis: this
    rank's gradient against one device's derivative of the global loss
    (the ranks' losses summed, or one loss every rank computes alike),
    over the same whole tensors; and the clip's norm."""
    comm = mesh.comm("model")
    m, r = comm.size, comm.rank
    gen = torch.Generator().manual_seed(11)
    whole = torch.randn(2 * m, 3, generator=gen)
    parts = [torch.randn(2 * m, 3, generator=gen) for _ in range(m)]
    cs = [torch.randn(2 * m, 3, generator=gen) for _ in range(m)]
    blocks = [torch.randn(2, 3, generator=gen) for _ in range(m)]
    out = {}

    def block(t, i, dim=0):
        return t.narrow(dim, i * (t.shape[dim] // m), t.shape[dim] // m)

    def check(name, local_in, local_loss, global_loss, leaves, pick):
        """``local_in`` this rank's input leaf; ``local_loss(x)`` its loss;
        ``global_loss(*leaves)`` one device's; ``pick(grads)`` this rank's
        share of one device's gradients."""
        x = local_in.clone().requires_grad_(True)
        got, = torch.autograd.grad(local_loss(x), x)
        leaves = [t.clone().requires_grad_(True) for t in leaves]
        want = pick(torch.autograd.grad(global_loss(*leaves), leaves))
        out[name] = float((got - want).abs().max())

    # all_reduce: partials -> whole, one loss every rank computes alike
    check("all_reduce", parts[r],
          lambda x: (C.all_reduce(comm, x) * cs[0]).sum(),
          lambda *ps: (sum(ps) * cs[0]).sum(), parts, lambda g: g[r])
    # copy_in: a whole tensor into each rank's own work
    check("copy_in", whole, lambda x: (C.copy_in(comm, x) * cs[r]).sum(),
          lambda w: sum((w * c).sum() for c in cs), [whole],
          lambda g: g[0])
    check("missing_copy_in", whole, lambda x: (x * cs[r]).sum(),
          lambda w: sum((w * c).sum() for c in cs), [whole],
          lambda g: g[0])
    # all_gather: the replicated loss's gather (gradient: the slice)
    check("all_gather", block(whole, r),
          lambda x: (C.all_gather(comm, x, 0) * cs[0]).sum(),
          lambda w: (w * cs[0]).sum(), [whole], lambda g: block(g[0], r))
    # gather_local: the gathered tensor feeds each rank's own work
    check("gather_local", block(whole, r),
          lambda x: (C.gather_local(comm, x, 0) * cs[r]).sum(),
          lambda w: sum((w * c).sum() for c in cs), [whole],
          lambda g: block(g[0], r))
    # reduce_scatter: partials -> this rank's block of the sum
    check("reduce_scatter", parts[r],
          lambda x: (C.reduce_scatter(comm, x, 0) * blocks[r]).sum(),
          lambda *ps: sum((block(sum(ps), i) * blocks[i]).sum()
                          for i in range(m)), parts, lambda g: g[r])
    # split: a whole tensor -> this rank's block
    check("split", whole,
          lambda x: (C.split(comm, x, 0) * blocks[r]).sum(),
          lambda w: sum((block(w, i) * blocks[i]).sum() for i in range(m)),
          [whole], lambda g: g[0])
    # all_to_all: blocks of dim 0 to their ranks, concatenated on dim 1
    check("all_to_all", parts[r],
          lambda x: (C.all_to_all(comm, x, 0, 1)
                     * torch.cat([blocks[r]] * m, 1)).sum(),
          lambda *ps: sum((torch.cat([block(p, i) for p in ps], 1)
                           * torch.cat([blocks[i]] * m, 1)).sum()
                          for i in range(m)), parts, lambda g: g[r])
    # combine: each rank's partial attention over its block of the keys,
    # with its log-sum-exp, merged; the first query's last block fully
    # masked (-1e30, as the attention masks), so that rank weighs 0 there
    logits = torch.randn(3, 2 * m, generator=gen)
    logits[0, -2:] = -1e30
    vals = torch.randn(2 * m, 4, generator=gen)
    cq = torch.randn(3, 4, generator=gen)

    def partial(x, i):
        return (torch.softmax(x, -1) @ block(vals, i),
                torch.logsumexp(x, -1))
    check("combine", block(logits, r, 1),
          lambda x: (C.combine(comm, *partial(x, r)) * cq).sum(),
          lambda w: ((torch.softmax(w, -1) @ vals) * cq).sum(), [logits],
          lambda g: block(g[0], r, 1))
    # the clip: a leaf split over model counted over the ranks, a whole
    # leaf once
    grads = {"split": block(whole, r).clone(), "whole": cs[0].clone()}
    specs = {"split": ("model",), "whole": ()}
    _, norm = clip_by_global_norm(grads, 1.0, mesh=mesh, specs=specs)
    out["clip_norm"] = float(norm)
    out["clip_want"] = float(torch.sqrt(whole.square().sum()
                                        + cs[0].square().sum()))
    return out


def main(spec_path, rank):
    spec = pickle.loads(Path(spec_path).read_bytes())
    out_path = Path(f"{spec_path}.{rank}.out")
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], spec["world"]),
        rank=rank, world_size=spec["world"],
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    results = {}
    kinds = {"train": lambda c, m: train_case(c, m, rank, spec["ckpt"]),
             "ep": lambda c, m: ep_case(c, m, rank),
             "collectives": lambda c, m: collectives_case(c, m, rank),
             "split": lambda c, m: split_case(c, m, rank),
             "launch": lambda c, m: launch_case(c, m, rank),
             "ckpt_memory": lambda c, m: ckpt_memory_case(c, m, rank,
                                                          spec["ckpt"])}
    for case in spec["cases"]:
        try:
            mesh = make_mesh(case["mesh"])
            results[case["name"]] = kinds[case["kind"]](case, mesh)
        except Exception:
            results[case["name"]] = {"error": traceback.format_exc()}
            out_path.write_bytes(pickle.dumps(results))
            return 1
        out_path.write_bytes(pickle.dumps(results))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
