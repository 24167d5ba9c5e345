"""The port's dry run (``launch/shapes.py``, ``launch/op_analysis.py``,
``launch/dryrun.py``, ``collectives.DryComm``, ``mesh.dry_mesh``) against
the JAX package's and against a real gloo world.

  * the inputs of every full configuration at the four assigned shapes
    and the analytic parameter counts equal the JAX package's;
  * ``op_analysis`` on the cases of ``tests/test_hlo_analysis.py``, and
    the port's own (views, cache-slot writes, temporaries, remat);
  * ``DryComm``'s results have the real ``Comm``'s shapes on a gloo world
    of 2, and a reduced Yi-6B's and DeepSeek-MoE's train steps tally the
    same collectives on a ``dry_mesh`` as on the world of that shape;
    FSDP-sharded prefill and decode of every family on that world, and
    Whisper's decode over a cache split by rows, give one device's
    tokens (one spawn of ``tests/torch_train_worker.py`` for the module);
  * the six (arch, shape) pairs of ``tests/test_dryrun_small.py`` on a
    (2, 4) mesh: the port's FLOPs and argument bytes against the JAX dry
    run's (``build_step`` + ``hlo_analysis.analyze`` in ONE subprocess
    with 8 host devices; its mesh takes ``AxisType.Auto`` axes, which
    jax 0.9's ``make_mesh`` no longer defaults to, and its
    ``shard_map`` takes ``check_rep`` under the name jax 0.9 gives it —
    the JAX package itself is untouched);
  * every reduced architecture in each mode on (2, 4) and (2, 2, 2)
    dry meshes, and the CLI, which writes its JSON without importing
    jax.
"""

import json
import math
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import shapes as jax_shapes
from repro.models import get_model as jax_get_model

from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import collectives as C
from repro_torch.launch import dryrun, op_analysis, shapes
from repro_torch.launch.mesh import (DryMesh, Mesh, dry_mesh,
                                     make_production_mesh)
from repro_torch.models import get_model

SRC = Path(__file__).resolve().parents[1] / "src"
WORKER = Path(__file__).resolve().parent / "torch_train_worker.py"
ARCHS = list_archs()
# the six pairs of tests/test_dryrun_small.py, on its (2, 4) mesh
PAIRS = [("qwen3-32b", "train"), ("mamba2-780m", "train"),
         ("deepseek-moe-16b", "prefill"), ("zamba2-1.2b", "decode"),
         ("whisper-large-v3", "decode"), ("paligemma-3b", "prefill")]
PAIR_SHAPE = {m: shapes.InputShape(m[0], 64, 4, m) for m in
              ("train", "prefill", "decode")}
# the port's FLOPs against the JAX dry run's (relative)
FLOPS_RTOL = 0.02
# the port's collective bytes over the JAX dry run's, each pair (the
# causes: test_pair_collective_bytes_within_a_band_of_jax)
COLLECTIVE_BAND = (0.5, 3.0)
# small shapes of every mode: long_500k's single row replicated over the
# data axes
SMALL = {"train": shapes.InputShape("t", 64, 4, "train"),
         "prefill": shapes.InputShape("p", 64, 4, "prefill"),
         "decode": shapes.InputShape("d", 64, 4, "decode"),
         "long": shapes.InputShape("l", 256, 1, "decode")}
# the gloo world of 2: a train step's tallies on each mesh, and FSDP
# serving on (2, 1)
TALLY_ARCHS = ["yi-6b", "deepseek-moe-16b"]
TALLY_MESHES = [(1, 2), (2, 1)]
TALLY_BATCH, TALLY_SEQ = 4, 32
# FSDP serving on (2, 1): every family besides the dense one's Yi-6B
SERVE_ARCHS = ["mamba2-780m", "zamba2-1.2b", "paligemma-3b",
               "whisper-large-v3"]
# Whisper's decode on (1, 2) over a cache split by rows: heads that do
# not divide over model (the policy's sequence mode), a ring of 16
# positions of which rank 1's 8 are empty for the first decode steps,
# and decode steps past the ring's end
SEQ_SERVE = {"replace": {"n_heads": 3, "n_kv_heads": 3, "head_dim": 32},
             "prompt": 4, "cache_len": 16, "new": 16}
# each decode step's logits on the world against one device's (relative
# to the largest; float32, the partials' merge rounds differently)
SERVE_RTOL = 1e-5
GROUP_S = 240
# DryComm's raw methods: name -> (method, input shapes, other args)
COMM_CALLS = {
    "all_reduce": ("all_reduce", [(4, 6, 8)], []),
    "all_gather 0": ("all_gather", [(4, 6, 8)], [0]),
    "all_gather 2": ("all_gather", [(4, 6, 8)], [2]),
    "gather_blocks 1": ("gather_blocks", [(4, 6, 8)], [1]),
    "reduce_scatter 0": ("reduce_scatter", [(4, 6, 8)], [0]),
    "reduce_scatter 1": ("reduce_scatter", [(4, 6, 8)], [1]),
    "all_to_all 0 1": ("all_to_all", [(4, 6, 8)], [0, 1]),
    "all_to_all 2 0": ("all_to_all", [(4, 6, 8)], [2, 0]),
    "combine": ("combine", [(3, 5, 8), (3, 5)], []),
    "merge": ("merge", [(3, 5, 8), (3, 5)], []),
}

JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
from jax.sharding import AxisType

_shard_map = jax.shard_map


def shard_map(*a, check_rep=None, **k):
    if check_rep is not None:
        k.setdefault("check_vma", check_rep)
    return _shard_map(*a, **k)


jax.shard_map = shard_map
from repro.configs import get_config
from repro.models import get_model
from repro.launch.dryrun import build_step
from repro.launch.shapes import InputShape
from repro.launch.hlo_analysis import analyze

mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch, mode in PAIRS:
    bundle = get_model(get_config(arch, reduced=True))
    fn, args, shards = build_step(bundle, InputShape(mode, 64, 4, mode),
                                  mesh)
    with mesh:
        compiled = jax.jit(fn, in_shardings=shards).lower(*args).compile()
    hc = analyze(compiled.as_text())
    out[arch + ":" + mode] = {
        "flops": hc.flops,
        "collective_bytes": hc.total_collective_bytes,
        "argument_bytes": compiled.memory_analysis().argument_size_in_bytes}
print("RESULT" + json.dumps(out))
"""


# ---------------------------------------------------------------------------
# (1) inputs, (2) parameter counts
# ---------------------------------------------------------------------------

def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    """Every leaf of the four shapes' inputs: the JAX ``input_specs``
    (abstract ``eval_shape``) against the port's, shape and dtype, under
    the same names."""
    jb = jax_get_model(jax_get_config(arch))
    pb = get_model(get_config(arch))
    for name, shape in shapes.SHAPES.items():
        assert shapes.cache_len_for(pb.cfg, shape) == \
            jax_shapes.cache_len_for(jb.cfg, jax_shapes.SHAPES[name])
        want = jax_shapes.input_specs(jb, jax_shapes.SHAPES[name])
        got = shapes.input_specs(pb, shape)
        assert sorted(got) == sorted(want), (name, sorted(got))
        for key, w in want.items():
            g = got[key]
            wl = w if isinstance(w, dict) else {key: w}
            gl = g if isinstance(g, dict) else {key: g}
            assert sorted(gl) == sorted(wl), (name, key)
            for leaf, spec in wl.items():
                assert tuple(gl[leaf].shape) == tuple(spec.shape), \
                    (name, key, leaf)
                assert _dtype_name(gl[leaf].dtype) == str(spec.dtype), \
                    (name, key, leaf)
        if shape.mode == "decode":
            assert all(t.device.type == "meta"
                       for t in got["cache"].values())


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch, reduced):
    jcfg, cfg = jax_get_config(arch, reduced), get_config(arch, reduced)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()


# ---------------------------------------------------------------------------
# (3) op_analysis
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_single_matmul_flops_exact():
    a, b = _meta(256, 512, dtype=torch.bfloat16), _meta(
        512, 1024, dtype=torch.bfloat16)
    _, cost = op_analysis.analyze(lambda a, b: a @ b, a, b)
    assert cost.flops == 2 * 256 * 512 * 1024
    # operands and result, once
    assert cost.bytes_accessed == 2 * (256 * 512 + 512 * 1024 + 256 * 1024)
    assert cost.argument_bytes == 2 * (256 * 512 + 512 * 1024)
    assert cost.output_bytes == cost.peak_temp_bytes == 2 * 256 * 1024


def test_matmul_chain_flops():
    a, b, c = _meta(64, 128), _meta(128, 256), _meta(256, 32)
    _, cost = op_analysis.analyze(lambda a, b, c: (a @ b) @ c, a, b, c)
    assert cost.flops == 2 * 64 * 128 * 256 + 2 * 64 * 256 * 32


def test_convolution_flops():
    """A 2-D convolution: 2 x output elements x kernel window x C_in, the
    HLO analysis's rule."""
    x, w = _meta(2, 8, 32, 32), _meta(16, 8, 3, 3)
    _, cost = op_analysis.analyze(
        lambda x, w: torch.nn.functional.conv2d(x, w, padding=1), x, w)
    assert cost.flops == 2 * (2 * 16 * 32 * 32) * (3 * 3 * 8)


def test_loop_of_ten_layers_counts_ten():
    """The HLO analysis multiplies a scan body by its trip count; eager
    execution runs the ten layers, so ten times one layer's FLOPs."""
    a, w = _meta(256, 512, dtype=torch.bfloat16), _meta(
        10, 512, 512, dtype=torch.bfloat16)

    def f(a, w):
        for i in range(10):
            a = a @ w[i]
        return a

    _, cost = op_analysis.analyze(f, a, w)
    assert cost.flops == 10 * 2 * 256 * 512 * 512


def test_views_cost_no_bytes():
    x = _meta(64, 128)
    _, cost = op_analysis.analyze(
        lambda x: x.transpose(0, 1)[::2].unsqueeze(0).expand(3, -1, -1)
        .narrow(2, 0, 32)[:, 1].detach().select(0, 1), x)
    assert cost.bytes_accessed == 0 and cost.flops == 0
    assert cost.peak_temp_bytes == 0 and cost.output_bytes == 0
    # an elementwise op reads and writes the whole tensor
    _, cost = op_analysis.analyze(lambda x: x + 1.0, x)
    assert cost.bytes_accessed == 2 * 64 * 128 * 4


def test_cache_slot_write_costs_its_slice():
    """A decode step's ring write into a (B, KH, C, dh) cache: the new
    rows read and written and the indices read, not the cache."""
    b, kh, c, dh = 4, 8, 4096, 64
    cache, k = _meta(b, kh, c, dh), _meta(b, kh, dh)
    lengths = torch.empty(b, dtype=torch.int64, device="meta")
    rows = torch.empty(b, dtype=torch.int64, device="meta")

    def write(cache, k, rows, lengths):
        cache[rows, :, lengths] = k

    _, cost = op_analysis.analyze(write, cache, k, rows, lengths)
    assert cost.bytes_accessed == 2 * b * kh * dh * 4 + 2 * b * 8
    # a copy into a slot's view: the view's bytes written, the source's
    # read
    _, cost = op_analysis.analyze(
        lambda cache, k: cache[:, :, 7].copy_(k), cache, k)
    assert cost.bytes_accessed == 2 * b * kh * dh * 4


def test_peak_temporary_bytes_of_a_chain():
    """x -> y = x @ w -> z = tanh(y) -> y dies -> s = z.sum(): at most y
    and z live at once (w and x are arguments, not counted)."""
    x, w = _meta(64, 128), _meta(128, 256)

    def f(x, w):
        y = x @ w
        z = torch.tanh(y)
        del y
        return z.sum()

    _, cost = op_analysis.analyze(f, x, w)
    assert cost.peak_temp_bytes == 2 * 64 * 256 * 4
    assert cost.output_bytes == 4


def test_temp_bytes_leave_out_the_outputs():
    """y = x @ w and its sum t live together, then y dies and
    out = t * x is returned.  ``peak_temp_bytes`` is the peak of all the
    step made (y + t); ``temp_bytes``, XLA's ``temp_size_in_bytes``, is
    the peak of what it did not return — here the same y + t, which came
    before the output existed — and ``output_bytes`` is out's."""
    x, w = _meta(64, 128), _meta(128, 256)

    def f(x, w):
        y = x @ w
        t = y.sum()
        del y
        return t * x

    def g(x, w):
        y = x @ w
        return torch.tanh(y)

    _, cost = op_analysis.analyze(f, x, w)
    assert cost.peak_temp_bytes == cost.temp_bytes == 64 * 256 * 4 + 4
    assert cost.output_bytes == 64 * 128 * 4
    # y and tanh(y) at once, the latter returned: the temporaries are y
    _, cost = op_analysis.analyze(g, x, w)
    assert cost.peak_temp_bytes == 2 * 64 * 256 * 4
    assert cost.temp_bytes == cost.output_bytes == 64 * 256 * 4


def test_remat_recompute_is_counted():
    """A rematerialized layer's forward runs again in backward, on the
    caller's thread on meta: fwd + recompute + two backward products =
    4/3 of the plain step's FLOPs."""
    from torch.utils.checkpoint import checkpoint
    w = _meta(64, 64).requires_grad_()
    x = _meta(8, 64).requires_grad_()

    def step(x, w, remat):
        def layer(h):
            return torch.tanh(h @ w)
        y = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
        return torch.autograd.grad(y.sum(), [x, w])

    _, plain = op_analysis.analyze(step, x, w, False)
    _, remat = op_analysis.analyze(step, x, w, True)
    assert plain.flops == 3 * 2 * 8 * 64 * 64
    assert remat.flops == 4 * 2 * 8 * 64 * 64


# ---------------------------------------------------------------------------
# (4) DryComm against a gloo world of 2
# ---------------------------------------------------------------------------

def _tally_batch(arch):
    rng = np.random.default_rng(7)
    vocab = get_config(arch, reduced=True).vocab
    return {k: rng.integers(0, vocab, (TALLY_BATCH, TALLY_SEQ)
                            ).astype(np.int32) for k in ("tokens", "labels")}


def _serve_batch(arch, b, s, seed=3):
    """Prompts (b, s) and the bundle's other prefill inputs (vision
    patches, audio frames), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    cfg = get_config(arch, reduced=True)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    for k, spec in get_model(cfg).batch_shapes("prefill", b, s).items():
        if k != "tokens":
            out[k] = rng.standard_normal(spec.shape).astype(np.float32)
    return out


def _cases():
    cases = [{"name": "comm shapes", "kind": "comm_shapes", "mesh": (1, 2),
              "calls": COMM_CALLS},
             {"name": "fsdp serve", "kind": "fsdp_serve", "mesh": (2, 1),
              "arch": "yi-6b", "new": 6,
              "batch": _serve_batch("yi-6b", 4, 16)},
             {"name": "seq serve", "kind": "fsdp_serve", "mesh": (1, 2),
              "arch": "whisper-large-v3", "seq_kv": True,
              "replace": SEQ_SERVE["replace"], "new": SEQ_SERVE["new"],
              "cache_len": SEQ_SERVE["cache_len"],
              "batch": _serve_batch("whisper-large-v3", 2,
                                    SEQ_SERVE["prompt"])}]
    for arch in SERVE_ARCHS:
        cases.append({"name": f"fsdp serve {arch}", "kind": "fsdp_serve",
                      "mesh": (2, 1), "arch": arch, "new": 6,
                      "batch": _serve_batch(arch, 4, 16)})
    for arch in TALLY_ARCHS:
        for mesh in TALLY_MESHES:
            cases.append({"name": f"tally {arch} {mesh}", "kind": "tally",
                          "mesh": mesh, "arch": arch,
                          "batch": _tally_batch(arch)})
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's results on a gloo world of 2, case name -> result."""
    path = tmp_path_factory.mktemp("dryrun_world")
    spec = path / "spec.pkl"
    spec.write_bytes(pickle.dumps({"world": 2, "cases": _cases(),
                                   "store": str(path / "store"),
                                   "ckpt": str(path / "ckpt")}))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(spec),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
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
            pytest.fail(f"rank {r} exited {p.returncode}:\n"
                        + "\n".join(errors) + "\n" + logs[r])
        results.append(res)
    return results


@pytest.mark.parametrize("call", list(COMM_CALLS))
def test_dry_comm_shapes_match_a_world(world, call):
    """Each raw method of ``DryComm(2)`` returns what the real ``Comm``
    of a 2-rank axis returns: the same shapes and dtypes."""
    method, shapes_, extra = COMM_CALLS[call]
    tally = C.new_tally()
    got = getattr(C.DryComm(2, tally), method)(
        *[torch.ones(s) for s in shapes_], *extra)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), str(t.dtype)) for t in got] == \
        world[0]["comm shapes"][call]
    kinds = {"all_reduce": "all-reduce", "combine": "all-reduce",
             "merge": "all-reduce", "all_to_all": "all-to-all",
             "reduce_scatter": "reduce-scatter"}
    kind = kinds.get(method, "all-gather")
    assert tally["counts"][kind] == (2 if kind == "all-reduce"
                                     and method != "all_reduce" else 1)
    assert sum(tally["counts"].values()) == tally["counts"][kind]


def test_dry_comm_one_rank_axis_records_nothing():
    tally = C.new_tally()
    comm = C.DryComm(1, tally)
    x = torch.ones(4, 6)
    assert comm.all_gather(x, 0).shape == x.shape
    assert comm.reduce_scatter(x, 1).shape == x.shape
    assert comm.all_to_all(x, 0, 1).shape == x.shape
    assert comm.all_reduce(x) is x
    assert sum(tally["counts"].values()) == 0


@pytest.mark.parametrize("mesh", TALLY_MESHES,
                         ids=[f"{d}x{m}" for d, m in TALLY_MESHES])
@pytest.mark.parametrize("arch", TALLY_ARCHS)
def test_dry_tallies_equal_a_worlds(world, arch, mesh):
    """A reduced train step (remat, FSDP, the data axes' MoE groups) on
    ``dry_mesh(mesh)``: the collectives ``DryComm`` tallies, kind by kind,
    bytes and calls, equal those the same step makes on a gloo world of
    that shape (each outermost raw ``Comm`` call of an axis of more than
    one rank, ``gather_blocks`` as one all-gather)."""
    name = f"tally {arch} {mesh}"
    assert world[0][name] == world[1][name]
    want = world[0][name]["tally"]
    dmesh = dry_mesh(mesh)
    fn, args = dryrun.build_step(
        get_model(get_config(arch, reduced=True)),
        shapes.InputShape("t", TALLY_SEQ, TALLY_BATCH, "train"), dmesh)
    _, cost = op_analysis.analyze(fn, *args, tally=dmesh.tally)
    assert cost.collective_bytes == want["bytes"]
    assert cost.collective_counts == want["counts"]
    assert cost.total_collective_bytes > 0


def test_fsdp_prefill_decode_gives_one_devices_tokens(world):
    """Reduced Yi-6B on a (2, 1) gloo world, weights FSDP-sharded over
    the data axis and gathered layer by layer inside the dry run's
    context: each rank's greedy tokens for its rows equal one device's on
    the whole weights, and so does each step's logits (``SERVE_RTOL``)."""
    for rank in world:
        res = rank["fsdp serve"]
        assert res["gathers"] > 0
        assert res["tokens"] == res["want"]
        assert res["logit_err"] <= SERVE_RTOL
        assert math.isfinite(res["logit_top"])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_fsdp_serving_of_each_family_gives_one_devices_tokens(world, arch):
    """The other families' prefill and decode (Mamba2's SSD blocks,
    Zamba2's shared attention, PaliGemma's projector and prefix,
    Whisper's encoder and cross K/V) on the (2, 1) world, weights
    FSDP-sharded and gathered layer by layer: each rank's greedy tokens
    for its rows equal one device's, and so does each step's logits
    (``SERVE_RTOL``)."""
    for rank in world:
        res = rank[f"fsdp serve {arch}"]
        assert res["gathers"] > 0
        assert res["tokens"] == res["want"]
        assert res["logit_err"] <= SERVE_RTOL
        assert math.isfinite(res["logit_top"])


def test_whisper_decode_on_a_row_split_cache_gives_one_devices_tokens(
        world):
    """Whisper (3 heads, which do not divide over model = 2) decoding on
    (1, 2) with ``seq_kv=True``: each rank holds half the rows of the
    self-attention rings and of the cross K/V (``cache_sharding``'s
    sequence mode), writes a new row only where it owns the ring slot
    (``lm.ring_write``), and merges its partial by its log-sum-exp — an
    empty block weighing nothing for the first steps, and the ring
    wrapping after 12.  Greedy tokens and each step's logits
    (``SERVE_RTOL``) equal one device's on the whole cache; every layer
    merges its self and cross attention each step.  The logits are what
    shows a wrong slot: the reduced model's greedy tokens stay the same
    with a ring of one rank's block."""
    cfg = get_config("whisper-large-v3", reduced=True)
    new = SEQ_SERVE["new"]
    for rank in world:
        res = rank["seq serve"]
        assert res["cache_rows"] == {
            "k": (SEQ_SERVE["cache_len"], SEQ_SERVE["cache_len"] // 2),
            "cross_k": (cfg.n_audio_ctx, cfg.n_audio_ctx // 2)}
        assert res["merges"] == 2 * cfg.n_layers * new
        assert res["tokens"] == res["want"]
        assert res["logit_err"] <= SERVE_RTOL
        assert math.isfinite(res["logit_top"])


# ---------------------------------------------------------------------------
# (5) the six pairs against the JAX dry run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pairs():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    script = JAX_SCRIPT.replace("PAIRS", repr(PAIRS))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


def test_train_loss_keeps_the_logits_split_by_vocabulary(monkeypatch):
    """The reduced Qwen3 train step on ``dry_mesh((2, 4))``: the loss
    runs on each rank's vocabulary block (``lm.masked_ce`` ->
    ``vocab_parallel_cross_entropy``, entered once) and meets the other
    ``model`` ranks in three all-reduces of its (rows, S) — the max
    (rows, S, 1), the sum of exp and the gold logit — and the data ranks
    in two scalar sums (the masked mean's numerator and count), and
    nothing else; no collective of the step gathers a (rows, S, V)
    tensor of the whole padded vocabulary."""
    from repro_torch.models import lm

    bundle = get_model(get_config("qwen3-32b", reduced=True))
    shape = PAIR_SHAPE["train"]
    mesh = dry_mesh((2, 4))
    rows = shape.global_batch // 2
    vp = lm.padded_vocab(bundle.cfg)
    calls, inside = [], []
    vpce = lm.vocab_parallel_cross_entropy

    def loss(*a, **k):
        inside.append(True)
        try:
            return vpce(*a, **k)
        finally:
            inside.pop()

    def recorder(name):
        fn = getattr(C.DryComm, name)

        def wrapped(self, x, *a, **k):
            out = fn(self, x, *a, **k)
            if self.size > 1:
                op = a[0] if a else k.get("op")
                calls.append((bool(inside), name, tuple(out.shape),
                              str(op) if name == "all_reduce" else None))
            return out
        return wrapped

    monkeypatch.setattr(lm, "vocab_parallel_cross_entropy", loss)
    for name in ("all_reduce", "all_gather", "gather_blocks"):
        monkeypatch.setattr(C.DryComm, name, recorder(name))
    fn, args = dryrun.build_step(bundle, shape, mesh)
    op_analysis.analyze(fn, *args, tally=mesh.tally)
    in_loss = sorted(c[1:] for c in calls if c[0])
    # the masked mean's numerator and count, summed over the data axis
    assert [c for c in in_loss if c[1] == ()] == \
        [("all_reduce", (), "None")] * 2, in_loss
    in_loss = [c for c in in_loss if c[1] != ()]
    assert [(n, s) for n, s, _ in in_loss] == [
        ("all_reduce", (rows, shape.seq_len)),
        ("all_reduce", (rows, shape.seq_len)),
        ("all_reduce", (rows, shape.seq_len, 1))], in_loss
    assert "MAX" in str(in_loss[-1][2]).upper(), in_loss
    assert not [c for c in calls if c[1] != "all_reduce"
                and c[2][-1] == vp and len(c[2]) == 3], calls


# the leaves a decode step does not read, which jax.jit drops from its
# arguments (keep_unused=False): Whisper's encoder and the decoder's
# cross-attention K/V projections (the cache holds their results)
UNUSED_IN_DECODE = ("encoder.", "enc_final_", "xattn.wk", "xattn.wv",
                    "xattn.bv")


@pytest.mark.parametrize("arch,mode", PAIRS)
def test_pair_flops_and_arguments_match_jax(jax_pairs, arch, mode):
    """The port's per-device FLOPs against the JAX ``hlo_analysis``'s on
    the same reduced configuration, shape and (2, 4) mesh, within
    ``FLOPS_RTOL``: the products whose weights stay whole over ``model``
    (Mamba-2's packed ``in_proj``, ``wk``/``wv`` where the query heads
    split and the KV heads do not) are split over the ranks in both, as
    GSPMD splits them (``lm.split_matmul``).  The other gaps
    the JAX program could show are absent here: GSPMD rematerializes
    nothing these steps count (the port's remat recomputes are the JAX
    program's), and attention replicated over ``model`` (Whisper's heads
    on a larger mesh) runs whole in both.  The argument bytes are the JAX
    ``memory_analysis``'s but for the leaves a decode step never reads,
    which jax.jit drops (``UNUSED_IN_DECODE``), named."""
    want = jax_pairs[f"{arch}:{mode}"]
    bundle = get_model(get_config(arch, reduced=True))
    mesh = dry_mesh((2, 4))
    shape = PAIR_SHAPE[mode]
    fn, args = dryrun.build_step(bundle, shape, mesh)
    _, cost = op_analysis.analyze(fn, *args, tally=mesh.tally)
    assert abs(cost.flops - want["flops"]) <= FLOPS_RTOL * want["flops"], \
        (cost.flops, want)
    assert cost.total_collective_bytes > 0 and want["collective_bytes"] > 0
    got = dryrun.measure(bundle, shape, dry_mesh((2, 4)))
    unused = 0
    if mode == "decode":
        unused = sum(p.numel() * p.element_size()
                     for n, p in args[0].named_parameters()
                     if any(u in n for u in UNUSED_IN_DECODE))
    assert got["memory"]["argument_bytes"] - unused == \
        want["argument_bytes"]


@pytest.mark.parametrize("arch,mode", PAIRS)
def test_pair_collective_bytes_within_a_band_of_jax(jax_pairs, arch, mode):
    """The port's per-device collective bytes (result bytes, the HLO
    analysis's convention) over the JAX dry run's, on the six pairs:
    within ``COLLECTIVE_BAND``.  They cannot agree kind by kind, and the
    ratios (printed; 0.60, 1.78, 0.85, 2.61, 1.83 and 1.17 in PAIRS'
    order) are the two programs' different choices:

      * the port gathers every FSDP weight a layer reads over ``data``
        before it uses it, a tied embedding at both ends of the step, and
        Mamba-2's whole ``in_proj`` over ``data`` too, then gathers the
        split product's blocks over ``model`` (``lm.split_matmul``;
        in training once more in the remat recompute) — most of
        Mamba-2's, Zamba2's and Whisper's excess (Whisper's decode: 524
        of its 868 KB are the tied embedding's two gathers); GSPMD may
        keep a weight sharded and reduce the activations instead, far
        fewer bytes at decode;
      * GSPMD adds layout changes the port's fixed Megatron layouts never
        make — all-to-alls, collective-permutes and all-reduces of
        gradients it does not reduce-scatter — Qwen3's and DeepSeek's
        deficit.

    The band catches a count off by a factor (operand in place of result
    bytes, a collective missed or counted per rank)."""
    want = jax_pairs[f"{arch}:{mode}"]["collective_bytes"]
    got = dryrun.measure(get_model(get_config(arch, reduced=True)),
                         PAIR_SHAPE[mode], dry_mesh((2, 4)))
    ratio = got["collectives"]["total_bytes_per_device"] / want
    print(f"{arch} {mode}: port / JAX collective bytes {ratio:.2f}")
    assert COLLECTIVE_BAND[0] <= ratio <= COLLECTIVE_BAND[1]


# ---------------------------------------------------------------------------
# (6) every reduced architecture in every mode, (7) the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [(2, 4), (2, 2, 2)],
                         ids=["2x4", "2x2x2"])
@pytest.mark.parametrize("mode", list(SMALL))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_reduced_arch_runs_dry(arch, mode, mesh):
    """Builds, runs one rank's step on meta and gives finite, positive
    terms; every step on a mesh of more than one rank communicates."""
    dmesh = dry_mesh(mesh)
    res = dryrun.measure(get_model(get_config(arch, reduced=True)),
                         SMALL[mode], dmesh)
    roof = res["roofline"]
    for term in ("compute_s", "memory_s", "collective_s"):
        assert math.isfinite(roof[term]) and roof[term] > 0, (term, roof)
    assert roof["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert 0 < roof["useful_flops_fraction"] < 10
    assert all(v > 0 for v in res["memory"].values()), res["memory"]
    assert res["collectives"]["total_bytes_per_device"] > 0
    assert res["n_chips"] == math.prod(mesh)


def test_dry_mesh_shapes_and_abstract_mesh():
    prod = make_production_mesh(multi_pod=True)
    dm = dry_mesh(prod)
    assert isinstance(dm, DryMesh) and not dm.abstract
    assert dm.shape == prod.shape and dm.coords == {"pod": 0, "data": 0,
                                                    "model": 0}
    assert dm.comm(dm.data_axes).size == 32 and dm.comm("model").size == 16
    assert dm.comm(dm.axis_names).size == 512
    assert dm.comm(("data",)).tally is dm.tally
    with pytest.raises(ValueError, match="abstract"):
        Mesh((16, 16), ("data", "model")).comm("model")


def test_cli_writes_json_without_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun`` at full width, no jax in
    the process: one JSON with the JAX result's keys; a failing
    combination writes its traceback beside it and exits 1."""
    code = ("import runpy, sys\n"
            "sys.argv = ['dryrun', '--arch', 'yi-6b', '--shape', "
            f"'decode_32k', '--out', {str(tmp_path)!r}]\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "print('JAX', 'jax' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX False" in proc.stdout
    files = list(tmp_path.glob("*.json"))
    assert [f.name for f in files] == ["yi-6b__decode_32k__16x16.json"]
    res = json.loads(files[0].read_text())
    assert {"arch", "shape", "mesh", "mode", "n_chips", "fsdp",
            "grad_accum", "trace_s", "memory", "cost", "collectives",
            "roofline"} <= set(res)
    assert set(res["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert {"compute_s", "memory_s", "collective_s", "dominant",
            "model_flops", "model_flops_per_device",
            "useful_flops_fraction"} <= set(res["roofline"])
    assert res["mesh"] == "16x16" and res["n_chips"] == 256
    assert res["roofline"]["device"] == dryrun.DEVICE
    # a combination that cannot run: 256 rows in 3 micro-batches
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "yi-6b", "--shape", "train_4k", "--grad-accum", "3", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert bad.returncode == 1
    err = tmp_path / "yi-6b__train_4k__16x16__ga3.json.err"
    assert err.exists() and "Traceback" in err.read_text()
