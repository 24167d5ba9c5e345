"""The slice as a whole: the port's MicroInterpreter on the CPU against the
JAX package's, on the same exported blobs and the same seeded requests,
plus the port's counterparts of tests/test_interpreter.py (the paper's
§4.1–4.5 invariants) and its package boundary."""

import ast
import inspect
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.apps.models as jax_apps
import repro.core as jax_core
import repro.kernels.ops  # noqa: F401  (registers the "pallas" tag)

import repro_torch.apps.models as torch_apps
from repro_torch.core import (AllOpsResolver, ArenaOverflowError,
                              GreedyMemoryPlanner, LinearMemoryPlanner,
                              MicroInterpreter, MicroModel,
                              MicroMutableOpResolver, OpCode,
                              OpResolutionError, export)
from repro_torch.kernels import quant_matmul as K1

REPO = Path(__file__).resolve().parent.parent

# The int8 models' only float ops are the closing DEQUANTIZE and SOFTMAX
# and the int8 ops are bit-identical (test_torch_micro_ops.py), so their
# outputs agree to float32 rounding of one softmax.
INT8_TOL = 1e-6
# Float models chain up to 30 float32 convolutions; the two frameworks
# sum in different orders.
FLOAT_TOL = 1e-5

APPS = {
    "conv_reference": ("build_conv_reference", {}),
    "hotword": ("build_hotword", {}),
    "vww32": ("build_vww", {"resolution": 32}),
    "fc_stack": ("build_fc_stack", {}),
}
CASES = [(a, q) for a in APPS for q in (False, True) if not
         (a == "hotword" and q)]                   # SVDF has no int8 path
IDS = [f"{a}-{'int8' if q else 'float'}" for a, q in CASES]
N_REQUESTS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module's torch work on one intra-op thread: its tensors are
    small, and with the suite's parallel workers on a shared CPU every
    extra OpenMP thread only waits for a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_x64_alias():
    """Alias ``jax.experimental.enable_x64`` (moved to ``jax.enable_x64``
    in newer jax) for this module's tests only; a no-op where it exists.
    The JAX interpreter's int8 requant runs under it."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        yield


def _jax_blob(app, int8):
    name, kw = APPS[app]
    gb = getattr(jax_apps, name)(**kw)
    if not int8:
        return jax_core.export(gb)
    return jax_core.export(gb, jax_apps.representative_dataset(gb),
                           quantize_int8=True)


def _requests(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32)
            for _ in range(N_REQUESTS)]


def _serve(it, requests):
    outs = []
    for x in requests:
        it.set_input(0, x)
        it.invoke()
        outs.append(np.array(it.output(0)))
    return outs


@pytest.mark.parametrize("app,int8", CASES, ids=IDS)
def test_slice_matches_jax_interpreter(app, int8):
    """Port ("reference",) vs JAX ("reference",), and port ("cuda",
    "reference") on the CPU vs JAX ("pallas", "reference"), over a few
    requests (hotword's SVDF state carries from one to the next)."""
    blob = _jax_blob(app, int8)
    tol = INT8_TOL if int8 else FLOAT_TOL
    for jtags, ttags in [(("reference",), ("reference",)),
                         (("pallas", "reference"), ("cuda", "reference"))]:
        mj = jax_core.MicroModel(blob)
        rj = jax_core.AllOpsResolver(tags=jtags)
        itj = jax_core.MicroInterpreter(
            mj, rj, jax_core.MicroInterpreter.required_arena_size(mj, rj))
        mt = MicroModel(blob)
        rt = AllOpsResolver(tags=ttags)
        itt = MicroInterpreter(mt, rt, MicroInterpreter.required_arena_size(
            mt, rt), device="cpu")
        reqs = _requests(itt.input_spec(0).shape)
        for want, got in zip(_serve(itj, reqs), _serve(itt, reqs)):
            assert got.shape == want.shape and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        assert itt.arena_used_bytes() == itj.arena_used_bytes()


def test_cuda_tag_resolves_and_counts_no_cpu_launches():
    res = AllOpsResolver(tags=("cuda", "reference"))
    assert res.resolve(OpCode.FULLY_CONNECTED).tag == "cuda"
    assert res.resolve(OpCode.ATTENTION).tag == "cuda"
    assert res.resolve(OpCode.CONV_2D).tag == "reference"
    assert AllOpsResolver().resolve(OpCode.FULLY_CONNECTED).tag == \
        "reference"
    gb = torch_apps.build_fc_stack()
    m = MicroModel(export(gb, torch_apps.representative_dataset(gb),
                          quantize_int8=True))
    before = K1.launches
    it = MicroInterpreter(m, res, 1 << 16, device="cpu")
    _serve(it, _requests((1, 64)))
    assert K1.launches == before           # CPU tensors: plain version


# ---------------------------------------------------------------------------
# counterparts of tests/test_interpreter.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def conv_model():
    return MicroModel(export(torch_apps.build_conv_reference()))


@pytest.fixture(scope="module")
def resolver():
    return AllOpsResolver()


def _run(model, resolver, x, **kw):
    size = MicroInterpreter.required_arena_size(model, resolver)
    it = MicroInterpreter(model, resolver, size, device="cpu", **kw)
    it.set_input(0, x)
    it.invoke()
    return it


def test_invoke_matches_repeatedly(conv_model, resolver):
    x = np.random.default_rng(0).normal(0, 1, (1, 16, 16, 1)
                                        ).astype(np.float32)
    it = _run(conv_model, resolver, x)
    first = it.output(0)
    assert first.shape == (1, 10) and np.isfinite(first).all()
    np.testing.assert_allclose(first.sum(), 1.0, rtol=1e-5)
    it.set_input(0, x)
    it.invoke()
    np.testing.assert_array_equal(it.output(0), first)


def test_no_allocation_after_init(conv_model, resolver):
    """The arena is frozen after init and the pooled device buffer is made
    once: invoke allocates from neither."""
    x = np.zeros((1, 16, 16, 1), np.float32)
    it = _run(conv_model, resolver, x)
    assert it.arena.frozen
    before = it.arena_used_bytes()
    allocs = it.shared.alloc_count
    buf = it.shared.buf
    for _ in range(3):
        it.set_input(0, x)
        it.invoke()
    assert it.arena_used_bytes() == before
    assert it.shared.alloc_count == allocs == 1
    assert it.shared.buf is buf
    assert buf.dtype == torch.uint8
    assert buf.numel() == it.alloc.nonpersistent_nbytes


def test_arena_too_small_raises_at_init(conv_model, resolver):
    with pytest.raises(ArenaOverflowError):
        MicroInterpreter(conv_model, resolver, 512, device="cpu")


def test_unregistered_op_raises(conv_model):
    r = MicroMutableOpResolver().add_many(
        [OpCode.CONV_2D, OpCode.MAX_POOL_2D])   # missing FC etc.
    with pytest.raises(OpResolutionError):
        MicroInterpreter(conv_model, r, 1 << 20, device="cpu")


def test_selective_resolver_smaller_than_all_ops(conv_model):
    minimal = MicroMutableOpResolver().add_many(
        [OpCode.CONV_2D, OpCode.MAX_POOL_2D, OpCode.MEAN,
         OpCode.FULLY_CONNECTED, OpCode.SOFTMAX])
    assert minimal.code_nbytes() < AllOpsResolver().code_nbytes()
    it = _run(conv_model, minimal, np.zeros((1, 16, 16, 1), np.float32))
    assert it.output(0).shape == (1, 10)


def test_planner_choice_changes_bytes_not_results(conv_model, resolver):
    x = np.random.default_rng(1).normal(0, 1, (1, 16, 16, 1)
                                        ).astype(np.float32)
    outs, used = [], []
    for planner in (GreedyMemoryPlanner(), LinearMemoryPlanner()):
        it = MicroInterpreter(conv_model, resolver, 1 << 20,
                              planner=planner, device="cpu")
        it.set_input(0, x)
        it.invoke()
        outs.append(it.output(0))
        used.append(it.arena_used_bytes()["nonpersistent"])
    np.testing.assert_array_equal(outs[0], outs[1])
    assert used[0] <= used[1]


def test_offline_plan_used_and_matches(resolver):
    model = MicroModel(export(torch_apps.build_conv_reference(),
                              offline_plan=True))
    assert "OfflineMemoryAllocation" in model.metadata
    x = np.random.default_rng(2).normal(0, 1, (1, 16, 16, 1)
                                        ).astype(np.float32)
    it = _run(model, resolver, x)
    assert it.planner_name == "offline"
    it2 = _run(model, resolver, x, prefer_offline_plan=False)
    assert it2.planner_name == "greedy_ffd"
    np.testing.assert_array_equal(it.output(0), it2.output(0))


def test_variable_tensors_persist_and_reset(resolver):
    """SVDF state is a persistent variable tensor: streaming the same
    frame twice gives different outputs, and reset_variable_tensors()
    restores the initial response."""
    model = MicroModel(export(torch_apps.build_hotword(n_layers=1)))
    it = MicroInterpreter(model, resolver,
                          MicroInterpreter.required_arena_size(model,
                                                               resolver),
                          device="cpu")
    x = np.random.default_rng(3).normal(0, 1, (1, 40)).astype(np.float32)
    first, second = _serve(it, [x, x])
    assert not np.array_equal(first, second)
    it.reset_variable_tensors()
    (third,) = _serve(it, [x])
    np.testing.assert_array_equal(third, first)


def test_int8_model_close_to_float(resolver):
    gb = torch_apps.build_conv_reference()
    x = np.random.default_rng(4).normal(0, 1, (1, 16, 16, 1)
                                        ).astype(np.float32)
    want = _run(MicroModel(export(gb)), resolver, x).output(0)
    mq = MicroModel(export(gb, torch_apps.representative_dataset(gb),
                           quantize_int8=True))
    got = _run(mq, resolver, x).output(0)
    assert np.abs(got - want).max() < 0.1
    assert got.argmax() == want.argmax()


def test_multitenancy_shared_arena(resolver):
    """§4.5: two models in one arena — persistent stacks, nonpersistent is
    the max of the two, results identical to private-arena runs."""
    m1 = MicroModel(export(torch_apps.build_conv_reference()))
    m2 = MicroModel(export(torch_apps.build_hotword(n_layers=1)))
    x1 = np.random.default_rng(5).normal(0, 1, (1, 16, 16, 1)
                                         ).astype(np.float32)
    x2 = np.random.default_rng(6).normal(0, 1, (1, 40)).astype(np.float32)
    p1, p2 = _run(m1, resolver, x1), _run(m2, resolver, x2)

    total = (p1.arena_used_bytes()["total"]
             + p2.arena_used_bytes()["total"] + 4096)
    it1 = MicroInterpreter(m1, resolver, total, device="cpu")
    it2 = MicroInterpreter(m2, resolver, 0, parent=it1)
    assert it2.shared is it1.shared and it2.device == it1.device
    it1.set_input(0, x1)
    it1.invoke()
    it2.set_input(0, x2)
    it2.invoke()
    np.testing.assert_array_equal(it1.output(0), p1.output(0))
    np.testing.assert_array_equal(it2.output(0), p2.output(0))

    shared_usage = it1.arena.usage()
    np1 = p1.arena_used_bytes()["nonpersistent"]
    np2 = p2.arena_used_bytes()["nonpersistent"]
    assert shared_usage.nonpersistent == max(np1, np2)   # Figure 5
    pp1 = p1.arena_used_bytes()["persistent"]
    pp2 = p2.arena_used_bytes()["persistent"]
    assert shared_usage.persistent >= pp1 + pp2 - 32     # stacks (±align)


def test_interleaved_multitenant_invokes(resolver):
    """Models alternate invocations sharing one physical buffer, which
    is made once for the larger tenant."""
    m1 = MicroModel(export(torch_apps.build_conv_reference()))
    m2 = MicroModel(export(torch_apps.build_hotword(n_layers=1)))
    it1 = MicroInterpreter(m1, resolver, 1 << 22, device="cpu")
    it2 = MicroInterpreter(m2, resolver, 0, parent=it1)
    x1 = np.zeros((1, 16, 16, 1), np.float32)
    x2 = np.zeros((1, 40), np.float32)
    outs = []
    for _ in range(2):
        it1.set_input(0, x1)
        it1.invoke()
        outs.append(it1.output(0).copy())
        it2.set_input(0, x2)
        it2.invoke()
    np.testing.assert_array_equal(outs[0], outs[1])
    assert it1.shared.alloc_count == 1


def test_plan_model_alone_and_as_a_tenant(conv_model, resolver):
    """plan_model sizes its own arena, or stacks a tenant's persistents
    under a host arena's and shares its head section (§4.5)."""
    from repro_torch.core import TwoStackArena, plan_model
    alone = plan_model(conv_model, resolver, device="cpu")
    assert alone.arena.size == MicroInterpreter.required_arena_size(
        conv_model, resolver)
    host = TwoStackArena(1 << 20)
    first = plan_model(conv_model, resolver, host_arena=host, device="cpu")
    second = plan_model(conv_model, resolver, host_arena=host, device="cpu")
    assert first.tensor_offset == second.tensor_offset == alone.tensor_offset
    assert host.usage().persistent == 2 * alone.arena.usage().persistent
    assert host.usage().nonpersistent == alone.arena.usage().nonpersistent


def test_memory_report_names_device_and_sizes(conv_model, resolver):
    it = _run(conv_model, resolver, np.zeros((1, 16, 16, 1), np.float32))
    report = it.memory_report()
    assert "device:              cpu" in report
    assert f"{conv_model.nbytes():>10,} B" in report


# ---------------------------------------------------------------------------
# the package boundary and the device contract
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_repro():
    """In a fresh process the port (core, apps, kernels) runs the
    interpreter on the CPU without loading jax or anything of the JAX
    package."""
    code = (
        "import sys, numpy as np\n"
        "sys.path.insert(0, 'src')\n"
        "import repro_torch.kernels\n"
        "from repro_torch.apps.models import build_fc_stack\n"
        "from repro_torch.core import AllOpsResolver, MicroInterpreter, "
        "MicroModel, export\n"
        "m = MicroModel(export(build_fc_stack()))\n"
        "r = AllOpsResolver(tags=('cuda', 'reference'))\n"
        "it = MicroInterpreter(m, r, 1 << 16, device='cpu')\n"
        "it.set_input(0, np.ones((1, 64), np.float32)); it.invoke()\n"
        "assert it.output(0).shape == (1, 8)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_default_device_is_cuda(conv_model, resolver):
    params = inspect.signature(MicroInterpreter).parameters
    assert params["device"].default == "cuda"
    if torch.cuda.is_available():
        it = MicroInterpreter(conv_model, resolver, 1 << 20)
        assert it.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MicroInterpreter(conv_model, resolver, 1 << 20)


@pytest.mark.parametrize("entry", ["plan_model", "AllocationPlan.build",
                                   "ArenaPool", "DenseLM",
                                   "params_from_jax", "MultiTenantHost",
                                   "StreamingServer", "MicroProfiler"])
def test_every_entry_point_defaults_to_cuda(entry, conv_model, resolver):
    """The executor's, the LM's and the serving layer's entry points
    default to the card too, and raise without one rather than plan or
    allocate on the CPU: the host's micro pools, the engine a
    StreamingServer drives, and the interpreter MicroProfiler times (its
    report names the device it ran on)."""
    from repro_torch.configs import get_config
    from repro_torch.core import (AllocationPlan, ArenaPool, TwoStackArena,
                                  plan_model)
    from repro_torch.core.profiler import MicroProfiler
    from repro_torch.launch.serve import StreamingServer
    from repro_torch.models import get_model, lm, params_from_jax
    from repro_torch.serving import MultiTenantHost, ServingEngine
    cfg = get_config("yi-6b", reduced=True)
    card = "cuda" if torch.cuda.is_available() else "cpu"
    x = np.zeros(conv_model.tensor(conv_model.inputs[0]).shape, np.float32)
    # a JAX init_lm tree of zeros (per-layer leaves stacked on L): only
    # where it lands matters
    blk = lm.DenseLM(cfg, device="cpu").layers[0]

    def zeros(module, lead=()):
        return {n: np.zeros((*lead, *p.shape), np.float32)
                for n, p in module.named_parameters() if "." not in n}
    tree = {**zeros(lm.DenseLM(cfg, device="cpu")),
            "blocks": {**zeros(blk, (cfg.n_layers,)),
                       "attn": zeros(blk.attn, (cfg.n_layers,)),
                       "mlp": zeros(blk.mlp, (cfg.n_layers,))}}
    fn, call = {
        "plan_model": (plan_model, lambda: plan_model(conv_model, resolver)),
        "AllocationPlan.build": (
            AllocationPlan.build, lambda: AllocationPlan.build(
                conv_model, resolver, TwoStackArena(1 << 20))),
        "ArenaPool": (ArenaPool, lambda: ArenaPool()),
        "DenseLM": (lm.DenseLM, lambda: lm.DenseLM(cfg).embed),
        "params_from_jax": (params_from_jax,
                            lambda: params_from_jax(tree, cfg).embed),
        "MultiTenantHost": (MultiTenantHost,
                            lambda: MultiTenantHost(1 << 20).ragged.pool),
        "StreamingServer": (ServingEngine, lambda: StreamingServer(
            ServingEngine(get_model(cfg), lm.DenseLM(cfg, device=card),
                          max_slots=1, cache_len=16)).engine),
        "MicroProfiler": (MicroInterpreter, lambda: MicroProfiler.profile(
            MicroInterpreter(conv_model, resolver, 1 << 20), [x], warmup=0,
            iters=1)),
    }[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_no_source_of_the_port_names_jax_or_repro():
    """Statically, no module of the port and not chip_smoke.py imports
    jax or the JAX package (chip_smoke imports the port inside main)."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path.relative_to(REPO)} imports {name}"
