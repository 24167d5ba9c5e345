"""The port's MicroProfiler (core/profiler.py, paper §5.4) on the CPU,
tests/test_profiler.py's two cases in the port's terms and held to the
JAX profiler on the same blobs: the same op list, op types and output
sizes; per-op attribution finds the bottleneck (a convolution), and the
eager per-op total stands beside the replayed invoke's.  Then
``measure_compile_and_step``'s fields on a port program."""

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.apps as jax_apps
import repro.core as jax_core
from repro.core.profiler import MicroProfiler as JaxMicroProfiler

from repro_torch.core import (AllOpsResolver, CapturedProgram,
                              MicroInterpreter, MicroModel, capture_count)
from repro_torch.core.profiler import (CompileStepTiming, MicroProfiler,
                                       ProfileReport,
                                       measure_compile_and_step)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_x64_alias():
    """Alias ``jax.experimental.enable_x64`` (moved to ``jax.enable_x64``
    in newer jax) for this module's JAX interpreters only."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        yield


def _profiles(build, seed, warmup, iters):
    """(JAX report, port report, port interpreter) of one exported graph
    on the same seeded inputs."""
    gb = build()
    blob = jax_core.export(gb)
    rng = np.random.default_rng(seed)
    xs = [rng.normal(0, 1, gb.tensors[t].shape).astype(np.float32)
          for t in gb.inputs]
    jmodel, jres = jax_core.MicroModel(blob), jax_core.AllOpsResolver()
    jit = jax_core.MicroInterpreter(
        jmodel, jres, jax_core.MicroInterpreter.required_arena_size(
            jmodel, jres))
    jrep = JaxMicroProfiler.profile(jit, xs, warmup=warmup, iters=iters)
    model, res = MicroModel(blob), AllOpsResolver()
    it = MicroInterpreter(model, res, MicroInterpreter.required_arena_size(
        model, res), device="cpu")
    rep = MicroProfiler.profile(it, xs, warmup=warmup, iters=iters)
    return jrep, rep, it


def _same_ops(jrep, rep):
    assert [(p.index, p.op_name, p.out_bytes) for p in rep.per_op] == \
        [(p.index, p.op_name, p.out_bytes) for p in jrep.per_op]
    assert set(rep.by_op_type()) == set(jrep.by_op_type())


def test_profile_conv_reference():
    jrep, rep, it = _profiles(jax_apps.build_conv_reference, 0, 1, 3)
    _same_ops(jrep, rep)
    assert len(rep.per_op) == len(it.alloc.op_plans)
    assert rep.eager_total_us > 0 and rep.fused_total_us > 0
    assert all(p.wall_us >= 0 for p in rep.per_op)
    assert rep.device == torch.device("cpu")
    # conv model: linear algebra dominates run time (the paper's premise)
    assert rep.bottleneck() in ("CONV_2D", "FULLY_CONNECTED",
                                "DEPTHWISE_CONV_2D")
    text = rep.render()
    assert "bottlenecks first" in text and "CONV_2D" in text
    assert "replayed invoke" in text and "on cpu" in text


def test_profile_vww_bottleneck_is_conv():
    jrep, rep, _ = _profiles(jax_apps.build_vww, 1, 1, 2)
    _same_ops(jrep, rep)
    by_type = rep.by_op_type()
    conv_us = sum(v for k, v in by_type.items() if "CONV" in k)
    assert conv_us > 0.5 * rep.eager_total_us, by_type
    assert "CONV" in rep.bottleneck()
    assert list(by_type.values()) == sorted(by_type.values(), reverse=True)


def test_measure_compile_and_step_fields():
    """The first call of a fresh program signature is the cold one (on
    the card its eager run and its capture), the median of ``iters``
    later calls the warm step; ``block`` is called on every result."""
    prog = CapturedProgram(lambda x: x * 2 + 1, name="affine")
    x = torch.arange(16, dtype=torch.float32)
    blocked = []
    timing = measure_compile_and_step(prog, x, iters=4,
                                      block=blocked.append)
    assert isinstance(timing, CompileStepTiming)
    assert timing.iters == 4 and len(blocked) == 5
    assert timing.compile_us > 0 and timing.step_us > 0
    assert timing.trace_overhead_us == max(timing.compile_us
                                           - timing.step_us, 0.0)
    assert torch.equal(blocked[-1], x * 2 + 1)
    assert capture_count(prog) == 1
    # the default block waits for the device of a result's tensors (none
    # on the CPU) and a zero iteration count still times one step
    timing = measure_compile_and_step(prog, x, iters=0)
    assert timing.iters == 1 and timing.step_us > 0


def test_report_surface():
    from repro_torch.core.profiler import OpProfile
    rep = ProfileReport(per_op=[OpProfile(0, "A", 3.0, 4),
                                OpProfile(1, "B", 5.0, 8),
                                OpProfile(2, "A", 4.0, 4)],
                        fused_total_us=6.0)
    assert rep.eager_total_us == 12.0
    assert rep.by_op_type() == {"A": 7.0, "B": 5.0}
    assert rep.bottleneck() == "A"
    assert "(replay win 2.00x)" in rep.render()
