"""Per-operator profiling hooks (paper §5.4, TFLM micro_profiler), ported
from the JAX package's ``repro.core.profiler``.

TFLM lets a developer instrument code sections and attribute cycles to
operators to find bottlenecks.  The port's invoke is ONE program (a CUDA
graph replay on the card), so per-op attribution needs a separate
instrumented mode: ``MicroProfiler.profile(interp, ...)`` re-runs the op
list eagerly under ``disable_capture()``, one op at a time, waiting for
the device after each op, and measures wall time per operator instance —
the numbers TFLM's hooks produce, at the cost of losing the replay's
single launch (the replayed total of the same invoke is reported beside
them, so that win is visible too).

Timing: host clock around work that ends in ``torch.cuda.synchronize()``
on the card (a device's work is asynchronous; the host clock alone would
measure the enqueue), plain host clock on the CPU.  Every report names
the device it ran on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from .executor import _spec_nbytes, disable_capture, torch_dtype
from .schema import OpCode

_OP_NAMES = {v: k for k, v in vars(OpCode).items()
             if isinstance(v, int) and not k.startswith("_")}


def _wait(device: torch.device) -> None:
    """Block until ``device`` has run everything enqueued on it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class OpProfile:
    """Wall time and output size of one op in an eager profiling run."""

    index: int
    op_name: str
    wall_us: float
    out_bytes: int

    def line(self) -> str:
        return (f"  [{self.index:3d}] {self.op_name:20s} "
                f"{self.wall_us:9.1f} us  ({self.out_bytes} B out)")


@dataclasses.dataclass
class ProfileReport:
    """Per-op eager timings next to the replayed invoke's total — the
    paper's §4.6 profiler surface — on ``device``."""

    per_op: List[OpProfile]
    fused_total_us: float
    device: torch.device = torch.device("cpu")

    @property
    def eager_total_us(self) -> float:
        return sum(p.wall_us for p in self.per_op)

    def by_op_type(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for p in self.per_op:
            out[p.op_name] = out.get(p.op_name, 0.0) + p.wall_us
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def bottleneck(self) -> str:
        return next(iter(self.by_op_type()))

    def render(self) -> str:
        lines = [f"per-operator profile on {self.device} (eager, one op at "
                 f"a time):"]
        lines += [p.line() for p in self.per_op]
        win = self.eager_total_us / max(self.fused_total_us, 1e-9)
        lines.append(f"  eager total: {self.eager_total_us:.1f} us   "
                     f"replayed invoke: {self.fused_total_us:.1f} us   "
                     f"(replay win {win:.2f}x)")
        lines.append("by op type (bottlenecks first):")
        for name, us in self.by_op_type().items():
            lines.append(f"  {name:20s} {us:9.1f} us")
        return "\n".join(lines)


@dataclasses.dataclass
class CompileStepTiming:
    """One calibration measurement: the COLD first call of a program
    (``compile_us``: on the card its eager run plus its CUDA-graph
    capture) next to its WARM steady-state cost (median of ``iters``
    replays, ``step_us``).

    This is the measurement primitive a calibration cost model builds
    on: a bucket's value is its warm step latency, its price the
    one-time capture it adds — both sides of the trade in one pair."""

    compile_us: float
    step_us: float
    iters: int

    @property
    def trace_overhead_us(self) -> float:
        """What the first call paid beyond a warm step — the capture
        cost a bucket table charges per level it actually hits."""
        return max(self.compile_us - self.step_us, 0.0)


def _block_on(result: Any) -> None:
    """Wait for every card that holds a tensor of ``result``."""
    leaves, _ = tree_flatten(result)
    for dev in {x.device for x in leaves
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def measure_compile_and_step(fn, *args, iters: int = 5,
                             block=None) -> CompileStepTiming:
    """Time ``fn(*args)`` cold (the first call: for a ``CapturedProgram``
    on the card, its eager run plus the capture) and warm (median of
    ``iters`` further calls: replays).

    ``fn`` must not have been called with this signature before,
    otherwise the "cold" call is already warm and the measured capture
    cost collapses to a step cost.  ``block`` (by default: synchronize
    every card holding a tensor of the result) waits for the device
    inside each timed call, so the asynchronous launch cannot leak device
    time out of the measurement."""
    if block is None:
        block = _block_on
    t0 = time.perf_counter()
    block(fn(*args))
    compile_us = (time.perf_counter() - t0) * 1e6
    times = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        block(fn(*args))
        times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return CompileStepTiming(compile_us=compile_us,
                             step_us=times[len(times) // 2],
                             iters=len(times))


class MicroProfiler:
    """Paper §5.4: instrument the interpreter's operator sequence."""

    @staticmethod
    def profile(interp, inputs: List[np.ndarray], *, warmup: int = 2,
                iters: int = 5) -> ProfileReport:
        """Profile ``interp`` (a ``MicroInterpreter``, on its device) on
        ``inputs``: the replayed invoke's mean time, then each op of its
        plan eagerly, one at a time, on the values the ops before it
        produced (the variables start from zero)."""
        alloc = interp.alloc
        model = alloc.model
        device = interp.device

        # the production invoke (replayed on the card), up to its outputs
        def fused():
            for i, x in enumerate(inputs):
                interp.set_input(i, x)
            interp.invoke()
            interp.output(0)
        for _ in range(warmup):
            fused()
        _wait(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fused()
        _wait(device)
        fused_us = (time.perf_counter() - t0) / iters * 1e6

        # eager per-op execution over a value environment
        def typed(t, value):
            spec = alloc.specs[t]
            return value.reshape(spec.shape).to(torch_dtype(spec.dtype))
        env: Dict[int, torch.Tensor] = {}
        var_env = {t: torch.zeros(alloc.var_specs[i].shape,
                                  dtype=torch_dtype(alloc.var_specs[i].dtype),
                                  device=device)
                   for t, i in alloc.var_pos.items()}
        for pos, tid in enumerate(model.inputs):
            env[tid] = typed(tid, torch.as_tensor(np.asarray(inputs[pos]),
                                                  device=device))
        profiles: List[OpProfile] = []
        with disable_capture(), torch.no_grad():
            for idx, opp in enumerate(alloc.op_plans):
                op = opp.op
                vals = []
                for t in op.inputs:
                    if t < 0:
                        vals.append(None)
                    elif t in alloc.const_pos:
                        vals.append(alloc.consts[alloc.const_pos[t]])
                    elif t in var_env and t not in env:
                        vals.append(var_env[t])
                    else:
                        vals.append(env[t])

                def run():
                    return opp.registration.eval(opp.eval_ctx, op, vals)
                for _ in range(warmup):
                    run()
                _wait(device)
                t0 = time.perf_counter()
                for _ in range(iters):
                    outs = run()
                    _wait(device)
                us = (time.perf_counter() - t0) / iters * 1e6
                n_out = len(op.outputs)
                for t, o in zip(op.outputs, outs[:n_out]):
                    env[t] = typed(t, o)
                for t, v in zip(opp.prep.variable_updates, outs[n_out:]):
                    var_env[t] = v.to(var_env[t].dtype)
                profiles.append(OpProfile(
                    index=idx,
                    op_name=_OP_NAMES.get(op.opcode, str(op.opcode)),
                    wall_us=us,
                    out_bytes=sum(_spec_nbytes(alloc.specs[t])
                                  for t in op.outputs)))
        return ProfileReport(per_op=profiles, fused_total_us=fused_us,
                             device=device)
