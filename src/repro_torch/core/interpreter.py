"""MicroInterpreter (paper §4.1–4.2) — thin facade over the executor.

Life cycle, exactly as the paper describes:

  1. the application builds an OpResolver (which ops "link in"),
  2. supplies a contiguous memory arena,
  3. constructs the interpreter — ALL allocation happens now: the
     executor's AllocationPlan walks the op list once, each op's
     prepare() communicates its memory needs, the memory planner
     bin-packs the nonpersistent section, the two-stack arena is
     frozen, and the weights move onto the device,
  4. the application writes inputs and calls invoke() — a blocking call
     into the executor's CompiledPlan: no allocation from the arena, no
     graph processing, just the op loop over the arena buffer (on the
     card one CUDA-graph replay, captured at the first invoke),
  5. outputs are read back from the arena.

The interpreter runs on ``device``, which defaults to ``"cuda"``; with no
card that raises, and ``device="cpu"`` runs the plain reference path on
the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .arena import TwoStackArena
from .executor import (AllocationPlan, ArenaPool, CompiledPlan,
                       required_arena_size, resolve_device, setup_device,
                       torch_dtype)
from .memory_planner import MemoryPlan
from .op_resolver import MicroMutableOpResolver, TensorSpec
from .schema import MicroModel


class MicroInterpreter:
    """Interpreter bound one-to-one to a model + arena (Figure 5)."""

    def __init__(
        self,
        model: MicroModel,
        op_resolver: MicroMutableOpResolver,
        arena_size_bytes: int,
        planner: Optional[object] = None,
        prefer_offline_plan: bool = True,
        shared: Optional[ArenaPool] = None,
        parent: Optional["MicroInterpreter"] = None,
        device="cuda",
    ):
        self.model = model
        self.resolver = op_resolver
        if parent is not None:
            # multitenant: stack persistents under the parent's (§4.5)
            self.device = parent.device
            self.arena = parent.arena.fork_tenant()
            self._shared = parent._shared
        else:
            self.device = resolve_device(device)
            self.arena = TwoStackArena(arena_size_bytes)
            self._shared = shared or ArenaPool(self.device)
        if self._shared.device != self.device:
            raise ValueError(f"arena pool on {self._shared.device}, "
                             f"interpreter on {self.device}")
        setup_device(self.device)
        self._set: set = set()
        self._outs: List[np.ndarray] = []

        # plan (all cost paid here, at init)
        self.alloc = AllocationPlan.build(
            model, op_resolver, self.arena, planner, prefer_offline_plan,
            self.device)
        self.compiled = CompiledPlan(self.alloc)
        self._variables: List[torch.Tensor] = self.alloc.zero_variables()
        # the static input tensors the invoke program reads: set_input
        # writes them in place, so every invoke is the same program; on
        # the card through a pinned host twin, one asynchronous copy
        self._inputs: List[torch.Tensor] = [
            torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                        device=self.device)
            for s in (self.alloc.specs[t] for t in model.inputs)]
        self._staging = ([torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                          for t in self._inputs]
                         if self.device.type == "cuda" else self._inputs)
        self._shared.ensure(self.alloc.nonpersistent_nbytes)
        if parent is not None:
            parent.arena.absorb_tenant(self.arena)

    @property
    def planner_name(self) -> str:
        return self.alloc.planner_name

    @property
    def shared(self) -> ArenaPool:
        """The arena pool whose physical buffer this interpreter uses."""
        return self._shared

    # ------------------------------------------------------------------
    # application API (paper §4.1 steps 4–5)
    # ------------------------------------------------------------------

    def set_input(self, pos: int, value: np.ndarray) -> None:
        tid = self.model.inputs[pos]
        spec = self.alloc.specs[tid]
        value = np.asarray(value)
        if tuple(value.shape) != tuple(spec.shape):
            raise ValueError(f"input {pos}: shape {value.shape} != "
                             f"{spec.shape}")
        stage = self._staging[pos]
        stage.copy_(torch.from_numpy(np.ascontiguousarray(value)))
        if stage is not self._inputs[pos]:
            self._inputs[pos].copy_(stage, non_blocking=True)
        self._set.add(pos)

    def input_spec(self, pos: int) -> TensorSpec:
        return self.alloc.specs[self.model.inputs[pos]]

    def output_spec(self, pos: int) -> TensorSpec:
        return self.alloc.specs[self.model.outputs[pos]]

    def invoke(self) -> None:
        """Run the model once on the inputs set; blocks until the outputs
        are on the host."""
        if len(self._set) != len(self.model.inputs):
            raise RuntimeError("not all inputs set")
        buf = self._shared.take()
        try:
            outs = self.compiled.execute(buf, self._variables, self._inputs)
            # copy the outputs out of the arena before another tenant
            # reuses the shared buffer
            self._outs = [o.to("cpu", copy=True).numpy() for o in outs]
        finally:
            self._shared.put(buf)

    def output(self, pos: int) -> np.ndarray:
        return self._outs[pos]

    def reset_variable_tensors(self) -> None:
        for v in self._variables:
            v.zero_()

    # ------------------------------------------------------------------
    # reporting (Table 2 / §5.3)
    # ------------------------------------------------------------------

    def arena_used_bytes(self) -> Dict[str, int]:
        u = self.arena.usage()
        return {
            "persistent": u.persistent,
            "nonpersistent": u.nonpersistent,
            "temp_high_water": u.temp_high_water,
            "total": u.total,
            "capacity": u.capacity,
        }

    def memory_report(self) -> str:
        u = self.arena_used_bytes()
        lines = [
            f"arena capacity:      {u['capacity']:>10,} B",
            f"persistent (tail):   {u['persistent']:>10,} B",
            f"nonpersistent (head):{u['nonpersistent']:>10,} B",
            f"total used:          {u['total']:>10,} B",
            f"planner:             {self.planner_name} "
            f"({len(self.alloc.plan.requests)} buffers -> "
            f"{self.alloc.plan.total_bytes:,} B)",
            f"model blob (flash):  {self.model.nbytes():>10,} B",
            f"linked op code:      {self.resolver.code_nbytes():>10,} B",
            f"device:              {self.device}",
        ]
        return "\n".join(lines)

    def memory_plan(self) -> MemoryPlan:
        return self.alloc.plan

    @staticmethod
    def required_arena_size(model: MicroModel,
                            op_resolver: MicroMutableOpResolver,
                            slack: int = 1024) -> int:
        return required_arena_size(model, op_resolver, slack)
