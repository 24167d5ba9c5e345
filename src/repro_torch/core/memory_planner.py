"""Memory planners (paper §4.4.2, Figure 4).

Intermediate tensors are rectangles in (time × size) space: each buffer is
needed from just before the op that populates it until the last op that
reads it.  Compacting them is bin packing; TF Micro uses *first-fit
decreasing* (Garey et al., 1972): sort requirements by size descending and
place each at the lowest offset where it does not collide with any
already-placed buffer whose lifetime overlaps.

Planners provided:

* ``GreedyMemoryPlanner``  — first-fit decreasing (the paper's planner).
* ``LinearMemoryPlanner``  — no reuse; every buffer gets its own offset
  (the paper's "simplistic approach [that] works well for initial
  prototyping, but wastes memory"); the baseline in Figure 4a.
* ``OfflineMemoryPlanner`` — replays a precomputed offset array carried in
  model metadata (paper: "offline-planned tensor allocation").

All planners are pure Python over integer byte ranges — they run in the
interpreter init phase only, matching the paper's "more overhead during
model preparation ... benefit of model generality" trade-off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .arena import DEFAULT_ALIGN, align_up


@dataclass(frozen=True)
class BufferRequest:
    """One rectangle: `nbytes` needed on [first_use, last_use] (op indices,
    inclusive)."""
    nbytes: int
    first_use: int
    last_use: int
    tag: str = ""

    def __post_init__(self):
        if self.nbytes < 0:
            raise ValueError("negative buffer size")
        if self.last_use < self.first_use:
            raise ValueError(f"lifetime ends before it starts: {self}")

    def overlaps_in_time(self, other: "BufferRequest") -> bool:
        return not (self.last_use < other.first_use
                    or other.last_use < self.first_use)


@dataclass
class MemoryPlan:
    """A planner's output: one byte offset per BufferRequest inside a
    ``total_bytes`` nonpersistent section, time-overlap safe
    (``validate()`` proves it)."""

    offsets: List[int]            # parallel to the request list
    total_bytes: int
    requests: List[BufferRequest]

    def validate(self) -> None:
        """No two time-overlapping buffers may overlap in address space."""
        n = len(self.requests)
        for i in range(n):
            ri, oi = self.requests[i], self.offsets[i]
            if oi + ri.nbytes > self.total_bytes:
                raise AssertionError(f"buffer {i} exceeds plan size")
            for j in range(i + 1, n):
                rj, oj = self.requests[j], self.offsets[j]
                if not ri.overlaps_in_time(rj):
                    continue
                if oi < oj + rj.nbytes and oj < oi + ri.nbytes:
                    raise AssertionError(
                        f"planned buffers {i} ({ri.tag}) and {j} ({rj.tag}) "
                        f"overlap in both time and space")

    def to_metadata(self) -> bytes:
        """Serialize offsets for embedding as model metadata (§4.4.2
        offline-planned tensor allocation)."""
        import struct

        out = struct.pack("<IQ", len(self.offsets), self.total_bytes)
        out += struct.pack(f"<{len(self.offsets)}q", *self.offsets)
        return out

    @staticmethod
    def offsets_from_metadata(raw: bytes) -> Tuple[List[int], int]:
        import struct

        n, total = struct.unpack_from("<IQ", raw, 0)
        offsets = list(struct.unpack_from(f"<{n}q", raw, 12))
        return offsets, total


class LinearMemoryPlanner:
    """No-reuse baseline (Figure 4a)."""

    name = "linear"

    def plan(self, requests: Sequence[BufferRequest],
             alignment: int = DEFAULT_ALIGN) -> MemoryPlan:
        offsets, cur = [], 0
        for r in requests:
            cur = align_up(cur, alignment)
            offsets.append(cur)
            cur += r.nbytes
        return MemoryPlan(offsets, cur, list(requests))


class GreedyMemoryPlanner:
    """First-fit decreasing over (time, address) rectangles (Figure 4b)."""

    name = "greedy_ffd"

    def plan(self, requests: Sequence[BufferRequest],
             alignment: int = DEFAULT_ALIGN) -> MemoryPlan:
        order = sorted(range(len(requests)),
                       key=lambda i: (-requests[i].nbytes,
                                      requests[i].first_use, i))
        offsets: List[Optional[int]] = [None] * len(requests)
        placed: List[int] = []          # indices already placed
        total = 0
        for i in order:
            r = requests[i]
            # Gather address intervals blocked by time-overlapping buffers.
            blockers = sorted(
                (offsets[j], offsets[j] + requests[j].nbytes)  # type: ignore
                for j in placed if r.overlaps_in_time(requests[j]))
            # First fit: lowest aligned offset with a big-enough gap.
            candidate = 0
            for lo, hi in blockers:
                if candidate + r.nbytes <= lo:
                    break
                candidate = max(candidate, align_up(hi, alignment))
            offsets[i] = candidate
            placed.append(i)
            total = max(total, candidate + r.nbytes)
        plan = MemoryPlan([int(o) for o in offsets], total, list(requests))
        plan.validate()
        return plan


class OfflineMemoryPlanner:
    """Replays a host-computed plan shipped in model metadata.

    Paper: "allows a more compact memory plan, gives memory-plan ownership
    and control to the end user, imposes less overhead on the MCU during
    initialization".
    """

    name = "offline"
    METADATA_KEY = "OfflineMemoryAllocation"

    def __init__(self, metadata: bytes):
        self._offsets, self._total = MemoryPlan.offsets_from_metadata(metadata)

    def plan(self, requests: Sequence[BufferRequest],
             alignment: int = DEFAULT_ALIGN) -> MemoryPlan:
        if len(requests) != len(self._offsets):
            raise ValueError(
                f"offline plan covers {len(self._offsets)} buffers but the "
                f"model needs {len(requests)}")
        plan = MemoryPlan(list(self._offsets), self._total, list(requests))
        plan.validate()                  # do not trust stale offline plans
        return plan


def select_planner(metadata: Dict[str, bytes], planner: Optional[object],
                   prefer_offline_plan: bool = True):
    """Planner choice for one model: an explicit planner wins; else the
    offline plan shipped in model metadata (§4.4.2) when preferred and
    present; else first-fit decreasing."""
    if planner is not None:
        return planner
    offline = metadata.get(OfflineMemoryPlanner.METADATA_KEY)
    if prefer_offline_plan and offline is not None:
        return OfflineMemoryPlanner(offline)
    return GreedyMemoryPlanner()


def plan_nonpersistent(op_inputs, op_outputs, planned_nbytes,
                       graph_inputs, graph_outputs, scratch, planner
                       ) -> Tuple[MemoryPlan, Dict[int, int], int]:
    """Plan a graph's nonpersistent arena section.

    Derives lifetimes for every planned intermediate tensor, runs the
    planner, and returns ``(plan, tensor_offset, scratch_bytes)``.
    Op-local scratch is always planned online, even under an offline
    tensor plan (TFLM: scratch comes from RequestScratchBufferInArena at
    prepare time); it packs into its own region above the tensors.
    """
    n_ops = len(op_inputs)
    tensor_requests, tensor_ids = lifetimes_from_graph(
        n_ops, op_inputs, op_outputs, planned_nbytes,
        graph_inputs, graph_outputs, None)
    scratch_requests, _ = lifetimes_from_graph(
        n_ops, [()] * n_ops, [()] * n_ops, {}, (), (), scratch)
    plan = planner.plan(tensor_requests)
    tensor_offset = {
        tid: plan.offsets[req_idx]
        for req_idx, tid in enumerate(tensor_ids) if tid >= 0}
    scratch_plan = GreedyMemoryPlanner().plan(scratch_requests) \
        if scratch_requests else None
    return plan, tensor_offset, (scratch_plan.total_bytes
                                 if scratch_plan else 0)


def lifetimes_from_graph(
    n_ops: int,
    op_inputs: Sequence[Sequence[int]],
    op_outputs: Sequence[Sequence[int]],
    tensor_nbytes: Dict[int, int],
    graph_inputs: Sequence[int],
    graph_outputs: Sequence[int],
    scratch: Optional[Dict[int, Sequence[int]]] = None,
) -> Tuple[List[BufferRequest], List[int]]:
    """Derive BufferRequests for every non-const intermediate tensor.

    Returns (requests, tensor_ids) — parallel lists.  Model inputs are live
    from op 0; model outputs are live through the final op (they must
    survive for the application to read, §4.1).  ``scratch`` maps op index
    -> list of scratch sizes requested by that op's prepare() — each lives
    only during its own op.
    """
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for t in graph_inputs:
        first[t] = 0
    for oi in range(n_ops):
        for t in op_outputs[oi]:
            first.setdefault(t, oi)
            last[t] = max(last.get(t, oi), oi)
        for t in op_inputs[oi]:
            if t < 0:
                continue
            if t in first:
                last[t] = max(last.get(t, oi), oi)
    for t in graph_outputs:
        if t in first:
            last[t] = n_ops - 1 if n_ops else 0
    requests, ids = [], []
    for t in sorted(first):
        if t not in tensor_nbytes:
            continue                      # const / variable: not planned here
        requests.append(BufferRequest(
            nbytes=tensor_nbytes[t],
            first_use=first[t],
            last_use=last.get(t, first[t]),
            tag=f"tensor{t}"))
        ids.append(t)
    if scratch:
        for oi, sizes in sorted(scratch.items()):
            for k, nb in enumerate(sizes):
                requests.append(BufferRequest(
                    nbytes=int(nb), first_use=oi, last_use=oi,
                    tag=f"scratch{oi}.{k}"))
                ids.append(-(oi * 1000 + k + 1))   # synthetic id for scratch
    return requests, ids
