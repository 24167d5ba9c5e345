"""Multitenant model hosting (paper §4.5, Figure 5) at pod scale, ported
from the JAX package's ``repro.serving.host``.

Several ``ServingEngine`` instances share ONE TwoStackArena exactly the
way TF Micro lets multiple interpreters share one arena:

  * each model's KV cache is an interpreter-lifetime (tail/persistent)
    allocation — persistent sections STACK per tenant;
  * prefill/decode scratch is function-lifetime (head) — the
    nonpersistent section is sized to the LARGEST requirement across
    tenants and is reused because tenants run non-concurrently;
  * admission fails loudly (ArenaOverflowError) when the stacks would
    cross — the paper's capacity-error semantics.

Micro-models are first-class tenants too, in two flavours:

  * ``add_micro_model`` — lockstep batch granularity: an
    ``InterpreterPool`` advances B identical lanes per program replay
    (``run_micro`` chunks a request list);
  * ``add_ragged_micro`` + ``submit_micro`` — request granularity: the
    tenant becomes a bucket of ONE shared ``RaggedInterpreterPool``.
    Requests are streams of frames; lanes are admitted as they free up,
    carry per-request continuation state across waves, and retire
    mid-flight without a new capture — so the micro path (e.g. the int8
    FC/SVDF families) and the pod engines drain through ONE scheduler,
    ``run_all``.

Scheduling (docs/SCHEDULING.md): the host owns ONE ``SchedulingPolicy``
(FIFO / priority-with-aging / EDF / per-tenant WFQ) and ONE ``clock``;
every engine it creates and every ragged micro queue admits through
them, so a deadline set on a pod ``Request`` and one set on a
``MicroRequest`` compete under the same rules.  It also owns the shared
``BucketTable`` pair: prompt-length buckets (engines compile prefill
once per bucket, and the bucket boundaries agree across tenants) and
lane-count buckets (ragged micro buckets round their lane counts so
nearby tenants share ``ArenaPool`` free lists).

Preemption (docs/PREEMPTION.md): give the host a ``PreemptionPolicy``
(``preempt="edf-displace"`` or a ``WFQDisplacePolicy``) and
``micro_step`` may EVICT a running lane when admission alone cannot
serve an urgent queued request: the victim's continuation state is
snapshotted host-side (``RaggedInterpreterPool.snapshot_lane``), the
lane retired, the victim re-queued; when the policy re-keys it to the
front of a free lane again, ``restore_lane`` resumes it bit-identically
from its checkpoint.  Preemption is lane-table surgery between
dispatches — the masked programs and their masks are untouched,
so preempt/resume cycles never capture a program again.

Compile-once invariants this module maintains:

  * **captured once** — each engine's decode step and each micro
    bucket's masked batched program is one ``CapturedProgram``: one CUDA
    graph, captured at its first call and replayed after (prefill one
    per bucket).  Scheduling decisions (admission order) are host-side
    Python over the queues; they never capture a program again.
  * **in place** — micro arena buffers and variable stacks cycle through
    the shared ``ArenaPool``; engine caches are device tensors the
    decode step updates in place.
  * **may vary per call** — request content (tokens, frames), slot/lane
    occupancy masks, and step counters.  Admitting a TENANT (a new
    model) is the only act that plans or allocates; admitting a REQUEST
    only flips lane-table state.

The host runs on ``device`` (``"cuda"`` by default, raising without a
card; ``"cpu"`` runs the plain reference path): its micro pools live
there, and every engine it makes serves there.  ``profile=`` (a
``CalibrationProfile``, ``core/costmodel.py``) gives every bucketed
tenant the profile's solved table, one table shared by all, and every
chunkable tenant its chunk size; a profile measured on another device
than the host's is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.arena import TwoStackArena, align_up
from repro_torch.core.executor import (ArenaPool, BucketTable,
                                       InterpreterPool, LaneCheckpoint,
                                       RaggedInterpreterPool, resolve_device)
from repro_torch.core.op_resolver import MicroMutableOpResolver
from repro_torch.core.schema import MicroModel
from repro_torch.models.registry import ModelBundle

from .engine import (BUCKETED_FAMILIES, CHUNKED_FAMILIES, Request,
                     RequestResult, ServingEngine, default_clock)
from .router import ReplicaRouter
from .scheduling import (PreemptionPolicy, SchedulingPolicy, get_policy,
                         get_preemption)


@dataclasses.dataclass
class MicroRequest:
    """A request-granularity micro-model job: ``frames[t]`` holds the
    per-input-position arrays the model consumes on its t-th invocation
    (one entry → single-shot; several → a streaming continuation).
    Carries the same scheduling fields as the pod ``Request`` so one
    policy orders both tenancies; ``tenant`` (defaulted to the micro
    tenant's name at submit) is the WFQ quota label."""

    uid: int
    frames: List[List[np.ndarray]]
    priority: int = 0                   # lower = more urgent
    deadline_us: Optional[int] = None   # absolute host time, EDF key
    arrival_us: Optional[int] = None    # stamped at submit_micro()
    tenant: str = ""                    # WFQ quota label


@dataclasses.dataclass
class MicroRequestResult:
    """Per-request outcome of the ragged micro path: output 0 after
    every completed step, plus the step count at completion and how
    many times the request was preempted (0 = ran uninterrupted)."""

    uid: int
    outputs: List[np.ndarray] = dataclasses.field(default_factory=list)
    steps: int = 0
    done: bool = False
    preemptions: int = 0


def _scratch_bytes(bundle: ModelBundle, max_prompt: int) -> int:
    """Head-section budget: activation scratch for the largest prefill."""
    cfg = bundle.cfg
    dt = 2 if cfg.dtype == "bfloat16" else 4
    # hidden + attention transients for one prompt (engine batch=1)
    return align_up(max_prompt * cfg.d_model * dt * 8)


class MultiTenantHost:
    """One arena, many models — never running concurrently."""

    def __init__(self, arena_bytes: int, *, policy: Any = None,
                 clock=None, preempt: Any = None, profile: Any = None,
                 on_token: Any = None, device="cuda"):
        self.device = resolve_device(device)
        if profile is not None and not profile.matches_device(self.device):
            raise ValueError(
                f"profile was measured on {profile.measured_on()!r}, not on "
                f"this host's {self.device} — costs are hardware facts; "
                f"re-calibrate on this device")
        self.arena = TwoStackArena(arena_bytes)
        self.engines: Dict[str, ServingEngine] = {}
        self.routers: Dict[str, ReplicaRouter] = {}
        self.micro: Dict[str, InterpreterPool] = {}
        self._micro_pool = ArenaPool(self.device)
        self.ragged = RaggedInterpreterPool(pool=self._micro_pool)
        self._micro_queue: Dict[str, List[MicroRequest]] = {}
        self._micro_inflight: Dict[str, Dict[int, MicroRequest]] = {}
        self.micro_results: Dict[str, Dict[int, MicroRequestResult]] = {}
        self._micro_ckpt: Dict[str, Dict[int, LaneCheckpoint]] = {}
        self._scratch_high = 0
        self.policy: SchedulingPolicy = get_policy(policy)
        self.preempt: Optional[PreemptionPolicy] = get_preemption(preempt)
        self.clock = clock if clock is not None else default_clock
        # one host-wide streaming sink: every tenant engine's per-token
        # StreamEvents (docs/STREAMING.md) funnel through it — uids are
        # caller-assigned, so a multi-tenant consumer demuxes by uid
        self.on_token = on_token
        # the shared bucket tables: one for prompt lengths (engines
        # agree on prefill bucket boundaries), one for ragged lane
        # counts (nearby tenants share ArenaPool free lists).  With a
        # CalibrationProfile the prompt table is the profile's SOLVED
        # layout, deliberately shared across every tenant (engines of
        # other models reuse the layout, not the measurements); with
        # no profile, it is the hand-picked pow2 default.
        self.profile = profile
        if profile is not None:
            self.prompt_buckets = profile.bucket_table()
        else:
            self.prompt_buckets = BucketTable(min_bucket=8,
                                              max_bucket=4096)
        self.lane_buckets = BucketTable(min_bucket=2, max_bucket=1024)

    def _make_engine(self, bundle: ModelBundle, params: Any, *,
                     max_slots: int, cache_len: int, max_prompt: int,
                     mesh: Any = None, overlap: bool = False,
                     weight_dtype: Any = None, kv_dtype: Any = None
                     ) -> ServingEngine:
        """Build one tenant engine wired to the host's shared arena,
        policy, clock, preemption, profile, streaming sink, device and
        prompt-bucket table (family permitting), growing the shared
        scratch reservation to the new maximum — the construction path
        ``add_model`` and every ``add_replicated_model`` replica go
        through.  ``mesh`` goes to the engine: every replica is sharded
        over the same ``model`` group, and replicas of one ``params``
        share this rank's weights (``shard_params`` makes them once)."""
        bucketable = bundle.cfg.family in BUCKETED_FAMILIES
        chunkable = bundle.cfg.family in CHUNKED_FAMILIES
        buckets = self.prompt_buckets if bucketable else False
        chunk = (self.profile.prefill_chunk or None
                 if self.profile is not None and chunkable else None)
        eng = ServingEngine(bundle, params, max_slots=max_slots,
                            cache_len=cache_len, arena=self.arena,
                            policy=self.policy, clock=self.clock,
                            prefill_buckets=buckets,
                            prefill_chunk=chunk,
                            preempt=self.preempt, mesh=mesh,
                            overlap=overlap, on_token=self.on_token,
                            weight_dtype=weight_dtype, kv_dtype=kv_dtype,
                            device=self.device)
        scratch = _scratch_bytes(bundle, max_prompt)
        if scratch > self._scratch_high:
            # grow the shared head-section reservation to the new max
            self.arena.allocate_temp(scratch - self._scratch_high)
            self.arena.reset_temp()
            self._scratch_high = scratch
        return eng

    def add_model(self, name: str, bundle: ModelBundle, params: Any, *,
                  max_slots: int = 2, cache_len: int = 128,
                  max_prompt: int = 64, mesh: Any = None,
                  overlap: bool = False, weight_dtype: Any = None,
                  kv_dtype: Any = None) -> ServingEngine:
        """Admit a tenant: its KV cache stacks persistently; the shared
        nonpersistent (head) section grows to the max requirement.  The
        engine admits through the host's policy/clock and buckets its
        prefill lengths through the host's shared prompt table (when
        its family supports bucketing).  ``mesh`` shards the tenant's
        weights and KV arena over the mesh's ``model`` axis
        (docs/ARCHITECTURE.md §9); ``overlap`` runs the tenant's decode
        loop with deferred readback (docs/STREAMING.md), streaming
        per-token events to the host's ``on_token`` sink;
        ``weight_dtype``/``kv_dtype`` serve the tenant quantized
        (docs/QUANTIZATION.md) — per tenant, so fp and quantized
        tenants of one host share the arena and the scheduler.
        ``params`` is the model module, on the host's device."""
        if name in self.engines or name in self.routers:
            raise ValueError(f"tenant {name!r} already exists")
        eng = self._make_engine(bundle, params, max_slots=max_slots,
                                cache_len=cache_len,
                                max_prompt=max_prompt, mesh=mesh,
                                overlap=overlap,
                                weight_dtype=weight_dtype,
                                kv_dtype=kv_dtype)
        self.engines[name] = eng
        return eng

    def add_replicated_model(self, name: str, bundle: ModelBundle,
                             params: Any, *, replicas: int = 2,
                             routing: Any = None, max_slots: int = 2,
                             cache_len: int = 128, max_prompt: int = 64,
                             mesh: Any = None, overlap: bool = False,
                             weight_dtype: Any = None,
                             kv_dtype: Any = None) -> ReplicaRouter:
        """Admit a tenant served by ``replicas`` engine replicas behind
        a ``ReplicaRouter`` — the data-parallel axis of ROADMAP item 2.
        Each replica is a full engine tenant of the shared arena (its
        KV stacks persistently like any other tenant's) sharing the
        host's policy/clock/preemption, and arrivals submitted via
        ``submit(name, …)`` are load-balanced across them by the
        ``routing`` policy (round-robin / least-loaded / locality).  The
        replicas share the one weight module ``params``, each with its
        own KV."""
        if name in self.engines or name in self.routers:
            raise ValueError(f"tenant {name!r} already exists")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        engs = [self._make_engine(bundle, params, max_slots=max_slots,
                                  cache_len=cache_len,
                                  max_prompt=max_prompt, mesh=mesh,
                                  overlap=overlap,
                                  weight_dtype=weight_dtype,
                                  kv_dtype=kv_dtype)
                for _ in range(replicas)]
        router = ReplicaRouter(engs, routing=routing)
        self.routers[name] = router
        return router

    def add_micro_model(self, name: str, model: MicroModel,
                        resolver: MicroMutableOpResolver, *,
                        batch: int = 1) -> InterpreterPool:
        """Admit a µFB micro-model tenant served at batch granularity:
        its persistents stack in the shared arena under the engines' KV
        caches, and its pooled nonpersistent buffers come from the one
        ArenaPool all micro tenants share (they run non-concurrently),
        on the host's device."""
        pool = InterpreterPool(model, resolver, batch,
                               host_arena=self.arena,
                               pool=self._micro_pool)
        self.micro[name] = pool
        return pool

    def add_ragged_micro(self, name: str, model: MicroModel,
                         resolver: MicroMutableOpResolver, *,
                         lanes: int = 4, exact: bool = False,
                         bucket_lanes: bool = True) -> None:
        """Admit a request-granularity micro tenant: a bucket of the
        host's shared RaggedInterpreterPool.  Persistents stack in the
        shared arena like every other tenant; all planning and
        compilation happens HERE — ``submit_micro`` and the scheduler
        only touch the lane table.

        ``bucket_lanes`` (default True) rounds ``lanes`` up through the
        host's shared lane BucketTable so nearby tenants reuse the same
        stacked ``ArenaPool`` buffers — the extra lanes are real (wider
        dispatch, more per-lane arena state, more admissible requests);
        pass False to get exactly ``lanes``."""
        self.ragged.add_bucket(name, model, resolver, lanes,
                               host_arena=self.arena, exact=exact,
                               lane_buckets=(self.lane_buckets
                                             if bucket_lanes else None))
        self._micro_queue[name] = []
        self._micro_inflight[name] = {}
        self._micro_ckpt[name] = {}
        self.micro_results[name] = {}

    def submit_micro(self, name: str, uid: int,
                     frames: Sequence[Sequence[np.ndarray]], *,
                     priority: int = 0,
                     deadline_us: Optional[int] = None,
                     arrival_us: Optional[int] = None,
                     tenant: Optional[str] = None) -> None:
        """Queue a micro request: ``frames[t]`` are the input arrays for
        the request's t-th invocation (len 1 = single shot, more = a
        streaming continuation across waves).  ``priority`` /
        ``deadline_us`` feed the host's scheduling policy; ``tenant``
        (default: the micro tenant's name) is the WFQ quota label."""
        frames = [list(f) for f in frames]
        if not frames:
            raise ValueError("a micro request needs at least one frame")
        if arrival_us is None:
            arrival_us = self.clock()
        self._micro_queue[name].append(
            MicroRequest(uid, frames, priority=priority,
                         deadline_us=deadline_us, arrival_us=arrival_us,
                         tenant=tenant if tenant is not None else name))
        self.micro_results[name][uid] = MicroRequestResult(uid=uid)

    def _micro_pending(self) -> bool:
        return any(self._micro_queue.values()) \
            or any(self._micro_inflight.values())

    def _admit_micro(self, name: str, req: MicroRequest) -> int:
        """Claim a lane for ``req``: a fresh ``admit`` for a new
        request, ``restore_lane`` for one that carries a preemption
        checkpoint — the continuation resumes at its snapshotted step
        with its snapshotted variable state, bit-identically."""
        ckpt = self._micro_ckpt[name].pop(req.uid, None)
        if ckpt is not None:
            return self.ragged.restore_lane(ckpt)
        return self.ragged.admit(name, uid=req.uid)

    def _preempt_micro(self, name: str, now: int) -> bool:
        """Try ONE displacement for tenant ``name``: ask the preemption
        policy whether the queue's policy-first candidate may evict a
        running lane; if so, snapshot + retire the victim, re-queue it,
        and admit the candidate into the freed lane.  Returns True when
        a displacement happened (the caller loops — each one strictly
        improves the running set, so the loop is bounded)."""
        queue = self._micro_queue[name]
        inflight = self._micro_inflight[name]
        if not queue or not inflight or self.preempt is None:
            return False
        slots = sorted(inflight)
        ci = self.policy.select(queue, now)
        cand = queue[ci]
        vi = self.preempt.victim([inflight[s] for s in slots], cand, now)
        if vi is None:
            return False
        queue.pop(ci)
        slot = slots[vi]
        victim = inflight.pop(slot)
        self._micro_ckpt[name][victim.uid] = \
            self.ragged.snapshot_lane(name, slot)
        self.ragged.retire(name, slot)
        self.micro_results[name][victim.uid].preemptions += 1
        queue.append(victim)
        inflight[self._admit_micro(name, cand)] = cand
        return True

    def micro_step(self) -> bool:
        """One scheduler tick of the ragged micro path: admit queued
        requests into free lanes IN POLICY ORDER (restoring preempted
        continuations from their checkpoints), let the preemption
        policy displace running best-effort lanes for urgent queued
        work, stage every active lane's next frame, advance all buckets
        with ONE masked dispatch each, then retire lanes whose requests
        finished.  Returns True if work remains."""
        now = self.clock() if any(self._micro_queue.values()) else 0
        for name, queue in self._micro_queue.items():
            inflight = self._micro_inflight[name]
            while queue and self.ragged.free_lanes(name):
                req = self.policy.pop(queue, now)
                inflight[self._admit_micro(name, req)] = req
            for _ in range(len(inflight)):
                if not self._preempt_micro(name, now):
                    break
            for slot, req in inflight.items():
                step = self.ragged.lanes(name)[slot].step
                for pos, arr in enumerate(req.frames[step]):
                    self.ragged.set_input(name, slot, pos, arr)
        if not self.ragged.dispatch():
            return self._micro_pending()
        for name, inflight in self._micro_inflight.items():
            for slot in list(inflight):
                req = inflight[slot]
                lane = self.ragged.lanes(name)[slot]
                res = self.micro_results[name][req.uid]
                self.policy.charge(req.tenant, 1.0)
                # copy: output() returns a view into the whole wave's
                # stacked host array — holding it would pin lanes x the
                # needed memory for the life of the result
                res.outputs.append(self.ragged.output(name, slot, 0).copy())
                res.steps = lane.step
                if lane.step >= len(req.frames):
                    res.done = True
                    self.ragged.retire(name, slot)
                    del inflight[slot]
        return self._micro_pending()

    def run_micro(self, name: str,
                  requests: Sequence[Sequence[np.ndarray]]
                  ) -> List[np.ndarray]:
        """Serve ``requests`` (each a per-input list of arrays) through
        the named micro tenant, B lanes per program replay; returns the
        first output of each request in order.

        Requests are INDEPENDENT: inputs and variable-tensor state are
        reset between chunks, so a stateful model (e.g. SVDF) sees every
        request from its initial state.  Streaming tenants that need
        state carried across invocations should drive the
        InterpreterPool directly."""
        pool = self.micro[name]
        out: List[np.ndarray] = []
        for start in range(0, len(requests), pool.batch):
            chunk = requests[start:start + pool.batch]
            pool.clear_inputs()
            pool.reset_variable_tensors()
            for lane, req in enumerate(chunk):
                for pos, arr in enumerate(req):
                    pool.set_input(lane, pos, arr)
            pool.invoke()
            out.extend(pool.output(lane, 0) for lane in range(len(chunk)))
        return out

    def submit(self, name: str, req: Request) -> None:
        """Queue ``req`` for pod tenant ``name`` — directly on its
        engine, or through its ``ReplicaRouter`` when the tenant was
        admitted with ``add_replicated_model``."""
        if name in self.routers:
            self.routers[name].submit(req)
        else:
            self.engines[name].submit(req)

    def run_all(self) -> Dict[str, Dict[int, RequestResult]]:
        """THE scheduler: round-robin every tenant — pod engines AND
        ragged micro buckets — until all queues drain (tenants are
        time-multiplexed — TF Micro's 'not concurrently' contract).
        WITHIN a tenant, the free slot/lane goes to whichever queued
        request the host's scheduling policy keys first (FIFO by
        default; priority/EDF reorder admission without recompiling).
        One tick = one decode step per engine with work plus one masked
        dispatch per micro bucket with active lanes, so mixed micro+pod
        tenancy advances through a single loop.  Every tick with work
        pending makes progress (admission happens whenever a slot or
        lane is free), so the loop terminates when the work does."""
        out = {}
        pending = True
        while pending:
            pending = False
            for name, eng in self.engines.items():
                if eng.step():
                    pending = True
            for name, router in self.routers.items():
                if router.step():
                    pending = True
            if self._micro_queue and self.micro_step():
                pending = True
        for name, eng in self.engines.items():
            out[name] = eng.results
        for name, router in self.routers.items():
            out[name] = router.results
        return out

    def usage(self):
        """The shared arena's usage: the tenants' persistents stacked,
        the head section the largest tenant's scratch."""
        return self.arena.usage()
