"""Data-parallel replica routing, a copy of the JAX package's
``repro.serving.router`` over the port's engines.

A ``ReplicaRouter`` sits ABOVE engine replicas the way an engine sits
above its slots: N ``ServingEngine`` instances of ONE model (they may
share one weight module, each with its own KV) serve one arrival
stream, and the router
decides WHICH replica each request is submitted to via a pluggable
``RoutingPolicy`` (serving/scheduling.py): round-robin, least-loaded,
or locality-aware.

Invariants the router maintains (property-tested in
tests/test_torch_router.py):

  * **no request lost or duplicated** — every submitted uid lives at
    exactly one replica at any moment (``routed`` maps uid → replica
    index and is updated atomically with every queue move), and every
    uid finishes with exactly one ``RequestResult``.
  * **locality stickiness** — a request whose continuation state (KV
    rows, slot checkpoint, half-run chunked prefill) is parked at a
    replica is NEVER migrated off it: an engine checkpoint is host
    memory at that replica, and the request's partial ``output`` has
    already been emitted there — re-running it elsewhere would both
    strand the checkpoint and double-emit tokens.  Stickiness is a
    ROUTER guarantee, independent of policy: load-blind policies only
    lose performance, never correctness.
  * **work conservation** — before each tick the router rebalances:
    no replica sits with an idle slot while another replica queues
    unstarted (checkpoint-free) work it cannot admit this tick.
    Rebalancing moves host queue entries only.
  * **policy swaps never capture** — routing is host-side Python over
    ``ReplicaLoad`` snapshots; replacing the policy mid-serve touches
    no device value, so every replica's programs are frozen across the
    swap (the same contract as admission/preemption policies).

The router is deliberately engine-shaped: ``submit`` / ``step`` /
``run`` / ``results`` mirror ``ServingEngine``, so
``MultiTenantHost.run_all`` drives routed tenants and plain engines
through one loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from .engine import Request, RequestResult, ServingEngine
from .scheduling import (ReplicaLoad, RoutingPolicy, get_routing)


class ReplicaRouter:
    """Load-balance one model's arrivals over engine replicas."""

    def __init__(self, replicas: Sequence[ServingEngine], *,
                 routing: Union[str, RoutingPolicy, None] = None,
                 rebalance: bool = True):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.replicas: List[ServingEngine] = list(replicas)
        self.routing: RoutingPolicy = get_routing(routing)
        self.rebalance = bool(rebalance)
        # uid -> replica index currently holding the request; the
        # single source of truth the no-loss/no-duplication invariant
        # hangs on (updated atomically with every submit/migration)
        self.routed: Dict[int, int] = {}
        self.migrations = 0

    # ------------------------------------------------------------------

    def loads(self) -> List[ReplicaLoad]:
        """Per-replica ``ReplicaLoad`` snapshots from host bookkeeping
        (queue length, busy slots, slot count, remaining-token
        backlog) — what routing policies key on.  Never touches a
        device buffer: queue entries carry their full budget, active
        slots their ``slot_budget`` remainder, and mid-chunked-prefill
        slots their full budget (the prompt is not done yet)."""
        out = []
        for e in self.replicas:
            backlog = sum(int(r.max_new_tokens) for r in e.queue)
            backlog += int(e.slot_budget[e.active].sum())
            backlog += sum(int(cs.req.max_new_tokens)
                           for cs in e._chunking.values())
            out.append(ReplicaLoad(
                queued=len(e.queue),
                active=int(e.active.sum()) + len(e._chunking),
                slots=e.max_slots, backlog=backlog))
        return out

    def home_of(self, uid: int) -> Optional[int]:
        """Index of the replica holding ``uid``'s continuation state
        (a parked ``SlotCheckpoint``), or None for a stateless uid —
        what locality-aware routing sends requests home to."""
        for i, eng in enumerate(self.replicas):
            if uid in eng._ckpt:
                return i
        return None

    def replica_of(self, uid: int) -> Optional[int]:
        """Index of the replica currently holding ``uid`` (queued,
        running, or finished there), or None if never submitted."""
        return self.routed.get(uid)

    def set_routing(self, policy: Union[str, RoutingPolicy]) -> None:
        """Swap the routing policy mid-serve.  Routing is host-side
        Python over load snapshots, so the swap touches no device
        value: every replica's programs are frozen across it (asserted
        in tests/test_torch_router.py)."""
        self.routing = get_routing(policy)

    def set_on_token(self, cb) -> None:
        """Point every replica's per-token streaming callback at one
        sink (docs/STREAMING.md).  The router's existing invariants
        already make routed streams exactly-once: a uid lives at one
        replica, work-stealing moves only UNSTARTED (checkpoint-free,
        zero-tokens-emitted) requests, and checkpoint stickiness keeps
        a mid-stream continuation at the replica that holds its
        emitted prefix — so per-uid event indices stay 0, 1, 2, …
        whichever replicas the fleet shuffles around it."""
        for eng in self.replicas:
            eng.on_token = cb

    def drain(self) -> None:
        """Settle every replica's in-flight overlapped step (see
        ``ServingEngine.drain``) — a fleet-wide quiesce point for
        checkpoint surgery or shutdown."""
        for eng in self.replicas:
            eng.drain()

    # ------------------------------------------------------------------

    def submit(self, req: Request) -> int:
        """Route ``req`` to a replica and submit it there; returns the
        replica index.  A uid may live at exactly one replica, so
        re-submitting an unfinished uid is refused loudly."""
        if req.uid in self.routed:
            res = self.results.get(req.uid)
            if res is None or not res.done:
                raise ValueError(
                    f"request uid {req.uid} is already routed to "
                    f"replica {self.routed[req.uid]} and not done")
        i = self.routing.route(self.loads(), req,
                               home=self.home_of(req.uid))
        if not 0 <= i < len(self.replicas):
            raise ValueError(
                f"routing policy {self.routing.name!r} returned "
                f"replica {i}, have {len(self.replicas)}")
        self.replicas[i].submit(req)
        self.routed[req.uid] = i
        return i

    def _movable(self, eng: ServingEngine, req: Request) -> bool:
        """May ``req`` leave ``eng``'s queue?  Only checkpoint-free
        (unstarted) requests move — continuation state is host memory
        at its replica, so checkpointed work is sticky by correctness,
        not preference."""
        return req.uid not in eng._ckpt

    def _rebalance(self) -> None:
        """Work conservation: while some replica has admission capacity
        it cannot fill from its own queue and another queues more
        unstarted work than it can admit this tick, migrate one movable
        request from the deepest-surplus donor to the neediest
        recipient (most recently arrived first — the work-stealing
        order that leaves the donor's imminent admissions alone).
        Pure host queue surgery: the request's ``RequestResult`` moves
        with it and ``routed`` is updated in the same step."""
        while True:
            loads = self.loads()
            free = [max(0, l.slots - l.active) for l in loads]
            need = [max(0, f - l.queued) for f, l in zip(free, loads)]
            surplus = [max(0, l.queued - f) for f, l in zip(free, loads)]
            donors = sorted((i for i in range(len(loads)) if surplus[i]),
                            key=lambda i: -surplus[i])
            recips = sorted((i for i in range(len(loads)) if need[i]),
                            key=lambda i: -need[i])
            moved = False
            for d in donors:
                donor = self.replicas[d]
                idx = next((k for k in reversed(range(len(donor.queue)))
                            if self._movable(donor, donor.queue[k])),
                           None)
                if idx is None:
                    continue
                for r in recips:
                    if r == d:
                        continue
                    req = donor.queue.pop(idx)
                    res = donor.results.pop(req.uid)
                    self.replicas[r].queue.append(req)
                    self.replicas[r].results[req.uid] = res
                    self.routed[req.uid] = r
                    self.migrations += 1
                    moved = True
                    break
                if moved:
                    break
            if not moved:
                return

    def step(self) -> bool:
        """One router tick: rebalance queued work across replicas, then
        advance EVERY replica one engine step (on real hardware the
        replicas run in parallel on disjoint device sets; here they are
        time-multiplexed like host tenants).  Returns True while any
        replica has work."""
        if self.rebalance and len(self.replicas) > 1:
            self._rebalance()
        pending = False
        for eng in self.replicas:
            if eng.step():
                pending = True
        return pending

    def run(self, max_steps: int = 10_000) -> Dict[int, RequestResult]:
        """Drive ``step`` until every replica drains; returns the
        merged results."""
        steps = 0
        while self.step():
            steps += 1
            if steps > max_steps:
                raise RuntimeError("replica routing did not converge")
        return self.results

    @property
    def results(self) -> Dict[int, RequestResult]:
        """Merged uid → ``RequestResult`` view across replicas (uids
        are router-unique, so the merge cannot collide)."""
        out: Dict[int, RequestResult] = {}
        for eng in self.replicas:
            out.update(eng.results)
        return out
