"""Latency-aware scheduling policies for the serving engine.

A copy of the JAX package's ``repro.serving.scheduling`` (which imports
no JAX): the admission and preemption policies, and the replica routing
policies the ``ReplicaRouter`` (``serving.router``) consults.

WHICH request enters a free slot next is the one degree of freedom the
engine leaves to the host.  Policy decisions are host-side: a policy
reorders the Python queue between decode steps and never sees the
device state (slot lengths, tokens, the KV cache), so swapping FIFO for
EDF changes no tensor shape and no step program.

Four admission policies (semantics in docs/SCHEDULING.md):

  * ``FIFOPolicy`` — arrival order.
  * ``PriorityPolicy`` — lower ``priority`` admits first, with an
    *aging* bound: a request's effective priority improves by one class
    per ``age_us`` waited, so starvation under a saturating stream of
    higher classes is bounded by ``(class gap) x age_us``.
  * ``EDFPolicy`` — earliest ``deadline_us`` first; deadline-less
    requests order after all deadlined ones, FIFO among themselves.
  * ``WFQPolicy`` — weighted-fair queueing ACROSS tenants on top of any
    inner policy: the free slot goes to the tenant furthest below its
    weighted service share, the inner policy orders within a tenant.

All policies break ties by arrival order (the submission sequence
number), so equal-key requests never reorder — FIFO is the fixed point.
``now_us`` flows in from the caller (the engine's ``clock``).

**Preemption** (docs/PREEMPTION.md): once admission alone cannot help
(every slot busy, a tight deadline waiting), a ``PreemptionPolicy`` may
pick a RUNNING victim to evict.  The engine checkpoints the victim's
continuation state (``ServingEngine.snapshot_slot``), re-queues it, and
admits the urgent request into the freed slot; the victim resumes later
with exactly the tokens of an uninterrupted run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

_INF = float("inf")


# Policies only read four optional request attributes — ``priority``,
# ``deadline_us``, ``arrival_us``, ``tenant`` — so pod ``Request`` and
# micro ``MicroRequest`` schedule through the identical code path.
def _arrival(req, default: float = 0.0) -> float:
    a = getattr(req, "arrival_us", None)
    return default if a is None else a


def _deadline(req) -> float:
    d = getattr(req, "deadline_us", None)
    return _INF if d is None else d


def _tenant(req) -> str:
    return getattr(req, "tenant", "") or ""


class SchedulingPolicy:
    """Base policy: an admission-order key over queued requests.

    Subclasses implement ``key(req, now_us)`` — smaller admits first.
    ``select``/``pop`` are shared: a stable argmin over the queue, so
    every policy inherits FIFO tie-breaking for equal keys.  Policies
    hold no per-request state and never touch device state, so one
    instance may be shared by every tenant of a host.
    """

    name = "fifo"

    def key(self, req, now_us: int) -> Tuple:
        """Admission key for ``req`` at host time ``now_us`` (µs);
        smaller admits earlier.  Must be cheap — it runs per queued
        request per admission decision."""
        return ()

    def select(self, queue: Sequence, now_us: int = 0) -> Optional[int]:
        """Index of the request to admit next, or None when empty.
        Stable: among equal keys the earliest-queued index wins."""
        best, best_key = None, None
        for i, req in enumerate(queue):
            k = self.key(req, now_us)
            if best is None or k < best_key:
                best, best_key = i, k
        return best

    def pop(self, queue: List, now_us: int = 0):
        """Remove and return the next request to admit (policy order)."""
        i = self.select(queue, now_us)
        if i is None:
            raise IndexError("pop from an empty queue")
        return queue.pop(i)

    def charge(self, tenant: str, units: float = 1.0) -> None:
        """Account ``units`` of service delivered to ``tenant``.

        A no-op for memoryless policies; ``WFQPolicy`` overrides it to
        integrate per-tenant service.  Engines and the host call it
        once per slot/lane advanced per dispatch, so a fair-share
        policy sees the real service distribution regardless of which
        surface (pod engine or ragged micro bucket) delivered it."""

    def served(self, tenant: str) -> float:
        """Normalized service delivered to ``tenant`` so far (0 for
        memoryless policies — only ``WFQPolicy`` integrates it)."""
        return 0.0


class FIFOPolicy(SchedulingPolicy):
    """Arrival order — the baseline.  ``select`` short-circuits to the
    queue head (no O(queue) key scan per admission)."""

    name = "fifo"

    def select(self, queue: Sequence, now_us: int = 0) -> Optional[int]:
        """Queue head, unconditionally — FIFO needs no key scan."""
        return 0 if queue else None


class PriorityPolicy(SchedulingPolicy):
    """Strict priority classes with an aging starvation bound.

    ``req.priority`` (default 0) orders admission: lower is more
    urgent.  A waiting request's *effective* priority improves by one
    class per ``age_us`` of queue wait, so a class-p request is
    admitted after at most ``p x age_us`` of continuous higher-class
    pressure — starvation is bounded, not merely unlikely (asserted in
    tests/test_scheduling.py)."""

    name = "priority"

    def __init__(self, age_us: int = 1_000_000):
        if age_us < 1:
            raise ValueError("age_us must be >= 1")
        self.age_us = int(age_us)

    def key(self, req, now_us: int) -> Tuple:
        """Effective (aged) priority, ties broken by arrival."""
        prio = getattr(req, "priority", 0) or 0
        waited = max(0.0, now_us - _arrival(req, default=now_us))
        return (prio - waited / self.age_us, _arrival(req))


class EDFPolicy(SchedulingPolicy):
    """Earliest-deadline-first on ``req.deadline_us`` (absolute µs).

    The classic latency-SLO policy: under contention the request whose
    deadline expires soonest takes the free lane.  Requests without a
    deadline sort after every deadlined request and FIFO among
    themselves, so best-effort traffic fills leftover capacity."""

    name = "edf"

    def key(self, req, now_us: int) -> Tuple:
        """Absolute deadline (∞ when deadline-less), ties by arrival."""
        return (_deadline(req), _arrival(req))


class WFQPolicy(SchedulingPolicy):
    """Weighted-fair queueing ACROSS tenants, any policy WITHIN one.

    Each request carries a ``tenant`` label; each tenant has a weight
    (``weights[tenant]``, default 1.0).  The policy integrates service
    per tenant via ``charge`` — one unit per slot/lane-dispatch the
    tenant consumed — and admits from the tenant with the LOWEST
    normalized service ``service / weight``.  Under saturation every
    tenant's share of dispatches therefore converges to its weight
    fraction (asserted in tests/test_preemption.py), and an idle
    tenant's unused share spills to the others instead of going to
    waste — work-conserving, like classic WFQ.

    Within a tenant (and between tenants at equal normalized service)
    the ``inner`` policy orders requests — quotas stack ON TOP of
    FIFO/priority/EDF semantics rather than replacing them.  Service
    state is host-side floats; like every policy here it cannot touch
    device state, so re-weighting at runtime changes no step program."""

    name = "wfq"

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 inner: Union[str, SchedulingPolicy, None] = None):
        self.weights = dict(weights or {})
        for t, w in self.weights.items():
            if w <= 0:
                raise ValueError(f"tenant {t!r}: weight must be > 0")
        self.inner = get_policy(inner)
        self.service: Dict[str, float] = {}

    def weight(self, tenant: str) -> float:
        """``tenant``'s configured weight (1.0 when unlisted)."""
        return float(self.weights.get(tenant, 1.0))

    def charge(self, tenant: str, units: float = 1.0) -> None:
        """Integrate ``units`` of delivered service for ``tenant``."""
        self.service[tenant] = self.service.get(tenant, 0.0) + units

    def served(self, tenant: str) -> float:
        """Weight-normalized service: ``service[tenant] / weight``."""
        return self.service.get(tenant, 0.0) / self.weight(tenant)

    def key(self, req, now_us: int) -> Tuple:
        """(normalized tenant service, inner-policy key, arrival)."""
        return ((self.served(_tenant(req)),)
                + tuple(self.inner.key(req, now_us))
                + (_arrival(req),))


# ---------------------------------------------------------------------------
# preemption policies (docs/PREEMPTION.md)
# ---------------------------------------------------------------------------

class PreemptionPolicy:
    """Decides whether an urgent queued request may EVICT a running one.

    Consulted by ``ServingEngine.step`` and ``MultiTenantHost.micro_step``
    only after plain admission failed (no free slot/lane while the queue
    is non-empty).  ``victim(running, candidate, now_us)`` returns the
    index of the running request to evict, or None to let the candidate
    wait.  The CALLER then performs the mechanics: checkpoint the
    victim's continuation state, retire its lane/slot, re-queue it, and
    admit the candidate — so a policy here is pure decision logic and,
    like admission policies, can never touch device state.

    Contract for subclasses: only return a victim the candidate
    STRICTLY beats under the policy's own order.  That makes each
    preemption an improvement of the running set, bounds preemptions
    per tick by the slot count, and guarantees the evicted request —
    whose key is now the worse one — cannot immediately displace its
    displacer (no thrash)."""

    name = "never"

    def victim(self, running: Sequence, candidate,
               now_us: int = 0) -> Optional[int]:
        """Index into ``running`` of the request to evict for
        ``candidate``, or None to keep all running requests."""
        return None


class EDFDisplacePolicy(PreemptionPolicy):
    """Evict the loosest-deadline running request for a tighter one.

    The victim is the running request with the LATEST deadline
    (deadline-less best-effort sorts last, so it is displaced first);
    preemption happens only when the candidate's deadline is more than
    ``margin_us`` tighter than the victim's.  A deadline-less candidate
    never preempts anything.  Pairs naturally with ``EDFPolicy``
    admission: admission gets urgent work to the FRONT of the queue,
    displacement gets it INTO a slot when the queue's front would
    otherwise wait behind a long best-effort run — the head-of-line
    fix for checkpointable lanes."""

    name = "edf-displace"

    def __init__(self, margin_us: int = 0):
        if margin_us < 0:
            raise ValueError("margin_us must be >= 0")
        self.margin_us = int(margin_us)

    def victim(self, running: Sequence, candidate,
               now_us: int = 0) -> Optional[int]:
        """Latest-deadline running index, when the candidate's deadline
        is more than ``margin_us`` tighter; else None."""
        cd = getattr(candidate, "deadline_us", None)
        if cd is None or not running:
            return None
        worst = max(range(len(running)),
                    key=lambda i: (_deadline(running[i]),
                                   -_arrival(running[i])))
        if cd + self.margin_us < _deadline(running[worst]):
            return worst
        return None


class WFQDisplacePolicy(PreemptionPolicy):
    """Weighted-fair-per-tenant preemption: evict the most over-served
    tenant's running request for an under-served tenant's.

    Reads the shared ``WFQPolicy`` service integrals: the victim is the
    running request whose tenant has the HIGHEST normalized service;
    preemption happens only when that exceeds the candidate tenant's by
    more than ``slack`` dispatch-units (hysteresis — without it two
    tenants at equal share would evict each other every tick).  With
    checkpointable lanes this turns WFQ from a long-run average into a
    per-tick guarantee: a quota violator is displaced MID-REQUEST, not
    merely passed over at its next admission."""

    name = "wfq-displace"

    def __init__(self, policy: WFQPolicy, slack: float = 1.0):
        if not isinstance(policy, WFQPolicy):
            raise TypeError(f"WFQDisplacePolicy needs the shared "
                            f"WFQPolicy instance, got {policy!r}")
        if slack < 0:
            raise ValueError("slack must be >= 0")
        self.policy = policy
        self.slack = float(slack)

    def victim(self, running: Sequence, candidate,
               now_us: int = 0) -> Optional[int]:
        """Most over-served tenant's running index, when it beats the
        candidate tenant's normalized service by > ``slack``."""
        if not running:
            return None
        cand = self.policy.served(_tenant(candidate))
        worst = max(range(len(running)),
                    key=lambda i: (self.policy.served(
                        _tenant(running[i])), -_arrival(running[i])))
        if self.policy.served(_tenant(running[worst])) > cand + self.slack:
            return worst
        return None


_POLICIES = {p.name: p for p in (FIFOPolicy, PriorityPolicy, EDFPolicy,
                                 WFQPolicy)}


def get_policy(policy: Union[str, SchedulingPolicy, None]
               ) -> SchedulingPolicy:
    """Resolve a policy argument: an instance passes through, a name
    (``"fifo"``/``"priority"``/``"edf"``/``"wfq"``) constructs the
    default instance, None means FIFO."""
    if policy is None:
        return FIFOPolicy()
    if isinstance(policy, SchedulingPolicy):
        return policy
    try:
        return _POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown scheduling policy {policy!r}; "
                         f"have {sorted(_POLICIES)}") from None


# ---------------------------------------------------------------------------
# routing policies (docs/ARCHITECTURE.md §9, docs/SCHEDULING.md §6)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplicaLoad:
    """One replica's host-visible load snapshot at route time: queued
    requests, busy slots (decoding + mid-chunked-prefill), the
    replica's total slot count, and the remaining-token ``backlog``.
    Built by ``ReplicaRouter.loads()`` from plain host bookkeeping —
    reading it never synchronizes a device."""

    queued: int
    active: int
    slots: int
    # remaining decode tokens across queued + active + mid-prefill
    # requests — the COST-aware load key.  Request count is blind to
    # heterogeneous service times (a 16-token monopolizer weighs the
    # same as a 4-token deadline request), which is exactly how
    # join-the-shortest-queue degenerates to round-robin on a
    # heavy-tail mix; token backlog sees the difference.
    backlog: int = 0

    @property
    def depth(self) -> int:
        """Total outstanding request count at the replica (queued +
        active) — the tiebreak load key behind ``backlog``."""
        return self.queued + self.active


class RoutingPolicy:
    """Decides WHICH engine replica a fresh arrival is submitted to —
    the route-time sibling of ``SchedulingPolicy`` (which decides
    admission order WITHIN a replica's queue).  Same contract: a
    routing decision is host-side Python over load snapshots; it never
    sees a traced value, so swapping routing policies at runtime
    (``ReplicaRouter.set_routing``) never recompiles anything.

    Subclasses implement ``route(loads, req, home)`` returning the
    replica index to submit to.  ``home`` is the index of the replica
    holding the request's preemption checkpoint/KV, or None for a
    fresh request: policies MAY ignore it (round-robin does — that is
    exactly its p99 penalty), but the ``ReplicaRouter`` itself never
    migrates checkpointed work regardless of policy, so ignoring
    ``home`` costs performance, never correctness."""

    name = "round-robin"

    def route(self, loads: Sequence[ReplicaLoad], req,
              home: Optional[int] = None) -> int:
        """Replica index for ``req`` given per-replica ``loads``;
        ``home`` names the replica holding its checkpoint (or None)."""
        raise NotImplementedError


class RoundRobinRouting(RoutingPolicy):
    """Cycle through replicas in submission order — the load-blind
    baseline.  Under heterogeneous service times (a long monopolizer
    on one replica) it keeps feeding the busy replica while others
    idle, which is the queueing delay the load-aware policies beat."""

    name = "round-robin"

    def __init__(self) -> None:
        self._next = 0

    def route(self, loads: Sequence[ReplicaLoad], req,
              home: Optional[int] = None) -> int:
        """The next replica in cyclic order, ignoring load and home."""
        i = self._next % len(loads)
        self._next += 1
        return i


class LeastLoadedRouting(RoutingPolicy):
    """Route to the replica with the smallest remaining-token
    ``backlog`` (ties broken by request depth, then replica index) —
    join-the-shortest-WORKLOAD rather than shortest queue, because a
    count-based key cannot tell a monopolizer from a deadline-class
    request.  Load-aware but locality-blind: it reads only the
    snapshot, never ``home``."""

    name = "least-loaded"

    def route(self, loads: Sequence[ReplicaLoad], req,
              home: Optional[int] = None) -> int:
        """Index of the least-backlogged replica (stable on ties)."""
        return min(range(len(loads)),
                   key=lambda i: (loads[i].backlog, loads[i].depth, i))


class LocalityRouting(RoutingPolicy):
    """Least-loaded with continuation stickiness: a request whose
    KV/checkpoint is parked at a replica (``home``) goes HOME —
    re-prefilling elsewhere would pay the full prompt again and strand
    the checkpoint — and only fresh requests load-balance through the
    ``inner`` policy (least-loaded by default)."""

    name = "locality"

    def __init__(self, inner: Union[str, RoutingPolicy, None] = None):
        self.inner = get_routing(inner if inner is not None
                                 else "least-loaded")

    def route(self, loads: Sequence[ReplicaLoad], req,
              home: Optional[int] = None) -> int:
        """``home`` when the request has one, else the inner policy."""
        if home is not None:
            return home
        return self.inner.route(loads, req, None)


_ROUTING = {p.name: p for p in (RoundRobinRouting, LeastLoadedRouting,
                                LocalityRouting)}


def get_routing(policy: Union[str, RoutingPolicy, None]) -> RoutingPolicy:
    """Resolve a routing argument: an instance passes through, a name
    (``"round-robin"``/``"least-loaded"``/``"locality"``) constructs
    the default instance, None means round-robin (the baseline, like
    FIFO for admission)."""
    if policy is None:
        return RoundRobinRouting()
    if isinstance(policy, RoutingPolicy):
        return policy
    try:
        return _ROUTING[policy]()
    except KeyError:
        raise ValueError(f"unknown routing policy {policy!r}; "
                         f"have {sorted(_ROUTING)}") from None


_PREEMPTION = {p.name: p for p in (PreemptionPolicy, EDFDisplacePolicy)}


def get_preemption(policy: Union[str, PreemptionPolicy, None]
                   ) -> Optional[PreemptionPolicy]:
    """Resolve a preemption argument: None disables preemption, an
    instance passes through, a name (``"edf-displace"``/``"never"``)
    constructs the default instance.  ``WFQDisplacePolicy`` has no name
    here because it needs the shared ``WFQPolicy`` instance."""
    if policy is None:
        return None
    if isinstance(policy, PreemptionPolicy):
        return policy
    try:
        return _PREEMPTION[policy]()
    except KeyError:
        raise ValueError(f"unknown preemption policy {policy!r}; "
                         f"have {sorted(_PREEMPTION)}") from None
