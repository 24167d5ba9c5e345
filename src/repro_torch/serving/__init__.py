"""Serving substrate of the port: the batched prefill/decode engine with
its KV cache budgeted in the TFLM two-stack arena (and its overlapped
decode loop), multitenant hosting of engines and micro models on one
arena (``host``), data-parallel replica routing (``router``),
registry-resolved serving macro-kernels (``ops``), latency-aware
admission, preemption and routing policies (``scheduling``) and the
typed family errors."""

from . import ops  # registers the reference serving macro-kernels
from .engine import (BUCKETED_FAMILIES, CHUNKED_FAMILIES, DEFAULT_TAGS,
                     PAGED_FAMILIES, RECURRENT_FAMILIES, SHARDED_FAMILIES,
                     STREAMING_FAMILIES, Request, RequestResult,
                     ServingEngine, SlotCheckpoint, StreamEvent,
                     default_clock)
from .errors import UnsupportedFamilyError
from .host import MicroRequest, MicroRequestResult, MultiTenantHost
from .router import ReplicaRouter
from .scheduling import (EDFDisplacePolicy, EDFPolicy, FIFOPolicy,
                         LeastLoadedRouting, LocalityRouting,
                         PreemptionPolicy, PriorityPolicy, ReplicaLoad,
                         RoundRobinRouting, RoutingPolicy, SchedulingPolicy,
                         WFQDisplacePolicy, WFQPolicy, get_policy,
                         get_preemption, get_routing)

__all__ = ["BUCKETED_FAMILIES", "CHUNKED_FAMILIES", "DEFAULT_TAGS",
           "PAGED_FAMILIES", "RECURRENT_FAMILIES", "SHARDED_FAMILIES",
           "STREAMING_FAMILIES",
           "Request", "RequestResult", "ServingEngine", "SlotCheckpoint",
           "StreamEvent", "UnsupportedFamilyError", "default_clock",
           "MicroRequest", "MicroRequestResult", "MultiTenantHost",
           "ReplicaRouter", "EDFDisplacePolicy", "EDFPolicy", "FIFOPolicy",
           "LeastLoadedRouting", "LocalityRouting", "PreemptionPolicy",
           "PriorityPolicy", "ReplicaLoad", "RoundRobinRouting",
           "RoutingPolicy", "SchedulingPolicy", "WFQDisplacePolicy",
           "WFQPolicy", "get_policy", "get_preemption", "get_routing", "ops"]
