"""Serving substrate of the port: the batched prefill/decode engine with
its KV cache budgeted in the TFLM two-stack arena, registry-resolved
serving macro-kernels (``ops``), latency-aware admission and preemption
policies (``scheduling``) and the typed family errors."""

from . import ops  # registers the reference serving macro-kernels
from .engine import (BUCKETED_FAMILIES, CHUNKED_FAMILIES, DEFAULT_TAGS,
                     PAGED_FAMILIES, RECURRENT_FAMILIES, Request,
                     RequestResult, ServingEngine, SlotCheckpoint,
                     StreamEvent, default_clock)
from .errors import UnsupportedFamilyError
from .scheduling import (EDFDisplacePolicy, EDFPolicy, FIFOPolicy,
                         PreemptionPolicy, PriorityPolicy, SchedulingPolicy,
                         WFQDisplacePolicy, WFQPolicy, get_policy,
                         get_preemption)

__all__ = ["BUCKETED_FAMILIES", "CHUNKED_FAMILIES", "DEFAULT_TAGS",
           "PAGED_FAMILIES", "RECURRENT_FAMILIES", "Request", "RequestResult",
           "ServingEngine", "SlotCheckpoint", "StreamEvent",
           "UnsupportedFamilyError", "default_clock", "EDFDisplacePolicy",
           "EDFPolicy", "FIFOPolicy", "PreemptionPolicy", "PriorityPolicy",
           "SchedulingPolicy", "WFQDisplacePolicy", "WFQPolicy",
           "get_policy", "get_preemption", "ops"]
