"""Serving gateway: the frontend layer between the predictor HTTP app
and the bus — admission control with per-request deadlines, quorum
fan-out with hedged stragglers, per-worker circuit breakers, routing
policies, microbatching and graceful drain.

Counterpart of ``rafiki_tpu/gateway``.
"""

from rafiki_tpu_torch.gateway.admission import AdmissionController, ShedError
from rafiki_tpu_torch.gateway.breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from rafiki_tpu_torch.gateway.gateway import (DEADLINE_RESERVE_FRAC,
                                              LATENCY_EWMA_ALPHA, POLICIES,
                                              RETRY_AFTER_FLOOR_S, Gateway,
                                              GatewayConfig)
from rafiki_tpu_torch.gateway.microbatch import (FLUSH_REASONS, BatchMember,
                                                 MicroBatcher)

__all__ = [
    "AdmissionController", "ShedError",
    "CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN",
    "Gateway", "GatewayConfig", "POLICIES",
    "DEADLINE_RESERVE_FRAC", "LATENCY_EWMA_ALPHA", "RETRY_AFTER_FLOOR_S",
    "MicroBatcher", "BatchMember", "FLUSH_REASONS",
]
