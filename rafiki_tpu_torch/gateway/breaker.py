"""Per-worker circuit breakers for the serving fan-out.

The port's own copy of ``rafiki_tpu/gateway/breaker.py``, counting its
transitions into the port's ``telemetry``.

A SIGKILLed worker keeps its bus registration until its heartbeat
lease expires (bus/queues.py); during that window the predictor still
fans out to it and every gather waits on a reply that will never come.
The breaker closes that window from the *reply* side: consecutive
batches with zero replies from a worker open its breaker, and the
gateway stops routing to it immediately — before the lease expires.
After a cooldown the breaker goes half-open and admits ONE probe
batch; a reply closes it, another miss re-opens it for a full
cooldown.

States (the classic three): ``closed`` (healthy, route freely) →
``open`` (skip this worker) → ``half-open`` (one probe outstanding).

The clock is injectable so the open→half-open transition is testable
without sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from rafiki_tpu_torch import telemetry

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, failure_threshold)
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        # Lifetime reply/miss tallies — surfaced in gateway stats so an
        # operator can see WHY a breaker opened, not just that it did.
        self.successes = 0
        self.failures = 0
        # EWMA of observed batch latency for this worker's replies.
        self._latency_ewma_s = None

    # -- routing decision ----------------------------------------------------

    def allow(self) -> bool:
        """May the gateway fan out to this worker right now?"""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._state = HALF_OPEN
                    self._probe_inflight = True
                    telemetry.inc("gateway.breaker_half_open")
                    return True  # this caller carries the probe
                return False
            # HALF_OPEN: exactly one probe at a time.
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    # -- outcome feedback ----------------------------------------------------

    def record_success(self, latency_s: Optional[float] = None) -> None:
        with self._lock:
            self.successes += 1
            self._consecutive_failures = 0
            self._probe_inflight = False
            if latency_s is not None:
                prev = self._latency_ewma_s
                self._latency_ewma_s = (latency_s if prev is None
                                        else 0.8 * prev + 0.2 * latency_s)
            if self._state != CLOSED:
                self._state = CLOSED
                telemetry.inc("gateway.breaker_closed")

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            self._consecutive_failures += 1
            self._probe_inflight = False
            tripped = (self._state == HALF_OPEN
                       or (self._state == CLOSED
                           and self._consecutive_failures
                           >= self.failure_threshold))
            if tripped:
                self._state = OPEN
                self._opened_at = self._clock()
                telemetry.inc("gateway.breaker_opened")

    # -- introspection -------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "successes": self.successes,
                "failures": self.failures,
                "latency_ewma_s": (None if self._latency_ewma_s is None
                                   else round(self._latency_ewma_s, 6)),
            }
