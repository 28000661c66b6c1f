"""Admission control: a bounded inflight budget + bounded wait queue.

The port's own copy of ``rafiki_tpu/gateway/admission.py``, unchanged.

The predict path used to accept unlimited concurrent requests — under
saturating offered load every request queued forever and ALL of them
blew their deadline. Admission control inverts that: at most
``max_inflight`` requests execute at once, at most ``max_queue`` wait
for a slot, and a waiter that cannot possibly get a slot before its
deadline is shed immediately. Shed requests surface as HTTP 429 with a
``Retry-After`` hint, so well-behaved clients back off instead of
retry-storming a saturated predictor.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class ShedError(RuntimeError):
    """Request refused by admission control (or a draining gateway)."""

    def __init__(self, reason: str, retry_after_s: float = 1.0):
        super().__init__(f"request shed: {reason}")
        self.reason = reason
        self.retry_after_s = retry_after_s


class AdmissionController:
    """Counting semaphore with a bounded, deadline-aware wait queue."""

    def __init__(self, max_inflight: int = 8, max_queue: int = 32):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.max_inflight = max_inflight
        self.max_queue = max(0, max_queue)
        self._cv = threading.Condition()
        self._inflight = 0
        self._waiting = 0
        self._closed = False

    # -- admission -----------------------------------------------------------

    def admit(self, deadline: float, retry_after_s: float = 1.0,
              tenant: Optional[str] = None) -> float:
        """Block until an inflight slot is free, the monotonic
        ``deadline`` passes, or the controller closes (drain). Returns
        the seconds spent waiting; raises :class:`ShedError` instead of
        admitting a request that already lost its deadline race.
        ``tenant`` is ignored here; the tenant-aware subclass
        (``tenancy/admission.py``) grants by it."""
        t0 = time.monotonic()
        with self._cv:
            if self._closed:
                raise ShedError("draining", retry_after_s)
            if self._inflight < self.max_inflight and self._waiting == 0:
                self._inflight += 1
                return 0.0
            if self._waiting >= self.max_queue:
                raise ShedError("queue_full", retry_after_s)
            if time.monotonic() >= deadline:
                raise ShedError("deadline", retry_after_s)
            self._waiting += 1
            try:
                while self._inflight >= self.max_inflight:
                    if self._closed:
                        raise ShedError("draining", retry_after_s)
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise ShedError("deadline", retry_after_s)
                    self._cv.wait(remaining)
                if self._closed:  # drain raced the slot we just won
                    raise ShedError("draining", retry_after_s)
                self._inflight += 1
            finally:
                self._waiting -= 1
        return time.monotonic() - t0

    def release(self, tenant: Optional[str] = None) -> None:
        with self._cv:
            self._inflight -= 1
            self._cv.notify_all()

    # -- drain ---------------------------------------------------------------

    def close(self) -> None:
        """Stop admitting: new arrivals and queued waiters shed with
        reason ``draining``; inflight requests run to completion."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every inflight request finished (drain flush).
        Returns False if ``timeout`` elapsed first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._inflight > 0:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    # -- introspection -------------------------------------------------------

    @property
    def inflight(self) -> int:
        with self._cv:
            return self._inflight

    @property
    def waiting(self) -> int:
        with self._cv:
            return self._waiting

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed
