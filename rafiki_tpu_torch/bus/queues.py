"""The bus: per-worker query queues + per-query prediction slots.

The port's own copy of the in-process bus of ``rafiki_tpu/bus/queues.py``
(``InProcBus`` and ``_envelope``), with the same interface:

  add_worker(job_id, worker_id)          — register a live worker
  get_workers(job_id, max_age_s=None)    — running-worker set
  remove_worker(job_id, worker_id)
  heartbeat(job_id, worker_id)           — refresh the liveness lease
  add_query(worker_id, query_id, query)  — predictor → worker fan-out
  pop_queries(worker_id, max_n, timeout) — worker batch pull
  put_prediction(query_id, worker_id, prediction)
  get_predictions(query_id, n, timeout)  — predictor gather-wait

Envelopes are ``(query_id, query)``, or ``(query_id, query, trace)``
when the caller passes an explicit ``trace`` dict, as in the JAX
package. Liveness is a LEASE refreshed by each worker's heartbeat
thread; ``get_workers(max_age_s=...)`` sees only fresh leases and
``reap_stale`` deletes corpses.

Not in the port yet: the multiprocessing bus, the chaos hooks, and the
trace-context / hop / journal planes that stamp envelopes.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from rafiki_tpu_torch import telemetry


def _envelope(query_id: str, query: Any,
              trace: Optional[Dict[str, Any]]) -> tuple:
    if trace is None:
        return (query_id, query)
    # Copy: an explicit trace arg may be a caller-owned dict shared
    # across queries.
    return (query_id, query, dict(trace))


class InProcBus:
    _EXPIRED_CAP = 4096  # remembered timed-out query ids (leak guard)
    # Auto-janitor factor: get_workers reaps any lease older than
    # REAP_FACTOR × the caller's max_age_s on sight, so corpse queues
    # cannot grow unboundedly under worker churn even when nothing ever
    # calls reap_stale explicitly. Env override: RAFIKI_BUS_REAP_FACTOR.
    REAP_FACTOR = 6.0

    def __init__(self):
        self._reap_factor = float(
            os.environ.get("RAFIKI_BUS_REAP_FACTOR", str(self.REAP_FACTOR)))
        # Queues exist exactly while their worker is registered:
        # created in add_worker, destroyed in remove_worker, and
        # add_query drops (rather than resurrects) queries to dead
        # workers.
        self._queues: Dict[str, queue.Queue] = {}
        # Running total of enqueued-not-yet-popped queries (approximate:
        # feeds a gauge only, clamped at 0).
        self._depth = 0
        self._preds: Dict[str, list] = {}
        self._pred_cv = threading.Condition()
        self._workers: Dict[str, set] = {}
        self._worker_ts: Dict[Tuple[str, str], float] = {}
        self._expired: "deque[str]" = deque(maxlen=self._EXPIRED_CAP)
        self._expired_set: set = set()
        self._lock = threading.Lock()

    # -- worker registry -----------------------------------------------------

    def add_worker(self, job_id: str, worker_id: str) -> None:
        with self._lock:
            self._workers.setdefault(job_id, set()).add(worker_id)
            self._worker_ts[(job_id, worker_id)] = time.monotonic()
            self._queues.setdefault(worker_id, queue.Queue())

    def remove_worker(self, job_id: str, worker_id: str) -> None:
        with self._lock:
            self._workers.get(job_id, set()).discard(worker_id)
            self._worker_ts.pop((job_id, worker_id), None)
            q = self._queues.pop(worker_id, None)
            if q is not None:  # pending queries die with the queue
                self._depth = max(0, self._depth - q.qsize())

    def heartbeat(self, job_id: str, worker_id: str) -> None:
        with self._lock:
            if worker_id in self._workers.get(job_id, ()):  # never resurrect
                self._worker_ts[(job_id, worker_id)] = time.monotonic()

    def get_workers(self, job_id: str,
                    max_age_s: Optional[float] = None) -> List[str]:
        with self._lock:
            ws = self._workers.get(job_id, ())
            if max_age_s is None:
                return sorted(ws)
            cutoff = time.monotonic() - max_age_s
            # Auto-janitor, inline under the same (non-reentrant) lock.
            self._reap_locked(cutoff - max_age_s * (self._reap_factor - 1.0),
                              [job_id])
            return sorted(w for w in ws
                          if self._worker_ts.get((job_id, w), 0.0) >= cutoff)

    def _reap_locked(self, cutoff: float,
                     jobs: List[str]) -> List[Tuple[str, str]]:
        """Delete registrations with leases older than ``cutoff``.
        Caller holds ``self._lock``."""
        reaped: List[Tuple[str, str]] = []
        for j in jobs:
            ws = self._workers.get(j)
            if not ws:
                continue
            for w in [w for w in ws
                      if self._worker_ts.get((j, w), 0.0) < cutoff]:
                ws.discard(w)
                self._worker_ts.pop((j, w), None)
                q = self._queues.pop(w, None)
                if q is not None:
                    self._depth = max(0, self._depth - q.qsize())
                reaped.append((j, w))
        if reaped:
            telemetry.inc("bus.reaped_workers", len(reaped))
        return reaped

    def reap_stale(self, max_age_s: float,
                   job_id: Optional[str] = None) -> List[Tuple[str, str]]:
        """Janitor: delete every registration whose lease is older than
        ``max_age_s`` — worker set entry, timestamp AND pending-query
        queue. Callers pick max_age_s well above the liveness TTL."""
        cutoff = time.monotonic() - max_age_s
        with self._lock:
            jobs = [job_id] if job_id is not None else list(self._workers)
            return self._reap_locked(cutoff, jobs)

    # -- queries -------------------------------------------------------------

    def add_query(self, worker_id: str, query_id: str, query: Any,
                  trace: Optional[Dict[str, Any]] = None) -> None:
        item = _envelope(query_id, query, trace)
        with self._lock:
            q = self._queues.get(worker_id)
            if q is not None:
                q.put(item)  # unbounded Queue: put never blocks
                self._depth += 1
                depth = self._depth
        if q is not None:  # dead worker → drop; the gather just sees n-1
            telemetry.inc("bus.queries_added")
            telemetry.set_gauge("bus.queue_depth", depth)
        else:
            telemetry.inc("bus.queries_dropped_dead_worker")

    def queue_depth(self, worker_id: str) -> int:
        """Pending (unpopped) queries for one worker."""
        with self._lock:
            q = self._queues.get(worker_id)
            return q.qsize() if q is not None else 0

    def pop_queries(self, worker_id: str, max_n: int = 64,
                    timeout: float = 0.1) -> List[tuple]:
        """Block up to ``timeout`` for the first query, then drain up to
        max_n without blocking — natural micro-batching for the device."""
        with self._lock:
            q = self._queues.get(worker_id)
        if q is None:  # not registered (stopped): nothing to serve
            time.sleep(min(timeout, 0.05))
            return []
        out: List[tuple] = []
        try:
            out.append(q.get(timeout=timeout))
        except queue.Empty:
            return out
        while len(out) < max_n:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                break
        with self._lock:
            self._depth = max(0, self._depth - len(out))
        telemetry.inc("bus.queries_popped", len(out))
        telemetry.observe("bus.pop_batch_size", len(out))
        return out

    # -- predictions ---------------------------------------------------------

    def put_prediction(self, query_id: str, worker_id: str, prediction: Any,
                       hops: Optional[list] = None) -> None:
        item = ((worker_id, prediction) if hops is None
                else (worker_id, prediction, hops))
        with self._pred_cv:
            if query_id in self._expired_set:
                return  # late answer to a timed-out query: drop, don't leak
            self._preds.setdefault(query_id, []).append(item)
            self._pred_cv.notify_all()

    def get_predictions(self, query_id: str, n: int,
                        timeout: float = 10.0,
                        min_n: Optional[int] = None,
                        grace_s: Optional[float] = None) -> List[Tuple[str, Any]]:
        """Wait until n predictions arrived (or timeout); pops the slot.
        After this returns, late answers for query_id are discarded.

        Quorum gather: with ``min_n`` (and optionally ``grace_s``), the
        wait relaxes once ``min_n`` replies are in — from that moment
        at most ``grace_s`` more seconds are granted for stragglers.
        """
        deadline = time.monotonic() + timeout
        quorum = n if min_n is None else max(1, min(min_n, n))
        quorum_at: Optional[float] = None
        with self._pred_cv:
            while True:
                got = len(self._preds.get(query_id, []))
                if got >= n:
                    break
                now = time.monotonic()
                limit = deadline
                if got >= quorum:
                    if quorum_at is None:
                        quorum_at = now
                    if grace_s is not None:
                        limit = min(limit, quorum_at + grace_s)
                if now >= limit:
                    break
                self._pred_cv.wait(limit - now)
            if len(self._expired) == self._expired.maxlen:
                self._expired_set.discard(self._expired[0])
            self._expired.append(query_id)
            self._expired_set.add(query_id)
            return self._preds.pop(query_id, [])
