"""The bus: per-worker query queues + per-query prediction slots.

The port's own copy of ``rafiki_tpu/bus/queues.py``: the in-process bus
(``InProcBus``) and the multiprocessing bus (``make_mp_bus``), with the
same interface:

  add_worker(job_id, worker_id)          — register a live worker
  get_workers(job_id, max_age_s=None)    — running-worker set
  remove_worker(job_id, worker_id)
  heartbeat(job_id, worker_id)           — refresh the liveness lease
  add_query(worker_id, query_id, query)  — predictor → worker fan-out
  pop_queries(worker_id, max_n, timeout) — worker batch pull
  put_prediction(query_id, worker_id, prediction, hops=None)
  get_predictions(query_id, n, timeout)  — predictor gather-wait

Trace envelopes, as in the JAX package: when a trace context is
active (or an explicit ``trace`` dict is passed), ``add_query``
enqueues ``(query_id, query, trace)`` instead of the bare 2-tuple,
journals the fan-out hop (``bus/add_query``), and ``pop_queries`` hands
the envelope through, so the inference worker re-binds the trace and
its spans and journal records stitch into the same end-to-end trace as
the gateway's. Untraced messages stay 2-tuples. The trace dict holds
``trace_id``, the enqueuing span as ``parent_span`` and the tenant,
where there are, and the hop marks (``obs/anatomy/hops.py``): the
gateway's thread-local prefix (``admit``, ``queue``) plus the ``enq``
mark stamped here. A worker with a hop chain replies
``(worker_id, prediction, hops)``; plain replies stay 2-tuples.

Liveness is a LEASE refreshed by each worker's heartbeat thread;
``get_workers(max_age_s=...)`` sees only fresh leases and reaps leases
``REAP_FACTOR`` times older (``RAFIKI_BUS_REAP_FACTOR``), and
``reap_stale`` deletes corpses.

Chaos sites, as in the JAX package: ``bus.add_query`` (``drop`` a
fan-out message), ``bus.put_prediction`` (``drop`` a reply) and
``bus.heartbeat`` (``skip`` a lease refresh), each keyed by the worker
id; and on the multiprocessing bus ``bus.proxy``, an injected fault at
the start of a round-trip to the bus's server (``error`` raises, as a
dead manager would; ``delay`` stalls it), keyed by the verb
(``get_workers``, ``add_query``, ``pop_queries``, ``put_prediction``).
All fire in the calling process.

The multiprocessing bus departs from the JAX package's on purpose. The
JAX package's ``_MpBus`` keeps its state in ``Manager.dict`` proxies
behind a ``Manager.Lock`` that CLIENT processes acquire and release in
separate round-trips: a worker SIGKILLed between the two leaves the lock
taken for good, and every later bus call of every process waits on it
forever. Here the state is one object in the manager's server process
(``BusState``, registered on ``BusManager``), and every verb is ONE
method call that takes the server's own lock and releases it before it
replies, so a client killed at any moment cannot leave the lock held.
Blocking waits (``pop_queries``, ``get_predictions``) are client-side
polls of such calls with deadlines; no wait on this bus is unbounded.
Leases are stamped with the server's monotonic clock.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from multiprocessing.managers import BaseManager, BaseProxy
from typing import Any, Dict, List, Optional, Tuple

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.chaos import hook as _chaos
from rafiki_tpu_torch.obs import context as _trace_context
from rafiki_tpu_torch.obs.anatomy import hops as _hops
from rafiki_tpu_torch.obs.journal import journal as _journal


def _current_trace() -> Optional[Dict[str, Any]]:
    """The active trace as a plain envelope field (None when untraced:
    the message stays a 2-tuple)."""
    tid = _trace_context.current_trace_id()
    if tid is None:
        return None
    trace: Dict[str, Any] = {"trace_id": tid}
    parent = telemetry.current_span_id()
    if parent:
        trace["parent_span"] = parent
    tenant = _trace_context.current_tenant()
    if tenant:
        trace["tenant"] = tenant
    return trace


def _envelope(query_id: str, query: Any,
              trace: Optional[Dict[str, Any]]) -> tuple:
    trace = trace or _current_trace()
    if trace is None:
        return (query_id, query)
    if "hops" not in trace:
        # Hop marks ride the envelope: the gateway's thread-local prefix
        # (admit/queue), then the enqueue mark stamped here. Copy before
        # annotating: an explicit trace arg may be a caller-owned dict
        # shared across queries.
        trace = dict(trace)
        trace["hops"] = _hops.prefix_marks() + [_hops.mark("enq")]
    # Journal the fan-out hop so the bus appears in the stitched trace.
    _journal.record("bus", "add_query", query_id=query_id,
                    trace_id=trace.get("trace_id"),
                    parent_span=trace.get("parent_span"))
    return (query_id, query, trace)


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
        if _chaos("bus.heartbeat", worker_id) == "skip":
            return  # injected missed beat: the lease ages as if dead
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
        if _chaos("bus.add_query", worker_id) == "drop":
            telemetry.inc("bus.queries_dropped_chaos")
            return  # injected loss: the gather just sees one fewer reply
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
        if _chaos("bus.put_prediction", worker_id) == "drop":
            return  # injected reply loss
        # Reply-leg hop carriage: plain replies stay (worker_id,
        # prediction); a worker with a hop chain appends it third.
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


# -- the multiprocessing bus ---------------------------------------------------


class BusState:
    """The multiprocessing bus's whole state, held in the manager's
    server process. Every method runs in the server thread of the
    calling client's connection and does its update under ``_lock``
    within that one call: the lock is released before the reply is sent,
    so no client, killed or alive, ever holds it. Leases are stamped
    with this process's monotonic clock, the one clock every client's
    lease is compared on."""

    def __init__(self, reap_factor: float, expired_cap: int):
        self._lock = threading.Lock()
        self._reap_factor = float(reap_factor)
        self._expired_cap = int(expired_cap)
        self._queues: Dict[str, List[tuple]] = {}    # worker -> pending envelopes
        self._preds: Dict[str, List[tuple]] = {}     # query -> replies
        self._workers: Dict[str, List[str]] = {}     # job -> worker ids
        self._worker_ts: Dict[Tuple[str, str], float] = {}
        self._expired: Dict[str, None] = {}          # insertion-ordered ids

    def set_expired_cap(self, cap: int) -> None:
        with self._lock:
            self._expired_cap = int(cap)

    def add_worker(self, job_id: str, worker_id: str) -> None:
        with self._lock:
            ws = self._workers.setdefault(job_id, [])
            if worker_id not in ws:
                ws.append(worker_id)
            self._queues.setdefault(worker_id, [])
            self._worker_ts[(job_id, worker_id)] = time.monotonic()

    def remove_worker(self, job_id: str, worker_id: str) -> None:
        with self._lock:
            ws = self._workers.get(job_id, [])
            if worker_id in ws:
                ws.remove(worker_id)
            self._worker_ts.pop((job_id, worker_id), None)
            self._queues.pop(worker_id, None)

    def heartbeat(self, job_id: str, worker_id: str) -> None:
        with self._lock:
            if worker_id in self._workers.get(job_id, ()):  # never resurrect
                self._worker_ts[(job_id, worker_id)] = time.monotonic()

    def get_workers(self, job_id: str, max_age_s: Optional[float]
                    ) -> Tuple[List[str], List[Tuple[str, str]]]:
        """The job's worker set (fresh leases only, with ``max_age_s``)
        and the corpses this read reaped at ``REAP_FACTOR`` x the TTL."""
        with self._lock:
            ws = self._workers.get(job_id, [])
            if max_age_s is None:
                return sorted(ws), []
            now = time.monotonic()
            reaped = self._reap_locked(now - max_age_s * self._reap_factor, [job_id])
            cutoff = now - max_age_s
            return sorted(w for w in ws
                          if self._worker_ts.get((job_id, w), 0.0) >= cutoff), reaped

    def reap_stale(self, max_age_s: float, job_id: Optional[str]
                   ) -> List[Tuple[str, str]]:
        with self._lock:
            jobs = [job_id] if job_id is not None else list(self._workers)
            return self._reap_locked(time.monotonic() - max_age_s, jobs)

    def _reap_locked(self, cutoff: float, jobs: List[str]) -> List[Tuple[str, str]]:
        reaped: List[Tuple[str, str]] = []
        for j in jobs:
            ws = self._workers.get(j, [])
            dead = [w for w in ws if self._worker_ts.get((j, w), 0.0) < cutoff]
            for w in dead:
                ws.remove(w)
                self._worker_ts.pop((j, w), None)
                self._queues.pop(w, None)
                reaped.append((j, w))
        return reaped

    def add_query(self, worker_id: str, item: tuple) -> bool:
        with self._lock:
            pending = self._queues.get(worker_id)
            if pending is None:  # dead worker → drop; gather sees n-1
                return False
            pending.append(item)
            return True

    def queue_depth(self, worker_id: str) -> int:
        with self._lock:
            return len(self._queues.get(worker_id, ()))

    def pop(self, worker_id: str, max_n: int) -> Optional[List[tuple]]:
        """Up to ``max_n`` pending envelopes; None when not registered."""
        with self._lock:
            pending = self._queues.get(worker_id)
            if pending is None:
                return None
            out = pending[:max_n]
            del pending[:max_n]
            return out

    def put_prediction(self, query_id: str, item: tuple) -> None:
        with self._lock:
            if query_id in self._expired:
                return  # late answer to a gathered query: drop, don't leak
            self._preds.setdefault(query_id, []).append(item)

    def replies(self, query_id: str) -> int:
        with self._lock:
            return len(self._preds.get(query_id, ()))

    def take(self, query_id: str) -> List[tuple]:
        """Pop a query's replies and expire it; the expired ids are
        trimmed oldest first past the cap."""
        with self._lock:
            preds = self._preds.pop(query_id, [])
            self._expired[query_id] = None
            while len(self._expired) > self._expired_cap:
                del self._expired[next(iter(self._expired))]
            return preds


class BusStateProxy(BaseProxy):
    """Client handle on a :class:`BusState`: each call is one round-trip
    to the manager's server. Importable by name, so it pickles into
    spawn children."""

    _exposed_ = ("set_expired_cap", "add_worker", "remove_worker", "heartbeat",
                 "get_workers", "reap_stale", "add_query", "queue_depth", "pop",
                 "put_prediction", "replies", "take")



def _verb(name: str):
    def call(self, *args):
        return self._callmethod(name, args)
    call.__name__ = name
    return call


for _name in BusStateProxy._exposed_:
    setattr(BusStateProxy, _name, _verb(_name))


class BusManager(BaseManager):
    """The manager process that holds a multiprocessing bus's state."""


BusManager.register("BusState", BusState, proxytype=BusStateProxy)


def _start_manager() -> BusManager:
    """A started :class:`BusManager` in a spawned server process."""
    import multiprocessing as mp

    manager = BusManager(ctx=mp.get_context("spawn"))
    manager.start()
    return manager


def make_mp_bus(manager: Optional[BusManager] = None) -> "_MpBus":
    """A multiprocessing-shared bus with the same interface, so the
    predictor and inference workers can run as separate processes (the
    reference's deployment shape, which it gets from Redis). The bus
    pickles into spawn children (never fork: the parent may hold a
    CUDA context). With no ``manager`` (the usual call) the bus starts
    its own, and ``bus.close()`` stops it; a ``manager`` passed in (a
    started :class:`BusManager`) stays its caller's to shut down."""
    if manager is not None:
        return _MpBus(manager)
    return _MpBus(_start_manager(), owns_manager=True)


class _MpBus:
    """Cross-process bus over one :class:`BusState` proxy (see the
    module docstring for why it is not the JAX package's design)."""

    _EXPIRED_CAP = 4096  # remembered gathered/timed-out query ids
    REAP_FACTOR = 6.0    # same auto-janitor contract as InProcBus
    # Poll period of the pop and gather waits: a floor under the
    # enq→deq and reply→gather hops, at about a thousand cheap round-trips
    # a second per idle waiter.
    _POLL_S = 0.001

    def __init__(self, manager: BusManager, owns_manager: bool = False):
        self._manager = manager  # keepalive only; dropped on pickle
        self._owns_manager = owns_manager
        self._cap = self._EXPIRED_CAP
        self._state = manager.BusState(
            float(os.environ.get("RAFIKI_BUS_REAP_FACTOR", str(self.REAP_FACTOR))),
            self._cap)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_manager"] = None  # children use the proxy, never the manager
        state["_owns_manager"] = False
        return state

    def close(self) -> None:
        """Stop the manager this bus started (bounded: the server is
        terminated if it does not stop within a second). A no-op in a
        child, on a bus over a caller's manager, and when called again."""
        if self._owns_manager and self._manager is not None:
            self._manager.shutdown()
            self._manager = None

    @property
    def _expired_cap(self) -> int:
        return self._cap

    @_expired_cap.setter
    def _expired_cap(self, cap: int) -> None:
        """Settable per instance (for tests), as the JAX package's is."""
        self._cap = int(cap)
        self._state.set_expired_cap(cap)

    @staticmethod
    def _proxy(op: str):
        """``bus.proxy`` chaos site: an injected fault at the start of a
        round-trip to the server, keyed by the verb, in the calling
        process. The caller's own error handling (breakers, quorum
        gathers, lease expiry) must absorb it."""
        return _chaos("bus.proxy", op)

    def add_worker(self, job_id, worker_id):
        self._state.add_worker(job_id, worker_id)

    def remove_worker(self, job_id, worker_id):
        self._state.remove_worker(job_id, worker_id)

    def heartbeat(self, job_id, worker_id):
        if _chaos("bus.heartbeat", worker_id) == "skip":
            return  # injected missed beat (chaos fires in the CALLING process)
        self._state.heartbeat(job_id, worker_id)

    def get_workers(self, job_id, max_age_s=None):
        self._proxy("get_workers")
        fresh, reaped = self._state.get_workers(job_id, max_age_s)
        if reaped:
            telemetry.inc("bus.reaped_workers", len(reaped))
        return fresh

    def reap_stale(self, max_age_s, job_id=None):
        """Same janitor contract as InProcBus.reap_stale. The reap
        counter is per-process: whichever process runs the janitor
        (normally the predictor's) observes the reaps."""
        reaped = self._state.reap_stale(max_age_s, job_id)
        if reaped:
            telemetry.inc("bus.reaped_workers", len(reaped))
        return reaped

    def add_query(self, worker_id, query_id, query, trace=None):
        if _chaos("bus.add_query", worker_id) == "drop":
            telemetry.inc("bus.queries_dropped_chaos")
            return
        self._proxy("add_query")
        self._state.add_query(worker_id, _envelope(query_id, query, trace))

    def queue_depth(self, worker_id):
        """Pending (unpopped) queries for one worker."""
        return self._state.queue_depth(worker_id)

    def pop_queries(self, worker_id, max_n=64, timeout=0.1):
        self._proxy("pop_queries")
        deadline = time.monotonic() + timeout
        while True:
            items = self._state.pop(worker_id, max_n)
            if items is None:  # not registered (stopped)
                time.sleep(min(timeout, 0.05))
                return []
            if items or time.monotonic() >= deadline:
                return items
            time.sleep(self._POLL_S)

    def put_prediction(self, query_id, worker_id, prediction, hops=None):
        if _chaos("bus.put_prediction", worker_id) == "drop":
            return
        self._proxy("put_prediction")
        item = ((worker_id, prediction) if hops is None
                else (worker_id, prediction, hops))
        self._state.put_prediction(query_id, item)

    def get_predictions(self, query_id, n, timeout=10.0, min_n=None,
                        grace_s=None):
        """Same contract as InProcBus.get_predictions, including the
        quorum/hedge relaxation, over polling instead of a condvar."""
        deadline = time.monotonic() + timeout
        quorum = n if min_n is None else max(1, min(min_n, n))
        quorum_at = None
        while True:
            got = self._state.replies(query_id)
            now = time.monotonic()
            if got >= n:
                break
            limit = deadline
            if got >= quorum:
                if quorum_at is None:
                    quorum_at = now
                if grace_s is not None:
                    limit = min(limit, quorum_at + grace_s)
            if now >= limit:
                break
            time.sleep(self._POLL_S)
        return self._state.take(query_id)
