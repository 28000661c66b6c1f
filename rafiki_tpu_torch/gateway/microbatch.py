"""Deadline-aware dynamic microbatching for the serving gateway.

The port's own copy of ``rafiki_tpu/gateway/microbatch.py``, with the
same flush rules, and each member's hop-mark prefix and hop chains.

With a stacked (single-worker, device-resident) ensemble the forward
itself is one launch sequence over the whole batch, which makes the
per-request fan-out the dominant cost; the cure is to coalesce
admitted requests into ONE fan-out.

:class:`MicroBatcher` is that coalescer. Admitted requests (each
already holding its admission slot — the inflight budget still bounds
concurrency) enqueue their queries and block; a dedicated flusher
thread flushes a combined batch when:

* **size** — pending queries reach ``max_batch``;
* **deadline** — the oldest member has waited ``max_wait_s``, or ANY
  member's deadline minus the expected service reserve is due — a
  request's budget is never burned waiting for co-batchers;
* **drain** — the gateway is draining: flush what's pending now.

The flush executes one batched fan-out (the gateway's
``_execute_batch``) and scatters per-member slices back; each member
thread then finishes its own bookkeeping (hop-chain absorb under its
OWN trace id, rollup, journal) so waterfalls still stitch per request.

``max_batch=1`` disables batching entirely — the gateway keeps the
classic per-request fan-out and this module is never constructed.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional

#: Flush triggers — a closed enum; each maps to one literal counter in
#: the gateway (serving.microbatch.flush_*).
FLUSH_REASONS = ("size", "deadline", "drain")

#: Floor on the flusher's timed wait so a mis-set max_wait can never
#: busy-spin the flush loop.
_MIN_WAIT_S = 0.0005


class BatchMember:
    """One admitted request riding a microbatch."""

    __slots__ = ("queries", "deadline", "prefix", "enq_t", "done",
                 "outputs", "chains", "error", "flush_reason", "report",
                 "elapsed_s")

    def __init__(self, queries: List[Any], deadline: float,
                 prefix: List[List[Any]], enq_t: float):
        self.queries = queries
        self.deadline = deadline          # monotonic absolute
        self.prefix = prefix              # this request's hop marks
        self.enq_t = enq_t
        self.done = threading.Event()
        self.outputs: Optional[List[Any]] = None
        self.chains = None                # worker -> full member chain
        self.error: Optional[BaseException] = None
        self.flush_reason: Optional[str] = None
        self.report = None                # shared BatchGatherReport
        self.elapsed_s = 0.0              # flush -> scatter wall

    def wait(self, timeout_s: float) -> bool:
        return self.done.wait(timeout_s)


class MicroBatcher:
    """Coalesce admitted requests into size/deadline-bounded batches.

    ``execute(members, flush_reason)`` runs in the flusher thread and
    must fill every member (outputs or error) and set its event; an
    exception it raises is fanned to all members of that batch.
    """

    def __init__(self, execute: Callable[[List[BatchMember], str], None],
                 max_batch: int, max_wait_s: float,
                 reserve_fn: Optional[Callable[[], float]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if max_batch < 2:
            raise ValueError("MicroBatcher needs max_batch >= 2; "
                             "max_batch=1 means batching is off")
        self._execute = execute
        self.max_batch = max_batch
        self.max_wait_s = max(0.0, max_wait_s)
        self._reserve_fn = reserve_fn or (lambda: 0.0)
        self._clock = clock
        self._cond = threading.Condition()
        self._pending: List[BatchMember] = []
        self._closing = False
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gateway-microbatch")
        self._thread.start()

    # -- producer side -------------------------------------------------------

    def submit(self, queries: List[Any], deadline: float,
               prefix: List[List[Any]]) -> BatchMember:
        """Enqueue one admitted request; returns its member handle.
        The caller blocks on ``member.wait()`` — admission slot held."""
        m = BatchMember(list(queries), deadline, prefix, self._clock())
        with self._cond:
            if self._stopped:
                raise RuntimeError("microbatcher stopped")
            self._pending.append(m)
            self._cond.notify()
        return m

    def drain(self) -> None:
        """Flush whatever is pending immediately (reason ``drain``).
        New submits still work until :meth:`stop` — the gateway sheds
        them upstream once draining."""
        with self._cond:
            self._closing = True
            self._cond.notify()

    def stop(self) -> None:
        with self._cond:
            self._closing = True
            self._stopped = True
            self._cond.notify()
        self._thread.join(timeout=2.0)

    @property
    def pending(self) -> int:
        with self._cond:
            return len(self._pending)

    # -- flusher -------------------------------------------------------------

    def _flush_due(self, now: float) -> Optional[str]:
        """The reason to flush NOW, or None to keep waiting."""
        if sum(len(m.queries) for m in self._pending) >= self.max_batch:
            return "size"
        if self._closing:
            return "drain"
        if now >= self._flush_at():
            return "deadline"
        return None

    def _flush_at(self) -> float:
        """When the pending batch must flush: the oldest member's
        max-wait expiry, capped by every member's deadline minus the
        expected service reserve — waiting never burns a budget the
        fan-out itself needs."""
        reserve = self._reserve_fn()
        t = min(m.enq_t for m in self._pending) + self.max_wait_s
        for m in self._pending:
            t = min(t, m.deadline - reserve)
        return t

    def _take(self) -> List[BatchMember]:
        """FIFO members up to ``max_batch`` queries (always >= 1 member
        — one oversized request still ships alone). Caller (the flusher
        loop) holds ``self._cond``."""
        batch: List[BatchMember] = []
        n = 0
        while self._pending:
            m = self._pending[0]
            if batch and n + len(m.queries) > self.max_batch:
                break
            batch.append(self._pending.pop(0))
            n += len(m.queries)
        return batch

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending:
                    if self._stopped:
                        return
                    self._cond.wait(0.1)
                now = self._clock()
                reason = self._flush_due(now)
                if reason is None:
                    self._cond.wait(max(_MIN_WAIT_S, self._flush_at() - now))
                    continue
                batch = self._take()
            try:
                self._execute(batch, reason)
            except BaseException as e:  # noqa: BLE001 — fanned to members
                for m in batch:
                    if not m.done.is_set():
                        m.error = e
                        m.done.set()
                if not isinstance(e, Exception):
                    raise  # interrupts propagate after members unblock
