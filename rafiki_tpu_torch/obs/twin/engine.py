"""The discrete-event serving simulator.

The port's own copy of ``rafiki_tpu/obs/twin/engine.py``.

One :func:`simulate` call replays an arrival sequence through a model
of the full serving chain and returns headline metrics plus a
deterministic event log:

    arrive → admission (inflight budget / bounded queue / deadline
    shed) → route (breaker-filtered fan-out, policy) → per-worker FIFO
    service (sampled batch_wait + forward + reply_publish) → per-query
    quorum gather with hedge grace → request done → breaker feedback →
    slot release → next waiter admitted.

Fidelity rules:

* **Constants are imported, not copied.** Admission caps and the
  deadline-reserve rule come from the run's :class:`TwinConfig`
  (mirroring ``GatewayConfig`` field-for-field), the reserve fraction
  and EWMA weight from ``rafiki_tpu_torch.gateway.gateway``, the quorum
  formula from ``rafiki_tpu_torch.predictor`` — and the per-worker breakers
  are the LIVE :class:`~rafiki_tpu_torch.gateway.breaker.CircuitBreaker`
  class running on the sim clock, so open/half-open/close transitions
  fire at exactly the thresholds production uses.
* **Queueing is emergent, service is sampled.** ``admission_wait`` and
  ``bus_queue`` come out of the simulated queues; ``route`` /
  ``batch_wait`` / ``forward`` / ``reply_publish`` / ``gather_decide``
  are drawn from the calibration's captured samples (or a cost-model
  roofline point).
* **Deterministic.** One ``random.Random(seed)`` stream for service
  sampling, seeded streams in the load generator and the chaos plane,
  no ambient clocks: same seed + same calibration → the same
  event log, bit for bit.

Chaos: a ``RAFIKI_CHAOS``-grammar spec parses into a private
:class:`~rafiki_tpu_torch.chaos.plane.FaultPlane` consulted at the same
sites the live path hooks — ``gateway.predict`` (frontend stall /
poisoned request), ``bus.add_query`` (dropped envelope),
``inference.forward`` (slow / erroring / killed worker). Only
``decide`` is used — a simulated SIGKILL marks the model worker dead,
it does not signal anyone.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import math
import random
from hashlib import sha1
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from rafiki_tpu_torch.chaos.plane import FaultPlane
from rafiki_tpu_torch.gateway.breaker import CircuitBreaker, OPEN
from rafiki_tpu_torch.gateway.gateway import (DEADLINE_RESERVE_FRAC,
                                        GatewayConfig, LATENCY_EWMA_ALPHA)
from rafiki_tpu_torch.obs.twin.calibration import Calibration
from rafiki_tpu_torch.predictor.predictor import default_quorum

RESULT_SCHEMA_VERSION = 1

#: Resources the saturation report ranks, in tie-break priority order.
RESOURCES = ("worker", "gateway_inflight", "queue", "breaker", "hbm")

#: Cap on the events list carried in the result; the log hash always
#: covers ALL events regardless.
EVENT_CAP = 200_000


@dataclasses.dataclass
class TwinConfig:
    """The knob set one simulation runs under — a field-for-field
    mirror of the live ``GatewayConfig`` admission/gather knobs plus
    the fleet shape. Build via :meth:`from_calibration` to simulate
    the captured run, then override knobs for what-ifs."""

    workers: int = 2
    queries_per_request: int = 1     # the microbatch knob
    max_inflight: int = 8
    max_queue: int = 32
    deadline_s: float = 2.0
    min_replies: Optional[int] = None   # None → default_quorum(fan-out)
    hedge_grace_s: float = 0.25
    policy: str = "replicate-all"
    breaker_failures: int = 3
    breaker_cooldown_s: float = 5.0
    #: Micro-batch cap per forward — InferenceWorker's batch_size
    #: (bus.pop_queries max_n). Not a gateway knob, so not captured in
    #: gateway/config; override when the fleet runs a non-default cap.
    worker_batch: int = 64
    #: Gateway dynamic microbatcher (GatewayConfig.max_batch /
    #: max_batch_wait_ms, in SECONDS here like every sim knob): >1
    #: models the post-admission batch former — requests accumulate
    #: until max_batch queries or the deadline-aware wait expires, then
    #: ONE fan-out serves the whole batch. 1 = per-request fan-out.
    max_batch: int = 1
    max_batch_wait_s: float = 0.005
    #: Per-tenant QoS classes (docs/multitenancy.md): tenant id →
    #: ``{"weight": w}``. None → tenant-blind admission (the
    #: pre-tenancy gateway), byte-identical to earlier results. With
    #: tenants set, admission mirrors TenantAdmissionController:
    #: per-tenant queue/inflight quotas at ``tenant_quota_frac`` of
    #: capacity and weighted-fair granting by inflight/weight charge.
    tenants: Optional[Dict[str, Dict[str, float]]] = None
    #: Mirror of TenantDirectory.quota_frac.
    tenant_quota_frac: float = 0.5

    @classmethod
    def from_gateway(cls, g: GatewayConfig, workers: int,
                     **overrides) -> "TwinConfig":
        base = dict(workers=workers,
                    max_inflight=g.max_inflight, max_queue=g.max_queue,
                    deadline_s=g.default_deadline_s or 2.0,
                    min_replies=g.min_replies,
                    hedge_grace_s=g.hedge_grace_s, policy=g.policy,
                    breaker_failures=g.breaker_failures,
                    breaker_cooldown_s=g.breaker_cooldown_s,
                    max_batch=g.max_batch,
                    max_batch_wait_s=g.max_batch_wait_ms / 1000.0)
        base.update(overrides)
        return cls(**base)

    @classmethod
    def from_calibration(cls, cal: Calibration, **overrides) -> "TwinConfig":
        g = cal.gateway
        base = dict(workers=cal.workers,
                    max_inflight=int(g.get("max_inflight", 8)),
                    max_queue=int(g.get("max_queue", 32)),
                    deadline_s=float(g.get("default_deadline_s") or 2.0),
                    min_replies=g.get("min_replies"),
                    hedge_grace_s=float(g.get("hedge_grace_s", 0.25)),
                    policy=g.get("policy") or "replicate-all",
                    breaker_failures=int(g.get("breaker_failures", 3)),
                    breaker_cooldown_s=float(g.get("breaker_cooldown_s",
                                                   5.0)),
                    max_batch=int(g.get("max_batch", 1)),
                    max_batch_wait_s=float(g.get("max_batch_wait_ms",
                                                 5.0)) / 1000.0)
        base.update(overrides)
        return cls(**base)


class _Worker:
    __slots__ = ("wid", "queue", "busy", "alive", "warm", "busy_s")

    def __init__(self, wid: str):
        self.wid = wid
        self.queue: List[Tuple[Any, int]] = []   # (request, query index)
        self.busy = False
        self.alive = True
        self.warm = False
        self.busy_s = 0.0


class _Request:
    __slots__ = ("rid", "arrival", "queries", "deadline", "admit_deadline",
                 "admit_t", "join_t", "fanset", "quorum", "replies",
                 "decided", "done_q", "timeouts", "outcome", "done_t",
                 "replied_by", "tenant")

    def __init__(self, rid: int, arrival: float, queries: int,
                 tenant: Optional[str] = None):
        self.rid = rid
        self.arrival = arrival
        self.queries = queries
        self.tenant = tenant
        self.admit_t: Optional[float] = None
        self.join_t: Optional[float] = None   # microbatch former entry
        self.fanset: List[str] = []
        self.quorum = 1
        self.replies: List[List[float]] = []   # per query: reply times
        self.decided: List[bool] = []
        self.done_q: List[float] = []
        self.timeouts = 0
        self.outcome: Optional[str] = None
        self.done_t: Optional[float] = None
        self.replied_by: set = set()


class _Sim:
    def __init__(self, cal: Calibration, cfg: TwinConfig,
                 arrivals: Sequence[Union[float, Tuple[float, int]]],
                 seed: int, chaos_spec: Optional[str],
                 record_events: bool):
        self.cal = cal
        self.cfg = cfg
        self.rng = random.Random(f"{seed}:service")
        self.plane = (FaultPlane.from_spec(chaos_spec)
                      if chaos_spec else None)
        self.record_events = record_events
        self.now = 0.0
        self._heap: List[Tuple[float, int, str, Any]] = []
        self._seq = 0
        self.workers = {f"w{i}": _Worker(f"w{i}")
                        for i in range(cfg.workers)}
        self.order = sorted(self.workers)
        self.breakers = {w: CircuitBreaker(cfg.breaker_failures,
                                           cfg.breaker_cooldown_s,
                                           clock=lambda: self.now)
                         for w in self.order}
        self._breaker_open_since: Dict[str, float] = {}
        self.breaker_open_s = 0.0
        self.breaker_transitions: List[Tuple[float, str, str, str]] = []
        # Admission state (mirrors gateway/admission.py semantics).
        self.inflight = 0
        self.waiting: List[_Request] = []
        self.queue_peak = 0
        self.ewma: Optional[float] = None
        # Microbatch former state (mirrors gateway/microbatch.py when
        # cfg.max_batch > 1). The gateway's blackout re-route is NOT
        # modeled — it only engages on total fan-out death, which the
        # twin surfaces directly as worker_dead + breaker feedback.
        self.batch_pending: List[_Request] = []
        self.batch_flushes: Dict[str, int] = {}
        self.batch_sizes: List[int] = []
        # Metrics.
        self.requests: List[_Request] = []
        self.shed: Dict[str, int] = {}
        self.events: List[Tuple[float, str, str]] = []
        self.n_events = 0
        self.horizon = 0.0   # last REAL activity; stale deadline events
        #                      advance `now` but must not stretch duration
        self._hash = sha1()
        self._inflight_area = 0.0
        self._inflight_mark = 0.0
        # Arrivals normalized to (t, n_queries, tenant) — plain floats
        # and 2-tuples stay tenant-less (back-compat wire shapes).
        self.arrivals: List[Tuple[float, int, Optional[str]]] = [
            (float(a), cfg.queries_per_request, None)
            if isinstance(a, (int, float))
            else (float(a[0]), int(a[1]),
                  a[2] if len(a) > 2 else None)
            for a in arrivals]
        self.arrivals.sort(key=lambda p: p[0])
        # Per-tenant admission state (mirrors tenancy/admission.py);
        # inert when cfg.tenants is None.
        self.tenant_inflight: Dict[Optional[str], int] = {}
        self.tenant_shed: Dict[Tuple[Optional[str], str], int] = {}
        if cfg.tenants:
            frac = min(1.0, max(0.05, cfg.tenant_quota_frac))
            self.quota_inflight = max(1, int(math.ceil(
                cfg.max_inflight * frac)))
            self.quota_queue = (max(1, int(math.ceil(cfg.max_queue * frac)))
                                if cfg.max_queue else 0)

    # -- plumbing ------------------------------------------------------------

    def _push(self, t: float, kind: str, payload: Any) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, kind, payload))

    def _log(self, kind: str, detail: str) -> None:
        self.horizon = max(self.horizon, self.now)
        ev = (round(self.now, 7), kind, detail)
        self._hash.update(repr(ev).encode())
        self.n_events += 1
        if self.record_events and len(self.events) < EVENT_CAP:
            self.events.append(ev)

    def _sample(self, segment: str) -> float:
        xs = self.cal.dist(segment)
        if not xs:
            return 0.0
        return xs[self.rng.randrange(len(xs))]

    def _decide(self, site: str, key: str):
        return self.plane.decide(site, key) if self.plane else None

    def _track_inflight(self, delta: int) -> None:
        self._inflight_area += self.inflight * (self.now -
                                                self._inflight_mark)
        self._inflight_mark = self.now
        self.inflight += delta

    def _feed_breaker(self, w: str, ok: bool, latency: float) -> None:
        br = self.breakers[w]
        before = br.state
        if ok:
            br.record_success(latency_s=latency)
        else:
            br.record_failure()
        after = br.state
        if after != before:
            self.breaker_transitions.append((round(self.now, 7), w,
                                             before, after))
            self._log("breaker_" + after.replace("-", "_"), w)
            if after == OPEN:
                self._breaker_open_since[w] = self.now
            elif before == OPEN or w in self._breaker_open_since:
                self.breaker_open_s += (self.now -
                                        self._breaker_open_since.pop(w,
                                                                     self.now))

    # -- admission (mirrors AdmissionController.admit) -----------------------

    def _weight(self, tenant: Optional[str]) -> float:
        spec = (self.cfg.tenants or {}).get(tenant or "", {})
        return max(float(spec.get("weight", 1.0)), 1e-9)

    def _arrive(self, req: _Request) -> None:
        self._log("arrive", f"r{req.rid}")
        reserve = min(self.ewma or 0.0,
                      self.cfg.deadline_s * DEADLINE_RESERVE_FRAC)
        req.deadline = req.arrival + self.cfg.deadline_s
        req.admit_deadline = req.deadline - reserve
        if self.cfg.tenants:
            # Tenant-aware admission (mirrors TenantAdmissionController
            # shed order: tenant_quota before queue_full, so a flooder
            # is charged before it can fill the shared queue).
            t = req.tenant
            if (self.inflight < self.cfg.max_inflight and not self.waiting
                    and self.tenant_inflight.get(t, 0)
                    < self.quota_inflight):
                self._admit(req)
            elif (self.quota_queue
                    and sum(1 for r in self.waiting if r.tenant == t)
                    >= self.quota_queue):
                self._shed(req, "tenant_quota")
            elif len(self.waiting) >= self.cfg.max_queue:
                self._shed(req, "queue_full")
            elif self.now >= req.admit_deadline:
                self._shed(req, "deadline")
            else:
                self.waiting.append(req)
                self.queue_peak = max(self.queue_peak, len(self.waiting))
                self._push(req.admit_deadline, "queue_deadline", req)
            return
        if self.inflight < self.cfg.max_inflight and not self.waiting:
            self._admit(req)
        elif len(self.waiting) >= self.cfg.max_queue:
            self._shed(req, "queue_full")
        elif self.now >= req.admit_deadline:
            self._shed(req, "deadline")
        else:
            self.waiting.append(req)
            self.queue_peak = max(self.queue_peak, len(self.waiting))
            self._push(req.admit_deadline, "queue_deadline", req)

    def _next_waiter(self) -> Optional[_Request]:
        """Weighted-fair grant: the head (FIFO-within-tenant) waiter of
        the eligible tenant with the lowest inflight/weight charge,
        arrival order breaking ties — the same selection rule as
        TenantAdmissionController._chosen_tenant."""
        heads: Dict[Optional[str], _Request] = {}
        for r in self.waiting:
            if r.tenant not in heads:
                heads[r.tenant] = r
        eligible = [r for r in heads.values()
                    if self.tenant_inflight.get(r.tenant, 0)
                    < self.quota_inflight]
        if not eligible:
            return None
        return min(eligible,
                   key=lambda r: (self.tenant_inflight.get(r.tenant, 0)
                                  / self._weight(r.tenant), r.rid))

    def _pump(self) -> None:
        while self.inflight < self.cfg.max_inflight and self.waiting:
            if self.cfg.tenants:
                req = self._next_waiter()
                if req is None:
                    return   # everyone waiting is at their quota
                self.waiting.remove(req)
            else:
                req = self.waiting.pop(0)
            if self.now >= req.admit_deadline:
                self._shed(req, "deadline")
                continue
            self._admit(req)

    def _shed(self, req: _Request, reason: str) -> None:
        if req.outcome is not None:
            return
        req.outcome = "shed:" + reason
        self.shed[reason] = self.shed.get(reason, 0) + 1
        if self.cfg.tenants:
            key = (req.tenant, reason)
            self.tenant_shed[key] = self.tenant_shed.get(key, 0) + 1
        self._log("shed", f"r{req.rid} {reason}")

    def _admit(self, req: _Request) -> None:
        self._track_inflight(+1)
        if self.cfg.tenants:
            self.tenant_inflight[req.tenant] = (
                self.tenant_inflight.get(req.tenant, 0) + 1)
        req.admit_t = self.now
        self._log("admit", f"r{req.rid}")
        fault = self._decide("gateway.predict", f"r{req.rid}")
        if fault is not None and fault.mode == "error":
            # A poisoned frontend request: errors out still holding
            # its slot for zero time (the live hook raises pre-gather).
            req.outcome = "error"
            req.done_t = self.now
            self._log("done", f"r{req.rid} error")
            self._release(req)
            return
        delay = fault.delay_s if (fault is not None
                                  and fault.mode == "delay") else 0.0
        if self.cfg.max_batch > 1:
            self._push(self.now + delay, "batch_join", req)
        else:
            self._route(req, self.now + delay + self._sample("route"))

    def _release(self, req: Optional[_Request] = None) -> None:
        self._track_inflight(-1)
        if self.cfg.tenants and req is not None:
            self.tenant_inflight[req.tenant] = max(
                0, self.tenant_inflight.get(req.tenant, 0) - 1)
        self._pump()

    # -- gateway microbatch former (mirrors gateway/microbatch.py) -----------

    def _batch_join(self, req: _Request) -> None:
        if req.outcome is not None:
            return
        req.join_t = self.now
        self.batch_pending.append(req)
        self._log("batch_join", f"r{req.rid}")
        if self._batch_size() >= self.cfg.max_batch:
            self._batch_flush("size")
        else:
            self._push(self._batch_flush_at(), "batch_flush_check", None)

    def _batch_size(self) -> int:
        return sum(r.queries for r in self.batch_pending)

    def _batch_flush_at(self) -> float:
        """MicroBatcher._flush_at: oldest member's max-wait expiry,
        capped by every member's deadline minus the service reserve."""
        reserve = self.ewma or 0.0
        t = (min(r.join_t for r in self.batch_pending)
             + self.cfg.max_batch_wait_s)
        for r in self.batch_pending:
            t = min(t, r.deadline - reserve)
        return max(t, self.now)

    def _batch_flush_check(self) -> None:
        if not self.batch_pending:
            return   # stale timer: an earlier size flush took everyone
        if self._batch_size() >= self.cfg.max_batch:
            self._batch_flush("size")
        elif self.now >= self._batch_flush_at():
            self._batch_flush("deadline")

    def _batch_flush(self, reason: str) -> None:
        """FIFO members up to max_batch queries (always >= 1 member),
        then ONE fan-out for the whole batch: members share the flush
        instant and route sample, and their queries land on the workers
        at the same t_enq — the worker model's micro-batch drain then
        serves them in one forward, the live stacked worker's
        single-launch shape."""
        batch: List[_Request] = []
        nq = 0
        while self.batch_pending:
            r = self.batch_pending[0]
            if batch and nq + r.queries > self.cfg.max_batch:
                break
            batch.append(self.batch_pending.pop(0))
            nq += r.queries
        self.batch_flushes[reason] = self.batch_flushes.get(reason, 0) + 1
        self.batch_sizes.append(nq)
        self._log("batch_flush", f"n={nq} {reason}")
        t_enq = self.now + self._sample("route")
        for r in batch:
            self._route(r, t_enq)
        if self.batch_pending:
            self._push(self._batch_flush_at(), "batch_flush_check", None)

    # -- routing + worker service (mirrors Gateway._route) -------------------

    def _backlog(self, w: _Worker) -> int:
        return len(w.queue) + (1 if w.busy else 0)

    def _route(self, req: _Request, t_enq: float) -> None:
        allowed = [w for w in self.order if self.breakers[w].allow()]
        if not allowed:
            allowed = list(self.order)   # forced probe, like the gateway
        if self.cfg.policy == "least-loaded":
            allowed = [min(allowed,
                           key=lambda w: (self._backlog(self.workers[w]),
                                          w))]
            req.quorum = 1
        else:
            req.quorum = (self.cfg.min_replies
                          if self.cfg.min_replies is not None
                          else default_quorum(len(allowed)))
        req.fanset = allowed
        req.replies = [[] for _ in range(req.queries)]
        req.decided = [False] * req.queries
        req.done_q = [0.0] * req.queries
        self._push(req.deadline, "request_deadline", req)
        for qi in range(req.queries):
            for w in allowed:
                if self._fault_drops(w, req, qi):
                    continue
                self._push(t_enq, "enqueue", (req, qi, w))

    def _fault_drops(self, w: str, req: _Request, qi: int) -> bool:
        fault = self._decide("bus.add_query", w)
        if fault is not None and fault.mode == "drop":
            self._log("drop", f"r{req.rid}q{qi} {w}")
            return True
        return False

    def _enqueue(self, req: _Request, qi: int, wid: str) -> None:
        wk = self.workers[wid]
        if not wk.alive:
            return
        wk.queue.append((req, qi))
        if not wk.busy:
            self._start_next(wk)

    def _start_next(self, wk: _Worker) -> None:
        """Pop a MICRO-BATCH and run one forward for all of it —
        mirroring InferenceWorker/bus.pop_queries, which drain the
        queue (up to batch_size) after the first query arrives so the
        device sees batches, not query-at-a-time traffic. One sampled
        forward covers the whole batch, exactly as one ``fwd`` hop mark
        is shared by every chain in a live micro-batch."""
        if not wk.queue:
            wk.busy = False
            return
        batch = wk.queue[:self.cfg.worker_batch]
        wk.queue = wk.queue[len(batch):]
        fault = self._decide("inference.forward", wk.wid)
        if fault is not None and fault.mode in ("kill", "term"):
            wk.alive = False
            wk.queue = []
            wk.busy = False
            self._log("worker_dead", wk.wid)
            return
        dur = self._sample("batch_wait")
        if fault is not None and fault.mode == "error":
            pass   # chaos raises before predict; the worker catches
            #        and still publishes (error) payloads per query
        else:
            dur += self._sample("forward_cold" if not wk.warm
                                else "forward")
            if fault is not None and fault.mode == "delay":
                dur += fault.delay_s
        wk.warm = True
        wk.busy = True
        self._log("start", f"{wk.wid} n={len(batch)}")
        # Publishes happen sequentially on the worker thread after the
        # forward; the worker is busy until the last one lands.
        t = self.now + dur
        for req, qi in batch:
            t += self._sample("reply_publish")
            self._push(t, "reply", (req, qi, wk.wid))
        wk.busy_s += t - self.now
        self._push(t, "batch_done", wk)

    def _batch_done(self, wk: _Worker) -> None:
        if wk.alive:
            self._start_next(wk)

    # -- gather (mirrors Predictor quorum + hedge semantics) -----------------

    def _reply(self, req: _Request, qi: int, wid: str) -> None:
        if req.outcome is not None or req.decided[qi]:
            return   # late reply: gather already decided
        self._log("reply", f"r{req.rid}q{qi} {wid}")
        req.replies[qi].append(self.now)
        req.replied_by.add(wid)
        n = len(req.replies[qi])
        if n >= len(req.fanset):
            self._decide_query(req, qi)
        elif n == req.quorum:
            self._push(self.now + self.cfg.hedge_grace_s, "hedge",
                       (req, qi))

    def _decide_query(self, req: _Request, qi: int) -> None:
        if req.outcome is not None or req.decided[qi]:
            return
        req.decided[qi] = True
        if not req.replies[qi]:
            req.timeouts += 1
        # No sampled decide cost: the reply→decide span in live hop
        # chains is the quorum/hedge wait, which this engine simulates
        # directly (calibration.EMERGENT_SEGMENTS).
        req.done_q[qi] = self.now
        self._log("decide", f"r{req.rid}q{qi} n={len(req.replies[qi])}")
        if all(req.decided):
            self._finish(req, max(req.done_q))

    def _deadline(self, req: _Request) -> None:
        if req.outcome is not None:
            return
        for qi in range(req.queries):
            if not req.decided[qi]:
                self._decide_query(req, qi)
                if req.outcome is not None:
                    return

    def _finish(self, req: _Request, t_done: float) -> None:
        self.now = max(self.now, t_done)
        req.done_t = t_done
        req.outcome = "ok" if req.timeouts == 0 else "error"
        self._log("done", f"r{req.rid} {req.outcome}")
        latency = t_done - req.admit_t
        for w in req.fanset:
            self._feed_breaker(w, w in req.replied_by, latency)
        req.replied_by = set()
        if req.outcome == "ok":
            a = LATENCY_EWMA_ALPHA
            self.ewma = (latency if self.ewma is None
                         else (1 - a) * self.ewma + a * latency)
        self._release(req)

    # -- main loop -----------------------------------------------------------

    def run(self) -> None:
        for t, n, tenant in self.arrivals:
            req = _Request(len(self.requests), t, n, tenant=tenant)
            self.requests.append(req)
            self._push(t, "arrive", req)
        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            self.now = max(self.now, t)
            if kind == "arrive":
                self._arrive(payload)
            elif kind == "enqueue":
                self._enqueue(*payload)
            elif kind == "reply":
                self._reply(*payload)
            elif kind == "batch_done":
                self._batch_done(payload)
            elif kind == "batch_join":
                self._batch_join(payload)
            elif kind == "batch_flush_check":
                self._batch_flush_check()
            elif kind == "hedge":
                req, qi = payload
                self._decide_query(req, qi)
            elif kind == "request_deadline":
                self._deadline(payload)
            elif kind == "queue_deadline":
                req = payload
                if req.outcome is None and req.admit_t is None:
                    if req in self.waiting:
                        self.waiting.remove(req)
                    self._shed(req, "deadline")
                    self._pump()


def _pct(xs: List[float], p: float) -> Optional[float]:
    if not xs:
        return None
    last = len(xs) - 1
    return xs[min(last, int(last * p / 100))]


def simulate(cal: Calibration, cfg: TwinConfig,
             arrivals: Sequence[Union[float, Tuple[float, int]]],
             seed: int = 0, chaos_spec: Optional[str] = None,
             record_events: bool = False) -> Dict[str, Any]:
    """Run one simulation; returns the headline result dict (see
    docs/twin.md for the schema). ``record_events`` additionally
    carries the full event log (capped) in ``events``."""
    sim = _Sim(cal, cfg, arrivals, seed, chaos_spec, record_events)
    sim.run()
    reqs = sim.requests
    n = len(reqs)
    ok = [r for r in reqs if r.outcome == "ok"]
    shed = sum(sim.shed.values())
    errors = sum(1 for r in reqs if r.outcome == "error")
    lat = sorted(r.done_t - r.admit_t for r in ok)
    full = sorted(r.done_t - r.arrival for r in ok)
    t0 = reqs[0].arrival if reqs else 0.0
    duration = max(sim.horizon - t0, 1e-9)
    # Close out the open-interval accumulators at the horizon.
    sim.now = sim.horizon
    sim._track_inflight(0)
    for w, since in sim._breaker_open_since.items():
        sim.breaker_open_s += max(0.0, sim.horizon - since)
    util: Dict[str, Optional[float]] = {
        "worker": round(sum(w.busy_s for w in sim.workers.values())
                        / (duration * cfg.workers), 4),
        "gateway_inflight": round(sim._inflight_area
                                  / (duration * cfg.max_inflight), 4),
        "queue": (round(sim.queue_peak / cfg.max_queue, 4)
                  if cfg.max_queue else (1.0 if sim.queue_peak else 0.0)),
        "breaker": round(sim.breaker_open_s / (duration * cfg.workers), 4),
        "hbm": cal.hbm_frac(),
    }
    ranked = sorted(((util[r], -RESOURCES.index(r), r) for r in RESOURCES
                     if util[r] is not None), reverse=True)
    first_saturating = ranked[0][2] if ranked else None
    result: Dict[str, Any] = {
        "schema_version": RESULT_SCHEMA_VERSION,
        "seed": seed,
        "requests": n,
        "ok": len(ok),
        "shed": shed,
        "errors": errors,
        "shed_reasons": dict(sorted(sim.shed.items())),
        "duration_s": round(duration, 6),
        "qps": round(n / duration, 3),
        "p50_ms": _ms(_pct(lat, 50)),
        "p99_ms": _ms(_pct(lat, 99)),
        "mean_ms": _ms(sum(lat) / len(lat) if lat else None),
        "full_p50_ms": _ms(_pct(full, 50)),
        "full_p99_ms": _ms(_pct(full, 99)),
        "shed_rate": round(shed / n, 4) if n else None,
        "utilization": util,
        "first_saturating": first_saturating,
        "breaker_transitions": [list(t) for t in sim.breaker_transitions],
        "workers_dead": sorted(w.wid for w in sim.workers.values()
                               if not w.alive),
        "chaos_fired": (len(sim.plane.schedule()) if sim.plane else 0),
        "event_log_len": sim.n_events,
        "event_log_sha1": sim._hash.hexdigest(),
        "config": dataclasses.asdict(cfg),
    }
    if cfg.tenants is not None:
        tenant_ids = sorted({r.tenant for r in reqs} | set(cfg.tenants),
                            key=lambda t: (t is None, t or ""))
        blocks: Dict[str, Any] = {}
        for tenant in tenant_ids:
            rs = [r for r in reqs if r.tenant == tenant]
            lat_t = sorted(r.done_t - r.admit_t for r in rs
                           if r.outcome == "ok")
            # Caller-observed latency (arrival→done, admission wait
            # included) — the QoS p99 budget is a promise about THIS
            # number, same rule as the gateway's tenant ledger: under
            # contention the queue wait IS the noisy-neighbor signal.
            full_t = sorted(r.done_t - r.arrival for r in rs
                            if r.outcome == "ok")
            shed_t = sum(v for (tt, _), v in sim.tenant_shed.items()
                         if tt == tenant)
            blocks[tenant or ""] = {
                "requests": len(rs),
                "ok": sum(1 for r in rs if r.outcome == "ok"),
                "shed": shed_t,
                "shed_reasons": dict(sorted(
                    (reason, v)
                    for (tt, reason), v in sim.tenant_shed.items()
                    if tt == tenant)),
                "p50_ms": _ms(_pct(lat_t, 50)),
                "p99_ms": _ms(_pct(lat_t, 99)),
                "full_p50_ms": _ms(_pct(full_t, 50)),
                "full_p99_ms": _ms(_pct(full_t, 99)),
                "shed_rate": round(shed_t / len(rs), 4) if rs else None,
            }
        result["tenants"] = blocks
    if cfg.max_batch > 1:
        result["microbatch"] = {
            "flushes": dict(sorted(sim.batch_flushes.items())),
            "mean_size": (round(sum(sim.batch_sizes)
                                / len(sim.batch_sizes), 3)
                          if sim.batch_sizes else None),
        }
    if record_events:
        result["events"] = [list(e) for e in sim.events]
    return result


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v * 1000, 3)


def result_fingerprint(result: Dict[str, Any]) -> str:
    """A stable digest of everything deterministic in a result — the
    bit-identical-replay assertion surface (tests, twin_smoke)."""
    return sha1(json.dumps(result, sort_keys=True).encode()).hexdigest()
