"""The serving gateway: admission control, deadline-aware routing and
quorum fan-out between the HTTP frontend and the bus.

The port's own copy of ``rafiki_tpu/gateway/gateway.py``
(``GatewayConfig``, ``Gateway``) with the same decisions:

  * **admission control** — bounded inflight budget + bounded wait
    queue with per-request deadlines; overflow is shed *immediately*
    (HTTP 429 + Retry-After upstream) instead of queuing forever;
  * **deadline-aware quorum gather** — fan out, wait for
    ``min_replies`` (default ceil(k/2)), grant stragglers a short
    hedge grace, ensemble what arrived;
  * **per-worker circuit breakers** — consecutive zero-reply batches
    open a worker's breaker and it stops receiving fan-out *before*
    its heartbeat lease expires;
  * **routing policies** — ``replicate-all`` (ensemble, the default)
    or ``least-loaded`` (single replica by bus queue depth);
  * **bounded blackout re-routes** when a whole fan-out set is silent;
  * **dynamic microbatching** (``max_batch > 1``);
  * **graceful drain** — stop admitting, flush inflight, flip
    ``/healthz`` to draining.

``predict`` is the trace edge, as in the JAX package: a request
carries a caller trace id (``X-Rafiki-Trace-Id`` upstream) or gets a
fresh one, and the bus envelopes, worker spans and journal records
stitch to it. The journal gets the gateway's config
(``gateway/config``), each request (``serving/request``), breaker
transitions, blackout retries and sheds; each request ticks the SLO
engine.

An admitted request passes the ``gateway.predict`` chaos site, keyed
by the job id (a ``delay`` is a frontend latency spike that eats into
the request's deadline while it holds an inflight slot).

Hop marks (``obs/anatomy/hops.py``), as in the JAX package: a request
opens a thread-local prefix with ``admit``, adds ``queue`` once
admission is granted and clears it on every exit; the bus envelopes
copy it. A microbatch flush stamps one ``bat`` mark shared by its
members, and each member's chains (its prefix, ``bat``, the worker's
leg and ``dec``) are absorbed under its own trace. Every outcome, sheds
included, goes into ``self.rollup`` (``ServingRollup``: ``serving/ts``
rows with the admission and breaker context), registered as the
``serving`` telemetry collector.

Tenancy, as in the JAX package: ``Gateway(..., tenancy=TenantFabric())``
builds its admission through the fabric (weighted-fair, per-tenant
quotas), ``predict(..., tenant=)`` runs under the tenant's scope (bus
envelopes carry it), the tenant's tier gives the default deadline,
admissions, sheds and caller-observed latencies are charged to the
tenant, the ``serving/request`` records carry it, ``drain`` flushes the
accounting (``tenant/summary``) and ``sensors()`` adds the fabric's
keys. Without a fabric the gateway is single-tenant as before.
``stats()`` keeps every key of the JAX package's.

One Gateway fronts one inference job's Predictor. Its counters flow
both into gateway-local stats (``GET /gateway``) and into the
telemetry registry (``GET /metrics``), where ``stats`` is registered as
the ``gateway`` collector.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from rafiki_tpu_torch import chaos, telemetry
from rafiki_tpu_torch.gateway.admission import AdmissionController, ShedError
from rafiki_tpu_torch.gateway.breaker import CircuitBreaker
from rafiki_tpu_torch.gateway.microbatch import BatchMember, MicroBatcher
from rafiki_tpu_torch.obs import context as trace_context
from rafiki_tpu_torch.obs.anatomy import hops as _hops
from rafiki_tpu_torch.obs.anatomy.timeseries import ServingRollup
from rafiki_tpu_torch.obs.journal import journal as _journal
from rafiki_tpu_torch.obs.perf import slo as _slo
from rafiki_tpu_torch.predictor.predictor import default_quorum
from rafiki_tpu_torch.tenancy.qos import ANON_TENANT

POLICIES = ("replicate-all", "least-loaded")

#: Fraction of a request's deadline the admission queue may consume
#: before the expected service time no longer fits (shed-early rule).
DEADLINE_RESERVE_FRAC = 0.5
#: Smoothing weight of the newest sample in the gateway latency EWMA.
LATENCY_EWMA_ALPHA = 0.2
#: Minimum Retry-After hint — clients must never busy-spin.
RETRY_AFTER_FLOOR_S = 0.1
#: Blackout-retry probe: when a gather returns ZERO replies from EVERY
#: worker and retries remain, the next attempt's gather budget is
#: clamped to ``max(MIN, FACTOR × latency EWMA)`` instead of the full
#: deadline, so the request re-routes within its own budget. Only
#: engages once an EWMA exists. The 1 s floor keeps the probe a death
#: detector, not a straggler detector.
BLACKOUT_PROBE_FACTOR = 8.0
BLACKOUT_PROBE_MIN_S = 1.0
#: Pause between blackout attempts: long enough for a stale lease to
#: age out of the fan-out set.
BLACKOUT_BACKOFF_S = 0.2


@dataclasses.dataclass
class GatewayConfig:
    max_inflight: int = 8           # concurrent predict batches
    max_queue: int = 32             # waiters beyond the inflight budget
    default_deadline_s: Optional[float] = None  # None → predictor.timeout_s
    min_replies: Optional[int] = None  # gather quorum; None → ceil(k/2)
    hedge_grace_s: float = 0.25     # straggler grace once quorum arrived
    policy: str = "replicate-all"
    breaker_failures: int = 3       # consecutive misses before opening
    breaker_cooldown_s: float = 5.0
    max_queries_per_request: int = 1024  # HTTP app: 413 above this
    # Dynamic microbatching: >1 coalesces admitted requests into one bus
    # fan-out of up to max_batch queries, flushed after at most
    # max_batch_wait_ms (or sooner when a member deadline demands it).
    # 1 = off: classic per-request fan-out.
    max_batch: int = 1
    max_batch_wait_ms: float = 5.0
    # Bounded re-route attempts when a gather comes back with ZERO
    # replies from every worker. 0 = single attempt.
    blackout_retries: int = 3

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown routing policy {self.policy!r}; one of {POLICIES}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")

    @classmethod
    def from_config(cls, cfg, **overrides) -> "GatewayConfig":
        """Build from the framework Config (rafiki_tpu_torch/config.py),
        with per-job overrides on top (services manager plumbing)."""
        base = dict(
            max_inflight=cfg.gateway_max_inflight,
            max_queue=cfg.gateway_max_queue,
            default_deadline_s=cfg.predict_timeout_s,
            hedge_grace_s=cfg.gateway_hedge_grace_s,
            policy=cfg.gateway_policy,
            breaker_failures=cfg.gateway_breaker_failures,
            breaker_cooldown_s=cfg.gateway_breaker_cooldown_s,
            max_queries_per_request=cfg.max_queries_per_request,
            max_batch=cfg.gateway_max_batch,
            max_batch_wait_ms=cfg.gateway_max_batch_wait_ms,
        )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(overrides) - known
        if unknown:
            raise ValueError(f"unknown gateway config keys: {sorted(unknown)}")
        base.update(overrides)
        return cls(**base)


class Gateway:
    """Serving frontend for one inference job's predictor."""

    def __init__(self, predictor, config: Optional[GatewayConfig] = None,
                 tenancy=None):
        self.predictor = predictor
        self.cfg = config or GatewayConfig()
        # A TenantFabric swaps the plain admission controller for the
        # weighted-fair tenant-aware one, on the same capacity knobs.
        self.tenancy = tenancy
        if tenancy is not None:
            self.admission = tenancy.build_admission(self.cfg.max_inflight,
                                                     self.cfg.max_queue)
        else:
            self.admission = AdmissionController(self.cfg.max_inflight,
                                                 self.cfg.max_queue)
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._draining = False
        # Gateway-local counters: the numbers `GET /gateway` serves.
        # The same events also flow into the telemetry registry so
        # `/metrics` agrees with them.
        self._admitted = 0
        self._shed: Dict[str, int] = {}
        self._hedged = 0
        self._timeouts = 0
        self._latency_ewma_s: Optional[float] = None
        # Every outcome lands in a per-second rollup journaled as
        # serving/ts, with admission/breaker context merged per row.
        self.rollup = ServingRollup(context_fn=self._rollup_context)
        # Only constructed when batching is on — max_batch=1 keeps the
        # classic per-request fan-out with no extra moving parts.
        self._batcher: Optional[MicroBatcher] = None
        if self.cfg.max_batch > 1:
            self._batcher = MicroBatcher(
                self._execute_batch, self.cfg.max_batch,
                self.cfg.max_batch_wait_ms / 1000.0,
                reserve_fn=self._expected_service_s)
        # Latest gateway wins the collector slot: one predictor process
        # serves one job, and tests that build several gateways only
        # ever assert on the live one.
        telemetry.register_collector("gateway", self.stats)
        telemetry.register_collector("serving", self.rollup.collector)
        # The live limits, for post-mortems and capacity models.
        _journal.record("gateway", "config",
                        max_inflight=self.cfg.max_inflight,
                        max_queue=self.cfg.max_queue,
                        default_deadline_s=self.cfg.default_deadline_s,
                        min_replies=self.cfg.min_replies,
                        hedge_grace_s=self.cfg.hedge_grace_s,
                        policy=self.cfg.policy,
                        breaker_failures=self.cfg.breaker_failures,
                        breaker_cooldown_s=self.cfg.breaker_cooldown_s,
                        max_batch=self.cfg.max_batch,
                        max_batch_wait_ms=self.cfg.max_batch_wait_ms,
                        blackout_retries=self.cfg.blackout_retries,
                        tenants_enabled=tenancy is not None,
                        tenant_quota_frac=(tenancy.directory.quota_frac
                                           if tenancy is not None else None))

    # -- the predict path ----------------------------------------------------

    def predict(self, queries: List[Any],
                deadline_s: Optional[float] = None,
                trace_id: Optional[str] = None,
                tenant: Optional[str] = None) -> List[Any]:
        """Admit → route → quorum-gather → feed breakers. Raises
        :class:`ShedError` when admission refuses, RuntimeError when
        the job has no live workers.

        This is the trace edge: the request runs under ``trace_id``, the
        active trace, or a fresh one. The tenant edge too
        (``X-Rafiki-Tenant`` upstream): the tenant rides the same
        thread-local into the bus envelopes, and with a fabric attached
        admission, sheds and latency are charged to it."""
        with trace_context.trace(trace_id):
            with trace_context.tenant_scope(tenant):
                return self._predict(queries, deadline_s, tenant)

    def _predict(self, queries: List[Any], deadline_s: Optional[float],
                 tenant: Optional[str] = None) -> List[Any]:
        # Open this request's hop-mark prefix: admit/queue marks stamped
        # here ride into every bus envelope the fan-out produces. Cleared
        # in the finally: a stale prefix would leak this request's marks
        # into the thread's next chain.
        _hops.begin()
        _hops.add("admit")
        try:
            return self._predict_admitted(queries, deadline_s, tenant)
        finally:
            _hops.clear()

    def _predict_admitted(self, queries: List[Any], deadline_s: Optional[float],
                          tenant: Optional[str] = None) -> List[Any]:
        fabric = self.tenancy
        if deadline_s is None and fabric is not None:
            # The tier's deadline (gold shorter than batch) before the
            # gateway-wide default.
            deadline_s = fabric.directory.tier_of(tenant).deadline_s
        deadline_s = (deadline_s or self.cfg.default_deadline_s
                      or self.predictor.timeout_s)
        deadline = time.monotonic() + deadline_s
        with self._lock:
            draining = self._draining
        if draining:
            self._count_shed("draining")
            self._charge_shed(tenant, "draining")
            raise ShedError("draining", self._retry_after())
        # Deadline-aware admission: don't hold a waiter past the point
        # where the expected service time no longer fits its deadline —
        # shedding NOW beats admitting a request doomed to time out.
        reserve = min(self._expected_service_s(),
                      deadline_s * DEADLINE_RESERVE_FRAC)
        try:
            waited = self.admission.admit(
                deadline - reserve, retry_after_s=self._retry_after(),
                tenant=tenant)
        except ShedError as e:
            self._count_shed(e.reason)
            # Charged to THIS tenant: the per-tenant shed ledger is how
            # noisy-neighbor-shed proves who paid for a spike.
            self._charge_shed(tenant, e.reason)
            raise
        _hops.add("queue")  # admission granted: the queue wait is over
        with self._lock:
            self._admitted += 1
        telemetry.inc("gateway.admitted")
        if fabric is not None:
            fabric.accounting.admitted(tenant or ANON_TENANT, waited)
        if waited:
            telemetry.observe("gateway.queue_wait_s", waited)
        # A delay here is a frontend latency spike: it eats into the
        # request's own deadline while the request holds an inflight slot.
        chaos.hook("gateway.predict", self.predictor.job_id)
        if self._batcher is not None:
            return self._predict_batched(queries, deadline, tenant, waited)
        t0 = time.monotonic()
        try:
            with telemetry.span("gateway.predict",
                                job_id=self.predictor.job_id,
                                queries=len(queries)):
                report = self._fanout(queries, deadline)
        finally:
            self.admission.release(tenant=tenant)
        elapsed = time.monotonic() - t0
        self._absorb(report, elapsed)
        telemetry.observe("gateway.predict_s", elapsed)
        ok = report.timeouts == 0
        self.rollup.observe(latency_s=elapsed, outcome="ok" if ok else "error")
        self._charge_completed(tenant, waited + elapsed, ok)
        # The gateway-measured e2e: obs waterfall and tails hold the
        # stitched chain's total against it.
        _journal.record("serving", "request", queries=len(queries),
                        e2e_s=round(elapsed, 6), ok=ok,
                        hedged=report.hedged, timeouts=report.timeouts,
                        tenant=tenant)
        _slo.maybe_tick()
        return report.outputs

    def _predict_batched(self, queries: List[Any], deadline: float,
                         tenant: Optional[str] = None, waited: float = 0.0) -> List[Any]:
        """Microbatched path: ride a shared fan-out. The admission slot
        is held for the whole wait — the inflight budget still bounds
        concurrency."""
        member = self._batcher.submit(queries, deadline, prefix=_hops.prefix_marks())
        try:
            # +2s slack over the deadline: the flusher itself bounds the
            # fan-out by the member deadlines; this guard only catches a
            # wedged flusher rather than blocking forever.
            if not member.wait(max(0.0, deadline - time.monotonic()) + 2.0):
                raise RuntimeError("microbatch flush timed out")
        finally:
            self.admission.release(tenant=tenant)
        if member.error is not None:
            raise member.error
        report = member.report
        elapsed = time.monotonic() - member.enq_t
        telemetry.observe("gateway.predict_s", elapsed)
        ok = report.timeouts == 0
        self.rollup.observe(latency_s=elapsed, outcome="ok" if ok else "error")
        self._charge_completed(tenant, waited + elapsed, ok)
        # Re-absorb the shared flush chain under THIS request's trace
        # (prefix + bat + the worker's chain + dec): every member gets a
        # stitchable waterfall though the wire saw one envelope.
        if member.chains:
            _hops.absorb(uuid.uuid4().hex, member.chains)
        _journal.record("serving", "request", queries=len(queries),
                        e2e_s=round(elapsed, 6), ok=ok,
                        hedged=report.hedged, timeouts=report.timeouts,
                        batched=True, flush_reason=member.flush_reason,
                        tenant=tenant)
        _slo.maybe_tick()
        return member.outputs

    def _execute_batch(self, members: List[BatchMember],
                       flush_reason: str) -> None:
        """Flusher-thread body: one batched fan-out for all members,
        then scatter per-member output slices and hop chains."""
        t0 = time.monotonic()
        bat = _hops.mark("bat")  # shared flush instant for every member
        flat = [q for m in members for q in m.queries]
        deadline = min(m.deadline for m in members)
        telemetry.observe("serving.microbatch.size", float(len(flat)))
        telemetry.observe("serving.microbatch.fill_ratio",
                          len(flat) / float(self.cfg.max_batch))
        if flush_reason == "size":
            telemetry.inc("serving.microbatch.flush_size")
        elif flush_reason == "deadline":
            telemetry.inc("serving.microbatch.flush_deadline")
        else:
            telemetry.inc("serving.microbatch.flush_drain")
        with telemetry.span("gateway.predict",
                            job_id=self.predictor.job_id,
                            queries=len(flat), members=len(members)):
            report = self._fanout(flat, deadline, batched=True)
        elapsed = time.monotonic() - t0
        self._absorb(report, elapsed)
        shared = getattr(report, "chains", None)
        dec = getattr(report, "dec_mark", None)
        off = 0
        for m in members:
            n = len(m.queries)
            m.outputs = report.outputs[off:off + n]
            off += n
            if shared:
                m.chains = {w: list(m.prefix) + [bat] + list(ch) + ([dec] if dec else [])
                            for w, ch in shared.items()}
            m.flush_reason = flush_reason
            m.report = report
            m.elapsed_s = elapsed
            m.done.set()

    def _fanout(self, queries: List[Any], deadline: float,
                batched: bool = False):
        """Route + gather, with bounded blackout re-routes: a gather
        that ends with ZERO replies from ANY worker re-routes and
        retries while retries and deadline budget remain, instead of
        dropping an admitted request on the floor."""
        attempts = max(0, self.cfg.blackout_retries)
        ewma = self._expected_service_s()
        if not ewma:
            # No latency model yet (first request / cold gateway): no
            # basis to cut a gather short, so no probing retries.
            attempts = 0
        for attempt in range(attempts + 1):
            remaining = max(0.0, deadline - time.monotonic())
            retries_left = attempts - attempt
            if retries_left:
                budget = min(remaining, max(BLACKOUT_PROBE_MIN_S,
                                            BLACKOUT_PROBE_FACTOR * ewma))
            else:
                budget = remaining
            try:
                workers, quorum = self._route()
                gather = (self.predictor.predict_batch_detailed if batched
                          else self.predictor.predict_detailed)
                report = gather(queries, workers=workers, timeout_s=budget,
                                min_replies=quorum,
                                hedge_grace_s=self.cfg.hedge_grace_s)
            except RuntimeError:
                # No live workers RIGHT NOW — with retries left (and a
                # history of successful service) wait out the lease
                # flap instead of failing.
                if not retries_left:
                    raise
                report = None
            if report is not None and report.replies:
                return report
            if not retries_left:
                return report
            self._note_blackout(report, attempt)
            time.sleep(min(BLACKOUT_BACKOFF_S,
                           max(0.0, deadline - time.monotonic())))
        raise RuntimeError("unreachable")  # pragma: no cover

    def _note_blackout(self, report, attempt: int) -> None:
        """Feed a blackout attempt into the breakers and the journal."""
        if report is not None:
            for w in report.workers:
                self._record(w, ok=False)
        telemetry.inc("gateway.blackout_retries")
        _journal.record("gateway", "blackout_retry", attempt=attempt + 1,
                        workers=(list(report.workers) if report is not None else []))

    # -- routing -------------------------------------------------------------

    def _route(self) -> Tuple[List[str], int]:
        """Pick the fan-out set (breaker-filtered) and gather quorum."""
        workers = self.predictor.live_workers()
        allowed = [w for w in workers if self._breaker(w).allow()]
        if not allowed:
            # Every breaker open/probing: routing nowhere would turn a
            # brown-out into a black-out. Fan out to the full live set
            # as a forced probe instead.
            allowed = workers
        if self.cfg.policy == "least-loaded" and allowed:
            depth_of = getattr(self.predictor.bus, "queue_depth", None)
            if depth_of is not None:
                allowed = [min(allowed, key=depth_of)]
            else:  # bus without depth support: fall back to first
                allowed = allowed[:1]
            return allowed, 1
        quorum = (self.cfg.min_replies if self.cfg.min_replies is not None
                  else default_quorum(len(allowed)))
        return allowed, quorum

    def _breaker(self, worker_id: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(worker_id)
            if br is None:
                br = self._breakers[worker_id] = CircuitBreaker(
                    self.cfg.breaker_failures, self.cfg.breaker_cooldown_s)
            return br

    def _record(self, worker_id: str, ok: bool, latency_s: float = 0.0) -> None:
        """One outcome into a worker's breaker; a state change is
        journaled (``gateway/breaker_transition``), so a post-mortem sees
        why fan-out avoided a worker."""
        br = self._breaker(worker_id)
        before = br.snapshot().get("state")
        if ok:
            br.record_success(latency_s=latency_s)
        else:
            br.record_failure()
        after = br.snapshot().get("state")
        if after != before:
            _journal.record("gateway", "breaker_transition", worker_id=worker_id,
                            from_state=before, to_state=after)

    def _absorb(self, report, elapsed_s: float) -> None:
        """Feed one batch's gather report into breakers and stats."""
        n_queries = len(report.outputs)
        for w in report.workers:
            self._record(w, report.replies.get(w, 0) > 0, elapsed_s)
        with self._lock:
            self._hedged += report.hedged
            self._timeouts += report.timeouts
            if report.timeouts == 0 and n_queries:
                prev = self._latency_ewma_s
                a = LATENCY_EWMA_ALPHA
                self._latency_ewma_s = (elapsed_s if prev is None
                                        else (1 - a) * prev + a * elapsed_s)
        if report.hedged:
            telemetry.inc("gateway.hedged", report.hedged)

    # -- deadline bookkeeping ------------------------------------------------

    def _expected_service_s(self) -> float:
        with self._lock:
            return self._latency_ewma_s or 0.0

    def _retry_after(self) -> float:
        """Back-off hint: roughly one queue-drain time at current
        service latency, floored so clients never spin."""
        with self._lock:
            ewma = self._latency_ewma_s or 0.1
        backlog = self.admission.waiting + 1
        return round(max(RETRY_AFTER_FLOOR_S,
                         ewma * backlog / self.cfg.max_inflight), 3)

    def _rollup_context(self) -> Dict[str, Any]:
        """Live context merged into each serving/ts row: queue depth,
        inflight, and the per-worker breaker states."""
        with self._lock:
            breakers = {w: b.snapshot().get("state")
                        for w, b in self._breakers.items()}
        return {"queue_depth": self.admission.waiting,
                "inflight": self.admission.inflight,
                "breakers": breakers,
                "breakers_open": sum(1 for s in breakers.values()
                                     if s != "closed")}

    def _count_shed(self, reason: str) -> None:
        with self._lock:
            self._shed[reason] = self._shed.get(reason, 0) + 1
        self.rollup.observe(outcome="shed")
        telemetry.inc("gateway.shed")
        # Reasons are a closed enum of admission code paths, refining
        # the stable literal gateway.shed aggregate above.
        telemetry.inc(f"gateway.shed_{reason}")
        _journal.record("gateway", "shed", reason=reason)

    def _charge_shed(self, tenant: Optional[str], reason: str) -> None:
        if self.tenancy is not None:
            self.tenancy.accounting.shed(tenant or ANON_TENANT, reason)

    def _charge_completed(self, tenant: Optional[str], e2e_s: float, ok: bool) -> None:
        """The tenant ledger charges CALLER-observed latency (admission
        wait + service): the queue wait under contention is the whole
        noisy-neighbor signal."""
        if self.tenancy is not None:
            self.tenancy.accounting.completed(tenant or ANON_TENANT, e2e_s, ok)

    # -- drain ---------------------------------------------------------------

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def drain(self, timeout: Optional[float] = 10.0) -> bool:
        """Stop admitting (new requests and queued waiters shed with
        reason ``draining``), then flush inflight requests. Returns
        True when everything inflight finished within ``timeout``.
        ``/healthz`` reports draining from the first moment."""
        with self._lock:
            already = self._draining
            self._draining = True
        if not already:
            telemetry.inc("gateway.drains")
        if self._batcher is not None:
            # Flush pending microbatch members before closing admission:
            # they already hold slots, so wait_idle covers them.
            self._batcher.drain()
        self.admission.close()
        done = self.admission.wait_idle(timeout)
        if self.tenancy is not None:
            # The counter summary (tenant/summary) that `obs tenants
            # --check` reconciles the per-record tallies with.
            self.tenancy.accounting.flush()
        return done

    def close(self) -> None:
        """Stop the microbatch flusher thread (after :meth:`drain`)."""
        if self._batcher is not None:
            self._batcher.stop()

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """JSON-able state for ``GET /gateway`` and the telemetry
        collector: admission counters, routing config, breaker state."""
        with self._lock:
            shed = dict(self._shed)
            out: Dict[str, Any] = {
                "policy": self.cfg.policy,
                "draining": self._draining,
                "admitted": self._admitted,
                "shed": shed,
                "shed_total": sum(shed.values()),
                "hedged": self._hedged,
                "timeouts": self._timeouts,
                "latency_ewma_s": (None if self._latency_ewma_s is None
                                   else round(self._latency_ewma_s, 6)),
                "limits": {
                    "max_inflight": self.cfg.max_inflight,
                    "max_queue": self.cfg.max_queue,
                    "default_deadline_s": self.cfg.default_deadline_s,
                    "hedge_grace_s": self.cfg.hedge_grace_s,
                    "min_replies": self.cfg.min_replies,
                    "max_queries_per_request":
                        self.cfg.max_queries_per_request,
                    "max_batch": self.cfg.max_batch,
                    "max_batch_wait_ms": self.cfg.max_batch_wait_ms,
                    "blackout_retries": self.cfg.blackout_retries,
                },
                "breakers": {w: b.snapshot()
                             for w, b in self._breakers.items()},
            }
        out["inflight"] = self.admission.inflight
        out["waiting"] = self.admission.waiting
        return out

    def sensors(self) -> Dict[str, Any]:
        """Admission-pressure view: queue depth (absolute and as a
        fraction of capacity), inflight, cumulative shed rate, and
        breaker state, plus the fabric's tenant keys. Cheap by
        contract."""
        with self._lock:
            admitted = self._admitted
            shed = sum(self._shed.values())
            ewma = self._latency_ewma_s
            draining = self._draining
            breakers_open = sum(
                1 for b in self._breakers.values()
                if b.snapshot().get("state") != "closed")
        waiting = self.admission.waiting
        total = admitted + shed
        out = {
            "queue_depth": waiting,
            "queue_frac": waiting / max(1, self.cfg.max_queue),
            "inflight": self.admission.inflight,
            "shed_rate": (shed / total) if total else 0.0,
            "latency_ewma_s": ewma,
            "breakers_open": breakers_open,
            "draining": draining,
        }
        if self.tenancy is not None:
            # The tenant aggregates (worst burn, tenant shed rate).
            out.update(self.tenancy.sensors())
        return out
