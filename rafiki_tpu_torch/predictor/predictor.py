"""Predictor core: scatter queries to workers over the bus, gather with
timeout, ensemble.

The port's own copy of ``rafiki_tpu/predictor/predictor.py``: per query,
enqueue to every fresh-leased worker of the job, await the predictions
under one batch deadline (or a quorum plus a hedge grace), ensemble,
respond. When every lease is stale the batch fails fast with
``RuntimeError("no live inference workers ...")``.

``predict_batch_detailed`` sends a whole microbatch as ONE
``BATCH_KEY`` envelope per worker; workers reply with a per-query list.

Each batch runs under a trace (the caller's, the gateway's, or a fresh
one), so its bus envelopes and the workers' spans stitch to it; each
gather journals its quorum decision (``gather/predictor.gather``) and
ticks the SLO engine, as in the JAX package.

Not in the port yet: the tenancy program tag (``wrap_query``) and the
hop marks.
"""

from __future__ import annotations

import dataclasses
import math
import time
import uuid
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs import context as trace_context
from rafiki_tpu_torch.obs.journal import journal as _journal
from rafiki_tpu_torch.obs.perf import slo as _slo
from rafiki_tpu_torch.predictor.ensemble import ensemble_predictions

#: Straggler grace once the gather quorum arrived.
DEFAULT_HEDGE_GRACE_S = 0.25

#: Sentinel key wrapping a combined query list into ONE bus envelope.
#: Workers expand it, run one forward over the flattened batch, and
#: reply with a list of per-query predictions in order.
BATCH_KEY = "__rafiki_batch__"


@dataclasses.dataclass
class GatherReport:
    """Everything a caller needs to know about one predict batch."""

    outputs: List[Any]              # per-query ensembled predictions
    workers: List[str]              # the fan-out set actually used
    quorum: int                     # replies waited for per query
    replies: Dict[str, int]         # worker -> queries it answered in time
    timeouts: int                   # queries with ZERO replies by deadline
    hedged: int                     # queries ensembled before all replied
    elapsed_s: float                # whole-batch gather wall time

    def ok(self) -> bool:
        return self.timeouts == 0


@dataclasses.dataclass
class BatchGatherReport(GatherReport):
    """A :class:`GatherReport` for one microbatched fan-out, plus the
    raw hop chains replies carried (empty until the hop plane is
    ported)."""

    chains: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)
    dec_mark: Optional[List[Any]] = None


class Predictor:
    # A lease this many TTLs old is a corpse, not a starved worker.
    REAP_TTL_FACTOR = 4.0
    # Bounded stale-lease grace: when NO lease is fresh, fall back to
    # workers at most this many TTLs old (strictly below the reap
    # factor, so an all-workers-dead outage still raises).
    STALE_GRACE_FACTOR = 2.0

    def __init__(self, bus, job_id: str, timeout_s: float = 10.0,
                 worker_ttl_s: float = 3.0,
                 min_replies: Optional[int] = None,
                 hedge_grace_s: float = DEFAULT_HEDGE_GRACE_S):
        self.bus = bus
        self.job_id = job_id
        self.timeout_s = timeout_s
        # Liveness lease TTL: workers heartbeat every ~0.5s from a
        # dedicated thread, so a worker missing for worker_ttl_s is dead.
        self.worker_ttl_s = worker_ttl_s
        # Default gather quorum. None → wait for every fanned-out replica.
        self.min_replies = min_replies
        self.hedge_grace_s = hedge_grace_s

    def live_workers(self) -> List[str]:
        """Reap corpses, then return the fresh-leased worker set — or,
        when that set is empty, workers with a lease younger than
        ``STALE_GRACE_FACTOR×TTL``. Past that, []."""
        reap = getattr(self.bus, "reap_stale", None)
        if reap is not None:
            reap(self.REAP_TTL_FACTOR * self.worker_ttl_s, job_id=self.job_id)
        fresh = self.bus.get_workers(self.job_id, max_age_s=self.worker_ttl_s)
        if fresh:
            return fresh
        graced = self.bus.get_workers(
            self.job_id, max_age_s=self.STALE_GRACE_FACTOR * self.worker_ttl_s)
        if graced:
            telemetry.inc("predictor.stale_lease_fallback")
        return graced

    def predict(self, queries: List[Any],
                timeout_s: Optional[float] = None) -> List[Any]:
        """Fan each query out to all fresh-leased workers; ensemble per
        query."""
        return self.predict_detailed(queries, timeout_s=timeout_s).outputs

    def _fanout(self, workers, min_replies, hedge_grace_s, timeout_s):
        if workers is None:
            workers = self.live_workers()
        if not workers:
            # No serving capacity RIGHT NOW: fail the batch explicitly
            # rather than masking the outage as per-query timeouts.
            telemetry.inc("predictor.no_live_workers")
            raise RuntimeError(
                f"no live inference workers for job {self.job_id}")
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        if min_replies is None:
            min_replies = self.min_replies
        quorum = (len(workers) if min_replies is None
                  else max(1, min(min_replies, len(workers))))
        grace = self.hedge_grace_s if hedge_grace_s is None else hedge_grace_s
        return workers, timeout_s, quorum, grace

    def predict_detailed(self, queries: List[Any],
                         workers: Optional[List[str]] = None,
                         timeout_s: Optional[float] = None,
                         min_replies: Optional[int] = None,
                         hedge_grace_s: Optional[float] = None) -> GatherReport:
        """The full-control entry: an explicit fan-out set, a per-request
        gather budget, and a reply quorum. Returns per-worker reply
        counts alongside the ensembled outputs. The batch runs under the
        active trace, or a fresh one."""
        with trace_context.trace():
            return self._predict_detailed(queries, workers, timeout_s, min_replies,
                                          hedge_grace_s)

    def _predict_detailed(self, queries, workers, timeout_s, min_replies,
                          hedge_grace_s) -> GatherReport:
        workers, timeout_s, quorum, grace = self._fanout(
            workers, min_replies, hedge_grace_s, timeout_s)
        telemetry.inc("predictor.queries", len(queries))
        telemetry.observe("predictor.fanout_workers", len(workers))
        qids = []
        for query in queries:
            qid = uuid.uuid4().hex
            qids.append(qid)
            for w in workers:
                self.bus.add_query(w, qid, query)
        # One deadline for the whole batch; past it, remaining queries
        # gather non-blockingly so batch latency stays bounded.
        t_gather = time.monotonic()
        deadline = t_gather + timeout_s
        out: List[Any] = []
        replies: Dict[str, int] = {}
        timeouts = 0
        hedged = 0
        for qid in qids:
            remaining = max(0.0, deadline - time.monotonic())
            t_q = time.monotonic()
            preds = self.bus.get_predictions(
                qid, n=len(workers), timeout=remaining,
                min_n=quorum, grace_s=grace)
            telemetry.observe("predictor.gather_quorum_s", time.monotonic() - t_q)
            for item in preds:
                replies[item[0]] = replies.get(item[0], 0) + 1
            if not preds:
                timeouts += 1
                out.append({"error": "prediction timeout"})
            else:
                if len(preds) < len(workers):
                    hedged += 1
                out.append(ensemble_predictions([item[1] for item in preds]))
        elapsed = time.monotonic() - t_gather
        telemetry.observe("predictor.gather_s", elapsed)
        if timeouts:
            telemetry.inc("predictor.query_timeouts", timeouts)
        if hedged:
            telemetry.inc("predictor.hedged_gathers", hedged)
        # The quorum decision: which workers answered, who straggled.
        _journal.record("gather", "predictor.gather", job_id=self.job_id,
                        queries=len(queries), workers=list(workers),
                        quorum=quorum, replies=replies, timeouts=timeouts,
                        hedged=hedged, dur_s=round(elapsed, 6))
        _slo.maybe_tick()
        return GatherReport(outputs=out, workers=list(workers),
                            quorum=quorum, replies=replies,
                            timeouts=timeouts, hedged=hedged,
                            elapsed_s=elapsed)

    def predict_batch_detailed(self, queries: List[Any],
                               workers: Optional[List[str]] = None,
                               timeout_s: Optional[float] = None,
                               min_replies: Optional[int] = None,
                               hedge_grace_s: Optional[float] = None,
                               ) -> BatchGatherReport:
        """ONE fan-out for a whole microbatch: the combined query list
        rides a single ``BATCH_KEY`` envelope per worker. Replies
        ensemble per query index across workers under the same
        quorum/hedge semantics as :meth:`predict_detailed`. The batch runs
        under the active trace, or a fresh one (the gateway's flusher
        thread has none, so a microbatch gets its own)."""
        with trace_context.trace():
            return self._predict_batch_detailed(queries, workers, timeout_s, min_replies,
                                                hedge_grace_s)

    def _predict_batch_detailed(self, queries, workers, timeout_s, min_replies,
                                hedge_grace_s) -> BatchGatherReport:
        workers, timeout_s, quorum, grace = self._fanout(
            workers, min_replies, hedge_grace_s, timeout_s)
        n = len(queries)
        telemetry.inc("predictor.queries", n)
        telemetry.observe("predictor.fanout_workers", len(workers))
        qid = uuid.uuid4().hex
        payload = {BATCH_KEY: list(queries)}
        for w in workers:
            self.bus.add_query(w, qid, payload)
        t_gather = time.monotonic()
        preds = self.bus.get_predictions(
            qid, n=len(workers), timeout=timeout_s,
            min_n=quorum, grace_s=grace)
        telemetry.observe("predictor.gather_quorum_s", time.monotonic() - t_gather)
        chains = {item[0]: list(item[2])
                  for item in preds if len(item) > 2 and item[2]}
        # Only well-formed replies (a per-query list of length n) can
        # scatter back; anything else counts as silence.
        valid = [item for item in preds
                 if isinstance(item[1], list) and len(item[1]) == n]
        replies: Dict[str, int] = {item[0]: n for item in valid}
        hedged = n if valid and len(valid) < len(workers) else 0
        if valid:
            timeouts = 0
            out = [ensemble_predictions([item[1][i] for item in valid])
                   for i in range(n)]
        else:
            timeouts = n
            out = [{"error": "prediction timeout"}] * n
        elapsed = time.monotonic() - t_gather
        telemetry.observe("predictor.gather_s", elapsed)
        if timeouts:
            telemetry.inc("predictor.query_timeouts", timeouts)
        if hedged:
            telemetry.inc("predictor.hedged_gathers", hedged)
        _journal.record("gather", "predictor.gather", job_id=self.job_id,
                        queries=n, workers=list(workers), quorum=quorum,
                        replies=replies, timeouts=timeouts, hedged=hedged,
                        batched=True, dur_s=round(elapsed, 6))
        _slo.maybe_tick()
        return BatchGatherReport(outputs=out, workers=list(workers),
                                 quorum=quorum, replies=replies,
                                 timeouts=timeouts, hedged=hedged,
                                 elapsed_s=elapsed, chains=chains)


def default_quorum(k: int) -> int:
    """The gateway's default gather quorum: a majority of the fan-out."""
    return max(1, math.ceil(k / 2))
