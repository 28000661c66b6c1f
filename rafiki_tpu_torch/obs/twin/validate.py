"""Twin-vs-real validation: replay a captured serving run through the
simulator and score predicted against measured latency.

The port's own copy of ``rafiki_tpu/obs/twin/validate.py``.

The protocol keeps both sides honest by deriving EVERYTHING from the
same journal directory:

* **measured** — gateway-side end-to-end latencies from the
  ``serving/request`` records (the independent per-request stopwatch
  the gateway journals for hop-sum reconciliation);
* **replayed load** — each request's arrival reconstructed as
  ``wall_ts - e2e_s`` (when its predict() began), normalized to the
  earliest, with its actual ``queries`` microbatch size carried along;
* **calibration** — hop histograms + the journaled ``gateway/config``
  knobs from the very same run.

Prediction error is relative: ``|predicted - measured| / measured``
for p50 and p99. The gate passes only if BOTH are within tolerance.
``scales`` deliberately mis-calibrates named segments (e.g. forward
halved) — the negative polarity proves the gate
actually fails when the model is wrong.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from rafiki_tpu_torch.obs import journal as journal_mod
from rafiki_tpu_torch.obs.twin.calibration import Calibration, CalibrationError
from rafiki_tpu_torch.obs.twin.engine import TwinConfig, simulate

VALIDATE_SCHEMA_VERSION = 1

#: Default relative-error gate. Generous on purpose: the twin is a
#: capacity model, not a cycle simulator — it must catch a halved or
#: doubled service time, not a 10% drift.
DEFAULT_TOLERANCE = 0.40

#: Minimum measured requests for percentile errors to mean anything.
MIN_REQUESTS = 20


def measured_from_records(records: List[Dict[str, Any]]
                          ) -> Tuple[List[Tuple[float, int]], List[float]]:
    """(arrivals, latencies) from ``serving/request`` journal records.
    Arrivals are (offset_s, queries) with the earliest request at 0."""
    rows = [r for r in records
            if r.get("kind") == "serving" and r.get("name") == "request"
            and isinstance(r.get("e2e_s"), (int, float))
            and isinstance(r.get("ts"), (int, float))]
    if not rows:
        return [], []
    starts = [(float(r["ts"]) - float(r["e2e_s"]),
               int(r.get("queries") or 1)) for r in rows]
    t0 = min(s for s, _ in starts)
    arrivals = sorted((s - t0, q) for s, q in starts)
    latencies = sorted(float(r["e2e_s"]) for r in rows)
    return arrivals, latencies


def _pct_ms(xs: List[float], p: float) -> float:
    last = len(xs) - 1
    return xs[min(last, int(last * p / 100))] * 1000.0


def validate(log_dir, seed: int = 0,
             tolerance: float = DEFAULT_TOLERANCE,
             scales: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Score the twin against one captured run. Returns the gate
    artifact (see docs/twin.md); ``ok`` is the verdict. Raises
    :class:`CalibrationError` if the journals can't calibrate, and
    ``ValueError`` if too few requests were measured."""
    records = journal_mod.read_dir(log_dir)
    cal = Calibration.from_journal_dir(log_dir)
    if scales:
        cal = cal.scaled(scales)
    arrivals, latencies = measured_from_records(records)
    if len(latencies) < MIN_REQUESTS:
        raise ValueError(
            f"only {len(latencies)} serving/request record(s) in "
            f"{log_dir}; need >= {MIN_REQUESTS} for a meaningful "
            f"percentile comparison (serve a job behind a Gateway with "
            f"RAFIKI_LOG_DIR set)")
    cfg = TwinConfig.from_calibration(cal)
    res = simulate(cal, cfg, arrivals, seed=seed)
    measured = {"p50_ms": round(_pct_ms(latencies, 50), 3),
                "p99_ms": round(_pct_ms(latencies, 99), 3),
                "requests": len(latencies)}
    predicted = {"p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
                 "requests": res["requests"], "ok": res["ok"],
                 "shed": res["shed"],
                 "first_saturating": res["first_saturating"]}
    p50_err = _rel_err(predicted["p50_ms"], measured["p50_ms"])
    p99_err = _rel_err(predicted["p99_ms"], measured["p99_ms"])
    ok = (p50_err is not None and p99_err is not None
          and p50_err <= tolerance and p99_err <= tolerance)
    return {
        "twin_schema_version": VALIDATE_SCHEMA_VERSION,
        "source": str(log_dir),
        "seed": seed,
        "tolerance": tolerance,
        "scales": dict(scales or {}),
        "measured": measured,
        "predicted": predicted,
        "p50_err": None if p50_err is None else round(p50_err, 4),
        "p99_err": None if p99_err is None else round(p99_err, 4),
        "ok": ok,
        "event_log_sha1": res["event_log_sha1"],
        "config": res["config"],
        # Wall stamp of the artifact — metadata only, never an input to
        # the simulation itself.
        "created_ts": round(time.time(), 3),
    }


def _rel_err(pred: Optional[float], meas: Optional[float]
             ) -> Optional[float]:
    if pred is None or meas is None or meas <= 0:
        return None
    return abs(pred - meas) / meas


# -- per-tenant validation (docs/multitenancy.md) --------------------------

#: Per-tenant percentile gates need fewer points than the global gate:
#: a --tenants capture splits the same run across tenants, and the
#: skewed (aggressor) side would otherwise dominate the floor.
MIN_TENANT_REQUESTS = 10


def tenant_measured_from_records(records: List[Dict[str, Any]]):
    """(arrivals, per-tenant latencies, tenant→tier) from a
    ``--tenants`` capture. Arrivals are (offset_s, queries, tenant)
    3-tuples — the tenant-aware wire shape engine.simulate accepts;
    tiers come from the ``tenant/admit`` accounting records."""
    rows = [r for r in records
            if r.get("kind") == "serving" and r.get("name") == "request"
            and isinstance(r.get("e2e_s"), (int, float))
            and isinstance(r.get("ts"), (int, float))]
    if not rows:
        return [], {}, {}
    starts = [(float(r["ts"]) - float(r["e2e_s"]),
               int(r.get("queries") or 1), r.get("tenant")) for r in rows]
    t0 = min(s for s, _, _ in starts)
    arrivals = sorted((s - t0, q, t) for s, q, t in starts)
    lats: Dict[Optional[str], List[float]] = {}
    for r in rows:
        lats.setdefault(r.get("tenant"), []).append(float(r["e2e_s"]))
    for xs in lats.values():
        xs.sort()
    tiers: Dict[str, str] = {}
    for r in records:
        if (r.get("kind") == "tenant" and r.get("name") == "admit"
                and r.get("tenant") and r.get("tier")):
            tiers[str(r["tenant"])] = str(r["tier"])
    return arrivals, lats, tiers


def validate_tenants(log_dir, seed: int = 0,
                     tolerance: float = DEFAULT_TOLERANCE,
                     scales: Optional[Dict[str, float]] = None
                     ) -> Dict[str, Any]:
    """Score the twin's weighted-admission model against a captured
    tenant-aware serving run: replay the per-tenant arrival
    trains through the simulator with the capture's own tier weights
    and gate each tenant's predicted p99 against its measured p99.
    This is the model-fidelity check behind the new-job pre-gate
    (tenancy.arbiter.JobAdmissionGate): a gate that forecasts with an
    unvalidated model is just a random number generator with a journal.
    """
    from rafiki_tpu_torch.tenancy.qos import DEFAULT_TIER, TIERS

    records = journal_mod.read_dir(log_dir)
    cal = Calibration.from_journal_dir(log_dir)
    if scales:
        cal = cal.scaled(scales)
    arrivals, lats, tier_names = tenant_measured_from_records(records)
    total = sum(len(xs) for xs in lats.values())
    if total < MIN_REQUESTS:
        raise ValueError(
            f"only {total} serving/request record(s) in {log_dir}; need "
            f">= {MIN_REQUESTS} (serve a job behind a tenant-aware Gateway "
            f"with RAFIKI_LOG_DIR set)")
    tiers = TIERS()
    classes = {t: {"weight": tiers.get(tier_names.get(t, ""),
                                       tiers[DEFAULT_TIER]).weight}
               for t in lats if t is not None}
    cfg = TwinConfig.from_calibration(cal, tenants=classes)
    res = simulate(cal, cfg, arrivals, seed=seed)
    per_tenant: Dict[str, Any] = {}
    gated = 0
    ok = True
    for tenant, xs in sorted((t, x) for t, x in lats.items()
                             if t is not None):
        meas_p99 = round(_pct_ms(xs, 99), 3)
        pred = (res.get("tenants", {}).get(tenant, {}) or {})
        err = _rel_err(pred.get("p99_ms"), meas_p99)
        scored = len(xs) >= MIN_TENANT_REQUESTS
        if scored:
            gated += 1
            ok = ok and err is not None and err <= tolerance
        per_tenant[tenant] = {
            "tier": tier_names.get(tenant, DEFAULT_TIER),
            "measured_requests": len(xs),
            "measured_p99_ms": meas_p99,
            "predicted_p99_ms": pred.get("p99_ms"),
            "predicted_shed": pred.get("shed"),
            "p99_err": None if err is None else round(err, 4),
            "gated": scored,
        }
    ok = ok and gated > 0
    return {
        "twin_schema_version": VALIDATE_SCHEMA_VERSION,
        "source": str(log_dir),
        "seed": seed,
        "tolerance": tolerance,
        "scales": dict(scales or {}),
        "tenants": per_tenant,
        "gated_tenants": gated,
        "ok": ok,
        "event_log_sha1": res["event_log_sha1"],
        "config": res["config"],
        "created_ts": round(time.time(), 3),
    }
