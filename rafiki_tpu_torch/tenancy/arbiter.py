"""Fleet-level tenant arbitration.

The port's own copy of ``rafiki_tpu/tenancy/arbiter.py``.

Two pieces, both riding infrastructure that already exists:

* :func:`tenant_pressure` — the autoscale lane pressure function for a
  shared multi-tenant fleet. Same shape as the inference lane's
  (max-of-components, 1.0 = at the line) but reading the TENANT
  aggregates: worst per-tenant SLO burn, queue fraction, and the
  weighted tenant shed rate. Wire it with
  ``LaneSpec("tenants", pressure_fn=tenant_pressure)`` — the
  controller's hysteresis/cooldown/flap machinery applies unchanged.
* :class:`JobAdmissionGate` — twin-gated admission of NEW jobs onto a
  shared fleet. Before the services manager creates a job's serving
  stack, the gate simulates the fleet's current per-tenant load PLUS
  the newcomer's forecast rate through the serving twin (per-tenant
  weighted admission model, engine.py) and REJECTS the job when the
  forecast breaches an existing tenant's p99 budget that the baseline
  kept. Every verdict — admit or reject, with both forecasts —
  journals ``tenancy/arbiter``, so fleet-shape decisions replay like
  autoscale decisions do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.journal import journal as _journal
from rafiki_tpu_torch.tenancy.qos import TIERS, DEFAULT_TIER


def tenant_pressure(sensors: Dict[str, Any]) -> Tuple[Optional[float], str]:
    """Tenant-lane pressure: the max of worst per-tenant burn, queue
    fraction, and (weighted) tenant shed rate. Mirrors
    ``autoscale.controller.inference_pressure`` so the lane drops into
    the existing controller unchanged."""
    components = {
        "tenant_burn": float(sensors.get("tenant_burn") or 0.0),
        "queue_frac": float(sensors.get("queue_frac") or 0.0),
        "tenant_shed": float(sensors.get("tenant_shed_rate") or 0.0) * 10.0,
    }
    reason = max(components, key=lambda k: components[k])
    return components[reason], reason


class ModelUnvalidated(RuntimeError):
    """The twin failed per-tenant validation against the capture a
    :class:`JobAdmissionGate` was about to forecast with."""

    def __init__(self, source: str, report: Dict[str, Any]):
        self.report = report
        super().__init__(
            f"twin failed per-tenant validation against {source} — "
            f"refusing to arbitrate with an unvalidated model: "
            f"{report.get('tenants')}")


class JobRejected(RuntimeError):
    """A new job's forecast breaches an existing tenant's SLO."""

    def __init__(self, job_id: str, detail: Dict[str, Any]):
        super().__init__(f"job {job_id} rejected by tenant arbiter: "
                         f"{detail.get('breaches')}")
        self.detail = detail


class JobAdmissionGate:
    """Forecast-before-admit for new jobs on a shared tenant fleet.

    ``cal`` is a twin :class:`~rafiki_tpu_torch.obs.twin.calibration.
    Calibration` (captured from the live fleet's journals);
    ``base_cfg`` the matching ``TwinConfig``. ``existing`` maps tenant
    id → ``(tier_name, qps)`` for the load already on the fleet.
    """

    def __init__(self, cal: Any, base_cfg: Any,
                 existing: Optional[Dict[str, Tuple[str, float]]] = None,
                 horizon_s: float = 2.0, seed: int = 0):
        self.cal = cal
        self.base_cfg = base_cfg
        self.existing: Dict[str, Tuple[str, float]] = dict(existing or {})
        self.horizon_s = horizon_s
        self.seed = seed

    @classmethod
    def from_capture(cls, log_dir, horizon_s: float = 2.0, seed: int = 0,
                     require_valid: bool = True,
                     tolerance: Optional[float] = None
                     ) -> "JobAdmissionGate":
        """Build the gate straight from a tenant-aware serving
        capture: calibration, gateway knobs, AND the existing
        per-tenant load (tier + observed qps) all come from the same
        journal directory. With ``require_valid`` (the default) the
        twin's weighted-admission model must first pass
        :func:`~rafiki_tpu_torch.obs.twin.validate.validate_tenants` against
        that capture — a gate whose forecasts disagree with the very
        run that calibrated it has no business vetoing jobs."""
        from rafiki_tpu_torch.obs import journal as journal_mod
        from rafiki_tpu_torch.obs.twin.calibration import Calibration
        from rafiki_tpu_torch.obs.twin.engine import TwinConfig
        from rafiki_tpu_torch.obs.twin import validate as validate_mod

        if require_valid:
            kwargs = {} if tolerance is None else {"tolerance": tolerance}
            report = validate_mod.validate_tenants(log_dir, seed=seed,
                                                   **kwargs)
            if not report["ok"]:
                raise ModelUnvalidated(str(log_dir), report)
        records = journal_mod.read_dir(log_dir)
        cal = Calibration.from_journal_dir(log_dir)
        arrivals, lats, tiers = (
            validate_mod.tenant_measured_from_records(records))
        span = (arrivals[-1][0] - arrivals[0][0]) if len(arrivals) > 1 else 0
        existing = {}
        for tenant, xs in lats.items():
            if tenant is None:
                continue
            qps = (len(xs) / span) if span else float(len(xs))
            existing[tenant] = (tiers.get(tenant, DEFAULT_TIER), qps)
        return cls(cal, TwinConfig.from_calibration(cal),
                   existing=existing, horizon_s=horizon_s, seed=seed)

    # -- load shapes ---------------------------------------------------------

    def _arrivals(self, load: Dict[str, Tuple[str, float]]):
        """Deterministic uniform per-tenant arrival trains over the
        horizon, merged by time (ties broken by tenant name so the
        event order is stable)."""
        out = []
        for tenant in sorted(load):
            _, qps = load[tenant]
            n = max(1, int(qps * self.horizon_s))
            step = self.horizon_s / n
            for i in range(n):
                out.append((i * step, 1, tenant))
        out.sort(key=lambda a: (a[0], a[2]))
        return out

    def _tenant_classes(self, load: Dict[str, Tuple[str, float]]):
        tiers = TIERS()
        return {tenant: {"weight": tiers.get(tier, tiers[DEFAULT_TIER]).weight}
                for tenant, (tier, _) in load.items()}

    def _budget_ms(self, tier: str) -> float:
        tiers = TIERS()
        return tiers.get(tier, tiers[DEFAULT_TIER]).p99_budget_ms

    def _forecast(self, load: Dict[str, Tuple[str, float]]) -> Dict[str, Any]:
        import dataclasses

        from rafiki_tpu_torch.obs.twin.engine import simulate

        cfg = dataclasses.replace(self.base_cfg,
                                  tenants=self._tenant_classes(load))
        return simulate(self.cal, cfg, self._arrivals(load), seed=self.seed)

    # -- the gate ------------------------------------------------------------

    def admit_job(self, job_id: str, tenant: str, tier: str,
                  expected_qps: float, enforce: bool = True
                  ) -> Dict[str, Any]:
        """Forecast the fleet with ``tenant``'s new job added. Returns
        the journaled verdict dict; raises :class:`JobRejected` when
        ``enforce`` and an existing tenant's forecast p99 breaches its
        budget that the baseline forecast kept."""
        baseline = (self._forecast(self.existing)
                    if self.existing else None)
        proposed_load = dict(self.existing)
        prior_tier, prior_qps = proposed_load.get(tenant, (tier, 0.0))
        proposed_load[tenant] = (tier, prior_qps + max(0.0, expected_qps))
        proposed = self._forecast(proposed_load)
        breaches = []
        base_tenants = (baseline or {}).get("tenants", {})
        for other, (other_tier, _) in self.existing.items():
            if other == tenant:
                continue
            budget = self._budget_ms(other_tier)
            # Budgets gate CALLER-observed latency (full_p99_ms:
            # admission wait + service) — post-admission p99 stays low
            # under a flood precisely because the quota pushes the
            # damage into queue wait.
            fore = (proposed.get("tenants", {}).get(other, {})
                    .get("full_p99_ms"))
            base = base_tenants.get(other, {}).get("full_p99_ms")
            if fore is not None and fore > budget and (
                    base is None or base <= budget):
                breaches.append({"tenant": other, "tier": other_tier,
                                 "forecast_p99_ms": fore,
                                 "baseline_p99_ms": base,
                                 "budget_ms": budget})
        verdict = {
            "job_id": job_id,
            "tenant": tenant,
            "tier": tier,
            "expected_qps": expected_qps,
            "admit": not breaches,
            "breaches": breaches,
            "forecast_p99_ms": proposed.get("p99_ms"),
            "forecast_shed_rate": proposed.get("shed_rate"),
            "baseline_p99_ms": (baseline or {}).get("p99_ms"),
        }
        _journal.record("tenancy", "arbiter", **verdict)
        if breaches:
            telemetry.inc("tenancy.jobs_rejected")
            if enforce:
                raise JobRejected(job_id, verdict)
        else:
            telemetry.inc("tenancy.jobs_admitted")
            self.existing = proposed_load
        return verdict
