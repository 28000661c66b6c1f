"""Chaos pre-gate: forecast a fault spec's serving impact offline.

The port's own copy of ``rafiki_tpu/obs/twin/pregate.py``.

Before the chaos runner injects a spec into a live scenario, it can
ask the twin what the spec WOULD do: two simulations — baseline and
faulted — over the same synthetic load and seed, differing only in
the ``RAFIKI_CHAOS`` spec. The deltas (p99, shed rate, dead workers,
breaker trips) ride in the scenario report as ``twin_forecast``, so a
surprising live result can be compared against the model's
expectation: a live blast radius far beyond the forecast is itself a
finding.

The forecast is advisory — it never blocks a scenario, and any
forecasting failure degrades to ``None`` rather than poisoning the
run (the chaos plane's own guarantee is that observability never
breaks the workload it observes).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

from rafiki_tpu_torch.obs.twin import load as load_mod
from rafiki_tpu_torch.obs.twin.calibration import Calibration
from rafiki_tpu_torch.obs.twin.engine import TwinConfig, simulate

FORECAST_SCHEMA_VERSION = 1

#: Fault sites the twin models; a spec touching none of these gets no
#: forecast (faulting e.g. checkpoint.save tells the twin nothing).
SERVING_SITES = ("gateway.predict", "bus.add_query", "bus.put_prediction",
                 "inference.forward")

DEFAULT_QPS = 50.0
DEFAULT_DURATION_S = 8.0


def spec_touches_serving(spec: str) -> bool:
    """Does a raw RAFIKI_CHAOS spec name any serving-chain site?"""
    return any(site in spec for site in SERVING_SITES)


def _min_fleet_for(spec: str) -> int:
    """Smallest worker count under which every ``match=w<N>`` filter in
    the spec can actually select a twin worker. Twin workers are named
    ``w0..w{n-1}`` (the scenario-harness convention); a forecast fleet
    smaller than the filtered id silently simulates the fault never
    firing — a zero-delta forecast that looks like a prediction."""
    ids = [int(m) for m in re.findall(r"match=w(\d+)", spec)]
    return max(ids) + 1 if ids else 0


def forecast(spec: str, calibration: Optional[Calibration] = None,
             qps: float = DEFAULT_QPS,
             duration_s: float = DEFAULT_DURATION_S,
             seed: int = 0) -> Optional[Dict[str, Any]]:
    """Baseline-vs-faulted forecast for one spec, or None when the
    spec touches no serving site. Deterministic: the same spec, seed
    and calibration always forecast the same deltas."""
    if not spec_touches_serving(spec):
        return None
    cal = calibration or Calibration.nominal()
    cfg = TwinConfig.from_calibration(cal)
    floor = _min_fleet_for(spec)
    if cfg.workers < floor:
        cfg = TwinConfig.from_calibration(cal, workers=floor)
    arrivals = load_mod.synthesize("constant", qps=qps,
                                   duration_s=duration_s, seed=seed)
    base = simulate(cal, cfg, arrivals, seed=seed)
    faulted = simulate(cal, cfg, arrivals, seed=seed, chaos_spec=spec)
    return {
        "forecast_schema_version": FORECAST_SCHEMA_VERSION,
        "spec": spec,
        "qps": qps,
        "duration_s": duration_s,
        "seed": seed,
        "baseline": _headline(base),
        "faulted": _headline(faulted),
        "delta_p99_ms": _delta(faulted.get("p99_ms"), base.get("p99_ms")),
        "delta_shed_rate": _delta(faulted.get("shed_rate"),
                                  base.get("shed_rate")),
        "workers_dead": faulted.get("workers_dead") or [],
        "breaker_transitions": len(faulted.get("breaker_transitions")
                                   or []),
        "chaos_fired": faulted.get("chaos_fired", 0),
    }


def _headline(res: Dict[str, Any]) -> Dict[str, Any]:
    return {k: res.get(k) for k in ("qps", "p50_ms", "p99_ms",
                                    "shed_rate", "ok", "shed", "errors",
                                    "first_saturating")}


def _delta(after: Optional[float], before: Optional[float]
           ) -> Optional[float]:
    if after is None or before is None:
        return None
    return round(after - before, 4)
