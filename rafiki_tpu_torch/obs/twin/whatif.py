"""What-if capacity planning on top of the twin engine.

The port's own copy of ``rafiki_tpu/obs/twin/whatif.py``.

Three layers:

* :func:`sweep` — cartesian knob grids (worker count, quorum,
  microbatch, queue depth, policy) simulated against ONE arrival
  sequence under ONE seed, so every row differs only by the knob under
  study. Each row reports predicted p50/p99/qps/shed-rate plus the
  first-saturating resource.
* :func:`slo_targets` — the p99-latency and shed-rate budgets the
  capacity question is asked against, read from the SAME ``RAFIKI_SLO``
  spec set the live burn-rate engine runs (obs/perf/slo.py); the twin
  must not invent its own notion of "good enough".
* :func:`fleet_search` — the smallest-fleet answer: scan worker counts
  ascending and return the first meeting every target, with the full
  scan attached so the operator sees the frontier, not just the pick.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from rafiki_tpu_torch.obs.twin.calibration import Calibration
from rafiki_tpu_torch.obs.twin.engine import TwinConfig, simulate

#: TwinConfig fields sweepable via the CLI grid grammar.
SWEEPABLE = ("workers", "queries_per_request", "min_replies", "max_queue",
             "max_inflight", "hedge_grace_s", "policy", "deadline_s")

#: Result keys copied into each sweep row next to the knob values.
ROW_METRICS = ("qps", "p50_ms", "p99_ms", "shed_rate", "requests", "ok",
               "shed", "errors", "first_saturating")

#: Fleet search scans 1..this many workers before giving up.
MAX_FLEET = 64


def run_once(cal: Calibration, cfg: TwinConfig,
             arrivals: Sequence[Union[float, Tuple[float, int]]],
             seed: int = 0, chaos_spec: Optional[str] = None,
             record_events: bool = False) -> Dict[str, Any]:
    """One simulation — the CLI ``twin run`` body."""
    return simulate(cal, cfg, arrivals, seed=seed, chaos_spec=chaos_spec,
                    record_events=record_events)


def sweep(cal: Calibration, base: TwinConfig,
          arrivals: Sequence[Union[float, Tuple[float, int]]],
          grid: Dict[str, List[Any]], seed: int = 0,
          chaos_spec: Optional[str] = None) -> List[Dict[str, Any]]:
    """Simulate every combination in ``grid`` (knob -> values) over the
    same arrivals and seed. Rows come back in deterministic grid order:
    knobs sorted by name, values in the order given."""
    unknown = set(grid) - set(SWEEPABLE)
    if unknown:
        raise ValueError(f"unsweepable knob(s): {sorted(unknown)}; "
                         f"one of {SWEEPABLE}")
    knobs = sorted(grid)
    rows: List[Dict[str, Any]] = []
    for combo in itertools.product(*(grid[k] for k in knobs)):
        overrides = dict(zip(knobs, combo))
        cfg = dataclasses.replace(base, **overrides)
        res = simulate(cal, cfg, arrivals, seed=seed,
                       chaos_spec=chaos_spec)
        row = dict(overrides)
        row.update({m: res[m] for m in ROW_METRICS})
        row["utilization"] = res["utilization"]
        rows.append(row)
    return rows


def slo_targets() -> Dict[str, float]:
    """The capacity budgets, derived from the active SLO spec set:
    ``p99_ms`` from the gateway p99-latency spec (seconds -> ms) and
    ``shed_rate`` from the shed-ratio spec. Specs disabled via
    ``RAFIKI_SLO=off`` fall back to the defaults — a fleet search with
    no target at all is meaningless."""
    from rafiki_tpu_torch.obs.perf.slo import _specs_from_env, default_specs
    specs = _specs_from_env()
    if not specs:   # None (unset) or [] (disabled) -> defaults
        specs = default_specs()
    targets: Dict[str, float] = {}
    for s in specs:
        if s.source.startswith("hist_p99:gateway.predict"):
            targets["p99_ms"] = float(s.threshold) * 1000.0
        elif s.name == "gateway_shed_rate" or (
                s.source.startswith("ratio:gateway.shed")):
            targets["shed_rate"] = float(s.threshold)
    # Backstop with the default budgets for anything the custom spec
    # set doesn't cover — the search needs both axes.
    for s in default_specs():
        if s.source.startswith("hist_p99:gateway.predict"):
            targets.setdefault("p99_ms", float(s.threshold) * 1000.0)
        elif s.source.startswith("ratio:gateway.shed"):
            targets.setdefault("shed_rate", float(s.threshold))
    return targets


def meets(row: Dict[str, Any], targets: Dict[str, float]) -> bool:
    p99 = row.get("p99_ms")
    if p99 is None:   # nothing completed: saturated, not compliant
        return False
    if p99 > targets["p99_ms"]:
        return False
    # Failed = shed at admission OR timed out past its deadline. An
    # overloaded fleet mostly fails the second way (the p99 over the
    # surviving requests can look deceptively healthy), so both count
    # against the shed budget.
    n = row.get("requests") or 0
    failed = (row.get("shed") or 0) + (row.get("errors") or 0)
    rate = failed / n if n else 1.0
    return rate <= targets["shed_rate"]


def fleet_search(cal: Calibration, base: TwinConfig,
                 arrivals: Sequence[Union[float, Tuple[float, int]]],
                 seed: int = 0,
                 targets: Optional[Dict[str, float]] = None,
                 max_fleet: int = MAX_FLEET) -> Dict[str, Any]:
    """Smallest worker count meeting the SLO targets under this load.
    Scans ascending and stops at the first compliant fleet (capacity
    is monotone enough in practice that first-fit is the answer an
    operator wants); the scanned frontier rides along."""
    targets = dict(targets or slo_targets())
    scanned: List[Dict[str, Any]] = []
    pick: Optional[int] = None
    for w in range(1, max_fleet + 1):
        cfg = dataclasses.replace(base, workers=w)
        res = simulate(cal, cfg, arrivals, seed=seed)
        row = {"workers": w}
        row.update({m: res[m] for m in ROW_METRICS})
        scanned.append(row)
        if meets(row, targets):
            pick = w
            break
    return {"targets": targets, "workers": pick, "scanned": scanned,
            "satisfied": pick is not None,
            "first_saturating": (scanned[-1]["first_saturating"]
                                 if scanned else None)}


#: suggest_slo knee headrooms: the p99 budget sits 25% above the knee
#: fleet's simulated p99 (normal jitter must not page), the shed budget
#: at 2x observed, clamped to [1%, 25%] (a zero-shed sim must not emit
#: an unmeetable 0.0 budget; a melting one must not normalize 40% shed).
P99_HEADROOM = 1.25
SHED_HEADROOM = 2.0
SHED_FLOOR, SHED_CEIL = 0.01, 0.25


def suggest_slo(fleet: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Auto-tuned ``RAFIKI_SLO`` spec dicts from a fleet-search result:
    thresholds anchored at the smallest compliant fleet (the knee),
    where latency is highest among compliant picks — budgets derived
    there hold for any larger fleet. Output round-trips through
    ``SloSpec.from_dict`` / ``RAFIKI_SLO=<json>`` byte-identically for
    the same fleet doc, so an
    operator can paste it straight into the live burn-rate engine.

    When no scanned fleet met the default targets, anchor on the best
    scanned p99 instead: the suggestion then documents the gap rather
    than inventing a budget the hardware cannot meet."""
    scanned = fleet.get("scanned") or []
    rows = [r for r in scanned if r.get("p99_ms") is not None]
    if not rows:
        raise ValueError("fleet search completed no requests; "
                         "no knee to tune an SLO against")
    knee = None
    if fleet.get("workers") is not None:
        for r in rows:
            if r.get("workers") == fleet["workers"]:
                knee = r
                break
    if knee is None:
        knee = min(rows, key=lambda r: float(r["p99_ms"]))
    p99_s = round(float(knee["p99_ms"]) * P99_HEADROOM / 1000.0, 6)
    n = knee.get("requests") or 0
    failed = (knee.get("shed") or 0) + (knee.get("errors") or 0)
    observed = failed / n if n else 0.0
    shed = round(min(max(observed * SHED_HEADROOM, SHED_FLOOR),
                     SHED_CEIL), 6)
    anchor = (f"{knee['workers']}-worker knee"
              if fleet.get("workers") is not None
              else f"best scanned fleet ({knee['workers']} workers, "
                   f"targets unmet)")
    return [
        {"name": "gateway_p99_latency",
         "source": "hist_p99:gateway.predict_s",
         "threshold": p99_s, "op": ">",
         "description": f"auto-tuned at the {anchor}: sim p99 "
                        f"{knee['p99_ms']}ms x{P99_HEADROOM} headroom"},
        {"name": "gateway_shed_rate",
         "source": "ratio:gateway.shed/gateway.shed+gateway.admitted",
         "threshold": shed, "op": ">",
         "description": f"auto-tuned at the {anchor}: observed "
                        f"fail rate {round(observed, 6)} "
                        f"x{SHED_HEADROOM}, clamped to "
                        f"[{SHED_FLOOR}, {SHED_CEIL}]"},
    ]


def parse_grid(items: List[str]) -> Dict[str, List[Any]]:
    """CLI grid grammar: ``knob=v1,v2,...`` per item. Values coerce to
    int, then float, then the literal string; ``none`` -> None (the
    min_replies sentinel for default quorum)."""
    grid: Dict[str, List[Any]] = {}
    for item in items:
        knob, eq, vals = item.partition("=")
        if not eq or not vals:
            raise ValueError(f"bad grid item {item!r}; want knob=v1,v2")
        grid[knob.strip()] = [_coerce(v) for v in vals.split(",")]
    return grid


def _coerce(v: str) -> Any:
    v = v.strip()
    if v.lower() in ("none", "null"):
        return None
    for conv in (int, float):
        try:
            return conv(v)
        except ValueError:
            pass
    return v
