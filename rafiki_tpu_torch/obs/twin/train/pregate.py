"""Sweep-lane pre-gate forecasts: the train twin's answer to "what
would this autoscale decision (or this fault) buy?" before the
controller actuates or the chaos runner injects (docs/twin.md,
docs/autoscale.md).

The port's own copy of ``rafiki_tpu/obs/twin/train/pregate.py``.

Two mirrors of the serving twin's pre-gates:

* :func:`forecast` — chip-count what-if: the same drafted sweep
  simulated at the current and the target chip count; deltas in
  trials/hour and makespan ride back to the caller. A scale-UP the
  twin predicts buys nothing (no trials/hour gain) is VETOED — the
  one non-advisory bit, honored by ``AutoscaleController``'s pre-gate
  contract exactly like the serving ``twin_forecast``.
* :func:`chaos_forecast` — fault what-if: baseline vs faulted
  simulation under the same ``RAFIKI_CHAOS`` grammar the live sweep
  parses, at the sweep sites (``scheduler.preempt``, ``host.loss``).

Both degrade to ``None``/no-veto on any forecasting failure: a broken
model must never block a controller that was working without it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from rafiki_tpu_torch.obs.twin.train.calibration import TrainCalibration
from rafiki_tpu_torch.obs.twin.train.engine import (TrainTwinConfig,
                                                    simulate,
                                                    synthesize_trials)

TRAIN_FORECAST_SCHEMA_VERSION = 1

#: Fault sites the train twin models; a spec touching none of these
#: gets no chaos forecast.
SWEEP_SITES = ("scheduler.preempt", "host.loss")

#: Minimum predicted trials/hour gain for a scale-up to be worth its
#: chips (relative to baseline).
MIN_SCALE_UP_GAIN = 0.02


def spec_touches_sweep(spec: str) -> bool:
    """Does a raw RAFIKI_CHAOS spec name any sweep-lane site?"""
    return any(site in spec for site in SWEEP_SITES)


def _headline(res: Dict[str, Any]) -> Dict[str, Any]:
    return {f: res.get(f) for f in
            ("trials_per_hour", "makespan_s", "completed", "utilization",
             "chips_lost", "repacks", "status")}


def forecast(current: int, target: int,
             calibration: Optional[TrainCalibration] = None,
             n_trials: Optional[int] = None,
             seed: int = 0) -> Dict[str, Any]:
    """Chip-count what-if for the sweep lane: the same drafted trial
    set simulated at ``current`` and ``target`` chips. Deterministic:
    one (calibration, seed) pair always forecasts the same deltas."""
    cal = calibration or TrainCalibration.nominal()
    cur = TrainTwinConfig.from_calibration(cal, chips=max(1, int(current)))
    tgt = TrainTwinConfig.from_calibration(cal, chips=max(1, int(target)))
    n = int(n_trials or cal.sweep.get("n_trials")
            or max(cur.slots(), tgt.slots()))
    trials = synthesize_trials(cal, n, seed=seed)
    base = simulate(cal, cur, trials=trials, seed=seed)
    after = simulate(cal, tgt, trials=trials, seed=seed)
    d_tph = ((after.get("trials_per_hour") or 0.0)
             - (base.get("trials_per_hour") or 0.0))
    veto = False
    veto_reason = None
    base_tph = base.get("trials_per_hour") or 0.0
    if target > current and base_tph > 0:
        if d_tph / base_tph < MIN_SCALE_UP_GAIN:
            veto = True
            veto_reason = (
                f"twin predicts {d_tph / base_tph:+.1%} trials/hour for "
                f"{current}->{target} chips (< {MIN_SCALE_UP_GAIN:.0%} "
                f"gain): the sweep is not chip-bound")
    return {
        "forecast_schema_version": TRAIN_FORECAST_SCHEMA_VERSION,
        "lane": "sweep",
        "current": int(current),
        "target": int(target),
        "n_trials": n,
        "seed": seed,
        "baseline": _headline(base),
        "target_forecast": _headline(after),
        "delta_trials_per_hour": round(d_tph, 4),
        "delta_makespan_s": round((after.get("makespan_s") or 0.0)
                                  - (base.get("makespan_s") or 0.0), 4),
        "veto": veto,
        "veto_reason": veto_reason,
    }


def chaos_forecast(spec: str,
                   calibration: Optional[TrainCalibration] = None,
                   chips: Optional[int] = None,
                   chips_per_host: int = 0,
                   seed: int = 0) -> Optional[Dict[str, Any]]:
    """Baseline-vs-faulted forecast for one RAFIKI_CHAOS spec at the
    sweep sites, or None when the spec touches none of them."""
    if not spec_touches_sweep(spec):
        return None
    cal = calibration or TrainCalibration.nominal()
    overrides: Dict[str, Any] = {"chips_per_host": int(chips_per_host)}
    if chips is not None:
        overrides["chips"] = max(1, int(chips))
    cfg = TrainTwinConfig.from_calibration(cal, **overrides)
    trials = synthesize_trials(cal, int(cfg.n_trials or cfg.slots()),
                               seed=seed)
    base = simulate(cal, cfg, trials=trials, seed=seed)
    faulted = simulate(cal, cfg, trials=trials, seed=seed,
                       chaos_spec=spec)
    return {
        "forecast_schema_version": TRAIN_FORECAST_SCHEMA_VERSION,
        "spec": spec,
        "seed": seed,
        "baseline": _headline(base),
        "faulted": _headline(faulted),
        "delta_trials_per_hour": round(
            (faulted.get("trials_per_hour") or 0.0)
            - (base.get("trials_per_hour") or 0.0), 4),
        "delta_makespan_s": round((faulted.get("makespan_s") or 0.0)
                                  - (base.get("makespan_s") or 0.0), 4),
        "chips_lost": faulted.get("chips_lost") or [],
        "hosts_lost": faulted.get("hosts_lost") or [],
        "repacks": faulted.get("repacks") or 0,
        "chaos_fired": faulted.get("chaos_fired", 0),
    }


def sweep_chip_pregate(calibration: Optional[TrainCalibration] = None,
                       log_dir: Optional[str] = None,
                       seed: int = 0
                       ) -> Callable[..., Optional[Dict[str, Any]]]:
    """A ``pregate_fn`` for ``AutoscaleController(pregate_fn=...)``
    over the SweepChipLane: forecasts every sweep-lane decision before
    actuation, mirroring the serving ``twin_forecast``. Lanes other
    than ``sweep`` get None (no opinion); so does any forecasting
    failure — the controller's exception guard records it either way."""

    def pregate_fn(lane: str, current: int, target: int,
                   sensors: Optional[Dict[str, Any]] = None
                   ) -> Optional[Dict[str, Any]]:
        if lane != "sweep" or target == current:
            return None
        cal = calibration
        if cal is None and log_dir:
            cal = TrainCalibration.from_journal_dir(log_dir)
        return forecast(current, target, calibration=cal, seed=seed)

    return pregate_fn
