"""Train-twin-vs-real validation: replay a captured mesh sweep through
the simulator and score predicted against measured throughput.

The port's own copy of ``rafiki_tpu/obs/twin/train/validate.py``.

Both sides derive from the same journal directory, keeping the
comparison honest:

* **measured** — the training window reconstructed from the packed
  ``perf/step`` records: wall clock spans the first epoch start
  (``ts - dt``) to the last epoch end (``ts``); the trial count comes
  from ``mesh/sweep_started`` (falling back to the distinct member ids
  in ``mesh/pack_formed``), plus the trials the bundle's packs
  backfilled (``trial_pack/rounds``, a port departure:
  ``calibration.py``).
* **replayed placement** — the literal packs ``mesh/pack_formed``
  recorded, so the simulator runs the schedule the scheduler actually
  produced, not a re-derivation.
* **calibration** — per-(packing_key, k) epoch samples + the fitted
  epoch overhead from the very same run.

Prediction error is relative for BOTH trials/hour and total wall:
``|predicted - measured| / measured``; the gate passes only if both
are within tolerance. ``scales`` deliberately mis-calibrates (e.g.
``step=2.0``) — the negative polarity proves the gate actually fails
when the model is wrong.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from rafiki_tpu_torch.obs import journal as journal_mod
from rafiki_tpu_torch.obs.twin.train.calibration import (TrainCalibration,
                                                         TrainCalibrationError)
from rafiki_tpu_torch.obs.twin.train.engine import (TrainTwinConfig,
                                                    packs_from_calibration,
                                                    simulate)

TRAIN_VALIDATE_SCHEMA_VERSION = 1

#: Default relative-error gate — the acceptance bar: predicted
#: trials/hour and wall within 25% of measured. The twin is a capacity
#: model; it must catch a doubled step time, not a 5% drift.
DEFAULT_TOLERANCE = 0.25

#: Minimum measured trials for a throughput comparison to mean much.
MIN_TRIALS = 2


def measured_from_records(records: List[Dict[str, Any]]
                          ) -> Tuple[int, Optional[float]]:
    """(n_trials, wall_s) of the captured sweep's training window."""
    steps = [r for r in records
             if r.get("kind") == "perf" and r.get("name") == "step"
             and r.get("packing_key")
             and isinstance(r.get("ts"), (int, float))
             and isinstance(r.get("dt"), (int, float))]
    wall = None
    if len(steps) >= 2:
        wall = (max(float(r["ts"]) for r in steps)
                - min(float(r["ts"]) - float(r["dt"]) for r in steps))
    elif len(steps) == 1:
        wall = float(steps[0]["dt"])
    n = 0
    member_ids = set()
    for r in records:
        if r.get("kind") != "mesh":
            continue
        if r.get("name") == "sweep_started" and r.get("n_trials"):
            n = int(r["n_trials"])
        elif r.get("name") == "pack_formed":
            member_ids.update(r.get("trial_ids") or [])
    return (n or len(member_ids)), wall


def validate(log_dir, seed: int = 0,
             tolerance: float = DEFAULT_TOLERANCE,
             scales: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Score the train twin against one captured sweep. Returns the
    gate artifact; ``ok`` is the verdict. Raises
    :class:`TrainCalibrationError` if the journals can't calibrate and
    ``ValueError`` when too few trials were measured."""
    records = journal_mod.read_dir(log_dir)
    if not records:
        raise TrainCalibrationError(
            ["perf/step", "mesh/pack_formed"], str(log_dir))
    cal = TrainCalibration.from_records(records, source=str(log_dir))
    if scales:
        cal = cal.scaled(scales)
    n_meas, wall_meas = measured_from_records(records)
    # The trials backfilled into the packs ran too (a port departure:
    # ``trial_pack/rounds``, calibration.py).
    n_meas += sum(len(p.get("backfilled") or []) for p in cal.packs)
    if n_meas < MIN_TRIALS or not wall_meas or wall_meas <= 0:
        raise ValueError(
            f"only {n_meas} measured trial(s) over "
            f"{wall_meas if wall_meas else 0:.3f}s in {log_dir}; need "
            f">= {MIN_TRIALS} trials with packed perf/step records "
            f"(run a mesh sweep with the journal open in DIR)")
    packs = packs_from_calibration(cal)
    cfg = TrainTwinConfig.from_calibration(cal)
    res = simulate(cal, cfg, packs=packs, seed=seed)
    tph_meas = n_meas / wall_meas * 3600.0
    measured = {"trials": n_meas,
                "wall_s": round(wall_meas, 4),
                "trials_per_hour": round(tph_meas, 4)}
    predicted = {"trials": res["completed"],
                 "wall_s": res["makespan_s"],
                 "trials_per_hour": res["trials_per_hour"],
                 "utilization": res["utilization"],
                 "status": res["status"]}
    tph_err = _rel_err(res["trials_per_hour"], tph_meas)
    wall_err = _rel_err(res["makespan_s"], wall_meas)
    ok = (tph_err is not None and wall_err is not None
          and tph_err <= tolerance and wall_err <= tolerance)
    return {
        "train_twin_schema_version": TRAIN_VALIDATE_SCHEMA_VERSION,
        "source": str(log_dir),
        "seed": seed,
        "tolerance": tolerance,
        "scales": dict(scales or {}),
        "measured": measured,
        "predicted": predicted,
        "tph_err": None if tph_err is None else round(tph_err, 4),
        "wall_err": None if wall_err is None else round(wall_err, 4),
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
