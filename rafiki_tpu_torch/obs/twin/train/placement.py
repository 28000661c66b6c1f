"""Sweep-admission placement consultation (docs/twin.md).

The port's own copy of ``rafiki_tpu/obs/twin/train/placement.py``.

With ``RAFIKI_TWIN_PLACEMENT`` set, ``MeshSweepScheduler.run_sweep``
calls :func:`consult` at admission — before any budget slot is claimed
— and the twin answers from the journal history: the best pack width
per observed packing key and the best (chips, k) split for this
sweep's trial budget.

The contract is ADVISORY-ONLY, by construction:

* the answer is journaled as ``twin/placement`` and returned, never
  applied — the operator (or a future policy layer) closes the loop;
* any failure (no calibration captured yet, stale bundle, engine
  error) raises out of :func:`consult`, and the scheduler's caller
  wraps it: the error lands in a ``twin/placement`` record with an
  ``error`` field and the sweep proceeds untouched. Observability
  never breaks the workload it observes.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from rafiki_tpu_torch.obs.journal import journal as _journal

#: Fields of the what-if rows worth journaling per candidate.
_ROW_FIELDS = ("chips", "k", "trials_per_hour", "makespan_s", "hbm_frac",
               "fits")


def consult(job_id: str, chips: int, k: int,
            budget: Optional[Dict[str, Any]] = None,
            log_dir: Optional[str] = None,
            seed: int = 0) -> Dict[str, Any]:
    """Ask the twin for a pack/split recommendation at sweep admission.
    Calibrates from ``log_dir`` (default: the active journal dir /
    ``RAFIKI_LOG_DIR``), journals the answer as ``twin/placement``,
    and returns it. Raises when no calibration is available — the
    caller treats that as advice unavailable, never as a sweep error."""
    from rafiki_tpu_torch.obs.twin.train import whatif
    from rafiki_tpu_torch.obs.twin.train.calibration import TrainCalibration

    src = log_dir or _active_log_dir()
    if not src:
        raise RuntimeError(
            "twin placement: no journal dir to calibrate from "
            "(set RAFIKI_LOG_DIR)")
    cal = TrainCalibration.from_journal_dir(src)
    budget = budget or {}
    max_trials = budget.get("MODEL_TRIAL_COUNT")
    n_trials = int(chips) * int(k)
    if max_trials is not None:
        n_trials = min(n_trials, int(max_trials))
    ks = sorted({1, 2, 4} | {int(k)})
    per_key = whatif.best_k(cal, chips=int(chips), ks=ks, seed=seed)
    # Candidate splits: the requested shape plus its halved-fleet and
    # doubled-fleet neighbours at every scanned width.
    splits = sorted({(c, kk)
                     for c in {max(1, int(chips) // 2), int(chips),
                               int(chips) * 2}
                     for kk in ks})
    split = whatif.split_search(cal, n_trials=n_trials, splits=splits,
                                seed=seed)
    rec = {
        "best_k": {pk: v["best_k"] for pk, v in per_key.items()},
        "best_split": split["best"],
        "candidates": [{f: r.get(f) for f in _ROW_FIELDS}
                       for r in split["rows"]],
        "calibration_source": cal.source,
    }
    _journal.record("twin", "placement", job_id=job_id, advisory=True,
                    chips=int(chips), k=int(k), n_trials=n_trials,
                    recommendation=rec)
    return rec


def _active_log_dir() -> Optional[str]:
    d = _journal.log_dir
    if d is not None:
        return str(d)
    return os.environ.get("RAFIKI_LOG_DIR") or None
