"""Advisor decision audit: every propose/feedback leaves a record.

The port's own copy of ``rafiki_tpu/obs/search/audit.py``. Its helpers
are the way an advisor implementation journals its decisions; the
field names, their rounding and the join key equal the JAX package's,
so each package's readers (``obs sweep``, ``obs lineage``, advisor
rehydration) read the other's journals.

Record shapes, all ``kind="advisor"``:

``advisor/propose``
    one chosen knob assignment: ``engine``/``advisor_id``/``job_id``/
    ``seed``, the full ``knobs`` dict, its ``knobs_hash``, history and
    pending sizes, and the engine's ``acquisition`` breakdown (the
    "why": EI value + posterior mean/std + pool size for GP, KDE
    log-ratio + pool for TPE, warmup/epsilon markers, GP fit wall-time).

``advisor/propose_batch``
    one q-batch draft: ``n``, the drafting ``strategy`` (sequential vs
    constant-liar), liar state, and the member hashes.

``advisor/feedback``
    one observed score: ``knobs_hash``, ``score``, ``best_so_far``,
    history size, and whether the ledger saw the trial doomed.

``advisor/predict`` / ``advisor/kill`` / ``advisor/speculate`` /
``advisor/correct`` / ``advisor/false_kill``
    the learning-curve plane (docs/early_kill.md): one extrapolator
    fit consulted at an epoch boundary, one early-kill verdict, one
    speculative score fed to the engine, one speculative score
    replaced by the truth, one hindsight false-kill verdict. Each
    carries the fit slice (``CurveFit.to_record``: family, decay,
    n_obs, rmse, predicted, band, lo/hi, horizon) plus ``knobs_hash``
    and the kill knobs in force, so advisor rehydration can replay
    uncorrected speculations to byte-identical post-resume proposals.

The join key is ``knobs_hash``: a sha256 prefix over the canonical
JSON of the full knob assignment. Workers journal the same dict on
``event/trial_started``, so a reader hashes that side too and stitches
proposal -> trial_id -> ``trial/epoch_eval`` curves without the advisor
ever learning trial ids. A sweep's write-ahead log
(``scheduler/wal.py``) carries the same hash.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional, Sequence

from rafiki_tpu_torch.obs.journal import journal
from rafiki_tpu_torch.obs.search.ledger import search_ledger

KIND = "advisor"


def knobs_hash(knobs: Dict[str, Any]) -> str:
    """Canonical 16-hex digest of a full knob assignment. Knob values
    are JSON natives (knobs.py samples/decodes to float/int/str), so
    ``sort_keys`` JSON is a stable canonical form on both the writer
    side and the journal-reader side."""
    blob = json.dumps(knobs, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def note_doomed(knobs: Dict[str, Any]) -> None:
    """Worker error paths call this BEFORE the consolation
    ``advisor.feedback(0.0, knobs)`` so the ledger charges the trial's
    wall to the doomed bucket and the feedback record carries
    ``doomed=True`` (errored/diverged/lost — proposed but never
    scored for real)."""
    search_ledger.note_doomed(knobs_hash(knobs))


def _ident(advisor: Any) -> Dict[str, Any]:
    return {
        "engine": getattr(advisor, "engine", type(advisor).__name__),
        "advisor_id": getattr(advisor, "advisor_id", None),
        "job_id": getattr(advisor, "job_id", None),
        "seed": getattr(advisor, "seed", None),
    }


def record_propose(advisor: Any, knobs: Dict[str, Any],
                   acquisition: Optional[Dict[str, Any]] = None) -> str:
    """Journal one chosen assignment; returns its hash so callers can
    thread it into a batch record."""
    h = knobs_hash(knobs)
    search_ledger.note_propose(h)
    journal.record(
        KIND, "propose",
        knobs=dict(knobs),
        knobs_hash=h,
        n_observations=len(getattr(advisor, "history", ())),
        n_pending=len(getattr(advisor, "_pending", ())),
        acquisition=dict(acquisition or {"phase": "unknown"}),
        **_ident(advisor),
    )
    return h


def record_propose_batch(advisor: Any,
                         n: int,
                         knobs_list: Sequence[Dict[str, Any]],
                         strategy: str,
                         liar: Optional[Dict[str, Any]] = None) -> None:
    """Journal one q-batch draft. Members were each journaled by
    ``record_propose`` already; this record carries the batch-level
    state (constant-liar value, how many lies were planted)."""
    journal.record(
        KIND, "propose_batch",
        n=int(n),
        strategy=strategy,
        knobs_hashes=[knobs_hash(k) for k in knobs_list],
        liar=dict(liar) if liar else None,
        **_ident(advisor),
    )


def record_feedback(advisor: Any, score: float,
                    knobs: Dict[str, Any]) -> None:
    h = knobs_hash(knobs)
    doomed = search_ledger.note_feedback(h, float(score))
    best = None
    hist = getattr(advisor, "history", None)
    if hist:
        try:
            best = max(s for _, s in hist)
        except (TypeError, ValueError):
            best = None
    journal.record(
        KIND, "feedback",
        knobs_hash=h,
        score=float(score),
        best_so_far=best,
        doomed=doomed,
        n_observations=len(hist or ()),
        **_ident(advisor),
    )


# -- learning-curve plane (advisor/curve.py, docs/early_kill.md) -------------

def record_predict(knobs: Dict[str, Any], fit: Dict[str, Any],
                   epoch: int, best_so_far: Optional[float],
                   trial_id: Optional[str] = None) -> None:
    """Journal one extrapolator consultation at an epoch boundary.
    ``fit`` is ``CurveFit.to_record()``."""
    journal.record(
        KIND, "predict",
        knobs_hash=knobs_hash(knobs),
        epoch=int(epoch),
        best_so_far=best_so_far,
        trial_id=trial_id,
        **fit,
    )


def record_kill(knobs: Dict[str, Any], fit: Dict[str, Any],
                epoch: int, best_so_far: float,
                config: Dict[str, Any],
                trial_id: Optional[str] = None) -> None:
    """Journal one early-kill verdict: the fit that condemned the
    trial plus the ``RAFIKI_CURVE_KILL*`` knobs in force (``config``),
    so `obs sweep` can audit every kill against the rule that made it.
    Callers still route the trial through ``note_doomed`` + the
    consolation feedback — this record is the *why*, the ledger charge
    is the *cost*."""
    search_ledger.note_kill()
    journal.record(
        KIND, "kill",
        knobs_hash=knobs_hash(knobs),
        epoch=int(epoch),
        best_so_far=float(best_so_far),
        config=dict(config),
        trial_id=trial_id,
        **fit,
    )


def record_speculate(advisor: Any, predicted: float,
                     knobs: Dict[str, Any],
                     fit: Optional[Dict[str, Any]] = None) -> None:
    """Journal one speculative score entering the engine's training
    set. A later ``advisor/feedback`` for the same hash supersedes it
    (the correction); rehydration replays only speculations with no
    such feedback — see advisor/rehydrate.py."""
    search_ledger.note_speculation()
    journal.record(
        KIND, "speculate",
        knobs_hash=knobs_hash(knobs),
        knobs=dict(knobs),
        predicted=float(predicted),
        fit=dict(fit) if fit else None,
        n_observations=len(getattr(advisor, "history", ())),
        **_ident(advisor),
    )


def record_correct(advisor: Any, knobs: Dict[str, Any],
                   predicted: float, actual: float) -> None:
    """Journal one speculative score replaced by the trial's true
    score (the engine refits). The paired ``advisor/feedback`` record
    carries the authoritative score; this one carries the error the
    `obs sweep` prediction-quality roll-up wants."""
    search_ledger.note_correction()
    journal.record(
        KIND, "correct",
        knobs_hash=knobs_hash(knobs),
        predicted=float(predicted),
        actual=float(actual),
        error=float(actual) - float(predicted),
        **_ident(advisor),
    )


def record_false_kill(knobs: Dict[str, Any], killed_predicted: float,
                      sibling_score: float, best_so_far: float) -> None:
    """Hindsight verdict from a ground-truth checker (one that re-runs
    each killed trial's knobs to completion): the sibling finished
    above best-so-far, so the kill cost the search a contender."""
    search_ledger.note_false_kill()
    journal.record(
        KIND, "false_kill",
        knobs_hash=knobs_hash(knobs),
        killed_predicted=float(killed_predicted),
        sibling_score=float(sibling_score),
        best_so_far=float(best_so_far),
    )
