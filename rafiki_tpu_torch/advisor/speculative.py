"""Speculative scoring coordinator: the three curve-fit consumers.

The port's own copy of ``rafiki_tpu/advisor/speculative.py``
``CurveCoordinator``. One coordinator per sweep (the mesh scheduler
shares one across its chip workers; a standalone ``TrainWorker`` builds
its own) collects live (epoch, score) points per in-flight knob
assignment and answers three questions for the hot loop:

* **kill?** (:meth:`kill_verdict`): at an epoch boundary, should this
  trial die because its credible band's *upper* edge sits below
  best-so-far minus the margin? Gated by ``RAFIKI_CURVE_KILL``.
* **speculate?** (:meth:`speculate_inflight`): before the advisor
  drafts new proposals (a backfill), feed it predicted scores for
  stragglers still mid-flight, in sorted knobs-hash order. Gated by
  ``RAFIKI_CURVE_SPECULATE``. The true score lands later through the
  normal ``feedback`` path, which the advisor base routes into a
  correction (the engine refits).
* **done** (:meth:`note_scored` / :meth:`note_done`): bookkeeping that
  keeps best-so-far honest and stops a finished trial from being
  speculated or killed retroactively.

Everything is journaled through ``rafiki_tpu_torch.obs.search.audit``
(``advisor/predict``, ``advisor/kill``, ``advisor/speculate``), so a
crash-resume rebuilds the advisor's effective training set (real
observations plus uncorrected speculations) from journals alone and
re-proposes byte-identically (docs/early_kill.md). The coordinator only
reads Python floats the loops already synced at their epoch boundary;
it adds no device work.

With both switches off :func:`CurveCoordinator.from_env` returns
``None`` and every call site short-circuits on ``is None``: the loops
run as they do without it, bit for bit.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from rafiki_tpu_torch.advisor.curve import CurveFit, KillConfig, fit_curve
from rafiki_tpu_torch.obs.search import audit as search_audit

#: Fallback extrapolation horizon when the knob assignment carries no
#: integer ``epochs`` knob — long enough that a slow riser is judged
#: near its asymptote, not its prefix.
DEFAULT_HORIZON = 16


class CurveCoordinator:
    """Thread-safe per-sweep curve tracker + kill/speculate decider."""

    def __init__(self, config: Optional[KillConfig] = None):
        self.config = config or KillConfig.from_env()
        self._lock = threading.RLock()
        self._points: Dict[str, List[Tuple[int, float]]] = {}
        self._knobs: Dict[str, Dict[str, Any]] = {}
        self._horizon: Dict[str, int] = {}
        self._trial: Dict[str, Optional[str]] = {}
        self._killed: set = set()
        self._done: set = set()
        self._speculated: Dict[str, float] = {}
        self._best: Optional[float] = None

    @classmethod
    def from_env(cls) -> Optional["CurveCoordinator"]:
        """None unless at least one consumer is switched on — call
        sites guard on ``is None`` so the off path adds zero work."""
        cfg = KillConfig.from_env()
        if not (cfg.enabled or cfg.speculate):
            return None
        return cls(cfg)

    # -- feeding -------------------------------------------------------------

    def observe(self, knobs: Dict[str, Any], epoch: int, score: float,
                trial_id: Optional[str] = None,
                horizon: Optional[int] = None) -> None:
        """One live curve point from an epoch boundary."""
        h = search_audit.knobs_hash(knobs)
        with self._lock:
            if h in self._done or h in self._killed:
                return
            self._points.setdefault(h, []).append((int(epoch),
                                                   float(score)))
            self._knobs.setdefault(h, dict(knobs))
            if trial_id is not None:
                self._trial[h] = trial_id
            if horizon is None:
                ek = knobs.get("epochs")
                horizon = int(ek) if isinstance(ek, (int, float)) \
                    else DEFAULT_HORIZON
            self._horizon[h] = max(int(horizon), int(epoch) + 1)

    def note_scored(self, knobs: Dict[str, Any], score: float) -> None:
        """True final score landed: retire the curve, advance
        best-so-far."""
        h = search_audit.knobs_hash(knobs)
        with self._lock:
            self._done.add(h)
            self._speculated.pop(h, None)
            if self._best is None or float(score) > self._best:
                self._best = float(score)

    def note_done(self, knobs: Dict[str, Any]) -> None:
        """Trial left without a real score (diverged/errored/killed):
        retire the curve without moving best-so-far."""
        h = search_audit.knobs_hash(knobs)
        with self._lock:
            self._done.add(h)

    @property
    def best_so_far(self) -> Optional[float]:
        with self._lock:
            return self._best

    # -- consumers -----------------------------------------------------------

    def kill_verdict(self, knobs: Dict[str, Any], epoch: int,
                     trial_id: Optional[str] = None) -> Optional[CurveFit]:
        """The fit that condemns the trial, or None to keep training.
        Journals every consultation (``advisor/predict``) and every
        verdict (``advisor/kill``)."""
        if not self.config.enabled:
            return None
        h = search_audit.knobs_hash(knobs)
        with self._lock:
            if h in self._killed or h in self._done:
                return None
            pts = list(self._points.get(h, ()))
            horizon = self._horizon.get(h, DEFAULT_HORIZON)
            best = self._best
        fit = fit_curve(pts, horizon)
        if fit is None:
            return None
        search_audit.record_predict(knobs, fit.to_record(), epoch=epoch,
                                    best_so_far=best, trial_id=trial_id)
        if not self.config.should_kill(fit, epoch, best):
            return None
        with self._lock:
            self._killed.add(h)
            self._speculated.pop(h, None)
        search_audit.record_kill(
            knobs, fit.to_record(), epoch=epoch, best_so_far=best,
            config={
                "warmup_epochs": self.config.warmup_epochs,
                "margin": self.config.margin,
                "min_obs": self.config.min_obs,
            },
            trial_id=trial_id,
        )
        return fit

    def speculate_inflight(self, advisor: Any) -> int:
        """Feed the advisor predicted scores for every in-flight curve
        with enough points and no speculation yet. Iterates hashes in
        sorted order so concurrent call sites produce a deterministic
        speculation sequence for a given state. Returns how many were
        fed."""
        if not self.config.speculate:
            return 0
        with self._lock:
            candidates = []
            for h in sorted(self._points):
                if h in self._done or h in self._killed \
                        or h in self._speculated:
                    continue
                pts = self._points[h]
                if len(pts) < self.config.min_obs:
                    continue
                candidates.append((h, list(pts), self._horizon[h],
                                   dict(self._knobs[h])))
        n = 0
        for h, pts, horizon, knobs in candidates:
            fit = fit_curve(pts, horizon)
            if fit is None:
                continue
            with self._lock:
                if h in self._done or h in self._killed \
                        or h in self._speculated:
                    continue
                self._speculated[h] = fit.predicted_final
            advisor.speculate(fit.predicted_final, knobs,
                              fit=fit.to_record())
            n += 1
        return n
