"""Learning-curve extrapolation: predict a trial's final score mid-flight.

The port's own copy of ``rafiki_tpu/advisor/curve.py`` (``CurveFit``,
``fit_curve``, ``predict_points``, ``KillConfig`` and the
``RAFIKI_CURVE_*`` variables). Float64 numpy on the host, the same
operations in the same order as the JAX package's, so a fit of the same
points is bit-equal in both packages and a kill decided by either
audits the same in the other's journal reader.

Fit a tiny saturating family on the live (epoch, score) prefix,
extrapolate to the trial's epoch budget, and hand consumers a
CONSERVATIVE credible band. Two closed-form families

    pow:  s(e) = a - b * (e + 1) ** -c
    exp:  s(e) = a - b * exp(-c * e)

fit by linear least squares over a fixed decay grid (no iterative
optimiser, no rng): every fit is deterministic and costs microseconds,
so consulting the predictor at an epoch boundary is free next to one
training step. The band is residual-scaled and inflated at small n, so
the early-kill rule ("upper band below best-so-far minus margin") stays
conservative exactly when the curve is least trustworthy.

Consumers: the kill rule in :class:`KillConfig` (``worker/train.py``
consults it at epoch boundaries, off by default, ``RAFIKI_CURVE_KILL``)
and the speculative scorer (``advisor/speculative.py``) that feeds
predicted-then-corrected scores to the GP. Every decision made off a
fit is journaled through ``rafiki_tpu_torch.obs.search.audit``
(docs/early_kill.md).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

#: Master switch + knobs for the early-kill rule (docs/early_kill.md).
#: Off by default: with RAFIKI_CURVE_KILL unset the train loops run
#: today's behavior bit-exactly (no fits, no journals, no rng use).
ENV_KILL = "RAFIKI_CURVE_KILL"
ENV_KILL_WARMUP = "RAFIKI_CURVE_KILL_WARMUP"
ENV_KILL_MARGIN = "RAFIKI_CURVE_KILL_MARGIN"
ENV_KILL_MIN_OBS = "RAFIKI_CURVE_KILL_MIN_OBS"
ENV_SPECULATE = "RAFIKI_CURVE_SPECULATE"

#: Fixed decay-rate grid shared by both families: small enough to be
#: free, wide enough to bracket every curve the zoo produces. A grid
#: (not an optimiser) keeps the fit closed-form and deterministic.
_DECAY_GRID = tuple(float(c) for c in np.geomspace(0.05, 3.0, 16))


@dataclasses.dataclass(frozen=True)
class CurveFit:
    """One fitted extrapolation: point prediction + conservative band."""

    family: str              # "pow" | "exp"
    decay: float             # grid decay rate of the winning fit
    n_obs: int
    rmse: float              # residual RMSE on the observed prefix
    predicted_final: float   # point estimate at the trial's last epoch
    band: float              # half-width of the credible band
    horizon: int             # epoch budget the prediction targets

    @property
    def lo(self) -> float:
        return self.predicted_final - self.band

    @property
    def hi(self) -> float:
        return self.predicted_final + self.band

    def to_record(self) -> dict:
        """Journal-ready slice (audit.record_predict and friends)."""
        return {
            "family": self.family,
            "decay": round(self.decay, 6),
            "n_obs": self.n_obs,
            "rmse": round(self.rmse, 9),
            "predicted": round(self.predicted_final, 9),
            "band": round(self.band, 9),
            "lo": round(self.lo, 9),
            "hi": round(self.hi, 9),
            "horizon": self.horizon,
        }


def _basis(epochs: np.ndarray, family: str, c: float) -> np.ndarray:
    if family == "pow":
        return np.power(epochs + 1.0, -c)
    return np.exp(-c * epochs)


def fit_curve(points: Sequence[Tuple[int, float]],
              horizon: int) -> Optional[CurveFit]:
    """Fit the saturating family on (epoch, score) points and
    extrapolate to ``horizon`` epochs. Returns None below 2 points
    (nothing to extrapolate from). Deterministic: same points + horizon
    → bit-identical fit."""
    pts = sorted((int(e), float(s)) for e, s in points
                 if s is not None and math.isfinite(float(s)))
    if len(pts) < 2:
        return None
    e = np.asarray([p[0] for p in pts], dtype=np.float64)
    s = np.asarray([p[1] for p in pts], dtype=np.float64)
    horizon = max(int(horizon), int(e[-1]) + 1)
    best: Optional[CurveFit] = None
    for family in ("pow", "exp"):
        for c in _DECAY_GRID:
            g = _basis(e, family, c)
            # s ≈ a - b*g: linear LSQ in (a, b).
            A = np.column_stack([np.ones_like(g), -g])
            coef, *_ = np.linalg.lstsq(A, s, rcond=None)
            a, b = float(coef[0]), float(coef[1])
            resid = s - (a - b * g)
            rmse = float(np.sqrt(np.mean(resid * resid)))
            if best is not None and rmse >= best.rmse:
                continue
            gT = float(_basis(np.asarray([horizon - 1.0]), family, c)[0])
            pred = a - b * gT
            # Conservative band: residual scale, floored so a perfect
            # 2-point fit never claims certainty, inflated at small n
            # (4/n term) — the kill rule errs toward keeping trials.
            band = max(rmse, 1e-3) * (1.0 + 4.0 / len(pts))
            best = CurveFit(family=family, decay=c, n_obs=len(pts),
                            rmse=rmse, predicted_final=float(pred),
                            band=float(band), horizon=horizon)
    return best


def predict_points(fit: CurveFit,
                   points: Sequence[Tuple[int, float]]) -> List[Tuple[int, float]]:
    """The fitted curve re-evaluated at the observed epochs plus the
    horizon — what ``obs curves --predicted`` overlays."""
    pts = sorted(int(e) for e, _ in points)
    epochs = sorted(set(pts + [fit.horizon - 1]))
    e = np.asarray(epochs, dtype=np.float64)
    g = _basis(e, fit.family, fit.decay)
    # Re-derive (a, b) from prediction identities instead of carrying
    # them: a - b*g(h-1) = predicted_final and the fit minimised rmse,
    # so store both on the record? Cheaper to refit — the grid point is
    # pinned, one lstsq.
    obs = sorted((int(pe), float(ps)) for pe, ps in points)
    eo = np.asarray([p[0] for p in obs], dtype=np.float64)
    so = np.asarray([p[1] for p in obs], dtype=np.float64)
    go = _basis(eo, fit.family, fit.decay)
    A = np.column_stack([np.ones_like(go), -go])
    coef, *_ = np.linalg.lstsq(A, so, rcond=None)
    a, b = float(coef[0]), float(coef[1])
    return [(int(ep), float(a - b * gv)) for ep, gv in zip(epochs, g)]


@dataclasses.dataclass(frozen=True)
class KillConfig:
    """Early-kill rule knobs (``RAFIKI_CURVE_KILL*``, docs/early_kill.md).

    A trial dies at an epoch boundary iff ALL hold:
      * at least ``warmup_epochs`` epochs completed,
      * at least ``min_obs`` curve points observed,
      * a best-so-far score exists, and
      * the fit's UPPER band is below ``best - margin``.
    """

    enabled: bool = False
    warmup_epochs: int = 2
    margin: float = 0.02
    min_obs: int = 3
    speculate: bool = False

    @classmethod
    def from_env(cls) -> "KillConfig":
        enabled = os.environ.get(ENV_KILL, "0") not in ("", "0", "false")
        speculate = os.environ.get(ENV_SPECULATE, "0") not in ("", "0",
                                                               "false")
        return cls(
            enabled=enabled,
            warmup_epochs=int(os.environ.get(ENV_KILL_WARMUP, "2")),
            margin=float(os.environ.get(ENV_KILL_MARGIN, "0.02")),
            min_obs=int(os.environ.get(ENV_KILL_MIN_OBS, "3")),
            speculate=speculate,
        )

    def should_kill(self, fit: Optional[CurveFit], epoch: int,
                    best_so_far: Optional[float]) -> bool:
        if fit is None or best_so_far is None:
            return False
        if epoch + 1 < self.warmup_epochs or fit.n_obs < self.min_obs:
            return False
        return fit.hi < best_so_far - self.margin
