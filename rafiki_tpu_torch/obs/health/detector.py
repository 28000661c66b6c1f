"""Divergence detection: the host half of the numerics health plane.

The port's own copy of the serial half of
``rafiki_tpu/obs/health/detector.py``. A :class:`HealthMonitor` lives
on each ``TrainLoop`` and reads the epoch-boundary sentinel scalars
(``obs/health/sentinel.py``). Two trip conditions:

* **nonfinite** - any non-finite gradient/loss element this epoch (or
  a non-finite global grad norm). Trips at once: NaNs never heal.
* **explosion** - the epoch's max grad norm exceeds ``RAFIKI_HEALTH_K``
  times the trial's running median for ``RAFIKI_HEALTH_HYSTERESIS``
  consecutive epochs, after ``RAFIKI_HEALTH_WARMUP`` clean epochs of
  history. Exploded samples are not absorbed into the median.

On a trip the monitor bumps ``health.divergences`` and returns a
verdict; the loop raises :class:`DivergenceError` with it.

Left out until their planes are ported: the journal record, the
badput ledger charge, the flight record and replay capsules
(``snapshot_state`` returns None, as the JAX package's does with
capsules off), and the pack half (``observe_pack``, ``evict_member``,
``admit_member``).
"""

from __future__ import annotations

import math
import os
import statistics
import time
from collections import deque
from typing import Any, Dict, Optional

from rafiki_tpu_torch import telemetry

#: Kill switch for detection ("0"/"off" disables it; the per-step
#: bundle still runs).
ENV_ENABLE = "RAFIKI_HEALTH"
#: Grad-norm explosion multiplier over the trial's running median.
ENV_K = "RAFIKI_HEALTH_K"
#: Clean epochs of history required before the explosion arm is live.
ENV_WARMUP = "RAFIKI_HEALTH_WARMUP"
#: Consecutive exploding epochs required to trip (nonfinite ignores this).
ENV_HYSTERESIS = "RAFIKI_HEALTH_HYSTERESIS"

DEFAULT_K = 50.0
DEFAULT_WARMUP = 3
DEFAULT_HYSTERESIS = 2
_HISTORY = 32


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _on(name: str) -> bool:
    return os.environ.get(name, "1").strip().lower() not in (
        "0", "off", "false", "no")


class DivergenceError(RuntimeError):
    """A serial trial's numerics diverged; carries the verdict dict
    (kind, bad_step, diagnosis) for the caller to surface."""

    def __init__(self, verdict: Dict[str, Any]):
        super().__init__(verdict.get("diagnosis", "numerics diverged"))
        self.verdict = verdict


class HealthMonitor:
    """Per-loop divergence detector for one serial trial."""

    def __init__(self, key: str):
        self.key = str(key)
        self.history: deque = deque(maxlen=_HISTORY)
        self.streak = 0
        self.bank = 0.0  # wall-clock this trial has consumed so far
        self.tripped = False
        self._ctx: Optional[Dict[str, Any]] = None
        self.enabled = _on(ENV_ENABLE)
        self.explosion_k = _env_float(ENV_K, DEFAULT_K)
        self.warmup = max(1, _env_int(ENV_WARMUP, DEFAULT_WARMUP))
        self.hysteresis = max(1, _env_int(ENV_HYSTERESIS, DEFAULT_HYSTERESIS))

    def set_context(self, **ctx: Any) -> None:
        """Trial context from the model layer (``model`` identity dict,
        ``train_uri``, ``batch_size``, ``seed``, ``planned_steps``);
        it rides in the verdict."""
        self._ctx = dict(self._ctx or {}, **ctx)

    def snapshot_state(self, state: Any) -> None:
        """The pre-epoch state copy a replay capsule would need. The port
        has no capsules yet, so no copy is taken."""
        return None

    def _median_bar(self) -> Optional[float]:
        if len(self.history) < self.warmup:
            return None
        median = statistics.median(self.history)
        return self.explosion_k * median if median > 0.0 else None

    def _classify(self, health: Dict[str, float]) -> Optional[str]:
        gn = float(health.get("health_grad_norm", 0.0))
        nf = int(health.get("health_nonfinite", 0))
        if nf > 0 or not math.isfinite(gn):
            return "nonfinite"
        bar = self._median_bar()
        if bar is not None and gn > bar and self.streak + 1 >= self.hysteresis:
            return "explosion"
        return None

    def observe(self, health: Dict[str, float], *, t0: Optional[float] = None,
                epoch_seed: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Epoch boundary: returns a verdict dict on a trip, else None."""
        if not self.enabled or not health:
            return None
        if t0 is not None:
            self.bank += time.monotonic() - t0
        if self.tripped:
            return None
        kind = self._classify(health)
        if kind is None:
            bar = self._median_bar()
            if bar is not None and float(health.get("health_grad_norm", 0.0)) > bar:
                self.streak += 1  # above the bar but under the hysteresis
            else:
                self.streak = 0
                self.history.append(float(health.get("health_grad_norm", 0.0)))
            return None
        return self._trip(kind, health, epoch_seed)

    def _diagnosis(self, kind: str, health: Dict[str, float]) -> str:
        gn = float(health.get("health_grad_norm", float("nan")))
        if kind == "nonfinite":
            return (f"non-finite numerics at step "
                    f"{int(health.get('health_bad_step', -1))}: "
                    f"{int(health.get('health_nonfinite', 0))} bad elements, "
                    f"grad_norm={gn:.4g}")
        median = statistics.median(self.history) if self.history else 0.0
        return (f"grad-norm explosion: {gn:.4g} > {self.explosion_k:g}x "
                f"running median {median:.4g} "
                f"({self.hysteresis} consecutive epochs)")

    def _trip(self, kind: str, health: Dict[str, float],
              epoch_seed: Optional[int]) -> Dict[str, Any]:
        self.tripped = True
        telemetry.inc("health.divergences")
        return {
            "divergence": kind,
            "key": self.key,
            "member": None,
            "bad_step": int(health.get("health_bad_step", -1)),
            "epoch_seed": epoch_seed,
            "grad_norm": float(health.get("health_grad_norm", float("nan"))),
            "update_norm": float(health.get("health_update_norm", float("nan"))),
            "nonfinite": int(health.get("health_nonfinite", 0)),
            "badput_s": round(self.bank, 6),
            "capsule": None,
            "context": dict(self._ctx or {}),
            "diagnosis": self._diagnosis(kind, health),
        }
