"""EWMA+MAD anomaly detection for step/compile wall times.

The port's own copy of ``rafiki_tpu/obs/perf/anomaly.py``, unchanged.

The regression sentinel's core primitive: an exponentially weighted
moving average tracks the expected value of a timing series, and an
EWMA of absolute deviations (a robust MAD stand-in that needs no
sample buffer) tracks its spread. After a warmup count, a sample above

    mean + k * max(mad, floor_frac * mean)

is an anomaly. The MAD floor matters: a perfectly steady series has
mad -> 0, and without the floor any scheduler hiccup would alert.

Anomalous samples are absorbed at a quarter of the normal learning
rate, so a genuine sustained regression *eventually* becomes the new
baseline (one alert per shift, not one per epoch forever) while a
single spike barely moves the stats.

Detectors hold a few floats each; the profiler keys one per program
(bounded by its program-entry cap). No threads — callers
serialize access (the train loop records epochs from one thread).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

#: Samples absorbed before the detector is allowed to flag.
DEFAULT_WARMUP = 8
#: Threshold multiplier on the deviation estimate.
DEFAULT_K = 4.0
#: EWMA learning rate.
DEFAULT_ALPHA = 0.25
#: Deviation floor as a fraction of the mean (see module docstring).
DEFAULT_FLOOR_FRAC = 0.10

ENV_WARMUP = "RAFIKI_PERF_WARMUP"
ENV_K = "RAFIKI_PERF_K"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class EwmaMad:
    """One timing series' anomaly state (see module docstring)."""

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 k: Optional[float] = None,
                 warmup: Optional[int] = None,
                 floor_frac: float = DEFAULT_FLOOR_FRAC):
        self.alpha = alpha
        self.k = k if k is not None else _env_float(ENV_K, DEFAULT_K)
        self.warmup = int(warmup if warmup is not None
                          else _env_float(ENV_WARMUP, DEFAULT_WARMUP))
        self.floor_frac = floor_frac
        self.n = 0
        self.mean: Optional[float] = None
        self.mad = 0.0

    def threshold(self) -> Optional[float]:
        """Current alert threshold, or None before any sample."""
        if self.mean is None:
            return None
        return self.mean + self.k * max(self.mad, self.floor_frac * self.mean)

    def observe(self, value: float) -> Optional[Dict[str, float]]:
        """Absorb one sample; returns an anomaly report dict (value,
        mean, mad, threshold, ratio) when it fires, else None."""
        value = float(value)
        if self.mean is None:
            self.mean = value
            self.n = 1
            return None
        thr = self.threshold()
        anomalous = self.n >= self.warmup and thr is not None and value > thr
        report = None
        if anomalous:
            report = {
                "value": value,
                "mean": self.mean,
                "mad": self.mad,
                "threshold": thr,
                "ratio": value / self.mean if self.mean > 0 else float("inf"),
            }
        a = self.alpha * (0.25 if anomalous else 1.0)
        self.mad = (1 - a) * self.mad + a * abs(value - self.mean)
        self.mean = (1 - a) * self.mean + a * value
        self.n += 1
        return report
