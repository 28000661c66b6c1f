"""Arrival processes for the twin: synthetic shapes + journal replay.

The port's own copy of ``rafiki_tpu/obs/twin/load.py``.

Synthetic load is a non-homogeneous Poisson process generated by
thinning — one seeded stream draws candidate arrivals at the shape's
peak rate and accepts each with probability ``rate(t)/peak``, so a
fixed seed reproduces the identical arrival sequence regardless of
shape parameters evaluated lazily. Replay load reconstructs arrivals
from ``serving/ts`` rollup rows: each one-second bucket contributes
its ``requests`` count, placed uniformly (seeded) within the bucket —
per-second counts match the captured run exactly.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List

SHAPES = ("constant", "ramp", "spike", "diurnal")

#: Spike shape: offered rate multiplier during the burst window.
SPIKE_FACTOR = 4.0
#: Spike shape: burst occupies the middle this-fraction of the run.
SPIKE_WINDOW_FRAC = 0.1


def _rate_fn(shape: str, qps: float, duration_s: float):
    if shape == "constant":
        return lambda t: qps, qps
    if shape == "ramp":
        lo = 0.1 * qps
        return (lambda t: lo + (qps - lo) * min(1.0, t / duration_s)), qps
    if shape == "spike":
        w0 = duration_s * (0.5 - SPIKE_WINDOW_FRAC / 2)
        w1 = duration_s * (0.5 + SPIKE_WINDOW_FRAC / 2)
        peak = qps * SPIKE_FACTOR
        return (lambda t: peak if w0 <= t < w1 else qps), peak
    if shape == "diurnal":
        # One full "day" over the run: rate swings ±30% around qps.
        return (lambda t: qps * (1.0 + 0.3 * math.sin(
            2 * math.pi * t / duration_s))), qps * 1.3
    raise ValueError(f"unknown load shape {shape!r}; one of {SHAPES}")


def synthesize(shape: str, qps: float, duration_s: float,
               seed: int = 0) -> List[float]:
    """Sorted arrival offsets (seconds from 0) for one synthetic run."""
    if qps <= 0 or duration_s <= 0:
        return []
    rate, peak = _rate_fn(shape, qps, duration_s)
    rng = random.Random(f"{seed}:load:{shape}")
    out: List[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= duration_s:
            break
        if rng.random() < rate(t) / peak:
            out.append(t)
    return out


def replay_from_ts(rows: List[Dict[str, Any]], seed: int = 0) -> List[float]:
    """Arrival offsets reconstructed from ``serving/ts`` rollup rows
    (each row: ``bucket`` index, ``span_s`` width, ``requests`` count
    — obs/anatomy/timeseries.py). The first bucket anchors t=0."""
    rows = [r for r in rows if isinstance(r.get("requests"), int)
            and r["requests"] > 0 and r.get("bucket") is not None]
    if not rows:
        return []
    rows = sorted(rows, key=lambda r: r["bucket"])
    b0 = float(rows[0]["bucket"])
    rng = random.Random(f"{seed}:replay")
    out: List[float] = []
    for r in rows:
        width = float(r.get("span_s") or 1.0)
        off = (float(r["bucket"]) - b0) * width
        out.extend(off + rng.random() * width for _ in range(r["requests"]))
    return sorted(out)
