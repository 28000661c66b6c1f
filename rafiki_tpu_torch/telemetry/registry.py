"""Process-wide metrics registry: counters, gauges, histograms.

Design constraints (ISSUE 1):
  * thread-safe — trial worker threads, the predictor's HTTP threads,
    heartbeat daemons and the bench's serving threads all write
    concurrently; one registry lock is plenty at this event rate
    (every write is a dict update, far off any hot device path);
  * bounded memory — histograms keep a fixed-size reservoir
    (Vitter's algorithm R), never the full observation stream;
  * pull-based re-export — subsystems with their own counters (the
    program cache in ops/train.py) register a *collector* callable and
    the snapshot inlines its dict, so legacy stats surface through the
    same endpoint without double bookkeeping.

Everything is plain floats/ints/strings, so ``snapshot()`` is always
``json.dumps``-able — the contract the ``/metrics`` endpoints and
BENCH artifacts rely on.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class Histogram:
    """Count/sum/min/max plus a bounded reservoir for percentiles."""

    __slots__ = ("count", "sum", "min", "max", "_reservoir", "_cap", "_rng")

    def __init__(self, reservoir_cap: int = 512):
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._cap = reservoir_cap
        self._reservoir: List[float] = []
        # Seeded per-histogram: reservoir contents are reproducible in
        # tests and never consume the global random stream.
        self._rng = random.Random(0x5EED)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self._reservoir) < self._cap:
            self._reservoir.append(v)
        else:  # algorithm R: each of the n observations keeps cap/n odds
            i = self._rng.randrange(self.count)
            if i < self._cap:
                self._reservoir[i] = v

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "count": self.count,
            "sum": round(self.sum, 6),
            "min": self.min,
            "max": self.max,
            "mean": round(self.sum / self.count, 6) if self.count else None,
        }
        if self._reservoir:
            xs = sorted(self._reservoir)
            last = len(xs) - 1
            for p in (50, 90, 99):
                out[f"p{p}"] = xs[min(last, int(last * p / 100))]
        return out


class Registry:
    """Thread-safe named metrics with a JSON-able snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self._collectors: Dict[str, Callable[[], Dict[str, Any]]] = {}

    # -- writes --------------------------------------------------------------

    def inc(self, name: str, n: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def add_gauge(self, name: str, delta: float) -> None:
        with self._lock:
            self._gauges[name] = self._gauges.get(name, 0.0) + delta

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = Histogram()
            hist.observe(value)

    def register_collector(self, name: str,
                           fn: Callable[[], Dict[str, Any]]) -> None:
        """Attach a pull-based stats source; its dict appears verbatim
        under ``name`` in every snapshot. Re-registering replaces."""
        with self._lock:
            self._collectors[name] = fn

    # -- reads ---------------------------------------------------------------

    def get_counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def get_gauge(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "ts": time.time(),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.summary() for k, h in self._hists.items()},
            }
            collectors = list(self._collectors.items())
        # Collectors run OUTSIDE the registry lock: they may take their
        # own locks (program cache) and must not deadlock against a
        # metric write from under them.
        for name, fn in collectors:
            try:
                out[name] = fn()
            except Exception as e:  # a broken collector can't break /metrics
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def reset(self, clear_collectors: bool = False) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            if clear_collectors:
                self._collectors.clear()
