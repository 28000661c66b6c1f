"""Continuous serving time-series: the per-second rollup.

The port's own copy of ``rafiki_tpu/obs/anatomy/timeseries.py``.

Bench numbers are point-in-time; serving regressions are processes.
``ServingRollup`` buckets every gateway outcome into fixed wall
intervals (1s by default) and, each time a bucket rolls, journals one
``serving/ts`` record: qps, p50/p99 latency, shed rate, outcome
counts, plus whatever live context the owner injects (admission-queue
depth, inflight, per-worker breaker state). ``obs serving`` renders
the rows; the gauges it refreshes (``serving.qps`` etc.) feed the
SLO engine so a hop regression burns an alert, not just a bench
number.

Deterministic by construction: the clock is injectable, latencies per
bucket are bounded (``CAP``), and a bucket's row depends only on what
was observed in it — tests drive a fake clock and get byte-stable
rows.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.journal import journal as _journal

#: Latency samples kept per bucket. At one-second buckets this only
#: truncates past 4k qps, where the percentile is stable anyway.
CAP = 4096


def _pct_ms(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of a sorted seconds list, in ms."""
    if not xs:
        return None
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return round(xs[idx] * 1000.0, 3)


class ServingRollup:
    """Per-bucket outcome/latency aggregation -> ``serving/ts`` rows.

    ``context_fn`` (optional) returns a dict merged into each flushed
    row — the gateway wires admission/breaker state through it. It is
    called OUTSIDE the rollup lock.
    """

    def __init__(self, bucket_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 context_fn: Optional[Callable[[], Dict[str, Any]]] = None):
        self.bucket_s = float(bucket_s)
        self._clock = clock
        self._context_fn = context_fn
        self._lock = threading.Lock()
        self._bucket: Optional[int] = None
        self._lat: List[float] = []
        self._ok = 0
        self._shed = 0
        self._err = 0
        self._flushed = 0
        self._last_row: Dict[str, Any] = {}

    def observe(self, latency_s: Optional[float] = None,
                outcome: str = "ok") -> None:
        """Record one finished request. ``outcome`` is ``ok`` /
        ``shed`` / ``error``; latency only accumulates for ok."""
        row = None
        with self._lock:
            b = int(self._clock() / self.bucket_s)
            if self._bucket is None:
                self._bucket = b
            elif b != self._bucket:
                row = self._close_locked()
                self._bucket = b
            if outcome == "ok":
                self._ok += 1
                if latency_s is not None and len(self._lat) < CAP:
                    self._lat.append(float(latency_s))
            elif outcome == "shed":
                self._shed += 1
            else:
                self._err += 1
        if row is not None:
            self._emit(row)

    def flush(self) -> Optional[Dict[str, Any]]:
        """Force-close the current bucket (teardown — a run shorter
        than ``bucket_s`` would otherwise journal nothing)."""
        with self._lock:
            row = self._close_locked() if self._bucket is not None else None
            self._bucket = None
        if row is not None:
            self._emit(row)
        return row

    def _close_locked(self) -> Optional[Dict[str, Any]]:
        n = self._ok + self._shed + self._err
        if n == 0:
            self._lat = []
            return None
        xs = sorted(self._lat)
        row: Dict[str, Any] = {
            "bucket": self._bucket,
            "span_s": self.bucket_s,
            "requests": n,
            "ok": self._ok,
            "shed": self._shed,
            "errors": self._err,
            "qps": round(n / self.bucket_s, 3),
            "p50_ms": _pct_ms(xs, 50.0),
            "p99_ms": _pct_ms(xs, 99.0),
            "shed_rate": round(self._shed / n, 4),
        }
        self._lat = []
        self._ok = self._shed = self._err = 0
        self._flushed += 1
        self._last_row = row
        return row

    def _emit(self, row: Dict[str, Any]) -> None:
        if self._context_fn is not None:
            try:
                row.update(self._context_fn() or {})
            except Exception:
                pass  # context is garnish; the rollup row must land
        _journal.record("serving", "ts", **row)
        telemetry.set_gauge("serving.qps", row["qps"])
        telemetry.set_gauge("serving.shed_rate", row["shed_rate"])
        if row["p50_ms"] is not None:
            telemetry.set_gauge("serving.p50_ms", row["p50_ms"])
        if row["p99_ms"] is not None:
            telemetry.set_gauge("serving.p99_ms", row["p99_ms"])
        self._last_row = row

    def collector(self) -> Dict[str, Any]:
        """Telemetry collector payload: the last flushed row plus flush
        count — the live ``serving`` block in ``/metrics``."""
        with self._lock:
            return {"buckets_flushed": self._flushed,
                    "last": dict(self._last_row)}
