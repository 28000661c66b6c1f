"""Slowest-N exemplar ring: full waterfalls for the requests that
percentile summaries erase.

The port's own copy of ``rafiki_tpu/obs/anatomy/exemplars.py``.

A p99 histogram says *that* the tail is slow, never *why*. The ring
keeps the complete hop chains of the slowest N requests per time
window; when a window rolls (or :func:`ExemplarRing.flush` forces it)
the retained exemplars are journaled as ``serving/exemplar`` records —
so ``obs tails`` can show the actual anatomy of the worst requests,
not just their rank.

Bounded by construction: at most ``cap`` exemplars retained at any
moment, sorted slowest-first, windows sized in seconds. Both knobs are
env-tunable (``RAFIKI_EXEMPLAR_N``, ``RAFIKI_EXEMPLAR_WINDOW_S``).

The trace id is captured at *offer* time and journaled explicitly: a
window rolls during some LATER request's offer, and letting the
journal stamp that request's ambient trace onto these records would
mis-attribute every exemplar in the window.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.journal import journal as _journal

ENV_CAP = "RAFIKI_EXEMPLAR_N"
ENV_WINDOW = "RAFIKI_EXEMPLAR_WINDOW_S"
DEFAULT_CAP = 8
DEFAULT_WINDOW_S = 30.0


class ExemplarRing:
    """Slowest-``cap`` full-waterfall retention per ``window_s`` window.

    ``clock`` is injectable (monotonic by default) so window-roll tests
    are deterministic.
    """

    def __init__(self, cap: Optional[int] = None,
                 window_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if cap is None:
            cap = int(os.environ.get(ENV_CAP, DEFAULT_CAP))
        if window_s is None:
            window_s = float(os.environ.get(ENV_WINDOW, DEFAULT_WINDOW_S))
        self.cap = max(1, int(cap))
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._window_start: Optional[float] = None
        self._items: List[Tuple[float, Dict[str, Any]]] = []
        self._offered = 0
        self._windows_flushed = 0

    def offer(self, total_s: float, record: Dict[str, Any]) -> None:
        """Consider one finished request for retention. ``record`` must
        carry ``query_id`` / ``chains`` (and ideally ``trace_id``)."""
        rolled: List[Tuple[float, Dict[str, Any]]] = []
        with self._lock:
            now = self._clock()
            if self._window_start is None:
                self._window_start = now
            elif now - self._window_start >= self.window_s:
                rolled, self._items = self._items, []
                self._window_start = now
                self._windows_flushed += 1
            self._offered += 1
            self._items.append((float(total_s), record))
            self._items.sort(key=lambda it: it[0], reverse=True)
            del self._items[self.cap:]
        if rolled:
            self._journal_items(rolled)

    def flush(self) -> int:
        """Force the current window closed (bench/smoke teardown —
        otherwise a run shorter than ``window_s`` journals nothing).
        Returns how many exemplars were journaled."""
        with self._lock:
            items, self._items = self._items, []
            self._window_start = None
            if items:
                self._windows_flushed += 1
        self._journal_items(items)
        return len(items)

    def _journal_items(self,
                       items: List[Tuple[float, Dict[str, Any]]]) -> None:
        for rank, (total_s, rec) in enumerate(items):
            _journal.record("serving", "exemplar", rank=rank,
                            total_s=round(total_s, 6),
                            query_id=rec.get("query_id"),
                            chains=rec.get("chains"),
                            trace_id=rec.get("trace_id"))

    def collector(self) -> Dict[str, Any]:
        """Telemetry collector payload — numeric-only so the prom
        flattener keeps every leaf."""
        with self._lock:
            out: Dict[str, Any] = {
                "retained": len(self._items),
                "offered": self._offered,
                "windows_flushed": self._windows_flushed,
                "cap": self.cap,
                "window_s": self.window_s,
            }
            if self._items:
                out["slowest_s"] = round(self._items[0][0], 6)
            return out


#: Process-global ring, mirroring the journal/telemetry singletons:
#: the predictor's absorb step and bench teardown must agree on one.
ring = ExemplarRing()
telemetry.register_collector("serving_exemplars", ring.collector)
