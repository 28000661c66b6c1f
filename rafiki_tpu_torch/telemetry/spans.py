"""Lightweight span tracer: where did this trial's wall-clock go?

``span("trial.train", trial_id=...)`` is a nestable context manager.
Nesting is tracked per thread (worker threads each carry their own
stack), so a span records its parent's name and depth — enough to
reassemble a trial's phase tree from the flat JSONL export without a
distributed-tracing dependency.

Costs: two ``time`` calls plus one locked deque append per span — spans
wrap phases (compile, epoch, persist, gather), never per-step device
work.

Exports:
  * per-name aggregates (count / total_s / min / max) for snapshots;
  * a bounded ring of finished span records for ``dump_jsonl`` — old
    spans fall off instead of growing the process (same philosophy as
    the bus's expired-query ring).

Port note: the JAX package also stamps each span with the active trace
id and copies it into the durable journal; the port has neither plane
yet, so spans stay in-process.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional


class Span:
    """Context manager recording one timed, possibly-nested phase."""

    __slots__ = ("name", "tags", "_tracer", "_t0", "_start_ts",
                 "_parent", "_span_id", "_parent_id")

    def __init__(self, tracer: "Tracer", name: str, tags: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.tags = tags
        self._t0 = 0.0
        self._start_ts = 0.0
        self._parent: Optional[str] = None
        self._span_id = ""
        self._parent_id: Optional[str] = None

    @property
    def span_id(self) -> str:
        return self._span_id

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        if stack:
            self._parent, self._parent_id = stack[-1]
        self._span_id = uuid.uuid4().hex[:16]
        stack.append((self.name, self._span_id))
        self._start_ts = time.time()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.monotonic() - self._t0
        stack = self._tracer._stack()
        if stack and stack[-1][0] == self.name:
            stack.pop()
        self._tracer._record(self, dur, error=exc_type is not None)
        return False  # never swallow


class Tracer:
    _RECORD_CAP = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        # name -> [count, total_s, min_s, max_s]
        self._agg: Dict[str, List[float]] = {}
        self._records: "deque[Dict[str, Any]]" = deque(maxlen=self._RECORD_CAP)

    def _stack(self) -> list:
        """Per-thread stack of (name, span_id) tuples for open spans."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_span_id(self) -> Optional[str]:
        """The innermost open span's id on this thread (trace
        propagation: the bus envelope carries it as parent_span)."""
        stack = self._stack()
        return stack[-1][1] if stack else None

    def span(self, name: str, **tags: Any) -> Span:
        return Span(self, name, tags)

    def _record(self, span: Span, dur_s: float, error: bool) -> None:
        rec: Dict[str, Any] = {
            "type": "span",
            "name": span.name,
            "ts": span._start_ts,
            "dur_s": round(dur_s, 6),
            "parent": span._parent,
            "span_id": span._span_id,
            "parent_id": span._parent_id,
        }
        if span.tags:
            rec["tags"] = span.tags
        if error:
            rec["error"] = True
        with self._lock:
            agg = self._agg.get(span.name)
            if agg is None:
                self._agg[span.name] = [1, dur_s, dur_s, dur_s]
            else:
                agg[0] += 1
                agg[1] += dur_s
                agg[2] = min(agg[2], dur_s)
                agg[3] = max(agg[3], dur_s)
            self._records.append(rec)

    # -- reads ---------------------------------------------------------------

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "count": int(c),
                    "total_s": round(total, 6),
                    "min_s": round(mn, 6),
                    "max_s": round(mx, 6),
                }
                for name, (c, total, mn, mx) in self._agg.items()
            }

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def reset(self) -> None:
        with self._lock:
            self._agg.clear()
            self._records.clear()
