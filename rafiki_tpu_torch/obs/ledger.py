"""Goodput/cost ledger: where did the fleet's wall-clock go?

The port's own copy of ``rafiki_tpu/obs/ledger.py``.

The telemetry histograms say how long an epoch took; they don't say
who *paid* for it. The ledger does that accounting per entity
(``trial:<id>``, ``pack:<key>``, ``job:<id>``), in buckets of

    compile_s     a loop's first (cold) epoch: program build, the
                  first-call costs, the first graph capture
    step_s        warm-epoch step time — the only bucket that counts
                  as *productive*
    feed_s        host→device feed stalls
    checkpoint_s  checkpoint/persist writes
    downtime_s    death→respawn gaps (no writer in the port yet)
    badput_s      anomaly excess: wall an epoch spent over its EWMA
                  baseline (the perf sentinel's regression charge)

rolled up to ``goodput = productive_step_s / wall_s`` per entity and
fleet-wide. The roll-up is exposed as the ``goodput`` telemetry
collector, so it rides along in every ``GET /metrics`` snapshot.

Charging is ambient: ``with ledger.entity("trial:t1"): ...`` binds the
entity to the thread (nestable — inner entities win), and the training
loop and the checkpoint paths call ``ledger.add(bucket, s)``
without knowing who is currently paying. Unbound charges land on the
``process`` entity so nothing is silently dropped.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.journal import journal as _journal

BUCKETS = ("compile_s", "step_s", "feed_s", "checkpoint_s", "downtime_s",
           "badput_s")

#: Fallback entity for charges made outside any ``entity()`` block.
DEFAULT_ENTITY = "process"


class Ledger:
    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        # entity -> {bucket: seconds, "wall_s": seconds}
        self._entities: Dict[str, Dict[str, float]] = {}

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_entity(self) -> str:
        stack = self._stack()
        return stack[-1] if stack else DEFAULT_ENTITY

    @contextlib.contextmanager
    def entity(self, name: str) -> Iterator[str]:
        """Bind ``name`` as this thread's paying entity; its wall-clock
        accumulates into ``wall_s`` (the goodput denominator)."""
        stack = self._stack()
        stack.append(name)
        t0 = time.monotonic()
        try:
            yield name
        finally:
            dt = time.monotonic() - t0
            stack.pop()
            with self._lock:
                row = self._entities.setdefault(name, {})
                row["wall_s"] = row.get("wall_s", 0.0) + dt
                split = dict(row)
            _journal.record("ledger", name, **{
                k: round(v, 6) for k, v in split.items()})

    def add(self, bucket: str, seconds: float,
            entity: Optional[str] = None) -> None:
        """Charge ``seconds`` to ``bucket`` for ``entity`` (default:
        the thread's bound entity, else ``process``)."""
        if seconds <= 0.0:
            return
        name = entity or self.current_entity()
        with self._lock:
            row = self._entities.setdefault(name, {})
            row[bucket] = row.get(bucket, 0.0) + seconds

    # -- reads ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Per-entity splits plus the fleet roll-up. JSON-able; this is
        the ``goodput`` telemetry collector."""
        with self._lock:
            entities = {name: {k: round(v, 6) for k, v in row.items()}
                        for name, row in self._entities.items()}
        total: Dict[str, float] = {}
        for row in entities.values():
            for k, v in row.items():
                total[k] = total.get(k, 0.0) + v
        for name, row in entities.items():
            wall = row.get("wall_s", 0.0)
            if wall > 0.0:
                row["goodput"] = round(row.get("step_s", 0.0) / wall, 4)
        out: Dict[str, Any] = {
            "entities": entities,
            "total": {k: round(v, 6) for k, v in total.items()},
        }
        wall = total.get("wall_s", 0.0)
        out["goodput"] = (round(total.get("step_s", 0.0) / wall, 4)
                          if wall > 0.0 else None)
        return out

    def reset(self) -> None:
        with self._lock:
            self._entities.clear()


#: Process-global ledger (telemetry scope rules apply: per process).
ledger = Ledger()

telemetry.register_collector("goodput", ledger.snapshot)
