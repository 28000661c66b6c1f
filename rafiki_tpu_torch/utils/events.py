"""Structured JSONL event stream.

The port's own copy of ``rafiki_tpu/utils/events.py``. Every lifecycle
transition (job/trial/service) appends one JSON object per line to
``<logs_dir>/events.jsonl``, and is mirrored into the per-process
journal (``kind="event"``; a no-op unless the process journals).

Append semantics: each process opens the file in append mode and
writes whole lines; on POSIX, O_APPEND writes of < PIPE_BUF bytes are
atomic, so subprocess workers can share the file with the scheduler
without interleaving corruption.

Usage::

    from rafiki_tpu_torch.utils.events import events
    events.configure(logs_dir)          # once per process (optional)
    events.emit("trial_completed", trial_id=..., score=...)

Unconfigured, ``emit`` is a no-op, so library code can emit
unconditionally.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Iterator, Optional

from rafiki_tpu_torch.obs.journal import journal as _journal


class EventLog:
    def __init__(self, logs_dir: Optional[str | os.PathLike] = None,
                 filename: str = "events.jsonl"):
        self._lock = threading.Lock()
        self._path: Optional[Path] = None
        self._fh = None
        self.filename = filename
        if logs_dir is not None:
            self.configure(logs_dir)

    def configure(self, logs_dir: str | os.PathLike) -> "EventLog":
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            path = Path(logs_dir) / self.filename
            path.parent.mkdir(parents=True, exist_ok=True)
            self._path = path
            self._fh = open(path, "a", buffering=1)  # line-buffered append
        return self

    @property
    def path(self) -> Optional[Path]:
        return self._path

    def emit(self, event: str, **fields: Any) -> None:
        # Mirror into the per-process journal so trial lifecycle and
        # checkpoint events land in the same stream spans do.
        _journal.record("event", event, **fields)
        with self._lock:
            if self._fh is None:
                return
            record = {"time": time.time(), "event": event,
                      "pid": os.getpid(), **fields}
            self._fh.write(json.dumps(record, default=str) + "\n")

    def read(self, event: Optional[str] = None) -> Iterator[dict]:
        """Iterate recorded events (optionally filtered by type)."""
        if self._path is None or not self._path.exists():
            return
        with open(self._path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn line from a crashed writer
                if event is None or rec.get("event") == event:
                    yield rec

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


#: Process-global event log; workers/schedulers emit into it
#: unconditionally, hosts opt in via ``events.configure(logs_dir)``.
events = EventLog()


def configure_from_env() -> None:
    """Subprocess workers inherit the sink through RAFIKI_EVENTS_DIR."""
    d = os.environ.get("RAFIKI_EVENTS_DIR")
    if d:
        events.configure(d)
