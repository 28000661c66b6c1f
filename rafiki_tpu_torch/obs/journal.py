"""Durable per-process event journal: a bounded JSONL ring on disk.

The port's own copy of ``rafiki_tpu/obs/journal.py``. The file names
and the record layout are the JAX package's byte for byte, so either
package's ``read_dir`` and CLI read the other's journals.

Telemetry keeps spans and counters in memory — which is exactly
the evidence that dies with the process when it is killed.
The journal is the durable complement: every finished span, structured
event and gateway decision appends one JSON line to a
per-process file under ``RAFIKI_LOG_DIR``:

    <log_dir>/journal-<role>-<pid>.jsonl

One file per process means no cross-process write interleaving and no
locking beyond the in-process handle lock; readers (``python -m
rafiki_tpu_torch.obs``) merge the
files and sort by timestamp.

*Bounded*: after ``RAFIKI_JOURNAL_MAX`` lines (default 4096) the file
rotates to ``<name>.1`` (overwriting the previous generation), so a
journal never holds more than 2×max records — same philosophy as the
in-memory span ring, applied to disk.

Every record carries ``ts``/``pid``/``role``/``kind``/``name`` plus the
active ``trace_id`` (from :mod:`rafiki_tpu_torch.obs.context`), which is what
lets one gateway query be stitched back together across the gateway
process, the bus, and k inference workers.

Unconfigured, ``record`` is a no-op — library code journals
unconditionally, hosts opt in via ``configure``/``RAFIKI_LOG_DIR``.
This module is dependency-free (stdlib only): telemetry flushes spans
into it, so it must not import telemetry back.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

from rafiki_tpu_torch.obs import context

ENV_VAR = "RAFIKI_LOG_DIR"
ENV_MAX = "RAFIKI_JOURNAL_MAX"
DEFAULT_MAX = 4096


class Journal:
    """Bounded per-process JSONL journal (see module docstring)."""

    def __init__(self, log_dir: Optional[str | os.PathLike] = None,
                 role: str = "proc", max_records: Optional[int] = None):
        self._lock = threading.Lock()
        self._path: Optional[Path] = None
        self._fh = None
        self._count = 0
        self.role = role
        self.max_records = max_records or int(
            os.environ.get(ENV_MAX, DEFAULT_MAX))
        if log_dir is not None:
            self.configure(log_dir, role=role)

    # -- configuration -------------------------------------------------------

    def configure(self, log_dir: str | os.PathLike,
                  role: Optional[str] = None) -> "Journal":
        with self._lock:
            if role:
                self.role = role
            if self._fh is not None:
                self._fh.close()
            d = Path(log_dir)
            d.mkdir(parents=True, exist_ok=True)
            self._path = d / f"journal-{self.role}-{os.getpid()}.jsonl"
            # Re-configuring onto an existing file (same pid, e.g. a
            # worker that re-execs configure) keeps the ring bound.
            if self._path.exists():
                with open(self._path, "rb") as f:
                    self._count = sum(1 for _ in f)
            else:
                self._count = 0
            self._fh = open(self._path, "a", buffering=1)
        return self

    @property
    def path(self) -> Optional[Path]:
        return self._path

    @property
    def log_dir(self) -> Optional[Path]:
        return self._path.parent if self._path is not None else None

    @property
    def configured(self) -> bool:
        return self._fh is not None

    # -- writes --------------------------------------------------------------

    def record(self, kind: str, name: str, **fields: Any) -> None:
        """Append one record; no-op when unconfigured. ``trace_id`` is
        stamped from the active context unless the caller passes one."""
        with self._lock:
            if self._fh is None:
                return
            rec: Dict[str, Any] = {
                "ts": fields.pop("ts", None) or time.time(),
                "pid": os.getpid(),
                "role": self.role,
                "kind": kind,
                "name": name,
            }
            tid = fields.pop("trace_id", None) or context.current_trace_id()
            if tid:
                rec["trace_id"] = tid
            rec.update(fields)
            if self._count >= self.max_records:
                self._rotate_locked()
            self._fh.write(json.dumps(rec, default=str) + "\n")
            self._count += 1

    def _rotate_locked(self) -> None:
        """Shift the live file to the ``.1`` generation (overwriting the
        previous one) and start fresh — bounds disk at 2×max lines."""
        self._fh.close()
        old = self._path.with_name(self._path.name + ".1")
        os.replace(self._path, old)
        self._fh = open(self._path, "a", buffering=1)
        self._count = 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- reads ---------------------------------------------------------------

    def tail(self, n: int = 64) -> List[Dict[str, Any]]:
        """The last ``n`` records of THIS process's journal (both
        generations), oldest first. Used by the flight recorder."""
        if self._path is None:
            return []
        records: List[Dict[str, Any]] = []
        old = self._path.with_name(self._path.name + ".1")
        for p in (old, self._path):
            records.extend(_read_file(p))
        return records[-n:]


def _read_file(path: Path) -> Iterator[Dict[str, Any]]:
    if not path.exists():
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue  # torn line from a crashed writer


def read_dir(log_dir: str | os.PathLike) -> List[Dict[str, Any]]:
    """Merge every journal file (all processes, all generations) under
    ``log_dir``, sorted by timestamp. The CLI reads through this."""
    records: List[Dict[str, Any]] = []
    for p in sorted(glob.glob(str(Path(log_dir) / "journal-*.jsonl*"))):
        records.extend(_read_file(Path(p)))
    records.sort(key=lambda r: r.get("ts", 0.0))
    return records


#: Process-global journal; subsystems record into it unconditionally,
#: hosts opt in via ``journal.configure(dir)`` / RAFIKI_LOG_DIR.
journal = Journal()


def configure_from_env(role: Optional[str] = None) -> bool:
    """Subprocess workers inherit the sink via RAFIKI_LOG_DIR (the
    trace default rides along via RAFIKI_TRACE_ID). Returns True when
    a journal was configured."""
    context.configure_from_env()
    d = os.environ.get(ENV_VAR)
    if d:
        journal.configure(d, role=role)
        return True
    return False
