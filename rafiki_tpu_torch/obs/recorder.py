"""Flight recorder: dump the last-N observability ring on the way down.

The port's own copy of ``rafiki_tpu/obs/recorder.py``.

When a process dies — unhandled exception, SIGTERM from a drain,
Ctrl-C — its in-memory spans and metrics die
with it. The flight recorder writes one self-contained JSON file into
the journal directory at that moment:

    <log_dir>/flight-<role>-<pid>-<seq>.json

containing the dump reason, the active trace, the last-N finished span
records, the journal tail, and a full telemetry snapshot.

``install()`` chains — it calls the previous ``sys.excepthook`` /
signal handler after dumping, so behavior (exit codes, tracebacks,
KeyboardInterrupt) is unchanged. SIGKILL cannot be caught by design.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs import context
from rafiki_tpu_torch.obs.journal import ENV_VAR, journal

#: Span records kept in a dump (the journal tail is bounded the same).
TAIL_N = 256

_seq_lock = threading.Lock()
_seq = 0
_installed = False
_dumping = False


def _next_seq() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


def dump(reason: str, log_dir: Optional[str | os.PathLike] = None,
         extra: Optional[Dict[str, Any]] = None) -> Optional[Path]:
    """Write one flight record; returns its path, or None when no
    journal directory is known (nowhere durable to write). Never
    raises — this runs on the failure path."""
    global _dumping
    d = log_dir or journal.log_dir or os.environ.get(ENV_VAR)
    if not d:
        return None
    if _dumping:  # re-entrant fatal during a dump: give up quietly
        return None
    _dumping = True
    try:
        payload: Dict[str, Any] = {
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "role": journal.role,
            "trace_id": context.current_trace_id(),
            "spans": telemetry.span_records()[-TAIL_N:],
            "journal_tail": journal.tail(TAIL_N),
            "telemetry": telemetry.snapshot(),
        }
        if extra:
            payload.update(extra)
        d = Path(d)
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"flight-{journal.role}-{os.getpid()}-{_next_seq()}.json"
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
        journal.record("flight", reason, path=str(path))
        return path
    except Exception:
        return None  # the failure path must not fail louder
    finally:
        _dumping = False


def install(log_dir: Optional[str | os.PathLike] = None) -> bool:
    """Chain the flight recorder into ``sys.excepthook`` and the
    SIGTERM/SIGINT handlers. Main-thread only (signal API constraint);
    returns False when called from elsewhere or already installed."""
    global _installed
    if _installed or threading.current_thread() is not threading.main_thread():
        return False

    prev_hook = sys.excepthook

    def _hook(exc_type, exc, tb):
        dump(f"fatal:{exc_type.__name__}", log_dir=log_dir)
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _hook

    for signum, label in ((signal.SIGTERM, "sigterm"),
                          (signal.SIGINT, "sigint")):
        prev = signal.getsignal(signum)

        def _handler(sig, frame, _prev=prev, _label=label):
            dump(_label, log_dir=log_dir)
            if callable(_prev):
                _prev(sig, frame)
            else:  # SIG_DFL: restore and re-deliver so the exit
                   # status stays the conventional 128+sig
                signal.signal(sig, signal.SIG_DFL)
                os.kill(os.getpid(), sig)

        signal.signal(signum, _handler)

    _installed = True
    return True
