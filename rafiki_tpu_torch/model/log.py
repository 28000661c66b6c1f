"""Trial-time model logger.

The port's own copy of ``rafiki_tpu/model/log.py``: models call
``logger.define_plot(...)`` and ``logger.log(epoch=, loss=)`` during
``train()``; a worker routes a thread's entries into a sink with
``logger.capture(sink)``. Outside a capture, entries go to the
standard ``logging`` module. Entries are dicts ``{"time": ...,
"type": "message" | "values" | "plot", ...}``.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

_py_logger = logging.getLogger("rafiki_tpu_torch.model")

LogEntry = Dict[str, Any]
Sink = Callable[[LogEntry], None]


class ModelLogger:
    """The ``logger`` object importable by model templates."""

    def __init__(self):
        self._local = threading.local()

    def _sink(self) -> Optional[Sink]:
        return getattr(self._local, "sink", None)

    def _emit(self, entry: LogEntry) -> None:
        entry.setdefault("time", time.time())
        sink = self._sink()
        if sink is not None:
            sink(entry)
        else:
            _py_logger.info("%s", entry)

    def log(self, msg: str = "", **values) -> None:
        """``logger.log("message")`` or ``logger.log(epoch=3, loss=0.1)``."""
        if msg:
            self._emit({"type": "message", "message": str(msg)})
        if values:
            self._emit({"type": "values", "values": values})

    def define_plot(self, title: str, metrics: List[str], x_axis: Optional[str] = None) -> None:
        self._emit({"type": "plot", "title": title, "metrics": list(metrics), "x_axis": x_axis})

    @contextlib.contextmanager
    def capture(self, sink: Sink):
        """Route this thread's log entries into ``sink`` for the duration."""
        prev = self._sink()
        self._local.sink = sink
        try:
            yield
        finally:
            self._local.sink = prev


logger = ModelLogger()
