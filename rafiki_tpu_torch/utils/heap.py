"""The serving heap, kept out of the cyclic collector's full scans.

A server's heap is mostly what it imported and built before its first
request: about 220,000 objects in a process that serves VGG16 on the
card. Every full collection of the cyclic collector scans them all and
stalls every thread of the process meanwhile: 124-183 ms on an H100's
host (PERF.md §6), most of a gold tenant's 200 ms budget.
:func:`freeze` collects once, then moves every live object into the
collector's permanent generation (``gc.freeze``), so a full collection
under load scans only what the load allocates. Objects still die by
reference count; cyclic garbage among the frozen objects waits for the
heap to thaw.

Freezes are counted, as services hold them: the heap thaws
(``gc.unfreeze``) when the last holder calls :func:`thaw`. A process
that serves until it is killed freezes once and never thaws.
"""

from __future__ import annotations

import gc
import threading

_lock = threading.Lock()
_holders = 0


def freeze() -> None:
    """Collect, then freeze every live object; one more holder."""
    global _holders
    with _lock:
        _holders += 1
        gc.collect()
        gc.freeze()


def thaw() -> None:
    """One holder fewer; the last one thaws the heap."""
    global _holders
    with _lock:
        if _holders == 0:
            return
        _holders -= 1
        if _holders == 0:
            gc.unfreeze()


def holders() -> int:
    with _lock:
        return _holders
