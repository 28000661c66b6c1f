"""Trace context: one id that survives process boundaries.

The port's own copy of ``rafiki_tpu/obs/context.py``, unchanged in
behaviour: the same thread-local stack, process default and
``RAFIKI_TRACE_ID`` adoption, so a trace id minted by either package
reads the same in the other's journals.

A *trace* is one logical unit of work as the user sees it — one gateway
query, one trial, one train job — regardless of how many processes it
crosses. The context here is deliberately tiny: a ``trace_id`` string
carried in (a) a per-thread slot for in-process propagation, (b) bus
message envelopes for the serving path, and (c) the ``RAFIKI_TRACE_ID``
environment variable for spawned worker processes.

This module is dependency-free (stdlib only) on purpose: telemetry
imports it to stamp span records, so it must not import telemetry back.

Usage::

    from rafiki_tpu_torch.obs import context

    with context.trace():                 # new trace at the edge
        ...                               # spans/journal records inherit it

    with context.trace(incoming_id):      # continue a propagated trace
        ...

    context.set_process_trace(tid)        # whole-process default (workers)
"""

from __future__ import annotations

import contextlib
import os
import threading
import uuid
from typing import Iterator, Optional

ENV_VAR = "RAFIKI_TRACE_ID"

_tls = threading.local()
#: Process-wide default, used when no thread-local trace is active —
#: spawned workers inherit the job trace this way (set from ENV_VAR).
_process_trace: Optional[str] = None


def new_trace_id() -> str:
    """A fresh 32-hex-char trace id."""
    return uuid.uuid4().hex


def current_trace_id() -> Optional[str]:
    """The active trace id: thread-local first, then the process
    default, else None (untraced work)."""
    tid = getattr(_tls, "trace_id", None)
    if tid is not None:
        return tid
    return _process_trace


def set_process_trace(trace_id: Optional[str]) -> None:
    """Set the process-wide default trace (worker startup)."""
    global _process_trace
    _process_trace = trace_id


@contextlib.contextmanager
def trace(trace_id: Optional[str] = None) -> Iterator[str]:
    """Bind ``trace_id`` (or a fresh one) to this thread for the
    duration of the block. Nesting restores the outer binding."""
    tid = trace_id or current_trace_id() or new_trace_id()
    prev = getattr(_tls, "trace_id", None)
    _tls.trace_id = tid
    try:
        yield tid
    finally:
        _tls.trace_id = prev


def configure_from_env() -> None:
    """Adopt the spawning process's trace via RAFIKI_TRACE_ID."""
    tid = os.environ.get(ENV_VAR)
    if tid:
        set_process_trace(tid)


# -- tenant context -----------------------------------------------------------
# The tenant id rides exactly like the trace id: bound at the serving
# edge (gateway / HTTP header), carried per-thread, stamped into bus
# envelopes by queues._current_trace so worker-side journal records can
# attribute work to a tenant. Unlike traces,
# there is no fresh-id fallback — untagged work stays tenant-less.

def current_tenant() -> Optional[str]:
    """The active tenant id, or None for untagged work."""
    return getattr(_tls, "tenant_id", None)


@contextlib.contextmanager
def tenant_scope(tenant: Optional[str]) -> Iterator[Optional[str]]:
    """Bind ``tenant`` to this thread for the duration of the block
    (None binds nothing but still restores the outer value)."""
    prev = getattr(_tls, "tenant_id", None)
    _tls.tenant_id = tenant if tenant is not None else prev
    try:
        yield tenant
    finally:
        _tls.tenant_id = prev
