"""Per-hop timestamp marks: the wire format of the request waterfall.

The port's own copy of ``rafiki_tpu/obs/anatomy/hops.py``, with the same
mark codes, segments, metric names and records.

A *mark* is ``[code, ts, pid]`` — a stage code, a ``time.monotonic()``
timestamp and the stamping process id. Monotonic, not wall:
``CLOCK_MONOTONIC`` is system-wide on Linux, so marks stamped by the
gateway, a spawned inference worker and the predictor subtract cleanly
on one host, and NTP steps cannot corrupt a segment. The pid
is the cross-process evidence: a stitched waterfall proves it crossed
process boundaries because its marks carry distinct pids.

Marks ride inside the existing trace envelope (``trace["hops"]``) on
the query leg and as an optional third element of the prediction tuple
on the reply leg — both back-compat the same way the trace
3-tuple was: untraced messages keep their old shapes, old readers
ignore the extra element.

Chain order (full gateway path)::

    admit -> queue -> enq -> deq -> fwds -> fwd|fwdc -> reply -> dec

Each NON-FIRST mark names the segment that *ends* at it; the segment's
duration is its ts minus the previous mark's ts. A standalone
predictor call (no gateway) starts at ``enq`` — still a >=4-hop chain.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs import context as _context
from rafiki_tpu_torch.obs.journal import journal as _journal

#: Mark code -> the segment it terminates. A chain's first mark opens
#: the waterfall; every later mark closes one named segment.
SEGMENT_OF = {
    "queue": "admission_wait",   # gateway admit -> admission grant
    "bat": "gateway_batch_wait",  # admission grant -> microbatch flush
    "enq": "route",              # admission grant -> bus enqueue
    "deq": "bus_queue",          # bus enqueue -> worker dequeue
    "fwds": "batch_wait",        # dequeue -> device forward start
    "fwd": "forward",            # warm device forward
    "fwdc": "forward_cold",      # first forward on this worker (compile)
    "reply": "reply_publish",    # forward end -> put_prediction
    "dec": "gather_decide",      # reply -> predictor quorum/hedge decision
}

SEGMENTS: Tuple[str, ...] = tuple(dict.fromkeys(SEGMENT_OF.values()))

#: Histogram name per segment, precomputed so hot-path observes never
#: build strings (and the name set stays a closed, greppable table of
#: ``serving.hop.*`` rows).
METRIC_OF = {seg: "serving.hop." + seg + "_s" for seg in SEGMENTS}

#: The ensemble fan-out overhead: chain total minus the slowest device
#: forward — everything the k-replica round-trip adds on top of the
#: model itself. Rafiki's headline decomposition.
FANOUT_METRIC = "serving.fanout_cost_s"


def mark(code: str) -> List[Any]:
    """A fresh ``[code, ts, pid]`` mark stamped now."""
    return [code, time.monotonic(), os.getpid()]


# ---------------------------------------------------------------------------
# Gateway-side prefix: marks stamped BEFORE the bus envelope exists.
# ---------------------------------------------------------------------------

_local = threading.local()


def begin() -> None:
    """Open a per-thread mark prefix (gateway request entry). Until
    :func:`clear`, :func:`add` appends to it and the bus envelope
    copies it into ``trace["hops"]``."""
    _local.prefix = []


def add(code: str) -> Optional[List[Any]]:
    """Stamp ``code`` onto the open prefix; no-op (returns None) when
    no prefix is open, so bus users outside the gateway pay nothing."""
    pfx = getattr(_local, "prefix", None)
    if pfx is None:
        return None
    m = mark(code)
    pfx.append(m)
    return m


def prefix_marks() -> List[List[Any]]:
    """A copy of the open prefix (empty when none is open)."""
    pfx = getattr(_local, "prefix", None)
    return list(pfx) if pfx else []


def clear() -> None:
    """Close the prefix. MUST run in the gateway's finally: a stale
    prefix would leak one request's marks into the next chain stitched
    on this thread."""
    _local.prefix = None


# ---------------------------------------------------------------------------
# Segment math + the absorb step (predictor side, post-gather).
# ---------------------------------------------------------------------------

def segments(marks: Iterable[List[Any]]) -> List[Tuple[str, float]]:
    """``[(segment, duration_s), ...]`` for one chain. Unknown codes
    contribute no segment but still advance the clock — so a chain
    with a foreign mark fails hop-sum reconciliation loudly instead of
    silently absorbing the gap into a neighbor."""
    out: List[Tuple[str, float]] = []
    prev_ts: Optional[float] = None
    for m in marks:
        ts = float(m[1])
        seg = SEGMENT_OF.get(m[0])
        if seg is not None and prev_ts is not None:
            out.append((seg, ts - prev_ts))
        prev_ts = ts
    return out


def chain_total_s(marks: List[List[Any]]) -> float:
    """End-to-end span of one chain: last mark ts minus first."""
    if len(marks) < 2:
        return 0.0
    return float(marks[-1][1]) - float(marks[0][1])


def absorb(query_id: str, chains: Dict[str, List[List[Any]]]) -> float:
    """Fold one query's gathered chains (worker id -> full mark list,
    each ending in ``dec``) into the anatomy plane: per-segment
    histograms, the fan-out cost, a ``serving/hops`` journal record,
    and an exemplar-ring offer. Returns the query's total span (the
    slowest chain)."""
    totals: List[float] = []
    fwd_durs: List[float] = []
    bat_durs: List[float] = []
    for marks in chains.values():
        for seg, dur in segments(marks):
            # Dynamic name, drawn from the closed METRIC_OF table above.
            telemetry.observe(METRIC_OF[seg], max(0.0, dur))
            if seg in ("forward", "forward_cold"):
                fwd_durs.append(dur)
            elif seg == "gateway_batch_wait":
                bat_durs.append(dur)
        totals.append(chain_total_s(marks))
    total_s = max(totals) if totals else 0.0
    if fwd_durs:
        # The microbatch coalescing wait is a deliberate latency trade
        # the gateway chose, not fan-out overhead — exclude it so the
        # stacked route's fanout cost measures only what the wire adds.
        waited = max(bat_durs) if bat_durs else 0.0
        telemetry.observe(FANOUT_METRIC,
                          max(0.0, total_s - max(fwd_durs) - waited))
    trace_id = _context.current_trace_id()
    _journal.record("serving", "hops", query_id=query_id,
                    chains=chains, total_s=round(total_s, 6))
    from rafiki_tpu_torch.obs.anatomy import exemplars

    exemplars.ring.offer(total_s, {"query_id": query_id, "chains": chains,
                                   "trace_id": trace_id})
    return total_s
