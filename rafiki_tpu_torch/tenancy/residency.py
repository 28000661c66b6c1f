"""LRU program residency against an HBM byte budget.

The port's own copy of ``rafiki_tpu/tenancy/residency.py``. Co-hosting
many models in one worker works only if the worker never keeps more
program state resident than the card has memory for.
:class:`ResidencyManager` is the gatekeeper: programs activate through
it, it charges each one's byte estimate against the budget
(RAFIKI_TENANT_HBM_BUDGET_MB, default 512), and when an activation
would overflow it evicts least-recently-USED residents first, calling
the evicted program's ``destroy()``. On the card the destroy runs under
the card's lock (``ops/graphs.py card_lock``), so freeing a program's
tensors cannot reach another thread's graph capture.

Every transition journals ``tenancy/residency`` (event = ``activate`` /
``evict`` / ``hit``), so a co-hosted worker's swap history replays from
journals alone. The loader runs only on a miss, so a params fetch (a
CAS manifest's chunks, ``store/cas.py``) happens once per residency,
not once per request.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.journal import journal as _journal

#: Default HBM budget for co-hosted programs when the caller sizes none
#: (RAFIKI_TENANT_HBM_BUDGET_MB).
DEFAULT_HBM_BUDGET_MB = 512


def default_budget_bytes() -> int:
    raw = os.environ.get("RAFIKI_TENANT_HBM_BUDGET_MB")
    try:
        mb = int(raw) if raw else DEFAULT_HBM_BUDGET_MB
    except ValueError:
        mb = DEFAULT_HBM_BUDGET_MB
    return max(1, mb) * 1024 * 1024


class _Resident:
    __slots__ = ("program", "size_bytes", "activations")

    def __init__(self, program: Any, size_bytes: int):
        self.program = program
        self.size_bytes = size_bytes
        self.activations = 1


class ResidencyManager:
    """LRU cache of live programs keyed by program id, budgeted in
    bytes. ``activate`` is the only entry: a hit refreshes recency, a
    miss runs the loader (evicting LRU residents until the new program
    fits) and journals the swap."""

    def __init__(self, budget_bytes: Optional[int] = None):
        self.budget_bytes = (default_budget_bytes()
                             if budget_bytes is None else int(budget_bytes))
        self._lock = threading.Lock()
        self._residents: "OrderedDict[str, _Resident]" = OrderedDict()
        self._used = 0

    def activate(self, key: str, size_bytes: int,
                 loader: Callable[[], Any]) -> Any:
        """The resident program for ``key``, loading (and evicting)
        as needed. ``size_bytes`` is the program's HBM charge; a
        program larger than the whole budget is refused."""
        with self._lock:
            res = self._residents.get(key)
            if res is not None:
                self._residents.move_to_end(key)
                res.activations += 1
                telemetry.inc("tenancy.residency_hits")
                _journal.record("tenancy", "residency", event="hit",
                                program=key)
                return res.program
            size_bytes = max(0, int(size_bytes))
            if size_bytes > self.budget_bytes:
                raise MemoryError(
                    f"program {key} ({size_bytes}B) exceeds the HBM "
                    f"residency budget ({self.budget_bytes}B)")
            while self._used + size_bytes > self.budget_bytes:
                self._evict_lru_locked(for_program=key)
            t0 = time.monotonic()
            program = loader()
            # load_s rides the residency record itself: a span here would
            # nest inside the caller's forward span and count the load twice.
            load_s = time.monotonic() - t0
            self._residents[key] = _Resident(program, size_bytes)
            self._used += size_bytes
            telemetry.inc("tenancy.residency_misses")
            telemetry.set_gauge("tenancy.residency_used_bytes", self._used)
            _journal.record("tenancy", "residency", event="activate",
                            program=key, size_bytes=size_bytes,
                            used_bytes=self._used,
                            budget_bytes=self.budget_bytes,
                            load_s=round(load_s, 6))
            return program

    def _evict_lru_locked(self, for_program: str) -> None:
        if not self._residents:
            raise MemoryError(
                f"HBM residency budget ({self.budget_bytes}B) cannot "
                f"fit program {for_program} even with nothing resident")
        # Every caller (activate, drain) holds self._lock.
        key, res = self._residents.popitem(last=False)
        self._used -= res.size_bytes
        destroy = getattr(res.program, "destroy", None)
        if callable(destroy):
            # Imported here: the tenancy package itself imports no torch.
            from rafiki_tpu_torch.ops.graphs import card_lock

            try:
                with card_lock(res.program):
                    destroy()
            except Exception:
                pass  # eviction must not fail on a broken destroy hook
        telemetry.inc("tenancy.residency_evictions")
        telemetry.set_gauge("tenancy.residency_used_bytes", self._used)
        _journal.record("tenancy", "residency", event="evict",
                        program=key, size_bytes=res.size_bytes,
                        used_bytes=self._used, for_program=for_program)

    def drain(self) -> None:
        """Evict every resident (host shutdown), journaling each."""
        with self._lock:
            while self._residents:
                self._evict_lru_locked(for_program="shutdown")

    # -- introspection -------------------------------------------------------

    def resident_keys(self):
        with self._lock:
            return list(self._residents)

    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "resident": len(self._residents),
                "used_bytes": self._used,
                "budget_bytes": self.budget_bytes,
                "hits": telemetry.get_counter("tenancy.residency_hits"),
                "misses": telemetry.get_counter("tenancy.residency_misses"),
                "evictions": telemetry.get_counter(
                    "tenancy.residency_evictions"),
            }
