"""Bounded per-tenant accounting.

The port's own copy of ``rafiki_tpu/tenancy/accounting.py``
(``BoundedTenantMap``, ``TenantAccounting``). Everything the fleet knows
about a tenant at runtime lives here: admit/shed counters, a rolling
latency window, and the SLO-burn ratio against the tenant's tier
budget. Two rules:

* **Bounded state.** Tenant ids arrive from the network; a stream of
  fresh ids must not grow server memory. Every per-tenant structure of
  the package hangs off :class:`BoundedTenantMap`, an LRU-evicting dict
  capped at ``RAFIKI_TENANT_MAX_TENANTS``.
* **Journal-first evidence.** The ``noisy-neighbor-shed`` chaos gate
  proves isolation from per-tenant journals alone: ``tenant/admit``
  (admission grant, with the wait), ``tenant/request`` (completion, with
  the caller-observed latency), ``tenant/shed`` (denial, with the
  reason), and a ``tenant/summary`` flush that ``obs tenants --check``
  reconciles against the per-record tallies.

Metrics: the aggregates ``serving.tenant.admitted`` /
``serving.tenant.shed`` / ``serving.tenant.shed_<tier>`` and the
``serving.tenant.burn`` gauge (the worst burn across tenants).
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.journal import journal as _journal
from rafiki_tpu_torch.tenancy.qos import TenantDirectory

#: Rolling latency window per tenant — enough for a stable p99 at
#: test scale without unbounded growth.
LATENCY_WINDOW = 512


class BoundedTenantMap:
    """An LRU-evicting ``tenant_id -> value`` map with a hard cap.

    The one container for per-tenant runtime state: inserting tenant
    ``cap+1`` evicts the least-recently touched entry, so memory is
    O(cap) no matter how many distinct tenant ids a client invents.
    Reads refresh recency.
    """

    def __init__(self, cap: int, factory: Optional[Callable[[], Any]] = None):
        self.cap = max(1, int(cap))
        self._factory = factory
        self._data: "OrderedDict[str, Any]" = OrderedDict()

    def get(self, tenant: str) -> Any:
        """The tenant's slot, created via the factory on first touch."""
        slot = self._data.get(tenant)
        if slot is None:
            if self._factory is None:
                return None
            slot = self._factory()
            self._data[tenant] = slot
            while len(self._data) > self.cap:
                self._data.popitem(last=False)
                telemetry.inc("tenant.accounting_evictions")
        else:
            self._data.move_to_end(tenant)
        return slot

    def peek(self, tenant: str) -> Any:
        """Read without creating (and without refreshing recency)."""
        return self._data.get(tenant)

    def items(self):
        return list(self._data.items())

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._data


class _TenantStats:
    __slots__ = ("admitted", "shed", "ok", "errors", "shed_reasons",
                 "latencies_s", "waited_s")

    def __init__(self):
        self.admitted = 0
        self.shed = 0
        self.ok = 0
        self.errors = 0
        self.shed_reasons: Dict[str, int] = {}
        self.latencies_s: deque = deque(maxlen=LATENCY_WINDOW)
        self.waited_s = 0.0


def _p99(values: List[float]) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))]


def _p50(values: List[float]) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    return ordered[len(ordered) // 2]


class TenantAccounting:
    """Per-tenant admit/shed/latency/burn ledger behind a lock.

    One instance per gateway; the gateway calls :meth:`admitted`,
    :meth:`completed` and :meth:`shed` on the request path and
    :meth:`flush` at drain. ``collector()`` registers under the
    ``tenants`` telemetry section so the Prometheus exposition carries
    the per-tenant serving state.
    """

    def __init__(self, directory: TenantDirectory):
        self.directory = directory
        self._lock = threading.Lock()
        self._stats = BoundedTenantMap(directory.max_tenants, _TenantStats)

    # -- request path --------------------------------------------------------

    def admitted(self, tenant: str, waited_s: float) -> None:
        tier = self.directory.tier_of(tenant)
        with self._lock:
            st = self._stats.get(tenant)
            st.admitted += 1
            st.waited_s += waited_s
        telemetry.inc("serving.tenant.admitted")
        _journal.record("tenant", "admit", tenant=tenant, tier=tier.name,
                        waited_s=round(waited_s, 6))

    def completed(self, tenant: str, e2e_s: float, ok: bool) -> None:
        with self._lock:
            st = self._stats.get(tenant)
            st.latencies_s.append(e2e_s)
            if ok:
                st.ok += 1
            else:
                st.errors += 1
        telemetry.set_gauge("serving.tenant.burn", self.max_burn())
        _journal.record("tenant", "request", tenant=tenant,
                        e2e_s=round(e2e_s, 6), ok=bool(ok))

    def shed(self, tenant: str, reason: str) -> None:
        with self._lock:
            st = self._stats.get(tenant)
            st.shed += 1
            st.shed_reasons[reason] = st.shed_reasons.get(reason, 0) + 1
        telemetry.inc("serving.tenant.shed")
        telemetry.inc(f"serving.tenant.shed_{self.directory.tier_of(tenant).name}")
        _journal.record("tenant", "shed", tenant=tenant, reason=reason,
                        tier=self.directory.tier_of(tenant).name)

    # -- burn ----------------------------------------------------------------

    def burn(self, tenant: str) -> float:
        """p99 over the tier's budget: >1.0 means the tenant's latency
        promise is burning."""
        tier = self.directory.tier_of(tenant)
        with self._lock:
            st = self._stats.peek(tenant)
            lat = list(st.latencies_s) if st is not None else []
        if not lat:
            return 0.0
        return (_p99(lat) * 1000.0) / max(tier.p99_budget_ms, 1e-9)

    def max_burn(self) -> float:
        with self._lock:
            tenants = [t for t, _ in self._stats.items()]
        return max((self.burn(t) for t in tenants), default=0.0)

    def shed_rate(self) -> float:
        """Fleet-wide tenant shed fraction."""
        with self._lock:
            admitted = sum(st.admitted for _, st in self._stats.items())
            shed = sum(st.shed for _, st in self._stats.items())
        total = admitted + shed
        return (shed / total) if total else 0.0

    # -- introspection -------------------------------------------------------

    def per_tenant(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            rows = {}
            for tenant, st in self._stats.items():
                lat = list(st.latencies_s)
                rows[tenant] = {
                    "tier": self.directory.tier_of(tenant).name,
                    "admitted": st.admitted,
                    "ok": st.ok,
                    "errors": st.errors,
                    "shed": st.shed,
                    "shed_reasons": dict(st.shed_reasons),
                    "p50_ms": round(_p50(lat) * 1000.0, 3),
                    "p99_ms": round(_p99(lat) * 1000.0, 3),
                    "shed_rate": round(
                        st.shed / (st.admitted + st.shed), 4)
                        if (st.admitted + st.shed) else 0.0,
                }
        for tenant, row in rows.items():
            row["burn"] = round(self.burn(tenant), 4)
        return rows

    def collector(self) -> Dict[str, Any]:
        rows = self.per_tenant()
        return {
            "tracked": len(rows),
            "admitted": telemetry.get_counter("serving.tenant.admitted"),
            "shed": telemetry.get_counter("serving.tenant.shed"),
            "max_burn": round(self.max_burn(), 4),
            "per_tenant": rows,
        }

    def flush(self) -> None:
        """Journal the counter summary (``tenant/summary``) —
        ``obs tenants --check`` reconciles these totals against the
        per-record admit/shed tallies."""
        rows = self.per_tenant()
        _journal.record("tenant", "summary",
                        tenants={t: {"admitted": r["admitted"],
                                     "shed": r["shed"],
                                     "p99_ms": r["p99_ms"],
                                     "burn": r["burn"]}
                                 for t, r in rows.items()})
