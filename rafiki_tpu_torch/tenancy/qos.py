"""QoS classes and the tenant directory.

The port's own copy of ``rafiki_tpu/tenancy/qos.py``. A *tenant* is the
unit of isolation: one user, team or job stream sharing the fleet with
everyone else. Every tenant maps to one of three QoS tiers:

    gold   interactive traffic: short deadline, largest admission
           weight, tight p99 budget
    std    the default tier
    batch  throughput traffic: long deadline, smallest weight, loose
           budget; first to shed under pressure

A tier is three numbers. ``weight`` is the weighted-fair admission
share (``admission.py`` grants a freed slot to the waiting tenant with
the lowest inflight/weight charge, so a weight-4 gold tenant gets 4x a
weight-1 batch tenant's share under contention: proportional, not
absolute, priority). ``deadline_s`` is the default request deadline when
the caller sends none. ``p99_budget_ms`` is the tier's latency promise:
the per-tenant burn and the ``noisy-neighbor-shed`` chaos gate measure
against it.

Knobs:

    RAFIKI_TENANT_TIERS          tenant->tier map, "alice=gold,bob=batch"
    RAFIKI_TENANT_DEFAULT_TIER   tier for unmapped tenants (std)
    RAFIKI_TENANT_GOLD_WEIGHT    admission weight per tier
    RAFIKI_TENANT_STD_WEIGHT
    RAFIKI_TENANT_BATCH_WEIGHT
    RAFIKI_TENANT_QUOTA_FRAC     per-tenant cap as a fraction of the
                                 gateway's inflight/queue capacity
    RAFIKI_TENANT_MAX_TENANTS    bound on tracked per-tenant state
    RAFIKI_TENANT_UNWEIGHTED     polarity knob: weights and quotas off
                                 (the doctored run that shows the
                                 isolation gate can fail)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

ENV_PREFIX = "RAFIKI_TENANT_"

#: Tenant charged when the caller sent no tenant id: anonymous traffic
#: shares one bucket (and one quota) instead of bypassing isolation.
#: Lives here (the dependency-free leaf of the package) so the gateway
#: can import it without an import cycle.
ANON_TENANT = "anon"

#: Bound on per-tenant accounting/admission state fleet-wide. Tenants
#: beyond the cap still get served (at the default tier) — only their
#: per-tenant counters are subject to LRU eviction (accounting.py).
DEFAULT_MAX_TENANTS = 64

#: Per-tenant cap as a fraction of gateway capacity: with 0.5, one
#: tenant can use at most half the queue and half the inflight slots,
#: so a flood leaves the other half to everyone else.
DEFAULT_QUOTA_FRAC = 0.5


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(ENV_PREFIX + name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(ENV_PREFIX + name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def unweighted() -> bool:
    """Whether weighted-fair admission is DISABLED (quotas off, all
    weights equal): the doctored polarity, under which the victim-p99
    gate of ``noisy-neighbor-shed`` must fail."""
    return os.environ.get(ENV_PREFIX + "UNWEIGHTED", "").lower() in (
        "1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class QosClass:
    """One QoS tier: the admission weight, the default deadline, and
    the latency promise the tier sells."""

    name: str
    weight: float
    deadline_s: float
    p99_budget_ms: float


def TIERS() -> Dict[str, QosClass]:
    """The three tiers with env-overridable weights. A function, not a
    module constant, so tests and the doctored polarity can flip knobs
    per process without import-order traps."""
    if unweighted():
        gold = std = batch = 1.0
    else:
        gold = _env_float("GOLD_WEIGHT", 4.0)
        std = _env_float("STD_WEIGHT", 2.0)
        batch = _env_float("BATCH_WEIGHT", 1.0)
    return {
        "gold": QosClass("gold", weight=gold, deadline_s=2.0,
                         p99_budget_ms=200.0),
        "std": QosClass("std", weight=std, deadline_s=5.0,
                        p99_budget_ms=500.0),
        "batch": QosClass("batch", weight=batch, deadline_s=30.0,
                          p99_budget_ms=5000.0),
    }


DEFAULT_TIER = "std"


class TenantDirectory:
    """Resolves ``tenant_id`` → :class:`QosClass`.

    The mapping comes from RAFIKI_TENANT_TIERS ("alice=gold,bob=batch")
    or an explicit dict; unmapped tenants get the default tier. The
    directory is immutable after construction — per-tenant RUNTIME
    state (counters, queues) lives in accounting/admission behind
    bounded maps, never here, so an adversarial stream of fresh tenant
    ids cannot grow this object.
    """

    def __init__(self, tiers: Optional[Dict[str, str]] = None,
                 default_tier: Optional[str] = None,
                 quota_frac: Optional[float] = None,
                 max_tenants: Optional[int] = None):
        self._classes = TIERS()
        self.default_tier = (default_tier
                             or os.environ.get(ENV_PREFIX + "DEFAULT_TIER",
                                               DEFAULT_TIER))
        if self.default_tier not in self._classes:
            self.default_tier = DEFAULT_TIER
        self._map: Dict[str, str] = {}
        raw = (tiers if tiers is not None
               else _parse_tiers(os.environ.get(ENV_PREFIX + "TIERS", "")))
        for tenant, tier in raw.items():
            if tier in self._classes:
                self._map[tenant] = tier
        self.quota_frac = (quota_frac if quota_frac is not None
                           else _env_float("QUOTA_FRAC", DEFAULT_QUOTA_FRAC))
        self.unweighted = unweighted()
        if self.unweighted:
            self.quota_frac = 1.0  # doctored polarity: no per-tenant cap
        self.quota_frac = min(1.0, max(0.05, self.quota_frac))
        self.max_tenants = (max_tenants if max_tenants is not None
                            else _env_int("MAX_TENANTS", DEFAULT_MAX_TENANTS))

    def tier_of(self, tenant: Optional[str]) -> QosClass:
        """The tenant's QoS class (default tier for None/unmapped)."""
        name = self._map.get(tenant or "", self.default_tier)
        return self._classes[name]

    def known_tenants(self) -> Dict[str, str]:
        return dict(self._map)


def _parse_tiers(raw: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        tenant, _, tier = part.partition("=")
        out[tenant.strip()] = tier.strip().lower()
    return out
