"""Multi-tenant serving fabric.

Counterpart of ``rafiki_tpu/tenancy``: the serving chain made
tenant-aware end to end.

* :mod:`qos` — QoS classes (``gold``/``std``/``batch``: weight,
  deadline tier, p99 budget) and the tenant->tier directory, all
  ``RAFIKI_TENANT_*`` knobs.
* :mod:`admission` — weighted-fair admission across tenants with
  per-tenant queue/inflight quotas: one tenant's spike sheds THAT
  tenant, never starves another.
* :mod:`accounting` — bounded per-tenant admit/shed/latency/burn
  accounting (``serving.tenant.*`` metrics, ``tenant/*`` journals).
* :mod:`residency` — LRU program residency against an HBM byte budget
  with journaled activate/evict (``tenancy/residency``).
* :mod:`hosting` — ``ProgramHost``: one inference worker serving many
  jobs' models behind the residency manager.
* :mod:`fabric` — ``TenantFabric``, a gateway's opt-in.

Not ported yet: the JAX package's ``tenancy/arbiter.py``.
``JobAdmissionGate`` forecasts a new job through the serving twin and
comes with the twin (ROADMAP Queue 1 item 15); ``tenant_pressure``
feeds only the autoscaler and comes with it (item 14).
"""

from rafiki_tpu_torch.tenancy.qos import (ANON_TENANT, DEFAULT_TIER, TIERS, QosClass,
                                          TenantDirectory)
from rafiki_tpu_torch.tenancy.accounting import BoundedTenantMap, TenantAccounting
from rafiki_tpu_torch.tenancy.admission import TenantAdmissionController
from rafiki_tpu_torch.tenancy.residency import ResidencyManager
from rafiki_tpu_torch.tenancy.hosting import PROGRAM_KEY, ProgramHost, ProgramSpec, wrap_query
from rafiki_tpu_torch.tenancy.fabric import TenantFabric

__all__ = [
    "ANON_TENANT", "DEFAULT_TIER", "TIERS", "QosClass", "TenantDirectory",
    "BoundedTenantMap", "TenantAccounting", "TenantAdmissionController",
    "ResidencyManager", "PROGRAM_KEY", "ProgramHost", "ProgramSpec", "wrap_query",
    "TenantFabric",
]
