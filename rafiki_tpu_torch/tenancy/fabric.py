"""TenantFabric: the bundle a gateway opts into tenancy with.

The port's own copy of ``rafiki_tpu/tenancy/fabric.py``: one object
wiring the per-gateway tenancy pieces together: the directory (who maps
to which tier), weighted-fair admission (built against the gateway's
capacity knobs) and bounded accounting (metrics and journals), which it
registers as the ``tenants`` telemetry collector.
``Gateway(..., tenancy=TenantFabric())`` is the whole opt-in; a gateway
without a fabric behaves as before.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.tenancy.accounting import TenantAccounting
from rafiki_tpu_torch.tenancy.admission import TenantAdmissionController
from rafiki_tpu_torch.tenancy.qos import TenantDirectory


class TenantFabric:
    """Directory + admission + accounting for one gateway."""

    def __init__(self, directory: Optional[TenantDirectory] = None,
                 register_collector: bool = True):
        self.directory = directory or TenantDirectory()
        self.accounting = TenantAccounting(self.directory)
        self.admission: Optional[TenantAdmissionController] = None
        if register_collector:
            telemetry.register_collector("tenants",
                                         self.accounting.collector)

    def build_admission(self, max_inflight: int,
                        max_queue: int) -> TenantAdmissionController:
        """The gateway calls this in place of constructing a plain
        AdmissionController — same capacity knobs, tenant-aware."""
        self.admission = TenantAdmissionController(
            self.directory, max_inflight=max_inflight, max_queue=max_queue)
        return self.admission

    def sensors(self) -> Dict[str, Any]:
        """Tenant additions to the gateway's sensor snapshot."""
        return {
            "tenant_burn": round(self.accounting.max_burn(), 4),
            "tenant_shed_rate": round(self.accounting.shed_rate(), 4),
            "tenants_tracked": len(self.accounting.per_tenant()),
        }
