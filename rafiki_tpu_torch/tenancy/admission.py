"""Weighted-fair tenant admission.

The port's own copy of ``rafiki_tpu/tenancy/admission.py``:
:class:`TenantAdmissionController` extends the gateway's admission
controller (bounded inflight + bounded deadline-aware queue) with what
tenant isolation needs:

* **Per-tenant quotas.** One tenant may hold at most
  ``quota_frac x max_inflight`` slots and ``quota_frac x max_queue``
  queue positions. A flooding tenant exhausts ITS queue quota and sheds
  with reason ``tenant_quota``, charged to the flooder, while the rest
  of the queue stays open to everyone else.
* **Weighted-fair granting.** When a slot frees, it goes to the waiting
  tenant with the lowest ``inflight / weight`` charge (FIFO within a
  tenant), so a gold tenant (weight 4) gets 4x a batch tenant's share
  under contention; batch still progresses.

With ``RAFIKI_TENANT_UNWEIGHTED=1`` (the doctored polarity) quotas
widen to the whole gateway and granting degrades to global FIFO: the
single-tenant behaviour, which fails the victim-p99 gate.

Per-tenant state here is bounded: idle tenant slots (no inflight, no
waiters) are pruned once the tracked-tenant cap is exceeded.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Dict, Optional

from rafiki_tpu_torch.gateway.admission import AdmissionController, ShedError
from rafiki_tpu_torch.tenancy.qos import ANON_TENANT, TenantDirectory


class _TenantSlot:
    __slots__ = ("inflight", "waiters")

    def __init__(self):
        self.inflight = 0
        self.waiters: deque = deque()  # arrival seq tickets, FIFO

    def idle(self) -> bool:
        return self.inflight == 0 and not self.waiters


class TenantAdmissionController(AdmissionController):
    """Drop-in for :class:`AdmissionController` with tenant-aware
    ``admit``/``release`` (the tenant-less signature still works —
    untagged traffic lands in the shared anonymous bucket)."""

    def __init__(self, directory: TenantDirectory,
                 max_inflight: int = 8, max_queue: int = 32):
        super().__init__(max_inflight=max_inflight, max_queue=max_queue)
        self.directory = directory
        frac = directory.quota_frac
        self.quota_inflight = max(1, int(math.ceil(max_inflight * frac)))
        self.quota_queue = (max(1, int(math.ceil(self.max_queue * frac)))
                            if self.max_queue else 0)
        self._slots: Dict[str, _TenantSlot] = {}
        self._seq = 0

    # -- fairness ------------------------------------------------------------

    def _slot(self, tenant: str) -> _TenantSlot:
        slot = self._slots.get(tenant)
        if slot is None:
            slot = _TenantSlot()
            self._slots[tenant] = slot
            self._prune_locked()
        return slot

    def _prune_locked(self) -> None:
        """Bound per-tenant state: drop idle slots beyond the cap
        (insertion order ≈ LRU at this cadence). Never drops a slot
        with live inflight or waiters — counts must stay exact."""
        cap = self.directory.max_tenants
        if len(self._slots) <= cap:
            return
        for tenant in [t for t, s in self._slots.items() if s.idle()]:
            self._slots.pop(tenant, None)
            if len(self._slots) <= cap:
                break

    def _charge(self, tenant: str, slot: _TenantSlot) -> float:
        weight = max(self.directory.tier_of(tenant).weight, 1e-9)
        return slot.inflight / weight

    def _chosen_tenant(self) -> Optional[str]:
        """The tenant whose head waiter gets the next free slot.

        Weighted mode: the eligible (waiting, under inflight quota)
        tenant with the lowest inflight/weight charge, oldest arrival
        breaking ties. Unweighted (doctored) mode: global FIFO — the
        tenant owning the oldest waiter, quota ignored.
        """
        eligible = [(t, s) for t, s in self._slots.items() if s.waiters]
        if not eligible:
            return None
        if getattr(self.directory, "unweighted", False):
            return min(eligible, key=lambda ts: ts[1].waiters[0])[0]
        eligible = [(t, s) for t, s in eligible
                    if s.inflight < self.quota_inflight]
        if not eligible:
            return None
        return min(eligible,
                   key=lambda ts: (self._charge(*ts), ts[1].waiters[0]))[0]

    # -- admission -----------------------------------------------------------

    def admit(self, deadline: float, retry_after_s: float = 1.0,
              tenant: Optional[str] = None) -> float:
        tenant = tenant or ANON_TENANT
        unweighted = getattr(self.directory, "unweighted", False)
        t0 = time.monotonic()
        with self._cv:
            if self._closed:
                raise ShedError("draining", retry_after_s)
            slot = self._slot(tenant)
            if (self._inflight < self.max_inflight and self._waiting == 0
                    and (unweighted
                         or slot.inflight < self.quota_inflight)):
                self._inflight += 1
                slot.inflight += 1
                return 0.0
            # Quota shed order matters: the per-tenant check runs FIRST
            # so a flooder exhausts tenant_quota (charged to itself)
            # before it can fill the shared queue and charge queue_full
            # to everyone.
            if (not unweighted and self.quota_queue
                    and len(slot.waiters) >= self.quota_queue):
                raise ShedError("tenant_quota", retry_after_s)
            if self._waiting >= self.max_queue:
                raise ShedError("queue_full", retry_after_s)
            if time.monotonic() >= deadline:
                raise ShedError("deadline", retry_after_s)
            self._seq += 1
            ticket = self._seq
            slot.waiters.append(ticket)
            self._waiting += 1
            try:
                while True:
                    if self._closed:
                        raise ShedError("draining", retry_after_s)
                    if (self._inflight < self.max_inflight
                            and slot.waiters[0] == ticket
                            and self._chosen_tenant() == tenant):
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise ShedError("deadline", retry_after_s)
                    self._cv.wait(remaining)
                self._inflight += 1
                slot.inflight += 1
            finally:
                try:
                    slot.waiters.remove(ticket)
                except ValueError:
                    pass
                self._waiting -= 1
                # A shed/deadline exit may unblock a DIFFERENT tenant
                # (we might have been the chosen head).
                self._cv.notify_all()
        return time.monotonic() - t0

    def release(self, tenant: Optional[str] = None) -> None:
        tenant = tenant or ANON_TENANT
        with self._cv:
            self._inflight -= 1
            slot = self._slots.get(tenant)
            if slot is not None:
                slot.inflight = max(0, slot.inflight - 1)
            self._prune_locked()
            self._cv.notify_all()

    # -- introspection -------------------------------------------------------

    def tenant_inflight(self, tenant: str) -> int:
        with self._cv:
            slot = self._slots.get(tenant)
            return slot.inflight if slot is not None else 0

    def tenant_waiting(self, tenant: str) -> int:
        with self._cv:
            slot = self._slots.get(tenant)
            return len(slot.waiters) if slot is not None else 0
