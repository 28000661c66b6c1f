"""The scale actuator surface.

The port's own copy of ``rafiki_tpu/autoscale/actuators.py``.

Only code inside ``rafiki_tpu_torch.autoscale`` calls into this
module. Every other path to capacity change goes through
:class:`~rafiki_tpu_torch.autoscale.controller.AutoscaleController`, so
ad-hoc code cannot bypass hysteresis, cooldowns, or flap damping —
an undamped actuator is a flap amplifier.

Two lanes:

  * :class:`InferenceWorkerLane` — worker count behind the serving
    gateway. Scale-down honours the drain→reap→freed ordering
    contract: a drained worker's slot is NOT counted free until (1)
    its inflight replies flushed (the worker's ``drained`` event), and
    (2) its liveness lease has left the bus (graceful
    ``remove_worker``, or the janitor reap for a worker that died
    mid-drain). In the port the services manager's replica then frees
    its model: ``model.destroy()`` under ``ops/graphs.py card_lock``,
    which for a stacked replica drops its captured forward and its
    pool (``admin/services_manager.py _free_scale_replica``). Without
    the contract, the controller re-scales against
    phantom capacity and the gateway fans out to a corpse.
  * :class:`SweepChipLane` — chip count of a live mesh sweep, through
    :class:`rafiki_tpu_torch.scheduler.mesh.ElasticHandle` (the supervisor
    applies deltas with the existing elastic re-pack machinery; on one
    card a mesh's chips are (index, device) pairs on ``cuda:0``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Tuple

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.journal import journal as _journal

# (worker_id, worker, thread) — what spawn_fn returns per replica.
SpawnResult = Tuple[str, Any, Optional[threading.Thread]]


class InferenceWorkerLane:
    """Inference-lane actuator over a bus + a spawn callable.

    ``spawn_fn(index) -> (worker_id, worker, thread)`` must start the
    replica (thread running ``worker.run()``); the lane waits for its
    bus registration before counting it. ``initial`` seeds the lane
    with replicas spawned before the controller attached (the
    services-manager path). ``free_fn(worker_id, worker, thread)``, when
    given, frees a drained replica once its lease is gone and its
    thread joined, before the slot counts free (the services manager
    destroys its model there, under the card's lock).
    """

    def __init__(self, bus: Any, job_id: str,
                 spawn_fn: Callable[[int], SpawnResult],
                 initial: Optional[List[SpawnResult]] = None,
                 register_timeout_s: float = 5.0,
                 drain_timeout_s: float = 10.0,
                 poll_s: float = 0.02,
                 free_fn: Optional[Callable[[str, Any, Optional[threading.Thread]], None]]
                 = None):
        self.bus = bus
        self.job_id = job_id
        self._spawn_fn = spawn_fn
        self._entries: List[SpawnResult] = list(initial or [])
        self._spawned = len(self._entries)
        self._register_timeout_s = register_timeout_s
        self._drain_timeout_s = drain_timeout_s
        self._poll_s = poll_s
        self._free_fn = free_fn
        self._lock = threading.RLock()
        # Ordering audit for the drain→reap→freed regression test:
        # ("drained"|"reaped"|"freed", worker_id) in observed order.
        self.events: List[Tuple[str, str]] = []

    def size(self) -> int:
        with self._lock:
            return len(self._entries)

    def worker_ids(self) -> List[str]:
        with self._lock:
            return [wid for wid, _, _ in self._entries]

    def scale_to(self, n: int) -> None:
        with self._lock:
            while len(self._entries) < n:
                self._spawn_one()
            while len(self._entries) > n:
                self._drain_one()

    def _spawn_one(self) -> None:
        # Re-entered under scale_to's RLock; holding it again keeps the
        # mutation-under-lock contract visible in each step.
        with self._lock:
            index = self._spawned
            self._spawned += 1
            wid, worker, thread = self._spawn_fn(index)
            deadline = time.monotonic() + self._register_timeout_s
            while wid not in self.bus.get_workers(self.job_id):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"worker {wid} never registered on the bus")
                time.sleep(self._poll_s)
            self._entries.append((wid, worker, thread))
            telemetry.inc("autoscale.workers_spawned")
            _journal.record("autoscale", "spawn", job_id=self.job_id,
                            worker_id=wid, size=len(self._entries))

    def _drain_one(self) -> None:
        with self._lock:
            # Victim = newest replica: the oldest carry the warmed
            # compiles.
            wid, worker, thread = self._entries[-1]
            worker.stop()
            # (1) inflight replies flush: the worker sets ``drained``
            # only after its serve loop exited and it left the bus —
            # every already-popped query has had its prediction
            # published.
            drained = getattr(worker, "drained", None)
            if drained is not None:
                drained.wait(self._drain_timeout_s)
            self.events.append(("drained", wid))
            # (2) lease gone: graceful exit removes it synchronously; a
            # worker that died mid-drain ages out via the janitor reap
            # (get_workers reaps corpses on sight). Only then is the
            # slot free — re-scaling before this double-counts capacity.
            deadline = time.monotonic() + self._drain_timeout_s
            while wid in self.bus.get_workers(self.job_id):
                if time.monotonic() >= deadline:
                    telemetry.inc("autoscale.drain_timeouts")
                    break
                time.sleep(self._poll_s)
            self.events.append(("reaped", wid))
            if thread is not None:
                thread.join(self._drain_timeout_s)
            if self._free_fn is not None:
                self._free_fn(wid, worker, thread)
            self._entries.pop()
            self.events.append(("freed", wid))
            telemetry.inc("autoscale.workers_drained")
            _journal.record("autoscale", "drain", job_id=self.job_id,
                            worker_id=wid, size=len(self._entries))


class SweepChipLane:
    """Sweep-lane actuator over a mesh ElasticHandle. The handle is
    asynchronous — the supervisor applies deltas at its next poll — so
    ``size()`` reports desired capacity (live + pending delta) to keep
    the controller's view consistent between polls."""

    def __init__(self, handle: Any):
        self._handle = handle

    def size(self) -> int:
        return int(self._handle.desired())

    def scale_to(self, n: int) -> None:
        delta = int(n) - self.size()
        if delta:
            self._handle.request(delta)
