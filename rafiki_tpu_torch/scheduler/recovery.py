"""Failure detection and recovery of orphaned trials.

The port's own copy of ``recover_orphaned_trials`` and
``_RecoveryAdvisor`` from ``rafiki_tpu/scheduler/recovery.py``
(docs/recovery.md). Workers heartbeat their service row (between
trials, and within a trial through its epoch-log sink);
``MetaStore.get_orphaned_trials`` finds RUNNING trials whose service
died or went silent, and ``recover_orphaned_trials`` re-adopts each and
re-runs it, from its newest mid-trial checkpoint when one exists, on
the card unless the caller passes the CPU in ``devices``.

``stale_after_s`` must exceed the longest epoch: heartbeats inside a
trial come once per epoch. Not ported yet: the whole-sweep resume
(``resume_sweep``) and its journal reader, with the mesh sweep; the
recovery advisor does not journal the feedback it routes.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

from rafiki_tpu_torch.constants import ServiceStatus, ServiceType
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.events import events
from rafiki_tpu_torch.worker.train import build_worker_from_store


class _RecoveryAdvisor:
    """Advisor handle for adopted trials: their knobs are chosen
    already, so ``propose`` is refused; a score is routed to ``inner``
    when one is given (a live advisor of the job), else dropped."""

    def __init__(self, inner=None):
        self._inner = inner

    def propose(self):
        raise RuntimeError("Recovery workers do not propose new trials")

    def propose_batch(self, n: int):
        raise RuntimeError("Recovery workers do not propose new trials")

    def feedback(self, score: float, knobs) -> None:
        if self._inner is not None:
            self._inner.feedback(score, knobs)


def recover_orphaned_trials(
    store: MetaStore,
    params_store: ParamsStore,
    stale_after_s: float = 60.0,
    sub_train_job_id: Optional[str] = None,
    devices: Optional[List[Any]] = None,
    advisor=None,
    orphans: Optional[List[dict]] = None,
) -> List[dict]:
    """Find and re-run every orphaned trial; returns their final rows.

    Every orphan is claimed up front by the compare-and-swap
    ``adopt_trial``, so a sweep racing this one adopts each orphan at
    most once between them. While earlier re-runs execute, a beater
    thread keeps the queued claims' heartbeats fresh; each worker takes
    over its own heartbeat (its epoch sink) before its re-run starts, so
    a re-run that hangs goes stale and can be adopted again. Each
    recovery service is stopped after its run. Safe to call
    periodically.
    """
    orphans = orphans if orphans is not None \
        else store.get_orphaned_trials(stale_after_s, sub_train_job_id)
    if not isinstance(advisor, _RecoveryAdvisor):
        advisor = _RecoveryAdvisor(advisor)
    claimed = []
    for trial in orphans:
        service = store.create_service(ServiceType.TRAIN_WORKER.value)
        worker_id = f"recovery-{trial['id'][:8]}"
        if not store.adopt_trial(trial["id"], trial.get("service_id"), service["id"],
                                 worker_id, expected_status=trial.get("status")):
            # Lost the race (another sweep adopted it, or its worker
            # finished after all): leave it alone.
            store.update_service(service["id"], status=ServiceStatus.STOPPED.value)
            continue
        events.emit("trial_orphan_detected", trial_id=trial["id"],
                    worker_id=trial.get("worker_id"))
        store.update_service(service["id"], heartbeat=True)
        claimed.append((trial, service, worker_id))

    pending = {svc["id"] for _, svc, _ in claimed}
    pending_lock = threading.Lock()
    stop_beat = threading.Event()

    def beat() -> None:
        interval = max(0.05, min(stale_after_s / 4.0, 5.0))
        while not stop_beat.wait(interval):
            with pending_lock:
                ids = list(pending)
            for sid in ids:
                store.update_service(sid, heartbeat=True)

    beater = threading.Thread(target=beat, name="recovery-heartbeat", daemon=True)
    beater.start()
    results: List[dict] = []
    try:
        for trial, service, worker_id in claimed:
            worker = build_worker_from_store(
                store, params_store, trial["sub_train_job_id"], advisor,
                worker_id=worker_id, devices=devices,
                async_persist=False)  # recovery is synchronous: no saver thread
            worker.service_id = service["id"]
            with pending_lock:
                pending.discard(service["id"])
            try:
                results.append(worker.resume_trial(trial["id"]))
            finally:
                store.update_service(service["id"], status=ServiceStatus.STOPPED.value)
    finally:
        stop_beat.set()
        beater.join(timeout=5)
    return results
