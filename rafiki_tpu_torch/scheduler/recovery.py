"""Failure detection, recovery of orphaned trials, and whole-sweep
crash resume (docs/recovery.md).

The port's own copy of ``rafiki_tpu/scheduler/recovery.py``
(``recover_orphaned_trials``, ``_RecoveryAdvisor``, ``_journal_records``
and ``resume_sweep``). Workers heartbeat their service row (between
trials, and within a trial through its epoch-log sink);
``MetaStore.get_orphaned_trials`` finds RUNNING trials whose service
died or went silent, and ``recover_orphaned_trials`` re-adopts each and
re-runs it, from its newest mid-trial checkpoint when one exists, on
the card unless the caller passes the CPU in ``devices``.

``resume_sweep`` goes further: a fresh process adopts a DEAD
SUPERVISOR'S ENTIRE JOB. It reconciles the sweep WAL
(``scheduler/wal.py``) against the MetaStore rows to prove the budget
invariant, rehydrates the dead sweep's advisor from completed-trial
rows plus ``kind="advisor"`` audit journals (``advisor/rehydrate.py``),
re-claims orphaned trials idempotently (a double resume loses the CAS
and backs off), then re-enters ``MeshSweepScheduler.run_sweep`` at
generation+1 to spend whatever budget remains, so ``propose_batch``
continues from an equivalent posterior, not from scratch. Its devices
(``devices=``; None: every card) serve both the adopted trials and the
continuation.

``stale_after_s`` must exceed the longest epoch: heartbeats inside a
trial come once per epoch.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.constants import (BudgetType, ServiceStatus, ServiceType, TrainJobStatus,
                                        TrialStatus)
from rafiki_tpu_torch.obs.journal import journal as _journal
from rafiki_tpu_torch.obs.journal import read_dir as _read_journal_dir
from rafiki_tpu_torch.obs.search.audit import knobs_hash
from rafiki_tpu_torch.scheduler.wal import SweepWal, read_wal, reconcile, wal_path
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.events import events
from rafiki_tpu_torch.worker.train import build_worker_from_store

#: Knobs of the resume path (docs/recovery.md): how stale a heartbeat
#: must be before a supervisor or worker counts as dead, and how often
#: the services manager's reaper polls for dead supervisors.
ENV_RESUME_STALE_S = "RAFIKI_RESUME_STALE_S"
ENV_RESUME_POLL_S = "RAFIKI_RESUME_POLL_S"

_TERMINAL_JOB = (TrainJobStatus.COMPLETED.value, TrainJobStatus.ERRORED.value,
                 TrainJobStatus.STOPPED.value)


class _RecoveryAdvisor:
    """Advisor handle for adopted trials: their knobs are chosen
    already, so ``propose`` is refused; a score is journaled
    (``recovery/feedback``) and routed to ``inner`` when one is given (a
    rehydrated advisor of the job), so scores earned by adopted trials
    inform post-resume proposals."""

    def __init__(self, inner=None):
        self._inner = inner

    def propose(self):
        raise RuntimeError("Recovery workers do not propose new trials")

    def propose_batch(self, n: int):
        raise RuntimeError("Recovery workers do not propose new trials")

    def feedback(self, score: float, knobs) -> None:
        routed = self._inner is not None
        if routed:
            self._inner.feedback(score, knobs)
        _journal.record("recovery", "feedback", score=float(score),
                        knobs_hash=knobs_hash(knobs), routed=routed)

    def speculate(self, score: float, knobs, fit=None) -> None:
        # An adopted trial is speculated like any in-flight one: routed
        # when a rehydrated advisor is attached, dropped otherwise (a
        # speculation is advisory; nothing durable owes it).
        if self._inner is not None:
            self._inner.speculate(score, knobs, fit=fit)


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


# ---------------------------------------------------------------------------
# Whole-sweep resume
# ---------------------------------------------------------------------------

def _journal_records() -> List[Dict[str, Any]]:
    """Every journal record reachable from this process (the configured
    journal directory, or RAFIKI_LOG_DIR): the advisor-audit source for
    rehydration. Empty when no journal was ever configured."""
    d = _journal.log_dir or os.environ.get("RAFIKI_LOG_DIR")
    if not d:
        return []
    try:
        return _read_journal_dir(d)
    except OSError:
        return []


def resume_sweep(
    store: MetaStore,
    params_store: ParamsStore,
    job_id: str,
    *,
    chips: Optional[int] = None,
    trials_per_chip: Optional[int] = None,
    stale_after_s: Optional[float] = None,
    devices: Optional[List[Any]] = None,
    advisor_service=None,
    stop_event=None,
) -> Dict[str, Any]:
    """Adopt a dead supervisor's train job and drive it to completion.

    The crash -> detect -> adopt -> reconcile -> resume lifecycle
    (docs/recovery.md), in order:

    1. Read the sweep WAL. No WAL: degrade LOUDLY to plain orphan-trial
       recovery (pre-WAL jobs are still salvageable, just not provable or
       continuable).
    2. Per sub job: ``reconcile`` WAL claims against trial rows, and
       refuse to proceed (``WalReconcileError``) if the budget invariant
       does not hold.
    3. Rehydrate the advisor under the dead sweep's advisor_id from
       completed rows + advisor audit journals.
    4. CAS-adopt orphaned trials (stale-hearted AND claimed-but-never-
       assigned rows) and re-run them, feedback routed into the
       rehydrated advisor. A concurrent resumer loses the CAS per trial
       and backs off: a double resume is a no-op.
    5. Re-enter ``run_sweep`` at generation+1 with the WAL'd sweep
       config, so the remaining budget is spent from the rehydrated
       posterior. A terminal job with nothing adopted is skipped.

    Returns a summary dict (mode, generation, adopted/salvaged/restarted
    counts, reconcile summaries, continuation status).
    """
    t0 = time.monotonic()
    stale = float(stale_after_s if stale_after_s is not None
                  else os.environ.get(ENV_RESUME_STALE_S, "30"))
    job = store.get_train_job(job_id)
    if job is None:
        raise KeyError(f"No train job {job_id!r}")
    # Adopted trials re-run one at a time, on the first chip's device.
    adopt_devices = list(devices)[:1] if devices is not None else None
    wal_p = wal_path(store.path, job_id)
    _journal.record("recovery", "resume_started", job_id=job_id, job_status=job["status"],
                    wal=str(wal_p), stale_after_s=stale)

    summary: Dict[str, Any] = {
        "job_id": job_id, "mode": "wal", "generation": None,
        "adopted": 0, "salvaged": 0, "restarted": 0,
        "reconcile": [], "continuation": None, "wall_s": None,
    }

    records = read_wal(wal_p)
    if not records:
        # Pre-WAL job (or the WAL dir was lost): nothing to reconcile and
        # no config to continue from. Degrade to orphan-trial recovery,
        # and say so in the journal, loudly: the budget invariant is now
        # unprovable for this job.
        _journal.record("recovery", "no_wal", job_id=job_id, wal=str(wal_p),
                        note="degrading to orphan-trial recovery; budget "
                             "invariant unprovable, no sweep continuation")
        rows = recover_orphaned_trials(store, params_store, stale, devices=adopt_devices)
        summary["mode"] = "orphan_only"
        summary["adopted"] = len(rows)
        summary["wall_s"] = round(time.monotonic() - t0, 3)
        _journal.record("recovery", "resume_finished", job_id=job_id,
                        **{k: v for k, v in summary.items() if k not in ("job_id", "reconcile")})
        return summary

    cfg: Dict[str, Any] = {}
    for r in records:
        if r.get("rec") == "note" and r.get("op") == "sweep_config":
            cfg = r  # the last one wins (each generation re-notes it)
    generation = max(int(r.get("gen") or 0) for r in records) + 1
    summary["generation"] = generation

    from rafiki_tpu_torch.advisor.rehydrate import rehydrate_advisor
    from rafiki_tpu_torch.advisor.service import AdvisorService
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.scheduler.mesh import MeshSweepScheduler, _WalAdvisorHandle
    from rafiki_tpu_torch.worker.train import InProcAdvisorHandle

    advisors = advisor_service or AdvisorService()
    wal = SweepWal.for_job(store, job_id, generation=generation)
    jrecords = _journal_records()

    # The sub's atomic `claimed` counter only advances when the job has a
    # trial-count budget (create_trial claims a slot in the same txn);
    # without one it stays 0 and is not cross-checked.
    has_count_budget = (dict(job.get("budget") or {})
                        .get(BudgetType.MODEL_TRIAL_COUNT.value) is not None)

    adopted_rows: List[dict] = []
    for sub in store.get_sub_train_jobs(job_id):
        trials = store.get_trials_of_sub_train_job(sub["id"])
        rec = reconcile(records, trials, sub=sub if has_count_budget else None,
                        sub_id=sub["id"])
        _journal.record("recovery", "reconcile", job_id=job_id, sub_id=sub["id"],
                        **rec.summary())
        summary["reconcile"].append({"sub_id": sub["id"], **rec.summary()})
        if not rec.ok:
            _journal.record("recovery", "reconcile_failed", job_id=job_id, sub_id=sub["id"],
                            errors=rec.errors)
            rec.raise_if_failed()

        # Rehydrate the dead sweep's advisor under its original id, so
        # the continuation's idempotent create_advisor reuses this engine
        # instead of building a cold one.
        handle = _RecoveryAdvisor()
        aid = sub.get("advisor_id")
        if aid:
            model_row = store.get_model(sub["model_id"])
            model_cls = load_model_class(model_row["model_file"], model_row["model_class"])
            completed = [t for t in trials
                         if t["status"] == TrialStatus.COMPLETED.value
                         and t.get("score") is not None]
            rehydrate_advisor(
                advisors, model_cls.get_knob_config(), kind=cfg.get("advisor_kind", "gp"),
                advisor_id=aid, completed=completed, journal_records=jrecords,
                seed=int(cfg.get("seed") or 0),
                engine_kwargs=cfg.get("advisor_kwargs") or None, job_id=job_id)
            handle = _RecoveryAdvisor(
                _WalAdvisorHandle(InProcAdvisorHandle(advisors, aid), wal))

        # Orphans: stale-hearted RUNNING rows, PLUS rows the dead
        # supervisor claimed but never bound to a chip (create_trial
        # landed, mark_trial_as_running did not: service_id is NULL, so
        # get_orphaned_trials skips them; here the supervisor is known
        # dead, so they are provably abandoned).
        orphans = {t["id"]: t for t in store.get_orphaned_trials(stale, sub["id"])}
        for t in trials:
            if t["status"] == TrialStatus.RUNNING.value and not t.get("service_id"):
                orphans.setdefault(t["id"], t)
        ordered = sorted(orphans.values(), key=lambda t: (t.get("no") or 0, t["id"]))
        if ordered:
            wal.note("adopt", sub_id=sub["id"], trial_ids=[t["id"] for t in ordered])
            had_ckpt = {t["id"]: params_store.latest_checkpoint(t["id"]) is not None
                        for t in ordered}
            rows = recover_orphaned_trials(
                store, params_store, stale, sub_train_job_id=sub["id"],
                devices=adopt_devices, advisor=handle, orphans=ordered)
            adopted_rows.extend(rows)
            summary["adopted"] += len(rows)
            for row in rows:
                if had_ckpt.get(row["id"]):
                    summary["salvaged"] += 1
                else:
                    summary["restarted"] += 1

    # Continuation: spend whatever budget remains from the rehydrated
    # posterior. run_sweep re-notes the config, takes a fresh SUPERVISOR
    # lease at this generation, claims remaining slots atomically (a
    # racing resumer's claims simply drain the budget: no double
    # claims), and finalizes job/sub statuses even at zero remaining.
    # Skipped only when the job is already terminal and nothing was
    # adopted (a true no-op double resume).
    if job["status"] in _TERMINAL_JOB and not adopted_rows:
        summary["continuation"] = "skipped_terminal"
        _journal.record("recovery", "resume_noop", job_id=job_id, job_status=job["status"],
                        generation=generation)
    else:
        sched = MeshSweepScheduler(store, params_store, advisor_service=advisors)
        result = sched.run_sweep(
            job_id,
            chips=int(chips or cfg.get("chips") or 0) or None,
            trials_per_chip=int(trials_per_chip or cfg.get("trials_per_chip") or 2),
            advisor_kind=cfg.get("advisor_kind", "gp"),
            stop_event=stop_event,
            generation=generation,
            advisor_kwargs=cfg.get("advisor_kwargs") or None,
            devices=devices,
        )
        summary["continuation"] = result.status

    wal.close()
    summary["wall_s"] = round(time.monotonic() - t0, 3)
    _journal.record("recovery", "resume_finished", job_id=job_id,
                    **{k: v for k, v in summary.items() if k not in ("job_id", "reconcile")})
    events.emit("sweep_resumed", job_id=job_id, generation=generation,
                adopted=summary["adopted"], salvaged=summary["salvaged"],
                restarted=summary["restarted"], continuation=summary["continuation"])
    return summary
