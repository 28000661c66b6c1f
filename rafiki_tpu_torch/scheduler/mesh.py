"""Mesh sweep scheduler: k packed trials per chip x N chips, elastic.

The port's own copy of ``rafiki_tpu/scheduler/mesh.py``
(``_WalAdvisorHandle``, ``ElasticHandle``, ``_ChipRunner``,
``GroupHandle`` and ``MeshSweepScheduler``). It drives the whole mesh
as ONE sweep: a single ``Advisor.propose_batch(N*k)`` drafts every slot
up front, rows are budget-claimed atomically, each claim bracketed in
the sweep's write-ahead log (``scheduler/wal.py``), and each chip trains
its share as one pack (docs/trial_packing.md). Robustness is the
headline (docs/mesh_sweep.md):

  * **Elastic re-packing**: a chip lost mid-sweep (the supervisor's
    ``scheduler.preempt`` chaos probe, keyed ``chip<i>``, or a runner
    thread dying) leaves its trials RUNNING, never errored; the
    supervisor slices them off the dead chip and re-assigns them
    round-robin to surviving chips, where each resumes serially from its
    newest per-epoch packed checkpoint (a fresh rerun when none exists:
    both bit-match an unfaulted serial run).
  * **Collective-init retry**: mesh formation retries with exponential
    backoff inside a bounded grace window (``RAFIKI_MESH_INIT_RETRIES``
    / ``RAFIKI_MESH_INIT_BACKOFF_S`` / ``RAFIKI_MESH_FORM_GRACE_S``),
    with the ``collective.init`` chaos site armed per attempt.
  * **Bounded-grace degradation**: when the mesh cannot form inside the
    grace window, the sweep degrades to single-chip mode instead of
    failing (same trials, one chip) with a ``mesh_degraded`` event and a
    ``mesh/degraded`` journal record.
  * **Crash safety**: the supervisor holds a liveness lease (a SUPERVISOR
    service row heartbeated every ``RAFIKI_SUPERVISOR_HEARTBEAT_S / 2``)
    from before its first device call; the ``supervisor.tick`` and
    ``host.loss`` chaos sites (``RAFIKI_MESH_CHIPS_PER_HOST``) kill it
    mid-sweep, and ``scheduler/recovery.py resume_sweep`` adopts the job
    in a fresh process.
  * **Sharded lane**: a proposal whose plan wants ``width > 1`` chips
    forks onto a :class:`GroupHandle` instead of a pack: one trial
    sharded across a chip group (``shard/``), member loss handled by
    re-forming at reduced width and resuming by reshard-on-restore.

A mesh's "chips" are (index, device) pairs: ``run_sweep(devices=...)``
lists one device per chip, and several chips may share one device (two
chips, or two group members, on ``cuda:0``; on the CPU every chip is
``cpu``). ``devices=None`` means every card (``local_devices()``), which
raises without one. Chips on one card train their epochs one after the
other (``ops/graphs.py device_lock``), and call a template's
``evaluate``, ``dump_parameters`` and ``destroy`` under the same lock
(``card_lock``), so a template that synchronizes the card cannot reach
another chip's capture.

The per-chip worker is the ordinary :class:`TrainWorker`: every
per-trial contract (store rows, scores, feedback, logs, params, events)
is exactly the serial one; only placement and recovery are mesh-level
concerns.

One learning-curve coordinator (``advisor/speculative.py``; None
unless a ``RAFIKI_CURVE_*`` switch is on) is shared by every chip worker
of a sub-job's sweep: the chips share best-so-far, so a score on one
chip raises the bar for another's stragglers, and a backfill on any
chip can speculate every trial in flight across the mesh
(docs/early_kill.md).

Not ported yet: the twin placement consult (``RAFIKI_TWIN_PLACEMENT``,
ROADMAP Queue 1, item 15).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import chaos, telemetry
from rafiki_tpu_torch.advisor import AdvisorService
from rafiki_tpu_torch.advisor.speculative import CurveCoordinator
from rafiki_tpu_torch.constants import (BudgetType, ServiceStatus, ServiceType, TrainJobStatus,
                                        TrialStatus)
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.model.knobs import knob_config_signature
from rafiki_tpu_torch.obs.journal import journal as _journal
from rafiki_tpu_torch.obs.ledger import ledger
from rafiki_tpu_torch.obs.search.audit import knobs_hash as _knobs_hash
from rafiki_tpu_torch.ops.graphs import card_lock
from rafiki_tpu_torch.parallel.mesh import local_devices
from rafiki_tpu_torch.scheduler.local import TrainJobResult
from rafiki_tpu_torch.scheduler.wal import SweepWal
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.backend import default_device
from rafiki_tpu_torch.utils.events import events
from rafiki_tpu_torch.worker.train import (InProcAdvisorHandle, PackAborted, PackedTrialRunner,
                                           TrainWorker)

_LOSS_MODES = ("kill", "term", "preempt")


class _WalAdvisorHandle:
    """Durability wrapper around the advisor handle: every ``feedback``
    is intent/commit-bracketed in the sweep WAL before it mutates the
    in-memory posterior, so ``resume_sweep`` knows exactly which scores
    the dead advisor had absorbed (docs/recovery.md). Proposals need no
    WAL record: an unscored proposal claims nothing."""

    def __init__(self, inner, wal: SweepWal):
        self._inner = inner
        self._wal = wal

    def propose(self):
        return self._inner.propose()

    def propose_batch(self, n: int):
        return self._inner.propose_batch(n)

    def feedback(self, score: float, knobs) -> None:
        txn = self._wal.intent("advisor_feedback", score=float(score),
                               knobs_hash=_knobs_hash(knobs))
        self._inner.feedback(score, knobs)
        self._wal.commit(txn, "advisor_feedback")

    def speculate(self, score: float, knobs, fit=None) -> None:
        # Like proposals, speculations need no WAL record: an uncorrected
        # one replays from its advisor/speculate journal record
        # (advisor/rehydrate.py), and the correction rides the bracketed
        # feedback above.
        self._inner.speculate(score, knobs, fit=fit)


class ElasticHandle:
    """Runtime grow/shrink surface for a live sweep (docs/autoscale.md).

    A caller requests chip-count deltas here; the supervisor applies them
    at its next poll with the machinery that already exists: shrink
    aborts the highest-index runner at its next epoch boundary and
    re-packs its rows onto survivors (the chip-loss path, minus the
    downtime charge), grow spawns a fresh ``_ChipRunner`` into the sweep.
    Asynchronous: ``desired()`` reports live + pending so a controller
    never double-requests between polls."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending = 0
        self._live = 0
        self.applied: List[Dict[str, Any]] = []

    def request(self, delta: int) -> None:
        with self._lock:
            self._pending += int(delta)

    def desired(self) -> int:
        with self._lock:
            return max(0, self._live + self._pending)

    def live(self) -> int:
        with self._lock:
            return self._live

    def _set_live(self, n: int) -> None:
        with self._lock:
            self._live = int(n)

    def _take(self) -> int:
        """Consume the pending delta (supervisor poll)."""
        with self._lock:
            delta, self._pending = self._pending, 0
            return delta


class _ChipRunner:
    """One chip's worker thread + task queue. Tasks are ``("pack",
    rows)`` (train a claimed row set as one pack) or ``("resume",
    trial_id)`` (serially resume a trial re-packed off a dead chip);
    ``("stop", None)`` ends the thread. ``abort`` is the chip-loss
    signal: the in-flight pack raises :class:`PackAborted` at its next
    epoch boundary and the runner marks itself dead."""

    def __init__(self, index: int, device: Any, worker: TrainWorker, pack: int,
                 errors: List[str], budget_max: Optional[int] = None):
        self.index = index
        self.device = device
        self.worker = worker
        self.budget_max = budget_max
        self.runner = PackedTrialRunner(worker, pack)
        self.tasks: "queue.Queue" = queue.Queue()
        self.abort = threading.Event()
        self.dead = False        # chip lost: no further tasks run here
        self.reaped = False      # supervisor already re-packed its rows
        self.scaled_down = False  # voluntary shrink, not a loss
        self.busy = False
        self._errors = errors
        self.thread = threading.Thread(target=self._loop, name=f"mesh-chip-{index}", daemon=True)

    @property
    def service_id(self) -> Optional[str]:
        return self.worker.service_id

    def idle(self) -> bool:
        # unfinished_tasks increments at put() and only decrements at
        # task_done(): no window where an assigned-but-not-yet-started
        # task reads as idle.
        return self.tasks.unfinished_tasks == 0

    def alive(self) -> bool:
        return not self.dead and self.thread.is_alive()

    def _loop(self) -> None:
        # Leader/follower start skew: a delay-mode fault here staggers
        # this chip's entry into the sweep (the mesh.skew chaos site).
        chaos.hook("mesh.skew", key=f"chip{self.index}")
        while True:
            try:
                kind, payload = self.tasks.get(timeout=0.05)
            except queue.Empty:
                if self.abort.is_set():
                    self.dead = True
                    return
                continue
            if kind == "stop":
                self.tasks.task_done()
                return
            if self.abort.is_set():
                # Lost/stopping chip: don't START queued work; its rows
                # stay RUNNING bound to this chip's service, so the
                # supervisor's reap finds and re-packs them.
                self.dead = True
                self.tasks.task_done()
                return
            self.busy = True
            try:
                if kind == "pack":
                    # budget_max keeps the mid-pack backfill on the atomic
                    # slot-claim path, or the pack never drains.
                    self.runner.run_assigned(payload, budget_max=self.budget_max,
                                             abort=self.abort)
                else:  # "resume"
                    self.worker.resume_trial(payload)
            except PackAborted:
                # Chip lost mid-pack: rows are still RUNNING; the
                # supervisor re-packs them onto surviving chips.
                self.dead = True
                return  # the finally below still runs task_done()
            except Exception as e:
                # A task failure is contained (its trials are already
                # marked errored by the worker); the chip lives on.
                self._errors.append(f"chip {self.index}: {e!r}")
            finally:
                self.busy = False
                if kind != "stop":
                    self.tasks.task_done()


class GroupHandle:
    """One chip group running group-sharded trials (docs/sharding.md).

    The sharded-lane analog of a :class:`_ChipRunner`: ``width`` chips
    form a ``("shard",)`` group and train ONE trial at a time through
    :func:`rafiki_tpu_torch.shard.train_sharded`, checkpointing per-shard
    chunk manifests every ``RAFIKI_CHECKPOINT_EVERY`` epochs. Member loss
    (the same ``scheduler.preempt`` chaos probe the supervisor polls for
    single chips, keyed ``chip<i>`` over this group's member indices)
    aborts the in-flight trial at its next epoch boundary (that epoch's
    checkpoint durable FIRST), re-forms the group at reduced width on the
    survivors, and resumes the trial from its manifest by
    reshard-on-restore. The group survives while one member lives;
    re-formations journal ``shard/group_formed`` again, so the journal
    stream alone reconstructs the width history.
    """

    def __init__(self, gi: int, job: dict, sub: dict, model_cls: type, handle,
                 store: MetaStore, params_store: ParamsStore, member_indices: List[int],
                 devices: List[Any], errors: List[str], stop_event: threading.Event):
        self.gi = gi
        self.job = job
        self.sub = sub
        self.model_cls = model_cls
        self.handle = handle
        self.store = store
        self.params_store = params_store
        self.members = list(member_indices)
        self.devices = list(devices)
        self.rows: List[tuple] = []  # (trial_id, knobs), trained in order
        self.errors = errors
        self.stop_event = stop_event
        self.worker_id = f"{job['id'][:8]}-shard-g{gi}"
        self.abort = threading.Event()   # member-loss / stop signal
        self.lost: set = set()           # member indices the probe took
        self.done = threading.Event()
        service = store.create_service(
            ServiceType.TRAIN_WORKER.value, job_id=job["id"],
            worker_index=self.members[0], devices=[str(d) for d in devices])
        store.update_service(service["id"], status=ServiceStatus.RUNNING.value)
        self.service_id = service["id"]
        self.thread = threading.Thread(target=self._run, name=f"shard-group-{gi}", daemon=True)
        self._poller = threading.Thread(target=self._poll, name=f"shard-group-{gi}-probe",
                                        daemon=True)

    def start(self) -> None:
        self.thread.start()
        self._poller.start()

    def _poll(self) -> None:
        """Member-loss probe, same site and key scheme as the single-chip
        supervisor: a ``scheduler.preempt`` kill against any live member
        flags it lost and trips the group abort (the epoch loop raises
        GroupAborted AFTER the boundary checkpoint)."""
        while not self.done.is_set():
            for i in list(self.members):
                if i in self.lost:
                    continue
                decision = chaos.decide("scheduler.preempt", key=f"chip{i}")
                if decision is not None and decision.mode in _LOSS_MODES:
                    self.lost.add(i)
                    self.abort.set()
            if self.stop_event.is_set():
                self.abort.set()
            time.sleep(0.02)

    def _run(self) -> None:
        try:
            for tid, kn in self.rows:
                if self.stop_event.is_set():
                    return
                self._run_trial(tid, kn)
        finally:
            self.done.set()
            self.store.update_service(self.service_id, status=ServiceStatus.STOPPED.value)

    def _run_trial(self, tid: str, kn: dict) -> None:
        from rafiki_tpu_torch.shard import GroupAborted, ShardPlan, save_sharded, train_sharded

        job_id = self.job["id"]
        every = int(os.environ.get("RAFIKI_CHECKPOINT_EVERY", "0"))
        attempt = 0
        while True:
            width = len(self.devices)
            with default_device(self.devices[0]):  # the group's first member's
                model = self.model_cls(**kn)
            self.store.mark_trial_as_running(tid, service_id=self.service_id,
                                             worker_id=self.worker_id)
            plan = ShardPlan(width=width, family=self.model_cls.__name__)
            plan.note()
            telemetry.inc("shard.groups_formed")
            telemetry.set_gauge("shard.group_width", width)
            _journal.record("shard", "group_formed", job_id=job_id, trial_id=tid,
                            width=width, members=self.members, attempt=attempt)

            def sink(epoch: int, loop, _tid=tid) -> None:
                if every > 0 and (epoch + 1) % every == 0:
                    t0 = time.monotonic()
                    try:
                        save_sharded(self.params_store, _tid, epoch, loop.state, loop.width)
                        events.emit("checkpoint_written", trial_id=_tid, epoch=epoch,
                                    worker_id=self.worker_id)
                    except Exception:
                        # Same contract as the serial sink: a failed
                        # checkpoint costs resumability, not the trial.
                        telemetry.inc("worker.checkpoint_write_failed")
                    finally:
                        ledger.add("checkpoint_s", time.monotonic() - t0,
                                   entity=f"trial:{_tid}")
                self.store.update_service(self.service_id, heartbeat=True)
                # AFTER the write, the serial path's ordering: a
                # kill-at-epoch-N fault lands with epoch N durable.
                chaos.hook("worker.epoch", key=self.worker_id)

            try:
                train_sharded(model, self.job["train_dataset_uri"], self.devices, plan=plan,
                              checkpoint_sink=sink, abort=self.abort,
                              resume_from=(self.params_store, tid))
            except GroupAborted:
                survivors = [i for i in self.members if i not in self.lost]
                gone = [i for i in self.members if i in self.lost]
                if self.stop_event.is_set():
                    return  # stop, not loss: the row stays RUNNING
                telemetry.inc("mesh.chips_lost", max(1, len(gone)))
                _journal.record("shard", "member_lost", job_id=job_id, trial_id=tid,
                                lost=gone, survivors=survivors)
                events.emit("shard_member_lost", job_id=job_id, trial_id=tid, lost=gone)
                self.devices = [d for i, d in zip(self.members, self.devices)
                                if i not in self.lost]
                self.members = survivors
                self.abort.clear()
                if not self.members:
                    self.store.mark_trial_as_errored(tid, "sharded group lost every chip")
                    events.emit("trial_errored", trial_id=tid, worker_id=self.worker_id,
                                error="sharded group lost every chip")
                    return
                attempt += 1
                continue  # re-form on the survivors; the resume path
                # reshards the last durable manifest to the new width.
            except Exception as e:
                self.errors.append(f"shard group {self.gi}: {e!r}")
                self.store.mark_trial_as_errored(tid, repr(e))
                events.emit("trial_errored", trial_id=tid, worker_id=self.worker_id,
                            error=repr(e))
                return
            # Completion: TrainWorker._persist's bookkeeping (the serial
            # loop train_sharded installed makes evaluate/dump_parameters
            # behave exactly as after a serial train()).
            try:
                with card_lock(model):
                    score = float(model.evaluate(self.job["val_dataset_uri"]))
                    blob = model.dump_parameters()
                params_id = self.params_store.save(blob)
                self.store.mark_trial_as_completed(tid, score, params_id)
                self.params_store.delete_checkpoints(tid)  # superseded
                events.emit("trial_completed", trial_id=tid, score=score,
                            worker_id=self.worker_id)
            except Exception as e:
                self.errors.append(f"shard group {self.gi} persist: {e!r}")
                self.store.mark_trial_as_errored(tid, f"params persist failed: {e!r}")
                events.emit("trial_errored", trial_id=tid, worker_id=self.worker_id,
                            error="params persist failed")
                return
            finally:
                with card_lock(model):
                    model.destroy()
            try:
                self.handle.feedback(score, kn)
            except Exception:
                telemetry.inc("worker.feedback_errors")
            return


class MeshSweepScheduler:
    """Drives one train job as an elastic k-trials-per-chip x N-chip
    sweep (docs/mesh_sweep.md). Blocking, in-process: one thread per
    chip, a supervisor polling for chip loss and completion."""

    def __init__(self, store: MetaStore, params_store: ParamsStore,
                 advisor_service: Optional[AdvisorService] = None):
        self.store = store
        self.params_store = params_store
        self.advisors = advisor_service or AdvisorService()
        self._wal: Optional[SweepWal] = None
        self._generation = 0
        self._sup_service_id: Optional[str] = None
        self._devices: List[Any] = []

    # -- mesh formation ------------------------------------------------------

    def _form_mesh(self, want: int) -> "tuple[List[Any], bool]":
        """Take ``want`` chips off the sweep's device list, retrying
        collective initialization with exponential backoff inside a
        bounded grace window. Returns (devices, degraded): on exhaustion
        the sweep DEGRADES to single-chip mode rather than failing: the
        trials all still run, just without mesh parallelism."""
        retries = int(os.environ.get("RAFIKI_MESH_INIT_RETRIES", "3"))
        backoff = float(os.environ.get("RAFIKI_MESH_INIT_BACKOFF_S", "0.05"))
        grace = float(os.environ.get("RAFIKI_MESH_FORM_GRACE_S", "30"))
        deadline = time.monotonic() + grace
        last: Optional[BaseException] = None
        for attempt in range(retries + 1):
            try:
                # The collective.init chaos site is armed once per
                # attempt (error mode = injected init failure).
                chaos.hook("collective.init", key=f"attempt{attempt}")
                devs = list(self._devices)
                if len(devs) < want:
                    raise RuntimeError(f"{len(devs)} device(s) visible, want {want}")
                return devs[:want], False
            except Exception as e:
                last = e
                if attempt >= retries or time.monotonic() >= deadline:
                    break
                telemetry.inc("mesh.init_retries")
                events.emit("collective_init_retry", attempt=attempt, error=str(e))
                time.sleep(max(0.0, min(backoff * (2 ** attempt), deadline - time.monotonic())))
        telemetry.inc("mesh.degraded_single_chip")
        _journal.record("mesh", "degraded", want=want, error=str(last))
        events.emit("mesh_degraded", want=want, error=str(last))
        devs = list(self._devices)[:1]
        if not devs:
            # No device at all: run_sweep fails the job cleanly instead
            # of leaving it RUNNING.
            _journal.record("mesh", "no_devices", want=want, error=str(last))
            events.emit("mesh_no_devices", want=want, error=str(last))
        return devs, True

    # -- the sweep -----------------------------------------------------------

    def run_sweep(
        self,
        job_id: str,
        chips: Optional[int] = None,
        trials_per_chip: int = 2,
        advisor_kind: str = "gp",
        stop_event: Optional[threading.Event] = None,
        elastic: Optional[ElasticHandle] = None,
        generation: int = 0,
        advisor_kwargs: Optional[Dict[str, Any]] = None,
        devices: Optional[List[Any]] = None,
    ) -> TrainJobResult:
        """Run a train job as one mesh sweep to budget exhaustion.

        ``devices`` lists one device per chip (module doc; None: every
        card, which raises without one, before the job is touched);
        ``chips`` (default: the job's CHIP_COUNT or GPU_COUNT budget,
        else one chip per listed device) is how many the mesh takes.
        ``elastic``, when given, lets a controller grow and shrink the
        chip count while the sweep runs. ``generation`` distinguishes
        supervisor incarnations of the same job (0 = the original;
        ``resume_sweep`` runs at generation+1): it tags the WAL records
        and the ``supervisor.tick``/``host.loss`` chaos keys, so a kill
        fault can be scoped to one incarnation."""
        t0 = time.monotonic()
        job = self.store.get_train_job(job_id)
        if job is None:
            raise KeyError(f"No train job {job_id!r}")
        self._devices = list(devices) if devices is not None else local_devices()
        self.store.update_train_job_status(job_id, TrainJobStatus.RUNNING.value)
        events.emit("train_job_started", job_id=job_id, app=job["app"],
                    budget=job["budget"], scheduler="mesh")
        stop_event = stop_event or threading.Event()

        budget = dict(job["budget"])
        chip_budget = budget.get("CHIP_COUNT") or budget.get("GPU_COUNT")
        want = int(chips or chip_budget or len(self._devices) or 1)

        # Durable control-plane log + the supervisor's liveness lease:
        # both must exist BEFORE any budget mutation and before the first
        # device call, so a resumer can (a) find the sweep's config
        # without this process and (b) tell a dead supervisor from a slow
        # one (docs/recovery.md).
        self._generation = int(generation)
        self._wal = SweepWal.for_job(self.store, job_id, generation=self._generation)
        self._wal.note("sweep_config", job_id=job_id, advisor_kind=advisor_kind,
                       advisor_kwargs=advisor_kwargs or {}, chips=want,
                       trials_per_chip=int(trials_per_chip))
        sup = self.store.create_service(ServiceType.SUPERVISOR.value, job_id=job_id,
                                        worker_index=self._generation)
        self._sup_service_id = sup["id"]
        self.store.update_service(sup["id"], status=ServiceStatus.RUNNING.value,
                                  heartbeat=True)
        _journal.record("mesh", "supervisor_started", job_id=job_id,
                        generation=self._generation, service_id=sup["id"])

        devices, degraded = self._form_mesh(want)
        if not devices:
            self.store.update_service(sup["id"], status=ServiceStatus.STOPPED.value)
            self._wal.close()
            self.store.update_train_job_status(job_id, TrainJobStatus.ERRORED.value)
            for sub in self.store.get_sub_train_jobs(job_id):
                self.store.update_sub_train_job(sub["id"], status=TrainJobStatus.ERRORED.value)
            dur_s = time.monotonic() - t0
            events.emit("train_job_finished", job_id=job_id,
                        status=TrainJobStatus.ERRORED.value, duration_s=round(dur_s, 3),
                        degraded=True)
            return TrainJobResult(job_id=job_id, status=TrainJobStatus.ERRORED.value,
                                  trials=[], best_trials=[], duration_s=dur_s,
                                  errors=["mesh sweep: no device obtainable"])
        k = max(1, int(trials_per_chip))

        errors: List[str] = []
        subs = self.store.get_sub_train_jobs(job_id)
        if not subs:
            raise ValueError(f"Train job {job_id} has no sub jobs (no models attached)")

        for sub in subs:
            if stop_event.is_set():
                self.store.update_sub_train_job(sub["id"], status=TrainJobStatus.STOPPED.value)
                continue
            model_row = self.store.get_model(sub["model_id"])
            try:
                model_cls = load_model_class(model_row["model_file"], model_row["model_class"])
            except Exception as e:
                self.store.update_sub_train_job(sub["id"], status=TrainJobStatus.ERRORED.value)
                errors.append(f"model {model_row['name']}: {e}")
                continue
            advisor_id = self.advisors.create_advisor(
                model_cls.get_knob_config(), kind=advisor_kind,
                advisor_id=sub.get("advisor_id") or None, engine_kwargs=advisor_kwargs)
            try:
                self.advisors.get(advisor_id).job_id = job_id
            except KeyError:
                pass
            self.store.update_sub_train_job(sub["id"], advisor_id=advisor_id,
                                            status=TrainJobStatus.RUNNING.value)
            handle = _WalAdvisorHandle(InProcAdvisorHandle(self.advisors, advisor_id), self._wal)

            self._run_sub(job, sub, model_cls, handle, devices, k, budget, errors,
                          stop_event, elastic=elastic)

            trials = self.store.get_trials_of_sub_train_job(sub["id"])
            if stop_event.is_set():
                sub_status = TrainJobStatus.STOPPED.value
            elif trials and all(t["status"] == TrialStatus.ERRORED.value for t in trials):
                sub_status = TrainJobStatus.ERRORED.value
            else:
                sub_status = TrainJobStatus.COMPLETED.value
            self.store.update_sub_train_job(sub["id"], status=sub_status)
            self.advisors.delete_advisor(advisor_id)

        subs_after = self.store.get_sub_train_jobs(job_id)
        if stop_event.is_set():
            status = TrainJobStatus.STOPPED.value
        elif subs_after and all(s["status"] == TrainJobStatus.ERRORED.value for s in subs_after):
            status = TrainJobStatus.ERRORED.value
        else:
            status = TrainJobStatus.COMPLETED.value
        self.store.update_train_job_status(job_id, status)
        # Clean shutdown: release the liveness lease and the WAL handle.
        # On a crash neither line runs: exactly the signal the resume
        # reaper keys on (stale SUPERVISOR heartbeat + RUNNING job).
        self.store.update_service(sup["id"], status=ServiceStatus.STOPPED.value)
        self._wal.close()
        telemetry.inc("scheduler.train_jobs_finished")
        dur_s = time.monotonic() - t0
        telemetry.observe("scheduler.train_job_s", dur_s)
        events.emit("train_job_finished", job_id=job_id, status=status,
                    duration_s=round(dur_s, 3), degraded=degraded)
        return TrainJobResult(
            job_id=job_id,
            status=status,
            trials=self.store.get_trials_of_train_job(job_id),
            best_trials=self.store.get_best_trials_of_train_job(job_id, limit=2),
            duration_s=dur_s,
            errors=errors,
        )

    def _bucket_key(self, model_cls: type, kn: dict, train_uri: str):
        """(width, bucket key, epochs) of one proposal: a ``shard_plan``
        that solves a width > 1 buckets under ``("sharded", family,
        width)``, any other proposal under its packing key; a proposal
        that cannot be keyed is a singleton bucket of its own."""
        try:
            m = model_cls(**kn)
            ds = m._prepared_dataset(train_uri)
            sp = getattr(m, "shard_plan", None)
            sp = sp(ds) if callable(sp) else None
            width = max(1, int(getattr(sp, "width", 1) or 1))
            key = (repr(("sharded", model_cls.__name__, width)) if width > 1
                   else repr(m.packing_key(ds)))
            return width, key, int(getattr(m, "epochs", 0)) or None
        except Exception:
            return 1, f"unpackable:{id(kn)}", None

    def _new_runner(self, i: int, dev, job: dict, sub: dict, model_cls: type, handle,
                    budget: Dict[str, Any], k: int, errors: List[str],
                    stop_event: threading.Event, budget_max: Optional[int],
                    curve: Optional[CurveCoordinator]) -> _ChipRunner:
        """A chip: its service row (RUNNING), its worker (synchronous
        persistence: the supervisor reads row statuses for completion, so
        scores must be durable when a pack returns; the sweep's shared
        curve coordinator) and its runner."""
        service = self.store.create_service(ServiceType.TRAIN_WORKER.value, job_id=job["id"],
                                            worker_index=i, devices=[str(dev)])
        self.store.update_service(service["id"], status=ServiceStatus.RUNNING.value)
        worker = TrainWorker(
            self.store, self.params_store, sub["id"], model_cls, handle,
            job["train_dataset_uri"], job["val_dataset_uri"], budget,
            worker_id=f"{job['id'][:8]}-mesh-c{i}", devices=[dev],
            job_created_at=job["created_at"], service_id=service["id"],
            stop_event=stop_event, async_persist=False,
        )
        # The mid-pack backfill claims budget slots from inside the
        # worker: hand it the WAL so those claims are bracketed too.
        worker.wal = self._wal
        worker.curve = curve
        return _ChipRunner(i, dev, worker, k, errors, budget_max=budget_max)

    def _run_sub(self, job: dict, sub: dict, model_cls: type, handle, devices: List[Any],
                 k: int, budget: Dict[str, Any], errors: List[str],
                 stop_event: threading.Event, elastic: Optional[ElasticHandle] = None) -> None:
        """One sub-job's sweep: draft, claim, distribute, supervise."""
        job_id = job["id"]
        n_chips = len(devices)
        assert n_chips >= 1, "mesh sweep needs at least one device"
        max_trials = budget.get(BudgetType.MODEL_TRIAL_COUNT.value)
        budget_max = int(max_trials) if max_trials is not None else None
        n_slots = n_chips * k
        if budget_max is not None:
            n_slots = min(n_slots, budget_max)

        # ONE batched draft for the whole mesh: the paper's per-GPU
        # propose loop collapses into a single call.
        with telemetry.span("mesh.advisor_propose", job_id=job_id, n=n_slots):
            batch = getattr(handle, "propose_batch", None)
            proposals = (batch(n_slots) if batch is not None
                         else [handle.propose() for _ in range(n_slots)])

        knob_config = model_cls.get_knob_config()

        # Claim every row up front (atomic budget slots, each WAL
        # intent/commit-bracketed), bucketed by packing key: only
        # same-key rows may share a pack. A proposal whose plan solves a
        # width > 1 buckets under ("sharded", family, width) instead and
        # gets a chip GROUP carved from the tail of the device list.
        # Claiming happens BEFORE runner creation, so group devices never
        # host a _ChipRunner.
        wal = self._wal
        buckets: Dict[str, List[tuple]] = {}
        order: List[str] = []
        bucket_epochs: Dict[str, Optional[int]] = {}
        group_buckets: Dict[int, List[tuple]] = {}  # width -> rows
        group_order: List[int] = []
        for kn in proposals:
            with default_device(devices[0]):
                width, key, epochs = self._bucket_key(model_cls, kn, job["train_dataset_uri"])
            bucket_epochs.setdefault(key, epochs)
            txn = wal.intent("budget_claim", sub_id=sub["id"], knobs_hash=_knobs_hash(kn))
            trial = self.store.create_trial(
                sub["id"], model_cls.__name__, kn,
                shape_sig=knob_config_signature(knob_config, kn), budget_max=budget_max)
            if trial is None:
                wal.commit(txn, "budget_claim", denied=True)
                break  # budget drained under us
            wal.commit(txn, "budget_claim", trial_id=trial["id"])
            if width > 1:
                if width not in group_buckets:
                    group_order.append(width)
                    group_buckets[width] = []
                group_buckets[width].append((trial["id"], kn))
                continue
            if key not in buckets:
                order.append(key)
                buckets[key] = []
            buckets[key].append((trial["id"], kn))

        # Group devices come from the TAIL of the device list, so the
        # packed lane keeps the low indices; one GroupHandle per distinct
        # width, training its rows one after another. The width is
        # clamped to what the mesh can give (one chip left for the packed
        # lane while it has rows).
        avail = list(devices)
        reserve = 1 if any(buckets.values()) else 0
        groups: List[GroupHandle] = []
        for gi, width in enumerate(group_order):
            take = min(width, len(avail) - reserve)
            if take >= 1:
                member_devs = avail[len(avail) - take:]
                del avail[len(avail) - take:]
                member_idx = list(range(len(avail), len(avail) + take))
            else:
                # Degenerate mesh (packed rows + a group, one device):
                # share the device at width 1, under a member index past
                # every real chip so preempt keys never collide.
                member_devs = [avail[0]]
                member_idx = [n_chips + gi]
            g = GroupHandle(gi, job, sub, model_cls, handle, self.store, self.params_store,
                            member_idx, member_devs, errors, stop_event)
            g.rows = group_buckets[width]
            groups.append(g)
        n_regular = len(avail)

        # One curve coordinator for the whole mesh (None with the
        # RAFIKI_CURVE_* switches off): the chips share best-so-far.
        curve = CurveCoordinator.from_env()
        runners: List[_ChipRunner] = []
        if any(buckets.values()):
            for i, dev in enumerate(avail):
                runners.append(self._new_runner(i, dev, job, sub, model_cls, handle, budget, k,
                                                errors, stop_event, budget_max, curve))
        assign: List[List[List[tuple]]] = [[[] for _ in order] for _ in runners]
        # Global round-robin cursor: restarting at chip 0 per bucket would
        # pile every singleton bucket onto chip 0.
        cursor = 0
        for b, key in enumerate(order):
            for row in buckets[key]:
                assign[cursor % max(1, len(runners))][b].append(row)
                cursor += 1
        for r, per_bucket in zip(runners, assign):
            for b, rows in enumerate(per_bucket):
                if not rows:
                    continue
                txn = wal.intent("pack_assign", chip=r.index,
                                 trial_ids=[tid for tid, _kn in rows])
                # Bind the rows to their chip's service so a later chip
                # loss finds exactly this chip's orphans.
                for tid, _kn in rows:
                    self.store.mark_trial_as_running(tid, service_id=r.service_id,
                                                     worker_id=r.worker.worker_id)
                r.tasks.put(("pack", rows))
                wal.commit(txn, "pack_assign")
                _journal.record(
                    "mesh", "pack_formed", job_id=job_id, chip=r.index,
                    packing_key=order[b], k=len(rows),
                    fill_ratio=round(len(rows) / float(k), 4),
                    epochs=bucket_epochs.get(order[b]),
                    trial_ids=[tid for tid, _kn in rows],
                    knobs_hashes=[_knobs_hash(kn) for _tid, kn in rows])
        _journal.record("mesh", "sweep_started", job_id=job_id, chips=n_regular,
                        trials_per_chip=k,
                        n_trials=(sum(len(v) for v in buckets.values())
                                  + sum(len(v) for v in group_buckets.values())),
                        groups=[{"width": len(g.devices), "members": g.members,
                                 "trials": len(g.rows)} for g in groups] or None)
        for g in groups:
            g.start()
        for r in runners:
            r.thread.start()

        # The next chip index for elastic grow counts EVERY formed chip,
        # group members included, so a new index never collides with a
        # group member's scheduler.preempt key.
        chip_seq = [n_chips]

        def spawn_chip() -> _ChipRunner:
            """Elastic grow: one more chip joins the live sweep, on the
            next device of the sweep's list (several chips may share
            one). It starts idle and picks up re-packed resumes like any
            survivor."""
            i = chip_seq[0]
            chip_seq[0] += 1
            pool = self._devices or devices
            r = self._new_runner(i, pool[i % len(pool)], job, sub, model_cls, handle, budget, k,
                                 errors, stop_event, budget_max, curve)
            r.thread.start()
            return r

        self._supervise(job_id, sub["id"], runners, stop_event, elastic=elastic,
                        spawn_chip=spawn_chip)

        # The packed lane has drained (or the sweep was stopped); wait for
        # the sharded groups. Their member-loss probe runs in each group's
        # own poller thread, so what is left here is the liveness lease
        # and the stop signal.
        hb_s = float(os.environ.get("RAFIKI_SUPERVISOR_HEARTBEAT_S", "5"))
        last_beat = time.monotonic()
        for g in groups:
            while not g.done.wait(timeout=0.05):
                if stop_event.is_set():
                    g.abort.set()
                now = time.monotonic()
                if self._sup_service_id and now - last_beat >= hb_s / 2.0:
                    last_beat = now
                    self.store.update_service(self._sup_service_id, heartbeat=True)
            g.thread.join(timeout=30.0)

        for r in runners:
            if r.worker._saver is not None:
                r.worker._saver.close()
            self.store.update_service(r.service_id, status=ServiceStatus.STOPPED.value)

    def _supervise(self, job_id: str, sub_id: str, runners: List[_ChipRunner],
                   stop_event: threading.Event, elastic: Optional[ElasticHandle] = None,
                   spawn_chip=None) -> None:
        """Poll for chip loss (the ``scheduler.preempt`` chaos probe,
        keyed ``chip<i>``), re-pack dead chips' trials onto survivors,
        apply elastic grow/shrink requests, and stop every runner once
        the sweep is drained."""
        from rafiki_tpu_torch.obs.perf import slo as _slo

        lost_at: Dict[int, float] = {}
        rr = 0  # round-robin cursor over survivors for re-packed rows
        gen = self._generation
        hb_s = float(os.environ.get("RAFIKI_SUPERVISOR_HEARTBEAT_S", "5"))
        last_beat = time.monotonic()
        # Simulated host topology: with RAFIKI_MESH_CHIPS_PER_HOST=n, chips
        # i//n share a "host"; host 0 also carries the supervisor. The
        # host.loss chaos site kills whole hosts at once: host 0 through
        # a self-directed hook() (the supervisor dies with its chips and
        # the resume path takes over), the others through decide() + an
        # abort of their chips (survivors re-pack: the chip-loss path at
        # host granularity).
        per_host = int(os.environ.get("RAFIKI_MESH_CHIPS_PER_HOST", "0") or 0)
        while True:
            # supervisor.tick: the kill-the-supervisor injection point
            # (SIGKILL of this whole process, chip threads included).
            chaos.hook("supervisor.tick", key=f"g{gen}")
            now = time.monotonic()
            if self._sup_service_id and now - last_beat >= hb_s / 2.0:
                last_beat = now
                self.store.update_service(self._sup_service_id, heartbeat=True)
            if per_host > 0:
                hosts = sorted({r.index // per_host for r in runners if r.alive()})
                for h in hosts:
                    if h == 0:
                        chaos.hook("host.loss", key=f"g{gen}h0")
                        continue
                    decision = chaos.decide("host.loss", key=f"g{gen}h{h}")
                    if decision is not None and decision.mode in _LOSS_MODES:
                        victims = [r for r in runners if r.alive() and r.index // per_host == h]
                        for r in victims:
                            r.abort.set()
                            lost_at[r.index] = time.monotonic()
                        _journal.record("mesh", "host_lost", job_id=job_id, host=h,
                                        chips=[r.index for r in victims])
                        events.emit("mesh_host_lost", job_id=job_id, host=h,
                                    chips=[r.index for r in victims])
            if elastic is not None:
                elastic._set_live(sum(1 for r in runners if r.alive()))
                delta = elastic._take()
                if delta > 0 and spawn_chip is not None:
                    for _ in range(delta):
                        nr = spawn_chip()
                        runners.append(nr)
                        telemetry.inc("mesh.chips_scaled_up")
                        _journal.record("mesh", "scale_up", job_id=job_id, chip=nr.index)
                        events.emit("mesh_chip_added", job_id=job_id, chip=nr.index,
                                    worker_id=nr.worker.worker_id)
                        elastic.applied.append({"dir": "up", "chip": nr.index})
                elif delta < 0:
                    # Shrink newest-first, never below one live chip; the
                    # abort unwinds the pack at its next epoch boundary
                    # and the reap below re-packs its rows.
                    candidates = sorted((r for r in runners
                                         if r.alive() and not r.abort.is_set()),
                                        key=lambda r: -r.index)
                    for r in candidates[:max(0, min(-delta, len(candidates) - 1))]:
                        r.scaled_down = True
                        r.abort.set()
                        telemetry.inc("mesh.chips_scaled_down")
                        _journal.record("mesh", "scale_down", job_id=job_id, chip=r.index)
                        events.emit("mesh_chip_removed", job_id=job_id, chip=r.index,
                                    worker_id=r.worker.worker_id)
                        elastic.applied.append({"dir": "down", "chip": r.index})
            for r in runners:
                if not r.alive():
                    continue
                decision = chaos.decide("scheduler.preempt", key=f"chip{r.index}")
                if decision is not None and decision.mode in _LOSS_MODES:
                    # Chip loss: the in-flight pack aborts at its next
                    # epoch boundary (checkpoints durable first).
                    r.abort.set()
                    lost_at[r.index] = time.monotonic()

            for r in runners:
                if r.reaped or r.alive():
                    continue
                r.reaped = True
                r.dead = True
                if r.scaled_down:
                    # Voluntary shrink, already journaled as
                    # mesh/scale_down: no downtime charge; its rows still
                    # re-pack below like any orphan set.
                    _journal.record("mesh", "scale_down_drained", job_id=job_id, chip=r.index)
                else:
                    telemetry.inc("mesh.chips_lost")
                    events.emit("mesh_chip_lost", job_id=job_id, chip=r.index,
                                worker_id=r.worker.worker_id)
                    _journal.record("mesh", "chip_lost", job_id=job_id, chip=r.index)
                orphans = [t["id"] for t in self.store.get_trials_of_sub_train_job(sub_id)
                           if t["status"] == TrialStatus.RUNNING.value
                           and t.get("service_id") == r.service_id]
                survivors = [s for s in runners if s.alive()]
                if not survivors:
                    for tid in orphans:
                        self.store.mark_trial_as_errored(tid, "mesh sweep lost every chip")
                        events.emit("trial_errored", trial_id=tid, worker_id=r.worker.worker_id,
                                    error="mesh sweep lost every chip")
                    _journal.record("mesh", "repack_failed", job_id=job_id, chip=r.index,
                                    orphans=orphans)
                    continue
                for tid in orphans:
                    target = survivors[rr % len(survivors)]
                    rr += 1
                    txn = self._wal.intent("pack_assign", chip=target.index, trial_ids=[tid],
                                           repack=True)
                    # Re-bind BEFORE enqueueing: if the target chip dies
                    # with this resume still queued, the next reap's
                    # orphan query must find the row under the target's
                    # service, not the already-reaped one's.
                    self.store.mark_trial_as_running(tid, service_id=target.service_id,
                                                     worker_id=target.worker.worker_id)
                    target.tasks.put(("resume", tid))
                    self._wal.commit(txn, "pack_assign")
                _journal.record("mesh", "repack", job_id=job_id, chip=r.index, moved=orphans,
                                survivors=[s.index for s in survivors])
                # Downtime: wall-clock from the loss signal to the
                # re-pack, charged to the sweep's mesh entity.
                t_lost = lost_at.get(r.index)
                if t_lost is not None:
                    ledger.add("downtime_s", time.monotonic() - t_lost, entity=f"mesh:{job_id}")

            live = [r for r in runners if r.alive()]
            pending_reap = [r for r in runners if not r.alive() and not r.reaped]
            if stop_event.is_set():
                # Abort every live runner so in-flight packs unwind at
                # their next epoch boundary (rows stay RUNNING, as on the
                # chip-loss path) instead of training past the join
                # timeout and writing to the store after STOPPED.
                for r in live:
                    r.abort.set()
                break
            if not pending_reap and (not live or all(r.idle() for r in live)):
                break
            # SLO tick from the supervision loop: the mesh downtime budget
            # burns even when no epoch or request path ticks it.
            _slo.maybe_tick()
            time.sleep(0.02)

        for r in runners:
            if r.alive():
                r.tasks.put(("stop", None))
        for r in runners:
            r.thread.join(timeout=30.0)
