"""Process-per-device scheduler: one OS process per worker rank, one
device per process.

The port's own copy of ``rafiki_tpu/scheduler/process.py``, the
production scheduler shape: each worker runs as a subprocess
(``python -m rafiki_tpu_torch.worker.main``) whose environment exposes
only its own device, the reference's one-GPU-per-container isolation
without the container. Coordination is the JAX package's: the meta
store (shared sqlite, atomic trial claiming) is the source of truth, and
the advisor is shared over loopback HTTP (``advisor/app.py``, on the
port's ``utils/httpd.py``, behind a shared secret).

``worker_device_env`` pins a process: ``CUDA_VISIBLE_DEVICES`` on the
card, ``RAFIKI_WORKER_DEVICE=cpu`` (and no card visible) on the CPU.

A worker slot is a *group* of ``devices_per_trial x
multihost_processes`` processes, one rank per device, joined in one
``torch.distributed`` group (``nccl`` on the card, ``gloo`` on the CPU)
at a free loopback port; rank 0 leads (``TrainWorker``), the others
follow (``worker/follower.py``), and each trial trains data-parallel at
the group's width. With one rank the group is a single worker and no
process group is formed. (In the JAX package one process owns
``devices_per_trial`` devices and only the multihost processes form a
cluster; here every device is a process of its own.)

Supervision, as in the JAX package: a group with a member dead non-zero
is torn down at once (survivors are inside collectives their dead peer
will never join), and so is one whose follower exited 0 while the leader
runs, after ``FOLLOWER_EXIT_GRACE_S``; a failed group is respawned with
exponential backoff up to ``RAFIKI_WORKER_MAX_RESTARTS`` times (default
2, backoff ``RAFIKI_WORKER_RESTART_BACKOFF_S``, default 0.5 s, doubling),
its leader suffixed ``-r<attempt>`` and told to adopt the orphaned trials
of every dead predecessor. A group past its restarts is given up, and
its orphans are marked ERRORED. The ``scheduler.preempt`` chaos site
fires on a live group's leader once a poll.
"""

from __future__ import annotations

import contextlib
import os
import secrets as _secrets
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from rafiki_tpu_torch import chaos
from rafiki_tpu_torch.advisor import AdvisorService
from rafiki_tpu_torch.advisor.app import AdvisorApp
from rafiki_tpu_torch.constants import ServiceStatus, ServiceType, TrainJobStatus, TrialStatus
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.obs import context as trace_context
from rafiki_tpu_torch.obs.journal import journal as _journal
from rafiki_tpu_torch.scheduler.local import TrainJobResult
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.backend import resolve_device
from rafiki_tpu_torch.utils.events import events
from rafiki_tpu_torch.utils.httpd import start_server

#: The directory holding the ``rafiki_tpu_torch`` package: put on the
#: workers' PYTHONPATH, so they import this checkout's package.
_PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


def _free_ports(n: int) -> List[int]:
    """n distinct free loopback ports: every probe socket stays open
    until all are chosen, so the OS cannot hand one port to two groups
    (the race against other processes between close and rank 0's bind
    is inherent, and absorbed by the init retry)."""
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def worker_device_env(platform: str, worker_index: int,
                      devices_per_trial: int = 1) -> Dict[str, str]:
    """Env vars that pin a worker subprocess to its own device set: on
    the card (any platform but ``"cpu"``), ``CUDA_VISIBLE_DEVICES`` of
    the ``devices_per_trial`` cards from ``worker_index *
    devices_per_trial``; on the CPU, ``RAFIKI_WORKER_DEVICE=cpu`` and no
    card visible, so nothing of the worker touches a card."""
    if platform != "cpu":
        first = worker_index * devices_per_trial
        return {"CUDA_VISIBLE_DEVICES": ",".join(str(first + j)
                                                 for j in range(devices_per_trial))}
    return {"RAFIKI_WORKER_DEVICE": "cpu", "CUDA_VISIBLE_DEVICES": ""}


class _WorkerGroup:
    """One worker slot's process set (leader and followers) and its
    restart bookkeeping. procs[0] is always the leader."""

    def __init__(self, index: int):
        self.index = index
        self.procs: List[subprocess.Popen] = []
        self.out_files: list = []
        self.service: Optional[dict] = None
        self.leader_worker_id = ""
        self.restarts = 0
        self.respawn_at: Optional[float] = None  # monotonic; None = live
        # When a follower was first seen exited rc=0 while the leader still
        # ran; None while the group is whole. See state().
        self.partial_exit_at: Optional[float] = None
        # Service rows of every dead predecessor in this slot: the
        # replacement sweeps them all (a restart that crashed before
        # adopting leaves the orphan bound to an older corpse).
        self.dead_services: List[str] = []

    # A follower that exits rc=0 mid-trial is as gone as one that crashed
    # (the leader's next collective will never complete), but a zero rc
    # can also be the tail of a clean group shutdown racing the poll. The
    # grace window separates the two: long enough for the leader's own
    # clean exit to land, far shorter than the collective timeout.
    FOLLOWER_EXIT_GRACE_S = 15.0

    def state(self) -> str:
        """'running' | 'ok' | 'failed'. A member dead non-zero while the
        leader has not exited cleanly fails the group at once; a member
        dead rc=0 while the leader lives fails it after the grace window."""
        rcs = [p.poll() for p in self.procs]
        if any(rc is None for rc in rcs):
            if any(rc not in (0, None) for rc in rcs) and rcs[0] != 0:
                return "failed"
            if rcs[0] is None and any(rc == 0 for rc in rcs[1:]):
                now = time.monotonic()
                if self.partial_exit_at is None:
                    self.partial_exit_at = now
                elif now - self.partial_exit_at > self._follower_exit_grace_s():
                    return "failed"
            else:
                self.partial_exit_at = None
            return "running"
        self.partial_exit_at = None
        return "ok" if rcs[0] == 0 else "failed"

    def _follower_exit_grace_s(self) -> float:
        return float(os.environ.get("RAFIKI_FOLLOWER_EXIT_GRACE_S", self.FOLLOWER_EXIT_GRACE_S))

    def terminate(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 10
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def collect(self, blame=lambda k, rc: rc != 0) -> List[str]:
        """Reap every process and read its output; returns descriptions
        of the members ``blame(member_index, rc)`` selects."""
        msgs = []
        for k, (p, f) in enumerate(zip(self.procs, self.out_files)):
            try:
                rc = p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
            f.seek(0)
            out = f.read()
            f.close()
            if blame(k, rc):
                label = f"worker {self.index}" if k == 0 else f"worker {self.index} follower {k}"
                msgs.append(f"{label} rc={rc}: {out[-2000:]}")
        self.procs, self.out_files = [], []
        return msgs

    def shutdown(self) -> List[str]:
        """Kill survivors and reap everything; returns the ORIGINAL
        failures only (members this teardown killed are not blamed)."""
        original = [p.poll() for p in self.procs]
        self.terminate()
        return self.collect(blame=lambda k, rc: original[k] not in (None, 0))


class ProcessScheduler:
    """LocalScheduler's ``run_train_job`` contract, with subprocess workers."""

    def __init__(self, store: MetaStore, params_store: ParamsStore,
                 db_path: Optional[str] = None, params_dir: Optional[str] = None,
                 advisor_service: Optional[AdvisorService] = None):
        self.store = store
        self.params_store = params_store
        # Subprocesses need filesystem paths, not live objects.
        self.db_path = str(db_path if db_path is not None else store.path)
        self.params_dir = str(params_dir if params_dir is not None else params_store.directory)
        self.advisors = advisor_service or AdvisorService()

    # -- advisor server ------------------------------------------------------

    def _start_advisor_server(self):
        secret = _secrets.token_hex(16)
        server, thread = start_server(AdvisorApp(self.advisors, secret=secret),
                                      name="advisor-http")
        return server, thread, secret, f"http://127.0.0.1:{server.server_port}"

    # -- the job -------------------------------------------------------------

    def run_train_job(
        self,
        job_id: str,
        n_workers: int = 1,
        devices_per_trial: int = 1,
        advisor_kind: str = "gp",
        platform: Optional[str] = None,
        stop_event: Optional[threading.Event] = None,
        poll_s: float = 0.5,
        multihost_processes: int = 1,
    ) -> TrainJobResult:
        """Run a train job in subprocess workers to budget exhaustion.
        ``platform`` is ``"cuda"`` (the default, which raises without a
        card before the job is marked RUNNING) or ``"cpu"``. Each of the
        ``n_workers`` groups has ``devices_per_trial x multihost_processes``
        ranks, one device each; a ``CHIP_COUNT`` (or ``GPU_COUNT``) budget
        caps the groups to the devices it grants."""
        t0 = time.monotonic()
        job = self.store.get_train_job(job_id)
        if job is None:
            raise KeyError(f"No train job {job_id!r}")
        platform = platform or "cuda"
        resolve_device("cpu" if platform == "cpu" else "cuda")
        # Job-level trace: the scheduler's records (spawns, deaths,
        # restarts) stitch under one id; each trial mints its own.
        trace_scope = contextlib.ExitStack()
        trace_scope.enter_context(trace_context.trace(trace_context.new_trace_id()))
        self.store.update_train_job_status(job_id, TrainJobStatus.RUNNING.value)
        events.emit("train_job_started", job_id=job_id, app=job["app"],
                    budget=job["budget"], scheduler="process")
        stop_event = stop_event or threading.Event()
        width = max(1, devices_per_trial) * max(1, multihost_processes)
        chip_budget = job["budget"].get("CHIP_COUNT") or job["budget"].get("GPU_COUNT")
        if chip_budget:
            n_workers = min(n_workers, max(1, int(chip_budget) // width))

        server, thread, secret, advisor_url = self._start_advisor_server()
        errors: List[str] = []
        try:
            subs = self.store.get_sub_train_jobs(job_id)
            if not subs:
                raise ValueError(f"Train job {job_id} has no sub jobs")
            for sub in subs:
                if stop_event.is_set():
                    self.store.update_sub_train_job(sub["id"],
                                                    status=TrainJobStatus.STOPPED.value)
                    continue
                self._run_sub_job(sub, job, n_workers, width, advisor_kind, platform,
                                  advisor_url, secret, stop_event, poll_s, errors)
        except BaseException:
            # Never leave the job RUNNING: mark it terminal, then re-raise.
            self.store.update_train_job_status(job_id, TrainJobStatus.ERRORED.value)
            events.emit("train_job_finished", job_id=job_id,
                        status=TrainJobStatus.ERRORED.value,
                        duration_s=round(time.monotonic() - t0, 3))
            raise
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=5)
            trace_scope.close()

        subs_after = self.store.get_sub_train_jobs(job_id)
        if stop_event.is_set():
            status = TrainJobStatus.STOPPED.value
        elif subs_after and all(s["status"] == TrainJobStatus.ERRORED.value
                                for s in subs_after):
            status = TrainJobStatus.ERRORED.value
        else:
            status = TrainJobStatus.COMPLETED.value
        self.store.update_train_job_status(job_id, status)
        dur_s = time.monotonic() - t0
        events.emit("train_job_finished", job_id=job_id, status=status,
                    duration_s=round(dur_s, 3))
        return TrainJobResult(
            job_id=job_id, status=status,
            trials=self.store.get_trials_of_train_job(job_id),
            best_trials=self.store.get_best_trials_of_train_job(job_id, limit=2),
            duration_s=dur_s, errors=errors)

    def _spawn_group(self, g: _WorkerGroup, ctx: dict, port: Optional[int] = None) -> None:
        """(Re)spawn one worker group: a fresh service row, a fresh leader
        worker id (``-r<attempt>`` on restarts) and, on a restart, the
        adopt list of the dead predecessors' service rows."""
        job, sub, platform, width = ctx["job"], ctx["sub"], ctx["platform"], ctx["width"]
        g.partial_exit_at = None  # a fresh process set, a fresh grace
        service = self.store.create_service(
            ServiceType.TRAIN_WORKER.value, job_id=job["id"], worker_index=g.index,
            devices=[f"{platform}:{g.index * width + j}" for j in range(width)])
        g.service = service
        leader_worker_id = f"{job['id'][:8]}-p{g.index}" + (
            f"-r{g.restarts}" if g.restarts else "")
        g.leader_worker_id = leader_worker_id
        for j in range(width):
            env = dict(os.environ)
            env.update(worker_device_env(platform, g.index * width + j, 1))
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
            env.update({
                "RAFIKI_WORKER_DB": self.db_path,
                "RAFIKI_WORKER_PARAMS_DIR": self.params_dir,
                "RAFIKI_WORKER_SUB_JOB_ID": sub["id"],
                "RAFIKI_WORKER_ID": leader_worker_id + (f".{j}" if j > 0 else ""),
                "RAFIKI_WORKER_SERVICE_ID": service["id"] if j == 0 else "",
                "RAFIKI_WORKER_ADVISOR_URL": ctx["advisor_url"],
                "RAFIKI_WORKER_ADVISOR_ID": ctx["advisor_id"],
                "RAFIKI_WORKER_ADVISOR_SECRET": ctx["secret"],
            })
            if j == 0 and g.dead_services:
                env["RAFIKI_WORKER_ADOPT_SERVICE_ID"] = ",".join(g.dead_services)
            if width > 1:
                env.update({
                    "RAFIKI_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "RAFIKI_NUM_PROCESSES": str(width),
                    "RAFIKI_PROCESS_ID": str(j),
                    "RAFIKI_LEADER_WORKER_ID": leader_worker_id,
                    "RAFIKI_LEADER_SERVICE_ID": service["id"],
                })
            if events.path is not None:  # the subprocess shares the event sink
                env["RAFIKI_EVENTS_DIR"] = str(events.path.parent)
            # The child journals into the same directory and adopts this
            # job's trace: the spawn edge of cross-process stitching.
            if _journal.configured:
                env["RAFIKI_LOG_DIR"] = str(_journal.log_dir)
            tid = trace_context.current_trace_id()
            if tid:
                env["RAFIKI_TRACE_ID"] = tid
            # Output to a temporary file, not a pipe: a full pipe would
            # block the worker's writes and deadlock the supervise loop.
            out_f = tempfile.TemporaryFile(mode="w+t")
            g.out_files.append(out_f)
            g.procs.append(subprocess.Popen(
                [sys.executable, "-m", "rafiki_tpu_torch.worker.main"],
                env=env, stdout=out_f, stderr=subprocess.STDOUT, text=True))
        self.store.update_service(service["id"], status=ServiceStatus.RUNNING.value)

    @staticmethod
    def _maybe_preempt(g: _WorkerGroup) -> None:
        """A ``scheduler.preempt`` fault on a live group's leader: ``term``
        = SIGTERM, ``kill`` = SIGKILL, ``preempt`` = SIGTERM now and a
        SIGKILL after the fault's ``delay`` grace (a maintenance
        eviction's notice window)."""
        fault = chaos.decide("scheduler.preempt", key=f"w{g.index}")
        if fault is None or not g.procs:
            return
        leader = g.procs[0]
        events.emit("chaos_preempt", worker_index=g.index, mode=fault.mode)
        if fault.mode == "kill":
            leader.kill()
        elif fault.mode in ("term", "preempt"):
            leader.terminate()
            if fault.mode == "preempt":
                def _kill_after(p=leader, grace=fault.delay_s):
                    try:
                        p.wait(timeout=grace)
                    except subprocess.TimeoutExpired:
                        p.kill()

                threading.Thread(target=_kill_after, daemon=True,
                                 name=f"chaos-preempt-w{g.index}").start()

    def _run_sub_job(self, sub: dict, job: dict, n_workers: int, width: int,
                     advisor_kind: str, platform: str, advisor_url: str, secret: str,
                     stop_event: threading.Event, poll_s: float, errors: List[str]) -> None:
        sub_errors: List[str] = []  # this sub job's failures only
        model_row = self.store.get_model(sub["model_id"])
        try:  # validate the template before spending processes on it
            model_cls = load_model_class(model_row["model_file"], model_row["model_class"])
        except Exception as e:
            self.store.update_sub_train_job(sub["id"], status=TrainJobStatus.ERRORED.value)
            errors.append(f"model {model_row['name']}: {e}")
            return
        advisor_id = self.advisors.create_advisor(
            model_cls.get_knob_config(), kind=advisor_kind,
            advisor_id=sub.get("advisor_id") or None)
        self.store.update_sub_train_job(sub["id"], advisor_id=advisor_id,
                                        status=TrainJobStatus.RUNNING.value)
        ctx = dict(sub=sub, job=job, platform=platform, width=width, advisor_url=advisor_url,
                   advisor_id=advisor_id, secret=secret)
        ports = _free_ports(n_workers) if width > 1 else [None] * n_workers
        groups = []
        for i in range(n_workers):
            g = _WorkerGroup(i)
            self._spawn_group(g, ctx, port=ports[i])
            groups.append(g)

        # Supervise with in-job elasticity (the analog of the reference's
        # Swarm restart policy): module doc.
        max_restarts = int(os.environ.get("RAFIKI_WORKER_MAX_RESTARTS", "2"))
        backoff0 = float(os.environ.get("RAFIKI_WORKER_RESTART_BACKOFF_S", "0.5"))
        abandoned_services: set = set()  # corpses with no replacement coming
        while groups:
            if stop_event.is_set():
                for g in groups:
                    g.terminate()
                stopped_services = set()
                for g in groups:
                    g.collect(blame=lambda k, rc: False)
                    if g.respawn_at is None:
                        # A live group's row goes STOPPED; one caught in its
                        # backoff keeps its ERRORED corpse row. Either way its
                        # orphans are terminated below: no replacement is
                        # coming for a stopped job's trials.
                        self.store.update_service(g.service["id"],
                                                  status=ServiceStatus.STOPPED.value)
                    stopped_services.add(g.service["id"])
                    stopped_services.update(g.dead_services)
                for t in self.store.get_trials_of_sub_train_job(sub["id"]):
                    if (t["status"] == TrialStatus.RUNNING.value
                            and t.get("service_id") in stopped_services):
                        self.store.mark_trial_as_terminated(t["id"])
                groups.clear()
                break
            now = time.monotonic()
            for g in list(groups):
                if g.respawn_at is not None:  # waiting out its backoff
                    if now < g.respawn_at:
                        continue
                    g.respawn_at = None
                    self._spawn_group(g, ctx, port=_free_ports(1)[0] if width > 1 else None)
                    events.emit("worker_restarted", job_id=job["id"], worker_index=g.index,
                                attempt=g.restarts, adopt_service_ids=list(g.dead_services))
                    continue
                state = g.state()
                if state == "running":
                    self._maybe_preempt(g)
                    continue
                if state == "ok":
                    # Non-zero follower exits after a clean leader exit are
                    # shutdown noise, recorded as events only.
                    for msg in g.collect():
                        events.emit("worker_exit_noise", job_id=job["id"],
                                    worker_index=g.index, detail=msg[:500])
                    self.store.update_service(g.service["id"],
                                              status=ServiceStatus.STOPPED.value)
                    groups.remove(g)
                    continue
                # failed: tear down, then restart or give up.
                failures = g.shutdown()
                if not failures and g.partial_exit_at is not None:
                    failures = [
                        f"worker {g.index}: follower exited rc=0 mid-trial while the leader "
                        f"lived; group failed after {g._follower_exit_grace_s():.0f}s grace"]
                g.partial_exit_at = None
                self.store.update_service(g.service["id"], status=ServiceStatus.ERRORED.value)
                # A flight record on the dead child's behalf: a SIGKILLed
                # worker runs no hook, so the scheduler dumps what it saw.
                from rafiki_tpu_torch.obs import recorder

                recorder.dump(f"worker_died:{g.leader_worker_id}",
                              extra={"worker_index": g.index, "service_id": g.service["id"],
                                     "restarts": g.restarts,
                                     "detail": failures[0][:500] if failures else ""})
                if g.restarts < max_restarts:
                    g.restarts += 1
                    g.dead_services.append(g.service["id"])
                    backoff_s = backoff0 * (2 ** (g.restarts - 1))
                    g.respawn_at = now + backoff_s
                    # The death-to-respawn gap is capacity paid for and not used.
                    from rafiki_tpu_torch.obs.ledger import ledger

                    ledger.add("downtime_s", backoff_s, entity=f"job:{job['id']}")
                    events.emit("worker_died", job_id=job["id"], worker_index=g.index,
                                restart_attempt=g.restarts, max_restarts=max_restarts,
                                detail=failures[0][:500] if failures else "")
                else:
                    sub_errors.extend(failures)
                    events.emit("worker_failed_permanently", job_id=job["id"],
                                worker_index=g.index, restarts=g.restarts)
                    abandoned_services.update(g.dead_services)
                    abandoned_services.add(g.service["id"])
                    groups.remove(g)
            if groups:
                time.sleep(poll_s)
        if abandoned_services:
            # No replacement is coming: the orphans would otherwise leave
            # the sub-job in limbo (and a later recovery sweep would re-run
            # a trial whose slot provably cannot stay alive).
            for t in self.store.get_trials_of_sub_train_job(sub["id"]):
                if (t["status"] == TrialStatus.RUNNING.value
                        and t.get("service_id") in abandoned_services):
                    self.store.mark_trial_as_errored(t["id"], "worker died; restarts exhausted")
        errors.extend(sub_errors)

        trials = self.store.get_trials_of_sub_train_job(sub["id"])
        if stop_event.is_set():
            sub_status = TrainJobStatus.STOPPED.value
        elif trials and all(t["status"] == TrialStatus.ERRORED.value for t in trials):
            sub_status = TrainJobStatus.ERRORED.value
        elif not trials and sub_errors:
            sub_status = TrainJobStatus.ERRORED.value
        else:
            sub_status = TrainJobStatus.COMPLETED.value
        self.store.update_sub_train_job(sub["id"], status=sub_status)
        self.advisors.delete_advisor(advisor_id)
