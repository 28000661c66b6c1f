"""Services manager: jobs -> running services on the host.

The port's own copy of ``rafiki_tpu/admin/services_manager.py``: a train
job becomes a background thread driving ``LocalScheduler`` to budget
exhaustion (stoppable); an inference job becomes one inference worker
per chosen trial, or ONE worker over the stacked top-k
(``parallel/serving.py build_stacked``) when the trials share an
architecture, a ``Predictor`` over the bus, a serving ``Gateway`` and a
published HTTP predictor whose host:port is recorded on the job's row.
Service rows are written as the JAX package writes them.

The manager holds one device: CUDA unless the caller asks for the CPU
(``utils/backend.resolve_device``). A train job's ``devices_per_trial``
k gives each worker k cards, or, on a manager pinned to one device, one
worker of k replicas on it (an in-process dp mesh). An inference job's
stacked route takes no devices (``build_stacked``), as the JAX package's
manager passes none (``rafiki_tpu/admin/services_manager.py:337``). The
device scope is thread-local, so the manager opens it in every thread it
starts (the train job's, the inference workers') and wherever it builds
a model.

The route decision of each inference job is journaled
(``serving/route``, as in the JAX package) and evented
(``inference_route``, the port's own event).

The resume reaper (``start_resume_reaper``, ``RAFIKI_RESUME_POLL_S``)
watches for RUNNING jobs whose sweep supervisor stopped heartbeating and
adopts each through ``scheduler/recovery.py resume_sweep`` on the
manager's device.

An inference job may take a ``tenancy.TenantFabric`` (a tenant-aware
gateway). ``create_cohosted_inference_services`` serves several jobs
from ONE worker behind a ``tenancy.ProgramHost``: each job's trials load
(stacked when they share an architecture) on the first query that needs
them, under an LRU HBM byte budget (``tenancy.ResidencyManager``), each
charged its params blobs' bytes, floored at 1 MiB.

Every load, stack and ``destroy`` of a served model takes the card's
lock (``ops/graphs.py card_lock``), as a trainer's synchronizing calls
do: the dedicated route's, the co-hosted route's, a residency eviction's
and a scale-up replica's. A template's ``destroy`` may synchronize the
card, and a synchronize or an allocation inside another thread's epoch
capture would invalidate it. The stacked forward's capture itself runs
on the card's serving thread (``parallel/serving.py``), which takes the
lock there, so the warmup runs outside it.

With ``RAFIKI_AUTOSCALE_PREWARM=1`` a train job's admission pre-warms
its packed programs (``autoscale/prewarm.py``). ``attach_job_gate``
puts a ``tenancy.JobAdmissionGate`` in front of every new inference job
that declares a tenant: the job's load is forecast through the serving
twin and a job that would breach another tenant's p99 budget raises
``JobRejected`` before any service starts. ``attach_autoscaler`` closes
the loop over a running inference job (``autoscale/``): a scale-up
replica of the job's serving shape (the stacked ensemble or its best
trial) is built on the manager's device, and a drained replica's model
is freed.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.advisor import AdvisorService
from rafiki_tpu_torch.autoscale import actuators as _actuators
from rafiki_tpu_torch.autoscale import controller as _asc
from rafiki_tpu_torch.autoscale import prewarm as _prewarm
from rafiki_tpu_torch.bus.queues import InProcBus
from rafiki_tpu_torch.config import Config, get_config
from rafiki_tpu_torch.constants import (
    InferenceJobStatus,
    ServiceStatus,
    ServiceType,
    TrainJobStatus,
)
from rafiki_tpu_torch.gateway import Gateway, GatewayConfig
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.obs.journal import journal as _journal
from rafiki_tpu_torch.ops.graphs import card_lock
from rafiki_tpu_torch.parallel.serving import build_stacked
from rafiki_tpu_torch.predictor.app import start_predictor_server
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.scheduler.local import LocalScheduler
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.tenancy.arbiter import tenant_pressure
from rafiki_tpu_torch.tenancy.hosting import ProgramHost, ProgramSpec, TrialEnsemble
from rafiki_tpu_torch.tenancy.qos import DEFAULT_TIER
from rafiki_tpu_torch.tenancy.residency import ResidencyManager
from rafiki_tpu_torch.utils import heap
from rafiki_tpu_torch.utils.backend import DeviceLike, default_device, resolve_device
from rafiki_tpu_torch.utils.events import events
from rafiki_tpu_torch.worker.inference import InferenceWorker


class _TrainJobHandle:
    def __init__(self, thread: threading.Thread, stop_event: threading.Event):
        self.thread = thread
        self.stop_event = stop_event


class _InferenceJobHandle:
    def __init__(self):
        self.stop_event = threading.Event()
        self.worker_threads: List[threading.Thread] = []
        self.workers: List[InferenceWorker] = []
        self.predictor: Optional[Predictor] = None
        self.gateway: Optional[Gateway] = None
        self.http_server = None  # set when an HTTP frontend is attached
        self.heap_frozen = False  # holds a utils/heap.py freeze while serving
        # Autoscale attachment: the serving shape a scale-up replica
        # must reproduce, and the live controller.
        self.best_trials: List[dict] = []
        self.batch_size: int = 0
        self.stacked_route: bool = False
        self.autoscaler = None  # AutoscaleController when attached


class ServicesManager:
    def __init__(self, store: MetaStore, params_store: ParamsStore,
                 config: Optional[Config] = None, device: DeviceLike = None):
        self.store = store
        self.params_store = params_store
        self.bus = InProcBus()
        self.advisors = AdvisorService()
        self.config = config or get_config()
        self.device = resolve_device(device)
        self._train_jobs: Dict[str, _TrainJobHandle] = {}
        self._inference_jobs: Dict[str, _InferenceJobHandle] = {}
        self._lock = threading.Lock()
        # Fleet-level tenant arbitration: with a JobAdmissionGate
        # attached, create_inference_services forecasts every NEW job
        # that declares a tenant through the serving twin first.
        self.job_gate = None
        self._reaper_thread: Optional[threading.Thread] = None
        self._reaper_stop: Optional[threading.Event] = None
        self._resuming: set = set()

    # -- train services ------------------------------------------------------

    def create_train_services(self, job_id: str, advisor_kind: str = "gp",
                              devices_per_trial: int = 1) -> None:
        """Start the job's worker fleet in the background and return: one
        per ``devices_per_trial`` cards when the manager's device is plain
        ``cuda``, else one worker whose set is the manager's device
        ``devices_per_trial`` times over (an in-process dp mesh of that
        many replicas on it when more than one; ``scheduler/local.py``)."""
        with self._lock:
            if job_id in self._train_jobs and self._train_jobs[job_id].thread.is_alive():
                raise ValueError(f"Train job {job_id} already has running services")
        devices = None if self.device == torch.device("cuda") \
            else [self.device] * max(1, int(devices_per_trial))
        scheduler = LocalScheduler(self.store, self.params_store, self.advisors)
        stop_event = threading.Event()

        def run():
            try:
                with default_device(self.device):
                    if _asc.prewarm_enabled():
                        # Admission-time pre-warm: each model's packed
                        # program is built BEFORE the sweep starts.
                        # Best-effort: admission never fails on it.
                        try:
                            _prewarm.prewarm_train_job(self.store, job_id)
                        except Exception:
                            telemetry.inc("autoscale.prewarm_errors")
                    scheduler.run_train_job(job_id, devices=devices,
                                            devices_per_trial=devices_per_trial,
                                            advisor_kind=advisor_kind, stop_event=stop_event)
            except BaseException as e:
                self.store.update_train_job_status(job_id, TrainJobStatus.ERRORED.value)
                events.emit("train_job_errored", job_id=job_id, error=repr(e))
                if not isinstance(e, Exception):
                    raise  # interrupts keep propagating after being recorded

        thread = threading.Thread(target=run, name=f"train-job-{job_id[:8]}", daemon=True)
        handle = _TrainJobHandle(thread, stop_event)
        with self._lock:
            self._train_jobs[job_id] = handle
        thread.start()

    def stop_train_services(self, job_id: str, wait: bool = True,
                            timeout: float = 60.0) -> None:
        with self._lock:
            handle = self._train_jobs.get(job_id)
        if handle is None:
            # No live services in this process (e.g. admin restarted):
            # mark the job stopped — but never clobber a terminal state.
            job = self.store.get_train_job(job_id)
            if job is not None and job["status"] in (TrainJobStatus.STARTED.value,
                                                     TrainJobStatus.RUNNING.value):
                self.store.update_train_job_status(job_id, TrainJobStatus.STOPPED.value)
            return
        handle.stop_event.set()
        if wait:
            handle.thread.join(timeout=timeout)

    # -- crash recovery (docs/recovery.md) -----------------------------------

    def start_resume_reaper(self, poll_s: Optional[float] = None,
                            stale_after_s: Optional[float] = None) -> None:
        """Watch for RUNNING jobs whose sweep supervisor stopped
        heartbeating (a crashed or SIGKILLed supervisor process leaves its
        SUPERVISOR service row going stale) and adopt them through
        ``resume_sweep``, on the manager's device. Poll cadence from
        ``RAFIKI_RESUME_POLL_S``, liveness cutoff from
        ``RAFIKI_RESUME_STALE_S`` unless given. Idempotent: a second start
        while the reaper runs is a no-op, and a job being resumed (here or
        by a racing resumer: the CAS adoption settles that) is never
        picked up twice."""
        from rafiki_tpu_torch.scheduler.recovery import (ENV_RESUME_POLL_S, ENV_RESUME_STALE_S,
                                                         resume_sweep)

        if self._reaper_thread is not None and self._reaper_thread.is_alive():
            return
        poll = float(poll_s if poll_s is not None else os.environ.get(ENV_RESUME_POLL_S, "10"))
        stale = float(stale_after_s if stale_after_s is not None
                      else os.environ.get(ENV_RESUME_STALE_S, "30"))
        devices = None if self.device == torch.device("cuda") else [self.device]
        stop = threading.Event()

        def loop():
            while not stop.wait(poll):
                try:
                    dead = self.store.get_jobs_with_dead_supervisor(stale)
                except Exception:
                    continue  # a transient store error: the next tick retries
                for job in dead:
                    jid = job["id"]
                    with self._lock:
                        handle = self._train_jobs.get(jid)
                        if handle is not None and handle.thread.is_alive():
                            # Our own live services: the job is not
                            # abandoned, only its heartbeat is.
                            continue
                        if jid in self._resuming:
                            continue
                        self._resuming.add(jid)
                    _journal.record("recovery", "reaper_detected", job_id=jid,
                                    stale_after_s=stale)
                    events.emit("supervisor_dead_detected", job_id=jid)
                    try:
                        with default_device(self.device):
                            resume_sweep(self.store, self.params_store, jid,
                                         stale_after_s=stale, devices=devices,
                                         advisor_service=self.advisors)
                    except Exception as e:
                        # A failed resume must not kill the reaper: the job
                        # stays adoptable and the next pass (or a manual
                        # `sweep_proc resume`) retries.
                        _journal.record("recovery", "reaper_resume_failed", job_id=jid,
                                        error=repr(e))
                    finally:
                        with self._lock:
                            self._resuming.discard(jid)

        self._reaper_stop = stop
        self._reaper_thread = threading.Thread(target=loop, name="resume-reaper", daemon=True)
        self._reaper_thread.start()

    def stop_resume_reaper(self, timeout: float = 10.0) -> None:
        if self._reaper_stop is not None:
            self._reaper_stop.set()
        if self._reaper_thread is not None:
            self._reaper_thread.join(timeout=timeout)
        self._reaper_thread = None
        self._reaper_stop = None

    # -- inference services --------------------------------------------------

    def attach_job_gate(self, gate) -> None:
        """Attach a :class:`~rafiki_tpu_torch.tenancy.arbiter.
        JobAdmissionGate`: from now on every new inference job that
        declares a tenant is forecast through the twin first, and a job
        whose load would breach an existing tenant's p99 budget raises
        ``JobRejected`` instead of starting services."""
        self.job_gate = gate

    def create_inference_services(self, inference_job_id: str,
                                  best_trials: List[dict],
                                  gateway_overrides: Optional[Dict[str, Any]] = None,
                                  tenancy=None, tenant: Optional[str] = None,
                                  tier: Optional[str] = None,
                                  expected_qps: float = 0.0) -> Predictor:
        """One inference worker per trial (or one over the stacked
        top-k) + a predictor over the bus fronted by a serving Gateway,
        plus a published HTTP frontend whose host:port is recorded on
        the inference-job row.

        ``gateway_overrides`` lets a job pick its own routing policy and
        limits (e.g. ``{"policy": "least-loaded", "max_batch": 8}``)
        over the framework-config defaults. ``tenancy`` (a
        ``TenantFabric``) makes the gateway tenant-aware: weighted-fair
        admission and per-tenant accounting. ``tenant``/``tier``/
        ``expected_qps`` declare whose load this job is: with a job gate
        attached, the declared load is twin-forecast against the fleet
        and the job can be REJECTED before any service starts."""
        if not best_trials:
            raise ValueError("No completed trials to serve")
        # Reject bad overrides before any model is loaded.
        gw_config = GatewayConfig.from_config(self.config, **(gateway_overrides or {}))
        if self.job_gate is not None and tenant is not None:
            # Raises JobRejected (journaling tenancy/arbiter) when the
            # forecast breaches an existing tenant's budget.
            self.job_gate.admit_job(inference_job_id, tenant, tier or DEFAULT_TIER,
                                    expected_qps)
        handle = _InferenceJobHandle()
        try:
            return self._start_inference(handle, inference_job_id, best_trials, gw_config,
                                         tenancy)
        except Exception:
            # Tear down whatever already started — otherwise worker
            # threads (each pinning a trained model) leak unreachably.
            self._teardown(handle, timeout=5.0)
            raise

    def _start_inference(self, handle: _InferenceJobHandle, inference_job_id: str,
                         best_trials: List[dict], gw_config: GatewayConfig,
                         tenancy=None) -> Predictor:
        batch_size = self.config.inference_batch_size
        # Same-architecture top-k -> ONE worker running a stacked vmapped
        # forward; otherwise one worker per trial.
        # RAFIKI_STACKED_SERVING=0 forces the replicated route.
        stacked, route_reason = None, "disabled-by-env"
        with card_lock(self):
            models = [self._load_trial_model(t) for t in best_trials]
            if os.environ.get("RAFIKI_STACKED_SERVING", "1").lower() not in (
                    "0", "false", "no", "off"):
                stacked, route_reason = build_stacked(best_trials, models,
                                                      batch_size=batch_size)
        serve_models = [stacked] if stacked is not None else models
        handle.best_trials = list(best_trials)
        handle.batch_size = batch_size
        handle.stacked_route = stacked is not None
        warmup_s = None
        if stacked is not None:
            # The stacked forward's first-call costs are paid HERE, at
            # service creation, never by the first live request.
            warmup_s = round(stacked.warmup(), 6)
            events.emit("inference_stacked", job_id=inference_job_id, k=len(best_trials))
        # The route decision: which serving shape this job got and why.
        route = dict(job_id=inference_job_id,
                     route="stacked" if stacked is not None else "replicated",
                     reason=route_reason, k=len(best_trials), workers=len(serve_models),
                     warmup_s=warmup_s)
        _journal.record("serving", "route", **route)
        events.emit("inference_route", **route)

        for i, model in enumerate(serve_models):
            worker_id = f"{inference_job_id[:8]}-iw{i}"
            service = self.store.create_service(
                ServiceType.INFERENCE_WORKER.value, job_id=inference_job_id,
                worker_index=i)
            worker = InferenceWorker(self.bus, inference_job_id, worker_id, model,
                                     batch_size=batch_size, stop_event=handle.stop_event)
            th = threading.Thread(target=self._run_inference_worker,
                                  args=(worker, service["id"]), name=worker_id, daemon=True)
            handle.workers.append(worker)
            handle.worker_threads.append(th)

        self.store.create_service(ServiceType.PREDICTOR.value, job_id=inference_job_id)
        handle.predictor = Predictor(self.bus, inference_job_id,
                                     timeout_s=self.config.predict_timeout_s)
        handle.gateway = Gateway(handle.predictor, gw_config, tenancy=tenancy)
        for th in handle.worker_threads:
            th.start()
        # Wait for workers to register so the first query doesn't race them.
        t0 = time.monotonic()
        while (len(self.bus.get_workers(inference_job_id)) < len(serve_models)
               and time.monotonic() - t0 < 5.0):
            time.sleep(0.01)
        handle.http_server, predictor_host = start_predictor_server(
            handle.gateway, host=self.config.admin_host)
        # A wildcard bind address is unroutable for clients: advertise
        # a reachable address instead.
        bind_host, _, port = predictor_host.rpartition(":")
        if bind_host in ("0.0.0.0", "::", ""):
            try:
                advertise = socket.gethostbyname(socket.gethostname())
            except OSError:
                advertise = "127.0.0.1"
            predictor_host = f"{advertise}:{port}"
        self.store.update_inference_job(inference_job_id,
                                        status=InferenceJobStatus.RUNNING.value,
                                        predictor_host=predictor_host)
        events.emit("inference_job_started", job_id=inference_job_id,
                    n_workers=len(best_trials), predictor_host=predictor_host)
        # The heap built so far is the server's: out of the collector's
        # full scans while it serves (utils/heap.py).
        heap.freeze()
        handle.heap_frozen = True
        with self._lock:
            self._inference_jobs[inference_job_id] = handle
        return handle.predictor

    # -- co-hosted serving ----------------------------------------------------

    def _make_program_loader(self, trials: List[dict], batch_size: int):
        """A lazy model loader for one co-hosted job: it runs on a
        residency MISS (the job's first query, or its first after an
        eviction), never at service creation, so a cold job holds no
        card memory. The load takes the card's lock (module doc).
        Trials that cannot stack are served as a :class:`TrialEnsemble`
        (the JAX package serves the first trial alone, ROADMAP Queue 3)."""
        def load():
            with card_lock(self):
                models = [self._load_trial_model(t) for t in trials]
                if len(models) == 1:
                    return models[0]
                stacked, _ = build_stacked(trials, models, batch_size=batch_size)
                return stacked if stacked is not None else TrialEnsemble(models)

        return load

    def create_cohosted_inference_services(
            self, job_trials: Dict[str, List[dict]],
            gateway_overrides: Optional[Dict[str, Any]] = None,
            hbm_budget_bytes: Optional[int] = None) -> Dict[str, Predictor]:
        """ONE inference worker serving EVERY job in ``job_trials``
        behind a ``ProgramHost``: models swap in and out of a shared HBM
        byte budget by LRU residency (journaled ``tenancy/residency``)
        instead of each job pinning a worker. Each job keeps its OWN
        Predictor and Gateway (admission, QoS and metrics stay per job);
        the predictor tags queries with the job's program id and the
        host routes them. The gateways are not tenant-aware. No HTTP
        frontend is published.

        Returns ``{job_id: Predictor}``. The worker is owned by the
        FIRST job's handle and the cohort shares one stop event, so
        stopping ANY co-hosted job stops serving for all of them:
        co-hosting trades isolation of failures for card memory."""
        if not job_trials:
            raise ValueError("No jobs to co-host")
        gw_config = GatewayConfig.from_config(self.config, **(gateway_overrides or {}))
        batch_size = self.config.inference_batch_size
        job_ids = list(job_trials)
        specs = []
        for job_id, trials in job_trials.items():
            if not trials:
                raise ValueError(f"Job {job_id} has no completed trials")
            # The HBM charge: the params blobs' bytes, floored (a charge
            # of 0 would make eviction free).
            size = sum(self.params_store.size(t["params_id"])
                       for t in trials if t.get("params_id"))
            specs.append(ProgramSpec(program_id=job_id,
                                     loader=self._make_program_loader(list(trials), batch_size),
                                     size_bytes=max(size, 1 << 20)))
        host = ProgramHost(specs, residency=ResidencyManager(hbm_budget_bytes))
        primary, extras = job_ids[0], job_ids[1:]
        worker_id = f"cohost-{primary[:8]}-iw0"
        stop_event = threading.Event()
        worker = InferenceWorker(self.bus, primary, worker_id, host, batch_size=batch_size,
                                 stop_event=stop_event, extra_job_ids=extras)
        service = self.store.create_service(ServiceType.INFERENCE_WORKER.value,
                                            job_id=primary, worker_index=0)
        th = threading.Thread(target=self._run_inference_worker, args=(worker, service["id"]),
                              name=worker_id, daemon=True)
        th.start()
        _journal.record("tenancy", "cohost", worker_id=worker_id, jobs=list(job_ids),
                        budget_bytes=host.residency.budget_bytes)
        # Wait for the worker to register under every co-hosted job id
        # so the first query doesn't race registration.
        t0 = time.monotonic()
        while (any(worker_id not in self.bus.get_workers(j) for j in job_ids)
               and time.monotonic() - t0 < 5.0):
            time.sleep(0.01)
        # One heap freeze for the cohort (utils/heap.py), held by the
        # primary's handle: the cohort stops together.
        heap.freeze()
        predictors: Dict[str, Predictor] = {}
        for job_id in job_ids:
            handle = _InferenceJobHandle()
            handle.stop_event = stop_event  # cohort-shared by design
            if job_id == primary:
                handle.workers.append(worker)
                handle.worker_threads.append(th)
                handle.heap_frozen = True
            handle.best_trials = list(job_trials[job_id])
            handle.batch_size = batch_size
            self.store.create_service(ServiceType.PREDICTOR.value, job_id=job_id)
            handle.predictor = Predictor(self.bus, job_id,
                                         timeout_s=self.config.predict_timeout_s,
                                         program=job_id)
            handle.gateway = Gateway(handle.predictor, gw_config)
            self.store.update_inference_job(job_id, status=InferenceJobStatus.RUNNING.value,
                                            predictor_host=None)
            events.emit("inference_job_started", job_id=job_id, n_workers=1,
                        predictor_host=None)
            with self._lock:
                self._inference_jobs[job_id] = handle
            predictors[job_id] = handle.predictor
        return predictors

    def _run_inference_worker(self, worker: InferenceWorker, service_id: str) -> None:
        self.store.update_service(service_id, status=ServiceStatus.RUNNING.value)
        try:
            with default_device(self.device):
                worker.run()
            self.store.update_service(service_id, status=ServiceStatus.STOPPED.value)
        except Exception:
            self.store.update_service(service_id, status=ServiceStatus.ERRORED.value)

    def _load_trial_model(self, trial: dict):
        """Rebuild a trained model from its trial row: class + knobs +
        params, on the manager's device."""
        sub = self.store.get_sub_train_job(trial["sub_train_job_id"])
        if sub is None:  # data-integrity failure, not a caller mistake
            raise RuntimeError(f"Trial {trial['id']} has no sub train job")
        model_row = self.store.get_model(sub["model_id"])
        model_cls = load_model_class(model_row["model_file"], model_row["model_class"])
        with default_device(self.device):
            model = model_cls(**trial["knobs"])
            if trial.get("params_id"):
                model.load_parameters(self.params_store.load(trial["params_id"]))
        return model

    def get_predictor(self, inference_job_id: str) -> Optional[Predictor]:
        with self._lock:
            handle = self._inference_jobs.get(inference_job_id)
        return handle.predictor if handle else None

    def get_gateway(self, inference_job_id: str) -> Optional[Gateway]:
        with self._lock:
            handle = self._inference_jobs.get(inference_job_id)
        return handle.gateway if handle else None

    # -- autoscale -------------------------------------------------------------

    def _spawn_scale_replica(self, handle: _InferenceJobHandle, inference_job_id: str,
                             index: int):
        """Build one scale-up replica of the job's serving shape: the
        stacked ensemble when that route was taken (one worker = the
        whole ensemble, its forward captured by the warmup on the card's
        serving thread), otherwise the best trial's model. The load and
        stack take the card's lock (module doc). Own stop event: the
        autoscaler drains replicas one at a time, never through the
        job-wide event."""
        with card_lock(self):
            if handle.stacked_route:
                models = [self._load_trial_model(t) for t in handle.best_trials]
                stacked, _ = build_stacked(handle.best_trials, models,
                                           batch_size=handle.batch_size)
                model = stacked if stacked is not None else models[0]
            else:
                stacked, model = None, self._load_trial_model(handle.best_trials[0])
        if stacked is not None:
            stacked.warmup()
        worker_id = f"{inference_job_id[:8]}-as{index}"
        service = self.store.create_service(
            ServiceType.INFERENCE_WORKER.value, job_id=inference_job_id,
            worker_index=1000 + index)
        worker = InferenceWorker(self.bus, inference_job_id, worker_id, model,
                                 batch_size=handle.batch_size)
        th = threading.Thread(target=self._run_inference_worker, args=(worker, service["id"]),
                              name=worker_id, daemon=True)
        th.start()
        handle.workers.append(worker)
        handle.worker_threads.append(th)
        return worker_id, worker, th

    def _free_scale_replica(self, handle: _InferenceJobHandle, worker: InferenceWorker,
                            thread: Optional[threading.Thread]) -> None:
        """A drained replica leaves the job's handle and its model is
        destroyed under the card's lock: for a stacked replica that
        drops its captured forward and its pool."""
        if worker in handle.workers:
            i = handle.workers.index(worker)
            handle.workers.pop(i)
            handle.worker_threads.pop(i)
        with card_lock(self):
            worker.model.destroy()

    def attach_autoscaler(self, inference_job_id: str,
                          min_workers: Optional[int] = None,
                          max_workers: Optional[int] = None,
                          tick_s: Optional[float] = None,
                          pregate_fn=None, start: bool = True,
                          **controller_kwargs):
        """Close the loop over a running inference job: SLO burn and
        gateway sensors in, replica spawn and drain out, every decision
        journaled. The baseline fleet is the floor by default: the
        controller only drains replicas it spawned (they carry their
        own stop events; the original workers share the job-wide one).
        Returns the (started) :class:`AutoscaleController`."""
        with self._lock:
            handle = self._inference_jobs.get(inference_job_id)
        if handle is None:
            raise ValueError(f"Inference job {inference_job_id} has no "
                             "running services in this process")
        baseline = [(w.worker_id, w, None) for w in handle.workers]
        lane = _actuators.InferenceWorkerLane(
            self.bus, inference_job_id,
            spawn_fn=lambda i: self._spawn_scale_replica(handle, inference_job_id, i),
            initial=baseline,
            free_fn=lambda wid, w, th: self._free_scale_replica(handle, w, th))
        overrides: Dict[str, Any] = {
            "min_size": len(baseline) if min_workers is None else min_workers}
        if max_workers is not None:
            overrides["max_size"] = max_workers
        spec = _asc.LaneSpec.from_env("inference", **overrides)
        if handle.gateway is not None and handle.gateway.tenancy is not None:
            # A tenant-aware fleet: the lane scales on the WORST of the
            # inference pressure and the tenant aggregates (worst
            # per-tenant burn, tenant shed rate): one tenant burning its
            # p99 budget is a capacity signal while the queue is calm.
            base_fn = spec.pressure_fn

            def _tenant_aware(sensors, _base=base_fn):
                bp, breason = _base(sensors)
                tp, treason = tenant_pressure(sensors)
                if bp is None or (tp is not None and tp > bp):
                    return tp, treason
                return bp, breason

            spec = dataclasses.replace(spec, pressure_fn=_tenant_aware)
        controller = _asc.AutoscaleController(
            lanes=[spec],
            sensor_fn=lambda: _asc.read_sensors(gateway=handle.gateway),
            actuators={"inference": lane},
            tick_s=tick_s, pregate_fn=pregate_fn, **controller_kwargs)
        handle.autoscaler = controller
        if start:
            controller.start()
        return controller

    def stop_inference_services(self, inference_job_id: str,
                                timeout: float = 10.0) -> None:
        with self._lock:
            handle = self._inference_jobs.pop(inference_job_id, None)
        if handle is None:
            self.store.update_inference_job(inference_job_id,
                                            status=InferenceJobStatus.STOPPED.value)
            return
        if handle.autoscaler is not None:
            # The control loop stops FIRST: a controller reacting to the
            # drain's shed spike would fight the teardown.
            handle.autoscaler.stop()
        if handle.gateway is not None:
            # Graceful drain BEFORE the workers stop: in-flight requests
            # finish against live workers; new arrivals shed immediately.
            handle.gateway.drain(timeout=min(timeout, 5.0))
        self._teardown(handle, timeout)
        if handle.heap_frozen:
            heap.thaw()
        self.store.update_inference_job(inference_job_id,
                                        status=InferenceJobStatus.STOPPED.value)
        events.emit("inference_job_stopped", job_id=inference_job_id)

    def _teardown(self, handle: _InferenceJobHandle, timeout: float) -> None:
        """Stop the workers (a scale-up replica has its own stop event),
        the microbatch flusher and the HTTP frontend (its listening
        socket is released now), then free the models of the workers
        that stopped, under the card's lock (module doc)."""
        handle.stop_event.set()
        for worker in handle.workers:
            worker.stop()
        for th in handle.worker_threads:
            if th.ident is not None:  # join only threads that started
                th.join(timeout=timeout)
        if handle.gateway is not None:
            handle.gateway.close()
        if handle.http_server is not None:
            handle.http_server.shutdown()
            handle.http_server.server_close()
        with card_lock(self):
            for worker, th in zip(handle.workers, handle.worker_threads):
                if not th.is_alive():
                    worker.model.destroy()

    # -- teardown ------------------------------------------------------------

    def stop_all(self) -> None:
        self.stop_resume_reaper()
        with self._lock:
            train_ids = list(self._train_jobs)
            inf_ids = list(self._inference_jobs)
        for jid in train_ids:
            self.stop_train_services(jid, wait=False)
        for jid in inf_ids:
            self.stop_inference_services(jid)
        for jid in train_ids:
            self.stop_train_services(jid, wait=True)
