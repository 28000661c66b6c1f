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
(``utils/backend.resolve_device``). The device scope is thread-local,
so the manager opens it in every thread it starts (the train job's,
the inference workers') and wherever it builds a model.

The route decision of each inference job is journaled
(``serving/route``, as in the JAX package) and evented
(``inference_route``, the port's own event).

The resume reaper (``start_resume_reaper``, ``RAFIKI_RESUME_POLL_S``)
watches for RUNNING jobs whose sweep supervisor stopped heartbeating and
adopts each through ``scheduler/recovery.py resume_sweep`` on the
manager's device.

Not in the port yet: compile prewarm, the job admission gate, co-hosted
serving and autoscale.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from rafiki_tpu_torch.advisor import AdvisorService
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
from rafiki_tpu_torch.parallel.serving import build_stacked
from rafiki_tpu_torch.predictor.app import start_predictor_server
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.scheduler.local import LocalScheduler
from rafiki_tpu_torch.store import MetaStore, ParamsStore
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
        self._reaper_thread: Optional[threading.Thread] = None
        self._reaper_stop: Optional[threading.Event] = None
        self._resuming: set = set()

    # -- train services ------------------------------------------------------

    def create_train_services(self, job_id: str, advisor_kind: str = "gp",
                              devices_per_trial: int = 1) -> None:
        """Start the job's worker fleet in the background and return: one
        worker on the manager's device, or one per ``devices_per_trial``
        cards when that device is plain ``cuda``."""
        with self._lock:
            if job_id in self._train_jobs and self._train_jobs[job_id].thread.is_alive():
                raise ValueError(f"Train job {job_id} already has running services")
        devices = None if self.device == torch.device("cuda") else [self.device]
        scheduler = LocalScheduler(self.store, self.params_store, self.advisors)
        stop_event = threading.Event()

        def run():
            try:
                with default_device(self.device):
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

    def create_inference_services(self, inference_job_id: str,
                                  best_trials: List[dict],
                                  gateway_overrides: Optional[Dict[str, Any]] = None
                                  ) -> Predictor:
        """One inference worker per trial (or one over the stacked
        top-k) + a predictor over the bus fronted by a serving Gateway,
        plus a published HTTP frontend whose host:port is recorded on
        the inference-job row.

        ``gateway_overrides`` lets a job pick its own routing policy and
        limits (e.g. ``{"policy": "least-loaded", "max_batch": 8}``)
        over the framework-config defaults."""
        if not best_trials:
            raise ValueError("No completed trials to serve")
        # Reject bad overrides before any model is loaded.
        gw_config = GatewayConfig.from_config(self.config, **(gateway_overrides or {}))
        handle = _InferenceJobHandle()
        try:
            return self._start_inference(handle, inference_job_id, best_trials, gw_config)
        except Exception:
            # Tear down whatever already started — otherwise worker
            # threads (each pinning a trained model) leak unreachably.
            self._teardown(handle, timeout=5.0)
            raise

    def _start_inference(self, handle: _InferenceJobHandle, inference_job_id: str,
                         best_trials: List[dict], gw_config: GatewayConfig) -> Predictor:
        batch_size = self.config.inference_batch_size
        models = [self._load_trial_model(t) for t in best_trials]
        # Same-architecture top-k -> ONE worker running a stacked vmapped
        # forward; otherwise one worker per trial.
        # RAFIKI_STACKED_SERVING=0 forces the replicated route.
        stacked, route_reason = None, "disabled-by-env"
        if os.environ.get("RAFIKI_STACKED_SERVING", "1").lower() not in (
                "0", "false", "no", "off"):
            stacked, route_reason = build_stacked(best_trials, models, batch_size=batch_size)
        serve_models = [stacked] if stacked is not None else models
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
        handle.gateway = Gateway(handle.predictor, gw_config)
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
        with self._lock:
            self._inference_jobs[inference_job_id] = handle
        return handle.predictor

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

    def stop_inference_services(self, inference_job_id: str,
                                timeout: float = 10.0) -> None:
        with self._lock:
            handle = self._inference_jobs.pop(inference_job_id, None)
        if handle is None:
            self.store.update_inference_job(inference_job_id,
                                            status=InferenceJobStatus.STOPPED.value)
            return
        if handle.gateway is not None:
            # Graceful drain BEFORE the workers stop: in-flight requests
            # finish against live workers; new arrivals shed immediately.
            handle.gateway.drain(timeout=min(timeout, 5.0))
        self._teardown(handle, timeout)
        self.store.update_inference_job(inference_job_id,
                                        status=InferenceJobStatus.STOPPED.value)
        events.emit("inference_job_stopped", job_id=inference_job_id)

    @staticmethod
    def _teardown(handle: _InferenceJobHandle, timeout: float) -> None:
        """Stop the workers, the microbatch flusher and the HTTP
        frontend (its listening socket is released now), then free the
        models of the workers that stopped."""
        handle.stop_event.set()
        for th in handle.worker_threads:
            if th.ident is not None:  # join only threads that started
                th.join(timeout=timeout)
        if handle.gateway is not None:
            handle.gateway.close()
        if handle.http_server is not None:
            handle.http_server.shutdown()
            handle.http_server.server_close()
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
