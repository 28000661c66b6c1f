"""In-process scheduler: N worker threads, each owning one device.

The port's own copy of ``rafiki_tpu/scheduler/local.py``
(``LocalScheduler``, ``TrainJobResult``) with the same device math and
per-sub-job status rules. ``devices=None`` means every CUDA card
(``local_devices()``), and raises without one; pass
``devices=[torch.device("cpu")]`` to run a job on the CPU.
``devices_per_trial`` follows the JAX package's device arithmetic
(``rafiki_tpu/scheduler/local.py:79-121``, ``partition_devices``): with
k > 1 each thread worker owns a set of k devices and trains each trial
as one in-process dp mesh over them (``worker/train.py``,
``parallel/mesh.py LocalDataParallelMesh``). A device may repeat in
``devices``: ``[cpu, cpu]`` with k = 2 is one worker of two replicas on
the CPU, ``[cuda:0, cuda:0]`` two on one card. The ``ProcessScheduler``
runs a dp trial as one process per device instead.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.advisor import AdvisorService
from rafiki_tpu_torch.constants import ServiceStatus, ServiceType, TrainJobStatus, TrialStatus
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.parallel.mesh import local_devices, partition_devices
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.events import events
from rafiki_tpu_torch.worker.train import InProcAdvisorHandle, TrainWorker


@dataclass
class TrainJobResult:
    job_id: str
    status: str
    trials: List[dict]
    best_trials: List[dict]
    duration_s: float
    errors: List[str] = field(default_factory=list)


class LocalScheduler:
    def __init__(self, store: MetaStore, params_store: ParamsStore,
                 advisor_service: Optional[AdvisorService] = None):
        self.store = store
        self.params_store = params_store
        self.advisors = advisor_service or AdvisorService()

    def run_train_job(
        self,
        job_id: str,
        n_workers: Optional[int] = None,
        devices: Optional[List[Any]] = None,
        devices_per_trial: int = 1,
        advisor_kind: str = "gp",
        stop_event: Optional[threading.Event] = None,
        trial_pack: Optional[int] = None,
    ) -> TrainJobResult:
        """Run a train job to budget exhaustion. Blocking; thread-safe.

        Device math, the JAX package's: with D devices and
        ``devices_per_trial`` k there are D // k workers (at least one),
        each owning k devices, unless the job's CHIP_COUNT (or GPU_COUNT)
        budget or ``n_workers`` caps it lower; a worker of k > 1 devices
        trains each trial on an in-process dp mesh over them. With one
        device and k = 2 that is one worker of that device, at width 1.
        The per-model sub-jobs share the worker pool one
        after another; the budget is per sub-job, as in the reference.
        The devices are resolved before the job is marked RUNNING, so a
        missing card leaves the job as it was.

        ``trial_pack``: each worker trains up to k same-program trials as
        one stacked program on its device (None -> ``RAFIKI_TRIAL_PACK``,
        default 1 = off; docs/trial_packing.md). A worker that fails the
        packing eligibility checks runs its trials serially.
        """
        t0 = time.monotonic()
        job = self.store.get_train_job(job_id)
        if job is None:
            raise KeyError(f"No train job {job_id!r}")
        devices = list(devices) if devices is not None else local_devices()
        budget = dict(job["budget"])
        chip_budget = budget.get("CHIP_COUNT") or budget.get("GPU_COUNT")
        if chip_budget:
            devices = devices[: int(chip_budget) * devices_per_trial]
        max_workers = max(1, len(devices) // devices_per_trial)
        n_workers = min(n_workers or max_workers, max_workers)
        device_sets = partition_devices(devices[: n_workers * devices_per_trial], n_workers)

        self.store.update_train_job_status(job_id, TrainJobStatus.RUNNING.value)
        events.emit("train_job_started", job_id=job_id, app=job["app"],
                    budget=job["budget"], scheduler="local")
        stop_event = stop_event or threading.Event()
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
                advisor_id=sub.get("advisor_id") or None)
            self.store.update_sub_train_job(sub["id"], advisor_id=advisor_id,
                                            status=TrainJobStatus.RUNNING.value)

            threads = []
            services = []
            for i, dev_set in enumerate(device_sets):
                service = self.store.create_service(
                    ServiceType.TRAIN_WORKER.value, job_id=job_id, worker_index=i,
                    devices=[str(d) for d in dev_set])
                services.append(service)
                worker = TrainWorker(
                    self.store, self.params_store, sub["id"], model_cls,
                    InProcAdvisorHandle(self.advisors, advisor_id),
                    job["train_dataset_uri"], job["val_dataset_uri"], budget,
                    worker_id=f"{job_id[:8]}-w{i}", devices=dev_set,
                    job_created_at=job["created_at"], service_id=service["id"],
                    stop_event=stop_event, trial_pack=trial_pack,
                )
                threads.append(threading.Thread(target=self._run_worker, args=(worker, errors),
                                                name=f"train-worker-{i}", daemon=True))
            for svc in services:
                self.store.update_service(svc["id"], status=ServiceStatus.RUNNING.value)
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            for svc in services:
                self.store.update_service(svc["id"], status=ServiceStatus.STOPPED.value)
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
        telemetry.inc("scheduler.train_jobs_finished")
        dur_s = time.monotonic() - t0
        telemetry.observe("scheduler.train_job_s", dur_s)
        events.emit("train_job_finished", job_id=job_id, status=status,
                    duration_s=round(dur_s, 3))
        return TrainJobResult(
            job_id=job_id,
            status=status,
            trials=self.store.get_trials_of_train_job(job_id),
            best_trials=self.store.get_best_trials_of_train_job(job_id, limit=2),
            duration_s=dur_s,
            errors=errors,
        )

    @staticmethod
    def _run_worker(worker: TrainWorker, errors: List[str]) -> None:
        telemetry.add_gauge("scheduler.active_workers", 1)
        try:
            worker.run()
        except Exception as e:  # worker crash != job crash; trials already contained
            errors.append(f"worker {worker.worker_id}: {e!r}")
        finally:
            telemetry.add_gauge("scheduler.active_workers", -1)
