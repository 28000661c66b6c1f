"""Train worker: the trial loop.

The port's own copy of the serial path of ``rafiki_tpu/worker/train.py``:
poll budget -> propose knobs -> create the Trial row (claiming a budget
slot in the same transaction) -> ``model_class(**knobs)`` -> train ->
evaluate -> advisor feedback -> dump_parameters -> ParamsStore ->
mark completed. A failing trial is contained: ERRORED with
``diverged: ...`` for a :class:`DivergenceError`, with its traceback
otherwise, and the advisor hears a floor score of 0.0 either way. The
model's log entries land in TrialLog rows, and they double as a
throttled service heartbeat. Parameters persist on a background saver
thread while the next trial trains.

Device handling: a worker owns a device set (one card). Its trials run
inside ``utils.backend.default_device``, so a template built as
``model_class(**knobs)``, with no device argument, lands on the
worker's card (or on the CPU when the worker was given the CPU). With
``RAFIKI_PROFILE_DIR`` set, each trial records a ``torch.profiler``
Chrome trace under ``<dir>/<trial_id>/``.

Spans ``trial.total``/``build``/``train``/``evaluate``/``persist`` and
``trial.advisor_propose``; counters ``worker.trials_succeeded``,
``worker.trials_errored``, ``worker.feedback_errors`` and
``worker.saver_errors``.

Not ported yet: mid-trial checkpoints and resume, orphan adoption,
trial packing (``PackedTrialRunner``), the learning-curve coordinator
(early kill, speculation), and the chaos, journal, goodput-ledger and
trace-context hooks.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Protocol

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.config import get_config
from rafiki_tpu_torch.constants import BudgetType
from rafiki_tpu_torch.model.base import BaseModel
from rafiki_tpu_torch.model.knobs import Knobs, knob_config_signature
from rafiki_tpu_torch.model.log import logger
from rafiki_tpu_torch.obs.health import DivergenceError
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.backend import default_device
from rafiki_tpu_torch.utils.events import events


class AdvisorHandle(Protocol):
    """What the worker needs from an advisor, local or remote."""

    def propose(self) -> Knobs: ...

    def feedback(self, score: float, knobs: Knobs) -> None: ...


class InProcAdvisorHandle:
    def __init__(self, advisor_service, advisor_id: str):
        self._svc = advisor_service
        self._id = advisor_id

    def propose(self) -> Knobs:
        return self._svc.propose(self._id)

    def feedback(self, score: float, knobs: Knobs) -> None:
        self._svc.feedback(self._id, score, knobs)


class TrainWorker:
    def __init__(
        self,
        store: MetaStore,
        params_store: ParamsStore,
        sub_train_job_id: str,
        model_class: type,
        advisor: AdvisorHandle,
        train_dataset_uri: str,
        val_dataset_uri: str,
        budget: Dict[str, Any],
        worker_id: str = "worker-0",
        devices: Optional[List[Any]] = None,
        job_created_at: Optional[float] = None,
        service_id: Optional[str] = None,
        stop_event=None,
        async_persist: bool = True,
    ):
        if not (isinstance(model_class, type) and issubclass(model_class, BaseModel)):
            raise TypeError("model_class must subclass BaseModel")
        if devices is not None and len(devices) > 1:
            raise ValueError(
                f"a worker runs its trials on one device; got {len(devices)} "
                "(within-trial data parallelism is not ported)")
        self.store = store
        self.params_store = params_store
        self.sub_id = sub_train_job_id
        self.model_class = model_class
        self.advisor = advisor
        self.train_uri = train_dataset_uri
        self.val_uri = val_dataset_uri
        self.budget = dict(budget or {})
        self.worker_id = worker_id
        self.devices = devices
        self.job_created_at = job_created_at or time.time()
        self.service_id = service_id
        self._stop = stop_event
        self.trials_run = 0
        self._saver = _AsyncSaver(self) if async_persist else None
        self.heartbeat_min_interval_s = get_config().trial_heartbeat_s
        self._last_heartbeat = 0.0

    # -- budget --------------------------------------------------------------

    def budget_exhausted(self) -> bool:
        """Non-consuming checks (stop flag, wall clock). The trial-count
        budget is enforced by the atomic claim in ``run()``."""
        if self._stop is not None and self._stop.is_set():
            return True
        hours = self.budget.get(BudgetType.TIME_HOURS.value)
        if hours is not None and time.time() - self.job_created_at >= float(hours) * 3600:
            return True
        return False

    # -- one trial -----------------------------------------------------------

    def run_trial(self, knobs: Knobs, budget_max: Optional[int] = None) -> Optional[dict]:
        """Run one trial of ``knobs``. With ``budget_max`` the row insert
        claims a trial-count slot in the same transaction; None back means
        the budget drained, and nothing ran."""
        sig = knob_config_signature(self.model_class.get_knob_config(), knobs)
        trial = self.store.create_trial(
            self.sub_id, self.model_class.__name__, knobs,
            worker_id=self.worker_id, shape_sig=sig,
            service_id=self.service_id, budget_max=budget_max)
        if trial is None:
            return None
        tid = trial["id"]

        def sink(entry):
            self.store.add_trial_log(tid, entry)
            if self.service_id is not None:
                # Epoch logs double as liveness, throttled so chatty
                # loggers don't turn every line into a sqlite write.
                now = time.monotonic()
                if now - self._last_heartbeat >= self.heartbeat_min_interval_s:
                    self._last_heartbeat = now
                    self.store.update_service(self.service_id, heartbeat=True)

        events.emit("trial_started", trial_id=tid, sub_job_id=self.sub_id,
                    model=self.model_class.__name__, worker_id=self.worker_id,
                    knobs=knobs)
        model: Optional[BaseModel] = None
        persisted_async = False
        try:
            with telemetry.span("trial.total", trial_id=tid, worker_id=self.worker_id), \
                    logger.capture(sink), self._device_scope(), self._profile_scope(tid):
                with telemetry.span("trial.build", trial_id=tid):
                    model = self.model_class(**knobs)
                with telemetry.span("trial.train", trial_id=tid):
                    model.train(self.train_uri)
                with telemetry.span("trial.evaluate", trial_id=tid):
                    score = float(model.evaluate(self.val_uri))
            # The advisor hears the score at once (it steers the next
            # proposal); persisting the params runs on the saver thread
            # while this worker trains the next trial.
            self.advisor.feedback(score, knobs)
            telemetry.inc("worker.trials_succeeded")
            if self._saver is not None:
                self._saver.submit(tid, model, score, sink)
                persisted_async = True  # the saver owns model.destroy() now
            else:
                with logger.capture(sink):
                    self._persist(tid, model, score)
            return self.store.get_trial(tid)
        except DivergenceError as e:
            # Numerics containment: fail the trial fast with the
            # diagnosis, steer the advisor away, keep the loop alive.
            v = e.verdict
            telemetry.inc("worker.trials_errored")
            self.store.mark_trial_as_errored(tid, f"diverged: {e}")
            events.emit("trial_diverged", trial_id=tid, worker_id=self.worker_id,
                        divergence=v.get("divergence"), bad_step=v.get("bad_step"),
                        diagnosis=v.get("diagnosis"))
            self._floor_feedback(knobs)
            return self.store.get_trial(tid)
        except Exception:
            err = traceback.format_exc()
            telemetry.inc("worker.trials_errored")
            self.store.mark_trial_as_errored(tid, err)
            events.emit("trial_errored", trial_id=tid, worker_id=self.worker_id,
                        error=err.splitlines()[-1] if err else "")
            self._floor_feedback(knobs)
            return self.store.get_trial(tid)
        finally:
            if model is not None and not persisted_async:
                model.destroy()

    def _floor_feedback(self, knobs: Knobs) -> None:
        """Feed the advisor a floor score so it learns to avoid the
        region instead of re-proposing it (the reference just skips)."""
        try:
            self.advisor.feedback(0.0, knobs)
        except Exception:
            telemetry.inc("worker.feedback_errors")

    def _persist(self, tid: str, model: BaseModel, score: float) -> None:
        """Dump -> write -> mark completed (on the saver thread when
        async persistence is on)."""
        try:
            with telemetry.span("trial.persist", trial_id=tid):
                blob = model.dump_parameters()
                params_id = self.params_store.save(blob)
                self.store.mark_trial_as_completed(tid, score, params_id)
            events.emit("trial_completed", trial_id=tid, score=score,
                        worker_id=self.worker_id)
        except Exception:
            err = traceback.format_exc()
            self.store.mark_trial_as_errored(tid, f"params persist failed:\n{err}")
            events.emit("trial_errored", trial_id=tid, worker_id=self.worker_id,
                        error="params persist failed")

    def _device_scope(self):
        if self.devices:
            return default_device(self.devices[0])
        return contextlib.nullcontext()

    @staticmethod
    @contextlib.contextmanager
    def _profile_scope(trial_id: str):
        """A ``torch.profiler`` Chrome trace of the trial at
        ``<RAFIKI_PROFILE_DIR>/<trial_id>/trace.json`` when the variable
        is set (viewable in Perfetto or chrome://tracing)."""
        profile_dir = os.environ.get("RAFIKI_PROFILE_DIR")
        if not profile_dir:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        out = os.path.join(profile_dir, trial_id)
        os.makedirs(out, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(out, "trace.json"))

    # -- the loop ------------------------------------------------------------

    def run(self) -> int:
        """Pull trials until the budget is exhausted. Returns #trials run."""
        max_trials = self.budget.get(BudgetType.MODEL_TRIAL_COUNT.value)
        budget_max = int(max_trials) if max_trials is not None else None
        try:
            while not self.budget_exhausted():
                with telemetry.span("trial.advisor_propose", worker_id=self.worker_id):
                    knobs = self.advisor.propose()
                # The slot claim is inside the trial-row insert; None back
                # = budget drained, and the unused proposal is dropped.
                if self.run_trial(knobs, budget_max=budget_max) is None:
                    break
                self.trials_run += 1
                if self.service_id is not None:
                    self.store.update_service(self.service_id, heartbeat=True)
        finally:
            if self._saver is not None:
                # close() flushes first: every trial durable before we
                # return, and the saver thread exits.
                self._saver.close()
        return self.trials_run


class _AsyncSaver:
    """One background thread persisting trial parameters off the
    critical path. Bounded to one pending save: at most two param sets
    are alive at once (the one being written and the one training), so
    memory stays flat; a slow disk degrades to serial, never unbounded.
    """

    def __init__(self, worker: TrainWorker):
        self._worker = worker
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._thread = threading.Thread(target=self._loop,
                                        name=f"saver-{worker.worker_id}", daemon=True)
        self._thread.start()

    def submit(self, trial_id: str, model: BaseModel, score: float, sink=None) -> None:
        if not self._thread.is_alive():
            # close()d by a previous run(); restart for the new caller
            # (single-producer, so no start race).
            self._thread = threading.Thread(
                target=self._loop, name=self._thread.name, daemon=True)
            self._thread.start()
        self._q.put((trial_id, model, score, sink))

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            trial_id, model, score, sink = item
            try:
                # Re-enter the trial's log capture on this thread so
                # logger.log() calls during dump still land in TrialLog.
                scope = logger.capture(sink) if sink is not None else contextlib.nullcontext()
                with scope:
                    self._worker._persist(trial_id, model, score)
            except Exception:
                # _persist contains its failures; the saver thread must
                # never die, and what it absorbs is counted.
                telemetry.inc("worker.saver_errors")
            finally:
                try:
                    model.destroy()
                except Exception:
                    telemetry.inc("worker.saver_errors")
                self._q.task_done()

    def flush(self) -> None:
        """Block until all submitted saves are durable."""
        self._q.join()

    def close(self) -> None:
        self.flush()
        self._q.put(None)
        self._thread.join(timeout=10)
