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

Device handling: a worker owns a device set of one device (a card, or
the CPU when it was given the CPU); a set of several, which the JAX
package trains as one in-process dp mesh, is refused (ROADMAP Queue 1,
item 7: the in-process multi-device worker). Its trials run inside
``utils.backend.default_device``, so a template built as
``model_class(**knobs)``, with no device argument, lands on the
worker's device. With ``RAFIKI_PROFILE_DIR`` set, each trial records a
``torch.profiler`` Chrome trace under ``<dir>/<trial_id>/``.

Within-trial data parallelism: a worker that is rank 0 of a
``torch.distributed`` group of W > 1 ranks (``worker/main.py`` joins it)
leads a dp group: each trial's model gets ``set_mesh(data_parallel_mesh
(devices))`` and trains as one rank of the width-W trial, while the
other ranks mirror it (``worker/follower.py``). Such a group does not
pack. An adopted trial resumes from its newest checkpoint on every rank:
the leader restores it here, and each follower reads the same one from
the shared params store, so all ranks issue the same collectives from
the same state. A failed collective
(``ops/train.py CollectiveError``) is not contained as a trial error:
it ends the worker, and the scheduler respawns the whole group.

Spans ``trial.total``/``build``/``train``/``evaluate``/``persist`` and
``trial.advisor_propose``; counters ``worker.trials_succeeded``,
``worker.trials_errored``, ``worker.feedback_errors`` and
``worker.saver_errors``.

Trial packing (``trial_pack=k`` or ``RAFIKI_TRIAL_PACK``, default 1 =
off; docs/trial_packing.md): :class:`PackedTrialRunner` drafts k
proposals a round, buckets them by packing key and trains each bucket
of two or more as one stacked program on the worker's device, keeping
every per-trial contract of a serial trial (its row, score, feedback,
logs, params and containment). Spans ``trial_pack.total``/``build``/
``train``/``evaluate``, histograms ``trial_pack.size`` and
``trial_pack.fill_ratio``, counters ``worker.packed_trials`` and
``worker.packed_rounds``. A worker that is not eligible (another
template base, a custom ``preprocess``, several devices or processes,
a masked dataset) runs serially, and counts it in
``worker.pack_ineligible``.

Mid-trial checkpoints (``checkpoint_every=n`` or
``RAFIKI_CHECKPOINT_EVERY``, default 0 = off): every n-th epoch a trial
writes its whole train state to the params store (a pack writes one
serial-format checkpoint per member, each under its own epoch), and a
write that fails is counted (``worker.checkpoint_write_failed``) and
evented (``checkpoint_write_failed``), never raised: the trial goes on.
``resume_trial`` re-runs an interrupted trial from its newest
checkpoint (``trial_resumed``; ``checkpoint_restore_failed`` and a
fresh start when the blob does not restore), ``adopt_orphans_of_service``
re-runs the trials a dead predecessor left RUNNING, and a completed
trial's checkpoints are deleted. ``build_worker_from_store`` builds a
worker from the meta store's rows (the recovery sweep's,
``scheduler/recovery.py``). Event ``checkpoint_written`` carries the
blob's bytes and the seconds to take and write it (a pack member's:
to write it, with ``slice_seconds`` to take the round's blobs);
``trial_resumed`` the seconds to read and restore it.

Observability, as in the JAX package: one trial (or one pack) is one
trace, minted fresh, and one goodput-ledger entity (``trial:<id>``,
``pack:<worker>:k<k>``); checkpoint writes and persists are charged to
``checkpoint_s``; every epoch's eval values are journaled as
``trial/epoch_eval`` (the learning-curve record, with the trial's
wall seconds so far). All of it is a no-op unless the process journals.

Chaos: whenever a plane is active (``rafiki_tpu_torch/chaos``), each
epoch's checkpoint sink is wired, checkpointing on or off, and passes
the ``worker.epoch`` site, keyed by the worker id, AFTER that epoch's
checkpoint write: a kill-at-epoch-N fault lands with epoch N durable.

``PackedTrialRunner.run_assigned`` trains rows its caller claimed as
one pack (the mesh sweep's chip runners and the chaos scenarios drive
it); a drained budget does not refill an evicted slot. Its ``abort``
event is the mesh sweep's chip-loss signal: the pack raises
:class:`PackAborted` at the next epoch boundary, after that epoch's
checkpoints are durable, and leaves every row RUNNING for the sweep to
re-pack. A worker given the sweep's write-ahead log (``worker.wal``,
``scheduler/wal.py``) brackets each mid-pack backfill claim in it.

The learning-curve plane (docs/early_kill.md): with
``RAFIKI_CURVE_KILL`` or ``RAFIKI_CURVE_SPECULATE`` set when the worker
is built, ``self.curve`` is a ``CurveCoordinator`` (the mesh scheduler
replaces it with one shared by its chips); unset, it is None and no
site consults it. A serial trial's log sink feeds each epoch's ``acc``
(higher is better; a model that logs only a loss is never killed) to
the coordinator and raises :class:`EarlyKilled` when the fit condemns
it: the trial is ERRORED with ``early_killed: ...``, its wall charged
to the search ledger's doomed bucket, and the advisor hears the
predicted score as its consolation feedback (``worker.trials_killed``,
events ``trial_killed`` then ``trial_errored``: the JAX package emits
the first alone, which its lineage reader counts as an orphan). In a
pack the same verdict evicts the member
(reason ``"killed"``), its bookkeeping done before the freed slot is
backfilled, the backfill first speculates the pack-mates still in
flight, and a killed member is not evaluated. Every failure arm tells
the search ledger the trial was doomed before its floor feedback.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Protocol

from rafiki_tpu_torch import chaos, telemetry
from rafiki_tpu_torch.advisor.speculative import CurveCoordinator
from rafiki_tpu_torch.config import get_config
from rafiki_tpu_torch.constants import BudgetType, TrialStatus
from rafiki_tpu_torch.model.base import BaseModel, TorchModel, load_model_class
from rafiki_tpu_torch.model.dataset import dataset_utils
from rafiki_tpu_torch.model.knobs import Knobs, knob_config_signature
from rafiki_tpu_torch.model.log import logger
from rafiki_tpu_torch.obs import context as trace_context
from rafiki_tpu_torch.obs.health import DivergenceError
from rafiki_tpu_torch.obs.health import detector as _health
from rafiki_tpu_torch.obs.journal import journal
from rafiki_tpu_torch.obs.ledger import ledger
from rafiki_tpu_torch.obs.search import audit as search_audit
from rafiki_tpu_torch.obs.search.audit import knobs_hash
from rafiki_tpu_torch.ops.graphs import card_lock
from rafiki_tpu_torch.ops.train import CollectiveError
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.backend import default_device
from rafiki_tpu_torch.utils.events import events


def _in_group() -> bool:
    """Whether this process is a rank of a dp group of several processes
    (``worker/main.py`` sets ``RAFIKI_NUM_PROCESSES`` for each)."""
    return int(os.environ.get("RAFIKI_NUM_PROCESSES", "1")) > 1


def _group_mesh(devices):
    """The dp mesh of a trial run by a rank of a group of W > 1 ranks,
    over the worker's one device; None outside such a group."""
    if not _in_group():
        return None
    from rafiki_tpu_torch.parallel.mesh import data_parallel_mesh
    from rafiki_tpu_torch.utils.backend import resolve_device

    return data_parallel_mesh(devices or [resolve_device(None)])


class PackAborted(RuntimeError):
    """A pack was torn down mid-train by its supervisor (chip lost,
    mesh preempt) rather than by a trial failure. The rows stay
    RUNNING, deliberately NOT marked errored, so the mesh scheduler
    can re-pack them onto surviving chips, where each resumes from its
    newest per-epoch packed checkpoint (docs/mesh_sweep.md)."""


class EarlyKilled(RuntimeError):
    """A serial trial condemned mid-flight by the learning-curve
    predictor: raised from the trial's log sink at an epoch boundary,
    caught by ``run_trial``'s own arm, which marks the trial errored,
    charges the doomed bucket and routes the predicted score to the
    advisor as its consolation feedback."""

    def __init__(self, fit, epoch: int, best: float):
        super().__init__(
            f"early-killed at epoch {epoch}: predicted final "
            f"{fit.predicted_final:.4f} (hi {fit.hi:.4f}) vs best {best:.4f}")
        self.fit = fit
        self.epoch = int(epoch)
        self.best = float(best)


def _destroy(model: BaseModel) -> None:
    """``model.destroy()`` under its card's lock: a template's hook may
    synchronize the card, which must not reach a capture that another
    thread on the same card (a mesh chip) has in flight
    (``ops/graphs.py``)."""
    with card_lock(model):
        model.destroy()


class AdvisorHandle(Protocol):
    """What the worker needs from an advisor, local or remote.
    ``propose_batch(n)`` is optional: the packed runner falls back to n
    proposals."""

    def propose(self) -> Knobs: ...

    def feedback(self, score: float, knobs: Knobs) -> None: ...


def _journal_epoch_eval(trial_id: str, entry: Dict[str, Any],
                        wall_s: Optional[float],
                        packed: bool = False) -> None:
    """Durable per-epoch learning-curve record (``trial/epoch_eval``):
    eval curves survive the worker process instead of living only in
    the trial log. No-op for non-epoch log entries and when no journal
    is configured."""
    if entry.get("type") != "values":
        return
    values = entry.get("values") or {}
    if "epoch" not in values:
        return
    score = values.get("acc", values.get("loss"))
    journal.record(
        "trial", "epoch_eval", trial_id=trial_id,
        epoch=int(values["epoch"]),
        score=None if score is None else float(score),
        loss=values.get("loss"), acc=values.get("acc"),
        wall_s=None if wall_s is None else round(float(wall_s), 6),
        packed=packed)


def _journal_pack_rounds(worker_id: str, rows, joined: Dict[int, int],
                         histories: List[List[Dict[str, Any]]]) -> None:
    """The pack's rounds (``trial_pack/rounds``): every member's trial
    id in row order, backfills included, and how many members trained
    in each round. The training twin replays a pack from it: the
    drafted members' ``mesh/pack_formed`` record alone says neither
    which trials joined the freed slots nor how long the pack ran."""
    spans = [(joined.get(i, 0), len(h)) for i, h in enumerate(histories)]
    n_rounds = max((j + n for j, n in spans), default=0)
    widths = [sum(1 for j, n in spans if j <= r < j + n) for r in range(n_rounds)]
    journal.record("trial_pack", "rounds", worker_id=worker_id,
                   trial_ids=[tid for tid, _ in rows], widths=widths)


class InProcAdvisorHandle:
    def __init__(self, advisor_service, advisor_id: str):
        self._svc = advisor_service
        self._id = advisor_id

    def propose(self) -> Knobs:
        return self._svc.propose(self._id)

    def propose_batch(self, n: int) -> List[Knobs]:
        return self._svc.propose_batch(self._id, n)

    def feedback(self, score: float, knobs: Knobs) -> None:
        self._svc.feedback(self._id, score, knobs)

    def speculate(self, score: float, knobs: Knobs, fit=None) -> None:
        self._svc.speculate(self._id, score, knobs, fit=fit)


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
        checkpoint_every: Optional[int] = None,
        trial_pack: Optional[int] = None,
    ):
        if not (isinstance(model_class, type) and issubclass(model_class, BaseModel)):
            raise TypeError("model_class must subclass BaseModel")
        if devices is not None and len(devices) > 1:
            raise NotImplementedError(
                f"a worker runs its trials on one device; got {len(devices)} (several "
                "devices in one process: ROADMAP Queue 1, item 7, the in-process "
                "multi-device worker; a dp trial is one process per device)")
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
        # Mid-trial checkpoint cadence in epochs; 0 = off.
        if checkpoint_every is None:
            checkpoint_every = int(os.environ.get("RAFIKI_CHECKPOINT_EVERY", "0"))
        self.checkpoint_every = int(checkpoint_every)
        # Trial packing width (docs/trial_packing.md): 1 = off, the default.
        if trial_pack is None:
            trial_pack = int(os.environ.get("RAFIKI_TRIAL_PACK", "1"))
        self.trial_pack = max(1, int(trial_pack))
        # The learning-curve coordinator: None unless RAFIKI_CURVE_KILL or
        # RAFIKI_CURVE_SPECULATE is set, and every site guards on None.
        # The mesh scheduler replaces it with one its chips share.
        self.curve = CurveCoordinator.from_env()
        self.heartbeat_min_interval_s = get_config().trial_heartbeat_s
        self._last_heartbeat = 0.0
        # The sweep's write-ahead log (scheduler/wal.py), set by the mesh
        # scheduler: mid-pack backfill claims are bracketed in it.
        self.wal = None

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

    def run_trial(self, knobs: Knobs, resume_trial_id: Optional[str] = None,
                  budget_max: Optional[int] = None) -> Optional[dict]:
        """Run one trial of ``knobs``. With ``budget_max`` the row insert
        claims a trial-count slot in the same transaction; None back means
        the budget drained, and nothing ran. ``resume_trial_id`` is a row
        already claimed: it is adopted (RUNNING again, its stale error
        cleared, bound to this worker) and the trial resumes from its
        newest checkpoint when one exists."""
        resume = resume_trial_id is not None
        if resume:
            trial = self.store.get_trial(resume_trial_id)
            if trial is None:
                raise KeyError(f"No trial {resume_trial_id!r} to resume")
            self.store.mark_trial_as_running(trial["id"], service_id=self.service_id,
                                             worker_id=self.worker_id)
        else:
            sig = knob_config_signature(self.model_class.get_knob_config(), knobs)
            trial = self.store.create_trial(
                self.sub_id, self.model_class.__name__, knobs,
                worker_id=self.worker_id, shape_sig=sig,
                service_id=self.service_id, budget_max=budget_max)
            if trial is None:
                return None
        tid = trial["id"]
        t_trial0 = time.monotonic()

        def sink(entry):
            self.store.add_trial_log(tid, entry)
            _journal_epoch_eval(tid, entry, wall_s=time.monotonic() - t_trial0)
            if self.curve is not None and entry.get("type") == "values":
                values = entry.get("values") or {}
                # Higher-is-better curves only (acc): a model that logs
                # only a loss is never killed.
                if "epoch" in values and values.get("acc") is not None:
                    ep = int(values["epoch"])
                    self.curve.observe(knobs, ep, float(values["acc"]), trial_id=tid)
                    fit = self.curve.kill_verdict(knobs, ep, trial_id=tid)
                    if fit is not None:
                        raise EarlyKilled(fit, ep, self.curve.best_so_far)
            if self.service_id is not None:
                # Epoch logs double as liveness, throttled so chatty
                # loggers don't turn every line into a sqlite write.
                now = time.monotonic()
                if now - self._last_heartbeat >= self.heartbeat_min_interval_s:
                    self._last_heartbeat = now
                    self.store.update_service(self.service_id, heartbeat=True)

        # One trial = one trace: spans, journal records and the ledger
        # entity stitch under it. A resumed trial mints a fresh trace; the
        # journal links the attempts through the trial_id field.
        trace_scope = contextlib.ExitStack()
        trace_scope.enter_context(trace_context.trace(trace_context.new_trace_id()))
        events.emit("trial_started", trial_id=tid, sub_job_id=self.sub_id,
                    model=self.model_class.__name__, worker_id=self.worker_id,
                    knobs=knobs)
        model: Optional[BaseModel] = None
        persisted_async = False
        try:
            with telemetry.span("trial.total", trial_id=tid, worker_id=self.worker_id), \
                    ledger.entity(f"trial:{tid}"), \
                    logger.capture(sink), self._device_scope(), self._profile_scope(tid):
                with telemetry.span("trial.build", trial_id=tid):
                    model = self.model_class(**knobs)
                    mesh = _group_mesh(self.devices)
                    if mesh is not None and hasattr(model, "set_mesh"):
                        model.set_mesh(mesh)
                    self._wire_checkpoints(model, tid, resume)
                with telemetry.span("trial.train", trial_id=tid):
                    model.train(self.train_uri)
                with telemetry.span("trial.evaluate", trial_id=tid):
                    with card_lock(model):
                        score = float(model.evaluate(self.val_uri))
            # The advisor hears the score at once (it steers the next
            # proposal); persisting the params runs on the saver thread
            # while this worker trains the next trial.
            self.advisor.feedback(score, knobs)
            if self.curve is not None:
                self.curve.note_scored(knobs, score)
            telemetry.inc("worker.trials_succeeded")
            if self._saver is not None:
                self._saver.submit(tid, model, score, sink)
                persisted_async = True  # the saver owns model.destroy() now
            else:
                with logger.capture(sink):
                    self._persist(tid, model, score)
            return self.store.get_trial(tid)
        except EarlyKilled as e:
            self._book_kill(tid, knobs, e.fit, e.epoch, e.best)
            return self.store.get_trial(tid)
        except DivergenceError as e:
            # Numerics containment: fail the trial fast with the
            # diagnosis, steer the advisor away, keep the loop alive.
            v = e.verdict
            telemetry.inc("worker.trials_errored")
            self.store.mark_trial_as_errored(tid, f"diverged: {e}")
            events.emit("trial_diverged", trial_id=tid, worker_id=self.worker_id,
                        divergence=v.get("divergence"), bad_step=v.get("bad_step"),
                        capsule=v.get("capsule"), diagnosis=v.get("diagnosis"))
            _health.note_contained()
            self._floor_feedback(knobs)
            return self.store.get_trial(tid)
        except CollectiveError:
            raise  # the group fails, not the trial: it stays RUNNING, to be adopted
        except Exception:
            err = traceback.format_exc()
            telemetry.inc("worker.trials_errored")
            self.store.mark_trial_as_errored(tid, err)
            events.emit("trial_errored", trial_id=tid, worker_id=self.worker_id,
                        error=err.splitlines()[-1] if err else "")
            self._floor_feedback(knobs)
            return self.store.get_trial(tid)
        finally:
            trace_scope.close()
            if model is not None and not persisted_async:
                _destroy(model)

    def _book_kill(self, tid: str, knobs: Knobs, fit, epoch: int, best: float) -> None:
        """The learning-curve kill's bookkeeping, serial or packed, shaped
        as the divergence arm: the row ERRORED with the fit's verdict, its
        wall doomed, and the advisor fed the conservative PREDICTED score
        (below best-so-far by the kill rule), which steers it more
        honestly than a 0.0 floor and replays from the journal. One
        departure from the JAX package: ``trial_errored`` follows
        ``trial_killed`` as the row's terminal event, so a lineage reader
        closes the trial."""
        telemetry.inc("worker.trials_killed")
        err = (f"early_killed: predicted {fit.predicted_final:.4f} "
               f"(hi {fit.hi:.4f}) vs best {best:.4f} at epoch {epoch}")
        self.store.mark_trial_as_errored(tid, err)
        events.emit("trial_killed", trial_id=tid, worker_id=self.worker_id,
                    epoch=epoch, predicted=fit.predicted_final)
        events.emit("trial_errored", trial_id=tid, worker_id=self.worker_id, error=err)
        self._floor_feedback(knobs, fit.predicted_final)

    def _floor_feedback(self, knobs: Knobs, score: float = 0.0) -> None:
        """A trial that ends without a real score: retire its curve, mark
        it doomed in the search ledger (BEFORE the feedback, so its wall is
        charged to the doomed bucket), and feed the advisor a floor score
        (a killed trial's: its predicted score) so it learns to avoid the
        region instead of re-proposing it (the reference just skips)."""
        if self.curve is not None:
            self.curve.note_done(knobs)
        search_audit.note_doomed(knobs)
        try:
            self.advisor.feedback(score, knobs)
        except Exception:
            telemetry.inc("worker.feedback_errors")

    def _wire_checkpoints(self, model: BaseModel, tid: str, resume: bool) -> None:
        """On resume, restore the trial's newest checkpoint (in a dp
        group the followers restore the same one, ``worker/follower.py``);
        with a cadence, install the per-epoch checkpoint sink."""
        if resume and hasattr(model, "restore_checkpoint"):
            t0 = time.monotonic()
            latest = self.params_store.latest_checkpoint(tid)
            if latest is not None:
                try:
                    start = model.restore_checkpoint(latest[1])
                    events.emit("trial_resumed", trial_id=tid, from_epoch=start,
                                worker_id=self.worker_id, seconds=time.monotonic() - t0)
                except Exception:
                    # An unreadable checkpoint must not error the trial:
                    # the knobs are fine, so it reruns from the start. The
                    # cause is kept, to tell a format fault from one
                    # stale blob.
                    events.emit("checkpoint_restore_failed", trial_id=tid,
                                worker_id=self.worker_id,
                                error=traceback.format_exc(limit=5))
        # The sink is also the per-epoch chaos site (worker.epoch), so it is
        # wired whenever a plane is active, checkpointing on or off.
        every = self.checkpoint_every
        if (every > 0 or chaos.active() is not None) and hasattr(model, "set_checkpoint_sink"):
            def sink(epoch: int, make_blob) -> None:
                if every > 0 and (epoch + 1) % every == 0:
                    self._save_checkpoint(tid, epoch, make_blob)
                # After the write: a kill-at-epoch-N fault lands with epoch
                # N's checkpoint durable.
                chaos.hook("worker.epoch", key=self.worker_id)

            model.set_checkpoint_sink(sink)

    def _save_checkpoint(self, tid: str, epoch: int, make_blob) -> None:
        """Write one mid-trial checkpoint. A failed write (a full disk)
        costs resumability, not the trial, whose real state is still in
        device memory: it is counted and evented, and training goes on."""
        t0 = time.monotonic()
        try:
            blob = make_blob()
            self.params_store.save_checkpoint(tid, epoch, blob)
            events.emit("checkpoint_written", trial_id=tid, epoch=epoch, worker_id=self.worker_id,
                        bytes=len(blob), seconds=time.monotonic() - t0)
        except Exception:
            telemetry.inc("worker.checkpoint_write_failed")
            events.emit("checkpoint_write_failed", trial_id=tid, epoch=epoch,
                        worker_id=self.worker_id, error=traceback.format_exc(limit=3))
        finally:
            ledger.add("checkpoint_s", time.monotonic() - t0, entity=f"trial:{tid}")

    def resume_trial(self, trial_id: str) -> dict:
        """Re-run an interrupted trial from its newest mid-trial
        checkpoint (from the start without one). Synchronous: the saver
        is drained (and restarted if a ``run()`` closed it), so the row
        returned is terminal."""
        trial = self.store.get_trial(trial_id)
        if trial is None:
            raise KeyError(f"No trial {trial_id!r}")
        out = self.run_trial(trial["knobs"], resume_trial_id=trial_id)
        if self._saver is not None:
            self._saver.flush()
            out = self.store.get_trial(trial_id)
        return out

    def _persist(self, tid: str, model: BaseModel, score: float) -> None:
        """Dump -> write -> mark completed -> drop the trial's checkpoints
        (on the saver thread when async persistence is on)."""
        t0 = time.monotonic()
        try:
            with telemetry.span("trial.persist", trial_id=tid):
                with card_lock(model):
                    blob = model.dump_parameters()
                params_id = self.params_store.save(blob)
                self.store.mark_trial_as_completed(tid, score, params_id)
                self.params_store.delete_checkpoints(tid)  # superseded
            # Persist runs on the saver thread (no bound entity there),
            # so the charge names its trial.
            ledger.add("checkpoint_s", time.monotonic() - t0, entity=f"trial:{tid}")
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

    def adopt_orphans_of_service(self, prev_service_id: str) -> int:
        """Resume the RUNNING trials a dead predecessor worker left bound
        to ``prev_service_id``. Each is taken by the compare-and-swap
        ``adopt_trial`` first, so a recovery sweep racing this worker
        loses it and every orphan re-runs once. The predecessor claimed
        their budget slots, so the job still runs its exact trial count.
        Returns the number resumed."""
        n = 0
        for t in self.store.get_trials_of_sub_train_job(self.sub_id):
            if t["status"] != TrialStatus.RUNNING.value or t.get("service_id") != prev_service_id:
                continue
            if not self.store.adopt_trial(t["id"], prev_service_id, self.service_id,
                                          self.worker_id):
                continue  # a recovery sweep won it; its re-run owns it
            self.resume_trial(t["id"])
            self.trials_run += 1
            n += 1
        return n

    def run(self) -> int:
        """Pull trials until the budget is exhausted. Returns #trials run."""
        max_trials = self.budget.get(BudgetType.MODEL_TRIAL_COUNT.value)
        budget_max = int(max_trials) if max_trials is not None else None
        packer = None
        if self.trial_pack > 1:
            packer = PackedTrialRunner(self, self.trial_pack)
            if not packer.eligible():
                telemetry.inc("worker.pack_ineligible")
                packer = None  # the serial loop below
        try:
            while not self.budget_exhausted():
                if packer is not None:
                    ran, drained = packer.run_round(budget_max)
                    self.trials_run += ran
                    if ran and self.service_id is not None:
                        self.store.update_service(self.service_id, heartbeat=True)
                    if drained:
                        break
                    continue
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


class PackedTrialRunner:
    """Drafts up to ``pack`` proposals a round, buckets them by packing
    key, and trains each bucket of two or more as one stacked program
    (``TorchModel.train_packed``) on the worker's device.

    Every per-trial contract holds: one store row per trial, its budget
    slot claimed atomically at creation; the trial's own score, advisor
    feedback, TrialLog entries, persisted params and error containment,
    as for k serial trials. Only the wall-clock is shared, so the
    predictor's top-k and the gateway see no difference.
    """

    def __init__(self, worker: TrainWorker, pack: int):
        self.w = worker
        self.pack = max(1, int(pack))

    def eligible(self) -> bool:
        """Checked once per ``run()``: a packable ``TorchModel`` template,
        one device, one process, an unmasked train dataset."""
        w = self.w
        if self.pack < 2:
            return False
        if not (isinstance(w.model_class, type) and issubclass(w.model_class, TorchModel)):
            return False
        if not w.model_class.packable():
            return False
        if w.devices is not None and len(w.devices) > 1:
            return False
        if _in_group():
            return False
        try:
            if dataset_utils.load(w.train_uri).mask is not None:
                return False
        except Exception:
            return False
        return True

    def _key(self, knobs: Knobs):
        with self.w._device_scope():
            m = self.w.model_class(**knobs)
            return repr(m.packing_key(m._prepared_dataset(self.w.train_uri)))

    def run_round(self, budget_max: Optional[int]) -> "tuple[int, bool]":
        """One draft-bucket-train round. Returns (trials run, budget
        drained). A proposal whose key matches no other runs serially."""
        w = self.w
        with telemetry.span("trial.advisor_propose", worker_id=w.worker_id):
            batch = getattr(w.advisor, "propose_batch", None)
            proposals = (batch(self.pack) if batch is not None
                         else [w.advisor.propose() for _ in range(self.pack)])
        buckets: Dict[Any, List[Knobs]] = {}
        for kn in proposals:
            try:
                key = self._key(kn)
            except Exception:
                key = ("unpackable", id(kn))  # its own bucket: runs serially
            buckets.setdefault(key, []).append(kn)
        ran = 0
        for knobs_list in buckets.values():
            if len(knobs_list) == 1:
                if w.run_trial(knobs_list[0], budget_max=budget_max) is None:
                    return ran, True
                ran += 1
            else:
                n, drained = self._run_packed(knobs_list, budget_max)
                ran += n
                if drained:
                    return ran, True
        return ran, False

    def _create_row(self, knobs: Knobs, budget_max: Optional[int]) -> Optional[dict]:
        w = self.w
        return w.store.create_trial(
            w.sub_id, w.model_class.__name__, knobs, worker_id=w.worker_id,
            shape_sig=knob_config_signature(w.model_class.get_knob_config(), knobs),
            service_id=w.service_id, budget_max=budget_max)

    def _run_packed(self, knobs_list: List[Knobs],
                    budget_max: Optional[int]) -> "tuple[int, bool]":
        # All rows claimed up front, each an atomic budget slot; the pack
        # shrinks to what the budget still allows.
        rows: List["tuple[str, Knobs]"] = []
        drained = False
        for kn in knobs_list:
            trial = self._create_row(kn, budget_max)
            if trial is None:
                drained = True
                break
            rows.append((trial["id"], kn))
        if not rows:
            return 0, True
        if len(rows) == 1:
            # The budget shrank the pack to one: run it serially on its
            # claimed row, through the resume path.
            out = self.w.run_trial(rows[0][1], resume_trial_id=rows[0][0])
            return (1 if out is not None else 0), drained
        return self._train_rows(rows, budget_max, drained)

    def run_assigned(self, rows: "List[tuple[str, Knobs]]",
                     budget_max: Optional[int] = None, abort=None) -> int:
        """Train trial rows the caller already claimed, ``[(trial id,
        knobs), ...]``, as one pack. A freed slot is backfilled only while
        ``budget_max`` has room: with the budget drained, an evicted
        member's slot stays empty and the pack's member indices stay
        put. ``abort`` is a ``threading.Event``: when set, the pack
        raises :class:`PackAborted` at the next epoch boundary, AFTER
        that epoch's checkpoints are durable, leaving every row RUNNING
        for re-packing. Returns the number of rows carried to an end
        (completed or errored), backfills included."""
        if not rows:
            return 0
        n, _ = self._train_rows(list(rows), budget_max, False, abort=abort)
        return n

    def _train_rows(self, rows: "List[tuple[str, Knobs]]", budget_max: Optional[int],
                    drained: bool, abort=None) -> "tuple[int, bool]":
        w = self.w
        k = len(rows)
        telemetry.observe("trial_pack.size", float(k))
        telemetry.observe("trial_pack.fill_ratio", k / float(self.pack))
        for tid, kn in rows:
            events.emit("trial_started", trial_id=tid, sub_job_id=w.sub_id,
                        model=w.model_class.__name__, worker_id=w.worker_id, knobs=kn)
        models: List[BaseModel] = []
        # model index -> (the CurveFit that condemned it, best-so-far at
        # the verdict); filled by kill_pred, read by on_evict and by the
        # scoring below.
        killed: Dict[int, Any] = {}
        pack_entity = f"pack:{w.worker_id}:k{k}"
        try:
            # One pack = one trace + one ledger entity: the pack's
            # compile/step/feed/checkpoint split is shared across its trials.
            with trace_context.trace(trace_context.new_trace_id()), \
                    telemetry.span("trial_pack.total", worker_id=w.worker_id, k=k), \
                    ledger.entity(pack_entity), w._device_scope():
                with telemetry.span("trial_pack.build"):
                    models = [w.model_class(**kn) for _, kn in rows]

                t_pack0 = time.monotonic()
                round_walls: List[float] = []
                # Row index -> the pack round a backfilled member joined
                # at (the rounds after the walls so far); others join at 0.
                joined: Dict[int, int] = {}

                def heartbeat(_round: int) -> None:
                    # The pack-relative wall at each round's end, for the
                    # members' epoch_eval records below.
                    round_walls.append(time.monotonic() - t_pack0)
                    # The abort lands at the epoch boundary AFTER the
                    # checkpoint sink ran, so every member's newest epoch
                    # is durable before the pack unwinds.
                    if abort is not None and abort.is_set():
                        raise PackAborted(f"pack on {w.worker_id} aborted at epoch boundary")
                    if w.service_id is not None:
                        now = time.monotonic()
                        if now - w._last_heartbeat >= w.heartbeat_min_interval_s:
                            w._last_heartbeat = now
                            w.store.update_service(w.service_id, heartbeat=True)

                def on_evict(mi: int, epoch: int, reason: str) -> None:
                    events.emit("pack_member_evicted", trial_id=rows[mi][0], epoch=epoch,
                                reason=reason, worker_id=w.worker_id)
                    if reason != "killed":
                        return
                    # The kill's bookkeeping runs here, before the backfill
                    # proposes into the freed slot, so that proposal is
                    # steered by this trial's consolation feedback (the
                    # serial EarlyKilled arm's contract).
                    tid_k, kn_k = rows[mi]
                    fit, best = killed[mi]
                    w._book_kill(tid_k, kn_k, fit, epoch, best)

                kill_pred = None
                if w.curve is not None:
                    def kill_pred(mi: int, epoch: int, metrics) -> bool:
                        # The member's epoch point (host floats of the
                        # epoch's one sync), then the verdict. Loss-only
                        # packs are never killed, as in the serial sink.
                        tid_k, kn_k = rows[mi]
                        acc = (metrics or {}).get("acc")
                        if acc is None:
                            return False
                        w.curve.observe(kn_k, epoch, float(acc), trial_id=tid_k)
                        fit = w.curve.kill_verdict(kn_k, epoch, trial_id=tid_k)
                        if fit is None:
                            return False
                        killed[mi] = (fit, w.curve.best_so_far)
                        return True

                def backfill(n: int) -> List[BaseModel]:
                    """Fresh proposals for the freed slots. One whose key
                    differs from the live pack's is dropped before its row
                    is claimed; the next round drafts again."""
                    nonlocal drained
                    if drained:
                        return []
                    # Speculative scoring: the advisor hears predicted
                    # scores for the pack-mates still in flight before it
                    # drafts (a no-op unless RAFIKI_CURVE_SPECULATE is set).
                    if w.curve is not None:
                        w.curve.speculate_inflight(w.advisor)
                    pack_key = repr(models[0].packing_key(
                        models[0]._prepared_dataset(w.train_uri)))
                    out: List[BaseModel] = []
                    for _ in range(n):
                        try:
                            kn = w.advisor.propose()
                            m2 = w.model_class(**kn)
                            if repr(m2.packing_key(m2._prepared_dataset(w.train_uri))) != pack_key:
                                telemetry.inc("trial_pack.backfill_key_mismatch")
                                continue
                        except Exception:
                            continue
                        txn = None if w.wal is None else w.wal.intent(
                            "backfill", sub_id=w.sub_id, knobs_hash=knobs_hash(kn))
                        trial = self._create_row(kn, budget_max)
                        if trial is None:
                            if txn is not None:
                                w.wal.commit(txn, "backfill", denied=True)
                            drained = True
                            break
                        if txn is not None:
                            w.wal.commit(txn, "backfill", trial_id=trial["id"])
                        joined[len(rows)] = len(round_walls)
                        rows.append((trial["id"], kn))
                        events.emit("trial_started", trial_id=trial["id"], sub_job_id=w.sub_id,
                                    model=w.model_class.__name__, worker_id=w.worker_id,
                                    knobs=kn)
                        out.append(m2)
                    return out

                # Per-epoch checkpoints of the whole pack: one serial-
                # format checkpoint per member, so a killed pack's
                # members resume serially, each from its newest epoch.
                # Wired whenever a chaos plane is active too: the sink is
                # the pack's worker.epoch site, as the serial one.
                every = w.checkpoint_every
                ckpt_sink = None
                if every > 0 or chaos.active() is not None:
                    def ckpt_sink(epoch: int, make_blobs) -> None:
                        if every > 0 and (epoch + 1) % every == 0:
                            self._save_pack_checkpoints(rows, epoch, make_blobs)
                        # After the writes: every member's epoch is durable.
                        chaos.hook("worker.epoch", key=w.worker_id)

                with telemetry.span("trial_pack.train"):
                    histories = w.model_class.train_packed(
                        models, w.train_uri, on_epoch=heartbeat, checkpoint_sink=ckpt_sink,
                        backfill=backfill, on_evict=on_evict, kill_predicate=kill_pred)
                _journal_pack_rounds(w.worker_id, rows, joined, histories)
                # Members evicted for divergence hold the divergent state:
                # they are not scored (a NaN score would skew the advisor).
                # Killed members are not scored either: that would spend
                # the wall the kill saved.
                verdicts = [getattr(m, "_health_verdict", None) for m in models]
                healthy = [i for i, v in enumerate(verdicts) if v is None and i not in killed]
                with telemetry.span("trial_pack.evaluate"), card_lock(models[0]):
                    healthy_scores = (w.model_class.evaluate_packed(
                        [models[i] for i in healthy], w.val_uri) if healthy else [])
                scores: List[Optional[float]] = [None] * len(models)
                for j, i in enumerate(healthy):
                    scores[i] = healthy_scores[j]
        except PackAborted:
            # The supervisor's teardown: the rows STAY RUNNING (the mesh
            # re-packs them onto surviving chips), device state is
            # released, and the abort propagates to the caller.
            for m in models:
                try:
                    _destroy(m)
                except Exception:
                    pass
            raise
        except Exception:
            # The pack failed as a whole: every member is ERRORED with the
            # floor feedback, as a failing serial trial is. Nothing reruns.
            err = traceback.format_exc()
            for i, (tid, kn) in enumerate(rows):
                if i in killed:
                    continue  # already ERRORED and fed back in on_evict
                telemetry.inc("worker.trials_errored")
                w.store.mark_trial_as_errored(tid, err)
                events.emit("trial_errored", trial_id=tid, worker_id=w.worker_id,
                            error=err.splitlines()[-1] if err else "")
                w._floor_feedback(kn)
            for m in models:
                try:
                    _destroy(m)
                except Exception:
                    pass
            return len(rows), drained

        # Per-trial bookkeeping in creation order: logs, feedback,
        # persistence, as for k serial trials.
        for i, (tid, kn) in enumerate(rows):
            def sink(entry, _tid=tid):
                w.store.add_trial_log(_tid, entry)

            with logger.capture(sink):
                logger.define_plot("Training", ["loss", "acc"], x_axis="epoch")
                for pos, h in enumerate(histories[i]):
                    logger.log(**h)
                    # Position in a member's history is the round it ran
                    # at (backfilled members borrow the pack's early walls).
                    _journal_epoch_eval(tid, {"type": "values", "values": h},
                                        wall_s=(round_walls[pos] if pos < len(round_walls)
                                                else None), packed=True)
            if i in killed:
                # Row, doomed charge and feedback were done in on_evict;
                # its curve prefix is journaled above.
                _destroy(models[i])
                continue
            if verdicts[i] is not None:
                # The serial DivergenceError arm's contract: ERRORED with
                # the diagnosis, floor feedback, nothing persisted.
                v = verdicts[i]
                telemetry.inc("worker.trials_errored")
                w.store.mark_trial_as_errored(tid, f"diverged: {v.get('diagnosis')}")
                events.emit("trial_diverged", trial_id=tid, worker_id=w.worker_id,
                            divergence=v.get("divergence"), bad_step=v.get("bad_step"),
                            capsule=v.get("capsule"), diagnosis=v.get("diagnosis"))
                _health.note_contained()
                w._floor_feedback(kn)
                _destroy(models[i])
                continue
            score = float(scores[i])
            w.advisor.feedback(score, kn)
            if w.curve is not None:
                w.curve.note_scored(kn, score)
            telemetry.inc("worker.trials_succeeded")
            telemetry.inc("worker.packed_trials")
            if w._saver is not None:
                w._saver.submit(tid, models[i], score, sink)
            else:
                with logger.capture(sink):
                    w._persist(tid, models[i], score)
        telemetry.inc("worker.packed_rounds")
        return len(rows), drained

    def _save_pack_checkpoints(self, rows, epoch: int, make_blobs) -> None:
        """Write one round's per-member checkpoints, each member's under
        its own epoch counter (evicted and backfilled members drift from
        the round index). A failed write costs that trial's
        resumability, never the pack: counted and evented, as a serial
        trial's."""
        w = self.w
        t0 = time.monotonic()
        try:
            blobs = make_blobs()
        except Exception:
            telemetry.inc("worker.checkpoint_write_failed")
            events.emit("checkpoint_write_failed", trial_id=rows[0][0], epoch=epoch,
                        worker_id=w.worker_id, error=traceback.format_exc(limit=3))
            ledger.add("checkpoint_s", time.monotonic() - t0)
            return
        slice_s = time.monotonic() - t0
        for mi, member_epoch, blob in blobs:
            tid = rows[mi][0]
            t1 = time.monotonic()
            try:
                w.params_store.save_checkpoint(tid, member_epoch, blob)
                events.emit("checkpoint_written", trial_id=tid, epoch=member_epoch,
                            worker_id=w.worker_id, bytes=len(blob),
                            seconds=time.monotonic() - t1, slice_seconds=slice_s)
            except Exception:
                telemetry.inc("worker.checkpoint_write_failed")
                events.emit("checkpoint_write_failed", trial_id=tid, epoch=member_epoch,
                            worker_id=w.worker_id, error=traceback.format_exc(limit=3))
        # Charged to the bound pack entity (the sink runs inside it).
        ledger.add("checkpoint_s", time.monotonic() - t0)


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
                    _destroy(model)
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


def build_worker_from_store(store: MetaStore, params_store: ParamsStore,
                            sub_train_job_id: str, advisor: AdvisorHandle,
                            worker_id: str = "worker-0", devices=None,
                            stop_event=None, async_persist: bool = True) -> TrainWorker:
    """A TrainWorker for a sub train job, built from the meta store's
    rows alone: its job's datasets and budget, and its model's uploaded
    template."""
    sub_row = store.get_sub_train_job(sub_train_job_id)
    if sub_row is None:
        raise KeyError(f"No sub train job {sub_train_job_id!r}")
    job = store.get_train_job(sub_row["train_job_id"])
    model = store.get_model(sub_row["model_id"])
    model_cls = load_model_class(model["model_file"], model["model_class"])
    return TrainWorker(
        store, params_store, sub_train_job_id, model_cls, advisor,
        job["train_dataset_uri"], job["val_dataset_uri"], job["budget"],
        worker_id=worker_id, devices=devices, job_created_at=job["created_at"],
        stop_event=stop_event, async_persist=async_persist)
