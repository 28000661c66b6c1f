"""Follower half of a dp worker group.

The port's own copy of ``rafiki_tpu/worker/follower.py``. In a worker
group of W processes (one per device, one ``torch.distributed`` group),
rank 0, the leader, runs the ordinary ``TrainWorker`` trial loop: store
writes, advisor propose and feedback, params persistence. Ranks 1..W-1
run this follower loop instead. Every rank must issue the same sequence
of collectives, so the follower mirrors each of the leader's trials
step for step:

  * it watches the shared meta store for trials of its sub-job entering
    RUNNING under its own leader's worker id (the leader creates the row
    before building the model, so no trial's collectives are missed);
  * for each, it builds the same model from the same knobs, joins the
    dp mesh on its own device and calls train and evaluate, drawing the
    same global batches (an epoch's order is seeded by the trial seed
    and the epoch) and training on its rows of them;
  * where the trial has a checkpoint in the shared params store (an
    adopted trial the leader resumes), it restores that checkpoint
    first, as the leader does. The JAX package's follower has no such
    channel, so its multihost groups rerun an adopted trial from the
    start. The leader writes the trial's next checkpoint only after an
    epoch whose collectives this rank has joined, so both ranks read
    the same one;
  * it writes no rows and no params, and calls no advisor: one control
    plane, a replicated data plane;
  * it exits when the sub-job reaches a terminal status, the trial
    budget is spent and nothing runs, or its leader's service row is
    terminal.

A model error raises on the leader too (same class, same knobs, same
data) and is the leader's to report, so the follower contains it. A
failed collective (``ops/train.py CollectiveError``) is not contained:
the follower exits non-zero and the scheduler tears the whole group
down and respawns it (``scheduler/process.py``).
"""

from __future__ import annotations

import time
from typing import Optional

from rafiki_tpu_torch.constants import ServiceStatus, TrainJobStatus, TrialStatus
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.ops.train import CollectiveError
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.backend import default_device, resolve_device

_TERMINAL = {TrainJobStatus.COMPLETED.value, TrainJobStatus.ERRORED.value,
             TrainJobStatus.STOPPED.value}


class FollowerWorker:
    def __init__(self, store: MetaStore, params_store: ParamsStore, sub_train_job_id: str,
                 leader_worker_id: Optional[str] = None,
                 leader_service_id: Optional[str] = None,
                 poll_s: float = 0.2, device=None):
        self.store = store
        self.params_store = params_store
        self.sub_id = sub_train_job_id
        # Scoped to OUR group's leader: with several groups on one sub-job,
        # mirroring another group's trials would enter collectives our own
        # leader never issues.
        self.leader_worker_id = leader_worker_id
        self.leader_service_id = leader_service_id
        self.poll_s = poll_s
        self.device = resolve_device(device)
        self.mirrored = 0

    def _budget_drained(self, job: dict, trials: list) -> bool:
        max_trials = (job.get("budget") or {}).get("MODEL_TRIAL_COUNT")
        if max_trials is None:
            return False
        settled = [t for t in trials
                   if t["status"] in (TrialStatus.COMPLETED.value, TrialStatus.ERRORED.value)]
        return len(settled) >= int(max_trials)

    def run(self) -> int:
        """Mirror trials until the job ends. Returns #trials mirrored."""
        from rafiki_tpu_torch.parallel.mesh import data_parallel_mesh

        sub = self.store.get_sub_train_job(self.sub_id)
        if sub is None:
            raise KeyError(f"No sub train job {self.sub_id!r}")
        job = self.store.get_train_job(sub["train_job_id"])
        model_row = self.store.get_model(sub["model_id"])
        model_cls = load_model_class(model_row["model_file"], model_row["model_class"])
        mesh = data_parallel_mesh([self.device])
        seen = set()
        while True:
            trials = self.store.get_trials_of_sub_train_job(self.sub_id)
            ran_one = False
            for t in trials:
                if t["id"] in seen or t["status"] != TrialStatus.RUNNING.value:
                    continue
                if (self.leader_worker_id is not None
                        and t.get("worker_id") != self.leader_worker_id):
                    continue  # another group's trial
                seen.add(t["id"])
                ran_one = True
                self._mirror(model_cls, t, job, mesh)
            if ran_one:
                continue  # look again at once: the next trial may be up
            sub = self.store.get_sub_train_job(self.sub_id)
            if sub is None or sub["status"] in _TERMINAL:
                break
            if self._budget_drained(job, trials) and not any(
                    t["status"] == TrialStatus.RUNNING.value for t in trials):
                break
            if self._leader_done():
                # Budgets with no trial count (TIME_HOURS only): the leader
                # marks its service row terminal before it exits; without
                # this the follower would wait for a sub-job status the
                # scheduler writes only after every group process exits.
                break
            time.sleep(self.poll_s)
        return self.mirrored

    def _mirror(self, model_cls, trial: dict, job: dict, mesh) -> None:
        model = None
        try:
            # Construction stays inside the containment: a knob-dependent
            # constructor error raises on the leader too.
            with default_device(self.device):
                model = model_cls(**trial["knobs"])
                if hasattr(model, "set_mesh"):
                    model.set_mesh(mesh)
                self._restore(model, trial["id"])
                model.train(job["train_dataset_uri"])
                model.evaluate(job["val_dataset_uri"])
            self.mirrored += 1
        except CollectiveError:
            raise  # the group is broken: exit, and let the scheduler respawn it
        except Exception:
            # The leader hit the same error and reports it; the follower
            # only keeps the collectives paired.
            pass
        finally:
            if model is not None:
                try:
                    model.destroy()
                except Exception:
                    pass  # a template's destroy() must not kill the group

    def _restore(self, model, trial_id: str) -> None:
        """The leader's resume, mirrored: restore the trial's newest
        checkpoint where there is one. A blob that does not restore fails
        the leader's restore too, and both ranks start from scratch."""
        if not hasattr(model, "restore_checkpoint"):
            return
        latest = self.params_store.latest_checkpoint(trial_id)
        if latest is not None:
            try:
                model.restore_checkpoint(latest[1])
            except Exception:
                pass

    def _leader_done(self) -> bool:
        if self.leader_service_id is None:
            return False
        svc = self.store.get_service(self.leader_service_id)
        return svc is None or svc["status"] in (ServiceStatus.STOPPED.value,
                                                ServiceStatus.ERRORED.value)
