"""A dp group of the port's ProcessScheduler killed between epochs
resumes its trial from the checkpoint on every rank, on the CPU.

The leader of a width-2 gloo group SIGKILLs itself after epoch 1 of a
3-epoch trial (the ``worker.epoch`` chaos site, after that epoch's
checkpoint is written). The respawned leader journals ``trial_resumed``
from epoch 2 and its follower restores the same checkpoint from the
shared params store. The resumed trial's params equal, bit for bit, those
of the same trial run unfaulted by a width-2 group: a follower that
reran from epoch 0 would pair its collectives with the leader's at other
params, and a group that reran both ranks from epoch 0 would journal no
resume.
"""

import pickle

import torch

from rafiki_tpu_torch.chaos.scenarios import FF_SOURCE, TRAIN, VAL
from rafiki_tpu_torch.obs import journal as journal_mod
from rafiki_tpu_torch.scheduler import ProcessScheduler
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.serial import load_flat

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

KILL_AFTER_EPOCH_1 = "seed=7;worker.epoch:kill:after=1:times=1:unless=-r"


def _group_trial(tmp, monkeypatch, chaos):
    """The one trial of a width-2 job (``chaos`` the fault spec, or
    None), its params store and its journal records."""
    if chaos:
        monkeypatch.setenv("RAFIKI_CHAOS", chaos)
    else:
        monkeypatch.delenv("RAFIKI_CHAOS", raising=False)
    monkeypatch.setenv(journal_mod.ENV_VAR, str(tmp / "obs"))
    store, params = MetaStore(tmp / "meta.sqlite3"), ParamsStore(tmp / "params")
    model = store.create_model("chaosff", "IMAGE_CLASSIFICATION", None, FF_SOURCE, "ChaosFF")
    job = store.create_train_job("resume", "IMAGE_CLASSIFICATION", None, TRAIN, VAL,
                                 {"MODEL_TRIAL_COUNT": 1})
    store.create_sub_train_job(job["id"], model["id"])
    result = ProcessScheduler(store, params).run_train_job(
        job["id"], n_workers=1, devices_per_trial=2, advisor_kind="random", platform="cpu",
        poll_s=0.2)
    assert result.status == "COMPLETED", result.errors
    [trial] = result.trials
    assert trial["status"] == "COMPLETED"
    assert params.latest_checkpoint(trial["id"]) is None
    return trial, params, journal_mod.read_dir(tmp / "obs")


def test_killed_group_resumes_its_trial_from_the_checkpoint_on_both_ranks(tmp_path,
                                                                          monkeypatch):
    monkeypatch.setenv("RAFIKI_CHECKPOINT_EVERY", "1")
    monkeypatch.setenv("RAFIKI_TPU_SERVING_PARAMS_DTYPE", "float32")
    monkeypatch.setenv("RAFIKI_WORKER_RESTART_BACKOFF_S", "0.1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    (tmp_path / "killed").mkdir()
    (tmp_path / "plain").mkdir()
    trial, params, recs = _group_trial(tmp_path / "killed", monkeypatch, KILL_AFTER_EPOCH_1)
    ref, ref_params, ref_recs = _group_trial(tmp_path / "plain", monkeypatch, None)

    assert trial["worker_id"].endswith("-r1") and not ref["worker_id"].endswith("-r1")
    resumed = [(r.get("trial_id"), r.get("from_epoch")) for r in recs
               if r.get("kind") == "event" and r.get("name") == "trial_resumed"]
    assert resumed == [(trial["id"], 2)]
    assert not any(r.get("name") == "trial_resumed" for r in ref_recs)
    assert trial["knobs"] == ref["knobs"]

    def leaves(store, t):
        return load_flat(pickle.loads(store.load(t["params_id"]))["packed"])

    got, want = leaves(params, trial), leaves(ref_params, ref)
    assert set(got) == set(want)
    for k in want:
        assert want[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
