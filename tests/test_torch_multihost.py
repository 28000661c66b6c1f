"""The port's dp worker groups under the ProcessScheduler, on the CPU:
the counterparts of ``tests/test_multihost.py``'s group cases.

A group of ``devices_per_trial x multihost_processes`` ranks, one CPU
process each, joins one gloo group; rank 0 leads, the other rank mirrors
its trials (``worker/follower.py``), so every step's all-reduce crosses
the process boundary. Completion is itself the evidence: the leader's
collectives block unless the follower joins them. Each rank's
``multihost_init`` event keeps the JAX package's fields; a rank owns one
device, so ``process_count`` is the world size and ``local_devices`` is
1 (where the JAX package's process owns ``devices_per_trial`` devices).
"""

import threading
import time

import pytest
import torch

from rafiki_tpu_torch.scheduler import ProcessScheduler
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.events import events
from tests.test_torch_scheduler import make_job, sources  # noqa: F401

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)


@pytest.fixture()
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    prev = events.path
    events.configure(tmp_path / "logs")
    yield MetaStore(tmp_path / "meta.sqlite3"), ParamsStore(tmp_path / "params")
    events.close()
    if prev is not None:
        events.configure(prev.parent)


@pytest.mark.parametrize("dpt, mh", [(2, 1), (1, 2)], ids=["devices_per_trial=2",
                                                         "multihost_processes=2"])
def test_dp_train_job(env, sources, dpt, mh):  # noqa: F811
    store, params = env
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 2})
    result = ProcessScheduler(store, params).run_train_job(
        job["id"], n_workers=1, devices_per_trial=dpt, advisor_kind="random", platform="cpu",
        poll_s=0.2, multihost_processes=mh)
    assert result.status == "COMPLETED", result.errors
    completed = [t for t in result.trials if t["status"] == "COMPLETED"]
    assert len(completed) == 2 and all(t["params_id"] for t in completed)
    inits = list(events.read("multihost_init"))
    assert sorted(e["process_id"] for e in inits) == [0, 1]
    assert all(e["process_count"] == 2 and e["global_devices"] == 2 and e["local_devices"] == 1
               for e in inits)
    assert sorted(e["worker_id"] for e in inits) == [f"{job['id'][:8]}-p0",
                                                     f"{job['id'][:8]}-p0.1"]
    # Each rank reports the device it resolved: the CPU it was asked for.
    assert sorted((e["worker_id"], e["device"], e["device_name"])
                  for e in events.read("worker_device")) == [
        (f"{job['id'][:8]}-p0", "cpu", "cpu"), (f"{job['id'][:8]}-p0.1", "cpu", "cpu")]


def test_two_groups_do_not_cross_mirror(env, sources):  # noqa: F811
    """Two 2-rank groups on one sub-job: each follower mirrors only its
    own leader's trials (one mirroring another group's would enter
    collectives its leader never issues; this test hanging is the
    failure)."""
    store, params = env
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 4})
    result = ProcessScheduler(store, params).run_train_job(
        job["id"], n_workers=2, devices_per_trial=2, advisor_kind="random", platform="cpu",
        poll_s=0.2)
    assert result.status == "COMPLETED", result.errors
    assert len([t for t in result.trials if t["status"] == "COMPLETED"]) == 4
    assert len(list(events.read("multihost_init"))) == 4  # 2 groups x 2 ranks


def test_time_budget_terminates_the_group(env, sources):  # noqa: F811
    """A TIME_HOURS-only budget: the leader marks its service row stopped
    before exiting and the follower watches it (else each waits for the
    other)."""
    store, params = env
    job = make_job(store, sources["port"], {"TIME_HOURS": 8.0 / 3600})
    result = ProcessScheduler(store, params).run_train_job(
        job["id"], n_workers=1, devices_per_trial=2, advisor_kind="random", platform="cpu",
        poll_s=0.2)
    assert result.status == "COMPLETED", result.errors


def test_stop_event_ends_leader_and_follower(env, sources):  # noqa: F811
    store, params = env
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 10_000})
    stop = threading.Event()
    out = {}

    def run():
        out["result"] = ProcessScheduler(store, params).run_train_job(
            job["id"], n_workers=1, devices_per_trial=2, advisor_kind="random",
            platform="cpu", poll_s=0.2, stop_event=stop)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and not any(
            t["status"] == "COMPLETED" for t in store.get_trials_of_train_job(job["id"])):
        time.sleep(0.2)
    stop.set()
    th.join(timeout=90)
    assert not th.is_alive()
    assert out["result"].status == "STOPPED"
