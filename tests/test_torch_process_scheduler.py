"""The port's process-per-device scheduler against the JAX package's, on
the CPU: subprocess workers (``python -m rafiki_tpu_torch.worker.main``)
sharing the sqlite meta store and a loopback HTTP advisor.

The counterparts of ``tests/test_process_scheduler.py``: the device
env, a process train job (here the same 4-trial job in both packages,
run side by side and compared: the same knobs in the same order, every
trial COMPLETED, scores within ``tests/test_torch_ff.py``'s F32_TOL, the
port's best blob served by the JAX package), two workers sharing a
budget, the stop event, and the five ``_WorkerGroup`` state rules. Then
the counterparts of ``tests/test_multihost.py``'s worker-entry cases:
the backend-init watchdog and the three ``initialize_collective`` retry
cases; and the scheduler's device arithmetic for ``devices_per_trial``.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rafiki_tpu.model.base import load_model_class as jax_load_model_class
from rafiki_tpu.scheduler import ProcessScheduler as JaxProcessScheduler
from rafiki_tpu.store import MetaStore as JaxMetaStore, ParamsStore as JaxParamsStore
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.config import Config
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.scheduler import LocalScheduler, ProcessScheduler, worker_device_env
from rafiki_tpu_torch.scheduler.process import _WorkerGroup
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from tests.test_torch_ff import F32_TOL
from tests.test_torch_scheduler import CPU, TRAIN, VAL, make_job, sources  # noqa: F401

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Subprocess workers inherit OMP_NUM_THREADS: one intra-op thread
    each, beside the other xdist workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def port_env(tmp_path):
    return MetaStore(tmp_path / "port.sqlite3"), ParamsStore(tmp_path / "port-params")


def test_device_env_cpu():
    env = worker_device_env("cpu", 0, devices_per_trial=2)
    assert env == {"RAFIKI_WORKER_DEVICE": "cpu", "CUDA_VISIBLE_DEVICES": ""}


def test_device_env_card():
    assert worker_device_env("cuda", 3, devices_per_trial=1) == {"CUDA_VISIBLE_DEVICES": "3"}
    assert worker_device_env("cuda", 1, devices_per_trial=2) == {"CUDA_VISIBLE_DEVICES": "2,3"}


def test_same_process_job_in_both_packages(sources, tmp_path):  # noqa: F811
    """One subprocess worker per package, the random advisor from seed 0,
    the same float32 template and start params: both jobs run at once,
    and their outcomes agree."""
    jstore, jparams = JaxMetaStore(tmp_path / "jax.sqlite3"), JaxParamsStore(tmp_path / "jax-p")
    jjob = make_job(jstore, sources["jax"], {"MODEL_TRIAL_COUNT": 4})
    store, params = port_env(tmp_path)
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 4})
    out = {}

    def run_jax():
        out["jax"] = JaxProcessScheduler(jstore, jparams).run_train_job(
            jjob["id"], n_workers=1, advisor_kind="random", platform="cpu", poll_s=0.2)

    th = threading.Thread(target=run_jax)
    th.start()
    got = ProcessScheduler(store, params).run_train_job(
        job["id"], n_workers=1, advisor_kind="random", platform="cpu", poll_s=0.2)
    th.join(timeout=300)
    want = out["jax"]
    assert got.status == want.status == "COMPLETED", (got.errors, want.errors)
    assert [t["knobs"] for t in got.trials] == [t["knobs"] for t in want.trials]
    assert [t["status"] for t in got.trials] == [t["status"] for t in want.trials] == \
        ["COMPLETED"] * 4
    scores = [(t["score"], u["score"]) for t, u in zip(got.trials, want.trials)]
    assert max(abs(a - b) for a, b in scores) <= F32_TOL["score"], scores
    assert {t["worker_id"] for t in got.trials} == {f"{job['id'][:8]}-p0"}
    svc = store.get_services_of_job(job["id"])
    assert [s["status"] for s in svc] == ["STOPPED"]
    # The port's best blob, written by its subprocess, serves in the JAX package.
    best = got.best_trials[0]
    blob = params.load(best["params_id"])
    served = load_model_class(sources["port"], "TinyFF")(device="cpu", **best["knobs"])
    ref = jax_load_model_class(sources["jax"], "TinyFF")(**best["knobs"])
    served.load_parameters(blob)
    ref.load_parameters(blob)
    q = np.random.default_rng(3).uniform(0, 1, size=(10, 8, 8, 1)).astype(np.float32).tolist()
    np.testing.assert_allclose(np.asarray(served.predict(q)), np.asarray(ref.predict(q)),
                               rtol=0, atol=1e-2)


def _slow(source: bytes) -> bytes:
    """The template with a 2 s sleep before each trial: six trials then
    outlast the workers' start-up skew, even on a loaded machine, so one
    worker cannot drain the budget alone."""
    return source.replace(b"    def train(self, dataset_uri):\n",
                          b"    def train(self, dataset_uri):\n"
                          b"        import time\n        time.sleep(2.0)\n")


def test_process_train_job_shares_the_budget_between_two_workers(sources, tmp_path):  # noqa: F811
    store, params = port_env(tmp_path)
    job = make_job(store, _slow(sources["port"]), {"MODEL_TRIAL_COUNT": 6})
    result = ProcessScheduler(store, params).run_train_job(
        job["id"], n_workers=2, advisor_kind="random", platform="cpu", poll_s=0.2)
    assert result.status == "COMPLETED", result.errors
    assert len(result.trials) == 6
    assert all(t["status"] == "COMPLETED" for t in result.trials)
    workers = {t["worker_id"] for t in result.trials}
    assert len(workers) == 2, f"budget drained by one worker: {workers}"
    assert len(params.load(result.best_trials[0]["params_id"])) > 100


def test_process_job_stop_event(sources, tmp_path):  # noqa: F811
    store, params = port_env(tmp_path)
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 5000})
    stop = threading.Event()
    out = {}

    def run():
        out["result"] = ProcessScheduler(store, params).run_train_job(
            job["id"], n_workers=2, advisor_kind="random", platform="cpu", poll_s=0.2,
            stop_event=stop)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and not any(
            t["status"] == "COMPLETED" for t in store.get_trials_of_train_job(job["id"])):
        time.sleep(0.2)
    stop.set()
    th.join(timeout=60)
    assert not th.is_alive()
    assert out["result"].status == "STOPPED"
    assert 1 <= len(out["result"].trials) < 5000
    assert all(t["status"] != "RUNNING" for t in out["result"].trials)
    assert {s["status"] for s in store.get_services_of_job(job["id"])} == {"STOPPED"}


def test_a_card_job_refuses_to_start_without_a_card(sources, tmp_path):  # noqa: F811
    """Nothing falls back to the CPU: the default platform is the card."""
    store, params = port_env(tmp_path)
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 1})
    with pytest.raises(RuntimeError, match="CUDA"):
        ProcessScheduler(store, params).run_train_job(job["id"])
    assert store.get_train_job(job["id"])["status"] == "STARTED"


# -- group liveness: _WorkerGroup.state ------------------------------------------


class _StubProc:
    """poll()-only stand-in for a subprocess.Popen in _WorkerGroup."""

    def __init__(self, rc):
        self._rc = rc

    def poll(self):
        return self._rc


def _group(*rcs):
    g = _WorkerGroup(0)
    g.procs = [_StubProc(rc) for rc in rcs]
    return g


def test_follower_rc0_midtrial_fails_group_after_grace(monkeypatch):
    monkeypatch.setenv("RAFIKI_FOLLOWER_EXIT_GRACE_S", "0.2")
    g = _group(None, 0)  # leader alive, follower exited clean
    assert g.state() == "running"  # the first look arms the clock
    assert g.partial_exit_at is not None
    time.sleep(0.3)
    assert g.state() == "failed"


def test_follower_rc0_within_grace_stays_running(monkeypatch):
    monkeypatch.setenv("RAFIKI_FOLLOWER_EXIT_GRACE_S", "30")
    g = _group(None, 0)
    assert g.state() == "running"
    assert g.state() == "running"


def test_clean_group_exit_is_ok_not_failed():
    g = _group(0, 0)
    assert g.state() == "ok"
    assert g.partial_exit_at is None


def test_follower_nonzero_exit_fails_immediately():
    assert _group(None, 1).state() == "failed"


def test_leader_clean_exit_with_follower_draining_stays_running():
    g = _group(0, None)
    assert g.state() == "running"
    assert g.partial_exit_at is None


# -- the worker entry point ----------------------------------------------------------


def test_backend_init_watchdog_exits_structured(tmp_path):
    """A rank whose rendezvous never answers exits 17 with a structured
    line instead of stalling the scheduler's supervise loop."""
    env = dict(os.environ)
    env.update({
        "RAFIKI_WORKER_DEVICE": "cpu",
        "RAFIKI_WORKER_DB": str(tmp_path / "meta.sqlite3"),
        "RAFIKI_WORKER_PARAMS_DIR": str(tmp_path / "params"),
        "RAFIKI_WORKER_SUB_JOB_ID": "nope",
        "RAFIKI_WORKER_ADVISOR_URL": "http://127.0.0.1:1",
        "RAFIKI_WORKER_ADVISOR_ID": "nope",
        # A coordinator that never answers: the rendezvous blocks.
        "RAFIKI_COORDINATOR_ADDRESS": "127.0.0.1:1",
        "RAFIKI_NUM_PROCESSES": "2",
        "RAFIKI_PROCESS_ID": "1",
        "RAFIKI_BACKEND_INIT_TIMEOUT_S": "3",
    })
    r = subprocess.run([sys.executable, "-m", "rafiki_tpu_torch.worker.main"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 17, (r.stdout, r.stderr)
    assert "backend init exceeded" in r.stdout


def test_a_card_worker_exits_1_without_a_card(tmp_path):
    env = dict(os.environ, RAFIKI_WORKER_DB=str(tmp_path / "m.sqlite3"),
               RAFIKI_WORKER_PARAMS_DIR=str(tmp_path / "p"), RAFIKI_WORKER_SUB_JOB_ID="nope",
               RAFIKI_WORKER_ADVISOR_URL="http://127.0.0.1:1", RAFIKI_WORKER_ADVISOR_ID="nope")
    env.pop("RAFIKI_WORKER_DEVICE", None)
    r = subprocess.run([sys.executable, "-m", "rafiki_tpu_torch.worker.main"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "CUDA" in r.stderr


def test_collective_init_retries_transient_failure(monkeypatch):
    from rafiki_tpu_torch.worker.main import initialize_collective

    monkeypatch.setenv("RAFIKI_COLLECTIVE_INIT_RETRIES", "3")
    monkeypatch.setenv("RAFIKI_COLLECTIVE_INIT_BACKOFF_S", "0.01")
    calls = []

    def flaky(coordinator_address, num_processes, process_id):
        calls.append((coordinator_address, num_processes, process_id))
        if len(calls) == 1:
            raise RuntimeError("transient barrier race")

    initialize_collective(flaky, "127.0.0.1:9999", 2, 1)
    assert len(calls) == 2, "the failed attempt was not retried"
    assert calls[-1] == ("127.0.0.1:9999", 2, 1)


def test_collective_init_exhaustion_reraises(monkeypatch):
    from rafiki_tpu_torch.worker.main import initialize_collective

    monkeypatch.setenv("RAFIKI_COLLECTIVE_INIT_RETRIES", "2")
    monkeypatch.setenv("RAFIKI_COLLECTIVE_INIT_BACKOFF_S", "0.01")
    calls = []

    def dead(coordinator_address, num_processes, process_id):
        calls.append(1)
        raise RuntimeError("coordinator unreachable")

    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        initialize_collective(dead, "127.0.0.1:9999", 2, 0)
    assert len(calls) == 3, "retries + the final attempt"


def test_collective_init_chaos_fault_absorbed_by_retry(monkeypatch):
    """An injected collective.init error is absorbed like a real init
    failure: the faulted attempt never reaches the initialize fn."""
    from rafiki_tpu_torch.chaos import FaultPlane, install, uninstall
    from rafiki_tpu_torch.worker.main import initialize_collective

    monkeypatch.setenv("RAFIKI_COLLECTIVE_INIT_RETRIES", "3")
    monkeypatch.setenv("RAFIKI_COLLECTIVE_INIT_BACKOFF_S", "0.01")
    calls = []

    def ok(coordinator_address, num_processes, process_id):
        calls.append(1)

    install(FaultPlane.from_spec("seed=5;collective.init:error:times=1"))
    try:
        initialize_collective(ok, "127.0.0.1:9999", 2, 0)
    finally:
        uninstall()
    assert len(calls) == 1, "the injected-fault attempt leaked through"


# -- devices_per_trial in the thread scheduler and the admin ------------------------


def test_local_scheduler_follows_the_device_arithmetic(sources, tmp_path):  # noqa: F811
    """One device and devices_per_trial=2: one worker of one device, at
    width 1, as the JAX package runs it; two devices and
    devices_per_trial=2: one worker of both, each trial on an in-process
    dp mesh over them."""
    store, params = port_env(tmp_path)
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 1})
    result = LocalScheduler(store, params).run_train_job(
        job["id"], devices=CPU, devices_per_trial=2, advisor_kind="random")
    assert result.status == "COMPLETED" and len(result.trials) == 1
    assert [json.loads(s["devices"]) for s in store.get_services_of_job(job["id"])] == [["cpu"]]
    job2 = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 1}, name="two")
    result2 = LocalScheduler(store, params).run_train_job(
        job2["id"], devices=CPU * 2, devices_per_trial=2, advisor_kind="random")
    assert result2.status == "COMPLETED" and not result2.errors
    assert [t["status"] for t in result2.trials] == ["COMPLETED"]
    assert [json.loads(s["devices"]) for s in store.get_services_of_job(job2["id"])] == \
        [["cpu", "cpu"]]


def test_a_collective_step_fault_errors_the_in_process_trial_in_both_packages(
        sources, tmp_path):  # noqa: F811
    """Two devices in one worker: the trial's first epoch passes the
    ``collective.step`` site once, keyed ``p0:<worker id>`` in both
    packages (the JAX package's in-process mesh is process 0), and an
    injected error there errors the trial."""
    import jax

    from rafiki_tpu import chaos as jax_chaos
    from rafiki_tpu.scheduler import LocalScheduler as JaxLocalScheduler
    from rafiki_tpu_torch import chaos

    spec = "seed=3;collective.step:error:times=1:match=p0"
    jstore, jparams = JaxMetaStore(tmp_path / "jax.sqlite3"), JaxParamsStore(tmp_path / "jax-p")
    jjob = make_job(jstore, sources["jax"], {"MODEL_TRIAL_COUNT": 1})
    jax_chaos.install(jax_chaos.FaultPlane.from_spec(spec))
    try:
        want = JaxLocalScheduler(jstore, jparams).run_train_job(
            jjob["id"], devices=jax.devices("cpu")[:2], devices_per_trial=2,
            advisor_kind="random")
    finally:
        jax_chaos.uninstall()
    store, params = port_env(tmp_path)
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 1})
    chaos.install(chaos.FaultPlane.from_spec(spec))
    try:
        got = LocalScheduler(store, params).run_train_job(
            job["id"], devices=CPU * 2, devices_per_trial=2, advisor_kind="random")
    finally:
        chaos.uninstall()
    for result in (want, got):
        assert [t["status"] for t in result.trials] == ["ERRORED"]
        assert "injected collective.step failure" in result.trials[0]["error"]
    assert got.status == want.status
    assert [json.loads(s["devices"]) for s in store.get_services_of_job(job["id"])] == \
        [["cpu", "cpu"]]


def test_admin_takes_devices_per_trial(sources, tmp_path):  # noqa: F811
    admin = Admin(config=Config(data_dir=tmp_path / "admin"), device="cpu")
    try:
        admin.create_model(None, "tinyff", "IMAGE_CLASSIFICATION", sources["port"], "TinyFF")
        job = admin.create_train_job(None, "dpapp", "IMAGE_CLASSIFICATION", TRAIN, VAL,
                                     {"MODEL_TRIAL_COUNT": 1}, devices_per_trial=2,
                                     advisor_kind="random")
        admin.services._train_jobs[job["id"]].thread.join(timeout=120)
        assert admin.store.get_train_job(job["id"])["status"] == "COMPLETED"
        # The CPU admin's one device, twice: one worker of two replicas.
        assert [json.loads(s["devices"]) for s in
                admin.store.get_services_of_job(job["id"])] == [["cpu", "cpu"]]
    finally:
        admin.stop()
