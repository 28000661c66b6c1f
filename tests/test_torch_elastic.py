"""In-job elasticity of the port's ProcessScheduler, on the CPU: the
counterparts of ``tests/test_elastic.py``'s subprocess cases.

A worker that dies mid-trial (a template that SIGKILLs its own process
from inside ``train``, first attempt only, gated on a flag file) must be
respawned with backoff, and the replacement must adopt the orphaned
RUNNING trial, so the job still completes its exact budget; a worker
that dies every time is given up after its restarts, its orphan marked
ERRORED; and stopping the job during a restart backoff leaves no trial
RUNNING. The same templates die in the JAX package's test.
"""

import threading
import time

import pytest
import torch

from rafiki_tpu_torch.scheduler import ProcessScheduler
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from tests.test_torch_scheduler import make_job, sources  # noqa: F401

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

TRAIN_DEF = b"    def train(self, dataset_uri):\n"


def with_train_prologue(source: bytes, name: bytes, prologue: bytes) -> bytes:
    """The TinyFF template renamed ``name``, ``prologue`` run first in its
    ``train``."""
    return source.replace(b"class TinyFF(", b"class " + name + b"(").replace(
        TRAIN_DEF, TRAIN_DEF + prologue)


CRASH_ONCE = b"""        import os, pathlib
        flag = pathlib.Path(os.environ["RAFIKI_TEST_CRASH_FLAG"])
        if not flag.exists():
            flag.write_text("crashed")
            os.kill(os.getpid(), 9)  # SIGKILL: no cleanup, no excepthook
"""
ALWAYS_CRASH = b"""        import os
        os.kill(os.getpid(), 9)
"""


@pytest.fixture()
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFIKI_TEST_CRASH_FLAG", str(tmp_path / "crash.flag"))
    monkeypatch.setenv("RAFIKI_WORKER_RESTART_BACKOFF_S", "0.1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return MetaStore(tmp_path / "meta.sqlite3"), ParamsStore(tmp_path / "params"), tmp_path


def test_sigkilled_worker_restarts_and_budget_completes(env, sources):  # noqa: F811
    store, params, tmp = env
    src = with_train_prologue(sources["port"], b"CrashOnceFF", CRASH_ONCE)
    job = make_job(store, src, {"MODEL_TRIAL_COUNT": 3}, name="crashff", cls="CrashOnceFF")
    result = ProcessScheduler(store, params).run_train_job(
        job["id"], n_workers=1, advisor_kind="random", platform="cpu", poll_s=0.2)
    assert (tmp / "crash.flag").exists(), "the crash never happened"
    assert result.status == "COMPLETED", result.errors
    assert len(result.trials) == 3, "budget shrank or overshot after restart"
    assert all(t["status"] == "COMPLETED" for t in result.trials)
    # Every trial ran on (or was adopted by) the restarted worker.
    assert {t["worker_id"] for t in result.trials} == {f"{job['id'][:8]}-p0-r1"}
    assert len(params.load(result.best_trials[0]["params_id"])) > 100
    svc = store.get_services_of_job(job["id"])
    assert [s["status"] for s in svc] == ["ERRORED", "STOPPED"]


def test_restarts_exhausted_marks_job_errored(env, sources, monkeypatch):  # noqa: F811
    store, params, _ = env
    monkeypatch.setenv("RAFIKI_WORKER_MAX_RESTARTS", "1")
    src = with_train_prologue(sources["port"], b"AlwaysCrashFF", ALWAYS_CRASH)
    job = make_job(store, src, {"MODEL_TRIAL_COUNT": 2}, name="always", cls="AlwaysCrashFF")
    result = ProcessScheduler(store, params).run_train_job(
        job["id"], n_workers=1, advisor_kind="random", platform="cpu", poll_s=0.2)
    assert result.status == "ERRORED"
    assert result.errors, "permanent worker death left no trace"
    assert result.trials and all(t["status"] == "ERRORED" for t in result.trials)
    assert all("restarts exhausted" in (t["error"] or "") for t in result.trials)


def test_stop_during_backoff_terminates_orphan(env, sources, monkeypatch):  # noqa: F811
    store, params, _ = env
    monkeypatch.setenv("RAFIKI_WORKER_RESTART_BACKOFF_S", "60")
    src = with_train_prologue(sources["port"], b"AlwaysCrashFF", ALWAYS_CRASH)
    job = make_job(store, src, {"MODEL_TRIAL_COUNT": 5}, name="always", cls="AlwaysCrashFF")
    stop = threading.Event()
    out = {}

    def run():
        out["result"] = ProcessScheduler(store, params).run_train_job(
            job["id"], n_workers=1, advisor_kind="random", platform="cpu", poll_s=0.2,
            stop_event=stop)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    # Wait until the group sits in its 60 s backoff: its service row is
    # ERRORED once the supervise loop has seen the corpse.
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not any(
            s["status"] == "ERRORED" for s in store.get_services_of_job(job["id"])):
        time.sleep(0.2)
    stop.set()
    th.join(timeout=60)
    assert not th.is_alive()
    assert out["result"].status == "STOPPED"
    trials = store.get_trials_of_train_job(job["id"])
    assert trials
    for t in trials:
        assert t["status"] in ("TERMINATED", "COMPLETED", "ERRORED"), \
            f"orphan left {t['status']} on a stopped job"
