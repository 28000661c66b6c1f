"""A dp group of the port's ProcessScheduler losing one member, on the
CPU: the counterpart of ``tests/test_elastic.py::
test_multihost_group_member_sigkill_respawns_group``.

``kill -9`` one rank of a 2-process gloo group (the follower, then the
leader) on its first attempt: the scheduler tears the whole group down
at once (no wait for the collective timeout), respawns it, the new
leader adopts the orphan, and the budget completes
(``tests/test_torch_elastic_group_resume.py``: a group killed between
epochs resumes the orphan from its checkpoint on both ranks).
"""

import time

import pytest
import torch

from rafiki_tpu_torch.scheduler import ProcessScheduler
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from tests.test_torch_elastic import with_train_prologue
from tests.test_torch_scheduler import make_job, sources  # noqa: F401

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

GROUP_CRASH = b"""        import os, pathlib
        import torch.distributed as dist
        flag = pathlib.Path(os.environ["RAFIKI_TEST_CRASH_FLAG"])
        if dist.get_rank() == %d and not flag.exists():
            flag.write_text("crashed")
            os.kill(os.getpid(), 9)
"""


@pytest.mark.parametrize("crash_rank", [1, 0], ids=["follower-killed", "leader-killed"])
def test_group_member_sigkill_respawns_group(tmp_path, monkeypatch, sources,  # noqa: F811
                                             crash_rank):
    monkeypatch.setenv("RAFIKI_TEST_CRASH_FLAG", str(tmp_path / "crash.flag"))
    monkeypatch.setenv("RAFIKI_WORKER_RESTART_BACKOFF_S", "0.1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    store, params = MetaStore(tmp_path / "meta.sqlite3"), ParamsStore(tmp_path / "params")
    src = with_train_prologue(sources["port"], b"GroupCrashFF", GROUP_CRASH % crash_rank)
    job = make_job(store, src, {"MODEL_TRIAL_COUNT": 2}, name="gcrash", cls="GroupCrashFF")
    t0 = time.monotonic()
    result = ProcessScheduler(store, params).run_train_job(
        job["id"], n_workers=1, devices_per_trial=1, advisor_kind="random", platform="cpu",
        poll_s=0.2, multihost_processes=2)
    wall = time.monotonic() - t0
    assert (tmp_path / "crash.flag").exists(), "the crash never happened"
    assert result.status == "COMPLETED", result.errors
    completed = [t for t in result.trials if t["status"] == "COMPLETED"]
    assert len(completed) == 2
    assert {t["worker_id"] for t in completed} == {f"{job['id'][:8]}-p0-r1"}
    # Teardown is direct process supervision, not a collective timeout.
    assert wall < 100, f"group teardown took {wall:.0f}s"

