"""Failure detection and orphaned-trial recovery in the port, against the
JAX package's, on the CPU.

``tests/test_recovery.py``'s orphan tests and its compare-and-swap
double adoption in the port, and a restarted worker adopting its dead
predecessor's trials; one orphan left in a shared meta store by
each package and adopted and re-run by the other (the same SQL); and
``POST /recovery`` over both packages' REST apps, with the same
statuses for an admin, another user and no token.
"""

import time

import pytest
import torch

from rafiki_tpu.constants import ServiceStatus as JaxServiceStatus
from rafiki_tpu.scheduler.recovery import recover_orphaned_trials as jax_recover
from rafiki_tpu.store import MetaStore as JaxMetaStore, ParamsStore as JaxParamsStore
from rafiki_tpu_torch.admin import Admin
from rafiki_tpu_torch.config import Config
from rafiki_tpu_torch.constants import ServiceStatus, ServiceType
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.scheduler.recovery import _RecoveryAdvisor, recover_orphaned_trials
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.worker.train import TrainWorker
from tests.test_checkpoint_resume import FF3_SOURCE as JAX_FF3_SOURCE
from tests.test_torch_checkpoint import FF3_SOURCE, KNOBS, TRAIN, VAL
from tests.test_torch_rest import SUPER, call, servers  # noqa: F401 — fixture

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

CPU = [torch.device("cpu")]


@pytest.fixture()
def env(tmp_path):
    store = MetaStore(tmp_path / "meta.sqlite3")
    params = ParamsStore(tmp_path / "params")
    row = store.create_model("ff3", "IMAGE_CLASSIFICATION", None, FF3_SOURCE, "FF3")
    job = store.create_train_job("recapp", "IMAGE_CLASSIFICATION", None,
                                 TRAIN, VAL, {"MODEL_TRIAL_COUNT": 2})
    sub = store.create_sub_train_job(job["id"], row["id"])
    return store, params, sub


def _orphan(store, sub, worker_id="dead"):
    svc = store.create_service(ServiceType.TRAIN_WORKER.value)
    t = store.create_trial(sub["id"], "FF3", KNOBS, worker_id=worker_id, service_id=svc["id"])
    store.update_service(svc["id"], status=ServiceStatus.ERRORED.value)
    return t


# -- tests/test_recovery.py in the port -------------------------------------------


def test_orphan_detection(env):
    store, params, sub = env
    svc_live = store.create_service(ServiceType.TRAIN_WORKER.value)
    svc_dead = store.create_service(ServiceType.TRAIN_WORKER.value)
    t_live = store.create_trial(sub["id"], "FF3", KNOBS, worker_id="w0", service_id=svc_live["id"])
    t_dead = store.create_trial(sub["id"], "FF3", KNOBS, worker_id="w1", service_id=svc_dead["id"])
    store.update_service(svc_dead["id"], status=ServiceStatus.ERRORED.value)
    store.update_service(svc_live["id"], heartbeat=True)

    assert [t["id"] for t in store.get_orphaned_trials(stale_after_s=60)] == [t_dead["id"]]
    # a live trial goes stale once its service stops heartbeating
    orphans = store.get_orphaned_trials(stale_after_s=-1)
    assert {t["id"] for t in orphans} == {t_live["id"], t_dead["id"]}
    # a trial bound to no service opted out of failure detection
    store.create_trial(sub["id"], "FF3", KNOBS, worker_id="w2")
    assert len(store.get_orphaned_trials(stale_after_s=-1, sub_train_job_id=sub["id"])) == 2


def test_completed_trials_never_orphaned(env):
    store, params, sub = env
    svc = store.create_service(ServiceType.TRAIN_WORKER.value)
    t = store.create_trial(sub["id"], "FF3", {"epochs": 3}, service_id=svc["id"])
    store.mark_trial_as_completed(t["id"], 0.9, None)
    store.update_service(svc["id"], status=ServiceStatus.ERRORED.value)
    assert store.get_orphaned_trials(stale_after_s=-1) == []
    t2 = store.create_trial(sub["id"], "FF3", {"epochs": 3}, service_id=svc["id"])
    store.mark_trial_as_terminated(t2["id"])
    assert store.get_trial(t2["id"])["status"] == "TERMINATED"
    assert store.get_orphaned_trials(stale_after_s=-1) == []


def test_admin_recover_sync_and_background(tmp_path):
    """wait=True returns terminal rows; wait=False returns the orphans as
    found and finishes them on a background thread."""
    admin = Admin(config=Config(data_dir=tmp_path / "port"), device="cpu")
    try:
        store = admin.store
        row = store.create_model("ff3", "IMAGE_CLASSIFICATION", None, FF3_SOURCE, "FF3")
        job = store.create_train_job("recadm", "IMAGE_CLASSIFICATION", None,
                                     TRAIN, VAL, {"MODEL_TRIAL_COUNT": 2})
        sub = store.create_sub_train_job(job["id"], row["id"])

        t1 = _orphan(store, sub)
        out = admin.recover_trials(stale_after_s=60, wait=True)
        assert [o["id"] for o in out] == [t1["id"]]
        assert out[0]["status"] == "COMPLETED"

        t2 = _orphan(store, sub)
        out = admin.recover_trials(stale_after_s=60, wait=False)
        assert [o["id"] for o in out] == [t2["id"]]
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if store.get_trial(t2["id"])["status"] == "COMPLETED":
                break
            time.sleep(0.2)
        assert store.get_trial(t2["id"])["status"] == "COMPLETED"
        assert admin.recover_trials(stale_after_s=60) == []
    finally:
        admin.stop()


def test_recover_orphaned_trial_end_to_end(env):
    """A trial whose worker died mid-run is found and re-run to
    completion from its checkpoint, on the device asked for."""
    store, params, sub = env
    cls = load_model_class(store.get_model(sub["model_id"])["model_file"], "FF3")

    class Crashy(cls):
        def evaluate(self, uri):
            raise KeyboardInterrupt  # hard death: no ERRORED mark

    Crashy.__name__ = "FF3"
    svc = store.create_service(ServiceType.TRAIN_WORKER.value)
    w = TrainWorker(store, params, sub["id"], Crashy, None, TRAIN, VAL,
                    {"MODEL_TRIAL_COUNT": 2}, worker_id="dying", async_persist=False,
                    checkpoint_every=1, devices=CPU)
    w.service_id = svc["id"]
    with pytest.raises(KeyboardInterrupt):
        w.run_trial(KNOBS)
    store.update_service(svc["id"], status=ServiceStatus.ERRORED.value)

    orphans = store.get_orphaned_trials(stale_after_s=60)
    assert len(orphans) == 1
    assert params.latest_checkpoint(orphans[0]["id"])[0] == 2

    results = recover_orphaned_trials(store, params, stale_after_s=60, devices=CPU)
    assert len(results) == 1
    assert results[0]["status"] == "COMPLETED"
    assert results[0]["score"] is not None and results[0]["params_id"]
    assert results[0]["worker_id"] == f"recovery-{orphans[0]['id'][:8]}"
    assert params.latest_checkpoint(orphans[0]["id"]) is None
    assert store.get_orphaned_trials(stale_after_s=60) == []
    # each recovery service is stopped after its run
    svc_id = store.get_trial(orphans[0]["id"])["service_id"]
    assert store.get_service(svc_id)["status"] == ServiceStatus.STOPPED.value


def test_a_restarted_worker_adopts_its_predecessors_orphans(env):
    """adopt_orphans_of_service: the replacement worker takes each RUNNING
    trial of the dead service by compare-and-swap and re-runs it from its
    checkpoint; a second pass finds nothing to adopt."""
    store, params, sub = env
    cls = load_model_class(store.get_model(sub["model_id"])["model_file"], "FF3")

    class Dying(cls):
        def evaluate(self, uri):
            raise KeyboardInterrupt

    Dying.__name__ = "FF3"
    dead = store.create_service(ServiceType.TRAIN_WORKER.value)
    w = TrainWorker(store, params, sub["id"], Dying, None, TRAIN, VAL, {"MODEL_TRIAL_COUNT": 2},
                    async_persist=False, checkpoint_every=1, devices=CPU)
    w.service_id = dead["id"]
    with pytest.raises(KeyboardInterrupt):
        w.run_trial(KNOBS)
    tid = store.get_trials_of_sub_train_job(sub["id"])[0]["id"]

    live = store.create_service(ServiceType.TRAIN_WORKER.value)
    heir = TrainWorker(store, params, sub["id"], cls, _RecoveryAdvisor(), TRAIN, VAL,
                       {"MODEL_TRIAL_COUNT": 2}, worker_id="heir", async_persist=True,
                       service_id=live["id"], checkpoint_every=1, devices=CPU)
    assert heir.adopt_orphans_of_service(dead["id"]) == 1
    t = store.get_trial(tid)
    assert (t["status"], t["service_id"], t["worker_id"]) == ("COMPLETED", live["id"], "heir")
    assert params.latest_checkpoint(tid) is None
    assert heir.adopt_orphans_of_service(dead["id"]) == 0 and heir.trials_run == 1


def test_double_resume_adoption_is_cas(env):
    """Two resumers see the same orphan: exactly one adoption wins, and a
    zombie's completion is never regressed to RUNNING."""
    store, params, sub = env
    svc_dead = store.create_service(ServiceType.TRAIN_WORKER.value)
    t = store.create_trial(sub["id"], "FF3", {"epochs": 3}, service_id=svc_dead["id"])
    s1 = store.create_service(ServiceType.TRAIN_WORKER.value)
    s2 = store.create_service(ServiceType.TRAIN_WORKER.value)
    assert store.adopt_trial(t["id"], svc_dead["id"], s1["id"], "r1", expected_status=t["status"])
    assert not store.adopt_trial(t["id"], svc_dead["id"], s2["id"], "r2",
                                 expected_status=t["status"])
    assert store.get_trial(t["id"])["service_id"] == s1["id"]

    store.mark_trial_as_completed(t["id"], 0.5, None)
    s3 = store.create_service(ServiceType.TRAIN_WORKER.value)
    assert not store.adopt_trial(t["id"], s1["id"], s3["id"], "r3")
    assert store.get_trial(t["id"])["status"] == "COMPLETED"


def test_recovery_advisor_routes_scores_and_refuses_proposals():
    class Inner:
        def __init__(self):
            self.seen = []

        def feedback(self, score, knobs):
            self.seen.append((score, dict(knobs)))

    inner = Inner()
    _RecoveryAdvisor(inner).feedback(0.75, {"learning_rate": 0.01})
    _RecoveryAdvisor(None).feedback(0.5, {"learning_rate": 0.02})
    assert inner.seen == [(0.75, {"learning_rate": 0.01})]
    with pytest.raises(RuntimeError):
        _RecoveryAdvisor(inner).propose()


# -- across the two packages -----------------------------------------------------


def test_each_package_adopts_the_others_orphan(tmp_path):
    """One meta store, written by both packages: the port's sweep adopts
    and completes an orphan the JAX package left, and the JAX package's
    sweep one the port left (each re-runs its own template)."""
    db, pdir = tmp_path / "meta.sqlite3", tmp_path / "params"
    jstore, pstore = JaxMetaStore(db), MetaStore(db)
    jparams, pparams = JaxParamsStore(pdir), ParamsStore(pdir)
    subs = {}
    for name, store, src in (("port", pstore, FF3_SOURCE), ("jax", jstore, JAX_FF3_SOURCE)):
        row = store.create_model(f"ff3-{name}", "IMAGE_CLASSIFICATION", None, src, "FF3")
        job = store.create_train_job(f"app-{name}", "IMAGE_CLASSIFICATION", None,
                                     TRAIN, VAL, {"MODEL_TRIAL_COUNT": 1})
        subs[name] = store.create_sub_train_job(job["id"], row["id"])
    # The JAX package leaves the port template's orphan, and the port the
    # JAX template's.
    svc = jstore.create_service(ServiceType.TRAIN_WORKER.value)
    left_by_jax = jstore.create_trial(subs["port"]["id"], "FF3", KNOBS, worker_id="dead",
                                      service_id=svc["id"])
    jstore.update_service(svc["id"], status=JaxServiceStatus.ERRORED.value)
    left_by_port = _orphan(pstore, subs["jax"])

    got = recover_orphaned_trials(pstore, pparams, stale_after_s=60,
                                  sub_train_job_id=subs["port"]["id"], devices=CPU)
    assert [t["id"] for t in got] == [left_by_jax["id"]]
    assert got[0]["status"] == "COMPLETED" and got[0]["score"] is not None

    got = jax_recover(jstore, jparams, stale_after_s=60, sub_train_job_id=subs["jax"]["id"])
    assert [t["id"] for t in got] == [left_by_port["id"]]
    assert got[0]["status"] == "COMPLETED" and got[0]["score"] is not None
    assert pstore.get_orphaned_trials(stale_after_s=60) == []
    assert jstore.get_orphaned_trials(stale_after_s=60) == []


def test_post_recovery_answers_as_the_jax_package(servers, tmp_path):
    """POST /recovery on both REST apps: 401 without a token and for an
    app developer; an admin gets the recovered rows (``wait: true``)."""
    templates = {"port": FF3_SOURCE, "jax": JAX_FF3_SOURCE}
    want_ids = {}
    for name, url in servers.url.items():
        store = servers.admin[name].store
        row = store.create_model("ff3", "IMAGE_CLASSIFICATION", None, templates[name], "FF3")
        job = store.create_train_job("recrest", "IMAGE_CLASSIFICATION", None,
                                     TRAIN, VAL, {"MODEL_TRIAL_COUNT": 1})
        sub = store.create_sub_train_job(job["id"], row["id"])
        want_ids[name] = _orphan(store, sub)["id"]
    answers = {}
    for name, url in servers.url.items():
        _, body = call(url, "POST", "/tokens", {"email": SUPER[0], "password": SUPER[1]})
        sup = body["token"]
        for email, kind in (("adm@x", "ADMIN"), ("dev@x", "APP_DEVELOPER")):
            status, _ = call(url, "POST", "/users",
                             {"email": email, "password": "pw", "user_type": kind}, token=sup)
            assert status == 201
        tokens = {kind: call(url, "POST", "/tokens", {"email": e, "password": "pw"})[1]["token"]
                  for e, kind in (("adm@x", "ADMIN"), ("dev@x", "APP_DEVELOPER"))}
        req = {"stale_after_s": 60, "wait": True}
        answers[name] = {
            "none": call(url, "POST", "/recovery", req),
            "developer": call(url, "POST", "/recovery", req, token=tokens["APP_DEVELOPER"]),
            "admin": call(url, "POST", "/recovery", req, token=tokens["ADMIN"]),
            "admin_again": call(url, "POST", "/recovery", {}, token=tokens["ADMIN"]),
            "get": call(url, "GET", "/recovery", token=tokens["ADMIN"]),
        }
    port, ref = answers["port"], answers["jax"]
    assert {k: v[0] for k, v in port.items()} == {k: v[0] for k, v in ref.items()} == {
        "none": 401, "developer": 401, "admin": 200, "admin_again": 200, "get": 405}
    for name, got in answers.items():
        rows = got["admin"][1]
        assert [r["id"] for r in rows] == [want_ids[name]]
        assert rows[0]["status"] == "COMPLETED"
        assert got["admin_again"][1] == []
    assert sorted(port["admin"][1][0]) == sorted(ref["admin"][1][0])
