"""The port's stores against the JAX package's, on the CPU.

A MetaStore database and a ParamsStore directory written by either
package read the same through the other: same SQLite schema, same
JSON columns, same file layout.
"""

import sqlite3
import sys
import threading

import pytest
import torch

from rafiki_tpu.store import MetaStore as JaxMetaStore, ParamsStore as JaxParamsStore
from rafiki_tpu_torch.store import MetaStore, ParamsStore

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

PACKAGES = {"jax": (JaxMetaStore, JaxParamsStore), "port": (MetaStore, ParamsStore)}
KNOBS = [{"dropout": 0.1, "learning_rate": 1e-3, "batch_size": 128, "depth": 16},
         {"dropout": 0.4, "learning_rate": 2.5e-2, "batch_size": 64, "depth": 16},
         {"dropout": 0.0, "learning_rate": 3e-4, "batch_size": 256, "depth": 16},
         {"dropout": 0.2, "learning_rate": 1e-2, "batch_size": 128, "depth": 16}]
SCORES = [0.71, None, 0.82, 0.82]  # None: the trial errored


def write(store):
    """A job as a scheduler leaves it: a user, a model, a job with a
    sub-job, trials (completed, errored, tied scores), logs, a service."""
    user = store.create_user("dev@rafiki", "hash", "MODEL_DEVELOPER")
    model = store.create_model("vgg", "IMAGE_CLASSIFICATION", user["id"], b"class X: pass\n",
                               "X", dependencies={"torch": "2"}, docs="a model")
    job = store.create_train_job("app", "IMAGE_CLASSIFICATION", user["id"],
                                 "synthetic://a", "synthetic://b", {"MODEL_TRIAL_COUNT": 4})
    sub = store.create_sub_train_job(job["id"], model["id"], advisor_id="adv-1")
    svc = store.create_service("TRAIN_WORKER", job_id=job["id"], worker_index=0,
                               devices=["cuda:0"])
    for i, (knobs, s) in enumerate(zip(KNOBS, SCORES)):
        t = store.create_trial(sub["id"], "X", knobs, worker_id="w0", shape_sig=f"sig{i}",
                               service_id=svc["id"], budget_max=4)
        store.add_trial_log(t["id"], {"type": "values", "values": {"epoch": 0, "loss": 1.5 - i}})
        store.add_trial_log(t["id"], {"type": "plot", "title": "Training",
                                      "metrics": ["loss"], "x_axis": "epoch"})
        if s is None:
            store.mark_trial_as_errored(t["id"], "diverged: loss went non-finite")
        else:
            store.mark_trial_as_completed(t["id"], s, f"params-{i}")
    store.update_sub_train_job(sub["id"], status="COMPLETED")
    store.update_train_job_status(job["id"], "COMPLETED")
    store.update_service(svc["id"], status="STOPPED", heartbeat=True)
    return job["id"]


def read(store, job_id):
    """Everything a reader of the job sees."""
    job = store.get_train_job(job_id)
    trials = store.get_trials_of_train_job(job_id)
    return {
        "job": job,
        "job_by_app": store.get_train_job_by_app("app"),
        "user": store.get_user_by_email("dev@rafiki"),
        "model": store.get_model_by_name("vgg"),
        "subs": store.get_sub_train_jobs(job_id),
        "trials": trials,
        "best": store.get_best_trials_of_train_job(job_id, limit=3),
        "logs": [store.get_trial_logs(t["id"]) for t in trials],
        "counts": [store.count_trials_of_sub_train_job(s["id"], ["COMPLETED"])
                   for s in store.get_sub_train_jobs(job_id)],
        "services": store.get_services_of_job(job_id),
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_meta_store_written_by_either_reads_the_same_in_both(writer, tmp_path):
    db = tmp_path / "meta.sqlite3"
    job_id = write(PACKAGES[writer][0](db))
    seen = {name: read(cls(db), job_id) for name, (cls, _) in PACKAGES.items()}
    assert seen["port"] == seen["jax"]
    got = seen["port"]
    assert [t["knobs"] for t in got["trials"]] == KNOBS
    assert [t["no"] for t in got["trials"]] == [1, 2, 3, 4]
    # Best first; a tie goes to the trial that stopped first.
    assert [t["knobs"] for t in got["best"]] == [KNOBS[2], KNOBS[3], KNOBS[0]]
    assert got["trials"][1]["status"] == "ERRORED"
    assert got["trials"][1]["error"].startswith("diverged:")
    assert got["logs"][0][0] == {"type": "values", "values": {"epoch": 0, "loss": 1.5}}
    assert got["model"]["dependencies"] == {"torch": "2"}
    assert got["counts"] == [3]


def write_services(store, job_id):
    """What the admin adds around a finished job: users (one banned),
    models of two tasks, two inference jobs (one stopped), their
    service rows."""
    admin = store.create_user("ops@rafiki", "hash", "ADMIN")
    store.ban_user(store.get_user_by_email("dev@rafiki")["id"])
    store.create_model("pos", "POS_TAGGING", admin["id"], b"class P: pass\n", "P")
    old = store.create_inference_job(job_id, admin["id"])
    store.update_inference_job(old["id"], status="STOPPED")
    inf = store.create_inference_job(job_id, admin["id"])
    svc = store.create_service("INFERENCE_WORKER", job_id=inf["id"], worker_index=0)
    store.create_service("PREDICTOR", job_id=inf["id"])
    store.update_service(svc["id"], status="RUNNING")
    store.update_inference_job(inf["id"], status="RUNNING", predictor_host="127.0.0.1:1")
    return old["id"], inf["id"], svc["id"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_admin_rows_written_by_either_read_the_same_in_both(writer, tmp_path):
    """The MetaStore methods the admin path adds (user listing and
    banning, model and train-job listing, inference jobs, services)."""
    db = tmp_path / "meta.sqlite3"
    store = PACKAGES[writer][0](db)
    job_id = write(store)
    old_id, inf_id, svc_id = write_services(store, job_id)

    def read_admin(store):
        dev = store.get_user_by_email("dev@rafiki")
        return {"users": store.get_users(), "models": store.get_models(),
                "pos": store.get_models_of_task("POS_TAGGING"),
                "jobs": store.get_train_jobs(), "dev_jobs": store.get_train_jobs(dev["id"]),
                "old": store.get_inference_job(old_id),
                "live": store.get_inference_job_of_train_job(job_id),
                "svc": store.get_service(svc_id), "rows": store.get_services_of_job(inf_id)}

    seen = {name: read_admin(cls(db)) for name, (cls, _) in PACKAGES.items()}
    assert seen["port"] == seen["jax"]
    got = seen["port"]
    assert [(u["email"], u["banned"]) for u in got["users"]] == [("dev@rafiki", 1),
                                                                 ("ops@rafiki", 0)]
    assert [m["name"] for m in got["models"]] == ["vgg", "pos"]
    assert [m["name"] for m in got["pos"]] == ["pos"]
    assert [j["id"] for j in got["jobs"]] == [job_id] == [j["id"] for j in got["dev_jobs"]]
    assert got["jobs"][0]["budget"] == {"MODEL_TRIAL_COUNT": 4}
    assert got["old"]["status"] == "STOPPED" and got["old"]["stopped_at"] is not None
    assert got["live"]["id"] == inf_id and got["live"]["predictor_host"] == "127.0.0.1:1"
    assert got["svc"]["status"] == "RUNNING"
    assert sorted(r["service_type"] for r in got["rows"]) == ["INFERENCE_WORKER", "PREDICTOR"]


def test_both_packages_create_the_same_schema(tmp_path):
    def schema(path):
        with sqlite3.connect(path) as c:
            return sorted(c.execute("SELECT type, name, sql FROM sqlite_master").fetchall())

    JaxMetaStore(tmp_path / "jax.sqlite3")
    MetaStore(tmp_path / "port.sqlite3")
    assert schema(tmp_path / "port.sqlite3") == schema(tmp_path / "jax.sqlite3")


def test_slot_claim_never_overshoots_under_two_threads(tmp_path):
    """Two workers race ``create_trial(budget_max=)`` on one sub-job:
    the claim and the insert are one transaction, so exactly the budget
    is created, and trial numbers are unique."""
    db = tmp_path / "meta.sqlite3"
    store = MetaStore(db)
    model = store.create_model("m", "T", None, b"", "M")
    job = store.create_train_job("app", "T", None, "a", "b", {"MODEL_TRIAL_COUNT": 40})
    sub = store.create_sub_train_job(job["id"], model["id"])
    got = {0: 0, 1: 0}

    def worker(i):
        mine = MetaStore(db)  # one connection per worker, as the scheduler has
        while mine.create_trial(sub["id"], "M", {"i": i}, budget_max=40) is not None:
            got[i] += 1

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    trials = store.get_trials_of_sub_train_job(sub["id"])
    assert got[0] + got[1] == len(trials) == 40
    assert sorted(t["no"] for t in trials) == list(range(1, 41))
    assert store.get_sub_train_job(sub["id"])["claimed"] == 40
    assert not store.claim_trial_slot(sub["id"], 40)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_params_store_round_trips_the_same_files(writer, tmp_path):
    blob = bytes(range(256)) * 40
    w = PACKAGES[writer][1](tmp_path / writer)
    pid = w.save(blob)
    w.save(b"step-1", params_id="t1_ckpt_1")
    w.save(b"step-12", params_id="t1_ckpt_12")
    w.save(b"chunk", params_id="t1_ckpt_3_s0of2")  # a shard chunk, not a head
    other = "port" if writer == "jax" else "jax"
    for name in (writer, other):
        r = PACKAGES[name][1](tmp_path / writer)
        assert r.load(pid) == blob
        assert r.exists(pid) and r.size(pid) == len(blob) + 65
        assert r.latest_checkpoint("t1") == (12, b"step-12")
        assert sorted(r.list()) == sorted([pid, "t1_ckpt_1", "t1_ckpt_12", "t1_ckpt_3_s0of2"])
    # Byte-identical files from both writers.
    PACKAGES[other][1](tmp_path / other).save(blob, params_id=pid)
    assert (tmp_path / other / f"{pid}.params").read_bytes() == \
        (tmp_path / writer / f"{pid}.params").read_bytes()
    r = PACKAGES[other][1](tmp_path / writer)
    r.delete_checkpoints("t1")
    assert r.latest_checkpoint("t1") is None and w.list() == [pid]
    (tmp_path / writer / f"{pid}.params").write_bytes(b"0" * 64 + b"\n" + blob)
    with pytest.raises(IOError, match="integrity"):
        r.load(pid)
    with pytest.raises(ValueError, match="Bad params id"):
        r.save(b"x", params_id="../x")
