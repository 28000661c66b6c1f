"""Whole-sweep crash resume in the port, on the CPU (the counterpart of
``tests/test_recovery.py``'s resume, rehydration and reaper tests):
a doctored WAL is refused, a job without a WAL degrades loudly to orphan
recovery, a double resume is a compare-and-swap, adopted scores are
routed into the rehydrated advisor, the rehydrated GP proposes what the
JAX package's rehydrated GP proposes byte for byte, a dead supervisor is
detected and the services manager's reaper resumes its job, and
``python -m rafiki_tpu_torch.scheduler.sweep_proc`` keeps its exit codes
and its last-line summary. The two subprocess acceptance scenarios are
``slow``, as their JAX counterparts are.
"""

import json
import subprocess
import sys
import time

import pytest
import torch

from rafiki_tpu.advisor.rehydrate import rehydrate_advisor as jax_rehydrate
from rafiki_tpu.advisor.service import AdvisorService as JaxAdvisorService
from rafiki_tpu.model.knobs import FixedKnob as JaxFixedKnob, FloatKnob as JaxFloatKnob
from rafiki_tpu.store import MetaStore as JaxMetaStore
from rafiki_tpu_torch.advisor.rehydrate import journal_observations, rehydrate_advisor
from rafiki_tpu_torch.advisor.service import AdvisorService
from rafiki_tpu_torch.chaos.scenarios import FF_SOURCE, TRAIN, VAL
from rafiki_tpu_torch.constants import ServiceStatus, ServiceType, TrainJobStatus
from rafiki_tpu_torch.model.knobs import FixedKnob, FloatKnob
from rafiki_tpu_torch.obs.journal import journal, read_dir
from rafiki_tpu_torch.obs.search.audit import knobs_hash
from rafiki_tpu_torch.scheduler.recovery import _RecoveryAdvisor, resume_sweep
from rafiki_tpu_torch.scheduler.wal import SweepWal, WalReconcileError, read_wal, reconcile, \
    wal_path
from rafiki_tpu_torch.store import MetaStore, ParamsStore

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

CPU = [torch.device("cpu")]
KNOBS = {"hidden_units": 16, "learning_rate": 3e-3, "batch_size": 32, "epochs": 3}
REPO = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.fixture()
def env(tmp_path):
    store = MetaStore(tmp_path / "meta.sqlite3")
    params = ParamsStore(tmp_path / "params")
    row = store.create_model("chaosff", "IMAGE_CLASSIFICATION", None, FF_SOURCE, "ChaosFF")
    job = store.create_train_job("recapp", "IMAGE_CLASSIFICATION", None, TRAIN, VAL,
                                 {"MODEL_TRIAL_COUNT": 2})
    sub = store.create_sub_train_job(job["id"], row["id"])
    return store, params, sub


@pytest.fixture
def journaled(tmp_path):
    journal.configure(tmp_path / "obs", role="test")
    try:
        yield tmp_path / "obs"
    finally:
        journal.close()


def test_resume_refuses_doctored_wal(env, journaled):
    """resume_sweep must NOT adopt a job whose WAL-vs-store accounting is
    provably wrong: compounding the damage is worse than staying down."""
    store, params, sub = env
    job_id = sub["train_job_id"]
    wal = SweepWal(wal_path(store.path, job_id))
    wal.note("sweep_config", advisor_kind="random", chips=1, trials_per_chip=1)
    txn = wal.intent("budget_claim", sub_id=sub["id"], knobs_hash="h")
    wal.commit(txn, "budget_claim", trial_id="ghost")  # doctored
    wal.close()
    with pytest.raises(WalReconcileError):
        resume_sweep(store, params, job_id, stale_after_s=60, devices=CPU)
    assert any(r.get("kind") == "recovery" and r.get("name") == "reconcile_failed"
               for r in read_dir(journaled))


def test_resume_without_wal_degrades_loudly(env, journaled):
    store, params, sub = env
    summary = resume_sweep(store, params, sub["train_job_id"], stale_after_s=60, devices=CPU)
    assert summary["mode"] == "orphan_only"
    assert any(r.get("kind") == "recovery" and r.get("name") == "no_wal"
               for r in read_dir(journaled)), "the no-WAL degrade must be journaled loudly"


def test_double_resume_adoption_is_cas(env):
    """Both resumers see the same orphan; the CAS adopt means exactly one
    wins and the loser backs off. A zombie worker finishing first beats
    adoption too: a terminal status never regresses to RUNNING. A row
    the JAX package's store claimed is adopted by the port's (one
    schema)."""
    store, params, sub = env
    svc_dead = store.create_service(ServiceType.TRAIN_WORKER.value)
    t = store.create_trial(sub["id"], "ChaosFF", {"epochs": 3}, service_id=svc_dead["id"])
    s1 = store.create_service(ServiceType.TRAIN_WORKER.value)
    s2 = JaxMetaStore(store.path).create_service(ServiceType.TRAIN_WORKER.value)
    assert store.adopt_trial(t["id"], svc_dead["id"], s1["id"], "r1", expected_status=t["status"])
    assert not JaxMetaStore(store.path).adopt_trial(t["id"], svc_dead["id"], s2["id"], "r2",
                                                    expected_status=t["status"])
    assert store.get_trial(t["id"])["service_id"] == s1["id"]
    store.mark_trial_as_completed(t["id"], 0.5, None)
    s3 = store.create_service(ServiceType.TRAIN_WORKER.value)
    assert not store.adopt_trial(t["id"], s1["id"], s3["id"], "r3")
    assert store.get_trial(t["id"])["status"] == "COMPLETED"


def test_recovery_advisor_routes_adopted_scores(journaled):
    class Inner:
        def __init__(self):
            self.seen = []

        def feedback(self, score, knobs):
            self.seen.append((score, dict(knobs)))

    inner = Inner()
    routed = _RecoveryAdvisor(inner)
    routed.feedback(0.75, {"learning_rate": 0.01})
    assert inner.seen == [(0.75, {"learning_rate": 0.01})]
    _RecoveryAdvisor(None).feedback(0.25, {"learning_rate": 0.02})  # must not raise
    with pytest.raises(RuntimeError):
        routed.propose()
    with pytest.raises(RuntimeError):
        routed.propose_batch(2)
    recs = [r for r in read_dir(journaled)
            if r.get("kind") == "recovery" and r.get("name") == "feedback"]
    assert [r["routed"] for r in recs] == [True, False]
    assert [r["knobs_hash"] for r in recs] == [knobs_hash({"learning_rate": 0.01}),
                                              knobs_hash({"learning_rate": 0.02})]


def _gp_knob_config(jax_side: bool):
    F, X = (JaxFloatKnob, JaxFixedKnob) if jax_side else (FloatKnob, FixedKnob)
    return {"learning_rate": F(1e-3, 3e-2, is_exp=True), "batch_size": X(32), "epochs": X(3)}


OBS = [({"learning_rate": lr, "batch_size": 32, "epochs": 3}, score)
       for lr, score in ((0.001, 0.4), (0.004, 0.7), (0.012, 0.55), (0.028, 0.3))]


def test_rehydrated_advisor_proposes_byte_identically(journaled):
    """The equivalence contract: a rehydrated advisor proposes byte for
    byte what a fresh advisor fed the same observations proposes,
    whatever order the crashed process's rows come in; and the port's
    rehydrated GP proposes what the JAX package's rehydrated GP does."""
    ref = AdvisorService()
    aid_ref = ref.create_advisor(_gp_knob_config(False), kind="gp", seed=7,
                                 engine_kwargs={"n_initial": 4})
    for kn, score in OBS:
        ref.feedback(aid_ref, score, kn)
    want = ref.propose_batch(aid_ref, 3)

    rows = [{"id": f"t{i}", "no": i + 1, "knobs": kn, "score": score, "status": "COMPLETED"}
            for i, (kn, score) in enumerate(OBS)]
    rows.reverse()  # the crashed process's row order must not matter
    re = AdvisorService()
    aid = rehydrate_advisor(re, _gp_knob_config(False), "gp", "dead-advisor-id", completed=rows,
                            seed=7, engine_kwargs={"n_initial": 4})
    assert aid == "dead-advisor-id"
    got = re.propose_batch(aid, 3)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)

    jre = JaxAdvisorService()
    jaid = jax_rehydrate(jre, _gp_knob_config(True), "gp", "dead-advisor-id", completed=rows,
                         seed=7, engine_kwargs={"n_initial": 4})
    assert json.dumps(jre.propose_batch(jaid, 3), sort_keys=True) == \
        json.dumps(got, sort_keys=True)
    assert any(r.get("kind") == "recovery" and r.get("name") == "rehydrated"
               and r.get("n_from_store") == 4 for r in read_dir(journaled))


def test_rehydrate_supplements_from_advisor_journals():
    """Scores the store never saw as completed rows come back from
    ``kind="advisor"`` journal records (the JAX package's writes them):
    feedback joined to its propose by knobs_hash, another advisor's
    records excluded, store-covered hashes excluded."""
    from rafiki_tpu.advisor.rehydrate import journal_observations as jax_observations

    k1 = {"learning_rate": 0.002, "batch_size": 32, "epochs": 3}
    k2 = {"learning_rate": 0.009, "batch_size": 32, "epochs": 3}
    records = [
        {"kind": "advisor", "name": "propose", "advisor_id": "a1", "knobs": k1,
         "knobs_hash": knobs_hash(k1)},
        {"kind": "advisor", "name": "propose", "advisor_id": "a1", "knobs": k2,
         "knobs_hash": knobs_hash(k2)},
        {"kind": "advisor", "name": "feedback", "advisor_id": "a1",
         "knobs_hash": knobs_hash(k1), "score": 0.6},
        {"kind": "advisor", "name": "feedback", "advisor_id": "a1",
         "knobs_hash": knobs_hash(k2), "score": 0.8},
        {"kind": "advisor", "name": "feedback", "advisor_id": "OTHER",
         "knobs_hash": knobs_hash(k1), "score": 0.0},
    ]
    got = journal_observations(records, advisor_id="a1")
    assert sorted(s for _, s in got) == [0.6, 0.8]
    assert got == jax_observations(records, advisor_id="a1")
    got = journal_observations(records, advisor_id="a1", exclude_hashes={knobs_hash(k1)})
    assert [s for _, s in got] == [0.8]


def test_dead_supervisor_detection(env):
    store, params, sub = env
    job_id = sub["train_job_id"]
    jstore = JaxMetaStore(store.path)
    store.update_train_job_status(job_id, TrainJobStatus.RUNNING.value)
    assert store.get_jobs_with_dead_supervisor(60) == []  # no supervisor row

    store.create_service(ServiceType.SUPERVISOR.value, job_id=job_id, worker_index=0)
    assert store.get_jobs_with_dead_supervisor(60) == []  # fresh heartbeat
    time.sleep(0.15)
    dead = store.get_jobs_with_dead_supervisor(0.1)
    assert [j["id"] for j in dead] == [job_id]
    assert [j["id"] for j in jstore.get_jobs_with_dead_supervisor(0.1)] == [job_id]

    # A live next-generation supervisor clears the alarm.
    store.create_service(ServiceType.SUPERVISOR.value, job_id=job_id, worker_index=1)
    assert store.get_jobs_with_dead_supervisor(0.1) == []
    assert jstore.get_jobs_with_dead_supervisor(0.1) == []


def _dead_sweep(store, sub, claims=2, bound=1):
    """What a SIGKILLed supervisor leaves: its WAL (config, ``claims``
    committed claims), the claimed rows (``bound`` of them bound to a
    dead chip's service, the rest never assigned), the sub's advisor id
    and a stale SUPERVISOR lease on a RUNNING job."""
    job_id = sub["train_job_id"]
    store.update_train_job_status(job_id, TrainJobStatus.RUNNING.value)
    store.update_sub_train_job(sub["id"], advisor_id="dead-advisor",
                               status=TrainJobStatus.RUNNING.value)
    store.create_service(ServiceType.SUPERVISOR.value, job_id=job_id, worker_index=0)
    chip = store.create_service(ServiceType.TRAIN_WORKER.value, job_id=job_id, worker_index=0)
    store.update_service(chip["id"], status=ServiceStatus.RUNNING.value)
    wal = SweepWal(wal_path(store.path, job_id))
    wal.note("sweep_config", job_id=job_id, advisor_kind="random", advisor_kwargs={},
             chips=1, trials_per_chip=2)
    tids = []
    for i in range(claims):
        kn = dict(KNOBS, learning_rate=3e-3 * (i + 1))
        txn = wal.intent("budget_claim", sub_id=sub["id"], knobs_hash=knobs_hash(kn))
        t = store.create_trial(sub["id"], "ChaosFF", kn, budget_max=2,
                               service_id=chip["id"] if i < bound else None)
        wal.commit(txn, "budget_claim", trial_id=t["id"])
        tids.append(t["id"])
    wal.close()
    return job_id, tids


def test_resume_sweep_adopts_every_orphan_and_a_second_resume_is_a_no_op(env, journaled):
    store, params, sub = env
    job_id, tids = _dead_sweep(store, sub)
    time.sleep(0.2)
    summary = resume_sweep(store, params, job_id, stale_after_s=0.1, devices=CPU)
    assert summary["mode"] == "wal" and summary["generation"] == 1
    assert summary["adopted"] == 2 and summary["restarted"] == 2
    assert summary["continuation"] == "COMPLETED"
    trials = store.get_trials_of_train_job(job_id)
    assert sorted(t["id"] for t in trials) == sorted(tids)
    assert all(t["status"] == "COMPLETED" and t["score"] is not None for t in trials)
    recs = read_wal(wal_path(store.path, job_id))
    assert {r["gen"] for r in recs} == {0, 1}
    assert [r for r in recs if r["op"] == "adopt"][0]["trial_ids"] == tids
    r = reconcile(recs, store.get_trials_of_sub_train_job(sub["id"]),
                  sub=store.get_sub_train_job(sub["id"]), sub_id=sub["id"])
    assert r.ok and all(n == 1 for n in r.claims.values()), r.summary()
    # The adopted trials' scores reached the rehydrated advisor, WAL-bracketed.
    assert sum(x["op"] == "advisor_feedback" and x["rec"] == "commit" for x in recs) == 2
    names = {x.get("name") for x in read_dir(journaled) if x.get("kind") == "recovery"}
    assert {"resume_started", "reconcile", "rehydrated", "resume_finished"} <= names
    again = resume_sweep(store, params, job_id, stale_after_s=0.1, devices=CPU)
    assert again["adopted"] == 0 and again["continuation"] == "skipped_terminal"


def test_reaper_detects_and_resumes_dead_supervisor(env, journaled):
    from rafiki_tpu_torch.admin.services_manager import ServicesManager

    store, params, sub = env
    job_id, _ = _dead_sweep(store, sub)
    time.sleep(0.15)
    sm = ServicesManager(store, params, device="cpu")
    sm.start_resume_reaper(poll_s=0.05, stale_after_s=0.1)
    try:
        deadline = time.monotonic() + 60
        seen = set()
        while time.monotonic() < deadline:
            seen = {r.get("name") for r in read_dir(journaled)
                    if r.get("kind") == "recovery" and r.get("job_id") == job_id}
            if {"reaper_detected", "resume_finished"} <= seen:
                break
            time.sleep(0.05)
        assert {"reaper_detected", "resume_started", "resume_finished"} <= seen, seen
    finally:
        sm.stop_resume_reaper()
    assert store.get_train_job(job_id)["status"] == "COMPLETED"
    # idempotent stop/start
    sm.start_resume_reaper(poll_s=10, stale_after_s=10)
    sm.start_resume_reaper(poll_s=10, stale_after_s=10)
    sm.stop_all()


def _sweep_proc(*args, timeout=120):
    out = subprocess.run([sys.executable, "-m", "rafiki_tpu_torch.scheduler.sweep_proc", *args],
                         cwd=REPO, capture_output=True, text=True, timeout=timeout)
    return out.returncode, json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_sweep_proc_runs_and_resumes_on_the_cpu(tmp_path, monkeypatch):
    """``sweep_proc run`` exits 0 on a COMPLETED job with its summary as
    the last stdout line; ``resume`` of the finished job adopts nothing
    and skips the continuation (its chips and k come from the WAL)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    store = MetaStore(tmp_path / "meta.sqlite3")
    params = ParamsStore(tmp_path / "params")
    row = store.create_model("chaosff", "IMAGE_CLASSIFICATION", None, FF_SOURCE, "ChaosFF")
    job = store.create_train_job("p", "IMAGE_CLASSIFICATION", None, TRAIN, VAL,
                                 {"MODEL_TRIAL_COUNT": 2})
    store.create_sub_train_job(job["id"], row["id"])
    base = ["--db", str(store.path), "--params", str(params.directory), "--job", job["id"],
            "--device", "cpu"]
    rc, out, err = _sweep_proc("run", *base, "--chips", "2", "--trials-per-chip", "1",
                               "--advisor", "random")
    assert rc == 0, err[-2000:]
    assert out == {"mode": "run", "job_id": job["id"], "status": "COMPLETED", "n_trials": 2,
                   "errors": []}
    rc, out, err = _sweep_proc("resume", *base, "--stale-after-s", "30")
    assert rc == 0, err[-2000:]
    # The summary's "mode" (wal or orphan_only) follows the leading "resume".
    assert (out["mode"], out["adopted"], out["continuation"], out["status"]) == \
        ("wal", 0, "skipped_terminal", "COMPLETED")


# -- the subprocess acceptance scenarios (slow, as in the JAX package) -----------


def _scenario_passes(name, monkeypatch):
    from rafiki_tpu_torch.chaos.runner import format_report, run_scenario

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    report = run_scenario(name, device="cpu")
    assert report.passed, format_report(report)
    return {c.name for c in report.checks}


@pytest.mark.slow
def test_supervisor_kill_mid_sweep_acceptance(monkeypatch):
    """A SIGKILLed sweep resumes in a fresh process with the unfaulted
    run's best score and knob set and zero double-claimed slots."""
    names = _scenario_passes("supervisor-kill-mid-sweep", monkeypatch)
    assert {"best_score_matches_unfaulted", "knob_set_matches_unfaulted",
            "no_double_claims", "advisor_rehydrated", "post_resume_batch_non_warmup",
            "obs_resume_reconstructs"} <= names


@pytest.mark.slow
def test_early_kill_mid_pack_resume_acceptance(monkeypatch):
    """A supervisor SIGKILLed just after a pack member's early kill, with
    its pack-mate's speculation in flight, rehydrates to the same
    proposals twice and resumes to the unfaulted kill-on run's best score
    and knob set."""
    names = _scenario_passes("early-kill-mid-pack-resume", monkeypatch)
    assert {"kill_seen_before_crash", "speculation_in_flight_at_crash",
            "rehydrated_proposals_byte_match", "killed_trial_errored",
            "best_score_matches_unfaulted", "knob_set_matches_unfaulted",
            "no_double_claims"} <= names


@pytest.mark.slow
def test_host_loss_mid_sweep_acceptance(monkeypatch):
    names = _scenario_passes("host-loss-mid-sweep", monkeypatch)
    assert {"survivors_repacked", "wal_reconciles_clean"} <= names
