"""The mesh sweep in the port, on the CPU (the counterpart of
``tests/test_elastic.py``'s mesh tests): k packed trials per chip over
N chips from one batched draft, chip loss re-packed onto survivors with
params byte-equal to unfaulted serial runs, the mid-pack backfill on the
atomic budget claim, degradation to one chip, the pack's abort at an
epoch boundary, and one 2-chip random-advisor sweep against the JAX
package's: the same trial knobs, WAL op sequence and ``mesh/*`` journal
kinds, and params within ``tests/test_torch_train.py``'s F32_TOL.

Every chip is ``cpu`` here: a mesh's chips are (index, device) pairs,
and several may share a device.
"""

import dataclasses
import pickle
import threading

import jax.numpy as jnp
import pytest
import torch

from rafiki_tpu.config import get_config as jax_get_config, set_config as jax_set_config
from rafiki_tpu.models.ff import _Mlp as JaxMlp
from rafiki_tpu.obs import journal as jax_journal_mod
from rafiki_tpu.scheduler import MeshSweepScheduler as JaxMeshSweepScheduler
from rafiki_tpu.scheduler.wal import read_wal as jax_read_wal, wal_path as jax_wal_path
from rafiki_tpu.store import MetaStore as JaxMetaStore, ParamsStore as JaxParamsStore
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.chaos import FaultPlane, install, uninstall
from rafiki_tpu_torch.chaos.scenarios import EVICT_SOURCE, FF_SOURCE, TRAIN, VAL
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.obs import journal as journal_mod
from rafiki_tpu_torch.scheduler import MeshSweepScheduler
from rafiki_tpu_torch.scheduler.wal import read_wal, reconcile, wal_path
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.serial import load_flat
from tests.test_torch_pack import SCHED_JAX, SCHED_PORT, SCHED_TEMPLATE
from tests.test_torch_train import F32_TOL, flax_init_blob

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture()
def env(tmp_path):
    telemetry.reset()
    store = MetaStore(tmp_path / "meta.sqlite3")
    params = ParamsStore(tmp_path / "params")
    yield store, params, tmp_path
    uninstall()


def _job(store, source, cls_name, budget, train=TRAIN, val=VAL):
    model = store.create_model(cls_name.lower(), "IMAGE_CLASSIFICATION", None, source, cls_name)
    job = store.create_train_job("meshapp", "IMAGE_CLASSIFICATION", None, train, val, budget)
    store.create_sub_train_job(job["id"], model["id"])
    return job


def _sweep(store, params, job, chips, k, **kw):
    return MeshSweepScheduler(store, params).run_sweep(
        job["id"], chips=chips, trials_per_chip=k, advisor_kind="random",
        devices=[CPU] * chips, **kw)


def _params_equal_serial(params, trials, source=FF_SOURCE, cls_name="ChaosFF"):
    """Each trial's stored params against a fresh unfaulted serial train()
    of its knobs, leaf for leaf, byte for byte."""
    cls = load_model_class(source, cls_name)
    out = []
    for t in trials:
        ref = cls(device="cpu", **t["knobs"])
        ref.train(TRAIN)
        want = load_flat(pickle.loads(ref.dump_parameters())["packed"])
        got = load_flat(pickle.loads(params.load(t["params_id"]))["packed"])
        out.append(set(got) == set(want) and all(
            got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want))
    return out


def _reconciles(store, job):
    recs = read_wal(wal_path(store.path, job["id"]))
    for sub in store.get_sub_train_jobs(job["id"]):
        r = reconcile(recs, store.get_trials_of_sub_train_job(sub["id"]), sub=sub,
                      sub_id=sub["id"])
        assert r.ok and all(n == 1 for n in r.claims.values()), r.summary()
    return recs


def test_mesh_sweep_packs_trials_across_chips(env):
    store, params, _ = env
    job = _job(store, FF_SOURCE, "ChaosFF", {"MODEL_TRIAL_COUNT": 4})
    result = _sweep(store, params, job, chips=2, k=2)
    assert result.status == "COMPLETED", result.errors
    assert len(result.trials) == 4
    assert all(t["status"] == "COMPLETED" and t.get("score") is not None for t in result.trials)
    # One packing bucket round-robins across both chips: each trained 2.
    workers = sorted({t["worker_id"] for t in result.trials})
    assert workers == [f"{job['id'][:8]}-mesh-c0", f"{job['id'][:8]}-mesh-c1"]
    assert telemetry.get_counter("worker.packed_rounds") == 2.0
    recs = _reconciles(store, job)
    assert sum(r["op"] == "pack_assign" and r["rec"] == "commit" for r in recs) == 2
    # The supervisor released its lease: no dead supervisor to resume.
    assert store.get_jobs_with_dead_supervisor(0) == []


def test_mesh_chip_killed_mid_sweep_repacks_onto_survivor(env, monkeypatch):
    store, params, _ = env
    monkeypatch.setenv("RAFIKI_CHECKPOINT_EVERY", "1")
    job = _job(store, FF_SOURCE, "ChaosFF", {"MODEL_TRIAL_COUNT": 4})
    install(FaultPlane.from_spec("seed=11;scheduler.preempt:kill:after=2:times=1:match=chip1"))
    result = _sweep(store, params, job, chips=2, k=2)
    uninstall()
    assert result.status == "COMPLETED", result.errors
    assert len(result.trials) == 4, "chip loss lost or duplicated rows"
    assert all(t["status"] == "COMPLETED" and t.get("score") is not None
               for t in result.trials)
    assert telemetry.get_counter("mesh.chips_lost") >= 1.0
    # The re-packed rows finished under the surviving chip's worker...
    assert all((t["worker_id"] or "").endswith("-mesh-c0") for t in result.trials)
    # ...re-assigned in the WAL, and byte-equal to unfaulted serial runs.
    recs = _reconciles(store, job)
    assert any(r.get("repack") for r in recs if r["op"] == "pack_assign")
    monkeypatch.delenv("RAFIKI_CHECKPOINT_EVERY")
    assert all(_params_equal_serial(params, result.trials))


def test_pack_abort_lands_at_the_epoch_boundary_after_the_checkpoint(env, monkeypatch):
    """``run_assigned(abort=)``: the pack raises PackAborted at the next
    epoch boundary, after that epoch's checkpoints are durable, and
    leaves every row RUNNING; a resume of each from its checkpoint ends
    byte-equal to an unfaulted serial run."""
    from rafiki_tpu_torch.advisor import AdvisorService
    from rafiki_tpu_torch.model.knobs import knob_config_signature
    from rafiki_tpu_torch.worker.train import (InProcAdvisorHandle, PackAborted,
                                               PackedTrialRunner, TrainWorker)

    store, params, _ = env
    job = _job(store, FF_SOURCE, "ChaosFF", {"MODEL_TRIAL_COUNT": 2})
    sub = store.get_sub_train_jobs(job["id"])[0]
    cls = load_model_class(FF_SOURCE, "ChaosFF")
    advisors = AdvisorService()
    aid = advisors.create_advisor(cls.get_knob_config(), kind="random")
    worker = TrainWorker(store, params, sub["id"], cls, InProcAdvisorHandle(advisors, aid),
                         TRAIN, VAL, {"MODEL_TRIAL_COUNT": 2}, worker_id="abort-w0",
                         devices=[CPU], async_persist=False, checkpoint_every=1)
    rows = []
    for lr in (0.002, 0.008):
        kn = {"hidden_units": 16, "learning_rate": lr, "batch_size": 32, "epochs": 3}
        t = store.create_trial(sub["id"], "ChaosFF", kn, budget_max=2,
                               shape_sig=knob_config_signature(cls.get_knob_config(), kn))
        store.mark_trial_as_running(t["id"], worker_id="abort-w0")
        rows.append((t["id"], kn))
    abort = threading.Event()
    abort.set()
    with pytest.raises(PackAborted):
        PackedTrialRunner(worker, 2).run_assigned(rows, budget_max=2, abort=abort)
    for tid, _ in rows:
        assert store.get_trial(tid)["status"] == "RUNNING"
        assert params.latest_checkpoint(tid)[0] == 0  # epoch 0 durable
    done = [worker.resume_trial(tid) for tid, _ in rows]
    assert [t["status"] for t in done] == ["COMPLETED"] * 2
    assert all(_params_equal_serial(params, done))


def test_mesh_backfill_respects_trial_budget(env):
    """Mid-pack backfill on the mesh path claims atomic budget slots, each
    bracketed in the WAL: with threshold 0.005 most proposals early-stop
    at epoch 0, and each eviction frees a slot that backfill refills
    until MODEL_TRIAL_COUNT drains (without budget_max the pack would
    never drain)."""
    store, params, _ = env
    src = EVICT_SOURCE.replace(b">= 0.02", b">= 0.005")
    job = _job(store, src, "EvictFF", {"MODEL_TRIAL_COUNT": 5})
    result = _sweep(store, params, job, chips=1, k=2)
    assert result.status == "COMPLETED", result.errors
    trials = store.get_trials_of_train_job(job["id"])
    assert len(trials) == 5, f"backfill bypassed the trial-count budget ({len(trials)} rows)"
    assert all(t["status"] == "COMPLETED" and t.get("score") is not None for t in trials)
    recs = _reconciles(store, job)
    assert sum(r["op"] == "backfill" and r["rec"] == "commit" and "trial_id" in r
               for r in recs) == 3


def test_mesh_degrades_to_single_chip(env, monkeypatch):
    store, params, tmp = env
    monkeypatch.setenv("RAFIKI_MESH_INIT_RETRIES", "2")
    monkeypatch.setenv("RAFIKI_MESH_INIT_BACKOFF_S", "0.01")
    monkeypatch.setenv("RAFIKI_MESH_FORM_GRACE_S", "5")
    job = _job(store, FF_SOURCE, "ChaosFF", {"MODEL_TRIAL_COUNT": 2})
    install(FaultPlane.from_spec("seed=17;collective.init:error:times=8"))
    journal_mod.journal.configure(tmp / "obs", role="test")
    try:
        result = _sweep(store, params, job, chips=2, k=2)
    finally:
        journal_mod.journal.close()
        uninstall()
    assert result.status == "COMPLETED", result.errors
    assert len(result.trials) == 2
    assert all(t["status"] == "COMPLETED" for t in result.trials)
    assert telemetry.get_counter("mesh.degraded_single_chip") >= 1.0
    assert telemetry.get_counter("mesh.init_retries") >= 2.0
    assert {t["worker_id"] for t in result.trials} == {f"{job['id'][:8]}-mesh-c0"}
    recs = journal_mod.read_dir(tmp / "obs")
    assert any(r.get("kind") == "mesh" and r.get("name") == "degraded" for r in recs)


def test_elastic_shrink_repacks_the_newest_chip_without_a_loss(env, monkeypatch):
    """``ElasticHandle.request(-1)``: the supervisor aborts the newest
    chip at its next epoch boundary and re-packs its rows onto the
    survivor (the chip-loss path, journaled as a scale-down and not
    counted as a loss); every trial completes."""
    from rafiki_tpu_torch.scheduler.mesh import ElasticHandle

    store, params, tmp = env
    monkeypatch.setenv("RAFIKI_CHECKPOINT_EVERY", "1")
    job = _job(store, FF_SOURCE, "ChaosFF", {"MODEL_TRIAL_COUNT": 4})
    elastic = ElasticHandle()
    elastic.request(-1)
    journal_mod.journal.configure(tmp / "obs", role="test")
    try:
        result = _sweep(store, params, job, chips=2, k=2, elastic=elastic)
    finally:
        journal_mod.journal.close()
    assert result.status == "COMPLETED", result.errors
    assert all(t["status"] == "COMPLETED" for t in result.trials) and len(result.trials) == 4
    assert elastic.applied == [{"dir": "down", "chip": 1}]
    assert telemetry.get_counter("mesh.chips_scaled_down") == 1.0
    assert telemetry.get_counter("mesh.chips_lost") == 0.0
    names = {r["name"] for r in journal_mod.read_dir(tmp / "obs") if r.get("kind") == "mesh"}
    assert {"scale_down", "scale_down_drained", "repack"} <= names
    _reconciles(store, job)


def test_the_sweep_runs_on_the_card_unless_given_devices(env):
    """``devices=None`` means every card: without one the sweep raises
    before the job is touched (no silent CPU fallback)."""
    store, params, _ = env
    job = _job(store, FF_SOURCE, "ChaosFF", {"MODEL_TRIAL_COUNT": 2})
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshSweepScheduler(store, params).run_sweep(job["id"], chips=1, advisor_kind="random")
    assert store.get_train_job(job["id"])["status"] == "STARTED"


def test_a_two_chip_random_sweep_matches_the_jax_packages(tmp_path, monkeypatch):
    """The same 4-trial job (random advisor, seed 0: the same proposals;
    float32, every trial from the same flax-drawn params) as a 2-chip
    k=2 sweep in both packages: the same trial knobs, the same WAL op
    sequence up to the packs' feedback (whose order across the chips is
    the threads'), the same ``mesh/*`` journal kinds, and params within
    F32_TOL (readings: 1.2e-7 max abs; scores equal). Both store float32
    params blobs (the JAX package reads its serving dtype from its
    process config, the port from the environment)."""
    monkeypatch.setenv("RAFIKI_TPU_SERVING_PARAMS_DTYPE", "float32")
    prev = jax_get_config()
    jax_set_config(dataclasses.replace(prev, serving_params_dtype="float32"))
    try:
        runs = _two_chip_sweeps(tmp_path)
    finally:
        jax_set_config(prev)
    got, want = runs["port"], runs["jax"]
    assert got["result"].status == want["result"].status == "COMPLETED"
    assert [t["knobs"] for t in got["result"].trials] == [t["knobs"] for t in want["result"].trials]
    assert [t["worker_id"][9:] for t in got["result"].trials] == \
        [t["worker_id"][9:] for t in want["result"].trials]

    def ops(recs):
        return [(r["rec"], r["op"]) for r in recs]

    def shape(recs):
        skip = ("ts", "pid", "txn", "trial_id", "trial_ids", "sub_id", "job_id")
        return [{k: v for k, v in r.items() if k not in skip} for r in recs]

    n_head = max(i for i, r in enumerate(want["wal"]) if r["op"] == "pack_assign") + 1
    assert ops(got["wal"])[:n_head] == ops(want["wal"])[:n_head]
    assert sorted(ops(got["wal"])) == sorted(ops(want["wal"]))
    assert shape(got["wal"][:n_head]) == shape(want["wal"][:n_head])
    assert got["mesh"] == want["mesh"] == {"supervisor_started", "pack_formed", "sweep_started"}
    gap = 0.0
    for t, u in zip(got["result"].trials, want["result"].trials):
        a = load_flat(pickle.loads(got["blobs"][t["id"]])["packed"])
        b = load_flat(pickle.loads(want["blobs"][u["id"]])["packed"])
        assert set(a) == set(b)
        assert all(a[k].dtype == b[k].dtype == torch.float32 for k in a)
        gap = max(gap, max(float((a[k] - b[k]).abs().max()) for k in a))
        assert abs(t["score"] - u["score"]) <= F32_TOL["score"]
    print("param max abs", gap)
    assert gap <= F32_TOL["param_max_abs"]


def _two_chip_sweeps(tmp_path):
    init = flax_init_blob(JaxMlp(hidden_layers=1, hidden_units=32, num_classes=5,
                                 dtype=jnp.float32), (8, 8, 1), num_classes=5)
    runs = {}
    for side, store, params, sched, fmt, journal, kw in (
            ("jax", JaxMetaStore(tmp_path / "j.sqlite3"), JaxParamsStore(tmp_path / "jp"),
             JaxMeshSweepScheduler, SCHED_JAX, jax_journal_mod, {}),
            ("port", MetaStore(tmp_path / "p.sqlite3"), ParamsStore(tmp_path / "pp"),
             MeshSweepScheduler, SCHED_PORT, journal_mod, {"devices": [CPU, CPU]})):
        src = SCHED_TEMPLATE.format(init=init, **fmt).encode()
        job = _job(store, src, "PackFF", {"MODEL_TRIAL_COUNT": 4})
        journal.journal.configure(tmp_path / f"obs-{side}", role="test")
        try:
            result = sched(store, params).run_sweep(job["id"], chips=2, trials_per_chip=2,
                                                    advisor_kind="random", **kw)
        finally:
            journal.journal.close()
        wal_fn = jax_read_wal(jax_wal_path(store.path, job["id"])) if side == "jax" else \
            read_wal(wal_path(store.path, job["id"]))
        blobs = {t["id"]: params.load(t["params_id"]) for t in result.trials}
        runs[side] = {"result": result, "wal": wal_fn, "blobs": blobs,
                      "mesh": {r["name"] for r in journal.read_dir(tmp_path / f"obs-{side}")
                               if r.get("kind") == "mesh"}}
    return runs


def test_template_hooks_run_under_the_card_lock(env, monkeypatch, tmp_path):
    """Chips sharing a card: a template's hook that synchronizes the card
    must not reach another chip's capture, so the worker calls
    ``evaluate`` (``evaluate_packed``), ``dump_parameters`` and
    ``destroy`` inside ``card_lock``. Off the card that lock is no lock,
    so here it is replaced by one that marks its thread, in a 2-chip
    packed sweep and in a serial trial."""
    import contextlib

    import rafiki_tpu_torch.worker.train as train_mod
    from rafiki_tpu_torch.model.base import TorchModel
    from tests.test_torch_pack import _mk_worker

    held = threading.local()

    @contextlib.contextmanager
    def marking_lock(model):
        held.depth = getattr(held, "depth", 0) + 1
        try:
            yield
        finally:
            held.depth -= 1

    calls = []

    def wrap(name, fn):
        def hook(*args, **kwargs):
            calls.append((name, getattr(held, "depth", 0) > 0))
            return fn(*args, **kwargs)
        return hook

    monkeypatch.setattr(train_mod, "card_lock", marking_lock)
    for name in ("evaluate", "dump_parameters", "destroy"):
        monkeypatch.setattr(TorchModel, name, wrap(name, getattr(TorchModel, name)))
    monkeypatch.setattr(TorchModel, "evaluate_packed", classmethod(
        wrap("evaluate_packed", TorchModel.evaluate_packed.__func__)))
    store, params, _ = env
    job = _job(store, FF_SOURCE, "ChaosFF", {"MODEL_TRIAL_COUNT": 4})
    assert _sweep(store, params, job, chips=2, k=2).status == "COMPLETED"
    (tmp_path / "serial").mkdir()
    _, _, worker, _, _ = _mk_worker(tmp_path / "serial", trial_pack=1, n_trials=1)
    assert worker.run() == 1
    assert {n for n, _ in calls} == {"evaluate", "evaluate_packed", "dump_parameters",
                                     "destroy"}
    assert all(locked for _, locked in calls), calls
