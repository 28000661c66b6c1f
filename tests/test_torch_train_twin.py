"""The port's training twin against the JAX package's, on the CPU.

Every test of ``tests/test_train_twin.py`` has its counterpart here, run
through both packages on the same inputs. ``simulate`` gives equal
results, event-log digests included, on hand-built bundles and on
bundles built from the same journal records (nominal, eviction, a chip
preempted and re-packed, the supervisor's host lost, a ``@groupw2``
bucket); the what-ifs, the pre-gate, the calibration errors and a
bundle's round trip are equal too. ``validate`` is held both ways on the
JAX test's synthetic journal and on a capture of the port's own
``MeshSweepScheduler`` on the CPU (ChaosFF, 2 chips x k=2, 4 trials):
the faithful bundle passes at the JAX package's 0.25, the doctored one
fails, and both packages give the same report. The placement consult
journals the same ``twin/placement`` record, ``run_sweep`` consults
before its first claim and trains the same trials whether the consult
answers, raises or is off, and ``obs twin train`` prints what the JAX
package's CLI prints. Last, the departures: a port cost row reads its
own card, and a pack's recorded rounds (``trial_pack/rounds``) are
replayed, backfills included.
"""

import copy
import json
import pathlib
import re

import pytest
import torch

from rafiki_tpu.obs import journal as jax_journal_mod
from rafiki_tpu.obs.perf.profiler import PEAK_FLOPS_V5E_BF16
from rafiki_tpu.obs.twin import calibration as jax_serving_cal
from rafiki_tpu.obs.twin.train import (calibration as jax_calibration, engine as jax_engine,
                                       placement as jax_placement, pregate as jax_pregate,
                                       validate as jax_validate, whatif as jax_whatif)
from rafiki_tpu_torch.chaos import FaultPlane, install, uninstall
from rafiki_tpu_torch.chaos.scenarios import FF_SOURCE
from rafiki_tpu_torch.obs import journal as journal_mod
from rafiki_tpu_torch.obs.twin import calibration as serving_cal
from rafiki_tpu_torch.obs.twin.train import (calibration, engine, placement, pregate, validate,
                                             whatif)
from rafiki_tpu_torch.scheduler import MeshSweepScheduler
from rafiki_tpu_torch.store import MetaStore, ParamsStore

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

PKGS = {"jax": (jax_calibration, jax_engine, jax_whatif, jax_pregate, jax_validate),
        "port": (calibration, engine, whatif, pregate, validate)}
CPU = torch.device("cpu")
# The capture's task: 1,024 images, 32 steps an epoch at batch 32, so
# the epochs' compute outweighs the wiring between them.
CAPTURE_TRAIN = "synthetic://images?classes=5&n=1024&w=8&h=8&seed=0"
CAPTURE_VAL = "synthetic://images?classes=5&n=64&w=8&h=8&seed=1"
DOCTORED = {"step": 2.0, "compile": 2.0}
EPOCH_DELAY_S = 0.6


# -- inputs ------------------------------------------------------------------------


def _analytic(mod):
    """The JAX test's hand-computable bundle: pkA width-2 packs (cold 2.0,
    warm 1.0, 3 epochs), pkB width-1 packs (cold 3.0, warm 0.5, 2 epochs)."""
    return mod.TrainCalibration(
        steps={"pkA": {"2": [1.0]}, "pkB": {"1": [0.5]}},
        compiles={"pkA": {"2": [2.0]}, "pkB": {"1": [3.0]}},
        packs=[{"packing_key": "pkA", "k": 2, "epochs": 3},
               {"packing_key": "pkB", "k": 1, "epochs": 2}],
        sweep={"chips": 2, "trials_per_chip": 2, "n_trials": 6},
        cost={}, epoch_overhead_s=0.0, source="analytic")


ANALYTIC_TRIALS = ([{"id": f"a{i}", "packing_key": "pkA", "epochs": 3} for i in range(4)]
                   + [{"id": f"b{i}", "packing_key": "pkB", "epochs": 2} for i in range(2)])


def _records(group=False, cost=False):
    """A captured 2-chip k=2 sweep as journal records: a pack of
    6 epochs per chip, 16 warm and 2 cold epoch walls of ``pk``; with
    ``group``, width-2 group walls of ``pk`` too (``@groupw2``); with
    ``cost``, a packed ``perf/cost`` row that names no card."""
    rows = [{"ts": 100.0, "kind": "mesh", "name": "sweep_started", "job_id": "j",
             "chips": 2, "trials_per_chip": 2, "n_trials": 8}]
    for chip in range(2):
        rows.append({"ts": 100.5, "kind": "mesh", "name": "pack_formed", "job_id": "j",
                     "chip": chip, "packing_key": "pk", "k": 2, "fill_ratio": 1.0,
                     "epochs": 6, "trial_ids": [f"t{chip}a", f"t{chip}b"]})
    ts = 101.0
    for i in range(18):
        cold = i < 2
        dt = (4.0 - 1.5 * i) if cold else round(0.5 + 0.1 * (i - 2), 3)
        ts += dt
        rows.append({"ts": ts, "kind": "perf", "name": "step", "key_hash": "kh", "dt": dt,
                     "cold": cold, "program_kind": "packed", "k": 2, "packing_key": "pk"})
    if group:
        for i, dt in enumerate((3.0, 1.4, 1.5, 1.6)):
            ts += dt
            rows.append({"ts": ts, "kind": "perf", "name": "step", "key_hash": "kg", "dt": dt,
                         "cold": i == 0, "program_kind": "sharded", "k": 1,
                         "packing_key": "pk", "group_width": 2})
    if cost:
        rows.append({"ts": ts, "kind": "perf", "name": "cost", "key_hash": "abc123def",
                     "key": "pk", "program_kind": "packed", "k": 2, "flops": 4.8e11,
                     "bytes_accessed": None, "peak_hbm_bytes": None, "device": None,
                     "peak_flops": PEAK_FLOPS_V5E_BF16})
    return rows


def _from_records(mod, **kw):
    return mod.TrainCalibration.from_records(copy.deepcopy(_records(**kw)), source="records")


def _write_synthetic_journal(log_dir, step_scale=1.0):
    """The JAX test's capture: per chip one pack (width 2, 3 epochs) of
    cold 2 s + warm 1 s + warm 1 s back to back: measured wall 4.0 s,
    fitted overhead 0."""
    rows = [{"ts": 1000.0, "kind": "mesh", "name": "sweep_started", "job_id": "j1",
             "chips": 2, "trials_per_chip": 2, "n_trials": 4}]
    for chip in range(2):
        rows.append({"ts": 1000.5, "kind": "mesh", "name": "pack_formed", "job_id": "j1",
                     "chip": chip, "packing_key": "pk", "k": 2, "fill_ratio": 1.0,
                     "epochs": 3, "trial_ids": [f"t{chip}a", f"t{chip}b"]})
        for ts, dt, cold in ((1002.0, 2.0, True), (1003.0, 1.0, False), (1004.0, 1.0, False)):
            rows.append({"ts": ts, "kind": "perf", "name": "step", "key_hash": "kh",
                         "dt": dt * step_scale, "cold": cold, "program_kind": "packed",
                         "k": 2, "packing_key": "pk"})
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with open(log_dir / "journal-test-1.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return log_dir


def _strip(doc):
    return {k: v for k, v in doc.items() if k != "created_ts"}


# -- the engine ----------------------------------------------------------------------


def test_assignment_mirrors_the_mesh_round_robin():
    want = [(0, "pkA", ["a0", "a2"]), (0, "pkB", ["b0"]), (1, "pkA", ["a1", "a3"]),
            (1, "pkB", ["b1"])]
    got = {pkg: engine_mod._assign(copy.deepcopy(ANALYTIC_TRIALS), chips=2, k=2)
           for pkg, (_, engine_mod, *_rest) in PKGS.items()}
    assert got["port"] == got["jax"]
    assert [(p["chip"], p["packing_key"], p["members"]) for p in got["port"]] == want


def _case(name):
    """(bundle builder, config kwargs, simulate kwargs) of one case."""
    spread = lambda mod: _from_records(mod)  # noqa: E731
    cold_order = lambda mod: mod.TrainCalibration(  # noqa: E731
        steps={"pkA": {"2": [1.0]}}, compiles={"pkA": {"2": [4.0, 2.5]}}, packs=[],
        sweep={}, cost={}, epoch_overhead_s=0.0, source="t")
    two_packs = [{"chip": 0, "packing_key": "pkA", "epochs": 2, "members": ["x", "y"]},
                 {"chip": 0, "packing_key": "pkA", "epochs": 2, "members": ["u", "v"]}]

    def overhead(mod):
        cal = _analytic(mod)
        cal.epoch_overhead_s = 0.25
        return cal

    return {
        "analytic": (_analytic, dict(chips=2, k=2, n_trials=6),
                     dict(trials=ANALYTIC_TRIALS, seed=0)),
        "cold_order": (cold_order, dict(chips=1, k=2), dict(packs=two_packs, seed=0)),
        "overhead": (overhead, dict(chips=2, k=2, n_trials=6),
                     dict(trials=ANALYTIC_TRIALS, seed=0)),
        "nominal": (lambda mod: mod.TrainCalibration.from_dict(
            jax_calibration.TrainCalibration.nominal().to_dict()), {}, dict(seed=4)),
        "records_seed7": (spread, dict(chips=2, k=2, n_trials=8), dict(seed=7)),
        "records_seed8": (spread, dict(chips=2, k=2, n_trials=8), dict(seed=8)),
        "eviction": (spread, dict(chips=2, k=2, evict_prob=0.5), dict(seed=3)),
        "chaos_preempt": (spread, dict(chips=2, k=2, n_trials=8),
                          dict(seed=7, chaos_spec="scheduler.preempt:preempt:match=chip0:times=1")),
        "supervisor_host_loss": (spread, dict(chips=4, k=2, n_trials=8, chips_per_host=2),
                                 dict(seed=0, chaos_spec="host.loss:kill:match=g0h0:times=1")),
        "host_loss": (spread, dict(chips=4, k=2, n_trials=8, chips_per_host=2),
                      dict(seed=0, chaos_spec="host.loss:kill:match=g0h1:times=1")),
        "groupw2": (lambda mod: _from_records(mod, group=True), dict(chips=2, k=2, n_trials=8),
                    dict(seed=1)),  # seed 1 drafts two trials of the group bucket
    }[name]


def _simulate(pkg, name):
    cal_mod, eng_mod, *_ = PKGS[pkg]
    build, cfg_kw, sim_kw = _case(name)
    cal = build(cal_mod)
    cfg = (eng_mod.TrainTwinConfig.from_calibration(cal) if not cfg_kw
           else eng_mod.TrainTwinConfig(**cfg_kw))
    return eng_mod.simulate(cal, cfg, record_events=True, **copy.deepcopy(sim_kw))


@pytest.mark.parametrize("name", ["analytic", "cold_order", "overhead", "nominal",
                                  "records_seed7", "records_seed8", "eviction", "chaos_preempt",
                                  "supervisor_host_loss", "host_loss", "groupw2"])
def test_simulate_equals_the_jax_packages(name):
    ref, got = _simulate("jax", name), _simulate("port", name)
    assert got == ref
    assert engine.result_fingerprint(got) == jax_engine.result_fingerprint(ref)
    assert _simulate("port", name) == got  # one seed, one event log
    if name == "analytic":
        # Per chip: pkA 2.0 cold + 1.0 + 1.0, then pkB 3.0 cold + 0.5.
        assert (got["status"], got["makespan_s"], got["completed"]) == ("ok", 7.5, 6)
        assert got["trials_per_hour"] == pytest.approx(6 / 7.5 * 3600)
        assert (got["compile_s"], got["step_s"], got["utilization"]) == (10.0, 5.0, 1.0)
    elif name == "cold_order":
        # The first pack pays the true first call (4.0), the second the cache hit.
        assert got["makespan_s"] == (4.0 + 1.0) + (2.5 + 1.0)
    elif name == "overhead":
        assert got["makespan_s"] == 7.5 + 5 * 0.25
    elif name == "records_seed8":
        assert got["event_log_sha1"] != _simulate("port", "records_seed7")["event_log_sha1"]
    elif name == "eviction":
        assert got["completed"] == got["trials"] == 4 and got["evicted"] > 0
    elif name == "chaos_preempt":
        base = engine.simulate(_from_records(calibration), engine.TrainTwinConfig(
            chips=2, k=2, n_trials=8), seed=7)
        assert got["chaos_fired"] == 1 and got["chips_lost"] == [0] and got["repacks"] > 0
        assert got["completed"] == got["trials"] and got["makespan_s"] > base["makespan_s"]
    elif name == "supervisor_host_loss":
        assert got["status"] == "supervisor_lost"
    elif name == "host_loss":
        assert got["status"] == "ok" and got["hosts_lost"] == [1]
        assert got["chips_lost"] == [2, 3]
    elif name == "groupw2":
        cal = _from_records(calibration, group=True)
        assert "pk@groupw2" in cal.steps and cal.meta["group_step_records"] == 4
        assert any("pk=pk@groupw2" in ev[2] for ev in got["events"])


def test_replayed_rounds_run_the_pack_the_runner_recorded():
    """A departure from the JAX package: a pack whose ``trial_pack/rounds``
    record the port's runner journaled replays its rounds, the trials
    backfilled into it included. Without the record the replay is the
    JAX package's, event log and all."""
    rows = _records()
    for r in rows:
        if r.get("name") == "pack_formed":
            r["worker_id"] = f"w{r['chip']}"
    plain = calibration.TrainCalibration.from_records(copy.deepcopy(rows))
    ref = jax_calibration.TrainCalibration.from_records(copy.deepcopy(rows))
    run = lambda mod, cal: mod.simulate(cal, mod.TrainTwinConfig.from_calibration(cal),  # noqa
                                        packs=mod.packs_from_calibration(cal), seed=2)
    assert run(engine, plain) == run(jax_engine, ref)
    # Chip 0's pack: 2 drafted members, then 2 backfills in the freed
    # slots, 3 rounds of widths 2, 2, 1.
    rows.append({"ts": 200.0, "kind": "trial_pack", "name": "rounds", "worker_id": "w0",
                 "trial_ids": ["t0a", "t0b", "t0c", "t0d"], "widths": [2, 2, 1]})
    cal = calibration.TrainCalibration.from_records(copy.deepcopy(rows))
    assert cal.packs[0]["rounds"] == [2, 2, 1] and cal.packs[0]["backfilled"] == ["t0c", "t0d"]
    assert "rounds" not in cal.packs[1]
    packs = engine.packs_from_calibration(cal)
    assert packs[0]["members"] == ["t0a", "t0b", "t0c", "t0d"] and packs[0]["epochs"] == 3
    res = engine.simulate(cal, engine.TrainTwinConfig.from_calibration(cal), packs=packs,
                          seed=2, record_events=True)
    assert res["completed"] == 6
    widths = [ev[2].split("w=")[1] for ev in res["events"]
              if ev[1] == "epoch_end" and ev[2].startswith("chip0")]
    assert widths == ["2", "2", "1"]
    assert validate.measured_from_records(rows) == jax_validate.measured_from_records(rows)
    # Another worker's record (a resumed pack elsewhere) is not this pack's.
    rows[-1]["worker_id"] = "w1"
    assert "rounds" not in calibration.TrainCalibration.from_records(rows).packs[0]


# -- the bundle ----------------------------------------------------------------------


@pytest.mark.parametrize("capture", ["empty", "partial"])
def test_calibration_errors_name_the_same_missing_kinds(tmp_path, capture):
    if capture == "partial":
        with open(tmp_path / "journal-test-1.jsonl", "w") as f:
            f.write(json.dumps({"ts": 1.0, "kind": "perf", "name": "step", "dt": 0.5,
                                "cold": False, "k": 2, "packing_key": "pk"}) + "\n")
    errors = {}
    for pkg, mod, base in (("jax", jax_calibration, jax_serving_cal.CalibrationError),
                           ("port", calibration, serving_cal.CalibrationError)):
        with pytest.raises(mod.TrainCalibrationError) as e:
            mod.TrainCalibration.from_journal_dir(tmp_path)
        assert isinstance(e.value, base) and str(tmp_path) in str(e.value)
        errors[pkg] = e.value.missing
        with pytest.raises(mod.TrainCalibrationError):
            PKGS[pkg][4].validate(tmp_path, seed=0)
    assert errors["port"] == errors["jax"]
    assert errors["port"] == (["perf/step", "mesh/pack_formed"] if capture == "empty"
                              else ["mesh/pack_formed"])


def test_bundles_cross_load_scale_alike_and_gate_their_version(tmp_path):
    for src, dst in ((calibration, jax_calibration), (jax_calibration, calibration)):
        cal = _analytic(src)
        cal.save(tmp_path / "cal.json")
        loaded = dst.TrainCalibration.load(tmp_path / "cal.json")
        assert (loaded.steps, loaded.compiles, loaded.sweep, loaded.packs) == (
            cal.steps, cal.compiles, cal.sweep, cal.packs)
        doc = json.loads((tmp_path / "cal.json").read_text())
        doc["train_calibration_version"] = 99
        with pytest.raises(ValueError, match="99"):
            dst.TrainCalibration.from_dict(doc)
        with pytest.raises(ValueError, match="step"):
            cal.scaled({"forward": 2.0})
    assert (_from_records(calibration).scaled(DOCTORED).to_dict()
            == _from_records(jax_calibration).scaled(DOCTORED).to_dict())


# -- the what-ifs and the pre-gate ----------------------------------------------------------


def _whatifs(pkg):
    cal_mod, eng_mod, whatif_mod, _, _ = PKGS[pkg]
    cal = _from_records(cal_mod, group=True, cost=True)
    base = eng_mod.TrainTwinConfig.from_calibration(cal)
    return {"best_k": whatif_mod.best_k(cal, chips=2, seed=0),
            "split": whatif_mod.split_search(cal, n_trials=8, seed=0),
            "member": whatif_mod.member_forecast(cal, "abc", k=2, mfu=0.3),
            "groups": whatif_mod.group_width_forecast(cal, "pk"),
            "sweep": whatif_mod.sweep(cal, base, whatif_mod.parse_grid(
                ["chips=1,2", "pack=1,2,4"]), seed=1,
                chaos_spec="scheduler.preempt:preempt:match=chip0:times=1")}


def test_the_what_ifs_equal_the_jax_packages():
    """On a bundle whose cost row names no card (its peak is the JAX
    package's default, its memory fields null)."""
    got, ref = _whatifs("port"), _whatifs("jax")
    assert got == ref
    assert got["member"]["step_s"] == round(4.8e11 / (PEAK_FLOPS_V5E_BF16 * 0.3), 9)
    assert got["member"]["hbm_frac"] is None and got["member"]["fits"]
    assert [r["measured"] for r in got["groups"]["rows"]] == [True, True, False, False]
    assert got["best_k"]["pk"]["best_k"] in (1, 2, 4, 8) and len(got["sweep"]) == 6


def test_the_pregate_equals_the_jax_packages():
    out = {}
    for pkg in PKGS:
        cal_mod, _, _, pregate_mod, _ = PKGS[pkg]
        cal = _from_records(cal_mod)
        fn = pregate_mod.sweep_chip_pregate(calibration=cal)
        out[pkg] = (pregate_mod.forecast(1, 4, calibration=cal, seed=0),
                    pregate_mod.forecast(1, 2, calibration=cal, n_trials=1, seed=0),
                    pregate_mod.forecast(2, 3),
                    fn("sweep", 1, 4), fn("serving", 1, 4), fn("sweep", 2, 2),
                    pregate_mod.chaos_forecast("gateway.admit:drop:p=0.5", calibration=cal),
                    pregate_mod.chaos_forecast("scheduler.preempt:preempt:match=chip0:times=1",
                                               calibration=cal, chips=2, seed=0),
                    pregate_mod.chaos_forecast("host.loss:kill:match=g0h1:times=1",
                                               chips=4, chips_per_host=2, seed=1))
    assert out["port"] == out["jax"]
    gain, pointless, _, via_fn, serving, same, none, preempt, _ = out["port"]
    assert gain["veto"] is False and gain["delta_trials_per_hour"] > 0
    assert gain["target_forecast"]["makespan_s"] < gain["baseline"]["makespan_s"]
    assert pointless["veto"] is True and "trials/hour" in pointless["veto_reason"]
    assert via_fn == gain and serving is None and same is None and none is None
    assert preempt["chaos_fired"] == 1 and preempt["delta_makespan_s"] > 0
    assert pregate.forecast(1, 4, calibration=_from_records(calibration), seed=0) == gain


# -- validate ---------------------------------------------------------------------------


@pytest.mark.parametrize("scales", [None, {"step": 2.0}], ids=["faithful", "doctored"])
def test_validate_on_the_jax_tests_journal_equals_the_jax_packages(tmp_path, scales):
    log_dir = _write_synthetic_journal(tmp_path)
    got = validate.validate(log_dir, seed=0, scales=scales)
    assert _strip(got) == _strip(jax_validate.validate(log_dir, seed=0, scales=scales))
    assert got["measured"] == {"trials": 4, "wall_s": 4.0, "trials_per_hour": 3600.0}
    if scales is None:
        assert got["predicted"]["wall_s"] == 4.0 and got["tph_err"] == got["wall_err"] == 0.0
        assert got["ok"] is True
        assert validate.validate(log_dir, seed=0)["event_log_sha1"] == got["event_log_sha1"]
    else:
        # Warm epochs double: 2 + 2 + 2 = 6.0 s against 4.0 measured.
        assert got["predicted"]["wall_s"] == 6.0 and got["wall_err"] == 0.5
        assert got["ok"] is False


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """The port's mesh sweep on the CPU with the journal open: ChaosFF,
    2 chips x k=2, 4 random-advisor trials, one pack per chip. The twin
    models chips that share no processor, and the two chips here are
    threads of one interpreter on a loaded machine, so the capture holds
    its epochs mostly to a wall neither chip takes from the other (as
    the serving twin's test holds its forward to a sleep): every epoch
    sleeps EPOCH_DELAY_S at the ``train.epoch`` chaos site, inside its
    timed wall, and the one-off FLOP count of a journaled process's
    first step is off (``RAFIKI_PERF_COST_CAPTURE=0``), since it lands
    in one chip's cold epoch while the other chip's thread waits."""
    tmp = tmp_path_factory.mktemp("train-twin-capture")
    log_dir = tmp / "journal"
    store, params = MetaStore(tmp / "meta.sqlite3"), ParamsStore(tmp / "params")
    model = store.create_model("chaosff", "IMAGE_CLASSIFICATION", None, FF_SOURCE, "ChaosFF")
    job = store.create_train_job("traintwin", "IMAGE_CLASSIFICATION", None, CAPTURE_TRAIN,
                                 CAPTURE_VAL, {"MODEL_TRIAL_COUNT": 4})
    store.create_sub_train_job(job["id"], model["id"])
    journal_mod.journal.configure(log_dir, role="sweep")
    install(FaultPlane.from_spec(f"seed=0;train.epoch:delay:delay={EPOCH_DELAY_S}"))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RAFIKI_PERF_COST_CAPTURE", "0")
            result = MeshSweepScheduler(store, params).run_sweep(
                job["id"], chips=2, trials_per_chip=2, advisor_kind="random",
                devices=[CPU, CPU])
    finally:
        uninstall()
        journal_mod.journal.close()
    assert result.status == "COMPLETED", result.errors
    return log_dir


@pytest.mark.parametrize("scales", [None, DOCTORED], ids=["faithful", "doctored"])
def test_validate_on_a_port_sweep_equals_the_jax_packages(capture, scales):
    got = validate.validate(capture, seed=0, scales=scales)
    ref = jax_validate.validate(capture, seed=0, scales=scales)
    assert _strip(got) == _strip(ref)
    recs = journal_mod.read_dir(capture)
    rounds = [r for r in recs if r.get("kind") == "trial_pack" and r.get("name") == "rounds"]
    assert [r["widths"] for r in rounds] == [[2, 2, 2]] * 2
    assert got["measured"]["trials"] == got["predicted"]["trials"] == 4
    if scales is None:
        assert got["ok"] is True, got
    else:
        assert got["ok"] is False and got["wall_err"] > got["tolerance"], got


# -- the placement consult ---------------------------------------------------------------


def test_placement_consult_journals_the_jax_packages_record(tmp_path):
    cap = _write_synthetic_journal(tmp_path / "cap")
    recs = {}
    for pkg, mod, jm in (("jax", jax_placement, jax_journal_mod),
                         ("port", placement, journal_mod)):
        jm.journal.configure(tmp_path / f"out-{pkg}", role="test")
        try:
            rec = mod.consult(job_id="j1", chips=2, k=2, budget={"MODEL_TRIAL_COUNT": 4},
                              log_dir=str(cap), seed=0)
        finally:
            jm.journal.close()
        got = [r for r in jm.read_dir(tmp_path / f"out-{pkg}")
               if r.get("kind") == "twin" and r.get("name") == "placement"]
        assert len(got) == 1 and got[0]["recommendation"] == rec
        recs[pkg] = {k: v for k, v in got[0].items() if k != "ts"}
    assert recs["port"] == recs["jax"]
    assert recs["port"]["advisory"] is True and recs["port"]["recommendation"]["best_k"]
    assert recs["port"]["recommendation"]["calibration_source"] == str(cap)


def _switched_sweep(tmp_path, monkeypatch, name, switch, consult=None):
    """A 2-chip k=1 ChaosFF sweep of 2 random trials, its journal in a
    directory that already holds the JAX test's capture. ``consult(store)``
    makes the consult that stands in for the twin's."""
    log_dir = _write_synthetic_journal(tmp_path / name)
    if switch:
        monkeypatch.setenv("RAFIKI_TWIN_PLACEMENT", "1")
    else:
        monkeypatch.delenv("RAFIKI_TWIN_PLACEMENT", raising=False)
    store, params = MetaStore(log_dir / "meta.sqlite3"), ParamsStore(log_dir / "params")
    if consult is not None:
        monkeypatch.setattr(placement, "consult", consult(store))
    model = store.create_model("twinff", "IMAGE_CLASSIFICATION", None, FF_SOURCE, "ChaosFF")
    job = store.create_train_job("twinhook", "IMAGE_CLASSIFICATION", None, CAPTURE_TRAIN,
                                 CAPTURE_VAL, {"MODEL_TRIAL_COUNT": 2})
    store.create_sub_train_job(job["id"], model["id"])
    journal_mod.journal.configure(log_dir, role="test")
    try:
        result = MeshSweepScheduler(store, params).run_sweep(
            job["id"], chips=2, trials_per_chip=1, advisor_kind="random", devices=[CPU, CPU])
    finally:
        journal_mod.journal.close()
    assert result.status == "COMPLETED", result.errors
    recs = [r for r in journal_mod.read_dir(log_dir) if r.get("job_id") == job["id"]]
    return recs, [(t["knobs"], t["score"]) for t in store.get_trials_of_train_job(job["id"])]


def test_run_sweep_consults_the_twin_before_its_first_claim(tmp_path, monkeypatch):
    """Advisory only: the sweep trains the same trials to the same scores
    whether the consult answers, raises or is switched off."""
    seen = []
    real = placement.consult

    def answering(store):
        def consult(job_id, **kw):
            seen.append(len(store.get_trials_of_train_job(job_id)))
            return real(job_id=job_id, **kw)
        return consult

    def raising(store):
        def consult(job_id, **kw):
            raise RuntimeError("no calibration")
        return consult

    answered, trials = _switched_sweep(tmp_path, monkeypatch, "answers", True, answering)
    failed, trials_raised = _switched_sweep(tmp_path, monkeypatch, "raises", True, raising)
    off, trials_off = _switched_sweep(tmp_path, monkeypatch, "off", False)
    assert seen == [0]  # no row claimed when the twin was asked
    kinds = [(r["kind"], r["name"]) for r in answered]
    first = kinds.index(("twin", "placement"))
    assert kinds.count(("twin", "placement")) == 1 and first < kinds.index(("mesh", "pack_formed"))
    rec = answered[first]
    assert rec["advisory"] is True and rec.get("error") is None
    assert rec["recommendation"]["best_split"]
    err = [r for r in failed if r["kind"] == "twin"]
    assert len(err) == 1 and err[0]["error"] == "no calibration" and err[0]["advisory"] is True
    assert not [r for r in off if r["kind"] == "twin"]
    assert trials == trials_raised == trials_off and len(trials) == 2
    # The sweep's own records are the next calibration's input.
    formed = [r for r in answered if r["kind"] == "mesh" and r["name"] == "pack_formed"]
    assert formed and all(r["trial_ids"] and r["packing_key"] for r in formed)


# -- the CLI ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["twin", "train", "run"],
    ["twin", "train", "run", "--chips", "3", "--pack", "1", "--events", "--chaos",
     "scheduler.preempt:preempt:match=chip0:times=1"],
    ["twin", "train", "sweep", "--grid", "chips=1,2", "--grid", "pack=1,2", "--best-k",
     "--split", "--seed", "2"],
    ["twin", "train", "validate"],
    ["twin", "train", "validate", "--scale", "step=2.0", "--scale", "compile=2.0"],
], ids=lambda a: "-".join(a[2:4]))
@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_the_train_verbs_print_what_the_jax_packages_print(argv, as_json, capture, capsys):
    from rafiki_tpu.obs import cli as jax_cli
    from rafiki_tpu_torch.obs import cli

    full = ["--dir", str(capture)] + (["--json"] if as_json else []) + argv
    outs = []
    for main in (jax_cli.main, cli.main):
        rc = main(full)
        out, err = capsys.readouterr()
        if argv[2] == "validate" and as_json:
            out = json.dumps(_strip(json.loads(out)), sort_keys=True)
        outs.append((rc, out, err))
    assert outs[1] == outs[0]
    rc, out, err = outs[1]
    assert out and not err
    if argv[2] == "validate":
        assert rc == (0 if len(argv) == 3 else 1)


# -- the card's constants ---------------------------------------------------------------


def test_a_port_cost_row_reads_its_own_card():
    """The roofline takes the row's own peak (or the caller's) and no
    memory term when ``bytes_accessed`` is null; no row with
    ``peak_hbm_bytes`` gives no ``hbm_frac``; no TPU constant is in the
    port's training twin."""
    row = {"key": "k", "program_kind": "packed", "k": 2, "flops": 3.0e12,
           "bytes_accessed": None, "peak_hbm_bytes": None, "device": "NVIDIA H100 80GB HBM3",
           "peak_flops": 989.5e12}
    cal = calibration.TrainCalibration.nominal()
    cal.cost = {"abc123": dict(row)}
    assert cal.roofline_step_s("abc", k=4, mfu=0.5) == 3.0e12 * 2 / (989.5e12 * 0.5)
    assert cal.hbm_frac(k=4) is None
    cal.cost["abc123"]["bytes_accessed"] = 6.7e12
    assert cal.roofline_step_s("abc", k=2, mfu=0.5) == 6.7e12 / 3.35e12
    assert whatif.member_forecast(cal, "abc", k=2)["hbm_frac"] is None
    cal.cost = {"def456": dict(row, device="cpu", peak_flops=None)}
    with pytest.raises(ValueError, match="peak_flops"):
        cal.roofline_step_s("def")
    assert cal.roofline_step_s("def", k=2, peak_flops=1e12, mfu=1.0) == 3.0
    assert whatif.group_width_forecast(cal, "nominal", hbm_bytes=8 << 30)["solved_width"] == 1
    src = "\n".join(p.read_text() for p in sorted(
        pathlib.Path(calibration.__file__).parent.glob("*.py")))
    assert not re.search(r"V5E|v5e|8\.19e11|1\.6e10", src)
