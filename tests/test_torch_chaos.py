"""The port's chaos plane held against the JAX package's, on the CPU.

Every spec of the JAX package's scenarios and of ``tests/test_chaos.py``
parses to the same faults in both packages; a scripted sequence of
``(site, key)`` hits fires the same schedule in both, across seeds and
``p<1`` specs; bad specs fail in both. Then the port's counterparts of
``tests/test_chaos.py``'s inertness, env install, gating, enactment and
hook-site tests, and of its runner tests.
"""

import os
import time

import pytest
import torch

from rafiki_tpu import chaos as jax_chaos
from rafiki_tpu.chaos.scenarios import SCENARIOS as JAX_SCENARIOS
from rafiki_tpu_torch import chaos, telemetry
from rafiki_tpu_torch.chaos import ChaosError, ChaosSpecError, FaultPlane, install, uninstall
from rafiki_tpu_torch.chaos import runner as runner_mod
from rafiki_tpu_torch.chaos.scenarios import SCENARIOS, SUBPROCESS_SCENARIOS, Scenario

torch.set_num_threads(2)

#: The specs ``tests/test_chaos.py`` parses or installs.
TEST_SPECS = [
    "seed=9;worker.epoch:kill:after=1:times=2:unless=-r;"
    "bus.add_query:drop:p=0.25;store.params_write:delay:delay=0.5:match=_ckpt_",
    "seed=42;bus.add_query:drop:p=0.3;bus.heartbeat:skip:p=0.2:match=w1",
    "seed=1;bus.add_query:drop:p=0.3",
    "seed=2;bus.add_query:drop:p=0.3",
    "seed=7;bus.add_query:drop:p=0.5",
    "seed=3;bus.heartbeat:skip",
    "worker.epoch:kill:after=2:times=1:match=w0:unless=-r",
    "store.params_write:delay:delay=0.12:times=1;inference.forward:error",
    "bus.add_query:drop;bus.heartbeat:skip",
    "store.params_write:error:match=_ckpt_",
    "scheduler.preempt:preempt:delay=1.5:times=1",
    "seed=5;bus.heartbeat:skip",
]
ALL_SPECS = sorted({sc.spec for sc in JAX_SCENARIOS.values()}) + TEST_SPECS
BAD_SPECS = ["", "worker.epoch", "worker.epoch:explode", "worker.epoch:kill:after",
             "worker.epoch:kill:nope=1", "worker.epoch:kill:p=lots", "seed=seven;a.b:drop",
             ":drop", "a.b:drop:times=x"]
KEYS = ["w0", "w1", "w2", "w0-r1", "w1-r2", "chip0", "chip1", "p0:w0", "t1_ckpt_0",
        "0123abcd", "k@m0", "k@m1", "k@m2", "k@m3", "chaosjob", "evict-w0"]


@pytest.fixture(autouse=True)
def _clean_plane():
    telemetry.reset()
    uninstall()
    jax_chaos.uninstall()
    yield
    uninstall()
    jax_chaos.uninstall()
    telemetry.reset()


# -- parity with the JAX package's plane -------------------------------------


def test_the_catalogs_have_nineteen_and_six_scenarios():
    """Nineteen in the JAX package; in the port the six in-process ones,
    the three that SIGKILL ProcessScheduler workers, and, since the mesh
    sweep, its three in-process scenarios and the two that SIGKILL the
    sweep's supervisor process, since the search plane,
    ``early-kill-mid-pack-resume``, since the multiprocessing bus,
    ``stacked-worker-loss-fallback``, which SIGKILLs a spawned inference
    worker, and, since tenancy, ``noisy-neighbor-shed``: seventeen, each
    with the JAX package's spec, description and env."""
    assert len(JAX_SCENARIOS) == 19
    assert set(SCENARIOS) == {"checkpoint-write-failure", "straggler-quorum", "drain-under-load",
                              "predictor-outage-surfaces", "pack-straggler-evict",
                              "nan-trial-contained", "mesh-chip-loss-repack",
                              "chip-loss-mid-sharded-trial",
                              "mesh-degrades-single-chip",
                              "noisy-neighbor-shed"} | SUBPROCESS_SCENARIOS
    assert SUBPROCESS_SCENARIOS == {"kill-mid-trial-resume", "kill-mid-pack-resume",
                                    "collective-kill-mid-step", "supervisor-kill-mid-sweep",
                                    "host-loss-mid-sweep", "early-kill-mid-pack-resume",
                                    "stacked-worker-loss-fallback"}
    assert len(SCENARIOS) == 17
    for name, sc in SCENARIOS.items():
        jsc = JAX_SCENARIOS[name]
        assert (sc.spec, sc.description, sc.env) == (jsc.spec, jsc.description, jsc.env), name


@pytest.mark.parametrize("spec", ALL_SPECS)
def test_every_spec_parses_as_in_the_jax_package(spec):
    got, want = FaultPlane.from_spec(spec), jax_chaos.FaultPlane.from_spec(spec)
    assert got.seed == want.seed
    assert [f.describe() for f in got.faults] == [f.describe() for f in want.faults]
    for a, b in zip(got.faults, want.faults):
        assert (a.site, a.mode, a.prob, a.after, a.times, a.delay_s, a.match, a.unless) == \
            (b.site, b.mode, b.prob, b.after, b.times, b.delay_s, b.match, b.unless)


def _script(spec, n, seed):
    """A fixed sequence of (site, key) hits over the spec's sites and one
    site no spec names."""
    import random

    sites = sorted({e.split(":")[0] for e in spec.split(";") if e and not e.startswith("seed=")})
    sites.append("bus.put_prediction")
    rng = random.Random(seed)
    return [(rng.choice(sites), rng.choice(KEYS)) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_the_same_hits_fire_the_same_schedule(seed):
    """Every spec above, and p<1 specs at three plane seeds: the port's
    schedule is the JAX package's, hit for hit."""
    specs = ALL_SPECS + [f"seed={s};bus.add_query:drop:p=0.3;bus.heartbeat:skip:p=0.6:match=w1;"
                         f"worker.epoch:kill:p=0.5:after=2:times=4:unless=-r" for s in (1, 2, 99)]
    fired = 0
    for spec in specs:
        got, want = FaultPlane.from_spec(spec), jax_chaos.FaultPlane.from_spec(spec)
        for site, key in _script(spec, 300, seed):
            a, b = got.decide(site, key), want.decide(site, key)
            assert (a is None) == (b is None)
        assert got.schedule() == want.schedule(), spec
        fired += len(got.schedule())
    assert fired > 100


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_bad_specs_fail_in_both_packages(bad):
    with pytest.raises(ChaosSpecError):
        FaultPlane.from_spec(bad)
    with pytest.raises(jax_chaos.ChaosSpecError):
        jax_chaos.FaultPlane.from_spec(bad)


# -- the port's plane ------------------------------------------------------------


def test_inert_when_unset(monkeypatch):
    monkeypatch.delenv(chaos.ENV_VAR, raising=False)
    assert chaos.reset_from_env() is None
    assert chaos.active() is None
    assert chaos.hook("bus.add_query", "w0") is None
    assert chaos.decide("worker.epoch", "w0") is None
    assert telemetry.get_counter("chaos.injected") == 0.0


def test_env_spec_installs_on_reset(monkeypatch):
    monkeypatch.setenv(chaos.ENV_VAR, "seed=3;bus.heartbeat:skip")
    plane = chaos.reset_from_env()
    assert plane is not None and plane.seed == 3
    assert chaos.hook("bus.heartbeat", "w0") == "skip"
    monkeypatch.delenv(chaos.ENV_VAR)
    assert chaos.reset_from_env() is None


def test_after_times_match_unless_gates(tmp_path):
    from rafiki_tpu_torch.obs.journal import journal, read_dir

    journal.configure(tmp_path, role="test")
    try:
        plane = FaultPlane.from_spec("worker.epoch:kill:after=2:times=1:match=w0:unless=-r")
        install(plane)
        assert chaos.decide("worker.epoch", "w0-r1") is None  # unless: no hit counted
        assert chaos.decide("worker.epoch", "w1") is None      # match
        assert chaos.decide("worker.epoch", "w0") is None      # after=2
        assert chaos.decide("worker.epoch", "w0") is None
        fault = chaos.decide("worker.epoch", "w0")
        assert fault is not None and fault.mode == "kill"
        assert chaos.decide("worker.epoch", "w0") is None      # times=1
    finally:
        journal.close()
    assert plane.schedule() == [("worker.epoch", "kill", 3, "w0")]
    assert telemetry.get_counter("chaos.injected") == 1.0
    assert telemetry.get_counter("chaos.injected.worker.epoch.kill") == 1.0
    [rec] = [r for r in read_dir(tmp_path) if r["kind"] == "chaos"]
    assert (rec["name"], rec["site"], rec["mode"], rec["key"], rec["hit"]) == \
        ("injected", "worker.epoch", "kill", "w0", 3)


def test_delay_and_error_modes_enact():
    from rafiki_tpu_torch.obs.ledger import ledger

    before = ledger.snapshot()["total"].get("downtime_s", 0.0)
    install(FaultPlane.from_spec(
        "store.params_write:delay:delay=0.12:times=1;inference.forward:error"))
    t0 = time.monotonic()
    assert chaos.hook("store.params_write", "p1") == "delay"
    assert time.monotonic() - t0 >= 0.1
    assert ledger.snapshot()["total"].get("downtime_s", 0.0) - before == pytest.approx(0.12)
    with pytest.raises(ChaosError):
        chaos.hook("inference.forward", "w0")
    assert issubclass(ChaosError, OSError)


def test_bus_drop_and_heartbeat_skip():
    from rafiki_tpu_torch.bus import InProcBus

    bus = InProcBus()
    bus.add_worker("j", "w0")
    assert bus.get_workers("j", max_age_s=10.0) == ["w0"]
    install(FaultPlane.from_spec("bus.add_query:drop;bus.heartbeat:skip;bus.put_prediction:drop"))
    bus.add_query("w0", "q1", [1.0])
    assert bus.pop_queries("w0", max_n=10, timeout=0.05) == []
    assert telemetry.get_counter("bus.queries_dropped_chaos") == 1.0
    bus.put_prediction("q1", "w0", [0.5])
    assert bus.get_predictions("q1", 1, timeout=0.05) == []
    time.sleep(0.15)
    bus.heartbeat("j", "w0")  # skipped: the lease does NOT refresh
    assert bus.get_workers("j", max_age_s=0.1) == []
    uninstall()
    bus.heartbeat("j", "w0")
    assert bus.get_workers("j", max_age_s=0.1) == ["w0"]


def test_store_write_fault_targets_checkpoints_only(tmp_path):
    from rafiki_tpu_torch.store import ParamsStore

    params = ParamsStore(tmp_path / "p")
    install(FaultPlane.from_spec("store.params_write:error:match=_ckpt_"))
    pid = params.save(b"final-params")
    assert params.load(pid) == b"final-params"
    with pytest.raises(ChaosError):
        params.save_checkpoint("trial1", 0, b"snap")
    assert params.latest_checkpoint("trial1") is None  # nothing torn


def test_skipped_service_heartbeat_ages_the_lease(tmp_path):
    from rafiki_tpu_torch.store import MetaStore

    store = MetaStore(tmp_path / "m.sqlite3")
    svc = store.create_service("TRAIN", "job", 0)
    store.update_service(svc["id"], heartbeat=True)
    first = store.get_service(svc["id"])["heartbeat_at"]
    install(FaultPlane.from_spec("store.heartbeat:skip"))
    time.sleep(0.02)
    store.update_service(svc["id"], status="RUNNING", heartbeat=True)
    row = store.get_service(svc["id"])
    assert row["heartbeat_at"] == first and row["status"] == "RUNNING"
    uninstall()
    store.update_service(svc["id"], heartbeat=True)
    assert store.get_service(svc["id"])["heartbeat_at"] > first


def test_checkpoint_write_failure_does_not_error_trial(tmp_path):
    """An injected checkpoint-write failure costs resumability, not the
    trial; the worker.epoch site fires after each epoch's write."""
    from rafiki_tpu_torch.model.base import BaseModel
    from rafiki_tpu_torch.store import MetaStore, ParamsStore
    from rafiki_tpu_torch.worker.train import TrainWorker

    class _Model(BaseModel):
        _sink = None

        @staticmethod
        def get_knob_config():
            return {}

        def set_checkpoint_sink(self, sink):
            self._sink = sink

        def train(self, uri):
            for epoch in range(2):
                self._sink(epoch, lambda: b"snap")

        def evaluate(self, uri):
            return 0.5

        def predict(self, queries):
            return []

        def dump_parameters(self):
            return b"params"

    class _Advisor:
        def propose(self):
            return {}

        def feedback(self, score, knobs):
            pass

    store = MetaStore(tmp_path / "m.sqlite3")
    params = ParamsStore(tmp_path / "p")
    mrow = store.create_model("m", "T", None, b"x = 1", "X")
    job = store.create_train_job("app", "T", None, "t", "v", {})
    sub = store.create_sub_train_job(job["id"], mrow["id"])
    plane = FaultPlane.from_spec("store.params_write:error:match=_ckpt_;worker.epoch:skip")
    install(plane)
    worker = TrainWorker(store, params, sub["id"], _Model, _Advisor(), "t", "v", {},
                         async_persist=False, checkpoint_every=1)
    assert worker.run_trial({})["status"] == "COMPLETED"
    assert telemetry.get_counter("worker.checkpoint_write_failed") == 2.0
    sites = [s[0] for s in plane.schedule()]
    assert sites == ["store.params_write", "worker.epoch"] * 2
    # With no checkpointing the sink is still wired while a plane is active.
    worker.checkpoint_every = 0
    assert worker.run_trial({})["status"] == "COMPLETED"
    assert [s[0] for s in plane.schedule()][4:] == ["worker.epoch"] * 2


def test_serving_sites_enact_at_the_gateway_and_the_worker():
    """``gateway.predict`` and ``inference.forward`` fire on the predict
    path: a forward error is answered as an error reply."""
    from rafiki_tpu_torch.bus import InProcBus
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    class _Const:
        def predict(self, queries):
            return [[1.0] for _ in queries]

    bus = InProcBus()
    worker = InferenceWorker(bus, "j", "w0", _Const())
    bus.add_worker("j", "w0")
    plane = FaultPlane.from_spec("inference.forward:error:times=1")
    install(plane)
    worker._serve([("q1", [0.0])])
    worker._serve([("q2", [0.0])])
    assert "error" in str(bus.get_predictions("q1", 1, timeout=1.0)[0][1])
    assert bus.get_predictions("q2", 1, timeout=1.0)[0][1] == [1.0]
    assert plane.schedule() == [("inference.forward", "error", 1, "w0")]


# -- the runner -------------------------------------------------------------------


def test_runner_rejects_unknown_scenario():
    with pytest.raises(KeyError):
        runner_mod.run_scenario("no-such-scenario", device="cpu")


def test_invariant_failures_actually_fail(monkeypatch):
    def always_wrong(tmp, check):
        check("impossible", False, "violated by construction")

    def raises(tmp, check):
        raise RuntimeError("scenario body exploded")

    def checks_nothing(tmp, check):
        pass

    for name, fn in (("always-wrong", always_wrong), ("raises", raises),
                     ("vacuous", checks_nothing)):
        monkeypatch.setitem(SCENARIOS, name, Scenario(name=name, description="x",
                                                      spec="bus.heartbeat:skip", fn=fn))
    report = runner_mod.run_scenario("always-wrong", device="cpu")
    assert not report.passed
    assert [c.name for c in report.checks if not c.ok] == ["impossible"]
    report = runner_mod.run_scenario("raises", device="cpu")
    assert not report.passed and "exploded" in report.error
    assert not runner_mod.run_scenario("vacuous", device="cpu").passed
    assert "FAIL  vacuous" in runner_mod.format_report(runner_mod.run_scenario("vacuous",
                                                                               device="cpu"))


def test_runner_restores_env_plane_and_journal(monkeypatch, tmp_path):
    from rafiki_tpu_torch.obs.journal import journal
    from rafiki_tpu_torch.utils.backend import resolve_device

    monkeypatch.setenv(chaos.ENV_VAR, "bus.add_query:drop")
    seen = {}

    def body(tmp, check):
        seen["env"] = os.environ.get(chaos.ENV_VAR)
        seen["extra"] = os.environ.get("RAFIKI_CHAOS_TEST_EXTRA")
        seen["device"] = resolve_device(None)
        seen["journal"] = journal.configured
        check("ran", True)

    monkeypatch.setitem(SCENARIOS, "env-probe", Scenario(
        name="env-probe", description="x", spec="seed=5;bus.heartbeat:skip", fn=body,
        env={"RAFIKI_CHAOS_TEST_EXTRA": "1"}))
    journal.configure(tmp_path, role="caller")
    try:
        report = runner_mod.run_scenario("env-probe", device="cpu")
        assert journal.configured and journal.log_dir == tmp_path and journal.role == "caller"
    finally:
        journal.close()
    assert report.passed and report.to_dict()["checks"] == [
        {"name": "ran", "ok": True, "detail": ""}]
    assert seen == {"env": "seed=5;bus.heartbeat:skip", "extra": "1",
                    "device": torch.device("cpu"), "journal": True}
    assert os.environ[chaos.ENV_VAR] == "bus.add_query:drop"
    assert "RAFIKI_CHAOS_TEST_EXTRA" not in os.environ
    assert chaos.active() is None


def test_journal_checks_read_a_kill_story(tmp_path):
    """The runner's journals-alone checks, on two processes' records: one
    story whole, then one with no death and no flight record."""
    from rafiki_tpu_torch.obs.journal import Journal

    runner_journal = Journal(tmp_path, role="runner")
    runner_journal.record("event", "trial_started", trial_id="t")
    runner_journal.record("event", "worker_died", worker_id="w0")
    runner_journal.record("event", "trial_completed", trial_id="t")
    runner_journal.close()
    (tmp_path / "journal-worker-1.jsonl").write_text(
        '{"ts": 1.0, "pid": 1, "role": "worker", "kind": "chaos", "name": "injected", '
        '"site": "worker.epoch", "mode": "kill"}\n')
    got = []
    runner_mod._journal_checks(lambda n, ok, d="": got.append((n, bool(ok))), tmp_path,
                               [tmp_path / "flight-x.json"])
    assert all(ok for _, ok in got) and len(got) == 5
    got.clear()
    (tmp_path / "journal-runner-{}.jsonl".format(os.getpid())).unlink()
    runner_mod._journal_checks(lambda n, ok, d="": got.append((n, bool(ok))), tmp_path, [])
    assert [n for n, ok in got if not ok] == ["journal_multi_process",
                                             "journal_records_trial_lifecycle",
                                             "journal_records_worker_death",
                                             "flight_record_dumped"]


def test_cli_lists_and_refuses_unknown_scenarios(capsys):
    from rafiki_tpu_torch.chaos.__main__ import main

    assert main(["list"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in SCENARIOS)
    assert main(["run", "no-such-scenario", "--device", "cpu"]) == 2
