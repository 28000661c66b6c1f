"""The port's autoscale package against the JAX package's, on the CPU.

The controller of each package runs the same scripted sensor sequence
on an injected clock with one seed, and the ``ScaleDecision.to_dict()``
streams (and the lane's calls) are equal as JSON: hysteresis, the
per-direction cooldowns, flap damping on and off, a twin pre-gate veto,
a failing actuator, sensor faults from each package's chaos plane, and
the sweep lane over ``scheduler/mesh.py ElasticHandle`` with the
supervisor applying its deltas between ticks. Then the inference lane's
drain order on a real bus in both packages (the port's lane also frees
the drained replica), ``probe_knobs`` and ``tenant_pressure`` equal,
and ``ServicesManager.attach_autoscaler`` scaling a stacked job of the
port up and down on the CPU.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from rafiki_tpu import chaos as jax_chaos
from rafiki_tpu.autoscale import actuators as jax_actuators, controller as jax_controller
from rafiki_tpu.autoscale.prewarm import probe_knobs as jax_probe_knobs
from rafiki_tpu.bus import InProcBus as JaxInProcBus
from rafiki_tpu.model import knobs as jax_knobs
from rafiki_tpu.scheduler.mesh import ElasticHandle as JaxElasticHandle
from rafiki_tpu.tenancy.arbiter import tenant_pressure as jax_tenant_pressure
from rafiki_tpu.worker.inference import InferenceWorker as JaxInferenceWorker
from rafiki_tpu_torch import chaos, telemetry
from rafiki_tpu_torch.autoscale import actuators, controller
from rafiki_tpu_torch.autoscale.prewarm import probe_knobs
from rafiki_tpu_torch.bus import InProcBus
from rafiki_tpu_torch.model import knobs
from rafiki_tpu_torch.scheduler.mesh import ElasticHandle
from rafiki_tpu_torch.tenancy.arbiter import tenant_pressure
from rafiki_tpu_torch.worker.inference import InferenceWorker

torch.set_num_threads(2)

PKGS = {"jax": (jax_controller, jax_actuators, jax_chaos, JaxElasticHandle),
        "port": (controller, actuators, chaos, ElasticHandle)}


class StubLane:
    def __init__(self, n=2, fail=False):
        self.n, self.fail, self.calls = n, fail, []

    def size(self):
        return self.n

    def scale_to(self, n):
        if self.fail:
            raise RuntimeError("spawn failed")
        self.calls.append(n)
        self.n = n


def _burn(level, queue=0.0, shed=0.0):
    return {"slo_breaching": ["x"] if level else [], "slo_burn": level,
            "queue_frac": queue, "shed_rate": shed}


#: name -> (sensor script by tick, controller kwargs, lane kwargs, chaos
#: spec, tick spacing s, ticks). The script cycles.
SCRIPTS = {
    "hysteresis": ([_burn(0.0, queue=0.6), _burn(0.0, queue=0.31), _burn(1.2), _burn(0.0, queue=0.9),
                    _burn(0.0, queue=0.29), _burn(0.0)], {}, {}, None, 7.0, 18),
    "cooldowns": ([_burn(2.0), _burn(2.0), _burn(0.0), _burn(0.0), _burn(2.0), _burn(0.0)],
                  {}, {}, None, 3.0, 30),
    "damped": ([_burn(2.0), _burn(0.0)], {"damping": True}, {}, None, 2.0, 60),
    "undamped": ([_burn(2.0), _burn(0.0)], {"damping": False}, {}, None, 2.0, 60),
    "veto": ([_burn(2.0), _burn(0.0, shed=0.2)], {"pregate": True}, {}, None, 6.0, 12),
    "actuator-failure": ([_burn(2.0)], {}, {"fail": True}, None, 2.0, 8),
    "sensor-faults": ([_burn(2.0), _burn(0.0)], {"damping": True}, {},
                      "seed=13;autoscale.sensor:error:p=0.3", 2.0, 40),
}


def _decisions(pkg, name):
    """One package's decision stream (JSON) and lane calls for a script."""
    ctl_mod, _, chaos_mod, _ = PKGS[pkg]
    script, kw, lane_kw, spec, spacing, ticks = SCRIPTS[name]
    kw = dict(kw)
    clock = {"t": 0.0}
    state = {"i": -1}

    def sensors():
        state["i"] += 1
        return dict(script[state["i"] % len(script)])

    if kw.pop("pregate", False):
        kw["pregate_fn"] = lambda lane, cur, target, s: (
            {"veto": True, "target": target} if target > cur else {"veto": False})
    lane = StubLane(**lane_kw)
    ctl = ctl_mod.AutoscaleController(
        lanes=[ctl_mod.LaneSpec("inference", min_size=1, max_size=4, up_threshold=1.0,
                                down_threshold=0.3, up_cooldown_s=5.0, down_cooldown_s=12.0)],
        sensor_fn=sensors, actuators={"inference": lane}, clock=lambda: clock["t"], seed=7,
        tick_s=spacing, flap_window_s=600.0, flap_flips=2, flap_backoff=2.0, flap_guard_s=2.0,
        flap_guard_cap_s=64.0, tick_global_slo=False, **kw)
    if spec:
        chaos_mod.install(chaos_mod.FaultPlane.from_spec(spec))
    try:
        out = []
        for _ in range(ticks):
            out.extend(d.to_dict() for d in ctl.tick())
            clock["t"] += spacing
    finally:
        if spec:
            chaos_mod.uninstall()
    return json.dumps(out, sort_keys=True), lane.calls, ctl.actuation_count("inference")


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_decision_streams_equal_the_jax_packages(name):
    ref, got = _decisions("jax", name), _decisions("port", name)
    assert got == ref
    assert json.loads(got[0])  # the stream is not empty
    if name == "undamped":
        assert got[2] >= 20 and _decisions("port", "damped")[2] * 3 <= got[2]
    if name == "veto":
        assert any(d["vetoed"] for d in json.loads(got[0])) and 4 not in got[1]
    if name == "sensor-faults":
        assert any(d["reason"] == "sensor-error" for d in json.loads(got[0]))


def _sweep_stream(pkg, monkeypatch):
    """The sweep lane over an ElasticHandle, the supervisor applying the
    pending delta between ticks; eph falls as the lane grows."""
    ctl_mod, act_mod, _, handle_cls = PKGS[pkg]
    monkeypatch.setenv("RAFIKI_AUTOSCALE_TARGET_EPH", "1000")
    h = handle_cls()
    h._set_live(2)
    clock = {"t": 0.0}
    eph = [400.0, 600.0, 900.0, 1600.0, 4000.0, 4000.0, 4000.0, 1000.0]
    seq = {"i": -1}

    def sensors():
        seq["i"] += 1
        return {"effective_trials_per_hour": eph[seq["i"] % len(eph)]}

    ctl = ctl_mod.AutoscaleController(
        lanes=[ctl_mod.LaneSpec("sweep", min_size=1, max_size=4, up_threshold=1.2,
                                down_threshold=0.5, up_cooldown_s=2.0, down_cooldown_s=2.0,
                                pressure_fn=ctl_mod.sweep_pressure)],
        sensor_fn=sensors, actuators={"sweep": act_mod.SweepChipLane(h)},
        clock=lambda: clock["t"], seed=3, tick_s=5.0, tick_global_slo=False)
    out, applied = [], []
    for _ in range(16):
        out.extend(d.to_dict() for d in ctl.tick())
        delta = h._take()
        applied.append(delta)
        h._set_live(h.live() + delta)
        clock["t"] += 5.0
    return json.dumps(out, sort_keys=True), applied, h.desired()


def test_the_sweep_lane_over_an_elastic_handle_equals_the_jax_packages(monkeypatch):
    ref, got = _sweep_stream("jax", monkeypatch), _sweep_stream("port", monkeypatch)
    assert got == ref
    assert any(d > 0 for d in got[1]) and any(d < 0 for d in got[1])


class _SlowModel:
    """Holds each forward long enough that a drain overlaps inflight work."""

    def __init__(self, hold_s=0.2):
        self.hold_s, self.destroyed = hold_s, 0

    def predict(self, queries):
        time.sleep(self.hold_s)
        return [[0.5, 0.5] for _ in queries]

    def destroy(self):
        self.destroyed += 1


def _drain(pkg):
    """Two replicas, a query parked on the newest, a drain to one: the
    lane's events, the parked reply, and what the port's free hook saw."""
    bus_cls, worker_cls, act_mod = ((JaxInProcBus, JaxInferenceWorker, jax_actuators)
                                    if pkg == "jax" else (InProcBus, InferenceWorker, actuators))
    bus, job = bus_cls(), "drainjob"
    freed = []

    def spawn(i):
        w = worker_cls(bus, job, f"as{i}", _SlowModel(), stop_event=threading.Event())
        th = threading.Thread(target=w.run, daemon=True)
        th.start()
        return f"as{i}", w, th

    kw = {} if pkg == "jax" else {
        "free_fn": lambda wid, w, th: freed.append((wid, th.is_alive(), w.drained.is_set(),
                                                    wid in bus.get_workers(job)))}
    lane = act_mod.InferenceWorkerLane(bus, job, spawn_fn=spawn, **kw)
    lane.scale_to(2)
    bus.add_query("as1", "q-inflight", [1.0])
    deadline = time.monotonic() + 5
    while bus.queue_depth("as1") > 0:
        assert time.monotonic() < deadline, "query never popped"
        time.sleep(0.005)
    lane.scale_to(1)
    preds = bus.get_predictions("q-inflight", 1, timeout=0.0)
    out = (lane.events, preds[0][1] if preds else None, lane.worker_ids(),
           "as1" in bus.get_workers(job))
    lane.scale_to(0)
    return out, freed


def test_the_drain_order_equals_the_jax_packages_and_frees_after_the_reap():
    (ref, _), (got, freed) = _drain("jax"), _drain("port")
    assert got == ref
    events, reply, ids, registered = got
    assert [e for e in events if e[1] == "as1"] == [("drained", "as1"), ("reaped", "as1"),
                                                     ("freed", "as1")]
    assert reply == [0.5, 0.5] and ids == ["as0"] and not registered
    # The port's free hook ran once per drained replica, after its
    # thread ended, its drained event was set and its lease was gone.
    assert freed == [("as1", False, True, False), ("as0", False, True, False)]


def _knob_config(k):
    return {"depth": k.FixedKnob(16), "width": k.IntegerKnob(2, 9),
            "lr": k.FloatKnob(1e-4, 3e-2, is_exp=True), "dropout": k.FloatKnob(0.0, 0.5),
            "batch_size": k.CategoricalKnob([128, 64, 256], affects_shape=True),
            "act": k.CategoricalKnob(["relu", "gelu"])}


def test_probe_knobs_equal_the_jax_packages():
    got = probe_knobs(_knob_config(knobs))
    assert got == jax_probe_knobs(_knob_config(jax_knobs))
    assert got["batch_size"] == 128 and got["width"] == 5 and got["depth"] == 16


@pytest.mark.parametrize("sensors", [
    {}, {"tenant_burn": 1.7, "queue_frac": 0.2, "tenant_shed_rate": 0.01},
    {"tenant_burn": 0.1, "queue_frac": 0.2, "tenant_shed_rate": 0.05},
    {"tenant_burn": None, "queue_frac": 0.9, "tenant_shed_rate": None}])
def test_tenant_pressure_equals_the_jax_packages(sensors):
    assert tenant_pressure(sensors) == jax_tenant_pressure(sensors)


SHAPE = (8, 8, 1)
FF_KNOBS = dict(hidden_layers=1, hidden_units=32, learning_rate=1e-3, batch_size=32,
                epochs=1, seed=0)


def _ff_trials(tmp_path):
    """A CPU services manager over two completed FeedForward trials of
    one template: (manager, store, trials)."""
    from rafiki_tpu_torch.admin.services_manager import ServicesManager
    from rafiki_tpu_torch.models.ff import FeedForward
    from rafiki_tpu_torch.store import MetaStore, ParamsStore

    store, params = MetaStore(tmp_path / "m.sqlite3"), ParamsStore(tmp_path / "p")
    src = b"from rafiki_tpu_torch.models.ff import FeedForward\n"
    model = store.create_model("ff", "IMAGE_CLASSIFICATION", None, src, "FeedForward")
    tj = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, "x", "y", {})
    sub = store.create_sub_train_job(tj["id"], model["id"])
    trials = []
    for seed in range(2):
        m = FeedForward(device="cpu", **FF_KNOBS)
        m.init_parameters(4, SHAPE, torch.Generator().manual_seed(seed))
        t = store.create_trial(sub["id"], "ff", FF_KNOBS)
        store.mark_trial_as_completed(t["id"], 0.5, params.save(m.dump_parameters(), f"t{seed}"))
        trials.append(store.get_trial(t["id"]))
    return ServicesManager(store, params, device="cpu"), store, trials


def test_attach_autoscaler_scales_a_stacked_job_up_and_down_on_the_cpu(tmp_path, monkeypatch):
    """A stacked top-2 job on a CPU services manager, the autoscaler
    attached (not started) and ticked on an injected clock: a breach
    spawns a replica of the stacked shape that registers and answers as
    the base worker does, idle pressure drains it (its model freed),
    and stopping the job stops the controller first."""
    mgr, store, trials = _ff_trials(tmp_path)
    job = store.create_inference_job(trials[0]["id"], None)["id"]
    mgr.create_inference_services(job, trials)
    level = {"burn": 2.0}
    monkeypatch.setattr(controller, "read_sensors", lambda gateway=None: _burn(level["burn"]))
    ctl = mgr.attach_autoscaler(job, min_workers=1, max_workers=2, start=False, seed=0,
                                tick_global_slo=False)
    handle = mgr._inference_jobs[job]
    try:
        (up,) = ctl.tick(0.0)
        assert up.direction == "up" and up.actuated and up.target == 2
        base, replica = handle.workers
        assert sorted(mgr.bus.get_workers(job)) == sorted([base.worker_id, replica.worker_id])
        q = np.random.default_rng(1).uniform(0, 1, size=(5,) + SHAPE).astype(np.float32).tolist()
        assert replica.model.predict(q) == base.model.predict(q)
        assert len(mgr.get_predictor(job).predict(q, timeout_s=30)) == 5
        level["burn"] = 0.0
        (hold,) = ctl.tick(1.0)
        assert hold.reason == "flap-guard"  # a flip waits out the guard
        (down,) = ctl.tick(100.0)
        assert down.direction == "down" and down.actuated and down.target == 1
        assert handle.workers == [base] and mgr.bus.get_workers(job) == [base.worker_id]
        assert replica.model._ens is None  # freed: the stacked copy dropped
    finally:
        mgr.stop_inference_services(job)
    assert handle.autoscaler is ctl and ctl._thread is None
    assert telemetry.get_counter("autoscale.workers_spawned") >= 1


def test_a_job_gate_refuses_a_job_before_any_service_starts(tmp_path):
    """With a JobAdmissionGate attached (a nominal 50 ms forward, a gold
    tenant at 5 qps), a job declaring 25 qps raises ``JobRejected`` and
    starts nothing; one declaring 1 qps is admitted and served; a job
    that declares no tenant is not forecast."""
    from rafiki_tpu_torch.obs.twin.calibration import Calibration
    from rafiki_tpu_torch.obs.twin.engine import TwinConfig
    from rafiki_tpu_torch.tenancy import JobAdmissionGate
    from rafiki_tpu_torch.tenancy.arbiter import JobRejected

    mgr, store, trials = _ff_trials(tmp_path)
    cal = Calibration.nominal(forward_ms=50.0, workers=1)
    gate = JobAdmissionGate(cal, TwinConfig.from_calibration(cal, workers=1),
                            existing={"alice": ("gold", 5.0)}, horizon_s=2.0, seed=0)
    mgr.attach_job_gate(gate)
    jobs = [store.create_inference_job(trials[0]["id"], None)["id"] for _ in range(3)]
    try:
        with pytest.raises(JobRejected):
            mgr.create_inference_services(jobs[0], trials, tenant="bob", tier="std",
                                          expected_qps=25.0)
        assert jobs[0] not in mgr._inference_jobs and mgr.bus.get_workers(jobs[0]) == []
        assert store.get_inference_job(jobs[0])["status"] == "STARTED"
        mgr.create_inference_services(jobs[1], trials, tenant="carol", tier="batch",
                                      expected_qps=1.0)
        assert mgr.bus.get_workers(jobs[1]) and gate.existing["carol"] == ("batch", 1.0)
        mgr.create_inference_services(jobs[2], trials)
        assert set(gate.existing) == {"alice", "carol"}
    finally:
        mgr.stop_all()
