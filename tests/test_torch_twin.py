"""The port's serving twin and job admission gate against the JAX
package's, on the CPU.

One ``Calibration`` dict and seed go through both packages' ``simulate``
under constant and spike load, a chaos spec, a tenant-weighted fleet and
the gateway's microbatch former: the results, event-log digests
included, are equal. ``fleet_search`` and the pre-gate's ``forecast``
are equal too. Then a capture served on the CPU through the port's own
gateway (journal on): ``validate`` passes on it and fails once the
forward is halved, in both packages with equal reports, and a
tenant-aware capture builds a ``JobAdmissionGate`` in each package whose
verdicts (admit, then reject with ``JobRejected``) are equal. Last, the
calibration's card departures: a port ``perf/cost`` row's roofline
reads its own card's peak and bandwidth, and a bundle whose rows carry
no ``peak_hbm_bytes`` has no ``hbm_frac``.
"""

import json
import threading
import time

import pytest
import torch

from rafiki_tpu.obs import journal as jax_journal_mod
from rafiki_tpu.obs.twin import (calibration as jax_calibration, engine as jax_engine,
                                 load as jax_load, pregate as jax_pregate,
                                 validate as jax_validate, whatif as jax_whatif)
from rafiki_tpu.tenancy import arbiter as jax_arbiter
from rafiki_tpu_torch.bus import InProcBus
from rafiki_tpu_torch.gateway import Gateway, GatewayConfig
from rafiki_tpu_torch.obs import journal as journal_mod
from rafiki_tpu_torch.obs.perf import profiler
from rafiki_tpu_torch.obs.twin import (calibration, engine, load, pregate, validate,
                                       whatif)
from rafiki_tpu_torch.predictor import Predictor
from rafiki_tpu_torch.tenancy import TenantDirectory, TenantFabric, arbiter
from rafiki_tpu_torch.worker.inference import InferenceWorker

torch.set_num_threads(2)

PKGS = {"jax": (jax_calibration, jax_engine, jax_load, jax_whatif, jax_pregate),
        "port": (calibration, engine, load, whatif, pregate)}

SPEC = "seed=2;inference.forward:delay:delay=0.08:match=w1;bus.add_query:error:p=0.05"

#: name -> (load shape, qps, duration s, chaos spec, TwinConfig overrides)
RUNS = {
    "constant": ("constant", 60.0, 4.0, None, {}),
    "spike": ("spike", 40.0, 5.0, None, {}),
    "chaos": ("constant", 60.0, 4.0, SPEC, {}),
    "tenants": ("constant", 80.0, 3.0, None,
                {"max_inflight": 2, "max_queue": 8,
                 "tenants": {"a": {"weight": 4.0}, "b": {"weight": 1.0}}}),
    "microbatch": ("spike", 50.0, 3.0, None, {"max_batch": 4, "max_batch_wait_s": 0.004}),
}


def _cal_dict():
    return jax_calibration.Calibration.nominal(forward_ms=12.0, workers=3).to_dict()


def _simulate(pkg, name):
    cal_mod, eng_mod, load_mod, _, _ = PKGS[pkg]
    shape, qps, dur, spec, over = RUNS[name]
    cal = cal_mod.Calibration.from_dict(_cal_dict())
    cfg = eng_mod.TwinConfig.from_calibration(cal, **over)
    arrivals = load_mod.synthesize(shape, qps, dur, seed=5)
    if over.get("tenants"):
        arrivals = [(t, 1, "a" if i % 3 == 0 else "b") for i, t in enumerate(arrivals)]
    return arrivals, eng_mod.simulate(cal, cfg, arrivals, seed=5, chaos_spec=spec,
                                      record_events=True)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_simulate_equals_the_jax_packages(name):
    (a_ref, ref), (a_got, got) = _simulate("jax", name), _simulate("port", name)
    assert a_got == a_ref and got == ref
    assert got["requests"] > 50 and got["p99_ms"] is not None
    if name == "chaos":
        assert got["chaos_fired"] > 0
    if name == "tenants":
        assert set(got["tenants"]) == {"a", "b"}


def test_fleet_search_and_the_pregate_forecast_equal_the_jax_packages():
    out = {}
    for pkg in PKGS:
        cal_mod, eng_mod, load_mod, whatif_mod, pregate_mod = PKGS[pkg]
        cal = cal_mod.Calibration.from_dict(_cal_dict())
        arrivals = load_mod.synthesize("spike", 120.0, 4.0, seed=1)
        out[pkg] = (whatif_mod.fleet_search(cal, eng_mod.TwinConfig.from_calibration(cal),
                                            arrivals, seed=1),
                    pregate_mod.forecast("seed=11;inference.forward:delay:delay=0.3:match=w0"),
                    pregate_mod.forecast(SPEC, calibration=cal, qps=30.0, duration_s=3.0,
                                         seed=4),
                    pregate_mod.forecast("seed=1;checkpoint.save:error"))
    assert out["port"] == out["jax"]
    fleet, spike, spec, none = out["port"]
    assert fleet["satisfied"] and fleet["scanned"]
    assert spike["delta_p99_ms"] > 0 and spec["chaos_fired"] > 0 and none is None


class _SleepModel:
    """A forward of a fixed wall time: the capture's service time."""

    def __init__(self, forward_s):
        self.forward_s = forward_s

    def predict(self, queries):
        time.sleep(self.forward_s)
        return [[0.25, 0.75] for _ in queries]


def _capture(log_dir, tiers=None, n=60, gap_s=0.02, forward_s=0.02):
    """Serve ``n`` one-query requests, one after another, through the
    port's gateway over one thread worker, with the journal on. With
    ``tiers`` (tenant -> tier) the gateway is tenant-aware and the
    tenants take turns."""
    journal_mod.journal.configure(log_dir, role="gateway")
    bus, stop = InProcBus(), threading.Event()
    worker = InferenceWorker(bus, "twinjob", "w0", _SleepModel(forward_s), stop_event=stop)
    th = threading.Thread(target=worker.run, daemon=True)
    th.start()
    try:
        while "w0" not in bus.get_workers("twinjob"):
            time.sleep(0.005)
        fabric = TenantFabric(TenantDirectory(tiers=tiers)) if tiers else None
        gw = Gateway(Predictor(bus, "twinjob", timeout_s=10.0), GatewayConfig(min_replies=1),
                     tenancy=fabric)
        tenants = sorted(tiers) if tiers else [None]
        for i in range(n):
            gw.predict([[1.0]], tenant=tenants[i % len(tenants)])
            time.sleep(gap_s)
        gw.close()
    finally:
        stop.set()
        th.join(timeout=10)
        journal_mod.journal.close()
    return log_dir


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    # A 100 ms forward: a loaded machine's scheduling stalls stay small
    # beside it, so the faithful twin's p99 holds its tolerance.
    return _capture(tmp_path_factory.mktemp("twin-capture"), n=24, gap_s=0.005, forward_s=0.1)


def _strip(report):
    return {k: v for k, v in report.items() if k != "created_ts"}


@pytest.mark.parametrize("scales", [None, {"forward": 0.5}], ids=["faithful", "halved"])
def test_validate_on_a_port_capture_equals_the_jax_packages(capture, scales):
    got = validate.validate(capture, seed=0, scales=scales)
    ref = jax_validate.validate(capture, seed=0, scales=scales)
    assert _strip(got) == _strip(ref)
    assert got["measured"]["requests"] == 24
    if scales is None:
        assert got["ok"] is True, got
    else:
        assert got["ok"] is False and got["p50_err"] > got["tolerance"], got


def test_the_admission_gate_from_a_port_capture_equals_the_jax_packages(tmp_path):
    """Both packages' gates from one tenant-aware capture of the port's
    gateway: a light job is admitted, and a job whose load breaches the
    gold tenant's budget is rejected; both verdicts are journaled."""
    # An 80 ms forward: two tenants' requests that meet wait one forward
    # each (within gold's 200 ms budget), a heavy third tenant makes gold
    # wait two.
    log_dir = _capture(tmp_path / "cap", tiers={"gold_t": "gold", "batch_t": "batch"}, n=30,
                       gap_s=0.01, forward_s=0.08)
    verdicts = {}
    for pkg, mod, jm in (("jax", jax_arbiter, jax_journal_mod),
                         ("port", arbiter, journal_mod)):
        gate = mod.JobAdmissionGate.from_capture(log_dir, seed=0)
        jm.journal.configure(tmp_path / f"verdicts-{pkg}", role="arbiter")
        try:
            light = gate.admit_job("job-light", "carol", "batch", expected_qps=1.0)
            with pytest.raises(mod.JobRejected) as e:
                gate.admit_job("job-heavy", "bob", "std", expected_qps=400.0)
        finally:
            jm.journal.close()
        recs = [{k: v for k, v in r.items() if k not in ("ts", "pid", "role")}
                for r in jm.read_dir(tmp_path / f"verdicts-{pkg}")
                if r.get("kind") == "tenancy" and r.get("name") == "arbiter"]
        verdicts[pkg] = (gate.existing, light, e.value.detail, recs)
    assert verdicts["port"] == verdicts["jax"]
    existing, light, heavy, recs = verdicts["port"]
    assert light["admit"] and not heavy["admit"] and "bob" not in existing
    assert any(b["tenant"] == "gold_t" for b in heavy["breaches"])
    assert [r["admit"] for r in recs] == [True, False]
    with pytest.raises(arbiter.ModelUnvalidated):
        arbiter.JobAdmissionGate.from_capture(log_dir, seed=0, tolerance=1e-6)


def test_a_port_cost_row_reads_its_own_card():
    """The roofline takes the row's own peak and its card's bandwidth;
    a null ``bytes_accessed`` gives no memory term, and no row with
    ``peak_hbm_bytes`` gives no ``hbm_frac`` (no TPU constant)."""
    row = {"key": "k", "program_kind": "serial", "k": 1, "flops": 3.0e12,
           "bytes_accessed": None, "peak_hbm_bytes": None,
           "device": "NVIDIA H100 80GB HBM3", "peak_flops": 989.5e12}
    cal = calibration.Calibration.nominal()
    cal.cost = {"abc123": dict(row)}
    assert cal.service_from_cost("abc", mfu=0.5) == 3.0e12 / (989.5e12 * 0.5)
    assert cal.hbm_frac() is None
    cal.cost["abc123"]["bytes_accessed"] = 6.7e12
    assert cal.service_from_cost("abc", mfu=0.5) == 6.7e12 / 3.35e12
    assert profiler.hbm_bandwidth("NVIDIA H100 PCIe") == 2.0e12
    assert profiler.hbm_bandwidth("cpu") is None
    cpu = dict(row, device="cpu", peak_flops=None)
    cal.cost = {"def456": cpu}
    with pytest.raises(ValueError, match="peak_flops"):
        cal.service_from_cost("def")
    assert not any(hasattr(calibration, n) for n in ("HBM_BW_BYTES_S", "HBM_BYTES_PER_CHIP"))


def _journaled_controller(log_dir, damping):
    """A port controller on a fake clock over a square-wave burn, its
    decisions journaled to ``log_dir``."""
    from rafiki_tpu_torch.autoscale.controller import AutoscaleController, LaneSpec

    class _Lane:
        n = 2

        def size(self):
            return self.n

        def scale_to(self, n):
            self.n = n

    clock, state = {"t": 0.0}, {"i": 0}

    def sensors():
        state["i"] += 1
        high = state["i"] % 2 == 1
        return {"slo_breaching": ["x"] if high else [], "slo_burn": 2.0 if high else 0.0,
                "queue_frac": 0.0, "shed_rate": 0.0}

    journal_mod.journal.configure(log_dir, role="test")
    try:
        ctl = AutoscaleController(
            lanes=[LaneSpec("inference", min_size=1, max_size=8, up_cooldown_s=1.0,
                            down_cooldown_s=1.0)],
            sensor_fn=sensors, actuators={"inference": _Lane()}, clock=lambda: clock["t"],
            seed=0, tick_s=2.0, damping=damping, flap_window_s=600.0, tick_global_slo=False)
        for _ in range(40):
            ctl.tick()
            clock["t"] += 2.0
    finally:
        journal_mod.journal.close()
    return log_dir


@pytest.mark.parametrize("argv", [
    ["autoscale", "-n", "6"], ["autoscale", "--check"], ["autoscale", "--check", "-n", "0"],
    ["twin", "run", "--load", "spike", "--qps", "40", "--duration", "3"],
    ["twin", "run", "--load", "replay", "--workers", "2", "--chaos",
     "seed=1;inference.forward:delay:delay=0.05:match=w0"],
    ["twin", "sweep", "--grid", "workers=1,2", "--grid", "max_queue=4,32", "--fleet",
     "--qps", "5", "--duration", "3"],
    ["twin", "validate"], ["twin", "validate", "--scale", "forward=0.5"],
], ids=lambda a: "-".join(a[:2]))
@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_the_obs_verbs_print_what_the_jax_packages_print(argv, as_json, capture, tmp_path,
                                                         capsys):
    """``obs autoscale`` over the port controller's journal (undamped:
    ``--check`` exits 1, FLAPPING) and ``obs twin run|sweep|validate``
    over the port gateway's capture print, and exit, as the JAX
    package's CLI does on the same directory."""
    from rafiki_tpu.obs import cli as jax_cli
    from rafiki_tpu_torch.obs import cli

    log_dir = (_journaled_controller(tmp_path / "as", damping=False)
               if argv[0] == "autoscale" else capture)
    full = ["--dir", str(log_dir)] + (["--json"] if as_json else []) + argv
    outs = []
    for main in (jax_cli.main, cli.main):
        rc = main(full)
        out, err = capsys.readouterr()
        if argv[:2] == ["twin", "validate"] and as_json:
            out = json.dumps(_strip(json.loads(out)), sort_keys=True)
        outs.append((rc, out, err))
    assert outs[1] == outs[0]
    rc, out, err = outs[1]
    assert out or err
    if argv == ["autoscale", "--check"]:
        assert rc == 1 and "FLAPPING" in err
    if argv[:2] == ["twin", "validate"]:
        assert rc == (0 if len(argv) == 2 else 1)
