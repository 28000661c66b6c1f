"""The port's in-process chaos scenarios (the six of the serving,
checkpoint and pack planes and the three of the mesh sweep), on the CPU, and
``nan-trial-contained`` against the JAX package's run of its own.

Each scenario runs through the port's runner (``rafiki_tpu_torch/chaos/
runner.py``) with ``device="cpu"`` and passes every check, the fault
having fired. (The three whose faults fire in ProcessScheduler
subprocesses run beside the JAX package's in
``tests/test_torch_chaos_kill_*.py``; the two that kill the sweep's
supervisor process in ``tests/test_torch_sweep_resume.py``.) Then the two packages' ``nan-trial-contained`` bodies run
side by side, each with its own plane and journal: the same member
errors, at the same bad step, the rows end in the same statuses, and
the journals hold the same record kinds and names, the advisor's audit
records included, and the port's pack rounds besides. Last, both packages' ``noisy-neighbor-shed`` bodies
run weighted (every check passes, the aggressor alone is shed, for
``tenant_quota``) and under ``RAFIKI_TENANT_UNWEIGHTED=1``, where both
must fail ``victim_p99_within_budget``. The two autoscale scenarios run
with the rest (``load-spike-scale-up`` on the wall clock,
``autoscale-flap-damping`` on a fake one, whose checks and fault schedule
equal the JAX package's), and the runner's twin pre-gate forecast of
every serving spec equals the JAX runner's.
"""

import pytest
import torch

from rafiki_tpu import chaos as jax_chaos
from rafiki_tpu.chaos import runner as jax_runner
from rafiki_tpu.chaos.scenarios import SCENARIOS as JAX_SCENARIOS
from rafiki_tpu.obs.journal import journal as jax_journal, read_dir as jax_read_dir
from rafiki_tpu.obs.perf import profiler as jax_profiler, slo as jax_slo
from rafiki_tpu.obs.twin import pregate as jax_pregate
from rafiki_tpu.ops.train import clear_program_cache as jax_clear_program_cache
from rafiki_tpu.store import MetaStore as JaxMetaStore
from rafiki_tpu_torch import chaos
from rafiki_tpu_torch.chaos import runner as port_runner
from rafiki_tpu_torch.chaos.runner import format_report, run_scenario
from rafiki_tpu_torch.chaos.scenarios import SCENARIOS, SUBPROCESS_SCENARIOS
from rafiki_tpu_torch.obs.journal import journal, read_dir
from rafiki_tpu_torch.obs.perf import profiler, slo
from rafiki_tpu_torch.ops.train import clear_program_cache
from rafiki_tpu_torch.store import MetaStore
from rafiki_tpu_torch.utils.backend import default_device

torch.set_num_threads(2)

#: Journal kinds of planes the port does not have yet: none (the advisor
#: decision audit and the search ledger's kinds are compared too).
JAX_ONLY_KINDS = set()
#: Records only the port journals: a pack's rounds, which the port's
#: training twin replays (``obs/twin/train/calibration.py``).
PORT_ONLY_PAIRS = {("trial_pack", "rounds")}


@pytest.mark.parametrize("name", sorted(set(SCENARIOS) - SUBPROCESS_SCENARIOS))
def test_scenario_passes_on_the_cpu(name):
    report = run_scenario(name, device="cpu")
    assert report.passed, format_report(report)
    assert report.schedule, "the fault never fired"
    assert chaos.active() is None


def _run_body(pkg, tmp):
    """One package's nan-trial-contained body, with its plane installed,
    its journal in ``tmp/obs`` and its program cache, profiler and SLO
    engine cold (so each builds and counts its programs, and ticks its
    SLOs on the same clock, whatever ran before in the process); returns
    its checks, its rows (by learning rate) and its journal records."""
    checks = []
    check = lambda name, ok, detail="": checks.append((name, bool(ok), str(detail)))  # noqa: E731
    if pkg == "jax":
        sc, plane_mod, j, store_cls, read = (JAX_SCENARIOS["nan-trial-contained"], jax_chaos,
                                             jax_journal, JaxMetaStore, jax_read_dir)
    else:
        sc, plane_mod, j, store_cls, read = (SCENARIOS["nan-trial-contained"], chaos, journal,
                                             MetaStore, read_dir)
    for clear in ((jax_clear_program_cache, jax_profiler.reset, jax_slo.configure)
                  if pkg == "jax" else (clear_program_cache, profiler.reset, slo.configure)):
        clear()
    plane_mod.install(plane_mod.FaultPlane.from_spec(sc.spec))
    j.configure(tmp / "obs", role="chaos-runner")
    try:
        if pkg == "jax":
            sc.fn(tmp, check)
        else:
            with default_device("cpu"):
                sc.fn(tmp, check)
    finally:
        j.close()
        plane_mod.uninstall()
    store = store_cls(tmp / "meta.sqlite3")
    [job] = store.get_train_jobs()
    rows = {t["knobs"]["learning_rate"]: t for t in store.get_trials_of_train_job(job["id"])}
    return checks, rows, read(tmp / "obs")


def test_nan_trial_contained_matches_the_jax_packages(tmp_path, monkeypatch):
    # Both packages' perf anomaly detectors flag epochs by their wall
    # time, which a loaded machine varies: their threshold is put out of
    # reach, so neither journals a perf/anomaly by chance.
    monkeypatch.setenv("RAFIKI_PERF_K", "1e9")
    got_checks, got_rows, got_recs = _run_body("port", tmp_path / "port")
    want_checks, want_rows, want_recs = _run_body("jax", tmp_path / "jax")
    assert all(ok for _, ok, _ in got_checks), [c for c in got_checks if not c[1]]
    assert all(ok for _, ok, _ in want_checks), [c for c in want_checks if not c[1]]
    # The same checks by name (trial ids aside).
    assert [n.split(":")[0] for n, _, _ in got_checks] == \
        [n.split(":")[0] for n, _, _ in want_checks]
    # The same member errored, the others completed.
    assert sorted(got_rows) == sorted(want_rows) == [0.001, 0.002, 0.004, 0.008]
    assert {lr: t["status"] for lr, t in got_rows.items()} == \
        {lr: t["status"] for lr, t in want_rows.items()} == \
        {0.001: "COMPLETED", 0.002: "COMPLETED", 0.004: "ERRORED", 0.008: "COMPLETED"}

    def divergences(recs):
        return [(r["member"], r["bad_step"], r["divergence"]) for r in recs
                if r["kind"] == "health" and r["name"] == "divergence"]

    assert divergences(got_recs) == divergences(want_recs) == [(2, 2, "nonfinite")]

    def pairs(recs):
        return {(r["kind"], r["name"].split(":")[0] if r["kind"] == "ledger" else r["name"])
                for r in recs if r["kind"] not in JAX_ONLY_KINDS}

    assert pairs(got_recs) - PORT_ONLY_PAIRS == pairs(want_recs)
    assert PORT_ONLY_PAIRS <= pairs(got_recs)
    for pair in [("chaos", "injected"), ("health", "divergence"), ("health", "capsule"),
                 ("flight", "health:divergence"), ("event", "trial_diverged"),
                 ("event", "pack_member_evicted")]:
        assert pair in pairs(got_recs), pair


# -- noisy-neighbor-shed, both packages, both polarities ------------------------


def _tenant_view(recs):
    """What the scenario's checks read: per tenant and record name, the
    count and the shed reasons."""
    out = {}
    for r in recs:
        if r.get("kind") == "tenant" and r.get("name") != "summary":
            key = (r["tenant"], r["name"])
            n, reasons = out.get(key, (0, set()))
            out[key] = (n + 1, reasons | ({r["reason"]} if "reason" in r else set()))
    return out


@pytest.mark.parametrize("unweighted", [False, True], ids=["weighted", "unweighted"])
def test_noisy_neighbor_shed_matches_the_jax_packages(unweighted, tmp_path, monkeypatch):
    """Each package's noisy-neighbor-shed body with its own plane and
    journal: weighted, both pass all six checks, shed only the aggressor
    and only for ``tenant_quota``; under ``RAFIKI_TENANT_UNWEIGHTED=1``
    (the doctored polarity) both fail ``victim_p99_within_budget``."""
    if unweighted:
        monkeypatch.setenv("RAFIKI_TENANT_UNWEIGHTED", "1")
    runs = {}
    for pkg in ("jax", "port"):
        checks = []
        check = lambda name, ok, detail="": checks.append((name, bool(ok), str(detail)))  # noqa: E731
        sc, plane_mod, j, read = ((JAX_SCENARIOS["noisy-neighbor-shed"], jax_chaos, jax_journal,
                                   jax_read_dir) if pkg == "jax" else
                                  (SCENARIOS["noisy-neighbor-shed"], chaos, journal, read_dir))
        plane_mod.install(plane_mod.FaultPlane.from_spec(sc.spec))
        j.configure(tmp_path / pkg, role="chaos-runner")
        try:
            sc.fn(tmp_path, check)
        finally:
            j.close()
            plane_mod.uninstall()
        runs[pkg] = checks, _tenant_view(read(tmp_path / pkg))
    (got, got_view), (want, want_view) = runs["port"], runs["jax"]
    assert [n for n, _, _ in got] == [n for n, _, _ in want] == [
        "victim_served", "victim_p99_within_budget", "aggressor_shed",
        "shed_charged_to_aggressor_quota", "victim_never_shed", "summary_reconciles_sheds"]
    if not unweighted:
        assert all(ok for _, ok, _ in got), got
        assert all(ok for _, ok, _ in want), want
        for view in (got_view, want_view):
            assert view[("aggressor", "shed")][1] == {"tenant_quota"}
            assert ("victim", "shed") not in view and view[("victim", "request")][0] == 25
    else:
        for checks in (got, want):
            assert dict((n, ok) for n, ok, _ in checks)["victim_p99_within_budget"] is False
    assert set(got_view) - {("aggressor", "shed")} == set(want_view) - {("aggressor", "shed")}


# -- the twin pre-gate and the autoscale scenarios --------------------------------


@pytest.mark.parametrize("name", sorted(n for n in SCENARIOS
                                        if jax_pregate.spec_touches_serving(SCENARIOS[n].spec)))
def test_the_twin_forecast_of_a_serving_spec_equals_the_jax_packages(name):
    """The runner forecasts every serving spec through the serving twin
    before injecting it; the forecast equals the JAX runner's for the
    same spec (the two autoscale scenarios among them)."""
    spec = SCENARIOS[name].spec
    assert spec == JAX_SCENARIOS[name].spec
    got = port_runner._twin_pregate(spec)
    assert got is not None and got == jax_runner._twin_pregate(spec)


def test_the_runner_report_carries_the_forecast_and_none_off_serving():
    report = run_scenario("autoscale-flap-damping", device="cpu")
    assert report.passed and report.twin_forecast is None  # autoscale.sensor: no serving site
    assert report.to_dict()["twin_forecast"] is None
    assert port_runner._twin_pregate(SCENARIOS["load-spike-scale-up"].spec)["workers_dead"] == []


def test_autoscale_flap_damping_matches_the_jax_packages(tmp_path):
    """Both packages' bodies on their fake clocks, each with its own
    plane: the same checks with the same details, and the same fired
    sensor-fault schedule."""
    runs = {}
    for pkg in ("jax", "port"):
        checks = []
        check = lambda name, ok, detail="": checks.append((name, bool(ok), str(detail)))  # noqa: E731
        sc, plane_mod = ((JAX_SCENARIOS, jax_chaos) if pkg == "jax" else (SCENARIOS, chaos))
        sc = sc["autoscale-flap-damping"]
        plane = plane_mod.FaultPlane.from_spec(sc.spec)
        plane_mod.install(plane)
        try:
            sc.fn(tmp_path, check)
        finally:
            plane_mod.uninstall()
        runs[pkg] = checks, plane.schedule()
    assert runs["port"] == runs["jax"]
    assert all(ok for _, ok, _ in runs["port"][0]) and runs["port"][1]
