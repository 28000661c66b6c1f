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
records included.
"""

import pytest
import torch

from rafiki_tpu import chaos as jax_chaos
from rafiki_tpu.chaos.scenarios import SCENARIOS as JAX_SCENARIOS
from rafiki_tpu.obs.journal import journal as jax_journal, read_dir as jax_read_dir
from rafiki_tpu.obs.perf import profiler as jax_profiler, slo as jax_slo
from rafiki_tpu.ops.train import clear_program_cache as jax_clear_program_cache
from rafiki_tpu.store import MetaStore as JaxMetaStore
from rafiki_tpu_torch import chaos
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

    assert pairs(got_recs) == pairs(want_recs)
    for pair in [("chaos", "injected"), ("health", "divergence"), ("health", "capsule"),
                 ("flight", "health:divergence"), ("event", "trial_diverged"),
                 ("event", "pack_member_evicted")]:
        assert pair in pairs(got_recs), pair
