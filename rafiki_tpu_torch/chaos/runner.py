"""Scenario runner: install the fault plane, run the body, report.

The port's own copy of ``rafiki_tpu/chaos/runner.py`` (``run_scenario``,
``run_scenarios``, ``format_report``, ``_journal_checks`` and the env
save and restore). One scenario run: set ``RAFIKI_CHAOS`` (subprocesses
inherit it) plus the scenario's extra env, install a freshly parsed
:class:`FaultPlane` in THIS process, reset telemetry and the goodput
ledger so invariants read from zero, run the body
in a temporary directory with a journal of its own, on the run's device
(``utils.backend.default_device``: the card unless the CPU is asked
for), then restore everything: env, plane and journal, so nothing leaks
into the caller. The report carries every invariant's verdict and the
plane's fired-fault schedule (the replay surface: same seed, same
schedule).

Telemetry: each run is a ``chaos.scenario`` span, its wall lands in the
``chaos.scenario_s`` histogram and, for a scenario that recovers from a
fault rather than surfacing one, in ``chaos.recovery_s``; the plane
counts ``chaos.injected`` itself.

Before the plane is installed, the serving twin forecasts what the spec
should do to serving (``_twin_pregate``, ``obs/twin/pregate.py``); the
report carries it as ``twin_forecast``, None for a spec that touches no
serving site.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.chaos.plane import ENV_VAR, FaultPlane, install, uninstall
from rafiki_tpu_torch.chaos.scenarios import SCENARIOS
from rafiki_tpu_torch.obs import journal as journal_mod
from rafiki_tpu_torch.obs.journal import journal
from rafiki_tpu_torch.utils.backend import DeviceLike, default_device

# Scenarios whose pass means "the system RECOVERED" (not "the failure
# surfaced correctly"): their duration feeds the recovery histogram.
_RECOVERY_SCENARIOS = frozenset({"checkpoint-write-failure", "drain-under-load",
                                 "load-spike-scale-up"})

# The scenarios that SIGKILL ProcessScheduler workers must be
# reconstructible from the journals alone: after the run, _journal_checks
# reads the death and recovery story back out of the merged files. (The
# sweep-supervisor kills check their own journal story.)
_JOURNALED_SCENARIOS = frozenset({"kill-mid-trial-resume", "kill-mid-pack-resume",
                                  "collective-kill-mid-step"})


@dataclasses.dataclass
class CheckResult:
    name: str
    ok: bool
    detail: str = ""


@dataclasses.dataclass
class ScenarioReport:
    name: str
    passed: bool
    checks: List[CheckResult]
    schedule: List[tuple]          # fired faults: (site, mode, hit, key)
    duration_s: float
    error: Optional[str] = None    # traceback if the body raised
    # Last flight record dumped during the run (the scenario's temporary
    # directory is gone by the time the report is read, so the payload is
    # carried, not the path). None when nothing dumped.
    flight_record: Optional[dict] = None
    # The serving twin's forecast of the spec (obs/twin/pregate.py),
    # simulated offline BEFORE injection. None for specs that touch no
    # serving site, or if forecasting failed.
    twin_forecast: Optional[dict] = None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "passed": self.passed,
            "duration_s": round(self.duration_s, 3),
            "checks": [dataclasses.asdict(c) for c in self.checks],
            "schedule": [list(s) for s in self.schedule],
            "error": self.error,
            "flight_record": ({"reason": self.flight_record.get("reason"),
                               "role": self.flight_record.get("role"),
                               "pid": self.flight_record.get("pid")}
                              if self.flight_record else None),
            "twin_forecast": self.twin_forecast,
        }


def _set_env(values: Dict[str, str]) -> Dict[str, Optional[str]]:
    saved: Dict[str, Optional[str]] = {}
    for k, v in values.items():
        saved[k] = os.environ.get(k)
        os.environ[k] = v
    return saved


def _restore_env(saved: Dict[str, Optional[str]]) -> None:
    for k, old in saved.items():
        if old is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = old


def run_scenario(name: str, device: DeviceLike = None) -> ScenarioReport:
    """Run one scenario on ``device`` (the card unless the CPU is asked
    for) and report it."""
    sc = SCENARIOS.get(name)
    if sc is None:
        raise KeyError(f"unknown chaos scenario {name!r}; one of {sorted(SCENARIOS)}")
    checks: List[CheckResult] = []

    def check(cname: str, ok, detail="") -> None:
        checks.append(CheckResult(cname, bool(ok), str(detail)))

    plane = FaultPlane.from_spec(sc.spec)  # parse FIRST: typos fail loudly
    twin_forecast = _twin_pregate(sc.spec)
    saved = _set_env(dict(sc.env, **{ENV_VAR: sc.spec}))
    install(plane)
    telemetry.reset()
    from rafiki_tpu_torch.obs.ledger import ledger

    ledger.reset()  # goodput buckets read from zero, like the counters
    # The runner's journal is re-pointed into each scenario's directory;
    # remember where it was, so nothing leaks into the caller.
    prev_journal_dir = journal.log_dir if journal.configured else None
    prev_journal_role = journal.role
    flight: Optional[dict] = None
    error: Optional[str] = None
    t0 = time.monotonic()
    try:
        with telemetry.span("chaos.scenario", scenario=name), default_device(device):
            with tempfile.TemporaryDirectory(prefix=f"chaos-{name}-") as td:
                log_dir = Path(td) / "obs"
                saved_log = _set_env({journal_mod.ENV_VAR: str(log_dir)})
                journal.configure(log_dir, role="chaos-runner")
                try:
                    sc.fn(Path(td), check)
                finally:
                    _restore_env(saved_log)
                flights = sorted(log_dir.glob("flight-*.json"))
                if flights:
                    try:
                        flight = json.loads(flights[-1].read_text())
                    except (OSError, json.JSONDecodeError):
                        flight = None
                if name in _JOURNALED_SCENARIOS:
                    _journal_checks(check, log_dir, flights)
    except Exception:
        error = traceback.format_exc()
    finally:
        _restore_env(saved)
        uninstall()
        if prev_journal_dir is not None:
            journal.configure(prev_journal_dir, role=prev_journal_role)
        else:
            journal.close()
    duration = time.monotonic() - t0
    telemetry.observe("chaos.scenario_s", duration)
    if name in _RECOVERY_SCENARIOS:
        telemetry.observe("chaos.recovery_s", duration)
    passed = error is None and bool(checks) and all(c.ok for c in checks)
    return ScenarioReport(name=name, passed=passed, checks=checks,
                          schedule=plane.schedule(), duration_s=duration,
                          error=error, flight_record=flight,
                          twin_forecast=twin_forecast)


def _twin_pregate(spec: str) -> Optional[dict]:
    """Ask the serving twin what this spec should do to serving before
    injecting it for real. Advisory only: any failure degrades to None,
    since the pre-gate must never break the scenario it pre-games. Runs
    before install() and telemetry.reset(), so the forecast's simulated
    chaos decisions cannot pollute the scenario's counters."""
    try:
        from rafiki_tpu_torch.obs.twin import pregate
        return pregate.forecast(spec)
    except Exception:
        return None


def _journal_checks(check, log_dir: Path, flights: List[Path]) -> None:
    """The journals-alone story of a kill scenario: the merged journal
    files must show the injection, the death and the trial lifecycle,
    across the runner and at least one worker, and the scheduler must
    have dumped a flight record for the dead child."""
    recs = journal_mod.read_dir(log_dir)
    pids = {r.get("pid") for r in recs}
    check("journal_multi_process", len(pids) >= 2, f"records from {len(pids)} pid(s)")
    check("journal_records_kill_injection",
          any(r.get("kind") == "chaos" and r.get("mode") == "kill" for r in recs),
          "no chaos/injected kill record in the journals")
    ev = {r.get("name") for r in recs if r.get("kind") == "event"}
    check("journal_records_trial_lifecycle", {"trial_started", "trial_completed"} <= ev,
          f"event names journaled: {sorted(ev)}")
    check("journal_records_worker_death", "worker_died" in ev,
          f"event names journaled: {sorted(ev)}")
    check("flight_record_dumped", bool(flights), f"no flight-*.json under {log_dir}")


def run_scenarios(names: Optional[List[str]] = None,
                  device: DeviceLike = None) -> List[ScenarioReport]:
    return [run_scenario(n, device) for n in (names or sorted(SCENARIOS))]


def format_report(report: ScenarioReport) -> str:
    lines = [f"{'PASS' if report.passed else 'FAIL'}  {report.name}  "
             f"({report.duration_s:.1f}s)"]
    for c in report.checks:
        mark = "ok " if c.ok else "FAIL"
        tail = f"  -- {c.detail}" if (c.detail and not c.ok) else ""
        lines.append(f"  [{mark}] {c.name}{tail}")
    if report.schedule:
        lines.append(f"  injected ({len(report.schedule)} faults):")
        shown = report.schedule[:10]
        for site, mode, hit, key in shown:
            lines.append(f"    {site}:{mode} hit={hit} key={key!r}")
        if len(report.schedule) > len(shown):
            lines.append(f"    ... {len(report.schedule) - len(shown)} more")
    else:
        lines.append("  injected: (none fired)")
    if report.error:
        lines.append("  scenario raised:")
        lines.extend(f"    {line}" for line in report.error.splitlines())
    return "\n".join(lines)
