"""The stacked route's loss fallback in the port, on the CPU.

``FallbackSupervisor`` against the JAX package's on the same scripted
lease timeline, each on its own package's ``InProcBus``: neither fires
during the registration race or while the watched worker beats, both
fire once when its lease dies, and both journal the same
``serving/fallback`` record; the port's exits quietly once its
multiprocessing bus's manager is gone. Then ``stacked-worker-loss-
fallback`` through the port's chaos runner: a spawned stacked worker
kills itself on its second forward, and all seven of the JAX package's
checks pass.
"""

import time

import pytest
import torch

from rafiki_tpu import telemetry as jax_telemetry
from rafiki_tpu.bus import InProcBus as JaxBus
from rafiki_tpu.obs.journal import journal as jax_journal, read_dir as jax_read_dir
from rafiki_tpu.worker.fallback import FallbackSupervisor as JaxSupervisor
from rafiki_tpu_torch import chaos, telemetry
from rafiki_tpu_torch.bus import InProcBus, make_mp_bus
from rafiki_tpu_torch.chaos.runner import format_report, run_scenario
from rafiki_tpu_torch.obs.journal import journal, read_dir
from rafiki_tpu_torch.worker.fallback import FallbackSupervisor

torch.set_num_threads(2)

TTL_S = 0.4
POLL_S = 0.05
SEVEN = ["no_request_dropped", "stacked_worker_sigkilled", "fallback_supervisor_fired",
         "blackout_reroute_engaged", "journal_records_fallback",
         "journal_records_blackout_retry", "kill_journaled_from_child"]


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    jax_telemetry.reset()
    yield
    journal.close()
    jax_journal.close()


def test_supervisor_fires_once_on_lease_death_as_the_jax_packages(tmp_path):
    pkgs = {"jax": (JaxBus(), JaxSupervisor), "port": (InProcBus(), FallbackSupervisor)}
    jax_journal.configure(tmp_path / "jax", role="test")
    journal.configure(tmp_path / "port", role="test")
    spawned = {name: [] for name in pkgs}
    sups = {name: sup_cls(bus, "job", "stacked-w0",
                          lambda name=name: spawned[name].append(time.monotonic()),
                          ttl_s=TTL_S, poll_s=POLL_S).start()
            for name, (bus, sup_cls) in pkgs.items()}
    try:
        time.sleep(6 * POLL_S)  # the registration race: nothing to watch yet
        seen = {name: sup.fired.is_set() for name, sup in sups.items()}
        for bus, _ in pkgs.values():
            bus.add_worker("job", "stacked-w0")
        t_end = time.monotonic() + 4 * TTL_S
        while time.monotonic() < t_end:  # beating: the lease stays fresh
            for bus, _ in pkgs.values():
                bus.heartbeat("job", "stacked-w0")
            time.sleep(POLL_S)
        beating = {name: sup.fired.is_set() for name, sup in sups.items()}
        t_dead = time.monotonic()  # the beats stop: the lease dies
        for sup in sups.values():
            assert sup.fired.wait(10 * TTL_S)
        time.sleep(4 * POLL_S)
    finally:
        for sup in sups.values():
            sup.stop()
    assert seen == beating == {"jax": False, "port": False}
    assert {name: len(v) for name, v in spawned.items()} == {"jax": 1, "port": 1}
    assert all(TTL_S * 0.5 <= v[0] - t_dead <= 8 * TTL_S for v in spawned.values())
    assert telemetry.get_counter("serving.fallbacks") == \
        jax_telemetry.get_counter("serving.fallbacks") == 1.0
    jax_journal.close()
    journal.close()
    recs = {name: [{k: v for k, v in r.items() if k not in ("ts", "pid")}
                   for r in read(tmp_path / name) if r["kind"] == "serving"]
            for name, read in (("jax", jax_read_dir), ("port", read_dir))}
    assert recs["port"] == recs["jax"] == [
        {"role": "test", "kind": "serving", "name": "fallback", "job_id": "job",
         "lost_worker": "stacked-w0", "route": "replicated"}]


def test_supervisor_exits_quietly_when_the_bus_manager_is_gone():
    bus = make_mp_bus()
    fired = []
    sup = FallbackSupervisor(bus, "job", "stacked-w0", lambda: fired.append(1),
                             ttl_s=TTL_S, poll_s=POLL_S).start()
    bus.add_worker("job", "stacked-w0")
    time.sleep(4 * POLL_S)
    bus.close()
    sup._thread.join(5.0)
    assert not sup._thread.is_alive() and not sup.fired.is_set() and fired == []


def test_stacked_worker_loss_fallback_passes_its_seven_checks():
    report = run_scenario("stacked-worker-loss-fallback", device="cpu")
    assert report.passed, format_report(report)
    assert [c.name for c in report.checks] == SEVEN
    assert chaos.active() is None
