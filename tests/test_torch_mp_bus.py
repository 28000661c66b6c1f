"""The port's multiprocessing bus against the JAX package's, on the CPU.

One script of bus operations (registration, a lease that expires, the
janitor, add and pop in batches, queue depth, a quorum gather with
grace, a late reply to a gathered query dropped, the expired-id cap
trimmed oldest first) returns the same values on both packages'
``make_mp_bus``. Then, on the port's bus: a spawn child that registers
and answers, hop chains included; the ``bus.proxy`` chaos site against
the JAX package's; the corpse of a SIGKILLed worker reaped by an
ordinary ``get_workers`` read (``tests/test_serve_elastic.py``'s
janitor case); and, port only, a child SIGKILLed 20 times in the middle
of its bus calls, after each of which every call the parent makes
returns within 5 s. That last case is not run against the JAX package's
bus: its client-held ``Manager.Lock`` stays taken when the holder dies,
and the next call waits forever (the reference fault the port's bus
repairs).
"""

import multiprocessing as mp
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from rafiki_tpu import chaos as jax_chaos, telemetry as jax_telemetry
from rafiki_tpu.bus import make_mp_bus as jax_make_mp_bus
from rafiki_tpu_torch import chaos, telemetry
from rafiki_tpu_torch.bus import make_mp_bus
from rafiki_tpu_torch.obs import context
from tests import test_torch_bus_child as bus_child

torch.set_num_threads(2)

CTX = mp.get_context("spawn")
#: Every call the parent makes after a kill returns within this.
CALL_DEADLINE_S = 5.0


@pytest.fixture(autouse=True)
def _clean_planes():
    telemetry.reset()
    jax_telemetry.reset()
    yield
    chaos.uninstall()
    jax_chaos.uninstall()


def _within(fn, deadline_s=CALL_DEADLINE_S):
    """``fn()`` on a daemon thread joined with a deadline: a call that
    would block forever fails the test instead of hanging it."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 (re-raised in the test's thread)
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    t0 = time.monotonic()
    th.start()
    th.join(deadline_s)
    assert not th.is_alive(), f"{fn} still blocked after {deadline_s}s"
    if "error" in out:
        raise out["error"]
    return out["value"], time.monotonic() - t0


def _script(bus, tel):
    """The bus operations both packages run; returns every result."""
    out = []
    bus.add_worker("j", "a")
    bus.add_worker("j", "b")
    bus.add_worker("j", "a")  # registering twice keeps one entry
    bus.add_worker("k", "c")
    out += [bus.get_workers("j"), bus.get_workers("j", max_age_s=30.0), bus.get_workers("none")]
    for i in range(5):
        bus.add_query("a", f"q{i}", [float(i)])
    bus.add_query("nobody", "qx", [9.0])  # no such worker: dropped
    out += [bus.queue_depth("a"), bus.queue_depth("nobody")]
    out.append(bus.pop_queries("a", max_n=2, timeout=0.5))
    out.append(bus.pop_queries("a", max_n=8, timeout=0.5))
    out.append(bus.pop_queries("a", max_n=8, timeout=0.05))  # empty once the wait ends
    out.append(bus.pop_queries("unregistered", timeout=0.05))
    out.append(bus.queue_depth("a"))
    # A quorum gather with grace: 2 of 3 replies, closed after the grace.
    bus.put_prediction("g1", "a", [0.1])
    bus.put_prediction("g1", "b", [0.2], hops=[["enq", 1.0, 7]])
    t0 = time.monotonic()
    out.append(sorted(bus.get_predictions("g1", n=3, timeout=5.0, min_n=2, grace_s=0.1)))
    out.append(time.monotonic() - t0 < 2.0)
    bus.put_prediction("g1", "c", [0.3])  # late: the query was gathered
    out.append(bus.get_predictions("g1", n=1, timeout=0.05))
    out.append(bus.get_predictions("never", n=1, timeout=0.05))
    # Leases: b and c stop beating, a beats.
    time.sleep(1.0)
    bus.heartbeat("j", "a")
    bus.heartbeat("j", "zz")  # never resurrects
    out += [bus.get_workers("j", max_age_s=0.5), bus.get_workers("j")]
    out.append(bus.reap_stale(0.8, job_id="j"))  # b's corpse
    out.append(bus.get_workers("j"))
    # The auto-janitor: c's lease is past REAP_FACTOR x the TTL.
    out += [bus.get_workers("k", max_age_s=0.1), bus.get_workers("k")]
    out.append(tel.get_counter("bus.reaped_workers"))
    bus.remove_worker("j", "a")
    out += [bus.get_workers("j"), bus.queue_depth("a")]
    # The expired-id cap, trimmed oldest first.
    bus._expired_cap = 3
    for i in range(5):
        bus.get_predictions(f"e{i}", n=1, timeout=0)
    for i in range(5):
        bus.put_prediction(f"e{i}", "w", [float(i)])
    out.append([bus.get_predictions(f"e{i}", n=1, timeout=0) for i in range(5)])
    return out


def _close(bus):
    """Stop a bus's manager: the port's bus owns it, the JAX package's
    is reached through its private handle."""
    if hasattr(bus, "close"):
        bus.close()
    else:
        bus._manager.shutdown()


def test_one_script_returns_the_same_on_both_mp_buses():
    got = {}
    for name, make, tel in (("jax", jax_make_mp_bus, jax_telemetry),
                            ("port", make_mp_bus, telemetry)):
        bus = make()
        try:
            got[name] = _within(lambda: _script(bus, tel), deadline_s=60.0)[0]
        finally:
            _close(bus)
    assert got["port"] == got["jax"]
    assert got["port"][-1] == [[("w", [0.0])], [("w", [1.0])], [], [], []]
    assert got["port"][:3] == [["a", "b"], ["a", "b"], []]


def test_the_bus_pickles_into_a_spawn_child_that_registers_and_answers():
    bus = make_mp_bus()
    proc = None
    try:
        proc = CTX.Process(target=bus_child.answer, args=(bus, "j", "child"), daemon=True)
        proc.start()
        deadline = time.monotonic() + 30
        while "child" not in bus.get_workers("j", max_age_s=30.0):
            assert proc.is_alive(), f"child died before registering: {proc.exitcode}"
            assert time.monotonic() < deadline, "child never registered"
            time.sleep(0.01)
        bus.add_query("child", "plain", [1.0])
        with context.trace("ab" * 16):
            bus.add_query("child", "traced", [2.0])
        plain = _within(lambda: bus.get_predictions("plain", n=1, timeout=4.0))[0]
        traced = _within(lambda: bus.get_predictions("traced", n=1, timeout=4.0))[0]
        assert plain == [("child", proc.pid)]
        ((worker, pid, chain),) = traced
        assert (worker, pid) == ("child", proc.pid)
        assert [m[0] for m in chain] == ["enq", "reply"]
        assert [m[2] for m in chain] == [os.getpid(), proc.pid]
        assert chain[0][1] <= chain[1][1]  # one system-wide monotonic clock
    finally:
        if proc is not None:
            proc.kill()
            proc.join(5)
        bus.close()


@pytest.mark.parametrize("verb", ["get_workers", "add_query", "pop_queries", "put_prediction"])
def test_bus_proxy_faults_fire_in_the_caller_as_in_the_jax_package(verb):
    calls = {
        "get_workers": lambda b: b.get_workers("j", max_age_s=5.0),
        "add_query": lambda b: b.add_query("w", "q", [1.0]),
        "pop_queries": lambda b: b.pop_queries("w", timeout=0),
        "put_prediction": lambda b: b.put_prediction("q", "w", [1.0]),
    }
    got = {}
    for name, make, plane in (("jax", jax_make_mp_bus, jax_chaos), ("port", make_mp_bus, chaos)):
        bus = make()
        try:
            bus.add_worker("j", "w")
            plane.install(plane.FaultPlane.from_spec(f"seed=1;bus.proxy:error:times=1:match={verb}"))
            with pytest.raises(plane.ChaosError):
                calls[verb](bus)
            calls[verb](bus)  # times=1: the next round-trip goes through
            errors = plane.active().schedule()
            plane.install(plane.FaultPlane.from_spec(
                f"seed=1;bus.proxy:delay:delay=0.3:times=1:match={verb}"))
            _, took = _within(lambda: calls[verb](bus))
            got[name] = (errors, plane.active().schedule(), took >= 0.3)
            plane.uninstall()
        finally:
            _close(bus)
    assert got["port"] == got["jax"]
    assert got["port"][2]


def test_sigkilled_worker_corpse_reaped_by_get_workers_janitor():
    """A SIGKILLed worker never runs remove_worker: once its lease is
    REAP_FACTOR x the TTL old, an ordinary ``get_workers(ttl)`` read
    reaps its registration, lease and pending queue."""
    ttl = 0.3
    bus = make_mp_bus()
    proc = None
    try:
        proc = CTX.Process(target=bus_child.squat, args=(bus, "reap-job", "corpse", 0.05),
                           daemon=True)
        proc.start()
        deadline = time.monotonic() + 30
        while "corpse" not in bus.get_workers("reap-job"):
            assert proc.is_alive(), f"squatter died (exit {proc.exitcode})"
            assert time.monotonic() < deadline, "squatter never registered"
            time.sleep(0.02)
        bus.add_query("corpse", "q-leak", [1.0])
        assert bus.queue_depth("corpse") == 1
        os.kill(proc.pid, signal.SIGKILL)
        proc.join(10)
        assert not proc.is_alive()
        deadline = time.monotonic() + 30
        while "corpse" in bus.get_workers("reap-job"):
            bus.get_workers("reap-job", max_age_s=ttl)  # the observing read
            assert time.monotonic() < deadline, "janitor never reaped the corpse"
            time.sleep(0.05)
        assert bus.queue_depth("corpse") == 0, "corpse queue outlived the reap"
        assert telemetry.get_counter("bus.reaped_workers") == 1.0
        bus.heartbeat("reap-job", "corpse")  # a reaped lease stays dead
        assert bus.get_workers("reap-job") == []
    finally:
        if proc is not None and proc.is_alive():
            proc.kill()
            proc.join(5)
        bus.close()


def test_sigkill_during_bus_calls_never_wedges_the_bus():
    """20 SIGKILLs at seeded random moments of a child that calls the bus
    back to back: after each, the parent's reap_stale, get_workers,
    add_query and get_predictions each return within 5 s."""
    rng = np.random.default_rng(14)
    bus = make_mp_bus()
    procs = []
    try:
        bus.add_worker("kill-job", "parent")
        for k in range(20):
            wid = f"hammer-{k}"
            proc = CTX.Process(target=bus_child.hammer, args=(bus, "kill-job", wid),
                               daemon=True)
            procs.append(proc)
            proc.start()
            deadline = time.monotonic() + 30
            while wid not in bus.get_workers("kill-job"):
                assert proc.is_alive(), f"kill {k}: child died early ({proc.exitcode})"
                assert time.monotonic() < deadline, f"kill {k}: child never registered"
                time.sleep(0.005)
            time.sleep(float(rng.uniform(0.0, 0.05)))
            os.kill(proc.pid, signal.SIGKILL)
            proc.join(10)
            assert proc.exitcode == -signal.SIGKILL, f"kill {k}: exit {proc.exitcode}"
            _within(lambda: bus.reap_stale(0.0, job_id="kill-job"))
            fresh, _ = _within(lambda: bus.get_workers("kill-job", max_age_s=60.0))
            assert wid not in fresh
            bus.add_worker("kill-job", "parent")  # the reap above took it too
            _within(lambda: bus.add_query("parent", f"p{k}", [float(k)]))
            bus.put_prediction(f"p{k}", "parent", [float(k)])
            got, _ = _within(lambda: bus.get_predictions(f"p{k}", n=1, timeout=0.5))
            assert got == [("parent", [float(k)])]
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join(5)
        bus.close()
