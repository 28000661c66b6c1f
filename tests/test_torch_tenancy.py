"""The port's tenancy package against the JAX package's, on the CPU.

``tests/test_tenancy.py``'s cases of the QoS directory, weighted-fair
admission with per-tenant quotas, bounded accounting, LRU residency and
the program host run once per package on the same inputs: the same
grants in the same order, the same sheds and reasons, the same journal
records (every field but the clock's: ``ts``, ``pid``, ``role`` and
``load_s``), the same telemetry counters. Then the gateway's tenancy
half: a tenant-aware ``Gateway`` over each package's own bus and worker
charges admissions, sheds and latencies per tenant alike, its
``serving/request`` records carry the tenant, ``drain`` flushes the
summary, ``sensors()`` has the same keys, and the port's HTTP predictor
takes the tenant from ``X-Rafiki-Tenant`` or the body's ``"tenant"``.

Exact comparisons: no tolerance applies. Every wait is bounded.
"""

import threading
import time
import types

import pytest
import torch

from rafiki_tpu import telemetry as jax_telemetry
from rafiki_tpu import tenancy as jax_tenancy
from rafiki_tpu.gateway import Gateway as JaxGateway, GatewayConfig as JaxGatewayConfig
from rafiki_tpu.gateway.admission import ShedError as JaxShedError
from rafiki_tpu.obs import journal as jax_journal_mod
from rafiki_tpu_torch import telemetry as port_telemetry
from rafiki_tpu_torch import tenancy as port_tenancy
from rafiki_tpu_torch.gateway import Gateway, GatewayConfig
from rafiki_tpu_torch.gateway.admission import ShedError
from rafiki_tpu_torch.obs import journal as port_journal_mod
from tests.test_gateway import _SlowConst
from tests.test_torch_gateway import JOB, PACKAGES as GW_PACKAGES, PredictorServer, Serving, http

torch.set_num_threads(2)

PKGS = {
    "jax": types.SimpleNamespace(t=jax_tenancy, telemetry=jax_telemetry, journal=jax_journal_mod,
                                 shed=JaxShedError, gateway=JaxGateway,
                                 config=JaxGatewayConfig, gw=GW_PACKAGES["jax"]),
    "port": types.SimpleNamespace(t=port_tenancy, telemetry=port_telemetry,
                                  journal=port_journal_mod, shed=ShedError, gateway=Gateway,
                                  config=GatewayConfig, gw=GW_PACKAGES["port"]),
}
#: Journal fields the clock or the process writes.
CLOCK_FIELDS = {"ts", "pid", "role", "load_s", "trace_id"}


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    for pkg in PKGS.values():
        pkg.telemetry.reset()
    yield
    for pkg in PKGS.values():
        pkg.telemetry.reset()


def both(case, tmp_path=None):
    """``case(pkg)`` once per package; with ``tmp_path``, each run
    journals to its own directory and returns (result, records)."""
    out = {}
    for name, pkg in PKGS.items():
        if tmp_path is None:
            out[name] = case(pkg)
            continue
        d = tmp_path / name
        pkg.journal.journal.configure(d, role="test")
        try:
            result = case(pkg)
        finally:
            pkg.journal.journal.close()
        recs = [{k: v for k, v in r.items() if k not in CLOCK_FIELDS}
                for r in pkg.journal.read_dir(d)]
        out[name] = (result, recs)
    return out


def _directory(pkg, **kw):
    kw.setdefault("tiers", {"alice": "gold", "bob": "batch"})
    return pkg.t.TenantDirectory(**kw)


def wait_until(cond, what, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, f"{what} not reached in {timeout_s}s"
        time.sleep(0.005)


# -- qos ---------------------------------------------------------------------


def _tiers(pkg):
    d = _directory(pkg, default_tier="std")
    return ({t: d.tier_of(t).name for t in ("alice", "bob", "stranger", None)},
            {k: (v.weight, v.deadline_s, v.p99_budget_ms) for k, v in pkg.t.TIERS().items()},
            d.quota_frac, d.max_tenants, d.unweighted)


def test_directory_resolves_tiers_and_defaults_alike():
    got = both(_tiers)
    assert got["port"] == got["jax"]
    names, tiers, quota, cap, unweighted = got["port"]
    assert names == {"alice": "gold", "bob": "batch", "stranger": "std", None: "std"}
    assert tiers["gold"][0] > tiers["std"][0] > tiers["batch"][0]
    assert tiers["gold"][2] < tiers["batch"][2]
    assert (quota, cap, unweighted) == (0.5, 64, False)


def test_env_knobs_read_alike(monkeypatch):
    monkeypatch.setenv("RAFIKI_TENANT_TIERS", " alice=GOLD, bob = batch,junk,eve=platinum")
    monkeypatch.setenv("RAFIKI_TENANT_DEFAULT_TIER", "batch")
    monkeypatch.setenv("RAFIKI_TENANT_GOLD_WEIGHT", "8")
    monkeypatch.setenv("RAFIKI_TENANT_QUOTA_FRAC", "0.01")
    monkeypatch.setenv("RAFIKI_TENANT_MAX_TENANTS", "7")

    def read(pkg):
        d = pkg.t.TenantDirectory()
        return (d.known_tenants(), d.default_tier, d.quota_frac, d.max_tenants,
                d.tier_of("alice").weight, d.tier_of("eve").name)

    got = both(read)
    assert got["port"] == got["jax"] == ({"alice": "gold", "bob": "batch"}, "batch", 0.05, 7,
                                         8.0, "batch")


def test_unweighted_knob_flattens_weights_alike(monkeypatch):
    monkeypatch.setenv("RAFIKI_TENANT_UNWEIGHTED", "1")

    def read(pkg):
        d = _directory(pkg)
        return ({k: v.weight for k, v in pkg.t.TIERS().items()}, d.unweighted, d.quota_frac)

    got = both(read)
    assert got["port"] == got["jax"] == ({"gold": 1.0, "std": 1.0, "batch": 1.0}, True, 1.0)


# -- admission ---------------------------------------------------------------


def _quota_case(pkg):
    """bob fills his inflight quota (1 of 2) and his queue quota (2 of
    4); his next request sheds ``tenant_quota`` while alice admits."""
    ctl = pkg.t.TenantAdmissionController(_directory(pkg, quota_frac=0.5),
                                          max_inflight=2, max_queue=4)
    ctl.admit(time.monotonic() + 5.0, tenant="bob")
    waits = []
    started = threading.Barrier(3, timeout=5.0)

    def waiter():
        started.wait()
        waits.append(ctl.admit(time.monotonic() + 5.0, tenant="bob"))

    ths = [threading.Thread(target=waiter, daemon=True) for _ in range(2)]
    for th in ths:
        th.start()
    started.wait()
    wait_until(lambda: ctl.tenant_waiting("bob") == 2, "bob's waiters queued")
    with pytest.raises(pkg.shed) as ei:
        ctl.admit(time.monotonic() + 5.0, tenant="bob")
    ctl.admit(time.monotonic() + 5.0, tenant="alice")
    alice_inflight = ctl.tenant_inflight("alice")
    ctl.release(tenant="alice")
    for want in (1, 2):
        ctl.release(tenant="bob")
        wait_until(lambda: len(waits) >= want, "bob's waiter admitted")
    ctl.release(tenant="bob")
    for th in ths:
        th.join(timeout=5.0)
    return (ei.value.reason, alice_inflight, len(waits), ctl.quota_inflight, ctl.quota_queue,
            ctl.inflight, ctl.waiting)


def test_quota_shed_charged_to_the_flooder_alike():
    got = both(_quota_case)
    assert got["port"] == got["jax"] == ("tenant_quota", 1, 2, 1, 2, 0, 0)


def _weighted_case(pkg):
    """Both tenants at inflight 1; bob queues first, yet the freed slot
    goes to alice (charge 0/4 against bob's 1/1)."""
    ctl = pkg.t.TenantAdmissionController(_directory(pkg, quota_frac=1.0),
                                          max_inflight=2, max_queue=8)
    ctl.admit(time.monotonic() + 5.0, tenant="alice")
    ctl.admit(time.monotonic() + 5.0, tenant="bob")
    order = []

    def waiter(tenant):
        ctl.admit(time.monotonic() + 5.0, tenant=tenant)
        order.append(tenant)

    tb = threading.Thread(target=waiter, args=("bob",), daemon=True)
    ta = threading.Thread(target=waiter, args=("alice",), daemon=True)
    tb.start()
    wait_until(lambda: ctl.tenant_waiting("bob") == 1, "bob queued")
    ta.start()
    wait_until(lambda: ctl.tenant_waiting("alice") == 1, "alice queued")
    ctl.release(tenant="alice")
    wait_until(lambda: len(order) == 1, "the freed slot granted")
    first = list(order)
    ctl.release(tenant="bob")
    wait_until(lambda: len(order) == 2, "the second slot granted")
    for th in (ta, tb):
        th.join(timeout=5.0)
    ctl.release(tenant="alice")
    ctl.release(tenant="bob")
    return first, sorted(order), ctl.inflight


def test_weighted_grant_prefers_lower_charge_per_weight_alike():
    got = both(_weighted_case)
    assert got["port"] == got["jax"] == (["alice"], ["alice", "bob"], 0)


def test_unweighted_grant_is_global_fifo_alike(monkeypatch):
    """The doctored polarity: the same race goes to bob, who queued
    first, and no tenant quota sheds."""
    monkeypatch.setenv("RAFIKI_TENANT_UNWEIGHTED", "1")
    got = both(_weighted_case)
    assert got["port"] == got["jax"] == (["bob"], ["alice", "bob"], 0)


def _bounded_case(pkg):
    ctl = pkg.t.TenantAdmissionController(_directory(pkg, tiers={}, max_tenants=8),
                                          max_inflight=4, max_queue=4)
    sizes = []
    for i in range(100):
        t = f"rotating-{i}"
        ctl.admit(time.monotonic() + 1.0, tenant=t)
        ctl.release(tenant=t)
        sizes.append(len(ctl._slots))
    ctl.admit(time.monotonic() + 1.0)  # untagged: the anonymous bucket
    anon = ctl.tenant_inflight(pkg.t.ANON_TENANT)
    ctl.release()
    return max(sizes), sizes[-1], anon


def test_admission_state_stays_bounded_alike():
    got = both(_bounded_case)
    assert got["port"] == got["jax"]
    assert got["port"][0] <= 8 and got["port"][2] == 1


# -- accounting --------------------------------------------------------------


def _map_case(pkg):
    m = pkg.t.BoundedTenantMap(cap=3, factory=dict)
    for t in ("a", "b", "c"):
        m.get(t)
    m.get("a")
    m.get("d")
    return (sorted(t for t, _ in m.items()), len(m), m.peek("b"),
            pkg.telemetry.get_counter("tenant.accounting_evictions"))


def test_bounded_tenant_map_evicts_lru_alike():
    got = both(_map_case)
    assert got["port"] == got["jax"] == (["a", "c", "d"], 3, None, 1)


def _accounting_case(pkg):
    acc = pkg.t.TenantAccounting(_directory(pkg))
    for i in range(20):
        acc.admitted("alice", waited_s=0.001 * i)
        acc.completed("alice", e2e_s=0.01 + 0.001 * i, ok=i != 7)
    acc.shed("bob", "tenant_quota")
    acc.shed("bob", "queue_full")
    acc.admitted("bob", waited_s=0.5)
    acc.completed("bob", e2e_s=6.0, ok=True)  # past batch's 5 s budget
    acc.flush()
    snap = {k: pkg.telemetry.get_counter(k) for k in (
        "serving.tenant.admitted", "serving.tenant.shed", "serving.tenant.shed_batch")}
    return (acc.per_tenant(), round(acc.burn("alice"), 6), round(acc.max_burn(), 6),
            round(acc.shed_rate(), 6), snap, pkg.telemetry.get_gauge("serving.tenant.burn"),
            {k: v for k, v in acc.collector().items() if k != "per_tenant"})


def test_accounting_burn_summary_and_journal_alike(tmp_path):
    got = both(_accounting_case, tmp_path)
    assert got["port"] == got["jax"]
    (per, burn_alice, max_burn, shed_rate, counters, gauge, _), recs = got["port"]
    assert per["alice"]["admitted"] == 20 and per["alice"]["errors"] == 1
    assert per["bob"]["shed_reasons"] == {"tenant_quota": 1, "queue_full": 1}
    assert burn_alice < 1.0 < max_burn == gauge
    assert counters["serving.tenant.shed"] == counters["serving.tenant.shed_batch"] == 2
    names = [(r["kind"], r["name"]) for r in recs]
    assert names.count(("tenant", "admit")) == 21 and names[-1] == ("tenant", "summary")
    assert recs[-1]["tenants"]["bob"] == {"admitted": 1, "shed": 2, "p99_ms": 6000.0,
                                          "burn": 1.2}


# -- residency + hosting -----------------------------------------------------


class _TagModel:
    def __init__(self, tag):
        self.tag = tag
        self.destroyed = False

    def predict(self, queries):
        return [f"{self.tag}:{q}" for q in queries]

    def destroy(self):
        self.destroyed = True


def _residency_case(pkg):
    rm = pkg.t.ResidencyManager(budget_bytes=100)
    a, b = _TagModel("A"), _TagModel("B")
    out = [rm.activate("jobA", 80, lambda: a) is a,
           rm.activate("jobA", 80, lambda: a) is a,
           rm.activate("jobB", 80, lambda: b) is b,
           a.destroyed, b.destroyed, rm.used_bytes()]
    with pytest.raises(MemoryError):
        rm.activate("huge", 101, lambda: _TagModel("X"))
    out.append(rm.resident_keys())
    stats = rm.stats()
    rm.drain()
    out += [stats, b.destroyed, rm.resident_keys()]
    return out


def test_residency_lru_swap_journaled_alike(tmp_path):
    got = both(_residency_case, tmp_path)
    assert got["port"] == got["jax"]
    result, recs = got["port"]
    assert result[:7] == [True, True, True, True, False, 80, ["jobB"]]
    assert [r["event"] for r in recs if r["kind"] == "tenancy"] == [
        "activate", "hit", "evict", "activate", "evict"]
    assert recs[2] == {"kind": "tenancy", "name": "residency", "event": "evict",
                       "program": "jobA", "size_bytes": 80, "used_bytes": 0,
                       "for_program": "jobB"}


def test_default_budget_reads_the_env_alike(monkeypatch):
    monkeypatch.setenv("RAFIKI_TENANT_HBM_BUDGET_MB", "3")
    got = both(lambda pkg: pkg.t.ResidencyManager().budget_bytes)
    assert got["port"] == got["jax"] == 3 << 20
    monkeypatch.delenv("RAFIKI_TENANT_HBM_BUDGET_MB")
    got = both(lambda pkg: pkg.t.ResidencyManager().budget_bytes)
    assert got["port"] == got["jax"] == 512 << 20


class _Broken:
    def predict(self, queries):
        raise RuntimeError("boom")


def _host_case(pkg):
    host = pkg.t.ProgramHost([
        pkg.t.ProgramSpec("jobA", lambda: _TagModel("A"), 60),
        pkg.t.ProgramSpec("jobB", lambda: _TagModel("B"), 60),
        pkg.t.ProgramSpec("jobC", _Broken, 60),
    ], residency=pkg.t.ResidencyManager(budget_bytes=130))
    w = pkg.t.wrap_query
    out = [host.predict([w("jobA", "x"), w("jobB", "y"), w("jobA", "z"), "bare"]),
           host.predict([w("jobC", "q"), w("jobB", "r")]),
           host.program_ids(), host.residency.resident_keys()]
    with pytest.raises(ValueError):
        pkg.t.ProgramHost([pkg.t.ProgramSpec("a", lambda: None, 1)], default_program="zz")
    host.destroy()
    out += [host.residency.resident_keys(),
            pkg.telemetry.get_counter("tenancy.host_queries"),
            pkg.telemetry.get_counter("tenancy.host_errors"), pkg.t.PROGRAM_KEY]
    return out


def test_program_host_routes_by_program_tag_alike(tmp_path):
    got = both(_host_case, tmp_path)
    assert got["port"] == got["jax"]
    result, recs = got["port"]
    assert result[0] == ["A:x", "B:y", "A:z", "A:bare"]
    assert result[1] == [{"error": "boom"}, "B:r"]
    assert result[4:7] == [[], 6, 1]


# -- the gateway's tenancy half ----------------------------------------------


def _gateway_case(pkg):
    """A tenant-aware gateway (one inflight slot, no queue) over one
    slow worker: alice's request holds the slot while bob's and an
    anonymous one shed (``queue_full``), then a drain; returns the sheds,
    the stats and the sensor keys."""
    serving = Serving(pkg.gw, [_SlowConst([0.25, 0.75], delay_s=0.3)])
    fabric = pkg.t.TenantFabric(_directory(pkg))
    try:
        predictor = pkg.gw.predictor(serving.bus, JOB, timeout_s=5.0)
        gw = pkg.gateway(predictor, pkg.config(max_inflight=1, max_queue=0, min_replies=1),
                         tenancy=fabric)
        assert isinstance(gw.admission, pkg.t.TenantAdmissionController)
        out = {}
        th = threading.Thread(target=lambda: out.setdefault(
            "alice", gw.predict([[1.0]], tenant="alice")), daemon=True)
        th.start()
        wait_until(lambda: gw.admission.inflight == 1, "alice admitted")
        sheds = []
        for tenant in ("bob", None):
            try:
                gw.predict([[1.0]], tenant=tenant)
            except pkg.shed as e:
                sheds.append((tenant, e.reason))
        th.join(timeout=10)
        gw.predict([[2.0]], tenant="bob", deadline_s=3.0)
        gw.drain(timeout=5.0)
        try:
            gw.predict([[3.0]], tenant="alice")
        except pkg.shed as e:
            sheds.append(("alice", e.reason))
        sensors = gw.sensors()
        stats = fabric.accounting.per_tenant()
        gw_close = getattr(gw, "close", None)
        if gw_close is not None:
            gw_close()
        return (out["alice"], sheds, {t: (r["admitted"], r["shed"], r["shed_reasons"], r["tier"])
                                      for t, r in stats.items()},
                sorted(sensors), sensors["tenants_tracked"])
    finally:
        serving.close()


def test_gateway_charges_tenants_alike(tmp_path):
    got = both(_gateway_case, tmp_path)
    (result, recs), (want, want_recs) = got["port"], got["jax"]
    assert result == want
    assert result[1] == [("bob", "queue_full"), (None, "queue_full"), ("alice", "draining")]
    assert result[2] == {"alice": (1, 1, {"draining": 1}, "gold"),
                         "bob": (1, 1, {"queue_full": 1}, "batch"),
                         "anon": (0, 1, {"queue_full": 1}, "std")}
    assert {"tenant_burn", "tenant_shed_rate", "tenants_tracked"} <= set(result[3])

    def tenant_view(rs):
        return [(r["kind"], r["name"], r.get("tenant"), r.get("reason"), r.get("tier"))
                for r in rs if r["kind"] == "tenant"
                or (r["kind"], r["name"]) in {("serving", "request"), ("gateway", "shed")}]

    assert tenant_view(recs) == tenant_view(want_recs)
    assert [r["tenant"] for r in recs if (r["kind"], r["name"]) == ("serving", "request")] == [
        "alice", "bob"]
    [cfg] = [r for r in recs if (r["kind"], r["name"]) == ("gateway", "config")]
    [want_cfg] = [r for r in want_recs if (r["kind"], r["name"]) == ("gateway", "config")]
    assert cfg["tenants_enabled"] is want_cfg["tenants_enabled"] is True
    assert cfg["tenant_quota_frac"] == want_cfg["tenant_quota_frac"] == 0.5
    # drain() flushed the summary; the post-drain shed comes after it.
    [summary] = [r for r in recs if r["name"] == "summary"]
    assert [(r["kind"], r["name"]) for r in recs[recs.index(summary) + 1:]] == [
        ("gateway", "shed"), ("tenant", "shed")]
    assert {t: (v["admitted"], v["shed"]) for t, v in summary["tenants"].items()} == {
        "alice": (1, 0), "bob": (1, 1), "anon": (0, 1)}


def test_http_tenant_header_and_body_key(tmp_path):
    """The port's predictor app charges the ``X-Rafiki-Tenant`` header,
    else the body's ``"tenant"``, else the anonymous tenant."""
    pkg = PKGS["port"]
    serving = Serving(pkg.gw, [_SlowConst([0.5, 0.5])])
    pkg.journal.journal.configure(tmp_path, role="test")
    fabric = pkg.t.TenantFabric(_directory(pkg))
    try:
        gw = Gateway(pkg.gw.predictor(serving.bus, JOB, timeout_s=5.0),
                     GatewayConfig(min_replies=1), tenancy=fabric)
        srv = PredictorServer("port", gw)
        try:
            import urllib.request

            req = urllib.request.Request(f"{srv.url}/predict", method="POST",
                                         data=b'{"queries": [[1.0]], "tenant": "bob"}',
                                         headers={"Content-Type": "application/json",
                                                  "X-Rafiki-Tenant": "alice"})
            opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
            with opener.open(req, timeout=30) as r:
                assert r.status == 200
            assert http("POST", f"{srv.url}/predict",
                        {"queries": [[1.0]], "tenant": "bob"})[0] == 200
            assert http("POST", f"{srv.url}/predict", {"queries": [[1.0]]})[0] == 200
        finally:
            srv.close()
        gw.drain(timeout=5.0)
        gw.close()
    finally:
        pkg.journal.journal.close()
        serving.close()
    recs = pkg.journal.read_dir(tmp_path)
    assert [r["tenant"] for r in recs if (r["kind"], r["name"]) == ("tenant", "admit")] == [
        "alice", "bob", "anon"]
    assert [r["tenant"] for r in recs if (r["kind"], r["name"]) == ("serving", "request")] == [
        "alice", "bob", None]
