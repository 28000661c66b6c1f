"""The port's serving gateway against the JAX package's, on the CPU.

Each scenario runs once per package, on the same scripted fake
predictors (``tests/test_gateway.py``'s ``_SlowConst`` stand-in models
on each package's own bus and inference workers, or a package-free
scripted predictor) and with a fake clock where the code takes one.
The two must take the same decisions: admit or shed with the same
reasons, the same breaker transitions, the same microbatch flushes and
members, the same routes, the same drain behaviour. ``stats()`` keeps
every key of the JAX package's; the JAX package's rollup collector
(``serving`` in the telemetry snapshot) belongs to a plane the port
does not have.

Every wait here is bounded: HTTP calls, joins and registration waits
all carry a timeout.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch
from werkzeug.serving import make_server

from rafiki_tpu import gateway as jax_gateway
from rafiki_tpu import telemetry as jax_telemetry
from rafiki_tpu.bus import InProcBus as JaxBus
from rafiki_tpu import tenancy as jax_tenancy
from rafiki_tpu.obs.anatomy import exemplars as jax_exemplars
from rafiki_tpu.ops import train as _jax_ops_train  # noqa: F401 (see below)
from rafiki_tpu.predictor import Predictor as JaxPredictor
from rafiki_tpu.predictor.app import PredictorApp as JaxPredictorApp
from rafiki_tpu.worker.inference import InferenceWorker as JaxWorker
from rafiki_tpu_torch import gateway as port_gateway
from rafiki_tpu_torch import telemetry as port_telemetry
from rafiki_tpu_torch.bus.queues import InProcBus
from rafiki_tpu_torch import tenancy as port_tenancy
from rafiki_tpu_torch.obs.anatomy import exemplars as port_exemplars
from rafiki_tpu_torch.predictor.app import start_predictor_server
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.worker.inference import InferenceWorker
from tests.test_gateway import _SlowConst

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

JOB = "gwjob"
PACKAGES = {
    "jax": types.SimpleNamespace(gw=jax_gateway, telemetry=jax_telemetry, bus=JaxBus,
                                 worker=JaxWorker, predictor=JaxPredictor),
    "port": types.SimpleNamespace(gw=port_gateway, telemetry=port_telemetry, bus=InProcBus,
                                  worker=InferenceWorker, predictor=Predictor),
}
#: Telemetry collectors of planes the port does not have: none (the
#: gateway's per-second serving rollup is compared too).
DROPPED_COLLECTORS = set()


def both(scenario):
    """Run ``scenario(pkg)`` for each package; returns {name: result}."""
    return {name: scenario(pkg) for name, pkg in PACKAGES.items()}


def wait_until(cond, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, f"{what} not reached in {timeout_s}s"
        time.sleep(0.002)


class Serving:
    """k live inference workers of one package on its own bus, plus
    (optionally) a fresh-leased corpse that never answers, as
    ``tests/test_gateway.py`` ``_Serving`` builds them."""

    def __init__(self, pkg, models, corpse=None):
        self.bus = pkg.bus()
        self.stop = threading.Event()
        self.threads = []
        for i, model in enumerate(models):
            w = pkg.worker(self.bus, JOB, f"w{i}", model, stop_event=self.stop)
            self.threads.append(threading.Thread(target=w.run, daemon=True))
        for th in self.threads:
            th.start()
        wait_until(lambda: len(self.bus.get_workers(JOB)) == len(models),
                   what="workers registered")
        self.corpse = corpse
        if corpse is not None:
            self.bus.add_worker(JOB, corpse)
            th = threading.Thread(target=self._beat_corpse, daemon=True)
            self.threads.append(th)
            th.start()

    def _beat_corpse(self):
        while not self.stop.wait(0.2):
            self.bus.heartbeat(JOB, self.corpse)

    def close(self):
        self.stop.set()
        for th in self.threads:
            th.join(timeout=5)
        assert not any(th.is_alive() for th in self.threads)


def http(method, url, body=None, timeout_s=30.0):
    """(status, JSON body, headers) of one request."""
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=timeout_s) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        out = (e.code, json.loads(e.read()), dict(e.headers))
        e.close()
        return out


class PredictorServer:
    """A package's predictor app over real HTTP on a free port."""

    def __init__(self, name, gateway):
        if name == "jax":
            self.server = make_server("127.0.0.1", 0, JaxPredictorApp(gateway), threaded=True)
            self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
            self.thread.start()
            self.url = f"http://127.0.0.1:{self.server.server_port}"
        else:
            self.server, host = start_predictor_server(gateway)
            self.thread = None
            self.url = f"http://{host}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        if self.thread is not None:
            self.thread.join(timeout=10)


def _no_errors(preds):
    return all(not (isinstance(p, dict) and "error" in p) for p in preds)


# -- admission ---------------------------------------------------------------


def _admission_trace(pkg):
    ac = pkg.gw.AdmissionController(max_inflight=1, max_queue=1)

    def attempt(deadline_s):
        try:
            ac.admit(time.monotonic() + deadline_s)
            return "admitted"
        except pkg.gw.ShedError as e:
            return f"shed:{e.reason}"

    def queued():
        got = []
        th = threading.Thread(target=lambda: got.append(attempt(5.0)))
        th.start()
        wait_until(lambda: ac.waiting == 1, what="waiter queued")
        return th, got

    out = [attempt(1.0), attempt(0.05)]          # admitted; then the deadline passes queued
    th, got = queued()
    out.append(attempt(1.0))                     # the queue is full
    ac.release()
    th.join(timeout=5)
    out += got + [("inflight", ac.inflight, "waiting", ac.waiting)]
    th, got = queued()
    ac.close()                                   # drain: the waiter and new arrivals shed
    th.join(timeout=5)
    out += got + [attempt(1.0), ac.wait_idle(0.05)]
    ac.release()
    out += [ac.wait_idle(1.0), ac.inflight, ac.closed]
    return out


def test_admission_admits_and_sheds_alike():
    got = both(_admission_trace)
    assert got["port"] == got["jax"] == [
        "admitted", "shed:deadline", "shed:queue_full", "admitted",
        ("inflight", 1, "waiting", 0), "shed:draining", "shed:draining", False,
        True, 0, True]


# -- circuit breaker ---------------------------------------------------------


def _breaker_trace(pkg):
    pkg.telemetry.reset()
    now = [0.0]
    br = pkg.gw.CircuitBreaker(failure_threshold=2, cooldown_s=5.0, clock=lambda: now[0])
    out = []

    def step(op, *args):
        r = getattr(br, op)(*args)
        out.append((op, r, br.state))

    step("allow")
    step("record_failure")
    step("record_failure")            # threshold: open
    step("allow")
    now[0] = 5.1                      # cooldown over: one probe
    step("allow")
    step("allow")
    step("record_failure")            # the probe missed: open again
    step("allow")
    now[0] = 10.3
    step("allow")
    step("record_success", 0.02)      # closed
    step("record_success", 0.04)
    step("allow")
    out.append(br.snapshot())
    out.append({k: pkg.telemetry.get_counter(f"gateway.breaker_{k}")
                for k in ("opened", "half_open", "closed")})
    return out


def test_breaker_transitions_alike():
    got = both(_breaker_trace)
    assert got["port"] == got["jax"]
    assert [s for _, _, s in got["port"][:-2]] == [
        "closed", "closed", "open", "open", "half-open", "half-open", "open", "open",
        "half-open", "closed", "closed", "closed"]
    assert got["port"][-1] == {"opened": 2, "half_open": 2, "closed": 1}


# -- microbatcher ------------------------------------------------------------


class _Collector:
    """Records every flush the batcher executes and answers members."""

    def __init__(self, fail=False):
        self.flushes = []
        self.lock = threading.Lock()
        self.fail = fail

    def execute(self, members, reason):
        with self.lock:
            self.flushes.append((len(members), sum(len(m.queries) for m in members), reason))
        if self.fail:
            raise RuntimeError("injected flush failure")
        for m in members:
            m.outputs = [f"out-{q}" for q in m.queries]
            m.flush_reason = reason
            m.done.set()


def _submit(pkg, b, queries, deadline_s=5.0):
    return b.submit(queries, time.monotonic() + deadline_s, prefix=[])


def _microbatch_trace(pkg):
    MB = pkg.gw.MicroBatcher
    out = []
    with pytest.raises(ValueError):
        MB(lambda m, r: None, max_batch=1, max_wait_s=0.01)
    with pytest.raises(ValueError):
        pkg.gw.GatewayConfig(max_batch=0)

    def run(max_batch, max_wait_s, script, fail=False, reserve=None):
        col = _Collector(fail=fail)
        b = MB(col.execute, max_batch=max_batch, max_wait_s=max_wait_s,
               **({"reserve_fn": reserve} if reserve else {}))
        try:
            members = script(b)
        finally:
            b.stop()
        return col.flushes, [(m.outputs, m.flush_reason, type(m.error).__name__)
                             for m in members]

    def size(b):
        ms = [_submit(pkg, b, [i]) for i in range(3)]
        assert all(m.wait(5.0) for m in ms)
        return ms

    def solo(b):
        m = _submit(pkg, b, ["solo"])
        assert m.wait(5.0)
        return [m]

    def urgent(b):
        m = _submit(pkg, b, ["urgent"], deadline_s=0.2)
        assert m.wait(5.0)
        return [m]

    def drain(b):
        m = _submit(pkg, b, ["a", "b"])
        assert not m.wait(0.05)
        b.drain()
        assert m.wait(5.0)
        return [m]

    def fifo(b):
        big = _submit(pkg, b, ["q0", "q1", "q2", "q3", "q4"])
        assert big.wait(5.0)
        ms = [_submit(pkg, b, ["a", "b"]), _submit(pkg, b, ["c", "d"]), _submit(pkg, b, ["e"])]
        assert all(m.wait(5.0) for m in ms[:2])
        b.drain()
        assert ms[2].wait(5.0)
        return [big] + ms

    out.append(run(3, 10.0, size))
    out.append(run(64, 0.05, solo))
    out.append(run(64, 30.0, urgent, reserve=lambda: 0.05))
    out.append(run(64, 30.0, drain))
    out.append(run(4, 10.0, fifo))
    out.append(run(2, 0.01, solo, fail=True))
    b = MB(_Collector().execute, max_batch=2, max_wait_s=0.01)
    b.stop()
    with pytest.raises(RuntimeError):
        _submit(pkg, b, ["late"])
    return out


def test_microbatcher_flushes_alike():
    got = both(_microbatch_trace)
    assert got["port"] == got["jax"]
    flushes = [f for f, _ in got["port"]]
    assert flushes == [[(3, 3, "size")], [(1, 1, "deadline")], [(1, 1, "deadline")],
                       [(1, 2, "drain")], [(1, 5, "size"), (2, 4, "size"), (1, 1, "drain")],
                       [(1, 1, "deadline")]]
    assert got["port"][4][1][1] == (["out-a", "out-b"], "size", "NoneType")
    assert got["port"][5][1] == [(None, None, "RuntimeError")]


# -- the gateway on scripted predictors --------------------------------------


class Scripted:
    """A predictor stand-in, the same for both packages: its gathers
    follow ``script`` (replying workers per call, None = every routed
    worker), it records each route, and it can hold a call until
    ``gate`` is set."""

    job_id = "scripted"
    timeout_s = 5.0

    def __init__(self, live=("w0",), script=(), gate=None, depths=None):
        self.live = list(live)
        self.script = list(script)
        self.gate = gate
        self.routes = []
        self.calls = 0
        self.bus = types.SimpleNamespace(queue_depth=lambda w: (depths or {}).get(w, 0))

    def live_workers(self):
        return list(self.live)

    def predict_detailed(self, queries, workers=None, timeout_s=None, min_replies=None,
                         hedge_grace_s=None):
        self.calls += 1
        self.routes.append((list(workers), min_replies))
        if self.gate is not None:
            assert self.gate.wait(10.0), "gate never opened"
        repliers = self.script.pop(0) if self.script else None
        repliers = list(workers) if repliers is None else [w for w in repliers if w in workers]
        n = len(queries)
        return types.SimpleNamespace(
            outputs=([[0.6, 0.4]] * n if repliers else [{"error": "prediction timeout"}] * n),
            workers=list(workers), replies={w: n for w in repliers},
            timeouts=0 if repliers else n, hedged=0)

    predict_batch_detailed = predict_detailed


def _gateway(pkg, predictor, **cfg):
    return pkg.gw.Gateway(predictor, pkg.gw.GatewayConfig(**cfg))


def _blackout_trace(pkg):
    pkg.telemetry.reset()
    out = []
    for script, retries, armed, deadline_s in (([[], None], 2, True, 8.0),
                                              ([[], None], 3, False, 2.0),
                                              ([[], [], []], 2, True, 3.0)):
        pred = Scripted(script=script)
        gw = _gateway(pkg, pred, min_replies=1, blackout_retries=retries)
        if armed:
            gw._latency_ewma_s = 0.01  # a latency model exists: probing is armed
        preds = gw.predict([[1.0]], deadline_s=deadline_s)
        out.append((pred.calls, _no_errors(preds), gw.stats()["timeouts"],
                    gw.stats()["breakers"]["w0"]["failures"]))
    out.append(pkg.telemetry.get_counter("gateway.blackout_retries"))
    return out


def test_blackout_reroutes_alike():
    got = both(_blackout_trace)
    assert got["port"] == got["jax"] == [(2, True, 0, 1), (1, False, 1, 1),
                                         (3, False, 1, 3), 3]


def _routing_trace(pkg):
    out = []
    # least-loaded: one replica, the emptiest, quorum 1.
    pred = Scripted(live=["busy", "w0", "w1"], depths={"busy": 2, "w0": 1})
    gw = _gateway(pkg, pred, policy="least-loaded")
    gw.predict([[1.0], [2.0]])
    out.append(pred.routes)
    # replicate-all: a majority quorum over the breaker-allowed set; a
    # worker silent three times is routed around once its breaker opens,
    # until every breaker is open and the full set is probed.
    pred = Scripted(live=["w0", "w1", "stuck"], script=[["w0", "w1"]] * 5)
    gw = _gateway(pkg, pred, breaker_failures=3, blackout_retries=0)
    for _ in range(5):
        gw.predict([[1.0]])
    out.append(pred.routes)
    out.append({w: b["state"] for w, b in gw.stats()["breakers"].items()})
    pred = Scripted(live=["w0", "w1"], script=[[]] * 3)
    gw = _gateway(pkg, pred, breaker_failures=1, blackout_retries=0)
    for _ in range(3):
        gw.predict([[1.0]])
    out.append(pred.routes)
    return out


def test_routes_alike():
    got = both(_routing_trace)
    assert got["port"] == got["jax"]
    assert got["port"][0] == [(["w1"], 1)]
    assert got["port"][1] == [(["w0", "w1", "stuck"], 2)] * 3 + [(["w0", "w1"], 1)] * 2
    assert got["port"][2] == {"w0": "closed", "w1": "closed", "stuck": "open"}
    assert got["port"][3] == [(["w0", "w1"], 1)] * 3


def _shed_and_drain_trace(pkg):
    """max_inflight 1, max_queue 1: one request holds the slot, one
    waits, a third is shed; a drain sheds the waiter and new arrivals
    and flushes the one in flight."""
    pkg.telemetry.reset()
    gate = threading.Event()
    pred = Scripted(gate=gate)
    gw = _gateway(pkg, pred, max_inflight=1, max_queue=1)
    results = {}

    def fire(name):
        try:
            results[name] = ("ok", gw.predict([[1.0]], deadline_s=10.0))
        except pkg.gw.ShedError as e:
            results[name] = ("shed", e.reason, e.retry_after_s > 0)

    holder = threading.Thread(target=fire, args=("holder",))
    holder.start()
    wait_until(lambda: pred.calls == 1, what="holder in flight")
    waiter = threading.Thread(target=fire, args=("waiter",))
    waiter.start()
    wait_until(lambda: gw.admission.waiting == 1, what="waiter queued")
    fire("overflow")
    drained = []
    drainer = threading.Thread(target=lambda: drained.append(gw.drain(timeout=10.0)))
    drainer.start()
    waiter.join(timeout=10)
    wait_until(lambda: gw.draining, what="draining")
    fire("late")
    gate.set()
    for th in (holder, drainer):
        th.join(timeout=10)
    stats = gw.stats()
    counters = {k: pkg.telemetry.get_counter(k) for k in (
        "gateway.admitted", "gateway.shed", "gateway.shed_queue_full",
        "gateway.shed_draining", "gateway.drains")}
    return (results, drained, pred.calls,
            {k: stats[k] for k in ("draining", "admitted", "shed", "shed_total", "timeouts",
                                   "inflight", "waiting")},
            counters)


def test_shed_and_drain_decisions_alike():
    got = both(_shed_and_drain_trace)
    assert got["port"] == got["jax"]
    results, drained, calls, stats, counters = got["port"]
    assert results == {"holder": ("ok", [[0.6, 0.4]]), "waiter": ("shed", "draining", True),
                       "overflow": ("shed", "queue_full", True),
                       "late": ("shed", "draining", True)}
    assert drained == [True] and calls == 1
    assert stats["shed"] == {"queue_full": 1, "draining": 2} and stats["admitted"] == 1


def test_stats_and_metrics_keys_alike():
    def keys(pkg):
        pkg.telemetry.reset()
        # The exemplar ring is process-global and outlives reset(): an
        # earlier test file in this worker may have left exemplars in one
        # package's ring (its collector then has ``slowest_s``).
        ring = (jax_exemplars if pkg is PACKAGES["jax"] else port_exemplars).ring
        ring.flush()
        # A tenant fabric registers the process-global ``tenants``
        # collector: one is made here in each package, so the sets below
        # do not depend on whether an earlier test file made one.
        (jax_tenancy if pkg is PACKAGES["jax"] else port_tenancy).TenantFabric()
        gw = _gateway(pkg, Scripted(live=["w0", "w1"]), max_batch=1)
        gw.predict([[1.0]])
        stats = gw.stats()
        snap = pkg.telemetry.snapshot()
        return ((set(stats), set(stats["limits"]), set(stats["breakers"]["w0"]),
                 set(gw.sensors()), set(snap["gateway"]), set(snap["serving"]),
                 set(snap["serving_exemplars"]),
                 sorted(k for k in snap["counters"] if k.startswith("gateway."))),
                set(snap))

    got = both(keys)
    assert got["port"][0] == got["jax"][0]
    # The port's snapshot: the registry, the spans, the gateway collector,
    # (The JAX package's program-cache collector registers when its
    # ``ops.train`` is imported, as the port's does through its worker:
    # this module imports it, so the comparison holds whatever ran first.)
    # the gateway's serving rollup and the exemplar ring, the program
    # cache's, the observability plane's (perf, slo and the goodput
    # ledger), the search ledger's and the tenant fabric's. The JAX
    # package's has those and the collectors of its other planes.
    assert got["port"][1] == {"counters", "gauges", "histograms", "spans", "ts", "gateway",
                              "serving", "serving_exemplars", "program_cache", "perf", "slo",
                              "goodput", "search", "tenants"}
    assert got["jax"][1] >= got["port"][1] | DROPPED_COLLECTORS


# -- real workers on each package's bus ----------------------------------------


def _acceptance(name):
    """``tests/test_gateway.py``'s acceptance scenario over HTTP: k=3
    with one fresh-leased corpse, offered load above the inflight
    budget."""
    pkg = PACKAGES[name]
    pkg.telemetry.reset()
    serving = Serving(pkg, [_SlowConst([0.8, 0.2], 0.05), _SlowConst([0.6, 0.4], 0.05)],
                      corpse="stuck")
    gw = _gateway(pkg, pkg.predictor(serving.bus, JOB, timeout_s=5.0),
                  max_inflight=1, max_queue=1, hedge_grace_s=0.05, breaker_failures=3)
    server = PredictorServer(name, gw)
    try:
        deadline_s, offered, results = 4.0, 12, []
        lock = threading.Lock()

        def fire():
            t0 = time.monotonic()
            r = http("POST", server.url + "/predict",
                     {"queries": [[1.0]], "deadline_s": deadline_s})
            with lock:
                results.append((r[0], time.monotonic() - t0, r[1], r[2]))

        threads = [threading.Thread(target=fire) for _ in range(offered)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        for _ in range(3):  # sequential batches force the corpse's breaker open
            assert http("POST", server.url + "/predict", {"queries": [[1.0]]})[0] == 200
        stats = http("GET", server.url + "/gateway")[1]
        snap = http("GET", server.url + "/metrics")[1]
        health = http("GET", server.url + "/healthz")
        trace = http("POST", server.url + "/predict", {"queries": [[1.0]]})
    finally:
        server.close()
        serving.close()
    codes = sorted(c for c, _, _, _ in results)
    assert len(results) == offered and set(codes) <= {200, 429}, codes
    assert codes.count(429) >= 1 and codes.count(200) >= 1, codes
    for code, dt, body, headers in results:
        if code == 200:
            assert dt < deadline_s and _no_errors(body["predictions"]), body
        else:
            assert int(headers["Retry-After"]) >= 1 and body["reason"]
    assert stats["admitted"] == snap["counters"]["gateway.admitted"]
    assert stats["shed_total"] == snap["counters"]["gateway.shed"]
    assert stats["admitted"] + stats["shed_total"] == offered + 3
    assert stats["timeouts"] == 0 and stats["hedged"] >= 1
    assert stats["breakers"]["stuck"]["state"] == "open"
    assert stats["breakers"]["stuck"]["failures"] >= 3
    assert snap["gateway"]["breakers"]["stuck"]["state"] == "open"
    assert snap["counters"]["gateway.breaker_opened"] >= 1
    assert health[:2] == (200, {"status": "ok"})
    assert trace[2]["X-Rafiki-Trace-Id"] == trace[1]["trace_id"]
    return set(stats), set(trace[1])


def test_acceptance_scenario_in_both_packages():
    """The decisions that do not depend on thread timing agree: the
    corpse's breaker opens, every admitted request is answered within
    its deadline, the overflow is shed with Retry-After, and the two
    endpoints agree with each other."""
    assert _acceptance("port") == _acceptance("jax")


def _microbatched(name):
    pkg = PACKAGES[name]
    pkg.telemetry.reset()
    serving = Serving(pkg, [_SlowConst([0.6, 0.4], 0.005)] * 2)
    try:
        gw = _gateway(pkg, pkg.predictor(serving.bus, JOB, timeout_s=5.0),
                      min_replies=2, max_batch=4, max_batch_wait_ms=10.0)
        results, lock = {}, threading.Lock()

        def fire(i):
            out = gw.predict([[float(i)], [float(i) + 0.5]])
            with lock:
                results[i] = out

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=15)
        snap = pkg.telemetry.snapshot()
        flushes = sum(snap["counters"].get(f"serving.microbatch.flush_{r}", 0)
                      for r in ("size", "deadline", "drain"))
        # A drain flushes a member that waits on a long max-wait.
        gw2 = _gateway(pkg, pkg.predictor(serving.bus, JOB, timeout_s=5.0),
                       min_replies=2, max_batch=64, max_batch_wait_ms=30_000.0)
        late = {}
        th = threading.Thread(target=lambda: late.update(v=gw2.predict([[1.0]])))
        th.start()
        wait_until(lambda: gw2._batcher.pending == 1, what="member enqueued")
        drained = gw2.drain(timeout=10.0)
        th.join(timeout=10)
    finally:
        serving.close()
    assert len(results) == 6 and all(len(o) == 2 and _no_errors(o) for o in results.values())
    assert all(o[0] == pytest.approx([0.6, 0.4], abs=1e-6) for o in results.values())
    assert 1 <= flushes < 6
    assert snap["histograms"]["serving.microbatch.size"]["count"] == flushes
    return (gw.stats()["timeouts"], gw.stats()["limits"]["max_batch"], drained,
            _no_errors(late["v"]), snap["counters"].get("serving.microbatch.flush_drain", 0))


def test_microbatched_gateway_in_both_packages():
    assert _microbatched("port") == _microbatched("jax") == (0, 4, True, True, 0)
