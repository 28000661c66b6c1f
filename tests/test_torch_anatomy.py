"""The port's request-anatomy plane against the JAX package's, on the CPU.

The cases of ``tests/test_anatomy.py``, each run through both packages
on the same inputs and compared: the envelope shapes (untraced, traced
with the gateway's prefix, an explicit trace left unmutated, the reply's
optional third element), segment math and chain totals (exact), the
unknown mark that breaks reconciliation, ``absorb`` (histogram counts
and sums within 1e-12, the fan-out cost, the ``serving/hops`` record),
the exemplar ring and the serving rollup under one fake clock (journal
records equal apart from ``ts`` and ``pid``), the Prometheus text of
the hop histograms, and each package's ``obs waterfall``, ``tails`` and
``serving`` over journals the port's serving path and the JAX package's
wrote: the same documents, each package reading the other's journal.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from rafiki_tpu import telemetry as jax_telemetry
from rafiki_tpu.bus import InProcBus as JaxBus
from rafiki_tpu.gateway import Gateway as JaxGateway, GatewayConfig as JaxGatewayConfig
from rafiki_tpu.obs import cli as jax_cli, context as jax_context, prom as jax_prom
from rafiki_tpu.obs.anatomy import exemplars as jax_exemplars, hops as jax_hops
from rafiki_tpu.obs.anatomy.timeseries import ServingRollup as JaxRollup
from rafiki_tpu.obs.journal import journal as jax_journal, read_dir as jax_read_dir
from rafiki_tpu.predictor import Predictor as JaxPredictor
from rafiki_tpu.worker.inference import InferenceWorker as JaxWorker
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.bus import InProcBus
from rafiki_tpu_torch.gateway import Gateway, GatewayConfig
from rafiki_tpu_torch.obs import cli, context, prom
from rafiki_tpu_torch.obs.anatomy import exemplars, hops
from rafiki_tpu_torch.obs.anatomy.timeseries import ServingRollup
from rafiki_tpu_torch.obs.journal import journal, read_dir
from rafiki_tpu_torch.predictor import Predictor
from rafiki_tpu_torch.worker.inference import InferenceWorker

torch.set_num_threads(2)

PKGS = {
    "jax": dict(telemetry=jax_telemetry, bus=JaxBus, context=jax_context, hops=jax_hops,
                exemplars=jax_exemplars, rollup=JaxRollup, journal=jax_journal,
                read_dir=jax_read_dir, prom=jax_prom, cli=jax_cli, gateway=JaxGateway,
                gateway_config=JaxGatewayConfig, predictor=JaxPredictor, worker=JaxWorker),
    "port": dict(telemetry=telemetry, bus=InProcBus, context=context, hops=hops,
                 exemplars=exemplars, rollup=ServingRollup, journal=journal,
                 read_dir=read_dir, prom=prom, cli=cli, gateway=Gateway,
                 gateway_config=GatewayConfig, predictor=Predictor, worker=InferenceWorker),
}
#: Journal fields that differ between any two runs: the wall stamp and
#: the writing process.
VOLATILE = ("ts", "pid")


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    for p in PKGS.values():
        p["telemetry"].reset()
    yield
    for p in PKGS.values():
        p["telemetry"].reset()
        p["journal"].close()


def _journaled(tmp_path, name):
    """Point ``name``'s journal at its own directory; returns it."""
    d = tmp_path / name
    PKGS[name]["journal"].configure(d, role="test")
    return d


def _records(name, d, kind="serving", rec_name=None):
    PKGS[name]["journal"].close()
    return [{k: v for k, v in r.items() if k not in VOLATILE}
            for r in PKGS[name]["read_dir"](d)
            if r["kind"] == kind and (rec_name is None or r["name"] == rec_name)]


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _chain(pid, *steps):
    return [[code, float(ts), pid] for code, ts in steps]


FULL = (("admit", 0.0), ("queue", 0.010), ("enq", 0.012), ("deq", 0.020),
        ("fwds", 0.021), ("fwd", 0.071), ("reply", 0.072), ("dec", 0.080))


# -- envelope shapes ----------------------------------------------------------


def _envelopes(name):
    p = PKGS[name]
    bus = p["bus"]()
    bus.add_worker("job", "w0")
    bus.add_query("w0", "q1", [1.0])
    p["hops"].begin()
    p["hops"].add("admit")
    p["hops"].add("queue")
    try:
        with p["context"].trace("t-anatomy-1"):
            bus.add_query("w0", "q2", [2.0])
    finally:
        p["hops"].clear()
    closed = (p["hops"].add("admit"), p["hops"].prefix_marks())
    shared = {"trace_id": "t-shared"}
    bus.add_query("w0", "q3", [3.0], trace=shared)
    items = bus.pop_queries("w0", max_n=8, timeout=0.5)
    chain = [p["hops"].mark("enq"), p["hops"].mark("deq"), p["hops"].mark("reply")]
    bus.add_worker("job", "w1")
    bus.put_prediction("q9", "w0", [0.5], hops=chain)
    bus.put_prediction("q9", "w1", [0.4])
    replies = sorted(bus.get_predictions("q9", n=2, timeout=0.5), key=lambda it: it[0])
    return items, closed, shared, chain, replies


def test_envelope_shapes_equal_the_jax_packages():
    got = {name: _envelopes(name) for name in PKGS}
    for name, (items, closed, shared, chain, replies) in got.items():
        assert items[0] == ("q1", [1.0])  # untraced: the bare 2-tuple
        assert [len(it) for it in items] == [2, 3, 3]
        assert closed == (None, [])  # clear() closed the prefix
        assert shared == {"trace_id": "t-shared"}  # copied, not annotated
        assert [len(r) for r in replies] == [3, 2] and replies[0][2] is chain
        for it in items[1:]:
            marks = it[2]["hops"]
            assert all(isinstance(m[1], float) and isinstance(m[2], int) for m in marks)
            assert [m[1] for m in marks] == sorted(m[1] for m in marks)

    def shape(items):
        return [(it[0], it[1], {k: v for k, v in it[2].items() if k != "hops"},
                 [m[0] for m in it[2]["hops"]]) for it in items[1:]]

    assert shape(got["port"][0]) == shape(got["jax"][0]) == [
        ("q2", [2.0], {"trace_id": "t-anatomy-1"}, ["admit", "queue", "enq"]),
        ("q3", [3.0], {"trace_id": "t-shared"}, ["enq"])]


# -- segment math -------------------------------------------------------------


@pytest.mark.parametrize("steps", [
    FULL,
    (("enq", 0.012), ("deq", 0.020), ("fwds", 0.021), ("fwdc", 0.171), ("reply", 0.172),
     ("dec", 0.180)),
    (("admit", 0.0), ("queue", 0.003), ("bat", 0.008), ("enq", 0.009), ("deq", 0.013),
     ("fwds", 0.0131), ("fwd", 0.05), ("reply", 0.0502), ("dec", 0.06)),
    (("enq", 0.0), ("mystery", 0.5), ("dec", 0.6)),  # the foreign mark
    (("enq", 1.0),),
])
def test_segments_and_chain_totals_equal_exactly(steps):
    marks = _chain(42, *steps)
    assert hops.segments(marks) == jax_hops.segments(marks)
    assert hops.chain_total_s(marks) == jax_hops.chain_total_s(marks)
    assert hops.SEGMENT_OF == jax_hops.SEGMENT_OF and hops.SEGMENTS == jax_hops.SEGMENTS
    assert hops.METRIC_OF == jax_hops.METRIC_OF
    assert hops.FANOUT_METRIC == jax_hops.FANOUT_METRIC


def test_unknown_mark_breaks_reconciliation_loudly_in_both():
    marks = _chain(42, ("enq", 0.0), ("mystery", 0.5), ("dec", 0.6))
    for h in (hops, jax_hops):
        segs = h.segments(marks)
        assert [s for s, _ in segs] == ["gather_decide"]
        assert sum(d for _, d in segs) == pytest.approx(0.1, abs=1e-9)
        assert h.chain_total_s(marks) == pytest.approx(0.6, abs=1e-9)


# -- absorb -------------------------------------------------------------------


def test_absorb_feeds_the_same_histograms_and_records(tmp_path):
    rng = np.random.default_rng(0)
    queries = []
    for q in range(12):
        chains = {}
        for w in range(3):
            gaps = rng.uniform(1e-4, 2e-2, size=7).cumsum()
            codes = ["admit", "queue", "enq", "deq", "fwds", "fwdc" if q == 0 else "fwd",
                     "reply", "dec"]
            chains[f"w{w}"] = _chain(100 + w, *zip(codes, [0.0, *gaps]))
        queries.append((f"q{q}", chains))
    hists, recs, totals = {}, {}, {}
    for name, p in PKGS.items():
        d = _journaled(tmp_path, name)
        with p["context"].trace("ab" * 16):
            totals[name] = [p["hops"].absorb(qid, chains) for qid, chains in queries]
        hists[name] = {k: v for k, v in p["telemetry"].snapshot()["histograms"].items()
                       if k.startswith("serving.")}
        recs[name] = _records(name, d, rec_name="hops")
    assert totals["port"] == totals["jax"]
    assert set(hists["port"]) == set(hists["jax"]) == set(hops.METRIC_OF.values()) - {
        "serving.hop.gateway_batch_wait_s"} | {hops.FANOUT_METRIC}
    for k, h in hists["port"].items():
        assert h["count"] == hists["jax"][k]["count"]
        assert abs(h["sum"] - hists["jax"][k]["sum"]) <= 1e-12
    assert hists["port"][hops.FANOUT_METRIC] == hists["jax"][hops.FANOUT_METRIC]
    assert recs["port"] == recs["jax"] and len(recs["port"]) == 12


# -- exemplar ring --------------------------------------------------------------


def test_exemplar_ring_keeps_and_journals_the_same(tmp_path):
    totals = [0.05, 0.9, 0.1, 0.7, 0.3, 0.2, 0.95, 0.01]
    got = {}
    for name, p in PKGS.items():
        d = _journaled(tmp_path, name)
        clock = _Clock()
        ring = p["exemplars"].ExemplarRing(cap=3, window_s=10.0, clock=clock)
        cols = []
        for i, total in enumerate(totals):
            clock.t = 6.0 * i  # a window rolls every other offer
            ring.offer(total, {"query_id": f"q{i}", "chains": {"w0": [["enq", 0.0, 1]]},
                               "trace_id": f"t{i}"})
            cols.append(ring.collector())
        flushed = ring.flush()
        got[name] = (cols, flushed, ring.collector(), _records(name, d, rec_name="exemplar"))
    assert got["port"] == got["jax"]
    assert [r["query_id"] for r in got["port"][3]][:2] == ["q1", "q0"]


# -- serving rollup -------------------------------------------------------------


def test_rollup_rows_equal_under_one_fake_clock(tmp_path):
    got = {}
    for name, p in PKGS.items():
        d = _journaled(tmp_path, name)
        clock = _Clock(100.2)
        rollup = p["rollup"](bucket_s=1.0, clock=clock,
                             context_fn=lambda: {"queue_depth": 3, "inflight": 2})
        for lat in (0.010, 0.020, 0.030, 0.250):
            rollup.observe(latency_s=lat)
        rollup.observe(outcome="shed")
        rollup.observe(outcome="error")
        clock.t = 101.2
        rollup.observe(latency_s=0.005)
        clock.t = 103.7
        rollup.observe(outcome="shed")
        last = rollup.flush()
        gauges = {k: v for k, v in p["telemetry"].snapshot()["gauges"].items()
                  if k.startswith("serving.")}
        got[name] = (last, gauges, rollup.collector(), _records(name, d, rec_name="ts"))
    assert got["port"] == got["jax"]
    rows = got["port"][3]
    assert [(r["bucket"], r["requests"]) for r in rows] == [(100, 6), (101, 1), (103, 1)]
    assert json.dumps(rows, sort_keys=True) == json.dumps(got["jax"][3], sort_keys=True)


def test_rollup_empty_bucket_journals_nothing(tmp_path):
    for name, p in PKGS.items():
        d = _journaled(tmp_path, name)
        assert p["rollup"](bucket_s=1.0, clock=_Clock()).flush() is None
        assert _records(name, d) == []


# -- prom -------------------------------------------------------------------------


def test_hop_histograms_flatten_into_the_same_prom_text():
    text = {}
    for name, p in PKGS.items():
        p["hops"].absorb("q-prom", {"w0": _chain(7, *FULL)})
        # The histograms' lines only: collectors (a gateway's rollup, the
        # SLO engine's state) depend on what else ran in this process.
        text[name] = [line for line in p["prom"].to_prometheus(p["telemetry"].snapshot())
                      .splitlines() if "serving_hop_" in line or "serving_fanout_cost" in line]
    assert text["port"] == text["jax"]
    assert 'rafiki_serving_hop_forward_s{quantile="0.99"}' in "\n".join(text["port"])
    assert "rafiki_serving_hop_forward_s_count 1" in text["port"]
    assert "rafiki_serving_hop_admission_wait_s_count 1" in text["port"]
    assert "rafiki_serving_fanout_cost_s_count 1" in text["port"]


# -- the serving path's journal, read by both CLIs ----------------------------------


class _Const:
    def __init__(self, vec):
        self.vec = list(vec)

    def predict(self, queries):
        return [self.vec for _ in queries]


def _serve(name, d, monkeypatch):
    """Two thread workers behind a per-request and a microbatched
    gateway of one package, journaling to ``d`` with an empty exemplar
    ring; returns the trace ids of the requests."""
    p = PKGS[name]
    monkeypatch.setattr(p["exemplars"], "ring", p["exemplars"].ExemplarRing())
    p["journal"].configure(d, role="test")
    bus = p["bus"]()
    stop = threading.Event()
    workers = [p["worker"](bus, "anat", f"w{i}", _Const([0.6, 0.4]), stop_event=stop)
               for i in range(2)]
    threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
    for th in threads:
        th.start()
    try:
        deadline = time.monotonic() + 10
        while len(bus.get_workers("anat")) < 2:
            assert time.monotonic() < deadline, "workers never registered"
            time.sleep(0.005)
        pred = p["predictor"](bus, "anat", timeout_s=5.0)
        traces = [f"{name[0]}{i:031x}" for i in range(6)]
        gw = p["gateway"](pred, p["gateway_config"](min_replies=2))
        for t in traces[:3]:
            gw.predict([[1.0], [2.0]], trace_id=t)
        gw.rollup.flush()
        gwb = p["gateway"](pred, p["gateway_config"](min_replies=2, max_batch=8,
                                                     max_batch_wait_ms=20.0))
        pool = [threading.Thread(target=gwb.predict, args=([[3.0]],),
                                 kwargs={"trace_id": t}) for t in traces[3:]]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=10)
            assert not th.is_alive()
        gwb.rollup.flush()
        gwb._batcher.stop()  # the flusher thread (the port's Gateway.close)
        p["exemplars"].ring.flush()
        return traces
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=5)
        p["journal"].close()


def _cli_docs(name, d, traces, capsys):
    c = PKGS[name]["cli"]
    capsys.readouterr()
    docs = {}
    for t in traces:
        assert c.cmd_waterfall(str(d), t, as_json=True) == 0
        docs[t] = json.loads(capsys.readouterr().out)
    assert c.cmd_tails(str(d), as_json=True, check=True, tolerance=0.10) == 0
    docs["tails"] = json.loads(capsys.readouterr().out)
    assert c.cmd_serving(str(d), 32, as_json=True) == 0
    docs["serving"] = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    return docs


def test_each_cli_reads_either_packages_serving_journal_alike(tmp_path, capsys, monkeypatch):
    for writer in PKGS:
        d = tmp_path / writer
        traces = _serve(writer, d, monkeypatch)
        docs = {reader: _cli_docs(reader, d, traces, capsys) for reader in PKGS}
        assert docs["port"] == docs["jax"], writer
        doc = docs["port"]
        for t in traces[:3]:  # per-request fan-out: admit .. dec on each chain
            (q0, q1) = doc[t]["queries"]
            for q in (q0, q1):
                assert sorted(q["chains"]) == ["w0", "w1"]
                codes = [[m[0] for m in v["marks"]] for v in q["chains"].values()]
                assert all(c[:4] == ["admit", "queue", "enq", "deq"] and c[-2:] == ["reply", "dec"]
                           for c in codes)
                assert q["max_reconcile_err"] <= 1e-9
            assert doc[t]["e2e_s"] is not None
        for t in traces[3:]:  # microbatched: one shared bat mark per member
            (q,) = doc[t]["queries"]
            for v in q["chains"].values():
                assert [m[0] for m in v["marks"]][:4] == ["admit", "queue", "bat", "enq"]
        assert doc["tails"]["reconcile"]["ok"] and doc["tails"]["requests"] >= 9
        assert len(doc["serving"]) >= 2 and all(r["errors"] == 0 for r in doc["serving"])
        assert {r["kind"] + "/" + r["name"] for r in PKGS["port"]["read_dir"](d)
                if r["kind"] == "serving"} == {"serving/hops", "serving/exemplar",
                                               "serving/ts", "serving/request"}


def test_waterfall_of_an_unknown_trace_exits_nonzero_in_both(tmp_path, capsys):
    for c in (cli, jax_cli):
        assert c.cmd_waterfall(str(tmp_path), "nope", as_json=True) == 1
        assert "no serving hop records" in capsys.readouterr().err
    assert cli.main(["--dir", str(tmp_path), "tails", "--check"]) == 1
    assert cli.main(["--dir", str(tmp_path), "serving"]) == 1
