"""The port's observability plane (``rafiki_tpu_torch/obs/``) against the
JAX package's, on the CPU.

Mirrors ``tests/test_obs.py``: trace propagation through bus envelopes
(traced 3-tuples, untraced 2-tuples) and over HTTP, the bounded journal
ring and its torn-line reader, spans flushed into the journal, the
goodput ledger, the flight recorder, the forensics CLI, and the
Prometheus exposition, byte-equal to the JAX package's on
``tests/test_obs.py``'s snapshot and to ``tests/data/prom_golden.txt``.
A journal either package writes reads the same through the other's
``read_dir`` and CLI.
"""

import io
import json
import os
import threading
import urllib.request
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from rafiki_tpu import telemetry as jax_telemetry
from rafiki_tpu.obs import cli as jax_cli
from rafiki_tpu.obs import journal as jax_journal_mod
from rafiki_tpu.obs import prom as jax_prom
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs import context as trace_context
from rafiki_tpu_torch.obs import journal as journal_mod
from rafiki_tpu_torch.obs.journal import Journal, journal
from tests.test_obs import _SNAPSHOT

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "data" / "prom_golden.txt"


@pytest.fixture
def journaled(tmp_path):
    """The port's process-global journal in a tmp dir, closed after."""
    journal.configure(tmp_path, role="test")
    try:
        yield tmp_path
    finally:
        journal.close()


class _StubModel:
    def predict(self, queries):
        return [[0.6, 0.4] for _ in queries]


def _serving(job="tp"):
    """A bus with one stub inference worker serving ``job``; returns
    (bus, stop event, thread)."""
    from rafiki_tpu_torch.bus import InProcBus
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    bus = InProcBus()
    stop = threading.Event()
    worker = InferenceWorker(bus, job, "w1", _StubModel(), stop_event=stop)
    th = threading.Thread(target=worker.run, daemon=True)
    th.start()
    return bus, stop, th


# -- trace propagation -------------------------------------------------------


def test_trace_propagates_through_bus_envelope(journaled):
    """One traced predict batch: the same trace id on the predictor's
    fan-out hop, the worker's pop hop and the worker's forward span."""
    from rafiki_tpu_torch.predictor import Predictor

    bus, stop, th = _serving()
    try:
        tid = "cafe" * 8
        with trace_context.trace(tid):
            out = Predictor(bus, "tp", timeout_s=5.0).predict([[1.0]])
        assert out and "error" not in str(out[0])
    finally:
        stop.set()
        th.join(timeout=5)
    traced = [r for r in journal_mod.read_dir(journaled) if r.get("trace_id") == tid]
    names = {(r["kind"], r["name"]) for r in traced}
    assert {("bus", "add_query"), ("bus", "pop_query"), ("span", "inference.forward"),
            ("gather", "predictor.gather")} <= names
    for r in traced:
        assert r["pid"] == os.getpid() and r["role"] == "test" and r["ts"] > 0


def test_envelopes_traced_3_tuples_and_untraced_2_tuples_as_the_jax_packages():
    from rafiki_tpu.bus import InProcBus as JaxBus
    from rafiki_tpu_torch.bus import InProcBus

    got = {}
    for name, bus in (("port", InProcBus()), ("jax", JaxBus())):
        bus.add_worker("tp", "w1")
        assert trace_context.current_trace_id() is None
        bus.add_query("w1", "q1", [1.0])
        ctx = trace_context if name == "port" else __import__(
            "rafiki_tpu.obs.context", fromlist=["trace"])
        with ctx.trace("ab" * 16), ctx.tenant_scope("alice"):
            bus.add_query("w1", "q2", [2.0])
        got[name] = bus.pop_queries("w1", timeout=1.0)
    assert got["port"][0] == got["jax"][0] == ("q1", [1.0])
    (qid, query, trace), (jqid, jquery, jtrace) = got["port"][1], got["jax"][1]
    assert (qid, query) == (jqid, jquery) == ("q2", [2.0])

    def codes(tr):  # the hop marks by code: their times and pids are the run's own
        return dict(tr, hops=[m[0] for m in tr["hops"]])

    assert codes(trace) == codes(jtrace) == {
        "trace_id": "ab" * 16, "tenant": "alice", "hops": ["enq"]}


def test_trace_context_nesting_process_default_and_env(monkeypatch):
    with trace_context.trace("a" * 32):
        assert trace_context.current_trace_id() == "a" * 32
        with trace_context.trace():  # inherits, does not mint
            assert trace_context.current_trace_id() == "a" * 32
    assert trace_context.current_trace_id() is None
    trace_context.set_process_trace("b" * 32)
    try:
        assert trace_context.current_trace_id() == "b" * 32
        with trace_context.trace("c" * 32):  # thread-local wins
            assert trace_context.current_trace_id() == "c" * 32
        seen = []
        th = threading.Thread(target=lambda: seen.append(trace_context.current_trace_id()))
        th.start()
        th.join()
        assert seen == ["b" * 32]  # other threads see the process default
    finally:
        trace_context.set_process_trace(None)
    monkeypatch.setenv(trace_context.ENV_VAR, "d" * 32)
    monkeypatch.delenv(journal_mod.ENV_VAR, raising=False)
    from rafiki_tpu_torch import obs

    try:
        assert obs.configure_from_env(role="x") is False  # no journal dir
        assert trace_context.current_trace_id() == "d" * 32
    finally:
        trace_context.set_process_trace(None)
    with trace_context.tenant_scope("t1"):
        assert trace_context.current_tenant() == "t1"
        with trace_context.tenant_scope(None):
            assert trace_context.current_tenant() == "t1"
    assert trace_context.current_tenant() is None
    assert len(trace_context.new_trace_id()) == 32


# -- journal ring ------------------------------------------------------------


def test_journal_ring_rotates_and_stays_bounded(tmp_path):
    j = Journal(tmp_path, role="ring", max_records=10)
    try:
        for i in range(25):
            j.record("event", f"e{i}")
        live = j.path
        old = live.with_name(live.name + ".1")
        assert old.exists() and live.name == f"journal-ring-{os.getpid()}.jsonl"
        assert sum(1 for _ in open(live)) <= 10 and sum(1 for _ in open(old)) <= 10
        assert len(list(tmp_path.glob("journal-*"))) == 2
        merged = journal_mod.read_dir(tmp_path)
        assert [r["name"] for r in merged] == [f"e{i}" for i in range(10, 25)]
        assert [r["name"] for r in j.tail(5)] == [f"e{i}" for i in range(20, 25)]
    finally:
        j.close()


def test_journal_unconfigured_is_noop_and_reader_skips_torn_lines(tmp_path):
    j = Journal()
    j.record("event", "dropped")
    assert j.path is None and not j.configured
    p = tmp_path / "journal-x-1.jsonl"
    p.write_text(json.dumps({"ts": 1.0, "name": "ok"}) + "\n" + '{"ts": 2.0, "na')
    assert [r["name"] for r in journal_mod.read_dir(tmp_path)] == ["ok"]
    assert [r["name"] for r in jax_journal_mod.read_dir(tmp_path)] == ["ok"]


def test_spans_and_events_flush_into_journal(journaled):
    from rafiki_tpu_torch.utils.events import events

    with trace_context.trace("e" * 32):
        with telemetry.span("obs.test_phase", trial_id="t1"):
            events.emit("obs_test_event", trial_id="t1")
    recs = journal_mod.read_dir(journaled)
    [span] = [r for r in recs if (r["kind"], r["name"]) == ("span", "obs.test_phase")]
    [event] = [r for r in recs if (r["kind"], r["name"]) == ("event", "obs_test_event")]
    assert span["dur_s"] >= 0 and span["tags"] == {"trial_id": "t1"}
    assert span["trace_id"] == event["trace_id"] == "e" * 32 and event["trial_id"] == "t1"
    assert set(span) == {"ts", "pid", "role", "kind", "name", "trace_id", "dur_s", "span_id",
                         "parent_id", "tags"}
    assert [r for r in telemetry.span_records()
            if r["name"] == "obs.test_phase"][-1]["trace_id"] == "e" * 32


# -- goodput ledger ----------------------------------------------------------


def test_ledger_entities_and_goodput_rollup(journaled):
    from rafiki_tpu.obs.ledger import Ledger as JaxLedger
    from rafiki_tpu_torch.obs.ledger import Ledger, ledger

    ledger.reset()
    try:
        with ledger.entity("trial:t1"):
            ledger.add("compile_s", 3.0)
            ledger.add("step_s", 1.0)
            ledger.add("step_s", -1.0)  # non-positive charges are dropped
        ledger.add("downtime_s", 2.0, entity="job:j1")
        snap = ledger.snapshot()
        t1 = snap["entities"]["trial:t1"]
        assert t1["compile_s"] == 3.0 and t1["step_s"] == 1.0 and t1["wall_s"] > 0
        assert snap["entities"]["job:j1"]["downtime_s"] == 2.0
        assert snap["goodput"] == pytest.approx(1.0 / snap["total"]["wall_s"], rel=1e-3)
        assert telemetry.snapshot()["goodput"]["total"]["step_s"] == 1.0
        [rec] = [r for r in journal_mod.read_dir(journaled) if r["kind"] == "ledger"]
        assert rec["name"] == "trial:t1" and rec["compile_s"] == 3.0
        assert ledger.current_entity() == "process"
        # The same charges roll up as in the JAX package's ledger (walls
        # aside, which are the blocks' own).
        ref, port = JaxLedger(), Ledger()
        for lg in (ref, port):
            lg.add("step_s", 2.0, entity="trial:a")
            lg.add("feed_s", 0.5, entity="trial:a")
            lg.add("checkpoint_s", 1.0)
        assert ref.snapshot() == port.snapshot()
    finally:
        ledger.reset()


# -- flight recorder ---------------------------------------------------------


def test_flight_recorder_dump(journaled):
    from rafiki_tpu_torch.obs import recorder

    journal.record("event", "before_crash")
    with trace_context.trace("d" * 32):
        path = recorder.dump("test_reason", extra={"detail": "x"})
    assert path is not None and path.exists()
    payload = json.loads(path.read_text())
    assert payload["reason"] == "test_reason" and payload["role"] == "test"
    assert payload["trace_id"] == "d" * 32 and payload["detail"] == "x"
    assert any(r["name"] == "before_crash" for r in payload["journal_tail"])
    assert "counters" in payload["telemetry"]
    assert any(r["kind"] == "flight" for r in journal.tail(8))


def test_flight_recorder_without_log_dir_is_noop_and_install_chains(monkeypatch):
    import sys

    from rafiki_tpu_torch.obs import recorder

    monkeypatch.delenv(journal_mod.ENV_VAR, raising=False)
    monkeypatch.setattr(recorder, "journal", Journal())  # a process that never journaled
    assert recorder.dump("nowhere") is None
    # install() chains sys.excepthook (main thread only, once).
    monkeypatch.setattr(recorder, "_installed", False)
    prev = sys.excepthook
    calls = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: calls.append(a[0]))
    import signal

    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        assert recorder.install() is True and recorder.install() is False
        sys.excepthook(ValueError, ValueError("x"), None)
        assert calls == [ValueError]
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
        monkeypatch.setattr(sys, "excepthook", prev)


# -- CLI ---------------------------------------------------------------------


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_obs_cli_trace_tail_slowest(journaled, capsys):
    from rafiki_tpu_torch.obs import cli

    tid = "beef" * 8
    with trace_context.trace(tid):
        journal.record("event", "hop1")
        with telemetry.span("obs.cli_span"):
            journal.record("event", "hop2")
    journal.record("event", "unrelated")
    rc, out = _run(cli.main, ["--dir", str(journaled), "trace", tid])
    assert rc == 0 and "hop1" in out and "hop2" in out and "unrelated" not in out
    assert "3 records" in out
    rc, out = _run(cli.main, ["--dir", str(journaled), "--json", "trace", tid[:8]])
    assert rc == 0 and {json.loads(line)["trace_id"] for line in out.splitlines()} == {tid}
    rc, out = _run(cli.main, ["--dir", str(journaled), "tail", "-n", "1"])
    assert rc == 0 and "unrelated" in out
    rc, out = _run(cli.main, ["--dir", str(journaled), "slowest", "-n", "1"])
    assert rc == 0 and "obs.cli_span" in out
    assert cli.main(["--dir", str(journaled), "trace", "f" * 32]) == 1
    assert cli.main(["--dir", str(journaled), "profile"]) == 1
    assert cli.main(["--dir", str(journaled), "slo"]) == 1


def _write_journal(record, tel, ctx, slo_mod):
    """A small journal of every record shape the CLI verbs read."""
    tid = "abcd" * 8
    with ctx.trace(tid):
        record("event", "trial_started", trial_id="t1")
        with tel.span("trial.total", trial_id="t1"):
            record("bus", "add_query", query_id="q1", parent_span=None)
    record("gateway", "shed", reason="queue_full")
    eng = slo_mod.SloEngine(specs=[slo_mod.SloSpec("burn", "counter:cross.x", 0.0,
                                                   windows=(1.0,))], tick_s=0.0,
                            clock=iter([0.0, 0.0, 2.0]).__next__)
    eng.tick()
    tel.inc("cross.x", 3)
    eng.tick()
    return tid


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("verb", [["trace", "abcd"], ["tail", "-n", "50"], ["slowest"], ["slo"],
                                  ["--json", "tail", "-n", "50"]])
def test_either_packages_journal_reads_the_same_through_both_clis(writer, verb, tmp_path):
    """A journal the port writes reads in the JAX package's ``read_dir``
    and CLI as in the port's, and the other way round."""
    from rafiki_tpu.obs import context as jax_context
    from rafiki_tpu.obs.journal import journal as jax_journal
    from rafiki_tpu.obs.perf import slo as jax_slo
    from rafiki_tpu_torch.obs import cli
    from rafiki_tpu_torch.obs.perf import slo

    j, tel, ctx, slo_mod = ((journal, telemetry, trace_context, slo) if writer == "port"
                            else (jax_journal, jax_telemetry, jax_context, jax_slo))
    j.configure(tmp_path, role=f"{writer}-writer")
    try:
        _write_journal(j.record, tel, ctx, slo_mod)
    finally:
        j.close()
    assert journal_mod.read_dir(tmp_path) == jax_journal_mod.read_dir(tmp_path)
    [path] = tmp_path.glob("journal-*.jsonl")
    assert path.name == f"journal-{writer}-writer-{os.getpid()}.jsonl"
    port = _run(cli.main, ["--dir", str(tmp_path)] + verb)
    ref = _run(jax_cli.main, ["--dir", str(tmp_path)] + verb)
    assert port == ref and port[0] == 0 and port[1]


def test_profile_reads_a_jax_package_journal_as_one_step_an_epoch(tmp_path):
    """A JAX package journal has no ``steps``: the port's profile reads
    its epochs as one step each, the JAX package's own reading."""
    from rafiki_tpu.obs.journal import journal as jax_journal
    from rafiki_tpu_torch.obs import cli

    jax_journal.configure(tmp_path, role="jax")
    try:
        jax_journal.record("perf", "cost", key="k", key_hash="h1", program_kind="serial", k=1,
                           flops=2.0e9, bytes_accessed=1.0e9, peak_hbm_bytes=None,
                           cost_capture_s=0.1)
        for dt in (0.5, 0.4, 0.45):
            jax_journal.record("perf", "step", key_hash="h1", dt=dt, feed_s=0.0, cold=False,
                               program_kind="serial", k=1, packing_key=None, group_width=None)
    finally:
        jax_journal.close()
    [row] = cli.profile_rows(str(tmp_path), peak_flops=1e12)
    [ref] = json.loads(_run(jax_cli.main, ["--dir", str(tmp_path), "--json", "profile",
                                           "--peak-flops", "1e12"])[1])["programs"]
    assert row["steps"] == 1 and row["achieved_flops_s"] == ref["achieved_flops_s"]
    assert row["mfu_vs_peak"] == ref["mfu_vs_peak"] == pytest.approx(2.0e9 / 0.45 / 1e12)


# -- Prometheus exposition ---------------------------------------------------


def test_prometheus_exposition_byte_equal_to_the_jax_packages_and_golden():
    from rafiki_tpu_torch.obs import prom

    rendered = prom.to_prometheus(_SNAPSHOT)
    assert rendered == jax_prom.to_prometheus(_SNAPSHOT)
    assert rendered == GOLDEN.read_text()


def test_prometheus_exposition_is_deterministic_and_parseable():
    import re

    from rafiki_tpu_torch.obs import prom

    telemetry.reset()
    try:
        telemetry.inc("obs.test_counter", 2)
        with telemetry.span("obs.prom_span"):
            pass
        text = prom.to_prometheus(telemetry.snapshot())
        assert text == prom.to_prometheus(telemetry.snapshot())
        sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.e+-]+$')
        for line in text.splitlines():
            assert line.startswith("# TYPE ") or sample.match(line), line
        assert "rafiki_obs_test_counter 2" in text
    finally:
        telemetry.reset()


# -- over HTTP: the predictor app ----------------------------------------------


def test_http_query_stitches_and_metrics_serve_prom(journaled):
    """A POST with a pinned trace id: the HTTP spans, the gateway, the
    bus envelope and the inference worker all journal under it, and
    ``/metrics?format=prom`` serves the snapshot as Prometheus text."""
    from rafiki_tpu_torch.gateway import Gateway
    from rafiki_tpu_torch.predictor import Predictor
    from rafiki_tpu_torch.predictor.app import start_predictor_server

    bus, stop, th = _serving()
    gateway = Gateway(Predictor(bus, "tp", timeout_s=5.0))
    server, host = start_predictor_server(gateway)
    tid = "f00d" * 8
    try:
        req = urllib.request.Request(f"http://{host}/predict", method="POST",
                                     data=json.dumps({"queries": [[1.0]]}).encode(),
                                     headers={"X-Rafiki-Trace-Id": tid})
        with urllib.request.urlopen(req, timeout=30) as r:
            body, echoed = json.loads(r.read()), r.headers["X-Rafiki-Trace-Id"]
        with urllib.request.urlopen(f"http://{host}/metrics?format=prom", timeout=30) as r:
            ctype, text = r.headers["Content-Type"], r.read().decode()
    finally:
        server.shutdown()
        server.server_close()
        gateway.close()
        stop.set()
        th.join(timeout=5)
    assert body["trace_id"] == echoed == tid and "error" not in str(body["predictions"])
    names = {(r["kind"], r["name"]) for r in journal_mod.read_dir(journaled)
             if r.get("trace_id") == tid}
    assert {("span", "predictor_http.decode"), ("span", "gateway.predict"),
            ("bus", "add_query"), ("bus", "pop_query"), ("span", "inference.forward"),
            ("gather", "predictor.gather"), ("serving", "request"),
            ("span", "predictor_http.encode")} <= names
    assert ctype.startswith("text/plain") and "rafiki_gateway_admitted 1" in text
    config = [r for r in journal_mod.read_dir(journaled)
              if (r["kind"], r["name"]) == ("gateway", "config")]
    assert len(config) == 1 and config[0]["max_inflight"] == gateway.cfg.max_inflight


def test_a_divergence_journals_charges_badput_and_dumps_a_flight_record(journaled):
    """The health detector's trip, as the JAX package's: the verdict
    journaled as ``health/divergence``, the trial's wall so far charged
    to the ledger's ``badput_s``, and a flight record."""
    import time

    from rafiki_tpu_torch.obs.health import HealthMonitor
    from rafiki_tpu_torch.obs.ledger import ledger

    ledger.reset()
    try:
        mon = HealthMonitor("serial:test")
        t0 = time.monotonic() - 0.5
        assert mon.observe({"health_grad_norm": 1.0, "health_nonfinite": 0}, t0=t0) is None
        verdict = mon.observe({"health_grad_norm": float("nan"), "health_nonfinite": 3,
                               "health_bad_step": 2}, t0=t0, epoch_seed=7)
        assert verdict["divergence"] == "nonfinite" and verdict["badput_s"] >= 0.5
        [rec] = [r for r in journal_mod.read_dir(journaled)
                 if (r["kind"], r["name"]) == ("health", "divergence")]
        assert rec["bad_step"] == 2 and rec["nonfinite"] == 3 and rec["epoch_seed"] == 7
        assert ledger.snapshot()["total"]["badput_s"] == pytest.approx(verdict["badput_s"],
                                                                       abs=1e-5)
        [flight] = journaled.glob("flight-*.json")
        assert json.loads(flight.read_text())["reason"] == "health:divergence"
    finally:
        ledger.reset()
