"""Serve-path elasticity over the port's processes, on the CPU.

The port of ``tests/test_serve_elastic.py``: two trials of a small
FeedForward, trained by the port's ``LocalScheduler``, served by THREE
``run_inference_worker_process`` children (spawned, on the CPU through
``RAFIKI_WORKER_DEVICE=cpu``, one thread each) over the port's
multiprocessing bus, with the predictor and gateway in this process. A
quorum gather survives a SIGKILLed straggler, the ensemble degrades to
k-1 within one lease, and a corpse is reaped by an ordinary read. Before
any kill: the served predictions equal the JAX package's in-process
ensemble of the same stored params, and one traced request's hop chains
each carry two pids and reconcile under ``obs tails --check``.
"""

import json
import multiprocessing as mp
import os
import signal
import time

import numpy as np
import pytest
import torch

from rafiki_tpu.model.base import load_model_class as jax_load_model_class
from rafiki_tpu.predictor.ensemble import ensemble_predictions as jax_ensemble
from rafiki_tpu_torch.bus import make_mp_bus
from rafiki_tpu_torch.gateway import Gateway, GatewayConfig
from rafiki_tpu_torch.obs import cli
from rafiki_tpu_torch.obs.anatomy import exemplars
from rafiki_tpu_torch.obs.journal import journal
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.scheduler import LocalScheduler
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.worker.inference import run_inference_worker_process
from tests.test_torch_scheduler import CPU, make_job, sources  # noqa: F401 (fixture)

torch.set_num_threads(2)

JOB = "serve-elastic"
TIMEOUT_S = 3.0   # predictor batch gather deadline
TTL_S = 4.0       # liveness lease: 8x the 0.5 s heartbeat, as the reference test
#: The served ensemble against the JAX package's in-process ensemble of
#: the same stored params: both run the float32 MLP on the same
#: bf16-stored values, so they differ by float32 rounding of a softmax
#: and a mean.
F32_PROB_ATOL = 1e-6
CTX = mp.get_context("spawn")


def _ok(out):
    return all(not (isinstance(o, dict) and "error" in o) for o in out)


def _queries(seed, n):
    return np.random.default_rng(seed).uniform(0, 1, size=(n, 8, 8, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def served(sources, tmp_path_factory):  # noqa: F811 (the imported fixture)
    """Two trained trials served by THREE worker processes (the third
    re-serves trial 0: k=3 leaves a majority once one is SIGKILLed)."""
    tmp = tmp_path_factory.mktemp("serve")
    store, params = MetaStore(tmp / "meta.sqlite3"), ParamsStore(tmp / "params")
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 2})
    result = LocalScheduler(store, params).run_train_job(
        job["id"], n_workers=1, devices=CPU, advisor_kind="random")
    best = result.best_trials[:2]
    assert len(best) == 2
    trials = [best[0], best[1], best[0]]
    # This module's journal holds this module's requests only: an empty
    # exemplar ring, so no other test's window rolls into it.
    patch = pytest.MonkeyPatch()
    patch.setattr(exemplars, "ring", exemplars.ExemplarRing())
    journal.configure(tmp / "obs", role="test")
    env = {"RAFIKI_WORKER_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
           "RAFIKI_LOG_DIR": str(tmp / "obs")}
    saved = {k: os.environ.get(k) for k in env}
    bus = make_mp_bus()
    procs = []
    try:
        os.environ.update(env)  # the spawn children inherit it
        try:
            for i, t in enumerate(trials):
                procs.append(CTX.Process(
                    target=run_inference_worker_process,
                    args=(bus, str(tmp / "meta.sqlite3"), str(tmp / "params"), t["id"], JOB,
                          f"iw-{i}"), daemon=True))
                procs[-1].start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + 60
        while len(bus.get_workers(JOB)) < len(procs):
            dead = [(p.name, p.exitcode) for p in procs if not p.is_alive()]
            assert not dead, f"worker process died before registering: {dead}"
            assert time.monotonic() < deadline, "workers never registered"
            time.sleep(0.05)
        yield dict(bus=bus, procs=procs, trials=trials, params=params, tmp=tmp,
                   source=sources["jax"])
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        bus.close()
        journal.close()
        patch.undo()


def _warm(pred, queries, n_workers):
    """Wait until every worker answers within one deadline (the first
    forward of each child pays its cold start)."""
    deadline = time.monotonic() + 60
    while True:
        report = pred.predict_detailed(queries)
        if _ok(report.outputs) and len(report.replies) == n_workers:
            return report
        assert time.monotonic() < deadline, "serving never warmed"
        time.sleep(0.2)


def test_served_ensemble_equals_the_jax_packages_in_process_ensemble(served):
    pred = Predictor(served["bus"], JOB, timeout_s=TIMEOUT_S, worker_ttl_s=TTL_S)
    queries = list(_queries(5, 6))
    report = _warm(pred, queries, 3)
    got = np.asarray(report.outputs)
    cls = jax_load_model_class(served["source"], "TinyFF")
    probs = []
    for t in served["trials"]:
        ref = cls(**t["knobs"])
        ref.load_parameters(served["params"].load(t["params_id"]))
        probs.append(ref.predict([q.tolist() for q in queries]))
    want = np.asarray([jax_ensemble([p[i] for p in probs]) for i in range(len(queries))])
    assert got.shape == want.shape == (6, 5)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_PROB_ATOL)


def test_a_traced_request_stitches_two_pids_a_chain_and_reconciles(served, capsys):
    pred = Predictor(served["bus"], JOB, timeout_s=TIMEOUT_S, worker_ttl_s=TTL_S)
    _warm(pred, [_queries(6, 1)[0]], 3)
    gw = Gateway(pred, GatewayConfig(min_replies=3, default_deadline_s=TIMEOUT_S))
    trace = "5e" * 16
    assert _ok(gw.predict([_queries(7, 1)[0]], trace_id=trace))
    gw.rollup.flush()
    obs = str(served["tmp"] / "obs")
    capsys.readouterr()
    assert cli.main(["--dir", obs, "--json", "waterfall", trace]) == 0
    (q,) = json.loads(capsys.readouterr().out)["queries"]
    assert len(q["chains"]) == 3
    child_pids = {p.pid for p in served["procs"]}
    for chain in q["chains"].values():
        codes = [m[0] for m in chain["marks"]]
        assert codes == ["admit", "queue", "enq", "deq", "fwds", "fwd", "reply", "dec"]
        pids = {m[2] for m in chain["marks"]}
        assert len(pids) == 2 and os.getpid() in pids and pids - {os.getpid()} <= child_pids
    assert len(set(q["pids"])) == 4
    assert cli.main(["--dir", obs, "--json", "tails", "--check", "--tolerance", "0.10"]) == 0
    assert json.loads(capsys.readouterr().out)["reconcile"]["ok"]


def test_quorum_gather_survives_sigkilled_straggler(served):
    bus, procs = served["bus"], served["procs"]
    pred = Predictor(bus, JOB, timeout_s=TIMEOUT_S, worker_ttl_s=TTL_S)
    queries = list(_queries(1, 4))
    _warm(pred, queries, len(procs))
    gateway = Gateway(pred, GatewayConfig(max_inflight=4, min_replies=2, hedge_grace_s=0.2,
                                          default_deadline_s=TIMEOUT_S))
    # SIGKILL the straggler-to-be; its lease stays fresh for up to TTL_S,
    # during which only the quorum keeps requests fast.
    os.kill(procs[2].pid, signal.SIGKILL)
    procs[2].join(10)
    assert not procs[2].is_alive()
    deadline = time.monotonic() + 1.0
    while "iw-2" not in bus.get_workers(JOB, max_age_s=TTL_S):
        assert time.monotonic() < deadline, \
            "corpse lease expired before the quorum window was exercised"
        time.sleep(0.05)
    for _ in range(3):
        t0 = time.monotonic()
        out = gateway.predict(queries)
        dt = time.monotonic() - t0
        assert _ok(out), f"quorum batch failed: {out[:2]}"
        assert dt < TIMEOUT_S, f"quorum gather waited on the SIGKILLed straggler ({dt:.1f}s)"
    stats = gateway.stats()
    assert stats["timeouts"] == 0
    assert stats["breakers"]["iw-2"]["failures"] >= 1


def test_sigkilled_inference_worker_degrades_to_k_minus_1(served):
    bus, procs = served["bus"], served["procs"]
    pred = Predictor(bus, JOB, timeout_s=TIMEOUT_S, worker_ttl_s=TTL_S)
    queries = list(_queries(0, 8))
    deadline = time.monotonic() + 60
    while not _ok(pred.predict(queries)):
        assert time.monotonic() < deadline, "serving never warmed"
        time.sleep(0.2)
    os.kill(procs[0].pid, signal.SIGKILL)
    procs[0].join(10)
    assert not procs[0].is_alive()
    # The very next batch still answers (k-1), bounded by ONE deadline.
    t0 = time.monotonic()
    out = pred.predict(queries)
    dt = time.monotonic() - t0
    assert _ok(out), f"post-kill batch failed: {out[:2]}"
    assert dt < TIMEOUT_S + 2.0, f"post-kill batch took {dt:.1f}s"
    # Once the leases expire the corpses leave the fan-out set.
    deadline = time.monotonic() + TTL_S * 4
    while bus.get_workers(JOB, max_age_s=TTL_S) != ["iw-1"]:
        assert time.monotonic() < deadline, "dead worker still holds a fresh lease"
        time.sleep(0.1)
    t0 = time.monotonic()
    out = pred.predict(queries)
    dt = time.monotonic() - t0
    assert _ok(out)
    assert dt < TIMEOUT_S, f"lease-expired corpse still stalls the gather ({dt:.1f}s)"
    assert len(out) == len(queries) and all(len(np.asarray(o)) == 5 for o in out)


def test_sigkilled_serving_corpse_reaped_by_the_janitor(served):
    """The corpses of the two kills above: an ordinary ``get_workers(ttl)``
    read reaps them once their leases are REAP_FACTOR x the TTL old
    (here a short TTL, so the read reaps at once), with their queues."""
    bus = served["bus"]
    bus.add_query("iw-0", "q-leak", [1.0])
    assert bus.queue_depth("iw-0") >= 1  # and what the k-1 test fanned out to it
    deadline = time.monotonic() + 30
    while {"iw-0", "iw-2"} & set(bus.get_workers(JOB)):
        bus.get_workers(JOB, max_age_s=0.3)  # the observing read
        assert time.monotonic() < deadline, "janitor never reaped the corpses"
        time.sleep(0.05)
    assert bus.get_workers(JOB) == ["iw-1"]
    assert bus.queue_depth("iw-0") == 0 and bus.queue_depth("iw-2") == 0
    assert served["procs"][1].is_alive()
