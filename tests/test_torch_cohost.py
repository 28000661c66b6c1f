"""Co-hosted serving: three jobs behind ONE inference worker under an HBM
budget that fits two, the port against the JAX package, on the CPU.

One blob set (FeedForward 1 x 256 on 32x32x3, bf16 serving blobs of the
port's ``dump_parameters``, about 1.6 MB a trial) is saved once into a
content-addressed params directory (``RAFIKI_PARAMS_CAS=1``) that both
packages' services managers read. Jobs J0 and J1 have two trials each;
J2 is J0's first trial plus one of its own, so its save writes only the
new trial's chunks. Each package co-hosts the three jobs with
``create_cohosted_inference_services`` under a budget of 2.5 times its
own charge for one job, then serves a fixed order of requests:

- each job's co-hosted predictions equal the same job served alone
  through ``create_inference_services`` (the stacked route) in the same
  package, bit for bit (ROUTE_ATOL), and the port's equal the JAX
  package's within BF16_PROB_ATOL;
- the ``tenancy/residency`` events (activate/evict/hit, program) equal
  the LRU sequence computed from the query order, in both packages, and
  each other;
- no record's ``used_bytes`` exceeds its budget;
- the port charges a job its blobs' bytes (``store/cas.py`` ``size``,
  the plain store's size for the same blob); the JAX package charges
  the 1 MiB floor, because its CAS ``size`` is the manifest's (the
  reference's fault, ROADMAP Queue 3);
- ``obs tenants --json`` prints the same object in both packages on
  each journal directory;
- a job whose trials cannot stack is co-hosted as its whole ensemble in
  the port (ENSEMBLE_ATOL of the job served alone), where the JAX
  package serves its first trial alone;
- serving holds the heap frozen (``utils/heap.py``) until it stops.
"""

import contextlib
import gc
import io
import json
import threading

import numpy as np
import pytest
import torch

from rafiki_tpu import telemetry as jax_telemetry
from rafiki_tpu.admin.services_manager import ServicesManager as JaxServicesManager
from rafiki_tpu.obs import cli as jax_cli
from rafiki_tpu.obs import journal as jax_journal_mod
from rafiki_tpu.store import MetaStore as JaxMetaStore, make_params_store as jax_make_store
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.admin.services_manager import ServicesManager
from rafiki_tpu_torch.models.ff import FeedForward
from rafiki_tpu_torch.obs import cli as port_cli
from rafiki_tpu_torch.obs import journal as port_journal_mod
from rafiki_tpu_torch.store import CasParamsStore, MetaStore, ParamsStore, make_params_store
from rafiki_tpu_torch.tenancy import wrap_query
from rafiki_tpu_torch.utils import heap

torch.set_num_threads(2)

KNOBS = dict(hidden_layers=1, hidden_units=256, learning_rate=1e-3, batch_size=32, epochs=1,
             seed=0)
SHAPE = (32, 32, 3)
# One package's co-hosted and dedicated stacked routes run the same
# forward on the same padded batch: equal bit for bit on the CPU.
ROUTE_ATOL = 0.0
# Port vs JAX package on bf16 serving blobs (tests/test_torch_serving.py).
BF16_PROB_ATOL = 5e-3
#: The request order: misses, hits and evictions under a two-job budget.
ORDER = ["J0", "J1", "J2", "J0", "J2", "J2", "J1", "J0"]
SOURCES = {"port": b"from rafiki_tpu_torch.models.ff import FeedForward\n",
           "jax": b"from rafiki_tpu.models.ff import FeedForward\n"}


def lru_events(order, capacity):
    """The residency manager's (event, program) sequence, computed on
    the host: a hit refreshes, a miss evicts the least recently used
    until the program fits (every job costs one unit here)."""
    resident, events = [], []
    for job in order:
        if job in resident:
            resident.remove(job)
            events.append(("hit", job))
        else:
            while len(resident) >= capacity:
                events.append(("evict", resident.pop(0)))
            events.append(("activate", job))
        resident.append(job)
    return events


def _blob(seed):
    m = FeedForward(device="cpu", **KNOBS)
    m.init_parameters(10, SHAPE, torch.Generator().manual_seed(seed))
    return m.dump_parameters()


@pytest.fixture(scope="module")
def setup(tmp_path_factory, request):
    """The shared CAS directory and each package's meta store with jobs
    J0-J2 (trial rows pointing at the shared params ids)."""
    tmp = tmp_path_factory.mktemp("cohost")
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    mp.setenv("RAFIKI_PARAMS_CAS", "1")
    params = make_params_store(tmp / "params")
    assert isinstance(params, CasParamsStore)
    ids = {}
    writes = {}
    for job, seeds in (("J0", (0, 1)), ("J1", (2, 3)), ("J2", (0, 4))):
        before = telemetry.get_counter("cas.chunk_writes")
        ids[job] = [params.save(_blob(s), params_id=f"s{s}") if not params.exists(f"s{s}")
                    else f"s{s}" for s in seeds]
        writes[job] = telemetry.get_counter("cas.chunk_writes") - before
    stores = {}
    for name, store_cls in (("port", MetaStore), ("jax", JaxMetaStore)):
        store = store_cls(tmp / f"meta-{name}.sqlite3")
        model = store.create_model("ff", "IMAGE_CLASSIFICATION", None, SOURCES[name],
                                   "FeedForward")
        tj = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, "x", "y", {})
        sub = store.create_sub_train_job(tj["id"], model["id"])
        trials = {}
        for job, pids in ids.items():
            rows = []
            for pid in pids:
                t = store.create_trial(sub["id"], "ff", KNOBS)
                store.mark_trial_as_completed(t["id"], 0.5, pid)
                rows.append(store.get_trial(t["id"]))
            trials[job] = rows
        stores[name] = (store, trials)
    queries = np.random.default_rng(5).uniform(0, 1, size=(5,) + SHAPE).astype(np.float32)
    return {"tmp": tmp, "params_dir": tmp / "params", "ids": ids, "writes": writes,
            "stores": stores, "queries": queries.tolist()}


def test_cas_save_writes_only_the_new_trials_chunks(setup):
    """J2 shares J0's first trial: its save wrote half of J0's chunks."""
    w = setup["writes"]
    assert w["J0"] == w["J1"] > 0 and w["J2"] == w["J0"] / 2


def _serve(name, setup):
    """Co-host J0-J2 in ``name``'s services manager, serve ORDER (one
    single-query request per entry, the 5-query request on each miss),
    then each job alone; returns predictions, records and charges."""
    tmp = setup["tmp"]
    store, trials = setup["stores"][name]
    jm = port_journal_mod if name == "port" else jax_journal_mod
    log_dir = tmp / f"obs-{name}"
    jm.journal.configure(log_dir, role="test")
    try:
        if name == "port":
            params = make_params_store(setup["params_dir"])
            mgr = ServicesManager(store, params, device="cpu")
        else:
            params = jax_make_store(setup["params_dir"])
            mgr = JaxServicesManager(store, params)
        charge = max(sum(params.size(t["params_id"]) for t in trials["J0"]), 1 << 20)
        budget = int(2.5 * charge)
        jobs = {j: store.create_inference_job(trials[j][0]["id"], None)["id"] for j in trials}
        predictors = mgr.create_cohosted_inference_services(
            {jobs[j]: trials[j] for j in trials}, hbm_budget_bytes=budget)
        q, seen = setup["queries"], set()
        cohosted = {}
        try:
            for j in ORDER:
                out = predictors[jobs[j]].predict([q[0]], timeout_s=60)
                cohosted.setdefault(j, out)
                if j not in seen:
                    seen.add(j)
                    # One envelope: one forward, one residency hit.
                    report = predictors[jobs[j]].predict_batch_detailed(q, timeout_s=60)
                    cohosted[j + "/5"] = report.outputs
            mixed = None
            if name == "port":
                # Queries of two programs in one forward batch: each
                # reaches its own program, padded per program group.
                host = mgr._inference_jobs[jobs["J0"]].workers[0].model
                mixed = host.predict([wrap_query(jobs["J0"], q[1]),
                                      wrap_query(jobs["J2"], q[2]),
                                      wrap_query(jobs["J0"], q[3])])
        finally:
            for j in trials:
                mgr.stop_inference_services(jobs[j])
        alone = {}
        for j in trials:
            job = store.create_inference_job(trials[j][0]["id"], None)["id"]
            kwargs = {} if name == "port" else {"serve_http": False}
            pred = mgr.create_inference_services(job, trials[j], **kwargs)
            try:
                alone[j] = pred.predict(q, timeout_s=60)
            finally:
                mgr.stop_inference_services(job)
        mgr.stop_all()
    finally:
        jm.journal.close()
    recs = jm.read_dir(log_dir)
    return {"cohosted": cohosted, "alone": alone, "mixed": mixed, "recs": recs,
            "jobs": jobs, "charge": charge, "budget": budget, "log_dir": log_dir}


@pytest.fixture(scope="module")
def served(setup):
    telemetry.reset()
    jax_telemetry.reset()
    return {name: _serve(name, setup) for name in ("port", "jax")}


def _residency(run):
    back = {v: k for k, v in run["jobs"].items()}
    return [r for r in run["recs"] if (r["kind"], r["name"]) == ("tenancy", "residency")
            and r.get("for_program") != "shutdown"], back


@pytest.mark.parametrize("name", ["port", "jax"])
def test_cohosted_equals_dedicated_serving(served, name):
    run = served[name]
    for j, alone in run["alone"].items():
        got = np.asarray(run["cohosted"][j + "/5"])
        assert got.shape == (5, 10) and np.isfinite(got).all()
        assert np.abs(got - np.asarray(alone)).max() <= ROUTE_ATOL
        assert np.abs(np.asarray(run["cohosted"][j]) - np.asarray(alone[:1])).max() <= ROUTE_ATOL
    # The three jobs' models differ (J2 shares one trial of J0's two).
    assert not np.array_equal(run["alone"]["J0"], run["alone"]["J2"])


def test_port_cohosted_predictions_equal_the_jax_packages(served):
    for key, got in served["port"]["cohosted"].items():
        np.testing.assert_allclose(np.asarray(got), np.asarray(served["jax"]["cohosted"][key]),
                                   rtol=0, atol=BF16_PROB_ATOL)


def test_mixed_programs_in_one_batch_reach_their_own(served):
    run = served["port"]
    mixed = np.asarray(run["mixed"])
    single = {j: np.asarray(run["alone"][j]) for j in ("J0", "J2")}
    # q[1] and q[3] through J0, q[2] through J2 (rows 1-3 of each alone run).
    np.testing.assert_array_equal(mixed[[0, 2]], single["J0"][[1, 3]])
    np.testing.assert_array_equal(mixed[1], single["J2"][2])


@pytest.mark.parametrize("name", ["port", "jax"])
def test_residency_events_follow_the_host_lru(served, name):
    recs, back = _residency(served[name])
    got = [(r["event"], back[r["program"]]) for r in recs]
    # Each job's first request is followed by its 5-query one (a hit).
    requests = []
    for j in ORDER:
        requests += [j] if j in requests else [j, j]
    want = lru_events(requests, capacity=2)
    assert got[:len(want)] == want
    # The port's mixed batch after them (J1 and J0 resident; its groups
    # run in program-id order): J0 hits, J2 evicts J1 and activates.
    assert sorted(got[len(want):]) == (
        [("activate", "J2"), ("evict", "J1"), ("hit", "J0")] if name == "port" else [])
    for r in recs:
        if "used_bytes" in r:
            assert r["used_bytes"] <= served[name]["budget"]
    [cohost] = [r for r in served[name]["recs"] if (r["kind"], r["name"]) == ("tenancy",
                                                                              "cohost")]
    assert cohost["budget_bytes"] == served[name]["budget"]
    assert sorted(cohost["jobs"]) == sorted(served[name]["jobs"].values())


def test_residency_events_equal_the_jax_packages(served):
    """The same (event, job) sequence for the same requests (the port's
    mixed batch aside), whatever each package charges."""
    got, want = ([(r["event"], back[r["program"]]) for r in recs]
                 for recs, back in (_residency(served["port"]), _residency(served["jax"])))
    assert got[:len(want)] == want and len(want) > 8


def test_charges_blob_bytes_in_the_port_and_the_floor_in_the_jax_package(setup, served):
    plain = ParamsStore(setup["tmp"] / "plain")
    blob_bytes = {}
    for j, pids in setup["ids"].items():
        cas = CasParamsStore(setup["params_dir"])
        blob_bytes[j] = sum(plain.size(plain.save(cas.load(p))) for p in pids)
    for name in ("port", "jax"):
        recs, back = _residency(served[name])
        sizes = {back[r["program"]]: r["size_bytes"] for r in recs if r["event"] == "activate"}
        if name == "port":
            assert sizes == blob_bytes and min(sizes.values()) > 3_000_000
        else:
            assert sizes == {j: 1 << 20 for j in blob_bytes}


def test_tenants_verb_prints_the_same_json(served):
    for run in served.values():
        outs = []
        for cli in (port_cli, jax_cli):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.cmd_tenants(str(run["log_dir"]), True, False) == 0
            outs.append(json.loads(buf.getvalue()))
        assert outs[0] == outs[1]
        assert outs[0]["residency_events"]["activate"] >= 3
        assert len(outs[0]["cohosted_workers"]) == 1
    assert not [t for t in threading.enumerate() if t.name.startswith("cohost-")
                and t.is_alive()]


#: Two trials whose widths differ cannot stack.
NARROW = dict(KNOBS, hidden_units=128)
# The co-hosted ensemble renormalizes once more than the dedicated
# route's (the predictor ensembles the one reply it gets): float32
# rounding apart.
ENSEMBLE_ATOL = 1e-6


def _serve_unstackable(name, setup):
    """Co-host one job of a wide and a narrow trial in ``name``'s
    services manager; serve the queries co-hosted, then the job alone
    (one worker per trial) and its first trial alone."""
    store, trials = setup["stores"][name]
    params = make_params_store(setup["params_dir"])
    pids = []
    for knobs, seed in ((KNOBS, 0), (NARROW, 6)):
        m = FeedForward(device="cpu", **knobs)
        m.init_parameters(10, SHAPE, torch.Generator().manual_seed(seed))
        pid = f"mixed{seed}"
        if not params.exists(pid):
            params.save(m.dump_parameters(), params_id=pid)
        pids.append((knobs, pid))
    sub_id = trials["J0"][0]["sub_train_job_id"]
    rows = []
    for knobs, pid in pids:
        t = store.create_trial(sub_id, "ff", knobs)
        store.mark_trial_as_completed(t["id"], 0.5, pid)
        rows.append(store.get_trial(t["id"]))
    if name == "port":
        mgr = ServicesManager(store, make_params_store(setup["params_dir"]), device="cpu")
        kwargs = {}
    else:
        mgr = JaxServicesManager(store, jax_make_store(setup["params_dir"]))
        kwargs = {"serve_http": False}
    q, out = setup["queries"], {}
    try:
        job = store.create_inference_job(rows[0]["id"], None)["id"]
        out["cohosted"] = mgr.create_cohosted_inference_services({job: rows})[job].predict(
            q, timeout_s=60)
        mgr.stop_inference_services(job)
        for key, serve in (("alone", rows), ("first", rows[:1])):
            job = store.create_inference_job(rows[0]["id"], None)["id"]
            out[key] = mgr.create_inference_services(job, serve, **kwargs).predict(
                q, timeout_s=60)
            mgr.stop_inference_services(job)
    finally:
        mgr.stop_all()
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}


def test_a_job_whose_trials_cannot_stack_serves_its_whole_ensemble(setup):
    """The port co-hosts such a job as a ``TrialEnsemble``: what the job
    serves alone. The JAX package's loader serves its first trial alone
    (the reference's fault, ROADMAP Queue 3)."""
    port, jax = (_serve_unstackable(name, setup) for name in ("port", "jax"))
    for run in (port, jax):
        assert run["cohosted"].shape == (5, 10) and np.isfinite(run["cohosted"]).all()
        assert np.abs(run["alone"] - run["first"]).max() > 1e-3
    assert np.abs(port["cohosted"] - port["alone"]).max() <= ENSEMBLE_ATOL
    np.testing.assert_allclose(port["cohosted"], jax["alone"], rtol=0, atol=BF16_PROB_ATOL)
    assert np.abs(jax["cohosted"] - jax["first"]).max() <= ENSEMBLE_ATOL


def test_serving_holds_the_heap_frozen_until_it_stops(setup):
    """A served job, and a co-hosted cohort, each hold one freeze of the
    heap (``utils/heap.py``) from creation to stop; the last stop thaws."""
    store, trials = setup["stores"]["port"]
    mgr = ServicesManager(store, make_params_store(setup["params_dir"]), device="cpu")
    before = heap.holders()
    try:
        job = store.create_inference_job(trials["J1"][0]["id"], None)["id"]
        mgr.create_inference_services(job, trials["J1"])
        assert heap.holders() == before + 1 and gc.get_freeze_count() > 0
        cohort = [store.create_inference_job(trials[j][0]["id"], None)["id"] for j in ("J0", "J2")]
        mgr.create_cohosted_inference_services(dict(zip(cohort, (trials["J0"], trials["J2"]))))
        assert heap.holders() == before + 2
        mgr.stop_inference_services(cohort[1])  # the primary's handle holds the cohort's
        assert heap.holders() == before + 2
        mgr.stop_inference_services(cohort[0])
        mgr.stop_inference_services(job)
        assert heap.holders() == before
    finally:
        mgr.stop_all()
    if before == 0:
        assert gc.get_freeze_count() == 0
