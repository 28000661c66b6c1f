"""The port's search plane against the JAX package's, on the CPU.

Every advisor decision leaves the same audit record in both packages
(``obs/search/audit.py``); the search ledger keeps the same books; the
seeded statistics, ``lineage.build``, ``reconstruct`` and the CLI verbs
(``sweep``, ``lineage``, ``resume``, ``curves --predicted``) give the
JAX functions' output on one journal, whichever package wrote it; a
doctored journal fails reconciliation in both; and ``decisions`` shows
the curve advisor's kills.
"""

import contextlib
import io
import json
import math

import numpy as np
import pytest
import torch

import rafiki_tpu.model.knobs as jax_knobs
import rafiki_tpu_torch.model.knobs as port_knobs
from rafiki_tpu.advisor import make_advisor as jax_make_advisor
from rafiki_tpu.advisor.service import AdvisorService as JaxAdvisorService
from rafiki_tpu.model.base import load_model_class as jax_load_model_class
from rafiki_tpu.obs import cli as jax_cli
from rafiki_tpu.obs.journal import journal as jax_journal, read_dir as jax_read_dir
from rafiki_tpu.obs.search import audit as jax_audit
from rafiki_tpu.obs.search import lineage as jax_lineage
from rafiki_tpu.obs.search import reconstruct as jax_reconstruct
from rafiki_tpu.obs.search import stats as jax_stats
from rafiki_tpu.obs.search.ledger import search_ledger as jax_search_ledger
from rafiki_tpu.store import MetaStore as JaxMetaStore, ParamsStore as JaxParamsStore
from rafiki_tpu.worker.train import InProcAdvisorHandle as JaxHandle, TrainWorker as JaxWorker
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.advisor import make_advisor
from rafiki_tpu_torch.advisor.service import AdvisorService
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.obs import cli
from rafiki_tpu_torch.obs.journal import journal, read_dir
from rafiki_tpu_torch.obs.search import audit, lineage, reconstruct, stats
from rafiki_tpu_torch.obs.search.ledger import search_ledger
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.worker.train import InProcAdvisorHandle, TrainWorker
from tests.test_torch_curve_kill import VOLATILE, _advisor_records, _KillLr

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

TRAIN = "synthetic://images?classes=5&n=128&w=8&h=8&seed=0"
VAL = "synthetic://images?classes=5&n=64&w=8&h=8&seed=1"


def _kc(k):
    return {"lr": k.FloatKnob(1e-4, 3e-2, is_exp=True), "units": k.IntegerKnob(4, 64),
            "b": k.FixedKnob(8)}


def _objective(knobs):
    """One interior optimum: the GP has something to exploit and the
    regret curve a real shape."""
    return round(1.0 - (math.log10(knobs["lr"]) + 2.5) ** 2 * 0.2
                 - abs(knobs["units"] - 32) / 64 * 0.2, 6)


@pytest.fixture
def journaled(tmp_path):
    for led in (search_ledger, jax_search_ledger):
        led.reset()
    journal.configure(tmp_path / "port", role="test")
    jax_journal.configure(tmp_path / "jax", role="test")
    try:
        yield tmp_path
    finally:
        journal.close()
        jax_journal.close()
        for led in (search_ledger, jax_search_ledger):
            led.reset()


def _close():
    journal.close()
    jax_journal.close()


# -- the decision audit ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gp", "tpe", "random"])
def test_every_engine_writes_the_jax_packages_audit_records(journaled, kind):
    """Seven proposals and scores, a doomed consolation and a q-batch
    through each engine of both packages: the same ``advisor/*`` records
    in the same order, field for field (acquisition internals included:
    the GP's EI, posterior mean and deviation, pool), the GP's fit
    seconds and the journal's clock fields aside."""
    for pkg, mk, k, aud in (("port", make_advisor, port_knobs, audit),
                            ("jax", jax_make_advisor, jax_knobs, jax_audit)):
        adv = mk(_kc(k), kind=kind, seed=3, n_initial=3) if kind != "random" else \
            mk(_kc(k), kind=kind, seed=3)
        adv.advisor_id, adv.job_id = "adv-audit", "job-audit"
        for i in range(7):
            knobs = adv.propose()
            if i == 4:
                aud.note_doomed(knobs)
                adv.feedback(0.0, knobs)
            else:
                adv.feedback(_objective(knobs), knobs)
        adv.propose_batch(3)
    _close()
    got = _advisor_records(journaled / "port", read_dir)
    want = _advisor_records(journaled / "jax", jax_read_dir)
    assert len(got) == len(want) == 7 + 7 + 3 + 1
    for a, b in zip(got, want):
        assert a == b, (a, b)
    phases = {r["acquisition"]["phase"] for r in got if r["name"] == "propose"}
    assert phases == {"gp": {"warmup", "ei"}, "tpe": {"warmup", "tpe", "epsilon"},
                      "random": {"random"}}[kind] or (kind == "tpe" and "tpe" in phases)
    assert [r["doomed"] for r in got if r["name"] == "feedback"].count(True) == 1


def test_ledger_keeps_the_jax_packages_books(journaled):
    """The same propose/doomed/kill/speculation/correction/feedback
    calls into both ledgers: the same counts, best and regret; the doomed
    wall charged apart from the scored one; the ``search`` collector and
    its gauges live."""
    for led in (search_ledger, jax_search_ledger):
        for h in ("a", "b", "c", "d"):
            led.note_propose(h)
        led.note_doomed("b")
        led.note_kill()
        led.note_speculation()
        led.note_correction()
        led.note_false_kill()
        for h, s in (("a", 0.6), ("b", 0.3), ("c", 0.8)):
            led.note_feedback(h, s)
    got, want = search_ledger.snapshot(), jax_search_ledger.snapshot()
    assert set(got) == set(want)
    for key in got:
        if not key.endswith("_s") and key != "effective_trials_per_hour":
            assert got[key] == want[key], key
    assert (got["n_scored"], got["n_doomed"], got["n_pending"], got["n_killed"]) == (2, 1, 1, 1)
    assert got["doomed_wall_s"] >= 0 and got["scored_wall_s"] >= 0
    snap = telemetry.snapshot()
    assert snap["gauges"]["search.best_score"] == 0.8 and "search" in snap


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_statistics_equal_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 9, 40):
        diffs = rng.normal(0.05, 0.1, size=n).tolist()
        for boot_seed in (0, 3):
            assert stats.bootstrap_ci(diffs, n_boot=500, seed=boot_seed) == \
                jax_stats.bootstrap_ci(diffs, n_boot=500, seed=boot_seed)
        assert stats.regret_curve(diffs) == jax_stats.regret_curve(diffs)


# -- one journal, both packages' readers ----------------------------------------------

PORT_SRC = b"""
from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import FixedKnob, FloatKnob
from rafiki_tpu_torch.models.ff import _Mlp


class SearchFF(TorchModel):
    @staticmethod
    def get_knob_config():
        return {"learning_rate": FloatKnob(1e-3, 3e-2, is_exp=True),
                "batch_size": FixedKnob(32), "epochs": FixedKnob(3), "seed": FixedKnob(0)}

    def build_module(self, num_classes, input_shape):
        return _Mlp(1, 16, num_classes, input_shape)
"""
JAX_SRC = b"""
from rafiki_tpu.model.knobs import FixedKnob, FloatKnob
from rafiki_tpu.models.ff import FeedForward


class SearchFF(FeedForward):
    @staticmethod
    def get_knob_config():
        return {"learning_rate": FloatKnob(1e-3, 3e-2, is_exp=True),
                "batch_size": FixedKnob(32), "epochs": FixedKnob(3), "seed": FixedKnob(0),
                "hidden_layers": FixedKnob(1), "hidden_units": FixedKnob(16)}
"""


def _job_journal(tmp_path, writer):
    """A journaled 5-trial random-advisor job in ``writer``'s package, a
    pack of two per round; in the port the pack's second member is
    early-killed (evicted ``killed``, its slot backfilled)."""
    if writer == "port":
        store_cls, params_cls, worker_cls, handle_cls, svc = \
            MetaStore, ParamsStore, TrainWorker, InProcAdvisorHandle, AdvisorService()
        cls, src = load_model_class(PORT_SRC, "SearchFF"), PORT_SRC
    else:
        store_cls, params_cls, worker_cls, handle_cls, svc = \
            JaxMetaStore, JaxParamsStore, JaxWorker, JaxHandle, JaxAdvisorService()
        cls, src = jax_load_model_class(JAX_SRC, "SearchFF"), JAX_SRC
    store = store_cls(tmp_path / writer / "meta.sqlite3")
    params = params_cls(tmp_path / writer / "params")
    mrow = store.create_model("searchff", "IMAGE_CLASSIFICATION", None, src, "SearchFF")
    job = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, TRAIN, VAL,
                                 {"MODEL_TRIAL_COUNT": 5})
    sub = store.create_sub_train_job(job["id"], mrow["id"])
    aid = svc.create_advisor(cls.get_knob_config(), kind="random", seed=2,
                             advisor_id="adv-job")
    svc.get(aid).job_id = job["id"]
    kw = {"devices": [torch.device("cpu")]} if writer == "port" else {}
    worker = worker_cls(store, params, sub["id"], cls, handle_cls(svc, aid), TRAIN, VAL,
                        {"MODEL_TRIAL_COUNT": 5}, async_persist=False, trial_pack=2, **kw)
    if writer == "port":
        # The advisor's second proposal (the first pack's second member).
        probe = make_advisor(cls.get_knob_config(), kind="random", seed=2)
        worker.curve = _KillLr([probe.propose() for _ in range(2)][1]["learning_rate"])
    assert worker.run() == 5
    return job["id"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lineage_and_reconstruct_equal_the_jax_functions(journaled, writer):
    job_id = _job_journal(journaled, writer)
    _close()
    recs = (read_dir if writer == "port" else jax_read_dir)(journaled / writer)
    got, want = lineage.build(recs), jax_lineage.build(recs)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert lineage.reconcile(got) == jax_lineage.reconcile(want) == []
    assert len(got) == 5
    for job in (None, job_id[:8]):
        doc = reconstruct.reconstruct(recs, job=job, boot_seed=1)
        assert json.dumps(doc, sort_keys=True) == \
            json.dumps(jax_reconstruct.reconstruct(recs, job=job, boot_seed=1), sort_keys=True)
        # A backfill may propose once more and find the budget drained.
        assert doc["reconciliation"]["ok"] and doc["n_proposals"] >= 5
        assert reconstruct.artifact(doc) == jax_reconstruct.artifact(doc)
    if writer == "port":
        doc = reconstruct.reconstruct(recs)
        killed = [p for p in doc["proposals"] if p.get("killed")]
        assert len(killed) == 1 and killed[0]["doomed"] and killed[0]["kill_epoch"] == 0
        assert doc["curve_advisor"]["n_kills"] == 1 and doc["n_doomed"] == 1
        [t] = [t for t in got.values() if t["trial_id"] == killed[0]["trial_id"]]
        # Closed by its terminal event, with its eviction on the walk.
        assert t["status"] == "trial_errored" and t["n_evictions"] == 1
        assert any(e["event"] == "pack_member_evicted" and e["reason"] == "killed"
                   for i in t["incarnations"] for e in i["events"])
        assert doc["lineage"]["n_backfilled"] >= 1


def _run_cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cli_verbs_print_what_the_jax_packages_print(journaled, writer):
    job_id = _job_journal(journaled, writer)
    _close()
    d = str(journaled / writer)
    for argv in (["sweep"], ["sweep", job_id[:8]], ["lineage"], ["lineage", "--check"],
                 ["curves", "--predicted"], ["--json", "curves", "--predicted"],
                 ["--json", "sweep"], ["resume"]):
        got = _run_cli(cli.main, ["--dir", d] + argv)
        want = _run_cli(jax_cli.main, ["--dir", d] + argv)
        assert got == want, (argv, got, want)
    rc, out, _ = _run_cli(cli.main, ["--dir", d, "sweep"])
    assert rc == 0 and "lineage: trials=5" in out
    rc, out, _ = _run_cli(cli.main, ["--dir", d, "curves", "--predicted"])
    assert rc == 0 and "predicted final=" in out
    # One trial by its id prefix, in both.
    tid = next(r["trial_id"] for r in (read_dir(d) if writer == "port" else jax_read_dir(d))
               if r.get("name") == "trial_started")
    assert _run_cli(cli.main, ["--dir", d, "lineage", tid[:10]]) == \
        _run_cli(jax_cli.main, ["--dir", d, "lineage", tid[:10]])


def test_decisions_show_the_curve_advisors_kills(journaled):
    _job_journal(journaled, "port")
    _close()
    rc, out, _ = _run_cli(cli.main, ["--dir", str(journaled / "port"), "decisions", "-n", "0"])
    assert rc == 0
    kills = [line for line in out.splitlines() if "  kill " in line]
    assert len(kills) == 1 and "epoch=0" in kills[0]
    assert "kill 1," in out.splitlines()[-1]
    rc, _, err = _run_cli(cli.main, ["--dir", str(journaled / "jax"), "decisions"])
    assert rc == 1 and "no decision records" in err


def test_a_doctored_journal_fails_reconciliation_in_both(journaled):
    adv = make_advisor(_kc(port_knobs), kind="gp", seed=5, n_initial=3)
    for _ in range(5):
        knobs = adv.propose()
        adv.feedback(_objective(knobs), knobs)
    # A score for an assignment no propose record chose.
    audit.record_feedback(adv, 0.99, {"lr": 0.5, "units": 7, "b": 8})
    _close()
    recs = read_dir(journaled / "port")
    for mod in (reconstruct, jax_reconstruct):
        doc = mod.reconstruct(recs)
        assert not doc["reconciliation"]["ok"]
        assert [e["type"] for e in doc["reconciliation"]["errors"]] == \
            ["feedback_without_propose"]
    for main in (cli.main, jax_cli.main):
        rc, _, err = _run_cli(main, ["--dir", str(journaled / "port"), "sweep"])
        assert rc == 1 and "RECONCILIATION FAILED" in err
    assert {k for r in recs for k in r} >= VOLATILE - {"trace_id"}
