"""The sweep's write-ahead log in the port against the JAX package's, on
the CPU (the counterpart of ``tests/test_recovery.py``'s WAL tests).

Each package's ``SweepWal`` writes the same record grammar
(``intent``/``commit``/``note`` lines with ``lsn``, ``gen``, ``pid``,
``ts``, ``txn``), so a WAL written by either reconciles in the other,
with equal summaries; the reconcile verdicts on the same records and
rows are the JAX package's, the doctored cases included.
"""

import json

import pytest
import torch

from rafiki_tpu.obs.search.audit import knobs_hash as jax_knobs_hash
from rafiki_tpu.scheduler import wal as jax_wal
from rafiki_tpu_torch.obs.search.audit import knobs_hash
from rafiki_tpu_torch.scheduler import wal

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

PACKAGES = {"jax": jax_wal, "port": wal}


def test_wal_roundtrip_and_torn_tail(tmp_path):
    p = tmp_path / "wal" / "sweep-j1.wal"
    w = wal.SweepWal(p, generation=0)
    txn = w.intent("budget_claim", sub_id="s1", knobs_hash="h1")
    w.commit(txn, "budget_claim", trial_id="t1")
    w.note("sweep_config", advisor_kind="gp", chips=2)
    w.close()

    recs = wal.read_wal(p)
    assert [r["rec"] for r in recs] == ["intent", "commit", "note"]
    assert recs[0]["txn"] == recs[1]["txn"] == txn
    assert recs[0]["lsn"] == 1 and recs[2]["gen"] == 0
    assert recs == jax_wal.read_wal(p)

    # A torn FINAL line (death mid-write, before the fsync returned: the
    # writer never acted on it) is dropped silently, in both packages.
    with open(p, "a") as fh:
        fh.write('{"lsn": 4, "rec": "inte')
    assert len(wal.read_wal(p)) == len(jax_wal.read_wal(p)) == 3

    # A torn INTERIOR line is corruption, not a crash artifact.
    lines = p.read_text().splitlines()
    lines[1] = lines[1][:10]
    p.write_text("\n".join(lines) + "\n")
    with pytest.raises(wal.WalError):
        wal.read_wal(p)
    with pytest.raises(jax_wal.WalError):
        jax_wal.read_wal(p)


def test_wal_txn_ids_unique_across_handles(tmp_path):
    """Two handles on one file (a resume process opens the adoption
    phase's log AND the continuation's) never collide on txn ids,
    though they share a pid; nor do the two packages' handles."""
    p = tmp_path / "w.wal"
    a, b = wal.SweepWal(p), wal.SweepWal(p, generation=1)
    c = jax_wal.SweepWal(p, generation=2)
    txns = {a.intent("budget_claim"), b.intent("budget_claim"), c.intent("budget_claim"),
            a.intent("backfill"), b.intent("backfill"), c.intent("backfill")}
    a.close(), b.close(), c.close()
    assert len(txns) == 6
    assert len({r["txn"] for r in wal.read_wal(p)}) == 6


def test_wal_paths_and_dir_env(tmp_path, monkeypatch):
    db = tmp_path / "meta.sqlite3"
    monkeypatch.delenv(wal.ENV_WAL_DIR, raising=False)
    assert wal.wal_path(db, "j1") == jax_wal.wal_path(db, "j1") == tmp_path / "wal" / "sweep-j1.wal"
    monkeypatch.setenv(wal.ENV_WAL_DIR, str(tmp_path / "elsewhere"))
    assert wal.wal_path(db, "j1") == jax_wal.wal_path(db, "j1") == \
        tmp_path / "elsewhere" / "sweep-j1.wal"


@pytest.mark.parametrize("knobs", [{"learning_rate": 0.003},
                                   {"lr": 1e-3, "batch_size": 32, "name": "x", "epochs": 3},
                                   {}])
def test_knobs_hash_is_the_jax_packages(knobs):
    assert knobs_hash(knobs) == jax_knobs_hash(knobs)


def _summaries(records, trials, **kw):
    got = wal.reconcile(records, trials, **kw)
    want = jax_wal.reconcile(records, trials, **kw)
    assert got.summary() == want.summary()
    assert (got.claims, got.in_doubt, got.denied) == (want.claims, want.in_doubt, want.denied)
    return got


def test_reconcile_proves_clean_accounting():
    trials = [{"id": "t1", "knobs": {"lr": 0.01}, "no": 1}]
    records = [
        {"rec": "intent", "op": "budget_claim", "txn": "w1-ab-1", "sub_id": "s1"},
        {"rec": "commit", "op": "budget_claim", "txn": "w1-ab-1", "trial_id": "t1"},
        {"rec": "intent", "op": "budget_claim", "txn": "w1-ab-2", "sub_id": "s1"},
        {"rec": "commit", "op": "budget_claim", "txn": "w1-ab-2", "denied": True},
    ]
    r = _summaries(records, trials, sub={"claimed": 1}, sub_id="s1")
    assert r.ok, r.errors
    assert r.claims == {"t1": 1} and r.denied == 1


def test_reconcile_catches_doctored_wal():
    """The polarity check: a committed-but-unclaimed slot (the WAL says a
    claim landed; no store row exists) is CAUGHT, and so is a store row
    no claim covers."""
    records = [
        {"rec": "intent", "op": "budget_claim", "txn": "w1-cd-1"},
        {"rec": "commit", "op": "budget_claim", "txn": "w1-cd-1", "trial_id": "ghost"},
    ]
    r = _summaries(records, [])
    assert not r.ok
    assert {e["type"] for e in r.errors} == {"committed_unclaimed"}
    with pytest.raises(wal.WalReconcileError, match="committed_unclaimed"):
        r.raise_if_failed()
    r2 = _summaries([], [{"id": "tX", "knobs": {}, "no": 1}])
    assert {e["type"] for e in r2.errors} == {"unlogged_claim"}
    # A commit without its intent, a double commit, a double claim and a
    # counter that disagrees with the rows.
    doctored = [
        {"rec": "commit", "op": "budget_claim", "txn": "w1-x-9", "trial_id": "t1"},
        {"rec": "intent", "op": "budget_claim", "txn": "w1-x-1"},
        {"rec": "commit", "op": "budget_claim", "txn": "w1-x-1", "trial_id": "t1"},
        {"rec": "commit", "op": "budget_claim", "txn": "w1-x-1", "trial_id": "t1"},
        {"rec": "intent", "op": "backfill", "txn": "w1-x-2"},
        {"rec": "commit", "op": "backfill", "txn": "w1-x-2", "trial_id": "t1"},
    ]
    r3 = _summaries(doctored, [{"id": "t1", "knobs": {}, "no": 1}], sub={"claimed": 2})
    assert {e["type"] for e in r3.errors} == {"commit_without_intent", "double_commit",
                                             "duplicate_claim", "claimed_counter_mismatch"}


def test_reconcile_resolves_in_doubt_intent_by_knobs_hash():
    knobs = {"learning_rate": 0.003}
    trials = [{"id": "t1", "knobs": knobs, "no": 1}]
    records = [{"rec": "intent", "op": "budget_claim", "txn": "w9-ef-1",
                "knobs_hash": knobs_hash(knobs)},
               # never landed: no row carries its hash
               {"rec": "intent", "op": "budget_claim", "txn": "w9-ef-2",
                "knobs_hash": knobs_hash({"learning_rate": 0.02})}]
    r = _summaries(records, trials)
    assert r.ok, r.errors
    assert r.in_doubt == [{"txn": "w9-ef-1", "op": "budget_claim", "landed": True},
                          {"txn": "w9-ef-2", "op": "budget_claim", "landed": False}]
    assert r.claims == {"t1": 1}


def _write_sweep(pkg, path):
    """A sweep's worth of records through ``pkg``'s writer: the config,
    three claims (one denied), an in-doubt claim that landed, a pack
    assignment, a backfill and advisor feedback."""
    w = pkg.SweepWal(path, generation=0)
    w.note("sweep_config", job_id="j1", advisor_kind="gp", advisor_kwargs={}, chips=2,
           trials_per_chip=2)
    for tid, lr in (("t1", 0.001), ("t2", 0.002)):
        txn = w.intent("budget_claim", sub_id="s1", knobs_hash=knobs_hash({"lr": lr}))
        w.commit(txn, "budget_claim", trial_id=tid)
    w.intent("budget_claim", sub_id="s1", knobs_hash=knobs_hash({"lr": 0.003}))
    txn = w.intent("pack_assign", chip=0, trial_ids=["t1", "t2"])
    w.commit(txn, "pack_assign")
    txn = w.intent("backfill", sub_id="s1", knobs_hash=knobs_hash({"lr": 0.004}))
    w.commit(txn, "backfill", trial_id="t4")
    txn = w.intent("budget_claim", sub_id="s1", knobs_hash=knobs_hash({"lr": 0.005}))
    w.commit(txn, "budget_claim", denied=True)
    txn = w.intent("advisor_feedback", score=0.5, knobs_hash=knobs_hash({"lr": 0.001}))
    w.commit(txn, "advisor_feedback")
    w.close()


ROWS = [{"id": "t1", "knobs": {"lr": 0.001}, "no": 1},
        {"id": "t2", "knobs": {"lr": 0.002}, "no": 2},
        {"id": "t3", "knobs": {"lr": 0.003}, "no": 3},
        {"id": "t4", "knobs": {"lr": 0.004}, "no": 4}]


def _shape(records):
    """A record without what differs by writer: its time, pid and txn."""
    return [{k: v for k, v in r.items() if k not in ("ts", "pid", "txn")} for r in records]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_wal_written_by_each_package_reconciles_in_the_other(writer, tmp_path):
    path = tmp_path / "sweep-j1.wal"
    _write_sweep(PACKAGES[writer], path)
    other = tmp_path / "other.wal"
    _write_sweep(PACKAGES["port" if writer == "jax" else "jax"], other)
    # The same grammar, line for line: keys, order of keys, values.
    lines = path.read_text().splitlines()
    assert [list(json.loads(x)) for x in lines] == \
        [list(json.loads(x)) for x in other.read_text().splitlines()]
    records = wal.read_wal(path)
    assert records == jax_wal.read_wal(path)
    assert _shape(records) == _shape(wal.read_wal(other))
    r = _summaries(records, ROWS, sub={"claimed": 4}, sub_id="s1")
    assert r.ok, r.errors
    assert r.claims == {"t1": 1, "t2": 1, "t3": 1, "t4": 1} and r.denied == 1
    assert r.in_doubt == [{"txn": records[5]["txn"], "op": "budget_claim", "landed": True}]
