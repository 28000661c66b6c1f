"""Durable sweep write-ahead log (docs/recovery.md).

The port's own copy of ``rafiki_tpu/scheduler/wal.py`` (``SweepWal``,
``read_wal``, ``WalReconcile``, ``reconcile``, ``wal_path`` and
``wal_dir``), with the same record grammar byte for byte, so a WAL
written by either package reconciles in the other.

The observability journals (``obs/journal.py``) are *best effort*: line
buffered, per-process, rotated: fine for reconstruction, useless as a
correctness substrate because a SIGKILL can eat the tail. The
control-plane decisions of a sweep (budget claims, pack assignments,
backfills, advisor feedback) need the opposite contract: every
mutation is preceded by an fsynced ``intent`` record and followed by
an fsynced ``commit``, so a fresh process adopting a dead supervisor's
job (``scheduler/recovery.py resume_sweep``) can reconcile exactly
what the dead process was doing against the MetaStore rows that
actually landed.

Record grammar (one JSON object per line)::

    {"lsn": 7, "ts": ..., "pid": ..., "gen": 0,
     "rec": "intent" | "commit" | "note",
     "op":  "budget_claim" | "pack_assign" | "backfill"
          | "advisor_feedback" | "adopt" | "sweep_config" | ...,
     "txn": "w<pid>-<rand>-3",     # intent/commit only; commit refs its intent
     ...op-specific fields}

* ``intent``: written (and fsynced) BEFORE the mutation executes.
* ``commit``: written after; carries the outcome (``trial_id`` for a
  claim that landed, ``denied=True`` for an atomic claim the store
  refused because the budget drained).
* ``note``: durable facts that are not two-phase (the sweep config a
  resumer needs to rehydrate the advisor, adoption markers).

The WAL lives NEXT TO the MetaStore sqlite file (``<db dir>/wal/
sweep-<job_id>.wal``, overridable via ``RAFIKI_WAL_DIR``): the same
durability domain as the rows it journals, discoverable by a resumer
that only knows the store path and the job id. Appends from several
processes (the dead supervisor, then its resumer) are safe: the file
is opened O_APPEND and records carry pid + generation.

Reconciliation (``reconcile``) proves the budget invariant "every
slot claimed exactly once": every committed claim must reference an
existing trial row, every trial row must be covered by exactly one
claim (committed, or an in-doubt intent resolved by knobs-hash match:
the MetaStore claim+insert is one sqlite txn, so an intent without a
commit either fully landed or never happened), and the sub's
``claimed`` counter must equal the row count.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.obs.search.audit import knobs_hash as _khash

ENV_WAL_DIR = "RAFIKI_WAL_DIR"

#: ops whose intent/commit pairs claim (or assign) budgeted work.
CLAIM_OPS = ("budget_claim", "backfill")


class WalError(RuntimeError):
    """A structurally broken WAL (torn non-tail line, commit without
    intent) - distinct from a *reconciliation* failure against the
    store, which is a :class:`WalReconcileError`."""


class WalReconcileError(RuntimeError):
    """WAL-vs-store reconciliation failed: the log claims a state the
    MetaStore does not corroborate (e.g. a committed budget claim with
    no trial row). Resume must NOT proceed past this - adopting a job
    whose accounting is provably wrong would compound the damage."""

    def __init__(self, errors: List[Dict[str, Any]]):
        self.errors = list(errors)
        super().__init__(
            f"sweep WAL reconciliation failed: {len(self.errors)} "
            f"error(s): " + "; ".join(sorted({e["type"] for e in self.errors})))


def wal_dir(store_path: str) -> Path:
    env = os.environ.get(ENV_WAL_DIR, "").strip()
    if env:
        return Path(env)
    return Path(os.path.dirname(os.path.abspath(str(store_path)))) / "wal"


def wal_path(store_path: str, job_id: str) -> Path:
    return wal_dir(store_path) / f"sweep-{job_id}.wal"


class SweepWal:
    """Append-only fsynced intent/commit log for one train job's sweep.

    Thread-safe (the supervisor, chip runners and backfill closures all
    write); every ``intent``/``commit``/``note`` is flushed AND fsynced
    before returning, so a record the caller observed written survives
    a SIGKILL of the whole process.
    """

    def __init__(self, path: Path | str, generation: int = 0):
        self.path = Path(path)
        self.generation = int(generation)
        self._lock = threading.Lock()
        self._fh = None
        self._lsn = 0
        self._txn_no = 0
        # Txn ids must be unique across every writer that ever appends
        # to this file - pid alone is not enough (one resume process
        # opens two handles: the adoption-phase log and the
        # continuation run_sweep's; pids also recycle), so each handle
        # gets its own random discriminator.
        self._txn_prefix = f"w{os.getpid()}-{uuid.uuid4().hex[:6]}"

    # -- lifecycle ----------------------------------------------------------

    @classmethod
    def for_job(cls, store, job_id: str, generation: int = 0) -> "SweepWal":
        return cls(wal_path(store.path, job_id), generation=generation)

    def exists(self) -> bool:
        try:
            return self.path.stat().st_size > 0
        except OSError:
            return False

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None

    def _ensure_open_locked(self):
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    # -- writers ------------------------------------------------------------

    def _write_locked(self, rec: str, op: str, txn: Optional[str],
                      fields: Dict[str, Any]) -> None:
        fh = self._ensure_open_locked()
        self._lsn += 1
        row = {"lsn": self._lsn, "ts": round(time.time(), 6),
               "pid": os.getpid(), "gen": self.generation,
               "rec": rec, "op": op}
        if txn is not None:
            row["txn"] = txn
        row.update(fields)
        fh.write(json.dumps(row, sort_keys=True, default=str) + "\n")
        # The whole point of this module: the record is on disk before
        # the mutation it announces. flush() alone dies with the page
        # cache on power loss and proves nothing under SIGKILL ordering
        # arguments; fsync is the contract docs/recovery.md documents.
        fh.flush()
        os.fsync(fh.fileno())

    def intent(self, op: str, **fields: Any) -> str:
        """Durably announce a mutation BEFORE executing it. Returns the
        txn id the matching :meth:`commit` must reference."""
        with self._lock:
            self._txn_no += 1
            txn = f"{self._txn_prefix}-{self._txn_no}"
            self._write_locked("intent", op, txn, fields)
            return txn

    def commit(self, txn: str, op: str, **fields: Any) -> None:
        """Durably record the outcome of an intented mutation."""
        with self._lock:
            self._write_locked("commit", op, txn, fields)

    def note(self, op: str, **fields: Any) -> None:
        """A durable single-shot fact (sweep config, adoption marker)."""
        with self._lock:
            self._write_locked("note", op, None, fields)


# ---------------------------------------------------------------------------
# Readers + reconciliation
# ---------------------------------------------------------------------------

def read_wal(path: Path | str) -> List[Dict[str, Any]]:
    """Parse a WAL file. A torn FINAL line (the process died mid-write,
    before its fsync returned - so the writer never acted on it) is
    dropped silently; a torn interior line is corruption and raises."""
    p = Path(path)
    if not p.exists():
        return []
    raw = p.read_text(encoding="utf-8", errors="replace").splitlines()
    out: List[Dict[str, Any]] = []
    for i, line in enumerate(raw):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            if i == len(raw) - 1:
                break  # torn tail: never acknowledged, never acted on
            raise WalError(f"{p}: corrupt WAL record at line {i + 1}")
    return out


@dataclass
class WalReconcile:
    """The verdict of WAL-vs-store reconciliation for one sub job."""

    ok: bool = True
    errors: List[Dict[str, Any]] = field(default_factory=list)
    #: trial_id -> number of WAL claims covering it (committed or
    #: resolved in-doubt). The budget invariant is all-values == 1.
    claims: Dict[str, int] = field(default_factory=dict)
    #: intents that never committed, resolved against the store:
    #: [{"txn", "op", "landed": bool}]
    in_doubt: List[Dict[str, Any]] = field(default_factory=list)
    denied: int = 0

    def _err(self, type_: str, **fields: Any) -> None:
        self.ok = False
        self.errors.append({"type": type_, **fields})

    def raise_if_failed(self) -> None:
        if not self.ok:
            raise WalReconcileError(self.errors)

    def summary(self) -> Dict[str, Any]:
        return {"ok": self.ok, "n_claims": len(self.claims),
                "n_in_doubt": len(self.in_doubt), "denied": self.denied,
                "errors": self.errors}


def reconcile(records: List[Dict[str, Any]], trials: List[Dict[str, Any]],
              sub: Optional[Dict[str, Any]] = None,
              sub_id: Optional[str] = None) -> WalReconcile:
    """Prove (or refute) the budget invariant for one sub-train-job.

    ``trials`` are the MetaStore rows of the sub; ``sub`` (optional)
    supplies the atomic ``claimed`` counter to cross-check; ``sub_id``
    restricts claim records to one sub of a multi-model job (claim
    intents carry their sub). Claim-class ops (``budget_claim``/
    ``backfill``) are the audited set; assignment ops (``pack_assign``)
    are checked only for intent/commit pairing.
    """
    r = WalReconcile()
    trials = [dict(t) for t in trials]
    for t in trials:
        if not t.get("knobs_hash") and isinstance(t.get("knobs"), dict):
            t["knobs_hash"] = _khash(t["knobs"])
    rows_by_id = {t["id"]: t for t in trials}
    intents: Dict[str, Dict[str, Any]] = {}
    commits: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        kind = rec.get("rec")
        if kind == "intent":
            intents[rec["txn"]] = rec
        elif kind == "commit":
            txn = rec.get("txn")
            if txn not in intents:
                r._err("commit_without_intent", txn=txn, op=rec.get("op"))
                continue
            if txn in commits:
                r._err("double_commit", txn=txn, op=rec.get("op"))
                continue
            commits[txn] = rec

    def _in_scope(txn: str) -> bool:
        it = intents.get(txn)
        return (sub_id is None or it is None
                or it.get("sub_id") in (None, sub_id))

    # 1. Committed claims must reference real rows, each exactly once.
    for txn, c in commits.items():
        if c.get("op") not in CLAIM_OPS or not _in_scope(txn):
            continue
        if c.get("denied"):
            r.denied += 1
            continue
        tid = c.get("trial_id")
        if tid is None or tid not in rows_by_id:
            r._err("committed_unclaimed", txn=txn, trial_id=tid,
                   op=c.get("op"))
            continue
        r.claims[tid] = r.claims.get(tid, 0) + 1

    # 2. In-doubt intents (no commit): the store claim+insert is one
    #    sqlite transaction, so the slot either fully landed (an
    #    as-yet-unclaimed row with this intent's knobs hash exists) or
    #    never happened. Either way, resolvable.
    for txn, it in intents.items():
        if txn in commits or it.get("op") not in CLAIM_OPS:
            continue
        if sub_id is not None and it.get("sub_id") not in (None, sub_id):
            continue
        landed = None
        h = it.get("knobs_hash")
        if h:
            for t in trials:
                if t["id"] in r.claims:
                    continue
                if t.get("knobs_hash") == h:
                    landed = t["id"]
                    break
        if landed is not None:
            r.claims[landed] = r.claims.get(landed, 0) + 1
        r.in_doubt.append({"txn": txn, "op": it.get("op"),
                           "landed": landed is not None})

    for tid, n in r.claims.items():
        if n != 1:
            r._err("duplicate_claim", trial_id=tid, n=n)

    # 3. Every store row must be covered by a WAL claim, and the
    #    atomic counter must agree with the row count.
    for t in trials:
        if t["id"] not in r.claims:
            r._err("unlogged_claim", trial_id=t["id"])
    if sub is not None and sub.get("claimed") is not None:
        if int(sub["claimed"]) != len(trials):
            r._err("claimed_counter_mismatch", claimed=int(sub["claimed"]),
                   rows=len(trials))
    return r
