"""Meta store: all control-plane state in one sqlite3 file.

The port's own copy of ``rafiki_tpu/store/meta.py`` ``MetaStore``,
with the same SQLite schema, queries and atomic trial-slot claim
(``create_trial(..., budget_max=)``), so a database written by either
package reads the same in the other. Ported: users (with listing and
banning), models (with listing), train jobs (+ per-model sub-jobs),
trials (knobs JSON, score, params ref, status, logs), inference jobs
and services, and the recovery queries (``mark_trial_as_running``,
the compare-and-swap ``adopt_trial``, ``mark_trial_as_terminated``,
``get_orphaned_trials``) in the same SQL, so either package adopts the
other's orphans. A service heartbeat passes the ``store.heartbeat``
chaos site (``skip`` ages the lease the orphan sweep reads).
``get_jobs_with_dead_supervisor`` is the sweep resume reaper's
detection query (``admin/services_manager.py``). Writes are short
transactions; trial claiming uses an atomic UPDATE so concurrent
workers never double-run a trial.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.constants import (
    InferenceJobStatus,
    ServiceStatus,
    ServiceType,
    TrainJobStatus,
    TrialStatus,
)

_SCHEMA = """
PRAGMA journal_mode=WAL;
CREATE TABLE IF NOT EXISTS users (
    id TEXT PRIMARY KEY, email TEXT UNIQUE NOT NULL,
    password_hash TEXT NOT NULL, user_type TEXT NOT NULL,
    banned INTEGER DEFAULT 0, created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS models (
    id TEXT PRIMARY KEY, name TEXT NOT NULL, task TEXT NOT NULL,
    user_id TEXT, model_file BLOB NOT NULL, model_class TEXT NOT NULL,
    dependencies TEXT DEFAULT '{}', access_right TEXT DEFAULT 'PRIVATE',
    docs TEXT DEFAULT '', created_at REAL NOT NULL,
    UNIQUE(name, user_id)
);
CREATE TABLE IF NOT EXISTS train_jobs (
    id TEXT PRIMARY KEY, app TEXT NOT NULL, app_version INTEGER NOT NULL,
    task TEXT NOT NULL, user_id TEXT,
    train_dataset_uri TEXT NOT NULL, val_dataset_uri TEXT NOT NULL,
    budget TEXT NOT NULL, status TEXT NOT NULL,
    created_at REAL NOT NULL, stopped_at REAL,
    UNIQUE(app, app_version, user_id)
);
CREATE TABLE IF NOT EXISTS sub_train_jobs (
    id TEXT PRIMARY KEY, train_job_id TEXT NOT NULL, model_id TEXT NOT NULL,
    status TEXT NOT NULL, advisor_id TEXT, claimed INTEGER DEFAULT 0,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS trials (
    id TEXT PRIMARY KEY, sub_train_job_id TEXT NOT NULL, no INTEGER NOT NULL,
    model_name TEXT NOT NULL, knobs TEXT NOT NULL, status TEXT NOT NULL,
    score REAL, params_id TEXT, worker_id TEXT, shape_sig TEXT,
    service_id TEXT,
    error TEXT, started_at REAL, stopped_at REAL, created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS trial_logs (
    id INTEGER PRIMARY KEY AUTOINCREMENT, trial_id TEXT NOT NULL,
    time REAL NOT NULL, entry TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS inference_jobs (
    id TEXT PRIMARY KEY, train_job_id TEXT NOT NULL, user_id TEXT,
    status TEXT NOT NULL, predictor_host TEXT,
    created_at REAL NOT NULL, stopped_at REAL
);
CREATE TABLE IF NOT EXISTS services (
    id TEXT PRIMARY KEY, service_type TEXT NOT NULL, status TEXT NOT NULL,
    job_id TEXT, worker_index INTEGER, devices TEXT,
    heartbeat_at REAL, created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_trials_sub_job ON trials(sub_train_job_id);
CREATE INDEX IF NOT EXISTS idx_trials_score ON trials(status, score);
CREATE INDEX IF NOT EXISTS idx_trial_logs ON trial_logs(trial_id);
"""


def _now() -> float:
    return time.time()


def _uid() -> str:
    return uuid.uuid4().hex


class MetaStore:
    """Typed CRUD over sqlite3; safe across threads and processes."""

    def __init__(self, db_path: str | os.PathLike):
        self._path = str(db_path)
        self._local = threading.local()
        with self._conn() as c:
            c.executescript(_SCHEMA)
            self._migrate(c)

    @staticmethod
    def _migrate(c: sqlite3.Connection) -> None:
        """Additive migrations for databases created by older versions."""
        cols = {r[1] for r in c.execute("PRAGMA table_info(trials)")}
        if "service_id" not in cols:
            c.execute("ALTER TABLE trials ADD COLUMN service_id TEXT")

    @property
    def path(self) -> str:
        """Filesystem path of the sqlite file (subprocess workers reopen it)."""
        return self._path

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self._path, timeout=30.0)
            conn.row_factory = sqlite3.Row
            conn.execute("PRAGMA busy_timeout=30000")
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
        return conn

    def _one(self, sql: str, args=()) -> Optional[dict]:
        row = self._conn().execute(sql, args).fetchone()
        return dict(row) if row else None

    def _all(self, sql: str, args=()) -> List[dict]:
        return [dict(r) for r in self._conn().execute(sql, args).fetchall()]

    # -- users ---------------------------------------------------------------

    def create_user(self, email: str, password_hash: str, user_type: str) -> dict:
        uid = _uid()
        with self._conn() as c:
            c.execute(
                "INSERT INTO users (id, email, password_hash, user_type, created_at)"
                " VALUES (?,?,?,?,?)",
                (uid, email, password_hash, user_type, _now()),
            )
        return self.get_user(uid)

    def get_user(self, user_id: str) -> Optional[dict]:
        return self._one("SELECT * FROM users WHERE id=?", (user_id,))

    def get_user_by_email(self, email: str) -> Optional[dict]:
        return self._one("SELECT * FROM users WHERE email=?", (email,))

    def ban_user(self, user_id: str, banned: bool = True) -> None:
        with self._conn() as c:
            c.execute("UPDATE users SET banned=? WHERE id=?", (int(banned), user_id))

    def get_users(self) -> List[dict]:
        return self._all("SELECT * FROM users ORDER BY created_at")

    # -- models --------------------------------------------------------------

    def create_model(self, name: str, task: str, user_id: Optional[str],
                     model_file: bytes, model_class: str,
                     dependencies: Optional[Dict[str, str]] = None,
                     access_right: str = "PRIVATE", docs: str = "") -> dict:
        mid = _uid()
        with self._conn() as c:
            c.execute(
                "INSERT INTO models (id, name, task, user_id, model_file, model_class,"
                " dependencies, access_right, docs, created_at) VALUES (?,?,?,?,?,?,?,?,?,?)",
                (mid, name, task, user_id, model_file, model_class,
                 json.dumps(dependencies or {}), access_right, docs, _now()),
            )
        return self.get_model(mid)

    def get_model(self, model_id: str) -> Optional[dict]:
        m = self._one("SELECT * FROM models WHERE id=?", (model_id,))
        return self._load_model_row(m)

    def get_model_by_name(self, name: str, user_id: Optional[str] = None) -> Optional[dict]:
        if user_id is not None:
            m = self._one("SELECT * FROM models WHERE name=? AND user_id=?", (name, user_id))
            if m:
                return self._load_model_row(m)
        m = self._one("SELECT * FROM models WHERE name=? ORDER BY created_at DESC", (name,))
        return self._load_model_row(m)

    def get_models(self) -> List[dict]:
        return [self._load_model_row(m) for m in
                self._all("SELECT * FROM models ORDER BY created_at")]

    def get_models_of_task(self, task: str) -> List[dict]:
        return [self._load_model_row(m) for m in
                self._all("SELECT * FROM models WHERE task=? ORDER BY created_at", (task,))]

    @staticmethod
    def _load_model_row(m: Optional[dict]) -> Optional[dict]:
        if m is None:
            return None
        m["dependencies"] = json.loads(m["dependencies"])
        return m

    # -- train jobs ----------------------------------------------------------

    def create_train_job(self, app: str, task: str, user_id: Optional[str],
                         train_dataset_uri: str, val_dataset_uri: str,
                         budget: Dict[str, Any]) -> dict:
        prev = self._one(
            "SELECT MAX(app_version) AS v FROM train_jobs WHERE app=? AND user_id IS ?",
            (app, user_id))
        version = (prev["v"] or 0) + 1
        jid = _uid()
        with self._conn() as c:
            c.execute(
                "INSERT INTO train_jobs (id, app, app_version, task, user_id,"
                " train_dataset_uri, val_dataset_uri, budget, status, created_at)"
                " VALUES (?,?,?,?,?,?,?,?,?,?)",
                (jid, app, version, task, user_id, train_dataset_uri, val_dataset_uri,
                 json.dumps(budget), TrainJobStatus.STARTED.value, _now()),
            )
        return self.get_train_job(jid)

    def get_train_job(self, job_id: str) -> Optional[dict]:
        j = self._one("SELECT * FROM train_jobs WHERE id=?", (job_id,))
        if j:
            j["budget"] = json.loads(j["budget"])
        return j

    def get_train_job_by_app(self, app: str, app_version: int = -1,
                             user_id: Optional[str] = None) -> Optional[dict]:
        """``user_id`` scopes the lookup to that user's jobs (pass None
        for an unscoped/admin lookup)."""
        q = "SELECT * FROM train_jobs WHERE app=?"
        args: list = [app]
        if app_version > 0:
            q += " AND app_version=?"
            args.append(app_version)
        if user_id is not None:
            q += " AND user_id=?"
            args.append(user_id)
        q += " ORDER BY app_version DESC"
        j = self._one(q, tuple(args))
        if j:
            j["budget"] = json.loads(j["budget"])
        return j

    def get_train_jobs(self, user_id: Optional[str] = None) -> List[dict]:
        rows = (self._all("SELECT * FROM train_jobs WHERE user_id=? ORDER BY created_at", (user_id,))
                if user_id else self._all("SELECT * FROM train_jobs ORDER BY created_at"))
        for j in rows:
            j["budget"] = json.loads(j["budget"])
        return rows

    def update_train_job_status(self, job_id: str, status: str) -> None:
        stopped = _now() if status in (TrainJobStatus.STOPPED.value,
                                       TrainJobStatus.COMPLETED.value,
                                       TrainJobStatus.ERRORED.value) else None
        with self._conn() as c:
            if stopped:
                c.execute("UPDATE train_jobs SET status=?, stopped_at=? WHERE id=?",
                          (status, stopped, job_id))
            else:
                c.execute("UPDATE train_jobs SET status=? WHERE id=?", (status, job_id))

    # -- sub train jobs (one per model in the job) --------------------------

    def create_sub_train_job(self, train_job_id: str, model_id: str,
                             advisor_id: Optional[str] = None) -> dict:
        sid = _uid()
        with self._conn() as c:
            c.execute(
                "INSERT INTO sub_train_jobs (id, train_job_id, model_id, status,"
                " advisor_id, created_at) VALUES (?,?,?,?,?,?)",
                (sid, train_job_id, model_id, TrainJobStatus.STARTED.value,
                 advisor_id, _now()),
            )
        return self._one("SELECT * FROM sub_train_jobs WHERE id=?", (sid,))

    def get_sub_train_job(self, sub_id: str) -> Optional[dict]:
        return self._one("SELECT * FROM sub_train_jobs WHERE id=?", (sub_id,))

    def get_sub_train_jobs(self, train_job_id: str) -> List[dict]:
        return self._all("SELECT * FROM sub_train_jobs WHERE train_job_id=?", (train_job_id,))

    def update_sub_train_job(self, sub_id: str, status: Optional[str] = None,
                             advisor_id: Optional[str] = None) -> None:
        with self._conn() as c:
            if status is not None:
                c.execute("UPDATE sub_train_jobs SET status=? WHERE id=?", (status, sub_id))
            if advisor_id is not None:
                c.execute("UPDATE sub_train_jobs SET advisor_id=? WHERE id=?", (advisor_id, sub_id))

    @staticmethod
    def _claim_slot(c: sqlite3.Connection, sub_id: str, max_trials: int) -> bool:
        """Claim one of ``max_trials`` trial slots inside the caller's
        open transaction; False = budget exhausted. The single source of
        the budget-gate SQL for both claim forms below."""
        cur = c.execute(
            "UPDATE sub_train_jobs SET claimed = claimed + 1"
            " WHERE id=? AND claimed < ?", (sub_id, int(max_trials)))
        return cur.rowcount > 0

    def claim_trial_slot(self, sub_id: str, max_trials: int) -> bool:
        """Standalone atomic slot claim — the concurrency gate that
        stops N workers racing past a trial-count budget (the reference
        leaned on Postgres transactions for the same invariant).
        Production workers use ``create_trial(budget_max=...)`` instead,
        which claims in the same transaction as the row insert; this
        form remains for callers that size work before creating rows."""
        with self._conn() as c:
            return self._claim_slot(c, sub_id, max_trials)

    # -- trials --------------------------------------------------------------

    def create_trial(self, sub_train_job_id: str, model_name: str,
                     knobs: Dict[str, Any], worker_id: Optional[str] = None,
                     shape_sig: Optional[str] = None,
                     service_id: Optional[str] = None,
                     budget_max: Optional[int] = None) -> Optional[dict]:
        """Insert a RUNNING trial row; with ``budget_max``, a trial-count
        slot is claimed in the SAME write transaction (claimed++ guarded
        by claimed < budget_max) and None is returned when the budget is
        exhausted. The combined form exists for crash safety: a worker
        killed between a separate ``claim_trial_slot`` and the insert
        would leak the slot and silently shrink the job's budget."""
        tid = _uid()
        with self._conn() as c:
            if budget_max is not None and not self._claim_slot(
                    c, sub_train_job_id, budget_max):
                return None
            # 'no' is assigned inside the INSERT's write transaction so
            # concurrent workers can't get duplicate trial numbers.
            c.execute(
                "INSERT INTO trials (id, sub_train_job_id, no, model_name, knobs, status,"
                " worker_id, shape_sig, service_id, started_at, created_at)"
                " VALUES (?,?,"
                "   (SELECT COUNT(*)+1 FROM trials WHERE sub_train_job_id=?),"
                " ?,?,?,?,?,?,?,?)",
                (tid, sub_train_job_id, sub_train_job_id, model_name, json.dumps(knobs),
                 TrialStatus.RUNNING.value, worker_id, shape_sig, service_id,
                 _now(), _now()),
            )
        return self.get_trial(tid)

    def get_trial(self, trial_id: str) -> Optional[dict]:
        t = self._one("SELECT * FROM trials WHERE id=?", (trial_id,))
        if t:
            t["knobs"] = json.loads(t["knobs"])
        return t

    def mark_trial_as_completed(self, trial_id: str, score: float, params_id: Optional[str]) -> None:
        with self._conn() as c:
            c.execute(
                "UPDATE trials SET status=?, score=?, params_id=?, stopped_at=? WHERE id=?",
                (TrialStatus.COMPLETED.value, float(score), params_id, _now(), trial_id),
            )

    def mark_trial_as_errored(self, trial_id: str, error: str) -> None:
        with self._conn() as c:
            c.execute(
                "UPDATE trials SET status=?, error=?, stopped_at=? WHERE id=?",
                (TrialStatus.ERRORED.value, error[:4000], _now(), trial_id),
            )

    def mark_trial_as_running(self, trial_id: str,
                              service_id: Optional[str] = None,
                              worker_id: Optional[str] = None) -> None:
        """Re-adopt a trial for resume: back to RUNNING, stale error and
        stop time cleared, and, when the adopter passes its identity,
        rebound to the new service and worker, so a concurrent recovery
        sweep sees a live owner."""
        with self._conn() as c:
            c.execute(
                "UPDATE trials SET status=?, error=NULL, stopped_at=NULL,"
                " started_at=?,"
                " service_id=COALESCE(?, service_id),"
                " worker_id=COALESCE(?, worker_id)"
                " WHERE id=?",
                (TrialStatus.RUNNING.value, _now(), service_id, worker_id, trial_id))

    def adopt_trial(self, trial_id: str, prev_service_id: Optional[str],
                    service_id: str, worker_id: str,
                    expected_status: Optional[str] = None) -> bool:
        """Take ownership of an orphaned trial, atomically: a
        compare-and-swap on (status, service_id). It succeeds only while
        the trial still has the status the sweep observed (RUNNING by
        default) and is still bound to the service it observed, so two
        concurrent sweeps adopt each orphan once (the loser's UPDATE
        matches no row), and a worker that finished the trial meanwhile
        keeps its terminal status."""
        expected = expected_status or TrialStatus.RUNNING.value
        with self._conn() as c:
            cur = c.execute(
                "UPDATE trials SET status=?, error=NULL, stopped_at=NULL,"
                " started_at=?, service_id=?, worker_id=?"
                " WHERE id=? AND status=? AND service_id IS ?",
                (TrialStatus.RUNNING.value, _now(), service_id, worker_id,
                 trial_id, expected, prev_service_id))
            return cur.rowcount > 0

    def mark_trial_as_terminated(self, trial_id: str) -> None:
        with self._conn() as c:
            c.execute("UPDATE trials SET status=?, stopped_at=? WHERE id=?",
                      (TrialStatus.TERMINATED.value, _now(), trial_id))

    def get_orphaned_trials(self, stale_after_s: float,
                            sub_train_job_id: Optional[str] = None) -> List[dict]:
        """RUNNING trials whose service is terminal, missing or
        heartbeat-stale: trials whose worker died mid-trial. A trial
        with no service row opted out of failure detection and is never
        flagged."""
        cutoff = _now() - stale_after_s
        q = ("SELECT t.* FROM trials t LEFT JOIN services s ON t.service_id=s.id"
             " WHERE t.status=? AND t.service_id IS NOT NULL AND ("
             "   s.id IS NULL"
             "   OR s.status IN ('STOPPED','ERRORED')"
             "   OR s.heartbeat_at < ?)")
        args: list = [TrialStatus.RUNNING.value, cutoff]
        if sub_train_job_id is not None:
            q += " AND t.sub_train_job_id=?"
            args.append(sub_train_job_id)
        rows = self._all(q, tuple(args))
        for t in rows:
            t["knobs"] = json.loads(t["knobs"])
        return rows

    def get_trials_of_sub_train_job(self, sub_train_job_id: str) -> List[dict]:
        rows = self._all(
            "SELECT * FROM trials WHERE sub_train_job_id=? ORDER BY no", (sub_train_job_id,))
        for t in rows:
            t["knobs"] = json.loads(t["knobs"])
        return rows

    def get_trials_of_train_job(self, train_job_id: str) -> List[dict]:
        rows = self._all(
            "SELECT t.* FROM trials t JOIN sub_train_jobs s ON t.sub_train_job_id=s.id"
            " WHERE s.train_job_id=? ORDER BY t.created_at", (train_job_id,))
        for t in rows:
            t["knobs"] = json.loads(t["knobs"])
        return rows

    def get_best_trials_of_train_job(self, train_job_id: str, limit: int = 2) -> List[dict]:
        rows = self._all(
            "SELECT t.* FROM trials t JOIN sub_train_jobs s ON t.sub_train_job_id=s.id"
            " WHERE s.train_job_id=? AND t.status=? AND t.score IS NOT NULL"
            " ORDER BY t.score DESC, t.stopped_at ASC LIMIT ?",
            (train_job_id, TrialStatus.COMPLETED.value, limit))
        for t in rows:
            t["knobs"] = json.loads(t["knobs"])
        return rows

    def count_trials_of_sub_train_job(self, sub_train_job_id: str,
                                      statuses: Optional[List[str]] = None) -> int:
        if statuses:
            marks = ",".join("?" * len(statuses))
            return self._one(
                f"SELECT COUNT(*) AS n FROM trials WHERE sub_train_job_id=? AND status IN ({marks})",
                (sub_train_job_id, *statuses))["n"]
        return self._one("SELECT COUNT(*) AS n FROM trials WHERE sub_train_job_id=?",
                         (sub_train_job_id,))["n"]

    # -- trial logs ----------------------------------------------------------

    def add_trial_log(self, trial_id: str, entry: Dict[str, Any]) -> None:
        with self._conn() as c:
            c.execute("INSERT INTO trial_logs (trial_id, time, entry) VALUES (?,?,?)",
                      (trial_id, entry.get("time", _now()), json.dumps(entry)))

    def get_trial_logs(self, trial_id: str) -> List[dict]:
        return [json.loads(r["entry"]) for r in
                self._all("SELECT * FROM trial_logs WHERE trial_id=? ORDER BY id", (trial_id,))]

    # -- inference jobs ------------------------------------------------------

    def create_inference_job(self, train_job_id: str, user_id: Optional[str]) -> dict:
        iid = _uid()
        with self._conn() as c:
            c.execute(
                "INSERT INTO inference_jobs (id, train_job_id, user_id, status, created_at)"
                " VALUES (?,?,?,?,?)",
                (iid, train_job_id, user_id, InferenceJobStatus.STARTED.value, _now()),
            )
        return self.get_inference_job(iid)

    def get_inference_job(self, job_id: str) -> Optional[dict]:
        return self._one("SELECT * FROM inference_jobs WHERE id=?", (job_id,))

    def get_inference_job_of_train_job(self, train_job_id: str) -> Optional[dict]:
        return self._one(
            "SELECT * FROM inference_jobs WHERE train_job_id=? AND status IN ('STARTED','RUNNING')"
            " ORDER BY created_at DESC", (train_job_id,))

    def update_inference_job(self, job_id: str, status: Optional[str] = None,
                             predictor_host: Optional[str] = None) -> None:
        with self._conn() as c:
            if status is not None:
                stopped = _now() if status in (InferenceJobStatus.STOPPED.value,
                                               InferenceJobStatus.ERRORED.value) else None
                c.execute("UPDATE inference_jobs SET status=?, stopped_at=COALESCE(?, stopped_at)"
                          " WHERE id=?", (status, stopped, job_id))
            if predictor_host is not None:
                c.execute("UPDATE inference_jobs SET predictor_host=? WHERE id=?",
                          (predictor_host, job_id))

    # -- services (worker registry; replaces Docker Swarm service rows) -----

    def create_service(self, service_type: str, job_id: Optional[str] = None,
                       worker_index: Optional[int] = None,
                       devices: Optional[List[str]] = None) -> dict:
        sid = _uid()
        with self._conn() as c:
            c.execute(
                "INSERT INTO services (id, service_type, status, job_id, worker_index,"
                " devices, heartbeat_at, created_at) VALUES (?,?,?,?,?,?,?,?)",
                (sid, service_type, ServiceStatus.STARTED.value, job_id, worker_index,
                 json.dumps(devices or []), _now(), _now()),
            )
        return self._one("SELECT * FROM services WHERE id=?", (sid,))

    def update_service(self, service_id: str, status: Optional[str] = None,
                       heartbeat: bool = False) -> None:
        if heartbeat:
            # A skipped service heartbeat ages the lease the orphan sweep
            # (get_orphaned_trials) reads: a wedged worker, not a dead one.
            # Status updates are never skipped: they are state, not liveness.
            from rafiki_tpu_torch.chaos import hook as _chaos

            if _chaos("store.heartbeat", service_id) == "skip":
                heartbeat = False
        with self._conn() as c:
            if status is not None:
                c.execute("UPDATE services SET status=? WHERE id=?", (status, service_id))
            if heartbeat:
                c.execute("UPDATE services SET heartbeat_at=? WHERE id=?", (_now(), service_id))

    def get_service(self, service_id: str) -> Optional[dict]:
        return self._one("SELECT * FROM services WHERE id=?", (service_id,))

    def get_jobs_with_dead_supervisor(self, stale_after_s: float) -> List[dict]:
        """RUNNING train jobs whose sweep supervisor is provably gone:
        at least one SUPERVISOR service row exists (the job IS a
        supervised sweep: jobs without one are not flagged), and none of
        them is live (non-terminal status AND a heartbeat newer than the
        staleness cutoff). The resume reaper's detection query
        (docs/recovery.md)."""
        cutoff = _now() - float(stale_after_s)
        return self._all(
            "SELECT j.* FROM train_jobs j WHERE j.status=?"
            " AND EXISTS (SELECT 1 FROM services s WHERE s.job_id=j.id"
            "   AND s.service_type=?)"
            " AND NOT EXISTS (SELECT 1 FROM services s WHERE s.job_id=j.id"
            "   AND s.service_type=? AND s.status IN (?,?)"
            "   AND s.heartbeat_at >= ?)",
            (TrainJobStatus.RUNNING.value, ServiceType.SUPERVISOR.value,
             ServiceType.SUPERVISOR.value, ServiceStatus.STARTED.value,
             ServiceStatus.RUNNING.value, cutoff))

    def get_services_of_job(self, job_id: str) -> List[dict]:
        return self._all("SELECT * FROM services WHERE job_id=?", (job_id,))

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
