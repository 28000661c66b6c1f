"""Trial lineage: stitch journaled lifecycle events into genealogy.

The port's own copy of ``rafiki_tpu/obs/search/lineage.py`` (``build``,
``reconcile``, ``walk``). Workers journal every pack/evict/backfill/
resume/kill lifecycle transition as ``event/*`` records and the mesh
scheduler journals ``mesh/chip_lost``/``mesh/repack``/
``mesh/repack_failed``, but each record only sees its own hop. This
module joins them per trial id into explicit incarnation chains:

* an **incarnation** starts at each ``trial_started`` (serial runs,
  pack rows, mid-pack backfills and post-repack resumes all re-emit
  it) and collects that attempt's events in timestamp order;
* a trial is **closed** when its last incarnation carries a terminal
  event (``trial_completed``/``trial_errored``/``trial_diverged``) or
  ends on a ``pack_member_evicted`` (the eviction *is* the
  explanation). The port's worker closes an early-killed trial, serial
  or packed, with ``trial_errored`` after its ``trial_killed``;
* anything else is an **orphaned incarnation**: a trial the fleet
  lost without writing down why. ``reconcile`` surfaces those and the
  CLI (``obs lineage --check``) fails loudly on them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

TERMINAL = ("trial_completed", "trial_errored", "trial_diverged")

#: lifecycle events worth keeping on the per-incarnation walk (the
#: full journal line stays in the journal; lineage keeps the join keys)
_KEEP_FIELDS = ("epoch", "from_epoch", "reason", "score", "error",
                "divergence", "diagnosis", "sub_job_id", "model")


def _slim(rec: Dict[str, Any]) -> Dict[str, Any]:
    out = {"ts": rec.get("ts"), "event": rec.get("name"),
           "worker_id": rec.get("worker_id"), "pid": rec.get("pid")}
    for k in _KEEP_FIELDS:
        if rec.get(k) is not None:
            out[k] = rec[k]
    return out


def build(records: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """records (from ``journal.read_dir``) -> {trial_id: lineage}."""
    # knobs hashed lazily to avoid importing audit when unused
    from rafiki_tpu_torch.obs.search.audit import knobs_hash

    trials: Dict[str, Dict[str, Any]] = {}
    evict_ts_by_worker: Dict[str, List[float]] = {}
    for rec in records:
        kind, name = rec.get("kind"), rec.get("name")
        if kind == "event" and name == "pack_member_evicted":
            evict_ts_by_worker.setdefault(
                str(rec.get("worker_id")), []).append(rec.get("ts", 0.0))
        if kind == "event" and rec.get("trial_id") is not None:
            tid = str(rec["trial_id"])
            t = trials.setdefault(tid, {
                "trial_id": tid, "incarnations": [], "workers": [],
                "knobs_hash": None, "n_epoch_evals": 0,
                "repacked_from": [], "repack_orphaned": False,
            })
            if name == "trial_started":
                t["incarnations"].append({
                    "seq": len(t["incarnations"]) + 1,
                    "started_ts": rec.get("ts"),
                    "worker_id": rec.get("worker_id"),
                    "events": [], "terminal": None,
                })
                if rec.get("knobs") is not None:
                    t["knobs_hash"] = knobs_hash(rec["knobs"])
            if not t["incarnations"]:
                # Event before any trial_started (e.g. a resume record
                # from a process whose start landed in a rotated-away
                # generation): keep it on a synthetic incarnation so
                # nothing is silently dropped.
                t["incarnations"].append({
                    "seq": 1, "started_ts": rec.get("ts"),
                    "worker_id": rec.get("worker_id"),
                    "events": [], "terminal": None, "synthetic": True,
                })
            inc = t["incarnations"][-1]
            if name != "trial_started":
                inc["events"].append(_slim(rec))
            if name in TERMINAL:
                inc["terminal"] = name
            w = rec.get("worker_id")
            if w is not None and w not in t["workers"]:
                t["workers"].append(w)
        elif kind == "trial" and name == "epoch_eval":
            tid = str(rec.get("trial_id"))
            if tid in trials:
                trials[tid]["n_epoch_evals"] += 1
        elif kind == "mesh" and name == "repack":
            for tid in rec.get("moved") or []:
                if str(tid) in trials:
                    trials[str(tid)]["repacked_from"].append(
                        rec.get("chip"))
        elif kind == "mesh" and name == "repack_failed":
            for tid in rec.get("orphans") or []:
                if str(tid) in trials:
                    trials[str(tid)]["repack_orphaned"] = True

    for t in trials.values():
        incs = t["incarnations"]
        last = incs[-1] if incs else None
        evicted_last = bool(
            last and last["events"]
            and last["events"][-1]["event"] == "pack_member_evicted")
        t["n_incarnations"] = len(incs)
        t["n_evictions"] = sum(
            1 for i in incs for e in i["events"]
            if e["event"] == "pack_member_evicted")
        t["n_resumes"] = sum(
            1 for i in incs for e in i["events"]
            if e["event"] == "trial_resumed")
        t["n_checkpoints"] = sum(
            1 for i in incs for e in i["events"]
            if e["event"] == "checkpoint_written")
        # A backfill fills a slot some eviction freed: first start
        # strictly after an eviction on the same worker.
        first = incs[0] if incs else None
        t["backfilled"] = bool(
            first and any(ts <= (first["started_ts"] or 0.0)
                          for ts in evict_ts_by_worker.get(
                              str(first["worker_id"]), ())))
        t["status"] = (last["terminal"] if last and last["terminal"]
                       else "evicted" if evicted_last
                       else "orphaned")
    return trials


def reconcile(trials: Dict[str, Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Fleet-wide orphan check: every trial the journals started must
    end with a written-down fate. Returns the violations (empty list
    == clean); callers exit nonzero on any."""
    orphans = []
    for tid, t in sorted(trials.items()):
        if t["status"] == "orphaned":
            last = t["incarnations"][-1] if t["incarnations"] else {}
            orphans.append({
                "trial_id": tid,
                "incarnation": t["n_incarnations"],
                "worker_id": last.get("worker_id"),
                "last_event": (last["events"][-1]["event"]
                               if last.get("events") else "trial_started"),
                "repack_orphaned": t["repack_orphaned"],
            })
    return orphans


def walk(trials: Dict[str, Dict[str, Any]],
         trial: str) -> Optional[Dict[str, Any]]:
    """One trial's lineage by exact id or unique prefix."""
    if trial in trials:
        return trials[trial]
    hits = [t for tid, t in trials.items() if tid.startswith(trial)]
    return hits[0] if len(hits) == 1 else None
