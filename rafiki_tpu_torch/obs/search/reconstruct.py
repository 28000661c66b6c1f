"""Rebuild a whole sweep from journals alone (``obs sweep``).

The port's own copy of ``rafiki_tpu/obs/search/reconstruct.py``
(``reconstruct``, ``artifact``). The audit plane
(:mod:`rafiki_tpu_torch.obs.search.audit`) gives every proposal, batch
draft and feedback a durable record; this module is the reader that
turns a journal directory back into the sweep: ordered proposals with
their acquisition breakdowns, the score each one earned, the
best-so-far/regret curve, the curve advisor's kills, speculations and
corrections, lineage roll-ups, and, when a random-engine baseline ran
beside the main advisor, the advisor lift with a seeded bootstrap CI.

Reconciliation is always on and loud: a ``feedback`` whose knobs-hash
never appeared in a ``propose`` record, a ``propose_batch`` member, a
speculation or a kill with no matching ``propose``, means an advisor
decision escaped the audit trail; the CLI exits nonzero naming the
hash.

Joins (all by the canonical knobs-hash):

    advisor/propose --(hash)--> event/trial_started --(trial_id)-->
        trial/epoch_eval + terminal events
    advisor/feedback --(hash)--> advisor/propose (order-preserving)
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.obs.search import lineage as lineage_mod
from rafiki_tpu_torch.obs.search import stats
from rafiki_tpu_torch.obs.search.audit import knobs_hash

SWEEP_SCHEMA_VERSION = 1


def _group_key(rec: Dict[str, Any]) -> str:
    if rec.get("advisor_id"):
        return str(rec["advisor_id"])
    return (f"{rec.get('engine', '?')}/{rec.get('role', '?')}-"
            f"{rec.get('pid', 0)}/seed{rec.get('seed', 0)}")


def _match(rec: Dict[str, Any], job: Optional[str]) -> bool:
    if not job:
        return True
    j = str(job)
    return (j in str(rec.get("job_id") or "")
            or str(rec.get("advisor_id") or "").startswith(j))


def reconstruct(records: List[Dict[str, Any]], job: Optional[str] = None,
                boot_seed: int = 0,
                n_boot: int = stats.DEFAULT_N_BOOT) -> Dict[str, Any]:
    """Journal records -> sweep document. Never raises on bad input;
    violations land in ``doc["reconciliation"]["errors"]``."""
    adv = [r for r in records
           if r.get("kind") == "advisor" and _match(r, job)]
    groups: Dict[str, Dict[str, Any]] = {}
    # The curve plane (predict/kill/false_kill) journals from the
    # coordinator, which deliberately knows no advisor identity —
    # these records join the sweep by knobs_hash, not by group.
    predicts: List[Dict[str, Any]] = []
    kills: List[Dict[str, Any]] = []
    false_kills: List[Dict[str, Any]] = []
    for r in adv:
        if r.get("name") == "predict":
            predicts.append(r)
            continue
        if r.get("name") == "kill":
            kills.append(r)
            continue
        if r.get("name") == "false_kill":
            false_kills.append(r)
            continue
        g = groups.setdefault(_group_key(r), {
            "engine": r.get("engine"), "seed": r.get("seed"),
            "job_id": r.get("job_id"),
            "proposes": [], "feedbacks": [], "batches": [],
            "speculates": [], "corrects": []})
        if r.get("name") == "propose":
            g["proposes"].append(r)
        elif r.get("name") == "feedback":
            g["feedbacks"].append(r)
        elif r.get("name") == "propose_batch":
            g["batches"].append(r)
        elif r.get("name") == "speculate":
            g["speculates"].append(r)
        elif r.get("name") == "correct":
            g["corrects"].append(r)

    errors: List[Dict[str, Any]] = []

    # -- per-group audit reconciliation (loud) -------------------------------
    for key, g in groups.items():
        unmatched: Dict[str, int] = {}
        for p in g["proposes"]:
            h = p.get("knobs_hash")
            unmatched[h] = unmatched.get(h, 0) + 1
        for f in g["feedbacks"]:
            h = f.get("knobs_hash")
            if unmatched.get(h, 0) > 0:
                unmatched[h] -= 1
            else:
                errors.append({
                    "type": "feedback_without_propose", "group": key,
                    "knobs_hash": h, "ts": f.get("ts"),
                    "detail": "a score arrived for a knob assignment no "
                              "advisor/propose record ever chose — an "
                              "unjournaled decision or a torn journal"})
        batch_budget: Dict[str, int] = {}
        for p in g["proposes"]:
            h = p.get("knobs_hash")
            batch_budget[h] = batch_budget.get(h, 0) + 1
        for b in g["batches"]:
            for h in b.get("knobs_hashes") or []:
                if batch_budget.get(h, 0) > 0:
                    batch_budget[h] -= 1
                else:
                    errors.append({
                        "type": "batch_member_without_propose",
                        "group": key, "knobs_hash": h, "ts": b.get("ts"),
                        "detail": "a propose_batch member has no matching "
                                  "advisor/propose record"})
        # Membership (not count) check: rehydration legitimately
        # re-journals a speculation it replays, so duplicates per hash
        # are fine — a speculation for a never-proposed assignment is
        # not.
        proposed = {p.get("knobs_hash") for p in g["proposes"]}
        for s in g["speculates"]:
            if s.get("knobs_hash") not in proposed:
                errors.append({
                    "type": "speculate_without_propose", "group": key,
                    "knobs_hash": s.get("knobs_hash"), "ts": s.get("ts"),
                    "detail": "a speculative score entered the advisor "
                              "for a knob assignment no advisor/propose "
                              "record ever chose"})

    # Kill verdicts join globally (coordinator records carry no group
    # identity): a kill for a hash nobody proposed escaped the audit
    # trail.
    all_proposed = {p.get("knobs_hash")
                    for g in groups.values() for p in g["proposes"]}
    for kr in kills:
        if kr.get("knobs_hash") not in all_proposed:
            errors.append({
                "type": "kill_without_propose",
                "knobs_hash": kr.get("knobs_hash"), "ts": kr.get("ts"),
                "detail": "an early-kill verdict names a knob assignment "
                          "no advisor/propose record ever chose"})

    # -- pick the main sweep + random baseline -------------------------------
    def _n(gk: str) -> int:
        return len(groups[gk]["proposes"])

    non_random = [k for k, g in groups.items() if g["engine"] != "random"]
    main_key = (max(non_random, key=_n) if non_random
                else (max(groups, key=_n) if groups else None))
    baselines = [k for k, g in groups.items()
                 if g["engine"] == "random" and k != main_key]
    base_key = (max(baselines, key=lambda k: len(groups[k]["feedbacks"]))
                if baselines else None)

    # -- trial join: hash -> trial ids (order-preserving queues) -------------
    trial_q: Dict[str, List[str]] = {}
    for r in records:
        if (r.get("kind") == "event" and r.get("name") == "trial_started"
                and r.get("knobs") is not None):
            trial_q.setdefault(knobs_hash(r["knobs"]), []).append(
                str(r.get("trial_id")))
    trials = lineage_mod.build(records)

    doc: Dict[str, Any] = {
        "sweep_schema_version": SWEEP_SCHEMA_VERSION,
        "job": job,
        "groups": {k: {"engine": g["engine"], "seed": g["seed"],
                       "job_id": g["job_id"],
                       "n_proposals": len(g["proposes"]),
                       "n_feedbacks": len(g["feedbacks"]),
                       "n_batches": len(g["batches"])}
                   for k, g in groups.items()},
        "main": main_key,
        "baseline": base_key,
    }

    proposals: List[Dict[str, Any]] = []
    scores: List[float] = []
    n_doomed = 0
    if main_key is not None:
        g = groups[main_key]
        doc["engine"] = g["engine"]
        doc["seed"] = g["seed"]
        # feedback join per hash, order-preserving
        fb_q: Dict[str, List[Dict[str, Any]]] = {}
        for f in g["feedbacks"]:
            fb_q.setdefault(f.get("knobs_hash"), []).append(f)
        # Curve-plane joins, last record per hash wins (the newest fit
        # has the most observations).
        predict_by_hash = {p.get("knobs_hash"): p for p in predicts}
        kill_by_hash = {kr.get("knobs_hash"): kr for kr in kills}
        false_kill_hashes = {fk.get("knobs_hash") for fk in false_kills}
        speculated_hashes = {s.get("knobs_hash")
                             for s in g["speculates"]}
        correct_by_hash = {c.get("knobs_hash"): c for c in g["corrects"]}
        pred_errors: List[float] = []
        for seq, p in enumerate(g["proposes"], start=1):
            h = p.get("knobs_hash")
            fb = fb_q.get(h)
            f = fb.pop(0) if fb else None
            tq = trial_q.get(h)
            tid = tq.pop(0) if tq else None
            t = trials.get(tid) if tid else None
            doomed = bool(
                (f and f.get("doomed"))
                or (t and t["status"] in ("trial_errored",
                                          "trial_diverged")))
            row = {
                "seq": seq, "ts": p.get("ts"), "knobs_hash": h,
                "acquisition": p.get("acquisition"),
                "trial_id": tid,
                "score": f.get("score") if f else None,
                "doomed": doomed,
                "n_epoch_evals": (t or {}).get("n_epoch_evals"),
                "status": (t or {}).get("status"),
            }
            pr = predict_by_hash.get(h) or kill_by_hash.get(h)
            if pr is not None:
                row["predicted_final"] = pr.get("predicted")
                row["prediction_band"] = pr.get("band")
            if h in kill_by_hash:
                row["killed"] = True
                row["kill_epoch"] = kill_by_hash[h].get("epoch")
                row["false_kill"] = h in false_kill_hashes
            if h in speculated_hashes:
                row["speculated"] = True
                row["corrected"] = h in correct_by_hash
            # Per-trial prediction error: the truth (real score, or a
            # correction's `actual`) vs the newest mid-flight
            # prediction.
            truth = None
            if f is not None and not doomed:
                truth = float(f["score"])
            elif h in correct_by_hash:
                truth = correct_by_hash[h].get("actual")
            if truth is not None and row.get("predicted_final") is not None:
                err = float(truth) - float(row["predicted_final"])
                row["prediction_error"] = round(err, 9)
                pred_errors.append(abs(err))
            proposals.append(row)
            if f is not None and not doomed:
                scores.append(float(f["score"]))
            if doomed:
                n_doomed += 1
        doc["proposals"] = proposals
        doc["curve"] = stats.regret_curve(scores)
        ts_all = ([p.get("ts") for p in g["proposes"]]
                  + [f.get("ts") for f in g["feedbacks"]])
        ts_all = [t for t in ts_all if t is not None]
        span_s = (max(ts_all) - min(ts_all)) if len(ts_all) > 1 else 0.0
        doc.update({
            "n_proposals": len(proposals),
            "n_scored": len(scores),
            "n_doomed": n_doomed,
            "span_s": round(span_s, 6),
            "best_score": doc["curve"]["best_score"],
            "regret": doc["curve"]["mean_regret"],
            "effective_trials_per_hour": (
                round(len(scores) / (span_s / 3600.0), 4)
                if span_s > 0 and scores else None),
        })
        # -- learning-curve roll-up (docs/early_kill.md) ---------------------
        n_kills = sum(1 for row in proposals if row.get("killed"))
        n_false = sum(1 for row in proposals if row.get("false_kill"))
        true_kills = n_kills - n_false
        # Recall ground truth: scored trials that finished below
        # final-best minus the kill margin SHOULD have been killed;
        # each one that ran to completion is a miss. Margin comes from
        # the kill records' own config (they carry the knobs in force).
        margin = 0.02
        for kr in kills:
            cfg = kr.get("config") or {}
            if cfg.get("margin") is not None:
                margin = float(cfg["margin"])
                break
        final_best = doc["curve"]["best_score"]
        missed = (sum(1 for s in scores if s < final_best - margin)
                  if final_best is not None else 0)
        curve_stats: Dict[str, Any] = {
            "n_predicts": len(predicts),
            "n_kills": n_kills,
            "n_false_kills": n_false,
            "n_speculations": len(g["speculates"]),
            "n_corrections": len(g["corrects"]),
            "kill_precision": (round(true_kills / n_kills, 4)
                               if n_kills else None),
            "kill_recall": (round(true_kills / (true_kills + missed), 4)
                            if (true_kills + missed) else None),
            "mean_abs_prediction_error": (
                round(sum(pred_errors) / len(pred_errors), 6)
                if pred_errors else None),
        }
        doc["curve_advisor"] = curve_stats
        doc.update({k: v for k, v in curve_stats.items()
                    if k != "n_predicts"})

    # -- advisor lift vs the random baseline ---------------------------------
    if main_key is not None and base_key is not None:
        base_scores = [float(f["score"])
                       for f in groups[base_key]["feedbacks"]
                       if not f.get("doomed")]
        n_pair = min(len(scores), len(base_scores))
        if n_pair:
            diffs = [scores[i] - base_scores[i] for i in range(n_pair)]
            ci = stats.bootstrap_ci(diffs, n_boot=n_boot, seed=boot_seed)
            doc["lift"] = ci
            doc["advisor_lift"] = ci["mean"]
            doc["lift_ci_low"] = ci["lo"]
            doc["lift_ci_high"] = ci["hi"]

    # -- lineage roll-up ------------------------------------------------------
    orphans = lineage_mod.reconcile(trials)
    doc["lineage"] = {
        "n_trials": len(trials),
        "n_evictions": sum(t["n_evictions"] for t in trials.values()),
        "n_resumes": sum(t["n_resumes"] for t in trials.values()),
        "n_backfilled": sum(1 for t in trials.values() if t["backfilled"]),
        "n_multi_incarnation": sum(
            1 for t in trials.values() if t["n_incarnations"] > 1),
        "orphans": orphans,
    }

    doc["reconciliation"] = {"ok": not errors, "errors": errors}
    return doc


def artifact(doc: Dict[str, Any]) -> Dict[str, Any]:
    """The trendable slice of a sweep document: its headline keys at
    top level, the same keys and values as the JAX package's."""
    keys = ("sweep_schema_version", "job", "engine", "seed",
            "n_proposals", "n_scored", "n_doomed", "span_s",
            "best_score", "regret", "effective_trials_per_hour",
            "advisor_lift", "lift_ci_low", "lift_ci_high",
            "n_kills", "n_false_kills", "n_speculations",
            "n_corrections", "kill_precision", "kill_recall",
            "mean_abs_prediction_error")
    out = {k: doc.get(k) for k in keys if doc.get(k) is not None}
    out["sweep_schema_version"] = doc.get("sweep_schema_version",
                                          SWEEP_SCHEMA_VERSION)
    if not doc.get("reconciliation", {}).get("ok", False):
        out["error"] = "sweep reconciliation failed"
    return out
