"""``obs sweep`` / ``obs lineage`` / ``obs resume``: the search-plane reader verbs.

The port's own copy of ``rafiki_tpu/obs/search/cli.py``, mounted by
:mod:`rafiki_tpu_torch.obs.cli`: ``attach(sub)`` is stdlib-only at
import time; the reconstruction (numpy for the bootstrap) loads inside
the verbs. None imports torch.

    sweep [job]     rebuild the whole sweep from journals alone:
                    ordered proposals with acquisition breakdowns,
                    scores, best-so-far/regret curve, kills and
                    speculations, lineage roll-up, advisor lift vs the
                    random baseline with a seeded bootstrap CI. Exit 1
                    when audit reconciliation fails (a feedback, batch
                    member, speculation or kill with no propose record)
                    or no advisor records exist. ``--out`` writes the
                    sweep's trendable summary as JSON.
    lineage [trial] walk one trial across incarnations, chips and
                    packs; omit the trial for the fleet-wide table.
                    ``--check`` exits 1 on orphaned incarnations:
                    trials the fleet lost without writing down why.
    resume [job]    reconstruct a sweep's crash->detect->adopt->
                    reconcile->resume timeline from journals alone:
                    supervisor incarnations, the fault that killed
                    generation 0, WAL reconcile verdicts, advisor
                    rehydration, adopted-trial feedback routing, and
                    the first post-resume proposal batch. Exit 1 when
                    no recovery records exist for the job
                    (docs/recovery.md).
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict


def attach(sub) -> None:
    sp = sub.add_parser(
        "sweep",
        help="reconstruct a sweep from advisor/* journal records")
    sp.add_argument("job", nargs="?", default=None,
                    help="job-id substring or advisor-id prefix filter")
    sp.add_argument("--out", default=None,
                    help="write the sweep's trendable summary (JSON) to this path")
    sp.add_argument("--boot-seed", type=int, default=0,
                    help="bootstrap-CI seed (default 0, deterministic)")
    sp = sub.add_parser(
        "lineage",
        help="trial genealogy from journaled lifecycle events")
    sp.add_argument("trial", nargs="?", default=None,
                    help="trial id or unique prefix (omit for all)")
    sp.add_argument("--check", action="store_true",
                    help="exit 1 on orphaned incarnations")
    sp = sub.add_parser(
        "resume",
        help="crash→adopt→resume timeline from recovery records")
    sp.add_argument("job", nargs="?", default=None,
                    help="job-id substring filter (omit for all)")


def dispatch(args, log_dir: str, as_json: bool) -> int:
    if args.cmd == "sweep":
        return cmd_sweep(args, log_dir, as_json)
    if args.cmd == "resume":
        return cmd_resume(args, log_dir, as_json)
    return cmd_lineage(args, log_dir, as_json)


def _print_sweep(doc: Dict[str, Any]) -> None:
    print(f"sweep: engine={doc.get('engine')} seed={doc.get('seed')} "
          f"advisor={doc.get('main')}"
          + (f" job={doc.get('job')}" if doc.get("job") else ""))
    print(f"  proposals={doc.get('n_proposals')} "
          f"scored={doc.get('n_scored')} doomed={doc.get('n_doomed')} "
          f"span={doc.get('span_s')}s "
          f"eff_trials_per_hour={doc.get('effective_trials_per_hour')}")
    curve = doc.get("curve") or {}
    print(f"  best={curve.get('best_score')} "
          f"mean_regret={curve.get('mean_regret')}")
    for p in doc.get("proposals") or []:
        acq = p.get("acquisition") or {}
        why = acq.get("phase", "?")
        if why == "ei":
            why += (f" ei={acq.get('ei')} mu={acq.get('mu')} "
                    f"sigma={acq.get('sigma')} pool={acq.get('pool')}")
            if acq.get("fit_s") is not None:
                why += f" fit={acq['fit_s']}s"
        elif why == "tpe":
            why += (f" log_ratio={acq.get('log_ratio')} "
                    f"pool={acq.get('pool')} n_good={acq.get('n_good')}")
        mark = " DOOMED" if p.get("doomed") else ""
        if p.get("killed"):
            fk = " FALSE-KILL" if p.get("false_kill") else ""
            mark += (f" KILLED@e{p.get('kill_epoch')}"
                     f"(pred={p.get('predicted_final')}){fk}")
        elif p.get("speculated"):
            mark += (" corrected" if p.get("corrected")
                     else " SPECULATED")
        if p.get("prediction_error") is not None:
            mark += f" pred_err={p['prediction_error']}"
        print(f"  #{p['seq']:>3} {p.get('knobs_hash')} "
              f"score={p.get('score')}{mark} "
              f"trial={p.get('trial_id')}  [{why}]")
    ca = doc.get("curve_advisor") or {}
    if any(ca.get(k) for k in ("n_predicts", "n_kills",
                               "n_speculations")):
        print(f"  curve advisor: predicts={ca.get('n_predicts')} "
              f"kills={ca.get('n_kills')} "
              f"false_kills={ca.get('n_false_kills')} "
              f"speculations={ca.get('n_speculations')} "
              f"corrections={ca.get('n_corrections')} "
              f"precision={ca.get('kill_precision')} "
              f"recall={ca.get('kill_recall')} "
              f"mean_abs_pred_err={ca.get('mean_abs_prediction_error')}")
    if doc.get("advisor_lift") is not None:
        print(f"  lift vs random: {doc['advisor_lift']} "
              f"[{doc.get('lift_ci_low')}, {doc.get('lift_ci_high')}] "
              f"(n={doc.get('lift', {}).get('n')}, seeded bootstrap)")
    lin = doc.get("lineage") or {}
    print(f"  lineage: trials={lin.get('n_trials')} "
          f"evictions={lin.get('n_evictions')} "
          f"resumes={lin.get('n_resumes')} "
          f"backfilled={lin.get('n_backfilled')} "
          f"orphans={len(lin.get('orphans') or [])}")


def cmd_sweep(args, log_dir: str, as_json: bool) -> int:
    from rafiki_tpu_torch.obs import journal as journal_mod
    from rafiki_tpu_torch.obs.search import reconstruct as rec_mod

    records = journal_mod.read_dir(log_dir)
    if not any(r.get("kind") == "advisor" for r in records):
        print(f"no advisor records under {log_dir} (did the sweep "
              f"journal? see docs/search_anatomy.md)", file=sys.stderr)
        return 1
    doc = rec_mod.reconstruct(records, job=args.job,
                              boot_seed=args.boot_seed)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec_mod.artifact(doc), f)
    if as_json:
        print(json.dumps(doc, default=str))
    else:
        _print_sweep(doc)
    recon = doc.get("reconciliation") or {}
    if not recon.get("ok"):
        print("SWEEP RECONCILIATION FAILED — advisor decisions escaped "
              "the audit trail:", file=sys.stderr)
        for e in recon.get("errors") or []:
            print(f"  {e['type']}: group={e.get('group')} "
                  f"knobs_hash={e.get('knobs_hash')} — {e.get('detail')}",
                  file=sys.stderr)
        return 1
    return 0


def cmd_lineage(args, log_dir: str, as_json: bool) -> int:
    from rafiki_tpu_torch.obs import journal as journal_mod
    from rafiki_tpu_torch.obs.search import lineage as lineage_mod

    records = journal_mod.read_dir(log_dir)
    trials = lineage_mod.build(records)
    if not trials:
        print(f"no trial lifecycle records under {log_dir}",
              file=sys.stderr)
        return 1
    if args.trial:
        t = lineage_mod.walk(trials, args.trial)
        if t is None:
            print(f"no unique trial matching {args.trial!r} "
                  f"({len(trials)} trials known)", file=sys.stderr)
            return 1
        if as_json:
            print(json.dumps(t, default=str))
            return 0
        _print_trial(t)
        return 0
    orphans = lineage_mod.reconcile(trials)
    if as_json:
        print(json.dumps({"trials": trials, "orphans": orphans},
                         default=str))
    else:
        for tid in sorted(trials):
            t = trials[tid]
            back = " backfilled" if t["backfilled"] else ""
            print(f"trial {tid}: {t['status']}{back} "
                  f"incarnations={t['n_incarnations']} "
                  f"workers={t['workers']} "
                  f"evictions={t['n_evictions']} "
                  f"resumes={t['n_resumes']}")
        print(f"-- {len(trials)} trials, {len(orphans)} orphaned")
    if args.check and orphans:
        print("LINEAGE RECONCILIATION FAILED — orphaned incarnations "
              "(started, never resolved):", file=sys.stderr)
        for o in orphans:
            print(f"  trial {o['trial_id']} incarnation "
                  f"{o['incarnation']} on {o['worker_id']} — last event "
                  f"{o['last_event']}", file=sys.stderr)
        return 1
    return 0


def _resume_timeline(records, job: str = None) -> Dict[str, Any]:
    """The recovery story, assembled from journals alone — no store,
    no WAL file. Selects supervisor lifecycle, injected faults,
    recovery/* verdicts and the post-resume advisor continuation, in
    timestamp order."""
    def _match(r) -> bool:
        return job is None or job in str(r.get("job_id") or "")

    picked = []
    for r in records:
        kind, name = r.get("kind"), r.get("name")
        if kind == "recovery" and _match(r):
            picked.append(r)
        elif kind == "mesh" and name in (
                "supervisor_started", "sweep_started", "host_lost",
                "chip_lost", "repack", "repack_failed") and _match(r):
            picked.append(r)
        elif kind == "chaos":
            # Fault records carry no job id; scoped by the log dir.
            picked.append(r)
        elif (kind == "event" and name in ("trial_orphan_detected",
                                           "sweep_resumed")):
            picked.append(r)
        elif kind == "advisor" and name == "propose_batch" and _match(r):
            picked.append(r)
    picked.sort(key=lambda r: r.get("ts", 0.0))
    generations = sorted({r.get("generation") for r in picked
                          if r.get("kind") == "mesh"
                          and r.get("name") == "supervisor_started"
                          and r.get("generation") is not None})
    finished = [r for r in picked if r.get("kind") == "recovery"
                and r.get("name") == "resume_finished"]
    return {
        "n_records": len(picked),
        "generations": generations,
        "resumes": len(finished),
        "outcome": finished[-1] if finished else None,
        "timeline": picked,
    }


def cmd_resume(args, log_dir: str, as_json: bool) -> int:
    from rafiki_tpu_torch.obs import journal as journal_mod

    records = journal_mod.read_dir(log_dir)
    doc = _resume_timeline(records, job=args.job)
    has_recovery = any(r.get("kind") == "recovery"
                       for r in doc["timeline"])
    if not has_recovery:
        print(f"no recovery records under {log_dir}"
              + (f" for job {args.job!r}" if args.job else "")
              + " (was resume_sweep ever run? see docs/recovery.md)",
              file=sys.stderr)
        return 1
    if as_json:
        print(json.dumps(doc, default=str))
        return 0
    t0 = doc["timeline"][0].get("ts", 0.0)
    print(f"resume timeline: {doc['n_records']} records, "
          f"supervisor generations {doc['generations']}, "
          f"{doc['resumes']} resume(s)")
    for r in doc["timeline"]:
        dt = (r.get("ts") or 0.0) - t0
        kind, name = r.get("kind"), r.get("name")
        extra = " ".join(
            f"{k}={r[k]}" for k in (
                "generation", "site", "mode", "key", "host", "chip",
                "ok", "n_claims", "n_in_doubt", "errors",
                "n_observations", "n_from_store", "n_from_journal",
                "routed", "score", "adopted", "salvaged", "restarted",
                "continuation", "strategy", "trial_id", "wall_s")
            if r.get(k) not in (None, [], ""))
        print(f"  +{dt:8.3f}s {kind}/{name}"
              + (f"  [{extra}]" if extra else ""))
    out = doc["outcome"]
    if out is not None:
        print(f"-- resumed: adopted={out.get('adopted')} "
              f"salvaged={out.get('salvaged')} "
              f"restarted={out.get('restarted')} "
              f"continuation={out.get('continuation')} "
              f"wall={out.get('wall_s')}s")
    return 0


def _print_trial(t: Dict[str, Any]) -> None:
    back = " backfilled" if t["backfilled"] else ""
    print(f"trial {t['trial_id']}: {t['status']}{back} "
          f"knobs_hash={t['knobs_hash']} "
          f"epoch_evals={t['n_epoch_evals']}")
    if t["repacked_from"]:
        print(f"  repacked off chip(s) {t['repacked_from']}")
    for inc in t["incarnations"]:
        syn = " (synthetic start)" if inc.get("synthetic") else ""
        print(f"  incarnation {inc['seq']} on {inc['worker_id']}"
              f"{syn}: terminal={inc['terminal']}")
        t0 = inc.get("started_ts") or 0.0
        for e in inc["events"]:
            dt = (e.get("ts") or 0.0) - t0
            extra = " ".join(
                f"{k}={e[k]}" for k in ("epoch", "from_epoch", "reason",
                                        "score", "divergence", "error")
                if e.get(k) is not None)
            print(f"    +{dt:8.3f}s {e['event']}"
                  + (f"  [{extra}]" if extra else ""))
