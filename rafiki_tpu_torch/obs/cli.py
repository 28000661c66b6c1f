"""``python -m rafiki_tpu_torch.obs`` — read the merged cross-process journals.

The port's counterpart of ``rafiki_tpu/obs/cli.py``, with the verbs of
the planes the port has. Subcommands (all read ``journal-*.jsonl*``
under ``--dir``, default ``$RAFIKI_LOG_DIR`` then the configured
``logs_dir``):

    trace <id>     every record carrying the trace id (prefix match),
                   time-ordered across processes, one line per hop —
                   the stitched end-to-end view of one query or trial
    tail [-n N]    the last N records fleet-wide
    slowest [-n N] the N slowest finished spans
    profile [key]  per-program join of the FLOP count (``perf/cost``)
                   with the measured epochs (``perf/step``): flops per
                   step, steps per epoch, the median warm epoch,
                   achieved FLOP/s and MFU; ``key`` prefix-matches the
                   program key hash or substring-matches the key repr
    slo            current SLO burn state (latest ``slo/state``) plus
                   the breach/recovery history
    health         numerics health: every ``health/divergence`` verdict
                   with its diagnosis and capsule, plus totals
    curves [id]    per-trial learning curves from the durable
                   ``trial/epoch_eval`` records; ``id`` prefix-matches
                   trial ids (omit for every trial); ``--predicted``
                   overlays the curve extrapolator's fit and credible
                   band (the fit the early kill decides by)
    replay <cap>   re-execute a divergence capsule (on the card, or
                   ``--device cpu``) and bit-verify the reproduction;
                   exit 0 only when the bad step reproduced bit for bit
    shard          the sharded lane's story: each ``shard/plan``, and per
                   trial its width history (group formations, member
                   losses, reshard-on-restore events); exit 1 when the
                   journals hold no ``shard/*`` record
    decisions      control-plane decisions in one time-ordered stream:
                   serving route switches, gateway sheds, breaker flips,
                   placement advisories, and the curve advisor's kills,
                   speculations and corrections; exit 1 when there are
                   none
    sweep [job]    a whole sweep rebuilt from the ``advisor/*`` audit
                   records (``obs/search/cli.py``); exit 1 when a
                   feedback, batch member, speculation or kill has no
                   propose record
    lineage [id]   one trial across incarnations, chips and packs (evict,
                   kill, backfill, resume, repack); ``--check`` exits 1 on
                   orphaned incarnations fleet-wide
    resume [job]   a sweep's crash->adopt->resume timeline from the
                   ``recovery/*`` and supervisor records; exit 1 when no
                   recovery story exists

The journals of either package read the same: ``trace``, ``tail``,
``slowest``, ``slo``, ``health``, ``curves`` (with ``--predicted``),
``shard``, ``sweep``, ``lineage`` and ``resume`` print what the JAX
package's CLI prints. ``decisions`` prints the JAX package's four kinds
of decision and, beyond them, the curve advisor's (``advisor/kill``,
``advisor/speculate``, ``advisor/correct``).
``profile`` multiplies a step's flops by the epoch's ``steps`` where
the ``perf/step`` record carries them (the port's do; a JAX package
journal's count as one step, as its own CLI reads them) and takes the
MFU denominator from ``--peak-flops`` or else from the ``perf/cost``
record's ``peak_flops`` (the card and compute dtype the step ran on).

Output is one human line per record by default, ``--json`` for JSONL.
Exit code 1 when a requested trace has no records. Importing this
module imports no torch: it reads journals on any machine (``replay``
and ``curves --predicted``, which fits through the advisor package, load
it when they run).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.obs import journal as journal_mod


def _default_dir() -> str:
    d = os.environ.get(journal_mod.ENV_VAR)
    if d:
        return d
    from rafiki_tpu_torch.config import get_config
    return str(get_config().logs_dir)


def _fmt_record(rec: Dict[str, Any], t0: float) -> str:
    dt = rec.get("ts", 0.0) - t0
    who = f"{rec.get('role', '?')}/{rec.get('pid', '?')}"
    head = f"+{dt:9.3f}s  {who:<18} {rec.get('kind', '?'):<7} {rec.get('name', '?')}"
    parts = []
    if rec.get("dur_s") is not None:
        parts.append(f"dur={rec['dur_s']:.4f}s")
    for k in ("trial_id", "worker_id", "query_id", "site", "mode", "event",
              "reason", "path", "error"):
        if rec.get(k) is not None:
            parts.append(f"{k}={rec[k]}")
    tags = rec.get("tags")
    if isinstance(tags, dict):
        parts.extend(f"{k}={v}" for k, v in tags.items())
    return head + ("  [" + " ".join(parts) + "]" if parts else "")


def _emit(records: List[Dict[str, Any]], as_json: bool) -> None:
    if as_json:
        for rec in records:
            print(json.dumps(rec, default=str))
        return
    t0 = records[0].get("ts", 0.0) if records else 0.0
    for rec in records:
        print(_fmt_record(rec, t0))


def cmd_trace(log_dir: str, trace_id: str, as_json: bool) -> int:
    records = [r for r in journal_mod.read_dir(log_dir)
               if str(r.get("trace_id", "")).startswith(trace_id)]
    if not records:
        print(f"no journal records for trace {trace_id!r} under {log_dir}",
              file=sys.stderr)
        return 1
    _emit(records, as_json)
    if not as_json:
        pids = {(r.get("role"), r.get("pid")) for r in records}
        wall = records[-1].get("ts", 0.0) - records[0].get("ts", 0.0)
        print(f"-- trace {records[0].get('trace_id')}: {len(records)} records "
              f"across {len(pids)} processes, {wall:.3f}s")
    return 0


def cmd_tail(log_dir: str, n: int, as_json: bool) -> int:
    _emit(journal_mod.read_dir(log_dir)[-n:], as_json)
    return 0


def cmd_slowest(log_dir: str, n: int, as_json: bool) -> int:
    spans = [r for r in journal_mod.read_dir(log_dir)
             if r.get("kind") == "span" and r.get("dur_s") is not None]
    spans.sort(key=lambda r: r["dur_s"], reverse=True)
    _emit(spans[:n], as_json)
    return 0


def profile_rows(log_dir: str, key: Optional[str] = None,
                 peak_flops: Optional[float] = None) -> List[Dict[str, Any]]:
    """The ``profile`` verb's rows: one per program, joining its latest
    ``perf/cost`` with its ``perf/step`` records."""
    costs: Dict[str, Dict[str, Any]] = {}
    steps: Dict[str, List[Any]] = {}
    colds: Dict[str, List[float]] = {}
    for r in journal_mod.read_dir(log_dir):
        if r.get("kind") != "perf":
            continue
        h = r.get("key_hash")
        if not h:
            continue
        if r.get("name") == "cost":
            costs[h] = r  # latest wins: re-captures supersede
        elif r.get("name") == "step":
            dt = r.get("dt")
            if dt is None:
                continue
            compute = float(dt) - float(r.get("feed_s") or 0.0)
            if r.get("cold"):
                colds.setdefault(h, []).append(compute)
            else:
                steps.setdefault(h, []).append((compute, int(r.get("steps") or 1)))
    hashes = sorted(set(costs) | set(steps) | set(colds))
    if key:
        hashes = [h for h in hashes
                  if h.startswith(key) or key in str(costs.get(h, {}).get("key", ""))]
    rows = []
    for h in hashes:
        c = costs.get(h, {})
        warm = sorted(steps.get(h, []))
        row: Dict[str, Any] = {
            "key_hash": h,
            "key": c.get("key"),
            "kind": c.get("program_kind"),
            "k": c.get("k"),
            "flops": c.get("flops"),
            "bytes_accessed": c.get("bytes_accessed"),
            "peak_hbm_bytes": c.get("peak_hbm_bytes"),
            "device": c.get("device"),
            "dtype": c.get("dtype"),
            "epochs": len(warm),
            "cold_epochs": len(colds.get(h, [])),
        }
        if warm:
            row["step_p50_s"], row["steps"] = warm[len(warm) // 2]
            row["step_min_s"] = warm[0][0]
        if c.get("flops") and c.get("bytes_accessed"):
            row["arith_intensity"] = c["flops"] / c["bytes_accessed"]
        if c.get("flops") and warm:
            row["achieved_flops_s"] = c["flops"] * row["steps"] / row["step_p50_s"]
            peak = peak_flops or c.get("peak_flops")
            row["peak_flops_basis"] = peak
            row["mfu_vs_peak"] = row["achieved_flops_s"] / peak if peak else None
        rows.append(row)
    return rows


def cmd_profile(log_dir: str, key: Optional[str], as_json: bool,
                peak_flops: Optional[float]) -> int:
    """Join perf/cost x perf/step journal records into per-program
    MFU rows (the cross-process sibling of the live ``perf`` collector)."""
    rows = profile_rows(log_dir, key, peak_flops)
    if not rows:
        print(f"no perf records{f' matching {key!r}' if key else ''} "
              f"under {log_dir}", file=sys.stderr)
        return 1
    if as_json:
        print(json.dumps({"programs": rows}, default=str))
        return 0
    for row in rows:
        print(f"program {row['key_hash']}  kind={row['kind'] or '?'} "
              f"k={row['k'] or '?'} epochs={row['epochs']}"
              f" (+{row['cold_epochs']} cold)")
        if row.get("key"):
            print(f"  key: {row['key']}")
        if row.get("flops"):
            print(f"  count: {row['flops']:.4e} flops a step "
                  f"({row.get('dtype') or '?'} on {row.get('device') or '?'})")
        if row.get("step_p50_s") is not None:
            print(f"  observed: p50 warm epoch {row['step_p50_s']:.4f}s of "
                  f"{row['steps']} steps (min {row['step_min_s']:.4f}s)")
        if row.get("achieved_flops_s"):
            mfu = row.get("mfu_vs_peak")
            print(f"  achieved: {row['achieved_flops_s'] / 1e12:.3f} TFLOP/s -> "
                  + (f"MFU {mfu * 100:.3f}% of {row['peak_flops_basis'] / 1e12:.1f} "
                     "TFLOP/s peak" if mfu is not None else "MFU n/a (no known peak)"))
    return 0


def cmd_slo(log_dir: str, as_json: bool) -> int:
    """Latest slo/state snapshot + full breach/recovery history."""
    records = journal_mod.read_dir(log_dir)
    state = None
    breaches: List[Dict[str, Any]] = []
    recoveries: List[Dict[str, Any]] = []
    for r in records:
        if r.get("kind") != "slo":
            continue
        if r.get("name") == "state":
            state = r
        elif r.get("name") == "breach":
            breaches.append(r)
        elif r.get("name") == "recover":
            recoveries.append(r)
    if state is None and not breaches:
        print(f"no slo records under {log_dir} (is the engine ticking? "
              f"see docs/perf.md)", file=sys.stderr)
        return 1
    if as_json:
        print(json.dumps({"state": state, "breaches": breaches,
                          "recoveries": recoveries}, default=str))
        return 0
    if state is not None:
        print(f"slo state @ ts={state.get('ts')}:")
        for name, st in sorted((state.get("state") or {}).items()):
            mark = "BREACH" if st.get("breaching") else "ok"
            val = st.get("value")
            burn = st.get("burn")
            print(f"  {name:<24} {mark:<7} value="
                  f"{'n/a' if val is None else format(val, '.4g')} "
                  f"threshold={st.get('threshold')}"
                  + (f" burn={burn:.2f}x" if burn is not None else ""))
    print(f"breaches: {len(breaches)}, recoveries: {len(recoveries)}")
    for b in breaches[-8:]:
        print(f"  ts={b.get('ts')} {b.get('slo')} value={b.get('value')} "
              f"threshold={b.get('threshold')} ({b.get('source')})")
    return 0


def cmd_health(log_dir: str, as_json: bool) -> int:
    """Numerics health report: divergence verdicts and the capsule
    inventory from the ``health/*`` journal records. An empty report is a
    pass: exit 0 with a clean bill."""
    divergences: List[Dict[str, Any]] = []
    capsules: List[Dict[str, Any]] = []
    errors: List[Dict[str, Any]] = []
    for r in journal_mod.read_dir(log_dir):
        if r.get("kind") != "health":
            continue
        if r.get("name") == "divergence":
            divergences.append(r)
        elif r.get("name") == "capsule":
            capsules.append(r)
        elif r.get("name") == "capsule_error":
            errors.append(r)
    if as_json:
        print(json.dumps({"divergences": divergences, "capsules": capsules,
                          "capsule_errors": errors}, default=str))
        return 0
    if not divergences and not errors:
        print(f"no divergences under {log_dir} — numerically clean")
        return 0
    print(f"divergences: {len(divergences)}, capsules: {len(capsules)}, "
          f"capsule write errors: {len(errors)}")
    for d in divergences:
        member = d.get("member")
        where = f" member={member}" if member is not None else ""
        print(f"  ts={d.get('ts')} {d.get('divergence', '?'):<10}"
              f"{where} bad_step={d.get('bad_step')} badput={d.get('badput_s')}s")
        print(f"    {d.get('diagnosis', '?')}")
        if d.get("capsule"):
            print(f"    capsule: {d['capsule']}")
    for e in errors:
        print(f"  capsule write FAILED: {e.get('error')}")
    return 0


def _curve_overlay(rows: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Fit the extrapolator the early kill uses (higher-is-better
    ``acc`` points only): ``{fit, points}``, or None below two accuracy
    observations."""
    from rafiki_tpu_torch.advisor import curve as curve_mod
    from rafiki_tpu_torch.advisor.speculative import DEFAULT_HORIZON

    pts = [(int(r["epoch"]), float(r["acc"])) for r in rows
           if r.get("epoch") is not None and r.get("acc") is not None]
    if len(pts) < 2:
        return None
    fit = curve_mod.fit_curve(pts, max(DEFAULT_HORIZON, max(e for e, _ in pts) + 1))
    if fit is None:
        return None
    return {"fit": fit.to_record(),
            "points": [{"epoch": e, "predicted": v}
                       for e, v in curve_mod.predict_points(fit, pts)]}


def cmd_curves(log_dir: str, trial: Optional[str], as_json: bool,
               predicted: bool = False) -> int:
    """Per-trial learning curves from the durable ``trial/epoch_eval``
    records; with ``predicted``, each overlaid with the curve
    extrapolator's fit, the prediction a kill decision is audited
    against."""
    curves: Dict[str, List[Dict[str, Any]]] = {}
    for r in journal_mod.read_dir(log_dir):
        if r.get("kind") != "trial" or r.get("name") != "epoch_eval":
            continue
        tid = str(r.get("trial_id", "?"))
        if trial and not tid.startswith(trial):
            continue
        curves.setdefault(tid, []).append(r)
    if not curves:
        print(f"no epoch_eval records{f' for trial {trial!r}' if trial else ''} "
              f"under {log_dir}", file=sys.stderr)
        return 1
    for rows in curves.values():
        rows.sort(key=lambda r: (r.get("epoch", 0), r.get("ts", 0.0)))
    overlays: Dict[str, Optional[Dict[str, Any]]] = {}
    if predicted:
        overlays = {tid: _curve_overlay(rows) for tid, rows in curves.items()}
    if as_json:
        doc: Dict[str, Any] = {"trials": curves}
        if predicted:
            doc["predicted"] = overlays
        print(json.dumps(doc, default=str))
        return 0
    for tid, rows in sorted(curves.items()):
        last = rows[-1]
        packed = " [packed]" if last.get("packed") else ""
        print(f"trial {tid}{packed}: {len(rows)} epochs, final score={last.get('score')}")
        ov = overlays.get(tid)
        fitted = {p["epoch"]: p["predicted"] for p in ov["points"]} if ov else {}
        for r in rows:
            vals = [f"{k}={r[k]:.6g}" for k in ("loss", "acc") if r.get(k) is not None]
            if r.get("wall_s") is not None:
                vals.append(f"wall={r['wall_s']:.3f}s")
            if r.get("epoch") in fitted:
                vals.append(f"fit={fitted[r['epoch']]:.6g}")
            print(f"  epoch {r.get('epoch'):>3}  " + " ".join(vals))
        if predicted:
            if ov is None:
                print("  predicted: (needs >=2 acc observations)")
            else:
                f = ov["fit"]
                print(f"  predicted final={f['predicted']:.6g} band=±{f['band']:.6g} "
                      f"[{f['lo']:.6g}, {f['hi']:.6g}] family={f['family']} "
                      f"n_obs={f['n_obs']} rmse={f['rmse']:.6g} horizon={f['horizon']}")
    return 0


def cmd_replay(path: str, as_json: bool, device: Optional[str]) -> int:
    """Re-execute a divergence capsule and report the bit comparison.
    Exit 0 only when every compared sentinel value reproduced exactly;
    2 when the file is no capsule."""
    from rafiki_tpu_torch.obs.health import capsule

    try:
        result = capsule.replay(path, device=device)
    except (FileNotFoundError, ValueError) as e:
        print(f"replay failed: {e}", file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps(result, default=str))
        return 0 if result["reproduced"] else 1
    member = result.get("member")
    where = f" member={member}" if member is not None else ""
    print(f"capsule {result['capsule']}: {result['kind']}{where} "
          f"bad_step={result['bad_step']} steps_replayed={result['steps_replayed']}"
          + (" (poisoned)" if result["poisoned"] else ""))
    for k, c in result["comparisons"].items():
        mark = "ok " if c["match"] else "DIFF"
        bits = (f" [{c['expected_bits']} vs {c['got_bits']}]" if "expected_bits" in c else "")
        print(f"  {mark} {k:<26} expected={c['expected']} got={c['got']}{bits}")
    if result["reproduced"]:
        print("reproduced: the divergent step re-executed bit-exactly")
        return 0
    print(f"NOT reproduced: {', '.join(result['mismatches'])} diverged from the "
          f"observed run — the failure is not deterministic under replay")
    if result.get("captured_env") != result.get("replay_env"):
        print(f"  note: captured on {result.get('captured_env')}, replayed on "
              f"{result.get('replay_env')} — another device, build or switch "
              f"changes kernels and rounding")
    return 1


def cmd_shard(log_dir: str, as_json: bool) -> int:
    """The sharded-lane story (docs/sharding.md), reconstructed from the
    journals alone: per trial, the plan, every group (re-)formation with
    its width and members, member losses, and reshard-on-restore events,
    the width history a post-mortem needs."""
    plans = []
    by_trial: Dict[str, List[dict]] = {}
    group_walls = 0
    for r in journal_mod.read_dir(log_dir):
        kind, name = r.get("kind"), r.get("name")
        if kind == "shard" and name == "plan":
            plans.append(r)
        elif kind == "shard" and name in ("group_formed", "member_lost", "reshard"):
            by_trial.setdefault(str(r.get("trial_id")), []).append(r)
        elif kind == "perf" and name == "step" and int(r.get("group_width") or 0) > 1:
            group_walls += 1
    if not plans and not by_trial:
        print(f"no shard/* records under {log_dir} (did a sharded "
              f"group run? see docs/sharding.md)", file=sys.stderr)
        return 1
    if as_json:
        for r in plans:
            print(json.dumps(r, default=str))
        for rows in by_trial.values():
            for r in sorted(rows, key=lambda x: x.get("ts", 0.0)):
                print(json.dumps(r, default=str))
        return 0
    for r in plans:
        frac = r.get("hbm_frac")
        print(f"plan    family={r.get('family')} width={r.get('width')} "
              f"hbm_bytes={r.get('hbm_bytes')} "
              f"hbm_frac={round(frac, 4) if isinstance(frac, float) else frac}")
    reshards = 0
    for tid in sorted(by_trial):
        rows = sorted(by_trial[tid], key=lambda x: x.get("ts", 0.0))
        widths = [r.get("width") for r in rows if r.get("name") == "group_formed"]
        print(f"trial {tid[:13]}  width history: "
              + (" -> ".join(str(w) for w in widths) or "(none)"))
        for r in rows:
            name = r.get("name")
            if name == "group_formed":
                line = (f"width={r.get('width')} members={r.get('members')} "
                        f"attempt={r.get('attempt')}")
            elif name == "member_lost":
                line = f"lost={r.get('lost')} survivors={r.get('survivors')}"
            else:
                reshards += 1
                line = f"{r.get('from_width')} -> {r.get('to_width')} @epoch {r.get('epoch')}"
            print(f"  {name:<13} {line}")
    print(f"{len(by_trial)} sharded trial(s), {reshards} reshard "
          f"restore(s), {group_walls} group epoch wall(s) journaled")
    return 0


#: The decision records ``decisions`` reads: (kind, name) -> tag. The
#: first four are the JAX package's; the last three the curve advisor's.
_DECISIONS = {("serving", "route"): "route", ("gateway", "shed"): "shed",
              ("gateway", "breaker_transition"): "breaker", ("twin", "placement"): "placement",
              ("advisor", "kill"): "kill", ("advisor", "speculate"): "speculate",
              ("advisor", "correct"): "correct"}


def _decision_line(tag: str, r: Dict[str, Any]) -> str:
    if tag == "route":
        return (f"route={r.get('route')} job={r.get('job_id')} k={r.get('k')} "
                f"reason={r.get('reason')} workers={r.get('workers')}")
    if tag == "shed":
        return f"reason={r.get('reason')}"
    if tag == "breaker":
        return f"worker={r.get('worker_id')} {r.get('from_state')}→{r.get('to_state')}"
    if tag == "placement":
        return (f"job={r.get('job_id')} k={r.get('k')} chips={r.get('chips')} "
                f"rec={r.get('recommendation')} advisory={r.get('advisory')}")
    if tag == "kill":
        return (f"knobs_hash={r.get('knobs_hash')} trial={r.get('trial_id')} "
                f"epoch={r.get('epoch')} predicted={r.get('predicted')} hi={r.get('hi')} "
                f"best={r.get('best_so_far')} margin={(r.get('config') or {}).get('margin')}")
    if tag == "speculate":
        return (f"knobs_hash={r.get('knobs_hash')} predicted={r.get('predicted')} "
                f"advisor={r.get('advisor_id')}")
    return (f"knobs_hash={r.get('knobs_hash')} predicted={r.get('predicted')} "
            f"actual={r.get('actual')} error={r.get('error')}")


def cmd_decisions(log_dir: str, n: int, as_json: bool) -> int:
    """Decision forensics: route switches, admission sheds, breaker
    flips, placement advisories and the curve advisor's kills,
    speculations and corrections, merged into one time-ordered stream
    (the "why did serving degrade, why did this trial die" view)."""
    rows = [(_DECISIONS[(r.get("kind"), r.get("name"))], r)
            for r in journal_mod.read_dir(log_dir)
            if (r.get("kind"), r.get("name")) in _DECISIONS]
    if not rows:
        print(f"no decision records under {log_dir} (routes, sheds, breaker "
              f"transitions, placement advisories, curve kills and speculations)",
              file=sys.stderr)
        return 1
    rows.sort(key=lambda kr: kr[1].get("ts", 0.0))
    shown = rows[-n:] if n else rows
    if as_json:
        for _, r in shown:
            print(json.dumps(r, default=str))
        return 0
    for tag, r in shown:
        ts = r.get("ts")
        line = _decision_line(tag, r)
        print(f"{ts:>14.3f}  {tag:<9} {line}" if isinstance(ts, float)
              else f"{str(ts):>14}  {tag:<9} {line}")
    counts: Dict[str, int] = {}
    sheds: Dict[str, int] = {}
    flips: Dict[str, int] = {}
    for tag, r in rows:
        counts[tag] = counts.get(tag, 0) + 1
        if tag == "shed":
            sheds[str(r.get("reason"))] = sheds.get(str(r.get("reason")), 0) + 1
        elif tag == "breaker":
            flips[str(r.get("worker_id"))] = flips.get(str(r.get("worker_id")), 0) + 1
    print(f"{len(rows)} decisions ({', '.join(f'{k} {v}' for k, v in sorted(counts.items()))})"
          + (f"; sheds by reason: {sheds}" if sheds else "")
          + (f"; breaker transitions by worker: {flips}" if flips else ""))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m rafiki_tpu_torch.obs",
        description="merge and query the per-process observability journals")
    p.add_argument("--dir", default=None,
                   help="journal directory (default: $RAFIKI_LOG_DIR, "
                        "then the configured logs_dir)")
    p.add_argument("--json", action="store_true",
                   help="emit raw JSONL instead of formatted lines")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("trace", help="stitch one trace across processes")
    sp.add_argument("trace_id")
    sp = sub.add_parser("tail", help="last N records fleet-wide")
    sp.add_argument("-n", type=int, default=32)
    sp = sub.add_parser("slowest", help="N slowest spans")
    sp.add_argument("-n", type=int, default=16)
    sp = sub.add_parser("profile",
                        help="per-program FLOP count x epoch-time join")
    sp.add_argument("key", nargs="?", default=None,
                    help="program key-hash prefix or key substring")
    sp.add_argument("--peak-flops", type=float, default=None,
                    help="MFU denominator (default: the peak of the card "
                         "and dtype the cost record names)")
    sub.add_parser("slo", help="current SLO burn state + breach history")
    sub.add_parser("health", help="numerics divergences + replay capsule inventory")
    sp = sub.add_parser("curves", help="per-trial learning curves from the journals")
    sp.add_argument("trial", nargs="?", default=None,
                    help="trial id prefix (omit for all trials)")
    sp.add_argument("--predicted", action="store_true",
                    help="overlay the learning-curve extrapolator's fit "
                         "(predicted final + credible band) on each curve")
    sp = sub.add_parser("replay", help="re-execute a divergence capsule, bit-verify")
    sp.add_argument("capsule", help="path to a capsule-*.rcap file")
    sp.add_argument("--device", default=None,
                    help="where to replay (default: the CUDA card; 'cpu' on request)")
    sp.add_argument("--json", action="store_true", default=argparse.SUPPRESS,
                    help="the verdict as one JSON document")
    sub.add_parser("shard", help="sharded-group width history: plans, "
                                 "formations, member losses, reshard restores")
    sp = sub.add_parser("decisions",
                        help="decision stream: routes, sheds, breaker flips, placement "
                             "advisories, curve kills, speculations and corrections")
    sp.add_argument("-n", type=int, default=32,
                    help="show the last N decisions (0 = all)")
    from rafiki_tpu_torch.obs.search import cli as search_cli

    # Argparse only at attach; the readers load inside the verbs.
    search_cli.attach(sub)
    args = p.parse_args(argv)

    if args.cmd == "replay":
        # No journal directory needed: the capsule is self-contained.
        return cmd_replay(args.capsule, args.json, args.device)
    log_dir = args.dir or _default_dir()
    if args.cmd == "trace":
        return cmd_trace(log_dir, args.trace_id, args.json)
    if args.cmd == "tail":
        return cmd_tail(log_dir, args.n, args.json)
    if args.cmd == "profile":
        return cmd_profile(log_dir, args.key, args.json, args.peak_flops)
    if args.cmd == "slo":
        return cmd_slo(log_dir, args.json)
    if args.cmd == "health":
        return cmd_health(log_dir, args.json)
    if args.cmd == "curves":
        return cmd_curves(log_dir, args.trial, args.json, args.predicted)
    if args.cmd == "shard":
        return cmd_shard(log_dir, args.json)
    if args.cmd == "decisions":
        return cmd_decisions(log_dir, args.n, args.json)
    if args.cmd in ("sweep", "lineage", "resume"):
        return search_cli.dispatch(args, log_dir, args.json)
    return cmd_slowest(log_dir, args.n, args.json)
