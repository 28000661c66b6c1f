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
    waterfall <id> per-hop serving waterfall for one trace (prefix
                   match): every gathered hop chain rendered with
                   offsets, segments, pids, and the hop-sum
                   reconciliation error
    tails          tail attribution: decompose the p99-over-p50 excess
                   of the serving path into per-hop contributions from
                   the ``serving/hops`` + ``serving/exemplar``
                   records; ``--check`` also gates hop-sum
                   reconciliation within ``--tolerance``
    serving [-n N] the continuous serving time-series: last N
                   ``serving/ts`` rollup rows (qps, p50/p99, shed
                   rate, queue depth, inflight, breaker state)
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
    autoscale      replay the elasticity controller's decision stream
                   (``autoscale/decision`` + spawn/drain/prewarm):
                   direction, sizes, pressure, reason, damping/veto
                   flags and the sensor snapshot; ``--check`` exits 1
                   when actuated direction flips inside ``--window``
                   exceed ``--flips``
    twin run|sweep|validate
                   the serving twin (``obs/twin/cli.py``): one simulation
                   over a load shape or the journal's ``serving/ts``
                   rows, a knob sweep with the smallest-fleet search, and
                   predicted-vs-measured p50/p99 against a captured run
    tenants        per-tenant serving forensics from the ``tenant/*``
                   accounting records (admit/request/shed/summary) and
                   the ``tenancy/*`` records (residency swaps, co-hosted
                   workers): one row per tenant with tier, qps, p50/p99,
                   shed breakdown and SLO burn; ``--check`` exits 1 when
                   the flushed ``tenant/summary`` disagrees with the raw
                   per-record counts

The journals of either package read the same: ``trace``, ``tail``,
``slowest``, ``slo``, ``health``, ``curves`` (with ``--predicted``),
``waterfall``, ``tails``, ``serving``, ``shard``, ``sweep``, ``lineage``,
``resume``, ``tenants``, ``autoscale`` and ``twin`` print what the JAX package's CLI prints. ``decisions`` prints the JAX package's four kinds
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


def _hop_records(log_dir: str,
                 trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """The unique ``serving`` hop-chain records (waterfalls), deduped
    by query id — an exemplar is the same chains journaled twice."""
    out: List[Dict[str, Any]] = []
    seen = set()
    for r in journal_mod.read_dir(log_dir):
        if r.get("kind") != "serving" or r.get("name") not in ("hops",
                                                               "exemplar"):
            continue
        if trace_id and not str(r.get("trace_id", "")).startswith(trace_id):
            continue
        if not r.get("chains"):
            continue
        qid = r.get("query_id")
        if qid in seen:
            continue
        seen.add(qid)
        out.append(r)
    return out


def _chain_view(marks: List[List[Any]]) -> Dict[str, Any]:
    """Segments + reconciliation for one chain. The reconciliation
    compares the sum of NAMED segments against the chain's end-to-end
    span — exact when every mark is known and ordered, loud when a hop
    went missing or a foreign mark absorbed time."""
    from rafiki_tpu_torch.obs.anatomy import hops as hops_mod

    total = hops_mod.chain_total_s(marks)
    segs = hops_mod.segments(marks)
    seg_sum = sum(d for _, d in segs)
    err = abs(seg_sum - total) / total if total > 0 else 0.0
    return {"marks": marks,
            "segments": [{"segment": s, "ms": round(d * 1000.0, 3)}
                         for s, d in segs],
            "total_ms": round(total * 1000.0, 3),
            "seg_sum_ms": round(seg_sum * 1000.0, 3),
            "reconcile_err": round(err, 6)}


def cmd_waterfall(log_dir: str, trace_id: str, as_json: bool) -> int:
    """Stitch one trace's hop chains into a waterfall."""
    records = _hop_records(log_dir, trace_id)
    if not records:
        print(f"no serving hop records for trace {trace_id!r} under "
              f"{log_dir}", file=sys.stderr)
        return 1
    e2e = [r for r in journal_mod.read_dir(log_dir)
           if r.get("kind") == "serving" and r.get("name") == "request"
           and str(r.get("trace_id", "")).startswith(trace_id)]
    queries = []
    for r in records:
        chains = {w: _chain_view(m) for w, m in r["chains"].items()}
        all_marks = [m for v in chains.values() for m in v["marks"]]
        queries.append({
            "query_id": r.get("query_id"),
            "trace_id": r.get("trace_id"),
            "n_hops": max((len(v["marks"]) for v in chains.values()),
                          default=0),
            "pids": sorted({int(m[2]) for m in all_marks}),
            "total_s": r.get("total_s"),
            "max_reconcile_err": max((v["reconcile_err"]
                                      for v in chains.values()), default=0.0),
            "chains": chains,
        })
    doc = {"trace_id": records[0].get("trace_id"), "queries": queries,
           "e2e_s": e2e[-1].get("e2e_s") if e2e else None}
    if as_json:
        print(json.dumps(doc, default=str))
        return 0
    for q in queries:
        print(f"query {q['query_id']}  trace={q['trace_id']} "
              f"hops={q['n_hops']} pids={q['pids']} "
              f"total={q['total_s']}s "
              f"reconcile_err={q['max_reconcile_err']:.4f}")
        for w, v in sorted(q["chains"].items()):
            print(f"  chain {w}: total {v['total_ms']}ms "
                  f"(segments sum {v['seg_sum_ms']}ms)")
            t_first = float(v["marks"][0][1]) if v["marks"] else 0.0
            for m in v["marks"]:
                off_ms = (float(m[1]) - t_first) * 1000.0
                print(f"    +{off_ms:10.3f}ms  {str(m[0]):<6} pid={m[2]}")
            for s in v["segments"]:
                print(f"      {s['segment']:<16} {s['ms']:10.3f}ms")
    if doc["e2e_s"] is not None:
        print(f"-- gateway e2e (post-admission): {doc['e2e_s']}s")
    return 0


def _pctile(xs: List[float], q: float) -> float:
    xs = sorted(xs)
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[idx]


def cmd_tails(log_dir: str, as_json: bool, check: bool,
              tolerance: float) -> int:
    """Decompose the p99-over-p50 latency excess into hop
    contributions, and (with ``--check``) gate hop-sum
    reconciliation."""
    from rafiki_tpu_torch.obs.anatomy import hops as hops_mod

    records = _hop_records(log_dir)
    if not records:
        print(f"no serving hop records under {log_dir}", file=sys.stderr)
        return 1
    per_seg: Dict[str, List[float]] = {}
    totals: List[float] = []
    worst_err = 0.0
    for r in records:
        rec_total = 0.0
        for marks in r["chains"].values():
            total = hops_mod.chain_total_s(marks)
            segs = hops_mod.segments(marks)
            for s, d in segs:
                per_seg.setdefault(s, []).append(d)
            seg_sum = sum(d for _, d in segs)
            if total > 0:
                worst_err = max(worst_err, abs(seg_sum - total) / total)
            rec_total = max(rec_total, total)
        totals.append(rec_total)
    p50_tot, p99_tot = _pctile(totals, 50.0), _pctile(totals, 99.0)
    excess = max(0.0, p99_tot - p50_tot)
    contribs = {s: max(0.0, _pctile(d, 99.0) - _pctile(d, 50.0))
                for s, d in per_seg.items()}
    contrib_sum = sum(contribs.values()) or 1.0
    segments = [{"segment": s,
                 "count": len(per_seg[s]),
                 "p50_ms": round(_pctile(per_seg[s], 50.0) * 1000.0, 3),
                 "p99_ms": round(_pctile(per_seg[s], 99.0) * 1000.0, 3),
                 "excess_ms": round(c * 1000.0, 3),
                 "share": round(c / contrib_sum, 4)}
                for s, c in sorted(contribs.items(),
                                   key=lambda kv: kv[1], reverse=True)]
    reconciled = worst_err <= tolerance
    doc = {"requests": len(records),
           "p50_ms": round(p50_tot * 1000.0, 3),
           "p99_ms": round(p99_tot * 1000.0, 3),
           "excess_ms": round(excess * 1000.0, 3),
           "dominant": segments[0]["segment"] if segments else None,
           "segments": segments,
           "reconcile": {"worst_err": round(worst_err, 6),
                         "tolerance": tolerance, "ok": reconciled}}
    if as_json:
        print(json.dumps(doc, default=str))
    else:
        print(f"{doc['requests']} requests: p50 {doc['p50_ms']}ms, "
              f"p99 {doc['p99_ms']}ms, excess {doc['excess_ms']}ms")
        for s in segments:
            print(f"  {s['segment']:<16} n={s['count']:<5} "
                  f"p50={s['p50_ms']:>9.3f}ms p99={s['p99_ms']:>9.3f}ms "
                  f"excess={s['excess_ms']:>9.3f}ms share={s['share']:.0%}")
        print(f"hop-sum reconciliation: worst_err="
              f"{doc['reconcile']['worst_err']:.4f} "
              f"({'ok' if reconciled else 'FAIL'} at tol {tolerance})")
    if check and not reconciled:
        print(f"hop sums do not reconcile with end-to-end latency "
              f"(worst_err {worst_err:.4f} > {tolerance})", file=sys.stderr)
        return 1
    return 0


def cmd_serving(log_dir: str, n: int, as_json: bool) -> int:
    """Render the last N serving/ts rollup rows."""
    rows = [r for r in journal_mod.read_dir(log_dir)
            if r.get("kind") == "serving" and r.get("name") == "ts"]
    if not rows:
        print(f"no serving/ts records under {log_dir} (is a gateway "
              f"journaling?)", file=sys.stderr)
        return 1
    rows = rows[-n:]
    if as_json:
        for r in rows:
            print(json.dumps(r, default=str))
        return 0
    for r in rows:
        breakers = r.get("breakers") or {}
        open_n = r.get("breakers_open", 0)
        print(f"bucket {r.get('bucket')}  qps={r.get('qps')} "
              f"p50={r.get('p50_ms')}ms p99={r.get('p99_ms')}ms "
              f"shed_rate={r.get('shed_rate')} ok={r.get('ok')} "
              f"shed={r.get('shed')} err={r.get('errors')} "
              f"queue={r.get('queue_depth')} inflight={r.get('inflight')} "
              f"breakers={len(breakers)} ({open_n} open)")
    return 0


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


def cmd_autoscale(log_dir: str, n: int, as_json: bool, check: bool,
                  window_s: float, max_flips: int) -> int:
    """Replay the controller's decision stream; with ``--check``, gate
    on flap: actuated direction flips per lane inside ``window_s``
    must stay under ``max_flips`` (the smoke's vacuous-pass polarity
    runs an undamped controller through here and MUST fail)."""
    records = [r for r in journal_mod.read_dir(log_dir)
               if r.get("kind") == "autoscale"]
    if not records:
        print(f"no autoscale records under {log_dir} (is a controller "
              f"running? see docs/autoscale.md)", file=sys.stderr)
        return 1
    decisions = [r for r in records if r.get("name") == "decision"]
    shown = decisions[-n:] if n else decisions
    if as_json:
        for r in shown:
            print(json.dumps(r, default=str))
    else:
        for r in shown:
            flags = "".join((" DAMPED" if r.get("damped") else "",
                             " VETOED" if r.get("vetoed") else "",
                             " actuated" if r.get("actuated") else ""))
            s = r.get("sensors") or {}
            press = r.get("pressure")
            print(f"{r.get('lane', '?'):<10} {r.get('direction', '?'):<5}"
                  f" {r.get('current')}→{r.get('target')}"
                  f"  p={press if press is None else round(press, 3)}"
                  f" reason={r.get('reason')}{flags}"
                  f"  [burn={s.get('slo_burn')} queue={s.get('queue_depth')}"
                  f" shed={s.get('shed_rate')}"
                  f" eph={s.get('effective_trials_per_hour')}]")
    if not check:
        return 0
    worst = 0
    for lane in {r.get("lane") for r in decisions}:
        acts = [(r.get("tick_ts") or r.get("ts", 0.0), r.get("direction"))
                for r in decisions
                if r.get("lane") == lane and r.get("actuated")]
        flips = [b_ts for (a_ts, a), (b_ts, b) in zip(acts, acts[1:])
                 if a != b]
        for i, ts in enumerate(flips):
            inside = sum(1 for t in flips[:i + 1] if ts - t <= window_s)
            worst = max(worst, inside)
    if worst > max_flips:
        print(f"FLAPPING: {worst} direction flips inside {window_s}s "
              f"(limit {max_flips}) — an undamped actuator is thrashing "
              f"capacity (docs/autoscale.md)", file=sys.stderr)
        return 1
    print(f"damping ok: worst flip count {worst} within {window_s}s "
          f"(limit {max_flips})")
    return 0


def cmd_tenants(log_dir: str, as_json: bool, check: bool) -> int:
    """Per-tenant serving forensics: who was admitted, who was shed
    and why, and whose SLO burned (the "which tenant is the noisy
    neighbor" view), read from journals alone: the ``tenant`` kind the
    admission and accounting write per request, and the ``tenancy``
    kind the residency manager writes per swap, the co-hosting services
    per worker and the JAX package's arbiter per job verdict."""
    recs = journal_mod.read_dir(log_dir)
    # Kind-wholesale filters on purpose: every name under these two
    # kinds is forensic state this verb must surface, including names
    # added later.
    tenant_recs = [r for r in recs if r.get("kind") == "tenant"]
    tenancy_recs = [r for r in recs if r.get("kind") == "tenancy"]
    if not tenant_recs and not tenancy_recs:
        print(f"no tenant/tenancy records under {log_dir} (is a "
              f"tenant-aware gateway running?)", file=sys.stderr)
        return 1

    def _p(xs: List[float], frac: float) -> Optional[float]:
        if not xs:
            return None
        return xs[min(len(xs) - 1, int(frac * len(xs)))]

    per: Dict[str, Dict[str, Any]] = {}
    for r in tenant_recs:
        t = r.get("tenant")
        if t is None:
            continue
        row = per.setdefault(t, {"tier": None, "admitted": 0, "requests": 0,
                                 "ok": 0, "shed": 0, "shed_reasons": {},
                                 "lat_s": [], "burn": None})
        name = r.get("name")
        if name == "admit":
            row["admitted"] += 1
            row["tier"] = r.get("tier") or row["tier"]
        elif name == "request":
            row["requests"] += 1
            row["ok"] += 1 if r.get("ok") else 0
            if isinstance(r.get("e2e_s"), (int, float)):
                row["lat_s"].append(float(r["e2e_s"]))
        elif name == "shed":
            row["shed"] += 1
            row["tier"] = r.get("tier") or row["tier"]
            reason = str(r.get("reason"))
            row["shed_reasons"][reason] = (
                row["shed_reasons"].get(reason, 0) + 1)
    summaries = [r for r in tenant_recs if r.get("name") == "summary"]
    latest = summaries[-1].get("tenants", {}) if summaries else {}
    ts = [r.get("ts") for r in tenant_recs
          if isinstance(r.get("ts"), (int, float))]
    span_s = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    table = []
    for t in sorted(per):
        row = per[t]
        xs = sorted(row["lat_s"])
        table.append({
            "tenant": t,
            "tier": row["tier"],
            "admitted": row["admitted"],
            "requests": row["requests"],
            "ok": row["ok"],
            "shed": row["shed"],
            "shed_reasons": row["shed_reasons"],
            "qps": (round(row["requests"] / span_s, 2) if span_s else None),
            "p50_ms": (None if _p(xs, 0.50) is None
                       else round(_p(xs, 0.50) * 1000, 3)),
            "p99_ms": (None if _p(xs, 0.99) is None
                       else round(_p(xs, 0.99) * 1000, 3)),
            "burn": (latest.get(t, {}) or {}).get("burn"),
        })
    residency = [r for r in tenancy_recs if r.get("name") == "residency"]
    cohosts = [r for r in tenancy_recs if r.get("name") == "cohost"]
    verdicts = [r for r in tenancy_recs if r.get("name") == "arbiter"]
    swap_events: Dict[str, int] = {}
    for r in residency:
        ev = str(r.get("event"))
        swap_events[ev] = swap_events.get(ev, 0) + 1
    if as_json:
        print(json.dumps({
            "tenants": table,
            "summary": latest or None,
            "residency_events": swap_events,
            "cohosted_workers": [
                {"worker_id": r.get("worker_id"), "jobs": r.get("jobs"),
                 "budget_bytes": r.get("budget_bytes")} for r in cohosts],
            "arbiter_verdicts": [
                {"job_id": r.get("job_id"), "tenant": r.get("tenant"),
                 "verdict": r.get("verdict")} for r in verdicts],
        }, default=str))
    else:
        for row in table:
            sheds = (f" shed={row['shed']}{row['shed_reasons']}"
                     if row["shed"] else "")
            print(f"{row['tenant']:<16} {str(row['tier']):<6} "
                  f"adm={row['admitted']:<5} req={row['requests']:<5} "
                  f"qps={row['qps']} p50={row['p50_ms']}ms "
                  f"p99={row['p99_ms']}ms burn={row['burn']}{sheds}")
        if swap_events:
            print(f"residency: {swap_events}")
        for r in cohosts:
            print(f"cohost: worker={r.get('worker_id')} "
                  f"jobs={r.get('jobs')} budget={r.get('budget_bytes')}B")
        for r in verdicts:
            print(f"arbiter: job={r.get('job_id')} "
                  f"tenant={r.get('tenant')} verdict={r.get('verdict')}")
    if not check:
        return 0
    if not summaries:
        print("no tenant/summary record — the gateway never drained, so "
              "the accounting flush is missing", file=sys.stderr)
        return 1
    bad = []
    for t, row in per.items():
        s = latest.get(t, {}) or {}
        if s.get("admitted") != row["admitted"]:
            bad.append(f"{t}: summary admitted={s.get('admitted')} vs "
                       f"{row['admitted']} tenant/admit records")
        if s.get("shed") != row["shed"]:
            bad.append(f"{t}: summary shed={s.get('shed')} vs "
                       f"{row['shed']} tenant/shed records")
    if bad:
        print("RECONCILIATION FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    print(f"reconciled: {len(per)} tenant(s) against the flushed summary")
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
    sp = sub.add_parser("waterfall",
                        help="per-hop serving waterfall for one trace")
    sp.add_argument("trace_id")
    sp = sub.add_parser("tails",
                        help="p99-over-p50 excess by serving hop")
    sp.add_argument("--check", action="store_true",
                    help="exit 1 unless hop sums reconcile with "
                         "end-to-end latency")
    sp.add_argument("--tolerance", type=float, default=0.10,
                    help="reconciliation tolerance (default 0.10)")
    sp = sub.add_parser("serving",
                        help="continuous serving time-series rows")
    sp.add_argument("-n", type=int, default=32)
    sub.add_parser("shard", help="sharded-group width history: plans, "
                                 "formations, member losses, reshard restores")
    sp = sub.add_parser("decisions",
                        help="decision stream: routes, sheds, breaker flips, placement "
                             "advisories, curve kills, speculations and corrections")
    sp.add_argument("-n", type=int, default=32,
                    help="show the last N decisions (0 = all)")
    sp = sub.add_parser("tenants",
                        help="per-tenant serving forensics: admission, "
                             "shed breakdown, SLO burn, residency swaps")
    sp.add_argument("--check", action="store_true",
                    help="exit 1 when the flushed tenant/summary "
                         "disagrees with raw per-record counts")
    sp = sub.add_parser("autoscale",
                        help="elasticity controller decision replay")
    sp.add_argument("-n", type=int, default=32,
                    help="show the last N decisions (0 = all)")
    sp.add_argument("--check", action="store_true",
                    help="exit 1 when actuations flap (direction flips "
                         "within --window exceed --flips)")
    sp.add_argument("--window", type=float, default=60.0,
                    help="flap detection window seconds (default 60)")
    sp.add_argument("--flips", type=int, default=4,
                    help="max direction flips tolerated in the window")
    from rafiki_tpu_torch.obs.search import cli as search_cli
    from rafiki_tpu_torch.obs.twin import cli as twin_cli

    # Argparse only at attach; the readers (and the twin's engine) load
    # inside the verbs.
    twin_cli.attach(sub)
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
    if args.cmd == "waterfall":
        return cmd_waterfall(log_dir, args.trace_id, args.json)
    if args.cmd == "tails":
        return cmd_tails(log_dir, args.json, args.check, args.tolerance)
    if args.cmd == "serving":
        return cmd_serving(log_dir, args.n, args.json)
    if args.cmd == "shard":
        return cmd_shard(log_dir, args.json)
    if args.cmd == "decisions":
        return cmd_decisions(log_dir, args.n, args.json)
    if args.cmd == "tenants":
        return cmd_tenants(log_dir, args.json, args.check)
    if args.cmd == "autoscale":
        return cmd_autoscale(log_dir, args.n, args.json, args.check,
                             args.window, args.flips)
    if args.cmd == "twin":
        return twin_cli.dispatch(args, log_dir, args.json)
    if args.cmd in ("sweep", "lineage", "resume"):
        return search_cli.dispatch(args, log_dir, args.json)
    return cmd_slowest(log_dir, args.n, args.json)
