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
                   trial ids (omit for every trial)
    replay <cap>   re-execute a divergence capsule (on the card, or
                   ``--device cpu``) and bit-verify the reproduction;
                   exit 0 only when the bad step reproduced bit for bit
    shard          the sharded lane's story: each ``shard/plan``, and per
                   trial its width history (group formations, member
                   losses, reshard-on-restore events); exit 1 when the
                   journals hold no ``shard/*`` record

The journals of either package read the same: ``trace``, ``tail``,
``slowest``, ``slo``, ``health``, ``curves`` and ``shard`` print what the JAX
package's CLI prints (``curves`` without the JAX package's
``--predicted`` overlay: the learning-curve extrapolator is not
ported).
``profile`` multiplies a step's flops by the epoch's ``steps`` where
the ``perf/step`` record carries them (the port's do; a JAX package
journal's count as one step, as its own CLI reads them) and takes the
MFU denominator from ``--peak-flops`` or else from the ``perf/cost``
record's ``peak_flops`` (the card and compute dtype the step ran on).

Output is one human line per record by default, ``--json`` for JSONL.
Exit code 1 when a requested trace has no records. Importing this
module imports no torch: it reads journals on any machine (``replay``
alone needs torch, and loads it when it runs).
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


def cmd_curves(log_dir: str, trial: Optional[str], as_json: bool) -> int:
    """Per-trial learning curves from the durable ``trial/epoch_eval``
    records."""
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
    if as_json:
        print(json.dumps({"trials": curves}, default=str))
        return 0
    for tid, rows in sorted(curves.items()):
        last = rows[-1]
        packed = " [packed]" if last.get("packed") else ""
        print(f"trial {tid}{packed}: {len(rows)} epochs, final score={last.get('score')}")
        for r in rows:
            vals = [f"{k}={r[k]:.6g}" for k in ("loss", "acc") if r.get(k) is not None]
            if r.get("wall_s") is not None:
                vals.append(f"wall={r['wall_s']:.3f}s")
            print(f"  epoch {r.get('epoch'):>3}  " + " ".join(vals))
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
    sp = sub.add_parser("replay", help="re-execute a divergence capsule, bit-verify")
    sp.add_argument("capsule", help="path to a capsule-*.rcap file")
    sp.add_argument("--device", default=None,
                    help="where to replay (default: the CUDA card; 'cpu' on request)")
    sp.add_argument("--json", action="store_true", default=argparse.SUPPRESS,
                    help="the verdict as one JSON document")
    sub.add_parser("shard", help="sharded-group width history: plans, "
                                 "formations, member losses, reshard restores")
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
        return cmd_curves(log_dir, args.trial, args.json)
    if args.cmd == "shard":
        return cmd_shard(log_dir, args.json)
    return cmd_slowest(log_dir, args.n, args.json)
