"""CLI verbs for the digital twin: ``python -m rafiki_tpu_torch.obs twin
run|sweep|validate`` (docs/twin.md).

The port's own copy of ``rafiki_tpu/obs/twin/cli.py``.

Module-level imports stay stdlib-only: the obs CLI builds its parser
tree unconditionally, and the twin's engine imports (gateway,
predictor, chaos) must not tax ``obs tail`` on a host that never
simulates. Everything heavy loads inside the verb bodies.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Optional


def attach(sub: argparse._SubParsersAction) -> None:
    """Mount the ``twin`` verb on the obs CLI's subparser tree."""
    tp = sub.add_parser(
        "twin", help="digital-twin capacity plane: simulate, sweep, "
                     "validate (docs/twin.md)")
    tsub = tp.add_subparsers(dest="twin_cmd", required=True)

    def common(sp):
        sp.add_argument("--calibration", default=None,
                        help="calibration bundle JSON "
                             "(Calibration.save); default: "
                             "calibrate from the journal dir, falling "
                             "back to the nominal synthetic bundle")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--chaos", default=None, metavar="SPEC",
                        help="RAFIKI_CHAOS-grammar fault spec to inject")
        sp.add_argument("--scale", action="append", default=[],
                        metavar="SEG=FACTOR",
                        help="mis-calibrate a segment (repeatable), "
                             "e.g. forward=0.5")

    sp = tsub.add_parser("run", help="one simulation over a load shape "
                                     "or replayed serving/ts journal")
    common(sp)
    sp.add_argument("--load", default="constant",
                    help="constant|ramp|spike|diurnal|replay "
                         "(replay reconstructs arrivals from the "
                         "journal dir's serving/ts rows)")
    sp.add_argument("--qps", type=float, default=50.0)
    sp.add_argument("--duration", type=float, default=10.0)
    sp.add_argument("--workers", type=int, default=None)
    sp.add_argument("--queries", type=int, default=None,
                    help="microbatch: queries per request")
    sp.add_argument("--events", action="store_true",
                    help="carry the (capped) event log in the output")

    sp = tsub.add_parser("sweep", help="knob grid -> predicted "
                                       "p50/p99/qps/shed per row, plus "
                                       "the SLO smallest-fleet answer")
    common(sp)
    sp.add_argument("--load", default="constant")
    sp.add_argument("--qps", type=float, default=50.0)
    sp.add_argument("--duration", type=float, default=10.0)
    sp.add_argument("--grid", action="append", default=[],
                    metavar="KNOB=V1,V2,...",
                    help="sweep axis (repeatable), e.g. workers=1,2,4,8")
    sp.add_argument("--fleet", action="store_true",
                    help="also run the RAFIKI_SLO smallest-fleet search")
    sp.add_argument("--suggest-slo", action="store_true",
                    help="emit an auto-tuned RAFIKI_SLO spec set "
                         "anchored at the smallest-fleet knee "
                         "(implies --fleet)")

    sp = tsub.add_parser("validate",
                         help="replay a captured serving run; "
                              "gate predicted-vs-measured p50/p99 error")
    common(sp)
    sp.add_argument("--tolerance", type=float, default=None,
                    help="relative-error gate (default 0.40)")
    sp.add_argument("--out", default=None,
                    help="write the TWIN artifact JSON here (the "
                         "bench_report --twin ledger format)")


def _parse_scales(items) -> Dict[str, float]:
    scales: Dict[str, float] = {}
    for item in items:
        seg, eq, val = item.partition("=")
        if not eq:
            raise SystemExit(f"bad --scale {item!r}; want segment=factor")
        scales[seg.strip()] = float(val)
    return scales


def _load_calibration(args, log_dir):
    from rafiki_tpu_torch.obs.twin.calibration import Calibration, CalibrationError
    if args.calibration:
        cal = Calibration.load(args.calibration)
    else:
        try:
            cal = Calibration.from_journal_dir(log_dir)
        except CalibrationError as e:
            print(f"note: {e}; using the nominal synthetic bundle",
                  file=sys.stderr)
            cal = Calibration.nominal()
    scales = _parse_scales(args.scale)
    return cal.scaled(scales) if scales else cal


def _arrivals(args, log_dir):
    from rafiki_tpu_torch.obs.twin import load as load_mod
    if args.load == "replay":
        from rafiki_tpu_torch.obs import journal as journal_mod
        rows = [r for r in journal_mod.read_dir(log_dir)
                if r.get("kind") == "serving" and r.get("name") == "ts"]
        arr = load_mod.replay_from_ts(rows, seed=args.seed)
        if not arr:
            raise SystemExit(f"no serving/ts rows to replay under "
                             f"{log_dir}")
        return arr
    return load_mod.synthesize(args.load, qps=args.qps,
                               duration_s=args.duration, seed=args.seed)


def dispatch(args, log_dir: str, as_json: bool) -> int:
    if args.twin_cmd == "run":
        return cmd_run(args, log_dir, as_json)
    if args.twin_cmd == "sweep":
        return cmd_sweep(args, log_dir, as_json)
    return cmd_validate(args, log_dir, as_json)


def cmd_run(args, log_dir: str, as_json: bool) -> int:
    from rafiki_tpu_torch.obs.twin.engine import TwinConfig
    from rafiki_tpu_torch.obs.twin.whatif import run_once
    cal = _load_calibration(args, log_dir)
    overrides: Dict[str, Any] = {}
    if args.workers is not None:
        overrides["workers"] = args.workers
    if args.queries is not None:
        overrides["queries_per_request"] = args.queries
    cfg = TwinConfig.from_calibration(cal, **overrides)
    res = run_once(cal, cfg, _arrivals(args, log_dir), seed=args.seed,
                   chaos_spec=args.chaos, record_events=args.events)
    if as_json:
        print(json.dumps(res, default=str))
    else:
        u = res["utilization"]
        print(f"{res['requests']} requests @ {res['qps']} qps over "
              f"{res['duration_s']}s: ok={res['ok']} shed={res['shed']} "
              f"errors={res['errors']}")
        print(f"  latency p50={res['p50_ms']}ms p99={res['p99_ms']}ms "
              f"(admit->done); shed_rate={res['shed_rate']}")
        print(f"  first saturating: {res['first_saturating']} "
              f"(worker={u['worker']} inflight={u['gateway_inflight']} "
              f"queue={u['queue']} breaker={u['breaker']} "
              f"hbm={u['hbm']})")
        print(f"  event log: {res['event_log_len']} events, "
              f"sha1 {res['event_log_sha1'][:12]}")
    return 0


def cmd_sweep(args, log_dir: str, as_json: bool) -> int:
    from rafiki_tpu_torch.obs.twin.engine import TwinConfig
    from rafiki_tpu_torch.obs.twin import whatif
    cal = _load_calibration(args, log_dir)
    base = TwinConfig.from_calibration(cal)
    arrivals = _arrivals(args, log_dir)
    grid = whatif.parse_grid(args.grid) or {"workers": [1, 2, 4, 8]}
    rows = whatif.sweep(cal, base, arrivals, grid, seed=args.seed,
                        chaos_spec=args.chaos)
    doc: Dict[str, Any] = {"grid": {k: list(v) for k, v in grid.items()},
                           "seed": args.seed, "rows": rows}
    if args.fleet or args.suggest_slo:
        doc["fleet"] = whatif.fleet_search(cal, base, arrivals,
                                           seed=args.seed)
    if args.suggest_slo:
        doc["suggested_slo"] = whatif.suggest_slo(doc["fleet"])
    if as_json:
        print(json.dumps(doc, default=str))
        return 0
    knobs = sorted(grid)
    for row in rows:
        knobstr = " ".join(f"{k}={row[k]}" for k in knobs)
        print(f"{knobstr:<32} qps={row['qps']:>8} p50={row['p50_ms']}ms "
              f"p99={row['p99_ms']}ms shed={row['shed_rate']} "
              f"saturates={row['first_saturating']}")
    if "fleet" in doc:
        f = doc["fleet"]
        t = f["targets"]
        if f["satisfied"]:
            print(f"fleet: {f['workers']} worker(s) meet p99<="
                  f"{t['p99_ms']}ms shed<={t['shed_rate']} "
                  f"(scanned {len(f['scanned'])})")
        else:
            print(f"fleet: NO worker count up to {len(f['scanned'])} "
                  f"meets p99<={t['p99_ms']}ms shed<={t['shed_rate']}; "
                  f"last saturates {f['first_saturating']}")
    if "suggested_slo" in doc:
        print("suggested RAFIKI_SLO (paste as the env value):")
        print(f"  {json.dumps(doc['suggested_slo'])}")
    return 0


def cmd_validate(args, log_dir: str, as_json: bool) -> int:
    from rafiki_tpu_torch.obs.twin import validate as validate_mod
    kwargs: Dict[str, Any] = {"seed": args.seed}
    if args.tolerance is not None:
        kwargs["tolerance"] = args.tolerance
    scales = _parse_scales(args.scale)
    if scales:
        kwargs["scales"] = scales
    try:
        doc = validate_mod.validate(log_dir, **kwargs)
    except (ValueError, OSError) as e:
        print(f"twin validate: {e}", file=sys.stderr)
        return 2
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
    if as_json:
        print(json.dumps(doc, default=str))
    else:
        m, pr = doc["measured"], doc["predicted"]
        print(f"measured : p50={m['p50_ms']}ms p99={m['p99_ms']}ms "
              f"({m['requests']} requests)")
        print(f"predicted: p50={pr['p50_ms']}ms p99={pr['p99_ms']}ms "
              f"(saturates {pr['first_saturating']})")
        print(f"error    : p50={doc['p50_err']} p99={doc['p99_err']} "
              f"tolerance={doc['tolerance']} -> "
              f"{'OK' if doc['ok'] else 'FAIL'}")
    return 0 if doc["ok"] else 1
