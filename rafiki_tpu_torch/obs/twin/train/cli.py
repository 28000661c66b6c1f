"""CLI verbs for the train twin: ``python -m rafiki_tpu_torch.obs twin
train run|sweep|validate`` (docs/twin.md).

The port's own copy of ``rafiki_tpu/obs/twin/train/cli.py``.

Mounted by :mod:`rafiki_tpu_torch.obs.twin.cli` under the ``twin`` verb.
Module-level imports stay stdlib-only for the same reason as the
parent: the obs CLI builds its parser tree unconditionally, and the
engine/chaos imports must not tax ``obs tail``. Everything heavy loads
inside the verb bodies.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict


def attach(tsub: argparse._SubParsersAction) -> None:
    """Mount ``train`` (with its run/sweep/validate verbs) on the twin
    subparser tree."""
    tp = tsub.add_parser(
        "train", help="training/sweep twin: simulate a mesh sweep, "
                      "plan pack/split, validate vs a captured run "
                      "(docs/twin.md)")
    trsub = tp.add_subparsers(dest="train_cmd", required=True)

    def common(sp):
        sp.add_argument("--calibration", default=None,
                        help="train calibration bundle JSON "
                             "(TrainCalibration.save); "
                             "default: calibrate from the journal dir, "
                             "falling back to the nominal synthetic "
                             "bundle")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--chaos", default=None, metavar="SPEC",
                        help="RAFIKI_CHAOS-grammar fault spec "
                             "(scheduler.preempt / host.loss sites)")
        sp.add_argument("--scale", action="append", default=[],
                        metavar="SEG=FACTOR",
                        help="mis-calibrate a segment (repeatable), "
                             "e.g. step=2.0 or compile=0.5")

    sp = trsub.add_parser("run", help="one sweep simulation")
    common(sp)
    sp.add_argument("--chips", type=int, default=None)
    sp.add_argument("--pack", type=int, default=None,
                    help="RAFIKI_TRIAL_PACK slots per chip (k)")
    sp.add_argument("--trials", type=int, default=None)
    sp.add_argument("--chips-per-host", type=int, default=0,
                    help="group chips into hosts for the host.loss "
                         "chaos site")
    sp.add_argument("--events", action="store_true",
                    help="carry the (capped) event log in the output")

    sp = trsub.add_parser(
        "sweep", help="config grid -> predicted trials/hour per row, "
                      "plus best-k per packing key and the chips-vs-"
                      "pack split search")
    common(sp)
    sp.add_argument("--grid", action="append", default=[],
                    metavar="KNOB=V1,V2,...",
                    help="sweep axis (repeatable): chips=1,2,4 "
                         "pack=1,2,4 n_trials=8")
    sp.add_argument("--best-k", action="store_true",
                    help="also rank pack widths per packing key")
    sp.add_argument("--split", action="store_true",
                    help="also run the many-small-chips vs big-trial-"
                         "groups split search")
    sp.add_argument("--trials", type=int, default=None,
                    help="trial budget for --split (default: the "
                         "calibrated sweep's)")
    sp.add_argument("--member", default=None, metavar="KEY_HASH_PREFIX",
                    help="roofline forecast for a proposed zoo member "
                         "by perf/cost key-hash prefix")
    sp.add_argument("--member-k", type=int, default=1)
    sp.add_argument("--mfu", type=float, default=0.3)

    sp = trsub.add_parser(
        "validate", help="replay a captured mesh sweep; gate predicted"
                         "-vs-measured trials/hour and wall clock")
    common(sp)
    sp.add_argument("--tolerance", type=float, default=None,
                    help="relative-error gate (default 0.25)")
    sp.add_argument("--out", default=None,
                    help="write the validation artifact JSON here")


def _load_calibration(args, log_dir):
    from rafiki_tpu_torch.obs.twin.cli import _parse_scales
    from rafiki_tpu_torch.obs.twin.train.calibration import (
        TrainCalibration, TrainCalibrationError)
    if args.calibration:
        cal = TrainCalibration.load(args.calibration)
    else:
        try:
            cal = TrainCalibration.from_journal_dir(log_dir)
        except TrainCalibrationError as e:
            print(f"note: {e}; using the nominal synthetic bundle",
                  file=sys.stderr)
            cal = TrainCalibration.nominal()
    scales = _parse_scales(args.scale)
    return cal.scaled(scales) if scales else cal


def dispatch(args, log_dir: str, as_json: bool) -> int:
    if args.train_cmd == "run":
        return cmd_run(args, log_dir, as_json)
    if args.train_cmd == "sweep":
        return cmd_sweep(args, log_dir, as_json)
    return cmd_validate(args, log_dir, as_json)


def cmd_run(args, log_dir: str, as_json: bool) -> int:
    from rafiki_tpu_torch.obs.twin.train.engine import TrainTwinConfig, simulate
    cal = _load_calibration(args, log_dir)
    overrides: Dict[str, Any] = {"chips_per_host": args.chips_per_host}
    if args.chips is not None:
        overrides["chips"] = args.chips
    if args.pack is not None:
        overrides["k"] = args.pack
    if args.trials is not None:
        overrides["n_trials"] = args.trials
    cfg = TrainTwinConfig.from_calibration(cal, **overrides)
    res = simulate(cal, cfg, seed=args.seed, chaos_spec=args.chaos,
                   record_events=args.events)
    if as_json:
        print(json.dumps(res, default=str))
    else:
        print(f"{res['trials']} trial(s) on {res['chips']} chip(s) x "
              f"k={res['k']}: status={res['status']} "
              f"completed={res['completed']}")
        print(f"  makespan={res['makespan_s']}s "
              f"trials/hour={res['trials_per_hour']} "
              f"utilization={res['utilization']} "
              f"compile={res['compile_s']}s step={res['step_s']}s")
        print(f"  chaos: fired={res['chaos_fired']} "
              f"chips_lost={res['chips_lost']} repacks={res['repacks']}; "
              f"hbm_frac={res['hbm_frac']}")
        print(f"  event log: {res['event_log_len']} events, "
              f"sha1 {res['event_log_sha1'][:12]}")
    return 0


def cmd_sweep(args, log_dir: str, as_json: bool) -> int:
    from rafiki_tpu_torch.obs.twin.train import whatif
    from rafiki_tpu_torch.obs.twin.train.engine import TrainTwinConfig
    cal = _load_calibration(args, log_dir)
    base = TrainTwinConfig.from_calibration(cal)
    grid = (whatif.parse_grid(args.grid)
            or {"chips": [1, 2, 4], "pack": [1, 2, 4]})
    rows = whatif.sweep(cal, base, grid, seed=args.seed,
                        chaos_spec=args.chaos)
    doc: Dict[str, Any] = {"grid": {k: list(v) for k, v in grid.items()},
                           "seed": args.seed, "rows": rows}
    if args.best_k:
        doc["best_k"] = whatif.best_k(cal, chips=base.chips,
                                      seed=args.seed)
    if args.split:
        n = int(args.trials or base.n_trials or base.slots())
        doc["split"] = whatif.split_search(cal, n_trials=n,
                                           seed=args.seed)
    if args.member:
        doc["member"] = whatif.member_forecast(
            cal, args.member, k=args.member_k, mfu=args.mfu)
    if as_json:
        print(json.dumps(doc, default=str))
        return 0
    knobs = sorted(grid)
    for row in rows:
        knobstr = " ".join(f"{k}={row[k]}" for k in knobs)
        print(f"{knobstr:<28} trials/hour={row['trials_per_hour']:>10} "
              f"makespan={row['makespan_s']}s "
              f"util={row['utilization']} status={row['status']}")
    if "best_k" in doc:
        for pk, v in sorted(doc["best_k"].items()):
            print(f"best k for {pk[:52]}: {v['best_k']} "
                  f"({v['trials_per_hour']} trials/hour)")
    if "split" in doc:
        b = doc["split"]["best"]
        print(f"best split for {doc['split']['n_trials']} trial(s): "
              f"{b['chips']} chip(s) x k={b['k']} "
              f"({b['trials_per_hour']} trials/hour, "
              f"{b['makespan_s']}s)")
    if "member" in doc:
        m = doc["member"]
        print(f"member {m['key_hash_prefix']}: step={m['step_s']}s "
              f"trials/hour={m['trials_per_hour']} "
              f"hbm={m['hbm_frac']} fits={m['fits']}")
    return 0


def cmd_validate(args, log_dir: str, as_json: bool) -> int:
    from rafiki_tpu_torch.obs.twin.cli import _parse_scales
    from rafiki_tpu_torch.obs.twin.train import validate as validate_mod
    kwargs: Dict[str, Any] = {"seed": args.seed}
    if args.tolerance is not None:
        kwargs["tolerance"] = args.tolerance
    scales = _parse_scales(args.scale)
    if scales:
        kwargs["scales"] = scales
    try:
        doc = validate_mod.validate(log_dir, **kwargs)
    except (ValueError, OSError) as e:
        print(f"twin train validate: {e}", file=sys.stderr)
        return 2
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
    if as_json:
        print(json.dumps(doc, default=str))
    else:
        m, pr = doc["measured"], doc["predicted"]
        print(f"measured : {m['trials']} trial(s) in {m['wall_s']}s "
              f"-> {m['trials_per_hour']} trials/hour")
        print(f"predicted: {pr['trials']} trial(s) in {pr['wall_s']}s "
              f"-> {pr['trials_per_hour']} trials/hour "
              f"(status {pr['status']})")
        print(f"error    : tph={doc['tph_err']} wall={doc['wall_err']} "
              f"tolerance={doc['tolerance']} -> "
              f"{'OK' if doc['ok'] else 'FAIL'}")
    return 0 if doc["ok"] else 1
