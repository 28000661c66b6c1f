"""Sweep-supervisor process entrypoint:
``python -m rafiki_tpu_torch.scheduler.sweep_proc run|resume ...``.

The port's own copy of ``rafiki_tpu/scheduler/sweep_proc.py``. The mesh
sweep normally runs in the caller's process. Crash-safety testing needs
it in a process OF ITS OWN, so a chaos fault (the ``supervisor.tick``
kill site, a whole-host loss) can SIGKILL the supervisor without taking
the caller down with it, and so ``resume_sweep`` can then prove that a
genuinely fresh process (no shared memory, only the MetaStore, the
sweep WAL and the journals) adopts the job. The chaos scenarios drive
sweeps through this module; it is equally usable as a manual
supervisor launcher.

Modes::

    run     --db X --params Y --job J [--chips N] [--trials-per-chip K]
            [--advisor KIND] [--advisor-kwargs JSON] [--device cuda|cpu]
    resume  --db X --params Y --job J [--chips N] [--trials-per-chip K]
            [--stale-after-s S] [--device cuda|cpu]

``--device`` (the port's own flag) is where the chips are: ``cuda``
(the default) cycles the chips over the process's cards, so two chips
share one card where there is one card; ``cpu`` puts every chip on the
CPU. Without a card and without ``--device cpu`` the process fails.
``resume`` without ``--chips`` takes the dead sweep's chip count from
its WAL.

Chaos and observability propagate by environment, as for every other
subprocess: ``RAFIKI_CHAOS`` self-installs at import, ``RAFIKI_LOG_DIR``
points the journal, ``RAFIKI_EVENTS_DIR`` the event sink. Exit codes:
0 = job COMPLETED, 2 = any other terminal status, 1 = crash (including
a WAL reconcile refusal on resume). The last line on stdout is a JSON
summary (status, trial count, and for resume the adopt/salvage
accounting), which callers parse instead of scraping the store again.
"""

from __future__ import annotations

import json
import sys


def chip_devices(device: str, chips):
    """One device per chip: ``chips`` entries cycled over the platform's
    devices (every card for ``cuda``; the CPU for ``cpu``). ``chips``
    None: one chip per device."""
    import torch

    from rafiki_tpu_torch.parallel.mesh import local_devices

    base = [torch.device("cpu")] if device == "cpu" else local_devices()
    n = int(chips or len(base))
    return [base[i % len(base)] for i in range(n)]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    import argparse

    ap = argparse.ArgumentParser(prog="rafiki_tpu_torch.scheduler.sweep_proc")
    ap.add_argument("mode", choices=("run", "resume"))
    ap.add_argument("--db", required=True)
    ap.add_argument("--params", required=True)
    ap.add_argument("--job", required=True)
    ap.add_argument("--chips", type=int, default=None)
    ap.add_argument("--trials-per-chip", type=int, default=None)
    ap.add_argument("--advisor", default="gp")
    ap.add_argument("--advisor-kwargs", default=None,
                    help="JSON dict of engine kwargs, e.g. '{\"n_initial\": 4}'")
    ap.add_argument("--stale-after-s", type=float, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the chips are (default: the CUDA cards)")
    args = ap.parse_args(argv)

    from rafiki_tpu_torch.obs import journal as journal_mod
    from rafiki_tpu_torch.store import MetaStore, ParamsStore
    from rafiki_tpu_torch.utils.events import configure_from_env as _events_env

    journal_mod.configure_from_env(role=f"sweep-{args.mode}")
    _events_env()
    store = MetaStore(args.db)
    params = ParamsStore(args.params)
    chips = args.chips
    if chips is None and args.mode == "resume":
        # The dead sweep's chip count, from its WAL'd config.
        from rafiki_tpu_torch.scheduler.wal import read_wal, wal_path

        cfg = [r for r in read_wal(wal_path(store.path, args.job)) if r.get("op") == "sweep_config"]
        chips = int(cfg[-1].get("chips") or 0) or None if cfg else None
    devices = chip_devices(args.device, chips)

    if args.mode == "run":
        from rafiki_tpu_torch.scheduler.mesh import MeshSweepScheduler

        kwargs = json.loads(args.advisor_kwargs) if args.advisor_kwargs else None
        result = MeshSweepScheduler(store, params).run_sweep(
            args.job, chips=args.chips, trials_per_chip=int(args.trials_per_chip or 2),
            advisor_kind=args.advisor, advisor_kwargs=kwargs, devices=devices)
        out = {"mode": "run", "job_id": args.job, "status": result.status,
               "n_trials": len(result.trials), "errors": result.errors}
        print(json.dumps(out))
        return 0 if result.status == "COMPLETED" else 2

    from rafiki_tpu_torch.scheduler.recovery import resume_sweep

    summary = resume_sweep(store, params, args.job, chips=args.chips,
                           trials_per_chip=args.trials_per_chip,
                           stale_after_s=args.stale_after_s, devices=devices)
    job = store.get_train_job(args.job)
    summary["status"] = None if job is None else job["status"]
    print(json.dumps({"mode": "resume", **summary}, default=str))
    return 0 if summary["status"] == "COMPLETED" else 2


if __name__ == "__main__":
    sys.exit(main())
