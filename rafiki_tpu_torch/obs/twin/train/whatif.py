"""Sweep-planning what-ifs over the train twin (docs/twin.md): the
questions a sweep owner should answer BEFORE chips are claimed.

The port's own copy of ``rafiki_tpu/obs/twin/train/whatif.py``. HBM
fractions are of this process's card (``obs/twin/calibration.py
card_memory_bytes``), and the ``HBM_CEILING`` solve is kept.

* :func:`best_k` — the best ``RAFIKI_TRIAL_PACK`` width per packing
  key: larger packs amortize one compile over more trials but pay a
  wider (slower) step; the calibrated step/compile distributions
  arbitrate, per key.
* :func:`split_search` — many-small-chips vs big-trial-groups: the
  same trial budget simulated across (chips, k) splits, ranked by
  predicted trials/hour (HBM headroom reported alongside — a winning
  split that does not fit is not a winner).
* :func:`member_forecast` — predicted trials/hour and HBM headroom for
  a PROPOSED zoo member that was never trained: roofline step time
  from its ``perf/cost`` row at an assumed MFU.
* :func:`group_width_forecast` — the sharded-lane question
  (docs/sharding.md): one trial of a family run as a width-w chip
  group, per candidate width — measured group epoch walls where the
  calibration has ``@groupw`` buckets, per-chip HBM share, and the
  smallest width that fits (the same solve shard/plan.py performs
  live, answered from the twin before chips are claimed).
* :func:`sweep` — a generic config grid (chips/k/n_trials), one
  simulation per combination — the ``obs twin train sweep`` verb.

Everything here is deterministic per seed (the engine's contract) and
pure planning: nothing mutates the live sweep.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

from rafiki_tpu_torch.obs.twin.train.calibration import TrainCalibration
from rafiki_tpu_torch.obs.twin.train.engine import TrainTwinConfig, simulate
from rafiki_tpu_torch.obs.twin.whatif import parse_grid  # noqa: F401  (CLI reuse)

#: Default pack widths best_k scans.
DEFAULT_KS = (1, 2, 4, 8)

#: Default (chips, k) splits split_search ranks.
DEFAULT_SPLITS = ((1, 8), (2, 4), (4, 2), (8, 1), (2, 2), (4, 4))

#: Above this predicted HBM fraction a row is flagged as not fitting.
HBM_CEILING = 0.9


def _headline(res: Dict[str, Any]) -> Dict[str, Any]:
    return {f: res.get(f) for f in
            ("trials_per_hour", "makespan_s", "completed", "utilization",
             "compile_s", "step_s", "hbm_frac", "status")}


def best_k(cal: TrainCalibration, chips: int,
           ks: Sequence[int] = DEFAULT_KS, n_trials: Optional[int] = None,
           seed: int = 0) -> Dict[str, Any]:
    """Per packing key: simulate the same trial count at each pack
    width and rank by trials/hour. Ties break toward the SMALLER k —
    when the model cannot tell the widths apart, the narrower pack is
    the safer claim (less HBM, finer eviction granularity)."""
    out: Dict[str, Any] = {}
    for pk in cal.packing_keys():
        epochs = cal.epochs_for(pk)
        rows = []
        for k in ks:
            n = int(n_trials or chips * k)
            trials = [{"id": f"t{i:03d}", "packing_key": pk,
                       "epochs": epochs} for i in range(n)]
            cfg = TrainTwinConfig(chips=chips, k=int(k), n_trials=n)
            res = simulate(cal, cfg, trials=trials, seed=seed)
            hbm = cal.hbm_frac(k=int(k))
            rows.append(dict(_headline(res), k=int(k), n_trials=n,
                             hbm_frac=hbm,
                             fits=(hbm is None or hbm <= HBM_CEILING)))
        fitting = [r for r in rows if r["fits"]] or rows
        best = max(fitting,
                   key=lambda r: (r["trials_per_hour"] or 0.0, -r["k"]))
        out[pk] = {"best_k": best["k"],
                   "trials_per_hour": best["trials_per_hour"],
                   "rows": rows}
    return out


def split_search(cal: TrainCalibration, n_trials: int,
                 splits: Sequence[Tuple[int, int]] = DEFAULT_SPLITS,
                 seed: int = 0) -> Dict[str, Any]:
    """Rank (chips, k) splits for one trial budget: the many-small-
    chips vs big-trial-groups question. Each split drafts the same
    synthesized trial mix (seeded), so rows differ only in placement."""
    rows = []
    for chips, k in splits:
        cfg = TrainTwinConfig(chips=int(chips), k=int(k),
                              n_trials=int(n_trials))
        res = simulate(cal, cfg, seed=seed)
        hbm = cal.hbm_frac(k=int(k))
        rows.append(dict(_headline(res), chips=int(chips), k=int(k),
                         slots=cfg.slots(), hbm_frac=hbm,
                         fits=(hbm is None or hbm <= HBM_CEILING)))
    fitting = [r for r in rows if r["fits"]] or rows
    best = max(fitting, key=lambda r: (r["trials_per_hour"] or 0.0,
                                       -r["chips"] * r["k"]))
    return {"n_trials": int(n_trials), "rows": rows,
            "best": {"chips": best["chips"], "k": best["k"],
                     "trials_per_hour": best["trials_per_hour"],
                     "makespan_s": best["makespan_s"]}}


def member_forecast(cal: TrainCalibration, key_hash_prefix: str,
                    k: int = 1, epochs: int = 3,
                    steps_per_epoch: int = 100,
                    mfu: float = 0.3) -> Dict[str, Any]:
    """Roofline forecast for a proposed zoo member never trained here:
    predicted step/epoch walls from its ``perf/cost`` row, single-chip
    trials/hour at pack width ``k``, and the HBM-headroom verdict."""
    step_s = cal.roofline_step_s(key_hash_prefix, k=k, mfu=mfu)
    epoch_s = step_s * max(1, int(steps_per_epoch))
    trial_s = epoch_s * max(1, int(epochs))
    hbm = cal.hbm_frac(k=k, key_hash_prefix=key_hash_prefix)
    return {
        "key_hash_prefix": key_hash_prefix,
        "k": int(k), "epochs": int(epochs),
        "steps_per_epoch": int(steps_per_epoch), "mfu": mfu,
        "step_s": round(step_s, 9),
        "epoch_s": round(epoch_s, 9),
        "trials_per_hour": (round(int(k) * 3600.0 / trial_s, 4)
                            if trial_s > 0 else None),
        "hbm_frac": hbm,
        "hbm_headroom_frac": (None if hbm is None
                              else round(max(0.0, 1.0 - hbm), 4)),
        "fits": hbm is None or hbm <= HBM_CEILING,
    }


#: Default group widths group_width_forecast scans.
DEFAULT_WIDTHS = (1, 2, 4, 8)


def group_width_forecast(cal: TrainCalibration, packing_key: str,
                         widths: Sequence[int] = DEFAULT_WIDTHS,
                         hbm_bytes: Optional[int] = None,
                         epochs: Optional[int] = None) -> Dict[str, Any]:
    """What happens if ONE trial of ``packing_key`` runs as a width-w
    sharded group, per candidate width: the measured group epoch wall
    where the calibration holds a ``@groupw`` bucket for that width
    (group walls are kept out of the single-chip pools, so this is the
    only place they surface), the per-chip HBM share, and the smallest
    width that fits under the ceiling — the same solve shard/plan.py
    performs when the trial is placed for real.

    ``hbm_bytes`` is the trial's whole-state residency estimate
    (``ShardPlan.hbm_bytes``); absent that the calibration's captured
    single-chip fraction seeds the share math, and absent THAT (or
    absent a card to divide by) the fit column reads unknown-but-
    permissive (None → fits)."""
    from rafiki_tpu_torch.obs.twin.calibration import card_memory_bytes
    from rafiki_tpu_torch.obs.twin.train.calibration import GROUP_KEY_MARK

    n_epochs = int(epochs or cal.epochs_for(packing_key))
    per_chip = card_memory_bytes() if hbm_bytes else None
    if per_chip:
        base_frac: Optional[float] = float(hbm_bytes) / per_chip
    else:
        base_frac = cal.hbm_frac(k=1)
    rows = []
    for w in widths:
        w = int(w)
        key = packing_key if w <= 1 else (
            f"{packing_key}{GROUP_KEY_MARK}{w}")
        by_k = cal.steps.get(key) or {}
        xs = sorted(x for samples in by_k.values() for x in samples)
        epoch_s = xs[len(xs) // 2] if xs else None  # median warm wall
        frac = None if base_frac is None else base_frac / w
        trial_s = epoch_s * n_epochs if epoch_s else None
        rows.append({
            "width": w,
            "measured": bool(xs),
            "epoch_s": round(epoch_s, 9) if epoch_s else None,
            "trials_per_hour": (round(3600.0 / trial_s, 4)
                                if trial_s else None),
            "hbm_frac": None if frac is None else round(frac, 6),
            "fits": frac is None or frac <= HBM_CEILING,
        })
    solved = min((r["width"] for r in rows if r["fits"]), default=None)
    return {"packing_key": packing_key, "epochs": n_epochs,
            "rows": rows, "solved_width": solved}


def sweep(cal: TrainCalibration, base: TrainTwinConfig,
          grid: Dict[str, List[Any]], seed: int = 0,
          chaos_spec: Optional[str] = None) -> List[Dict[str, Any]]:
    """One simulation per grid combination. Grid knobs are
    TrainTwinConfig field names (``chips``, ``k``/``pack``,
    ``n_trials``); rows carry the knobs plus the headline."""
    knobs = sorted(grid)
    rows = []
    for combo in itertools.product(*(grid[kn] for kn in knobs)):
        overrides = {("k" if kn == "pack" else kn): v
                     for kn, v in zip(knobs, combo)}
        cfg = TrainTwinConfig(**{**base.__dict__, **overrides})
        cfg.chips, cfg.k = max(1, int(cfg.chips)), max(1, int(cfg.k))
        res = simulate(cal, cfg, seed=seed, chaos_spec=chaos_spec)
        row = dict(zip(knobs, combo))
        row.update(_headline(res))
        row["event_log_sha1"] = res["event_log_sha1"]
        rows.append(row)
    return rows
