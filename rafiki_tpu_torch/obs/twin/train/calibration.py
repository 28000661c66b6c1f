"""Train-twin calibration bundles: everything the sweep simulator runs
on, in one versioned JSON artifact (docs/twin.md).

The port's own copy of ``rafiki_tpu/obs/twin/train/calibration.py``.
Like the port's serving bundle (``obs/twin/calibration.py``), the
roofline and HBM views read the card a cost row was counted on, never a
TPU's constants: the peak is the row's own ``peak_flops`` (or the
caller's), the bandwidth is ``profiler.hbm_bandwidth`` of the row's
``device``, and a chip's memory is the card's own (``shard/plan.py
device_memory_bytes``). The port's rows carry ``bytes_accessed`` and
``peak_hbm_bytes`` as null, so a port row has no memory term and a port
bundle no ``hbm_frac``.

A bundle is extracted from a journal directory — the durable side
channel every mesh sweep leaves under ``RAFIKI_LOG_DIR`` — and carries
four ingredient classes:

* **epoch samples** — per-(packing_key, k) warm/cold epoch walls from
  ``perf/step`` records (``packing_key`` and ``k`` are stamped there by
  ``profiler.note_epoch``). Cold epochs pay the first call (the eager
  warm-up steps and the CUDA-graph capture); warm epochs are the
  steady-state step cost. The twin draws warm epochs from the sampled
  distribution and assigns cold epochs by descending order statistic
  (the first pack of a (packing_key, k) pays the true first call; later
  packs hit the process-wide program cache).
* **pack composition** — ``mesh/pack_formed`` records (chip id,
  packing_key, k, fill ratio, epochs, member trial ids), the literal
  placement the scheduler produced, so ``validate`` replays the real
  sweep rather than re-guessing it. A departure from the JAX package:
  the port's pack runner also journals each pack's rounds when it ends
  (``trial_pack/rounds``: every member's trial id, backfills included,
  and the members that trained in each round), and a pack whose rounds
  were journaled carries them here (``rounds``, ``backfilled``), so the
  replay runs the rounds the pack ran: the trials that joined the slots
  of early-stopped members, and the narrower rounds after them.
* **sweep shape** — the ``mesh/sweep_started`` record (chips,
  trials_per_chip, n_trials), the simulator's default topology.
* **cost rows** — ``perf/cost`` FLOP counts keyed by key hash, each with
  the card it was counted on: the roofline source for zoo members that
  were never measured, and the HBM-headroom answer for pack-width
  what-ifs where a row carries ``peak_hbm_bytes``.

``epoch_overhead_s`` is a fitted residual: the captured wall clock
minus the per-chip sum of epoch compute, spread over epoch boundaries.
It folds per-epoch eval/feedback/wiring time — which ``perf/step``
deliberately excludes — into the twin's epoch model without a second
record kind.

Extraction fails LOUDLY, listing every missing record kind, instead of
silently defaulting: a twin calibrated on air would predict air.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Tuple

from rafiki_tpu_torch.obs import journal as journal_mod
from rafiki_tpu_torch.obs.perf.profiler import hbm_bandwidth
from rafiki_tpu_torch.obs.twin.calibration import (CalibrationError, _cap,
                                                   card_memory_bytes)

TRAIN_CALIBRATION_VERSION = 1

#: Record kinds a train bundle cannot be built without (kind/name keys
#: as they appear in the journals).
REQUIRED_KINDS = ("perf/step", "mesh/pack_formed")

#: Segments :meth:`TrainCalibration.scaled` may doctor — the
#: deliberate mis-calibration knob the validation smoke uses.
SCALABLE_SEGMENTS = ("step", "compile")

#: Multiplier spread for :meth:`TrainCalibration.nominal` warm epochs —
#: mild right skew, same philosophy as the serving bundle's grid.
_NOMINAL_SPREAD = (0.90, 0.94, 0.97, 1.00, 1.00, 1.03, 1.06, 1.10)

#: Bucket-key marker for group-sharded epoch samples (``perf/step``
#: records stamped with ``group_width`` > 1 by the sharded loop). A
#: width-w epoch's wall includes per-step all-gathers, so its samples
#: live under ``<packing_key>@groupw<w>`` and never mix into the
#: single-chip pools — not even via the unknown-key pooled fallback.
GROUP_KEY_MARK = "@groupw"

#: The fields a ``perf/cost`` row keeps: the JAX package's, plus the card
#: the count was taken on and that card's peak.
_COST_FIELDS = ("key", "program_kind", "k", "flops", "bytes_accessed",
                "peak_hbm_bytes", "device", "peak_flops")


class TrainCalibrationError(CalibrationError):
    """A journal dir missing required TRAIN record kinds. ``missing``
    lists every absent kind so the operator fixes the capture once.
    Subclasses the serving :class:`CalibrationError` so existing
    ``except CalibrationError`` handlers (CLI, smokes) catch both."""

    def __init__(self, missing: List[str], source: str = ""):
        self.missing = list(missing)
        self.source = source
        ValueError.__init__(
            self,
            "cannot calibrate the train twin from %r: missing journal "
            "record kind(s): %s — run a mesh sweep with RAFIKI_LOG_DIR "
            "set (MeshSweepScheduler.run_sweep with the journal open) so "
            "the sweep plane journals them"
            % (source or "<records>", ", ".join(self.missing)))


def _nearest_k(by_k: Dict[str, List[float]], k: int
               ) -> Optional[Tuple[int, List[float]]]:
    """The measured pack width closest to ``k`` in log space (ties to
    the smaller width — underestimating a pack is the safer error)."""
    widths = sorted(int(w) for w in by_k if by_k[w])
    if not widths:
        return None
    if k in widths:
        return k, by_k[str(k)]
    best = min(widths, key=lambda w: (abs(math.log(max(k, 1) / w)), w))
    return best, by_k[str(best)]


@dataclasses.dataclass
class TrainCalibration:
    """One loaded train bundle. ``steps``/``compiles`` map
    packing_key -> str(pack width k) -> sorted epoch-wall samples
    (seconds, warm vs cold); ``packs`` is the captured pack-formation
    log; ``sweep`` the captured topology; ``cost`` key_hash -> cost
    row."""

    steps: Dict[str, Dict[str, List[float]]]
    compiles: Dict[str, Dict[str, List[float]]]
    packs: List[Dict[str, Any]]
    sweep: Dict[str, Any]
    cost: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    epoch_overhead_s: float = 0.0
    source: str = ""
    version: int = TRAIN_CALIBRATION_VERSION
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_records(cls, records: List[Dict[str, Any]],
                     source: str = "") -> "TrainCalibration":
        """Build from already-merged journal records (read_dir output).
        Raises :class:`TrainCalibrationError` listing every missing
        kind."""
        steps: Dict[str, Dict[str, List[float]]] = {}
        compiles: Dict[str, Dict[str, List[float]]] = {}
        packs: List[Dict[str, Any]] = []
        sweep: Dict[str, Any] = {}
        cost: Dict[str, Dict[str, Any]] = {}
        step_rows: List[Dict[str, Any]] = []
        formed: List[Dict[str, Any]] = []
        rounds: List[Dict[str, Any]] = []
        for r in records:
            kind, name = r.get("kind"), r.get("name")
            if kind == "perf" and name == "step":
                pk = r.get("packing_key")
                dt = r.get("dt")
                if not pk or not isinstance(dt, (int, float)) or dt < 0:
                    continue
                step_rows.append(r)
                gw = int(r.get("group_width") or 0)
                if gw > 1:
                    pk = f"{pk}{GROUP_KEY_MARK}{gw}"
                w = str(int(r.get("k") or 1))
                dest = compiles if r.get("cold") else steps
                dest.setdefault(pk, {}).setdefault(w, []).append(float(dt))
            elif kind == "mesh" and name == "pack_formed":
                formed.append(r)
                packs.append({f: r.get(f) for f in
                              ("chip", "packing_key", "k", "fill_ratio",
                               "epochs", "trial_ids", "knobs_hashes",
                               "job_id")})
            elif kind == "trial_pack" and name == "rounds":
                rounds.append(r)
            elif kind == "mesh" and name == "sweep_started":
                sweep = {f: r.get(f) for f in
                         ("chips", "trials_per_chip", "n_trials", "job_id")}
            elif kind == "perf" and name == "cost":
                kh = r.get("key_hash")
                if kh:
                    cost[kh] = {f: r.get(f) for f in _COST_FIELDS}
        missing = []
        if not step_rows:
            missing.append("perf/step")
        if not packs:
            missing.append("mesh/pack_formed")
        if missing:
            raise TrainCalibrationError(missing, source)
        for pack, rec in zip(packs, formed):
            got = _pack_rounds(rec, rounds)
            if got is not None:
                pack["rounds"], pack["backfilled"] = got
        overhead = _fit_epoch_overhead(step_rows,
                                       int(sweep.get("chips") or 1))
        return cls(
            steps={pk: {w: _cap(xs) for w, xs in by_k.items()}
                   for pk, by_k in steps.items()},
            compiles={pk: {w: _cap(xs) for w, xs in by_k.items()}
                      for pk, by_k in compiles.items()},
            packs=packs, sweep=sweep, cost=cost,
            epoch_overhead_s=overhead, source=source,
            meta={"step_records": len(step_rows),
                  "group_step_records": sum(
                      1 for r in step_rows
                      if int(r.get("group_width") or 0) > 1),
                  "pack_records": len(packs),
                  "cost_rows": len(cost)})

    @classmethod
    def from_journal_dir(cls, log_dir) -> "TrainCalibration":
        records = journal_mod.read_dir(log_dir)
        if not records:
            raise TrainCalibrationError(list(REQUIRED_KINDS), str(log_dir))
        return cls.from_records(records, source=str(log_dir))

    @classmethod
    def nominal(cls, step_s: float = 0.5, compile_s: float = 2.0,
                epochs: int = 3, chips: int = 2, k: int = 2
                ) -> "TrainCalibration":
        """A synthetic bundle for pre-gaming without captured journals
        (the autoscale pre-gate default): one packing key, warm epochs
        spread around ``step_s``, a single ``compile_s`` cold sample."""
        pk = "nominal"
        return cls(
            steps={pk: {str(k): sorted(step_s * m
                                       for m in _NOMINAL_SPREAD)}},
            compiles={pk: {str(k): [compile_s]}},
            packs=[], sweep={"chips": chips, "trials_per_chip": k,
                             "n_trials": chips * k, "epochs": epochs},
            source="nominal",
            meta={"step_s": step_s, "compile_s": compile_s,
                  "epochs": epochs})

    # -- (de)serialization ---------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        rounded = lambda d: {pk: {w: [round(x, 9) for x in xs]
                                  for w, xs in by_k.items()}
                             for pk, by_k in d.items()}
        return {"train_calibration_version": self.version,
                "source": self.source, "sweep": self.sweep,
                "steps": rounded(self.steps),
                "compiles": rounded(self.compiles),
                "packs": self.packs, "cost": self.cost,
                "epoch_overhead_s": round(self.epoch_overhead_s, 9),
                "meta": self.meta}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainCalibration":
        v = d.get("train_calibration_version")
        if v != TRAIN_CALIBRATION_VERSION:
            raise ValueError(
                f"unsupported train_calibration_version {v!r} "
                f"(this build reads {TRAIN_CALIBRATION_VERSION})")
        load = lambda key: {pk: {w: sorted(float(x) for x in xs)
                                 for w, xs in (by_k or {}).items()}
                            for pk, by_k in (d.get(key) or {}).items()}
        return cls(steps=load("steps"), compiles=load("compiles"),
                   packs=list(d.get("packs") or []),
                   sweep=dict(d.get("sweep") or {}),
                   cost=dict(d.get("cost") or {}),
                   epoch_overhead_s=float(d.get("epoch_overhead_s") or 0.0),
                   source=d.get("source") or "", version=v,
                   meta=dict(d.get("meta") or {}))

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path) -> "TrainCalibration":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- derived views -------------------------------------------------------

    def packing_keys(self) -> List[str]:
        return sorted(set(self.steps) | set(self.compiles)
                      | {p.get("packing_key") for p in self.packs
                         if p.get("packing_key")})

    def epochs_for(self, packing_key: str) -> int:
        """Member epoch count for one packing key — from the captured
        pack_formed rows, falling back to the sweep/nominal default."""
        for p in self.packs:
            if p.get("packing_key") == packing_key and p.get("epochs"):
                return int(p["epochs"])
        return int(self.sweep.get("epochs") or 1)

    def step_samples(self, packing_key: str, k: int
                     ) -> Tuple[List[float], float]:
        """(samples, scale) for one warm epoch of a width-``k`` pack of
        ``packing_key``. Exact (packing_key, k) samples scale by 1.0;
        a nearest-width fallback scales linearly in width (a packed
        step does k× the member FLOPs); an unknown packing key pools
        every measured key's samples."""
        by_k = self.steps.get(packing_key) or self._pooled(self.steps)
        got = _nearest_k(by_k, k)
        if got is None:
            raise TrainCalibrationError(["perf/step"], self.source)
        k0, xs = got
        return xs, (float(k) / float(k0) if k0 else 1.0)

    def compile_samples(self, packing_key: str, k: int) -> List[float]:
        """Cold-epoch (first-call-paying) samples for a width-``k`` pack,
        DESCENDING — the engine assigns them in pack order so the first
        pack of a (packing_key, k) pays the slowest observed cold epoch
        (the true first call) and later packs the faster ones (program
        cache hits). Width fallback is unscaled: the first call's cost
        is the program's build and capture, not the pack width."""
        by_k = self.compiles.get(packing_key) or self._pooled(self.compiles)
        got = _nearest_k(by_k, k)
        if got is None:
            # No cold epoch captured anywhere: the first call reads as a
            # warm epoch (a process whose program cache is warm).
            xs, scale = self.step_samples(packing_key, k)
            return sorted((x * scale for x in xs), reverse=True)[:1]
        _k0, xs = got
        return sorted(xs, reverse=True)

    @staticmethod
    def _pooled(d: Dict[str, Dict[str, List[float]]]
                ) -> Dict[str, List[float]]:
        pooled: Dict[str, List[float]] = {}
        for pk, by_k in d.items():
            if GROUP_KEY_MARK in pk:
                continue  # group-sharded walls never model a chip
            for w, xs in by_k.items():
                pooled.setdefault(w, []).extend(xs)
        return {w: sorted(xs) for w, xs in pooled.items()}

    def scaled(self, scales: Dict[str, float]) -> "TrainCalibration":
        """A copy with named segments multiplied — the deliberate
        mis-calibration knob the validation smoke uses to prove the
        gate fails when the model is wrong."""
        unknown = set(scales) - set(SCALABLE_SEGMENTS)
        if unknown:
            raise ValueError(
                f"unknown segment(s) to scale: {sorted(unknown)}; "
                f"one of {SCALABLE_SEGMENTS}")
        mul = lambda d, f: {pk: {w: [x * f for x in xs]
                                 for w, xs in by_k.items()}
                            for pk, by_k in d.items()}
        return dataclasses.replace(
            self,
            steps=mul(self.steps, scales.get("step", 1.0)),
            compiles=mul(self.compiles, scales.get("compile", 1.0)),
            meta=dict(self.meta, scaled={s: f for s, f in scales.items()}))

    def roofline_step_s(self, key_hash_prefix: str, k: int = 1,
                        mfu: float = 0.3,
                        peak_flops: Optional[float] = None) -> float:
        """Roofline per-step prediction for an UNMEASURED program at
        pack width ``k``: max(compute, memory) seconds at an assumed
        MFU, FLOPs scaled from the captured row's width. The peak is
        ``peak_flops`` or else the row's own; the memory term needs the
        row's ``bytes_accessed`` and its card's bandwidth, and is 0
        without either (module doc)."""
        rows = [r for kh, r in sorted(self.cost.items())
                if kh.startswith(key_hash_prefix)]
        if not rows:
            raise KeyError(
                f"no perf/cost row with key_hash prefix "
                f"{key_hash_prefix!r} in this calibration "
                f"({len(self.cost)} row(s) present)")
        row = rows[0]
        if peak_flops is None:
            peak_flops = row.get("peak_flops")
        if not peak_flops:
            raise ValueError(
                f"perf/cost row {key_hash_prefix!r} has no peak_flops "
                f"(counted on {row.get('device')!r}); pass peak_flops")
        width = max(1, int(row.get("k") or 1))
        ratio = float(k) / float(width)
        compute_s = (float(row.get("flops") or 0.0) * ratio
                     / (peak_flops * mfu))
        bandwidth = hbm_bandwidth(row.get("device"))
        memory_s = (float(row["bytes_accessed"]) * ratio / bandwidth
                    if row.get("bytes_accessed") is not None and bandwidth
                    else 0.0)
        return max(compute_s, memory_s)

    def hbm_frac(self, k: int = 1,
                 key_hash_prefix: str = "") -> Optional[float]:
        """Predicted peak-memory fraction of this process's card for a
        width-``k`` pack: the captured per-member peak times ``k``
        (stacked members each hold params/opt state/activations).
        None without a row carrying ``peak_hbm_bytes`` (the port's
        never do) or without a card."""
        per_member = []
        for kh, r in sorted(self.cost.items()):
            if key_hash_prefix and not kh.startswith(key_hash_prefix):
                continue
            peak = float(r.get("peak_hbm_bytes") or 0.0)
            width = max(1, int(r.get("k") or 1))
            if peak > 0:
                per_member.append(peak / width)
        if not per_member:
            return None
        per_chip = card_memory_bytes()
        if per_chip is None:
            return None
        return max(per_member) * max(1, int(k)) / per_chip


def _pack_rounds(formed: Dict[str, Any], rounds: List[Dict[str, Any]]
                ) -> Optional[Tuple[List[int], List[str]]]:
    """(widths by round, backfilled trial ids) of the pack one
    ``mesh/pack_formed`` record drafted, from the ``trial_pack/rounds``
    record its chip's worker journaled when the pack ended; None when
    there is none (a pack cut short by a chip loss, or a JAX-package
    capture). A rounds record belongs to the pack when it comes from the
    same worker, opens with the pack's drafted trial ids, and its first
    round trained all of them."""
    ids = list(formed.get("trial_ids") or [])
    for r in rounds:
        got = list(r.get("trial_ids") or [])
        widths = [int(w) for w in r.get("widths") or []]
        if (ids and widths and r.get("worker_id") == formed.get("worker_id")
                and got[:len(ids)] == ids and widths[0] == len(ids)):
            return widths, got[len(ids):]
    return None


def _fit_epoch_overhead(step_rows: List[Dict[str, Any]],
                        chips: int) -> float:
    """Residual per-epoch overhead (eval/feedback/wiring) fitted from
    the capture: wall span minus per-chip epoch compute, spread over
    the per-chip epoch count. Clamped at zero — a parallel-idle capture
    must not produce negative overhead."""
    times = [r for r in step_rows
             if isinstance(r.get("ts"), (int, float))]
    if len(times) < 2:
        return 0.0
    span = (max(float(r["ts"]) for r in times)
            - min(float(r["ts"]) - float(r["dt"]) for r in times))
    chips = max(1, chips)
    compute_per_chip = sum(float(r["dt"]) for r in times) / chips
    epochs_per_chip = max(1.0, len(times) / chips)
    return max(0.0, (span - compute_per_chip) / epochs_per_chip)
