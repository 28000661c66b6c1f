"""Calibration bundles: everything the twin engine runs on, in one
versioned JSON artifact.

The port's own copy of ``rafiki_tpu/obs/twin/calibration.py``. The
roofline service path reads the card a cost row was counted on, not a
TPU's constants: the peak is the row's own ``peak_flops`` (the port's
``perf/cost`` rows carry it, ``obs/perf/profiler.py``), the HBM
bandwidth is ``profiler.hbm_bandwidth`` of the row's ``device``, and a
chip's HBM bytes are the card's own (``shard/plan.py
device_memory_bytes``). The port's rows carry ``bytes_accessed`` and
``peak_hbm_bytes`` as null, so a port row has no memory term and a port
bundle no ``hbm_frac``.

A bundle is extracted from a journal directory (the durable side
channel every serving run leaves under ``RAFIKI_LOG_DIR``) and carries
three ingredient classes:

* **hop-segment samples** — per-segment service/overhead durations
  harvested from ``serving/hops`` chains (docs/serving_anatomy.md).
  Only the *sampled* segments are kept: ``route``, ``batch_wait``,
  ``forward``/``forward_cold``, ``reply_publish``. The waiting
  segments (``admission_wait``, ``bus_queue``, ``gather_decide``) are
  deliberately DROPPED — the simulator derives those emergently from
  its own queues and quorum/hedge timing, and sampling them too would
  double-count waiting (``gather_decide`` spans reply→decide, i.e. it
  IS the straggler wait the twin simulates).
* **gateway knobs** — the live limits journaled as ``gateway/config``
  by ``Gateway.__init__``, so the twin simulates the admission budget
  the run actually had, not a guessed default.
* **cost rows** — ``perf/cost`` FLOP counts (``obs/perf/profiler.py``)
  keyed by key hash, the service-time source for configurations that
  were never measured (:func:`service_from_cost` roofline); each row
  keeps the card it was counted on (``device``) and that card's peak
  (``peak_flops``).

Extraction fails LOUDLY, listing every missing record kind, instead of
silently defaulting: a twin calibrated on air would predict air.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.obs import journal as journal_mod
from rafiki_tpu_torch.obs.anatomy import hops as _hops
from rafiki_tpu_torch.obs.perf.profiler import hbm_bandwidth

CALIBRATION_VERSION = 1

#: Segments whose duration the engine SAMPLES from the bundle. The
#: complement of the emergent set below — together they cover every
#: segment in hops.SEGMENT_OF.
SAMPLED_SEGMENTS = ("route", "batch_wait", "forward", "forward_cold",
                    "reply_publish")

#: Segments the engine derives from its own queue/gather dynamics.
EMERGENT_SEGMENTS = ("admission_wait", "bus_queue", "gather_decide",
                     "gateway_batch_wait")

#: Per-segment sample cap: above this, evenly spaced order statistics
#: of the sorted samples are kept — deterministic, shape-preserving.
SAMPLE_CAP = 512

#: Record kinds a bundle cannot be built without (kind/name keys as
#: they appear in the journals).
REQUIRED_KINDS = ("serving/hops", "gateway/config")

#: Multiplier spread applied around the nominal forward time by
#: :meth:`Calibration.nominal` — a literal right-skewed grid (p50≈1,
#: long tail) so even the synthetic bundle has believable percentiles.
_NOMINAL_SPREAD = (0.82, 0.86, 0.89, 0.92, 0.94, 0.96, 0.97, 0.98,
                   0.99, 1.00, 1.00, 1.01, 1.02, 1.03, 1.04, 1.05,
                   1.06, 1.08, 1.10, 1.12, 1.15, 1.18, 1.22, 1.27,
                   1.33, 1.40, 1.50, 1.62, 1.80, 2.05, 2.40, 3.00)


class CalibrationError(ValueError):
    """A journal dir missing required record kinds. ``missing`` lists
    every absent kind so the operator fixes the capture once, not one
    error message at a time."""

    def __init__(self, missing: List[str], source: str = ""):
        self.missing = list(missing)
        self.source = source
        super().__init__(
            "cannot calibrate twin from %r: missing journal record "
            "kind(s): %s — run the workload with RAFIKI_LOG_DIR set "
            "(a served job behind a Gateway) so the serving plane journals "
            "them" % (source or "<records>", ", ".join(self.missing)))


def _cap(samples: List[float]) -> List[float]:
    xs = sorted(samples)
    if len(xs) <= SAMPLE_CAP:
        return xs
    last = len(xs) - 1
    return [xs[(i * last) // (SAMPLE_CAP - 1)] for i in range(SAMPLE_CAP)]


@dataclasses.dataclass
class Calibration:
    """One loaded bundle. ``segments`` maps segment name -> sorted
    duration samples (seconds); ``gateway`` carries the live knob dict;
    ``cost`` maps key_hash -> cost row; ``workers`` is the observed
    fleet size."""

    segments: Dict[str, List[float]]
    gateway: Dict[str, Any]
    workers: int
    cost: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    source: str = ""
    version: int = CALIBRATION_VERSION
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_records(cls, records: List[Dict[str, Any]],
                     source: str = "") -> "Calibration":
        """Build from already-merged journal records (read_dir output).
        Raises :class:`CalibrationError` listing every missing kind."""
        seg_samples: Dict[str, List[float]] = {s: [] for s in SAMPLED_SEGMENTS}
        gateway_cfg: Optional[Dict[str, Any]] = None
        cost: Dict[str, Dict[str, Any]] = {}
        fanouts: List[int] = []
        for r in records:
            kind, name = r.get("kind"), r.get("name")
            if kind == "serving" and name == "hops":
                chains = r.get("chains") or {}
                fanouts.append(len(chains))
                for marks in chains.values():
                    for seg, dur in _hops.segments(marks):
                        if seg in seg_samples and dur >= 0:
                            seg_samples[seg].append(float(dur))
            elif kind == "gateway" and name == "config":
                gateway_cfg = {k: v for k, v in r.items()
                               if k not in ("ts", "pid", "role", "kind",
                                            "name", "trace_id")}
            elif kind == "perf" and name == "cost":
                kh = r.get("key_hash")
                if kh:
                    cost[kh] = {k: r.get(k) for k in
                                ("key", "program_kind", "k", "flops",
                                 "bytes_accessed", "peak_hbm_bytes",
                                 "device", "peak_flops")}
            elif kind == "gather" and name == "predictor.gather":
                ws = r.get("workers") or []
                fanouts.append(len(ws))
        missing = []
        if not any(seg_samples[s] for s in ("forward", "forward_cold")):
            missing.append("serving/hops")
        if gateway_cfg is None:
            missing.append("gateway/config")
        if missing:
            raise CalibrationError(missing, source)
        workers = max(fanouts) if fanouts else 1
        return cls(
            segments={s: _cap(xs) for s, xs in seg_samples.items() if xs},
            gateway=gateway_cfg, workers=max(1, workers), cost=cost,
            source=source,
            meta={"hops_records": sum(1 for r in records
                                      if r.get("kind") == "serving"
                                      and r.get("name") == "hops"),
                  "cost_rows": len(cost)})

    @classmethod
    def from_journal_dir(cls, log_dir) -> "Calibration":
        records = journal_mod.read_dir(log_dir)
        if not records:
            raise CalibrationError(list(REQUIRED_KINDS), str(log_dir))
        return cls.from_records(records, source=str(log_dir))

    @classmethod
    def nominal(cls, forward_ms: float = 5.0, workers: int = 2,
                overhead_ms: float = 0.2) -> "Calibration":
        """A synthetic bundle for pre-gaming without captured telemetry
        (the chaos pre-gate default). Forward times spread the literal
        :data:`_NOMINAL_SPREAD` grid around ``forward_ms``; the wiring
        segments get a flat ``overhead_ms``."""
        fwd = sorted(forward_ms / 1000.0 * m for m in _NOMINAL_SPREAD)
        ovh = [overhead_ms / 1000.0 * m for m in (0.5, 0.8, 1.0, 1.2, 2.0)]
        from rafiki_tpu_torch.gateway.gateway import GatewayConfig

        g = GatewayConfig()
        return cls(
            segments={"forward": fwd, "forward_cold": [f * 4 for f in fwd],
                      "route": list(ovh), "batch_wait": list(ovh),
                      "reply_publish": list(ovh)},
            gateway={"max_inflight": g.max_inflight,
                     "max_queue": g.max_queue,
                     "default_deadline_s": g.default_deadline_s,
                     "min_replies": g.min_replies,
                     "hedge_grace_s": g.hedge_grace_s,
                     "policy": g.policy,
                     "breaker_failures": g.breaker_failures,
                     "breaker_cooldown_s": g.breaker_cooldown_s},
            workers=workers, source="nominal",
            meta={"forward_ms": forward_ms})

    # -- (de)serialization ---------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"calibration_version": self.version, "source": self.source,
                "workers": self.workers, "gateway": self.gateway,
                "segments": {s: [round(x, 9) for x in xs]
                             for s, xs in self.segments.items()},
                "cost": self.cost, "meta": self.meta}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Calibration":
        v = d.get("calibration_version")
        if v != CALIBRATION_VERSION:
            raise ValueError(f"unsupported calibration_version {v!r} "
                             f"(this build reads {CALIBRATION_VERSION})")
        return cls(segments={s: sorted(float(x) for x in xs)
                             for s, xs in (d.get("segments") or {}).items()},
                   gateway=dict(d.get("gateway") or {}),
                   workers=int(d.get("workers") or 1),
                   cost=dict(d.get("cost") or {}),
                   source=d.get("source") or "", version=v,
                   meta=dict(d.get("meta") or {}))

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path) -> "Calibration":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- derived views -------------------------------------------------------

    def dist(self, segment: str) -> List[float]:
        """The (possibly empty) sample list for one segment; forward
        falls back to forward_cold and vice versa so a cold-only or
        warm-only capture still simulates."""
        xs = self.segments.get(segment)
        if xs:
            return xs
        if segment == "forward":
            return self.segments.get("forward_cold") or []
        if segment == "forward_cold":
            return self.segments.get("forward") or []
        return []

    def scaled(self, scales: Dict[str, float]) -> "Calibration":
        """A copy with named segments multiplied — the deliberate
        mis-calibration knob the validation smoke uses to prove the
        gate fails when the model is wrong."""
        unknown = set(scales) - set(SAMPLED_SEGMENTS)
        if unknown:
            raise ValueError(f"unknown segment(s) to scale: "
                             f"{sorted(unknown)}; one of {SAMPLED_SEGMENTS}")
        segs = {s: ([x * scales[s] for x in xs] if s in scales else list(xs))
                for s, xs in self.segments.items()}
        return dataclasses.replace(
            self, segments=segs,
            meta=dict(self.meta, scaled={k: v for k, v in scales.items()}))

    def service_from_cost(self, key_hash_prefix: str,
                          peak_flops: Optional[float] = None,
                          mfu: float = 0.3) -> float:
        """Roofline service-time prediction for an UNMEASURED program:
        max(compute, memory) seconds at an assumed MFU — the path that
        answers capacity questions for configs never run on hardware.
        The peak is ``peak_flops`` or else the row's own; the memory
        term needs the row's ``bytes_accessed`` and its card's HBM
        bandwidth, and is 0 without either (module doc)."""
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
        compute_s = float(row.get("flops") or 0.0) / (peak_flops * mfu)
        bandwidth = hbm_bandwidth(row.get("device"))
        memory_s = (float(row["bytes_accessed"]) / bandwidth
                    if row.get("bytes_accessed") is not None and bandwidth
                    else 0.0)
        return max(compute_s, memory_s)

    def with_forward_from_cost(self, key_hash_prefix: str,
                               mfu: float = 0.3) -> "Calibration":
        """Replace the forward distribution with the cost-model
        roofline point — single-sample, i.e. deterministic service."""
        svc = self.service_from_cost(key_hash_prefix, mfu=mfu)
        segs = dict(self.segments)
        segs["forward"] = [svc]
        segs.pop("forward_cold", None)
        return dataclasses.replace(
            self, segments=segs,
            meta=dict(self.meta, forward_from_cost=key_hash_prefix, mfu=mfu))

    def hbm_frac(self) -> Optional[float]:
        """Static peak-HBM occupancy fraction of the largest captured
        program, against this process's card (``shard/plan.py
        device_memory_bytes``) — None when no cost row has
        ``peak_hbm_bytes`` (the port's never do) or there is no card."""
        peaks = [float(r["peak_hbm_bytes"]) for r in self.cost.values()
                 if r.get("peak_hbm_bytes") is not None]
        if not peaks:
            return None
        from rafiki_tpu_torch.shard.plan import device_memory_bytes

        try:
            per_chip = device_memory_bytes()
        except (ValueError, RuntimeError):
            return None
        return max(peaks) / per_chip
