"""Training/sweep digital twin (docs/twin.md).

The port's own copy of ``rafiki_tpu/obs/twin/train/``.

A deterministic discrete-event simulator of the sweep chain —
propose_batch → pack formation by packing key → chip assignment →
packed epochs (compile-vs-step costs from captured ``perf/step``
samples) → eviction/backfill → feedback — calibrated from the same
journal substrate the serving twin uses, plus the ``mesh/pack_formed``
records the scheduler journals at pack formation.

Layers:

* :mod:`~rafiki_tpu_torch.obs.twin.train.calibration` — the versioned
  bundle: per-(packing_key, k) step/compile samples, pack shapes, the
  fitted epoch overhead, ``perf/cost`` rows for roofline forecasts;
* :mod:`~rafiki_tpu_torch.obs.twin.train.engine` — the event-heap sweep
  simulator (chips, packed epochs, eviction, chaos repack);
* :mod:`~rafiki_tpu_torch.obs.twin.train.whatif` — best pack width per key,
  the chips-vs-pack split search, proposed-member forecasts;
* :mod:`~rafiki_tpu_torch.obs.twin.train.validate` — predicted-vs-measured
  gating against a captured mesh sweep;
* :mod:`~rafiki_tpu_torch.obs.twin.train.placement` — the advisory
  sweep-admission consultation behind ``RAFIKI_TWIN_PLACEMENT``;
* :mod:`~rafiki_tpu_torch.obs.twin.train.pregate` — SweepChipLane autoscale
  pre-gate + chaos forecasts at the sweep sites.

Same determinism contract as the parent package: one seed reproduces
the event log bit-for-bit: no ambient clocks, no OS-entropy RNG.
"""

from __future__ import annotations

import importlib

#: Public surface -> defining submodule; resolved lazily for the same
#: reason as the parent package (the obs CLI mounts parsers eagerly).
_EXPORTS = {
    "TrainCalibration": "calibration",
    "TrainCalibrationError": "calibration",
    "TrainTwinConfig": "engine", "simulate": "engine",
}
_LAZY_MODULES = ("calibration", "engine", "whatif", "validate",
                 "placement", "pregate", "cli")

__all__ = [*_EXPORTS, *_LAZY_MODULES]


def __getattr__(name: str):
    if name in _EXPORTS:
        mod = importlib.import_module(
            f"rafiki_tpu_torch.obs.twin.train.{_EXPORTS[name]}")
        val = getattr(mod, name)
        globals()[name] = val
        return val
    if name in _LAZY_MODULES:
        mod = importlib.import_module(
            f"rafiki_tpu_torch.obs.twin.train.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
