"""Digital-twin capacity plane.

The port's own copy of ``rafiki_tpu/obs/twin/``: the serving twin, and
under :mod:`~rafiki_tpu_torch.obs.twin.train` the training/sweep twin
(with the ``twin train`` verbs).

A deterministic discrete-event simulator of the serving chain —
gateway admission/queue/shed → bus enqueue/dequeue → k-way worker
forward → quorum gather → reply — with service times drawn from
captured hop histograms (``serving/hops``) or, for unmeasured
configurations, from ``perf/cost`` roofline predictions. Load is
replayed from ``serving/ts`` journals or synthesized
(constant/ramp/spike/diurnal), and faults are injected from the same
``RAFIKI_CHAOS`` spec grammar the live plane parses, so chaos
scenarios can be pre-gamed offline.

Layers:

* :mod:`~rafiki_tpu_torch.obs.twin.calibration` — the versioned bundle the
  simulator runs on: hop-segment samples, gateway knobs, cost rows;
* :mod:`~rafiki_tpu_torch.obs.twin.load` — arrival processes (synthetic
  shapes + ``serving/ts`` replay);
* :mod:`~rafiki_tpu_torch.obs.twin.engine` — the event-heap simulator;
* :mod:`~rafiki_tpu_torch.obs.twin.whatif` — knob sweeps, the
  ``RAFIKI_SLO``-aware smallest-fleet search;
* :mod:`~rafiki_tpu_torch.obs.twin.validate` — predicted-vs-measured gating
  against a captured serving run;
* :mod:`~rafiki_tpu_torch.obs.twin.pregate` — the chaos runner's offline
  fault forecast;
* :mod:`~rafiki_tpu_torch.obs.twin.train` — the training/sweep twin
  (docs/twin.md), lazily loaded like the rest.

Determinism contract: one seed reproduces the event log bit-for-bit
(no ambient clocks or unseeded RNG in this package),
exactly like chaos schedules. The admission/quorum/breaker constants
are IMPORTED from the live gateway/predictor modules, never copied,
so the model cannot silently drift from the code it predicts.
"""

from __future__ import annotations

import importlib

#: Public surface -> defining submodule. Resolved lazily: the obs CLI
#: imports this package just to mount the argparse verbs, and must not
#: pay for the engine's gateway/predictor/chaos imports on every
#: ``obs tail``.
_EXPORTS = {
    "Calibration": "calibration", "CalibrationError": "calibration",
    "SAMPLED_SEGMENTS": "calibration",
    "TwinConfig": "engine", "simulate": "engine",
}
_LAZY_MODULES = ("calibration", "load", "engine", "whatif", "validate",
                 "pregate", "cli", "train")

__all__ = [*_EXPORTS, *_LAZY_MODULES]


def __getattr__(name: str):
    if name in _EXPORTS:
        mod = importlib.import_module(
            f"rafiki_tpu_torch.obs.twin.{_EXPORTS[name]}")
        val = getattr(mod, name)
        globals()[name] = val
        return val
    if name in _LAZY_MODULES:
        mod = importlib.import_module(f"rafiki_tpu_torch.obs.twin.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
