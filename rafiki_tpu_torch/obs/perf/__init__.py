"""Perf sentinel, counterpart of ``rafiki_tpu/obs/perf``: profiling,
SLOs and anomaly detection.

* :mod:`~rafiki_tpu_torch.obs.perf.profiler` — each training program's
  FLOPs, counted with ``torch.utils.flop_counter`` on its first eager
  step, joined with its measured epoch times (achieved FLOP/s, MFU),
  the ``perf`` telemetry collector and the ``perf/*`` journal records.
* :mod:`~rafiki_tpu_torch.obs.perf.slo` — declarative SLO specs
  evaluated as multi-window burn rates; breaches journal, count, and
  trip the flight recorder.
* :mod:`~rafiki_tpu_torch.obs.perf.anomaly` — the EWMA+MAD detector the
  profiler runs over every program's epoch times.

Importing this package registers the ``perf`` and ``slo`` telemetry
collectors. It never imports torch at module scope.
"""

from rafiki_tpu_torch.obs.perf import anomaly, profiler, slo

__all__ = ["anomaly", "profiler", "slo"]
