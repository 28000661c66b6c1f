"""The observability plane, counterpart of ``rafiki_tpu/obs``.

Layers on top of :mod:`rafiki_tpu_torch.telemetry`:

* :mod:`~rafiki_tpu_torch.obs.context` — trace ids propagated across
  threads, bus envelopes and worker-spawn env;
* :mod:`~rafiki_tpu_torch.obs.journal` — bounded per-process JSONL
  journals under ``RAFIKI_LOG_DIR`` that spans, events and serving
  decisions flush into, in the JAX package's file and record layout;
* :mod:`~rafiki_tpu_torch.obs.ledger` — goodput/cost accounting
  (compile vs step vs feed vs checkpoint) per trial and pack;
* :mod:`~rafiki_tpu_torch.obs.recorder` — flight recorder dumping the
  last-N ring to disk on a fatal error or an interrupt;
* :mod:`~rafiki_tpu_torch.obs.perf` — the perf sentinel: each captured
  training program's FLOPs (counted on its first eager step) joined
  with its epoch times into achieved FLOP/s and MFU, SLO burn-rate
  alerting and step-time anomaly detection;
* :mod:`~rafiki_tpu_torch.obs.health` — the numerics health plane;
* :mod:`~rafiki_tpu_torch.obs.anatomy` — the request anatomy: per-hop
  marks in the bus envelopes, their segments and histograms, the
  slowest-N exemplar ring and the per-second serving rollup;

plus :mod:`~rafiki_tpu_torch.obs.prom` (Prometheus text exposition of
the registry snapshot) and the ``python -m rafiki_tpu_torch.obs`` CLI
(:mod:`~rafiki_tpu_torch.obs.cli`) that merges journals across
processes.

Import discipline: this package's eager surface (context, journal) is
stdlib-only, so telemetry can import it without a cycle and the CLI
reads journals on a machine without torch; anatomy, ledger, prom,
recorder, perf and cli import telemetry and load lazily via ``__getattr__``.
Nothing here imports torch at module scope.
"""

from __future__ import annotations

import importlib

from rafiki_tpu_torch.obs import context, journal  # noqa: F401  (eager, dep-free)

_LAZY = ("anatomy", "ledger", "perf", "prom", "recorder", "cli")

__all__ = ["context", "journal", *_LAZY, "configure_from_env"]


def __getattr__(name: str):
    if name in _LAZY:
        mod = importlib.import_module(f"rafiki_tpu_torch.obs.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def configure_from_env(role=None) -> bool:
    """One call a process makes at startup: adopt RAFIKI_TRACE_ID and,
    when RAFIKI_LOG_DIR is set, open this process's journal. Returns
    True when a journal was configured."""
    return journal.configure_from_env(role=role)
