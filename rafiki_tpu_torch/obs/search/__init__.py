"""The search-anatomy plane, counterpart of ``rafiki_tpu/obs/search``.

* :mod:`~rafiki_tpu_torch.obs.search.audit`: the journal records every
  advisor ``_propose*``/``_feedback`` implementation writes
  (``kind="advisor"``), and the curve plane's predict/kill/speculate/
  correct records, keyed by a knobs-hash joinable against
  ``event/trial_started`` and ``trial/epoch_eval`` records and the
  sweep's write-ahead log;
* :mod:`~rafiki_tpu_torch.obs.search.ledger`: the ``search`` telemetry
  collector charging wall-time to proposed-but-doomed vs
  completed-and-scored trials;
* :mod:`~rafiki_tpu_torch.obs.search.reconstruct`: a whole sweep from
  journals alone, failing loudly on an unjournaled decision;
* :mod:`~rafiki_tpu_torch.obs.search.lineage`: pack/evict/backfill/
  kill/resume/repack events stitched into trial genealogy, with
  fleet-wide orphan reconciliation;
* :mod:`~rafiki_tpu_torch.obs.search.stats`: the seeded bootstrap CI.

Read through ``python -m rafiki_tpu_torch.obs sweep`` / ``lineage`` /
``resume`` (:mod:`~rafiki_tpu_torch.obs.search.cli`). Either package's
journals read the same in the other's readers. Submodules load lazily.
"""

from __future__ import annotations

import importlib

_LAZY = ("audit", "ledger", "lineage", "reconstruct", "stats", "cli")

__all__ = list(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        mod = importlib.import_module(f"rafiki_tpu_torch.obs.search.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
