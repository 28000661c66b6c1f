"""Request anatomy plane, counterpart of ``rafiki_tpu/obs/anatomy``.

The serving path decomposed per hop, on the trace and journal plane:

* :mod:`hops` — compact per-hop timestamp marks carried inside the bus
  envelope, segment math, and the absorb step that turns a gathered
  chain into histograms and journal records;
* :mod:`exemplars` — a slowest-N-per-window ring keeping FULL
  waterfalls for the requests percentile summaries erase;
* :mod:`timeseries` — the per-second serving rollup journaled as
  ``serving/ts`` records (qps, p50/p99, shed rate, queue depth,
  inflight, breaker state).

Stitching and rendering live in the obs CLI (``obs waterfall``,
``obs tails``, ``obs serving``). Nothing here imports torch.
"""

from rafiki_tpu_torch.obs.anatomy import exemplars, hops, timeseries  # noqa: F401

__all__ = ["exemplars", "hops", "timeseries"]
