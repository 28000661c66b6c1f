"""The search-anatomy plane, counterpart of ``rafiki_tpu/obs/search``.

Only :mod:`~rafiki_tpu_torch.obs.search.audit`'s ``knobs_hash`` is
ported so far: the join key the sweep's write-ahead log
(``scheduler/wal.py``), the mesh sweep and advisor rehydration share.
The advisor audit records, the search ledger, sweep reconstruction and
lineage wait for ROADMAP Queue 1, item 9.
"""

from rafiki_tpu_torch.obs.search.audit import knobs_hash

__all__ = ["knobs_hash"]
