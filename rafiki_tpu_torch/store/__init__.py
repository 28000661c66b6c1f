"""Persistence layer: meta store (sqlite3) + params store (files).

Counterpart of ``rafiki_tpu/store``; the content-addressed params
store (``store/cas.py``) is not ported yet.
"""

from rafiki_tpu_torch.store.meta import MetaStore
from rafiki_tpu_torch.store.params import ParamsStore

__all__ = ["MetaStore", "ParamsStore"]
