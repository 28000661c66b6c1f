"""Persistence layer: meta store (sqlite3) + params store (files), plain
or content-addressed.

Counterpart of ``rafiki_tpu/store``.
"""

from rafiki_tpu_torch.store.cas import CasParamsStore, make_params_store
from rafiki_tpu_torch.store.meta import MetaStore
from rafiki_tpu_torch.store.params import ParamsStore

__all__ = ["CasParamsStore", "MetaStore", "ParamsStore", "make_params_store"]
