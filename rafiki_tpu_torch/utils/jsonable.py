"""JSON-serializable coercion for API responses (numpy -> plain types).

The port's own copy of ``rafiki_tpu/utils/jsonable.py``, unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def jsonable(obj: Any) -> Any:
    """Recursively convert numpy arrays/scalars so json.dumps accepts it."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if isinstance(obj, bytes):
        return obj.decode("utf-8", "replace")
    if isinstance(obj, dict):
        return {k: jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    return obj
