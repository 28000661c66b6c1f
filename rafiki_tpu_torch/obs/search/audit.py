"""The advisor audit's join key.

The port's own copy of ``knobs_hash`` from
``rafiki_tpu/obs/search/audit.py``: a sha256 prefix over the canonical
JSON of a full knob assignment, so a hash written by either package
(a sweep WAL's claim intent, a journal record) joins in the other. The
rest of that module, the ``advisor/*`` decision records, waits for
ROADMAP Queue 1, item 9.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict


def knobs_hash(knobs: Dict[str, Any]) -> str:
    """Canonical 16-hex digest of a full knob assignment. Knob values
    are JSON natives, so ``sort_keys`` JSON is a stable canonical form
    on both the writer side and the journal-reader side."""
    blob = json.dumps(knobs, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]
