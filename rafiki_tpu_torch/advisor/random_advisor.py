"""Uniform random search: the baseline engine and the test advisor.

The port's own copy of ``rafiki_tpu/advisor/random_advisor.py``, with
its ``advisor/propose`` audit record.
"""

from __future__ import annotations

from rafiki_tpu_torch.advisor.base import BaseAdvisor
from rafiki_tpu_torch.model.knobs import Knobs
from rafiki_tpu_torch.obs.search import audit


class RandomAdvisor(BaseAdvisor):
    engine = "random"

    def _propose(self) -> Knobs:
        knobs = self.space.sample(self._rng)
        audit.record_propose(self, knobs, {"phase": "random"})
        return knobs
