"""Uniform random search: the baseline engine and the test advisor.

The port's own copy of ``rafiki_tpu/advisor/random_advisor.py``.
"""

from __future__ import annotations

from rafiki_tpu_torch.advisor.base import BaseAdvisor
from rafiki_tpu_torch.model.knobs import Knobs


class RandomAdvisor(BaseAdvisor):
    def _propose(self) -> Knobs:
        return self.space.sample(self._rng)
