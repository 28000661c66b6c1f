"""Advisor service: a registry of per-(sub)job advisors shared by workers.

The port's own copy of ``rafiki_tpu/advisor/service.py``
``AdvisorService``: create/propose/feedback/speculate/delete so train
workers share one optimisation state. In-proc workers call this object
directly. Each advisor carries its registry id, so every ``advisor/*``
journal record it writes is filterable per sweep.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, Optional, Tuple

from rafiki_tpu_torch.advisor.base import BaseAdvisor, make_advisor
from rafiki_tpu_torch.model.knobs import KnobConfig, Knobs, deserialize_knob_config


class AdvisorService:
    def __init__(self):
        self._advisors: Dict[str, BaseAdvisor] = {}
        self._lock = threading.Lock()

    def create_advisor(self, knob_config: KnobConfig | str, kind: str = "gp",
                       seed: int = 0, advisor_id: Optional[str] = None,
                       engine_kwargs: Optional[dict] = None) -> str:
        if isinstance(knob_config, str):
            knob_config = deserialize_knob_config(knob_config)
        aid = advisor_id or uuid.uuid4().hex
        with self._lock:
            if aid not in self._advisors:
                adv = make_advisor(knob_config, kind=kind, seed=seed,
                                   **(engine_kwargs or {}))
                adv.advisor_id = aid
                self._advisors[aid] = adv
        return aid

    def get(self, advisor_id: str) -> BaseAdvisor:
        with self._lock:
            adv = self._advisors.get(advisor_id)
        if adv is None:
            raise KeyError(f"No advisor {advisor_id!r}")
        return adv

    def propose(self, advisor_id: str) -> Knobs:
        return self.get(advisor_id).propose()

    def propose_batch(self, advisor_id: str, n: int) -> list:
        return self.get(advisor_id).propose_batch(n)

    def feedback(self, advisor_id: str, score: float, knobs: Knobs) -> None:
        self.get(advisor_id).feedback(score, knobs)

    def speculate(self, advisor_id: str, score: float, knobs: Knobs,
                  fit: Optional[dict] = None) -> None:
        """Tell with a predicted score for a still-running trial
        (``advisor/speculative.py``; ``fit`` is the curve fit's record,
        journaled with it); the true score lands later through
        ``feedback`` as a correction."""
        self.get(advisor_id).speculate(score, knobs, fit=fit)

    def best(self, advisor_id: str) -> Optional[Tuple[Knobs, float]]:
        return self.get(advisor_id).best()

    def delete_advisor(self, advisor_id: str) -> None:
        with self._lock:
            self._advisors.pop(advisor_id, None)
