"""Predictor: the serving front end that fans queries out to inference
workers and ensembles their predictions.

Counterpart of ``rafiki_tpu/predictor``; the HTTP app is
``rafiki_tpu_torch.predictor.app``.
"""

from rafiki_tpu_torch.predictor.ensemble import ensemble_predictions
from rafiki_tpu_torch.predictor.predictor import (
    DEFAULT_HEDGE_GRACE_S,
    GatherReport,
    Predictor,
    default_quorum,
)

__all__ = ["DEFAULT_HEDGE_GRACE_S", "GatherReport", "Predictor",
           "default_quorum", "ensemble_predictions"]
