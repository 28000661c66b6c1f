"""Ensembling of per-trial predictions.

Reference parity: rafiki/predictor/ensemble.py (unverified):
classification ensembles by averaging probability vectors (then the
caller argmaxes); non-numeric predictions fall back to the first
worker's answer.

The port's own copy of ``rafiki_tpu/predictor/ensemble.py``. The
stacked route (rafiki_tpu_torch/parallel/ensemble.py) runs the same
host op sequence through :func:`renormalize_probs`.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np


def renormalize_probs(mean: np.ndarray) -> np.ndarray:
    """Re-normalize probability vectors so the ensemble is a
    distribution. Shared by the host-side mean below AND the stacked
    device-resident path (rafiki_tpu_torch/parallel/serving.py) — both
    routes MUST run the identical op sequence or the stacked-vs-serial
    bit-parity contract breaks."""
    if mean.ndim >= 1 and np.all(mean >= 0):
        s = mean.sum(axis=-1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = np.where(s > 0, mean / s, mean)
    return mean


def ensemble_predictions(predictions: Sequence[Any]) -> Any:
    """Combine k workers' predictions for ONE query."""
    preds = [p for p in predictions if not (isinstance(p, dict) and "error" in p)]
    if not preds:
        return {"error": "all workers errored", "detail": list(predictions)[:3]}
    try:
        arrs = [np.asarray(p) for p in preds]
    except (ValueError, TypeError):
        return preds[0]
    # Only *float* arrays are probability vectors we can average;
    # integer arrays are class labels / tag sequences (averaging tag
    # ids is meaningless) → fall back to the best worker's answer.
    if any(a.shape != arrs[0].shape or a.ndim == 0
           or not np.issubdtype(a.dtype, np.floating) for a in arrs):
        return preds[0]
    # Models emit float32 probabilities; replies arrive as JSON floats
    # (float64 carrying exact float32 values). Cast back to float32 so
    # the mean is computed in the SAME dtype the stacked on-device
    # ensemble uses — the bit-parity contract between the two routes.
    mean = renormalize_probs(np.mean(
        np.stack([a.astype(np.float32) for a in arrs]), axis=0))
    return mean.tolist()
