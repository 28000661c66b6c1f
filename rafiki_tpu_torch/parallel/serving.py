"""Stacked serving adapter: k same-architecture trials behind one
``predict()``.

Counterpart of ``rafiki_tpu/parallel/serving.py``. When an inference
job's top-k trials share an architecture they are served as ONE
InferenceWorker wrapping this adapter: a single vmapped forward per
query batch instead of k workers each doing its own device round-trip.
Heterogeneous top-k falls back to one worker per trial.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rafiki_tpu_torch.parallel.ensemble import StackedEnsemble


class StackedTrialModel:
    """Implements the slice of the model contract InferenceWorker uses
    (``predict``/``destroy``), fusing k loaded same-arch TorchModels."""

    def __init__(self, models: List[Any], batch_size: int = 64):
        if not models:
            raise ValueError("Need at least one model to stack")
        first = models[0]
        if any(m._arch != first._arch for m in models):
            raise ValueError("Models disagree on architecture; cannot stack")
        if any(m.device != first.device for m in models):
            raise ValueError("Models live on different devices; cannot stack")
        self.batch_size = int(batch_size)
        self.device = first.device
        self._first = first
        self._ens = StackedEnsemble([m._module for m in models])
        # The stacked copy is the serving copy: drop the per-model
        # modules (all but the first, which predict() still uses for
        # preprocess and the architecture).
        for m in models[1:]:
            m.destroy()

    def predict(self, queries: List[Any]) -> List[List[float]]:
        x = self._first.preprocess(
            np.asarray(queries, dtype=self._first._input_dtype()))
        return self.predict_proba(x).tolist()

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        """Fixed-size chunks, the last one padded with ZEROS (as the JAX
        package's adapter does), so the device sees one shape."""
        bs = self.batch_size
        out = []
        for start in range(0, len(x), bs):
            chunk = x[start:start + bs]
            valid = len(chunk)
            if valid < bs:
                pad = np.zeros((bs - valid,) + chunk.shape[1:], chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            xt = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            out.append(self._ens.ensemble_proba(xt)[:valid])
        return np.concatenate(out) if out else np.zeros((0, 0))

    def warmup(self) -> float:
        """Pay the first-call costs (cuDNN's algorithm choice, the CUDA
        context, allocator growth) at SERVICE CREATION, not on the first
        live request: one forward over a zero batch of the serving
        shape. Returns the warmup wall seconds."""
        t0 = time.monotonic()
        input_shape = tuple(self._first._arch[1])
        x = self._first.preprocess(
            np.zeros((self.batch_size,) + input_shape,
                     self._first._input_dtype()))
        self.predict_proba(x)
        return time.monotonic() - t0

    def destroy(self) -> None:
        self._first.destroy()
        self._ens = None


def _param_shape_tree(model) -> Dict[str, Tuple[tuple, str]]:
    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in model._module.state_dict().items()}


def build_stacked(trials: List[dict], models: List[Any],
                  batch_size: int = 64,
                  ) -> Tuple[Optional[StackedTrialModel], str]:
    """Return ``(stacked adapter, reason)``: the adapter when every
    trial is stackable (reason ``"stacked"``), else ``(None, why)``.

    Stackable = same model template, a TorchModel-style loaded instance
    (a live ``_module``), and IDENTICAL parameter shapes and dtypes.
    Dropout-rate differences vanish at serve time, so serving through
    the first model's architecture is exact for all k.
    """
    if len(models) < 2:
        return None, "single-trial"
    if len({t.get("model_name") for t in trials}) != 1:
        return None, "mixed-templates"
    if not all(getattr(m, "_module", None) is not None for m in models):
        return None, "not-torch-loaded"
    try:
        shapes0 = _param_shape_tree(models[0])
        if any(_param_shape_tree(m) != shapes0 for m in models[1:]):
            return None, "param-shape-mismatch"
        return StackedTrialModel(models, batch_size=batch_size), "stacked"
    except Exception as e:  # any mismatch → caller falls back to per-trial
        return None, f"build-error: {type(e).__name__}"


def try_build_stacked(trials: List[dict], models: List[Any],
                      batch_size: int = 64) -> Optional[StackedTrialModel]:
    """Back-compat wrapper over :func:`build_stacked` (adapter only)."""
    return build_stacked(trials, models, batch_size=batch_size)[0]
