"""Stacked ensemble forward: k trials, one vmapped forward.

Counterpart of ``rafiki_tpu/parallel/ensemble.py``. When the top-k
trials share an architecture, their parameters are stacked along a
leading "model" axis (``torch.func.stack_module_state``) and the forward
is ``torch.func.vmap``-ed over it through ``functional_call``: one
Python call, k logits batches. The GroupNorm is written from mean/rsqrt
ops and vmaps as it is.

Convolutions are the exception. Under vmap a conv with batched weights
lowers to one grouped conv, which sums in another order than the k
plain convs of the serial forwards, so the two routes would differ in
float32 and break the bit-parity contract of the JAX package's
``StackedEnsemble.ensemble_proba`` (docs/serving.md). The port's
models run their convs through ``ops.layers.conv2d``, which, given a
weight stacked under vmap, runs once per member, as the serial forward
runs it, and stacks the k outputs.

The JAX package's multi-chip branch (a ``shard_map`` over a "model"
mesh axis) is not ported: the port serves on one card.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, stack_module_state, vmap

from rafiki_tpu_torch.predictor.ensemble import renormalize_probs

Stacked = Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]


def stack_params(modules: Sequence[nn.Module]) -> Stacked:
    """Stack k identically-shaped modules' params and buffers along a new
    leading axis (detached: the stacked copy serves, it does not train)."""
    params, buffers = stack_module_state(list(modules))
    return ({k: v.detach() for k, v in params.items()},
            {k: v.detach() for k, v in buffers.items()})


def make_ensemble_forward(module: nn.Module) -> Callable[[Stacked, torch.Tensor], torch.Tensor]:
    """Build fn: ``(stacked, x) -> (k, B, C)`` float32 probabilities.

    ``module`` supplies the architecture only; its own weights are never
    read (it is copied to the meta device)."""
    base = copy.deepcopy(module).to("meta")

    def one(params, buffers, x):
        return functional_call(base, (params, buffers), (x,))

    batched = vmap(one, in_dims=(0, 0, None))

    def fwd(stacked: Stacked, x: torch.Tensor) -> torch.Tensor:
        logits = batched(stacked[0], stacked[1], x)
        return torch.softmax(logits.float(), dim=-1)

    return fwd


class StackedEnsemble:
    """Serve k same-architecture trials as one vmapped forward."""

    def __init__(self, modules: Sequence[nn.Module]):
        modules = list(modules)
        self.k = len(modules)
        self._fwd = make_ensemble_forward(modules[0])
        self._stacked = stack_params(modules)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(k, B, C)`` per-model probabilities, on the params' device."""
        return self._fwd(self._stacked, x)

    def predict_proba(self, x: torch.Tensor) -> np.ndarray:
        """Returns ``(k, B, C)`` per-model probabilities (host array)."""
        with torch.inference_mode():
            return self.forward(x).cpu().numpy()

    def ensemble_proba(self, x: torch.Tensor) -> np.ndarray:
        """Mean over the model axis -> ``(B, C)``, computed with the SAME
        host op sequence as the replicated route's ensembler
        (predictor/ensemble.py: float32 stack-mean, shared renormalize),
        so the two routes agree bit for bit where the per-model
        forwards do."""
        probs = self.predict_proba(x).astype(np.float32)
        return renormalize_probs(np.mean(probs, axis=0))
