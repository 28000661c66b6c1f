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

Member groups (``StackedEnsemble(devices=...)``): the counterpart of the
JAX package's ``shard_map`` over a ``("model",)`` mesh axis
(``rafiki_tpu/parallel/ensemble.py:27-80``), where each device vmaps its
k/n sub-ensemble with no collective until the host gathers. As there, n
is the largest divisor of k that is at most the number of devices; with
n > 1 the members split into n contiguous groups of k/n, in member order
(``P("model")``), each group's params stacked on its own device and run
through the same vmapped forward. Devices may repeat (``[cuda:0,
cuda:0]`` is two groups on one card; torch's one CPU device gives
``[cpu, cpu]``). A member's forward is the same in any group, so the
split forward gives the one-device forward's bits.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
    """Serve k same-architecture trials as one vmapped forward, or as n
    member groups on their devices (module doc). ``groups`` holds each
    group's ``(device, stacked params)`` in member order, one group on
    the params' own device when the ensemble is not split; ``mesh`` is
    the groups' devices when it is split (n > 1), else None."""

    def __init__(self, modules: Sequence[nn.Module], devices: Optional[Sequence] = None):
        modules = list(modules)
        self.k = len(modules)
        self._fwd = make_ensemble_forward(modules[0])
        n = 1
        if devices is not None and len(devices) > 1:
            n = max(d for d in range(1, min(len(devices), self.k) + 1) if self.k % d == 0)
        stacked = stack_params(modules)
        if n == 1:
            self.mesh = None
            self.groups: List[Tuple[torch.device, Stacked]] = [
                (next(iter(stacked[0].values())).device, stacked)]
        else:
            self.mesh = tuple(torch.device(d) for d in list(devices)[:n])
            per = self.k // n
            self.groups = [(d, tuple({name: v[g * per:(g + 1) * per].to(d, copy=True)
                                      for name, v in tree.items()} for tree in stacked))
                           for g, d in enumerate(self.mesh)]

    def group_forward(self, g: int, x: torch.Tensor) -> torch.Tensor:
        """Group ``g``'s ``(k/n, B, C)`` probabilities, on its device."""
        device, stacked = self.groups[g]
        return self._fwd(stacked, x.to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(k, B, C)`` per-model probabilities, on the first group's
        device: ``x`` is copied to each group's device, and the groups'
        outputs are gathered in member order."""
        outs = [self.group_forward(g, x) for g in range(len(self.groups))]
        if len(outs) == 1:
            return outs[0]
        return torch.cat([o.to(self.groups[0][0]) for o in outs])

    def predict_proba(self, x: torch.Tensor) -> np.ndarray:
        """Returns ``(k, B, C)`` per-model probabilities (host array),
        each group's gathered on the host."""
        with torch.inference_mode():
            return np.concatenate([self.group_forward(g, x).cpu().numpy()
                                   for g in range(len(self.groups))])

    def ensemble_proba(self, x: torch.Tensor) -> np.ndarray:
        """Mean over the model axis -> ``(B, C)``, computed with the SAME
        host op sequence as the replicated route's ensembler
        (predictor/ensemble.py: float32 stack-mean, shared renormalize),
        so the two routes agree bit for bit where the per-model
        forwards do."""
        return ensemble_mean(self.predict_proba(x))


def ensemble_mean(probs: np.ndarray) -> np.ndarray:
    """``(k, B, C)`` per-model probabilities (host) -> the ensembled
    ``(B, C)``: the replicated route's host op sequence."""
    return renormalize_probs(np.mean(probs.astype(np.float32), axis=0))
