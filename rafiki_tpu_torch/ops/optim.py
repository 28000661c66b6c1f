"""Adam's lr-free core, with optax's exact definition.

Counterpart of ``optax.scale_by_adam()`` as the JAX package's train
step uses it (``rafiki_tpu/model/base.py make_base_optimizer``): the
step multiplies the result by ``-effective_lr`` itself. All float32:

    mu    = (1 - b1) * g   + b1 * mu
    nu    = (1 - b2) * g^2 + b2 * nu
    count = count + 1
    u     = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

(optax's ``eps_root`` is 0 in the JAX package's use, so it is left out.)

``torch.optim.Adam`` places eps and the bias correction differently,
so it is not used. The arithmetic runs as multi-tensor ``_foreach``
ops: one launch per operation over all leaves, not one per leaf. The
bias corrections are computed on the host in float32 (the step count
lives there), so no step reads back from the device.

The moments are allocated at the first update, as zeros: a loop that
only serves holds no optimizer state, and the first update is the
same as from optax's zero-initialised state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass
class ScaleByAdamState:
    count: int
    mu: Optional[List[torch.Tensor]]
    nu: Optional[List[torch.Tensor]]


class ScaleByAdam:
    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]) -> ScaleByAdamState:
        return ScaleByAdamState(count=0, mu=None, nu=None)

    def update(self, grads: Sequence[torch.Tensor], state: ScaleByAdamState
               ) -> Tuple[List[torch.Tensor], ScaleByAdamState]:
        """The updates for ``grads``; the moments are updated in place."""
        grads = list(grads)
        if state.mu is None:
            mu = [torch.zeros_like(g) for g in grads]
            nu = [torch.zeros_like(g) for g in grads]
        else:
            mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, sq)
        count = min(state.count + 1, np.iinfo(np.int32).max)
        one = np.float32(1.0)
        bc1 = float(one - np.float32(self.b1) ** np.float32(count))
        bc2 = float(one - np.float32(self.b2) ** np.float32(count))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, bc1)
        torch._foreach_div_(updates, denom)
        return updates, ScaleByAdamState(count=count, mu=mu, nu=nu)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> ScaleByAdam:
    """optax's name for the transform."""
    return ScaleByAdam(b1, b2, eps)
