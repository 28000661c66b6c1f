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

A pack of k trials (``ops/train.py PackedTrainLoop``) keeps one step
count per member: members admitted mid-pack sit at other steps than
their pack-mates. There ``count`` is a tuple of k ints, each leaf is
stacked along a leading trial axis, and the bias corrections are a
vector of k float32 values, computed on the host as for one trial and
broadcast over the leading axis. Every other operand is the serial
one, and a division by a broadcast float32 value is the division by
that scalar, so a member's update equals its serial update bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


@dataclass
class ScaleByAdamState:
    #: An int for one trial; a tuple of k ints for a pack.
    count: Union[int, Tuple[int, ...]]
    mu: Optional[List[torch.Tensor]]
    nu: Optional[List[torch.Tensor]]


_COUNT_MAX = int(np.iinfo(np.int32).max)


def member_vector(values: Sequence[float], like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The k float32 ``values`` on the device of ``like``'s stacked
    leaves, as one ``(k, 1, ...)`` view per leaf to broadcast over it.
    To a card the copy goes from pinned memory without waiting, so no
    step waits for the device."""
    t = torch.tensor(values, dtype=torch.float32)
    device = like[0].device
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return [t.view((len(values),) + (1,) * (leaf.dim() - 1)) for leaf in like]


class ScaleByAdam:
    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]) -> ScaleByAdamState:
        return ScaleByAdamState(count=0, mu=None, nu=None)

    @staticmethod
    def _bias_correction(beta: float, count: int) -> float:
        """``1 - beta^count`` in float32, as optax computes it."""
        return float(np.float32(1.0) - np.float32(beta) ** np.float32(count))

    def update(self, grads: Sequence[torch.Tensor], state: ScaleByAdamState
               ) -> Tuple[List[torch.Tensor], ScaleByAdamState]:
        """The updates for ``grads``; the moments are updated in place.

        With an int ``count``, one trial. With a tuple of k counts, a
        pack: ``grads``, the moments and the updates are stacked leaves,
        and each member's slice gets its own bias corrections."""
        grads = list(grads)
        if state.mu is None:
            mu = [torch.zeros_like(g) for g in grads]
            nu = [torch.zeros_like(g) for g in grads]
        else:
            mu, nu = state.mu, state.nu
        if isinstance(state.count, int):
            count = min(state.count + 1, _COUNT_MAX)
            bc1 = self._bias_correction(self.b1, count)
            bc2 = self._bias_correction(self.b2, count)
        else:
            count = tuple(min(c + 1, _COUNT_MAX) for c in state.count)
            bc1 = member_vector([self._bias_correction(self.b1, c) for c in count], grads)
            bc2 = member_vector([self._bias_correction(self.b2, c) for c in count], grads)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, sq)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, bc1)
        torch._foreach_div_(updates, denom)
        return updates, ScaleByAdamState(count=count, mu=mu, nu=nu)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> ScaleByAdam:
    """optax's name for the transform."""
    return ScaleByAdam(b1, b2, eps)
