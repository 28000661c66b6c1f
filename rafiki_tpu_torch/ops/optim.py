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
ops: one launch per operation over all leaves, not one per leaf.

The per-step scalars (the bias corrections ``1 - b^count``, and the
schedule's value for ``adam``) are computed on the host in float32 from
the step count, which lives there, by :meth:`ScaleByAdam.step_scalars`,
and the update reads them from a device tensor (``scalars``): the train
step uploads a whole epoch's table of them at once, so a step reads no
host number and a captured CUDA graph of it (``ops/graphs.py``) serves
every step and every trial. A division by a host scalar and one by a
device tensor need not round alike on the card, so the eager step and
the captured one take the same device tensor. The update leaves the
count to its caller's bookkeeping: it returns the state advanced by
one, and :meth:`ScaleByAdam.advance` moves it by a whole epoch.

The moments are allocated at the first update, as zeros: a loop that
only serves holds no optimizer state, and the first update is the
same as from optax's zero-initialised state. (A captured step comes
after eager warm-up steps, so its moments exist.)

A pack of k trials (``ops/train.py PackedTrainLoop``) keeps one step
count per member: members admitted mid-pack sit at other steps than
their pack-mates. There ``count`` is a tuple of k ints, each leaf is
stacked along a leading trial axis and ``scalars`` has one row per
member. The moments update on the stacked leaves (elementwise products
and sums, the same on every slice); the bias-corrected quotient runs
once per member on its slices, with the serial ops and the member's
own scalars, so a member's update is its serial update bit for bit.

``adam`` and ``linear_schedule`` are optax's complete optimizer and
schedule, for templates that override ``make_optimizer``: the update is
the core's, scaled by ``-schedule(count)``. A pack of such a template
keeps both counts per member, and scales member i's updates by its own
``-schedule(count_i)``, as its serial trial does.

:func:`member_opt_state` and :func:`map_members` read one member's
serial-shaped state out of a pack's, and change a pack's members,
whichever of the two optimizers it holds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


@dataclass
class ScaleByAdamState:
    #: An int for one trial; a tuple of k ints for a pack.
    count: Union[int, Tuple[int, ...]]
    mu: Optional[List[torch.Tensor]]
    nu: Optional[List[torch.Tensor]]


_COUNT_MAX = int(np.iinfo(np.int32).max)


class ScaleByAdam:
    #: The per-step scalars ``update`` reads, in column order.
    scalar_names = ("bias_correction1", "bias_correction2")

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]) -> ScaleByAdamState:
        return ScaleByAdamState(count=0, mu=None, nu=None)

    def init_packed(self, k: int) -> ScaleByAdamState:
        """A fresh pack's state: k counts at 0, no moments yet."""
        return ScaleByAdamState(count=(0,) * k, mu=None, nu=None)

    @staticmethod
    def _bias_correction(beta: float, count: int) -> float:
        """``1 - beta^count`` in float32, as optax computes it."""
        return float(np.float32(1.0) - np.float32(beta) ** np.float32(count))

    def _member_scalars(self, count: int, n: int) -> np.ndarray:
        rows = []
        for t in range(n):
            c = min(count + 1 + t, _COUNT_MAX)
            rows.append((self._bias_correction(self.b1, c), self._bias_correction(self.b2, c)))
        return np.asarray(rows, np.float32).reshape(n, len(self.scalar_names))

    def step_scalars(self, state: ScaleByAdamState, n: int) -> np.ndarray:
        """The float32 scalars of the ``n`` updates after ``state``, one
        row per update: ``(n, 2)`` for one trial, ``(n, k, 2)`` for a
        pack (each member from its own count)."""
        if isinstance(state.count, int):
            return self._member_scalars(state.count, n)
        return np.stack([self._member_scalars(c, n) for c in state.count], axis=1)

    def advance(self, state: ScaleByAdamState, n: int) -> ScaleByAdamState:
        """``state`` with its count(s) moved on by ``n`` updates."""
        if isinstance(state.count, int):
            count = min(state.count + n, _COUNT_MAX)
        else:
            count = tuple(min(c + n, _COUNT_MAX) for c in state.count)
        return ScaleByAdamState(count=count, mu=state.mu, nu=state.nu)

    def update(self, grads: Sequence[torch.Tensor], state: ScaleByAdamState,
               scalars: Optional[torch.Tensor] = None) -> Tuple[list, ScaleByAdamState]:
        """The updates for ``grads``; the moments are updated in place.

        ``scalars`` is this update's row of :meth:`step_scalars` on the
        grads' device (``(2,)``, or ``(k, 2)`` for a pack); without it the
        row is computed from the count and uploaded, so a caller that
        steps one update at a time gets the same arithmetic.

        With an int ``count``, one trial: a list of updates. With a tuple
        of k counts, a pack: ``grads`` and the moments are stacked leaves,
        and the updates are k lists, member i's computed from its own
        slices of the moments by the serial ops, so they are its serial
        updates bit for bit on every device."""
        grads = list(grads)
        if scalars is None:
            scalars = torch.from_numpy(self.step_scalars(state, 1)[0]).to(grads[0].device)
        if state.mu is None:
            mu = [torch.zeros_like(g) for g in grads]
            nu = [torch.zeros_like(g) for g in grads]
        else:
            mu, nu = state.mu, state.nu
        # The moments are elementwise products and sums: the same on a
        # stacked leaf as on each member's slice.
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, sq)
        new = self.advance(ScaleByAdamState(count=state.count, mu=mu, nu=nu), 1)
        if isinstance(state.count, int):
            return self._scale(mu, nu, scalars), new
        updates = [self._scale([m[i] for m in mu], [v[i] for v in nu], scalars[i])
                   for i in range(len(state.count))]
        return updates, new

    def _scale(self, mu: List[torch.Tensor], nu: List[torch.Tensor],
               scalars: torch.Tensor) -> List[torch.Tensor]:
        """``(mu / bc1) / (sqrt(nu / bc2) + eps)`` for one trial, the bias
        corrections read from ``scalars``."""
        denom = torch._foreach_div(nu, scalars[1])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, scalars[0])
        torch._foreach_div_(updates, denom)
        return updates


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> ScaleByAdam:
    """optax's name for the transform."""
    return ScaleByAdam(b1, b2, eps)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``: ``count -> (init - end) * (1 - c / T) +
    end`` with ``c = clip(count, 0, T)``, in float32 as optax computes
    it; a constant ``init_value`` when ``T <= 0``."""
    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return float(np.float32(init_value))
        c = np.float32(min(max(int(count), 0), transition_steps))
        frac = np.float32(1.0) - c / np.float32(transition_steps)
        return float(np.float32(init_value - end_value) * frac + np.float32(end_value))
    return schedule


@dataclass
class AdamState:
    """``optax.adam``'s state: the core's, and ``scale_by_schedule``'s
    count (the updates made before this one)."""
    adam: ScaleByAdamState
    count: int


class Adam:
    """``optax.adam(learning_rate)``, a complete optimizer: the lr-free
    core, then ``-learning_rate(count)`` with ``count`` the number of
    earlier updates (optax's ``scale_by_schedule``). A train step whose
    hyper dict has no ``lr`` applies its updates as they are. In a pack
    ``count`` is a tuple of k ints, as the core's. The schedule's value
    is the third per-step scalar, after the core's two."""

    scalar_names = ScaleByAdam.scalar_names + ("neg_schedule",)

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.core = ScaleByAdam(b1, b2, eps)
        self.schedule = (learning_rate if callable(learning_rate)
                         else (lambda count: float(np.float32(learning_rate))))

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(adam=self.core.init(params), count=0)

    def init_packed(self, k: int) -> AdamState:
        return AdamState(adam=self.core.init_packed(k), count=(0,) * k)

    def _neg_schedule(self, count: int, n: int) -> np.ndarray:
        return np.asarray([-self.schedule(min(count + t, _COUNT_MAX)) for t in range(n)],
                          np.float32)

    def step_scalars(self, state: AdamState, n: int) -> np.ndarray:
        """``(n, 3)`` float32: the core's bias corrections and
        ``-schedule(count)`` of each of the next ``n`` updates; ``(n, k,
        3)`` for a pack, each member from its own counts."""
        if isinstance(state.count, int):
            neg = self._neg_schedule(state.count, n)[:, None]
        else:
            neg = np.stack([self._neg_schedule(c, n) for c in state.count], axis=1)[..., None]
        return np.concatenate([self.core.step_scalars(state.adam, n), neg], axis=-1)

    def advance(self, state: AdamState, n: int) -> AdamState:
        if isinstance(state.count, int):
            count = min(state.count + n, _COUNT_MAX)
        else:
            count = tuple(min(c + n, _COUNT_MAX) for c in state.count)
        return AdamState(adam=self.core.advance(state.adam, n), count=count)

    def update(self, grads: Sequence[torch.Tensor], state: AdamState,
               scalars: Optional[torch.Tensor] = None) -> Tuple[list, AdamState]:
        """The core's updates scaled by ``-schedule(count)``: one list for
        one trial, k lists for a pack (``scalars`` ``(k, 3)``), member i's
        by its own row."""
        grads = list(grads)
        if scalars is None:
            scalars = torch.from_numpy(self.step_scalars(state, 1)[0]).to(grads[0].device)
        updates, core = self.core.update(grads, state.adam, scalars[..., :2])
        if isinstance(state.count, int):
            torch._foreach_mul_(updates, scalars[2])
        else:
            for i, member in enumerate(updates):
                torch._foreach_mul_(member, scalars[i, 2])
        count = (min(state.count + 1, _COUNT_MAX) if isinstance(state.count, int)
                 else tuple(min(c + 1, _COUNT_MAX) for c in state.count))
        return updates, AdamState(adam=core, count=count)


def adam(learning_rate: Union[float, Callable[[int], float]], b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> Adam:
    """optax's name for the complete optimizer."""
    return Adam(learning_rate, b1, b2, eps)


OptState = Union[ScaleByAdamState, AdamState]


def member_opt_state(state: OptState, i: int,
                     take: Callable[[torch.Tensor], torch.Tensor] = lambda t: t) -> OptState:
    """Member ``i``'s serial-shaped state out of a pack's: its counts and
    ``take`` of its slices of the moments (``take`` may copy them)."""
    if isinstance(state, AdamState):
        return AdamState(adam=member_opt_state(state.adam, i, take), count=state.count[i])
    if state.mu is None:
        return ScaleByAdamState(count=state.count[i], mu=None, nu=None)
    return ScaleByAdamState(count=state.count[i], mu=[take(m[i]) for m in state.mu],
                            nu=[take(v[i]) for v in state.nu])


def map_members(state: OptState, leaf: Callable[[torch.Tensor], torch.Tensor],
                counts: Callable[[tuple], tuple]) -> OptState:
    """A pack's state with each stacked moment through ``leaf`` and each
    tuple of member counts through ``counts`` (to drop or add members)."""
    if isinstance(state, AdamState):
        return AdamState(adam=map_members(state.adam, leaf, counts), count=counts(state.count))
    return ScaleByAdamState(count=counts(state.count),
                            mu=None if state.mu is None else [leaf(m) for m in state.mu],
                            nu=None if state.nu is None else [leaf(v) for v in state.nu])
