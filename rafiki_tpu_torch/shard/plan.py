"""Group-width planning for sharded trials.

The port's own copy of ``rafiki_tpu/shard/plan.py``: ``shard_axis``,
``solve_width``, ``ShardPlan``, ``state_bytes``, ``estimate_hbm_bytes``,
``group_mesh`` and the three env knobs (``RAFIKI_SHARD_HBM_CEILING``,
``RAFIKI_SHARD_MAX_WIDTH``, ``RAFIKI_SHARD_WIDTH``).

The sweep's packing lane answers "how many small trials fit one chip";
this module answers the inverse question: "how many chips does one big
trial need". A :class:`ShardPlan` turns a trial's train state (its
leaves' shapes) plus a device-memory estimate into

  * the smallest group **width** whose per-chip share of the state fits
    under the ceiling (``RAFIKI_SHARD_HBM_CEILING`` of one chip's
    memory, 0.9 by default), and
  * per-leaf placement over a 1-D ``("shard",)`` group axis: each leaf
    is split along its largest width-divisible axis, small or
    indivisible leaves replicate.

**The per-chip memory is the device's own**: on the card,
``torch.cuda.get_device_properties(dev).total_memory``. The JAX package
imports a TPU figure for it; here no TPU figure is a default. On the
CPU there is no per-chip figure: ``solve_width`` needs the caller to
name one (``per_chip_bytes=``), and a plan without one keeps the pinned
width (``RAFIKI_SHARD_WIDTH``) or width 1. The plan keeps its figure.

Placement is *shape-deterministic*: the axis chosen for a leaf is a pure
function of (shape, width). Reshard-on-restore (``shard/checkpoint.py``)
leans on this: a checkpoint written at width w records each leaf's
saved axis in its manifest, and a restore at width w' recomputes its
own placement from the same rule. Every leaf is planned in the JAX
package's layout and under its name (``convert.py``: flax's HWIO conv
and ``(in, out)`` dense kernels), so a width-w manifest has the same
leaves, shapes, axes and chunks in both packages.

The memory estimate is 4x the raw parameter bytes (params, grads and
Adam's two moments) unless the caller has a measured peak.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple

ENV_HBM_CEILING = "RAFIKI_SHARD_HBM_CEILING"
ENV_MAX_WIDTH = "RAFIKI_SHARD_MAX_WIDTH"
ENV_FORCE_WIDTH = "RAFIKI_SHARD_WIDTH"


def hbm_ceiling() -> float:
    return float(os.environ.get(ENV_HBM_CEILING, "0.9"))


def max_width() -> int:
    return int(os.environ.get(ENV_MAX_WIDTH, "8"))


def forced_width() -> int:
    """``RAFIKI_SHARD_WIDTH`` > 0 pins the group width (tests, chaos
    scenarios, smokes, where no real model trips the ceiling); 0 (the
    default) solves it from the memory estimate."""
    return int(os.environ.get(ENV_FORCE_WIDTH, "0"))


def device_memory_bytes(device: Any = None) -> int:
    """One chip's memory: the card's own total. Raises on the CPU, which
    has no such figure: a CPU caller names it (``per_chip_bytes``)."""
    import torch

    from rafiki_tpu_torch.utils.backend import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"no per-chip memory figure for a {dev.type} device; "
                         "pass per_chip_bytes")
    return int(torch.cuda.get_device_properties(dev).total_memory)


def shard_axis(shape: Tuple[int, ...], width: int) -> Optional[int]:
    """The axis of ``shape`` a width-``width`` group shards, or None to
    replicate. Deterministic: the largest axis whose dim is divisible
    by (and at least) the width; ties go to the earliest axis."""
    if width <= 1:
        return None
    best = None
    for a, d in enumerate(shape):
        if d % width == 0 and d >= width and d > 1:
            if best is None or d > shape[best]:
                best = a
    return best


def _leaf_shapes(tree: Any) -> Iterable[Tuple[Tuple[int, ...], int]]:
    """(shape, itemsize) of every leaf of ``tree``: a module (its
    parameters, on any device, ``meta`` included), a mapping of tensors
    or arrays, or a sequence of them."""
    import numpy as np
    import torch

    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    elif isinstance(tree, Mapping):
        tree = list(tree.values())
    for leaf in tree:
        if isinstance(leaf, torch.Tensor):
            yield tuple(leaf.shape), leaf.element_size()
        else:
            arr = np.asarray(leaf)
            yield tuple(arr.shape), arr.dtype.itemsize


def state_bytes(tree: Any) -> int:
    """Raw bytes of every leaf of ``tree`` (shapes only: parameters on
    the ``meta`` device count as live ones)."""
    total = 0
    for shape, itemsize in _leaf_shapes(tree):
        n = 1
        for d in shape:
            n *= int(d)
        total += n * itemsize
    return total


def estimate_hbm_bytes(params: Any, peak_hbm_bytes: Optional[float] = None) -> int:
    """Device-memory residency estimate for one trial: a measured peak
    when the caller has one, else 4x param bytes (params + grads + Adam's
    mu and nu)."""
    if peak_hbm_bytes:
        return int(peak_hbm_bytes)
    return 4 * state_bytes(params)


def solve_width(hbm_bytes: int, ceiling: Optional[float] = None, cap: Optional[int] = None,
                per_chip_bytes: Optional[float] = None) -> int:
    """Smallest power-of-two group width whose per-chip share of
    ``hbm_bytes`` fits under the ceiling of ``per_chip_bytes`` (default:
    the card's own memory). ``RAFIKI_SHARD_WIDTH`` overrides (a pinned
    width); the solve clamps at ``RAFIKI_SHARD_MAX_WIDTH``."""
    forced = forced_width()
    if forced > 0:
        return forced
    ceiling = hbm_ceiling() if ceiling is None else ceiling
    cap = max_width() if cap is None else cap
    budget = ceiling * (device_memory_bytes() if per_chip_bytes is None else per_chip_bytes)
    width = 1
    while width < cap and hbm_bytes / width > budget:
        width *= 2
    return width


@dataclass(frozen=True)
class ShardPlan:
    """One trial's group placement: width + per-leaf partitioning rule.
    Frozen and cheap: a plan is derived data (shapes and an estimate),
    journaled once per group as ``shard/plan``. ``per_chip_bytes`` is the
    memory of one chip the plan was solved against (0: not known)."""

    width: int
    hbm_bytes: int = 0
    family: str = ""
    per_chip_bytes: int = 0

    @classmethod
    def for_params(cls, params: Any, family: str = "",
                   peak_hbm_bytes: Optional[float] = None,
                   width: Optional[int] = None,
                   per_chip_bytes: Optional[float] = None,
                   device: Any = None) -> "ShardPlan":
        """The plan of a trial whose parameters are ``params`` (shapes
        only). ``per_chip_bytes`` None takes ``device``'s memory on the
        card; the CPU has no per-chip figure, so there, unless the caller
        names one, the width is the pin (``RAFIKI_SHARD_WIDTH``) or 1."""
        hbm = estimate_hbm_bytes(params, peak_hbm_bytes)
        if per_chip_bytes is None:
            from rafiki_tpu_torch.utils.backend import resolve_device

            dev = resolve_device(device)
            per_chip_bytes = device_memory_bytes(dev) if dev.type == "cuda" else 0
        if not width:
            width = (solve_width(hbm, per_chip_bytes=per_chip_bytes) if per_chip_bytes
                     else (forced_width() or 1))
        return cls(width=int(width), hbm_bytes=hbm, family=family,
                   per_chip_bytes=int(per_chip_bytes))

    def hbm_frac(self) -> float:
        """Estimated per-chip memory fraction at this plan's width."""
        if not self.hbm_bytes or not self.per_chip_bytes:
            return 0.0
        return self.hbm_bytes / self.width / self.per_chip_bytes

    def axis_of(self, shape: Tuple[int, ...]) -> Optional[int]:
        return shard_axis(tuple(shape), self.width)

    def axes_map(self, shapes: Mapping[str, Sequence[int]]) -> Dict[str, Optional[int]]:
        """Flat leaf name -> shard axis (or None) for ``{name: shape}``."""
        return {k: self.axis_of(tuple(v)) for k, v in shapes.items()}

    def note(self) -> None:
        """Journal the plan (``shard/plan``) and publish the headroom
        gauge."""
        from rafiki_tpu_torch import telemetry
        from rafiki_tpu_torch.obs.journal import journal

        telemetry.set_gauge("shard.hbm_frac", self.hbm_frac())
        journal.record("shard", "plan", family=self.family, width=int(self.width),
                       hbm_bytes=int(self.hbm_bytes), hbm_frac=self.hbm_frac())


@dataclass(frozen=True)
class GroupMesh:
    """A 1-D ``("shard",)`` group over its members' devices, one entry
    per member (several members may share one device)."""

    devices: Tuple[Any, ...]
    axis_names = ("shard",)

    @property
    def width(self) -> int:
        return len(self.devices)

    def cache_key(self) -> Tuple:
        """The group's part of a program key."""
        return (self.axis_names, self.width, tuple(str(d) for d in self.devices))


def group_mesh(devices) -> GroupMesh:
    """The ``("shard",)`` group over ``devices`` (torch devices)."""
    import torch

    return GroupMesh(tuple(torch.device(d) for d in devices))
