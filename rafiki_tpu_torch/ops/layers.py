"""Layers whose numerics follow flax's, for the port's models.

``GroupNorm`` is the counterpart of ``flax.linen.GroupNorm`` as the
JAX package's VGG uses it (``nn.GroupNorm(num_groups=gcd(8, ch),
dtype=bfloat16)``). ``torch.nn.functional.group_norm`` differs in three
ways that matter for parity: its variance algorithm, its eps default
(1e-5 against flax's 1e-6) and its dtype handling. So this is written
from plain tensor ops, which also vmap cleanly over stacked params:

  * statistics in float32 whatever the compute dtype, with flax's fast
    variance ``max(0, E[x^2] - E[x]^2)``;
  * ``(x_f32 - mean) * (rsqrt(var + eps) * scale) + bias`` in float32,
    in that order, then a cast back to the compute dtype;
  * ``scale`` and ``bias`` are float32 parameters.

``conv2d`` is the models' convolution. It is ``F.conv2d``, except when
its weight is stacked under ``torch.func.vmap`` (the stacked serving
forward, ``parallel/ensemble.py``, and a pack's train step,
``ops/train.py PackedProgram``): there it runs once per member instead
of as the one grouped conv vmap would lower it to, which sums in
another order, so the stacked forward bit-matches the serial ones.
The unwrapped convs record their backward under the pack's outer
autograd like any op on the vmapped tensors underneath. ``linear`` does
the same for the dense layers, whose vmapped form adds the bias after
a rounded matmul, and ``GroupNorm`` where autograd records a pack's
step (its class doc says why).
"""

from __future__ import annotations

import torch
import torch._C._functorch as _functorch
import torch.nn.functional as F
from torch import nn

# The per-member layers use functorch's private C API, as torch.func.vmap
# does at its own boundary. Fail at import, not mid-forward, if a torch
# release moves any of it.
_FUNCTORCH_API = ("is_batchedtensor", "maybe_get_level", "_unwrap_batched", "_add_batch_dim")
_missing = [n for n in _FUNCTORCH_API if not hasattr(_functorch, n)]
if _missing:
    raise ImportError(f"torch {torch.__version__} has no torch._C._functorch."
                      f"{', '.join(_missing)}, which ops.layers needs")


def _per_member(op, weight: torch.Tensor, *operands: torch.Tensor) -> torch.Tensor:
    """``op`` once per member of a vmapped call whose ``weight`` is
    stacked, on operands unwrapped at the vmap level (as
    ``torch.func.vmap`` itself does at its boundary; an operand not
    batched is shared), with the k results stacked and wrapped back, so
    no batching rule runs. A custom ``autograd.Function`` vmap rule did
    the same at several times the host cost per call. unbind, not k
    selects: under autograd (a pack's train step) the backward of one
    unbind is one stack of the k member gradients, where k selects would
    each scatter into a zero tensor of all k."""
    level = _functorch.maybe_get_level(weight)
    w, w_dim = _functorch._unwrap_batched(weight, level)
    ws = w.unbind(w_dim)
    slices = []
    for t in operands:
        t, dim = _functorch._unwrap_batched(t, level)
        slices.append([t] * len(ws) if dim is None else t.unbind(dim))
    outs = [op(wi, *ts) for wi, *ts in zip(ws, *slices)]
    if outs[0].is_contiguous(memory_format=torch.channels_last) and not outs[0].is_contiguous():
        # Stacked as (k, N, H, W, C), so each member stays channels-last
        # and the next layer sees the strides the serial forward sees.
        stacked = torch.stack([o.permute(0, 2, 3, 1) for o in outs]).permute(0, 1, 4, 2, 3)
    else:
        stacked = torch.stack(outs)
    return _functorch._add_batch_dim(stacked, 0, level)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``F.linear``; once per member when ``weight`` is stacked under
    vmap. There vmap would run a batched matmul and then add the bias,
    rounding twice in bf16, where the serial ``addmm`` adds the bias in
    its float32 accumulator and rounds once."""
    if _functorch.is_batchedtensor(weight):
        return _per_member(lambda w, xi, b: F.linear(xi, w, b), weight, x, bias)
    return F.linear(x, weight, bias)


def conv2d(x: torch.Tensor, weight: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """Bias-free 2-D convolution (``F.conv2d``); once per member when
    ``weight`` is stacked under vmap."""
    if _functorch.is_batchedtensor(weight):
        return _per_member(lambda w, xi: F.conv2d(xi, w, None, padding=padding), weight, x)
    return F.conv2d(x, weight, None, padding=padding)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
               eps: float, dtype: torch.dtype) -> torch.Tensor:
    """GroupNorm of an NC... tensor with flax's numerics (module doc)."""
    n, c = x.shape[0], x.shape[1]
    spatial = x.shape[2:]
    g = num_groups
    ones = (1,) * len(spatial)
    xf = x.float()
    # Reduce over a contiguous copy: torch's CPU reduction order
    # follows the memory layout, which differs between a channels-last
    # activation and the same activation batched under vmap.
    grouped = xf.contiguous().reshape((n, g, c // g) + tuple(spatial))
    axes = tuple(range(2, grouped.dim()))
    mean = grouped.mean(axes, keepdim=True)
    mean2 = (grouped * grouped).mean(axes, keepdim=True)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    # Per-group stats repeated to per-channel, as flax's jnp.repeat.
    mean_c = mean.expand((n, g, c // g) + ones).reshape((n, c) + ones)
    inv_c = torch.rsqrt(var + eps).expand((n, g, c // g) + ones).reshape((n, c) + ones)
    mul = inv_c * weight.reshape((1, c) + ones)
    y = (xf - mean_c) * mul + bias.reshape((1, c) + ones)
    return y.to(dtype)


class GroupNorm(nn.Module):
    """GroupNorm over NC... input with flax's numerics. ``weight`` is
    flax's ``scale``.

    Where autograd records a pack's step (the ``weight`` stacked under
    vmap, grad enabled), it runs once per member: the backward of the
    vmapped form reduces the affine and statistic gradients over
    ``(k, N, ...)`` shapes, which the card's reduction kernels split in
    another order than the serial ``(N, ...)`` ones. Without grad (the
    stacked serving forward, a pack's eval) the vmapped form stands:
    its forward values are the serial ones."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(
                f"Number of groups ({num_groups}) does not divide the number "
                f"of channels ({num_channels}).")
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def norm(w, xi, b):
            return group_norm(xi, w, b, self.num_groups, self.eps, self.dtype)

        if torch.is_grad_enabled() and _functorch.is_batchedtensor(self.weight):
            return _per_member(norm, self.weight, x, self.bias)
        return norm(self.weight, x, self.bias)

    def extra_repr(self) -> str:
        return f"{self.num_groups}, {self.num_channels}, eps={self.eps}, dtype={self.dtype}"
