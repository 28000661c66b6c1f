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
"""

from __future__ import annotations

import torch
from torch import nn


class GroupNorm(nn.Module):
    """GroupNorm over NC... input with flax's numerics. ``weight`` is
    flax's ``scale``."""

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
        n, c = x.shape[0], x.shape[1]
        spatial = x.shape[2:]
        g = self.num_groups
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
        inv_c = torch.rsqrt(var + self.eps).expand((n, g, c // g) + ones).reshape((n, c) + ones)
        mul = inv_c * self.weight.reshape((1, c) + ones)
        y = (xf - mean_c) * mul + self.bias.reshape((1, c) + ones)
        return y.to(self.dtype)

    def extra_repr(self) -> str:
        return f"{self.num_groups}, {self.num_channels}, eps={self.eps}, dtype={self.dtype}"
