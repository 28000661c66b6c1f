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

The rest of the zoo's layers follow the same rule: each runs once per
member when any of its operands is batched under vmap
(``_member_wise``), so a pack member runs the serial op on the serial
shapes and layouts, forward and backward:

  * ``avg_pool2d``: flax's ``avg_pool`` over 2x2 windows, the window sum
    in float32 divided by 4, cast back to the input dtype;
  * ``channel_concat`` and ``spatial_mean`` (the global average pool:
    a float32 mean, cast back), DenseNet's concat and head;
  * ``Embed``: flax's ``nn.Embed`` (a lookup cast to the compute
    dtype; an id outside ``[-V, V)`` gives NaN, a negative one wraps,
    as ``jnp.take`` does);
  * ``LayerNorm``: flax's ``nn.LayerNorm()`` (float32 statistics with
    the fast variance, eps 1e-6, a float32 output whatever the input);
  * ``SelfAttention``: flax's ``nn.SelfAttention`` (``query``/``key``/
    ``value`` projections to heads, the query divided by ``sqrt(D)``
    rounded to the compute dtype, a softmax over keys, the ``out``
    projection), in the compute dtype, written from matmuls and a
    softmax: the fused attention kernels' backward is not deterministic;
  * ``LstmCell`` and ``bidirectional_lstm``: flax's ``LSTMCell`` (gates
    i, f, g, o; input kernels without bias, hidden kernels with) and
    ``Bidirectional(RNN, RNN)`` over the whole padded length, in
    float32, one step per token.
Each parameterized layer has ``flax_init(generator)``, which draws its
params from flax's default initializers (``model/base.py``).
"""

from __future__ import annotations

import math
from typing import Tuple

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
    # A copy even from float32, so the norm consumes ``x`` once: autograd
    # then adds its gradient to the other consumers' (a dense layer's
    # concat, a residual) in the same order whether the norm runs in a
    # serial step or once per member of a pack.
    xf = x.to(torch.float32, copy=True)
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


# -- the rest of the zoo's layers ----------------------------------------------


def _member_wise(op, *tensors: torch.Tensor) -> torch.Tensor:
    """``op(*tensors)``; once per member when any of them is batched
    under vmap (the others are shared), as ``_per_member`` runs it."""
    lead = next((t for t in tensors if _functorch.is_batchedtensor(t)), None)
    if lead is None:
        return op(*tensors)
    return _per_member(lambda _lead, *ts: op(*ts), lead, *tensors)


def avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, of an NCHW tensor (odd edges dropped)."""
    def pool(t: torch.Tensor) -> torch.Tensor:
        h, w = t.shape[2] // 2 * 2, t.shape[3] // 2 * 2
        f = t[:, :, :h, :w].float()
        s = f[:, :, 0::2, 0::2] + f[:, :, 0::2, 1::2] + f[:, :, 1::2, 0::2] + f[:, :, 1::2, 1::2]
        return (s / 4.0).to(t.dtype)

    return _member_wise(pool, x)


def channel_concat(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``torch.cat([x, h], 1)``: on NCHW tensors the serial cat keeps the
    channels-last layout, which a cat of batched 5-D tensors would not."""
    return _member_wise(lambda a, b: torch.cat([a, b], 1), x, h)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the H and W axes of NCHW ``x``, in float32, cast back."""
    return _member_wise(lambda t: t.float().mean((2, 3)).to(t.dtype), x)


def _trunc_normal_fan_in(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated at two standard
    deviations, rescaled so the variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def embed(ids: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows of ``weight`` for integer ``ids``, cast to ``dtype``."""
    def lookup(w: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        v = w.shape[0]
        i = i.long()
        inside = (i >= -v) & (i < v)
        rows = F.embedding(torch.where(inside, torch.remainder(i, v), 0), w).to(dtype)
        return torch.where(inside[..., None], rows, torch.full_like(rows, float("nan")))

    return _member_wise(lookup, weight, ids)


class Embed(nn.Module):
    """flax's ``nn.Embed(num_embeddings, features, dtype)``; ``weight`` is
    its ``embedding``, drawn from a normal of variance ``1 / features``."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embed(ids, self.weight, self.dtype)

    def flax_init(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, std=math.sqrt(1.0 / self.weight.shape[1]),
                        generator=generator)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with flax's numerics; float32 out."""
    def norm(w: torch.Tensor, t: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        tf = t.to(torch.float32, copy=True)  # one consumer of ``t`` (group_norm says why)
        mean = tf.mean(-1, keepdim=True)
        mean2 = (tf * tf).mean(-1, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        return (tf - mean) * (torch.rsqrt(var + eps) * w) + b

    return _member_wise(norm, weight, x, bias)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm()``: ``weight`` is its ``scale``."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)

    def flax_init(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dot-product attention over ``(B, L, H, D)`` heads, the query
    already scaled; everything in the inputs' dtype."""
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class SelfAttention(nn.Module):
    """flax's ``nn.SelfAttention(num_heads, dtype)`` with its default
    features: ``(B, L, E)`` in the compute dtype to ``(B, L, E)``. The
    projections are ``(H * D, E)`` weights (flax: ``(E, H, D)`` kernels)
    and ``out`` an ``(E, H * D)`` one (flax: ``(H, D, E)``)."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"Memory dimension ({embed_dim}) must be divisible by number "
                             f"of heads ({num_heads}).")
        self.num_heads, self.dtype = num_heads, dtype
        for name in ("q", "k", "v", "o"):
            self.register_parameter(f"{name}_weight", nn.Parameter(torch.zeros(embed_dim, embed_dim)))
            self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(embed_dim)))

    def _proj(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return linear(x, getattr(self, f"{name}_weight").to(self.dtype),
                      getattr(self, f"{name}_bias").to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        heads = (self.num_heads, x.shape[-1] // self.num_heads)
        # flax divides by sqrt(D) cast to the compute dtype.
        root = float(torch.tensor(math.sqrt(heads[1]), dtype=self.dtype))
        q = self._proj(x, "q").unflatten(-1, heads) / root
        k = self._proj(x, "k").unflatten(-1, heads)
        v = self._proj(x, "v").unflatten(-1, heads)
        out = _member_wise(_attend, q, k, v)
        return self._proj(out.flatten(-2), "o")

    def flax_init(self, generator: torch.Generator) -> None:
        for name in ("q", "k", "v", "o"):
            w = getattr(self, f"{name}_weight")
            _trunc_normal_fan_in(w, w.shape[1], generator)
            getattr(self, f"{name}_bias").zero_()


_GATES = ("i", "f", "g", "o")


class LstmCell(nn.Module):
    """flax's ``nn.LSTMCell(hidden)`` with its own params: ``w_i<gate>``
    the input kernels ``(in, hidden)`` (no bias), ``w_h<gate>`` the
    hidden kernels ``(hidden, hidden)`` and ``b_h<gate>`` their biases,
    for the gates i, f, g, o, in flax's layout. It computes in float32
    (flax's cells get no dtype)."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in _GATES:
            self.register_parameter(f"w_i{g}", nn.Parameter(torch.zeros(in_features, hidden)))
        for g in _GATES:
            self.register_parameter(f"w_h{g}", nn.Parameter(torch.zeros(hidden, hidden)))
            self.register_parameter(f"b_h{g}", nn.Parameter(torch.zeros(hidden)))

    def kernels(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(in, 4h)`` input and ``(h, 4h)`` hidden kernels and the ``(4h,)``
        bias, the gates side by side in the order i, f, g, o."""
        cat = lambda p: torch.cat([getattr(self, f"{p}{g}") for g in _GATES], -1)  # noqa: E731
        return cat("w_i"), cat("w_h"), cat("b_h")

    def flax_init(self, generator: torch.Generator) -> None:
        for g in _GATES:
            w = getattr(self, f"w_i{g}")
            _trunc_normal_fan_in(w, w.shape[0], generator)
            nn.init.orthogonal_(getattr(self, f"w_h{g}"), generator=generator)
            getattr(self, f"b_h{g}").zero_()


def _lstm_scan(x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
               reverse: bool) -> torch.Tensor:
    """One direction over ``(B, L, in)`` float32 ``x`` from zero carries;
    ``(B, L, h)`` outputs in input order."""
    n, length = x.shape[0], x.shape[1]
    hidden = wh.shape[0]
    xi = torch.matmul(x, wi)  # every step's input projection at once
    h = x.new_zeros((n, hidden))
    c = x.new_zeros((n, hidden))
    outs = [None] * length
    for t in (range(length - 1, -1, -1) if reverse else range(length)):
        z = xi[:, t] + torch.addmm(b, h, wh)
        i, f, g, o = z.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs[t] = h
    return torch.stack(outs, 1)


def bidirectional_lstm(x: torch.Tensor, forward: LstmCell, backward: LstmCell) -> torch.Tensor:
    """flax's ``Bidirectional(RNN(forward), RNN(backward))`` over every
    position of ``(B, L, in)`` ``x`` (no sequence lengths: the backward
    pass starts at the padded end), in float32: ``(B, L, 2h)``,
    ``[forward, backward]`` on the last axis."""
    def run(t: torch.Tensor, *kernels: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return torch.cat([_lstm_scan(t, *kernels[:3], reverse=False),
                          _lstm_scan(t, *kernels[3:], reverse=True)], -1)

    return _member_wise(run, x, *forward.kernels(), *backward.kernels())
