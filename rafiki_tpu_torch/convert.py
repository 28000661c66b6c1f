"""Weight carrier between the JAX package's params and the port's modules.

The JAX package's params, flattened the way ``utils/serial.py`` stores
them, are a dict ``{"Conv_0/kernel": array, "GroupNorm_0/scale": ...,
"_DenseLayer_3/Conv_1/kernel": ..., "pos_embed": ...}``. flax names a
submodule after its class and a counter per class in call order, and
restarts the counters inside each scope (a submodule that has
submodules of its own). The port's modules register their layers in
call order, so walking them in registration order and counting per
type recovers the flax names:
  * a layer (``nn.Conv2d``, ``GroupNorm``, ``nn.Linear``, ``Embed``,
    ``LayerNorm``, ``SelfAttention``, ``LstmCell``) is named
    ``<Type>_<i>`` in its scope, its params under it;
  * a module with a ``flax_scope`` attribute (DenseNet's ``_DenseLayer``
    and ``_Transition``) is a scope ``<flax_scope>_<i>``, its layers
    counted afresh inside it;
  * any other module (``nn.ModuleList``, a transformer block) is no
    scope: its layers are counted in the enclosing one; the params it
    holds itself (``pos_embed``) keep their own names.

Layouts:
  * Conv kernel: flax HWIO  <-> torch OIHW ``weight``;
  * Dense kernel: flax ``(in, out)`` <-> torch ``(out, in)`` ``weight``;
  * GroupNorm and LayerNorm ``scale``/``bias`` <-> ``weight``/``bias``,
    unchanged; Embed ``embedding`` <-> ``weight``, unchanged;
  * SelfAttention ``query``/``key``/``value`` kernels ``(E, H, D)`` and
    biases ``(H, D)`` <-> ``(H * D, E)`` weights and ``(H * D,)`` biases;
    ``out`` kernel ``(H, D, E)`` <-> an ``(E, H * D)`` weight;
  * LSTMCell ``ii``/``if``/``ig``/``io`` kernels and ``hi``/``hf``/``hg``/
    ``ho`` kernels and biases, kept in flax's layout;
  * Dense ``bias`` unchanged.
The Dense after a conv stack sees an NHWC-order flatten in both
packages (the port's forward flattens NHWC), so its kernel needs no
row permutation.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rafiki_tpu_torch.ops.layers import Embed, GroupNorm, LayerNorm, LstmCell, SelfAttention

_ATTENTION = {f"{t}_{p}": f"{name}/{'kernel' if p == 'weight' else 'bias'}"
              for t, name in (("q", "query"), ("k", "key"), ("v", "value"), ("o", "out"))
              for p in ("weight", "bias")}
_LSTM = {**{f"w_i{g}": f"i{g}/kernel" for g in "ifgo"},
         **{f"w_h{g}": f"h{g}/kernel" for g in "ifgo"},
         **{f"b_h{g}": f"h{g}/bias" for g in "ifgo"}}

# torch layer type -> (flax name prefix, {torch param: flax param}).
_LAYERS = {
    nn.Conv2d: ("Conv", {"weight": "kernel", "bias": "bias"}),
    GroupNorm: ("GroupNorm", {"weight": "scale", "bias": "bias"}),
    nn.Linear: ("Dense", {"weight": "kernel", "bias": "bias"}),
    Embed: ("Embed", {"weight": "embedding"}),
    LayerNorm: ("LayerNorm", {"weight": "scale", "bias": "bias"}),
    SelfAttention: ("SelfAttention", _ATTENTION),
    LstmCell: ("LSTMCell", _LSTM),
}


def _to_flax_layout(layer: nn.Module, pname: str, t: torch.Tensor) -> torch.Tensor:
    if pname == "weight" and isinstance(layer, nn.Conv2d):
        return t.permute(2, 3, 1, 0)  # OIHW -> HWIO
    if pname == "weight" and isinstance(layer, nn.Linear):
        return t.t()
    if isinstance(layer, SelfAttention):
        h = layer.num_heads
        if pname == "o_weight":  # (E, H*D) -> (H, D, E)
            return t.t().reshape(h, -1, t.shape[0])
        if pname.endswith("_weight"):  # (H*D, E) -> (E, H, D)
            return t.t().reshape(t.shape[1], h, -1)
        if pname != "o_bias":  # (H*D,) -> (H, D)
            return t.reshape(h, -1)
    return t


def _from_flax_layout(layer: nn.Module, pname: str, t: torch.Tensor) -> torch.Tensor:
    if pname == "weight" and isinstance(layer, nn.Conv2d):
        return t.permute(3, 2, 0, 1)  # HWIO -> OIHW
    if pname == "weight" and isinstance(layer, nn.Linear):
        return t.t()
    if isinstance(layer, SelfAttention):
        if pname == "o_weight":  # (H, D, E) -> (E, H*D)
            return t.reshape(-1, t.shape[-1]).t()
        if pname.endswith("_weight"):  # (E, H, D) -> (H*D, E)
            return t.reshape(t.shape[0], -1).t()
        if pname != "o_bias":  # (H, D) -> (H*D,)
            return t.reshape(-1)
    return t


def _walk(module: nn.Module, tprefix: str, fprefix: str,
          counts: Dict[str, int]) -> Iterator[Tuple[str, str, nn.Module, str]]:
    for pname, _ in module.named_parameters(recurse=False):
        yield f"{tprefix}{pname}", f"{fprefix}{pname}", module, pname
    for cname, child in module.named_children():
        layer = _LAYERS.get(type(child))
        scope = getattr(child, "flax_scope", None)
        prefix = layer[0] if layer is not None else scope
        if prefix is None:  # no scope: its layers count in this one
            yield from _walk(child, f"{tprefix}{cname}.", fprefix, counts)
            continue
        fname = f"{fprefix}{prefix}_{counts.get(prefix, 0)}"
        counts[prefix] = counts.get(prefix, 0) + 1
        if layer is None:
            yield from _walk(child, f"{tprefix}{cname}.", f"{fname}/", {})
            continue
        for pname, _ in child.named_parameters(recurse=False):
            yield f"{tprefix}{cname}.{pname}", f"{fname}/{layer[1][pname]}", child, pname


def flax_names(module: nn.Module) -> Iterator[Tuple[str, str, nn.Module, str]]:
    """Yield ``(torch key, flax key, layer, torch param name)`` for every
    parameter of ``module`` (module doc: how the names are found)."""
    return _walk(module, "", "", {})


def state_dict_to_flax(module: nn.Module,
                       tensors: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The module's parameters as the JAX package's flat params dict
    (flax layouts, the module's dtypes and device; views where the
    layout change allows, else copies).
    With ``tensors`` (one per parameter, in ``module.parameters()``
    order, such as Adam's moments), those under the parameters' names."""
    params = dict(module.named_parameters())
    if tensors is not None:
        params = dict(zip(params, tensors))
    return {fkey: _to_flax_layout(layer, pname, params[tkey].detach())
            for tkey, fkey, layer, pname in flax_names(module)}


def flax_to_state_dict(flat: Mapping[str, object], module: nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX package's flat params dict as a ``state_dict`` for
    ``module``. Leaves are cast to each parameter's dtype (bf16-stored
    serving blobs upcast exactly to f32) and shape-checked. Raises on a
    missing or an unexpected key."""
    params = dict(module.named_parameters())
    state: Dict[str, torch.Tensor] = {}
    used = set()
    for tkey, fkey, layer, pname in flax_names(module):
        if fkey not in flat:
            raise KeyError(f"params blob lacks {fkey!r} (for {tkey!r})")
        v = flat[fkey]
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        t = _from_flax_layout(layer, pname, t).to(params[tkey].dtype).contiguous()
        if t.shape != params[tkey].shape:
            raise ValueError(
                f"{fkey!r}: shape {tuple(t.shape)} does not fit {tkey!r} "
                f"{tuple(params[tkey].shape)}")
        state[tkey] = t
        used.add(fkey)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"params blob has keys the module does not: {extra}")
    return state
