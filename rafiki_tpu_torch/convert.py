"""Weight carrier between the JAX package's params and the port's modules.

The JAX package's params, flattened the way ``utils/serial.py`` stores
them, are a dict ``{"Conv_0/kernel": array, "GroupNorm_0/scale": ...,
"Dense_1/bias": ...}``. flax auto-names layers per layer TYPE in call
order (``Conv_i``, ``GroupNorm_i``, ``Dense_i``), not per block. The
port's modules register their layers in call order too, so counting
``nn.Conv2d`` / ``GroupNorm`` / ``nn.Linear`` submodules per type over
``named_modules()`` recovers the flax names.

Layouts:
  * Conv kernel: flax HWIO  <-> torch OIHW ``weight``;
  * Dense kernel: flax ``(in, out)`` <-> torch ``(out, in)`` ``weight``;
  * GroupNorm ``scale``/``bias`` <-> ``weight``/``bias``, unchanged;
  * Dense ``bias`` unchanged.
The Dense after the conv stack sees an NHWC-order flatten in both
packages (the port's forward flattens NHWC), so its kernel needs no
row permutation.

Trees carried: ``Vgg`` (``Conv_i``, ``GroupNorm_i``, ``Dense_0..1``)
and ``FeedForward`` (``Dense_0..hidden_layers``, its Linear layers in
call order).
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rafiki_tpu_torch.ops.layers import GroupNorm

# torch layer type -> (flax name prefix, {torch param: flax param}).
_LAYERS = (
    (nn.Conv2d, "Conv", {"weight": "kernel", "bias": "bias"}),
    (GroupNorm, "GroupNorm", {"weight": "scale", "bias": "bias"}),
    (nn.Linear, "Dense", {"weight": "kernel", "bias": "bias"}),
)


def _to_flax_layout(layer: nn.Module, pname: str, t: torch.Tensor) -> torch.Tensor:
    if pname == "weight" and isinstance(layer, nn.Conv2d):
        return t.permute(2, 3, 1, 0)  # OIHW -> HWIO
    if pname == "weight" and isinstance(layer, nn.Linear):
        return t.t()
    return t


def _from_flax_layout(layer: nn.Module, pname: str, t: torch.Tensor) -> torch.Tensor:
    if pname == "weight" and isinstance(layer, nn.Conv2d):
        return t.permute(3, 2, 0, 1)  # HWIO -> OIHW
    if pname == "weight" and isinstance(layer, nn.Linear):
        return t.t()
    return t


def flax_names(module: nn.Module) -> Iterator[Tuple[str, str, nn.Module, str]]:
    """Yield ``(torch key, flax key, layer, torch param name)`` for every
    parameter of ``module``'s Conv2d / GroupNorm / Linear layers."""
    counts = {prefix: 0 for _, prefix, _ in _LAYERS}
    for mname, layer in module.named_modules():
        for ltype, prefix, pmap in _LAYERS:
            if type(layer) is ltype:
                fname = f"{prefix}_{counts[prefix]}"
                counts[prefix] += 1
                for pname, p in layer.named_parameters(recurse=False):
                    tkey = f"{mname}.{pname}" if mname else pname
                    yield tkey, f"{fname}/{pmap[pname]}", layer, pname
                break


def state_dict_to_flax(module: nn.Module,
                       tensors: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The module's parameters as the JAX package's flat params dict
    (flax layouts, the module's dtypes and device; views, not copies).
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
