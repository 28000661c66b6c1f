"""Per-step numerics sentinels: the device half of the health plane.

Counterpart of ``rafiki_tpu/obs/health/sentinel.py``. :func:`bundle`
adds a health reduction to every train step's metric dict, and
:func:`reduce_epoch` collapses the per-step series to one fixed set of
epoch-boundary scalars, the only values the host reads, once per epoch.

* **Read only.** The bundle reads loss, grads, updates and params; it
  never touches the dropout stream or the update arithmetic, so params
  are the same with or without it.
* **No per-step host sync.** Every output is a device scalar; the loop
  stacks the series and reduces it on the device at the epoch end.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

#: Metric-dict key prefix for sentinel outputs. ``ops.train`` strips
#: these from caller-visible epoch metrics and routes them to the
#: HealthMonitor.
PREFIX = "health_"


def _norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm over all elements of ``tensors``, accumulated in
    float32 whatever the leaf dtype."""
    f32 = [t if t.dtype == torch.float32 else t.float() for t in tensors]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(f32)))


def _nonfinite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    return flat.numel() - torch.isfinite(flat).sum()


def bundle(loss: torch.Tensor, grads: Sequence[torch.Tensor],
           updates: Sequence[torch.Tensor],
           params: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-step health stats: global grad/update/param L2 norms (float32)
    and the count of non-finite elements across the gradients and the
    loss."""
    return {
        "health_grad_norm": _norm(grads),
        "health_update_norm": _norm(updates),
        "health_param_norm": _norm(params),
        "health_nonfinite": _nonfinite(grads) + (~torch.isfinite(loss)).sum(),
    }


def split(metrics: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor],
                                                     Dict[str, torch.Tensor]]:
    """Partition a metric dict into (caller-visible, health) halves."""
    rest = {k: v for k, v in metrics.items() if not k.startswith(PREFIX)}
    health = {k: v for k, v in metrics.items() if k.startswith(PREFIX)}
    return rest, health


def reduce_epoch(series: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Epoch-boundary reduction of the per-step sentinel series.

    Handles the serial shape ``(n_steps,)`` and the packed shape
    ``(n_steps, k)``. Outputs, per trial:

    * ``health_nonfinite``   - total non-finite elements this epoch
    * ``health_grad_norm``   - max step grad norm (NaN-propagating)
    * ``health_update_norm`` - max step update norm
    * ``health_param_norm``  - post-update param norm at the last step
    * ``health_bad_step``    - first step with non-finite numerics, -1
      if the epoch was clean
    * ``health_bad_*``       - grad/update norm and non-finite count AT
      the first bad step (step 0 when clean; ignore when bad_step < 0)
    """
    nf = series["health_nonfinite"]
    bad = nf > 0
    any_bad = bad.any(dim=0)
    at = torch.argmax(bad.to(torch.int32), dim=0)  # first bad step; 0 when clean
    first_bad = torch.where(any_bad, at, torch.full_like(at, -1))

    def _at_bad(v: torch.Tensor) -> torch.Tensor:
        if v.dim() == 1:
            return v[at]
        return torch.gather(v, 0, at[None, :])[0]

    gn = series["health_grad_norm"]
    un = series["health_update_norm"]
    return {
        "health_nonfinite": nf.sum(dim=0),
        "health_grad_norm": gn.amax(dim=0),
        "health_update_norm": un.amax(dim=0),
        "health_param_norm": series["health_param_norm"][-1],
        "health_bad_step": first_bad,
        "health_bad_grad_norm": _at_bad(gn),
        "health_bad_update_norm": _at_bad(un),
        "health_bad_nonfinite": _at_bad(nf),
    }
