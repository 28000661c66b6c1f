"""Forward programs of a trial, serving half.

Counterparts of ``rafiki_tpu/ops/train.py``: ``predict`` (the float32
softmax, ``:210``), ``eval_step`` (the masked argmax-correct count,
``:199``) and ``TrainLoop.predict_proba`` (``:763``), which pads the
last chunk to a full batch by REPEATING ITS LAST ROW so the device sees
one shape. PyTorch runs eagerly, so there is no compiled program to
cache; each function takes the module and runs it.

``torch.inference_mode`` is thread-local, so :func:`predict_proba`
enters it itself, on whatever thread serves the query.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


def predict(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Class probabilities: the float32 softmax of the module's logits."""
    return torch.softmax(module(x).float(), dim=-1)


def eval_step(module: nn.Module, x: torch.Tensor, y: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(correct, counted)`` over labels >= 0, optionally masked by a
    per-example ``valid`` flag broadcast over trailing label axes."""
    logits = module(x)
    mask = y >= 0
    if valid is not None:
        mask = mask & valid.reshape(valid.shape + (1,) * (mask.dim() - valid.dim())).bool()
    labels_safe = torch.where(mask, y, torch.zeros_like(y))
    correct = (logits.argmax(dim=-1) == labels_safe) & mask
    return correct.sum(), mask.sum()


def predict_proba(module: nn.Module, x: np.ndarray, batch_size: int,
                  device: torch.device) -> np.ndarray:
    """Forward a query array in fixed-size chunks; returns ``(N, ..., C)``
    float32 probabilities on the host. The last chunk is padded to
    ``batch_size`` by repeating its last row, as the JAX package does."""
    n = x.shape[0]
    outs = []
    with torch.inference_mode():
        for start in range(0, n, batch_size):
            chunk = x[start : start + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
            xt = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
            probs = predict(module, xt).cpu().numpy()
            outs.append(probs[: batch_size - pad] if pad else probs)
    return np.concatenate(outs) if outs else np.zeros((0,))
