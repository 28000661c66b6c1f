"""Device choice for the port.

Counterpart of ``rafiki_tpu/utils/backend.py`` and
``rafiki_tpu/parallel/mesh.py:local_devices``. The JAX package pins a
backend process-wide and a train worker scopes each trial with
``jax.default_device``; the port passes an explicit ``torch.device`` to
every entry point, or leaves it ``None`` and takes this thread's
default device. A train worker sets that default for the trials it runs
(:func:`default_device`), so ``model_class(**knobs)`` builds on the
worker's device with no change to templates. Outside such a scope the
default is the CUDA card. The CPU is used only when the caller asks for
it (the tests do), and a missing card is an error: nothing carries on
silently on the CPU.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_local = threading.local()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> this thread's default device (:func:`default_device`),
    else ``cuda``; ``"cpu"`` only on request; raise without CUDA."""
    if device is None:
        device = getattr(_local, "device", None)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rafiki_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev


@contextlib.contextmanager
def default_device(device: DeviceLike) -> Iterator[torch.device]:
    """Make ``device`` what ``resolve_device(None)`` returns on this
    thread for the duration (the port's ``jax.default_device``). Scopes
    nest."""
    prev = getattr(_local, "device", None)
    dev = resolve_device(device)
    _local.device = dev
    try:
        yield dev
    finally:
        _local.device = prev


def local_devices(platform: Optional[str] = None) -> List[torch.device]:
    """The process's devices: every CUDA card, or ``[cpu]`` when asked
    for ``platform="cpu"``. Raises when CUDA is asked for and absent."""
    if platform == "cpu":
        return [torch.device("cpu")]
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
