"""Device choice for the port.

Counterpart of ``rafiki_tpu/utils/backend.py`` and
``rafiki_tpu/parallel/mesh.py:local_devices``. The JAX package pins a
backend process-wide; the port passes an explicit ``torch.device`` to
every entry point instead. The default is the CUDA card. The CPU is
used only when the caller asks for it (the tests do), and a missing
card is an error: nothing carries on silently on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` only on request; raise without CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rafiki_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev


def local_devices(platform: Optional[str] = None) -> List[torch.device]:
    """The process's devices: every CUDA card, or ``[cpu]`` when asked
    for ``platform="cpu"``. Raises when CUDA is asked for and absent."""
    if platform == "cpu":
        return [torch.device("cpu")]
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
