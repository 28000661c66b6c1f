"""RTPK1 params blobs, read and written with torch and numpy only.

Counterpart of ``rafiki_tpu/utils/serial.py``, which imports jax and
ml_dtypes at top level; neither exists where the port runs. The format
is the same byte for byte, so a blob written here loads in the JAX
package and vice versa:

    magic ``b"RTPK1\\n"``, u64-le header length, a JSON header listing
    ``{"k": key, "shape": [...], "dtype": name}`` per leaf in sorted
    key order, then the raw concatenated little-endian buffers.

Keys are flax-style flattened paths (``"Conv_0/kernel"``) sorted as
strings, exactly as ``dump_pytree`` sorts them; the port's
``convert.py`` maps them to and from a torch ``state_dict``.

bfloat16 leaves travel as their raw 16-bit patterns: numpy has no
bfloat16, so they are read as ``int16`` and viewed as
``torch.bfloat16``. The f32 -> bf16 serving cast rounds to nearest
even, as XLA's ``astype`` does, so both packages write the same bits.
"""

from __future__ import annotations

import json
from typing import Dict, Mapping, Union

import numpy as np
import torch

MAGIC = b"RTPK1\n"

Leaf = Union[torch.Tensor, np.ndarray]

# dtype name in the header -> (numpy dtype of the raw bytes, torch dtype).
# Types numpy lacks travel as same-width integers and are viewed back.
_DTYPES = {
    "float32": (np.float32, torch.float32),
    "float64": (np.float64, torch.float64),
    "float16": (np.float16, torch.float16),
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "int64": (np.int64, torch.int64),
    "int32": (np.int32, torch.int32),
    "int16": (np.int16, torch.int16),
    "uint32": (np.uint32, torch.uint32),
    "int8": (np.int8, torch.int8),
    "uint8": (np.uint8, torch.uint8),
    "bool": (np.bool_, torch.bool),
}
_NAMES = {tdt: name for name, (_, tdt) in _DTYPES.items()}


def is_packed(blob: bytes) -> bool:
    return blob[: len(MAGIC)] == MAGIC


def _as_tensor(v: Leaf) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.array(v))  # copy: keeps 0-d shapes


def _raw_bytes(t: torch.Tensor) -> bytes:
    name = _NAMES[t.dtype]
    raw_np = _DTYPES[name][0]
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        t = t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.uint8)
    return t.numpy().astype(raw_np, copy=False).tobytes()


def dump_flat(flat: Mapping[str, Leaf], cast_f32_to_bf16: bool = True) -> bytes:
    """Serialize ``{path: tensor or array}`` as one RTPK1 blob. float32
    leaves are cast to bfloat16 first unless ``cast_f32_to_bf16`` is
    False (the serving-blob default of the JAX package). The cast runs
    where the leaf lives, so a leaf on the card crosses to the host at
    half its float32 size."""
    spec, bufs = [], []
    for k in sorted(flat):
        t = _as_tensor(flat[k])
        if cast_f32_to_bf16 and t.dtype == torch.float32:
            t = t.to(torch.bfloat16)
        t = t.cpu().contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"leaf {k!r}: dtype {t.dtype} has no RTPK1 name")
        spec.append({"k": k, "shape": list(t.shape), "dtype": _NAMES[t.dtype]})
        bufs.append(_raw_bytes(t))
    header = json.dumps(spec).encode()
    return b"".join([MAGIC, len(header).to_bytes(8, "little"), header] + bufs)


def load_flat(blob: bytes) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`dump_flat` (and of the JAX package's
    ``dump_pytree``): ``{path: CPU tensor}`` in the stored dtypes."""
    if not is_packed(blob):
        raise ValueError("not a RTPK1 packed pytree blob")
    off = len(MAGIC)
    hlen = int.from_bytes(blob[off : off + 8], "little")
    off += 8
    spec = json.loads(blob[off : off + hlen].decode())
    off += hlen
    out: Dict[str, torch.Tensor] = {}
    for ent in spec:
        if ent["dtype"] not in _DTYPES:
            raise ValueError(f"leaf {ent['k']!r}: unsupported dtype {ent['dtype']!r}")
        raw_np, tdt = _DTYPES[ent["dtype"]]
        shape = tuple(ent["shape"])
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        # copy(): an aligned, writable buffer that owns its memory.
        arr = np.frombuffer(blob, dtype=raw_np, count=n, offset=off).reshape(shape).copy()
        t = torch.from_numpy(arr)
        out[ent["k"]] = t.view(tdt) if t.dtype != tdt else t
        off += n * np.dtype(raw_np).itemsize
    return out
