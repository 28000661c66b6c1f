"""Sharded checkpoints: per-shard chunk manifests with reshard-on-restore.

The port's own copy of ``rafiki_tpu/shard/checkpoint.py``
(``shard-manifest-v1``, ``save_sharded``, ``is_manifest``,
``load_manifest``, ``restore_sharded``, ``gather_state``), in the same
format, so a manifest written by either package restores in the other.

A group-sharded train state at rest is a :class:`ShardedState`: the JAX
package's flat checkpoint tree (``0/<flax params>``, ``1/...`` Adam's
state, ``2`` the step, ``3`` the threefry key, ``4/<hyper>``; see
``model/base.py``), each leaf in flax's layout and split along its
planned axis (``shard/plan.py shard_axis``) over the group's members.

A width-w group checkpoints as **w+1 params-store blobs**:

  * ``<trial>_ckpt_<epoch>``            the JSON manifest (the head:
                                        ``ParamsStore.latest_checkpoint``
                                        finds it like any serial one)
  * ``<trial>_ckpt_<epoch>_s<t>of<w>``  shard t's slice of every sharded
                                        leaf, RTPK1-packed
                                        (``utils/serial.py``); shard 0
                                        also carries the replicated
                                        leaves (step, counts, rng key,
                                        hyper scalars, indivisible
                                        leaves).

Each shard writes only what its member holds. A torn or missing chunk
fails the load loudly, naming the chunk.

**Reshard-on-restore**: the manifest records, per leaf, the global shape,
dtype and the axis it was sliced along at width w. A restore at any
width w' recomputes each member's placement from the shape-deterministic
rule and assembles exactly the saved slices that overlap it.

**The generator leaf.** The JAX package's state carries a threefry key
(leaf ``3``); the port's dropout stream is a torch generator, which no
threefry key can stand for (``model/base.py GENERATOR_KEY``). A port
manifest says so in its ``extra``: ``"package": "rafiki_tpu_torch"``
and ``"torch_generator"`` (the generator's device type and its state,
base64), and leaf ``3`` holds ``PRNGKey(seed)``; a manifest without
``package`` is the JAX package's. Across packages a manifest carries the
parameters and Adam's state; each package keeps its own generator: the
port restores the generator only from a port manifest written on the
same device type, and otherwise keeps the trial's freshly seeded one.

:func:`gather_state` is the one full gather of group state: the trial's
completion hand-off, where the final state goes into a serial loop for
scoring and serving.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from rafiki_tpu_torch.shard.plan import ShardPlan, shard_axis
from rafiki_tpu_torch.utils.serial import _NAMES, dump_flat, load_flat

MANIFEST_FORMAT = "shard-manifest-v1"
PACKAGE = "rafiki_tpu_torch"


@dataclass
class ShardedState:
    """One trial's train state, split over a group (module doc).

    ``shapes`` and ``axes`` are each leaf's global shape and its shard
    axis at this width (None: replicated); ``shards[t]`` is member t's
    leaves: its slice of each sharded leaf and a copy of each replicated
    one. ``generator`` is the dropout generator's ``{"device", "state"}``
    (``model/base.py _generator_state``) or None."""

    shapes: Dict[str, Tuple[int, ...]]
    axes: Dict[str, Optional[int]]
    shards: List[Dict[str, torch.Tensor]]
    generator: Optional[Dict[str, Any]] = None

    @property
    def width(self) -> int:
        return len(self.shards)


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    import numpy as np

    return torch.from_numpy(np.array(v))


def split_tree(flat: Dict[str, Any], devices: Sequence[torch.device],
               generator: Optional[Dict[str, Any]] = None) -> ShardedState:
    """A full flat tree split over ``devices``, one member each. Every
    slice and every replicated leaf is a copy: none aliases ``flat``.
    Scalars and integer leaves (the step, counts, rng key, hyper
    scalars) stay where they are: on the host."""
    width = len(devices)
    shapes, axes = {}, {}
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in devices]
    for k in sorted(flat):
        v = _as_tensor(flat[k])
        shapes[k] = tuple(v.shape)
        a = axes[k] = shard_axis(tuple(v.shape), width)
        host = not v.is_floating_point() or v.dim() == 0
        for t, dev in enumerate(devices):
            if a is None:
                part = v
            else:
                blk = v.shape[a] // width
                part = v.narrow(a, t * blk, blk)
            part = part.to(v.device if host else dev)
            shards[t][k] = part.clone(memory_format=torch.contiguous_format)
    return ShardedState(shapes, axes, shards, generator)


def gather_leaf(state: ShardedState, key: str, device: torch.device, t: int = 0) -> torch.Tensor:
    """Leaf ``key`` whole on ``device``: each member's slice copied there
    and concatenated along the leaf's axis; a replicated leaf is member
    t's copy (host leaves stay on the host)."""
    a = state.axes[key]
    if a is None:
        return state.shards[t][key]
    return torch.cat([s[key].to(device) for s in state.shards], dim=a)


def _shard_ids(trial_id: str, epoch: int, width: int) -> List[str]:
    return [f"{trial_id}_ckpt_{epoch}_s{t}of{width}" for t in range(width)]


def save_sharded(store, trial_id: str, epoch: int, state: ShardedState,
                 width: Optional[int] = None, extra: Optional[Dict[str, Any]] = None) -> str:
    """Write a width-``state.width`` sharded checkpoint; returns the
    manifest's params id (the trial's checkpoint head for this epoch)."""
    width = state.width if width is None else int(width)
    if width != state.width:
        raise ValueError(f"state is split {state.width} ways, not {width}")
    spec = []
    per_shard: List[Dict[str, torch.Tensor]] = [dict() for _ in range(width)]
    for k in sorted(state.shapes):
        axis = state.axes[k]
        leaf0 = state.shards[0][k]
        spec.append({"k": k, "shape": list(state.shapes[k]),
                     "dtype": _NAMES[leaf0.dtype], "axis": axis})
        if axis is None:
            per_shard[0][k] = leaf0
        else:
            for t in range(width):
                per_shard[t][k] = state.shards[t][k]
    shard_ids = _shard_ids(trial_id, epoch, width)
    for t, sid in enumerate(shard_ids):
        store.save(dump_flat(per_shard[t], cast_f32_to_bf16=False), params_id=sid)
    ext = {"package": PACKAGE}
    if state.generator is not None:
        ext["torch_generator"] = {
            "device": state.generator["device"],
            "state": base64.b64encode(state.generator["state"]).decode()}
    ext.update(extra or {})
    manifest = {"format": MANIFEST_FORMAT, "trial": trial_id,
                "width": int(width), "epoch": int(epoch), "spec": spec,
                "shards": shard_ids, "extra": ext}
    return store.save_checkpoint(trial_id, epoch, json.dumps(manifest).encode())


def is_manifest(blob: bytes) -> bool:
    head = blob[:256]
    return head.lstrip()[:1] == b"{" and MANIFEST_FORMAT.encode() in head


def load_manifest(blob: bytes) -> Dict[str, Any]:
    try:
        manifest = json.loads(blob.decode())
    except Exception as exc:
        raise IOError(f"sharded checkpoint manifest unreadable: {exc}")
    if manifest.get("format") != MANIFEST_FORMAT:
        raise IOError("sharded checkpoint manifest has wrong format "
                      f"{manifest.get('format')!r} (want {MANIFEST_FORMAT})")
    if len(manifest.get("shards", [])) != int(manifest.get("width", -1)):
        raise IOError(
            "sharded checkpoint manifest is inconsistent: width="
            f"{manifest.get('width')} but {len(manifest.get('shards', []))} "
            "shard chunks listed — refusing a wrong-width restore")
    return manifest


def manifest_generator(manifest: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The torch generator a port manifest carries, or None (a JAX
    package manifest: its generator is the threefry leaf ``3``)."""
    extra = manifest.get("extra") or {}
    gen = extra.get("torch_generator")
    if extra.get("package") != PACKAGE or not gen:
        return None
    return {"device": gen["device"], "state": base64.b64decode(gen["state"])}


class _ShardReader:
    """Lazy per-shard chunk loader with slice-shape validation: each
    chunk is fetched once (integrity errors propagate, naming the chunk)
    and every sharded leaf in it must be exactly a 1/width-of-global
    slice: a chunk doctored in from another width fails here, naming the
    chunk and the leaf."""

    def __init__(self, store, manifest: Dict[str, Any]):
        self._store = store
        self._man = manifest
        self._spec = {e["k"]: e for e in manifest["spec"]}
        self._cache: Dict[int, Dict[str, torch.Tensor]] = {}

    def spec(self, key: str) -> Dict[str, Any]:
        return self._spec[key]

    def _load(self, t: int) -> Dict[str, torch.Tensor]:
        if t in self._cache:
            return self._cache[t]
        sid = self._man["shards"][t]
        try:
            blob = self._store.load(sid)
        except (IOError, OSError, FileNotFoundError) as exc:
            raise IOError(f"sharded restore failed on shard chunk {sid}: {exc}")
        flat = load_flat(blob)
        width = int(self._man["width"])
        for k, arr in flat.items():
            ent = self._spec.get(k)
            if ent is None:
                raise IOError(f"shard chunk {sid} carries unknown leaf "
                              f"{k!r} — manifest/chunk mismatch")
            axis = ent["axis"]
            want = list(ent["shape"])
            if axis is not None:
                want[axis] = want[axis] // width
            if list(arr.shape) != want:
                raise IOError(
                    f"shard chunk {sid} has a wrong-width slice for "
                    f"{k!r}: got {list(arr.shape)}, manifest (width="
                    f"{width}) expects {want}")
        self._cache[t] = flat
        return flat

    def leaf_range(self, key: str, lo: int, hi: int) -> torch.Tensor:
        """The saved leaf restricted to [lo, hi) along its saved axis
        (full extent on the other axes), assembled from exactly the
        chunks that overlap the range."""
        ent = self._spec[key]
        axis = ent["axis"]
        width = int(self._man["width"])
        if axis is None:
            return self._load(0)[key]
        blk = ent["shape"][axis] // width
        parts = []
        for t in range(width):
            s_lo, s_hi = t * blk, (t + 1) * blk
            if s_hi <= lo or s_lo >= hi:
                continue
            arr = self._load(t)[key]
            a, b = max(lo, s_lo) - s_lo, min(hi, s_hi) - s_lo
            parts.append(arr.narrow(axis, a, b - a))
        if not parts:
            raise IOError(f"sharded restore: no chunk covers [{lo}, {hi}) of leaf {key!r}")
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)


def restore_sharded(store, manifest_blob: bytes, template: ShardedState,
                    devices: Sequence[torch.device], plan: ShardPlan) -> ShardedState:
    """Restore a sharded checkpoint onto ``devices`` at ``plan.width``
    (any width: the reshard), as a :class:`ShardedState` whose leaves
    match ``template``'s names and shapes and whose placement is the
    template's devices' (host leaves stay on the host). Each member
    reads only the saved slices overlapping its new slice. The generator
    is the manifest's when it carries a port one (module doc)."""
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.obs.journal import journal

    manifest = load_manifest(manifest_blob)
    reader = _ShardReader(store, manifest)
    saved_keys = set(reader._spec)
    if set(template.shapes) != saved_keys:
        missing = sorted(set(template.shapes) - saved_keys)[:3]
        extra = sorted(saved_keys - set(template.shapes))[:3]
        raise IOError("sharded checkpoint does not match the trial's "
                      f"state tree (missing={missing}, extra={extra})")
    width = int(plan.width)
    if len(devices) != width:
        raise ValueError(f"{len(devices)} devices for a width-{width} plan")
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(width)]
    axes: Dict[str, Optional[int]] = {}
    for k in sorted(template.shapes):
        ent = reader.spec(k)
        shape = tuple(ent["shape"])
        if shape != tuple(template.shapes[k]):
            raise IOError(f"sharded checkpoint leaf {k!r} has shape {list(shape)}, the "
                          f"trial's is {list(template.shapes[k])}")
        saved_axis = ent["axis"]
        new_axis = axes[k] = plan.axis_of(shape)
        on_host = template.shards[0][k].device.type == "cpu"
        for t, dev in enumerate(devices):
            blk = shape[new_axis] // width if new_axis is not None else 0
            if saved_axis is None:
                arr = reader.leaf_range(k, 0, 1)
                if new_axis is not None:
                    arr = arr.narrow(new_axis, t * blk, blk)
            elif new_axis == saved_axis:
                arr = reader.leaf_range(k, t * blk, (t + 1) * blk)
            else:
                arr = reader.leaf_range(k, 0, shape[saved_axis])
                if new_axis is not None:
                    arr = arr.narrow(new_axis, t * blk, blk)
            shards[t][k] = arr.to("cpu" if on_host else dev).clone(
                memory_format=torch.contiguous_format)
    telemetry.inc("shard.reshard_restores")
    journal.record("shard", "reshard", trial_id=str(manifest.get("trial") or ""),
                   from_width=int(manifest["width"]), to_width=width,
                   epoch=int(manifest["epoch"]))
    return ShardedState(dict(template.shapes), axes, shards, manifest_generator(manifest))


def gather_state(state: ShardedState) -> Dict[str, torch.Tensor]:
    """Host copy of a group-sharded state, as a full flat tree: the one
    full gather (module doc). Leaf at a time."""
    return {k: gather_leaf(state, k, torch.device("cpu")).cpu().clone()
            for k in sorted(state.shapes)}
