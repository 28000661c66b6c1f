"""Params store: trained model parameters on disk, keyed by params id.

The port's own copy of ``rafiki_tpu/store/params.py`` ``ParamsStore``,
with the same file layout (``<dir>/<params_id>.params``: a sha256 hex
digest line, then the blob) and the mid-trial checkpoint namespace
(``<trial>_ckpt_<step>``), so either package reads what the other
wrote. Every write passes the ``store.params_write`` chaos site, keyed
by the params id (``delay``: a slow disk; ``error``: a failed write,
:class:`rafiki_tpu_torch.chaos.ChaosError`, an OSError; ``match=_ckpt_``
aims at checkpoints only).
"""

from __future__ import annotations

import hashlib
import os
import uuid
from pathlib import Path
from typing import List, Optional

from rafiki_tpu_torch.chaos import hook as _chaos


class ParamsStore:
    def __init__(self, params_dir: str | os.PathLike):
        self._dir = Path(params_dir)
        self._dir.mkdir(parents=True, exist_ok=True)

    @property
    def directory(self) -> Path:
        """Root directory (subprocess workers reopen it by path)."""
        return self._dir

    def _path(self, params_id: str) -> Path:
        if "/" in params_id or ".." in params_id:
            raise ValueError(f"Bad params id {params_id!r}")
        return self._dir / f"{params_id}.params"

    def save(self, blob: bytes, params_id: Optional[str] = None) -> str:
        params_id = params_id or uuid.uuid4().hex
        _chaos("store.params_write", params_id)  # delay=slow disk, error=failed write
        path = self._path(params_id)
        tmp = path.with_suffix(".tmp")
        digest = hashlib.sha256(blob).hexdigest().encode()
        with open(tmp, "wb") as f:
            f.write(digest + b"\n" + blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: readers never see a torn file
        return params_id

    def load(self, params_id: str) -> bytes:
        with open(self._path(params_id), "rb") as f:
            digest, blob = f.read().split(b"\n", 1)
        if hashlib.sha256(blob).hexdigest().encode() != digest:
            raise IOError(f"Params {params_id} failed integrity check")
        return blob

    def exists(self, params_id: str) -> bool:
        return self._path(params_id).exists()

    def size(self, params_id: str) -> int:
        """On-disk byte size of the params blob (0 when absent) — the
        HBM residency charge estimate for co-hosted serving."""
        try:
            return self._path(params_id).stat().st_size
        except OSError:
            return 0

    def delete(self, params_id: str) -> None:
        self._path(params_id).unlink(missing_ok=True)

    def list(self) -> List[str]:
        return sorted(p.stem for p in self._dir.glob("*.params"))

    # -- mid-trial checkpoints ----------------------------------------------

    def save_checkpoint(self, trial_id: str, step: int, blob: bytes) -> str:
        return self.save(blob, params_id=f"{trial_id}_ckpt_{step}")

    def latest_checkpoint(self, trial_id: str) -> Optional[tuple]:
        """Return (step, blob) of the newest checkpoint for a trial.

        Only ``<trial>_ckpt_<int>`` ids are checkpoint heads; sharded
        checkpoints park their per-shard chunk blobs in the same
        namespace with a non-integer suffix (``..._ckpt_3_s0of2``,
        shard/checkpoint.py) so one ``delete_checkpoints`` sweep
        reclaims both — those are skipped here, never parsed."""
        best = None
        for p in self._dir.glob(f"{trial_id}_ckpt_*.params"):
            suffix = p.stem.rsplit("_", 1)[1]
            if not suffix.isdigit():
                continue
            step = int(suffix)
            if best is None or step > best:
                best = step
        if best is None:
            return None
        return best, self.load(f"{trial_id}_ckpt_{best}")

    def delete_checkpoints(self, trial_id: str) -> None:
        for p in self._dir.glob(f"{trial_id}_ckpt_*.params"):
            p.unlink(missing_ok=True)
