"""Content-addressed params store: chunk-level dedup for checkpoints.

The port's own copy of ``rafiki_tpu/store/cas.py`` (``CasParamsStore``,
``make_params_store``). :class:`CasParamsStore` keeps the
:class:`~rafiki_tpu_torch.store.params.ParamsStore` contract (same ids,
same ``*.params`` namespace, same ``store.params_write`` chaos site,
same integrity guarantee) but stores each blob as a MANIFEST over
fixed-size content-addressed chunks:

    <params_id>.params   cas-manifest-v1\\n{"chunk_bytes": ..., "chunks": [...], ...}
    chunks/<sha256>      raw chunk bytes, written once, shared forever

The manifest is the JAX package's byte for byte (``json.dumps`` of the
same four keys, ``sort_keys=True``) and chunks are named by their
sha256, so either package reads a directory the other wrote. A chunk
already present is never rewritten: a second checkpoint of a
near-identical tree writes only its deltas. ``load`` verifies the
whole-blob sha256 like the plain store, and still reads plain-format
files, so a directory can migrate in place.

One departure, a repair: :meth:`CasParamsStore.size` is the size the
plain store reports for the same blob (the manifest's ``"size"``, the
blob's logical bytes, plus the plain file's 65-byte digest line). The
JAX package's inherits the plain store's ``size``, which under CAS is
the manifest file's few kilobytes, so co-hosted serving charged a job
the 1 MiB floor against its HBM residency budget whatever its params.

Opt-in via RAFIKI_PARAMS_CAS=1 (:func:`make_params_store`); chunk size
via RAFIKI_CAS_CHUNK_KB (default 64).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import uuid
from typing import Any, Dict, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.chaos import hook as _chaos
from rafiki_tpu_torch.store.params import ParamsStore

MANIFEST_MARKER = b"cas-manifest-v1"
DEFAULT_CHUNK_KB = 64
#: The plain format's first line: a sha256 hex digest and a newline.
PLAIN_HEADER_BYTES = 65


def _chunk_size() -> int:
    try:
        kb = int(os.environ.get("RAFIKI_CAS_CHUNK_KB", str(DEFAULT_CHUNK_KB)))
    except ValueError:
        kb = DEFAULT_CHUNK_KB
    return max(1, kb) * 1024


class CasParamsStore(ParamsStore):
    """Drop-in ParamsStore with content-addressed chunk storage."""

    def __init__(self, params_dir: "str | os.PathLike"):
        super().__init__(params_dir)
        self._chunks = self._dir / "chunks"
        self._chunks.mkdir(parents=True, exist_ok=True)
        self._chunk_bytes = _chunk_size()
        self._stats_lock = threading.Lock()
        self._bytes_logical = 0
        self._bytes_written = 0

    # -- write path ----------------------------------------------------------

    def save(self, blob: bytes, params_id: Optional[str] = None) -> str:
        params_id = params_id or uuid.uuid4().hex
        _chaos("store.params_write", params_id)  # delay=slow disk, error=failed write
        path = self._path(params_id)
        chunk_ids = []
        written = 0
        for off in range(0, len(blob), self._chunk_bytes):
            piece = blob[off:off + self._chunk_bytes]
            cid = hashlib.sha256(piece).hexdigest()
            chunk_ids.append(cid)
            written += self._write_chunk(cid, piece)
        manifest = json.dumps({
            "size": len(blob),
            "digest": hashlib.sha256(blob).hexdigest(),
            "chunk_bytes": self._chunk_bytes,
            "chunks": chunk_ids,
        }, sort_keys=True).encode()
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            f.write(MANIFEST_MARKER + b"\n" + manifest)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: readers never see a torn file
        written += len(MANIFEST_MARKER) + 1 + len(manifest)
        with self._stats_lock:
            self._bytes_logical += len(blob)
            self._bytes_written += written
        telemetry.inc("cas.bytes_logical", len(blob))
        telemetry.inc("cas.bytes_written", written)
        return params_id

    def _write_chunk(self, cid: str, piece: bytes) -> int:
        """Write a chunk once; a present chunk is the dedup hit. Returns
        the bytes physically written."""
        cpath = self._chunks / cid
        if cpath.exists():
            telemetry.inc("cas.chunk_hits")
            return 0
        tmp = cpath.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            f.write(piece)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, cpath)
        telemetry.inc("cas.chunk_writes")
        return len(piece)

    # -- read path -----------------------------------------------------------

    def _read(self, params_id: str) -> "tuple[bytes, bytes]":
        """The file's first line and the rest: a manifest marker and its
        JSON, or (plain format) a hex digest and the blob."""
        with open(self._path(params_id), "rb") as f:
            head, rest = f.read().split(b"\n", 1)
        return head, rest

    def load(self, params_id: str) -> bytes:
        head, rest = self._read(params_id)
        if head != MANIFEST_MARKER:
            # Plain-format file (pre-CAS, or written by the base store
            # into the same directory): head is the hex digest.
            if hashlib.sha256(rest).hexdigest().encode() != head:
                raise IOError(f"Params {params_id} failed integrity check")
            return rest
        manifest = json.loads(rest.decode())
        parts = []
        for cid in manifest["chunks"]:
            try:
                piece = (self._chunks / cid).read_bytes()
            except FileNotFoundError:
                raise IOError(f"Params {params_id} missing chunk {cid}")
            if hashlib.sha256(piece).hexdigest() != cid:
                raise IOError(f"Params {params_id} chunk {cid} corrupt")
            parts.append(piece)
        blob = b"".join(parts)
        if hashlib.sha256(blob).hexdigest() != manifest["digest"]:
            raise IOError(f"Params {params_id} failed integrity check")
        return blob

    def size(self, params_id: str) -> int:
        """The plain store's size for the same blob: the manifest's
        ``"size"`` plus the plain file's digest line; a plain-format
        file's own size; 0 when absent (module doc: a repair)."""
        try:
            head, rest = self._read(params_id)
        except (OSError, ValueError):
            return super().size(params_id)
        if head != MANIFEST_MARKER:
            return super().size(params_id)
        return int(json.loads(rest.decode())["size"]) + PLAIN_HEADER_BYTES

    # -- accounting / maintenance --------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Physical-vs-logical accounting since this instance opened:
        ``dedup_ratio`` is the fraction of logical bytes NOT written."""
        with self._stats_lock:
            logical, written = self._bytes_logical, self._bytes_written
        return {
            "bytes_logical": logical,
            "bytes_written": written,
            "dedup_ratio": round(1.0 - written / logical, 6) if logical else 0.0,
            "chunk_bytes": self._chunk_bytes,
            "chunks": sum(1 for _ in self._chunks.iterdir()),
        }

    def gc(self) -> int:
        """Delete chunks no surviving manifest references (deleted
        checkpoints leave shared chunks behind by design). Returns the
        number of chunks removed."""
        live = set()
        for pid in self.list():
            head, rest = self._read(pid)
            if head == MANIFEST_MARKER:
                live.update(json.loads(rest.decode())["chunks"])
        removed = 0
        for cpath in list(self._chunks.iterdir()):
            if cpath.suffix == ".tmp" or cpath.name not in live:
                cpath.unlink(missing_ok=True)
                removed += 1
        telemetry.inc("cas.chunks_gced", removed)
        return removed


def make_params_store(params_dir: "str | os.PathLike") -> ParamsStore:
    """The CAS store when RAFIKI_PARAMS_CAS is set, the plain one
    otherwise. The CAS store reads plain-format files, so an existing
    directory can turn the flag on in place (turning it OFF strands
    only manifests written while it was on)."""
    if os.environ.get("RAFIKI_PARAMS_CAS", "").lower() in ("1", "true", "yes", "on"):
        return CasParamsStore(params_dir)
    return ParamsStore(params_dir)
