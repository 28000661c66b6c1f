"""The port's content-addressed params store against the JAX package's.

``rafiki_tpu_torch/store/cas.py`` is the port's copy of
``rafiki_tpu/store/cas.py``: for the same blobs, written in the same
order, both write byte-identical manifests and the same chunk files, so
each package loads the other's directory (plain-format files in it
too), and ``stats()`` and ``gc()`` agree. The one departure is a repair:
the JAX package's ``CasParamsStore.size`` is the manifest file's size (it
inherits the plain store's), the port's equals the plain store's size
for the same blob. Exact comparisons throughout: no tolerance applies.
"""

import os

import numpy as np
import pytest
import torch

from rafiki_tpu import telemetry as jax_telemetry
from rafiki_tpu.store import (CasParamsStore as JaxCas, ParamsStore as JaxPlain,
                              make_params_store as jax_make)
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.store import CasParamsStore, ParamsStore, make_params_store
from rafiki_tpu_torch.store.cas import MANIFEST_MARKER

torch.set_num_threads(2)


def _blobs(seed=0, chunk=1024):
    """Three blobs over 1 KiB chunks: ``b`` shares ``a``'s first four
    chunks, ``c`` repeats one chunk and ends on a partial one."""
    rng = np.random.default_rng(seed)
    a = rng.bytes(6 * chunk)
    b = a[:4 * chunk] + rng.bytes(2 * chunk + 100)
    c = (rng.bytes(chunk) * 3) + rng.bytes(17)
    return {"a": a, "b": b, "c": c}


def _tree(d):
    """Every file under ``d``: relative path -> bytes."""
    out = {}
    for root, _, files in os.walk(d):
        for name in files:
            path = os.path.join(root, name)
            out[os.path.relpath(path, d)] = open(path, "rb").read()
    return out


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    monkeypatch.setenv("RAFIKI_CAS_CHUNK_KB", "1")
    telemetry.reset()
    jax_telemetry.reset()
    yield
    telemetry.reset()
    jax_telemetry.reset()


def _save_all(store, blobs):
    for pid, blob in blobs.items():
        assert store.save(blob, params_id=pid) == pid


def test_manifests_and_chunks_are_byte_identical(tmp_path):
    blobs = _blobs()
    port, ref = CasParamsStore(tmp_path / "port"), JaxCas(tmp_path / "jax")
    _save_all(port, blobs)
    _save_all(ref, blobs)
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want
    assert sorted(k for k in got if k.endswith(".params")) == ["a.params", "b.params",
                                                               "c.params"]
    assert got["a.params"].split(b"\n", 1)[0] == MANIFEST_MARKER
    # The shared chunks were written once: 6 (a) + 3 new (b) + 2 (c).
    assert sum(1 for k in got if k.startswith("chunks")) == 11
    for name in ("cas.chunk_writes", "cas.chunk_hits", "cas.bytes_logical", "cas.bytes_written"):
        assert telemetry.get_counter(name) == jax_telemetry.get_counter(name), name


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_loads_the_others_directory(tmp_path, writer):
    blobs = _blobs(seed=1)
    cas_w, plain_w = (CasParamsStore, ParamsStore) if writer == "port" else (JaxCas, JaxPlain)
    cas_r = JaxCas if writer == "port" else CasParamsStore
    _save_all(cas_w(tmp_path), blobs)
    plain_w(tmp_path).save(b"plain-format blob", params_id="old")
    reader = cas_r(tmp_path)
    for pid, blob in blobs.items():
        assert reader.load(pid) == blob
    assert reader.load("old") == b"plain-format blob"
    assert reader.list() == ["a", "b", "c", "old"]
    # A torn chunk fails the read in both packages.
    victim = tmp_path / "chunks" / sorted(os.listdir(tmp_path / "chunks"))[0]
    victim.write_bytes(b"torn")
    for store in (CasParamsStore(tmp_path), JaxCas(tmp_path)):
        failures = 0
        for pid in blobs:
            try:
                store.load(pid)
            except IOError:
                failures += 1
        assert failures >= 1


def test_stats_and_gc_agree(tmp_path):
    blobs = _blobs(seed=2)
    port, ref = CasParamsStore(tmp_path / "port"), JaxCas(tmp_path / "jax")
    _save_all(port, blobs)
    _save_all(ref, blobs)
    assert port.stats() == ref.stats()
    assert 0.0 < port.stats()["dedup_ratio"] < 1.0
    for store in (port, ref):
        store.delete("a")
        (store.directory / "chunks" / "leftover.tmp").write_bytes(b"x")
    assert port.gc() == ref.gc() == 3  # a's two unshared chunks and the .tmp
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    for store in (port, ref):
        assert store.load("b") == blobs["b"] and store.load("c") == blobs["c"]


def test_size_repair_equals_the_plain_store(tmp_path):
    """The JAX package's CAS ``size`` is the manifest's file bytes (the
    reference's fault); the port's is the plain store's size for the
    same blob. A 2 MiB blob (2,048 chunks of 1 KiB) shows it."""
    blob = np.random.default_rng(3).bytes(2 << 20)
    plain_port, plain_ref = ParamsStore(tmp_path / "pp"), JaxPlain(tmp_path / "pj")
    cas_port, cas_ref = CasParamsStore(tmp_path / "cp"), JaxCas(tmp_path / "cj")
    for store in (plain_port, plain_ref, cas_port, cas_ref):
        store.save(blob, params_id="t")
    plain = plain_port.size("t")
    assert plain == plain_ref.size("t") == len(blob) + 65
    assert cas_port.size("t") == plain
    manifest_bytes = (tmp_path / "cj" / "t.params").stat().st_size
    assert cas_ref.size("t") == manifest_bytes < (1 << 20) < len(blob)
    # Absent ids are 0 in both; a plain-format file in a CAS directory
    # is its own size.
    assert cas_port.size("nope") == cas_ref.size("nope") == 0
    ParamsStore(tmp_path / "cp").save(b"xyz", params_id="plain")
    assert cas_port.size("plain") == 3 + 65


@pytest.mark.parametrize("flag,want", [("1", "cas"), ("", "plain"), ("off", "plain")])
def test_make_params_store_honours_the_flag(tmp_path, monkeypatch, flag, want):
    monkeypatch.setenv("RAFIKI_PARAMS_CAS", flag)
    port, ref = make_params_store(tmp_path / "p"), jax_make(tmp_path / "j")
    assert isinstance(port, CasParamsStore) == isinstance(ref, JaxCas) == (want == "cas")
    assert isinstance(port, ParamsStore)
