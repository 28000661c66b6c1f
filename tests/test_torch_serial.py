"""RTPK1 params blobs shared by the JAX package and the PyTorch port:
both directions must be bit-exact, and so must a whole ``Vgg`` serving
blob going JAX -> port -> JAX."""

import pickle

import jax
import ml_dtypes
import numpy as np
import torch
from flax.traverse_util import flatten_dict

from rafiki_tpu.utils.serial import dump_pytree, load_pytree
from rafiki_tpu_torch.utils import serial as tserial

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

SMALL = dict(depth=11, width_mult=0.25, dropout=0.0, learning_rate=1e-3,
             batch_size=64, epochs=1, seed=0)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "Conv_0": {"kernel": rng.normal(size=(3, 3, 3, 8)).astype(np.float32)},
        "Dense_0": {"kernel": rng.normal(size=(16, 10)).astype(np.float32),
                    "bias": rng.normal(size=(10,)).astype(np.float32)},
        "GroupNorm_10": {"scale": rng.normal(size=(8,)).astype(np.float32)},
        "step": np.int32(17),
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_jax_blob_reads_bit_exact_in_port():
    tree = _tree()
    ref = {k: np.asarray(v) for k, v in flatten_dict(load_pytree(dump_pytree(tree)), sep="/").items()}
    got = tserial.load_flat(dump_pytree(tree))
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if v.dtype == np.dtype(ml_dtypes.bfloat16):
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(got[k]), v.view(np.uint16))
        else:
            np.testing.assert_array_equal(got[k].numpy(), v)


def test_port_blob_reads_bit_exact_in_jax():
    tree = _tree(1)
    flat = flatten_dict(tree, sep="/")
    for cast in (True, False):
        blob = tserial.dump_flat(flat, cast_f32_to_bf16=cast)
        # Same bytes as the JAX writer: header, key order, rounding.
        assert blob == dump_pytree(tree, cast_f32_to_bf16=cast)
        back = flatten_dict(load_pytree(blob), sep="/")
        for k, v in flat.items():
            want = np.asarray(v)
            if cast and want.dtype == np.float32:
                want = want.astype(ml_dtypes.bfloat16)
            assert back[k].dtype == want.dtype
            assert back[k].shape == want.shape
            assert back[k].tobytes() == want.tobytes()


def test_port_round_trip_full_precision_and_torch_leaves():
    flat = {"a/w": torch.randn(4, 3, generator=torch.Generator().manual_seed(0)),
            "a/h": torch.ones(2, dtype=torch.bfloat16) * 1.5,
            "n": torch.tensor(3, dtype=torch.int64)}
    got = tserial.load_flat(tserial.dump_flat(flat, cast_f32_to_bf16=False))
    for k, v in flat.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v)


def test_vgg_blob_jax_port_jax_params_equal():
    from rafiki_tpu.models.vgg import Vgg as JaxVgg
    from rafiki_tpu_torch.models.vgg import Vgg as TorchVgg

    src = JaxVgg(**SMALL)
    src._build_loop(10, (32, 32, 3))
    blob = src.dump_parameters()

    port = TorchVgg(device="cpu", **SMALL)
    port.load_parameters(blob)
    again = port.dump_parameters()
    assert pickle.loads(again)["packed"] == pickle.loads(blob)["packed"]

    ref = JaxVgg(**SMALL)
    ref.load_parameters(blob)
    back = JaxVgg(**SMALL)
    back.load_parameters(again)
    a = flatten_dict(jax.device_get(ref._loop.params), sep="/")
    b = flatten_dict(jax.device_get(back._loop.params), sep="/")
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])


def test_legacy_msgpack_blob_is_refused():
    import pytest

    from rafiki_tpu_torch.models.vgg import Vgg as TorchVgg

    legacy = pickle.dumps({"arch": (10, (32, 32, 3)), "params": b"\x80"})
    with pytest.raises(ValueError, match="legacy flax-msgpack"):
        TorchVgg(device="cpu", **SMALL).load_parameters(legacy)
