"""The rest of the model zoo in the port against the JAX package's, on
the CPU.

DenseNet (depth 22, growth 12, 16x16x3), the Transformer (embed 32, 2
heads, one layer) and PosBiLstm (embed 32, hidden 32) go through both
packages from the same flax-drawn params (carried by ``convert.py``) on
the same seeded inputs: the forward in float32 and in bf16 here, three
float32 training steps in ``test_torch_zoo_train.py`` and packs in
``test_torch_zoo_pack.py``. Then every template through the port's
``test_model_class`` with the floors of ``tests/test_zoo.py``, the host
templates' predictions, the text and corpus datasets byte for byte, the
weight carrier's round trips, the init distributions and the registry.
Each tolerance stands next to the readings that set it.
"""

import io
import pickle
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rafiki_tpu.model import dataset as jax_dataset
from rafiki_tpu.model.dev import test_model_class as jax_test_model_class
from rafiki_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from rafiki_tpu.models import get_model_class as jax_get_model_class
from rafiki_tpu.models.densenet import DenseNet as JaxDenseNet, _DenseNet as JaxDenseNetModule
from rafiki_tpu.models.pos_bilstm import PosBiLstm as JaxPosBiLstm, _BiLstmTagger as JaxTagger
from rafiki_tpu.models.pos_hmm import PosBigramHmm as JaxHmm
from rafiki_tpu.models.transformer import Transformer as JaxTransformer, _Encoder as JaxEncoder
from rafiki_tpu.utils.serial import load_pytree
from rafiki_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from rafiki_tpu_torch.model import dataset as port_dataset
from rafiki_tpu_torch.model.base import _lecun_init
from rafiki_tpu_torch.model.dev import test_model_class
from rafiki_tpu_torch.models import MODEL_REGISTRY, get_model_class
from rafiki_tpu_torch.models.densenet import DenseNet, _DenseNet
from rafiki_tpu_torch.models.pos_bilstm import PosBiLstm, _BiLstmTagger
from rafiki_tpu_torch.models.pos_hmm import PosBigramHmm
from rafiki_tpu_torch.models.transformer import Transformer, _Encoder
from rafiki_tpu_torch.utils.serial import dump_flat, load_flat

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

IMG = "synthetic://images?classes=5&n={n}&w=16&h=16&c=3&seed={seed}"
TEXT = "synthetic://text?vocab=81&classes=5&n={n}&len=16&seed={seed}"
CORPUS = "synthetic://corpus?vocab=80&tags=6&n={n}&len=12&seed={seed}"

# name -> (JAX template, port template, knobs, dataset URI pattern,
#          JAX module(dtype, classes, vocab), port module(dtype, classes, vocab))
FAMILIES = {
    "densenet": (JaxDenseNet, DenseNet,
                 dict(depth=22, growth=12, learning_rate=1e-3, batch_size=64, epochs=1, seed=0),
                 IMG,
                 lambda dt, nc, v: JaxDenseNetModule(depth=22, growth=12, num_classes=nc, dtype=dt),
                 lambda dt, nc, v: _DenseNet(22, 12, nc, 3, dtype=dt)),
    "transformer": (JaxTransformer, Transformer,
                    dict(embed_dim=32, num_heads=2, num_layers=1, learning_rate=1e-3,
                         batch_size=32, epochs=1, seed=0),
                    TEXT,
                    lambda dt, nc, v: JaxEncoder(vocab=v, embed_dim=32, num_heads=2,
                                                 num_layers=1, num_classes=nc, dtype=dt),
                    lambda dt, nc, v: _Encoder(v, 32, 2, 1, nc, 16, dtype=dt)),
    "pos_bilstm": (JaxPosBiLstm, PosBiLstm,
                   dict(embed_dim=32, hidden=32, learning_rate=1e-3, batch_size=32, epochs=1,
                        seed=0),
                   CORPUS,
                   lambda dt, nc, v: JaxTagger(vocab=v, embed_dim=32, hidden=32, num_tags=nc,
                                               dtype=dt),
                   lambda dt, nc, v: _BiLstmTagger(v, 32, 32, nc, dtype=dt)),
}


def _arch(family):
    ds = port_dataset.dataset_utils.load(FAMILIES[family][3].format(n=32, seed=0))
    return ds.classes, tuple(ds.x.shape[1:]), int(ds.meta.get("vocab", 0)), ds.meta


def _inputs(family, n=8, seed=3):
    nc, shape, vocab, _ = _arch(family)
    rng = np.random.default_rng(seed)
    if family == "densenet":
        return rng.uniform(0, 1, size=(n,) + shape).astype(np.float32)
    return rng.integers(0, vocab, size=(n,) + shape).astype(np.int32)


def init_blob(family, seed=0) -> bytes:
    """A float32 params blob drawn by the flax module's own init, with the
    dataset's meta (the text templates size their embedding from its
    ``vocab``): both packages load it, so both start from one set of
    params."""
    nc, shape, vocab, meta = _arch(family)
    module = FAMILIES[family][4](jnp.float32, nc, vocab)
    dummy = jnp.zeros((1,) + shape, jnp.float32 if family == "densenet" else jnp.int32)
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), dummy)["params"]
    flat = {k: torch.from_numpy(np.array(v)) for k, v in flatten_dict(params, sep="/").items()}
    return pickle.dumps({"arch": (nc, shape), "packed": dump_flat(flat, cast_f32_to_bf16=False),
                         "dataset_meta": {k: v for k, v in meta.items() if k == "vocab"}})


class _Blobs(dict):
    """Each family's init blob, drawn on first use."""

    def __missing__(self, family):
        self[family] = init_blob(family)
        return self[family]


BLOBS = _Blobs()


def _flat(blob):
    return load_flat(pickle.loads(blob)["packed"])


def _f32_pair(family):
    """float32 subclasses of the family's two templates."""
    jax_cls, port_cls, _, _, jax_mod, port_mod = FAMILIES[family]

    class JaxF32(jax_cls):
        def build_module(self, num_classes, input_shape):
            return jax_mod(jnp.float32, num_classes, max(int(self._dataset_meta.get("vocab", 2)), 2))

    class PortF32(port_cls):
        def build_module(self, num_classes, input_shape):
            return port_mod(torch.float32, num_classes,
                            max(int(self._dataset_meta.get("vocab", 2)), 2))

    return JaxF32, PortF32


# -- forwards -----------------------------------------------------------------

# float32 logits, the same params and inputs, max abs. Readings: DenseNet
# 1.1e-6, Transformer 4.8e-7, PosBiLstm 4.8e-8 (sums in other orders).
# Bounds: about 3x.
F32_LOGIT_ATOL = {"densenet": 3e-6, "transformer": 1.5e-6, "pos_bilstm": 1.5e-7}
# bf16 logits (the models as they ship) against the JAX package's (jit,
# XLA's default CPU flags), in units of one bf16 ulp at the largest
# logit: the packages round at other places (XLA keeps some values in
# float32 where flax's dtype says bf16; the port takes the softmax of
# bf16 attention scores in float32 and rounds once), so a logit may end
# an ulp or two away. Readings: DenseNet 7.8e-3 (1 ulp), Transformer
# 1.6e-2 (1 ulp), PosBiLstm 0 (its cells run in float32 in both); the
# JAX package's own bf16 against float32 logits: 5.2e-3, 8.9e-3 and
# 5.5e-4.
BF16_LOGIT_ULPS = 2


def _bf16_ulp(x: np.ndarray) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_matches_jax(family):
    nc, _, vocab, _ = _arch(family)
    x = _inputs(family)
    flat = _flat(BLOBS[family])
    tree = load_pytree(pickle.loads(BLOBS[family])["packed"])
    out = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        ref = jax.jit(FAMILIES[family][4](jdt, nc, vocab).apply)({"params": tree}, jnp.asarray(x))
        module = FAMILIES[family][5](tdt, nc, vocab)
        module.load_state_dict(flax_to_state_dict(flat, module))
        with torch.no_grad():
            got = module(torch.from_numpy(x))
        assert got.dtype == tdt and tuple(got.shape) == tuple(ref.shape)
        out[name] = (np.asarray(ref.astype(jnp.float32)), got.float().numpy())
    r = {"f32": float(np.abs(out["f32"][0] - out["f32"][1]).max()),
         "bf16": float(np.abs(out["bf16"][0] - out["bf16"][1]).max()),
         "jax_bf16_vs_f32": float(np.abs(out["bf16"][0] - out["f32"][0]).max()),
         "port_bf16_vs_f32": float(np.abs(out["bf16"][1] - out["f32"][1]).max())}
    print(family, r)
    assert r["f32"] <= F32_LOGIT_ATOL[family], r
    assert r["bf16"] <= BF16_LOGIT_ULPS * _bf16_ulp(out["bf16"][0]), r


def test_embed_out_of_range_ids_give_nan_as_flax_does():
    from rafiki_tpu_torch.ops.layers import embed

    w = torch.arange(15, dtype=torch.float32).reshape(5, 3)
    ids = torch.tensor([0, 4, 5, -1, -5, -6, 7], dtype=torch.int32)
    got = embed(ids, w, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got[[0, 1, 3, 4]].float().numpy(),
                                  w[[0, 4, 4, 0]].numpy())
    assert torch.isnan(got[[2, 5, 6]]).all()


# -- the model contract (tests/test_zoo.py's runs and floors) ---------------------

POS_TRAIN, POS_TEST = CORPUS.format(n=128, seed=0), CORPUS.format(n=64, seed=1)
IMG_TRAIN, IMG_TEST = IMG.format(n=256, seed=0), IMG.format(n=128, seed=1)


def test_densenet_contract():
    score, _ = test_model_class(
        DenseNet, "IMAGE_CLASSIFICATION", IMG_TRAIN, IMG_TEST, device="cpu",
        knobs=dict(depth=22, growth=12, learning_rate=3e-3, batch_size=64, epochs=4, seed=0))
    assert score > 0.4


def test_transformer_contract():
    score, preds = test_model_class(
        Transformer, "TEXT_CLASSIFICATION", TEXT.format(n=512, seed=0),
        TEXT.format(n=128, seed=1), queries=[[5, 9, 3] * 5 + [1], [17, 2] * 8], device="cpu",
        knobs=dict(embed_dim=32, num_heads=2, num_layers=1, learning_rate=5e-3,
                   batch_size=32, epochs=3, seed=0))
    assert score > 0.5
    assert len(preds[0]) == 5 and abs(sum(preds[0]) - 1.0) < 1e-5


def test_pos_bilstm_contract():
    score, preds = test_model_class(
        PosBiLstm, "POS_TAGGING", POS_TRAIN, POS_TEST, queries=[[5, 9, 3], [17, 2]],
        device="cpu",
        knobs=dict(embed_dim=32, hidden=32, learning_rate=5e-3, batch_size=32, epochs=8, seed=0))
    assert score > 0.5
    assert [len(p) for p in preds] == [3, 2]


def test_pos_hmm_contract_and_predictions_equal_the_jax_packages():
    queries = [[5, 9, 3], [17, 2, 79, 1, 0], []]
    knobs = dict(smoothing=0.1, seed=0)
    score, preds = test_model_class(PosBigramHmm, "POS_TAGGING", POS_TRAIN, POS_TEST,
                                    queries=queries, knobs=knobs, device="cpu")
    ref_score, ref_preds = jax_test_model_class(JaxHmm, "POS_TAGGING", POS_TRAIN, POS_TEST,
                                                queries=queries, knobs=knobs)
    assert score > 0.5 and score == ref_score
    assert preds == ref_preds and [len(p) for p in preds] == [3, 5, 0]


@pytest.mark.parametrize("name,knobs,floor", [
    ("SkDt", dict(max_depth=8, criterion="gini", seed=0), 0.3),
    ("SkSvm", dict(C=1.0, kernel="linear", seed=0), 0.5),
])
def test_sk_contract_and_predictions_equal_the_jax_packages(name, knobs, floor):
    pytest.importorskip("sklearn")
    queries = [np.zeros((16, 16, 3), np.float32),
               port_dataset.dataset_utils.load(IMG_TEST).x[0]]
    score, preds = test_model_class(get_model_class(name), "IMAGE_CLASSIFICATION", IMG_TRAIN,
                                    IMG_TEST, queries=queries, knobs=knobs, device="cpu")
    ref_score, ref_preds = jax_test_model_class(jax_get_model_class(name), "IMAGE_CLASSIFICATION",
                                                IMG_TRAIN, IMG_TEST, queries=queries,
                                                knobs=knobs)
    assert score > floor and score == ref_score
    assert preds == ref_preds and abs(sum(preds[0]) - 1.0) < 1e-6


# -- datasets, byte for byte ------------------------------------------------------


def _corpus_zip(path, sentences):
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("data/corpus.tsv", "\n\n".join(
            "\n".join(f"{tok}\t{tag}" for tok, tag in s) for s in sentences) + "\n")
    return str(path)


def _image_zip(path, rng):
    from PIL import Image

    rows = ["path,class"]
    with zipfile.ZipFile(path, "w") as zf:
        for i in range(6):
            arr = rng.integers(0, 256, size=(5, 4, 3) if i % 2 else (5, 4), dtype=np.uint8)
            if i % 2 == 0:
                arr = np.stack([arr] * 3, -1)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="PNG")
            zf.writestr(f"img/{i}.png", buf.getvalue())
            rows.append(f"img/{i}.png,{i % 3}")
        zf.writestr("images.csv", "\n".join(rows) + "\n")
    return str(path)


@pytest.mark.parametrize("uri", [
    CORPUS.format(n=64, seed=0),
    "synthetic://corpus?vocab=200&tags=10&n=33&len=24&seed=3&noise=0.2&dist=4",
    "synthetic://corpus",
    TEXT.format(n=64, seed=0),
    "synthetic://text?vocab=30&classes=3&n=17&len=7&seed=2&noise=0.5&dist=9",
    "synthetic://text",
    "corpus.zip", "corpus.npz", "text.npz", "images.zip",
])
def test_datasets_give_the_jax_loaders_bytes(uri, tmp_path):
    if uri == "corpus.zip":
        uri = _corpus_zip(tmp_path / uri, [[("The", "DET"), ("cat", "NOUN"), ("sat", "VERB")],
                                           [("A", "DET"), ("dog", "NOUN")] * 40,
                                           [("runs", "VERB")]])
    elif uri.endswith(".npz"):
        src = port_dataset.dataset_utils.load(
            CORPUS.format(n=20, seed=5) if uri == "corpus.npz" else TEXT.format(n=20, seed=5))
        uri = port_dataset.DatasetUtils.save_npz(src, str(tmp_path / uri))
        ref_npz = jax_dataset.DatasetUtils.save_npz(src, str(tmp_path / ("jax-" + uri.split("/")[-1])))
        assert open(ref_npz, "rb").read() and open(uri, "rb").read()
    elif uri == "images.zip":
        pytest.importorskip("PIL")
        uri = _image_zip(tmp_path / uri, np.random.default_rng(0))
    ref = jax_dataset.DatasetUtils().load(uri)
    got = port_dataset.DatasetUtils().load(uri)
    for key in ("x", "y", "mask"):
        a, b = getattr(got, key), getattr(ref, key)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert got.classes == ref.classes and got.meta == ref.meta
    for kw in (dict(batch_size=16, shuffle=True, seed=4),
               dict(batch_size=16, drop_remainder=False)):
        for a, b in zip(got.batches(**kw), ref.batches(**kw), strict=True):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_corpus_token_ids_are_the_jax_packages():
    toks = ["the", "The", "", "naïve", "x" * 100]
    assert [port_dataset.corpus_token_id(t) for t in toks] == \
        [jax_dataset.corpus_token_id(t) for t in toks]


# -- the weight carrier and the init ----------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_convert_round_trips_each_tree(family):
    """flax names and shapes of the port's modules are the flax init's,
    and a tree carried in and out comes back bit for bit."""
    nc, _, vocab, _ = _arch(family)
    flat = _flat(BLOBS[family])
    module = FAMILIES[family][5](torch.bfloat16, nc, vocab)
    out = state_dict_to_flax(module)
    assert sorted(out) == sorted(flat)
    assert all(tuple(out[k].shape) == tuple(flat[k].shape) for k in flat)
    module.load_state_dict(flax_to_state_dict(flat, module))
    back = state_dict_to_flax(module)
    assert all(torch.equal(back[k], flat[k]) for k in flat)
    # A blob of the port's trial loads into the JAX package's template.
    m = FAMILIES[family][1](device="cpu", **FAMILIES[family][2])
    m.load_parameters(BLOBS[family])
    ref = FAMILIES[family][0](**FAMILIES[family][2])
    ref.load_parameters(m.dump_parameters())
    x = _inputs(family, n=4)
    got_p, ref_p = m.predict(x.tolist()), ref.predict(x.tolist())
    if family == "pos_bilstm":
        assert got_p == ref_p
    else:
        # bf16 blobs served by the two packages (test_torch_vgg's bound).
        np.testing.assert_allclose(np.asarray(got_p), np.asarray(ref_p), rtol=0, atol=5e-3)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_draws_flax_distributions(family):
    """The port's seeded init against flax's init: the same leaves, each
    large kernel with its standard deviation within 10% of flax's
    (lecun_normal, the embedding's normal of variance 1/E, pos_embed's
    0.02), recurrent kernels orthogonal, biases 0 and norm scales 1."""
    nc, _, vocab, _ = _arch(family)
    ref = {k: v.numpy() for k, v in _flat(BLOBS[family]).items()}
    module = FAMILIES[family][5](torch.float32, nc, vocab)
    _lecun_init(module, torch.Generator().manual_seed(0))
    got = {k: v.detach().numpy() for k, v in state_dict_to_flax(module).items()}
    assert sorted(got) == sorted(ref)
    for k, a in got.items():
        b = ref[k]
        if k.endswith(("bias", "scale")):
            np.testing.assert_array_equal(a, b)
        elif a.size >= 1024:
            assert abs(a.std() / b.std() - 1.0) < 0.1, (k, a.std(), b.std())
        if "LSTMCell" in k and k.split("/")[1].startswith("h") and k.endswith("kernel"):
            np.testing.assert_allclose(a.T @ a, np.eye(a.shape[0]), atol=1e-5)


# -- the registry -----------------------------------------------------------------


def test_registry_resolves_every_name_of_the_jax_packages(monkeypatch):
    assert sorted(MODEL_REGISTRY) == sorted(JAX_REGISTRY)
    for name in MODEL_REGISTRY:
        cls = get_model_class(name)
        assert cls.__name__ == JAX_REGISTRY[name][1]
        assert cls.__module__.startswith("rafiki_tpu_torch.models.")
        assert sorted(cls.get_knob_config()) == sorted(
            jax_get_model_class(name).get_knob_config())
    with pytest.raises(ValueError, match="Unknown model template"):
        get_model_class("Nope")
    # Where scikit-learn is missing (the card's machine), its templates
    # raise the reference's error.
    import rafiki_tpu_torch.models as zoo

    monkeypatch.setitem(zoo._REQUIRES, "SkDt", "no_such_library_here")
    with pytest.raises(ValueError, match="'SkDt' is not available: No module named"):
        get_model_class("SkDt")



# -- serving and tuning -----------------------------------------------------------


@pytest.mark.parametrize("family", ["densenet", "transformer"])
def test_stacked_route_serves_what_each_trial_serves(family):
    """Two trials of one architecture behind the stacked route (one
    vmapped forward, each new layer run once per member): bf16 as
    shipped, each member's probabilities equal to its own serial
    forward's bit for bit, and the served ensemble their mean."""
    from rafiki_tpu_torch.parallel.serving import build_stacked

    jax_cls, port_cls, knobs = FAMILIES[family][:3]
    nc, shape, _, _ = _arch(family)
    models = []
    for seed in range(2):
        m = port_cls(device="cpu", **knobs)
        m._dataset_meta = {"vocab": 81} if family == "transformer" else {}
        m.init_parameters(nc, shape, torch.Generator().manual_seed(seed))
        models.append(m)
    x = _inputs(family, n=5)
    want = [m.predict_proba(x) for m in models]
    stacked, reason = build_stacked([{"model_name": family}] * 2, models, batch_size=8)
    assert reason == "stacked"
    with torch.inference_mode():
        got = stacked._ens.forward(torch.from_numpy(x)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], want[i])
    served = np.asarray(stacked.predict(x.tolist()))
    np.testing.assert_allclose(served, np.mean(want, axis=0), rtol=0, atol=1e-6)


def test_tune_model_takes_the_text_and_tagging_tasks():
    from rafiki_tpu_torch.model.dev import tune_model

    for cls, pattern in ((Transformer, TEXT), (PosBiLstm, CORPUS)):
        best, score, records = tune_model(cls, pattern.format(n=64, seed=0),
                                          pattern.format(n=32, seed=1), total_trials=2,
                                          advisor="random", seed=0, device="cpu")
        assert [r["status"] for r in records] == ["COMPLETED"] * 2, records
        assert 0.0 <= score <= 1.0 and set(best) == set(cls.get_knob_config())
