"""Packs of the rest of the model zoo in the port, on the CPU: DenseNet
and Transformer packs of two against their serial trials (bit for bit)
and against the JAX package (float32, from the same flax-drawn params),
and the corpus datasets' refusal. Each tolerance stands next to the
readings that set it.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rafiki_tpu.utils.serial import load_pytree
from rafiki_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from rafiki_tpu_torch.model.log import logger as port_logger
from rafiki_tpu_torch.models.pos_bilstm import PosBiLstm
from rafiki_tpu_torch.ops import train as port_train
from tests.test_torch_zoo import BLOBS, CORPUS, FAMILIES, _f32_pair, _flat
from tests.test_torch_zoo_train import _f32_tol, _zero_gradient_leaves

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)


PACK_FAMILIES = ("densenet", "transformer")
PACK_MEMBERS = [(1e-3, 0), (3e-3, 5)]  # (learning rate, seed)


def _pack_model(family, lr, seed, cls=None, side="port"):
    cls = cls or FAMILIES[family][1]
    knobs = dict(FAMILIES[family][2], learning_rate=lr, epochs=2)
    m = cls(**knobs) if side == "jax" else cls(device="cpu", **knobs)
    m._seed = seed  # the seed knob is fixed at 0; trials differ in their seed
    return m


def _port_params(m):
    return {k: v.detach().clone() for k, v in state_dict_to_flax(m._module).items()}


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("family", PACK_FAMILIES)
def test_pack2_matches_serial_trials(family, dtype):
    """Two members (other seeds and learning rates) as one pack against
    two serial trials, two epochs of 2 steps, in bf16 as shipped and in
    float32 (where a norm that read its input twice would sum that
    input's gradients in another order in a pack: ``ops/layers.py``
    group_norm). Readings: histories, params and scores equal; the
    bound is the reading."""
    cls = FAMILIES[family][1] if dtype == "bf16" else _f32_pair(family)[1]
    train = FAMILIES[family][3].format(n=64, seed=0)
    val = FAMILIES[family][3].format(n=40, seed=1)
    serial = []
    for lr, seed in PACK_MEMBERS:
        m = _pack_model(family, lr, seed, cls)
        logs = []
        with port_logger.capture(logs.append):
            m.train(train)
        serial.append((m, [e["values"] for e in logs if e["type"] == "values"], m.evaluate(val)))
    models = [_pack_model(family, lr, seed, cls) for lr, seed in PACK_MEMBERS]
    histories = cls.train_packed(models, train)
    scores = cls.evaluate_packed(models, val)
    assert all(isinstance(m._loop, port_train.PackedSliceLoop) for m in models)
    for m, h, score, (want, want_h, want_score) in zip(models, histories, scores, serial):
        assert h == want_h and score == want_score
        got, ref = _port_params(m), _port_params(want)
        assert all(torch.equal(got[k], ref[k]) for k in got)


def _const_pair(family):
    """float32 templates of both packages whose every trial starts from
    the family's blob, whatever its seed."""
    jax_f32, port_f32 = _f32_pair(family)
    tree = load_pytree(pickle.loads(BLOBS[family])["packed"])
    flat = _flat(BLOBS[family])

    class JaxConst(jax_f32):
        def _loop_fns(self, num_classes, input_shape):
            return dict(super()._loop_fns(num_classes, input_shape),
                        init_fn=lambda rng: jax.tree.map(jnp.asarray, tree))

    class PortConst(port_f32):
        def _loop_fns(self, num_classes, input_shape):
            fns = super()._loop_fns(num_classes, input_shape)
            module = fns["module"]
            sd = flax_to_state_dict(flat, module)

            def init_fn(_generator):
                module.load_state_dict(sd)
                return module

            return dict(fns, init_fn=init_fn)

    return JaxConst, PortConst


@pytest.mark.parametrize("family", PACK_FAMILIES)
def test_port_pack_matches_the_jax_package_in_float32(family):
    """The two members through the port's pack and the JAX package's,
    float32 from the same params (their seeds still differ, so each
    shuffles its own way), held to the serial tolerances above. The JAX
    package's
    ``train_packed`` builds a Transformer pack's module before its
    members read the dataset's vocab (an embedding of 2 rows: the pack
    trains to NaN), so the port's Transformer pack is held to the JAX
    package's serial trials. Readings (max over the members, two epochs
    of 2 steps): DenseNet loss 1.4e-7 rel, params 2.0e-3 max abs and
    2.4e-3 of the distance moved; Transformer (its key bias aside)
    8.4e-8, 2.4e-7 and 1.0e-6; accuracies and scores equal."""
    jax_cls, port_cls = _const_pair(family)
    train = FAMILIES[family][3].format(n=64, seed=0)
    val = FAMILIES[family][3].format(n=40, seed=1)
    start = {k: v.float().numpy() for k, v in _flat(BLOBS[family]).items()}
    models = [_pack_model(family, lr, s, port_cls) for lr, s in PACK_MEMBERS]
    histories = port_cls.train_packed(models, train)
    got = [{"history": h, "score": s, "params": {k: v.numpy() for k, v in _port_params(m).items()}}
           for m, h, s in zip(models, histories, port_cls.evaluate_packed(models, val))]
    refs = [_pack_model(family, lr, s, jax_cls, "jax") for lr, s in PACK_MEMBERS]
    if family == "densenet":
        histories = jax_cls.train_packed(refs, train)
        scores = jax_cls.evaluate_packed(refs, val)
    else:
        histories, scores = [], []
        for m in refs:
            logs = []
            from rafiki_tpu.model.log import logger

            with logger.capture(logs.append):
                m.train(train)
            histories.append([e["values"] for e in logs if e["type"] == "values"])
            scores.append(m.evaluate(val))
    want = [{"history": h, "score": s,
             "params": {k: np.asarray(v) for k, v in flatten_dict(m._loop.params, sep="/").items()}}
            for m, h, s in zip(refs, histories, scores)]
    _zero_gradient_leaves(want + got, start, max(lr for lr, _ in PACK_MEMBERS), 4)
    r = {"loss_rel": 0.0, "acc": 0.0, "score": 0.0, "param_max_abs": 0.0, "param_rel_l2": 0.0}
    for a, b in zip(want, got):
        assert [e["epoch"] for e in a["history"]] == [e["epoch"] for e in b["history"]] == [0, 1]
        for ea, eb in zip(a["history"], b["history"]):
            r["loss_rel"] = max(r["loss_rel"], abs(ea["loss"] - eb["loss"]) / abs(ea["loss"]))
            r["acc"] = max(r["acc"], abs(ea["acc"] - eb["acc"]))
        r["score"] = max(r["score"], abs(a["score"] - b["score"]))
        pa, pb = a["params"], b["params"]
        r["param_max_abs"] = max(r["param_max_abs"],
                                 max(float(np.abs(pa[k] - pb[k]).max()) for k in pa))
        num = np.sqrt(sum(float(((pa[k] - pb[k]) ** 2).sum()) for k in pa))
        den = np.sqrt(sum(float(((pa[k] - start[k]) ** 2).sum()) for k in pa))
        r["param_rel_l2"] = max(r["param_rel_l2"], float(num / den))
    print(family, r)
    for key in r:
        assert r[key] <= _f32_tol(family)[key], (key, r)


def test_corpus_trials_do_not_pack():
    """A corpus dataset has a mask: its trials are fed from the host and
    refused by ``train_packed``, as in the JAX package."""
    models = [_pack_model("pos_bilstm", lr, s) for lr, s in PACK_MEMBERS]
    with pytest.raises(ValueError, match="masked"):
        PosBiLstm.train_packed(models, CORPUS.format(n=64, seed=0))
    assert PosBiLstm.packable()  # the template may pack; its datasets may not


