"""Model zoo: the port's templates and their registry.

Counterpart of ``rafiki_tpu/models/__init__.py``, with the reference's
names and the port's modules:

  FeedForward  (MLP, MNIST-class images)        models/ff.py
  Vgg          (VGG CNN, CIFAR-10-class images) models/vgg.py
  DenseNet     (DenseNet-BC CNN, CIFAR-10)      models/densenet.py
  SkDt / SkSvm (scikit-learn host models)       models/sk.py
  PosBiLstm    (BiLSTM POS tagger)              models/pos_bilstm.py
  PosBigramHmm (bigram HMM POS tagger, host)    models/pos_hmm.py
  Transformer  (text-classifier encoder)        models/transformer.py

``get_model_class`` imports a template's module on first use. A
template whose module or declared library does not import here raises
the reference's ``ValueError(... is not available ...)``: the
scikit-learn templates import scikit-learn only to fit, so the
registry checks for it itself.
"""

from rafiki_tpu_torch.models.ff import FeedForward

__all__ = ["FeedForward"]

MODEL_REGISTRY = {
    "FeedForward": ("rafiki_tpu_torch.models.ff", "FeedForward"),
    "Vgg": ("rafiki_tpu_torch.models.vgg", "Vgg"),
    "DenseNet": ("rafiki_tpu_torch.models.densenet", "DenseNet"),
    "SkDt": ("rafiki_tpu_torch.models.sk", "SkDt"),
    "SkSvm": ("rafiki_tpu_torch.models.sk", "SkSvm"),
    "PosBiLstm": ("rafiki_tpu_torch.models.pos_bilstm", "PosBiLstm"),
    "PosBigramHmm": ("rafiki_tpu_torch.models.pos_hmm", "PosBigramHmm"),
    "Transformer": ("rafiki_tpu_torch.models.transformer", "Transformer"),
}

# Libraries a template needs beyond its module's own imports.
_REQUIRES = {"SkDt": "sklearn", "SkSvm": "sklearn"}


def get_model_class(name: str) -> type:
    import importlib
    import importlib.util

    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model template {name!r}; known: {sorted(MODEL_REGISTRY)}")
    mod_name, cls_name = MODEL_REGISTRY[name]
    try:
        required = _REQUIRES.get(name)
        if required is not None and importlib.util.find_spec(required) is None:
            raise ModuleNotFoundError(f"No module named {required!r}", name=required)
        return getattr(importlib.import_module(mod_name), cls_name)
    except ModuleNotFoundError as e:
        raise ValueError(f"Model template {name!r} is not available: {e}") from e
