"""Host-side scikit-learn templates.

The port's own copy of ``rafiki_tpu/models/sk.py``: a decision tree and
an SVM on flattened images, on the host CPU, which show that the model
contract assumes no deep-learning framework. scikit-learn is imported
only when a classifier is made (``_make_clf``), so this module imports
without it; the registry (``models/__init__.py``) reports these
templates as not available where scikit-learn is missing.
"""

from __future__ import annotations

import pickle
from typing import Any, List

import numpy as np

from rafiki_tpu_torch.model.base import BaseModel
from rafiki_tpu_torch.model.dataset import dataset_utils
from rafiki_tpu_torch.model.knobs import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob


class _SkImageModel(BaseModel):
    """Shared plumbing: flatten images, fit an sklearn classifier."""

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self._clf = None
        self._classes = None

    def _make_clf(self):
        raise NotImplementedError

    def train(self, dataset_uri: str) -> None:
        ds = dataset_utils.load(dataset_uri)
        x = ds.x.reshape((ds.size, -1))
        self._clf = self._make_clf()
        self._clf.fit(x, ds.y)
        self._classes = ds.classes

    def evaluate(self, dataset_uri: str) -> float:
        ds = dataset_utils.load(dataset_uri)
        x = ds.x.reshape((ds.size, -1))
        return float((self._clf.predict(x) == ds.y).mean())

    def predict(self, queries: List[Any]) -> List[List[float]]:
        x = np.asarray(queries, dtype=np.float32).reshape((len(queries), -1))
        if hasattr(self._clf, "predict_proba"):
            probs = self._clf.predict_proba(x)
            # align to full class range (sklearn drops absent classes)
            out = np.zeros((len(queries), self._classes))
            out[:, self._clf.classes_] = probs
            return out.tolist()
        preds = self._clf.predict(x)
        out = np.zeros((len(queries), self._classes))
        out[np.arange(len(queries)), preds] = 1.0
        return out.tolist()

    def dump_parameters(self) -> bytes:
        return pickle.dumps({"clf": self._clf, "classes": self._classes})

    def load_parameters(self, blob: bytes) -> None:
        payload = pickle.loads(blob)
        self._clf = payload["clf"]
        self._classes = payload["classes"]


class SkDt(_SkImageModel):
    """Decision tree (reference: SkDt.py)."""

    @staticmethod
    def get_knob_config():
        return {
            "max_depth": IntegerKnob(2, 16),
            "criterion": CategoricalKnob(["gini", "entropy"]),
            "seed": FixedKnob(0),
        }

    def _make_clf(self):
        from sklearn.tree import DecisionTreeClassifier

        return DecisionTreeClassifier(
            max_depth=int(self.knobs["max_depth"]),
            criterion=self.knobs["criterion"],
            random_state=int(self.knobs["seed"]),
        )


class SkSvm(_SkImageModel):
    """Linear/RBF SVM (reference: SkSvm.py)."""

    @staticmethod
    def get_knob_config():
        return {
            "C": FloatKnob(1e-2, 1e2, is_exp=True),
            "kernel": CategoricalKnob(["linear", "rbf"]),
            "seed": FixedKnob(0),
        }

    def _make_clf(self):
        from sklearn.svm import SVC

        # No probability=True (deprecated in sklearn 1.9): predictions
        # ensemble as one-hot votes via the predict() fallback path.
        return SVC(C=float(self.knobs["C"]), kernel=self.knobs["kernel"],
                   random_state=int(self.knobs["seed"]))
