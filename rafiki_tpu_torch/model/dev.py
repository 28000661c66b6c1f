"""Model-developer harness: run the full trial loop locally.

The port's own copy of ``rafiki_tpu/model/dev.py``: ``test_model_class``
(init -> train -> evaluate -> dump -> load -> predict, with the
contract checks) and ``tune_model`` (a local advisor-driven knob
search, the in-process miniature of a train job). Both take a
``device``: the CPU only on request, else the enclosing
``utils.backend.default_device`` scope's device, else the CUDA card;
every model is built inside ``default_device(device)``, so a template
takes no device argument.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from rafiki_tpu_torch.model.base import BaseModel
from rafiki_tpu_torch.model.knobs import Knobs, sample_knobs, validate_knobs
from rafiki_tpu_torch.utils.backend import DeviceLike, default_device


def test_model_class(model_class: type, task: str, train_dataset_uri: str,
                     test_dataset_uri: str, queries: Optional[List[Any]] = None,
                     knobs: Optional[Knobs] = None, seed: int = 0,
                     device: DeviceLike = None) -> Tuple[float, List[Any]]:
    # (name matches the reference API; the attribute below stops pytest
    # from collecting it as a test function when imported)
    """Run one full trial in-process on ``device``; raises on contract
    violations.

    Returns (score, predictions). Mirrors the reference harness's
    checks: knob config sanity, train/evaluate, params round-trip, and
    predict on the given queries via a *fresh* instance.
    """
    knob_config = model_class.get_knob_config()
    if not isinstance(knob_config, dict) or not knob_config:
        raise ValueError("get_knob_config() must return a non-empty dict of knobs")
    rng = np.random.default_rng(seed)
    knobs = validate_knobs(knob_config, knobs or sample_knobs(knob_config, rng))

    with default_device(device):
        t0 = time.monotonic()
        model: BaseModel = model_class(**knobs)
        try:
            model.train(train_dataset_uri)
            score = model.evaluate(test_dataset_uri)
            if not isinstance(score, float):
                raise ValueError(f"evaluate() must return float, got {type(score).__name__}")
            blob = model.dump_parameters()
            if not isinstance(blob, (bytes, bytearray)):
                raise ValueError("dump_parameters() must return bytes")
        finally:
            model.destroy()

        # Round-trip into a fresh instance, as the inference worker will.
        fresh: BaseModel = model_class(**knobs)
        try:
            fresh.load_parameters(bytes(blob))
            score2 = fresh.evaluate(test_dataset_uri)
            if abs(score2 - score) > 0.05:
                raise ValueError(
                    f"params round-trip drifted: evaluate {score:.4f} -> {score2:.4f}")
            predictions = fresh.predict(list(queries)) if queries is not None else []
        finally:
            fresh.destroy()
    elapsed = time.monotonic() - t0
    print(f"[test_model_class] {model_class.__name__}: score={score:.4f} "
          f"round_trip={score2:.4f} trial_time={elapsed:.1f}s knobs={knobs}")
    return score, predictions


test_model_class.__test__ = False  # not a pytest case despite the name


def tune_model(model_class: type, train_dataset_uri: str, test_dataset_uri: str,
               total_trials: int = 5, advisor: str = "gp", seed: int = 0,
               device: DeviceLike = None) -> Tuple[Knobs, float, List[Dict]]:
    """Local advisor-driven knob search (one device, one process).

    Returns (best_knobs, best_score, trial_records).
    """
    from rafiki_tpu_torch.advisor import make_advisor

    adv = make_advisor(model_class.get_knob_config(), kind=advisor, seed=seed)
    records: List[Dict] = []
    with default_device(device):
        for i in range(total_trials):
            knobs = adv.propose()
            t0 = time.monotonic()
            model = None
            try:
                model = model_class(**knobs)
                model.train(train_dataset_uri)
                score = float(model.evaluate(test_dataset_uri))
                status = "COMPLETED"
            except Exception as e:  # containment: a bad knob config must not kill the loop
                score, status = 0.0, f"ERRORED: {e}"
            finally:
                if model is not None:
                    model.destroy()
            adv.feedback(score, knobs)
            records.append({"no": i, "knobs": knobs, "score": score,
                            "time_s": time.monotonic() - t0, "status": status})
    best_knobs, best_score = adv.best()
    return best_knobs, best_score, records
