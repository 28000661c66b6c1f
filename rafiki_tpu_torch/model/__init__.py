"""Model contract, knob system, dataset utilities and dev harness.

Counterpart of ``rafiki_tpu/model``: the same names, with ``TorchModel``
in the place of ``JaxModel``.
"""

from rafiki_tpu_torch.model.base import (
    BaseModel,
    TorchModel,
    load_model_class,
    parse_model_install_command,
)
from rafiki_tpu_torch.model.dataset import Dataset, dataset_utils
from rafiki_tpu_torch.model.dev import test_model_class, tune_model
from rafiki_tpu_torch.model.knobs import (
    BaseKnob,
    CategoricalKnob,
    FixedKnob,
    FloatKnob,
    IntegerKnob,
    deserialize_knob_config,
    knob_config_signature,
    serialize_knob_config,
    validate_knobs,
)
from rafiki_tpu_torch.model.log import ModelLogger, logger

__all__ = [
    "BaseKnob",
    "FixedKnob",
    "CategoricalKnob",
    "IntegerKnob",
    "FloatKnob",
    "serialize_knob_config",
    "deserialize_knob_config",
    "knob_config_signature",
    "validate_knobs",
    "BaseModel",
    "TorchModel",
    "load_model_class",
    "parse_model_install_command",
    "Dataset",
    "dataset_utils",
    "ModelLogger",
    "logger",
    "test_model_class",
    "tune_model",
]
