"""Declarative hyperparameter ("knob") space.

The port's own copy of ``rafiki_tpu/model/knobs.py`` (pure Python; the
port imports nothing of the JAX package).

Reference parity: rafiki/model/knob.py (unverified path): FixedKnob,
CategoricalKnob, IntegerKnob(min,max), FloatKnob(min,max,is_exp) with
JSON (de)serialization so the advisor can consume the space.

TPU-native additions:
  * every knob declares whether it affects compiled program shapes
    (`affects_shape`) — the trial runner uses this to key the XLA
    compilation cache and the scheduler uses it to bucket proposals so
    recompiles are amortized (SURVEY.md §7 "compile-time vs trial
    throughput").
  * `knob_config_signature` gives a stable hash of the static
    (shape-affecting) part of a knob config.
"""

from __future__ import annotations

import hashlib
import json
import math
from typing import Any, Dict, List

KnobConfig = Dict[str, "BaseKnob"]
Knobs = Dict[str, Any]


class BaseKnob:
    """A declared hyperparameter dimension."""

    #: whether a change in this knob changes traced array shapes (and
    #: therefore forces an XLA recompile of the trial program)
    affects_shape: bool = False

    def validate(self, value) -> None:
        raise NotImplementedError

    def sample(self, rng) -> Any:
        """Draw a uniform random value (numpy Generator rng)."""
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_json(obj: dict) -> "BaseKnob":
        ktype = obj["type"]
        cls = _KNOB_TYPES.get(ktype)
        if cls is None:
            raise ValueError(f"Unknown knob type: {ktype!r}")
        return cls._from_json(obj)

    def __repr__(self):
        return f"{type(self).__name__}({self.to_json()})"

    def __eq__(self, other):
        return type(self) is type(other) and self.to_json() == other.to_json()


class FixedKnob(BaseKnob):
    """A constant exposed through the knob system (not tuned)."""

    def __init__(self, value, affects_shape: bool = False):
        self.value = value
        self.affects_shape = affects_shape

    def validate(self, value):
        if value != self.value:
            raise ValueError(f"FixedKnob expects {self.value!r}, got {value!r}")

    def sample(self, rng):
        return self.value

    def to_json(self):
        return {"type": "fixed", "value": self.value, "affects_shape": self.affects_shape}

    @classmethod
    def _from_json(cls, obj):
        return cls(obj["value"], obj.get("affects_shape", False))


class CategoricalKnob(BaseKnob):
    def __init__(self, values: List[Any], affects_shape: bool = False):
        if not values:
            raise ValueError("CategoricalKnob needs at least one value")
        self.values = list(values)
        self.affects_shape = affects_shape

    def validate(self, value):
        if value not in self.values:
            raise ValueError(f"{value!r} not in categorical values {self.values!r}")

    def sample(self, rng):
        return self.values[int(rng.integers(0, len(self.values)))]

    def to_json(self):
        return {"type": "categorical", "values": self.values, "affects_shape": self.affects_shape}

    @classmethod
    def _from_json(cls, obj):
        return cls(obj["values"], obj.get("affects_shape", False))


class IntegerKnob(BaseKnob):
    def __init__(self, value_min: int, value_max: int, is_exp: bool = False, affects_shape: bool = False):
        if value_min > value_max:
            raise ValueError("value_min > value_max")
        if is_exp and value_min <= 0:
            raise ValueError("log-scale IntegerKnob requires value_min > 0")
        self.value_min = int(value_min)
        self.value_max = int(value_max)
        self.is_exp = is_exp
        self.affects_shape = affects_shape

    def validate(self, value):
        if not isinstance(value, (int,)) or isinstance(value, bool):
            raise ValueError(f"IntegerKnob expects int, got {type(value).__name__}")
        if not (self.value_min <= value <= self.value_max):
            raise ValueError(f"{value} outside [{self.value_min}, {self.value_max}]")

    def sample(self, rng):
        if self.is_exp:
            lo, hi = math.log(self.value_min), math.log(self.value_max)
            return int(round(math.exp(rng.uniform(lo, hi))))
        return int(rng.integers(self.value_min, self.value_max + 1))

    def to_json(self):
        return {
            "type": "integer",
            "value_min": self.value_min,
            "value_max": self.value_max,
            "is_exp": self.is_exp,
            "affects_shape": self.affects_shape,
        }

    @classmethod
    def _from_json(cls, obj):
        return cls(obj["value_min"], obj["value_max"], obj.get("is_exp", False), obj.get("affects_shape", False))


class FloatKnob(BaseKnob):
    """Float dimension; ``is_exp`` samples log-uniformly (e.g. learning rates)."""

    def __init__(self, value_min: float, value_max: float, is_exp: bool = False,
                 affects_shape: bool = False):
        if value_min > value_max:
            raise ValueError("value_min > value_max")
        if is_exp and value_min <= 0:
            raise ValueError("log-scale FloatKnob requires value_min > 0")
        self.value_min = float(value_min)
        self.value_max = float(value_max)
        self.is_exp = is_exp
        self.affects_shape = affects_shape

    def validate(self, value):
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            raise ValueError(f"FloatKnob expects float, got {type(value).__name__}")
        if not (self.value_min <= value <= self.value_max):
            raise ValueError(f"{value} outside [{self.value_min}, {self.value_max}]")

    def sample(self, rng):
        if self.is_exp:
            lo, hi = math.log(self.value_min), math.log(self.value_max)
            return float(math.exp(rng.uniform(lo, hi)))
        return float(rng.uniform(self.value_min, self.value_max))

    def to_json(self):
        return {
            "type": "float",
            "value_min": self.value_min,
            "value_max": self.value_max,
            "is_exp": self.is_exp,
            "affects_shape": self.affects_shape,
        }

    @classmethod
    def _from_json(cls, obj):
        return cls(obj["value_min"], obj["value_max"], obj.get("is_exp", False),
                   obj.get("affects_shape", False))


_KNOB_TYPES = {
    "fixed": FixedKnob,
    "categorical": CategoricalKnob,
    "integer": IntegerKnob,
    "float": FloatKnob,
}


def serialize_knob_config(knob_config: KnobConfig) -> str:
    return json.dumps({name: k.to_json() for name, k in sorted(knob_config.items())})


def deserialize_knob_config(s: str) -> KnobConfig:
    obj = json.loads(s)
    return {name: BaseKnob.from_json(kj) for name, kj in obj.items()}


def validate_knobs(knob_config: KnobConfig, knobs: Knobs) -> Knobs:
    """Check a concrete knob dict against the declared space; fill fixed knobs."""
    out = dict(knobs)
    for name, knob in knob_config.items():
        if name not in out:
            if isinstance(knob, FixedKnob):
                out[name] = knob.value
                continue
            raise ValueError(f"Missing knob {name!r}")
        knob.validate(out[name])
    extra = set(out) - set(knob_config)
    if extra:
        raise ValueError(f"Unknown knobs: {sorted(extra)}")
    return out


def sample_knobs(knob_config: KnobConfig, rng) -> Knobs:
    return {name: k.sample(rng) for name, k in knob_config.items()}


def knob_config_signature(knob_config: KnobConfig, knobs: Knobs) -> str:
    """Stable hash of the shape-affecting subset of a concrete config.

    Two trials with the same signature reuse the same compiled XLA
    program (jit cache hit), so schedulers can group proposals by
    signature to minimise compile overhead.
    """
    static = {n: knobs[n] for n, k in knob_config.items() if k.affects_shape and n in knobs}
    blob = json.dumps(static, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]
