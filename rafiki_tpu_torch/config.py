"""Typed framework configuration with environment-variable overrides.

The port's own copy of ``rafiki_tpu/config.py``, cut to the fields the
port reads so far. Each field keeps its name, default and environment
override (``RAFIKI_TPU_<FIELD>``), so one environment configures both
packages alike.
"""

from __future__ import annotations

import dataclasses
import os


def _env(name: str, default, cast):
    raw = os.environ.get(f"RAFIKI_TPU_{name.upper()}")
    if raw is None:
        return default
    if cast is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclasses.dataclass
class Config:
    # Scheduling: the least seconds between two service heartbeats a
    # trial's log sink writes (worker/train.py).
    trial_heartbeat_s: float = 5.0

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        for f in dataclasses.fields(cls):
            cur = getattr(cfg, f.name)
            setattr(cfg, f.name, _env(f.name, cur, type(cur)))
        return cfg


_default: Config | None = None


def get_config() -> Config:
    global _default
    if _default is None:
        _default = Config.from_env()
    return _default


def set_config(cfg: Config) -> None:
    global _default
    _default = cfg
