"""Typed framework configuration with environment-variable overrides.

The port's own copy of ``rafiki_tpu/config.py``, cut to the fields the
port reads: storage paths, the admin's address, the superadmin seed,
auth, the trial heartbeat and the age at which a silent worker counts as
dead, and serving with its gateway limits. Each
field keeps its name, default and environment override
(``RAFIKI_TPU_<FIELD>``), so one environment configures both packages
alike. Not ported: ``default_dtype``, ``poll_interval_s``,
``predictor_port_base`` and ``serving_params_dtype`` (``dump_parameters``
reads ``RAFIKI_TPU_SERVING_PARAMS_DTYPE`` itself). The tenancy knobs are ``RAFIKI_TENANT_*`` environment
variables read by ``tenancy/qos.py`` and ``tenancy/residency.py``, as in
the JAX package, not fields here.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path


def _env(name: str, default, cast):
    raw = os.environ.get(f"RAFIKI_TPU_{name.upper()}")
    if raw is None:
        return default
    if cast is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclasses.dataclass
class Config:
    # Storage
    data_dir: Path = Path(os.environ.get("RAFIKI_TPU_DATA_DIR", "~/.rafiki_tpu")).expanduser()

    # Control plane
    admin_host: str = "127.0.0.1"
    admin_port: int = 3000

    # Superadmin seed (seeded on first boot)
    superadmin_email: str = "superadmin@rafiki"
    superadmin_password: str = "rafiki"

    # Auth
    jwt_secret: str = "rafiki-tpu-secret"
    jwt_ttl_hours: int = 24

    # Scheduling: the least seconds between two service heartbeats a
    # trial's log sink writes (worker/train.py), and the heartbeat age
    # past which a RUNNING trial's worker counts as dead (the recovery
    # sweep's default, admin/admin.py recover_trials).
    trial_heartbeat_s: float = 5.0
    worker_stale_after_s: float = 60.0

    # Serving
    predict_timeout_s: float = 10.0
    inference_batch_size: int = 64

    # Serving gateway (rafiki_tpu_torch/gateway/)
    gateway_max_inflight: int = 8
    gateway_max_queue: int = 32
    gateway_hedge_grace_s: float = 0.25
    gateway_policy: str = "replicate-all"
    gateway_breaker_failures: int = 3
    gateway_breaker_cooldown_s: float = 5.0
    max_queries_per_request: int = 1024
    # Dynamic microbatching: coalesce admitted requests into one bus
    # fan-out. 1 = off (per-request fan-out).
    gateway_max_batch: int = 1
    gateway_max_batch_wait_ms: float = 5.0

    @property
    def db_path(self) -> Path:
        return self.data_dir / "meta.sqlite3"

    @property
    def params_dir(self) -> Path:
        return self.data_dir / "params"

    @property
    def logs_dir(self) -> Path:
        return self.data_dir / "logs"

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        for f in dataclasses.fields(cls):
            cur = getattr(cfg, f.name)
            cast = type(cur) if not isinstance(cur, Path) else (lambda s: Path(s).expanduser())
            setattr(cfg, f.name, _env(f.name, cur, cast))
        return cfg

    def ensure_dirs(self) -> "Config":
        for d in (self.data_dir, self.params_dir, self.logs_dir):
            Path(d).mkdir(parents=True, exist_ok=True)
        return self


_default: Config | None = None


def get_config() -> Config:
    global _default
    if _default is None:
        _default = Config.from_env()
    return _default


def set_config(cfg: Config) -> None:
    global _default
    _default = cfg
