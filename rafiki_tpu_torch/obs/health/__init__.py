"""Numerics health plane, counterpart of ``rafiki_tpu/obs/health``:
``sentinel`` (the per-step device reduction) and ``detector`` (the
host-side divergence verdict and :class:`DivergenceError`)."""

from rafiki_tpu_torch.obs.health.detector import DivergenceError, HealthMonitor  # noqa: F401
