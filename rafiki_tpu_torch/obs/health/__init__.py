"""Numerics health plane, counterpart of ``rafiki_tpu/obs/health``:
``sentinel`` (the per-step device reduction), ``detector`` (the
host-side divergence verdict and :class:`DivergenceError`) and
``capsule`` (replay capsules: the pre-epoch snapshot, ``write``,
``load``, ``replay``)."""

from rafiki_tpu_torch.obs.health.detector import DivergenceError, HealthMonitor  # noqa: F401
