"""Closed-loop elasticity.

The port's own copy of ``rafiki_tpu/autoscale/``.

The repo grew every sensor (SLO burn rates, per-second serving rollup,
effective-trials-per-hour ledger) and every actuator (worker
spawn/drain, elastic mesh re-packing) before it grew the controller
connecting them. This package is that controller:

  * :mod:`controller` — the tick-driven reconciler: reads sensors,
    applies hysteresis / per-direction cooldowns / flap damping, and
    emits journaled scale decisions for the inference and sweep lanes.
  * :mod:`actuators` — the actuation surface the controller drives
    (only the controller calls it, so damping can't be bypassed).
  * :mod:`prewarm` — packed-program pre-warming at job admission, so a
    job's first pack finds its program in the process-wide cache.
"""

from rafiki_tpu_torch.autoscale.controller import (AutoscaleController, LaneSpec,
                                             ScaleDecision, inference_pressure,
                                             read_sensors, sweep_pressure)

__all__ = [
    "AutoscaleController",
    "LaneSpec",
    "ScaleDecision",
    "inference_pressure",
    "read_sensors",
    "sweep_pressure",
]
