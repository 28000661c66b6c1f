"""Chaos plane: deterministic fault injection and recovery scenarios.

The port's own copy of ``rafiki_tpu/chaos``. Two halves:

* :mod:`rafiki_tpu_torch.chaos.plane` — the ``RAFIKI_CHAOS``-driven
  fault registry and the ``hook()``/``decide()`` call-site API threaded
  through the bus, the stores, the workers, the train loops and the
  serving path.
* :mod:`rafiki_tpu_torch.chaos.scenarios` /
  :mod:`rafiki_tpu_torch.chaos.runner` — the scenario catalog and the
  runner that stands up an in-process cluster, injects the scheduled
  faults and checks the recovery invariants (``python -m
  rafiki_tpu_torch.chaos run <scenario>``).

Only ``plane`` loads eagerly (the bus and the stores import it); the
scenario machinery, which pulls in schedulers and models, stays behind
``python -m rafiki_tpu_torch.chaos`` and explicit imports.
"""

from rafiki_tpu_torch.chaos.plane import (  # noqa: F401
    ENV_VAR,
    ChaosError,
    ChaosSpecError,
    Fault,
    FaultPlane,
    active,
    decide,
    hook,
    install,
    perform,
    reset_from_env,
    uninstall,
)
