"""Stacked-route loss fallback: watch the stacked worker's lease, and
when it dies (SIGKILL never runs remove_worker — the lease just goes
stale) degrade the job to the replicated per-trial route by spawning
fallback workers.

The port's own copy of ``rafiki_tpu/worker/fallback.py``.

The stacked serving route (``parallel/serving.py``) concentrates a job's whole
top-k ensemble in ONE worker process: a single process loss would
otherwise take the job from k-way redundancy to zero capacity. This
supervisor is the containment: it polls the bus's lease table (the same
liveness source the predictor routes by), and the moment the watched
worker drops out of the fresh set it journals ``serving/fallback`` and
invokes the caller-supplied ``spawn_fallback`` — typically starting
one-worker-per-trial replicated serving from the already-loaded params.
In-flight requests ride the gateway's blackout re-route
(``GatewayConfig.blackout_retries``) while the fallback spins up, so
nothing admitted is dropped; the chaos scenario
``stacked-worker-loss-fallback`` pins exactly that sequence.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.journal import journal as _journal


class FallbackSupervisor:
    """Fire ``spawn_fallback()`` once when ``worker_id``'s lease dies.

    ``ttl_s`` mirrors the predictor's ``worker_ttl_s`` — supervisor and
    router must agree on what "dead" means, or the fallback would spawn
    while the router still fans out to the corpse (or vice versa).
    """

    def __init__(self, bus, job_id: str, worker_id: str,
                 spawn_fallback: Callable[[], None],
                 ttl_s: float = 3.0, poll_s: float = 0.25):
        self.bus = bus
        self.job_id = job_id
        self.worker_id = worker_id
        self._spawn = spawn_fallback
        self.ttl_s = ttl_s
        self.poll_s = poll_s
        self._stop = threading.Event()
        self.fired = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FallbackSupervisor":
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"fallback-{self.worker_id}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        # Wait for the watched worker to exist at all before arming —
        # a supervisor started alongside the worker must not fire on
        # the registration race.
        while not self._stop.wait(self.poll_s):
            try:
                fresh = self.bus.get_workers(self.job_id,
                                             max_age_s=self.ttl_s)
            except Exception:  # bus manager teardown: exit quietly
                return
            if self.worker_id in fresh:
                break
        while not self._stop.wait(self.poll_s):
            try:
                fresh = self.bus.get_workers(self.job_id,
                                             max_age_s=self.ttl_s)
            except Exception:
                return
            if self.worker_id not in fresh:
                telemetry.inc("serving.fallbacks")
                _journal.record("serving", "fallback",
                                job_id=self.job_id,
                                lost_worker=self.worker_id,
                                route="replicated")
                try:
                    self._spawn()
                finally:
                    self.fired.set()
                return
