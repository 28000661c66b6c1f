"""Train-worker process entry point: ``python -m rafiki_tpu_torch.worker.main``.

The port's own copy of ``rafiki_tpu/worker/main.py``. The
``ProcessScheduler`` spawns this module with the JAX package's
variables:

  RAFIKI_WORKER_DB             meta-store sqlite path
  RAFIKI_WORKER_PARAMS_DIR     params-store directory
  RAFIKI_WORKER_SUB_JOB_ID     sub train job to pull trials for
  RAFIKI_WORKER_ID             human-readable worker id
  RAFIKI_WORKER_SERVICE_ID     service row to heartbeat (optional)
  RAFIKI_WORKER_ADVISOR_URL    http://127.0.0.1:<port>
  RAFIKI_WORKER_ADVISOR_ID     advisor to ask for knobs
  RAFIKI_WORKER_ADVISOR_SECRET shared secret (optional)
  RAFIKI_WORKER_ADOPT_SERVICE_ID  dead predecessors' service rows whose
                               orphaned trials this worker resumes

and, for a rank of a dp group, ``RAFIKI_COORDINATOR_ADDRESS`` (host:port
of rank 0's rendezvous), ``RAFIKI_NUM_PROCESSES`` (the world size),
``RAFIKI_PROCESS_ID`` (the rank), ``RAFIKI_LEADER_WORKER_ID`` and
``RAFIKI_LEADER_SERVICE_ID``.

Device pinning comes from the environment the scheduler set
(``scheduler/process.py worker_device_env``): ``CUDA_VISIBLE_DEVICES``
on the card, so the process sees only its own cards, or
``RAFIKI_WORKER_DEVICE=cpu``, which makes the worker run its trials on
the CPU. Without that variable the worker runs on CUDA, and exits 1 when
there is none: nothing falls back to the CPU.

A group rank joins a ``torch.distributed`` process group over TCP
(``nccl`` on the card, ``gloo`` on the CPU) before its first trial,
under the JAX package's retry and backoff (:func:`initialize_collective`,
with the ``collective.init`` chaos site), and with a finite timeout
(:data:`COLLECTIVE_TIMEOUT_S`), so a dead peer cannot wedge a survivor
past the scheduler's teardown. Rank 0 leads; the other
ranks follow (``worker/follower.py``).

Once its device is up, each process emits ``worker_device`` with the
device it resolved and, on the card, the card's name: what the process
runs on, beside the device set the scheduler wrote into its service row.

Exit codes: 0 = budget spent cleanly, 1 = crash (a failed process group
or collective included), 17 = backend-init watchdog (the device or the
rendezvous did not come up within ``RAFIKI_BACKEND_INIT_TIMEOUT_S``).

The JAX package's worker also turns on XLA's persistent compilation
cache. The port has no counterpart: its compiled form is the CUDA graph
of an epoch's step, which lives only as long as its process (and its
epoch).
"""

from __future__ import annotations

import datetime
import os
import sys
import threading
import time


def initialize_collective(initialize, coordinator: str, num_processes: int,
                          process_id: int) -> None:
    """Join the process group with retry and exponential backoff.

    A follower that races rank 0's bind fails its rendezvous although
    the group is healthy. Bounded retries (``RAFIKI_COLLECTIVE_INIT_
    RETRIES``, backoff ``RAFIKI_COLLECTIVE_INIT_BACKOFF_S`` doubling per
    attempt) absorb that; exhaustion re-raises the last error, so the
    scheduler's restart path takes over. The ``collective.init`` chaos
    site is armed once per attempt (an error fault is an injected init
    failure), keyed ``p<process_id>``."""
    from rafiki_tpu_torch import chaos
    from rafiki_tpu_torch.utils.events import events

    retries = int(os.environ.get("RAFIKI_COLLECTIVE_INIT_RETRIES", "3"))
    backoff = float(os.environ.get("RAFIKI_COLLECTIVE_INIT_BACKOFF_S", "0.5"))
    for attempt in range(retries + 1):
        try:
            chaos.hook("collective.init", key=f"p{process_id}")
            initialize(coordinator_address=coordinator, num_processes=num_processes,
                       process_id=process_id)
            return
        except Exception as e:
            if attempt >= retries:
                raise
            events.emit("collective_init_retry", process_id=process_id,
                        attempt=attempt, error=str(e))
            time.sleep(backoff * (2 ** attempt))


# Bound on the rendezvous and on every collective of a dp group: a rank
# whose peer died fails its collective within this, and the group exits.
COLLECTIVE_TIMEOUT_S = 120


def init_process_group(device, coordinator_address: str, num_processes: int,
                       process_id: int) -> None:
    """``torch.distributed.init_process_group`` over TCP at the
    coordinator's address, with the device's backend and the finite
    collective timeout. On the card the group is bound to its device."""
    import torch
    import torch.distributed as dist

    from rafiki_tpu_torch.parallel.mesh import BACKENDS

    kwargs = {}
    if device.type == "cuda":
        kwargs["device_id"] = device
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    dist.init_process_group(BACKENDS[device.type], init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=timeout,
                            **kwargs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> int:
    db_path = os.environ["RAFIKI_WORKER_DB"]
    params_dir = os.environ["RAFIKI_WORKER_PARAMS_DIR"]
    sub_job_id = os.environ["RAFIKI_WORKER_SUB_JOB_ID"]
    worker_id = os.environ.get("RAFIKI_WORKER_ID", f"pw-{os.getpid()}")
    service_id = os.environ.get("RAFIKI_WORKER_SERVICE_ID")
    advisor_url = os.environ["RAFIKI_WORKER_ADVISOR_URL"]
    advisor_id = os.environ["RAFIKI_WORKER_ADVISOR_ID"]
    secret = os.environ.get("RAFIKI_WORKER_ADVISOR_SECRET")

    # Backend-init watchdog: a card or a rendezvous that never answers
    # would stall the scheduler's supervise loop with no diagnosis; exit
    # with a structured error instead.
    init_timeout = float(os.environ.get("RAFIKI_BACKEND_INIT_TIMEOUT_S", "180"))

    def _init_stuck():
        print(f"worker {worker_id}: FATAL backend init exceeded {init_timeout:.0f}s "
              f"(device or collective rendezvous unreachable?); exiting", flush=True)
        os._exit(17)

    watchdog = threading.Timer(init_timeout, _init_stuck)
    watchdog.daemon = True
    watchdog.start()

    import torch

    from rafiki_tpu_torch.utils.backend import local_devices, resolve_device

    if os.environ.get("RAFIKI_WORKER_DEVICE", "").strip().lower() == "cpu":
        devices = local_devices("cpu")
    else:
        devices = local_devices()  # raises without CUDA: no CPU fallback
        torch.cuda.set_device(devices[0])
        torch.zeros(1, device=devices[0])  # the card's context, under the watchdog
    device = resolve_device(devices[0])

    coordinator = os.environ.get("RAFIKI_COORDINATOR_ADDRESS")
    if coordinator:
        from rafiki_tpu_torch import chaos

        process_id = int(os.environ["RAFIKI_PROCESS_ID"])
        # Start skew: a delay fault here staggers this rank's arrival at
        # the rendezvous.
        chaos.hook("mesh.skew", key=f"p{process_id}")
        initialize_collective(
            lambda **kw: init_process_group(device, kw["coordinator_address"],
                                            kw["num_processes"], kw["process_id"]),
            coordinator, int(os.environ["RAFIKI_NUM_PROCESSES"]), process_id)
    watchdog.cancel()

    rc = _run(db_path, params_dir, sub_job_id, worker_id, service_id, advisor_url,
              advisor_id, secret, devices, coordinator)
    if coordinator:
        # Only on a clean exit: after a failed collective the process just
        # exits, and the scheduler tears down its peers.
        import torch.distributed as dist

        dist.destroy_process_group()
    return rc


def _run(db_path, params_dir, sub_job_id, worker_id, service_id, advisor_url, advisor_id,
         secret, devices, coordinator) -> int:
    from rafiki_tpu_torch.utils.events import configure_from_env, events

    configure_from_env()
    # Observability: this process journals under RAFIKI_LOG_DIR (spawn
    # env), adopts the scheduler's RAFIKI_TRACE_ID, and dumps a flight
    # record on a fatal error or SIGTERM.
    from rafiki_tpu_torch import obs

    if obs.configure_from_env(role="train-worker"):
        obs.recorder.install()

    import torch

    from rafiki_tpu_torch.store import MetaStore, ParamsStore

    store = MetaStore(db_path)
    device = devices[0]
    events.emit("worker_device", worker_id=worker_id, service_id=service_id,
                device=str(device), device_name=(torch.cuda.get_device_name(device)
                                                 if device.type == "cuda" else "cpu"))
    if coordinator:
        import torch.distributed as dist

        world = dist.get_world_size()
        # The JAX package's fields; a rank owns one device, so the global
        # device count is the world size and the local one is 1.
        events.emit("multihost_init", worker_id=worker_id, process_id=dist.get_rank(),
                    process_count=world, global_devices=world, local_devices=len(devices))
        from rafiki_tpu_torch.parallel.multihost import is_leader

        if not is_leader():
            from rafiki_tpu_torch.worker.follower import FollowerWorker

            n = FollowerWorker(
                store, ParamsStore(params_dir), sub_job_id,
                leader_worker_id=os.environ.get("RAFIKI_LEADER_WORKER_ID"),
                leader_service_id=os.environ.get("RAFIKI_LEADER_SERVICE_ID"),
                device=devices[0]).run()
            print(f"follower {worker_id}: mirrored {n} trials", flush=True)
            return 0

    from rafiki_tpu_torch.advisor.app import HttpAdvisorHandle
    from rafiki_tpu_torch.worker.train import build_worker_from_store

    params_store = ParamsStore(params_dir)
    advisor = HttpAdvisorHandle(advisor_url, advisor_id, secret=secret)
    worker = build_worker_from_store(store, params_store, sub_job_id, advisor,
                                     worker_id=worker_id, devices=devices)
    worker.service_id = service_id
    try:
        # Restart path: this process replaces a crashed predecessor. Every
        # dead service row the scheduler recorded for this slot is swept,
        # and the trials left RUNNING under them resume (each taken by a
        # compare-and-swap, so a racing recovery sweep cannot run it twice).
        adopt = os.environ.get("RAFIKI_WORKER_ADOPT_SERVICE_ID", "")
        for sid in filter(None, adopt.split(",")):
            n_adopted = worker.adopt_orphans_of_service(sid)
            if n_adopted:
                print(f"worker {worker_id}: adopted {n_adopted} orphaned trial(s) of "
                      f"dead service {sid}", flush=True)
        n = worker.run()
    finally:
        if coordinator and service_id:
            # Tell the followers we are done before exiting, on the crash
            # path too: the scheduler writes the sub-job's terminal status
            # only after every group process exits.
            from rafiki_tpu_torch.constants import ServiceStatus

            store.update_service(service_id, status=ServiceStatus.STOPPED.value)
    print(f"worker {worker_id}: ran {n} trials", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
