"""Spawn targets (no tests) over the port's multiprocessing bus, for
``tests/test_torch_mp_bus.py``. Kept apart from the test file so a child
imports the port's bus only (no JAX): each child starts in a fraction of
a second."""

import os
import time


def answer(bus, job, worker_id):
    """Register, then answer every popped query with this process's pid
    and the envelope's hop chain continued by a ``reply`` mark."""
    from rafiki_tpu_torch.obs.anatomy import hops

    bus.add_worker(job, worker_id)
    while True:
        for item in bus.pop_queries(worker_id, max_n=8, timeout=0.05):
            chain = list(item[2]["hops"]) + [hops.mark("reply")] if len(item) > 2 else None
            bus.put_prediction(item[0], worker_id, os.getpid(), hops=chain)


def squat(bus, job, worker_id, beat_s):
    """Register and heartbeat until killed: the least process whose
    SIGKILL leaves a corpse registration."""
    bus.add_worker(job, worker_id)
    while True:
        bus.heartbeat(job, worker_id)
        time.sleep(beat_s)


def hammer(bus, job, worker_id):
    """Register, then call the bus back to back with no sleep (heartbeat,
    pop, add_query, put_prediction) until killed, so a SIGKILL lands
    inside a round-trip."""
    bus.add_worker(job, worker_id)
    n = 0
    while True:
        bus.heartbeat(job, worker_id)
        bus.pop_queries(worker_id, max_n=4, timeout=0)
        bus.add_query(worker_id, f"h{n}", [float(n)])
        bus.put_prediction(f"h{n}", worker_id, [1.0])
        n += 1
