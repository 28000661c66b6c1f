"""Inference worker: serves one trained trial (or one stacked top-k).

The port's own copy of ``rafiki_tpu/worker/inference.py``: register as
running in the bus, keep the liveness lease fresh from a heartbeat
thread, then loop: pop a query batch from this worker's queue ->
``model.predict`` -> push predictions keyed by query id.
``pop_queries`` drains the queue after the first query arrives, so
concurrent requests are micro-batched into one forward pass.
``BATCH_KEY`` envelopes (a whole microbatch as one query) are expanded
into the flat forward batch and answered with a per-query list. A
failing forward answers every query of its batch with an error and
leaves the worker serving.

The model's ``predict`` enters ``torch.inference_mode`` itself, on this
worker's thread (the mode is thread-local), and returns host lists.

Traced envelopes ``(qid, query, trace)`` (``bus/queues.py``): each
traced query journals its pop (``bus/pop_query``) under its own trace,
and the batch's forward span binds to the first trace of the batch, as
in the JAX package, so a gateway query stitches across the worker.

Each forward passes the ``inference.forward`` chaos site, keyed by the
worker id (a ``delay`` is a stuck replica whose lease stays fresh; an
``error`` a failing forward, answered as one).

Hop chains (``obs/anatomy/hops.py``): a traced envelope's marks are
continued with this worker's leg: ``deq`` once per popped batch, ``fwds``
before the chaos hook (an injected delay lands inside the forward hop),
``fwd`` once ``predict`` has returned host lists (so the device has
finished), or ``fwdc`` on the worker's first forward (cuDNN's algorithm
choice and CUDA's lazy start, kept out of the warm percentiles), and
``reply`` per chain, which goes back through ``put_prediction(hops=)``.

``run_inference_worker_process`` is the worker as its own process (a
spawn target over ``make_mp_bus``): it rebuilds its trial from the
stores and serves on the card until killed.

A co-hosted worker (``extra_job_ids``, a ``tenancy/hosting.py
ProgramHost`` as its model) registers, heartbeats and deregisters under
every co-hosted job id with one worker id: each job's predictor fans out
to the same queue, and the program tag on each query routes it. This is
for thread workers; ``run_inference_worker_process`` serves one job, as
the JAX package's does.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, List, Optional

from rafiki_tpu_torch import chaos, telemetry
from rafiki_tpu_torch.obs import context as trace_context
from rafiki_tpu_torch.obs.anatomy import hops as _hops
from rafiki_tpu_torch.obs.journal import journal as _journal
from rafiki_tpu_torch.predictor.predictor import BATCH_KEY


class InferenceWorker:
    HEARTBEAT_S = 0.5

    def __init__(self, bus, job_id: str, worker_id: str, model: Any,
                 batch_size: int = 64, stop_event: Optional[threading.Event] = None,
                 extra_job_ids: Optional[List[str]] = None):
        self.bus = bus
        self.job_id = job_id
        self.job_ids = [job_id] + [j for j in (extra_job_ids or []) if j != job_id]
        self.worker_id = worker_id
        self.model = model
        self.batch_size = batch_size
        self._stop = stop_event or threading.Event()
        # Set only after the serve loop exited AND the bus registration
        # is gone: every popped query has had its prediction published.
        self.drained = threading.Event()
        # The first successful forward pays the cold start; its chains
        # end the forward with fwdc, not fwd.
        self._warm = False

    def stop(self) -> None:
        self._stop.set()

    def _beat(self) -> None:
        """Liveness lease refresher, on its own daemon thread so a long
        forward (the first one pays cuDNN's algorithm choice) cannot
        starve the lease."""
        while not self._stop.wait(self.HEARTBEAT_S):
            try:
                for job_id in self.job_ids:
                    self.bus.heartbeat(job_id, self.worker_id)
            except Exception:  # the bus's manager torn down: exit quietly
                return

    def run(self) -> None:
        for job_id in self.job_ids:
            self.bus.add_worker(job_id, self.worker_id)
        threading.Thread(target=self._beat, name=f"beat-{self.worker_id}",
                         daemon=True).start()
        try:
            while not self._stop.is_set():
                items = self.bus.pop_queries(self.worker_id, max_n=self.batch_size,
                                             timeout=0.1)
                if items:
                    self._serve(items)
        finally:
            for job_id in self.job_ids:
                self.bus.remove_worker(job_id, self.worker_id)
            self.drained.set()

    def _serve(self, items: List[tuple]) -> None:
        # Envelopes are (qid, query) or traced (qid, query, trace). A
        # microbatch can mix traces: the forward span binds to the first
        # one, and every traced query journals its own pop.
        qids = [item[0] for item in items]
        traces = [item[2] if len(item) > 2 else None for item in items]
        for qid, tr in zip(qids, traces):
            if tr:
                _journal.record("bus", "pop_query", query_id=qid, worker_id=self.worker_id,
                                trace_id=tr.get("trace_id"), parent_span=tr.get("parent_span"))
        lead = next((t for t in traces if t), None)
        # Batch-shared marks (deq, fwds, the forward's end) are stamped
        # once and appended to every traced chain of the batch.
        deq = _hops.mark("deq")
        chains = [list(tr["hops"]) + [deq] if tr and tr.get("hops") else None
                  for tr in traces]
        bind = (trace_context.trace(lead.get("trace_id")) if lead
                else contextlib.nullcontext())
        flat: List[Any] = []
        spans = []  # (offset, n, is_batch) per envelope
        for item in items:
            q = item[1]
            if isinstance(q, dict) and BATCH_KEY in q:
                group = list(q[BATCH_KEY])
                spans.append((len(flat), len(group), True))
                flat.extend(group)
            else:
                spans.append((len(flat), 1, False))
                flat.append(q)
        fwds = _hops.mark("fwds")
        was_cold = not self._warm
        try:
            chaos.hook("inference.forward", self.worker_id)
            with bind, telemetry.span("inference.forward", worker_id=self.worker_id):
                flat_preds = self.model.predict(flat)  # host lists: the card is done
            telemetry.inc("inference.queries_served", len(flat))
            self._warm = True
        except Exception as e:  # a bad query batch must not kill the worker
            telemetry.inc("inference.batch_errors")
            flat_preds = [{"error": str(e)}] * len(flat)
        fwd_end = _hops.mark("fwdc" if was_cold else "fwd")
        for qid, (off, n, is_batch), chain in zip(qids, spans, chains):
            pred = list(flat_preds[off:off + n]) if is_batch else flat_preds[off]
            if chain is None:
                self.bus.put_prediction(qid, self.worker_id, pred)
            else:
                chain += [fwds, fwd_end, _hops.mark("reply")]
                self.bus.put_prediction(qid, self.worker_id, pred, hops=chain)


def run_inference_worker_process(bus, meta_path: str, params_path: str,
                                 trial_id: str, job_id: str, worker_id: str,
                                 batch_size: int = 64) -> None:
    """Entry point of an inference worker as its OWN process (a spawn
    target; the mp bus pickles across). Rebuilds the trial's model from
    the stores (class bytes, knobs, trained params), then serves until
    killed: the deployment shape the reference gets from one container
    per trial, and the unit the serve-path elasticity tests SIGKILL.

    The device is the card, as for ``worker/main.py``, unless
    ``RAFIKI_WORKER_DEVICE=cpu``; without CUDA it raises (no CPU
    fallback). The journal and trace come from the environment
    (``RAFIKI_LOG_DIR``, ``RAFIKI_TRACE_ID``), with the flight recorder."""
    import os

    import torch

    from rafiki_tpu_torch import obs
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.store import MetaStore, ParamsStore
    from rafiki_tpu_torch.utils import heap
    from rafiki_tpu_torch.utils.backend import default_device, local_devices

    if obs.configure_from_env(role="infer"):
        obs.recorder.install()
    if os.environ.get("RAFIKI_WORKER_DEVICE", "").strip().lower() == "cpu":
        device = local_devices("cpu")[0]
    else:
        device = local_devices()[0]  # raises without CUDA: no CPU fallback
        torch.cuda.set_device(device)
    store = MetaStore(meta_path)
    trial = store.get_trial(trial_id)
    sub = store.get_sub_train_job(trial["sub_train_job_id"])
    model_row = store.get_model(sub["model_id"])
    cls = load_model_class(model_row["model_file"], model_row["model_class"])
    with default_device(device):  # templates build on the thread's device
        model = cls(**trial["knobs"])
        if trial.get("params_id"):
            model.load_parameters(ParamsStore(params_path).load(trial["params_id"]))
        heap.freeze()  # serves until killed: never thawed (utils/heap.py)
        InferenceWorker(bus, job_id, worker_id, model, batch_size=batch_size).run()
