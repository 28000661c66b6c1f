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

Not in the port yet: the process entrypoint, co-hosted job ids, and
the journal, hop, trace-context and chaos hooks.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.predictor.predictor import BATCH_KEY


class InferenceWorker:
    HEARTBEAT_S = 0.5

    def __init__(self, bus, job_id: str, worker_id: str, model: Any,
                 batch_size: int = 64, stop_event: Optional[threading.Event] = None):
        self.bus = bus
        self.job_id = job_id
        self.worker_id = worker_id
        self.model = model
        self.batch_size = batch_size
        self._stop = stop_event or threading.Event()
        # Set only after the serve loop exited AND the bus registration
        # is gone: every popped query has had its prediction published.
        self.drained = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def _beat(self) -> None:
        """Liveness lease refresher, on its own daemon thread so a long
        forward (the first one pays cuDNN's algorithm choice) cannot
        starve the lease."""
        while not self._stop.wait(self.HEARTBEAT_S):
            self.bus.heartbeat(self.job_id, self.worker_id)

    def run(self) -> None:
        self.bus.add_worker(self.job_id, self.worker_id)
        threading.Thread(target=self._beat, name=f"beat-{self.worker_id}",
                         daemon=True).start()
        try:
            while not self._stop.is_set():
                items = self.bus.pop_queries(self.worker_id, max_n=self.batch_size,
                                             timeout=0.1)
                if items:
                    self._serve(items)
        finally:
            self.bus.remove_worker(self.job_id, self.worker_id)
            self.drained.set()

    def _serve(self, items: List[tuple]) -> None:
        # Envelopes are (qid, query) or traced (qid, query, trace).
        qids = [item[0] for item in items]
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
        try:
            with telemetry.span("inference.forward", worker_id=self.worker_id):
                flat_preds = self.model.predict(flat)
            telemetry.inc("inference.queries_served", len(flat))
        except Exception as e:  # a bad query batch must not kill the worker
            telemetry.inc("inference.batch_errors")
            flat_preds = [{"error": str(e)}] * len(flat)
        for qid, (off, n, is_batch) in zip(qids, spans):
            pred = list(flat_preds[off:off + n]) if is_batch else flat_preds[off]
            self.bus.put_prediction(qid, self.worker_id, pred)
