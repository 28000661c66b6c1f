"""ProgramHost: one inference worker, many jobs' models.

The port's own copy of ``rafiki_tpu/tenancy/hosting.py``. The stacked
route fuses k *trials of one job* into one forward; ProgramHost serves
k *models of many jobs* behind ONE InferenceWorker. Each co-hosted
job's predictor wraps its queries with a program tag
(:data:`PROGRAM_KEY`, riding the query payload as the microbatcher's
``BATCH_KEY`` does), the shared worker registers on the bus under every
co-hosted job id (one worker id, one queue), and
``ProgramHost.predict`` routes each query group to its program through
the :class:`ResidencyManager`. Which models are hot is an LRU
byte-budget decision, and activating a cold model is a params fetch
(a CAS manifest's chunks, ``store/cas.py``), not a worker rollout.

Untagged queries route to the host's default program, so a co-hosted
worker still serves the single-job wire format.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.predictor.ensemble import ensemble_predictions
from rafiki_tpu_torch.tenancy.residency import ResidencyManager

#: Sentinel key tagging one query with its target program — the same
#: back-compat envelope trick as predictor.BATCH_KEY: untagged queries
#: are served by the default program, so old clients keep working.
PROGRAM_KEY = "__rafiki_program__"


def wrap_query(program_id: str, query: Any) -> Dict[str, Any]:
    """Tag ``query`` for ``program_id`` (the co-hosted predictor's
    per-query wrapper)."""
    return {PROGRAM_KEY: program_id, "q": query}


def _unwrap(query: Any) -> "tuple[Optional[str], Any]":
    if isinstance(query, dict) and PROGRAM_KEY in query:
        return query[PROGRAM_KEY], query.get("q")
    return None, query


@dataclasses.dataclass
class ProgramSpec:
    """One co-hostable program: how to load it and what it costs.

    ``loader`` builds the servable model (anything with ``predict``;
    typically a TorchModel or StackedTrialModel restored from its
    params blobs); ``size_bytes`` is its HBM residency charge, the
    params blobs' size.
    """

    program_id: str
    loader: Callable[[], Any]
    size_bytes: int


class TrialEnsemble:
    """A co-hosted job's trials that cannot stack (their architectures
    differ), served as the dedicated route serves them: each trial's
    forward, then the predictor's per-query ensemble. A trial that
    raises answers with an error dict, which the ensemble skips, as a
    dedicated worker's error reply is skipped.

    The JAX package's loader serves the first trial alone in this case
    (ROADMAP Queue 3)."""

    def __init__(self, models: List[Any]):
        self.models = list(models)

    def predict(self, queries: List[Any]) -> List[Any]:
        per_trial = []
        for m in self.models:
            try:
                per_trial.append(m.predict(queries))
            except Exception as e:
                per_trial.append([{"error": str(e)}] * len(queries))
        return [ensemble_predictions([preds[i] for preds in per_trial])
                for i in range(len(queries))]

    def destroy(self) -> None:
        for m in self.models:
            m.destroy()


class ProgramHost:
    """Implements the model contract (``predict``/``destroy``) over a
    residency-managed set of programs."""

    def __init__(self, specs: List[ProgramSpec],
                 residency: Optional[ResidencyManager] = None,
                 default_program: Optional[str] = None):
        if not specs:
            raise ValueError("ProgramHost needs at least one program")
        self.residency = residency or ResidencyManager()
        self._specs: Dict[str, ProgramSpec] = {
            s.program_id: s for s in specs}
        self.default_program = default_program or specs[0].program_id
        if self.default_program not in self._specs:
            raise ValueError(
                f"default program {self.default_program!r} not in specs")

    def program_ids(self) -> List[str]:
        return sorted(self._specs)

    def _model(self, program_id: str) -> Any:
        spec = self._specs.get(program_id)
        if spec is None:
            raise KeyError(f"unknown program {program_id!r}")
        return self.residency.activate(spec.program_id, spec.size_bytes,
                                       spec.loader)

    def predict(self, queries: List[Any]) -> List[Any]:
        """Route each query to its tagged program, preserving order.

        Queries group by program so each resident model runs ONE
        forward per batch (the device-efficiency point of hosting);
        a failed group degrades to per-query error dicts, the same
        containment contract as the inference worker loop.
        """
        groups: Dict[str, List[int]] = {}
        bare: List[Any] = []
        for i, q in enumerate(queries):
            pid, inner = _unwrap(q)
            bare.append(inner)
            groups.setdefault(pid or self.default_program, []).append(i)
        out: List[Any] = [None] * len(queries)
        for pid in sorted(groups):
            idxs = groups[pid]
            batch = [bare[i] for i in idxs]
            try:
                model = self._model(pid)
                preds = model.predict(batch)
                if not isinstance(preds, list) or len(preds) != len(batch):
                    raise RuntimeError(
                        f"program {pid} returned {type(preds).__name__} "
                        f"for a {len(batch)}-query batch")
            except Exception as e:
                preds = [{"error": str(e)}] * len(batch)
                telemetry.inc("tenancy.host_errors")
            for i, p in zip(idxs, preds):
                out[i] = p
        telemetry.inc("tenancy.host_queries", len(queries))
        return out

    def destroy(self) -> None:
        """Evict everything (worker shutdown) — through the normal
        eviction path so the swaps journal like any other."""
        self.residency.drain()
