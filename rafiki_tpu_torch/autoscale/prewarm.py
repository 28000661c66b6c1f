"""Packed-program pre-warming at job admission (docs/autoscale.md).

The port's own copy of ``rafiki_tpu/autoscale/prewarm.py``. At
admission, group a job's probe trials by ``packing_key`` and build each
bucket's :class:`~rafiki_tpu_torch.ops.train.PackedTrainLoop` once:
that fetches-or-builds the bucket's ``PackedProgram`` through the
process-wide cache (``ops/train.py get_program``), so the job's first
pack of that key and width finds it there (``program_cache.misses`` does
not move). The JAX package also persists its XLA executables across
processes (``enable_compilation_cache``); the port has no counterpart
and invents none: its compiled form is an epoch's CUDA graph, captured
at the epoch and living only as long as its process.

The probe trial per bucket is derived deterministically from the knob
config (fixed → value, ranges → midpoint, categorical → first), NOT
from an advisor — admission must not burn advisor state or journal
phantom proposals. Shape-affecting knobs sampled by the real sweep can
still produce unseen keys; pre-warming is best-effort and every
outcome journals ``autoscale/prewarm``. The probe pack's params are
allocated on the card under ``ops/graphs.py card_lock`` and dropped.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.model.knobs import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob
from rafiki_tpu_torch.obs.journal import journal as _journal
from rafiki_tpu_torch.ops.graphs import card_lock


def probe_knobs(knob_config: Dict[str, Any]) -> Dict[str, Any]:
    """A deterministic representative sample of a knob config: the
    middle of every range, the first categorical value. Advisor-free
    so admission never touches sweep state."""
    out: Dict[str, Any] = {}
    for name, knob in knob_config.items():
        if isinstance(knob, FixedKnob):
            out[name] = knob.value
        elif isinstance(knob, CategoricalKnob):
            out[name] = knob.values[0]
        elif isinstance(knob, IntegerKnob):
            out[name] = int((knob.value_min + knob.value_max) // 2)
        elif isinstance(knob, FloatKnob):
            if getattr(knob, "is_exp", False) and knob.value_min > 0:
                out[name] = float(math.exp(
                    (math.log(knob.value_min) + math.log(knob.value_max))
                    / 2.0))
            else:
                out[name] = (knob.value_min + knob.value_max) / 2.0
        # unknown knob kinds are skipped; the model ctor defaults apply
    return out


def prewarm_models(model_cls: type, knobs_list: Sequence[Dict[str, Any]],
                   dataset_uri: str, k: int = 2) -> Dict[str, Any]:
    """Build the packed program for every distinct ``packing_key`` in
    ``knobs_list`` at width ``k``, on the models' device (the caller's
    ``utils.backend.default_device``). Returns per-key stats; never
    raises (a template whose probe fails to build just reports an error
    — pre-warming must not fail admission)."""
    from rafiki_tpu_torch.ops.train import PackedTrainLoop

    buckets: Dict[str, List[Any]] = {}
    errors: List[str] = []
    for kn in knobs_list:
        try:
            m = model_cls(**kn)
            key = repr(m.packing_key(m._prepared_dataset(dataset_uri)))
        except Exception as e:
            errors.append(str(e))
            continue
        buckets.setdefault(key, []).append(m)
    warmed = 0
    hits = 0
    for key, models in buckets.items():
        width = min(max(1, int(k)), len(models)) if models else 1
        pack = models[:width]
        misses0 = telemetry.get_counter("program_cache.misses")
        try:
            lead = pack[0]
            ds = lead._prepared_dataset(dataset_uri)
            num_classes, input_shape = lead._dataset_arch(ds)
            fns = lead._loop_fns(num_classes, input_shape)
            hypers = []
            for m in pack:
                m._planned_steps = m.epochs * max(1, ds.size // m.batch_size)
                hypers.append(m._loop_fns(num_classes, input_shape)["hyper"])
            with telemetry.span("autoscale.prewarm", key=key), card_lock(lead):
                # Constructing the loop fetches-or-builds the
                # PackedProgram at this width: the build a first pack
                # would otherwise pay.
                PackedTrainLoop(fns["init_fn"], fns["apply_eval"],
                                fns["loss_fn"], fns["optimizer"],
                                seeds=[m._seed for m in pack],
                                hypers=hypers,
                                program_key=fns["program_key"],
                                device=lead.device)
            hit = telemetry.get_counter("program_cache.misses") == misses0
            warmed += 1
            hits += int(hit)
            _journal.record("autoscale", "prewarm", key=key, k=width,
                            hit=hit)
        except Exception as e:
            errors.append(f"{key}: {e}")
            _journal.record("autoscale", "prewarm", key=key, k=width,
                            error=str(e))
    telemetry.inc("autoscale.prewarmed_packs", warmed)
    return {"keys": len(buckets), "warmed": warmed, "cache_hits": hits,
            "errors": errors}


def prewarm_train_job(store: Any, job_id: str, k: int = 2) -> Dict[str, Any]:
    """Admission-time entry: pre-warm one probe pack per model attached
    to ``job_id`` (deterministic knob probe, no advisor). Called from
    the services manager when RAFIKI_AUTOSCALE_PREWARM is on."""
    from rafiki_tpu_torch.model.base import load_model_class

    job = store.get_train_job(job_id)
    if job is None:
        return {"keys": 0, "warmed": 0, "cache_hits": 0,
                "errors": [f"no train job {job_id!r}"]}
    totals: Dict[str, Any] = {"keys": 0, "warmed": 0, "cache_hits": 0,
                              "errors": []}
    for sub in store.get_sub_train_jobs(job_id):
        model_row = store.get_model(sub["model_id"])
        try:
            cls = load_model_class(model_row["model_file"],
                                   model_row["model_class"])
            if not cls.packable():
                continue
            probe = probe_knobs(cls.get_knob_config())
            res = prewarm_models(cls, [probe] * max(1, int(k)),
                                 job["train_dataset_uri"], k=k)
        except Exception as e:
            totals["errors"].append(f"{model_row.get('name')}: {e}")
            continue
        for key in ("keys", "warmed", "cache_hits"):
            totals[key] += res[key]
        totals["errors"].extend(res["errors"])
    return totals
