"""The same journaled job in both packages writes the same journal.

A 2-trial FeedForward job (``tests/test_torch_scheduler.py``'s TinyFF
template, random advisor from seed 0) through ``LocalScheduler``, then
its best trial served behind a bus worker, a ``Predictor`` and the
``Gateway``, and one query through the gateway, in the JAX package and
in the port, each process-global journal configured into its own
directory. The set of ``(kind, name)`` pairs each writes, and the
fields of each pair, are equal for the hooks the port has; the port's
own additions are listed in ``PORT_ONLY_FIELDS`` with the reason.
"""

import threading
import time

import jax
import torch

from rafiki_tpu.bus import InProcBus as JaxBus
from rafiki_tpu.gateway import Gateway as JaxGateway
from rafiki_tpu.model.base import load_model_class as jax_load_model_class
from rafiki_tpu.obs.anatomy import exemplars as jax_exemplars
from rafiki_tpu.obs.journal import journal as jax_journal
from rafiki_tpu.obs.journal import read_dir as jax_read_dir
from rafiki_tpu.obs.perf import profiler as jax_profiler
from rafiki_tpu.obs.perf import slo as jax_slo
from rafiki_tpu.ops.train import clear_program_cache as jax_clear_program_cache
from rafiki_tpu.predictor import Predictor as JaxPredictor
from rafiki_tpu.scheduler import LocalScheduler as JaxLocalScheduler
from rafiki_tpu.store import MetaStore as JaxMetaStore, ParamsStore as JaxParamsStore
from rafiki_tpu.worker.inference import InferenceWorker as JaxInferenceWorker
from rafiki_tpu_torch.bus import InProcBus
from rafiki_tpu_torch.gateway import Gateway
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.obs.anatomy import exemplars
from rafiki_tpu_torch.obs.journal import journal, read_dir
from rafiki_tpu_torch.obs.perf import profiler, slo
from rafiki_tpu_torch.ops.train import clear_program_cache
from rafiki_tpu_torch.predictor import Predictor
from rafiki_tpu_torch.scheduler import LocalScheduler
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.worker.inference import InferenceWorker
from tests.test_torch_scheduler import CPU, make_job, sources  # noqa: F401 (fixture)

torch.set_num_threads(2)

#: Fields the port's records carry beyond the JAX package's, by pair:
#: ``perf/step`` the epoch's step count (the port's MFU multiplies a
#: step's flops by it), ``perf/cost`` the card, the compute dtype and
#: the peak they give (the MFU denominator, read back by the CLI).
PORT_ONLY_FIELDS = {("perf", "step"): {"steps"},
                    ("perf", "cost"): {"device", "dtype", "peak_flops"}}
#: Pairs of planes the port does not have, left out of the comparison:
#: none (the hop anatomy and the serving rollup are compared too).
JAX_ONLY_KINDS = set()
JAX_ONLY_PAIRS = set()


def _run(pkg, sources, tmp_path, monkeypatch):
    """The job and the served query in one package; its journal records."""
    if pkg == "jax":
        store_cls, params_cls, sched, bus_cls, worker_cls, pred_cls, gw_cls, load, j, devices = (
            JaxMetaStore, JaxParamsStore, JaxLocalScheduler, JaxBus, JaxInferenceWorker,
            JaxPredictor, JaxGateway, jax_load_model_class, jax_journal, jax.devices("cpu")[:1])
        profiler_mod, slo_mod, clear_cache = jax_profiler, jax_slo, jax_clear_program_cache
        exemplars_mod = jax_exemplars
    else:
        store_cls, params_cls, sched, bus_cls, worker_cls, pred_cls, gw_cls, load, j, devices = (
            MetaStore, ParamsStore, LocalScheduler, InProcBus, InferenceWorker, Predictor,
            Gateway, load_model_class, journal, CPU)
        profiler_mod, slo_mod, clear_cache = profiler, slo, clear_program_cache
        exemplars_mod = exemplars
    # A cold program cache, whatever ran before on this process (another
    # test's job of the same template would skip the build and its
    # program.build span), every hot-path tick evaluates, so both
    # journals get slo/state, and an empty exemplar ring (another test's
    # requests would roll its window into this journal).
    clear_cache()
    profiler_mod.reset()
    slo_mod.configure(tick_s=0.0)
    monkeypatch.setattr(exemplars_mod, "ring", exemplars_mod.ExemplarRing())
    d = tmp_path / pkg
    j.configure(d / "journal", role="job")
    try:
        store, params = store_cls(d / "meta.sqlite3"), params_cls(d / "params")
        job = make_job(store, sources[pkg], {"MODEL_TRIAL_COUNT": 2})
        result = sched(store, params).run_train_job(job["id"], n_workers=1, devices=devices,
                                                    advisor_kind="random")
        assert result.status == "COMPLETED"
        best = result.best_trials[0]
        kw = {} if pkg == "jax" else {"device": "cpu"}
        model = load(sources[pkg], "TinyFF")(**kw, **best["knobs"])
        model.load_parameters(params.load(best["params_id"]))
        bus, stop = bus_cls(), threading.Event()
        worker = worker_cls(bus, "job", "w0", model, stop_event=stop)
        th = threading.Thread(target=worker.run, daemon=True)
        th.start()
        gateway = gw_cls(pred_cls(bus, "job", timeout_s=30.0))
        try:
            t0 = time.monotonic()
            while not bus.get_workers("job") and time.monotonic() - t0 < 30:
                time.sleep(0.01)
            out = gateway.predict([[[[0.5]] * 8] * 8])
            gateway.rollup.flush()  # serving/ts
            exemplars_mod.ring.flush()  # serving/exemplar
        finally:
            gateway.drain(1.0)
            stop.set()
            th.join(timeout=10)
        assert len(out) == 1 and "error" not in str(out[0])
    finally:
        j.close()
        slo_mod.configure_from_env()
    return (jax_read_dir if pkg == "jax" else read_dir)(d / "journal")


def _shape(records):
    """{(kind, name): set of field names}; ledger entities by their kind."""
    out = {}
    for r in records:
        name = r["name"].split(":")[0] if r["kind"] == "ledger" else r["name"]
        out.setdefault((r["kind"], name), set()).update(r)
    return out


def test_the_same_job_and_query_write_the_same_journal(sources, tmp_path,  # noqa: F811
                                                        monkeypatch):
    got = _shape(_run("port", sources, tmp_path, monkeypatch))
    want = _shape(_run("jax", sources, tmp_path, monkeypatch))
    want = {p: f for p, f in want.items()
            if p[0] not in JAX_ONLY_KINDS and p not in JAX_ONLY_PAIRS}
    assert set(got) == set(want), (sorted(set(got) - set(want)), sorted(set(want) - set(got)))
    for pair, fields in want.items():
        assert got[pair] == fields | PORT_ONLY_FIELDS.get(pair, set()), pair
    # The hooks this slice put back all wrote.
    for pair in [("event", "trial_started"), ("span", "trial.total"), ("ledger", "trial"),
                 ("perf", "cost"), ("perf", "step"), ("trial", "epoch_eval"),
                 ("gateway", "config"), ("serving", "request"), ("bus", "add_query"),
                 ("bus", "pop_query"), ("gather", "predictor.gather"),
                 ("span", "inference.forward"), ("slo", "state"), ("serving", "hops"),
                 ("serving", "exemplar"), ("serving", "ts")]:
        assert pair in got, pair
