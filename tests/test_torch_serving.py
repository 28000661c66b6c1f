"""The port's serving slice end to end on the CPU: three trials' blobs,
dumped by the JAX package, served through the port's InferenceWorker
threads on its InProcBus and queried with its Predictor, once through
the stacked route and once through the replicated route, against the
JAX package's own workers and predictor on the same blobs."""

import threading
import time

import numpy as np
import pytest
import torch

from rafiki_tpu.bus.queues import InProcBus as JaxBus
from rafiki_tpu.models.vgg import Vgg as JaxVgg
from rafiki_tpu.predictor.predictor import Predictor as JaxPredictor
from rafiki_tpu.worker.inference import InferenceWorker as JaxWorker
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.bus.queues import InProcBus
from rafiki_tpu_torch.models.vgg import Vgg
from rafiki_tpu_torch.parallel.serving import build_stacked, try_build_stacked
from rafiki_tpu_torch.predictor.ensemble import ensemble_predictions
from rafiki_tpu_torch.predictor.predictor import Predictor, default_quorum
from rafiki_tpu_torch.worker.inference import InferenceWorker

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

SMALL = dict(depth=11, width_mult=0.25, dropout=0.0, learning_rate=1e-3,
             batch_size=64, epochs=1, seed=0)
# Port vs JAX on bf16 serving blobs; see test_torch_vgg.BF16_PROB_ATOL.
BF16_PROB_ATOL = 5e-3
# Replicated route through the bus: replies arrive in any order and the
# float32 mean over k is not associative, so the two routes agree to a
# few float32 ulps of a probability, not bit for bit.
ROUTE_ATOL = 1e-6
TRIALS = [{"model_name": "vgg"}] * 3


@pytest.fixture(scope="module")
def blobs():
    out = []
    for seed in (0, 1, 2):
        m = JaxVgg(**SMALL)
        m._seed = seed
        m._build_loop(10, (32, 32, 3))
        out.append(m.dump_parameters())
    return out


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(7)
    return rng.uniform(0, 1, size=(5, 32, 32, 3)).astype(np.float32).tolist()


def _port_models(blobs):
    models = []
    for b in blobs:
        m = Vgg(device="cpu", **SMALL)
        m.load_parameters(b)
        models.append(m)
    return models


def _serve(bus, predictor_cls, worker_cls, models, queries):
    """Start one worker thread per model, answer ``queries`` one request
    per query and once as a microbatch, stop and drain the workers."""
    workers = [worker_cls(bus, "job", f"w{i}", m) for i, m in enumerate(models)]
    threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while len(bus.get_workers("job")) < len(workers):
        assert time.monotonic() < deadline, "workers never registered"
        time.sleep(0.01)
    pred = predictor_cls(bus, "job", timeout_s=60)
    single = [pred.predict([q])[0] for q in queries]
    batch = pred.predict_batch_detailed(queries)
    for w in workers:
        w.stop()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert all(w.drained.is_set() for w in workers)
    assert batch.ok() and batch.quorum == len(models)
    return np.asarray(single, np.float64), np.asarray(batch.outputs, np.float64)


def test_port_serves_both_routes_like_the_jax_package(blobs, queries):
    jax_models = []
    for b in blobs:
        m = JaxVgg(**SMALL)
        m.load_parameters(b)
        jax_models.append(m)
    ref, _ = _serve(JaxBus(), JaxPredictor, JaxWorker, jax_models, queries)

    telemetry.reset()
    rep, rep_b = _serve(InProcBus(), Predictor, InferenceWorker,
                        _port_models(blobs), queries)
    stacked, reason = build_stacked(TRIALS, _port_models(blobs), batch_size=8)
    assert reason == "stacked"
    assert stacked.warmup() > 0.0
    stk, stk_b = _serve(InProcBus(), Predictor, InferenceWorker, [stacked], queries)
    # Replicated: 3 workers x (5 single + 5 batched); stacked: 1 worker.
    assert telemetry.get_counter("inference.queries_served") == 40
    assert telemetry.get_counter("inference.batch_errors") == 0

    for got in (rep, rep_b, stk, stk_b):
        assert got.shape == (5, 10)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_PROB_ATOL)
    np.testing.assert_allclose(stk, rep, rtol=0, atol=ROUTE_ATOL)
    np.testing.assert_array_equal(stk, stk_b)


@pytest.mark.parametrize("stacked_batch", [8, 64])
def test_stacked_bit_matches_host_ensemble_of_serial_forwards(blobs, queries, stacked_batch):
    """The contract of docs/serving.md, inside the port: the stacked
    route's predictions BIT-MATCH the host ensemble of k serial
    forwards (same float32 mean + renormalize op sequence), whether the
    stacked chunk is smaller than the models' batch or the same."""
    models = _port_models(blobs)
    serial = [m.predict(queries) for m in models]
    host = [ensemble_predictions([s[i] for s in serial]) for i in range(len(queries))]
    stacked, reason = build_stacked(TRIALS, models, batch_size=stacked_batch)
    assert reason == "stacked"
    fused = stacked.predict(queries)
    assert np.array_equal(np.asarray(fused, np.float64), np.asarray(host, np.float64))
    # The stacked copy is the serving copy: the other models let go.
    assert all(m._module is None for m in models[1:])
    stacked.destroy()
    assert models[0]._module is None


def test_stacked_f32_forward_agrees_with_serial_to_rounding(blobs, queries):
    """In float32 too the stacked forward bit-matches the serial ones:
    under vmap each conv runs once per member, as the serial forward
    runs it, not as one grouped conv that sums in another order (the
    fault ROADMAP Queue 3 records; the bound here was 1e-6 before)."""
    from rafiki_tpu_torch.models.vgg import _Vgg
    from rafiki_tpu_torch.ops.train import predict
    from rafiki_tpu_torch.parallel.ensemble import StackedEnsemble

    f32 = []
    for m in _port_models(blobs):
        mod = _Vgg(11, 0.25, 10, (32, 32, 3), dtype=torch.float32)
        mod.load_state_dict(m._module.state_dict())
        f32.append(mod.eval())
    x = torch.tensor(queries, dtype=torch.float32)
    with torch.inference_mode():
        serial = np.stack([predict(m, x).numpy() for m in f32])
    stacked = StackedEnsemble(f32).predict_proba(x)
    assert stacked.shape == serial.shape == (3, 5, 10)
    np.testing.assert_array_equal(stacked, serial)


def test_build_stacked_fallback_reasons(blobs):
    class _NotTorch:
        pass

    got = build_stacked([{"model_name": "vgg"}], [_NotTorch()])
    assert got == (None, "single-trial")
    got = build_stacked([{"model_name": "vgg"}, {"model_name": "cnn"}],
                        [_NotTorch(), _NotTorch()])
    assert got == (None, "mixed-templates")
    got = build_stacked([{"model_name": "vgg"}] * 2, [_NotTorch(), _NotTorch()])
    assert got == (None, "not-torch-loaded")

    narrow = _port_models(blobs[:1])[0]
    wide = Vgg(device="cpu", **dict(SMALL, width_mult=0.5))
    wide.init_parameters(10, (32, 32, 3), torch.Generator().manual_seed(0))
    got = build_stacked([{"model_name": "vgg"}] * 2, [narrow, wide])
    assert got == (None, "param-shape-mismatch")
    assert try_build_stacked([{"model_name": "vgg"}] * 2, [narrow, wide]) is None


def test_worker_answers_a_failing_forward_with_errors():
    class _Broken:
        def predict(self, queries):
            raise ValueError("bad batch")

    bus = InProcBus()
    worker = InferenceWorker(bus, "job", "w0", _Broken())
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    try:
        while not bus.get_workers("job"):
            time.sleep(0.01)
        out = Predictor(bus, "job", timeout_s=10).predict([[0.0], [1.0]])
        assert out == [{"error": "all workers errored",
                        "detail": [{"error": "bad batch"}]}] * 2
    finally:
        worker.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()
    with pytest.raises(RuntimeError, match="no live inference workers"):
        Predictor(bus, "job").predict([[0.0]])
    assert default_quorum(3) == 2 and default_quorum(1) == 1
