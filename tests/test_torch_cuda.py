"""The port on the CUDA card, held against its own CPU path.

Runs only where a card is present (marker ``cuda``); here it skips.
This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import threading

import numpy as np
import pytest
import torch

SMALL = dict(depth=11, width_mult=0.25, dropout=0.0, learning_rate=1e-3,
             batch_size=64, epochs=1, seed=0)
# Card vs CPU, both bf16 compute: cuDNN and oneDNN round to bf16 at
# other points; the JAX package's own bf16-vs-f32 gap is about 2e-3.
BF16_PROB_ATOL = 5e-3

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _models(device):
    from rafiki_tpu_torch.models.vgg import Vgg

    blobs = []
    for seed in range(3):
        m = Vgg(device="cpu", **SMALL)
        m.init_parameters(10, (32, 32, 3), torch.Generator().manual_seed(seed))
        blobs.append(m.dump_parameters())
    out = []
    for b in blobs:
        m = Vgg(device=device, **SMALL)
        m.load_parameters(b)
        out.append(m)
    return out


def test_card_forward_matches_cpu(cuda):
    x = np.random.default_rng(0).uniform(0, 1, size=(7, 32, 32, 3)).astype(np.float32)
    card = [m.predict_proba(x) for m in _models(cuda)]
    cpu = [m.predict_proba(x) for m in _models("cpu")]
    for a, b in zip(card, cpu):
        assert a.shape == (7, 10) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=BF16_PROB_ATOL)


def test_card_stacked_route_matches_replicated(cuda):
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.bus.queues import InProcBus
    from rafiki_tpu_torch.parallel.serving import build_stacked
    from rafiki_tpu_torch.predictor.predictor import Predictor
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    queries = np.random.default_rng(1).uniform(0, 1, size=(5, 32, 32, 3)).astype(np.float32).tolist()
    stacked, reason = build_stacked([{"model_name": "vgg"}] * 3, _models(cuda))
    assert reason == "stacked" and stacked.warmup() > 0.0
    outs = []
    for models in ([stacked], _models(cuda)):
        telemetry.reset()
        bus = InProcBus()
        workers = [InferenceWorker(bus, "job", f"w{i}", m) for i, m in enumerate(models)]
        threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
        for t in threads:
            t.start()
        try:
            while len(bus.get_workers("job")) < len(workers):
                threading.Event().wait(0.01)
            outs.append(np.asarray(Predictor(bus, "job", timeout_s=60).predict(queries)))
        finally:
            for w in workers:
                w.stop()
            for t in threads:
                t.join(timeout=30)
        # Every worker served every query: an error reply would be
        # dropped from the ensemble and leave a smaller one behind.
        counters = telemetry.snapshot()["counters"]
        assert counters.get("inference.batch_errors", 0) == 0
        assert counters.get("predictor.hedged_gathers", 0) == 0
        assert counters["inference.queries_served"] == len(workers) * len(queries)
    assert outs[0].shape == (5, 10)
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=BF16_PROB_ATOL)
