"""The port on the CUDA card, held against its own CPU path.

Runs only where a card is present (marker ``cuda``); here it skips.
This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import threading
import time

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
            deadline = time.monotonic() + 60
            while len(bus.get_workers("job")) < len(workers):
                assert time.monotonic() < deadline, "workers never registered"
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


# Card vs CPU training, float32 with TF32 off: three steps of VGG11 w0.25
# from the same params on the same batches. The convs sum in other
# orders on the two devices, and Adam's first steps divide each gradient
# by its own magnitude, so elements whose gradient is rounding noise
# move by up to about lr: the params are held by their L2 distance
# relative to how far they moved. Readings (H100, max over the steps):
# loss 1.0e-7 rel, grad norm 4.9e-7, params 1.1e-2 of the distance
# moved. Bounds: about 3x.
TRAIN_PARITY_TOL = {"loss_rel": 1e-6, "grad_norm_rel": 2e-6, "param_rel_l2": 3e-2}


def test_card_training_steps_match_cpu(cuda):
    from rafiki_tpu_torch.convert import state_dict_to_flax
    from rafiki_tpu_torch.models.vgg import Vgg, _Vgg

    class VggF32(Vgg):
        def build_module(self, num_classes, input_shape):
            return _Vgg(11, 0.25, num_classes, input_shape, dtype=torch.float32)

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        src = VggF32(device="cpu", **SMALL)
        src.init_parameters(10, (8, 8, 3))
        start = {k: v.clone() for k, v in state_dict_to_flax(src._module).items()}
        rng = np.random.default_rng(3)
        batches = [{"x": torch.from_numpy(rng.uniform(0, 1, size=(16, 8, 8, 3)).astype(np.float32)),
                    "y": torch.from_numpy(rng.integers(0, 10, size=16).astype(np.int32))}
                   for _ in range(3)]
        runs = {}
        for device in ("cpu", cuda):
            m = VggF32(device=device, **SMALL)
            m.init_parameters(10, (8, 8, 3))  # the same seeded draw as src
            loop, rows = m._loop, []
            for b in batches:
                loop.state, metrics = loop.program.train_step(
                    loop.state, {k: v.to(loop.device) for k, v in b.items()})
                rows.append((float(metrics["loss"]), float(metrics["health_grad_norm"]),
                             int(metrics["health_nonfinite"]),
                             {k: v.detach().cpu().clone()
                              for k, v in state_dict_to_flax(m._module).items()}))
            runs[str(device)] = rows
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    for (loss_a, gn_a, nf_a, p_a), (loss_b, gn_b, nf_b, p_b) in zip(runs["cuda"], runs["cpu"]):
        assert nf_a == nf_b == 0
        num = sum(float(((p_a[k] - p_b[k]) ** 2).sum()) for k in p_a) ** 0.5
        den = sum(float(((p_b[k] - start[k]) ** 2).sum()) for k in p_a) ** 0.5
        r = {"loss_rel": abs(loss_a - loss_b) / loss_b, "grad_norm_rel": abs(gn_a - gn_b) / gn_b,
             "param_rel_l2": num / den}
        print(r)
        for key, bound in TRAIN_PARITY_TOL.items():
            assert r[key] <= bound, (key, r)
