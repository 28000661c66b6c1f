"""rafiki_tpu_torch: the PyTorch/CUDA port of rafiki_tpu.

The port is a package of its own beside the JAX package
(``rafiki_tpu/``), which stays the reference. It imports ``torch``,
``numpy`` and the standard library only: nothing of JAX, flax, optax,
ml_dtypes, werkzeug or ``rafiki_tpu``. Where it needs one of the JAX
package's framework-agnostic modules it keeps its own copy. Module
names mirror ``rafiki_tpu/`` so each counterpart is easy to find.

Entry points run on CUDA unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit CPU request they raise
(:func:`rafiki_tpu_torch.utils.backend.resolve_device`).

Ported so far:
  * the serving path: params blob -> model -> inference worker -> bus
    -> predictor -> ensemble, with the stacked (one vmapped forward over
    k trials) and replicated (one worker per trial) routes;
  * the trial's training path: ``Model.train(uri) -> evaluate(uri) ->
    dump_parameters()`` for ``Vgg`` and ``FeedForward`` (datasets,
    logger, the train loop with Adam and the health sentinels);
  * the train job: ``MetaStore``/``ParamsStore`` (the JAX package's
    schema and files) -> ``LocalScheduler.run_train_job`` ->
    ``TrainWorker`` -> advisor (random, TPE, or GP with its own Gaussian
    process) -> trials, with the model-developer harness
    (``model/dev.py``);
  * the service: the admin REST API (``admin/``, ``python -m
    rafiki_tpu_torch serve``), its ``Client``, and per inference job a
    published HTTP predictor behind the serving gateway (``gateway/``:
    admission, breakers, quorum gather, microbatching, drain);
  * the observability plane (``obs/``): trace ids across threads and
    bus envelopes, per-process JSONL journals under ``RAFIKI_LOG_DIR``
    in the JAX package's layout, the goodput ledger, the flight
    recorder, Prometheus text, SLO burn rates, and the perf profiler
    (each training program's FLOPs and MFU on the card), read by
    ``python -m rafiki_tpu_torch.obs``.
"""

__version__ = "0.1.0"
