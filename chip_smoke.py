#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one
CUDA card.

    python3 chip_smoke.py                  # from the root of a checkout
    python3 chip_smoke.py --bf16-readings  # the readings behind BF16_GAP_ATOL
    python3 chip_smoke.py --packed-step    # phase 16 alone: eager vs captured steps
    python3 chip_smoke.py --zoo            # phases 17-18 alone: DenseNet job, zoo trials
    python3 chip_smoke.py --obs            # phase 19 alone: journal, profile, trace
    python3 chip_smoke.py --chaos          # phase 20 alone: poisoned pack, replay, scenarios
    python3 chip_smoke.py --process        # phase 21 alone: subprocess workers, dp mesh
    python3 chip_smoke.py --mesh           # phase 22 alone: mesh sweep and its training
                                           #   twin, resume, sharded lane
    python3 chip_smoke.py --search         # phase 23 alone: early kill, speculation, audit
    python3 chip_smoke.py --mesh-repack N  # phase 22 (b) alone, N times
    python3 chip_smoke.py --serve-proc     # phase 24 alone: serving across processes
    python3 chip_smoke.py --tenancy [N]    # phase 25 alone: co-hosting, tenant isolation
    python3 chip_smoke.py --autoscale      # phase 26 alone: scale-up, prewarm, the twin

Drives ``rafiki_tpu_torch`` the way a user serves a top-k ensemble,
the way a tuning job runs and the way a trial trains, at the full width
of the bench's canonical model (VGG16, width_mult=1.0, 32x32x3 inputs,
10 classes), then the rest of the model zoo at the widest of each
template's knobs (phases 17-18).

Serving, k=3 trials of random weights, batch 64:

  1. the card's identity (``nvidia-smi`` name and power limit);
  2. three seeded trials: ``init_parameters`` -> ``dump_parameters``
     (bf16 RTPK1 blobs) -> ``load_parameters`` into fresh CUDA models;
  3. forward parity: each trial's float32 forward, card vs CPU, and
     each bf16 forward against the float32 forward on its own device,
     over two query sets;
  4. serving through InProcBus + InferenceWorker threads + Predictor:
     64 single-query requests and 64-query bursts, once through the
     stacked route (one vmapped forward over the 3 trials) and once
     through the replicated route (one worker per trial). Every worker
     must serve every query without an error; both routes agree with
     each other and with the CPU ensemble;
  5. timings (warmup, p50/p99 latency at 1 and 64 queries, queries/s,
     peak device memory) and a device profile of the same models'
     forwards (CUDA events and ``torch.profiler``), each with the
     card's name and power limit.

Training, the bench's canonical job and trial (VGG16 w1.0, one epoch of
the 50k-image synthetic task, bf16 compute):

  6. tune_job: the bench's canonical train job (``bench.py``
     ``run_real_loop``) through the port's entry points: a ``BenchVgg``
     template uploaded with ``MetaStore.create_model``, a job of
     TUNE_TRIALS trials (its GP warmed up on TUNE_ADVISOR's 3 proposals),
     ``LocalScheduler.run_train_job(n_workers=1,
     advisor_kind="gp")`` on the card, params in a ``ParamsStore``. One
     line per trial (knobs, status, score, seconds) in completion order,
     then one for the job (wall seconds, completed trials per hour, the
     cold trial, the advisor's and the saver's seconds, device memory).
     Fails unless the job COMPLETED, every ERRORED trial is a contained
     divergence, the GP proposed from expected improvement, the best
     score reaches TUNE_TOP1_TARGET and the memory left after each trial
     does not grow;
  7. the job's top-2 trials' stored blobs loaded into serving models
     and stacked: each trial's served argmax accuracy on the eval set
     against the score ``evaluate`` stored for it;
  8. one canonical trial (batch 128, dropout 0.1, lr 1e-3) through
     ``train -> evaluate -> dump_parameters``: every epoch's loss finite
     and no ``DivergenceError``, eval accuracy above ACC_FLOOR;
  9. FeedForward at its widest knobs (3 x 256, batch 128) trained and
     evaluated;
 10. card-vs-CPU training parity: three float32 steps (TF32 off,
     dropout 0) of VGG16 w1.0 from the same params on both devices;
     loss, the sentinel norms and the params after each step.

The service, as a user drives it (phase ``service_journey``):

 11. the admin server started through ``admin.app.serve`` (what
     ``python -m rafiki_tpu_torch serve`` runs) on the card, on a free
     loopback port, over a fresh data dir; ``GET /`` must serve the web
     UI byte-equal to ``rafiki_tpu_torch/web/index.html``; with the
     port's ``Client``:
     log in, upload BENCH_SRC, a JOURNEY_TRIALS-trial GP train job on
     the canonical task, then an inference job over its top 2 (the
     stacked route); JOURNEY_1Q requests of one query and JOURNEY_64Q of
     64 POSTed to the published predictor host (client p50/p99 and the
     server's split: JSON decode, gateway, JSON encode), the HTTP
     predictions for JOURNEY_IMAGES eval images against an in-process
     stacked ensemble of the same stored blobs (JOURNEY_ATOL) and their
     accuracy; then the job again with microbatching, under
     MB_THREADS x MB_REQUESTS concurrent single-query requests; then
     everything stopped, and the memory allocated on the card back
     within TUNE_LEAK_BYTES of its reading before the inference job.

Trial packing, the same canonical model and task:

 12. trial_pack (the counterpart of ``bench.py run_trial_pack_micro``
     at the canonical model): four BenchVgg trials at batch 128 (lr
     3e-4/1e-3/2e-3/3e-3 with dropout 0.0/0.1/0.2/0.3, one packing key),
     back to back in series and then as one pack
     (``train_packed`` -> ``evaluate_packed``), each path warmed up first
     on a 1024-image task of the same shapes, untimed. One line: serial
     and packed seconds (and per trial), the speedup, each member's
     packed score against its serial score, the pack's peak memory, and a
     count of captured steps replayed on each path. Fails unless every
     member's packed score is within PACK_SCORE_ATOL of its serial score,
     the member at lr 1e-3 / dropout 0.1 is above ACC_FLOOR, and every
     loss is finite. Then one line of captured step times, a serial
     trial's and packs of 1, 2 and 4 on the same card, and one float32
     step of a one-member pack against the serial step, gradient by
     gradient, which must give every gradient bit for bit;
 13. tune_job_packed: phase 6's job again with
     ``run_train_job(..., trial_pack=PACK_K)``. Its line is tune_job's
     plus the ``trial_pack.size`` and ``trial_pack.fill_ratio``
     histograms, ``worker.packed_rounds``/``packed_trials`` and the
     serial job's trials per hour from phase 6. Gates as phase 6's
     (the memory one reads the memory allocated before and after the job:
     a packed trial is scored in its pack's shared pass, not by its own
     ``evaluate``), plus ``worker.packed_rounds >= 1``, and the top-2
     served within SERVED_ACC_ATOL of their stored scores, as in 7.

Checkpoints, resume and orphan recovery, the canonical model for 3
epochs on the canonical task cut to RESUME_IMAGES images (params blobs
stored in float32, compared byte for byte):

 14. trial_resume: one trial (batch 256, dropout 0.2) uninterrupted, its
     params the reference; then the same knobs in a child process (a
     ``TrainWorker`` under a service row, RAFIKI_CHECKPOINT_EVERY=1),
     SIGKILLed once its epoch-0 checkpoint is durable; then the admin's
     ``POST /recovery`` through its REST app (``wait: true``,
     ``stale_after_s`` 1 s below the dead worker's silence). Fails unless
     the trial COMPLETED, resumed from epoch 1 or later, its params equal
     the reference's, its checkpoints are deleted and no orphan is left.
     Prints the checkpoint's bytes, its write and restore seconds, the
     seconds from POST to COMPLETED and the epochs trained after resume;
 15. pack_resume: two trials (batch 128, lr 1e-3/3e-4, dropout 0.1/0.2)
     as one pack (``PackedTrialRunner``, checkpoints every epoch) in a
     child process, SIGKILLed once the round-0 checkpoints are durable;
     both recovered by ``recover_orphaned_trials`` and resumed serially.
     Fails unless each ends byte-equal to an uninterrupted serial run of
     its knobs. Prints each member's checkpoint bytes and the pack's
     checkpoint seconds per round.

The captured step against the eager step:

 16. graph_step: the canonical serial step (batch 128, dropout 0.1, lr
     1e-3) and the k=PACK_K packed step (PACK_MEMBERS), each run eagerly
     (``Program.train_step``, the plain version) and captured
     (``train_steps``: GRAPH_WARMUP_STEPS eager steps, one capture,
     replays) from one initial state over the same batches of random
     data on the card. Per path: CUDA-event ms a step, device busy ms,
     idle share, device kernels and host launch calls a step; for the
     captured path the capture seconds and the memory its graph
     reserved. Fails unless the two paths end with the same params,
     moments, counts and generator states, and every step's loss and
     sentinels, bit for bit.

The rest of the model zoo:

 17. densenet_job: a ``BenchDenseNet`` template (DenseNet-BC depth 58,
     growth 24, the widest of its knob space; one epoch, tuning the
     learning rate and batch 64/128) uploaded as source, as a GP job of
     DENSENET_TRIALS trials (DENSENET_ADVISOR's 2 warm-up proposals)
     through ``LocalScheduler.run_train_job`` on
     the canonical task; its top-2 served through the stacked route
     against their stored scores (as 7); a k=2 pack of two DenseNet
     trials (``train_packed`` -> ``evaluate_packed``, one epoch of
     PROC_URI, the canonical task cut to 10,000 images since phase 24
     needed the time); the step at batch 128, eager
     under the profiler (forward, backward, Adam, sentinels, costliest
     operators) and captured (CUDA-event ms, device busy ms), as 16
     reads them; and one float32 step of a one-member pack against the
     serial step, gradient by gradient. One line per trial, then the
     phase's line: job wall and completed trials per hour, the cold
     trial and warm trial seconds by batch size, peak memory, the
     pack's seconds against two serial trials' (the job's warm ones at
     batch 128, scaled from 50,000 images to PROC_URI's). Fails unless the job
     COMPLETED with an expected-improvement proposal and a best score
     of TUNE_TOP1_TARGET, the memory left after each trial does not
     grow, the top-2 serve within SERVED_ACC_ATOL, every epoch replayed
     its captured step and every float32 gradient is bit-equal;
 18. zoo_trials: one Transformer trial at its widest knobs (embed 128,
     4 heads, 2 layers, batch 64) on ``synthetic://text`` (vocab 81, 5
     classes, 50,000 sequences of 128 tokens) and one PosBiLstm trial
     (embed 128, hidden 128, batch 64) on ``synthetic://corpus`` (vocab
     100, 8 tags, 20,000 sequences of up to 32 tokens) through train ->
     evaluate -> dump -> load -> predict on the card, with seconds and
     replays; PosBigramHmm trained and predicting on the host; every
     registry name resolved. Fails unless both scores pass
     ``tests/test_zoo.py``'s floor (ZOO_SCORE_FLOOR), each float32
     forward agrees card against CPU within F32_ATOL, PosBiLstm gives
     one tag per query token, the HMM passes the floor, and each
     registry name resolves or, for SkDt and SkSvm without
     scikit-learn, raises the reference's ValueError.

The observability plane:

 19. observability: with ``RAFIKI_LOG_DIR`` set to a temporary
     directory (``obs.configure_from_env``), the admin server on the
     card runs a GP job of OBS_TRIALS ``ObsVgg`` trials (the canonical
     knobs, two epochs, the learning rate tuned) with trial packing at
     k=OBS_PACK (one pack of two, one serial trial), serves its top-2
     stacked and answers one query through ``Client``, the HTTP
     predictor and the gateway; then the journal is closed and read
     back through the port's CLI (``rafiki_tpu_torch/obs/cli.py``):
     ``profile`` (per program: FLOPs a step, steps an epoch, the warm
     epoch p50, achieved TFLOP/s and MFU against the card's peak, next
     to its name and power limit) and ``trace`` (the query's records
     across the HTTP span, the gateway, the bus envelope and the
     inference worker), and the host cost of the hooks a warm epoch
     journals is timed. Fails unless both programs have a FLOP count
     and, on a known H100, an MFU; every ``perf/step`` record carries
     ``steps``; the serial step's count equals the analytic count of
     VGG16's convolutions and dense layers at batch 128 (OBS_FLOPS_RTOL)
     and the pack's is OBS_PACK times it; and the query's records
     stitch into one trace (OBS_TRACE_PAIRS).

Fault injection and divergence capsules:

 20. chaos: with a journal and ``RAFIKI_CHAOS`` set to CHAOS_SPEC, four
     canonical trials (CHAOS_KNOBS: batch 128, dropout 0, lr 3e-4 to
     1e-3, 3 epochs of the canonical task cut to CHAOS_IMAGES images)
     as claimed rows of one pack, ``PackedTrialRunner(worker, 4).
     run_assigned(rows, budget_max=4)``: member 2's gradients are
     NaN-poisoned at step 39 of its first epoch. Fails unless the fault
     fired once for ``@m2``; the 4 rows end with member 2 ERRORED
     (``diverged``) and 3 COMPLETED and scored; ``health.divergences``,
     ``health.contained`` and ``health.evictions`` count; the journal
     holds ``health/divergence`` and ``health/capsule``; and the
     survivors' float32 params blobs are byte-equal to unfaulted serial
     runs of their knobs on the card. Then ``python -m
     rafiki_tpu_torch.obs replay <capsule> --json`` in a fresh process
     on the card must reproduce the bad step (poisoned, ``bad_step + 1``
     = 40 steps of 78, under the capture's numerics switches). Then the
     canonical captured step of phase 16, with no plane and with a plane
     active that does not fire (CHAOS_QUIET_SPEC), must capture a graph
     of the same kernel nodes (read through libcuda), with no poison
     multiply, and the same step under a firing plane a graph of more;
     the profiler's kernels a step of each are printed beside phase 16's.
     Then the six in-process chaos
     scenarios of ``rafiki_tpu_torch/chaos`` run with the card visible,
     each passing (the three that kill ProcessScheduler workers need
     subprocesses, and ``collective-kill-mid-step`` two cards; phase 21
     runs ``kill-mid-pack-resume`` at the canonical model). The line prints the snapshot's device ms an epoch,
     the capsule's bytes and write seconds, the replay's seconds and the
     phase's.

Process workers and within-trial data parallelism:

 21. process: (a) phase 6's job (BENCH_SRC, PROC_TUNE_TRIALS GP trials on the
     canonical task) through ``ProcessScheduler.run_train_job(n_workers=1,
     devices_per_trial=1, advisor_kind="gp")``: one ``python -m
     rafiki_tpu_torch.worker.main`` subprocess under
     ``CUDA_VISIBLE_DEVICES=0``, the advisor served over loopback HTTP;
     its line prints the job wall, completed trials per hour and the
     worker's spawn-to-first-claim seconds, beside phase 6's in-process
     job. Fails unless the job COMPLETED with params for every trial,
     the best score reaches TUNE_TOP1_TARGET, and its top-2 stored blobs
     serve within SERVED_ACC_ATOL of their stored scores (as 7).
     (b) ``kill-mid-pack-resume`` at the canonical model: a k=PROC_KILL_K
     pack of PROC_PACK_SRC trials (batch 128, 3 epochs on PROC_CUT_URI)
     under the scheduler with the JAX package's spec and env
     (PROC_KILL_SPEC, PROC_KILL_ENV, its pack of four cut to two): the
     worker SIGKILLs itself after epoch 1 and the respawned ``-r1``
     worker resumes every member from its slice checkpoints; the line
     carries the job's event timeline. Fails unless all COMPLETED under
     ``-r1``, each
     resumed from epoch 1 or later, no checkpoint is left, and each
     member's float32 params are byte-equal to an unfaulted serial run
     of its knobs in this process. (c) the canonical trial (TRAIN_KNOBS,
     two epochs on PROC_CUT_URI) with ``set_mesh(data_parallel_mesh(...))``
     over a one-rank NCCL group, against the same trial with no mesh:
     fails unless the params are byte-equal (an all-reduce over one rank
     and the division by 1 change no bit) and the dp trial replayed no
     captured step (its steps run eagerly); prints the warm epoch's ms a
     step of both paths. Width 2 and more need two cards; the CPU tests
     show them over gloo.

The mesh sweep, its write-ahead log and resume, and the sharded lane:

 22. mesh: (a) a ``MeshVgg`` sweep (MESH_SRC: the canonical model at
     batch 128, 2 epochs of PROC_URI; a member at dropout 0.2 or more
     stops after one epoch) of MESH_TRIALS GP trials through
     ``MeshSweepScheduler.run_sweep(chips=1, trials_per_chip=MESH_K)``
     on the card: one batched draft of 4, every claim bracketed in the
     sweep's WAL, the stopped members' slots backfilled until the budget
     drains, the port's journal open in a temporary directory. Fails
     unless the job COMPLETED with MESH_TRIALS scored trials with
     params, the WAL reconciles (no double claim, claimed == rows), the
     best score reaches TUNE_TOP1_TARGET, a backfill ran, and the first
     and the last trial's float32 params are byte-equal to their serial
     trials'. Then the training twin (``obs/twin/train``) on that
     journal, one line with the card's name and power limit:
     ``validate``'s measured and predicted trials/hour and wall,
     ``tph_err``, ``wall_err`` and ``event_log_sha1``, faithful and
     doctored (TWIN_DOCTORED), and the JAX package's replay, which reads
     no ``trial_pack/rounds``, beside them. Fails unless the journal
     calibrates, the faithful bundle is within TWIN_TOLERANCE, the
     doctored one is not, and two replays of one seed give one digest.
     (b) ``mesh-chip-loss-repack`` at the canonical model
     (PROC_PACK_SRC, 3 epochs, budget 4, k=2) under
     ``RAFIKI_TWIN_PLACEMENT=1``, its journal in (a)'s directory: two
     chips share the card, the scenario's spec preempts chip 1. Fails
     unless every trial COMPLETED under chip 0, chip 1's rows were
     re-packed onto chip 0 and resumed from epoch 1 or later, each
     trial's params are byte-equal to an unfaulted serial run, both
     chips' threads replayed captured steps, and the twin's advisory
     consult journaled one ``twin/placement`` record for the job before
     its first ``mesh/pack_formed``, with a ``best_split`` (alone, as
     ``--mesh-repack N``, an ``error``: nothing to calibrate from), that
     ``obs decisions`` lists once. (c) the sharded lane at
     the Transformer's widest knobs (MESH_TF_SRC, 3 epochs of 10,000
     sequences of 128 tokens, ``RAFIKI_SHARD_WIDTH=2``, both members on
     the card): an unfaulted width-2 trial through the sweep's
     ``GroupHandle``, then ``chip-loss-mid-sharded-trial`` (member 1
     preempted, the group re-formed at width 1, reshard-on-restore).
     Fails unless both trials' params are byte-equal to the serial
     trial's and the journal shows the widths [2] and [2, 1] and one
     2 -> 1 reshard; prints the warm epoch ms at width 2, width 1 and
     serial, and the manifests' bytes. (d) ``supervisor-kill-mid-sweep``
     through ``sweep_proc`` subprocesses on the card; fails unless the
     scenario passes (the resumed sweep reconciles with no double
     claim, adopts the orphans, and ends with the unfaulted run's best
     score and knob set). ``mesh-degrades-single-chip`` and
     ``host-loss-mid-sweep`` run in the CPU tests only.

The search plane, both ``RAFIKI_CURVE_*`` switches on, the canonical
model (SEARCH_SRC: VGG16 w1.0, bf16, batch 128, SEARCH_EPOCHS epochs of
PROC_URI), the kill rule's defaults but a margin of SEARCH_MARGIN:

 23. search: (a) one ``TrainWorker`` with its own curve coordinator and a
     journal; two ``run_trial`` calls of SEARCH_SERIAL's knobs, proposed
     by a scripted advisor that journals its proposals: lr 1e-3 trains
     to the end and sets best-so-far, lr 3e-2 (chance at batch 128) is
     killed at an epoch boundary. Fails unless the second row is ERRORED
     ``early_killed`` after fewer epochs than its budget, the journal
     holds its ``advisor/predict`` and ``advisor/kill`` records, the
     advisor heard the kill's predicted score, and the memory allocated
     on the card after it is within TUNE_LEAK_BYTES of the reading
     before it. (b) the same worker and coordinator, its packed arm
     (``PackedTrialRunner.run_round``): a k=2 pack of SEARCH_PACK's
     knobs, whose chance member is evicted ``killed`` while its pack-mate
     trains on (the backfill that follows speculates the pack-mate, then
     finds the budget drained). Fails unless the killed member is ERRORED
     ``early_killed`` and was not evaluated, the survivor's float32
     params are byte-equal to a serial run of its knobs, ``obs lineage``
     shows the eviction, ``obs sweep`` reconciles with both kills, and
     the search ledger counts two doomed trials with their wall. (c)
     ``early-kill-mid-pack-resume`` through ``sweep_proc`` subprocesses
     on the card; fails unless every check passes. One line per part,
     with its seconds, each kill's epoch, the fit's predicted, hi and
     best, and the survivor's byte-equality.

Serving across processes and its request anatomy, phase 1's three
random-weight trials stored under the ``BenchVgg`` source (bf16 blobs in
a ``ParamsStore``, rows in a ``MetaStore``), the parent journaling:

 24. serve_proc: (a) three ``run_inference_worker_process`` children on
     the card over ``make_mp_bus``, with ``Predictor`` and ``Gateway``
     (quorum of 3) here; SERVE_PROC_1Q requests of one query and
     SERVE_PROC_64Q of 64, then the same through the in-process route
     (thread workers over ``InProcBus``, the same blobs). Fails unless
     the process route's predictions equal the in-process route's within
     SERVE_PROC_ATOL, one traced request's ``obs waterfall`` shows
     ``admit, queue, enq, deq, fwds, fwd, reply, dec`` on each of its
     three chains with four pids across them, ``obs tails --check``
     reconciles at 0.10, ``obs serving`` shows a ``serving/ts`` row, and
     ``serving.hop.forward_s`` has samples for the ``serving_forward_p99``
     SLO to read. Prints spawn-to-registered seconds, each hop's p50 and
     p99, the fan-out cost's p50, both routes' client p50/p99, and the
     in-process forward split into copy in, host launch, sync wait and
     device span, alone and on three threads (``_forward_split``). (b) one
     replica SIGKILLed under a load of single-query requests through a
     quorum-2 gateway (lease TTL SERVE_PROC_TTL_S): fails unless every
     request answers, the corpse leaves the fresh set within a lease and
     is reaped, and every bus call of this process returns within
     SERVE_PROC_CALL_S; prints kill-to-first-quorum-answer seconds. (c)
     ``stacked-worker-loss-fallback`` on the card: a child serves the
     stacked top-3 (``build_stacked``) and kills itself on its second
     forward (the scenario's ``RAFIKI_CHAOS``); the ``FallbackSupervisor``
     starts per-trial thread workers here, on the card. Fails unless the
     scenario's seven checks pass (five requests, none dropped; a blackout
     re-route; ``serving/fallback`` journaled; the child's
     ``chaos/injected`` record with its pid); prints kill-to-fallback-
     serving seconds.

Multi-tenant serving, random-weight VGG16 w1.0 trials (bf16 blobs)
saved through ``make_params_store`` with ``RAFIKI_PARAMS_CAS=1``:

 25. tenancy: (a) four jobs of three trials each, J0 phase 1's, J1 and J2
     their own, J3 J0's first two plus one of its own (so its CAS save
     writes only its new trial's chunks), served by ONE worker through
     ``ServicesManager.create_cohosted_inference_services`` under an HBM
     budget of 2.5 times one job's charge (two jobs resident), gateways
     microbatching so a 64-query request is one forward. Single-query
     requests in the order TENANCY_ORDER, and one 64-query request on each
     job's first. Fails unless each job's co-hosted predictions equal the
     same job served alone through ``create_inference_services`` within
     TENANCY_ATOL, the journal's ``tenancy/residency`` events equal the LRU
     sequence computed here from the requests, no record's ``used_bytes``
     exceeds the budget, every eviction lowers ``memory_allocated`` by at
     least TENANCY_FREE_FRAC of what its activation raised it by (read
     around each load inside the worker and between requests), J3's save
     wrote exactly the chunks its new trial added, and each charge is the
     blobs' logical bytes. Prints each job's charge against its
     activation bytes, ``load_s`` per activation, the client p50 of hit
     and miss requests and the store's ``dedup_ratio``. (b)
     ``noisy-neighbor-shed`` on a real forward: phase 1's job through
     ``create_inference_services(tenancy=TenantFabric(...))`` (gold
     victim, batch aggressor, 2 inflight, 8 queued) and its HTTP
     predictor, the scenario's 60 ms ``inference.forward`` delay on top of
     the card's forward (the services manager has frozen the server's
     heap, ``utils/heap.py``); after three warm-up requests, eight
     threads of a client process flood ``POST /predict`` as the aggressor
     (``X-Rafiki-Tenant``), then 25 victim requests go 20 ms apart.
     Fails unless the scenario's six checks pass from the journal and
     ``obs tenants --check`` exits 0, and unless the same run under
     ``RAFIKI_TENANT_UNWEIGHTED=1`` fails ``victim_p99_within_budget``.

Closed-loop elasticity and the serving twin, phase 1's trials:

 26. autoscale: (a) the trials as a stacked job at batch 64 through
     ``ServicesManager`` (a tenant-aware gateway, one reply enough), a
     private SLO on the serving p99 gauge (AUTOSCALE_SLO_MS over
     AUTOSCALE_WINDOW_S) and ``attach_autoscaler`` (1 to 2 workers, a
     0.2 s tick); the base replica pinned slow
     (``inference.forward:delay`` of AUTOSCALE_DELAY_S) and requests
     driven one after another until the burn breaches and clears. Fails
     unless the controller journals an actuated ``up``, the replica
     registers and answers, the burn clears within AUTOSCALE_RECOVERY_S
     of the breach, there are at most AUTOSCALE_MAX_ACTUATIONS
     actuations, the replica's answers to 64 queries equal the base
     replica's bit for bit, and a forced scale-down drains, reaps and
     frees it with ``memory_allocated`` back within TUNE_LEAK_BYTES of
     its value before the spawn. Prints breach to actuation, the
     replica's build (load, stack, capture: the actuation's span),
     registration to first answer, recovery and the freed bytes. (c) the
     serving twin on the card's own journal: TWIN_REQUESTS requests of
     two tenants in turns calibrate it (``serving/hops``,
     ``serving/ts``) and ``validate`` prints predicted against measured
     p50 and p99 with its 0.40 tolerance (a reading: it does not fail the
     run); then a window whose forward is held to TWIN_GATE_FORWARD_S
     builds ``JobAdmissionGate.from_capture``, which must admit a light
     job and refuse, with ``JobRejected``, one whose load breaches the
     gold tenant's budget, both verdicts journaled ``tenancy/arbiter``.
     (b) a canonical k=2 job (PREWARM_SRC, two trials on PROC_URI)
     admitted through ``create_train_services``, the program cache cleared
     first, without and then with ``RAFIKI_AUTOSCALE_PREWARM=1``. Fails
     unless both complete in a pack, the prewarmed job's
     ``autoscale/prewarm`` record says hit or warmed and its pack adds no
     ``program_cache.misses``. Prints the prewarm's seconds and each
     job's first packed epoch (``perf/step``), beside phase 12's pack.

The whole script's seconds are printed before the kernel line.

Every training phase runs its epochs as captured CUDA graphs
(``ops/graphs.py``). Each phase's line carries its seconds
(``phase_s``) and the captured steps it replayed (``graph_replays``,
with ``graph_captures`` and their seconds); the canonical trials'
phases (6, 8, 11-18) fail without a replay.

The port has no hand-written kernel yet (the JAX package has no Pallas
kernel to port), so the kernel line is ``{"kernels": []}``. The last
line is ``{"ok": true, "device": {...}}``. Any failed phase exits
nonzero before it; without a CUDA device the script exits 1 at once.

``--bf16-readings`` runs only the forward-parity measurement, over 16
other trial seeds and 4 other query sets, and prints the readings.
``--packed-step`` runs only phase 16, on random batches resident on the
card, so two checkouts can be compared in one call. ``--zoo`` runs only
phases 17 and 18, ``--obs`` only phase 19, ``--chaos`` only phase 20
(its clean-step check then holds the two runs of phase 20 to each
other, with no phase 16 count to add), ``--process`` only phase 21,
``--mesh`` only phase 22 (its twin line included), ``--search`` only
phase 23, ``--serve-proc``
only phase 24, ``--tenancy [N]`` only phase 25 (its weighted
isolation run N times over, 1 unless given), ``--autoscale`` only phase
26 (its cold job is then the process's first training, so its first
epoch also pays the process's own start), ``--mesh-repack N``
phase 22 (b) N times over (two chips' threads sharing the card, to
catch a capture that another thread's synchronize invalidates now and
then). ``--resume-child`` is the
child worker of phases 14 and 15; it journals when its parent sets
``RAFIKI_LOG_DIR``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np

K = 3
BATCH = 64
N_SINGLE = 64
N_BURSTS = 8
QUERY_SETS = 2
# Steps (or forwards) a window is timed over with CUDA events, and then
# profiled over: 6 since phase 25 needed the time (20 until phase 24, 10
# until phase 25; the profiler's trace of an eager packed step is costly
# to read back).
PROFILE_ITERS = 6
INPUT_SHAPE = (32, 32, 3)
NUM_CLASSES = 10
KNOBS = dict(depth=16, width_mult=1.0, dropout=0.0, learning_rate=1e-3,
             batch_size=BATCH, epochs=1, seed=0)
# The float32 build of the same network, card vs CPU, TF32 off: only the
# summation order differs, through 13 conv layers. This is the check
# that the card computes the same function as the CPU path.
F32_ATOL = 1e-4
# One trial's bf16 forward against the float32 forward of the same
# params on the same device, and the card's bf16 forward against the
# CPU's (probabilities, max abs). Each bound is 1.25x the largest of
# the readings that ``--bf16-readings`` takes (16 other trial seeds x 4
# other query sets), rounded up to 1e-3: 5.6e-3 (bf16 vs float32, on
# the CPU) and 5.5e-3 (card vs CPU) on an H100; PERF.md gives them all.
BF16_GAP_ATOL = 7e-3
BF16_CARD_VS_CPU_ATOL = 7e-3
# The served k=3 ensemble against the ensemble of the CPU forwards: the
# mean over trials halves the rounding spread of a single forward.
ENSEMBLE_ATOL = 5e-3
# Stacked vs replicated on the card: the vmapped forward runs grouped
# convs, for which cuDNN may choose other algorithms than for the k
# plain convs, so the routes agree to bf16 rounding, not bit for bit.
ROUTE_ATOL = 5e-3

# -- training -----------------------------------------------------------------
TRAIN_KNOBS = dict(depth=16, width_mult=1.0, dropout=0.1, learning_rate=1e-3,
                   batch_size=128, epochs=1, seed=0)
TRIAL_SEEDS = (0,)
# The bench's canonical task (bench.py CANON_TRAIN and run_real_loop):
# noise 0.35 and 20% of labels flipped, so a perfect classifier scores
# 0.8 + 0.2 / 10 = 0.82.
TRAIN_URI = "synthetic://images?classes=10&n=50000&w=32&h=32&c=3&seed=0&noise=0.35&flip=0.2"
EVAL_URI = "synthetic://images?classes=10&n=10000&w=32&h=32&c=3&seed=1&noise=0.35&flip=0.2"
# Readings (H100, the first run of this phase): 0.8231 for all three
# trials, which is this eval set's ceiling: every trial labels every
# example by its class template, and the errors are the flipped labels.
# The floor leaves 0.04 below it; the bench's own target is 0.70.
ACC_FLOOR = 0.78
# A trial's served accuracy (its bf16-stored blob, through the stacked
# vmapped forward) against the accuracy ``evaluate`` reported (the
# trained float32 params through the serial forward). Readings: equal
# for all three trials. The bound allows 20 flips of 10,000 near-ties.
SERVED_ACC_ATOL = 0.002
# The bench's canonical job (bench.py BENCH_MODEL_SRC and run_real_loop):
# VGG16 w1.0 for one epoch, tuning dropout, the learning rate and the
# batch size. Five trials (ten until phase 23 needed the time), the GP
# warmed up on TUNE_ADVISOR's 3 proposals (8 by default), so trials 4
# and 5 come from expected improvement.
TUNE_TRIALS = 5
TUNE_ADVISOR = {"n_initial": 3}
TUNE_TOP1_TARGET = 0.70  # bench.py _scale: the top-1 gate off the CPU
# The memory allocated once a trial has evaluated (its own model
# resident, the previous trial's destroyed), last trial against first.
TUNE_LEAK_BYTES = 64 << 20
BENCH_SRC = b'''
import torch

from rafiki_tpu_torch.model.knobs import CategoricalKnob, FixedKnob, FloatKnob
from rafiki_tpu_torch.models.vgg import Vgg


class BenchVgg(Vgg):
    """Canonical-trial VGG16: fixed arch, tunable lr/dropout/batch."""

    #: torch.cuda.memory_allocated() once each trial has evaluated, and
    #: once each trial's model is destroyed (on the params saver's thread).
    evaluated_bytes = []
    destroyed_bytes = []

    @staticmethod
    def get_knob_config():
        return {
            "depth": FixedKnob(16),
            "width_mult": FixedKnob(1.0),
            "dropout": FloatKnob(0.0, 0.5),
            "learning_rate": FloatKnob(1e-4, 3e-2, is_exp=True),
            "batch_size": CategoricalKnob([64, 128, 256], affects_shape=True),
            "epochs": FixedKnob(1),
            "seed": FixedKnob(0),
        }

    def evaluate(self, dataset_uri):
        score = super().evaluate(dataset_uri)
        torch.cuda.synchronize()
        BenchVgg.evaluated_bytes.append(torch.cuda.memory_allocated())
        return score

    def destroy(self):
        super().destroy()
        torch.cuda.synchronize()
        BenchVgg.destroyed_bytes.append(torch.cuda.memory_allocated())
'''
FF_KNOBS = dict(hidden_layers=3, hidden_units=256, learning_rate=1e-3, batch_size=128,
                epochs=3, seed=0)
FF_TRAIN_URI = "synthetic://images?classes=10&n=2048&seed=0"
FF_EVAL_URI = "synthetic://images?classes=10&n=512&seed=1"
# Reading: 1.0 (the 28x28x1 default task separates easily).
FF_ACC_FLOOR = 0.95
PARITY_STEPS = 3
PARITY_BATCH = 8
# Card vs CPU, float32 with TF32 off, after each of PARITY_STEPS steps
# (warmup 1 step, so lr 1e-3 from the first). Readings (H100, the
# first run, max over the 3 steps): loss 8.0e-6 rel, grad norm 8.5e-5,
# update norm 3.6e-4, param norm 1.0e-5, params 6.8e-3 of the distance
# they moved (2.9e-3 max abs: Adam moves an element whose gradient is
# rounding noise by up to lr either way). The forward agrees to 1e-6;
# the gradients less closely, as cuDNN's backward algorithms sum in
# other orders. Bounds: about 3x the readings.
PARITY_TOL = {"loss_rel": 3e-5, "health_grad_norm_rel": 3e-4,
              "health_update_norm_rel": 1e-3, "health_param_norm_rel": 3e-5,
              "param_rel_l2": 2e-2}
# -- trial packing ------------------------------------------------------------
PACK_K = 4
PACK_KNOBS = dict(depth=16, width_mult=1.0, batch_size=128, epochs=1, seed=0)
# Below the lr at which trials of the canonical job train to chance.
PACK_MEMBERS = ({"learning_rate": 3e-4, "dropout": 0.0}, {"learning_rate": 1e-3, "dropout": 0.1},
                {"learning_rate": 2e-3, "dropout": 0.2}, {"learning_rate": 3e-3, "dropout": 0.3})
# A member's packed score against its serial score: the JAX package's
# bound for packed against serial (tests/test_trial_pack.py:85).
PACK_SCORE_ATOL = 0.02
# The warm-up task of both paths: the canonical shapes, 8 steps.
PACK_WARMUP_URI = "synthetic://images?classes=10&n=1024&w=32&h=32&c=3&seed=2&noise=0.35&flip=0.2"
# -- the service journey -------------------------------------------------------
JOURNEY_TRIALS = 2  # 3 until phase 23 needed the time
JOURNEY_1Q = 50
JOURNEY_64Q = 20
JOURNEY_IMAGES = 512
# HTTP predictions against the in-process stacked ensemble of the same
# stored blobs on the card: the same forward on the same padded chunks,
# and JSON carries float32 values exactly, so they should be equal; the
# bound allows a float32 ulp of a probability.
JOURNEY_ATOL = 1e-5
MB_THREADS = 16
MB_REQUESTS = 8
MB_GATEWAY = {"max_batch": 8, "max_batch_wait_ms": 5}

# -- the rest of the zoo -------------------------------------------------------
# Phase 17: DenseNet at the widest of its knob space (depth 58, growth
# 24), tuning the learning rate and the batch size. Two trials (nine
# until phase 22, five until phase 23, three until phase 25 needed the
# time): both are DENSENET_ADVISOR's warm-up proposals (8 by default);
# the GP's expected-improvement proposals are driven by phases 6 and 21.
DENSENET_TRIALS = 2
DENSENET_ADVISOR = {"n_initial": 2}
DENSENET_SRC = b'''
import torch

from rafiki_tpu_torch.model.knobs import CategoricalKnob, FixedKnob, FloatKnob
from rafiki_tpu_torch.models.densenet import DenseNet


class BenchDenseNet(DenseNet):
    """DenseNet-BC depth 58, growth 24, one epoch: tunable lr and batch."""

    #: torch.cuda.memory_allocated() once each trial has evaluated, and
    #: once each trial's model is destroyed (on the params saver's thread).
    evaluated_bytes = []
    destroyed_bytes = []

    @staticmethod
    def get_knob_config():
        return {
            "depth": FixedKnob(58),
            "growth": FixedKnob(24),
            "learning_rate": FloatKnob(1e-4, 3e-2, is_exp=True),
            "batch_size": CategoricalKnob([64, 128], affects_shape=True),
            "epochs": FixedKnob(1),
            "seed": FixedKnob(0),
        }

    def evaluate(self, dataset_uri):
        score = super().evaluate(dataset_uri)
        torch.cuda.synchronize()
        BenchDenseNet.evaluated_bytes.append(torch.cuda.memory_allocated())
        return score

    def destroy(self):
        super().destroy()
        torch.cuda.synchronize()
        BenchDenseNet.destroyed_bytes.append(torch.cuda.memory_allocated())
'''
DENSENET_KNOBS = dict(depth=58, growth=24, batch_size=128, epochs=1, seed=0)
DENSENET_PROFILE_ITERS = 5
# The k=2 pack: two members of one packing key, other seeds and rates.
DENSENET_PACK = ({"learning_rate": 1e-3, "seed": 0}, {"learning_rate": 3e-4, "seed": 1})
# Phase 18: the Transformer and PosBiLstm at their widest knobs, on the
# vocabularies and classes of their templates' own harness runs, at a
# size that gives the card seconds of work.
TRANSFORMER_KNOBS = dict(embed_dim=128, num_heads=4, num_layers=2, learning_rate=1e-3,
                         batch_size=64, epochs=2, seed=0)
TEXT_TRAIN_URI = "synthetic://text?vocab=81&classes=5&n=50000&len=128&seed=0"
TEXT_EVAL_URI = "synthetic://text?vocab=81&classes=5&n=10000&len=128&seed=1"
POS_KNOBS = dict(embed_dim=128, hidden=128, learning_rate=3e-3, batch_size=64, epochs=2, seed=0)
POS_TRAIN_URI = "synthetic://corpus?vocab=100&tags=8&n=20000&len=32&seed=0"
POS_EVAL_URI = "synthetic://corpus?vocab=100&tags=8&n=4000&len=32&seed=1"
# tests/test_zoo.py's floors for both templates. Their float32 forwards,
# card against CPU, are held to F32_ATOL, the VGG forward's bound
# (readings: 1.2e-7 and 2.4e-7).
ZOO_SCORE_FLOOR = 0.5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi: rc={out.returncode} {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.split(",", 1))
    return line, name, limit


def percentile_ms(xs, q):
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def queries_for(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, size=(BATCH,) + INPUT_SHAPE).astype(np.float32)


def make_blob(seed: int) -> bytes:
    import torch

    from rafiki_tpu_torch.models.vgg import Vgg

    m = Vgg(**KNOBS)
    m.init_parameters(NUM_CLASSES, INPUT_SHAPE, torch.Generator().manual_seed(seed))
    blob = m.dump_parameters()
    m.destroy()
    return blob


def load(blobs, device=None, knobs=KNOBS):
    from rafiki_tpu_torch.models.vgg import Vgg

    out = []
    for b in blobs:
        m = Vgg(device=device, **knobs)
        m.load_parameters(b)
        out.append(m)
    return out


def f32_twin(model):
    """The same params in the float32 build of the network, on the
    model's device."""
    import torch

    from rafiki_tpu_torch.models.vgg import _Vgg

    mod = _Vgg(KNOBS["depth"], KNOBS["width_mult"], NUM_CLASSES, INPUT_SHAPE,
               dtype=torch.float32)
    mod.load_state_dict(model._module.state_dict())
    return mod.to(model.device).eval()


def forward_readings(blob: bytes, query_seeds):
    """One trial on the card and on the CPU, over several query sets.
    Returns the per-query-set readings and the bf16 probabilities of
    each device on each query set."""
    from rafiki_tpu_torch.ops.train import predict_proba

    models = {"cpu": load([blob], "cpu")[0], "card": load([blob])[0]}
    twins = {name: f32_twin(m) for name, m in models.items()}
    readings, probs = [], []
    for qs in query_seeds:
        x = queries_for(qs)
        p = {name: (m.predict_proba(x), predict_proba(twins[name], x, BATCH, m.device))
             for name, m in models.items()}
        for name, (bf16, _) in p.items():
            if bf16.shape != (BATCH, NUM_CLASSES) or not np.isfinite(bf16).all():
                fail(f"{name} forward gave shape {bf16.shape} or non-finite values")
        readings.append({
            "query_seed": qs,
            "f32_card_vs_cpu": float(np.abs(p["card"][1] - p["cpu"][1]).max()),
            "bf16_vs_f32_card": float(np.abs(p["card"][0] - p["card"][1]).max()),
            "bf16_vs_f32_cpu": float(np.abs(p["cpu"][0] - p["cpu"][1]).max()),
            "bf16_card_vs_cpu": float(np.abs(p["card"][0] - p["cpu"][0]).max()),
        })
        probs.append({name: bf16 for name, (bf16, _) in p.items()})
    return readings, probs


def bf16_readings() -> int:
    """The measurement behind BF16_GAP_ATOL: seeds and query sets apart
    from the ones the smoke serves."""
    import torch

    card = card_identity()
    print(card[0])
    rows = []
    for seed in range(100, 116):
        readings, _ = forward_readings(make_blob(seed), range(100, 104))
        rows += [dict(r, trial_seed=seed) for r in readings]
        torch.cuda.empty_cache()
    summary = {"phase": "bf16_readings", "card": card[1], "power_limit": card[2],
               "trials": 16, "query_sets": 4, "bf16_gap_atol": BF16_GAP_ATOL,
               "bf16_card_vs_cpu_atol": BF16_CARD_VS_CPU_ATOL}
    for key in ("bf16_vs_f32_card", "bf16_vs_f32_cpu", "bf16_card_vs_cpu", "f32_card_vs_cpu"):
        xs = np.asarray([r[key] for r in rows])
        summary[key] = {"max": float(xs.max()), "p50": float(np.median(xs)),
                        "p90": float(np.percentile(xs, 90))}
    print(json.dumps(rows))
    print(json.dumps(summary))
    return 0


# -- device profile -----------------------------------------------------------

def _event_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back runs."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _union_us(ranges) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(ranges):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_profile(fn, top: int = 6):
    """Where one forward's device time goes: CUDA-event ms, and under
    ``torch.profiler`` the device's busy time and idle share, kernel
    launches, and the costliest operators, per forward."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    iters = PROFILE_ITERS
    with torch.inference_mode():
        for _ in range(3):
            fn()
        event_ms = _event_ms(fn, iters)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in kernels])

    def device_us(avg) -> float:
        # torch >= 2.4 names it device_time_total; older releases cuda_time_total.
        return float(getattr(avg, "device_time_total", None)
                     or getattr(avg, "cuda_time_total", 0.0))

    ops = sorted(((a.key, device_us(a)) for a in prof.key_averages()
                  if device_us(a) > 0 and not a.key.startswith("cuda")),
                 key=lambda kv: -kv[1])
    return {
        "event_ms": event_ms,
        "device_busy_ms": busy_us / iters / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernel_launches": len(kernels) / iters,
        "top_ops_device_ms": {k: v / iters / 1e3 for k, v in ops[:top]},
    }


# -- serving ------------------------------------------------------------------

def serve(models, queries, label, card):
    """One route: worker threads on a fresh bus, then the timed requests.
    Fails unless every worker served every query without an error and
    every reply came back. Returns (per-query outputs of the single
    requests, burst outputs, timing dict)."""
    import torch

    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.bus.queues import InProcBus
    from rafiki_tpu_torch.predictor.predictor import Predictor
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    def check_counters(n_queries: int, phase: str) -> dict:
        snap = telemetry.snapshot()
        c = snap["counters"]
        got = {k: c.get(k, 0) for k in ("inference.batch_errors", "predictor.query_timeouts",
                                         "predictor.hedged_gathers")}
        got["inference.queries_served"] = c.get("inference.queries_served", 0)
        want = {"inference.batch_errors": 0, "predictor.query_timeouts": 0,
                "predictor.hedged_gathers": 0,
                "inference.queries_served": len(workers) * n_queries}
        if got != want:
            fail(f"{label} ({phase}): counters {got}, expected {want}")
        return snap

    telemetry.reset()
    bus = InProcBus()
    workers = [InferenceWorker(bus, f"job-{label}", f"{label}-{i}", m, batch_size=BATCH)
               for i, m in enumerate(models)]
    threads = [threading.Thread(target=w.run, name=w.worker_id, daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 60
        while len(bus.get_workers(f"job-{label}")) < len(workers):
            if time.monotonic() > deadline:
                fail(f"{label}: workers did not register")
            time.sleep(0.01)
        pred = Predictor(bus, f"job-{label}", timeout_s=120)
        # One untimed request: pays the first-call costs of a route that
        # has no warmup() of its own (the replicated workers).
        t0 = time.monotonic()
        pred.predict(queries[:1])
        first_s = time.monotonic() - t0
        check_counters(1, "first request")
        telemetry.reset()
        singles, lat1 = [], []
        for q in queries[:N_SINGLE]:
            t0 = time.monotonic()
            singles.append(pred.predict([q])[0])
            lat1.append(time.monotonic() - t0)
        bursts, lat64 = [], []
        for _ in range(N_BURSTS):
            t0 = time.monotonic()
            bursts.append(pred.predict(queries[:BATCH]))
            lat64.append(time.monotonic() - t0)
    finally:
        for w in workers:
            w.stop()
        for t in threads:
            t.join(timeout=30)
    if any(t.is_alive() for t in threads):
        fail(f"{label}: worker threads did not stop")
    for out in singles + [o for b in bursts for o in b]:
        if isinstance(out, dict):
            fail(f"{label}: a request failed: {out}")
    torch.cuda.synchronize()
    snap = check_counters(N_SINGLE + N_BURSTS * BATCH, "timed requests")
    fwd = snap["spans"]["inference.forward"]
    timing = {
        "route": label, "card": card[1], "power_limit": card[2],
        "workers": len(models), "first_request_s": first_s,
        "p50_ms_1q": percentile_ms(lat1, 50), "p99_ms_1q": percentile_ms(lat1, 99),
        "p50_ms_64q": percentile_ms(lat64, 50), "p99_ms_64q": percentile_ms(lat64, 99),
        "queries_per_s_1q": len(lat1) / sum(lat1),
        "queries_per_s_64q": BATCH * len(lat64) / sum(lat64),
        # Where a request's time went: worker forwards (summed over the
        # workers, which run side by side) against all request time.
        "forward_calls": fwd["count"], "forward_s_total": fwd["total_s"],
        "request_s_total": sum(lat1) + sum(lat64),
        "pop_batch_mean": snap["histograms"]["bus.pop_batch_size"]["mean"],
        "queries_served": snap["counters"]["inference.queries_served"],
    }
    return np.asarray(singles, np.float64), [np.asarray(b, np.float64) for b in bursts], timing


# -- training -----------------------------------------------------------------


def _synced_s(t0: float) -> float:
    import torch

    torch.cuda.synchronize()
    return time.monotonic() - t0


def train_trials(card):
    """Phase 8: the canonical trial, for each of TRIAL_SEEDS. It runs
    after the tune job, which loaded the same datasets, so its epoch is
    a warm one. Returns the phase's readings, the trained models and
    their serving blobs."""
    import torch

    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.model.log import logger
    from rafiki_tpu_torch.models.vgg import Vgg

    t_phase = time.monotonic()
    train_ds, eval_ds = dataset_utils.load(TRAIN_URI), dataset_utils.load(EVAL_URI)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graphs = _graph_counters()
    trials, models, blobs = [], [], []
    for seed in TRIAL_SEEDS:
        m = Vgg(**TRAIN_KNOBS)
        m._seed = seed  # the seed knob is fixed at 0; trials differ in their seed
        logs = []
        t0 = time.monotonic()
        with logger.capture(logs.append):
            m.train(TRAIN_URI)
        train_s = _synced_s(t0)
        t0 = time.monotonic()
        acc = m.evaluate(EVAL_URI)
        eval_s = _synced_s(t0)
        epochs = [e["values"] for e in logs if e["type"] == "values"]
        trials.append({"seed": seed, "train_s": train_s, "evaluate_s": eval_s,
                       "eval_acc": acc, "epochs": epochs})
        blobs.append(m.dump_parameters())
        models.append(m)
    steps = train_ds.size // TRAIN_KNOBS["batch_size"]
    epoch_s = float(np.mean([t["train_s"] for t in trials]))
    out = {
        "phase": "train_vgg", "card": card[1], "power_limit": card[2],
        "knobs": TRAIN_KNOBS, "train_uri": TRAIN_URI, "eval_uri": EVAL_URI,
        "train_examples": train_ds.size, "eval_examples": eval_ds.size,
        "steps_per_epoch": steps, "trials": trials,
        # One epoch per trial, after the tune job: datasets resident and
        # cuDNN's choices for batch 128 made.
        "epoch_s": epoch_s, "step_ms": epoch_s / steps * 1e3,
        "train_images_per_s": steps * TRAIN_KNOBS["batch_size"] / epoch_s,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        **_graph_since(graphs), "phase_s": time.monotonic() - t_phase,
    }
    return out, models, blobs


def _bench_class(src=BENCH_SRC, name="BenchVgg"):
    """The template class the scheduler loaded from ``src`` last
    (``load_model_class`` registers each load under one module name)."""
    module = sys.modules.get(f"_rafiki_model_{abs(hash(src)) % (1 << 30):x}")
    if module is None or not hasattr(module, name):
        fail(f"the scheduler did not load {name}")
    return getattr(module, name)


def _memory_without_cublas_workspaces() -> int:
    """The memory allocated on the card once cuBLAS has freed the
    workspace it keeps per thread's handle (a job's worker is a new
    thread, and takes a new one)."""
    import torch

    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def tune_job(card, trial_pack=None, src=BENCH_SRC, name="BenchVgg", trials=TUNE_TRIALS,
             phase=None, advisor_kwargs=None):
    """Phase 6 (and 13, with ``trial_pack``; 17 with DenseNet's ``src``):
    a GP train job of ``trials`` trials of the template ``name`` uploaded
    as ``src`` (the bench's canonical job by default) on the canonical
    task, through the port's entry points, in a temporary directory. With
    ``advisor_kwargs`` the job's GP is made with them (the sub job's
    advisor, created before the job runs). Returns the per-trial lines in
    completion order, the job line, and the top-2 trials with their
    stored blobs."""
    import gc
    import shutil
    import tempfile

    import torch

    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.advisor import AdvisorService
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.scheduler import LocalScheduler
    from rafiki_tpu_torch.store import MetaStore, ParamsStore

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="rafiki-tune-")
    try:
        store = MetaStore(f"{tmp}/meta.sqlite3")
        params = ParamsStore(f"{tmp}/params")
        model = store.create_model(name.lower(), "IMAGE_CLASSIFICATION", None, src, name)
        job = store.create_train_job("bench", "IMAGE_CLASSIFICATION", None, TRAIN_URI, EVAL_URI,
                                     {"MODEL_TRIAL_COUNT": trials})
        sub = store.create_sub_train_job(job["id"], model["id"])
        advisors = AdvisorService()
        if advisor_kwargs:
            aid = advisors.create_advisor(load_model_class(src, name).get_knob_config(),
                                          kind="gp", engine_kwargs=advisor_kwargs)
            store.update_sub_train_job(sub["id"], advisor_id=aid)
        telemetry.reset()
        # Earlier phases' reference cycles (worker threads, the bus) hold
        # card memory until the collector runs: free it before reading.
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem_before = _memory_without_cublas_workspaces()
        t0 = time.monotonic()
        result = LocalScheduler(store, params, advisors).run_train_job(
            job["id"], n_workers=1, advisor_kind="gp", trial_pack=trial_pack)
        wall = _synced_s(t0)
        peak = torch.cuda.max_memory_allocated()
        snap = telemetry.snapshot()
        gc.collect()
        mem_after = _memory_without_cublas_workspaces()
        best = [dict(t, blob=params.load(t["params_id"])) for t in result.best_trials]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cls = _bench_class(src, name)
    n_train = dataset_utils.load(TRAIN_URI).size
    train_s = {r["tags"]["trial_id"]: r["dur_s"] for r in telemetry.span_records()
               if r["name"] == "trial.train"}
    done = sorted((t for t in result.trials if t.get("stopped_at")), key=lambda t: t["stopped_at"])
    trials = []
    for t in done:
        bs = t["knobs"]["batch_size"]
        steps = n_train // bs
        row = {"phase": "tune_trial", "no": t["no"], "knobs": t["knobs"], "status": t["status"],
               "score": t["score"], "trial_s": t["stopped_at"] - t["started_at"],
               "batch_size": bs, "train_s": train_s.get(t["id"]),
               "error": (t["error"] or "")[:200] or None}
        if row["train_s"]:
            row["step_ms"] = row["train_s"] / steps * 1e3
        trials.append(row)
    completed = [t for t in trials if t["status"] == "COMPLETED"]
    spans = snap["spans"]
    by_bs = {}
    for t in completed:
        by_bs.setdefault(t["batch_size"], []).append(t["trial_s"])
    line = {
        "phase": phase or ("tune_job" if trial_pack is None else "tune_job_packed"),
        "card": card[1], "power_limit": card[2],
        "status": result.status, "trials": len(trials), "completed": len(completed),
        "errored": len(trials) - len(completed), "job_wall_s": wall,
        "scheduler_duration_s": result.duration_s,
        "completed_trials_per_hour": 3600.0 * len(completed) / wall,
        "cold_trial_s": trials[0]["trial_s"] if trials else None,
        "trial_s_by_batch_size": {str(k): v for k, v in sorted(by_bs.items())},
        "best_score": max((t["score"] for t in completed), default=None),
        "top1_target": TUNE_TOP1_TARGET,
        "advisor_propose_s_total": spans.get("trial.advisor_propose", {}).get("total_s"),
        "advisor_proposals": spans.get("trial.advisor_propose", {}).get("count"),
        "persist_s_total": spans.get("trial.persist", {}).get("total_s"),
        "trial_total_s_total": spans.get("trial.total", {}).get("total_s"),
        # The worker's time outside its trials and proposals: the
        # advisor's feedback (the GP refits there), store writes, and the
        # wait for the last save.
        "outside_trials_s": wall - spans.get("trial.total", {}).get("total_s", 0.0)
        - spans.get("trial_pack.total", {}).get("total_s", 0.0)
        - spans.get("trial.advisor_propose", {}).get("total_s", 0.0),
        "gp_warmup_proposals": snap["counters"].get("advisor.gp_warmup_proposals", 0),
        "gp_ei_proposals": snap["counters"].get("advisor.gp_ei_proposals", 0),
        "max_memory_allocated_bytes": peak,
        "evaluated_memory_allocated_bytes": list(cls.evaluated_bytes),
        "destroyed_memory_allocated_bytes": list(cls.destroyed_bytes),
        "memory_allocated_before_job": mem_before, "memory_allocated_after_job": mem_after,
        "errors": result.errors,
        # Captured steps: one capture an epoch, per eval pass too.
        "graph_replays": snap["counters"].get("train.graph_replays", 0.0),
        "graph_captures": snap["counters"].get("train.graph_captures", 0.0),
        "graph_capture_s": snap["histograms"].get("train.graph_capture_s"),
        "graph_pool_bytes": snap["histograms"].get("train.graph_pool_bytes"),
        "phase_s": time.monotonic() - t_phase,
    }
    if trial_pack is not None:
        hist, c = snap["histograms"], snap["counters"]
        line.update({
            "trial_pack": trial_pack,
            "trial_pack_size": hist.get("trial_pack.size"),
            "trial_pack_fill_ratio": hist.get("trial_pack.fill_ratio"),
            "packed_rounds": c.get("worker.packed_rounds", 0),
            "packed_trials": c.get("worker.packed_trials", 0),
            "pack_ineligible": c.get("worker.pack_ineligible", 0),
            "trial_pack_train_s_total": spans.get("trial_pack.train", {}).get("total_s"),
            "trial_pack_evaluate_s_total": spans.get("trial_pack.evaluate", {}).get("total_s"),
        })
    return trials, line, best


def served_accuracy(trials, card, template=None, name="BenchVgg"):
    """Phase 7 (and 17): the tune job's top trials' stored blobs loaded
    into serving models of ``template`` (``Vgg`` by default), stacked,
    and run over the eval set: each trial's argmax accuracy through the
    stacked route's forward, against the score the job stored for it,
    and the ensemble's."""
    import torch

    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.models.vgg import Vgg
    from rafiki_tpu_torch.parallel.serving import build_stacked
    from rafiki_tpu_torch.predictor.ensemble import renormalize_probs

    ds = dataset_utils.load(EVAL_URI)
    models = []
    for t in trials:
        m = (template or Vgg)(**t["knobs"])
        m.load_parameters(t["blob"])
        models.append(m)
    bs = TRAIN_KNOBS["batch_size"]
    stacked, reason = build_stacked([{"model_name": name}] * len(models), models,
                                    batch_size=bs)
    if stacked is None:
        fail(f"stacked route refused the trained trials: {reason}")
    hits = np.zeros(len(models), np.int64)
    ens_hits = 0
    t0 = time.monotonic()
    with torch.inference_mode():
        for start in range(0, ds.size, bs):
            xt = torch.from_numpy(ds.x[start:start + bs]).cuda()
            probs = stacked._ens.forward(xt).float().cpu().numpy()  # (k, B, C)
            y = ds.y[start:start + bs]
            hits += (probs.argmax(-1) == y[None, :]).sum(axis=1)
            ens = renormalize_probs(np.mean(probs, axis=0))
            ens_hits += int((ens.argmax(-1) == y).sum())
    serve_s = _synced_s(t0)
    stacked.destroy()
    served = (hits / ds.size).tolist()
    evaluated = [t["score"] for t in trials]
    return {"phase": "served_vs_evaluated", "card": card[1], "power_limit": card[2],
            "trials": [t["no"] for t in trials], "evaluated_acc": evaluated,
            "served_acc": served, "abs_diff": [abs(a - b) for a, b in zip(served, evaluated)],
            "ensemble_acc": ens_hits / ds.size, "serve_s": serve_s,
            "served_acc_atol": SERVED_ACC_ATOL}


def train_ff(card):
    """Phase 9: FeedForward at its widest knobs."""
    from rafiki_tpu_torch.model.log import logger
    from rafiki_tpu_torch.models.ff import FeedForward

    graphs = _graph_counters()
    m = FeedForward(**FF_KNOBS)
    logs = []
    t0 = time.monotonic()
    with logger.capture(logs.append):
        m.train(FF_TRAIN_URI)
    train_s = _synced_s(t0)
    acc = m.evaluate(FF_EVAL_URI)
    reloaded = FeedForward(**FF_KNOBS)
    reloaded.load_parameters(m.dump_parameters())
    return {"phase": "train_ff", "card": card[1], "power_limit": card[2], "knobs": FF_KNOBS,
            "train_uri": FF_TRAIN_URI, "eval_uri": FF_EVAL_URI, "train_s": train_s,
            "epochs": [e["values"] for e in logs if e["type"] == "values"],
            "eval_acc": acc, "reloaded_eval_acc": reloaded.evaluate(FF_EVAL_URI),
            **_graph_since(graphs), "phase_s": time.monotonic() - t0}


def _f32_vgg_class():
    from rafiki_tpu_torch.models.vgg import Vgg, _Vgg

    class VggF32(Vgg):
        """The canonical network with float32 compute."""

        def build_module(self, num_classes, input_shape):
            import torch

            return _Vgg(int(self.knobs["depth"]), float(self.knobs["width_mult"]), num_classes,
                        input_shape, dtype=torch.float32, dropout=float(self.knobs["dropout"]))

    return VggF32


def training_parity(card):
    """Phase 10: PARITY_STEPS float32 train steps (TF32 off, dropout 0)
    from the same params on the card and on the CPU, fed from the host
    through ``train_steps`` (on the card two eager steps, then a
    captured one). Returns the readings after each step."""
    from rafiki_tpu_torch.convert import state_dict_to_flax
    from rafiki_tpu_torch.obs.health import sentinel
    from rafiki_tpu_torch.ops.train import HostFeed

    cls = _f32_vgg_class()
    knobs = dict(TRAIN_KNOBS, dropout=0.0)
    rng = np.random.default_rng(7)
    batches = [{"x": rng.uniform(0, 1, size=(PARITY_BATCH,) + INPUT_SHAPE).astype(np.float32),
                "y": rng.integers(0, NUM_CLASSES, size=PARITY_BATCH).astype(np.int32)}
               for _ in range(PARITY_STEPS)]
    runs = {}
    t_phase = time.monotonic()
    graphs = _graph_counters()
    for name, device in (("card", "cuda"), ("cpu", "cpu")):
        m = cls(device=device, **knobs)
        m._planned_steps = PARITY_STEPS
        m.init_parameters(NUM_CLASSES, INPUT_SHAPE)  # the same seeded CPU draw on both
        loop, rows = m._loop, []
        start = {k: v.detach().cpu().clone() for k, v in state_dict_to_flax(m._module).items()}

        def on_step(t, metrics, m=m, rows=rows):
            rows.append({"loss": float(metrics["loss"]),
                         **{k: float(v) for k, v in sentinel.split(metrics)[1].items()},
                         "params": {k: v.detach().cpu().clone()
                                    for k, v in state_dict_to_flax(m._module).items()}})

        feed = HostFeed((dict(b) for b in batches), PARITY_STEPS, loop.device)
        loop.state, _ = loop.program.train_steps(loop.state, feed, on_step=on_step)
        runs[name] = rows
    steps = []
    for card_row, cpu_row in zip(runs["card"], runs["cpu"]):
        a, b = card_row["params"], cpu_row["params"]
        num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in a) ** 0.5
        den = sum(float(((b[k] - start[k]) ** 2).sum()) for k in a) ** 0.5
        r = {"loss_rel": abs(card_row["loss"] - cpu_row["loss"]) / abs(cpu_row["loss"]),
             "param_max_abs": max(float((a[k] - b[k]).abs().max()) for k in a),
             "param_rel_l2": num / den,
             "nonfinite": (card_row["health_nonfinite"], cpu_row["health_nonfinite"])}
        for k in ("health_grad_norm", "health_update_norm", "health_param_norm"):
            r[k + "_rel"] = abs(card_row[k] - cpu_row[k]) / abs(cpu_row[k])
        steps.append(r)
    return {"phase": "train_parity", "card": card[1], "power_limit": card[2],
            "model": f"VGG{knobs['depth']} w{knobs['width_mult']} float32",
            "batch": PARITY_BATCH, "steps": steps,
            "tolerance": PARITY_TOL, **_graph_since(graphs),
            "phase_s": time.monotonic() - t_phase}


_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def _analyze_profile(prof, n, wall_us, event_ms, bs, card, phase):
    """The readings of ``n`` steps under ``prof``: the device's busy time
    and idle share, device kernels and host launch calls (kernel and
    graph launches, async copies), the device and host time of the
    step's forward, Adam and sentinel ranges where the steps ran them
    eagerly, and of a dp step's all-reduce and host feed ranges (the
    backward: what they leave), and the costliest operators, per step."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    # The step's record_function ranges also show on the device timeline
    # as user annotations spanning their kernels; they are no kernels.
    kernels = [e for e in events if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False) and not e.name.startswith("train.")]
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in kernels])
    kernel_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    calls = [e for e in events if e.device_type == cpu and e.name in _LAUNCH_CALLS]

    def under(e):
        """The device kernels launched by a CPU event and its children."""
        out = list(e.kernels)
        for child in e.cpu_children:
            out += under(child)
        return out

    # The forward, Adam and sentinel ranges are recorded in the step
    # itself (ops/train.py); the backward runs on autograd's own thread,
    # so its kernels are what the ranges leave of the total. A replayed
    # graph runs no range.
    parts = {}
    for name in ("train.forward", "train.adam", "train.sentinel", "train.all_reduce",
                 "train.feed"):
        evs = [e for e in events if e.name == name and e.device_type == cpu]
        if not evs:
            continue
        ks = [k for e in evs for k in under(e)]
        parts[name[6:]] = {"device_ms": sum(k.duration for k in ks) / n / 1e3,
                           "launches": len(ks) / n,
                           "host_ms": sum(e.cpu_time_total for e in evs) / n / 1e3}
    if parts:
        parts["backward"] = {
            "device_ms": kernel_us / n / 1e3 - sum(p["device_ms"] for p in parts.values()),
            "launches": len(kernels) / n - sum(p["launches"] for p in parts.values()),
            "host_ms": event_ms - sum(p["host_ms"] for p in parts.values())}

    def self_device_us(a) -> float:
        # torch >= 2.4 names it self_device_time_total.
        return float(getattr(a, "self_device_time_total", None)
                     or getattr(a, "self_cuda_time_total", 0.0))

    ops = sorted(((a.key, self_device_us(a)) for a in prof.key_averages()
                  if self_device_us(a) > 0 and not a.key.startswith("train.")),
                 key=lambda kv: -kv[1])
    return {"phase": phase, "card": card[1], "power_limit": card[2],
            "steps": n, "batch": bs, "event_ms_per_step": event_ms,
            "device_busy_ms_per_step": busy_us / n / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "kernel_launches_per_step": len(kernels) / n,
            "host_launch_calls_per_step": len(calls) / n,
            "graph_launches_per_step": sum(e.name == "cudaGraphLaunch" for e in calls) / n,
            # host_ms of the backward: the step's CUDA-event time less the
            # host time of the three ranges.
            "per_part": parts,
            "top_ops_self_device_ms_per_step": {k[:80]: v / n / 1e3 for k, v in ops[:10]}}


class _StepWindow:
    """A per-step hook (``on_step(t, metrics)`` of ``train_steps``, or
    called by hand after each eager step): CUDA events over the
    PROFILE_ITERS steps from ``start``, then ``torch.profiler`` over the
    next ``profile_iters`` (PROFILE_ITERS by default). An epoch under it
    runs ``n_steps`` steps; the events record on the stream the steps
    run on."""

    def __init__(self, start: int, profile: bool = True, profile_iters: int = PROFILE_ITERS):
        self.start, self.profile, self.profile_iters = start, profile, profile_iters
        self.n_steps = start + PROFILE_ITERS + (profile_iters if profile else 0)
        self.event_ms = None

    def __call__(self, t, _metrics=None):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if t == self.start - 1:
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        elif t == self.start + PROFILE_ITERS - 1:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            ev1.synchronize()
            self.event_ms = self._ev0.elapsed_time(ev1) / PROFILE_ITERS
            if self.profile:
                torch.cuda.synchronize()
                self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self._prof.start()
                self._t0 = time.perf_counter()
        elif self.profile and t == self.n_steps - 1:
            torch.cuda.synchronize()
            self.wall_us = (time.perf_counter() - self._t0) * 1e6
            self._prof.stop()

    def readings(self, bs, card, phase):
        return _analyze_profile(self._prof, self.profile_iters, self.wall_us, self.event_ms, bs,
                                card, phase)


def _graph_counters():
    """The captured-step counters: replays, captures and capture seconds."""
    from rafiki_tpu_torch import telemetry

    snap = telemetry.snapshot()
    hist = snap["histograms"].get("train.graph_capture_s") or {}
    return {"graph_replays": snap["counters"].get("train.graph_replays", 0.0),
            "graph_captures": snap["counters"].get("train.graph_captures", 0.0),
            "graph_capture_s": hist.get("sum") or 0.0}


def _graph_since(before):
    return {k: v - before[k] for k, v in _graph_counters().items()}


def graph_step(card):
    """Phase 16 (and ``--packed-step``): the canonical serial step (batch
    128, dropout 0.1, lr 1e-3) and the k=PACK_K packed step
    (PACK_MEMBERS), each run eagerly (``train_step``, the plain version)
    and captured (``train_steps``: two eager steps, a capture, replays)
    from the same initial state over the same batches of random data
    resident on the card. Per path: CUDA-event ms a step, then under
    torch.profiler device busy ms, idle share, device kernels and host
    launch calls a step; for the captured path the capture seconds and
    the memory its graph reserved. Gate: after all the steps the two
    paths' params, moments, counts, generator states and every step's
    loss and sentinels are equal bit for bit."""
    import torch

    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.models.vgg import Vgg
    from rafiki_tpu_torch.ops.graphs import GRAPH_WARMUP_STEPS
    from rafiki_tpu_torch.ops.train import PackedTrainLoop, ResidentFeed, TrainLoop

    t_phase = time.monotonic()
    bs, k = PACK_KNOBS["batch_size"], PACK_K
    window = GRAPH_WARMUP_STEPS + 1
    n_steps = _StepWindow(window).n_steps
    def fns(members):
        """Fresh closures for each loop: a template's init_fn fills one
        module in place, which the loop then moves to the card."""
        out = []
        for m in members:
            model = Vgg(**dict(PACK_KNOBS, **m))
            model._planned_steps = 50000 // bs
            out.append(model._loop_fns(NUM_CLASSES, INPUT_SHAPE))
        return out

    n = n_steps * k * bs
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.rand((n,) + INPUT_SHAPE, device="cuda", generator=g)
    Y = torch.randint(0, NUM_CLASSES, (n,), device="cuda", generator=g)
    idx = torch.randperm(n, device="cuda", generator=g)
    line = {"phase": "graph_step", "card": card[1], "power_limit": card[2], "batch": bs,
            "k": k, "steps": n_steps, "warmup_steps": GRAPH_WARMUP_STEPS}

    def serial():
        f = fns([{"learning_rate": 1e-3, "dropout": 0.1}])[0]
        return TrainLoop(f["init_fn"], f["apply_eval"], f["loss_fn"], f["optimizer"],
                         hyper=f["hyper"], program_key=("chip_smoke", "graph_step"))

    def packed():
        fs = fns(PACK_MEMBERS[:k])
        return PackedTrainLoop(fs[0]["init_fn"], fs[0]["apply_eval"], fs[0]["loss_fn"],
                               fs[0]["optimizer"], seeds=list(range(k)),
                               hypers=[f["hyper"] for f in fs],
                               program_key=("chip_smoke", "graph_step"))

    def state_of(loop):
        if isinstance(loop, TrainLoop):
            module, opt, step, gen, _ = loop.state
            return ([p.detach() for p in module.parameters()], opt.mu + opt.nu,
                    (step, opt.count), [gen.get_state()])
        st = loop.state
        return (list(st.params.values()), st.opt.mu + st.opt.nu, (st.steps, st.opt.count),
                [gen.get_state() for gen in st.generators])

    equal = {}
    for name, make, rows in (("serial", serial, idx[: n_steps * bs].reshape(n_steps, bs)),
                             ("packed", packed, idx.reshape(n_steps, k, bs))):
        torch.cuda.synchronize()
        eager = make()
        win = _StepWindow(window)
        steps = []
        for t in range(n_steps):
            flat = rows[t].reshape(-1)
            batch = {"x": X.index_select(0, flat).reshape(tuple(rows[t].shape) + INPUT_SHAPE),
                     "y": Y.index_select(0, flat).reshape(tuple(rows[t].shape))}
            if isinstance(eager, TrainLoop):
                eager.state, metrics = eager.program.train_step(eager.state, batch)
            else:
                metrics = eager.program.train_step(eager.state, batch)
            steps.append(metrics)
            win(t)
        line[f"{name}_eager"] = win.readings(bs, card, f"{name}_eager")
        want = {key: torch.stack([m[key] for m in steps]) for key in steps[0]}
        del steps
        captured = make()
        telemetry.reset()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        win = _StepWindow(window)
        with _KeptGraphs() as kept:
            if isinstance(captured, TrainLoop):
                captured.state, got = captured.program.train_steps(
                    captured.state, ResidentFeed(X, Y, rows), on_step=win)
            else:
                got = captured.program.train_steps(captured.state, ResidentFeed(X, Y, rows),
                                                   on_step=win)
        snap = telemetry.snapshot()
        readings = win.readings(bs, card, f"{name}_captured")
        readings.update({
            "graph_kernel_nodes": _graph_kernel_nodes(kept[0]),
            "capture_s": snap["histograms"]["train.graph_capture_s"]["sum"],
            "graph_pool_reserved_bytes": snap["histograms"]["train.graph_pool_bytes"]["sum"],
            "max_memory_allocated_over_epoch_bytes": torch.cuda.max_memory_allocated() - before,
            "graph_replays": snap["counters"].get("train.graph_replays", 0.0)})
        line[f"{name}_captured"] = readings
        a, b = state_of(eager), state_of(captured)
        equal[name] = {
            "params": all(torch.equal(x, y) for x, y in zip(a[0], b[0])),
            "moments": all(torch.equal(x, y) for x, y in zip(a[1], b[1])),
            "counts": a[2] == b[2],
            "generators": all(torch.equal(x, y) for x, y in zip(a[3], b[3])),
            "metrics": sorted(got) == sorted(want)
            and all(torch.equal(got[key], want[key]) for key in want)}
        line[f"{name}_speedup"] = (line[f"{name}_eager"]["event_ms_per_step"]
                                   / readings["event_ms_per_step"])
        del eager, captured, want, got
        torch.cuda.empty_cache()
    line["bit_equal"] = equal
    line["phase_s"] = time.monotonic() - t_phase
    return line


# -- trial packing ---------------------------------------------------------------


def trial_pack(card):
    """Phase 12: four canonical trials in series, then as one pack.
    Returns the phase's line."""
    import gc

    import torch

    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.model.log import logger

    cls = load_model_class(BENCH_SRC, "BenchVgg")
    knobs = [dict(PACK_KNOBS, **m) for m in PACK_MEMBERS]

    def serial(train_uri, eval_uri):
        out = []
        for kn in knobs:
            m = cls(**kn)
            logs = []
            with logger.capture(logs.append):
                m.train(train_uri)
            out.append({"score": m.evaluate(eval_uri),
                        "epochs": [e["values"] for e in logs if e["type"] == "values"]})
            m.destroy()
        return out

    def packed(train_uri, eval_uri):
        models = [cls(**kn) for kn in knobs]
        histories = cls.train_packed(models, train_uri)
        return models, histories, cls.evaluate_packed(models, eval_uri)

    def release(models):
        for m in models:
            m.destroy()
        gc.collect()
        torch.cuda.empty_cache()

    t_phase = time.monotonic()
    # Warm-up of both paths (first calls, allocator growth), untimed.
    serial(PACK_WARMUP_URI, PACK_WARMUP_URI)
    release(packed(PACK_WARMUP_URI, PACK_WARMUP_URI)[0])
    graphs = _graph_counters()
    t0 = time.monotonic()
    ser = serial(TRAIN_URI, EVAL_URI)
    serial_s = _synced_s(t0)
    serial_graphs = _graph_since(graphs)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    graphs = _graph_counters()
    t0 = time.monotonic()
    models, histories, scores = packed(TRAIN_URI, EVAL_URI)
    packed_s = _synced_s(t0)
    packed_graphs = _graph_since(graphs)
    peak = torch.cuda.max_memory_allocated()
    release(models)
    k = len(knobs)
    return {
        "phase": "trial_pack", "card": card[1], "power_limit": card[2], "k": k,
        "knobs": PACK_KNOBS, "members": list(PACK_MEMBERS), "train_uri": TRAIN_URI,
        "eval_uri": EVAL_URI, "serial_s": serial_s, "packed_s": packed_s,
        "serial_s_per_trial": serial_s / k, "packed_s_per_trial": packed_s / k,
        "speedup_vs_serial": serial_s / packed_s,
        "serial_scores": [r["score"] for r in ser], "packed_scores": scores,
        "score_abs_diff": [abs(a - r["score"]) for a, r in zip(scores, ser)],
        "serial_epochs": [r["epochs"] for r in ser], "packed_epochs": histories,
        "score_atol": PACK_SCORE_ATOL,
        "memory_allocated_before_pack": mem_before, "max_memory_allocated_bytes": peak,
        "serial_graphs": serial_graphs, "packed_graphs": packed_graphs,
        "phase_s": time.monotonic() - t_phase,
    }


def pack_scaling(card):
    """Phase 12, after the pack: the captured step's event ms of a serial
    trial and of packs of 1, 2 and 4 (each an epoch of GRAPH_WARMUP_STEPS
    eager steps, a capture and PROFILE_ITERS timed replays on batches
    from the resident dataset), run in the order serial, 1, 2, 4, 4, 2,
    1, serial so a drift of the host's speed reads on both sides; then
    one float32 step (TF32 off, dropout 0) of a one-member pack against
    the serial step from the same params, gradient by gradient."""
    import torch

    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.ops.graphs import GRAPH_WARMUP_STEPS
    from rafiki_tpu_torch.ops.train import PackedTrainLoop, TrainLoop
    from rafiki_tpu_torch.ops.train import ResidentFeed, get_device_dataset
    from rafiki_tpu_torch.utils.backend import resolve_device

    t_phase = time.monotonic()
    graphs = _graph_counters()
    X, Y = get_device_dataset(dataset_utils.load(TRAIN_URI), resolve_device())
    bs = PACK_KNOBS["batch_size"]

    def fns(k, cls):
        out = []
        for m in PACK_MEMBERS[:k]:
            model = cls(**dict(PACK_KNOBS, **m))
            model._planned_steps = X.shape[0] // bs
            out.append(model._loop_fns(NUM_CLASSES, INPUT_SHAPE))
        return out

    def serial_loop(f):
        return TrainLoop(f["init_fn"], f["apply_eval"], f["loss_fn"], f["optimizer"],
                         hyper=f["hyper"])

    def packed_loop(fs):
        return PackedTrainLoop(fs[0]["init_fn"], fs[0]["apply_eval"], fs[0]["loss_fn"],
                               fs[0]["optimizer"], seeds=[0] * len(fs),
                               hypers=[f["hyper"] for f in fs])

    starts = iter(range(0, 10 ** 9, 7919))

    def epoch_ms(loop) -> float:
        """One captured epoch of the loop; the event ms of its replays."""
        win = _StepWindow(GRAPH_WARMUP_STEPS + 1, profile=False)
        k = loop.k if isinstance(loop, PackedTrainLoop) else 1
        rows = (torch.arange(win.n_steps * k * bs, device=X.device) + next(starts)) % X.shape[0]
        rows = rows.reshape((win.n_steps, bs) if isinstance(loop, TrainLoop)
                            else (win.n_steps, k, bs))
        if isinstance(loop, TrainLoop):
            loop.state, _ = loop.program.train_steps(loop.state, ResidentFeed(X, Y, rows),
                                                     on_step=win)
        else:
            loop.program.train_steps(loop.state, ResidentFeed(X, Y, rows), on_step=win)
        return win.event_ms

    from rafiki_tpu_torch.models.vgg import Vgg

    loops = {"serial": serial_loop(fns(1, Vgg)[0])}
    for k in (1, 2, 4):
        loops[f"packed_{k}"] = packed_loop(fns(k, Vgg))
    order = ["serial", "packed_1", "packed_2", "packed_4"]
    runs = {name: [] for name in order}
    for name in order + order[::-1]:
        runs[name].append(epoch_ms(loops[name]))
    del loops
    torch.cuda.empty_cache()

    # One float32 step, one-member pack against serial, gradient by gradient.
    cls = _f32_vgg_class()
    one = one_member_pack_vs_serial(fns(1, cls)[0], fns(1, cls)[0], X[:bs], Y[:bs])
    rel = one.pop("grad_rel")

    def worst(prefix):
        return max(v for n, v in rel.items() if n.startswith(prefix))

    return {"phase": "pack_scaling", "card": card[1], "power_limit": card[2], "batch": bs,
            "steps": PROFILE_ITERS, "captured": True, **_graph_since(graphs),
            "phase_s": time.monotonic() - t_phase,
            "step_event_ms": {name: float(np.mean(v)) for name, v in runs.items()},
            "step_event_ms_runs": runs,
            "ms_per_trial_step": {name: float(np.mean(v)) / (1 if name == "serial" else
                                                            int(name.split("_")[1]))
                                  for name, v in runs.items()},
            "f32_one_member_pack_vs_serial": dict(
                one, grad_rel_max={"convs": worst("convs."), "norms": worst("norms."),
                                   "dense": max(worst("fc1."), worst("fc2."))})}


def one_member_pack_vs_serial(f_serial, f_pack, x, y):
    """One step's loss and gradients of a serial TrainLoop and of a
    one-member PackedTrainLoop built from the same template closures
    (two ``_loop_fns`` of one model) on the batch ``x``, ``y``: the
    losses, the gradients that differ at all, and each gradient's max
    difference relative to its max."""
    import functools

    import torch

    from rafiki_tpu_torch.ops.train import PackedGenerators, PackedTrainLoop, TrainLoop

    loop = TrainLoop(f_serial["init_fn"], f_serial["apply_eval"], f_serial["loss_fn"],
                     f_serial["optimizer"], hyper=f_serial["hyper"])
    packed = PackedTrainLoop(f_pack["init_fn"], f_pack["apply_eval"], f_pack["loss_fn"],
                             f_pack["optimizer"], seeds=[0], hypers=[f_pack["hyper"]])
    module = loop.params
    with torch.enable_grad():
        loss, _ = f_serial["loss_fn"](module, {"x": x, "y": y}, loop.state[3], loop.state[4])
        want = torch.autograd.grad(loss, list(module.parameters()))
        st = packed.state
        v_loss = torch.func.vmap(functools.partial(packed.program._member_loss,
                                                   generators=PackedGenerators(st.generators)))
        losses, _ = v_loss(st.params, st.buffers, x[None], y[None], st.hyper_dev)
        got = torch.autograd.grad(losses.sum(), list(st.params.values()))
    names = [n for n, _ in module.named_parameters()]
    return {"loss": [float(loss.detach()), float(losses[0].detach())], "grads": len(want),
            "grads_differing": [n for n, a, b in zip(names, want, got) if not torch.equal(a, b[0])],
            "grad_rel": {n: float((a - b[0]).abs().max() / a.abs().max().clamp_min(1e-30))
                         for n, a, b in zip(names, want, got)}}


# -- the service journey --------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get_json(url: str):
    return json.loads(_get_raw(url)[2])


def _get_raw(url: str):
    """(status, content type, body bytes) of one GET."""
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(url, timeout=60) as r:
        return r.status, r.headers.get("Content-Type") or "", r.read()


def _span_p50_ms(records, name: str):
    xs = [r["dur_s"] for r in records if r["name"] == name]
    return percentile_ms(xs, 50) if xs else None


def _serving_counters(host: str, phase: str) -> dict:
    """The predictor's telemetry: fail on a worker error or a timed-out
    query (the inference worker answers a failing forward with an
    error reply and the manager's startup wait goes on regardless, so
    the counters are what shows a fault)."""
    snap = _get_json(f"http://{host}/metrics")
    c = snap["counters"]
    bad = {k: c.get(k, 0) for k in ("inference.batch_errors", "predictor.query_timeouts")}
    if any(bad.values()):
        fail(f"service_journey ({phase}): {bad}")
    return snap


def service_journey(card):
    """Phase 11: the user's journey through the port's service on the
    card. Returns the phase's line."""
    import gc
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    import rafiki_tpu_torch
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.admin.app import serve
    from rafiki_tpu_torch.client import Client
    from rafiki_tpu_torch.config import Config, get_config, set_config
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.parallel.serving import build_stacked
    from rafiki_tpu_torch.predictor.ensemble import ensemble_predictions
    from rafiki_tpu_torch.store import MetaStore
    from rafiki_tpu_torch.utils.events import events

    line = {"phase": "service_journey", "card": card[1], "power_limit": card[2]}
    tmp = Path(tempfile.mkdtemp(prefix="rafiki-journey-"))
    prev_config = get_config()
    cfg = Config(data_dir=tmp / "data")
    set_config(cfg)
    port = _free_port()
    stop = threading.Event()
    server = threading.Thread(target=serve, name="journey-admin", daemon=True,
                              kwargs=dict(host="127.0.0.1", port=port, device="cuda",
                                          stop_event=stop))
    t_phase = time.monotonic()
    server.start()
    try:
        # -- 1. the server answers --------------------------------------------
        client = Client(admin_port=port, timeout_s=300)
        deadline = time.monotonic() + 60
        while True:
            try:
                _get_json(f"http://127.0.0.1:{port}/healthz")
                break
            except OSError:
                if time.monotonic() > deadline or not server.is_alive():
                    fail("service_journey: the admin server never answered")
                time.sleep(0.1)
        store = MetaStore(cfg.db_path)
        # The web UI: the admin serves the port's page at ``/``.
        status, ctype, page = _get_raw(f"http://127.0.0.1:{port}/")
        want_page = (Path(rafiki_tpu_torch.__file__).resolve().parent / "web"
                     / "index.html").read_bytes()
        line["web_ui"] = {"status": status, "content_type": ctype, "bytes": len(page),
                          "byte_equal": page == want_page}
        if status != 200 or page != want_page or not ctype.startswith("text/html"):
            fail(f"service_journey: GET / did not serve the UI: {line['web_ui']}")

        # -- 2. train through the REST API ------------------------------------
        client.login(cfg.superadmin_email, cfg.superadmin_password)
        (tmp / "bench_vgg.py").write_bytes(BENCH_SRC)
        client.create_model("bench-vgg", "IMAGE_CLASSIFICATION", tmp / "bench_vgg.py",
                            "BenchVgg")
        t0 = time.monotonic()
        graphs = _graph_counters()
        client.create_train_job("journey", "IMAGE_CLASSIFICATION", TRAIN_URI, EVAL_URI,
                                {"MODEL_TRIAL_COUNT": JOURNEY_TRIALS}, advisor_kind="gp")
        job = client.wait_until_train_job_has_stopped("journey", timeout=900, poll_s=0.5)
        line["train_job_s"] = time.monotonic() - t0
        line.update(_graph_since(graphs))
        if line["graph_replays"] <= 0:
            fail(f"service_journey: the train job replayed no captured step: {line}")
        trials = client.get_trials_of_train_job("journey")
        line["train_job_status"] = job["status"]
        line["trials"] = [{"no": t["no"], "status": t["status"], "score": t["score"],
                           "batch_size": t["knobs"]["batch_size"],
                           "error": (t["error"] or "")[:200] or None} for t in trials]
        completed = [t for t in trials if t["status"] == "COMPLETED"]
        if job["status"] != "COMPLETED" or len(completed) < 2:
            fail(f"service_journey: train job {job['status']}, {len(completed)} trials "
                 f"completed: {line['trials']}")
        for t in trials:
            if t["status"] == "ERRORED" and not (t["error"] or "").startswith("diverged:"):
                fail(f"service_journey: trial {t['no']} errored, not a contained "
                     f"divergence: {t['error']}")

        # -- 3. serve through the REST API ------------------------------------
        gc.collect()
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        inf = client.create_inference_job("journey", max_models=2)
        line["create_inference_job_s"] = time.monotonic() - t0
        host = inf["predictor_host"]
        routes = [e for e in events.read("inference_route") if e.get("job_id") == inf["id"]]
        line["route"] = routes[-1] if routes else None
        rows = store.get_services_of_job(inf["id"])
        if inf["status"] != "RUNNING" or not host:
            fail(f"service_journey: inference job {inf}")
        if not routes or routes[-1]["route"] != "stacked":
            fail(f"service_journey: the job was not served stacked: {routes}")
        if not rows or any(r["status"] == "ERRORED" for r in rows):
            fail(f"service_journey: inference service rows {rows}")

        # -- 4. predict over HTTP ---------------------------------------------
        ds = dataset_utils.load(EVAL_URI)
        x = ds.x[:JOURNEY_IMAGES]
        singles = [x[i:i + 1].tolist() for i in range(JOURNEY_1Q)]
        bursts = [x[(i * BATCH) % JOURNEY_IMAGES:][:BATCH].tolist() for i in range(JOURNEY_64Q)]
        t0 = time.monotonic()
        client.predict_via_predictor(host, singles[0])
        line["first_request_s"] = time.monotonic() - t0
        _serving_counters(host, "first request")
        for label, reqs in (("1q", singles), ("64q", bursts)):
            telemetry.reset()
            lat = []
            for q in reqs:
                t0 = time.monotonic()
                out = client.predict_via_predictor(host, q)
                lat.append(time.monotonic() - t0)
                if len(out) != len(q) or any(isinstance(p, dict) for p in out):
                    fail(f"service_journey: a {label} request failed: {out[:2]}")
            _serving_counters(host, f"{label} requests")
            records = telemetry.span_records()
            line[f"client_p50_ms_{label}"] = percentile_ms(lat, 50)
            line[f"client_p99_ms_{label}"] = percentile_ms(lat, 99)
            line[f"server_p50_ms_{label}"] = {
                name: _span_p50_ms(records, name)
                for name in ("predictor_http.decode", "predictor_http.rows",
                             "gateway.predict", "predictor_http.encode",
                             "inference.forward")}
        line["request_body_bytes_64q"] = len(json.dumps({"queries": bursts[0]}))
        http_probs = np.asarray(
            [p for i in range(0, JOURNEY_IMAGES, BATCH)
             for p in client.predict_via_predictor(host, x[i:i + BATCH].tolist())], np.float64)
        # The same two stored blobs, stacked in-process on the card, and
        # gathered as the predictor gathers the stacked worker's reply.
        best = client.get_best_trials_of_train_job("journey", max_count=2)
        cls = load_model_class(BENCH_SRC, "BenchVgg")
        models = []
        for t in best:
            m = cls(device="cuda", **t["knobs"])
            m.load_parameters(client.get_trial_parameters(t["id"]))
            models.append(m)
        ref_model, reason = build_stacked(best, models, batch_size=BATCH)
        if ref_model is None:
            fail(f"service_journey: the reference ensemble did not stack: {reason}")
        ref = np.asarray([ensemble_predictions([p]) for i in range(0, JOURNEY_IMAGES, BATCH)
                          for p in ref_model.predict(x[i:i + BATCH].tolist())], np.float64)
        ref_model.destroy()
        del models, ref_model
        line["http_vs_in_process_max_abs"] = float(np.abs(http_probs - ref).max())
        line["http_top1"] = float((http_probs.argmax(-1) == ds.y[:JOURNEY_IMAGES]).mean())
        line["top1_target"] = TUNE_TOP1_TARGET
        if http_probs.shape != (JOURNEY_IMAGES, NUM_CLASSES) or not np.isfinite(http_probs).all():
            fail(f"service_journey: HTTP predictions of shape {http_probs.shape} or non-finite")
        if line["http_vs_in_process_max_abs"] > JOURNEY_ATOL:
            fail(f"service_journey: HTTP vs in-process ensemble "
                 f"{line['http_vs_in_process_max_abs']} > {JOURNEY_ATOL}")
        if line["http_top1"] < TUNE_TOP1_TARGET:
            fail(f"service_journey: top-1 {line['http_top1']} < {TUNE_TOP1_TARGET}")

        # -- 5. microbatching ---------------------------------------------------
        client.stop_inference_job("journey")
        inf = client.create_inference_job("journey", max_models=2, gateway=MB_GATEWAY)
        host = inf["predictor_host"]
        telemetry.reset()
        answers, errors = {}, []
        lock = threading.Lock()

        def fire(k: int) -> None:
            for j in range(MB_REQUESTS):
                i = k * MB_REQUESTS + j
                try:
                    out = client.predict_via_predictor(host, x[i:i + 1].tolist())
                    with lock:
                        answers[i] = out[0]
                except Exception as e:  # counted and failed on below
                    with lock:
                        errors.append(repr(e))

        t0 = time.monotonic()
        threads = [threading.Thread(target=fire, args=(k,)) for k in range(MB_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        mb_wall = time.monotonic() - t0
        n_req = MB_THREADS * MB_REQUESTS
        snap = _serving_counters(host, "microbatched requests")
        stats = _get_json(f"http://{host}/gateway")
        sizes = snap["histograms"].get("serving.microbatch.size", {})
        got = np.asarray([answers[i] for i in sorted(answers)], np.float64)
        line["microbatch"] = {
            "requests": n_req, "answered": len(answers), "errors": errors[:3],
            "wall_s": mb_wall, "requests_per_s": len(answers) / mb_wall,
            "shed_total": stats["shed_total"], "timeouts": stats["timeouts"],
            "batches": sizes.get("count"), "mean_batch": sizes.get("mean"),
            "max_batch": sizes.get("max"), "gateway": MB_GATEWAY,
            "flushes": {r: snap["counters"].get(f"serving.microbatch.flush_{r}", 0)
                        for r in ("size", "deadline", "drain")},
            "vs_in_process_max_abs": (float(np.abs(got - ref[:n_req]).max())
                                      if len(answers) == n_req else None)}
        mb = line["microbatch"]
        if errors or len(answers) != n_req or stats["shed_total"] or stats["timeouts"]:
            fail(f"service_journey: microbatched requests {mb}")
        if not sizes or not (sizes["max"] > 1 and sizes["mean"] > 1):
            fail(f"service_journey: no batch of more than one member: {mb}")
        if mb["vs_in_process_max_abs"] > JOURNEY_ATOL:
            fail(f"service_journey: microbatched predictions disagree: {mb}")

        # -- 6. stop, and the card's memory ---------------------------------
        client.stop_inference_job("journey")
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        line["memory_allocated_before_serving"] = mem_before
        line["memory_allocated_after_stop"] = mem_after
        # Not gated: what is left once cuBLAS frees the workspaces it
        # keeps per handle (a new thread that multiplies takes one).
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
            line["memory_allocated_after_clearing_cublas_workspaces"] = \
                torch.cuda.memory_allocated()
        if mem_after > mem_before + TUNE_LEAK_BYTES:
            fail(f"service_journey: {mem_after} bytes allocated after the inference jobs "
                 f"stopped, {mem_before} before them (+{TUNE_LEAK_BYTES} allowed)")
        store.close()
    finally:
        stop.set()
        server.join(timeout=120)
        set_config(prev_config)
        shutil.rmtree(tmp, ignore_errors=True)
    if server.is_alive():
        fail("service_journey: the admin server did not stop")
    line["phase_s"] = time.monotonic() - t_phase
    return line


# -- checkpoints, resume and orphan recovery ----------------------------------------
# The canonical model and task, for 3 epochs. The task is cut from the
# bench's 50,000 images to RESUME_IMAGES so both phases fit the script's
# time limit; its shapes, noise and label flips are the canonical ones.
RESUME_IMAGES = 20000
RESUME_URI = TRAIN_URI.replace("n=50000", f"n={RESUME_IMAGES}")
RESUME_SRC = BENCH_SRC.replace(b'"epochs": FixedKnob(1)', b'"epochs": FixedKnob(3)')
RESUME_KNOBS = dict(depth=16, width_mult=1.0, dropout=0.2, learning_rate=1e-3, batch_size=256,
                    epochs=3, seed=0)
PACK_RESUME_KNOBS = (dict(RESUME_KNOBS, batch_size=128, learning_rate=1e-3, dropout=0.1),
                     dict(RESUME_KNOBS, batch_size=128, learning_rate=3e-4, dropout=0.2))
# The killed worker's silence the sweep waits for, at least, before it
# calls the worker dead (stale_after_s is set 1 s below the silence).
RESUME_SILENCE_S = 2.0
RESUME_CHILD_TIMEOUT_S = 300


class _FixedAdvisor:
    """The advisor of a child worker: it proposes the given knobs."""

    def __init__(self, knobs_list):
        self.knobs_list = [dict(k) for k in knobs_list]

    def propose(self):
        return dict(self.knobs_list[0])

    def propose_batch(self, n):
        return [dict(k) for k in self.knobs_list[:n]]

    def feedback(self, score, knobs):
        pass


def resume_child(data_dir: str, sub_id: str, service_id: str, knobs_json: str) -> int:
    """``--resume-child``: a train worker on the card under the given
    service row, its trials (one, or a pack of two under
    RAFIKI_TRIAL_PACK) checkpointed every epoch (RAFIKI_CHECKPOINT_EVERY);
    the parent kills it mid-trial. Journals under RAFIKI_LOG_DIR when the
    parent sets it, as a worker process of the JAX package does."""
    from rafiki_tpu_torch import obs
    from rafiki_tpu_torch.config import Config
    from rafiki_tpu_torch.store import MetaStore, ParamsStore
    from rafiki_tpu_torch.utils.events import events
    from rafiki_tpu_torch.worker.train import build_worker_from_store

    if obs.configure_from_env(role="train-worker"):
        obs.recorder.install()
    cfg = Config(data_dir=__import__("pathlib").Path(data_dir)).ensure_dirs()
    events.configure(cfg.logs_dir)
    store, params = MetaStore(cfg.db_path), ParamsStore(cfg.params_dir)
    worker = build_worker_from_store(store, params, sub_id, _FixedAdvisor(json.loads(knobs_json)),
                                     worker_id="resume-child", async_persist=False)
    worker.service_id = service_id
    worker.run()
    return 0


def _resume_setup(trials: int):
    """A fresh data dir holding the template, a job of ``trials`` trials
    and a running train-worker service row."""
    import tempfile
    from pathlib import Path

    from rafiki_tpu_torch.config import Config
    from rafiki_tpu_torch.constants import ServiceStatus, ServiceType
    from rafiki_tpu_torch.store import MetaStore

    cfg = Config(data_dir=Path(tempfile.mkdtemp(prefix="rafiki-resume-")) / "data").ensure_dirs()
    store = MetaStore(cfg.db_path)
    model = store.create_model("bench-vgg-3", "IMAGE_CLASSIFICATION", None, RESUME_SRC, "BenchVgg")
    job = store.create_train_job("resume", "IMAGE_CLASSIFICATION", None, RESUME_URI, EVAL_URI,
                                 {"MODEL_TRIAL_COUNT": trials})
    sub = store.create_sub_train_job(job["id"], model["id"])
    svc = store.create_service(ServiceType.TRAIN_WORKER.value, job_id=job["id"], worker_index=0)
    store.update_service(svc["id"], status=ServiceStatus.RUNNING.value, heartbeat=True)
    store.close()
    return cfg, sub["id"], svc["id"]


def _kill_after_checkpoints(cfg, sub_id, svc_id, knobs_list, env_extra, label):
    """Run the child worker and SIGKILL it once every one of its trials'
    epoch-0 checkpoint is durable. Fails unless the child was alive
    until the kill. Returns the trial ids and the seconds the child ran."""
    import os
    import signal

    from rafiki_tpu_torch.store import MetaStore, ParamsStore

    env = dict(os.environ, RAFIKI_CHECKPOINT_EVERY="1", **env_extra)
    t0 = time.monotonic()
    child = subprocess.Popen([sys.executable, __file__, "--resume-child", str(cfg.data_dir),
                              sub_id, svc_id, json.dumps(knobs_list)], env=env)
    store, params = MetaStore(cfg.db_path), ParamsStore(cfg.params_dir)
    try:
        while True:
            if child.poll() is not None:
                fail(f"{label}: the child worker exited with {child.returncode} before the kill")
            if time.monotonic() - t0 > RESUME_CHILD_TIMEOUT_S:
                fail(f"{label}: no epoch-0 checkpoint after {RESUME_CHILD_TIMEOUT_S} s")
            tids = [t["id"] for t in store.get_trials_of_sub_train_job(sub_id)]
            if len(tids) == len(knobs_list) and all(params.exists(f"{t}_ckpt_0") for t in tids):
                break
            time.sleep(0.02)
        child.send_signal(signal.SIGKILL)
        rc = child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
        store.close()
    if rc != -signal.SIGKILL:
        fail(f"{label}: the child worker ended with {rc}, not by the kill")
    return tids, time.monotonic() - t0


def _wait_silence(store, svc_id) -> float:
    """Wait until the killed worker's service has been silent for
    RESUME_SILENCE_S; returns a stale_after_s 1 s below its silence."""
    svc = store.get_service(svc_id)
    silence = time.time() - svc["heartbeat_at"]
    if silence < RESUME_SILENCE_S:
        time.sleep(RESUME_SILENCE_S - silence)
    return time.time() - svc["heartbeat_at"] - 1.0


def _reference_blob(cls, knobs, ckpt_timer=None) -> bytes:
    """An uninterrupted serial trial of ``knobs`` on the card: its params
    blob (float32 in these phases)."""
    m = cls(**knobs)
    if ckpt_timer is not None:
        m.set_checkpoint_sink(ckpt_timer)
    m.train(RESUME_URI)
    blob = m.dump_parameters()
    m.destroy()
    return blob


def _resume_events(events, tids):
    out = {t: {"written": [], "resumed": [], "restore_failed": []} for t in tids}
    for name, key in (("checkpoint_written", "written"), ("trial_resumed", "resumed"),
                      ("checkpoint_restore_failed", "restore_failed")):
        for e in events.read(name):
            if e.get("trial_id") in out:
                out[e["trial_id"]][key].append(e)
    return out


def trial_resume(card):
    """Phase 14: a canonical trial killed after its epoch-0 checkpoint,
    recovered through the admin's POST /recovery. Returns the line."""
    import shutil
    import urllib.request

    import torch

    from rafiki_tpu_torch.admin import Admin
    from rafiki_tpu_torch.admin.app import AdminApp
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.store import ParamsStore
    from rafiki_tpu_torch.utils.events import events
    from rafiki_tpu_torch.utils.httpd import start_server

    t_phase = time.monotonic()
    graphs = _graph_counters()
    cls = load_model_class(RESUME_SRC, "BenchVgg")
    cfg, sub_id, svc_id = _resume_setup(1)
    # The reference, and the seconds to take and write a checkpoint (and
    # to restore it) on the card, each epoch.
    timing = {"write_s": [], "bytes": [], "restore_s": []}
    ref_store = ParamsStore(cfg.data_dir / "reference")

    def ckpt_timer(epoch, make_blob):
        t0 = time.monotonic()
        blob = make_blob()
        ref_store.save_checkpoint("reference", epoch, blob)
        timing["write_s"].append(time.monotonic() - t0)
        timing["bytes"].append(len(blob))
        t0 = time.monotonic()
        m = cls(**RESUME_KNOBS)
        m.restore_checkpoint(ref_store.load(f"reference_ckpt_{epoch}"))
        torch.cuda.synchronize()
        timing["restore_s"].append(time.monotonic() - t0)
        m.destroy()

    t0 = time.monotonic()
    ref = _reference_blob(cls, RESUME_KNOBS, ckpt_timer)
    ref_s = time.monotonic() - t0
    line = {"phase": "trial_resume", "card": card[1], "power_limit": card[2],
            "knobs": RESUME_KNOBS, "train_uri": RESUME_URI,
            "cut": f"task images {RESUME_IMAGES} of the canonical 50000",
            "reference_s": ref_s, "reference_checkpoint": timing}
    tids, child_s = _kill_after_checkpoints(cfg, sub_id, svc_id, [RESUME_KNOBS], {}, "trial_resume")
    tid = tids[0]
    admin = Admin(config=cfg)  # on the card
    server, _ = start_server(AdminApp(admin))
    try:
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        url = f"http://127.0.0.1:{server.server_port}"

        def post(path, body, token=None):
            headers = {"Content-Type": "application/json"}
            if token:
                headers["Authorization"] = f"Bearer {token}"
            req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                         method="POST", headers=headers)
            with opener.open(req, timeout=RESUME_CHILD_TIMEOUT_S) as r:
                return r.status, json.loads(r.read())

        _, tok = post("/tokens", {"email": cfg.superadmin_email,
                                  "password": cfg.superadmin_password})
        ckpt_bytes = admin.params_store.size(f"{tid}_ckpt_0")
        stale = _wait_silence(admin.store, svc_id)
        t0 = time.monotonic()
        status, rows = post("/recovery", {"stale_after_s": stale, "wait": True}, tok["token"])
        post_s = _synced_s(t0)
        trial = admin.store.get_trial(tid)
        stored = admin.params_store.load(trial["params_id"]) if trial["params_id"] else None
        ev = _resume_events(events, [tid])[tid]
        line.update({
            "device": str(admin.services.device),
            "child_s": child_s, "stale_after_s": stale, "post_status": status,
            "recovered": [(r["id"], r["status"]) for r in rows],
            "status": trial["status"], "score": trial["score"],
            "checkpoint_bytes": ckpt_bytes,
            "child_checkpoint_write_s": [e.get("seconds") for e in ev["written"]],
            "restore_s": [e.get("seconds") for e in ev["resumed"]],
            "resumed_from_epoch": [e.get("from_epoch") for e in ev["resumed"]],
            "restore_failed": len(ev["restore_failed"]),
            "post_to_completed_s": post_s,
            "epochs_trained_after_resume": [RESUME_KNOBS["epochs"] - e.get("from_epoch")
                                            for e in ev["resumed"]],
            "params_byte_equal": stored == ref,
            "checkpoints_left": admin.params_store.latest_checkpoint(tid) is not None,
            "orphans_left": len(admin.store.get_orphaned_trials(stale)),
        })
    finally:
        server.shutdown()
        server.server_close()
        admin.stop()
        events.close()
        shutil.rmtree(cfg.data_dir.parent, ignore_errors=True)
    # This process's captured steps: the reference and the recovered run.
    line.update(_graph_since(graphs), phase_s=time.monotonic() - t_phase)
    return line


def pack_resume(card):
    """Phase 15: two canonical trials trained as one pack, killed after
    the round-0 checkpoints, each recovered serially through
    ``recover_orphaned_trials``. Returns the line."""
    import shutil

    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.scheduler.recovery import recover_orphaned_trials
    from rafiki_tpu_torch.store import MetaStore, ParamsStore
    from rafiki_tpu_torch.utils.backend import resolve_device
    from rafiki_tpu_torch.utils.events import events

    t_phase = time.monotonic()
    graphs = _graph_counters()
    cls = load_model_class(RESUME_SRC, "BenchVgg")
    t0 = time.monotonic()
    refs = [_reference_blob(cls, kn) for kn in PACK_RESUME_KNOBS]
    ref_s = time.monotonic() - t0
    cfg, sub_id, svc_id = _resume_setup(len(PACK_RESUME_KNOBS))
    line = {"phase": "pack_resume", "card": card[1], "power_limit": card[2],
            "device": str(resolve_device()),
            "knobs": list(PACK_RESUME_KNOBS), "train_uri": RESUME_URI,
            "cut": f"task images {RESUME_IMAGES} of the canonical 50000",
            "serial_references_s": ref_s}
    tids, child_s = _kill_after_checkpoints(cfg, sub_id, svc_id, list(PACK_RESUME_KNOBS),
                                            {"RAFIKI_TRIAL_PACK": str(len(PACK_RESUME_KNOBS))},
                                            "pack_resume")
    events.configure(cfg.logs_dir)
    store, params = MetaStore(cfg.db_path), ParamsStore(cfg.params_dir)
    try:
        trials = {t["id"]: t for t in store.get_trials_of_sub_train_job(sub_id)}
        order = sorted(tids, key=lambda t: trials[t]["no"])
        ckpt_bytes = [params.size(f"{t}_ckpt_0") for t in order]
        stale = _wait_silence(store, svc_id)
        t0 = time.monotonic()
        rows = recover_orphaned_trials(store, params, stale_after_s=stale)
        recover_s = _synced_s(t0)
        ev = _resume_events(events, order)
        rounds = {}
        for t in order:
            for e in ev[t]["written"]:
                r = rounds.setdefault(e["epoch"], {"slice_s": e.get("slice_seconds"), "write_s": 0.0})
                r["write_s"] += e.get("seconds") or 0.0
        final = [store.get_trial(t) for t in order]
        stored = [params.load(t["params_id"]) if t["params_id"] else None for t in final]
        knobs_of = [final[i]["knobs"] for i in range(len(order))]
        line.update({
            "child_s": child_s, "stale_after_s": stale, "recover_s": recover_s,
            "recovered": [(r["id"], r["status"]) for r in rows],
            "status": [t["status"] for t in final], "scores": [t["score"] for t in final],
            "member_knobs": knobs_of,
            "checkpoint_bytes_per_member": ckpt_bytes,
            "pack_checkpoint_s_per_round": {str(k): v["slice_s"] + v["write_s"]
                                            for k, v in sorted(rounds.items())},
            "pack_checkpoint_rounds": {str(k): v for k, v in sorted(rounds.items())},
            "resumed_from_epoch": [[e.get("from_epoch") for e in ev[t]["resumed"]] for t in order],
            "restore_s": [[e.get("seconds") for e in ev[t]["resumed"]] for t in order],
            "restore_failed": sum(len(ev[t]["restore_failed"]) for t in order),
            # Member i's params against the serial run of its own knobs.
            "params_byte_equal": [kn in PACK_RESUME_KNOBS and stored[i] == refs[
                PACK_RESUME_KNOBS.index(kn)] for i, kn in enumerate(knobs_of)],
            "checkpoints_left": sum(params.latest_checkpoint(t) is not None for t in order),
            "orphans_left": len(store.get_orphaned_trials(stale)),
        })
    finally:
        store.close()
        events.close()
        shutil.rmtree(cfg.data_dir.parent, ignore_errors=True)
    line.update(_graph_since(graphs), phase_s=time.monotonic() - t_phase)
    return line


# -- the rest of the zoo ------------------------------------------------------


def _densenet_f32_class():
    from rafiki_tpu_torch.models.densenet import DenseNet, _DenseNet

    class DenseNetF32(DenseNet):
        """The DenseNet network with float32 compute."""

        def build_module(self, num_classes, input_shape):
            import torch

            return _DenseNet(int(self.knobs["depth"]), int(self.knobs["growth"]), num_classes,
                             int(input_shape[-1]), dtype=torch.float32)

    return DenseNetF32


def densenet_step(card):
    """Phase 17's step readings: the DenseNet step at batch 128 (lr 1e-3)
    on the canonical task resident on the card, eager (``train_step``,
    under the profiler: the device time of the forward, Adam, the
    sentinels and the rest, the backward, and the costliest operators)
    and captured (``train_steps``: CUDA-event ms, device busy ms, idle
    share), as phase 16 reads them; then one float32 step of a
    one-member pack against the serial step, gradient by gradient."""
    import torch

    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.models.densenet import DenseNet
    from rafiki_tpu_torch.ops.graphs import GRAPH_WARMUP_STEPS
    from rafiki_tpu_torch.ops.train import ResidentFeed, TrainLoop, get_device_dataset
    from rafiki_tpu_torch.utils.backend import resolve_device

    X, Y = get_device_dataset(dataset_utils.load(TRAIN_URI), resolve_device())
    bs = DENSENET_KNOBS["batch_size"]

    def fns(cls):
        model = cls(**dict(DENSENET_KNOBS, learning_rate=1e-3))
        model._planned_steps = X.shape[0] // bs
        return model._loop_fns(NUM_CLASSES, INPUT_SHAPE)

    def loop():
        f = fns(DenseNet)
        return TrainLoop(f["init_fn"], f["apply_eval"], f["loss_fn"], f["optimizer"],
                         hyper=f["hyper"])

    # Five profiled steps of about 3,900 kernels each: the profiler's
    # event processing, not the steps, sets this phase's time.
    window = GRAPH_WARMUP_STEPS + 1
    n_steps = _StepWindow(window, profile_iters=DENSENET_PROFILE_ITERS).n_steps
    rows = (torch.arange(n_steps * bs, device=X.device) % X.shape[0]).reshape(n_steps, bs)
    out = {}
    eager, win = loop(), _StepWindow(window, profile_iters=DENSENET_PROFILE_ITERS)
    for t in range(n_steps):
        batch = {"x": X.index_select(0, rows[t]), "y": Y.index_select(0, rows[t])}
        eager.state, _ = eager.program.train_step(eager.state, batch)
        win(t)
    out["eager"] = win.readings(bs, card, "densenet_eager")
    del eager
    captured, win = loop(), _StepWindow(window, profile_iters=DENSENET_PROFILE_ITERS)
    torch.cuda.reset_peak_memory_stats()
    captured.state, _ = captured.program.train_steps(captured.state, ResidentFeed(X, Y, rows),
                                                     on_step=win)
    out["captured"] = dict(win.readings(bs, card, "densenet_captured"),
                           max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    del captured
    torch.cuda.empty_cache()
    cls = _densenet_f32_class()
    one = one_member_pack_vs_serial(fns(cls), fns(cls), X[:bs], Y[:bs])
    one["grad_rel_max"] = max(one.pop("grad_rel").values())
    out["f32_one_member_pack_vs_serial"] = one
    return out


def densenet_pack(card):
    """Phase 17's pack: two DenseNet trials (DENSENET_PACK) as one pack,
    ``train_packed`` -> ``evaluate_packed``, one epoch of PROC_URI (the
    canonical task's 10,000-image cut); its seconds, scores, peak memory
    and captured steps."""
    import gc

    import torch

    from rafiki_tpu_torch.model.log import logger
    from rafiki_tpu_torch.models.densenet import DenseNet

    models = []
    for member in DENSENET_PACK:
        m = DenseNet(**dict(DENSENET_KNOBS, learning_rate=member["learning_rate"]))
        m._seed = member["seed"]
        models.append(m)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graphs = _graph_counters()
    t0 = time.monotonic()
    with logger.capture(lambda e: None):
        histories = DenseNet.train_packed(models, PROC_URI)
    train_s = _synced_s(t0)
    t0 = time.monotonic()
    scores = DenseNet.evaluate_packed(models, EVAL_URI)
    eval_s = _synced_s(t0)
    line = {"k": len(models), "members": list(DENSENET_PACK), "train_s": train_s,
            "evaluate_s": eval_s, "scores": scores, "epochs": histories,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            **_graph_since(graphs)}
    for m in models:
        m.destroy()
    return line


def densenet_job(card):
    """Phase 17: BenchDenseNet (DENSENET_SRC, uploaded as source) as a GP
    job of DENSENET_TRIALS trials on the canonical task, its top-2
    served through the stacked route against their stored scores, a k=2
    pack against the job's serial trials at its batch size, and the
    step readings of ``densenet_step``. Returns the per-trial lines and
    the phase's line."""
    import torch

    from rafiki_tpu_torch.models.densenet import DenseNet

    t_phase = time.monotonic()
    rows, job, best = tune_job(card, src=DENSENET_SRC, name="BenchDenseNet",
                               trials=DENSENET_TRIALS, phase="densenet_job",
                               advisor_kwargs=DENSENET_ADVISOR)
    # tune_job resets the telemetry: its line's counters are the job's.
    job_graphs = {k: job[k] for k in ("graph_replays", "graph_captures")}
    graphs = _graph_counters()
    split = {"job_s": time.monotonic() - t_phase}
    t0 = time.monotonic()
    served = served_accuracy(best, card, DenseNet, "BenchDenseNet") if len(best) == 2 else None
    split["served_s"] = time.monotonic() - t0
    del best
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    pack = densenet_pack(card)
    split["pack_s"] = time.monotonic() - t0
    # The job's serial trials train on the whole canonical task, the pack
    # on PROC_URI: their warm train seconds at the pack's batch size,
    # scaled by the image count, stand in for a serial trial on PROC_URI.
    bs = DENSENET_KNOBS["batch_size"]
    warm = [r["train_s"] for r in rows[1:] if r["batch_size"] == bs and r["train_s"]]
    if warm:
        pack["serial_train_s_per_trial_scaled"] = float(np.mean(warm)) * PROC_IMAGES / 50000
        pack["speedup_vs_serial_scaled"] = len(DENSENET_PACK) * \
            pack["serial_train_s_per_trial_scaled"] / pack["train_s"]
    t0 = time.monotonic()
    step = densenet_step(card)
    split["step_s"] = time.monotonic() - t0
    cold = rows[0] if rows else {}
    by_bs = {}
    for r in rows[1:]:
        if r["status"] == "COMPLETED":
            by_bs.setdefault(str(r["batch_size"]), []).append(r["trial_s"])
    line = dict(job, knobs=DENSENET_KNOBS, trial_count=DENSENET_TRIALS,
                cold_trial={"trial_s": cold.get("trial_s"), "batch_size": cold.get("batch_size")},
                warm_trial_s_by_batch_size=by_bs, job_graphs=job_graphs, served=served,
                pack=pack, step=step, phase_split_s=split,
                phase_s=time.monotonic() - t_phase)
    line["graph_replays"] = job_graphs["graph_replays"] + _graph_since(graphs)["graph_replays"]
    return rows, line


def _zoo_f32_forward_gap(model, f32_module, x):
    """A trained trial's float32 forward, card against CPU: its params
    (float32, as trained) in a float32 build of its network on each
    device, the same queries; max abs difference of the probabilities."""
    import copy

    import torch

    with torch.inference_mode():
        f32_module.load_state_dict(model._module.state_dict())
        card = torch.softmax(f32_module.cuda()(torch.from_numpy(x).cuda()).float(), -1).cpu()
        cpu = torch.softmax(copy.deepcopy(f32_module).cpu()(torch.from_numpy(x)).float(), -1)
    return float((card - cpu).abs().max())


def _zoo_trial(cls, knobs, train_uri, eval_uri, f32_module_of, queries):
    """train -> evaluate -> dump_parameters -> load_parameters -> predict
    on the card for one trial of ``cls``; returns its readings."""
    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.model.log import logger

    graphs = _graph_counters()
    m = cls(**knobs)
    logs = []
    t0 = time.monotonic()
    with logger.capture(logs.append):
        m.train(train_uri)
    train_s = _synced_s(t0)
    t0 = time.monotonic()
    score = m.evaluate(eval_uri)
    eval_s = _synced_s(t0)
    blob = m.dump_parameters()
    fresh = cls(**knobs)
    fresh.load_parameters(blob)
    t0 = time.monotonic()
    preds = fresh.predict(queries)
    predict_s = _synced_s(t0)
    ds = dataset_utils.load(train_uri)
    x = ds.x[:64]
    gap = _zoo_f32_forward_gap(m, f32_module_of(m), x)
    out = {"knobs": knobs, "train_uri": train_uri, "eval_uri": eval_uri,
           "train_examples": ds.size, "length": int(ds.x.shape[1]),
           "steps_per_epoch": ds.size // knobs["batch_size"], "train_s": train_s,
           "evaluate_s": eval_s, "score": score, "reloaded_score": fresh.evaluate(eval_uri),
           "predict_s": predict_s, "blob_bytes": len(blob),
           "epochs": [e["values"] for e in logs if e["type"] == "values"],
           "f32_card_vs_cpu": gap, **_graph_since(graphs)}
    m.destroy()
    fresh.destroy()
    return out, preds


def zoo_trials(card):
    """Phase 18: one Transformer trial (TRANSFORMER_KNOBS, the text task)
    and one PosBiLstm trial (POS_KNOBS, the corpus task) through train ->
    evaluate -> dump -> load -> predict on the card, each with its float32
    forward card against CPU; PosBigramHmm trained and predicting on the
    host; and every registry name resolved. Returns the phase's line."""
    import torch

    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.models import MODEL_REGISTRY, get_model_class
    from rafiki_tpu_torch.models.pos_bilstm import PosBiLstm, _BiLstmTagger
    from rafiki_tpu_torch.models.pos_hmm import PosBigramHmm
    from rafiki_tpu_torch.models.transformer import Transformer, _Encoder

    t_phase = time.monotonic()
    rng = np.random.default_rng(18)
    length = dataset_utils.load(TEXT_TRAIN_URI).x.shape[1]
    text_q = rng.integers(1, 81, size=(3, length)).tolist()
    pos_q = [rng.integers(1, 100, size=n).tolist() for n in (5, 32, 1, 40)]

    def encoder_f32(m):
        k = m.knobs
        return _Encoder(int(m._dataset_meta["vocab"]), k["embed_dim"], k["num_heads"],
                        k["num_layers"], m._arch[0], m._arch[1][0], dtype=torch.float32)

    def tagger_f32(m):
        k = m.knobs
        return _BiLstmTagger(int(m._dataset_meta["vocab"]), k["embed_dim"], k["hidden"],
                             m._arch[0], dtype=torch.float32)

    tr, tr_preds = _zoo_trial(Transformer, TRANSFORMER_KNOBS, TEXT_TRAIN_URI, TEXT_EVAL_URI,
                              encoder_f32, text_q)
    tr["predictions_shape"] = list(np.asarray(tr_preds).shape)
    torch.cuda.empty_cache()
    pos, pos_preds = _zoo_trial(PosBiLstm, POS_KNOBS, POS_TRAIN_URI, POS_EVAL_URI, tagger_f32,
                                pos_q)
    pos["query_lengths"] = [len(q) for q in pos_q]
    pos["prediction_lengths"] = [len(p) for p in pos_preds]
    t0 = time.monotonic()
    hmm = PosBigramHmm(smoothing=0.1, seed=0)
    hmm.train(POS_TRAIN_URI)
    hmm_line = {"score": hmm.evaluate(POS_EVAL_URI),
                "prediction_lengths": [len(p) for p in hmm.predict(pos_q)],
                "seconds": time.monotonic() - t0}
    registry = {}
    for name in MODEL_REGISTRY:
        try:
            registry[name] = get_model_class(name).__module__
        except ValueError as e:
            registry[name] = f"ValueError: {e}"
    return {"phase": "zoo_trials", "card": card[1], "power_limit": card[2],
            "transformer": tr, "pos_bilstm": pos, "pos_bigram_hmm": hmm_line,
            "registry": registry, "f32_atol": F32_ATOL, "score_floor": ZOO_SCORE_FLOOR,
            "phase_s": time.monotonic() - t_phase}


def zoo_phases(card, check) -> None:
    """Phases 17 and 18, their lines and their gates."""
    import torch

    torch.cuda.empty_cache()
    rows, dn = densenet_job(card)
    for row in rows:
        print(json.dumps(dict(row, phase="densenet_trial")))
    print(json.dumps(dn))
    torch.cuda.empty_cache()
    zoo = zoo_trials(card)
    print(json.dumps(zoo))
    zoo_checks(check, rows, dn, zoo)


def zoo_checks(check, rows, dn, zoo) -> None:
    """Phases 17 and 18's gates."""
    check(dn["status"] == "COMPLETED" and dn["trials"] == DENSENET_TRIALS and not dn["errors"],
          f"densenet_job: {dn['status']}, {dn['trials']} trials, errors {dn['errors']}")
    for row in rows:
        check(row["status"] == "COMPLETED" or (row["error"] or "").startswith("diverged:"),
              f"densenet_job, trial {row['no']}: {row['status']} and not a contained "
              f"divergence: {row['error']}")
    check(dn["gp_ei_proposals"] >= 1, f"densenet_job: no proposal from expected improvement {dn}")
    check(dn["best_score"] is not None and dn["best_score"] >= TUNE_TOP1_TARGET,
          f"densenet_job: best score {dn['best_score']} < {TUNE_TOP1_TARGET}")
    ev = dn["evaluated_memory_allocated_bytes"]
    check(len(ev) == dn["completed"] and ev and ev[-1] <= ev[0] + TUNE_LEAK_BYTES,
          f"densenet_job: memory allocated after the last trial {ev[-1:]} > after the first "
          f"{ev[:1]} + {TUNE_LEAK_BYTES}")
    # Every epoch, train and eval, of every trial and of the pack
    # captured its step once and replayed it.
    # (A contained divergence ends its trial before the eval pass.)
    for name, g, epochs in (("job", dn["job_graphs"], dn["trials"] + dn["completed"]),
                            ("pack", dn["pack"], 2)):
        check(g["graph_captures"] >= epochs and g["graph_replays"] > g["graph_captures"],
              f"densenet_job ({name}): {g['graph_captures']} captures and "
              f"{g['graph_replays']} replays for {epochs} epochs")
    check(dn["served"] is not None and max(dn["served"]["abs_diff"]) <= SERVED_ACC_ATOL,
          f"densenet_job: served accuracy disagrees with the stored score: {dn['served']}")
    check(all(np.isfinite(ep["loss"]) for h in dn["pack"]["epochs"] for ep in h),
          f"densenet_job: non-finite loss in the pack {dn['pack']['epochs']}")
    one = dn["step"]["f32_one_member_pack_vs_serial"]
    check(one["loss"][0] == one["loss"][1] and not one["grads_differing"],
          f"densenet_job: a one-member pack's float32 step is not the serial step: loss "
          f"{one['loss']}, gradients differing {one['grads_differing']}")
    for name in ("transformer", "pos_bilstm"):
        t = zoo[name]
        check(t["score"] > ZOO_SCORE_FLOOR and t["reloaded_score"] > ZOO_SCORE_FLOOR,
              f"zoo_trials {name}: scores {t['score']}, reloaded {t['reloaded_score']} <= "
              f"{ZOO_SCORE_FLOOR}")
        check(all(np.isfinite(ep["loss"]) for ep in t["epochs"]),
              f"zoo_trials {name}: non-finite loss {t['epochs']}")
        check(t["f32_card_vs_cpu"] <= F32_ATOL,
              f"zoo_trials {name}: float32 forward card vs CPU {t['f32_card_vs_cpu']} > {F32_ATOL}")
        check(t["graph_captures"] >= t["knobs"]["epochs"] and t["graph_replays"] > 0,
              f"zoo_trials {name}: {t['graph_captures']} captures, {t['graph_replays']} replays")
    check(zoo["transformer"]["predictions_shape"] == [3, 5],
          f"zoo_trials transformer: predictions of shape {zoo['transformer']['predictions_shape']}")
    pos, hmm = zoo["pos_bilstm"], zoo["pos_bigram_hmm"]
    check(pos["prediction_lengths"] == [min(n, pos["length"]) for n in pos["query_lengths"]],
          f"zoo_trials pos_bilstm: {pos['prediction_lengths']} tags for queries of "
          f"{pos['query_lengths']} tokens")
    check(hmm["score"] > ZOO_SCORE_FLOOR and hmm["prediction_lengths"] == pos["query_lengths"],
          f"zoo_trials pos_bigram_hmm: {hmm}")
    for name, got in zoo["registry"].items():
        ok = got.startswith("rafiki_tpu_torch.models.") or (
            name in ("SkDt", "SkSvm") and got.startswith("ValueError: ")
            and "is not available" in got)
        check(ok, f"zoo_trials: registry {name!r} -> {got}")


# -- the observability plane -----------------------------------------------------
# Phase 19: a journaled GP job of OBS_TRIALS canonical VGG16 trials (two
# epochs each, so every program has a warm epoch) with trial packing at
# k=OBS_PACK: the budget of three runs one pack of two and one serial
# trial, so both programs are counted and timed. The template tunes the
# learning rate only, in the range where the canonical trial trains, so
# every proposal shares one packing key.
OBS_TRIALS = 3
OBS_PACK = 2
OBS_SRC = b'''
from rafiki_tpu_torch.model.knobs import FixedKnob, FloatKnob
from rafiki_tpu_torch.models.vgg import Vgg


class ObsVgg(Vgg):
    """The canonical trial's knobs (VGG16 w1.0, batch 128, dropout 0.1),
    two epochs, tuning the learning rate."""

    @staticmethod
    def get_knob_config():
        return {
            "depth": FixedKnob(16),
            "width_mult": FixedKnob(1.0),
            "dropout": FixedKnob(0.1),
            "learning_rate": FloatKnob(3e-4, 1e-3, is_exp=True),
            "batch_size": FixedKnob(128),
            "epochs": FixedKnob(2),
            "seed": FixedKnob(0),
        }
'''
# The captured VGG16 step's FLOP count against the analytic count of its
# convolutions and dense layers at batch 128 (full 3x3 windows, forward
# plus the weight- and input-gradient products, no input gradient for
# the first conv): both count the same products, so they must be equal.
OBS_FLOPS_RTOL = 0.0
# The record pairs one gateway query must stitch into one trace: the
# HTTP span, the gateway, the bus envelope and the inference worker.
OBS_TRACE_PAIRS = (("span", "predictor_http.decode"), ("span", "gateway.predict"),
                   ("bus", "add_query"), ("bus", "pop_query"),
                   ("span", "inference.forward"), ("gather", "predictor.gather"),
                   ("serving", "request"))
# Hook calls timed for the journal's cost of one warm epoch.
OBS_HOOK_CALLS = 2000


def vgg_step_flops(depth, width_mult, input_shape, num_classes, batch) -> int:
    """The analytic FLOP count of a ``Vgg`` train step (2 a multiply-add):
    each 3x3 conv's full window and each dense layer, forward plus the
    weight- and input-gradient products, no input gradient for the
    first conv."""
    from rafiki_tpu_torch.models.vgg import _CFGS

    h, w, cin = input_shape
    total, first = 0, True
    for v in _CFGS[depth]:
        if v == "M":
            if min(h, w) >= 2:
                h, w = h // 2, w // 2
            continue
        ch = max(8, int(v * width_mult))
        total += 2 * batch * h * w * ch * cin * 9 * (2 if first else 3)
        first, cin = False, ch
    hidden = max(64, int(512 * width_mult))
    for a, b in ((h * w * cin, hidden), (hidden, num_classes)):
        total += 3 * 2 * batch * a * b
    return total


def _journal_hook_cost_us() -> float:
    """Host microseconds of the hooks a warm epoch runs into the journal
    (``ledger.add``, ``profiler.note_epoch``, ``slo.maybe_tick``), timed
    over OBS_HOOK_CALLS calls into a throwaway journal."""
    import shutil
    import tempfile

    from rafiki_tpu_torch.obs.journal import journal
    from rafiki_tpu_torch.obs.ledger import ledger
    from rafiki_tpu_torch.obs.perf import profiler, slo

    tmp = tempfile.mkdtemp(prefix="rafiki-hooks-")
    journal.configure(tmp, role="hooks")
    try:
        t0 = time.perf_counter()
        for _ in range(OBS_HOOK_CALLS):
            ledger.add("step_s", 1e-3)
            profiler.note_epoch(("hooks",), 1e-3, steps=1)
            slo.maybe_tick()
        return (time.perf_counter() - t0) / OBS_HOOK_CALLS * 1e6
    finally:
        journal.close()
        shutil.rmtree(tmp, ignore_errors=True)


def observability(card):
    """Phase 19: the journaled job and query, read back through the
    port's CLI. Returns the phase's line and its failures."""
    import gc
    import io
    import os
    import shutil
    import tempfile
    from contextlib import redirect_stdout
    from pathlib import Path

    import torch

    from rafiki_tpu_torch import obs
    from rafiki_tpu_torch.admin.app import serve
    from rafiki_tpu_torch.client import Client
    from rafiki_tpu_torch.config import Config, get_config, set_config
    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.obs import cli
    from rafiki_tpu_torch.obs.perf import profiler

    t_phase = time.monotonic()
    line = {"phase": "observability", "card": card[1], "power_limit": card[2]}
    bad = []
    tmp = Path(tempfile.mkdtemp(prefix="rafiki-obs-"))
    log_dir = tmp / "log"
    prev_config, prev_env = get_config(), {k: os.environ.get(k) for k in
                                           ("RAFIKI_LOG_DIR", "RAFIKI_TRIAL_PACK")}
    cfg = Config(data_dir=tmp / "data")
    set_config(cfg)
    os.environ.update(RAFIKI_LOG_DIR=str(log_dir), RAFIKI_TRIAL_PACK=str(OBS_PACK))
    # Earlier phases ran these programs' first epochs unjournaled: start
    # the profiler afresh so this job's programs are counted.
    profiler.reset()
    if not obs.configure_from_env(role="chip-smoke"):
        fail("observability: RAFIKI_LOG_DIR did not configure the journal")
    port = _free_port()
    stop = threading.Event()
    server = threading.Thread(target=serve, name="obs-admin", daemon=True,
                              kwargs=dict(host="127.0.0.1", port=port, device="cuda",
                                          stop_event=stop))
    server.start()
    try:
        client = Client(admin_port=port, timeout_s=300)
        deadline = time.monotonic() + 60
        while True:
            try:
                _get_json(f"http://127.0.0.1:{port}/healthz")
                break
            except OSError:
                if time.monotonic() > deadline or not server.is_alive():
                    fail("observability: the admin server never answered")
                time.sleep(0.1)
        client.login(cfg.superadmin_email, cfg.superadmin_password)
        (tmp / "obs_vgg.py").write_bytes(OBS_SRC)
        client.create_model("obs-vgg", "IMAGE_CLASSIFICATION", tmp / "obs_vgg.py", "ObsVgg")
        t0 = time.monotonic()
        client.create_train_job("obs", "IMAGE_CLASSIFICATION", TRAIN_URI, EVAL_URI,
                                {"MODEL_TRIAL_COUNT": OBS_TRIALS}, advisor_kind="gp")
        job = client.wait_until_train_job_has_stopped("obs", timeout=900, poll_s=0.5)
        line["train_job_s"] = time.monotonic() - t0
        trials = client.get_trials_of_train_job("obs")
        line["trials"] = [{"no": t["no"], "status": t["status"], "score": t["score"],
                           "learning_rate": t["knobs"]["learning_rate"]} for t in trials]
        if job["status"] != "COMPLETED" or sum(t["status"] == "COMPLETED" for t in trials) < 2:
            fail(f"observability: train job {job['status']}: {line['trials']}")
        t0 = time.monotonic()
        inf = client.create_inference_job("obs", max_models=2)
        x = dataset_utils.load(EVAL_URI).x[:1]
        out = client.predict_via_predictor(inf["predictor_host"], x.tolist())
        line["serve_s"] = time.monotonic() - t0
        if len(out) != 1 or isinstance(out[0], dict):
            fail(f"observability: the query failed: {out}")
        client.stop_inference_job("obs")
    finally:
        stop.set()
        server.join(timeout=120)
        obs.journal.journal.close()  # later phases run unjournaled
        set_config(prev_config)
        for k, v in prev_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if server.is_alive():
        fail("observability: the admin server did not stop")

    # -- read back through the CLI ----------------------------------------------
    records = obs.journal.read_dir(log_dir)
    line["journal_records"] = len(records)
    steps = [r for r in records if (r["kind"], r["name"]) == ("perf", "step")]
    if not steps or any(r.get("steps") is None for r in steps):
        bad.append(f"observability: {len(steps)} perf/step records, "
                   f"{sum(r.get('steps') is None for r in steps)} without steps")
    rows = {r["kind"]: r for r in cli.profile_rows(str(log_dir)) if r["kind"]}
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(["--dir", str(log_dir), "profile"])
    line["profile_text"] = buf.getvalue().splitlines()
    known_card = profiler.card_model(torch.cuda.get_device_name(0)) is not None
    for kind in ("serial", "packed"):
        row = rows.get(kind)
        if row is None:
            bad.append(f"observability: no {kind} program in the profile: {sorted(rows)}")
            continue
        line[kind] = {
            "k": row["k"], "flops_per_step": row["flops"], "steps_per_epoch": row.get("steps"),
            "warm_epoch_p50_s": row.get("step_p50_s"), "epochs": row["epochs"],
            "cold_epochs": row["cold_epochs"], "dtype": row["dtype"],
            "achieved_tflops": (row["achieved_flops_s"] / 1e12
                                if row.get("achieved_flops_s") else None),
            "peak_tflops": (row["peak_flops_basis"] / 1e12
                            if row.get("peak_flops_basis") else None),
            "mfu": row.get("mfu_vs_peak"),
            "cost_capture_s": next((r["cost_capture_s"] for r in records
                                    if r.get("key_hash") == row["key_hash"]
                                    and r["name"] == "cost"), None)}
        if not row["flops"]:
            bad.append(f"observability: the {kind} program's flops are null on the card")
        if known_card and row.get("mfu_vs_peak") is None:
            bad.append(f"observability: the {kind} program has no MFU on a known H100: {row}")
    analytic = vgg_step_flops(16, 1.0, INPUT_SHAPE, NUM_CLASSES, 128)
    line["analytic_flops_per_step"] = analytic
    line["flops_rtol"] = OBS_FLOPS_RTOL
    serial, packed = rows.get("serial", {}), rows.get("packed", {})
    if not serial.get("flops") or abs(serial["flops"] - analytic) > OBS_FLOPS_RTOL * analytic:
        bad.append(f"observability: the serial step counts {serial.get('flops')} flops, the "
                   f"analytic count is {analytic}")
    if not packed.get("flops") or packed["flops"] != OBS_PACK * analytic:
        bad.append(f"observability: the k={OBS_PACK} packed step counts {packed.get('flops')} "
                   f"flops, not {OBS_PACK} x {analytic}")

    # -- one query, one trace ---------------------------------------------------------
    requests = [r for r in records if (r["kind"], r["name"]) == ("serving", "request")]
    tid = requests[-1].get("trace_id") if requests else None
    traced = [r for r in records if tid and r.get("trace_id") == tid]
    pairs = {(r["kind"], r["name"]) for r in traced}
    line["trace"] = {"trace_id": tid, "records": len(traced),
                     "processes": len({(r["role"], r["pid"]) for r in traced}),
                     "missing": [f"{k}/{n}" for k, n in OBS_TRACE_PAIRS if (k, n) not in pairs]}
    if tid is None or line["trace"]["missing"]:
        bad.append(f"observability: the query does not stitch into one trace: {line['trace']}")
    else:
        buf = io.StringIO()
        with redirect_stdout(buf):
            cli.main(["--dir", str(log_dir), "trace", tid])
        line["trace_text"] = buf.getvalue().splitlines()

    # -- the journal's cost of a warm epoch ---------------------------------------
    line["journal_hooks_us_per_epoch"] = _journal_hook_cost_us()
    p50 = serial.get("step_p50_s")
    line["journal_hooks_share_of_warm_epoch"] = (
        line["journal_hooks_us_per_epoch"] * 1e-6 / p50 if p50 else None)
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    line["phase_s"] = time.monotonic() - t_phase
    return line, bad


def observability_phase(card, check) -> None:
    """Phase 19 and its checks (also ``--obs``)."""
    line, bad = observability(card)
    print(json.dumps(line))
    for msg in bad:
        check(False, msg)


# -- fault injection and divergence capsules -------------------------------------
# Phase 20: a k=4 pack of the canonical model (RESUME_SRC: BenchVgg for 3
# epochs) on the canonical task cut to CHAOS_IMAGES images (78 steps an
# epoch at batch 128; shapes, noise and label flips as the canonical
# task's), member 2's gradients NaN-poisoned at step 78 // 2 = 39 of its
# first epoch. The learning rates stay below the 2e-3 at which batch-128
# training collapses (ROADMAP Queue 3).
CHAOS_IMAGES = 10000
CHAOS_URI = TRAIN_URI.replace("n=50000", f"n={CHAOS_IMAGES}")
CHAOS_SPEC = "seed=19;train.nan:nan:times=1:match=@m2"
CHAOS_KNOBS = tuple(dict(RESUME_KNOBS, batch_size=128, dropout=0.0, learning_rate=lr)
                    for lr in (3e-4, 5e-4, 7e-4, 1e-3))
CHAOS_SICK = 2
# An active plane that never fires: the clean step's kernels must stay.
CHAOS_QUIET_SPEC = "seed=19;train.nan:nan:match=@m9"
# A plane that fires at once: the step that multiplies by the column.
CHAOS_LOUD_SPEC = "seed=19;train.nan:nan"
CHAOS_REPLAY_TIMEOUT_S = 300
# A serial trial of the pack's first knobs with dropout on, poisoned at
# once (CHAOS_LOUD_SPEC): its capsule carries a dropout stream to restore.
CHAOS_DROPOUT_KNOBS = dict(CHAOS_KNOBS[0], dropout=0.1)


def _changed_capsule(path, out, what):
    """A copy of the capsule at ``path`` with one part of its pre-epoch
    state changed: every value of the first parameter moved by 1e-3
    (``params``), or the dropout generator reseeded (``generator``). Its
    replay must not reproduce."""
    import pickle

    import torch

    from rafiki_tpu_torch.model.base import GENERATOR_KEY
    from rafiki_tpu_torch.obs.health import capsule
    from rafiki_tpu_torch.utils.serial import dump_flat, load_flat

    doc = capsule.load(path)
    if what == "generator":
        gen = doc[GENERATOR_KEY]
        other = torch.Generator(device=gen["device"]).manual_seed(12345).get_state()
        doc[GENERATOR_KEY] = dict(gen, state=bytes(other.numpy()))
    else:
        flat = load_flat(doc["state_packed"])
        key = next(k for k in sorted(flat) if k.startswith("0/"))
        flat[key] = flat[key] + 1e-3
        doc["state_packed"] = dump_flat(flat, cast_f32_to_bf16=False)
    out.write_bytes(pickle.dumps(doc))
    return out


def _graph_kernel_nodes(graph) -> int:
    """The kernel nodes of a captured CUDA graph, read through libcuda
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``): the kernels a replay of
    the step launches, counted exactly (the profiler's activity records
    can drop some under a long run)."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            fail("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


class _KeptGraphs:
    """Inside ``with _KeptGraphs() as kept:`` every CUDA graph the port
    captures is made with ``keep_graph=True`` and kept in ``kept``, so
    its kernel nodes can be counted (``_graph_kernel_nodes``)."""

    def __enter__(self):
        import torch

        self._real, kept = torch.cuda.CUDAGraph, []

        def keep_graph():
            kept.append(self._real(keep_graph=True))
            return kept[-1]

        torch.cuda.CUDAGraph = keep_graph
        return kept

    def __exit__(self, *exc):
        import torch

        torch.cuda.CUDAGraph = self._real


def _captured_serial_step(card, label, profile=True):
    """The canonical serial step (batch 128, dropout 0.1, lr 1e-3) captured
    over random batches resident on the card, as phase 16's captured path
    runs it, with the poison column its loop's ``train.nan`` site gives
    (None unless a plane fires). Returns the readings (with the captured
    graph's kernel nodes) and the loop."""
    import torch

    from rafiki_tpu_torch.models.vgg import Vgg
    from rafiki_tpu_torch.ops.graphs import GRAPH_WARMUP_STEPS
    from rafiki_tpu_torch.ops.train import ResidentFeed, TrainLoop

    bs = PACK_KNOBS["batch_size"]
    win = _StepWindow(GRAPH_WARMUP_STEPS + 1, profile=profile)
    model = Vgg(**dict(PACK_KNOBS, learning_rate=1e-3, dropout=0.1))
    model._planned_steps = 50000 // bs
    f = model._loop_fns(NUM_CLASSES, INPUT_SHAPE)
    loop = TrainLoop(f["init_fn"], f["apply_eval"], f["loss_fn"], f["optimizer"],
                     hyper=f["hyper"], program_key=("chip_smoke", "graph_step"))
    n = win.n_steps * bs
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.rand((n,) + INPUT_SHAPE, device="cuda", generator=g)
    Y = torch.randint(0, NUM_CLASSES, (n,), device="cuda", generator=g)
    rows = torch.randperm(n, device="cuda", generator=g).reshape(win.n_steps, bs)
    poison = loop._chaos_poison(win.n_steps)
    with _KeptGraphs() as kept:
        loop.state, _ = loop.program.train_steps(loop.state, ResidentFeed(X, Y, rows),
                                                 on_step=win, poison=poison)
    readings = (win.readings(bs, card, label) if profile
                else {"phase": label, "event_ms_per_step": win.event_ms})
    readings["poisoned"] = poison is not None
    readings["graph_kernel_nodes"] = _graph_kernel_nodes(kept[0])
    return readings, loop


def chaos(card, phase16_nodes=None):
    """Phase 20 (and ``--chaos``): the NaN-poisoned pack contained, its
    capsule replayed in a fresh process, the clean step's kernels, and
    the six in-process chaos scenarios. Returns the phase's line and its
    failures."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from rafiki_tpu_torch import chaos as chaos_plane
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.chaos.runner import format_report, run_scenarios
    from rafiki_tpu_torch.chaos.scenarios import SCENARIOS, SUBPROCESS_SCENARIOS
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.model.knobs import knob_config_signature
    from rafiki_tpu_torch.obs.health import DivergenceError, capsule
    from rafiki_tpu_torch.obs.journal import journal, read_dir
    from rafiki_tpu_torch.store import MetaStore, ParamsStore
    from rafiki_tpu_torch.worker.train import PackedTrialRunner, TrainWorker

    t_phase = time.monotonic()
    line = {"phase": "chaos", "card": card[1], "power_limit": card[2], "spec": CHAOS_SPEC,
            "knobs": list(CHAOS_KNOBS), "train_uri": CHAOS_URI,
            "cut": f"task images {CHAOS_IMAGES} of the canonical 50000"}
    bad = []
    tmp = Path(tempfile.mkdtemp(prefix="rafiki-chaos-"))
    log_dir = tmp / "log"
    saved_env = {k: os.environ.get(k) for k in ("RAFIKI_CHAOS", "RAFIKI_TPU_SERVING_PARAMS_DTYPE")}
    # Float32 blobs: the survivors' stored params are compared byte for byte.
    os.environ["RAFIKI_TPU_SERVING_PARAMS_DTYPE"] = "float32"
    take, write = capsule.DeviceSnapshot.take, capsule.write
    snapshot_ms, write_s = [], []

    def timed_take(self, state):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        take(self, state)
        end.record()
        end.synchronize()
        snapshot_ms.append(start.elapsed_time(end))

    def timed_write(*args, **kwargs):
        t0 = time.monotonic()
        try:
            return write(*args, **kwargs)
        finally:
            write_s.append(time.monotonic() - t0)

    capsule.DeviceSnapshot.take, capsule.write = timed_take, timed_write
    try:
        # -- 1. the poisoned pack ------------------------------------------------
        journal.configure(log_dir, role="chaos")
        store, params = MetaStore(tmp / "meta.sqlite3"), ParamsStore(tmp / "params")
        model_row = store.create_model("bench-vgg-3", "IMAGE_CLASSIFICATION", None, RESUME_SRC,
                                       "BenchVgg")
        job = store.create_train_job("chaos", "IMAGE_CLASSIFICATION", None, CHAOS_URI, EVAL_URI,
                                     {"MODEL_TRIAL_COUNT": len(CHAOS_KNOBS)})
        sub = store.create_sub_train_job(job["id"], model_row["id"])
        cls = load_model_class(RESUME_SRC, "BenchVgg")
        worker = TrainWorker(store, params, sub["id"], cls, _FixedAdvisor(CHAOS_KNOBS), CHAOS_URI,
                             EVAL_URI, {"MODEL_TRIAL_COUNT": len(CHAOS_KNOBS)},
                             worker_id="chaos-w0", async_persist=False)
        rows = []
        for kn in CHAOS_KNOBS:
            t = store.create_trial(sub["id"], "BenchVgg", kn, budget_max=len(CHAOS_KNOBS),
                                   shape_sig=knob_config_signature(cls.get_knob_config(), kn))
            rows.append((t["id"], kn))
        os.environ["RAFIKI_CHAOS"] = CHAOS_SPEC
        plane = chaos_plane.reset_from_env()
        telemetry.reset()  # the health counters read from zero
        graphs = _graph_counters()
        t0 = time.monotonic()
        try:
            carried = PackedTrialRunner(worker, len(CHAOS_KNOBS)).run_assigned(
                rows, budget_max=len(CHAOS_KNOBS))
        finally:
            pack_s = _synced_s(t0)
            fired = plane.schedule()
            os.environ.pop("RAFIKI_CHAOS", None)
            chaos_plane.reset_from_env()
        counters = telemetry.snapshot()["counters"]
        trials = {t["id"]: t for t in store.get_trials_of_train_job(job["id"])}
        status = [trials[tid]["status"] for tid, _ in rows]
        # The references below run unjournaled: no snapshot, no capsule.
        journal.close()
        recs = read_dir(log_dir)
        div = [r for r in recs if r["kind"] == "health" and r["name"] == "divergence"]
        caps = [r for r in recs if r["kind"] == "health" and r["name"] == "capsule"]
        cap_path = div[0].get("capsule") if div else None
        line.update({
            "pack_s": pack_s, "rows_carried": carried, "fired": [list(f) for f in fired],
            "status": status, "scores": [trials[tid]["score"] for tid, _ in rows],
            "sick_error": (trials[rows[CHAOS_SICK][0]]["error"] or "")[:200],
            "divergence": {k: div[0].get(k) for k in ("member", "bad_step", "divergence",
                                                       "nonfinite", "badput_s")} if div else None,
            "health_counters": {k: counters.get(f"health.{k}", 0.0)
                                for k in ("divergences", "contained", "evictions", "capsules")},
            "snapshot_device_ms_per_epoch": list(snapshot_ms),
            "capsule_bytes": os.path.getsize(cap_path) if cap_path else None,
            "capsule_write_s": write_s,
        })
        if not (len(fired) == 1 and fired[0][0] == "train.nan" and "@m2" in fired[0][3]):
            bad.append(f"chaos: the train.nan fault fired {fired}, want once for @m2")
        if carried != len(CHAOS_KNOBS) or len(trials) != len(CHAOS_KNOBS):
            bad.append(f"chaos: {carried} rows carried, {len(trials)} rows, want "
                       f"{len(CHAOS_KNOBS)} each")
        want = ["COMPLETED"] * len(CHAOS_KNOBS)
        want[CHAOS_SICK] = "ERRORED"
        if status != want or "diverged" not in line["sick_error"]:
            bad.append(f"chaos: statuses {status}, want {want}; member {CHAOS_SICK}'s error "
                       f"{line['sick_error']!r}")
        survivors = [i for i in range(len(CHAOS_KNOBS)) if i != CHAOS_SICK]
        if any(trials[rows[i][0]]["score"] is None for i in survivors):
            bad.append(f"chaos: a survivor has no score: {line['scores']}")
        if min(line["health_counters"][k] for k in ("divergences", "contained", "evictions")) < 1:
            bad.append(f"chaos: health counters {line['health_counters']}")
        if not div or not caps or not cap_path:
            bad.append(f"chaos: journal holds {len(div)} health/divergence and {len(caps)} "
                       f"health/capsule records, capsule {cap_path}")
        # The survivors against unfaulted serial runs of their knobs on the card.
        t0 = time.monotonic()
        equal = []
        for i in survivors:
            ref = cls(**CHAOS_KNOBS[i])
            ref.train(CHAOS_URI)
            blob = ref.dump_parameters()
            ref.destroy()
            equal.append(params.load(trials[rows[i][0]]["params_id"]) == blob)
        line["serial_references_s"] = _synced_s(t0)
        line["survivors_params_byte_equal"] = equal
        if not all(equal):
            bad.append(f"chaos: survivors' params against their serial runs: {equal}")
        store.close()

        # -- 2. the replay, in a fresh process on the card -------------------------
        if cap_path:
            env = {k: v for k, v in os.environ.items() if k != "RAFIKI_CHAOS"}
            t0 = time.monotonic()
            out = subprocess.run([sys.executable, "-m", "rafiki_tpu_torch.obs", "replay", cap_path,
                                  "--json"], cwd=os.path.dirname(os.path.abspath(__file__)),
                                 env=env, capture_output=True, text=True,
                                 timeout=CHAOS_REPLAY_TIMEOUT_S)
            line["replay_s"] = time.monotonic() - t0
            line["replay_rc"] = out.returncode
            try:
                verdict = json.loads(out.stdout.strip().splitlines()[-1])
            except (ValueError, IndexError):
                verdict = None
                bad.append(f"chaos: replay printed no verdict: rc {out.returncode} "
                           f"{out.stdout[-500:]} {out.stderr[-2000:]}")
            if verdict is not None:
                line["replay"] = {k: verdict.get(k) for k in (
                    "reproduced", "poisoned", "steps_replayed", "bad_step", "member",
                    "mismatches", "captured_env", "replay_env")}
                line["replay"]["bad_loss"] = (verdict.get("comparisons") or {}).get(
                    "health_bad_loss")
                bad_step = line["divergence"]["bad_step"] if line["divergence"] else None
                if not (out.returncode == 0 and verdict["reproduced"] and verdict["poisoned"]
                        and verdict["steps_replayed"] == (bad_step or 0) + 1
                        and bad_step == (CHAOS_IMAGES // 128) // 2):
                    bad.append(f"chaos: replay rc {out.returncode}: {line['replay']}")
                if verdict["captured_env"] != verdict["replay_env"]:
                    bad.append(f"chaos: replay env {verdict['replay_env']} is not the capture "
                               f"env {verdict['captured_env']}")
                if not (verdict.get("comparisons") or {}).get("health_bad_loss", {}).get("match"):
                    bad.append(f"chaos: the replay's loss at the bad step: "
                               f"{(verdict.get('comparisons') or {}).get('health_bad_loss')}")
            # The replay re-ran the member's prefix: the capsule with its
            # pre-epoch params moved does not reproduce (here, on the card).
            changed = capsule.replay(_changed_capsule(cap_path, tmp / "params.rcap", "params"),
                                     device="cuda")
            line["changed_params_replay"] = {k: changed[k] for k in ("reproduced", "mismatches")}
            if changed["reproduced"] or changed["mismatches"] != ["health_bad_loss"]:
                bad.append(f"chaos: a capsule with changed params replayed "
                           f"{line['changed_params_replay']}")

        # -- 2b. a serial trial with dropout: the generator's state replays too ------
        journal.configure(log_dir, role="chaos")
        chaos_plane.install(chaos_plane.FaultPlane.from_spec(CHAOS_LOUD_SPEC))
        verdict = None
        t0 = time.monotonic()
        try:
            cls(**CHAOS_DROPOUT_KNOBS).train(CHAOS_URI)
        except DivergenceError as e:
            verdict = e.verdict
        finally:
            chaos_plane.uninstall()
            journal.close()
            torch.cuda.empty_cache()
        dropout_cap = (verdict or {}).get("capsule")
        line["dropout_trial"] = {"knobs": CHAOS_DROPOUT_KNOBS, "s": time.monotonic() - t0,
                                 "bad_step": (verdict or {}).get("bad_step")}
        if not dropout_cap:
            bad.append(f"chaos: the dropout trial banked no capsule: {verdict}")
        else:
            same = capsule.replay(dropout_cap, device="cuda")
            other = capsule.replay(_changed_capsule(dropout_cap, tmp / "generator.rcap",
                                                    "generator"), device="cuda")
            line["dropout_trial"].update({
                "replay": {k: same[k] for k in ("reproduced", "mismatches", "steps_replayed")},
                "changed_generator_replay": {k: other[k] for k in ("reproduced", "mismatches")}})
            if not same["reproduced"] or other["reproduced"] \
                    or other["mismatches"] != ["health_bad_loss"]:
                bad.append(f"chaos: the dropout trial's capsule: {line['dropout_trial']}")

        # -- 3. clean steps keep their kernels ---------------------------------------
        torch.cuda.empty_cache()
        plain, loop = _captured_serial_step(card, "clean_step_no_plane")
        del loop
        journal.configure(log_dir, role="chaos")  # capsules on: snapshots are taken
        chaos_plane.install(chaos_plane.FaultPlane.from_spec(CHAOS_QUIET_SPEC))
        try:
            quiet, loop = _captured_serial_step(card, "clean_step_quiet_plane")
            loop.health.snapshot_state(loop.state)  # the buffers' allocation
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loop.health.snapshot_state(loop.state)
            end.record()
            end.synchronize()
            line["serial_snapshot_device_ms"] = start.elapsed_time(end)
            del loop
        finally:
            chaos_plane.uninstall()
            journal.close()
        chaos_plane.install(chaos_plane.FaultPlane.from_spec(CHAOS_LOUD_SPEC))
        try:
            loud, loop = _captured_serial_step(card, "poisoned_step", profile=False)
            del loop
        finally:
            chaos_plane.uninstall()
        line["clean_step"] = {"no_plane": plain, "quiet_plane": quiet, "poisoned": loud,
                              "phase16_graph_kernel_nodes": phase16_nodes}
        nodes = [r["graph_kernel_nodes"] for r in (plain, quiet, loud)]
        # The gate counts the captured graph's kernel nodes, which drop no
        # record (the profiler's kernels a step are printed beside them).
        want_nodes = nodes[0] if phase16_nodes is None else phase16_nodes
        if nodes[0] != want_nodes or nodes[1] != want_nodes or plain["poisoned"] \
                or quiet["poisoned"]:
            bad.append(f"chaos: the clean captured step's kernel nodes {nodes[:2]} (no plane, "
                       f"quiet plane) against phase 16's {phase16_nodes}, poisoned "
                       f"{plain['poisoned']}, {quiet['poisoned']}")
        if not (loud["poisoned"] and nodes[2] > nodes[0]):
            bad.append(f"chaos: the poisoned step's graph ({nodes[2]} kernel nodes, poisoned "
                       f"{loud['poisoned']}) does not show the multiply against {nodes[0]}")
        torch.cuda.empty_cache()
    finally:
        capsule.DeviceSnapshot.take, capsule.write = take, write
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        journal.close()
        shutil.rmtree(tmp, ignore_errors=True)
    line.update(_graph_since(graphs))

    # -- 4. the six in-process scenarios, with the card visible ----------------------
    t0 = time.monotonic()
    reports = run_scenarios(sorted(set(SCENARIOS) - SUBPROCESS_SCENARIOS - MESH_SCENARIOS),
                            device="cuda")
    line["scenarios_s"] = time.monotonic() - t0
    line["scenarios"] = {r.name: {"passed": r.passed, "s": r.duration_s,
                                  "fired": len(r.schedule)} for r in reports}
    for r in reports:
        if not r.passed:
            bad.append(f"chaos: scenario failed:\n{format_report(r)}")
    line["phase_s"] = time.monotonic() - t_phase
    return line, bad


def chaos_phase(card, check, phase16_nodes=None) -> None:
    """Phase 20 and its checks (also ``--chaos``, which runs no phase 16
    and so has no node count to hold the clean step to)."""
    line, bad = chaos(card, phase16_nodes)
    print(json.dumps(line))
    for msg in bad:
        check(False, msg)


# -- phase 21: process workers and within-trial data parallelism ----------------
# (a) phase 6's job through the ProcessScheduler: one subprocess worker under
# CUDA_VISIBLE_DEVICES=0, the GP advisor over loopback HTTP; PROC_TUNE_TRIALS
# trials (TUNE_TRIALS until phase 23 needed the time), the GP warmed up on
# PROC_ADVISOR's 2 proposals, so its last comes from expected improvement.
# (b) kill-mid-pack-resume at the canonical model: a k=PROC_KILL_K pack of
# PROC_PACK_SRC trials on PROC_CUT_URI, 3 epochs, the worker SIGKILLed after
# epoch 1 (the JAX package's spec and env, its k=4 pack cut to 2 members),
# its members resumed by the -r1 worker from their slice checkpoints; params
# stored in float32 and compared byte for byte with unfaulted serial runs of
# the same knobs.
# (c) the canonical trial (TRAIN_KNOBS, two epochs on PROC_CUT_URI) on a
# one-rank NCCL dp mesh against the same trial with no mesh: the params byte
# for byte, and the warm epoch's ms a step of each path (the dp step runs
# eagerly).
# (b) and (c) ran a 4-member pack on PROC_URI until phase 26 needed the time.
PROC_TUNE_TRIALS = 3
PROC_ADVISOR = {"n_initial": 2}
PROC_IMAGES = 10000
PROC_URI = TRAIN_URI.replace("n=50000", f"n={PROC_IMAGES}")
PROC_CUT_IMAGES = 5000
PROC_CUT_URI = TRAIN_URI.replace("n=50000", f"n={PROC_CUT_IMAGES}")
PROC_KILL_K = 2
PROC_KILL_SPEC = "seed=7;worker.epoch:kill:after=1:times=1:unless=-r"
PROC_KILL_ENV = {"RAFIKI_CHECKPOINT_EVERY": "1", "RAFIKI_TRIAL_PACK": str(PROC_KILL_K),
                 "RAFIKI_WORKER_MAX_RESTARTS": "3", "RAFIKI_WORKER_RESTART_BACKOFF_S": "0.2",
                 "RAFIKI_TPU_SERVING_PARAMS_DTYPE": "float32"}
# The canonical model at one packing key (batch 128, three epochs), the
# learning rate below the canonical job's collapse (ROADMAP Queue 3).
PROC_PACK_SRC = (BENCH_SRC.replace(b"class BenchVgg(Vgg):", b"class ProcPackVgg(Vgg):")
                 .replace(b"BenchVgg.", b"ProcPackVgg.")
                 .replace(b'"epochs": FixedKnob(1)', b'"epochs": FixedKnob(3)')
                 .replace(b'"batch_size": CategoricalKnob([64, 128, 256], affects_shape=True)',
                          b'"batch_size": FixedKnob(128)')
                 .replace(b'"learning_rate": FloatKnob(1e-4, 3e-2, is_exp=True)',
                          b'"learning_rate": FloatKnob(1e-4, 2e-3, is_exp=True)')
                 .replace(b'"dropout": FloatKnob(0.0, 0.5)', b'"dropout": FloatKnob(0.0, 0.3)'))
PROC_DP_KNOBS = dict(TRAIN_KNOBS, epochs=2)


def _proc_job(tmp, src, name, trials, uri=TRAIN_URI):
    from rafiki_tpu_torch.store import MetaStore, ParamsStore

    store, params = MetaStore(f"{tmp}/meta.sqlite3"), ParamsStore(f"{tmp}/params")
    model = store.create_model(name.lower(), "IMAGE_CLASSIFICATION", None, src, name)
    job = store.create_train_job("proc", "IMAGE_CLASSIFICATION", None, uri, EVAL_URI,
                                 {"MODEL_TRIAL_COUNT": trials})
    store.create_sub_train_job(job["id"], model["id"])
    return store, params, job


def process_tune_job(card):
    """Phase 21 (a): the canonical GP job in a subprocess worker."""
    import shutil
    import tempfile

    import torch

    from rafiki_tpu_torch.advisor import AdvisorService
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.scheduler import ProcessScheduler
    from rafiki_tpu_torch.utils.events import events

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="rafiki-proc-")
    try:
        torch.cuda.empty_cache()
        # The worker's own record of the device it resolved (worker/main.py).
        events.configure(f"{tmp}/logs")
        store, params, job = _proc_job(tmp, BENCH_SRC, "BenchVgg", PROC_TUNE_TRIALS)
        # The sub job's GP, made with PROC_ADVISOR before the job runs (the
        # scheduler adopts the sub job's advisor id).
        advisors = AdvisorService()
        sub = store.get_sub_train_jobs(job["id"])[0]
        aid = advisors.create_advisor(load_model_class(BENCH_SRC, "BenchVgg").get_knob_config(),
                                      kind="gp", engine_kwargs=PROC_ADVISOR)
        store.update_sub_train_job(sub["id"], advisor_id=aid)
        t0 = time.monotonic()
        result = ProcessScheduler(store, params, advisor_service=advisors).run_train_job(
            job["id"], n_workers=1, devices_per_trial=1, advisor_kind="gp", poll_s=0.2)
        wall = time.monotonic() - t0
        services = store.get_services_of_job(job["id"])
        resolved = [[e["device"], e["device_name"]] for e in events.read("worker_device")]
        best = [dict(t, blob=params.load(t["params_id"])) for t in result.best_trials]
    finally:
        events.close()
        shutil.rmtree(tmp, ignore_errors=True)
    done = [t for t in result.trials if t["status"] == "COMPLETED"]
    first_claim = min((t["created_at"] for t in result.trials), default=None)
    line = {"phase": "process_job", "card": card[1], "power_limit": card[2],
            "status": result.status, "trials": len(result.trials), "completed": len(done),
            "with_params": sum(bool(t["params_id"]) for t in done),
            "job_wall_s": wall, "completed_trials_per_hour": 3600.0 * len(done) / wall,
            "spawn_to_first_claim_s": (first_claim - services[0]["created_at"]
                                       if first_claim is not None and services else None),
            "worker_devices": [json.loads(s["devices"]) for s in services],
            "worker_resolved_devices": resolved,
            "worker_ids": sorted({t["worker_id"] for t in result.trials}),
            "best_score": max((t["score"] for t in done), default=None),
            "top1_target": TUNE_TOP1_TARGET, "errors": result.errors}
    served = served_accuracy(best, card) if len(best) == 2 else None
    line["served_abs_diff"] = None if served is None else served["abs_diff"]
    line["phase_s"] = time.monotonic() - t_phase
    return line


def process_kill_pack(card):
    """Phase 21 (b): kill-mid-pack-resume at the canonical model."""
    import os
    import pickle
    import shutil
    import tempfile

    import torch

    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.scheduler import ProcessScheduler
    from rafiki_tpu_torch.utils.events import events
    from rafiki_tpu_torch.utils.serial import load_flat

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="rafiki-prockill-")
    env = dict(PROC_KILL_ENV, RAFIKI_CHAOS=PROC_KILL_SPEC)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        torch.cuda.empty_cache()
        events.configure(f"{tmp}/logs")
        store, params, job = _proc_job(tmp, PROC_PACK_SRC, "ProcPackVgg", PROC_KILL_K,
                                       PROC_CUT_URI)
        t0, w0 = time.monotonic(), time.time()
        result = ProcessScheduler(store, params).run_train_job(
            job["id"], n_workers=1, advisor_kind="random", poll_s=0.2)
        wall = time.monotonic() - t0
        # Where the job's wall goes: every event of the job's processes,
        # seconds from its start.
        timeline = [[e["event"], round(e["time"] - w0, 3)] for e in events.read()][:80]
        trials = store.get_trials_of_train_job(job["id"])
        blobs = {t["id"]: params.load(t["params_id"]) for t in trials if t["params_id"]}
        left = [t["id"] for t in trials if params.latest_checkpoint(t["id"]) is not None]
        resumed = {e["trial_id"]: e["from_epoch"] for e in events.read("trial_resumed")}
        died = [e for e in events.read("worker_died")]
        # Unfaulted serial runs of the same knobs, in this process.
        for k in ("RAFIKI_CHAOS", "RAFIKI_CHECKPOINT_EVERY", "RAFIKI_TRIAL_PACK"):
            os.environ.pop(k, None)
        cls = load_model_class(PROC_PACK_SRC, "ProcPackVgg")
        equal = []
        t_ref = time.monotonic()
        for t in trials:
            m = cls(**t["knobs"])
            m.train(PROC_CUT_URI)
            want = load_flat(pickle.loads(m.dump_parameters())["packed"])
            m.destroy()
            got = (load_flat(pickle.loads(blobs[t["id"]])["packed"]) if t["id"] in blobs
                   else {})
            equal.append(set(got) == set(want) and all(
                got[k].dtype == torch.float32 and torch.equal(got[k], want[k]) for k in want))
        ref_s = _synced_s(t_ref)
    finally:
        events.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "process_kill_pack", "card": card[1], "power_limit": card[2],
            "status": result.status, "trials": len(trials),
            "trial_status": [t["status"] for t in trials],
            "worker_ids": [t["worker_id"] for t in trials],
            "resumed_from_epoch": [resumed.get(t["id"]) for t in trials],
            "worker_deaths": len(died), "checkpoints_left": len(left),
            "params_byte_equal": equal, "job_wall_s": wall, "serial_reference_s": ref_s,
            "timeline": timeline, "errors": result.errors,
            "phase_s": time.monotonic() - t_phase}


def process_dp_width1(card):
    """Phase 21 (c): the canonical trial on a one-rank NCCL dp mesh
    against the trial with no mesh. Each path's epoch 0 is cold and its
    epoch 1 is timed (host wall and CUDA events, from the end of epoch 0
    to the end of epoch 1, through the per-epoch checkpoint hook). Then
    the dp trial runs steps as its epochs run them (``HostFeed`` over
    the model's dataset, the loop's plan, ``train_steps``) under a
    ``_StepWindow``: CUDA events over PROFILE_ITERS steps, then
    ``torch.profiler`` over half as many (``_analyze_profile``:
    device busy ms, idle share and the ms under each step range,
    ``train.all_reduce`` and ``train.feed`` included). Phase 16 profiles
    the captured step without a mesh."""
    import datetime
    import socket

    import torch
    import torch.distributed as dist

    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.models.vgg import Vgg
    from rafiki_tpu_torch.ops.train import HostFeed
    from rafiki_tpu_torch.parallel.mesh import data_parallel_mesh

    t_phase = time.monotonic()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=120),
                            device_id=torch.device("cuda", 0))
    steps = dataset_utils.load(PROC_CUT_URI).size // PROC_DP_KNOBS["batch_size"]
    out = {}
    try:
        mesh = data_parallel_mesh([torch.device("cuda", 0)])
        for label, m_mesh in (("no_mesh", None), ("nccl_width1", mesh)):
            telemetry.reset()
            m = Vgg(**PROC_DP_KNOBS)
            m.set_mesh(m_mesh)
            seen = {}

            def at_epoch_end(epoch, _make_blob, seen=seen):
                if epoch == 0:
                    torch.cuda.synchronize()
                    seen["t0"] = time.perf_counter()
                    seen["ev0"] = torch.cuda.Event(enable_timing=True)
                    seen["ev0"].record()
                elif epoch == 1:
                    ev1 = torch.cuda.Event(enable_timing=True)
                    ev1.record()
                    ev1.synchronize()
                    seen["wall_ms"] = (time.perf_counter() - seen["t0"]) / steps * 1e3
                    seen["event_ms"] = seen["ev0"].elapsed_time(ev1) / steps

            m.set_checkpoint_sink(at_epoch_end)
            m.train(PROC_CUT_URI)
            torch.cuda.synchronize()
            snap = telemetry.snapshot()
            out[label] = {
                "params": {k: v.detach().cpu().clone() for k, v in m._module.state_dict().items()},
                "step_ms": seen["wall_ms"], "event_ms": seen["event_ms"],
                "graph_replays": snap["counters"].get("train.graph_replays", 0.0),
                "program_key_mesh": m._loop._perf_key[1]}
            if m_mesh is not None:
                loop, bs = m._loop, PROC_DP_KNOBS["batch_size"]
                win = _StepWindow(1, profile_iters=PROFILE_ITERS // 2)
                feed = HostFeed(m._prepared_dataset(PROC_CUT_URI).batches(
                    bs, shuffle=True, seed=PROC_DP_KNOBS["epochs"], drop_remainder=True),
                    win.n_steps, loop.device, loop.plan)
                loop.state, _ = loop.program.train_steps(loop.state, feed, on_step=win,
                                                         plan=loop.plan)
                out[label]["profile"] = win.readings(bs, card, f"process_dp_{label}")
            m.destroy()
    finally:
        dist.destroy_process_group()
    a, b = out["no_mesh"], out["nccl_width1"]
    equal = set(a["params"]) == set(b["params"]) and all(
        torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    return {"phase": "process_dp_width1", "card": card[1], "power_limit": card[2],
            "steps_per_epoch": steps, "params_byte_equal": equal,
            "no_mesh_step_ms": a["step_ms"], "nccl_width1_step_ms": b["step_ms"],
            "no_mesh_event_ms": a["event_ms"], "nccl_width1_event_ms": b["event_ms"],
            "nccl_width1_profile": b["profile"],
            "no_mesh_graph_replays": a["graph_replays"],
            "nccl_width1_graph_replays": b["graph_replays"],
            "nccl_program_key_mesh": b["program_key_mesh"],
            "phase_s": time.monotonic() - t_phase}


def process_phase(card, check) -> None:
    """Phase 21 and its checks (also ``--process``)."""
    t0 = time.monotonic()
    job = process_tune_job(card)
    print(json.dumps(job))
    check(job["status"] == "COMPLETED" and job["completed"] == PROC_TUNE_TRIALS
          and job["with_params"] == PROC_TUNE_TRIALS and not job["errors"],
          f"process job: {job['status']}, {job['completed']} completed, "
          f"{job['with_params']} with params, errors {job['errors']}")
    import torch

    name = torch.cuda.get_device_name(0)
    check(job["worker_resolved_devices"] == [["cuda:0", name]],
          f"process job: the worker resolved {job['worker_resolved_devices']}, "
          f"not cuda:0 on {name}")
    check(job["best_score"] is not None and job["best_score"] >= TUNE_TOP1_TARGET,
          f"process job: best score {job['best_score']} < {TUNE_TOP1_TARGET}")
    check(job["served_abs_diff"] is not None and max(job["served_abs_diff"]) <= SERVED_ACC_ATOL,
          f"process job: the best trials' served accuracy against their stored scores: "
          f"{job['served_abs_diff']}")
    kill = process_kill_pack(card)
    print(json.dumps(kill))
    check(kill["status"] == "COMPLETED" and kill["trial_status"] == ["COMPLETED"] * PROC_KILL_K,
          f"process kill: job {kill['status']}, trials {kill['trial_status']}, "
          f"errors {kill['errors']}")
    check(kill["worker_deaths"] >= 1 and all("-r1" in (w or "") for w in kill["worker_ids"]),
          f"process kill: deaths {kill['worker_deaths']}, worker ids {kill['worker_ids']}")
    check(all(e is not None and e >= 1 for e in kill["resumed_from_epoch"]),
          f"process kill: resumed from {kill['resumed_from_epoch']}")
    check(all(kill["params_byte_equal"]) and kill["checkpoints_left"] == 0,
          f"process kill: params against serial runs {kill['params_byte_equal']}, "
          f"checkpoints left {kill['checkpoints_left']}")
    dp = process_dp_width1(card)
    print(json.dumps(dp))
    check(dp["params_byte_equal"], "process dp: the width-1 NCCL trial's params differ from "
                                   "the trial with no mesh")
    check(dp["nccl_width1_graph_replays"] == 0 and dp["no_mesh_graph_replays"] > 0,
          f"process dp: replays {dp['no_mesh_graph_replays']} without a mesh, "
          f"{dp['nccl_width1_graph_replays']} on it (the dp step runs eagerly)")
    parts = dp["nccl_width1_profile"]["per_part"]
    check("all_reduce" in parts and "feed" in parts,
          f"process dp: the profiled dp epoch ran no all-reduce or host feed range: "
          f"{sorted(parts)}")
    print(json.dumps({"phase": "process", "card": card[1], "power_limit": card[2],
                      "phase_s": time.monotonic() - t0}))



# -- phase 22: the mesh sweep, its write-ahead log and resume, the sharded lane ----
# The in-process mesh scenarios: phase 22 drives two of them at the
# canonical sizes itself, and mesh-degrades-single-chip (like
# host-loss-mid-sweep) runs in the CPU tests only, so phase 20 leaves
# them out.
MESH_SCENARIOS = frozenset({"mesh-chip-loss-repack", "chip-loss-mid-sharded-trial",
                            "mesh-degrades-single-chip"})
MESH_TRIALS = 8
MESH_K = 4
# (a)'s training twin (``obs/twin/train``): ``validate`` of the sweep's
# journal at the JAX package's tolerance (its ``DEFAULT_TOLERANCE`` and
# its smoke's, ``scripts/train_twin_smoke.py``), and the doctored bundle
# of that smoke, which must fail it.
TWIN_TOLERANCE = 0.25
TWIN_DOCTORED = {"step": 2.0, "compile": 2.0}
# (a) PROC_PACK_SRC's canonical trial at two epochs; a member at dropout
# 0.2 or more stops after its first epoch (the JAX package's EvictFF
# straggler rule), so the pack evicts it and backfills its slot with a
# fresh proposal: the GP's seed-0 draws make that four backfills, which
# drain the 8-trial budget (two k=4 packs' worth of trials).
MESH_SRC = (PROC_PACK_SRC.replace(b"class ProcPackVgg(Vgg):", b"class MeshVgg(Vgg):")
            .replace(b"ProcPackVgg.", b"MeshVgg.")
            .replace(b'"epochs": FixedKnob(3)', b'"epochs": FixedKnob(2)')
            + b'''
    def should_stop_early(self, epoch, metrics):
        return epoch == 0 and float(self.knobs["dropout"]) >= 0.2
''')
# (c) the zoo Transformer at the widest point of its knob space (phase
# 18's), 3 epochs of 10,000 sequences of 128 tokens (156 steps an epoch).
MESH_TF_SRC = b'''
from rafiki_tpu_torch.model.knobs import FixedKnob
from rafiki_tpu_torch.models.transformer import Transformer


class MeshTf(Transformer):
    @staticmethod
    def get_knob_config():
        return {
            "embed_dim": FixedKnob(128),
            "num_heads": FixedKnob(4),
            "num_layers": FixedKnob(2),
            "learning_rate": FixedKnob(1e-3),
            "batch_size": FixedKnob(64),
            "epochs": FixedKnob(3),
            "seed": FixedKnob(0),
        }
'''
MESH_TEXT_URI = TEXT_TRAIN_URI.replace("n=50000", "n=10000")
MESH_TEXT_EVAL_URI = TEXT_EVAL_URI.replace("n=10000", "n=2000")


def _mesh_device():
    """Phase 22's card: every chip and group member shares it."""
    import torch

    return torch.device("cuda", 0)


class _Env:
    """Environment variables set for a block, then restored."""

    def __init__(self, values):
        self.values = values

    def __enter__(self):
        import os

        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _mesh_job(tmp, src, name, budget, train_uri=None, eval_uri=None,
              task="IMAGE_CLASSIFICATION"):
    from rafiki_tpu_torch.store import MetaStore, ParamsStore

    import os

    os.makedirs(tmp, exist_ok=True)
    train_uri, eval_uri = train_uri or PROC_URI, eval_uri or EVAL_URI
    store, params = MetaStore(f"{tmp}/meta.sqlite3"), ParamsStore(f"{tmp}/params")
    model = store.create_model(name.lower(), task, None, src, name)
    job = store.create_train_job("mesh", task, None, train_uri, eval_uri,
                                 {"MODEL_TRIAL_COUNT": budget})
    store.create_sub_train_job(job["id"], model["id"])
    return store, params, job


def _f32_leaves(blob):
    import pickle

    from rafiki_tpu_torch.utils.serial import load_flat

    return load_flat(pickle.loads(blob)["packed"])


def _byte_equal(a, b) -> bool:
    import torch

    return set(a) == set(b) and all(
        a[k].dtype == torch.float32 and torch.equal(a[k], b[k]) for k in b)


def _serial_leaves(cls, knobs, uri):
    """An unfaulted serial trial of ``knobs`` on the card: its float32
    params blob's leaves."""
    m = cls(**knobs)
    m.train(uri)
    out = _f32_leaves(m.dump_parameters())
    m.destroy()
    return out


def _wal_verdict(store, job_id):
    from rafiki_tpu_torch.scheduler.wal import read_wal, reconcile, wal_path

    recs = read_wal(wal_path(store.path, job_id))
    out = {}
    for sub in store.get_sub_train_jobs(job_id):
        r = reconcile(recs, store.get_trials_of_sub_train_job(sub["id"]), sub=sub,
                      sub_id=sub["id"])
        out = {"ok": r.ok, "errors": r.errors, "claims": len(r.claims),
               "double_claims": sum(1 for n in r.claims.values() if n != 1),
               "claimed": sub.get("claimed"),
               "rows": len(store.get_trials_of_sub_train_job(sub["id"]))}
    return recs, out


def mesh_sweep(card, twin_dir):
    """Phase 22 (a): the canonical sweep, chips=1 x k=4, 8 GP trials, the
    port's journal open in ``twin_dir`` while it runs."""
    import shutil
    import tempfile

    import torch

    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.obs.journal import journal
    from rafiki_tpu_torch.scheduler import MeshSweepScheduler

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="rafiki-mesh-")
    try:
        with _Env({"RAFIKI_TPU_SERVING_PARAMS_DTYPE": "float32"}):
            torch.cuda.empty_cache()
            telemetry.reset()
            store, params, job = _mesh_job(tmp, MESH_SRC, "MeshVgg", MESH_TRIALS)
            journal.configure(twin_dir, role="mesh-sweep")
            try:
                t0 = time.monotonic()
                result = MeshSweepScheduler(store, params).run_sweep(
                    job["id"], chips=1, trials_per_chip=MESH_K, advisor_kind="gp",
                    devices=[_mesh_device()])
                wall = _synced_s(t0)
            finally:
                journal.close()
            graphs = _graph_counters()
            snap = telemetry.snapshot()["counters"]
            trials = store.get_trials_of_train_job(job["id"])
            _, wal = _wal_verdict(store, job["id"])
            cls = load_model_class(MESH_SRC, "MeshVgg")
            # The first claimed member and the last backfilled one.
            picks = [t for t in (trials[0], trials[-1]) if t["params_id"]]
            equal = [_byte_equal(_f32_leaves(params.load(t["params_id"])),
                                 _serial_leaves(cls, t["knobs"], PROC_URI)) for t in picks]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    done = [t for t in trials if t["status"] == "COMPLETED"]
    return dict({"phase": "mesh_sweep", "card": card[1], "power_limit": card[2],
                 "status": result.status, "trials": len(trials), "completed": len(done),
                 "with_params": sum(bool(t["params_id"]) for t in done),
                 "dropouts": [round(t["knobs"]["dropout"], 3) for t in trials],
                 "scores": [t["score"] for t in trials],
                 "best_score": max((t["score"] for t in done), default=None),
                 "top1_target": TUNE_TOP1_TARGET, "job_wall_s": wall,
                 "completed_trials_per_hour": 3600.0 * len(done) / wall,
                 "packed_rounds": snap.get("worker.packed_rounds", 0.0),
                 "backfills": snap.get("trial_pack.backfills", 0.0),
                 "evictions": snap.get("trial_pack.evictions", 0.0),
                 "wal": wal, "serial_byte_equal": equal, "errors": result.errors,
                 "phase_s": time.monotonic() - t_phase}, **graphs)


def mesh_twin(card, twin_dir):
    """Phase 22 (a)'s training twin: ``validate`` of the sweep's journal,
    faithful and doctored, and one seed's replay twice."""
    from rafiki_tpu_torch.obs.twin.train import calibration, engine, validate

    t0 = time.monotonic()
    line = {"phase": "mesh_sweep_twin", "card": card[1], "power_limit": card[2]}
    try:
        cal = calibration.TrainCalibration.from_journal_dir(twin_dir)
    except calibration.TrainCalibrationError as e:
        return dict(line, calibrated=False, error=str(e))
    line.update(calibrated=True, calibration=cal.meta,
                packs=[{k: p.get(k) for k in ("chip", "k", "epochs", "rounds")}
                       for p in cal.packs],
                epoch_overhead_s=cal.epoch_overhead_s)
    for name, scales in (("faithful", None), ("doctored", TWIN_DOCTORED)):
        doc = validate.validate(twin_dir, seed=0, scales=scales)
        line[name] = {k: doc[k] for k in ("measured", "predicted", "tph_err", "wall_err",
                                          "tolerance", "ok", "event_log_sha1", "scales")}
    cfg = engine.TrainTwinConfig.from_calibration(cal)
    line["replay_sha1s"] = [engine.simulate(cal, cfg, packs=engine.packs_from_calibration(cal),
                                            seed=0)["event_log_sha1"] for _ in range(2)]
    # The JAX package's replay of the same journal, which reads no
    # ``trial_pack/rounds``: the drafted members for the formed epochs,
    # against the drafted trial count (a reading, not gated).
    drafted = dataclasses.replace(cal, packs=[
        {k: v for k, v in p.items() if k not in ("rounds", "backfilled")} for p in cal.packs])
    res = engine.simulate(drafted, cfg, packs=engine.packs_from_calibration(drafted), seed=0)
    n, wall = cal.sweep.get("n_trials"), line["faithful"]["measured"]["wall_s"]
    line["without_rounds"] = {
        "trials": res["completed"], "wall_s": res["makespan_s"],
        "tph_err": round(abs(res["trials_per_hour"] - n / wall * 3600.0) / (n / wall * 3600.0), 4),
        "wall_err": round(abs(res["makespan_s"] - wall) / wall, 4)}
    line["twin_s"] = time.monotonic() - t0
    return line


def check_twin(t, check) -> None:
    """Phase 22 (a)'s twin gates."""
    check(t["calibrated"], f"mesh twin: the sweep's journal does not calibrate: {t.get('error')}")
    if not t["calibrated"]:
        return
    f, d = t["faithful"], t["doctored"]
    check(f["ok"] and f["tolerance"] == TWIN_TOLERANCE,
          f"mesh twin: the faithful bundle misses {f['tolerance']}: tph_err {f['tph_err']}, "
          f"wall_err {f['wall_err']}, measured {f['measured']}, predicted {f['predicted']}")
    check(not d["ok"], f"mesh twin: the doctored bundle {d['scales']} passes: tph_err "
                       f"{d['tph_err']}, wall_err {d['wall_err']}")
    check(len(set(t["replay_sha1s"])) == 1,
          f"mesh twin: one seed, two event logs {t['replay_sha1s']}")


def mesh_repack(card, twin_dir=None):
    """Phase 22 (b): ``mesh-chip-loss-repack`` at the canonical model, two
    chips sharing the card, under ``RAFIKI_TWIN_PLACEMENT=1`` with the
    journal in ``twin_dir`` (phase 22 (a)'s; alone, a fresh one, where
    the consult finds nothing to calibrate from)."""
    import shutil
    import tempfile

    import torch

    from rafiki_tpu_torch import chaos as chaos_plane
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.chaos.scenarios import SCENARIOS
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.obs import journal as journal_mod
    from rafiki_tpu_torch.ops import graphs as graphs_mod
    from rafiki_tpu_torch.scheduler import MeshSweepScheduler
    from rafiki_tpu_torch.utils.events import events

    t_phase = time.monotonic()
    sc = SCENARIOS["mesh-chip-loss-repack"]
    tmp = tempfile.mkdtemp(prefix="rafiki-repack-")
    alone = twin_dir is None
    twin_dir = f"{tmp}/journal" if alone else twin_dir
    by_thread = {}
    lock = threading.Lock()
    run = graphs_mod.StepRunner.run

    def counted(self):
        try:
            run(self)
        finally:
            with lock:
                name = threading.current_thread().name
                by_thread[name] = by_thread.get(name, 0) + self.replays

    graphs_mod.StepRunner.run = counted
    try:
        # The journal is open for the consult's record; the FLOP count a
        # journaled process takes of each program's first step stays off,
        # so the two chips' threads step as they did unjournaled.
        with _Env(dict(sc.env, RAFIKI_TPU_SERVING_PARAMS_DTYPE="float32",
                       RAFIKI_TWIN_PLACEMENT="1", RAFIKI_PERF_COST_CAPTURE="0")):
            torch.cuda.empty_cache()
            telemetry.reset()
            events.configure(f"{tmp}/logs")
            store, params, job = _mesh_job(tmp, PROC_PACK_SRC, "ProcPackVgg", 4)
            plane = chaos_plane.FaultPlane.from_spec(sc.spec)
            chaos_plane.install(plane)
            journal_mod.journal.configure(twin_dir, role="mesh-repack")
            try:
                t0 = time.monotonic()
                result = MeshSweepScheduler(store, params).run_sweep(
                    job["id"], chips=2, trials_per_chip=2, advisor_kind="random",
                    devices=[_mesh_device()] * 2)
                wall = _synced_s(t0)
            finally:
                journal_mod.journal.close()
                chaos_plane.uninstall()
            t_twin = time.monotonic()
            recs = [r for r in journal_mod.read_dir(twin_dir) if r.get("job_id") == job["id"]]
            kinds = [(r.get("kind"), r.get("name")) for r in recs]
            placements = [r for r, kind in zip(recs, kinds) if kind == ("twin", "placement")]
            rc, decisions = _cli(["--dir", twin_dir, "decisions", "-n", "0"])
            twin = {"alone": alone, "placements": len(placements),
                    "before_first_pack": (("twin", "placement") in kinds
                                          and ("mesh", "pack_formed") in kinds
                                          and kinds.index(("twin", "placement"))
                                          < kinds.index(("mesh", "pack_formed"))),
                    "best_split": (placements[0].get("recommendation") or {}).get("best_split")
                    if placements else None,
                    "error": placements[0].get("error") if placements else None,
                    "decisions_rc": rc,
                    "decisions_placement": sum(1 for ln in decisions.splitlines()
                                               if " placement " in ln
                                               and f"job={job['id']}" in ln),
                    "twin_s": time.monotonic() - t_twin}
            graphs_mod.StepRunner.run = run
            graphs = _graph_counters()
            trials = store.get_trials_of_train_job(job["id"])
            recs, wal = _wal_verdict(store, job["id"])
            resumed = {e["trial_id"]: e["from_epoch"] for e in events.read("trial_resumed")}
            cls = load_model_class(PROC_PACK_SRC, "ProcPackVgg")
            t_ref = time.monotonic()
            equal = [bool(t["params_id"]) and _byte_equal(
                _f32_leaves(params.load(t["params_id"])),
                _serial_leaves(cls, t["knobs"], PROC_URI)) for t in trials]
            ref_s = _synced_s(t_ref)
    finally:
        graphs_mod.StepRunner.run = run
        events.close()
        shutil.rmtree(tmp, ignore_errors=True)
    chip1 = [tid for r in recs if r["op"] == "pack_assign" and r["rec"] == "intent"
             and r.get("chip") == 1 and not r.get("repack") for tid in r["trial_ids"]]
    repacked = [tid for r in recs if r["op"] == "pack_assign" and r["rec"] == "intent"
                and r.get("repack") and r.get("chip") == 0 for tid in r["trial_ids"]]
    return dict({"phase": "mesh_repack", "card": card[1], "power_limit": card[2],
                 "spec": sc.spec, "status": result.status,
                 "trial_status": [t["status"] for t in trials],
                 "trial_errors": [(t["error"] or "")[-1200:] or None for t in trials],
                 "worker_ids": [t["worker_id"] for t in trials],
                 "fired": [list(f) for f in plane.schedule()],
                 "chip1_trials": chip1, "repacked_onto_chip0": repacked,
                 "resumed_from_epoch": {tid[:8]: resumed.get(tid) for tid in chip1},
                 "replays_by_chip": {k: v for k, v in sorted(by_thread.items())
                                     if k.startswith("mesh-chip-")},
                 "chips_lost": telemetry.get_counter("mesh.chips_lost"),
                 "wal": wal, "serial_byte_equal": equal, "job_wall_s": wall,
                 "serial_reference_s": ref_s, "errors": result.errors, "twin": twin,
                 "phase_s": time.monotonic() - t_phase}, **graphs)


def mesh_sharded(card):
    """Phase 22 (c): the sharded lane at the Transformer's widest knobs,
    both members on the card: an unfaulted width-2 trial, then
    ``chip-loss-mid-sharded-trial``, each against the serial trial."""
    import shutil
    import tempfile

    import torch

    from rafiki_tpu_torch import chaos as chaos_plane
    from rafiki_tpu_torch import shard, telemetry
    from rafiki_tpu_torch.chaos.scenarios import SCENARIOS
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.obs.journal import journal, read_dir
    from rafiki_tpu_torch.scheduler import MeshSweepScheduler

    t_phase = time.monotonic()
    sc = SCENARIOS["chip-loss-mid-sharded-trial"]
    tmp = tempfile.mkdtemp(prefix="rafiki-shard-")
    manifests = []
    save = shard.save_sharded

    def saving(store, trial_id, epoch, state, width=None, extra=None):
        head = save(store, trial_id, epoch, state, width, extra)
        ids = json.loads(store.load(head).decode())["shards"]
        manifests.append({"epoch": epoch, "width": state.width,
                          "bytes": store.size(head) + sum(store.size(i) for i in ids)})
        return head

    shard.save_sharded = saving
    runs = {}
    try:
        with _Env(dict(sc.env, RAFIKI_TPU_SERVING_PARAMS_DTYPE="float32")):
            torch.cuda.empty_cache()
            telemetry.reset()
            journal.configure(f"{tmp}/obs", role="chip-smoke")
            for label, spec in (("unfaulted", None), ("member_lost", sc.spec)):
                store, params, job = _mesh_job(f"{tmp}/{label}", MESH_TF_SRC, "MeshTf", 1,
                                               MESH_TEXT_URI, MESH_TEXT_EVAL_URI,
                                               "TEXT_CLASSIFICATION")
                plane = chaos_plane.FaultPlane.from_spec(spec) if spec else None
                if plane is not None:
                    chaos_plane.install(plane)
                try:
                    t0 = time.monotonic()
                    result = MeshSweepScheduler(store, params).run_sweep(
                        job["id"], chips=2, trials_per_chip=1, advisor_kind="random",
                        devices=[_mesh_device()] * 2)
                    wall = _synced_s(t0)
                finally:
                    chaos_plane.uninstall()
                [t] = result.trials or [{"status": None, "params_id": None, "knobs": None,
                                         "worker_id": None, "id": ""}]
                runs[label] = {"job": job["id"], "trial": t["id"], "status": result.status,
                               "trial_status": t["status"], "worker_id": t["worker_id"],
                               "knobs": t["knobs"], "job_wall_s": wall,
                               "fired": [] if plane is None else [list(f) for f in
                                                                  plane.schedule()],
                               "leaves": (_f32_leaves(params.load(t["params_id"]))
                                          if t["params_id"] else {}),
                               "errors": result.errors}
            cls = load_model_class(MESH_TF_SRC, "MeshTf")
            t_ref = time.monotonic()
            want = _serial_leaves(cls, runs["unfaulted"]["knobs"], MESH_TEXT_URI)
            ref_s = _synced_s(t_ref)
            journal.close()
            recs = read_dir(f"{tmp}/obs")
            graphs = _graph_counters()
    finally:
        shard.save_sharded = save
        journal.close()
        shutil.rmtree(tmp, ignore_errors=True)

    def epoch_ms(width):
        dts = [r["dt"] * 1e3 for r in recs if r.get("kind") == "perf"
               and r.get("name") == "step" and not r.get("cold")
               and r.get("group_width") == width]
        return float(np.mean(dts)) if dts else None

    serial_ms = [r["dt"] * 1e3 for r in recs if r.get("kind") == "perf"
                 and r.get("name") == "step" and not r.get("cold")
                 and r.get("program_kind") == "serial"]
    line = {"phase": "mesh_sharded", "card": card[1], "power_limit": card[2],
            "knobs": runs["unfaulted"]["knobs"], "train_uri": MESH_TEXT_URI,
            "steps_per_epoch": 10000 // 64, "spec": sc.spec,
            "warm_epoch_ms_width2": epoch_ms(2), "warm_epoch_ms_width1": epoch_ms(1),
            "warm_epoch_ms_serial": float(np.mean(serial_ms)) if serial_ms else None,
            "manifest_bytes": sorted({m["bytes"] for m in manifests}),
            "manifests": len(manifests), "serial_reference_s": ref_s}
    for label, run in runs.items():
        shard_recs = [r for r in recs if r.get("kind") == "shard"
                      and r.get("trial_id") == run["trial"]]
        line[label] = {k: run[k] for k in ("status", "trial_status", "worker_id", "job_wall_s",
                                           "fired", "errors")}
        line[label]["width_history"] = [r["width"] for r in shard_recs
                                        if r["name"] == "group_formed"]
        line[label]["reshards"] = [(r["from_width"], r["to_width"], r["epoch"])
                                   for r in shard_recs if r["name"] == "reshard"]
        line[label]["member_lost"] = [r["lost"] for r in shard_recs
                                      if r["name"] == "member_lost"]
        line[label]["serial_byte_equal"] = _byte_equal(run["leaves"], want)
    line.update(graphs)
    line["phase_s"] = time.monotonic() - t_phase
    return line


def mesh_supervisor_kill(card):
    """Phase 22 (d): ``supervisor-kill-mid-sweep`` through ``sweep_proc``
    subprocesses on the card."""
    from rafiki_tpu_torch.chaos.runner import format_report, run_scenario

    t_phase = time.monotonic()
    report = run_scenario("supervisor-kill-mid-sweep", device="cuda")
    graphs = _graph_counters()
    return dict({"phase": "mesh_supervisor_kill", "card": card[1], "power_limit": card[2],
                 "passed": report.passed, "scenario_s": report.duration_s,
                 "checks": {c.name: c.ok for c in report.checks},
                 "report": None if report.passed else format_report(report),
                 "phase_s": time.monotonic() - t_phase}, **graphs)


def check_repack(b, check) -> None:
    """Phase 22 (b)'s checks of one ``mesh_repack`` result."""
    check(b["status"] == "COMPLETED" and b["trial_status"] == ["COMPLETED"] * 4,
          f"mesh repack: job {b['status']}, trials {b['trial_status']}, errors {b['errors']}, "
          f"trial errors {b['trial_errors']}")
    check(any(f[0] == "scheduler.preempt" and f[3] == "chip1" for f in b["fired"]),
          f"mesh repack: the preempt did not fire on chip1: {b['fired']}")
    check(b["chip1_trials"] and sorted(b["chip1_trials"]) == sorted(b["repacked_onto_chip0"])
          and all((wid or "").endswith("-mesh-c0") for wid in b["worker_ids"]),
          f"mesh repack: chip 1's rows {b['chip1_trials']} re-packed as "
          f"{b['repacked_onto_chip0']}, finished by {b['worker_ids']}")
    check(all(e is not None and e >= 1 for e in b["resumed_from_epoch"].values()),
          f"mesh repack: resumed from {b['resumed_from_epoch']}")
    check(all(b["serial_byte_equal"]),
          f"mesh repack: params against serial runs {b['serial_byte_equal']}")
    rep = b["replays_by_chip"]
    check(rep.get("mesh-chip-0", 0) > 0 and rep.get("mesh-chip-1", 0) > 0,
          f"mesh repack: captured steps replayed by chip {rep}")
    t = b["twin"]
    answer = t["error"] if t["alone"] else t["best_split"]
    check(t["placements"] == 1 and t["before_first_pack"] and answer
          and (t["error"] is None) != t["alone"],
          f"mesh repack: the twin placement consult journaled {t}")
    check(t["decisions_rc"] == 0 and t["decisions_placement"] == 1,
          f"mesh repack: obs decisions lists the consult {t['decisions_placement']} time(s), "
          f"exit {t['decisions_rc']}")


def mesh_phase(card, check) -> None:
    """Phase 22 and its checks (also ``--mesh``)."""
    import shutil
    import tempfile

    t0 = time.monotonic()
    twin_dir = tempfile.mkdtemp(prefix="rafiki-twin-")
    try:
        a = mesh_sweep(card, twin_dir)
        print(json.dumps(a))
        twin = mesh_twin(card, twin_dir)
        print(json.dumps(twin))
        check_twin(twin, check)
        b = mesh_repack(card, twin_dir)
    finally:
        shutil.rmtree(twin_dir, ignore_errors=True)
    check(a["status"] == "COMPLETED" and a["trials"] == MESH_TRIALS
          and a["completed"] == MESH_TRIALS and a["with_params"] == MESH_TRIALS
          and not a["errors"],
          f"mesh sweep: {a['status']}, {a['trials']} trials, {a['completed']} completed, "
          f"{a['with_params']} with params, errors {a['errors']}")
    w = a["wal"]
    check(w.get("ok") and w["double_claims"] == 0 and w["claims"] == w["rows"] == w["claimed"],
          f"mesh sweep: the WAL does not reconcile: {w}")
    check(a["best_score"] is not None and a["best_score"] >= TUNE_TOP1_TARGET,
          f"mesh sweep: best score {a['best_score']} < {TUNE_TOP1_TARGET}")
    check(len(a["serial_byte_equal"]) == 2 and all(a["serial_byte_equal"]),
          f"mesh sweep: members against their serial trials {a['serial_byte_equal']}")
    check(a["backfills"] >= 1 and a["graph_replays"] > 0,
          f"mesh sweep: {a['backfills']} backfills, {a['graph_replays']} replays")
    print(json.dumps(b))
    check_repack(b, check)
    c = mesh_sharded(card)
    print(json.dumps(c))
    for label, history in (("unfaulted", [2]), ("member_lost", [2, 1])):
        r = c[label]
        check(r["status"] == "COMPLETED" and r["trial_status"] == "COMPLETED"
              and (r["worker_id"] or "").endswith("-shard-g0"),
              f"mesh sharded ({label}): job {r['status']}, trial {r['trial_status']}, "
              f"worker {r['worker_id']}, errors {r['errors']}")
        check(r["width_history"] == history,
              f"mesh sharded ({label}): width history {r['width_history']}, not {history}")
        check(r["serial_byte_equal"],
              f"mesh sharded ({label}): the trial's params differ from the serial trial's")
    lost = c["member_lost"]
    check(any(f[0] == "scheduler.preempt" and f[3] == "chip1" for f in lost["fired"])
          and lost["member_lost"] == [[1]] and len(lost["reshards"]) == 1
          and lost["reshards"][0][:2] == (2, 1),
          f"mesh sharded: member loss {lost['member_lost']}, reshards {lost['reshards']}, "
          f"fired {lost['fired']}")
    check(c["manifests"] >= 1 and c["graph_replays"] > 0,
          f"mesh sharded: {c['manifests']} manifests, {c['graph_replays']} replays")
    d = mesh_supervisor_kill(card)
    print(json.dumps(d))
    check(d["passed"], f"mesh supervisor kill:\n{d['report']}")
    print(json.dumps({"phase": "mesh", "card": card[1], "power_limit": card[2],
                      "phase_s": time.monotonic() - t0}))



# -- phase 23: the search plane: early kill, speculation, the audit ----------------
# The canonical model at batch 128 on PROC_URI (the 10,000-image cut) for
# SEARCH_EPOCHS epochs, both RAFIKI_CURVE_* switches on (a verdict from the
# third epoch boundary on, the kill rule's default, margin SEARCH_MARGIN). The
# rows' knobs come from a scripted advisor that journals its proposals like
# any engine, so the sweep reconstructs from the journal alone.
SEARCH_EPOCHS = 4
SEARCH_SRC = (BENCH_SRC.replace(b"class BenchVgg(Vgg):", b"class SearchVgg(Vgg):")
              .replace(b"BenchVgg.", b"SearchVgg.")
              .replace(b'"epochs": FixedKnob(1)', b'"epochs": FixedKnob(%d)' % SEARCH_EPOCHS)
              .replace(b'"batch_size": CategoricalKnob([64, 128, 256], affects_shape=True)',
                       b'"batch_size": FixedKnob(128)'))
SEARCH_BASE = dict(depth=16, width_mult=1.0, batch_size=128, epochs=SEARCH_EPOCHS, seed=0)
# (a) serial: a learner that sets best-so-far, then lr 3e-2, which trains
# the canonical model to chance at batch 128 (ROADMAP Queue 3).
SEARCH_SERIAL = (dict(SEARCH_BASE, learning_rate=1e-3, dropout=0.1),
                 dict(SEARCH_BASE, learning_rate=3e-2, dropout=0.1))
# (b) a k=2 pack: a learner and a chance member, other knobs than (a)'s.
SEARCH_PACK = (dict(SEARCH_BASE, learning_rate=1e-3, dropout=0.2),
               dict(SEARCH_BASE, learning_rate=3e-2, dropout=0.0))
# The kill rule's warm-up (2 epochs) and minimum of 3 points are its
# defaults; the margin is widened from 0.02 to SEARCH_MARGIN, as the JAX
# package's early-kill scenario widens it (to 0.35) for noisy curves: a
# chance-level curve (about 0.10 against a best near 0.82) is condemned
# all the same, and a learner still rising at its third epoch is not.
SEARCH_MARGIN = 0.2
SEARCH_ENV = {"RAFIKI_CURVE_KILL": "1", "RAFIKI_CURVE_SPECULATE": "1",
              "RAFIKI_CURVE_KILL_MARGIN": str(SEARCH_MARGIN),
              "RAFIKI_TPU_SERVING_PARAMS_DTYPE": "float32"}


def _scripted_advisor(knob_config, proposals):
    """An advisor that proposes ``proposals`` in turn (then samples the
    space), journaling each proposal as an engine does."""
    from rafiki_tpu_torch.advisor.base import BaseAdvisor
    from rafiki_tpu_torch.obs.search import audit

    class ScriptedAdvisor(BaseAdvisor):
        engine = "scripted"

        def __init__(self):
            super().__init__(knob_config, seed=0)
            self.queue = [dict(k) for k in proposals]

        def _propose(self):
            knobs = self.queue.pop(0) if self.queue else self.space.sample(self._rng)
            audit.record_propose(self, knobs, {"phase": "scripted"})
            return knobs

    return ScriptedAdvisor()


def _cli(argv):
    """The port's obs CLI in this process: (exit code, stdout)."""
    import contextlib
    import io

    from rafiki_tpu_torch.obs import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, out.getvalue()


def _epochs_trained(store, tid):
    return len([e for e in store.get_trial_logs(tid) if e.get("type") == "values"])


def search_kill(card):
    """Phase 23 (a) and (b): one ``TrainWorker`` with its own curve
    coordinator: two serial trials, then a k=2 pack through its packed
    arm; the journal read back through ``obs lineage`` and ``obs sweep``."""
    import shutil
    import tempfile

    import torch

    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.obs.journal import journal, read_dir
    from rafiki_tpu_torch.obs.search import reconstruct
    from rafiki_tpu_torch.obs.search.ledger import search_ledger
    from rafiki_tpu_torch.utils.events import events
    from rafiki_tpu_torch.worker.train import PackedTrialRunner, TrainWorker

    tmp = tempfile.mkdtemp(prefix="rafiki-search-")
    cls = load_model_class(SEARCH_SRC, "SearchVgg")
    evaluated = []
    orig_eval = cls.evaluate_packed.__func__
    cls.evaluate_packed = classmethod(lambda c, ms, uri: (
        evaluated.extend((m.knobs["learning_rate"], m.knobs["dropout"]) for m in ms),
        orig_eval(c, ms, uri))[1])
    try:
        with _Env(SEARCH_ENV):
            torch.cuda.empty_cache()
            journal.configure(f"{tmp}/obs", role="chip-smoke")
            events.configure(f"{tmp}/logs")
            search_ledger.reset()
            store, params, job = _mesh_job(tmp, SEARCH_SRC, "SearchVgg", 4)
            sub = store.get_sub_train_jobs(job["id"])[0]
            adv = _scripted_advisor(cls.get_knob_config(), SEARCH_SERIAL + SEARCH_PACK)
            adv.advisor_id, adv.job_id = "chip-smoke-search", job["id"]
            worker = TrainWorker(store, params, sub["id"], cls, adv, PROC_URI, EVAL_URI,
                                 {"MODEL_TRIAL_COUNT": 4}, worker_id="search-w0",
                                 devices=[_mesh_device()], async_persist=False, trial_pack=2)
            coordinator = worker.curve is not None
            # (a) two serial trials in a fixed order.
            t_a = time.monotonic()
            serial, mem = [], []
            for i in range(2):
                torch.cuda.synchronize()
                mem.append(torch.cuda.memory_allocated())
                t0 = time.monotonic()
                row = worker.run_trial(adv.propose(), budget_max=4)
                serial.append(dict(row, trial_s=_synced_s(t0)))
            torch.cuda.synchronize()
            mem.append(torch.cuda.memory_allocated())
            a_s = time.monotonic() - t_a
            history_a = list(adv.history)
            # (b) the pack, through the packed arm, the same coordinator.
            t_b = time.monotonic()
            before = _graph_counters()
            ran, drained = PackedTrialRunner(worker, 2).run_round(budget_max=4)
            b_graphs = _graph_since(before)
            b_s = _synced_s(t_b)
            snap = search_ledger.snapshot()
            trials = {json.dumps(t["knobs"], sort_keys=True): t
                      for t in store.get_trials_of_sub_train_job(sub["id"])}
            packed = [trials.get(json.dumps(k, sort_keys=True)) for k in SEARCH_PACK]
            survivor = packed[0]
            t_ref = time.monotonic()
            equal = bool(survivor and survivor["params_id"]) and _byte_equal(
                _f32_leaves(params.load(survivor["params_id"])),
                _serial_leaves(cls, survivor["knobs"], PROC_URI))
            ref_s = _synced_s(t_ref)
            kills = list(events.read("trial_killed"))
            evictions = list(events.read("pack_member_evicted"))
            journal.close()
            recs = read_dir(f"{tmp}/obs")
            doomed_pack = packed[1] or {}
            lineage_rc, lineage_out = _cli(["--dir", f"{tmp}/obs", "lineage",
                                            doomed_pack.get("id") or "none"])
            sweep_rc, sweep_out = _cli(["--dir", f"{tmp}/obs", "sweep"])
            doc = reconstruct.reconstruct(recs)
    finally:
        cls.evaluate_packed = classmethod(orig_eval)
        journal.close()
        events.close()
        shutil.rmtree(tmp, ignore_errors=True)

    def kill_rec(tid):
        rs = [r for r in recs if r.get("kind") == "advisor" and r.get("name") == "kill"
              and r.get("trial_id") == tid]
        return rs[-1] if rs else None

    def fit_of(rec):
        return None if rec is None else {k: rec.get(k) for k in (
            "epoch", "predicted", "hi", "band", "best_so_far", "family", "n_obs")}

    ka = kill_rec(serial[1]["id"])
    kb = kill_rec(doomed_pack.get("id"))
    a = {"phase": "search_serial", "card": card[1], "power_limit": card[2],
         "coordinator": coordinator, "knobs": [dict(k) for k in SEARCH_SERIAL],
         "status": [t["status"] for t in serial], "scores": [t["score"] for t in serial],
         "error": serial[1]["error"], "trial_s": [t["trial_s"] for t in serial],
         "epochs_trained": [_epochs_trained(store, t["id"]) for t in serial],
         "epoch_budget": SEARCH_EPOCHS, "kill": fit_of(ka),
         "predicts": sum(1 for r in recs if r.get("kind") == "advisor"
                         and r.get("name") == "predict" and r.get("trial_id") == serial[1]["id"]),
         "advisor_heard": [s for _, s in history_a],
         "memory_allocated_before_killed": mem[1], "memory_allocated_after_killed": mem[2],
         "leak_bytes": TUNE_LEAK_BYTES, "part_s": a_s}
    b = dict({"phase": "search_packed", "card": card[1], "power_limit": card[2],
              "knobs": [dict(k) for k in SEARCH_PACK], "ran": ran, "drained": drained,
              "status": [t and t["status"] for t in packed],
              "scores": [t and t["score"] for t in packed],
              "error": doomed_pack.get("error"),
              "epochs_trained": [t and _epochs_trained(store, t["id"]) for t in packed],
              "kill": fit_of(kb), "kills_evented": [(e["trial_id"][:8], e["epoch"]) for e in kills],
              "evictions": [(e["trial_id"][:8], e["epoch"], e["reason"]) for e in evictions],
              "evaluated": evaluated, "survivor_byte_equal": equal,
              "serial_reference_s": ref_s,
              "lineage_rc": lineage_rc, "lineage_shows_killed_eviction": (
                  "pack_member_evicted" in lineage_out and "reason=killed" in lineage_out),
              "sweep_rc": sweep_rc, "sweep_reconciled": doc["reconciliation"]["ok"],
              "sweep_errors": doc["reconciliation"]["errors"],
              "sweep_kills": doc.get("n_kills"), "sweep_speculations": doc.get("n_speculations"),
              "sweep_corrections": doc.get("n_corrections"),
              "ledger": {k: snap[k] for k in ("n_proposed", "n_scored", "n_doomed", "n_killed",
                                               "n_speculations", "n_corrections",
                                               "scored_wall_s", "doomed_wall_s")},
              "part_s": b_s}, **b_graphs)
    return a, b


def search_scenario(card):
    """Phase 23 (c): ``early-kill-mid-pack-resume`` through ``sweep_proc``
    subprocesses on the card."""
    from rafiki_tpu_torch.chaos.runner import format_report, run_scenario

    t_phase = time.monotonic()
    report = run_scenario("early-kill-mid-pack-resume", device="cuda")
    return {"phase": "search_scenario", "card": card[1], "power_limit": card[2],
            "passed": report.passed, "scenario_s": report.duration_s,
            "checks": {c.name: c.ok for c in report.checks},
            "report": None if report.passed else format_report(report),
            "part_s": time.monotonic() - t_phase}


def search_phase(card, check) -> None:
    """Phase 23 and its checks (also ``--search``)."""
    t0 = time.monotonic()
    a, b = search_kill(card)
    print(json.dumps(a))
    print(json.dumps(b))
    check(a["coordinator"], "search: the worker built no curve coordinator with both switches on")
    check(a["status"] == ["COMPLETED", "ERRORED"]
          and (a["error"] or "").startswith("early_killed: "),
          f"search serial: trials {a['status']}, error {a['error']!r}")
    check(a["epochs_trained"][0] == SEARCH_EPOCHS and a["epochs_trained"][1] < SEARCH_EPOCHS,
          f"search serial: epochs trained {a['epochs_trained']} of {SEARCH_EPOCHS}")
    check(a["kill"] is not None and a["predicts"] >= 1,
          f"search serial: kill record {a['kill']}, {a['predicts']} predict records")
    check(len(a["advisor_heard"]) == 2 and a["kill"] is not None
          and abs(a["advisor_heard"][1] - a["kill"]["predicted"]) <= 1e-8,
          f"search serial: the advisor heard {a['advisor_heard']}, the kill predicted "
          f"{a['kill'] and a['kill']['predicted']}")
    check(a["memory_allocated_after_killed"] <= a["memory_allocated_before_killed"]
          + TUNE_LEAK_BYTES,
          f"search serial: {a['memory_allocated_after_killed']} bytes allocated after the killed "
          f"trial, {a['memory_allocated_before_killed']} before (+{TUNE_LEAK_BYTES} allowed)")
    check(b["status"] == ["COMPLETED", "ERRORED"]
          and (b["error"] or "").startswith("early_killed: ") and b["kill"] is not None,
          f"search packed: members {b['status']}, error {b['error']!r}, kill {b['kill']}")
    check([e[2] for e in b["evictions"]] == ["killed"]
          and b["epochs_trained"][1] < SEARCH_EPOCHS
          and b["epochs_trained"][0] == SEARCH_EPOCHS,
          f"search packed: evictions {b['evictions']}, epochs {b['epochs_trained']}")
    check(b["survivor_byte_equal"],
          "search packed: the survivor's params differ from its serial run's")
    killed_knobs = (SEARCH_PACK[1]["learning_rate"], SEARCH_PACK[1]["dropout"])
    check(killed_knobs not in [tuple(e) for e in b["evaluated"]] and b["evaluated"],
          f"search packed: evaluated {b['evaluated']}")
    check(b["lineage_rc"] == 0 and b["lineage_shows_killed_eviction"],
          f"search packed: obs lineage rc {b['lineage_rc']}, eviction shown "
          f"{b['lineage_shows_killed_eviction']}")
    check(b["sweep_rc"] == 0 and b["sweep_reconciled"] and b["sweep_kills"] == 2,
          f"search packed: obs sweep rc {b['sweep_rc']}, reconciled {b['sweep_reconciled']} "
          f"{b['sweep_errors']}, kills {b['sweep_kills']}")
    led = b["ledger"]
    check(led["n_killed"] == 2 and led["n_doomed"] == 2 and led["doomed_wall_s"] > 0,
          f"search packed: the search ledger {led}")
    check(b["graph_replays"] > 0, f"search packed: no captured step replayed {b}")
    c = search_scenario(card)
    print(json.dumps(c))
    check(c["passed"], f"search scenario:\n{c['report']}")
    print(json.dumps({"phase": "search", "card": card[1], "power_limit": card[2],
                      "phase_s": time.monotonic() - t0}))


# -- serving across processes and its request anatomy -------------------------------
# Phase 24: phase 1's trials served by run_inference_worker_process children
# over the multiprocessing bus. The process route's predictions against the
# in-process route's on the same card: the same forward on the same padded
# chunks of 64 (predict_proba), the same ensemble mean in another reply order,
# so they agree to float32 rounding of a mean of three.
SERVE_PROC_1Q = 200
SERVE_PROC_64Q = 10
SERVE_PROC_ATOL = 1e-5
SERVE_PROC_JOB = "serve-proc"
#: The liveness lease and heartbeat of the reference test
#: (tests/test_serve_elastic.py): TTL 8x the 0.5 s beat.
SERVE_PROC_TTL_S = 4.0
#: No bus call of this process may take longer (the mp bus's contract:
#: no wait on it is unbounded; a gather waits at most its own deadline).
SERVE_PROC_CALL_S = 5.0
SERVE_PROC_DEADLINE_S = 3.0
SERVE_PROC_CHAIN = ["admit", "queue", "enq", "deq", "fwds", "fwd", "reply", "dec"]


class _TimedBus:
    """A bus whose every call records its seconds (phase 24 (b))."""

    def __init__(self, bus):
        self._bus = bus
        self.calls = []  # (verb, seconds)

    def __getattr__(self, name):
        fn = getattr(self._bus, name)

        def timed(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return fn(*args, **kwargs)
            finally:
                self.calls.append((name, time.monotonic() - t0))
        return timed


def _stacked_child(bus, job, worker_id, params_dir, params_ids):
    """Spawn target of phase 24 (c): the stacked top-k served from ONE
    process on the card, journaling where its parent says. It warms its
    forward first, outside the inference.forward site, so the scenario's
    first request (the fault's after=1 skip) is a warm one."""
    import torch

    from rafiki_tpu_torch import obs
    from rafiki_tpu_torch.parallel.serving import build_stacked
    from rafiki_tpu_torch.store import ParamsStore
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    obs.configure_from_env(role="infer")
    torch.cuda.set_device(0)
    store = ParamsStore(params_dir)
    stacked, reason = build_stacked([{"model_name": "vgg"}] * len(params_ids),
                                    load([store.load(i) for i in params_ids], "cuda"),
                                    batch_size=BATCH)
    if stacked is None:
        raise RuntimeError(f"stacked route refused: {reason}")
    stacked.warmup()
    InferenceWorker(bus, job, worker_id, stacked, batch_size=BATCH).run()


def _serve_proc_store(tmp, blobs):
    """Phase 1's blobs as the trials of a BenchVgg job: the stores the
    children rebuild their models from."""
    from rafiki_tpu_torch.store import MetaStore, ParamsStore

    store, params = MetaStore(tmp / "meta.sqlite3"), ParamsStore(tmp / "params")
    model = store.create_model("benchvgg", "IMAGE_CLASSIFICATION", None, BENCH_SRC, "BenchVgg")
    job = store.create_train_job("serve-proc", "IMAGE_CLASSIFICATION", None, TRAIN_URI,
                                 EVAL_URI, {"MODEL_TRIAL_COUNT": len(blobs)})
    sub = store.create_sub_train_job(job["id"], model["id"])
    trials = []
    for b in blobs:
        t = store.create_trial(sub["id"], "benchvgg", dict(KNOBS))
        store.mark_trial_as_completed(t["id"], 0.0, params.save(b))
        trials.append(store.get_trial(t["id"]))
    return store, params, trials


def _route_load(gw, queries):
    """SERVE_PROC_1Q single-query requests, then SERVE_PROC_64Q of 64:
    their outputs, client seconds, and each part's hop summary (the
    telemetry is reset before each part)."""
    from rafiki_tpu_torch import telemetry

    singles, lat1, bursts, lat64 = [], [], [], []
    telemetry.reset()
    for i in range(SERVE_PROC_1Q):
        t0 = time.monotonic()
        singles.append(gw.predict([queries[i % len(queries)]])[0])
        lat1.append(time.monotonic() - t0)
    snap1 = telemetry.snapshot()
    telemetry.reset()
    for _ in range(SERVE_PROC_64Q):
        t0 = time.monotonic()
        bursts.append(gw.predict(queries[:BATCH]))
        lat64.append(time.monotonic() - t0)
    for out in singles + [o for b in bursts for o in b]:
        if isinstance(out, dict):
            fail(f"serve_proc: a request failed: {out}")
    timing = {"p50_ms_1q": percentile_ms(lat1, 50), "p99_ms_1q": percentile_ms(lat1, 99),
              "p50_ms_64q": percentile_ms(lat64, 50), "p99_ms_64q": percentile_ms(lat64, 99),
              "hops_1q": _hop_summary(snap1), "hops_64q": _hop_summary(telemetry.snapshot())}
    return np.asarray(singles, np.float64), np.asarray(bursts, np.float64), timing, snap1


def _hop_summary(snap):
    """Each serving hop's samples, p50 and p99 (ms), and the fan-out cost."""
    from rafiki_tpu_torch.obs.anatomy import hops

    out = {}
    for name in list(hops.METRIC_OF.values()) + [hops.FANOUT_METRIC]:
        h = snap["histograms"].get(name)
        if h:
            out[name] = {"n": h["count"], "p50_ms": h["p50"] * 1e3, "p99_ms": h["p99"] * 1e3}
    return out


SERVE_PROC_SPLIT_ROUNDS = 30


def _forward_split(models, query):
    """Where the in-process route's forward hop goes: one padded chunk of
    one query (the worker's forward, ``ops/train.py predict_proba``)
    split into the copy in (``.to``: a blocking copy, which drains the
    stream first), host launch (until the forward returns its device
    tensor), sync wait (``.cpu()``: the stream drained and the copy
    back) and the CUDA-event span of the forward on its stream.
    Three ways, SERVE_PROC_SPLIT_ROUNDS rounds each after a warm one:
    ``solo`` (one thread, one model), ``threads`` (three threads, one
    model each, released together each round as a request fans out,
    all on the default stream as the route runs) and ``threads_streams``
    (the same with a stream per thread). Each reading's p50 in ms; the
    launch time that ``threads`` adds over ``solo`` is the interpreter's
    lock (the same work, one interpreter)."""
    import torch

    from rafiki_tpu_torch.ops.train import predict

    def forward(m, stream):
        x = m.preprocess(np.asarray(query, m._input_dtype()))
        chunk = np.ascontiguousarray(np.concatenate([x, np.repeat(x[-1:], BATCH - len(x), 0)]))
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream), torch.inference_mode():
            t0 = time.perf_counter()
            xt = torch.from_numpy(chunk).to(m.device)
            t1 = time.perf_counter()
            ev0.record()
            probs = predict(m._loop.state[0], xt)
            ev1.record()
            t2 = time.perf_counter()
            probs.cpu()
            t3 = time.perf_counter()
        return [t1 - t0, t2 - t1, t3 - t2, t3 - t0], (ev0, ev1)

    def rounds(ms, streams):
        rows, events, errors = [], [], []
        barrier = threading.Barrier(len(ms))

        def run(m, stream):
            try:
                for r in range(SERVE_PROC_SPLIT_ROUNDS + 1):
                    barrier.wait(timeout=60)
                    row, ev = forward(m, stream)
                    if r:
                        rows.append(row)
                        events.append(ev)
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(repr(e))
                barrier.abort()

        threads = [threading.Thread(target=run, args=(m, st), daemon=True)
                   for m, st in zip(ms, streams)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        if errors or any(th.is_alive() for th in threads):
            fail(f"serve_proc: the forward split failed: {errors}")
        torch.cuda.synchronize()
        cols = np.asarray(rows) * 1e3
        return {"copy_in_ms": float(np.median(cols[:, 0])),
                "launch_ms": float(np.median(cols[:, 1])),
                "sync_ms": float(np.median(cols[:, 2])),
                "wall_ms": float(np.median(cols[:, 3])),
                "event_span_ms": float(np.median([a.elapsed_time(b) for a, b in events])),
                "forwards": len(rows)}

    default = torch.cuda.current_stream()
    out = {"solo": rounds(models[:1], [default]),
           "threads": rounds(models, [default] * len(models)),
           "threads_streams": rounds(models, [torch.cuda.Stream() for _ in models])}
    out["lock_wait_ms"] = out["threads"]["launch_ms"] - out["solo"]["launch_ms"]
    return out


def serve_proc_routes(card, tmp, blobs, queries):
    """Phase 24 (a), then (b) on the same children."""
    import multiprocessing as mp
    import os
    import signal

    import torch

    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.bus import InProcBus, make_mp_bus
    from rafiki_tpu_torch.gateway import Gateway, GatewayConfig
    from rafiki_tpu_torch.obs.perf import slo
    from rafiki_tpu_torch.predictor import Predictor
    from rafiki_tpu_torch.worker.inference import InferenceWorker, run_inference_worker_process

    t_phase = time.monotonic()
    store, params, trials = _serve_proc_store(tmp, blobs)
    a = {"phase": "serve_proc_routes", "card": card[1], "power_limit": card[2]}
    # The in-process route first: thread workers over InProcBus, the same blobs.
    telemetry.reset()
    bus = InProcBus()
    stop = threading.Event()
    workers = [InferenceWorker(bus, SERVE_PROC_JOB, f"t{i}", m, batch_size=BATCH,
                               stop_event=stop)
               for i, m in enumerate(load(blobs, "cuda"))]
    threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
    for th in threads:
        th.start()
    try:
        gw = Gateway(Predictor(bus, SERVE_PROC_JOB, timeout_s=60.0),
                     GatewayConfig(min_replies=len(blobs), default_deadline_s=60.0))
        gw.predict(queries[:1])  # the first forwards, untimed
        in_single, in_bursts, a["in_process"], _ = _route_load(gw, queries)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
    a["in_process_forward_split"] = _forward_split([w.model for w in workers], queries[:1])
    workers = None
    torch.cuda.empty_cache()

    bus = make_mp_bus()
    procs = []
    ctx = mp.get_context("spawn")
    try:
        telemetry.reset()
        t_spawn = time.monotonic()
        for i, t in enumerate(trials):
            procs.append(ctx.Process(target=run_inference_worker_process,
                                     args=(bus, str(tmp / "meta.sqlite3"), str(tmp / "params"),
                                           t["id"], SERVE_PROC_JOB, f"iw-{i}", BATCH),
                                     daemon=True))
            procs[-1].start()
        deadline = time.monotonic() + 180
        while len(bus.get_workers(SERVE_PROC_JOB)) < len(procs):
            dead = [(p.name, p.exitcode) for p in procs if not p.is_alive()]
            if dead:
                fail(f"serve_proc: a worker process died before registering: {dead}")
            if time.monotonic() > deadline:
                fail("serve_proc: the worker processes never registered")
            time.sleep(0.05)
        a["spawn_to_registered_s"] = time.monotonic() - t_spawn
        pred = Predictor(bus, SERVE_PROC_JOB, timeout_s=60.0, worker_ttl_s=SERVE_PROC_TTL_S)
        gw = Gateway(pred, GatewayConfig(min_replies=len(blobs), default_deadline_s=60.0))
        t0 = time.monotonic()
        gw.predict(queries[:1])  # each child's first forward (fwdc), untimed
        a["first_request_s"] = time.monotonic() - t0
        pr_single, pr_bursts, a["process"], snap = _route_load(gw, queries)
        # What the serving_forward_p99 SLO samples each tick (its windows
        # read None until they span a minute of samples).
        spec = next(sp for sp in slo.default_specs() if sp.name == "serving_forward_p99")
        a["serving_forward_p99_reading"] = slo._resolve(spec.source, snap)
        a["max_abs_err_1q"] = float(np.abs(pr_single - in_single).max())
        a["max_abs_err_64q"] = float(np.abs(pr_bursts - in_bursts).max())
        trace = "24" * 16
        gw.predict([queries[1]], trace_id=trace)
        gw.rollup.flush()
        from rafiki_tpu_torch.obs.anatomy import exemplars

        exemplars.ring.flush()
        obs_dir = str(tmp / "obs")
        rc, out = _cli(["--dir", obs_dir, "--json", "waterfall", trace])
        wf = json.loads(out) if rc == 0 else {"queries": []}
        q = wf["queries"][0] if len(wf["queries"]) == 1 else None
        a["waterfall_rc"] = rc
        a["waterfall_chains"] = (None if q is None else
                                 {w: [m[0] for m in v["marks"]] for w, v in q["chains"].items()})
        a["waterfall_pids"] = None if q is None else q["pids"]
        a["child_pids"] = sorted(p.pid for p in procs)
        rc, out = _cli(["--dir", obs_dir, "--json", "tails", "--check", "--tolerance", "0.10"])
        a["tails_rc"] = rc
        a["tails"] = json.loads(out) if out.strip() else None
        rc, out = _cli(["--dir", obs_dir, "--json", "serving"])
        a["serving_rc"], a["serving_rows"] = rc, len(out.splitlines())
        a["part_s"] = time.monotonic() - t_phase

        # (b) SIGKILL one replica under a quorum-2 load of single queries.
        t_b = time.monotonic()
        timed = _TimedBus(bus)
        gwq = Gateway(Predictor(timed, SERVE_PROC_JOB, timeout_s=SERVE_PROC_DEADLINE_S,
                                worker_ttl_s=SERVE_PROC_TTL_S),
                      GatewayConfig(max_inflight=4, min_replies=2, hedge_grace_s=0.2,
                                    default_deadline_s=SERVE_PROC_DEADLINE_S))
        results = []  # (start, end, ok)
        halt = threading.Event()

        def load_loop():
            i = 0
            while not halt.is_set():
                t0 = time.monotonic()
                try:
                    out = gwq.predict([queries[i % len(queries)]])
                    ok = not any(isinstance(o, dict) for o in out)
                except Exception:
                    ok = False
                results.append((t0, time.monotonic(), ok))
                i += 1

        loader = threading.Thread(target=load_loop, daemon=True)
        loader.start()
        time.sleep(1.0)
        t_kill = time.monotonic()
        os.kill(procs[2].pid, signal.SIGKILL)
        procs[2].join(10)
        stale_at = None
        deadline = t_kill + 3 * SERVE_PROC_TTL_S
        while time.monotonic() < deadline:
            if "iw-2" not in timed.get_workers(SERVE_PROC_JOB, max_age_s=SERVE_PROC_TTL_S):
                stale_at = time.monotonic()
                break
            time.sleep(0.1)
        time.sleep(1.0)  # load on the two survivors alone
        halt.set()
        loader.join(30)
        reaped = timed.reap_stale(SERVE_PROC_TTL_S, job_id=SERVE_PROC_JOB)
        after = [r for r in results if r[0] >= t_kill]
        b = {"phase": "serve_proc_kill", "card": card[1], "power_limit": card[2],
             "killed_exitcode": procs[2].exitcode, "requests": len(results),
             "requests_after_kill": len(after),
             "failed_requests": sum(1 for r in results if not r[2]),
             "kill_to_first_quorum_answer_s": (min(r[1] for r in after if r[2]) - t_kill
                                               if any(r[2] for r in after) else None),
             "kill_to_stale_s": None if stale_at is None else stale_at - t_kill,
             "reaped": reaped, "workers_after": bus.get_workers(SERVE_PROC_JOB),
             "corpse_queue_depth": bus.queue_depth("iw-2"),
             "slowest_bus_call": max(timed.calls, key=lambda c: c[1]),
             "bus_calls": len(timed.calls),
             "loader_alive": loader.is_alive(),
             "part_s": time.monotonic() - t_b}
        gwq.close()
        gw.close()
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        bus.close()
    return a, b, trials


def serve_proc_fallback(card, tmp, trials, blobs, queries):
    """Phase 24 (c): ``stacked-worker-loss-fallback`` with a real stacked
    VGG16 child and per-trial fallback workers on the card."""
    import os

    from rafiki_tpu_torch import chaos, telemetry
    from rafiki_tpu_torch.chaos.scenarios import SCENARIOS, stacked_loss_body

    t_c = time.monotonic()
    spec = SCENARIOS["stacked-worker-loss-fallback"].spec
    checks = {}
    prev = os.environ.get(chaos.ENV_VAR)
    os.environ[chaos.ENV_VAR] = spec  # the spawned child's plane
    chaos.install(chaos.FaultPlane.from_spec(spec))
    telemetry.reset()
    try:
        seen = stacked_loss_body(
            lambda name, ok, detail="": checks.__setitem__(name, (bool(ok), str(detail)[:300])),
            _stacked_child, (str(tmp / "params"), [t["params_id"] for t in trials]),
            load(blobs, "cuda"), [[queries[i]] for i in range(5)], register_timeout_s=180.0)
    finally:
        chaos.uninstall()
        if prev is None:
            os.environ.pop(chaos.ENV_VAR, None)
        else:
            os.environ[chaos.ENV_VAR] = prev
    return {"phase": "serve_proc_fallback", "card": card[1], "power_limit": card[2],
            "checks": {k: v[0] for k, v in checks.items()},
            "failed_details": {k: v[1] for k, v in checks.items() if not v[0]},
            "outcomes": seen["outcomes"], "child_pid": seen["child_pid"],
            "blackout_retries": seen["blackout_retries"],
            "kill_to_fallback_serving_s": (None if seen["killed_at"] is None
                                           or seen["first_answer_after_kill"] is None
                                           else seen["first_answer_after_kill"]
                                           - seen["killed_at"]),
            "part_s": time.monotonic() - t_c}


def serve_proc_phase(card, check, blobs=None) -> None:
    """Phase 24 and its checks (also ``--serve-proc``)."""
    import os
    import tempfile
    from pathlib import Path

    import torch

    from rafiki_tpu_torch.obs.journal import ENV_VAR as LOG_ENV, journal

    t0 = time.monotonic()
    if blobs is None:
        blobs = [make_blob(seed) for seed in range(K)]
    queries = queries_for(0).tolist()
    prev_dir = journal.log_dir if journal.configured else None
    prev_role, prev_env = journal.role, os.environ.get(LOG_ENV)
    with tempfile.TemporaryDirectory(prefix="serve-proc-") as td:
        tmp = Path(td)
        journal.configure(tmp / "obs", role="serve-proc")
        os.environ[LOG_ENV] = str(tmp / "obs")  # the children journal beside this process
        try:
            a, b, trials = serve_proc_routes(card, tmp, blobs, queries)
            print(json.dumps(a))
            print(json.dumps(b))
            torch.cuda.empty_cache()
            c = serve_proc_fallback(card, tmp, trials, blobs, queries)
            print(json.dumps(c))
        finally:
            if prev_env is None:
                os.environ.pop(LOG_ENV, None)
            else:
                os.environ[LOG_ENV] = prev_env
            if prev_dir is not None:
                journal.configure(prev_dir, role=prev_role)
            else:
                journal.close()
    for route in ("in_process", "process"):
        check(a[route]["p50_ms_1q"] > 0, f"serve_proc: no {route} timings {a[route]}")
    check(max(a["max_abs_err_1q"], a["max_abs_err_64q"]) <= SERVE_PROC_ATOL,
          f"serve_proc: the process route's predictions differ from the in-process route's "
          f"by {a['max_abs_err_1q']} (1 query) / {a['max_abs_err_64q']} (64) > {SERVE_PROC_ATOL}")
    chains = a["waterfall_chains"] or {}
    check(a["waterfall_rc"] == 0 and len(chains) == K
          and all(c == SERVE_PROC_CHAIN for c in chains.values()),
          f"serve_proc: obs waterfall rc {a['waterfall_rc']}, chains {chains}")
    pids = a["waterfall_pids"] or []
    check(len(set(pids)) == 4 and set(pids) - {os.getpid()} <= set(a["child_pids"]),
          f"serve_proc: waterfall pids {pids}, this process {os.getpid()}, children "
          f"{a['child_pids']}")
    check(a["tails_rc"] == 0 and a["tails"] and a["tails"]["reconcile"]["ok"],
          f"serve_proc: obs tails --check rc {a['tails_rc']}: {a['tails']}")
    check(a["serving_rc"] == 0 and a["serving_rows"] >= 1,
          f"serve_proc: obs serving rc {a['serving_rc']}, {a['serving_rows']} rows")
    fwd = a["process"]["hops_1q"].get("serving.hop.forward_s", {"n": 0})
    check(fwd["n"] > 0 and a["serving_forward_p99_reading"] is not None,
          f"serve_proc: serving.hop.forward_s {fwd}, SLO reading "
          f"{a['serving_forward_p99_reading']}")
    check(b["killed_exitcode"] == -9 and b["requests_after_kill"] > 0
          and b["failed_requests"] == 0 and not b["loader_alive"],
          f"serve_proc kill: exit {b['killed_exitcode']}, {b['failed_requests']} of "
          f"{b['requests']} requests failed ({b['requests_after_kill']} after the kill)")
    check(b["kill_to_stale_s"] is not None and b["kill_to_stale_s"] <= SERVE_PROC_TTL_S + 1.0,
          f"serve_proc kill: the corpse's lease stayed fresh {b['kill_to_stale_s']} s")
    check([tuple(r) for r in b["reaped"]] == [(SERVE_PROC_JOB, "iw-2")],
          f"serve_proc kill: reaped {b['reaped']}")
    check(b["workers_after"] == ["iw-0", "iw-1"] and b["corpse_queue_depth"] == 0,
          f"serve_proc kill: workers {b['workers_after']}, corpse queue "
          f"{b['corpse_queue_depth']}")
    check(b["slowest_bus_call"][1] <= SERVE_PROC_CALL_S,
          f"serve_proc kill: a bus call took {b['slowest_bus_call']}")
    check(all(c["checks"].values()) and len(c["checks"]) == 7,
          f"serve_proc fallback: checks {c['checks']}: {c['failed_details']}")
    check(c["kill_to_fallback_serving_s"] is not None,
          f"serve_proc fallback: no answer after the kill {c}")
    print(json.dumps({"phase": "serve_proc", "card": card[1], "power_limit": card[2],
                      "phase_s": time.monotonic() - t0}))


# -- multi-tenant serving: co-hosting and tenant isolation ---------------------------
# Phase 25. Each job is a stacked top-3; a job's charge is its blobs' bytes.
TENANCY_SEEDS = {"J0": (0, 1, 2), "J1": (3, 4, 5), "J2": (6, 7, 8), "J3": (0, 1, 9)}
TENANCY_ORDER = ["J0", "J1", "J0", "J1", "J2", "J0", "J3", "J3", "J1", "J0", "J2", "J2"]
#: Budget over one job's charge: two jobs resident, never three.
TENANCY_BUDGET_JOBS = 2.5
# A job co-hosted and the same job served alone run the same stacked
# forward on the same padded chunk of 64 on one card.
TENANCY_ATOL = 1e-5
#: An eviction gives back at least this share of its activation's bytes.
TENANCY_FREE_FRAC = 0.9
TENANCY_SRC = b"from rafiki_tpu_torch.models.vgg import Vgg\n\n\nclass TenantVgg(Vgg):\n    pass\n"
#: One forward a request, one residency event: the gateway's microbatch
#: makes a 64-query request one bus envelope.
TENANCY_GATEWAY = {"max_batch": BATCH, "max_batch_wait_ms": 2.0}
TENANCY_ISOLATION_GATEWAY = {"min_replies": 1, "max_inflight": 2, "max_queue": 8}


def _lru_events(requests, capacity):
    """The residency manager's (event, job) sequence for ``requests``,
    computed here: a hit refreshes, a miss evicts the least recently
    used job until one fits (every job charges about the same)."""
    resident, events = [], []
    for job in requests:
        if job in resident:
            resident.remove(job)
            events.append(("hit", job))
        else:
            while len(resident) >= capacity:
                events.append(("evict", resident.pop(0)))
            events.append(("activate", job))
        resident.append(job)
    return events


def _chunk_ids(blob: bytes, chunk_bytes: int) -> set:
    import hashlib

    return {hashlib.sha256(blob[o:o + chunk_bytes]).hexdigest()
            for o in range(0, len(blob), chunk_bytes)}


def _tenancy_store(tmp, blobs):
    """The CAS params store with the four jobs' blobs, each job saving
    its own three, and a meta store with their trial rows. Returns
    (store, params, train job, trials by job, CAS readings)."""
    import os

    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.store import CasParamsStore, MetaStore, make_params_store

    prev = os.environ.get("RAFIKI_PARAMS_CAS")
    os.environ["RAFIKI_PARAMS_CAS"] = "1"
    try:
        params = make_params_store(tmp / "params")
    finally:
        if prev is None:
            os.environ.pop("RAFIKI_PARAMS_CAS")
        else:
            os.environ["RAFIKI_PARAMS_CAS"] = prev
    if not isinstance(params, CasParamsStore):
        fail(f"tenancy: RAFIKI_PARAMS_CAS=1 gave {type(params).__name__}")
    store = MetaStore(tmp / "meta.sqlite3")
    model = store.create_model("vgg", "IMAGE_CLASSIFICATION", None, TENANCY_SRC, "TenantVgg")
    tj = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, "x", "y", {})
    sub = store.create_sub_train_job(tj["id"], model["id"])
    trials, cas = {}, {}
    for job, seeds in TENANCY_SEEDS.items():
        present = {p.name for p in (tmp / "params" / "chunks").iterdir()}
        new_chunks = set().union(*(_chunk_ids(blobs[s], params.stats()["chunk_bytes"])
                                   for s in seeds)) - present
        before = params.stats()
        writes0 = telemetry.get_counter("cas.chunk_writes")
        rows = []
        for i, s in enumerate(seeds):
            t = store.create_trial(sub["id"], "vgg", KNOBS)
            store.mark_trial_as_completed(t["id"], 0.5, params.save(blobs[s], f"{job}-t{i}"))
            rows.append(store.get_trial(t["id"]))
        trials[job] = rows
        after = params.stats()
        logical = after["bytes_logical"] - before["bytes_logical"]
        written = after["bytes_written"] - before["bytes_written"]
        cas[job] = {"chunk_writes": telemetry.get_counter("cas.chunk_writes") - writes0,
                    "new_chunks": len(new_chunks), "bytes_logical": logical,
                    "bytes_written": written, "dedup_ratio": 1.0 - written / logical}
    cas["store"] = params.stats()
    return store, params, tj, trials, cas


def tenancy_cohost(card, tmp, store, params, tj, trials):
    """Phase 25 (a): the four jobs co-hosted on one worker, then each
    alone. Returns the phase's line."""
    import torch

    from rafiki_tpu_torch.admin.services_manager import ServicesManager
    from rafiki_tpu_torch.obs.journal import journal, read_dir

    t0 = time.monotonic()
    log_dir = tmp / "obs-cohost"
    journal.configure(log_dir, role="tenancy")
    mgr = ServicesManager(store, params)
    charges = {j: max(sum(params.size(t["params_id"]) for t in rows), 1 << 20)
               for j, rows in trials.items()}
    blob_bytes = {j: sum(len(params.load(t["params_id"])) for t in rows)
                  for j, rows in trials.items()}
    budget = int(TENANCY_BUDGET_JOBS * charges["J0"])
    jobs = {j: store.create_inference_job(tj["id"], None)["id"] for j in trials}
    back = {v: k for k, v in jobs.items()}
    x = queries_for(25)
    one, full = x[:1].tolist(), x.tolist()
    torch.cuda.synchronize()
    mgr.create_cohosted_inference_services({jobs[j]: rows for j, rows in trials.items()},
                                           gateway_overrides=TENANCY_GATEWAY,
                                           hbm_budget_bytes=budget)
    host = mgr._inference_jobs[jobs["J0"]].workers[0].model
    loads = []  # (job, allocated before the load, after it), in the worker

    def measured(job, loader):
        def load():
            before = torch.cuda.memory_allocated()
            program = loader()
            loads.append((job, before, torch.cuda.memory_allocated()))
            return program
        return load

    for spec in host._specs.values():
        spec.loader = measured(back[spec.program_id], spec.loader)
    requests, cohosted, lat = [], {}, {"hit": [], "miss": []}
    evictions, last_act, resident = [], {}, []
    try:
        for j in TENANCY_ORDER:
            for q, tag in ((one, "1q"), (full, "64q")):
                if tag == "64q" and f"{j}/64q" in cohosted:
                    continue  # one 64-query request a job, on its first visit
                miss = j not in resident
                evicted = []
                if miss:
                    while len(resident) >= 2:
                        evicted.append(resident.pop(0))
                else:
                    resident.remove(j)
                resident.append(j)
                requests.append(j)
                n_loads = len(loads)
                torch.cuda.synchronize()
                quiet = torch.cuda.memory_allocated()  # the worker is idle
                t = time.monotonic()
                cohosted[f"{j}/{tag}"] = mgr.get_gateway(jobs[j]).predict(q)
                dt = time.monotonic() - t
                if tag == "1q":
                    lat["miss" if miss else "hit"].append(dt)
                if evicted and len(loads) > n_loads:
                    # The evictions ran before the load: what they freed is
                    # the quiet reading less the reading the load began at.
                    took = sum(last_act.get(e, 0) for e in evicted)
                    free = quiet - loads[n_loads][1]
                    evictions.append({"evicted": evicted, "freed_bytes": free,
                                      "activation_bytes": took,
                                      "frac": free / took if took else None})
                for job, before, after in loads[n_loads:]:
                    last_act[job] = after - before
    finally:
        for j in trials:
            mgr.stop_inference_services(jobs[j])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    alone = {}
    for j, rows in trials.items():
        job = store.create_inference_job(tj["id"], None)["id"]
        mgr.create_inference_services(job, rows, gateway_overrides=TENANCY_GATEWAY)
        try:
            alone[j] = {"1q": mgr.get_gateway(job).predict(one),
                        "64q": mgr.get_gateway(job).predict(full)}
        finally:
            mgr.stop_inference_services(job)
    mgr.stop_all()
    journal.close()
    res = [r for r in read_dir(log_dir)
           if (r.get("kind"), r.get("name")) == ("tenancy", "residency")
           and r.get("for_program") != "shutdown"]
    errs = []
    for j in trials:
        for tag in ("1q", "64q"):
            a = np.asarray(cohosted[f"{j}/{tag}"], np.float64)
            b = np.asarray(alone[j][tag], np.float64)
            if a.shape != b.shape or not np.isfinite(a).all():
                fail(f"tenancy cohost: {j} {tag} outputs of shape {a.shape} against {b.shape}")
            errs.append(float(np.abs(a - b).max()))
    return {"phase": "tenancy_cohost", "card": card[1], "power_limit": card[2],
            "budget_bytes": budget, "charges": charges, "blob_bytes": blob_bytes,
            "requests": requests, "events": [(r["event"], back.get(r["program"]))
                                             for r in res],
            "used_bytes_max": max((r["used_bytes"] for r in res if "used_bytes" in r),
                                  default=0),
            "activations": [{"job": j, "charge": charges[j], "bytes": after - before,
                             "ratio": (after - before) / charges[j]} for j, before, after in loads],
            "evictions": evictions,
            "load_s": [r.get("load_s") for r in res if r["event"] == "activate"],
            "p50_ms_hit": percentile_ms(lat["hit"], 50), "p50_ms_miss": percentile_ms(lat["miss"], 50),
            "n_hit": len(lat["hit"]), "n_miss": len(lat["miss"]),
            "max_abs_err_vs_alone": max(errs), "phase_s": time.monotonic() - t0}



def _post_predict(url: str, body: bytes, tenant=None) -> None:
    """One ``POST /predict`` as ``tenant`` (None: anonymous); raises on
    any status but 200."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if tenant is not None:
        headers["X-Rafiki-Tenant"] = tenant
    req = urllib.request.Request(url, data=body, method="POST", headers=headers)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=30) as r:
            r.read()
    except urllib.error.HTTPError as e:
        e.close()
        raise RuntimeError(f"HTTP {e.code}")


def _tenancy_flood(url: str, body: bytes, stop) -> None:
    """Spawn target of phase 25 (b): the aggressor's eight flooding
    threads, as ``noisy-neighbor-shed`` runs them (a shed backs off 5
    ms), until ``stop`` is set. A client process, not threads of this
    one: clients are not in the server's interpreter, and eight client
    threads here would contend with its worker's launches (PERF.md)."""
    def aggress():
        while not stop.is_set():
            try:
                _post_predict(url, body, "aggressor")
            except Exception:
                time.sleep(0.005)

    flood = [threading.Thread(target=aggress, daemon=True) for _ in range(8)]
    for th in flood:
        th.start()
    for th in flood:
        th.join(timeout=60)


def tenancy_isolation(card, tmp, store, params, tj, trials, unweighted, run=0):
    """Phase 25 (b): ``noisy-neighbor-shed`` through a tenant-aware
    inference job of phase 1's trials and its HTTP predictor on the
    card, weighted or (the doctored polarity) unweighted: the aggressor
    floods from a client process, then the victim sends its 25 requests
    20 ms apart from here. Returns the line, with the scenario's checks
    read from the journal."""
    import gc
    import multiprocessing as mp
    import os

    from rafiki_tpu_torch import chaos
    from rafiki_tpu_torch.admin.services_manager import ServicesManager
    from rafiki_tpu_torch.chaos.scenarios import SCENARIOS, noisy_neighbor_checks
    from rafiki_tpu_torch.obs.journal import journal, read_dir
    from rafiki_tpu_torch.tenancy import TenantDirectory, TenantFabric
    from rafiki_tpu_torch.utils import heap

    t0 = time.monotonic()
    polarity = "unweighted" if unweighted else "weighted"
    log_dir = tmp / f"obs-isolation-{polarity}-{run}"
    prev = os.environ.get("RAFIKI_TENANT_UNWEIGHTED")
    if unweighted:
        os.environ["RAFIKI_TENANT_UNWEIGHTED"] = "1"
    journal.configure(log_dir, role="tenancy")
    mgr = ServicesManager(store, params)
    flood = None
    try:
        fabric = TenantFabric(TenantDirectory(tiers={"victim": "gold", "aggressor": "batch"}))
        budget_ms = fabric.directory.tier_of("victim").p99_budget_ms
        job = store.create_inference_job(tj["id"], None)["id"]
        # What the services manager's freeze (utils/heap.py) pays at a
        # service start: a full collection of the unfrozen heap.
        t = time.monotonic()
        gc.collect()
        collect_s = time.monotonic() - t
        mgr.create_inference_services(job, trials, gateway_overrides=TENANCY_ISOLATION_GATEWAY,
                                      tenancy=fabric)
        url = f"http://{store.get_inference_job(job)['predictor_host']}/predict"
        body = json.dumps({"queries": queries_for(26)[:1].tolist()}).encode()
        for _ in range(3):  # the worker thread's first forwards, before any tenant's
            _post_predict(url, body)
        # The services manager froze the server's heap (utils/heap.py).
        heap_holders, frozen_objects = heap.holders(), gc.get_freeze_count()
        chaos.install(chaos.FaultPlane.from_spec(SCENARIOS["noisy-neighbor-shed"].spec))
        try:
            ctx = mp.get_context("spawn")
            stop = ctx.Event()
            flood = ctx.Process(target=_tenancy_flood, args=(url, body, stop), daemon=True)
            flood.start()
            deadline = time.monotonic() + 60
            while "aggressor" not in fabric.accounting.per_tenant():
                if time.monotonic() > deadline or not flood.is_alive():
                    fail("tenancy isolation: the flood never reached the gateway")
                time.sleep(0.01)
            time.sleep(0.3)  # the flood established before the victim
            victim_errors = 0
            for _ in range(25):
                try:
                    _post_predict(url, body, "victim")
                except RuntimeError:
                    victim_errors += 1
                time.sleep(0.02)
            stop.set()
            flood.join(timeout=60)
        finally:
            chaos.uninstall()
        mgr.stop_inference_services(job)  # drains the gateway: tenant/summary
    finally:
        if flood is not None and flood.is_alive():
            flood.kill()
            flood.join(timeout=10)
        mgr.stop_all()
        journal.close()
        if prev is None:
            os.environ.pop("RAFIKI_TENANT_UNWEIGHTED", None)
        else:
            os.environ["RAFIKI_TENANT_UNWEIGHTED"] = prev
    recs = read_dir(log_dir)
    checks = {}
    noisy_neighbor_checks(lambda name, ok, detail="": checks.update({name: [bool(ok), detail]}),
                          recs, "victim", "aggressor", budget_ms, victim_errors)
    rc, out = _cli(["--dir", str(log_dir), "tenants", "--check"])
    rc_json, out_json = _cli(["--dir", str(log_dir), "--json", "tenants"])
    tenants = {row["tenant"]: row for row in json.loads(out_json)["tenants"]} if rc_json == 0 else {}
    fwd = [(r["chains"]) for r in recs if (r.get("kind"), r.get("name")) == ("serving", "hops")]
    forward_ms = sorted(1000 * (dict((m[0], m[1]) for m in chain).get("fwd", 0)
                                - dict((m[0], m[1]) for m in chain).get("fwds", 0))
                        for chains in fwd for chain in chains.values()
                        if {"fwds", "fwd"} <= {m[0] for m in chain})
    return {"phase": f"tenancy_isolation_{polarity}", "card": card[1],
            "power_limit": card[2], "checks": checks, "victim_errors": victim_errors,
            "tenants_check_rc": rc, "tenants_check_out": out.strip()[-200:],
            "victim": tenants.get("victim"), "aggressor": tenants.get("aggressor"),
            "forward_hop_p50_ms": forward_ms[len(forward_ms) // 2] if forward_ms else None,
            "forward_hop_max_ms": forward_ms[-1] if forward_ms else None,
            "budget_ms": budget_ms, "heap_holders": heap_holders,
            "frozen_objects": frozen_objects, "collect_s": collect_s,
            "phase_s": time.monotonic() - t0}


def tenancy_phase(card, check, blobs=None, repeats=1) -> None:
    """Phase 25 and its checks (also ``--tenancy [N]``, which runs the
    weighted polarity of (b) ``repeats`` times)."""
    import tempfile
    from pathlib import Path

    import torch

    from rafiki_tpu_torch.obs.journal import journal

    t0 = time.monotonic()
    blobs = list(blobs or [])
    blobs += [make_blob(seed) for seed in range(len(blobs), 10)]
    prev_dir = journal.log_dir if journal.configured else None
    prev_role, prev_max = journal.role, journal.max_records
    # Every record of the run is read back: the flood's thousands of
    # sheds must not rotate the victim's records out.
    journal.max_records = 1 << 22
    with tempfile.TemporaryDirectory(prefix="tenancy-") as td:
        tmp = Path(td)
        try:
            store, params, tj, trials, cas = _tenancy_store(tmp, blobs)
            a = tenancy_cohost(card, tmp, store, params, tj, trials)
            a["cas"] = cas
            print(json.dumps(a))
            torch.cuda.empty_cache()
            weighted = []
            for run in range(repeats):
                weighted.append(tenancy_isolation(card, tmp, store, params, tj, trials["J0"],
                                                  unweighted=False, run=run))
                print(json.dumps(weighted[-1]), flush=True)
                torch.cuda.empty_cache()
            d = tenancy_isolation(card, tmp, store, params, tj, trials["J0"], unweighted=True)
            print(json.dumps(d))
        finally:
            journal.max_records = prev_max
            if prev_dir is not None:
                journal.configure(prev_dir, role=prev_role)
            else:
                journal.close()
    expanded = []
    for j in TENANCY_ORDER:
        expanded += [j] if j in expanded else [j, j]
    check(a["max_abs_err_vs_alone"] <= TENANCY_ATOL,
          f"tenancy cohost: co-hosted predictions differ from each job served alone by "
          f"{a['max_abs_err_vs_alone']} > {TENANCY_ATOL}")
    check(a["requests"] == expanded and [tuple(e) for e in a["events"]]
          == _lru_events(expanded, 2),
          f"tenancy cohost: residency events {a['events']} against the LRU of "
          f"{a['requests']}: {_lru_events(expanded, 2)}")
    check(a["used_bytes_max"] <= a["budget_bytes"],
          f"tenancy cohost: {a['used_bytes_max']} bytes resident > budget {a['budget_bytes']}")
    n_evict = sum(1 for e in _lru_events(expanded, 2) if e[0] == "evict")
    check(len(a["evictions"]) == n_evict and all(
        e["activation_bytes"] > 0 and e["freed_bytes"] >= TENANCY_FREE_FRAC * e["activation_bytes"]
        for e in a["evictions"]),
          f"tenancy cohost: evictions freed {a['evictions']} (want {n_evict}, each at least "
          f"{TENANCY_FREE_FRAC} of its activation)")
    check(all(a["charges"][j] == a["blob_bytes"][j] + 65 * len(TENANCY_SEEDS[j])
              for j in TENANCY_SEEDS),
          f"tenancy cohost: charges {a['charges']} are not the blobs' bytes {a['blob_bytes']} "
          f"(plus the plain store's digest line a trial)")
    check(cas["J3"]["chunk_writes"] == cas["J3"]["new_chunks"] > 0
          and cas["J3"]["chunk_writes"] < cas["J1"]["chunk_writes"],
          f"tenancy cohost: J3's save wrote {cas['J3']['chunk_writes']} chunks, its new "
          f"trial's are {cas['J3']['new_chunks']} (J1 wrote {cas['J1']['chunk_writes']})")
    for b in weighted:
        check(all(ok for ok, _ in b["checks"].values()) and len(b["checks"]) == 6,
              f"tenancy isolation: checks {b['checks']}")
        check(b["heap_holders"] > 0 and b["frozen_objects"] > 0,
              f"tenancy isolation: the services manager left the server's heap unfrozen "
              f"({b['heap_holders']} holders, {b['frozen_objects']} objects)")
        check(b["tenants_check_rc"] == 0,
              f"tenancy isolation: obs tenants --check rc {b['tenants_check_rc']}: "
              f"{b['tenants_check_out']}")
    check(d["checks"].get("victim_p99_within_budget", [True])[0] is False,
          f"tenancy isolation unweighted: victim_p99_within_budget passed, so the gate "
          f"cannot fail: {d['checks']}")
    print(json.dumps({"phase": "tenancy", "card": card[1], "power_limit": card[2],
                      "phase_s": time.monotonic() - t0}))


# -- closed-loop elasticity and the serving twin -------------------------------------
# Phase 26. (a) phase 1's trials as a stacked job at batch 64; the base
# replica pinned slow until the private serving-p99 SLO breaches and the
# autoscaler (0.2 s tick, 1 to 2 workers) scales it up.
AUTOSCALE_SRC = b"from rafiki_tpu_torch.models.vgg import Vgg\n\n\nclass ScaleVgg(Vgg):\n    pass\n"
AUTOSCALE_SLO_MS = 150.0
AUTOSCALE_WINDOW_S = 0.8
AUTOSCALE_DELAY_S = 0.3
AUTOSCALE_DRIVE_S = 20.0
AUTOSCALE_RECOVERY_S = 8.0
AUTOSCALE_MAX_ACTUATIONS = 2
#: The lane's band and cooldowns (``RAFIKI_AUTOSCALE_*``), as the JAX
#: package's ``load-spike-scale-up`` scenario sets them.
AUTOSCALE_ENV = {"RAFIKI_AUTOSCALE_UP_THRESHOLD": "1.0", "RAFIKI_AUTOSCALE_DOWN_THRESHOLD": "0.0",
                 "RAFIKI_AUTOSCALE_UP_COOLDOWN_S": "1.0",
                 "RAFIKI_AUTOSCALE_DOWN_COOLDOWN_S": "60.0"}
AUTOSCALE_GATEWAY = {"min_replies": 1, "max_queue": 32, "max_inflight": 8}
AUTOSCALE_TIERS = {"gold_t": "gold", "batch_t": "batch"}
# (b) the canonical model at one packing key (batch 128, one epoch) on the
# 10,000-image cut, a k=2 job of two trials.
PREWARM_SRC = (PROC_PACK_SRC.replace(b"class ProcPackVgg(Vgg):", b"class PrewarmVgg(Vgg):")
               .replace(b"ProcPackVgg.", b"PrewarmVgg.")
               .replace(b'"epochs": FixedKnob(3)', b'"epochs": FixedKnob(1)'))
PREWARM_K = 2
# (c) the twin's readings on the card's own journal: TWIN_REQUESTS one-query
# requests, the two tenants in turns, then the admission gate on a window
# whose forward is held to TWIN_GATE_FORWARD_S by an inference.forward delay
# on top of the card's (a model of a slower forward: two tenants' requests
# that meet wait one forward each, inside gold's 200 ms budget; a heavy
# third tenant makes gold wait two).
TWIN_REQUESTS = 40
TWIN_GATE_REQUESTS = 30
TWIN_GATE_FORWARD_S = 0.085
TWIN_LIGHT_QPS = 1.0
TWIN_HEAVY_QPS = 400.0


def _span_s(name: str):
    """Durations of the finished telemetry spans called ``name``."""
    from rafiki_tpu_torch import telemetry

    return [r.get("dur_s") for r in telemetry.span_records() if r.get("name") == name]


def _set_env(values):
    import os

    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    return saved


def _restore_env(saved):
    import os

    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def autoscale_spike(card, tmp, blobs):
    """Phase 26 (a): the load spike scaled up. Returns the line and the
    job's services manager, job id and gateway, still serving one
    replica (for (c))."""
    import torch

    from rafiki_tpu_torch import chaos, telemetry
    from rafiki_tpu_torch.admin.services_manager import ServicesManager
    from rafiki_tpu_torch.obs.journal import journal, read_dir
    from rafiki_tpu_torch.obs.perf import slo
    from rafiki_tpu_torch.store import MetaStore, ParamsStore
    from rafiki_tpu_torch.tenancy import TenantDirectory, TenantFabric

    t0 = time.monotonic()
    log_dir = tmp / "obs-autoscale"
    store, params = MetaStore(tmp / "meta.sqlite3"), ParamsStore(tmp / "params")
    model = store.create_model("vgg", "IMAGE_CLASSIFICATION", None, AUTOSCALE_SRC, "ScaleVgg")
    tj = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, "x", "y", {})
    sub = store.create_sub_train_job(tj["id"], model["id"])
    trials = []
    for i, b in enumerate(blobs[:K]):
        t = store.create_trial(sub["id"], "vgg", KNOBS)
        store.mark_trial_as_completed(t["id"], 0.5, params.save(b, f"as-t{i}"))
        trials.append(store.get_trial(t["id"]))
    journal.configure(log_dir, role="autoscale")
    saved = _set_env(AUTOSCALE_ENV)
    slo.configure([slo.SloSpec("serving_p99_spike", "gauge:serving.p99_ms", AUTOSCALE_SLO_MS,
                               windows=(AUTOSCALE_WINDOW_S,))], tick_s=0.0)
    telemetry.reset()
    mgr = ServicesManager(store, params)
    job = store.create_inference_job(tj["id"], None)["id"]
    mgr.create_inference_services(job, trials, gateway_overrides=AUTOSCALE_GATEWAY,
                                  tenancy=TenantFabric(TenantDirectory(tiers=AUTOSCALE_TIERS)))
    handle = mgr._inference_jobs[job]
    gw = mgr.get_gateway(job)
    base = handle.workers[0]
    q = queries_for(27)
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    chaos.install(chaos.FaultPlane.from_spec(
        f"seed=11;inference.forward:delay:delay={AUTOSCALE_DELAY_S}:match={base.worker_id}"))
    ctl = mgr.attach_autoscaler(job, min_workers=1, max_workers=2, tick_s=0.2, seed=11)
    lane = ctl._actuators["inference"]
    breach_at = scaled_at = recovered_at = None
    requests = 0
    try:
        t_end = time.monotonic() + AUTOSCALE_DRIVE_S
        while time.monotonic() < t_end:
            gw.predict(q[requests % BATCH:requests % BATCH + 1].tolist())
            requests += 1
            gw.rollup.flush()  # a fresh p99 gauge for every tick of the burn engine
            now = time.monotonic()
            state = slo.engine.collector()["state"].get("serving_p99_spike", {})
            breaching = bool(state.get("breaching"))
            if breaching and breach_at is None:
                breach_at = now
            if scaled_at is None and lane.size() == 2:
                scaled_at = now
            if breach_at is not None and scaled_at is not None and not breaching:
                recovered_at = now
                break
    finally:
        ctl.stop()
        chaos.uninstall()
    actuations = ctl.actuation_count("inference")
    replica = handle.workers[-1] if len(handle.workers) == 2 else None
    registered = replica is not None and replica.worker_id in mgr.bus.get_workers(job)
    got = want = None
    if replica is not None:
        got = np.asarray(replica.model.predict(q.tolist()))
        want = np.asarray(base.model.predict(q.tolist()))
    torch.cuda.synchronize()
    mem_scaled = torch.cuda.memory_allocated()
    # The forced scale-down: drained, reaped, freed (its model destroyed).
    lane.scale_to(1)
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    journal.close()
    _restore_env(saved)
    slo.configure()
    recs = read_dir(log_dir)
    decisions = [r for r in recs if (r.get("kind"), r.get("name")) == ("autoscale", "decision")]
    up = next((r for r in decisions if r.get("direction") == "up" and r.get("actuated")), None)
    breach = next((r for r in recs if (r.get("kind"), r.get("name")) == ("slo", "breach")), None)
    spawn = next((r for r in recs if (r.get("kind"), r.get("name")) == ("autoscale", "spawn")),
                 None)
    first_answer = None
    if replica is not None:
        first_answer = next((r for r in recs if (r.get("kind"), r.get("name"))
                             == ("serving", "hops") and replica.worker_id in (r.get("chains") or {})
                             and any(m[0] == "reply" for m in r["chains"][replica.worker_id])),
                            None)
    build = _span_s("autoscale.actuate")
    line = {"phase": "autoscale_spike", "card": card[1], "power_limit": card[2],
            "requests": requests, "slo_ms": AUTOSCALE_SLO_MS, "window_s": AUTOSCALE_WINDOW_S,
            "delay_s": AUTOSCALE_DELAY_S,
            "decision": {k: up.get(k) for k in ("direction", "current", "target", "pressure",
                                                 "reason", "actuated")} if up else None,
            "decisions": len(decisions), "actuations": actuations,
            "breach_to_actuation_s": (up["ts"] - breach["ts"]) if up and breach else None,
            # The actuation: the replica loaded, stacked and its forward
            # captured, then its bus registration awaited.
            "replica_build_s": build[0] if build else None,
            "serving_graph_captures": telemetry.get_counter("serving.graph_captures"),
            "registration_to_first_answer_s": (first_answer["ts"] - spawn["ts"])
            if first_answer and spawn else None,
            "recovery_s": (recovered_at - breach_at) if recovered_at and breach_at else None,
            "replica_registered": registered,
            "replica_bit_equal": got is not None and got.shape == (BATCH, NUM_CLASSES)
            and bool(np.array_equal(got, want)),
            "lane_events": [list(e) for e in lane.events],
            "workers_after_drain": mgr.bus.get_workers(job),
            "memory_allocated_before_spawn": mem_before,
            "memory_allocated_scaled": mem_scaled,
            "memory_allocated_after_drain": mem_after, "freed_bytes": mem_scaled - mem_after,
            "leak_bytes": TUNE_LEAK_BYTES, "phase_s": time.monotonic() - t0}
    return line, (mgr, job, gw, base, store)


def autoscale_prewarm(card, tmp, prewarm: bool):
    """Phase 26 (b): the canonical k=2 job admitted through the services
    manager, with or without ``RAFIKI_AUTOSCALE_PREWARM``, the program
    cache cleared first. Returns the line."""
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.admin.services_manager import ServicesManager
    from rafiki_tpu_torch.obs.journal import journal, read_dir
    from rafiki_tpu_torch.ops.train import clear_program_cache

    t0 = time.monotonic()
    label = "prewarmed" if prewarm else "cold"
    sub_tmp = tmp / f"prewarm-{label}"
    sub_tmp.mkdir()
    store, params, job = _proc_job(sub_tmp, PREWARM_SRC, "PrewarmVgg", PREWARM_K, PROC_URI)
    log_dir = sub_tmp / "obs"
    journal.configure(log_dir, role="prewarm")
    saved = _set_env({"RAFIKI_AUTOSCALE_PREWARM": "1" if prewarm else "0",
                      "RAFIKI_TRIAL_PACK": str(PREWARM_K)})
    clear_program_cache()
    telemetry.reset()
    mgr = ServicesManager(store, params)
    try:
        misses0 = telemetry.get_counter("program_cache.misses")
        mgr.create_train_services(job["id"], advisor_kind="random")
        mgr._train_jobs[job["id"]].thread.join(timeout=600)
        misses = telemetry.get_counter("program_cache.misses") - misses0
    finally:
        mgr.stop_all()
        journal.close()
        _restore_env(saved)
    recs = read_dir(log_dir)
    pre = [r for r in recs if (r.get("kind"), r.get("name")) == ("autoscale", "prewarm")]
    packed = [r for r in recs if (r.get("kind"), r.get("name")) == ("perf", "step")
              and r.get("program_kind") == "packed"]
    prewarm_s = _span_s("autoscale.prewarm")
    trials = store.get_trials_of_train_job(job["id"])
    built = sum(1 for r in pre if r.get("error") is None and not r.get("hit"))
    return {"phase": f"autoscale_prewarm_{label}", "card": card[1], "power_limit": card[2],
            "k": PREWARM_K, "train_uri": PROC_URI,
            "trial_status": [t["status"] for t in trials],
            "prewarm_records": [{k: r.get(k) for k in ("k", "hit", "error")} for r in pre],
            "prewarm_s": prewarm_s[0] if prewarm_s else None,
            "program_cache_misses": misses, "pack_misses": misses - built,
            "packed_rounds": telemetry.get_counter("worker.packed_rounds"),
            "first_pack_first_epoch_s": packed[0]["dt"] if packed else None,
            "first_pack_first_epoch_cold": packed[0].get("cold") if packed else None,
            "phase_s": time.monotonic() - t0}


def _twin_window(gw, gateway_config, log_dir, n, spacing_s=0.02):
    """``n`` one-query requests through ``gw``, the two tenants of
    AUTOSCALE_TIERS in turns, journaled to ``log_dir``. The gateway
    journaled its limits (``gateway/config``) once, at the service's
    start, into (a)'s journal: the window's journal opens with them."""
    from rafiki_tpu_torch.obs.journal import journal

    q = queries_for(28)
    tenants = sorted(AUTOSCALE_TIERS)
    journal.configure(log_dir, role="twin")
    journal.record("gateway", "config", **gateway_config)
    try:
        for i in range(n):
            gw.predict(q[i % BATCH:i % BATCH + 1].tolist(), tenant=tenants[i % 2])
            time.sleep(spacing_s)
        gw.rollup.flush()
    finally:
        journal.close()


def autoscale_twin(card, tmp, serving):
    """Phase 26 (c): the twin on the card's own journal, then the job
    admission gate. Returns the line."""
    from rafiki_tpu_torch import chaos
    from rafiki_tpu_torch.obs.journal import journal, read_dir
    from rafiki_tpu_torch.obs.twin import validate
    from rafiki_tpu_torch.obs.twin.calibration import Calibration
    from rafiki_tpu_torch.tenancy import JobAdmissionGate
    from rafiki_tpu_torch.tenancy.arbiter import JobRejected

    t0 = time.monotonic()
    mgr, job, gw, base, _ = serving
    config = next({k: v for k, v in r.items() if k not in ("ts", "pid", "role", "kind", "name",
                                                           "trace_id")}
                  for r in read_dir(tmp / "obs-autoscale")
                  if (r.get("kind"), r.get("name")) == ("gateway", "config"))
    read_dir_ = tmp / "obs-twin"
    _twin_window(gw, config, read_dir_, TWIN_REQUESTS)
    cal = Calibration.from_journal_dir(read_dir_)
    kinds = {(r.get("kind"), r.get("name")) for r in read_dir(read_dir_)}
    v = validate.validate(read_dir_, seed=0)
    gate_dir = tmp / "obs-twin-gate"
    forward = cal.dist("forward")
    delay_s = round(max(0.0, TWIN_GATE_FORWARD_S - forward[len(forward) // 2]), 4)
    chaos.install(chaos.FaultPlane.from_spec(
        f"seed=5;inference.forward:delay:delay={delay_s}:match={base.worker_id}"))
    try:
        _twin_window(gw, config, gate_dir, TWIN_GATE_REQUESTS)
    finally:
        chaos.uninstall()
    verdicts_dir = tmp / "obs-arbiter"
    gate = JobAdmissionGate.from_capture(gate_dir, seed=0)
    journal.configure(verdicts_dir, role="arbiter")
    rejected = None
    try:
        light = gate.admit_job("job-light", "carol", "batch", TWIN_LIGHT_QPS)
        try:
            gate.admit_job("job-heavy", "bob", "std", TWIN_HEAVY_QPS)
        except JobRejected as e:
            rejected = e.detail
    finally:
        journal.close()
    arbiter_recs = [r for r in read_dir(verdicts_dir)
                    if (r.get("kind"), r.get("name")) == ("tenancy", "arbiter")]
    mgr.stop_inference_services(job)
    return {"phase": "autoscale_twin", "card": card[1], "power_limit": card[2],
            "calibration": {"segments": {s: len(x) for s, x in cal.segments.items()},
                            "workers": cal.workers,
                            "has_hops": ("serving", "hops") in kinds,
                            "has_ts": ("serving", "ts") in kinds},
            "validate": {"measured": v["measured"],
                         "predicted": {k: v["predicted"][k] for k in ("p50_ms", "p99_ms")},
                         "p50_err": v["p50_err"], "p99_err": v["p99_err"],
                         "tolerance": v["tolerance"], "ok": v["ok"]},
            "gate_forward_s": TWIN_GATE_FORWARD_S, "gate_delay_s": delay_s,
            "gate_existing": {t: [tier, qps] for t, (tier, qps) in gate.existing.items()},
            "light": {k: light.get(k) for k in ("admit", "forecast_p99_ms", "baseline_p99_ms")},
            "heavy": None if rejected is None else {
                "admit": rejected["admit"], "expected_qps": rejected["expected_qps"],
                "breaches": rejected["breaches"]},
            "arbiter_records": [r.get("admit") for r in arbiter_recs],
            "phase_s": time.monotonic() - t0}


def autoscale_phase(card, check, blobs=None, pack=None) -> None:
    """Phase 26 and its checks (also ``--autoscale``)."""
    import tempfile
    from pathlib import Path

    import torch

    t0 = time.monotonic()
    blobs = list(blobs or [make_blob(seed) for seed in range(K)])
    with tempfile.TemporaryDirectory(prefix="autoscale-") as td:
        tmp = Path(td)
        a, serving = autoscale_spike(card, tmp, blobs)
        print(json.dumps(a), flush=True)
        try:
            c = autoscale_twin(card, tmp, serving)
        finally:
            serving[0].stop_all()
        print(json.dumps(c), flush=True)
        torch.cuda.empty_cache()
        cold = autoscale_prewarm(card, tmp, prewarm=False)
        print(json.dumps(cold), flush=True)
        b = autoscale_prewarm(card, tmp, prewarm=True)
        b["cold_first_pack_first_epoch_s"] = cold["first_pack_first_epoch_s"]
        b["saved_s"] = (None if b["first_pack_first_epoch_s"] is None
                        or cold["first_pack_first_epoch_s"] is None
                        else cold["first_pack_first_epoch_s"] - b["first_pack_first_epoch_s"])
        b["phase12_packed_s"] = None if pack is None else pack.get("packed_s")
        print(json.dumps(b), flush=True)
    d = a["decision"] or {}
    check(d.get("direction") == "up" and d.get("actuated"),
          f"autoscale spike: no actuated up decision ({a['decisions']} decisions): {d}")
    check(a["replica_registered"] and a["registration_to_first_answer_s"] is not None,
          f"autoscale spike: the replica registered {a['replica_registered']}, first answer "
          f"{a['registration_to_first_answer_s']}")
    check(a["recovery_s"] is not None and a["recovery_s"] <= AUTOSCALE_RECOVERY_S,
          f"autoscale spike: the burn cleared {a['recovery_s']} s after the breach "
          f"(> {AUTOSCALE_RECOVERY_S} or never)")
    check(a["actuations"] <= AUTOSCALE_MAX_ACTUATIONS,
          f"autoscale spike: {a['actuations']} actuations > {AUTOSCALE_MAX_ACTUATIONS}")
    check(a["replica_bit_equal"],
          "autoscale spike: the replica's answers to 64 queries differ from the base replica's")
    wid = next((e[1] for e in a["lane_events"]), None)
    check([e[0] for e in a["lane_events"]] == ["drained", "reaped", "freed"]
          and len(a["workers_after_drain"]) == 1 and wid not in a["workers_after_drain"],
          f"autoscale spike: drain events {a['lane_events']}, workers {a['workers_after_drain']}")
    check(a["memory_allocated_after_drain"] <= a["memory_allocated_before_spawn"]
          + TUNE_LEAK_BYTES,
          f"autoscale spike: {a['memory_allocated_after_drain']} bytes allocated after the drain, "
          f"{a['memory_allocated_before_spawn']} before the spawn (+{TUNE_LEAK_BYTES} allowed)")
    for run in (cold, b):
        check(run["trial_status"] == ["COMPLETED"] * PREWARM_K and run["packed_rounds"] >= 1,
              f"autoscale prewarm ({run['phase']}): trials {run['trial_status']}, packed rounds "
              f"{run['packed_rounds']}")
    check(b["prewarm_records"] and all(r["error"] is None for r in b["prewarm_records"]),
          f"autoscale prewarm: records {b['prewarm_records']} (want hit or warmed)")
    check(b["pack_misses"] == 0,
          f"autoscale prewarm: the job's pack added {b['pack_misses']} program_cache.misses")
    check(not cold["prewarm_records"], f"autoscale prewarm off: {cold['prewarm_records']}")
    cal = c["calibration"]
    check(cal["has_hops"] and cal["has_ts"] and cal["segments"].get("forward"),
          f"autoscale twin: the journal cannot calibrate: {cal}")
    check(c["light"]["admit"] is True and c["heavy"] is not None and not c["heavy"]["admit"]
          and any(br["tier"] == "gold" for br in c["heavy"]["breaches"])
          and c["arbiter_records"] == [True, False],
          f"autoscale twin gate: light {c['light']}, heavy {c['heavy']}, journaled "
          f"{c['arbiter_records']}")
    print(json.dumps({"phase": "autoscale", "card": card[1], "power_limit": card[2],
                      "phase_s": time.monotonic() - t0}))


def main() -> int:
    import torch

    t_script = time.monotonic()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    # The float32 reference forward must be full float32 on the card too
    # (cuDNN runs float32 convs in TF32 by default). The served bf16
    # path is unaffected by these flags.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:] == ["--bf16-readings"]:
        return bf16_readings()
    if sys.argv[1:2] == ["--resume-child"] and len(sys.argv) == 6:
        return resume_child(*sys.argv[2:])
    if sys.argv[1:] == ["--packed-step"]:
        card = card_identity()
        print(card[0])
        print(json.dumps(graph_step(card)))
        return 0
    counted = sys.argv[1:2] in (["--mesh-repack"], ["--tenancy"]) and len(sys.argv) == 3
    repeats = int(sys.argv[2]) if counted and sys.argv[2].isdigit() else None
    if sys.argv[1:] not in ([], ["--zoo"], ["--obs"], ["--chaos"], ["--process"], ["--mesh"],
                            ["--search"], ["--serve-proc"], ["--tenancy"],
                            ["--autoscale"]) and repeats is None:
        fail(f"unknown arguments {sys.argv[1:]}")
    card = card_identity()
    print(card[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    failures = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(msg)
            print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)

    if sys.argv[1:] == ["--zoo"]:
        zoo_phases(card, check)
        if failures:
            print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
            return 1
        print(json.dumps({"zoo": "ok", "device": torch.cuda.get_device_name(0)}))
        return 0
    if sys.argv[1:] == ["--obs"]:
        observability_phase(card, check)
        if failures:
            print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
            return 1
        print(json.dumps({"obs": "ok", "device": torch.cuda.get_device_name(0)}))
        return 0
    if sys.argv[1:] == ["--chaos"]:
        chaos_phase(card, check)
        if failures:
            print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
            return 1
        print(json.dumps({"chaos": "ok", "device": torch.cuda.get_device_name(0)}))
        return 0
    if sys.argv[1:] == ["--process"]:
        process_phase(card, check)
        if failures:
            print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
            return 1
        print(json.dumps({"process": "ok", "device": torch.cuda.get_device_name(0)}))
        return 0
    if sys.argv[1:] == ["--mesh"]:
        mesh_phase(card, check)
        if failures:
            print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
            return 1
        print(json.dumps({"mesh": "ok", "device": torch.cuda.get_device_name(0)}))
        return 0
    if sys.argv[1:2] == ["--mesh-repack"]:
        for i in range(repeats):
            n_failed = len(failures)
            b = mesh_repack(card)
            check_repack(b, check)
            print(json.dumps({"phase": "mesh_repack", "repeat": i,
                              "passed": len(failures) == n_failed,
                              "trial_status": b["trial_status"],
                              "serial_byte_equal": b["serial_byte_equal"],
                              "replays_by_chip": b["replays_by_chip"], "twin": b["twin"],
                              "job_wall_s": b["job_wall_s"], "phase_s": b["phase_s"]}),
                  flush=True)
        if failures:
            print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
            return 1
        print(json.dumps({"mesh_repack": "ok", "repeats": repeats,
                          "device": torch.cuda.get_device_name(0)}))
        return 0
    if sys.argv[1:] == ["--search"]:
        search_phase(card, check)
        if failures:
            print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
            return 1
        print(json.dumps({"search": "ok", "device": torch.cuda.get_device_name(0)}))
        return 0
    if sys.argv[1:] == ["--serve-proc"]:
        serve_proc_phase(card, check)
        if failures:
            print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
            return 1
        print(json.dumps({"serve_proc": "ok", "device": torch.cuda.get_device_name(0)}))
        return 0
    if sys.argv[1:2] == ["--tenancy"]:
        tenancy_phase(card, check, repeats=repeats or 1)
        if failures:
            print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
            return 1
        print(json.dumps({"tenancy": "ok", "device": torch.cuda.get_device_name(0)}))
        return 0
    if sys.argv[1:] == ["--autoscale"]:
        autoscale_phase(card, check)
        if failures:
            print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
            return 1
        print(json.dumps({"autoscale": "ok", "device": torch.cuda.get_device_name(0)}))
        return 0

    from rafiki_tpu_torch.ops.train import predict
    from rafiki_tpu_torch.parallel.serving import build_stacked
    from rafiki_tpu_torch.predictor.ensemble import ensemble_predictions

    # -- 2. trials -------------------------------------------------------------
    blobs = [make_blob(seed) for seed in range(K)]
    print(f"trials: {K} x VGG{KNOBS['depth']} width_mult={KNOBS['width_mult']}, "
          f"blobs of {len(blobs[0])} bytes (bf16 RTPK1)")

    # -- 3. forward parity, card vs CPU ----------------------------------------
    t_phase = time.monotonic()
    readings, served_probs = [], []  # served_probs: query set 0, per trial
    for b in blobs:
        r, p = forward_readings(b, range(QUERY_SETS))
        readings += r
        served_probs.append(p[0])
    fwd = {key: max(r[key] for r in readings) for key in readings[0] if key != "query_seed"}
    print(json.dumps(dict(fwd, phase="forward_parity", trials=K, query_sets=QUERY_SETS,
                          phase_s=time.monotonic() - t_phase,
                          card=card[1], power_limit=card[2], f32_atol=F32_ATOL,
                          bf16_gap_atol=BF16_GAP_ATOL,
                          bf16_card_vs_cpu_atol=BF16_CARD_VS_CPU_ATOL)))
    check(fwd["f32_card_vs_cpu"] <= F32_ATOL,
          f"float32 forward, card vs CPU: {fwd['f32_card_vs_cpu']} > {F32_ATOL}")
    for dev in ("card", "cpu"):
        got = fwd[f"bf16_vs_f32_{dev}"]
        check(got <= BF16_GAP_ATOL, f"bf16 vs float32 forward on the {dev}: "
                                    f"{got} > {BF16_GAP_ATOL}")
    check(fwd["bf16_card_vs_cpu"] <= BF16_CARD_VS_CPU_ATOL,
          f"bf16 forward, card vs CPU: {fwd['bf16_card_vs_cpu']} > {BF16_CARD_VS_CPU_ATOL}")
    cpu_ens = np.asarray([ensemble_predictions([p["cpu"][i].tolist() for p in served_probs])
                          for i in range(BATCH)], np.float64)
    qarr = queries_for(0)
    queries = qarr.tolist()
    x_card = torch.from_numpy(qarr).cuda()

    # -- 4. serving, both routes, and the device profile of each ---------------
    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stacked, reason = build_stacked([{"model_name": "vgg"}] * K, load(blobs), batch_size=BATCH)
    if stacked is None:
        fail(f"stacked route refused: {reason}")
    warmup_s = stacked.warmup()
    s_single, s_bursts, s_time = serve([stacked], queries, "stacked", card)
    s_time["warmup_s"] = warmup_s
    s_time["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    s_time["device_profile"] = device_profile(lambda: stacked._ens.forward(x_card))
    stacked.destroy()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    replicas = load(blobs)
    r_single, r_bursts, r_time = serve(replicas, queries, "replicated", card)
    r_time["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    r_time["device_profile"] = device_profile(
        lambda: [predict(m._module, x_card) for m in replicas])

    n = len(s_single)  # the single requests asked the first n queries
    errs = {
        "stacked_vs_replicated": float(np.abs(s_single - r_single).max()),
        "stacked_vs_cpu_ensemble": float(np.abs(s_single - cpu_ens[:n]).max()),
        "replicated_vs_cpu_ensemble": float(np.abs(r_single - cpu_ens[:n]).max()),
        "burst_vs_single": max(float(np.abs(b[:n] - s_single).max())
                               for b in s_bursts + r_bursts),
    }
    print(json.dumps(s_time))
    print(json.dumps(r_time))
    print(json.dumps(dict(errs, phase="route_parity", card=card[1], power_limit=card[2],
                          route_atol=ROUTE_ATOL, cpu_atol=ENSEMBLE_ATOL,
                          phase_s=time.monotonic() - t_phase)))
    for name, got in (("stacked", s_single), ("replicated", r_single)):
        check(got.shape == (N_SINGLE, NUM_CLASSES) and bool(np.isfinite(got).all()),
              f"{name}: outputs of shape {got.shape} or non-finite")
        check(float(np.abs(got.sum(-1) - 1.0).max()) <= 1e-5,
              f"{name}: ensembled probabilities do not sum to 1")
    check(errs["stacked_vs_replicated"] <= ROUTE_ATOL and errs["burst_vs_single"] <= ROUTE_ATOL,
          f"routes disagree: {errs}")
    check(max(errs["stacked_vs_cpu_ensemble"], errs["replicated_vs_cpu_ensemble"])
          <= ENSEMBLE_ATOL, f"served ensemble disagrees with the CPU ensemble: {errs}")

    replicas = None

    # -- 6.-7. the canonical tune job, and its top-2 served --------------------
    from rafiki_tpu_torch.obs.health import DivergenceError

    tune_rows, job, best = tune_job(card, advisor_kwargs=TUNE_ADVISOR)
    for row in tune_rows:
        print(json.dumps(row))
    print(json.dumps(job))
    check(job["status"] == "COMPLETED" and job["trials"] == TUNE_TRIALS and not job["errors"],
          f"tune job: {job['status']}, {job['trials']} trials, errors {job['errors']}")
    for row in tune_rows:
        check(row["status"] == "COMPLETED" or (row["error"] or "").startswith("diverged:"),
              f"tune trial {row['no']}: {row['status']} and not a contained divergence: "
              f"{row['error']}")
    check(job["gp_ei_proposals"] >= 1, f"tune job: no proposal from expected improvement {job}")
    check(job["graph_replays"] > 0, f"tune job: no captured step replayed {job}")
    check(job["best_score"] is not None and job["best_score"] >= TUNE_TOP1_TARGET,
          f"tune job: best score {job['best_score']} < {TUNE_TOP1_TARGET}")
    ev = job["evaluated_memory_allocated_bytes"]
    check(len(ev) == job["completed"] and ev and ev[-1] <= ev[0] + TUNE_LEAK_BYTES,
          f"tune job: memory allocated after the last trial {ev[-1:]} > after the first "
          f"{ev[:1]} + {TUNE_LEAK_BYTES}")
    check(len(best) == 2, f"tune job: {len(best)} completed trials to serve, expected 2")
    t_phase = time.monotonic()
    served = served_accuracy(best, card)
    served["phase_s"] = time.monotonic() - t_phase
    print(json.dumps(served))
    check(max(served["abs_diff"]) <= SERVED_ACC_ATOL,
          f"served accuracy disagrees with the stored score: {served}")
    del best
    torch.cuda.empty_cache()

    # -- 8.-10. one canonical trial, FeedForward, card-vs-CPU parity -----------
    try:
        vgg, trained, _ = train_trials(card)
    except DivergenceError as e:
        fail(f"canonical trial diverged: {e.verdict}")
    print(json.dumps(vgg))
    for t in vgg["trials"]:
        check(all(np.isfinite(ep["loss"]) for ep in t["epochs"]),
              f"trial seed {t['seed']}: non-finite loss {t['epochs']}")
        check(t["eval_acc"] >= ACC_FLOOR,
              f"trial seed {t['seed']}: eval accuracy {t['eval_acc']} < {ACC_FLOOR}")
    check(vgg["graph_replays"] > 0, f"canonical trial: no captured step replayed {vgg}")
    del trained
    torch.cuda.empty_cache()
    try:
        ff = train_ff(card)
    except DivergenceError as e:
        fail(f"FeedForward trial diverged: {e.verdict}")
    print(json.dumps(ff))
    check(all(np.isfinite(ep["loss"]) for ep in ff["epochs"]), f"FeedForward: non-finite loss {ff}")
    check(ff["eval_acc"] >= FF_ACC_FLOOR, f"FeedForward: eval accuracy {ff['eval_acc']} < {FF_ACC_FLOOR}")
    check(ff["reloaded_eval_acc"] == ff["eval_acc"], f"FeedForward: reloaded blob scores otherwise {ff}")
    parity = training_parity(card)
    print(json.dumps(parity))
    for i, r in enumerate(parity["steps"]):
        check(r["nonfinite"] == (0.0, 0.0), f"parity step {i}: non-finite {r}")
        for key, bound in PARITY_TOL.items():
            check(r[key] <= bound, f"parity step {i}: {key} {r[key]} > {bound}")

    # -- 11. the service journey ----------------------------------------------
    torch.cuda.empty_cache()
    print(json.dumps(service_journey(card)))

    # -- 12.-13. trial packing ----------------------------------------------
    torch.cuda.empty_cache()
    pack = trial_pack(card)
    print(json.dumps(pack))
    for name, eps in (("serial", pack["serial_epochs"]), ("packed", pack["packed_epochs"])):
        check(all(np.isfinite(ep["loss"]) for trial in eps for ep in trial),
              f"trial_pack: non-finite {name} loss {eps}")
    check(max(pack["score_abs_diff"]) <= PACK_SCORE_ATOL,
          f"trial_pack: packed scores {pack['packed_scores']} against serial "
          f"{pack['serial_scores']}, atol {PACK_SCORE_ATOL}")
    check(pack["serial_graphs"]["graph_replays"] > 0
          and pack["packed_graphs"]["graph_replays"] > 0,
          f"trial_pack: no captured step replayed: serial {pack['serial_graphs']}, packed "
          f"{pack['packed_graphs']}")
    member = PACK_MEMBERS.index({"learning_rate": 1e-3, "dropout": 0.1})
    check(pack["packed_scores"][member] >= ACC_FLOOR,
          f"trial_pack: the lr 1e-3 dropout 0.1 member scored "
          f"{pack['packed_scores'][member]} < {ACC_FLOOR}")
    scaling = pack_scaling(card)
    print(json.dumps(scaling))
    one = scaling["f32_one_member_pack_vs_serial"]
    check(one["loss"][0] == one["loss"][1] and not one["grads_differing"],
          f"pack_scaling: a one-member pack's float32 step is not the serial step: loss "
          f"{one['loss']}, gradients differing {one['grads_differing']}")
    torch.cuda.empty_cache()
    tune_rows, pjob, best = tune_job(card, trial_pack=PACK_K, advisor_kwargs=TUNE_ADVISOR)
    pjob["serial_job_completed_trials_per_hour"] = job["completed_trials_per_hour"]
    for row in tune_rows:
        print(json.dumps(dict(row, phase="tune_trial_packed")))
    print(json.dumps(pjob))
    check(pjob["status"] == "COMPLETED" and pjob["trials"] == TUNE_TRIALS and not pjob["errors"],
          f"tune job packed: {pjob['status']}, {pjob['trials']} trials, errors {pjob['errors']}")
    for row in tune_rows:
        check(row["status"] == "COMPLETED" or (row["error"] or "").startswith("diverged:"),
              f"tune job packed, trial {row['no']}: {row['status']} and not a contained "
              f"divergence: {row['error']}")
    check(pjob["gp_ei_proposals"] >= 1,
          f"tune job packed: no proposal from expected improvement {pjob}")
    check(pjob["best_score"] is not None and pjob["best_score"] >= TUNE_TOP1_TARGET,
          f"tune job packed: best score {pjob['best_score']} < {TUNE_TOP1_TARGET}")
    check(pjob["packed_rounds"] >= 1, f"tune job packed: no packed round {pjob}")
    check(pjob["graph_replays"] > 0, f"tune job packed: no captured step replayed {pjob}")
    check(pjob["memory_allocated_after_job"] <= pjob["memory_allocated_before_job"]
          + TUNE_LEAK_BYTES,
          f"tune job packed: {pjob['memory_allocated_after_job']} bytes allocated after the "
          f"job, {pjob['memory_allocated_before_job']} before (+{TUNE_LEAK_BYTES} allowed)")
    check(len(best) == 2, f"tune job packed: {len(best)} completed trials to serve, expected 2")
    t_phase = time.monotonic()
    served = dict(served_accuracy(best, card), phase="served_vs_evaluated_packed")
    served["phase_s"] = time.monotonic() - t_phase
    print(json.dumps(served))
    check(max(served["abs_diff"]) <= SERVED_ACC_ATOL,
          f"tune job packed: served accuracy disagrees with the stored score: {served}")
    del best

    # -- 14.-15. checkpoints, resume and orphan recovery -----------------------
    import os

    torch.cuda.empty_cache()
    prev_dtype = os.environ.get("RAFIKI_TPU_SERVING_PARAMS_DTYPE")
    os.environ["RAFIKI_TPU_SERVING_PARAMS_DTYPE"] = "float32"  # blobs compared bit for bit
    try:
        resumed = trial_resume(card)
        print(json.dumps(resumed))
        torch.cuda.empty_cache()
        presumed = pack_resume(card)
        print(json.dumps(presumed))
    finally:
        if prev_dtype is None:
            os.environ.pop("RAFIKI_TPU_SERVING_PARAMS_DTYPE", None)
        else:
            os.environ["RAFIKI_TPU_SERVING_PARAMS_DTYPE"] = prev_dtype
    check(resumed["post_status"] == 200 and resumed["status"] == "COMPLETED"
          and [s for _, s in resumed["recovered"]] == ["COMPLETED"],
          f"trial_resume: POST /recovery {resumed['post_status']}, recovered "
          f"{resumed['recovered']}, trial {resumed['status']}")
    check(resumed["resumed_from_epoch"] and min(resumed["resumed_from_epoch"]) >= 1
          and not resumed["restore_failed"],
          f"trial_resume: resumed from {resumed['resumed_from_epoch']}, "
          f"{resumed['restore_failed']} restores failed")
    check(resumed["params_byte_equal"],
          "trial_resume: the recovered trial's params differ from the uninterrupted run's")
    check(not resumed["checkpoints_left"] and resumed["orphans_left"] == 0,
          f"trial_resume: checkpoints left {resumed['checkpoints_left']}, orphans left "
          f"{resumed['orphans_left']}")
    check(presumed["status"] == ["COMPLETED"] * len(PACK_RESUME_KNOBS)
          and len(presumed["recovered"]) == len(PACK_RESUME_KNOBS),
          f"pack_resume: recovered {presumed['recovered']}, members {presumed['status']}")
    check(all(r and min(r) >= 1 for r in presumed["resumed_from_epoch"])
          and not presumed["restore_failed"],
          f"pack_resume: resumed from {presumed['resumed_from_epoch']}, "
          f"{presumed['restore_failed']} restores failed")
    check(all(presumed["params_byte_equal"]),
          f"pack_resume: members' params against their serial runs: "
          f"{presumed['params_byte_equal']}")
    check(presumed["checkpoints_left"] == 0 and presumed["orphans_left"] == 0,
          f"pack_resume: checkpoints left {presumed['checkpoints_left']}, orphans left "
          f"{presumed['orphans_left']}")
    check(resumed["graph_replays"] > 0 and presumed["graph_replays"] > 0,
          f"resume phases: no captured step replayed: {resumed['graph_replays']}, "
          f"{presumed['graph_replays']}")

    # -- 16. the captured step against the eager step ---------------------------
    torch.cuda.empty_cache()
    steps = graph_step(card)
    print(json.dumps(steps))
    for name, equal in steps["bit_equal"].items():
        check(all(equal.values()), f"graph_step: the captured {name} step is not the eager "
                                   f"step bit for bit: {equal}")
    for name in ("serial", "packed"):
        check(steps[f"{name}_captured"]["graph_replays"] > 0,
              f"graph_step: the {name} epoch replayed no captured step")
    phase16_nodes = steps["serial_captured"]["graph_kernel_nodes"]
    del steps

    # -- 17.-18. the rest of the zoo ---------------------------------------------
    zoo_phases(card, check)

    # -- 19. the observability plane ----------------------------------------------
    torch.cuda.empty_cache()
    observability_phase(card, check)

    # -- 20. fault injection and divergence capsules ---------------------------------
    torch.cuda.empty_cache()
    chaos_phase(card, check, phase16_nodes)

    # -- 21. process workers and within-trial data parallelism ------------------------
    torch.cuda.empty_cache()
    process_phase(card, check)

    # -- 22. the mesh sweep, its write-ahead log and resume, the sharded lane -----------
    torch.cuda.empty_cache()
    mesh_phase(card, check)

    # -- 23. the search plane: early kill, speculation, the advisor audit ---------------
    torch.cuda.empty_cache()
    search_phase(card, check)

    # -- 24. serving across processes and its request anatomy ---------------------------
    torch.cuda.empty_cache()
    serve_proc_phase(card, check, blobs)

    # -- 25. multi-tenant serving: co-hosting, tenant isolation --------------------------
    torch.cuda.empty_cache()
    tenancy_phase(card, check, blobs)

    # -- 26. closed-loop elasticity and the serving twin ----------------------------------
    torch.cuda.empty_cache()
    autoscale_phase(card, check, blobs, pack)

    # -- kernels and the result line -------------------------------------------
    print(json.dumps({"script": "chip_smoke", "card": card[1], "power_limit": card[2],
                      "total_s": time.monotonic() - t_script}))
    print(json.dumps({"kernels": []}))
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
