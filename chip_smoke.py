#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``analytics_zoo_tpu_torch``).

Runs the port's serving paths (generation, predict, image classification,
recommendation, the recurrent, text and time-series zoos, the HTTP front
door with its armour, the fleet control plane) and its
training paths (with the Estimator's checkpoints, retries, preemption,
k-step CUDA graphs, TensorBoard files and profile) on one NVIDIA GPU and checks them, phase by phase, each
phase printing its own lines:

1. card — the card's name and power limit (``nvidia-smi``) and the build of
   every CUDA kernel (one ``nvcc`` per source, started together): ptxas's
   registers, spills and static shared memory, the dynamic shared memory
   of the forward, ``fused_bn``, ``w8a8``, ``w4a16``, paged and
   ``w8a8_conv2d`` kernels, and their SASS (``cuobjdump``), which must
   hold the tensor-core products (TF32 HMMA in the flash kernels, f32
   ``fused_bn`` and f32-x ``w4a16``, BF16 HMMA in bf16 ``fused_bn`` and
   bf16-x ``w4a16``, s8 IMMA in ``w8a8`` and in ``w8a8_conv2d`` where it
   builds its A tiles byte by byte, s8 IGMMA (wgmma) where it copies them),
   and no spill in ``w8a8_conv2d``.
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it, then timed on the device (CUDA graph
   replay between CUDA events) beside its plain version and, where one
   PyTorch call computes the same function, that call.  The paged, w8a8
   and w4a16 timings cycle through enough input sets that one pass reads
   more than 100 MB (twice the L2), so no call finds its inputs in L2:
   - paged decode attention (8 rows, 12 heads, head_dim 64, 16-token
     blocks; f32 and int8 pools): parity at decode-time tables (16
     entries, one partition), a long cache's (64 entries, two partitions
     by the rule and four forced) at lengths 0, 1, a partition's edge +-1
     and past the table, 8 forced partitions, and every head_dim; timed
     at the main path's shape (16-entry tables, lengths 17-192) and at
     GPT-2's full context (64-entry tables, lengths 769-1024);
   - flash attention forward (f32 and bf16, causal and not, T = 77, 1000
     and 1024, with and without LSE, q/k/v read in place from a fused
     (B, T, 3·H·D) projection); timed at (8, 12, 1024, 64) f32 causal,
     without the LSE (predict) and with it (training), and at T = 128 and
     512 (the H100's crossover against the plain path and SDPA);
   - w8a8, bitwise in every ``W8_CASES`` case (M = 1 to 64, K below one
     k-step, ragged, odd and past one x segment, N = 1, 15, 61, 50257, a
     weight one byte into its buffer, all -128 / 127), timed at the
     predict head (M = 8, K = 768, N = 50257) and at M = 1 and 33 beside
     ``torch._int_mm`` + scale;
   - w4a16 (f32 and bf16 x) at the predict head and at ragged shapes:
     groups straddling a chunk and the two halves, odd K, M = 1, 17, 33,
     several x segments, a packed weight not on 16 bytes.
3. generation — ``TransformerLM`` at GPT-2-small geometry served by
   ``ClusterServing`` in generation mode with ``warmup`` (16 prompts, two
   waves sent once the warm-up reports ``ready``): paged lanes with f32
   and int8 KV, then monolithic per-slot lanes (``paged=false``, two
   capacity buckets).  The warm-up captures one CUDA graph a decode lane
   and fails no entry; the waves run every decode quantum as a graph
   replay (no capture, no eager quantum, so no paged launch counted by
   the wrapper, which a replay does not run).  Each paged variant serves
   twice: a timed run, then the same waves under a profiler trace of the
   card (``ops/_impl.card_launches``), which must show the paged kernel
   run decode steps x 12 times.  Token sequences cross-checked against
   the plain-attention batcher (the traced run's against the timed
   run's), and the monolithic lanes' against the paged f32 lane's
   (equal, or parting only at a near tie).
   Then continuity (checkpoints every 8 tokens, resume on): (a) four
   served requests, two sharing the 32-token prefix, resumed on a bare
   batcher at depths 1, 8, 17 and 63 of their served tokens, epoch 1, in
   paged f32, paged int8 and monolithic lanes through the kernels (eager
   quanta: the wrapper counts decode steps x 12 paged launches): every
   request resumed, partials past their depth, checkpoints of epoch 1,
   tokens equal to the served ones or parting at a near tie; (b) a victim
   process (this script with ``--resume-victim DIR``, a fresh interpreter
   holding the same seeded weights, checked by a parameter checksum)
   serves both waves over a ``FileQueue`` with checkpoints spooled and is
   killed by its ``decode_crash_after_n_tokens`` fault after 512 tokens
   (exit code 3); this process then serves as the survivor over the same
   directory and must answer all 16 records: resumes and wasted tokens as
   the queue and the spool say, tokens equal to the paged f32 run's or
   parting at a near tie, no failed warm-up entry, no extra capture, no
   eager quantum, and paged launches on the card (profiler trace) =
   decode steps x 12.  Prints the victim's checkpoint time a boundary,
   the spool's bytes, the survivor's wall time and the resumed records'
   TTFT.
4. predict — ``Sequential([TransformerLayer(GPT-2 small, T = 1024),
   GlobalAveragePooling1D, Dense(50257, softmax)])`` from ``--seed``,
   loaded by ``InferenceModel.do_load_model`` and served by
   ``ClusterServing`` in predict mode over ``InProcQueue`` (32 records of
   1024 token ids, batch 8, pipelined workers): f32, then int8 and int4
   heads (``ServingParams.quantize``).  Each engine warms its buckets (1,
   2, 4, 8) first (one eager run each), and every forward then finds its
   bucket warm.  Served under a profiler trace of the card: flash
   launches on the card = by the wrapper = 12 x forwards, w8a8 / w4a16
   launches = forwards; served top-5 probabilities checked against the
   same model with every kernel's plain version.
5. training — the flash backward's dq and dk/dv kernels against their
   plain version (f32 and bf16, causal and not, T = 77, 1000 and 1024,
   head_dim 32/64/128, with and without an LSE cotangent, strided views;
   the (8, 12, 1024, 64) path shape with a planted fault and a bitwise
   determinism check) and timed beside the plain backward and SDPA's
   backward; then ``Estimator.fit`` of ``Sequential([TransformerLayer(GPT-2
   small, T = 1024), Dense(50257, softmax)])`` (Adam 3e-4, global-norm
   clip 1.0) over 64 seeded sequences, 8 steps of 8 x 1024 tokens, once
   through the kernels and once through their plain versions from the same
   weights: flash forward, dq and dk/dv launches = 12 x 8 each, losses
   equal within a tolerance at every step, and falling.
6. resnet — the fused 1x1-conv + BN-statistics kernel (``fused_bn``)
   against its plain version at every distinct (M, K, N) the fusion plan
   of ResNet-50 gives at batch 128, f32 and bf16, and at ragged shapes; two
   launches bitwise equal; a planted y-scale fault and a dropped M-tile
   partial rejected; timed in f32 at every path shape beside
   ``torch.matmul`` alone, ``torch.matmul`` + a separate stats pass and the
   bound, summed over a step's 33 launches, and at the probe's shape
   (401408, 256) @ (256, 64) in bf16, with the plain version at the probe
   shape in both.  Then ``Estimator.fit`` of
   ``ImageClassifier("resnet50").model`` (224x224x3, 1000 classes, SGD 0.05
   momentum 0.9, f32, TF32 off, cuDNN deterministic) over seeded synthetic
   images of 100 classes: one warm-up step and 8 steps of 128 through the
   kernel and through its plain version from the same weights (fused
   launches = 33 x 9 and 0, losses falling).  Two free-running f32
   trainings part within a step (an f32 step's gradients are ~2% from
   f64 on either route, which the phase reads), so the routes are held
   together in lockstep: at every step's weights the training forward
   through the kernel and through the plain version, within a tolerance
   that a planted lost tile partial exceeds; ``Estimator.evaluate`` on a
   held-out batch (moving statistics) equal on both routes.
7. image — ``ImageClassifier("resnet50")``'s quantized forward at a batch
   of 16: the ``w8a8_conv2d`` kernel (``csrc/quant_conv.cu``) bitwise
   against its plain version at ResNet-50's 11 spatial path shapes (20
   launches a forward; the weight packed K-major beforehand, the rule's
   tile and split), at ragged shapes, and at every tile config and split
   forced at ``CONV_FORCED`` shapes; three planted faults (a dropped k
   piece of the weight, pads shifted by one, a split whose merge leaves
   out one block's partial: a build of the kernel with ``CV_MERGE_SKIP``)
   rejected; timed at each path shape (with its tile and split) and
   summed over a forward beside its plain version, cuDNN's f32
   convolution of the same shape (not the same function) and the bound; the w8a8 (bitwise) and w4a16 kernels at the forward's 13
   distinct pointwise (M, K, N) (34 launches), timed likewise (w8a8 beside
   ``torch._int_mm`` + scale).  Then the model from ``--seed`` (weights
   and BN state through ``InferenceModel.do_load_model``) served by
   ``ClusterServing`` in predict mode over ``InProcQueue``: 64 PNG image
   records (``InputQueue.enqueue_image``, half on the float path, half on
   the ``device_uint8`` path, resized by the engine to 224 x 224), batch
   16, every bucket warmed first (which packs each int8 spatial conv's
   weight once; the packs' resident bytes are read), in f32, int8
   (``ServingParams.quantize`` calibrated from a seeded ``.npy`` batch)
   and int4, each under a
   profiler trace of the card: conv launches = 20 x forwards and w8a8 =
   34 x forwards in int8, w4a16 = 34 x forwards in int4, none in f32, on
   the card and by the wrappers; the int8 top-5 bit for bit equal to the
   same model's through every kernel's plain version, f32 and int4 within
   ``IMAGE_LOGP_TOL``; weight bytes, records/s, e2e p50 and the model's
   images/s alone (readings); ``predict_image_set`` over seeded images
   through the default preprocessing chain.
8. recommendation — the w8a8 (bitwise, each weight its own allocation
   of exactly its bytes and again inside a buffer of 127s) and w4a16
   kernels at the recommendation models' Dense shapes, M = 1, 8192 and
   9000, then each distinct (K, N) timed at M = 8192 and summed over a
   forward of each model (w8a8 beside ``torch._int_mm`` + scale).  Then
   ``NeuralCF`` at MovieLens-1M width (6040 users, 3706 items, embeds 64,
   MLP (128, 64, 32)) from ``--seed``, trained with ``Estimator.fit``
   for 2 epochs on ``synthetic_ml1m``'s leave-one-out split with 4
   negatives a positive (Adam 1e-3, batch 4096) and ranked after each
   epoch by the NCF protocol (``evaluate_ranking``: 99 unseen negatives,
   HR@10 / NDCG@10): the loss falls and HR@10 >= 0.50 after epoch 2.
   The trained weights go through ``InferenceModel.do_load_model`` and
   rank the 604,000 candidates (batch 8192) in f32, int8 (calibrated on
   one batch of candidates, ``[(users, items)]``) and int4, each under a
   profiler trace of the card: w8a8 = 4 x forwards in int8, w4a16 = 4 x
   forwards in int4, neither in f32, on the card = by the wrappers; int8
   probabilities bit for bit the plain route's, int4 within W4_TOL;
   each HR@10 within 0.02 of f32's; ``recommend_for_user`` for 4 users
   the top 10 of the f32 scores.  Then ``WideAndDeep`` (wide_n_deep) at
   the Census example's columns over its surrogate (numpy, its draws and
   label rule): 3 epochs of 16,000 rows at batch 256, the loss falling
   and test accuracy above the majority class; int8 and int4 predict of
   the 4000 test rows bitwise / within W4_TOL of the plain route, 5
   launches a forward of the route's kernel on the card.
9. recurrent — the w8a8 (bitwise, each weight exact and inside a buffer
   of 127s) and w4a16 kernels at the recurrent zoo's Dense shapes (K = 20,
   100, 40, 15; N = 37,484, 40, 20, 1) at M = 1, 1024 and 1000, each
   timed at M = 1024 beside ``torch._int_mm`` + scale and the plain
   version, and summed over each model's forward.  Then
   ``SessionRecommender`` at RSC15's item count (37,483 items, embed 100,
   GRU (40, 20), the history branch with MLP (40, 20)) from ``--seed``,
   trained with ``Estimator.fit`` for 2 epochs of 65,536 seeded sessions
   (each inside one of 64 item clusters, Zipf popularity within it;
   Adam 1e-3, batch 1024) and ranked after each epoch on 8,192 held-out
   sessions (Recall@20, MRR@20, beside the popularity baseline): the loss
   falls and Recall@20 reaches SESSION_RECALL_MIN.  The trained weights
   are served through ``InferenceModel`` at batch 1024 in f32, int8
   (calibrated on 4 batches) and int4, each under a profiler trace of the
   card: w8a8 = 4 x forwards in int8, w4a16 = 4 x forwards in int4, on the
   card = by the wrappers; int8 probabilities bit for bit the plain
   route's, int4 within W4_TOL, each Recall@20 within 0.02 of f32's;
   ``recommend_for_session`` for 4 sessions.  ``AnomalyDetector`` at the
   example's configuration over its series at nyc_taxi's 10,320 points:
   3 epochs at batch 64, the planted anomalies flagged, int8 and int4
   predict (1 launch a forward, int8 bitwise the plain route's).
   ``Seq2seq`` (vocab 2048, embed 64, hidden (256,), dense bridge) served
   by ``ClusterServing`` on bare-state lanes with warm-up (the lane's
   quantum one CUDA graph): 64 requests of 4-24 tokens, budgets cycling
   4-256, every one equal to its own ``Seq2seq.infer`` or parting at a
   near tie; a bare batcher's graph route equal to its eager route; a
   reclaimed record that carries a snapshot restarted from 0 with the
   downgrade event.
10. text — ``w8a8_conv2d`` at the one-row geometries of a 1-D convolution
   (the (1, k) conv of (B, 1, T, C): T 500 and 499, 200, 300 and 16
   channels, kernels 5 and 4, valid and same, dilation 2) bitwise against
   its plain version, timed at the classifier's (128, 1, 500, 200) x (1, 5,
   200, 256) beside cuDNN's f32 convolution of that shape and the bound;
   ``w8a8`` (bitwise) and ``w4a16`` at the heads' (K, N) (256, 128), (128,
   20) and KNRM's (21, 1), timed.  Then ``TextClassifier`` at news20 width
   (embedding 200, sequence 500, encoder 256, 20 classes, 5000 words plus
   padding) over a seeded 20-topic corpus through ``TextSet`` (tokenize,
   normalize, ``word2idx``, ``shape_sequence``, ``gen_sample``) with a
   seeded table in GloVe's place: the cnn encoder trained 2 epochs of
   8192 documents at 128 (``compile`` / ``fit``, Adam) and evaluated, the
   lstm and gru encoders stepped; each served through ``InferenceModel``
   in f32, int8 and int4 (int8 bitwise, int4 within W4_TOL of the plain
   route, launches on the card = by the wrappers: conv 1 and w8a8 2 a cnn
   forward in int8, w4a16 2 in int4), and the cnn one through
   ``ClusterServing`` over 64 tensor records of 500 ids.  ``NER`` at the
   reference's widths (9 BIO tags, 20,000 words, 100 characters, words of
   12, sentences of 40) trained 2 epochs of 4096 sentences at 32 on the
   CRF loss, its Viterbi paths scored (token accuracy, entity-span F1);
   ``SequenceTagger`` and ``IntentEntity`` stepped; ``KNRM`` at WikiQA's
   widths (10 / 40 tokens, embedding 300, 21 kernels) trained and ranking
   256 held-out groups (NDCG@3, MAP) in f32, int8 and int4.
11. forecast — the w8a8 (bitwise, each weight exact and inside a buffer
   of 127s) and w4a16 kernels at the forecasting heads' (K, N) = (8, 1),
   (16, 1), (32, 1) and (64, 1) at M = 1, 32, 64 and 1024, each timed at
   1024 beside ``torch._int_mm`` + scale and the plain version.  Then
   AutoTS (``AutoTSTrainer`` with ``LSTMGridRandomRecipe(epochs=1)``, its
   own grid at parallelism 2) over a seeded series of nyc_taxi's 10,320
   half-hourly points from 2014-07-01 (daily and weekly seasonality and
   noise; 80% train, 10% validation): each trial's config, validation
   MSE and wall; ``TSPipeline.evaluate`` on the last 10% (MSE, sMAPE)
   beside the persistence and seasonal-naive forecasts, its MSE at most
   FORECAST_RATIO_MAX of the better one's; ``save`` / ``load`` predicting
   bit for bit; the same trials at parallelism 1 with identical metrics.
   ``MTNetForecaster`` at the JAX defaults trained 2 epochs (the loss
   falls), a ``TimeSequencePredictor`` fit with ``MTNetSmokeRecipe``,
   ``Seq2SeqForecaster`` stepped, ``PopulationTrainer`` with 8
   LSTMForecaster-shaped members (each member's loss falls, the best
   member's weights in a plain model reproduce its loss).  The best
   pipeline's model, the best member in an ``LSTMForecaster`` and MTNet
   served through ``InferenceModel`` in f32, int8 (calibrated on one
   batch of windows) and int4 under a profiler trace of the card: w8a8 =
   forwards in int8, w4a16 = forwards in int4, none in f32 and none for
   MTNet (which quantizes nothing, as in the JAX package, and equals
   f32), on the card = by the wrappers; int8 bitwise the plain route,
   int4 within W4_TOL; the int8 pipeline model over 64 ``ClusterServing``
   records of windows, each equal to ``do_predict``.
12. front door — GPT-2-small generation (paged f32 KV, 8 slots, partials
   every 8 tokens, warmed) served by ``ClusterServing`` with its HTTP
   gateway on an ephemeral port, tenant admission (``acme`` far above the
   traffic, ``slowco`` at 2 records/s with a burst of 4), the brownout
   ladder over a loose objective, metering on (the default) and
   profiling: phase 3's 16 prompts fed from the queue, then over HTTP as
   binary frames from 4 clients under both tenants, the clients in
   another process and then on threads of this process (a ``retune``
   under that traffic shows in ``knobs()`` and a ``retune`` event), then
   from the queue again — tokens/s, TTFT p50 and decode boundaries of
   each round, every token list equal to phase 3's (or parting at a near
   tie), every partial seen a prefix; slowco past its bucket draws 429s
   whose ``Retry-After`` is the bucket's refill time and queues nothing,
   acme passes; ``POST /debug/profile?seconds=2`` during traffic answers
   202, a second 409, and the trace's kernel events hold the paged
   kernel's; a traced wave after it counts paged launches = decode steps
   x 12; ``/healthz`` carries the ``resources``, ``process``, ``knobs``,
   ``usage``, ``admission`` and ``brownout`` blocks, ``/readyz`` answers
   200, the Prometheus text holds the gateway, device-seconds and
   ``serving_hbm_bytes`` series; the ledger's weights are the stored
   parameters' bytes, its kv_state the batcher's ``state_bytes()``, and
   weights + kv_state + the CUDA-graph pools within
   ``torch.cuda.memory_allocated()``; ``drain_usage()``'s device seconds
   equal the walls the meter was charged, and each tenant's records and
   tokens what was delivered to it (less each request's prefill token,
   which the meter charges outside the decode boundaries, as the JAX
   engine's does).  A second engine whose objective every record misses
   climbs the ladder: at stage 2 batch records end at
   ``batch_max_tokens`` (interactive ones at their budget) and no partial
   is written.  Then phase 4's model with its int8 head takes 32 JSON
   records over HTTP: each top-5 bit for bit ``InferenceModel.predict``'s
   on the batch the engine formed, flash forward and w8a8 launches on the
   card = by the wrappers; records/s, the gateway's p50 by endpoint and
   the phase's wall.
13. fleet — the control plane, run by the manager in subprocesses of
   this script (never a fork of it) under a temporary directory, with a
   ``file:`` queue and ephemeral ports.  (1) Phase 4's model with its
   int8 head from a seeded ``.npz`` and a topology file: ``manager
   warmup`` (``quantize`` calibrated on a seeded ``.npy`` batch) exports
   the quantized store, a second ``warmup`` skips it, neither runs
   ``nvcc``; ``InferenceModel.do_load`` here maps it (``load_mmap``) and
   its top-5 (every probability) equals, bit for bit, the int8 predict of
   the same model quantized here on the same batch, through 12 flash
   forward launches and one ``w8a8`` a forward on the card = by the
   wrappers; ``load_seconds`` from the store and from the ``.npz``.  (2)
   Phase 3's GPT-2-small deployment (paged f32 KV, 8 slots, warmed,
   partials and checkpoints every 8 tokens, resume on) under ``manager
   start --replicas 2 --lb-port P --autoscale --foreground``: the
   pre-warm exports the store, both replicas reach ``/readyz`` with the
   store mapped, warm-up failed 0 and no ``nvcc`` of their own; each
   replica's time to ready, its ledger and ``nvidia-smi``'s memory.  (3)
   Phase 3's 16 prompts through the load balancer from 4 client threads:
   every token list phase 3's (or parting at a near tie), both replicas
   served, tokens/s and TTFT p50 (``histogram_quantile`` over the
   fleet's merged buckets) beside phase 3's single engine; ``manager
   metrics --all-replicas --prom`` sums the replicas' decode steps;
   ``manager profile 0 --seconds 2`` during waves fed to the queue writes
   a trace whose kernel events hold the paged kernel's.  (4) A wave of 48 through the
   load balancer; the replica holding checkpointed generations is
   SIGKILLed mid-decode: no client request fails, generations resume on
   the survivor, every token list phase 3's (or parting at a near tie),
   the supervisor respawns it; ``incident --list`` shows the crash's
   bundle, an operator capture's timeline holds ``gen_checkpoint`` and
   ``gen_resume``; the time to recover.  (5) ``scale 3``: the new replica
   boots from the store and serves; ``scale 2``: it retires by SIGUSR1
   while a wave's enqueues through the load balancer answer 200.  (6)
   ``publish`` v1 and v2 (another seed's weights, a second config) while
   the fleet scales; ``rollout v2`` moves the fleet through its canary;
   results carry ``model_version`` v2 and four prompts' tokens equal
   v2's own in-process tokens; ``manager stop`` leaves no process
   behind.  (7) One replica (``start --foreground``) from the ``.npz``
   and one from the store, started together: seconds to ``/readyz``.
14. estimator — ``Estimator.fit`` of phase 5's model (GPT-2 small at
   T = 1024, Adam, global-norm clip 1.0) from the same seeded weights:
   80 sequences (10 steps an epoch, groups of 4, 4 and 2) for 2 epochs
   eagerly and with ``steps_per_call=4``, where every group after the
   first (the eager warm-up) replays a CUDA graph of k whole steps, one
   captured a group size: each step's loss within ``TRAIN_LOSS_TOL``, the
   weights within ``K_WEIGHT_TOL``, ms a step over the last epoch on each
   route; one epoch of the graph route under a trace of the card: flash
   forward, dq and dk/dv launches = 12 x 10 on the card, 12 x 4 by the
   wrappers (the warm-up group).  Then, over one-group epochs of 32
   sequences, an uninterrupted 16-step run as the reference; a fit whose
   step-6 listener raises (``utils/chaos``'s ``FaultInjector``) restores
   its last epoch's snapshot and ends on the reference's weights; a
   victim process (this script with ``--fit-victim DIR``, started with
   its resumer, ``--fit-victim DIR --resume``, before the reference run,
   both waiting with their models built) sent SIGTERM after its first
   step exits 143 leaving a snapshot, and the resumer continues to step
   16, every loss the reference's; a fit fed from a ``NativeFeatureSet``
   (its batches ``ArrayFeatureSet``'s) writing TensorBoard files and a
   ``profile_dir`` trace: the event files read back, the trace holding
   each flash kernel 12 x 8 times.  The host-bound trainings of phases
   8-11 (NeuralCF, SessionRecommender, AnomalyDetector, NER, MTNet) run
   through the same k-step route, ``ZOO_STEPS_PER_CALL`` steps a call.
15. layers — MobileNet v1 (alpha 1.0, 224 x 224, 1000 classes, 4,231,976
   trainable parameters) built from the port's ``keras2`` constructors
   (``mobilenet_v1``): ``fused_bn`` against its plain version and timed
   at the 9 distinct (M, K, N) of its 13 fused pairs at batch 128 (K = 32
   to 1024) and summed over a step; the stem's ``w8a8_conv2d`` (cin 3,
   3x3/2) bitwise and the 14 matmuls' ``w8a8`` (bitwise) / ``w4a16`` at
   batch 16, timed over a forward.  Three steps of the plain route
   (``impl="torch"``) held in lockstep with the fused route's training
   forward (within ``MOBILENET_LOSS_TOL``); then ``Estimator.fit`` (SGD
   0.05 momentum 0.9, f32, TF32 off) over 10 batches of 128 seeded images
   of 100 planted classes for 2 epochs with ``steps_per_call=4`` (the
   k-step CUDA-graph route) under a trace of the card: the loss falls,
   fused_bn launches on the card = 13 x 20, ms/step and images/s.  The
   trained model through ``InferenceModel.do_predict`` (64 held-out
   records, batch 16) in f32, int8 (calibrated on one batch) and int4:
   int8 top-5 bit for bit the plain route's, int4 within W4_TOL, launches
   a forward on the card = by the wrappers (int8 14 ``w8a8`` + 1
   ``w8a8_conv2d``, int4 14 ``w4a16``), records/s and each batch's p50.
   Then every other new layer once on the card against its own CPU
   result: ``Convolution3D`` f32 and int8 (through ``w8a8_conv2d``,
   bitwise), ``AtrousConvolution2D`` int8, ``Deconvolution2D``,
   ``SeparableConvolution2D``, ``LocallyConnected2D``, ``ResizeBilinear``,
   ``LRN2D``, the 3-D pools, ``MaxoutDense``, ``SparseDense`` and
   ``MixtureOfExperts`` at GPT-2-small width (8 experts, top 2, 8 x 1024
   tokens); the phase's wall.
16. detection — SSD-VGG16-300 (``SSDVGG(4, resolution=300)``: 24,013,232
   parameters, 8732 priors, no BN so no fused pair): at batch 16 its
   quantized forward's kernels, ``w8a8_conv2d`` bitwise at the 20
   distinct shapes of its 30 spatial convs (the 3-channel stem at
   300x300, the dilated fc6, valid convs down to 1x1, heads of cout 16 /
   24) and ``w8a8`` (bitwise) / ``w4a16`` at its 5 pointwise convs, timed
   and summed over a forward with their bounds, cuDNN's f32 conv2d and
   ``torch._int_mm`` beside them.  ``Estimator.fit`` with
   ``multibox_loss`` (Adam 2e-3, batch 16, f32, TF32 off) for 12 epochs
   over the example's fixture (``examples/ssd_voc_eval.py --arch vgg16``:
   48 seeded images of planted rectangles of 3 classes), cuDNN on its
   deterministic algorithms: the loss falls, its last epoch's mean at
   most ``SSD_LOSS_MAX`` (1.1 x the JAX package's from the same weights,
   ``ssd_reference.py``), ms/step and images/s.  ``detect`` on the
   training images before and after the fit, above the example's 0.25
   and the SSD paper's 0.01, VOC07 and VOC12 mAP with the background
   counted (``PascalVocEvaluator(num_classes=4)``); VOC07 above 0.01 at
   or above ``SSD_MAP_MIN`` (below the JAX CPU runs').  The
   trained model through ``InferenceModel.do_predict`` at batch 16 in
   f32, int8 (calibrated on the training images) and int4: int8 loc and
   conf bit for bit the plain route's, int4 within W4_TOL, launches a
   forward on the card = by the wrappers (int8 30 ``w8a8_conv2d`` + 5
   ``w8a8``, int4 5 ``w4a16``), records/s and each batch's p50, each
   route's detections (``decode_boxes`` + ``nms`` of its outputs) within
   0.02 mAP of f32's.  ``ObjectDetector("ssd-vgg16-300x300")`` (21
   classes, 26,285,486 parameters) on the card: ``save`` ->
   ``load_model`` bitwise, ``predict_image_set`` over seeded PNG files,
   loc / conf against the same weights on the CPU; the phase's wall.

The last two lines are the per-kernel JSON record and the contract line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
contract line.  Run from the repository root::

    python3 chip_smoke.py [--seed 0] [--profile]

``--resume-victim DIR`` is the continuity phase's victim process, which
the phase starts itself; ``--gateway-client SPEC`` is phase 12's HTTP
clients in a process of their own; ``--fit-victim DIR [--resume]`` is
phase 14's preempted fit and its resumption.

``--profile`` adds ``torch.profiler`` readings of a decode step (eager,
then replayed from its CUDA graph), a predict batch, a training step, a
ResNet-50 training step, an int8 ResNet-50 predict batch of 16, and an
NCF training step and int8 predict batch of 8192.
``--kernel-timing`` runs only the paged, w8a8, w4a16 and (in trees that
have it) w8a8_conv2d timings, the conv at each of its 11 path shapes and
over a forward, and (in trees with the tile and split rule) every tile
and split forced at its deep shapes, K >= 1152 (``kernel_timing``); a
copy of
this script run from the root of an earlier tree of the port times that
tree's kernels the same way::

    cp chip_smoke.py parent/chip_smoke_now.py
    (cd parent && python3 chip_smoke_now.py --kernel-timing)
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import copy
import ctypes
import faulthandler
import functools
import gc
import hashlib
import io
import json
import logging
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common import dtypes
from analytics_zoo_tpu_torch.common.context import ZooConf, ZooContext
from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
from analytics_zoo_tpu_torch.common.triggers import (MaxIteration,
                                                     SeveralIteration)
from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.feature.dataset import ArrayFeatureSet
from analytics_zoo_tpu_torch.feature.image import ImageSet
from analytics_zoo_tpu_torch.feature.text import TextSet
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.inference.quantize import (_quantize_w4,
                                                        _quantize_w8,
                                                        kv_pack_int8,
                                                        weight_bytes)
from analytics_zoo_tpu_torch.models.anomalydetection import AnomalyDetector
from analytics_zoo_tpu_torch.models.imageclassification import \
    ImageClassifier
from analytics_zoo_tpu_torch.models.objectdetection import (
    SSDVGG, ObjectDetector, PascalVocEvaluator, decode_boxes, multibox_loss,
    nms)
from analytics_zoo_tpu_torch.models.recommendation import (
    ColumnFeatureInfo, NeuralCF, SessionRecommender, WideAndDeep,
    evaluate_ranking)
from analytics_zoo_tpu_torch.models.recommendation.movielens import (
    leave_one_out, synthetic_ml1m, training_arrays)
from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq
from analytics_zoo_tpu_torch.models.textclassification import TextClassifier
from analytics_zoo_tpu_torch.models.textmatching import (KNRM, evaluate_map,
                                                         evaluate_ndcg)
from analytics_zoo_tpu_torch.models.textmodels import (NER, IntentEntity,
                                                       SequenceTagger,
                                                       TransformerLM)
from analytics_zoo_tpu_torch.nn.layers.advanced import MaxoutDense
from analytics_zoo_tpu_torch.nn.layers.attention import TransformerLayer
from analytics_zoo_tpu_torch.nn.layers.conv import (
    AtrousConvolution2D, Convolution2D, Convolution3D, Deconvolution2D,
    LocallyConnected2D, LRN2D, ResizeBilinear, SeparableConvolution2D)
from analytics_zoo_tpu_torch.nn.layers.core import BatchNormalization, Dense
from analytics_zoo_tpu_torch.nn.layers.embedding import SparseDense
from analytics_zoo_tpu_torch.nn.layers.moe import MixtureOfExperts
from analytics_zoo_tpu_torch.nn.layers.pooling import (
    AveragePooling3D, GlobalAveragePooling1D, GlobalAveragePooling3D,
    MaxPooling3D)
from analytics_zoo_tpu_torch.nn import graph as tgraph
from analytics_zoo_tpu_torch.nn import keras2
from analytics_zoo_tpu_torch.nn import models as tmodels
from analytics_zoo_tpu_torch.nn import objectives
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.nn.module import generator, split_seed
from analytics_zoo_tpu_torch.nn.optimizers import SGD, Adam
from analytics_zoo_tpu_torch.ops import _build, _impl
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from analytics_zoo_tpu_torch.ops import fused_bn as fb
from analytics_zoo_tpu_torch.ops import paged_attention as pa
from analytics_zoo_tpu_torch.ops import quant_matmul as qm
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.engine import (ClusterServing,
                                                    QuantizedTensor,
                                                    ServingParams,
                                                    default_postprocess,
                                                    default_preprocess)
from analytics_zoo_tpu_torch.serving.generate import (ContinuousBatcher,
                                                      GenerationParams,
                                                      GenRequest, commit)
from analytics_zoo_tpu_torch.serving import manager
from analytics_zoo_tpu_torch.serving import tracecollect
from analytics_zoo_tpu_torch.serving import wire
from analytics_zoo_tpu_torch.serving.queues import FileQueue, InProcQueue
from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                   export_state,
                                                   load_jax_params)

# OpenAI's 124M ``gpt2`` config
GPT2_SMALL = dict(vocab_size=50257, hidden=768, n_head=12, n_layers=12,
                  max_len=1024)
GENERATION = dict(paged=True, block_len=16, max_active_slots=8,
                  max_prompt_len=128, max_tokens=64, decode_quantum=4,
                  prefix_cache=True, stream_interval=8)
# the same deployment on monolithic per-slot lanes (generation.paged=false,
# the default): two capacity buckets, so requests of up to 64 prompt tokens
# take the 128-token lane and the rest the 256-token one
MONOLITHIC = dict(GENERATION, paged=False, bucket_lens=[128, 256])
N_REQUESTS = 16
PREFIX_LEN = 32
# continuity: checkpoints every 8 tokens, resume on; the depth check
# resumes four served requests at depths 1, 8, 17 (past a 16-token block
# edge) and 63 (the cap: budget - 1); the crash phase's victim dies once
# it has generated 512 tokens, half the 16 x 64 its queue holds
RESUME = dict(checkpoint_interval=8, resume=True)
RESUME_DEPTHS = (1, 8, 17, 63)
RESUME_PICKS = ("req-00", "req-02", "req-01", "req-03")
CRASH_AFTER = 512
RESUME_LEASE_S = 2.0
# the paged lane's capacity: pow2(max_prompt_len + max_tokens) tokens
LANE = 256
# kernel vs plain: both compute the same f32 convex combination of the
# same values; only the summation order differs
ATOL, RTOL = 2e-5, 1e-5
TIE_MARGIN = 1e-3
# H100 SXM data sheet: HBM3 rate, f32 rate outside the tensor cores,
# dense int8 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
# a kernel timing cycles through input sets that together hold more than
# twice the H100's 50 MB L2, so that no call finds its inputs in L2
L2_FLUSH_BYTES = 100e6
# f32-accurate products on the tensor cores: 3xTF32 (big·small + small·big
# + big·big) at a third of the dense TF32 rate, 495 / 3 TFLOP/s.  Every f32
# bound counts its products at this rate, and its elementwise work at
# F32_FLOP_PER_S
TF32X3_FLOP_PER_S = 495e12 / 3

# the predict path: OpenAI's 124M ``gpt2`` widths at the full context
PREDICT = dict(vocab=50257, hidden_size=768, n_block=12, n_head=12,
               seq_len=1024)
N_RECORDS = 32
PREDICT_BATCH = 8
# the predict warm-up: every bucket a batch of up to PREDICT_BATCH records
# pads to (1, 2, 4, 8), f32 records only
PREDICT_WARMUP = {"max_batch": PREDICT_BATCH, "scales": "off"}
# flash kernel vs plain: the same f32 math in another summation order
# (f32 out); bf16 outputs round the same f32 values once, so they may
# differ by one bf16 step: at most 2**-7 of |x| (rtol), with atol one
# bf16 step of values below 1 (2**-8)
FLASH_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (4e-3, 8e-3)}
LSE_TOL = (2e-5, 1e-5)
# w4a16 kernel vs plain: f32 sums of K <= 768 products in another order
W4_TOL = (1e-4, 1e-5)
# served predict vs the same model through every kernel's plain version:
# log-probabilities, f32 noise through 12 blocks, read at 2e-7..5e-7 on
# the H100 (PERF.md section 6), so 20x margin (int8 adds the steps of
# activation codes that land on the other side of a rounding edge)
LOGP_TOL = 1e-5
# a planted flash fault (softmax scale off by this factor) that the path
# shape's parity check must reject
PLANTED_SCALE_ERR = 1e-3

# the zoo's host-bound trainings (NCF, SessionRecommender,
# AnomalyDetector, NER, MTNet: small kernels, one Python dispatch each)
# run this many steps a call: on the card one CUDA graph of that many
# whole steps (the Estimator's k-step route, phase 14), which keeps the
# script inside its time limit
ZOO_STEPS_PER_CALL = 8

# the training path: the same GPT-2-small widths at the full context, as
# a causal LM (a Dense softmax over every position); 64 sequences of
# 1025 seeded ids give 8 optimizer steps of 8 x 1024 tokens
TRAIN = dict(vocab=50257, hidden_size=768, n_block=12, n_head=12,
             seq_len=1024)
TRAIN_SEQS = 64
TRAIN_BATCH = 8
TRAIN_LR = 3e-4
TRAIN_CLIP = 1.0
# ids are drawn from a sub-vocabulary, in repeating motifs, so that a few
# steps visibly lower the loss
TRAIN_SUBVOCAB = 1024
# kernel run vs plain run, loss at every step: the runs differ only in the
# attention's f32 summation order (the kernels equal the plain versions to
# <= 1.5e-6 on the card).  On the H100 sound runs read 9.537e-7 apart (one
# f32 step at a loss of ~10) and the planted dk block below 1.621e-5; the
# limit sits about 4x from each (PERF.md section 6)
TRAIN_LOSS_TOL = 4e-6
# planted backward faults, each trained like train[kernel] and compared
# with train[plain] as it is: (tag, wrapper spoiled, how it spoils the
# wrapper's output, whether the loss check must reject it).  Adam divides
# each gradient by its running RMS, so a uniform scale of dq barely moves
# the losses; a gradient block that is lost does.
TRAIN_FAULTS = (
    (f"dq x {1 + PLANTED_SCALE_ERR}", "flash_bwd_dq",
     lambda dq: dq.mul_(1 + PLANTED_SCALE_ERR), False),
    ("dk zeroed in one block (b 0, h 0, keys 0-63)", "flash_bwd_dkv",
     lambda dkv: dkv[0][0, 0, :64].zero_(), True),
)

# the ResNet training path: ImageClassifier("resnet50") as the JAX package
# builds it (224x224x3, 1000 classes, SAME padding, BN eps 1e-3), trained
# with SGD at the linear-scaling rule's 0.1 x 128 / 256 and momentum 0.9
RESNET = dict(model_name="resnet50", num_classes=1000,
              input_shape=(224, 224, 3))
RESNET_BATCH = 128
RESNET_STEPS = 8
RESNET_LR = 0.05
RESNET_MOMENTUM = 0.9
# labels from this many of the 1000 classes, each with its own
# per-channel offset under unit noise.  At the linear-scaling rule's lr a
# class's share of the head's gradient grows as fewer classes are used:
# with 10 the loss overshot (6.98 -> 4.66 -> 8.98 over the 8 steps, on
# the H100), with 1000 it did not move; with 100 it falls (PERF.md)
RESNET_CLASSES = 100
# the probe's own shape (tools/fused_bn_probe.py:33-34): ResNet-50 stage 0's
# bottleneck reduce at batch 128, (128 * 56 * 56, 256) @ (256, 64)
PROBE_SHAPE = (128 * 56 * 56, 256, 64)
BF16_FLOP_PER_S = 989e12
# fused_bn kernel vs plain, y: f32 sums of the same products in another
# order, on unit-scale inputs (w ~ N(0, 1/K)); bf16 y rounds the same f32
# sums once, so one bf16 step (rtol 2**-7).  The sums over the rows: rtol
# 1e-5 (Σ with atol 1e-5 · Σ|y|, for cancellation); a lost 128-row tile
# moves Σ² by 128 / M >= 3.2e-4 of it
FUSED_BN_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-5, 8e-3)}
STATS_RTOL = 1e-5
# kernel vs plain in lockstep: at every training step, the training
# forward's loss through the kernel and through the plain version from the
# same weights and BN state (two free-running f32 trainings drift apart
# within a step: an f32 step's gradients are some 2% from f64 on either
# route, PERF.md)
RESNET_LOSS_TOL = 1e-4
# planted fused_bn faults, each run through the lockstep comparison: (tag,
# how it spoils one launch's y and tile partials (site = the launch's
# index in the forward), whether the loss check must reject it).  BN
# divides by the batch's own spread, so a kernel that scales its
# accumulator (y and the sums alike) barely moves the loss; a lost tile
# partial does.
RESNET_FAULTS = (
    (f"accumulator x {1 + PLANTED_SCALE_ERR} at every site",
     lambda y, part, site, n: (y.mul_(1 + PLANTED_SCALE_ERR),
                               part[:, 0].mul_(1 + PLANTED_SCALE_ERR),
                               part[:, 1].mul_((1 + PLANTED_SCALE_ERR) ** 2)),
     False),
    ("tile 0's partials dropped at the last site (M = 6272)",
     lambda y, part, site, n: part[0].zero_() if site == n - 1 else None,
     True),
)

# the image-classification path: ImageClassifier("resnet50") served in
# predict mode, f32, int8 (W8A8) and int4 (W4A16): 64 records in batches
# of 16
IMAGE = dict(model_name="resnet50", num_classes=1000,
             input_shape=(224, 224, 3))
IMAGE_BATCH = 16
IMAGE_RECORDS = 64
# ResNet-50's quantized forward at 224 x 224: 20 spatial convolutions
# (the w8a8_conv2d kernel in int8) at 11 distinct shapes, 33 pointwise
# convolutions and the Dense head (the w8a8 / w4a16 matmul kernels)
IMAGE_SPATIAL, IMAGE_SPATIAL_SHAPES, IMAGE_MATMULS = 20, 11, 34
# the engine warms every bucket a batch of up to IMAGE_BATCH records pads
# to, for f32 records and for compact uint8 ones with per-row scales
IMAGE_WARMUP = {"max_batch": IMAGE_BATCH, "scales": "both",
                "scale_dtypes": ["|u1"]}
# the records: seeded 256 x 256 BGR images sent as PNG and resized to 224 x
# 224 by the engine, half on the float path and half on the u8 path
IMAGE_SOURCE = (256, 256, 3)
# the head's weights are scaled so that its logits have this standard
# deviation over the calibration batch (random weights on raw pixels
# otherwise saturate the softmax)
IMAGE_LOGIT_STD = 2.0
# served f32 / int4 vs the same model through every kernel's plain
# version, log-probabilities.  f32 runs no kernel of the port (cuDNN's
# convolutions on both routes) and read 0 on the H100: LOGP_TOL.  int4
# differs by the w4a16 kernel's summation order in 34 launches a forward
# (each within W4_TOL), which read 8.057e-06 on the H100 (PERF.md section
# 6): about 25x margin.  int8 is held bit for bit.
IMAGE_LOGP_TOL = {"f32": LOGP_TOL, "int4": 2e-4}
# ragged w8a8_conv2d cases: (x shape, (kh, kw, cin/g, cout), strides,
# pads, dilation, groups, extremes, x offset in bytes): B = 1 with odd
# H / W, cin = 3 and cout = 70 (off the 64-channel tile); 3x3 with
# explicit symmetric pads and cout = 61 (channels off 4 bytes: byte loads
# of w); dilation 2; groups 2 with 32 and 8 channels a group; cin = 24
# (off 16 bytes: byte gathers of x); a strided 1x1 on an odd size; x one
# byte into its buffer; all -128 / 127 at stage 4's K = 4608
CONV_RAGGED = (
    ((1, 37, 45, 3), (7, 7, 3, 70), (2, 2), ((3, 3), (3, 3)), (1, 1), 1,
     False, 0),
    ((2, 13, 11, 16), (3, 3, 16, 61), (1, 1), ((1, 1), (1, 1)), (1, 1), 1,
     False, 0),
    ((2, 17, 19, 32), (3, 3, 32, 64), (1, 1), ((2, 2), (2, 2)), (2, 2), 1,
     False, 0),
    ((2, 14, 14, 64), (3, 3, 32, 128), (2, 2), ((0, 1), (0, 1)), (1, 1), 2,
     False, 0),
    ((2, 9, 9, 16), (3, 3, 8, 24), (1, 1), ((1, 1), (1, 1)), (1, 1), 2,
     False, 0),
    ((3, 10, 12, 24), (5, 3, 24, 40), (2, 1), ((1, 2), (1, 1)), (1, 1), 1,
     False, 0),
    ((2, 15, 15, 32), (1, 1, 32, 96), (2, 2), ((0, 0), (0, 0)), (1, 1), 1,
     False, 0),
    ((2, 14, 14, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1)), (1, 1), 1,
     False, 1),
    ((16, 7, 7, 512), (3, 3, 512, 512), (1, 1), ((1, 1), (1, 1)), (1, 1), 1,
     True, 0),
)


# w8a8_conv2d forced to every tile config and split (conv_parity): the
# distinct path shapes of these indices (the stem, on the RUN loader; the
# stride-2 3x3 of stage 2; both 3x3s of stage 4) and these CONV_RAGGED
# cases (cout 61: scalar stores; groups 2; x one byte into its buffer)
CONV_FORCED = (0, 2, 8, 10)
CONV_FORCED_RAGGED = (1, 3, 7)
# the planted lost partial: the kernel split this many ways, built with
# its merge leaving out the block this many places after each block's own
CONV_PLANTED_SPLIT = 4
CONV_MERGE_SKIP = ("-DCV_MERGE_SKIP=1",)


def say(*parts) -> None:
    print(*parts, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- phase 1: card + build ----------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# the conv kernel's source by name: an earlier tree's qm has no
# KERNEL_CONV, and --kernel-timing runs this script in such trees
CONV_SOURCE = "quant_conv"
KERNEL_SOURCES = (pa.KERNEL, fa.KERNEL, fa.KERNEL_BWD, qm.KERNEL, fb.KERNEL,
                  CONV_SOURCE)


def build_kernels() -> dict:
    t0 = time.perf_counter()
    # the conv kernel's planted merge fault too (conv_planted)
    _build.build_all(KERNEL_SOURCES + ((CONV_SOURCE, CONV_MERGE_SKIP),))
    wall = time.perf_counter() - t0
    # load + bind now, not inside a timing
    pa._kernel_fns()
    fa._kernel_fn()
    fa._bwd_kernel_fns()
    qm._kernel_fns()
    qm._conv_kernel_fn()
    fb._kernel_fns()
    return {"wall_s": wall, "nvcc_s": dict(_build.BUILD_SECONDS),
            "ptxas": {k: _build.BUILD_LOG.get(k, "")
                      for k in KERNEL_SOURCES}}


# the kernels that must run on the tensor cores, by the SASS instruction of
# their products: f32 as 3xTF32, bf16 as bf16 mma, s8 as s8 mma (m16n8k32)
# or, where w8a8_conv2d copies its A tiles, s8 wgmma (m64nNk32, N = 64 /
# 128 channels a tile)
SASS_TF32, SASS_BF16 = "HMMA.1688.F32.TF32", "HMMA.16816.F32.BF16"
SASS_S8 = "IMMA.16832.S8.S8"
SASS_S8_WG = {64: "IGMMA.64x64x32.S8.S8", 128: "IGMMA.64x128x32.S8.S8"}
SASS_KERNELS = {
    fb.KERNEL: (("fused_bn_kernelIf", SASS_TF32),
                ("fused_bn_kernelI13__nv_bfloat16", SASS_BF16)),
    fa.KERNEL: (("flash_fwd_kernel", SASS_TF32),),
    fa.KERNEL_BWD: (("flash_bwd_dq_kernel", SASS_TF32),
                    ("flash_bwd_dkv_kernel", SASS_TF32)),
    qm.KERNEL: (("w8a8_kernel", SASS_S8),
                ("w4a16_kernelIf", SASS_TF32),
                ("w4a16_kernelI13__nv_bfloat16", SASS_BF16)),
    # w8a8_conv2d_kernel<channels a tile, A route>: 0 copied (wgmma);
    # 1 gathered from x, 2 built by runs from staged input rows (mma.sync)
    CONV_SOURCE: tuple(
        (f"w8a8_conv2d_kernelILi{bn}ELi{route}E",
         SASS_S8_WG[bn] if route == 0 else SASS_S8)
        for bn in (64, 128) for route in (0, 1, 2)),
}


def sass_check() -> dict:
    """Count, in each built library's SASS (``cuobjdump -sass``), the
    tensor-core instructions and FFMAs of every kernel function; fail if a
    kernel named in SASS_KERNELS lacks its HMMA or IMMA."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name, rules in SASS_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        counts, fn = {}, None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                fn = m.group(1)
                counts[fn] = {SASS_TF32: 0, SASS_BF16: 0, SASS_S8: 0,
                              **{op: 0 for op in SASS_S8_WG.values()},
                              "FFMA": 0}
            elif fn:
                for op in counts[fn]:
                    if op in ln:
                        counts[fn][op] += 1
        for key, op in rules:
            fns = [f for f in counts if key in f]
            check(fns, f"sass[{name}]: no function matching {key}")
            for f in fns:
                check(counts[f][op] > 0, f"sass[{name}]: {f} has no {op}")
        out[name] = counts
        say(f"sass[{name}]: " + "; ".join(
            f"{f}: " + ", ".join(f"{n} {op}" for op, n in c.items() if n)
            for f, c in counts.items()))
    return out


def smem_line() -> str:
    """Dynamic shared memory a block of the forward, fused_bn, w8a8,
    w4a16 and w8a8_conv2d kernels, as their libraries report it, and the
    paged kernel's table (ptxas -v shows only static shared memory)."""
    flash = _build.load(fa.KERNEL).flash_attention_fwd_smem
    bn = _build.load(fb.KERNEL).fused_bn_smem
    w8 = _build.load(qm.KERNEL).w8a8_smem
    w4 = _build.load(qm.KERNEL).w4a16_smem
    conv = _build.load(CONV_SOURCE).w8a8_conv2d_smem
    for fn, n_args in ((flash, 2), (bn, 2), (w8, 1), (w4, 2), (conv, 19)):
        fn.argtypes = [ctypes.c_int] * n_args
        fn.restype = ctypes.c_int
    return ", ".join(
        [f"flash[{t} D={d}] {flash(b, d)} B" for t, b in (("f32", 0),
                                                           ("bf16", 1))
         for d in fa.KERNEL_HEAD_DIMS]
        + [f"fused_bn[{t} BN={n}] {bn(b, n)} B" for t, b in (("f32", 0),
                                                              ("bf16", 1))
           for n in (64, 128)]
        + [f"w8a8[{8 * mt} rows] {w8(mt)} B" for mt in (1, 5, 8)]
        + [f"w4a16[{t} x, {8 * mt} rows] {w4(b, mt)} B"
           for t, b in (("f32", 0), ("bf16", 1)) for mt in (1, 4)]
        + [f"paged[table of {n} entries, 96 (row, head) pairs] "
           f"{4 * pa.partitions(n, None, 96, pa._sm_count(0))[1]} B"
           for n in (16, 64)]
        + [f"w8a8_conv2d[128 x {n}, {tag}] "
           f"{conv(*conv_args(geom), n, 1, 1)} B"
           for n in qm.CONV_BNS for tag, geom in CONV_SMEM_SHAPES])


# w8a8_conv2d's shared memory (smem_line) at a copied A (ResNet-50's
# stage-1 3x3) and at the stem's input rows staged for its runs
CONV_SMEM_SHAPES = (
    ("copied A", ((IMAGE_BATCH, 56, 56, 64), (3, 3, 64, 64), (1, 1),
                  ((1, 1), (1, 1)), (1, 1), 1)),
    ("the stem's staged rows", ((IMAGE_BATCH, 224, 224, 3), (7, 7, 3, 64),
                                (2, 2), ((2, 3), (2, 3)), (1, 1), 1)))


def conv_args(geom) -> tuple:
    """The geometry arguments of the w8a8_conv2d entry points, B .. G."""
    (b, h, w, c), (kh, kw, _, cout), strides, pads, dil, groups = geom
    ho = (h + sum(pads[0]) - (kh - 1) * dil[0] - 1) // strides[0] + 1
    wo = (w + sum(pads[1]) - (kw - 1) * dil[1] - 1) // strides[1] + 1
    return (b, h, w, c, kh, kw, cout, ho, wo, *strides, pads[0][0],
            pads[1][0], *dil, groups)


# -- phase 2: kernel vs plain -------------------------------------------------

def paged_case(seed: int, lengths, *, rows=8, heads=12, head_dim=64,
               block_len=16, n_table=16, device="cuda"):
    """One paged-attention input set: a random pool with garbage in the
    trash block and every unreferenced block, tables whose entries past a
    row's length point at block 0, and the last two rows sharing their
    first two blocks."""
    g = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    n_blocks = 1 + rows * n_table
    perm = g.permutation(np.arange(1, n_blocks)).reshape(rows, n_table)
    tables = np.zeros((rows, n_table), np.int32)
    for a in range(rows):
        used = -(-int(lengths[a]) // block_len)
        tables[a, :used] = perm[a, :used]
    tables[rows - 1, :2] = tables[rows - 2, :2]
    shape = (n_blocks, block_len, heads, head_dim)
    t = {"q": g.normal(size=(rows, heads, head_dim)),
         "k": g.normal(size=shape), "v": g.normal(size=shape)}
    t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
         for k, v in t.items()}
    t["tables"] = torch.from_numpy(tables).to(device)
    t["lengths"] = torch.from_numpy(lengths).to(device)
    return t


def quantize_case(case):
    qk, ks = kv_pack_int8(case["k"])
    qv, vs = kv_pack_int8(case["v"])
    return dict(case, k=qk, v=qv, ks=ks, vs=vs)


def run_paged(case, impl, parts=None):
    if parts is not None:
        return pa._paged_cuda(case["q"], case["k"], case["v"],
                              case["tables"], case["lengths"],
                              case.get("ks"), case.get("vs"), parts=parts)
    return pa.paged_attention(case["q"], case["k"], case["v"],
                              case["tables"], case["lengths"],
                              case.get("ks"), case.get("vs"), impl=impl)


def cuda_ms(fn, iters: int = 240, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` in ms: ``iters`` calls are
    captured into one CUDA graph, which is replayed once to warm up and
    once between two CUDA events.  Replaying a graph keeps the host's
    per-call cost (Python, argument checks, the launch itself) out of the
    measurement, so back-to-back kernels leave no idle gaps between them
    on the device."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def cycled(fns):
    """One callable that calls ``fns`` in turn (one per input set)."""
    state = {"i": 0}

    def call():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()
    return call


def n_sets(nbytes: int) -> int:
    """Distinct input sets a timing cycles through so that the bytes one
    pass over them reads exceed L2_FLUSH_BYTES: each call then finds its
    inputs in device memory, as the served paths do, where the model's
    other weights pass through L2 between two calls of a kernel."""
    return int(L2_FLUSH_BYTES // max(1, int(nbytes))) + 1


def paged_bound(case) -> dict:
    """Least time for one call at these inputs: each input byte the
    function needs read once (K/V rows below each row's length, their
    scales, the table entries it walks, q, lengths), the output written
    once, at the HBM rate; against ~4 flops per K/V element at the f32
    rate.  The larger of the two bounds it."""
    q = case["q"]
    rows, heads, head_dim = q.shape
    bl = case["k"].shape[1]
    lens = case["lengths"].cpu().numpy().astype(np.int64)
    entries = int(np.sum(-(-lens // bl)))
    kv_elems = int(lens.sum()) * heads * head_dim
    nbytes = 2 * kv_elems * case["k"].element_size() \
        + 2 * q.numel() * 4 + entries * 4 + rows * 4
    if "ks" in case:
        nbytes += 2 * entries * heads * 4
    flops = 4 * kv_elems
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def sdpa_yardstick(case):
    """SDPA over the table's blocks gathered into a contiguous, dequantized
    (A, heads, n_table * block_len, head_dim) cache with a length mask.
    The gather is done once, outside the timing: this is a yardstick for
    the attention itself, not the same function as the paged kernel."""
    kc = pa._gather_dequant(case["k"], case.get("ks"), case["tables"])
    vc = pa._gather_dequant(case["v"], case.get("vs"), case["tables"])
    A, T, bl, nh, hd = kc.shape
    kc = kc.reshape(A, T * bl, nh, hd).transpose(1, 2).contiguous()
    vc = vc.reshape(A, T * bl, nh, hd).transpose(1, 2).contiguous()
    mask = (torch.arange(T * bl, device=kc.device)[None]
            < case["lengths"][:, None])[:, None, None, :]
    q = case["q"][:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)


def paged_timing_lengths(seed: int) -> dict:
    """The two timed shapes' lengths (8 rows, 12 heads, head_dim 64,
    16-token blocks): the main path's decode-time lengths (prompt 16..128
    + 1..64 tokens) over 16-entry tables, and GPT-2's full context, 769 to
    1024, over 64-entry tables."""
    g = np.random.default_rng(seed + 1)
    return {"main": (g.integers(17, 193, 8), 16),
            "long": (g.integers(769, 1025, 8), 64)}


def paged_sets(seed: int, lengths, n_table: int, quant: bool):
    """Input sets for one paged timing: ``paged_case``'s, then sets with
    the same tables and pools of their own drawn on the card, as many as
    ``n_sets`` asks for the bytes a call reads."""
    first = paged_case(seed, lengths, n_table=n_table)
    first = quantize_case(first) if quant else first
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sets = [first]
    for _ in range(1, n_sets(paged_bound(first)["bytes"])):
        c = dict(first)
        for name in ("k", "v"):
            c[name] = torch.randn(first["k"].shape, generator=gen,
                                  device="cuda")
        sets.append(quantize_case(c) if quant else c)
    return sets


def paged_timing(seed: int, variant: str, shape: str, lengths,
                 n_table: int) -> dict:
    """Kernel, plain version and the SDPA yardstick at one shape, each
    cycling over the same input sets; the kernel's output on the first set
    held against the plain version's."""
    sets = paged_sets(seed, lengths, n_table, variant == "int8")
    got = run_paged(sets[0], "cuda")
    torch.cuda.synchronize()
    err = check_close(f"kernel[{variant}/{shape} timing set]", got,
                      run_paged(sets[0], "torch"), ATOL, RTOL)
    ms = cuda_ms(cycled([lambda c=c: run_paged(c, "cuda") for c in sets]))
    plain_ms = cuda_ms(cycled([lambda c=c: run_paged(c, "torch")
                               for c in sets]))
    lib_ms = cuda_ms(cycled([sdpa_yardstick(c) for c in sets]))
    b = paged_bound(sets[0])
    say(f"kernel[{variant}] timing {shape} lengths={list(map(int, lengths))} "
        f"n_table={n_table} ({len(sets)} input sets): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, SDPA over pre-gathered cache "
        f"(yardstick) {lib_ms:.4f} ms, bound {b['bound_ms']:.5f} ms "
        f"({b['bound_by']}: {b['bytes']} B, {b['flops']} flop), "
        f"{100 * b['bound_ms'] / ms:.1f}% of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "max_abs_err": err, **b}


def paged_parity_cases(seed: int):
    """(tag, case, forced partitions) for the kernel-vs-plain checks: the
    decode path's table (16 entries, one partition), the long cache's (64
    entries: two partitions by the rule, four forced) at lengths 0
    (uniform over the whole table, trash included), 1, a partition's edge
    and +-1, the full table and past it, the decode table forced into 8
    partitions (most of them with no valid position), and every head_dim
    with and without partitions."""
    out = [("ragged", paged_case(seed, [1, 16, 17, 256, 100, 33, 255, 64]),
            None),
           ("edges", paged_case(seed + 10, [16, 32, 48, 256, 1, 2, 128,
                                            240]), None),
           ("long", paged_case(seed + 20, [0, 1, 511, 512, 513, 1024, 1100,
                                           700], n_table=64), None),
           ("long, 4 parts", paged_case(seed + 25, [0, 1, 255, 256, 257, 767,
                                                    768, 769], n_table=64), 4),
           ("8 parts", paged_case(seed + 30, [1, 16, 17, 256, 100, 33, 0,
                                              64]), 8)]
    for hd in pa.KERNEL_HEAD_DIMS:
        case = paged_case(seed + 40 + hd, [0, 1, 79, 80, 81, 160], rows=6,
                          heads=3, head_dim=hd, block_len=8, n_table=20)
        out += [(f"head_dim {hd}", case, None),
                (f"head_dim {hd}, 5 parts", case, 5)]
    return out


def kernel_phase(seed: int) -> dict:
    """Parity on the card for both pool types, then timing at the two
    shapes.  Returns the per-variant record (without launches, which the
    main path fills)."""
    cases = paged_parity_cases(seed)
    timing = paged_timing_lengths(seed)
    out = {}
    for variant in ("f32", "int8"):
        worst = 0.0
        for tag, case, parts in cases:
            if variant == "int8":
                case = quantize_case(case)
            got = run_paged(case, "cuda", parts)
            torch.cuda.synchronize()
            lens = case["lengths"].tolist()
            err = check_close(f"kernel[{variant}/{tag}] lengths={lens}", got,
                              run_paged(case, "torch"), ATOL, RTOL)
            worst = max(worst, err)
            rows, heads, _ = case["q"].shape
            n_table = case["tables"].shape[1]
            n_parts = pa.partitions(n_table, parts, rows * heads,
                                    pa._sm_count(0))[0]
            say(f"kernel[{variant}] parity {tag} lengths={lens}: "
                f"{n_parts} partition(s) of {n_table} entries, max abs err "
                f"{err:.3e} (atol {ATOL}, rtol {RTOL})")
        t = {shape: paged_timing(seed + 100, variant, shape, lens, n_table)
             for shape, (lens, n_table) in timing.items()}
        main, long = t["main"], t["long"]
        out[variant] = {
            "name": f"paged_attention[{variant}]", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/paged_attention.cu",
            "replaces": "analytics_zoo_tpu/ops/paged_attention.py:105",
            "launches": None,
            "max_abs_err": max(worst, main["max_abs_err"],
                               long["max_abs_err"]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "long_ms": long["ms"], "long_plain_ms": long["plain_ms"],
            "long_bound_ms": long["bound_ms"],
            "long_bound_by": long["bound_by"],
            "long_library_ms": long["library_ms"]}
    return out


# -- phase 3: the served main path --------------------------------------------

def make_requests(seed: int, vocab: int):
    """16 prompts of 16..128 tokens; the even ones share a 32-token prefix.
    Wave 1 holds one sharer whose length (40) registers exactly the two
    prefix blocks, and 7 unique prompts; wave 2 the 7 other sharers (prefix
    hits: ``pshared``) and 1 unique prompt."""
    g = np.random.default_rng(seed + 7)
    prefix = g.integers(0, vocab, PREFIX_LEN)
    reqs = []
    for i in range(N_REQUESTS):
        if i % 2 == 0:
            n = 40 if i == 0 else int(g.integers(PREFIX_LEN + 1, 129))
            p = np.concatenate([prefix, g.integers(0, vocab, n - PREFIX_LEN)])
        else:
            p = g.integers(0, vocab, int(g.integers(16, 129)))
        reqs.append((f"req-{i:02d}", p.astype(np.int32)))
    first = [0, 1, 3, 5, 7, 9, 11, 13]
    return [[reqs[i] for i in first],
            [r for i, r in enumerate(reqs) if i not in first]]


def wait_warm(serving, timeout_s: float = 600.0) -> dict:
    """Block until the engine's warm-up pass ends; it must end ``ready``
    with no failed entry, and the engine must then report ready."""
    t0 = time.perf_counter()
    while True:
        w = serving.health()["warmup"]
        if w["state"] not in ("pending", "warming"):
            break
        check(time.perf_counter() - t0 < timeout_s,
              f"warm-up still {w['state']} after {timeout_s} s ({w})")
        time.sleep(0.05)
    check(w["state"] == "ready" and w["failed"] == 0, f"warm-up {w}")
    check(serving.ready()["ready"], f"not ready after warm-up: "
                                    f"{serving.ready()}")
    return w


def serve(im, waves, gen: dict, trace: bool = False,
          timeout_s: float = 600.0) -> dict:
    """Drive ClusterServing over InProcQueue: started with ``warmup``, the
    waves sent once the warm-up is ``ready``; returns the terminal results
    and the counters of the waves alone: the batcher's before and after,
    the paged-kernel launches its wrapper counted (eager ones) and, with
    ``trace``, the launches the card ran, read from a profiler trace of
    the waves (``_impl.card_launches``; a graph replay runs no wrapper).
    The trace slows the host, so a timed run is not traced."""
    q = InProcQueue()
    params = ServingParams(max_batch=N_REQUESTS, max_wait_ms=2.0,
                           generation=gen, warmup=True)
    serving = ClusterServing(im, q, params)
    b = serving._batcher
    n_decode = sum(e.kind in ("paged_decode", "decode_step")
                   for e in b.warmup_manifest())
    iq, oq = InputQueue(q), OutputQueue(q)
    results = {}
    try:
        serving.start()
        warm = wait_warm(serving)
        torch.cuda.synchronize()
        before = b.stats()
        pa.launches = 0
        with (_impl.card_launches(("paged",)) if trace
              else contextlib.nullcontext({"paged": None})) as card:
            t0 = time.perf_counter()
            for wave in waves:
                for rid, prompt in wave:
                    iq.enqueue_tensor(rid, prompt.astype(np.float32))
                got = oq.query_many([rid for rid, _ in wave],
                                    timeout_s=timeout_s)
                results.update(got)
            wall = time.perf_counter() - t0
    finally:
        serving.shutdown(drain_s=5.0)
    torch.cuda.synchronize()
    stats = b.stats()
    ttft = serving._m_ttft.percentiles((50,))["p50"]
    return {"results": results, "wall_s": wall, "traced": trace,
            "launches": card["paged"], "eager_launches": pa.launches,
            "stats": stats, "before": before, "warm": warm,
            "n_decode": n_decode, "ttft_p50_s": ttft,
            "layers": im._model.n_layers}


def check_served(run: dict, waves, vocab: int, tag: str,
                 paged: bool = True) -> dict:
    """Every request answered with its full budget of in-range tokens;
    the warm-up captured one graph a decode lane and the waves ran every
    quantum from it (no capture, no eager quantum, no paged launch by the
    wrapper); in a traced run the card ran the paged kernel decode steps x
    layers times (none for monolithic lanes, whose attention is
    plain)."""
    tokens = {}
    for wave in waves:
        for rid, prompt in wave:
            r = run["results"].get(rid)
            check(r is not None and "value" in r
                  and not OutputQueue.is_partial(r),
                  f"[{tag}] {rid}: no terminal result ({r})")
            toks = r["value"]["tokens"]
            want = min(GENERATION["max_tokens"], LANE - len(prompt))
            check(len(toks) == want and r["value"]["length"] == want,
                  f"[{tag}] {rid}: {len(toks)} tokens, want {want}")
            check(all(0 <= t < vocab for t in toks),
                  f"[{tag}] {rid}: token out of range")
            tokens[rid] = list(toks)
    st, st0, warm = run["stats"], run["before"], run["warm"]
    steps = st["decode_steps"] - st0["decode_steps"]
    check(st["finished"] == N_REQUESTS and st["quarantined"] == 0
          and st["shed"] == 0, f"[{tag}] scheduler stats {st}")
    check(warm["compile_stats"]["captures"] == run["n_decode"]
          == st0["captures"] == st["captures"],
          f"[{tag}] captures: warm-up {warm['compile_stats']}, batcher "
          f"{st0['captures']} -> {st['captures']}, decode entries "
          f"{run['n_decode']}")
    eager = st["eager_quanta"] - st0["eager_quanta"]
    replays = st["replays"] - st0["replays"]
    check(eager == 0 and replays > 0
          and replays * GENERATION["decode_quantum"] == steps,
          f"[{tag}] {eager} eager quanta, {replays} replays for {steps} "
          f"decode steps")
    layers = run["layers"] if paged else 0
    check(run["eager_launches"] == 0,
          f"[{tag}] {run['eager_launches']} paged launches by the wrapper "
          f"while every quantum was a replay")
    if run["traced"]:
        check(run["launches"] == steps * layers
              and (run["launches"] > 0 or not paged),
              f"[{tag}] paged kernel launches on the card "
              f"{run['launches']} != decode steps {steps} x {layers} "
              f"layers")
    if paged:
        check(st["pool"]["prefix_hits"] > 0,
              f"[{tag}] no prefix hit: pshared never ran ({st['pool']})")
    n_tok = sum(len(t) for t in tokens.values())
    traced = (f", paged kernel launches on the card {run['launches']} (= "
              f"{steps} x {layers}, from the trace)" if run["traced"]
              else "")
    say(f"main[{tag}{'/traced' if run['traced'] else ''}]: warm-up "
        f"{warm['total']} entries in "
        f"{warm['seconds']:.3f} s, {warm['compile_stats']['captures']} "
        f"graph capture(s) (= decode lanes) in "
        f"{warm['compile_stats']['capture_seconds']:.3f} s; "
        f"{len(tokens)}/{N_REQUESTS} terminal results, {n_tok} tokens in "
        f"{run['wall_s']:.3f} s = {n_tok / run['wall_s']:.1f} tokens/s, "
        f"TTFT p50 {run['ttft_p50_s'] * 1e3:.2f} ms, decode steps {steps} "
        f"in {replays} graph replays, eager quanta {eager}, captures after "
        f"the waves {st['captures']}, paged launches by the wrapper "
        f"{run['eager_launches']}" + traced
        + (f", prefix hits {st['pool']['prefix_hits']}" if paged else ""))
    return tokens


# -- phase 4: cross-check against the plain attention -------------------------

def batcher_tokens(im, waves, kv_quant: str, impl: str) -> dict:
    b = ContinuousBatcher(im, GenerationParams(**dict(GENERATION,
                                                      kv_quant=kv_quant)),
                          impl=impl)
    done = {}
    for wave in waves:
        for rid, prompt in wave:
            check(b.submit(GenRequest(rid, prompt)), "waiting room full")
        want = len(done) + len(wave)
        while len(done) < want:
            for ev in b.step():
                check(ev.kind not in ("shed", "quarantine"),
                      f"cross-check {ev.kind} on {ev.rid}: {ev.error}")
                if ev.kind == "finish":
                    done[ev.rid] = list(ev.tokens)
    return done


@torch.inference_mode()
def replay_margin(lm, prompt, tokens, d: int, kv_quant: str):
    """``(top-2 logit margin, argmax)`` of the logits that pick
    ``tokens[d]``: one row replayed through the paged path (plain
    attention) with the first ``d`` tokens fed back."""
    bl = GENERATION["block_len"]
    ntab = LANE // bl
    dev = lm.device
    pools = lm.init_paged_pools(1 + ntab, bl, 1, kv_quant)
    tables = torch.arange(1, ntab + 1, dtype=torch.int32,
                          device=dev)[None]
    plen = len(prompt)
    lengths = torch.tensor([plen], dtype=torch.int32, device=dev)
    ks, vs, logits = lm.prefill_kv(torch.as_tensor(prompt)[None], lengths)
    commit(pools, ks, vs, lengths, tables[:, :-(-plen // bl)],
           torch.zeros(1, dtype=torch.int32, device=dev), block_len=bl,
           kv_quant=kv_quant)
    for i in range(d):
        logits, _ = lm.decode_paged(pools, tables, [plen + i], [tokens[i]],
                                    block_len=bl, kv_quant=kv_quant,
                                    impl="torch")
    top = torch.topk(logits[0], 2)
    return float(top.values[0] - top.values[1]), int(top.indices[0])


def compare_tokens(im, waves, got: dict, ref: dict, kv_quant: str,
                   tag: str, what: str) -> None:
    """Every token sequence of ``got`` equal to ``ref``'s, or parting from
    it only at a near tie: at the first divergence the replayed logits'
    top-2 margin is below ``TIE_MARGIN`` and their argmax is one of the
    two tokens."""
    prompts = {rid: p for wave in waves for rid, p in wave}
    diverged = 0
    for rid, toks in got.items():
        want = ref[rid]
        if want == toks:
            continue
        d = next(i for i, (a, b) in enumerate(zip(toks, want)) if a != b)
        margin, top = replay_margin(im._model, prompts[rid], toks, d,
                                    kv_quant)
        say(f"{tag} {rid}: diverges at token {d} (got {toks[d]}, "
            f"{what} {want[d]}, replay {top}), top-2 logit margin "
            f"{margin:.3e}")
        check(top in (toks[d], want[d]),
              f"{tag} {rid}: the replay picks neither token")
        check(margin < TIE_MARGIN,
              f"{tag} {rid}: divergence at token {d} is not a near tie "
              f"(margin {margin:.3e} >= {TIE_MARGIN})")
        diverged += 1
    say(f"{tag}: {len(got) - diverged}/{len(got)} token sequences "
        f"identical to the {what}, {diverged} diverged at a near tie")


def cross_check(im, waves, served: dict, kv_quant: str) -> None:
    compare_tokens(im, waves, served,
                   batcher_tokens(im, waves, kv_quant, "torch"), kv_quant,
                   f"cross[{kv_quant}]", "plain-attention batcher")


# -- phase 3b: continuity: resume at depth, crash and resume across processes --

def resume_gen(base: dict) -> dict:
    return dict(base, **RESUME)


def resume_run(im, waves, golden: dict, gen: dict) -> dict:
    """A bare batcher (eager quanta, ``impl`` left at auto) given each of
    ``RESUME_PICKS`` at every depth of ``RESUME_DEPTHS`` as a resume of
    its uninterrupted tokens ``golden[rid]``, epoch 1, all submitted at
    once; drained to the end.  The paged wrapper's launch counter is set to
    0 just before the drive and read just after."""
    prompts = {rid: p for wave in waves for rid, p in wave}
    b = ContinuousBatcher(im, GenerationParams(**gen))
    subs = [(f"{rid}@{k}", rid, k) for rid in RESUME_PICKS
            for k in RESUME_DEPTHS]
    for sid, rid, k in subs:
        check(b.submit(GenRequest(sid, prompts[rid],
                                  resume_tokens=list(golden[rid][:k]),
                                  epoch=1)), "waiting room full")
    pa.launches = 0
    events, snaps = [], []
    t0 = time.perf_counter()
    while not b.idle:
        events.extend(b.step())
        snaps.extend(b.drain_checkpoints())
    sync(im.device)
    return {"events": events, "snaps": snaps, "stats": b.stats(),
            "launches": pa.launches, "wall_s": time.perf_counter() - t0,
            "subs": subs, "prompts": prompts}


def check_resume_run(im, run: dict, golden: dict, kv_quant: str, tag: str,
                     layers: int) -> None:
    """Every submission resumed, finished with its budget, and equal to
    its uninterrupted tokens or parting at a near tie; every partial after
    the resume longer than its depth; every checkpoint of epoch 1; the
    paged wrapper launched decode steps x ``layers`` times (0 for
    monolithic lanes, whose attention is plain)."""
    st = run["stats"]
    depth = {sid: k for sid, _, k in run["subs"]}
    fin, bad = {}, []
    for ev in run["events"]:
        if ev.kind in ("shed", "quarantine", "resume_failed"):
            bad.append((ev.kind, ev.rid, ev.error))
        elif ev.kind == "partial" and len(ev.tokens) <= depth[ev.rid]:
            bad.append(("partial", ev.rid, len(ev.tokens)))
        elif ev.kind == "finish":
            fin[ev.rid] = list(ev.tokens)
    check(not bad, f"resume[{tag}]: {bad[:4]}")
    n = len(run["subs"])
    check(st["resumed"] == n and st["resume_failed"] == 0
          and len(fin) == n, f"resume[{tag}]: resumed {st['resumed']}, "
                             f"failed {st['resume_failed']}, finished "
                             f"{len(fin)} of {n}")
    check(run["snaps"] and all(s["epoch"] == 1 for s in run["snaps"]),
          f"resume[{tag}]: checkpoints {len(run['snaps'])}, epochs "
          f"{sorted({s['epoch'] for s in run['snaps']})}")
    steps = st["decode_steps"]
    check(run["launches"] == steps * layers,
          f"resume[{tag}]: paged launches by the wrapper {run['launches']}"
          f" != decode steps {steps} x {layers}")
    waves = [[(sid, run["prompts"][rid]) for sid, rid, _ in run["subs"]]]
    ref = {sid: golden[rid] for sid, rid, _ in run["subs"]}
    for sid, toks in fin.items():
        check(len(toks) == len(ref[sid]),
              f"resume[{tag}] {sid}: {len(toks)} tokens, want "
              f"{len(ref[sid])}")
    say(f"resume[{tag}]: {n} resumes ({len(RESUME_PICKS)} requests at "
        f"depths {'/'.join(map(str, RESUME_DEPTHS))}) in "
        f"{run['wall_s']:.3f} s, decode steps {steps} in "
        f"{st['eager_quanta']} eager quanta, paged launches by the wrapper "
        f"{run['launches']} (= {steps} x {layers}), checkpoints "
        f"{len(run['snaps'])} (epoch 1)")
    compare_tokens(im, waves, fin, ref, kv_quant, f"resume[{tag}]",
                   "uninterrupted run")


def params_checksum(module: torch.nn.Module) -> str:
    """sha256 over every parameter and buffer (name, then raw bytes) in
    name order: the victim and the survivor hold the same weights iff
    their checksums agree."""
    h = hashlib.sha256()
    for name, t in sorted(module.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().reshape(-1).contiguous().cpu()
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def resume_victim(tmp: str, seed: int, device=None,
                  timeout_s: float = 300.0) -> int:
    """``--resume-victim DIR``: serve ``DIR/q`` (paged f32 lanes with
    checkpoints and resume, warm-up, a 2 s lease) until the fault armed at
    ``CRASH_AFTER`` generated tokens kills the process (exit code 3).
    Prints the parameters' checksum, writes ``DIR/ready.json`` once warm,
    and prints the wall time of every step boundary that spooled
    checkpoints (``ckpt_s``).  Exits 1 if no crash came within
    ``timeout_s``."""
    dev = device or torch.device("cuda", 0)
    lm = TransformerLM(**GPT2_SMALL, seed=seed, device=dev)
    checksum = params_checksum(lm)
    say(f"victim: params checksum {checksum}")
    im = InferenceModel(device=dev).do_load_model(lm)
    serving = ClusterServing(im, FileQueue(os.path.join(tmp, "q")),
                             ServingParams(
                                 max_batch=N_REQUESTS, max_wait_ms=2.0,
                                 generation=resume_gen(GENERATION),
                                 warmup=True, lease_s=RESUME_LEASE_S,
                                 replica_id=f"victim-{seed}",
                                 faults={"decode_crash_after_n_tokens": {
                                     "version": "*", "n": CRASH_AFTER,
                                     "once": os.path.join(tmp,
                                                          "crash.marker")}}))
    serving.snapshot_path = os.path.join(tmp, "victim.gensnap.jsonl")
    b = serving._batcher
    spool = serving._maybe_checkpoint

    def timed_checkpoint():
        n = len(b.pending_checkpoints)
        t0 = time.perf_counter()
        spool()
        if n:
            say(json.dumps({"ckpt_s": time.perf_counter() - t0,
                            "snapshots": n}))
    serving._maybe_checkpoint = timed_checkpoint
    serving.start()
    try:
        warm = wait_warm(serving)
        ready = os.path.join(tmp, "ready.json")
        with open(ready + ".tmp", "w") as f:
            json.dump({"checksum": checksum, "warm": warm}, f)
        os.replace(ready + ".tmp", ready)
        say(f"victim: warm ({warm['total']} entries, "
            f"{warm['compile_stats']['captures']} capture(s)), serving")
        time.sleep(timeout_s)
        say(f"victim: no crash within {timeout_s} s")
        return 1
    finally:
        serving.shutdown()


def expected_resume(queue, rids, spool: str) -> dict:
    """What a survivor must do with the records a dead owner left, worked
    out from the queue and the owner's spool as the engine's reclaim rule
    reads them: a record with a terminal result is ``done``; one whose
    annotation points at ``spool`` and which has a checkpoint there of the
    annotated epoch with a valid checksum is ``resumed`` from its deepest
    one, wasting what its streamed partial holds past it; any other is
    ``restarted`` and wastes its whole partial.  ``waste`` = sum of
    max(0, partial_n - n), n = 0 for a restart."""
    results = queue.get_results(list(rids))
    snaps = tracecollect.load_snapshots([spool])
    out = {"done": [], "resumed": {}, "restarted": [], "waste": 0}
    for rid in rids:
        r = results.get(rid)
        if isinstance(r, dict) and not r.get("partial"):
            out["done"].append(rid)
            continue
        partial_n = int((r or {}).get("n") or 0)
        ann = queue.annotation(rid) or {}
        best = None
        if ann.get("spool") == spool:
            for snap in snaps:
                if snap.get("rid") == rid and int(snap.get("epoch") or 0) \
                        == int(ann.get("epoch") or 0) and (
                        best is None or snap["n"] > best["n"]):
                    best = snap
        if best is not None \
                and int(best["crc"]) == tracecollect.snapshot_checksum(best):
            out["resumed"][rid] = int(best["n"])
            out["waste"] += max(0, partial_n - int(best["n"]))
        else:
            out["restarted"].append(rid)
            out["waste"] += partial_n
    return out


def victim_readings(log: str) -> dict:
    """The victim's checksum and per-boundary checkpoint times, from its
    output."""
    out = {"checksum": None, "ckpt_s": [], "snapshots": 0}
    for line in log.splitlines():
        if line.startswith("victim: params checksum "):
            out["checksum"] = line.split()[-1]
        elif line.startswith('{"ckpt_s"'):
            doc = json.loads(line)
            out["ckpt_s"].append(doc["ckpt_s"])
            out["snapshots"] += doc["snapshots"]
    return out


def run_victim(tmp: str, seed: int, waves, victim_cmd=None,
               timeout_s: float = 300.0) -> dict:
    """Start the victim in a fresh interpreter (``subprocess``, never a
    fork of this process, which holds a CUDA context), enqueue both waves
    once it is warm, and wait for it to die; stops it if it does not."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = victim_cmd or [sys.executable, os.path.join(here, "chip_smoke.py"),
                         "--resume-victim", tmp, "--seed", str(seed)]
    ready = os.path.join(tmp, "ready.json")
    log_path = os.path.join(tmp, "victim.log")
    q = FileQueue(os.path.join(tmp, "q"))
    iq = InputQueue(q)
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=here, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            while not os.path.exists(ready):
                check(proc.poll() is None,
                      f"victim exited {proc.returncode} before it was warm")
                check(time.perf_counter() - t0 < timeout_s,
                      f"victim not warm after {timeout_s} s")
                time.sleep(0.05)
            t_start = time.perf_counter() - t0
            t_enqueue = time.monotonic()
            for wave in waves:
                for rid, prompt in wave:
                    iq.enqueue_tensor(rid, prompt.astype(np.float32))
            rc = proc.wait(timeout=timeout_s)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log_path) as f:
        text = f.read()
    with open(ready) as f:
        doc = json.load(f)
    return {"rc": rc, "log": text, "ready": doc, "t_enqueue": t_enqueue,
            "start_s": t_start, **victim_readings(text)}


def resume_crash_phase(im, waves, golden: dict, seed: int,
                       victim_cmd=None) -> dict:
    """Part (b) of the continuity phase: the victim serves both waves over
    a ``FileQueue`` and is killed by its fault after ``CRASH_AFTER``
    tokens; this process then serves as the survivor over the same
    directory (paged f32 lanes, resume on, warmed before it starts, as a
    replica already up when its peer died) under a profiler trace of the
    card, and must answer every record: resumes counted, waste as the
    queue and the spool say, tokens equal to ``golden`` or parting at a
    near tie, no eager quantum and no extra capture."""
    rids = [rid for wave in waves for rid, _ in wave]
    tmp = tempfile.mkdtemp(prefix="zoo-resume-")
    try:
        v = run_victim(tmp, seed, waves, victim_cmd)
        mine = params_checksum(im._model)
        check(v["checksum"] == v["ready"]["checksum"] == mine,
              f"victim params {v['checksum']} != survivor's {mine}")
        marker = os.path.join(tmp, "crash.marker")
        spool = os.path.join(tmp, "victim.gensnap.jsonl")
        check(v["rc"] == 3 and os.path.exists(marker),
              f"victim exit code {v['rc']} (want 3), marker "
              f"{os.path.exists(marker)}; its output ends "
              f"{v['log'][-2000:]}")
        q = FileQueue(os.path.join(tmp, "q"))
        n_snaps = len(tracecollect.load_snapshots([spool]))
        check(n_snaps > 0 and v["snapshots"] == n_snaps,
              f"victim spool holds {n_snaps} checkpoints, the victim "
              f"wrote {v['snapshots']}")
        want = expected_resume(q, rids, spool)
        spool_bytes = os.path.getsize(spool)
        # the claims must be a lease old before the survivor's first sweep
        time.sleep(max(0.0, v["t_enqueue"] + RESUME_LEASE_S + 0.2
                       - time.monotonic()))
        run = survive(im, tmp, rids)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"victim": v, "want": want, "run": run, "spool_bytes": spool_bytes,
            "n_snaps": n_snaps}


def survive(im, tmp: str, rids) -> dict:
    """The survivor: warmed, then started over the dead victim's queue,
    served to the last result under a profiler trace of the card."""
    gen = resume_gen(GENERATION)
    serving = ClusterServing(im, FileQueue(os.path.join(tmp, "q")),
                             ServingParams(
                                 max_batch=N_REQUESTS, max_wait_ms=2.0,
                                 generation=gen, warmup=True,
                                 lease_s=RESUME_LEASE_S,
                                 reclaim_interval_s=0.1,
                                 replica_id="survivor"))
    serving.snapshot_path = os.path.join(tmp, "survivor.gensnap.jsonl")
    b = serving._batcher
    prewarm = b.warm()
    sync(im.device)
    before = b.stats()
    pa.launches = 0
    oq = OutputQueue(FileQueue(os.path.join(tmp, "q")))
    try:
        with _impl.card_launches(("paged",)) as card:
            t0 = time.perf_counter()
            serving.start()
            warm = wait_warm(serving)
            results = oq.query_many(list(rids), timeout_s=300.0)
            wall = time.perf_counter() - t0
    finally:
        serving.shutdown(drain_s=5.0)
    sync(im.device)
    reg = serving.registry.snapshot()
    events = [e for e in serving.recorder.events()
              if e.get("replica") == serving.replica_id]
    ttft = {s["uri"]: s["dur_s"] for s in serving.tracer.spans()
            if s["stage"] == "prefill"}
    snap_path = serving.snapshot_path
    return {"results": results, "wall_s": wall, "prewarm": prewarm,
            "warm": warm, "before": before, "stats": b.stats(),
            "card": card["paged"], "eager_launches": pa.launches,
            "resumed_total": reg["serving_generations_resumed_total"][
                "values"][0]["value"],
            "wasted_total": reg["serving_resume_wasted_tokens_total"][
                "values"][0]["value"],
            "resumes": [e for e in events if e.get("event") == "gen_resume"],
            "failed": [e for e in events
                       if e.get("event") == "gen_resume_failed"],
            "ttft": ttft, "layers": im._model.n_layers,
            "survivor_spool_bytes": (os.path.getsize(snap_path)
                                     if os.path.exists(snap_path) else 0)}


def check_crash_phase(im, waves, golden: dict, out: dict, vocab: int,
                      layers: int) -> None:
    """Every record answered with its budget of in-range tokens, equal to
    ``golden`` or parting at a near tie; resumes and waste as
    ``expected_resume`` worked out; one ``gen_resume`` event a resumed
    record; no failed warm-up entry, no capture after the pre-warm, no
    eager quantum; paged launches on the card = decode steps x
    ``layers``."""
    v, want, run = out["victim"], out["want"], out["run"]
    tokens = {}
    for wave in waves:
        for rid, prompt in wave:
            r = run["results"].get(rid)
            check(r is not None and "value" in r
                  and not OutputQueue.is_partial(r),
                  f"[survivor] {rid}: no terminal result ({r})")
            toks = r["value"]["tokens"]
            n = min(GENERATION["max_tokens"], LANE - len(prompt))
            check(len(toks) == n and all(0 <= t < vocab for t in toks),
                  f"[survivor] {rid}: {len(toks)} tokens (want {n}) or "
                  f"out of range")
            tokens[rid] = list(toks)
    resumed = sorted(want["resumed"])
    check(run["resumed_total"] == len(resumed)
          and sorted(e["rid"] for e in run["resumes"]) == resumed
          and run["stats"]["resumed"] - run["before"]["resumed"]
          == len(resumed),
          f"[survivor] resumed {run['resumed_total']} "
          f"(events {sorted(e['rid'] for e in run['resumes'])}), want "
          f"{resumed}")
    check(all(e["resumed_tokens"] == want["resumed"][e["rid"]]
              for e in run["resumes"]),
          f"[survivor] resume depths {run['resumes']} != {want['resumed']}")
    check(run["wasted_total"] == want["waste"],
          f"[survivor] wasted tokens {run['wasted_total']} != "
          f"{want['waste']}")
    st, st0, pre, warm = (run["stats"], run["before"], run["prewarm"],
                          run["warm"])
    check(pre["failed"] == 0 and warm["failed"] == 0
          and pre["compile_stats"]["captures"] == st0["captures"]
          == st["captures"] and warm["compile_stats"]["captures"] == 0,
          f"[survivor] warm-up {pre} / {warm}, captures "
          f"{st0['captures']} -> {st['captures']}")
    steps = st["decode_steps"] - st0["decode_steps"]
    eager = st["eager_quanta"] - st0["eager_quanta"]
    replays = st["replays"] - st0["replays"]
    check(eager == 0 and run["eager_launches"] == 0 and replays > 0
          and replays * GENERATION["decode_quantum"] == steps,
          f"[survivor] {eager} eager quanta, {run['eager_launches']} "
          f"wrapper launches, {replays} replays for {steps} decode steps")
    check(run["card"] == steps * layers,
          f"[survivor] paged launches on the card {run['card']} != decode "
          f"steps {steps} x {layers}")
    ttft = sorted(run["ttft"][rid] for rid in resumed if rid in run["ttft"])
    ttft_p50 = ttft[len(ttft) // 2] if ttft else float("nan")
    ck = sorted(v["ckpt_s"])
    say(f"resume[crash]: victim exit code {v['rc']} (fault after "
        f"{CRASH_AFTER} tokens, warm {v['start_s']:.2f} s after its start),"
        f" params checksum {v['checksum']} = the survivor's; spool "
        f"{out['n_snaps']} checkpoints, {out['spool_bytes']} bytes")
    say(f"resume[crash]: checkpoint time a boundary (victim, "
        f"{len(ck)} boundaries, {v['snapshots']} snapshots): median "
        f"{ck[len(ck) // 2] * 1e3:.3f} ms, max {ck[-1] * 1e3:.3f} ms")
    say(f"resume[crash]: survivor answered {len(tokens)}/{len(tokens)}: "
        f"{len(resumed)} resumed, {len(want['restarted'])} restarted, "
        f"{len(want['done'])} done by the victim; wasted tokens "
        f"{int(run['wasted_total'])}; wall {run['wall_s']:.3f} s from "
        f"start to last result (traced, a lease after the claims); TTFT "
        f"p50 of the resumed {ttft_p50 * 1e3:.2f} ms; decode steps {steps}"
        f" in {replays} graph replays, paged launches on the card "
        f"{run['card']} (= {steps} x {layers}); survivor spool "
        f"{run['survivor_spool_bytes']} bytes")
    compare_tokens(im, waves, tokens, golden, "off", "resume[crash]",
                   "paged f32 served run")


def resume_phase(im, waves, served: dict, mono: dict, seed: int) -> None:
    """Phase 3b: (a) resumes at depth through the kernels, in paged f32,
    paged int8 and monolithic lanes; (b) a crash and its resume across
    processes."""
    layers = im._model.n_layers
    for tag, base, kv_quant, golden, paged in (
            ("off", GENERATION, "off", served["off"]["timed"], True),
            ("int8", dict(GENERATION, kv_quant="int8"), "int8",
             served["int8"]["timed"], True),
            ("mono", MONOLITHIC, "off", mono, False)):
        run = resume_run(im, waves, golden, resume_gen(base))
        check_resume_run(im, run, golden, kv_quant, tag,
                         layers if paged else 0)
    out = resume_crash_phase(im, waves, served["off"]["timed"], seed)
    check_crash_phase(im, waves, served["off"]["timed"], out,
                      GPT2_SMALL["vocab_size"], layers)


# -- phase 2b: flash attention, w8a8 and w4a16 against their plain versions ---

def bound(nbytes: int, *terms) -> dict:
    """The least time for the work: bytes at the HBM rate against the
    operations, each ``(ops, rate)`` term at its own rate; the larger of
    the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(ops / rate for ops, rate in terms) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(sum(o for o, _ in terms))}


def flash_bound(B, H, T, D, causal, in_bytes=4, out_bytes=4, lse=False):
    """q, k, v read once, the output (and LSE) written once; 4·D flop per
    (query, key) pair the mask keeps: T(T+1)/2 pairs causal, T² not."""
    pairs = T * (T + 1) // 2 if causal else T * T
    nbytes = B * H * T * D * (3 * in_bytes + out_bytes) \
        + (B * H * T * 4 if lse else 0)
    return bound(nbytes, (4 * B * H * pairs * D, TF32X3_FLOP_PER_S))


def w8a8_bound(M, K, N):
    return bound(M * K + K * N + 4 * N + 4 * M * N,
                 (2 * M * K * N, INT8_OP_PER_S))


def w4a16_bound(M, K, N, G, x_bytes=4):
    """x, the packed weight, its group scales and the output once; 2 flop
    per product on the tensor cores (f32-accurate for f32 x, bf16 for bf16
    x) plus one dequantizing multiply per weight (elementwise f32)."""
    rate = TF32X3_FLOP_PER_S if x_bytes == 4 else BF16_FLOP_PER_S
    return bound(M * K * x_bytes + (K + 1) // 2 * N + 4 * G * N + 4 * M * N,
                 (2 * M * K * N, rate), (K * N, F32_FLOP_PER_S))


def qkv_views(g, B, T, H, D, dtype, device="cuda"):
    """q, k, v as (B, H, T, D) views of one (B, T, 3·H·D) projection — the
    layout ``MultiHeadAttention`` hands the kernel."""
    qkv = torch.from_numpy(
        g.standard_normal((B, T, 3 * H * D), dtype=np.float32)).to(
            device, dtype)
    return [t.unflatten(-1, (H, D)).transpose(1, 2)
            for t in qkv.split(H * D, dim=-1)]


def run_flash(q, k, v, causal, lse, impl, out_dtype=None):
    if lse:
        return fa.flash_attention_with_lse(q, k, v, causal=causal,
                                           out_dtype=out_dtype, impl=impl)
    return fa.flash_attention(q, k, v, causal=causal, impl=impl), None


def check_close(tag, got, ref, atol, rtol) -> float:
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    worst = float(err.max())
    check(ok, f"{tag}: max abs err {worst:.3e} outside atol {atol} rtol "
              f"{rtol}")
    return worst


def flash_parity(seed: int) -> dict:
    """Kernel vs plain version over dtypes, masks, ragged T, LSE, head_dim
    and layouts.  Returns the worst abs error per output dtype."""
    g = np.random.default_rng(seed + 20)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(dt, causal, T, lse, 64, None)
             for dt in (torch.float32, torch.bfloat16)
             for causal in (False, True) for T in (77, 1000, 1024)
             for lse in (False, True)]
    # other head_dims, and bf16 inputs with f32 outputs (out_dtype)
    cases += [(torch.float32, True, 77, True, 32, None),
              (torch.float32, False, 200, False, 128, None),
              (torch.bfloat16, True, 1000, True, 64, torch.float32)]
    for dt, causal, T, lse, D, out_dt in cases:
        q, k, v = qkv_views(g, 2, T, 4, D, dt)
        got, glse = run_flash(q, k, v, causal, lse, "cuda", out_dt)
        torch.cuda.synchronize()
        ref, rlse = run_flash(q, k, v, causal, lse, "torch", out_dt)
        o_dt = out_dt or dt
        tag = (f"flash[{str(dt)[6:]}->{str(o_dt)[6:]} causal={causal} "
               f"T={T} D={D} lse={lse}]")
        err = check_close(tag, got, ref, *FLASH_TOL[o_dt])
        worst[o_dt] = max(worst[o_dt], err)
        if lse:
            worst[torch.float32] = max(worst[torch.float32], check_close(
                tag + " lse", glse, rlse, *LSE_TOL))
    # contiguous (B, H, T, D) inputs, as a direct caller may pass them
    q, k, v = (t.contiguous() for t in qkv_views(g, 2, 333, 4, 64,
                                                  torch.float32))
    got, _ = run_flash(q, k, v, True, False, "cuda")
    ref, _ = run_flash(q, k, v, True, False, "torch")
    worst[torch.float32] = max(worst[torch.float32], check_close(
        "flash[contiguous]", got, ref, *FLASH_TOL[torch.float32]))
    say(f"flash parity: {len(cases) + 1} cases, max abs err f32 "
        f"{worst[torch.float32]:.3e} (atol {FLASH_TOL[torch.float32][0]}, "
        f"rtol {FLASH_TOL[torch.float32][1]}), bf16 "
        f"{worst[torch.bfloat16]:.3e} (atol {FLASH_TOL[torch.bfloat16][0]},"
        f" rtol {FLASH_TOL[torch.bfloat16][1]})")
    return worst


def flash_path_parity(q, k, v, D) -> float:
    """Kernel vs plain at the path shape, output and LSE; and a planted
    fault (the scale off by ``PLANTED_SCALE_ERR``) that the check must
    reject.  Returns the worst abs error."""
    scale = 1.0 / math.sqrt(D)
    got, glse = run_flash(q, k, v, True, True, "cuda")
    ref, rlse = run_flash(q, k, v, True, True, "torch")
    tag = f"flash[path {tuple(q.shape)} f32 causal]"
    worst = max(check_close(tag, got, ref, *FLASH_TOL[torch.float32]),
                check_close(tag + " lse", glse, rlse, *LSE_TOL))
    # the same path with lse=False, as MultiHeadAttention calls it
    worst = max(worst, check_close(
        tag, fa.flash_attention(q, k, v, True, impl="cuda"), ref,
        *FLASH_TOL[torch.float32]))
    bad, _ = fa.flash_attention_torch(q, k, v, True,
                                      scale * (1 + PLANTED_SCALE_ERR))
    try:
        planted = check_close("planted", got, bad, *FLASH_TOL[torch.float32])
    except SmokeFailure:
        planted = float((got - bad).abs().max())
    else:
        raise SmokeFailure(f"{tag}: a scale off by {PLANTED_SCALE_ERR} "
                           f"passes the parity check (err {planted:.3e})")
    say(f"{tag} parity: max abs err {worst:.3e} (out and lse; atol "
        f"{FLASH_TOL[torch.float32][0]}, rtol {FLASH_TOL[torch.float32][1]})"
        f"; planted fault (scale x {1 + PLANTED_SCALE_ERR}) err "
        f"{planted:.3e}, rejected")
    return worst


def flash_timing(seed: int, B=8, H=12, T=1024, D=64, iters=40,
                 parity=False) -> dict:
    g = np.random.default_rng(seed + 21 + T)
    q, k, v = qkv_views(g, B, T, H, D, torch.float32)
    err = flash_path_parity(q, k, v, D) if parity else None
    scale = 1.0 / math.sqrt(D)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, True, impl="cuda"),
                 iters=iters)
    # the training call: the same forward that also writes the LSE
    lse_ms = cuda_ms(lambda: fa.flash_attention_with_lse(
        q, k, v, True, impl="cuda"), iters=iters)
    plain_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, True,
                                                  impl="torch"), iters=iters)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), iters=iters)
    b = flash_bound(B, H, T, D, True)
    b_lse = flash_bound(B, H, T, D, True, lse=True)
    say(f"flash timing (B={B}, H={H}, T={T}, D={D}, f32, causal): kernel "
        f"{ms:.4f} ms, with LSE (training) {lse_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B, "
        f"{b['ops']} flop; with LSE {b_lse['bound_ms']:.4f} ms)")
    return {"ms": ms, "lse_ms": lse_ms, "lse_bound_ms": b_lse["bound_ms"],
            "plain_ms": plain_ms, "library_ms": lib_ms, "max_abs_err": err,
            **b}


def w8a8_case(g, M, K, N, w_offset=0, extremes=False):
    """x, w and scale on the card: s8 values over all of [-128, 127], or
    (``extremes``) only -128 and 127; ``w_offset`` puts w that many bytes
    into its buffer (a contiguous view whose base is off 16 bytes)."""
    if extremes:
        ends = np.array([-128, 127], np.int8)
        x, w = g.choice(ends, (M, K)), g.choice(ends, (K, N))
    else:
        x = g.integers(-128, 128, (M, K), dtype=np.int8)
        w = g.integers(-128, 128, (K, N), dtype=np.int8)
    s = torch.from_numpy(g.uniform(1e-4, 1e-2, N).astype(np.float32))
    wt = torch.from_numpy(w).cuda()
    if w_offset:
        buf = torch.zeros(K * N + w_offset, dtype=torch.int8, device="cuda")
        buf[w_offset:] = wt.flatten()
        wt = buf[w_offset:].view(K, N)
    return torch.from_numpy(x).cuda(), wt, s.cuda()


# (M, K, N, weight offset, extremes): the head at M = 1, 8 (one m-tile a
# block), 9 (two) and 33 (five), and M = 20 (three), 64 (eight) and 65 (two
# blocks of rows); K below one k-step (20), ragged (100), odd and past one
# x segment (777); N = 1, below one mma tile (15), odd (61); a weight one
# byte into its buffer; all -128 / 127 (the largest sums)
W8_CASES = ((1, 768, 50257, 0, False),
            (8, 768, 50257, 0, False),
            (9, 768, 50257, 0, False),
            (33, 768, 50257, 0, False),
            (64, 777, 1000, 0, False),
            (8, 20, 15, 0, False),
            (33, 100, 61, 0, False),
            (1, 777, 1, 0, False),
            (20, 20, 1, 0, False),
            (65, 100, 61, 0, False),
            (8, 768, 50257, 1, False),
            (9, 777, 61, 1, False),
            (64, 768, 1000, 0, True),
            (8, 777, 50257, 0, True))
# rows of x timed at the head: one request, the served batch, and a batch
# of five m-tiles
W8_TIMED_M = (1, 8, 33)


def w8a8_timing(seed: int, M: int, K=768, N=50257, plain=False) -> dict:
    """The kernel at one shape, cycling over input sets (the first held
    against the plain version, then weights and scales drawn on the card),
    beside ``torch._int_mm`` + scale and, with ``plain``, the plain
    version."""
    g = np.random.default_rng(seed + 31 + M)
    x, w, s = w8a8_case(g, M, K, N)
    b = w8a8_bound(M, K, N)
    gen = torch.Generator(device="cuda").manual_seed(seed + 30 + M)
    sets = [(x, w, s)] + [
        (x, torch.randint(-128, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8),
         torch.rand(N, generator=gen, device="cuda") * 1e-2 + 1e-4)
        for _ in range(1, n_sets(b["bytes"]))]
    got = qm.w8a8_matmul(x, w, s, impl="cuda")
    torch.cuda.synchronize()
    check(torch.equal(got, qm.w8a8_matmul(x, w, s, impl="torch")),
          f"w8a8 ({M}, {K}, {N}) timing set: not bitwise equal to the plain "
          f"version")
    # _int_mm needs M > 16 and K, N multiples of 8: M padded to 32 (above,
    # to a multiple of 8), K and N to multiples of 8 with zeros
    mp, k8, n8 = max(32, -(-M // 8) * 8), -(-K // 8) * 8, -(-N // 8) * 8
    xp = torch.zeros(mp, k8, dtype=torch.int8, device="cuda")
    xp[:M, :K] = x
    padded = []
    for _, ws, ss in sets:
        wp = torch.zeros(k8, n8, dtype=torch.int8, device="cuda")
        wp[:K, :N] = ws
        padded.append((wp, ss))
    ms = cuda_ms(cycled([lambda c=c: qm.w8a8_matmul(*c, impl="cuda")
                         for c in sets]))
    plain_ms = cuda_ms(cycled([lambda c=c: qm.w8a8_matmul(*c, impl="torch")
                               for c in sets])) if plain else None
    lib_ms = cuda_ms(cycled([
        lambda wp=wp, ss=ss: torch._int_mm(xp, wp)[:M, :N].float() * ss
        for wp, ss in padded]))
    say(f"w8a8 timing (M={M}, K={K}, N={N}, {len(sets)} input sets): kernel "
        f"{ms:.4f} ms, "
        + (f"plain {plain_ms:.4f} ms, " if plain else "")
        + f"torch._int_mm (M padded to {mp}, K to {k8}, N to {n8}) + scale "
        f"{lib_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
        f"{b['bytes']} B), {100 * b['bound_ms'] / ms:.1f}% of bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **b}


def w8a8_phase(seed: int) -> dict:
    g = np.random.default_rng(seed + 30)
    for m, k, n, off, ext in W8_CASES:
        x, w, s = w8a8_case(g, m, k, n, off, ext)
        got = qm.w8a8_matmul(x, w, s, impl="cuda")
        torch.cuda.synchronize()
        ref = qm.w8a8_matmul(x, w, s, impl="torch")
        check(torch.equal(got, ref),
              f"w8a8 ({m}, {k}, {n}, weight offset {off}, extremes {ext}): "
              f"not bitwise equal to the plain version (max abs err "
              f"{float((got - ref).abs().max()):.3e})")
    say(f"w8a8 parity: bitwise equal in {len(W8_CASES)} cases (M, K, N, "
        f"weight offset, extremes) {list(W8_CASES)}")
    t = {m: w8a8_timing(seed, m, plain=m == 8) for m in W8_TIMED_M}
    main = t[8]
    return {"name": "w8a8_matmul", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "analytics_zoo_tpu/ops/quant_matmul.py:144",
            "launches": None, "max_abs_err": 0.0, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            **{f"m{m}_{key}": t[m][key] for m in W8_TIMED_M if m != 8
               for key in ("ms", "bound_ms", "library_ms")}}


def w4a16_case(g, M, K, N, group, dtype=torch.float32, w_offset=0):
    """x, the packed weight and its scales from ``_quantize_w4`` of a
    seeded N(0, 0.05^2) weight; ``w_offset`` puts the packed weight that
    many bytes into its buffer (not 16-byte aligned)."""
    W = (g.standard_normal((K, N)) * 0.05).astype(np.float32)
    leaves = _quantize_w4(W, group)
    x = torch.from_numpy(g.standard_normal((M, K), dtype=np.float32))
    wq = torch.from_numpy(leaves["W_q4"]).cuda()
    if w_offset:
        buf = torch.zeros(wq.numel() + w_offset, dtype=torch.uint8,
                          device="cuda")
        buf[w_offset:] = wq.flatten()
        wq = buf[w_offset:].view(wq.shape)
    return (x.to("cuda", dtype), wq, torch.from_numpy(leaves["s_g"]).cuda())


# (M, K, N, group size, x dtype, weight offset): the head in f32 and bf16
# and at M = 1; M = 17 and 33 (four m-tiles a block); ragged groups whose
# boundaries fall inside a 16-row chunk and one group straddling the low
# and high halves (K = 100, group 34); odd K (101, 26); groups of 5 rows;
# one group over all of K; K = 2000 (several x segments); a packed weight
# that does not start on 16 bytes
W4_CASES = ((8, 768, 50257, 64, torch.float32, 0),
            (8, 768, 50257, 64, torch.bfloat16, 0),
            (1, 768, 50257, 64, torch.float32, 0),
            (33, 768, 1000, 64, torch.float32, 0),
            (17, 768, 1000, 64, torch.bfloat16, 0),
            (5, 100, 61, 34, torch.float32, 0),
            (5, 100, 61, 34, torch.bfloat16, 0),
            (3, 101, 61, 26, torch.float32, 0),
            (3, 101, 61, 26, torch.bfloat16, 0),
            (8, 64, 40, 5, torch.float32, 0),
            (8, 96, 70, 96, torch.bfloat16, 0),
            (8, 2000, 130, 64, torch.float32, 0),
            (8, 2000, 130, 64, torch.bfloat16, 0),
            (8, 100, 61, 34, torch.float32, 3))


def w4a16_timing(seed: int, M, K, N, group, dtype) -> dict:
    """Kernel and plain version at one shape, cycling over input sets: the
    quantized case first (held against the plain version), then packed
    weights and scales drawn on the card."""
    g = np.random.default_rng(seed + 41)
    x, wq, sg = w4a16_case(g, M, K, N, group, dtype)
    x_bytes = 4 if dtype == torch.float32 else 2
    b = w4a16_bound(M, K, N, sg.shape[0], x_bytes)
    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    sets = [(x, wq, sg)] + [
        (x, torch.randint(0, 256, wq.shape, generator=gen, device="cuda",
                          dtype=torch.uint8),
         torch.rand(sg.shape, generator=gen, device="cuda") * 0.01 + 1e-3)
        for _ in range(1, n_sets(b["bytes"]))]
    got = qm.w4a16_matmul(x, wq, sg, impl="cuda")
    torch.cuda.synchronize()
    tag = f"w4a16 (M={M}, K={K}, N={N}, G={sg.shape[0]}, {str(dtype)[6:]})"
    err = check_close(tag + " timing set", got,
                      qm.w4a16_matmul(x, wq, sg, impl="torch"), *W4_TOL)
    ms = cuda_ms(cycled([lambda c=c: qm.w4a16_matmul(*c, impl="cuda")
                         for c in sets]))
    plain_ms = cuda_ms(cycled([lambda c=c: qm.w4a16_matmul(*c, impl="torch")
                               for c in sets]))
    say(f"{tag} timing ({len(sets)} input sets): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, no single PyTorch call, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B, "
        f"{b['ops']} flop), {100 * b['bound_ms'] / ms:.1f}% of bound")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, **b}


def w4a16_phase(seed: int, M=8, K=768, N=50257) -> dict:
    g = np.random.default_rng(seed + 40)
    worst = 0.0
    for m, k, n, group, dt, off in W4_CASES:
        x, wq, sg = w4a16_case(g, m, k, n, group, dt, off)
        got = qm.w4a16_matmul(x, wq, sg, impl="cuda")
        torch.cuda.synchronize()
        ref = qm.w4a16_matmul(x, wq, sg, impl="torch")
        worst = max(worst, check_close(
            f"w4a16 ({m}, {k}, {n}, G={sg.shape[0]}, {str(dt)[6:]}, weight "
            f"offset {off})", got, ref, *W4_TOL))
    say(f"w4a16 parity: {len(W4_CASES)} cases (M, K, N, group, x, weight "
        f"offset) {[(c[0], c[1], c[2], c[3], str(c[4])[6:], c[5]) for c in W4_CASES]}, "
        f"max abs err {worst:.3e} (atol {W4_TOL[0]}, rtol {W4_TOL[1]})")
    t = w4a16_timing(seed, M, K, N, 64, torch.float32)
    tb = w4a16_timing(seed + 1, M, K, N, 64, torch.bfloat16)
    return {"name": "w4a16_matmul", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "analytics_zoo_tpu/ops/quant_matmul.py:187",
            "launches": None,
            "max_abs_err": max(worst, t["max_abs_err"], tb["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "bf16_ms": tb["ms"],
            "bf16_plain_ms": tb["plain_ms"], "bf16_bound_ms": tb["bound_ms"]}


def predict_kernel_phase(seed: int) -> dict:
    """Parity and timing of the predict path's three kernels.  Returns
    their records (launches filled by the predict phase)."""
    worst = flash_parity(seed)
    t = flash_timing(seed, parity=True)
    for short in (128, 512):
        flash_timing(seed, T=short, iters=200)
    flash = {"name": "flash_attention_fwd[f32]", "route": "cuda",
             "source": "analytics_zoo_tpu_torch/csrc/flash_attention.cu",
             "replaces": "analytics_zoo_tpu/ops/flash_attention.py:52",
             "launches": None,
             "max_abs_err": max(worst[torch.float32], t["max_abs_err"]),
             "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "library_ms": t["library_ms"], "lse_ms": t["lse_ms"],
             "lse_bound_ms": t["lse_bound_ms"]}
    return {"flash": flash, "w8a8": w8a8_phase(seed),
            "w4a16": w4a16_phase(seed)}


# -- phase 4: the served predict path ------------------------------------------

def build_predict_model(seed: int) -> Sequential:
    T = PREDICT["seq_len"]
    return Sequential([
        TransformerLayer(**PREDICT, input_shape=(T,)),
        GlobalAveragePooling1D(),
        Dense(PREDICT["vocab"], activation="softmax")]).init_weights(seed)


def predict_records(seed: int, n: int = N_RECORDS) -> np.ndarray:
    g = np.random.default_rng(seed + 50)
    return g.integers(0, PREDICT["vocab"],
                      (n, PREDICT["seq_len"])).astype(np.float32)


def set_impl(model, impl) -> None:
    """Every kernel of the model (flash, w8a8, w4a16) or its plain
    version."""
    for m in model.modules():
        if hasattr(m, "impl"):
            m.impl = impl


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_launches() -> None:
    fa.launches = qm.launches_w8a8 = qm.launches_w4a16 = 0
    qm.launches_conv = 0
    fa.dq_launches = fa.dkv_launches = 0
    fb.launches = 0


def serve_predict(im, X, params,
                  kernels=("flash_fwd", "w8a8", "w4a16")) -> dict:
    """ClusterServing in predict mode over InProcQueue, started with its
    ``warmup`` spec; once the warm-up is ``ready`` the counts are set to 0
    and every record is enqueued, under a profiler trace of the card
    (``_impl.card_launches``).  Forwards are the model's executions of a
    padded batch over exactly that run, ``warm_hits`` the ones whose
    bucket the warm-up had run; ``card`` the launches of ``kernels`` the
    card ran, ``wrapper`` those the wrappers counted."""
    q = InProcQueue()
    serving = ClusterServing(im, q, params)     # quantizes here
    iq, oq = InputQueue(q), OutputQueue(q)
    rids = [f"rec-{i:02d}" for i in range(len(X))]
    try:
        serving.start()
        warm = wait_warm(serving)
        sync(im.device)
        st0 = im.aot_stats()
        reset_launches()
        with _impl.card_launches(kernels) as card:
            t0 = time.perf_counter()
            for rid, x in zip(rids, X):
                iq.enqueue_tensor(rid, x)
            results = oq.query_many(rids, timeout_s=600.0)
            wall = time.perf_counter() - t0
    finally:
        serving.shutdown(drain_s=5.0)
    sync(im.device)
    st = im.aot_stats()
    counts = {"flash_fwd": fa.launches, "w8a8": qm.launches_w8a8,
              "w4a16": qm.launches_w4a16, "w8a8_conv": qm.launches_conv}
    return {"rids": rids, "results": results, "wall_s": wall,
            "forwards": sum(st["programs"].values())
            - sum(st0["programs"].values()),
            "warm_hits": st["hits"] - st0["hits"], "warm": warm,
            "card": card, "wrapper": {k: counts[k] for k in kernels},
            "e2e_p50_s": serving._e2e.percentiles((50,))["p50"],
            "dead_lettered": serving.dead_lettered}


@torch.inference_mode()
def head_inputs(im, X, impl):
    """Probabilities of the whole model with ``impl`` and the inputs the
    head saw."""
    seen = []
    head = im._model.layers_list[-1]
    hook = head.register_forward_pre_hook(
        lambda _m, args: seen.append(args[0].clone()))
    set_impl(im._model, impl)
    try:
        probs = InferenceModel(device=im.device).do_load_model(
            im._model).do_predict(X, batch_size=PREDICT_BATCH)
    finally:
        set_impl(im._model, None)
        hook.remove()
    return probs, torch.cat(seen)


def logp_tolerance(im, x_kernel, x_plain) -> np.ndarray:
    """Per-row log-probability tolerance of the served path against the
    plain one: ``LOGP_TOL``, plus for an int8 head twice the largest logit
    step that the activation codes which differ between the two paths can
    make (each code step moves a logit by at most s_x·max|W|)."""
    head = im._model.layers_list[-1]
    tol = np.full(len(x_kernel), LOGP_TOL)
    if head.bits == 8:
        def codes(x):
            return torch.clamp(torch.round(x / head.s_x), -127, 127)
        steps = (codes(x_kernel) - codes(x_plain)).abs().sum(-1)
        w_max = float((head.W_q.float().abs() * head.s_w).max())
        tol += (2 * steps * float(head.s_x) * w_max).cpu().numpy()
    return tol


def check_predict(tag: str, run: dict, ref_probs, tol, quant) -> dict:
    """Every record answered with a top-5 whose probabilities match the
    plain path's; top-1 equal where the plain top-2 margin exceeds the
    tolerance; every forward's bucket warmed; the card ran the flash
    kernel 12 x forwards and the quantized head's kernel once a forward,
    and the wrappers counted each of those launches."""
    n = len(run["rids"])
    check(run["dead_lettered"] == 0, f"predict[{tag}]: records quarantined")
    ref_logp = np.log(ref_probs.astype(np.float64))
    top1, worst, compared = [], 0.0, 0
    for i, rid in enumerate(run["rids"]):
        r = run["results"].get(rid)
        check(r is not None and "value" in r,
              f"predict[{tag}] {rid}: no result ({r})")
        top = r["value"]
        check(len(top) == 5, f"predict[{tag}] {rid}: top-{len(top)}")
        cls = [int(c) for c, _ in top]
        lp = np.log(np.asarray([p for _, p in top], np.float64))
        check(bool(np.isfinite(lp).all()) and all(
            0 <= c < PREDICT["vocab"] for c in cls),
              f"predict[{tag}] {rid}: malformed top-5 {top}")
        err = float(np.abs(lp - ref_logp[i, cls]).max())
        worst = max(worst, err)
        check(err <= tol[i], f"predict[{tag}] {rid}: log-prob error "
                             f"{err:.3e} > {tol[i]:.3e}")
        order = np.sort(ref_logp[i])
        if order[-1] - order[-2] > 2 * tol[i]:
            compared += 1
            check(cls[0] == int(np.argmax(ref_logp[i])),
                  f"predict[{tag}] {rid}: top-1 {cls[0]} != plain "
                  f"{int(np.argmax(ref_logp[i]))}")
        top1.append(cls[0])
    fw = run["forwards"]
    check(run["warm_hits"] == fw > 0,
          f"predict[{tag}]: {run['warm_hits']} of {fw} forwards found "
          f"their bucket warm")
    per = {"flash_fwd": PREDICT["n_block"]}
    if quant:
        per[quant] = 1
    for k, n_per in per.items():
        check(run["card"][k] == run["wrapper"][k] == fw * n_per,
              f"predict[{tag}]: {k} launches on the card {run['card'][k]}, "
              f"by the wrapper {run['wrapper'][k]}, != {fw} forwards x "
              f"{n_per}")
    w = run["warm"]
    say(f"predict[{tag}]: warm-up {w['total']} buckets in "
        f"{w['seconds']:.3f} s; {len(run['results'])}/{n} records served "
        f"in {run['wall_s']:.3f} s = {n / run['wall_s']:.2f} records/s, "
        f"e2e p50 {run['e2e_p50_s'] * 1e3:.1f} ms (under the trace); {fw} "
        f"forwards, each of a warmed bucket; launches on the card = by the "
        f"wrappers: " + ", ".join(f"{k} {run['card'][k]}" for k in per)
        + f"; top-5 log-prob max err vs plain {worst:.3e}, top-1 checked "
        f"on {compared}/{n} (plain top-2 margin > 2 x tolerance)")
    return {"top1": top1, "run": run}


def predict_phase(seed: int, float_model, records: dict) -> None:
    """f32, int8 and int4 served in turn (each quantized variant on a copy
    of the float model); fills the kernels' launch counts."""
    dev = next(float_model.parameters()).device
    X = predict_records(seed)
    params = dict(batch_size=PREDICT_BATCH, max_wait_ms=2.0,
                  warmup=PREDICT_WARMUP)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        calib = os.path.join(tmp, "calib.npy")
        np.save(calib, predict_records(seed + 1, PREDICT_BATCH))
        for tag, quant, spec in (("f32", None, None),
                                 ("int8", "w8a8", {"bits": 8,
                                                   "calib": calib}),
                                 ("int4", "w4a16", "int4")):
            model = float_model if spec is None \
                else copy.deepcopy(float_model)
            im = InferenceModel(device=dev).do_load_model(model)
            run = serve_predict(im, X, ServingParams(quantize=spec,
                                                     **params))
            ref, x_plain = head_inputs(im, X, "torch")
            _, x_kernel = head_inputs(im, X, None)
            tol = logp_tolerance(im, x_kernel, x_plain)
            out[tag] = check_predict(tag, run, ref, tol, quant)
            out[tag]["bytes"] = weight_bytes(im._params)
            if tag != "f32":
                agree = np.mean(np.asarray(out[tag]["top1"])
                                == np.asarray(out["f32"]["top1"]))
                say(f"predict[{tag}]: weight_bytes {out[tag]['bytes']} vs "
                    f"f32 {out['f32']['bytes']} "
                    f"({out['f32']['bytes'] / out[tag]['bytes']:.2f}x "
                    f"smaller), head {im._model.layers_list[-1].bits}-bit; "
                    f"top-1 agreement with the f32 path {agree:.3f}")
            del im, model
    records["flash"]["launches"] = out["f32"]["run"]["card"]["flash_fwd"]
    records["w8a8"]["launches"] = out["int8"]["run"]["card"]["w8a8"]
    records["w4a16"]["launches"] = out["int4"]["run"]["card"]["w4a16"]


# -- optional: where the decode time goes -------------------------------------

def kernel_rows(prof):
    """(name, calls, ms) of every kernel in a profile, slowest first, and
    their summed device seconds.  Kernel rows only: an operator's row
    repeats its kernels' time."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    return rows, sum(r[2] for r in rows) / 1e3


def profile_predict(im, X) -> None:
    """One predict batch of a warmed bucket under ``torch.profiler``: the
    device's busy share of the wall time and the kernels that take the
    most time."""
    from torch.profiler import ProfilerActivity, profile
    im.warm(len(X), X.shape[1:], dtype=X.dtype.str)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        im.do_predict(X)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, busy = kernel_rows(prof)
    say(f"profile[predict]: one batch of {len(X)} x {X.shape[1]} tokens in "
        f"{wall * 1e3:.2f} ms under the profiler, kernels "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% of the wall)")
    for name, count, ms in rows[:12]:
        say(f"profile[predict]   {ms:9.3f} ms  {count:4d} calls  "
            f"{name[:90]}")


def profile_steps(b, kv_quant: str, route: str, boundaries: int) -> None:
    """Wall time per decode step over ``boundaries`` boundaries of a full
    batch, then ``torch.profiler`` over as many more: the device's busy
    share (summed kernel time over the profiled wall) and the kernels that
    take the most time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    steps0 = b.decode_steps
    t0 = time.perf_counter()
    for _ in range(boundaries):
        b.step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_steps = b.decode_steps - steps0
    steps0 = b.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(boundaries):
            b.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = b.decode_steps - steps0
    check(b.active == GENERATION["max_active_slots"],
          f"profile[{kv_quant}/{route}]: {b.active} active rows")
    rows, busy = kernel_rows(prof)
    say(f"profile[{kv_quant}/{route}]: {plain_steps} decode steps (8 rows) "
        f"in {plain_wall * 1e3:.2f} ms = {plain_wall * 1e3 / plain_steps:.3f}"
        f" ms/step; under the profiler {wall * 1e3 / steps:.3f} ms/step, "
        f"kernels {busy * 1e3 / steps:.3f} ms/step ({100 * busy / wall:.1f}% "
        f"of the profiled wall)")
    for name, count, ms in rows[:10]:
        say(f"profile[{kv_quant}/{route}]   {ms / steps:8.4f} ms/step  "
            f"{count // steps:4d} calls/step  {name[:90]}")


def profile_decode(im, waves, kv_quant: str, boundaries: int = 4) -> None:
    """The decode step of a full batch (8 active rows, no admissions) read
    on both routes in one run: each quantum run eagerly, then, after
    ``warm()`` captured the lane's graph between two boundaries, each
    quantum replayed.  Budgets of 128 tokens keep all 8 rows active
    through both readings."""
    b = ContinuousBatcher(im, GenerationParams(**dict(
        GENERATION, kv_quant=kv_quant, max_tokens=128)))
    for rid, prompt in waves[0]:
        b.submit(GenRequest(rid, prompt))
    b.step()                              # admission + first quantum
    b.step()
    profile_steps(b, kv_quant, "eager", boundaries)
    doc = b.warm()
    check(doc["failed"] == 0 and b.captures == 1,
          f"profile[{kv_quant}]: warm-up {doc}")
    b.step()
    profile_steps(b, kv_quant, "graph", boundaries)
    check(b.stats()["replays"] == 2 * boundaries + 1,
          f"profile[{kv_quant}]: replays {b.stats()['replays']}")


# -- phase 5: training: the flash backward kernels and Estimator.fit ----------

def flash_bwd_bound(B, H, T, D, causal, part="both", in_bytes=4):
    """The least time for the backward (``part="both"``: q, k, v, O, dO and
    the LSE read once, dq, dk, dv written once; 10·D flop per kept pair:
    recompute s, then dp, dv, dk, dq) or for one kernel's function alone
    (``"dq"``: q, k, v, dO, LSE and delta in, dq out, 6·D flop a pair;
    ``"dkv"``: the same inputs, dk and dv out, 8·D flop a pair)."""
    pairs = T * (T + 1) // 2 if causal else T * T
    tensors = {"both": 8, "dq": 5, "dkv": 6}[part]
    rows = {"both": 1, "dq": 2, "dkv": 2}[part]     # LSE (and delta)
    nbytes = B * H * T * (D * in_bytes * tensors + 4 * rows)
    flop = {"both": 10, "dq": 6, "dkv": 8}[part] * D
    return bound(nbytes, (flop * B * H * pairs, TF32X3_FLOP_PER_S))


def bwd_case(g, B, T, H, D, dt, causal, lse_ct, out_dtype=None):
    """q/k/v as strided views of one projection, their forward through the
    kernel (output and LSE), and cotangents: dO a (B, H, T, D) view of
    (B, T, H, D) memory as autograd hands it over, and optionally one for
    the LSE."""
    q, k, v = qkv_views(g, B, T, H, D, dt)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                           out_dtype=out_dtype, impl="cuda")
    o_dt = out_dtype or dt
    dO = torch.from_numpy(g.standard_normal((B, T, H, D), dtype=np.float32)
                          ).to("cuda", o_dt).transpose(1, 2)
    g_lse = torch.from_numpy(g.standard_normal((B, H, T), dtype=np.float32)
                             ).cuda() if lse_ct else None
    return q, k, v, out, lse, dO, g_lse


def run_bwd(case, causal, impl, scale=None):
    q, k, v, out, lse, dO, g_lse = case
    return fa.flash_attention_bwd(q, k, v, out, lse, dO, g_lse, causal,
                                  scale, impl)


def check_grads(tag, got, ref, atol, rtol) -> float:
    return max(check_close(f"{tag} {name}", a, b, atol, rtol)
               for name, a, b in zip(("dq", "dk", "dv"), got, ref))


def flash_bwd_parity(seed: int) -> dict:
    """dq, dk, dv from the kernels against the plain backward over dtypes,
    masks, ragged T, head_dim, the LSE cotangent and bf16 inputs with an
    f32 output.  Returns the worst abs error per gradient dtype."""
    g = np.random.default_rng(seed + 60)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(dt, causal, T, 64, lse_ct, None)
             for dt in (torch.float32, torch.bfloat16)
             for causal in (False, True) for T in (77, 1000, 1024)
             for lse_ct in (False, True)]
    cases += [(torch.float32, True, 77, 32, True, None),
              (torch.float32, False, 200, 32, False, None),
              (torch.float32, True, 1000, 128, True, None),
              (torch.bfloat16, False, 77, 128, False, None),
              (torch.bfloat16, True, 1000, 64, True, torch.float32)]
    for dt, causal, T, D, lse_ct, out_dt in cases:
        case = bwd_case(g, 2, T, 4, D, dt, causal, lse_ct, out_dt)
        got = run_bwd(case, causal, "cuda")
        torch.cuda.synchronize()
        ref = run_bwd(case, causal, "torch")
        tag = (f"flash-bwd[{str(dt)[6:]} causal={causal} T={T} D={D} "
               f"lse_ct={lse_ct}{' out f32' if out_dt else ''}]")
        worst[dt] = max(worst[dt], check_grads(tag, got, ref,
                                               *FLASH_TOL[dt]))
    say(f"flash-bwd parity: {len(cases)} cases, max abs err f32 "
        f"{worst[torch.float32]:.3e} (atol {FLASH_TOL[torch.float32][0]}, "
        f"rtol {FLASH_TOL[torch.float32][1]}), bf16 "
        f"{worst[torch.bfloat16]:.3e} (atol {FLASH_TOL[torch.bfloat16][0]},"
        f" rtol {FLASH_TOL[torch.bfloat16][1]})")
    return worst


def flash_bwd_path(seed: int, B=8, H=12, T=1024, D=64, iters=20) -> dict:
    """The path shape: kernels vs plain (dq, dk, dv), a planted fault (the
    plain backward's scale off by ``PLANTED_SCALE_ERR``) that the check
    must reject, bitwise-equal gradients from two launches, then the
    timing of each kernel, both, the plain backward and SDPA's
    backward."""
    g = np.random.default_rng(seed + 61)
    case = bwd_case(g, B, T, H, D, torch.float32, True, False)
    q, k, v, out, lse, dO, _ = case
    scale = 1.0 / math.sqrt(D)
    got = run_bwd(case, True, "cuda")
    again = run_bwd(case, True, "cuda")
    torch.cuda.synchronize()
    ref = run_bwd(case, True, "torch")
    tag = f"flash-bwd[path {(B, H, T, D)} f32 causal]"
    err = check_grads(tag, got, ref, *FLASH_TOL[torch.float32])
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{tag}: two launches gave different gradients")
    bad = run_bwd(case, True, "torch", scale * (1 + PLANTED_SCALE_ERR))
    try:
        planted = check_grads("planted", got, bad, *FLASH_TOL[torch.float32])
    except SmokeFailure:
        planted = max(float((a - b).abs().max()) for a, b in zip(got, bad))
    else:
        raise SmokeFailure(f"{tag}: a scale off by {PLANTED_SCALE_ERR} "
                           f"passes the parity check (err {planted:.3e})")
    say(f"{tag} parity: max abs err {err:.3e} (dq, dk, dv; atol "
        f"{FLASH_TOL[torch.float32][0]}, rtol {FLASH_TOL[torch.float32][1]})"
        f"; two launches bitwise equal; planted fault (scale x "
        f"{1 + PLANTED_SCALE_ERR}) err {planted:.3e}, rejected")

    delta = fa._delta(out, dO, None)
    ms_dq = cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, dO, lse, delta, True,
                                            scale), iters=iters)
    ms_dkv = cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, dO, lse, delta, True,
                                              scale), iters=iters)
    ms = cuda_ms(lambda: run_bwd(case, True, "cuda"), iters=iters)
    plain_ms = cuda_ms(lambda: run_bwd(case, True, "torch"),
                       iters=iters // 2)
    # SDPA's backward runs on autograd's streams, which a CUDA graph
    # capture on a side stream cannot take: timed as back-to-back calls
    # between CUDA events instead (the host enqueues far faster than the
    # ~1 ms of device work per call, so the device stays busy)
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                       scale=scale)
    lib_ms = events_ms(lambda: torch.autograd.grad(
        o, (qq, kk, vv), dO, retain_graph=True), iters=iters)
    b = flash_bwd_bound(B, H, T, D, True)
    say(f"flash-bwd timing (B={B}, H={H}, T={T}, D={D}, f32, causal): "
        f"kernels {ms:.4f} ms (dq {ms_dq:.4f}, dk/dv {ms_dkv:.4f}; delta "
        f"in torch included), plain {plain_ms:.4f} ms, SDPA backward "
        f"{lib_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
        f"{b['bytes']} B, {b['ops']} flop)")
    return {"ms_dq": ms_dq, "ms_dkv": ms_dkv, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "max_abs_err": err}


def events_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device time of one call of ``fn``: ``iters`` back-to-back calls
    between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def flash_bwd_smem() -> str:
    """The backward kernels' dynamic shared memory a block, per input type
    and head_dim, as the library reports it (ptxas -v shows only static
    shared memory)."""
    fn = _build.load(fa.KERNEL_BWD).flash_attention_bwd_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return ", ".join(
        f"{kern}[{tag} D={d}] {fn(ib, gb, d, dkv)} B"
        for kern, dkv in (("dq", 0), ("dkv", 1))
        for tag, ib, gb in (("f32", 0, 0), ("bf16", 1, 1), ("bf16 dO f32", 1, 0))
        for d in fa.KERNEL_HEAD_DIMS)


def flash_bwd_phase(seed: int) -> dict:
    """Parity and timing of the backward kernels; their two records
    (launches filled by the training phase)."""
    say(f"flash-bwd smem: {flash_bwd_smem()}")
    worst = flash_bwd_parity(seed)
    t = flash_bwd_path(seed)
    err = max(worst[torch.float32], t["max_abs_err"])
    shape = (8, 12, 1024, 64)
    whole = flash_bwd_bound(*shape, True)
    out = {}
    for part, line in (("dq", 158), ("dkv", 194)):
        own = flash_bwd_bound(*shape, True, part)
        # no plain or library call computes one kernel's function alone,
        # so the contract's fields hold the whole backward, and each
        # kernel's own time and bound stand beside them
        out[part] = {
            "name": f"flash_attention_bwd_{part}[f32]", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"analytics_zoo_tpu/ops/flash_attention.py:{line}",
            "launches": None, "max_abs_err": err,
            "scope": "ms, plain_ms, bound_ms and library_ms are of the "
                     "whole backward: the dq and dk/dv kernels with delta, "
                     "the plain backward, SDPA's backward; kernel_ms and "
                     "kernel_bound_ms are of this kernel alone",
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": whole["bound_ms"], "bound_by": whole["bound_by"],
            "library_ms": t["library_ms"], "kernel_ms": t[f"ms_{part}"],
            "kernel_bound_ms": own["bound_ms"],
            "kernel_bound_by": own["bound_by"]}
    return out


def train_data(seed: int):
    """``TRAIN_SEQS`` sequences of ``seq_len + 1`` ids from a ``TRAIN_SUBVOCAB``-id
    sub-vocabulary, each a motif of 8..64 ids repeated: ``x = s[:, :-1]``,
    ``y = s[:, 1:]``."""
    g = np.random.default_rng(seed + 70)
    sub = g.choice(TRAIN["vocab"], TRAIN_SUBVOCAB, replace=False)
    L = TRAIN["seq_len"] + 1
    seqs = np.stack([np.resize(g.choice(sub, int(g.integers(8, 65))), L)
                     for _ in range(TRAIN_SEQS)]).astype(np.int64)
    return seqs[:, :-1], seqs[:, 1:]


def train_layers() -> Sequential:
    """Named, so that every process's model has the same leaf paths
    (phase 17 holds its ranks' weights to the parent's by path)."""
    T = TRAIN["seq_len"]
    return Sequential([TransformerLayer(**TRAIN, input_shape=(T,),
                                        name="gpt2"),
                       Dense(TRAIN["vocab"], activation="softmax",
                             name="lm_head")])


def build_train_model(seed: int) -> Sequential:
    return train_layers().init_weights(seed)


def train_run(model, x, y, seed: int) -> dict:
    """``Estimator.fit`` over (x, y), one epoch of ``TRAIN_BATCH``: the
    per-step losses (kept as device tensors by a step listener, read after
    the run), the host-clock wall time to the last step's end, the
    kernels' launch counts over exactly that run, and the peak device
    memory."""
    dev = next(model.parameters()).device
    est = Estimator(model, optimizer=Adam(lr=TRAIN_LR),
                    loss="sparse_categorical_crossentropy",
                    clip_norm=TRAIN_CLIP, registry=MetricsRegistry(),
                    ctx=ZooContext(ZooConf(seed=seed, device=str(dev))))
    losses = []
    est._listeners.append(lambda step, loss: losses.append(loss))
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    est.fit(x, y, batch_size=TRAIN_BATCH, epochs=1, verbose=False)
    sync(dev)
    wall = time.perf_counter() - t0
    return {"losses": [float(v) for v in losses], "wall_s": wall,
            "flash": fa.launches, "dq": fa.dq_launches,
            "dkv": fa.dkv_launches, "summary": est.fit_summary(),
            "peak_bytes": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else 0, "estimator": est}


def check_train(tag: str, run: dict, kernels: bool) -> None:
    """8 finite losses, a falling loss, fit_summary's 8 steps and 64
    weighted samples, and launches = 12 blocks x 8 steps for each kernel
    (0 for the plain run)."""
    n_steps = TRAIN_SEQS // TRAIN_BATCH
    ls = run["losses"]
    check(len(ls) == n_steps and all(math.isfinite(v) for v in ls),
          f"train[{tag}]: losses {ls}")
    check(ls[-1] < ls[0], f"train[{tag}]: the loss did not fall ({ls})")
    summ = run["summary"]
    check(summ["steps"] == n_steps and summ["samples"] == TRAIN_SEQS,
          f"train[{tag}]: fit_summary counts {summ['steps']} steps, "
          f"{summ['samples']} samples")
    want = TRAIN["n_block"] * n_steps if kernels else 0
    for key in ("flash", "dq", "dkv"):
        check(run[key] == want, f"train[{tag}]: {key} launches "
                                f"{run[key]} != {want}")
    tokens = TRAIN_SEQS * TRAIN["seq_len"]
    say(f"train[{tag}]: {n_steps} steps of {TRAIN_BATCH} x "
        f"{TRAIN['seq_len']} tokens in {run['wall_s']:.3f} s (host clock) ="
        f" {run['wall_s'] / n_steps * 1e3:.1f} ms/step, "
        f"{tokens / run['wall_s']:.0f} tokens/s; losses "
        f"{[round(v, 5) for v in ls]}; flash forward / dq / dk/dv launches "
        f"{run['flash']} / {run['dq']} / {run['dkv']}; peak device memory "
        f"{run['peak_bytes'] / 2 ** 30:.2f} GiB")


def train_phase(seed: int, records: dict, profile: bool) -> Sequential:
    """The same seeded weights and data trained through the kernels and
    through their plain versions; launches fill the records.  Returns the
    host copy of the seeded model (phase 14 trains it again)."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    host = build_train_model(seed)
    x, y = train_data(seed)
    say(f"model: Sequential[TransformerLayer {TRAIN}, Dense("
        f"{TRAIN['vocab']}, softmax)] ({host.param_count()} params) built "
        f"in {time.perf_counter() - t0:.2f} s; data {x.shape[0]} sequences "
        f"of {x.shape[1] + 1} ids from {TRAIN_SUBVOCAB} ids")
    # one step through each route first, on throwaway copies, so that
    # neither timed run pays the first use of the training shapes
    # (allocator growth, cuBLAS's choice of GEMM) on the host clock
    for impl in (None, "torch"):
        model = copy.deepcopy(host).to(dev)
        set_impl(model, impl)
        train_run(model, x[:TRAIN_BATCH], y[:TRAIN_BATCH], seed)
        del model
    runs = {}
    for tag, impl in (("kernel", None), ("plain", "torch")):
        model = copy.deepcopy(host).to(dev)
        set_impl(model, impl)
        runs[tag] = train_run(model, x, y, seed)
        check_train(tag, runs[tag], kernels=impl is None)
        if profile and impl is None:
            profile_train(runs[tag]["estimator"], x, y)
        del model, runs[tag]["estimator"]
        torch.cuda.empty_cache()
    gap = loss_gap(runs["kernel"], runs["plain"])
    check(gap <= TRAIN_LOSS_TOL,
          f"train: kernel and plain losses differ by {gap:.3e} > "
          f"{TRAIN_LOSS_TOL} ({runs['kernel']['losses']} vs "
          f"{runs['plain']['losses']})")
    say(f"train: kernel vs plain loss, max abs diff over "
        f"{len(runs['plain']['losses'])} steps {gap:.3e} (tolerance "
        f"{TRAIN_LOSS_TOL}); loss {runs['kernel']['losses'][0]:.4f} -> "
        f"{runs['kernel']['losses'][-1]:.4f}")
    records["flash_bwd_dq"]["launches"] = runs["kernel"]["dq"]
    records["flash_bwd_dkv"]["launches"] = runs["kernel"]["dkv"]
    for tag, name, spoil, must_reject in TRAIN_FAULTS:
        model = copy.deepcopy(host).to(dev)
        with planted(name, spoil):
            bad = train_run(model, x, y, seed)
        del model, bad["estimator"]
        gap = loss_gap(bad, runs["plain"])
        rejected = gap > TRAIN_LOSS_TOL
        say(f"train[planted {tag}]: max abs loss diff to train[plain] "
            f"{gap:.3e}, {'rejected' if rejected else 'passes'} at "
            f"tolerance {TRAIN_LOSS_TOL}")
        check(rejected or not must_reject,
              f"train: the planted fault '{tag}' passes the loss check "
              f"({gap:.3e} <= {TRAIN_LOSS_TOL})")
    torch.cuda.empty_cache()
    return host


def loss_gap(run: dict, ref: dict) -> float:
    return max(abs(a - b) for a, b in zip(run["losses"], ref["losses"]))


@contextlib.contextmanager
def planted(name: str, spoil):
    """``fa.<name>`` (a backward kernel's wrapper, which the autograd
    backward looks up at each call) spoils its output with ``spoil``
    while the block runs."""
    launch = getattr(fa, name)

    def faulty(*args):
        out = launch(*args)
        spoil(out)
        return out

    setattr(fa, name, faulty)
    try:
        yield
    finally:
        setattr(fa, name, launch)


def profile_train(est, x, y) -> None:
    """One more optimizer step under ``torch.profiler``: the device's busy
    share of the wall time and the kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile
    dev = est.device
    batch = est._transfer((x[:TRAIN_BATCH], y[:TRAIN_BATCH],
                           np.ones(TRAIN_BATCH, np.float32)))
    est.model.train()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est._train_step(*batch[:3])
        sync(dev)
        wall = time.perf_counter() - t0
    est.model.eval()
    rows, busy = kernel_rows(prof)
    say(f"profile[train]: one step of {TRAIN_BATCH} x {TRAIN['seq_len']} "
        f"tokens in {wall * 1e3:.2f} ms under the profiler, kernels "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% of the wall)")
    for name, count, ms in rows[:14]:
        say(f"profile[train]   {ms:9.3f} ms  {count:4d} calls  {name[:90]}")


# -- phase 6: ResNet-50 training: the fused_bn kernel and Estimator.fit --------

def fused_bn_bound(M, K, N, dtype) -> dict:
    """x, w read once, y (input dtype) and the sums (f32) written once;
    2·K flop per output on the tensor cores (f32-accurate 3xTF32, or
    bf16) plus 3 elementwise f32 flop per output for the sums."""
    eb = torch.finfo(dtype).bits // 8
    nbytes = (M * K + K * N + M * N) * eb + 2 * N * 4
    rate = TF32X3_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
    return bound(nbytes, (2 * M * K * N, rate), (3 * M * N, F32_FLOP_PER_S))


def fused_bn_shapes(model, batch: int):
    """The distinct (M, K, N) of the model's fusion plan at ``batch``, in
    plan order, with how many pairs give each."""
    count = {}
    for conv, _ in model.fusion_plan:
        m = batch * math.prod(conv.shape[:-1])
        key = (m, conv.inputs[0].shape[-1], conv.shape[-1])
        count[key] = count.get(key, 0) + 1
    return count


def fused_bn_case(g, M, K, N, dtype, row_pad=0, device="cuda"):
    """Unit-scale x (M, K), read through a row stride of K + row_pad (drawn
    on the device from a seed taken from ``g``), and w ~ N(0, 1/K)
    (K, N)."""
    x = torch.empty(M, K + row_pad, device=device)
    x.normal_(generator=generator(int(g.integers(2 ** 31)), device))
    x = x.to(dtype)[:, :K]
    w = torch.from_numpy((g.standard_normal((K, N)) / math.sqrt(K)).astype(
        np.float32)).to(device, dtype)
    return x, w


def check_fused_bn(tag, got, ref):
    """y within FUSED_BN_TOL, Σ² within STATS_RTOL of itself, Σ within
    STATS_RTOL of itself plus 1e-5 · Σ|y|.  Returns y's max abs error and
    the sums' max error relative to Σ|y| and Σy² (the scales their f32
    rounding goes with)."""
    (y, s), (y_ref, s_ref) = got, ref
    atol, rtol = FUSED_BN_TOL[y.dtype]
    y_err = check_close(f"{tag} y", y, y_ref, atol, rtol)
    scale = (y_ref.float().abs().sum(0), s_ref[1].abs())
    s_err = 0.0
    for i, name, floor in ((0, "sum", 1e-5 * scale[0]), (1, "sumsq", 0.0)):
        err = (s[i] - s_ref[i]).abs()
        ok = bool((err <= floor + STATS_RTOL * s_ref[i].abs()).all())
        s_err = max(s_err, float((err / scale[i].clamp_min(1e-30)).max()))
        check(bool(torch.isfinite(s[i]).all()) and ok,
              f"{tag} {name}: max abs err {float(err.max()):.3e} outside "
              f"rtol {STATS_RTOL}")
    return y_err, s_err


@contextlib.contextmanager
def planted_partials(spoil, sites: int):
    """``fb._launch_partials`` (which ``fused_bn`` looks up at each launch)
    hands its y and tile partials to ``spoil(y, part, site, sites)`` while
    the block runs; ``site`` counts the launches modulo ``sites`` (a
    forward launches the plan's pairs in order)."""
    launch = fb._launch_partials
    calls = [0]

    def faulty(x, w):
        y, part = launch(x, w)
        spoil(y, part, calls[0] % sites, sites)
        calls[0] += 1
        return y, part

    fb._launch_partials = faulty
    try:
        yield
    finally:
        fb._launch_partials = launch


def fused_bn_parity(seed: int, shapes) -> dict:
    """Kernel vs plain at every path shape (f32, the training dtype, and
    bf16, the probe's), at ragged shapes, a bitwise repeat, and the two
    planted faults.  Returns the worst (y abs error, sums relative error)
    per dtype."""
    g = np.random.default_rng(seed + 80)
    worst = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    cases = [(m, k, n, dt, 0) for (m, k, n) in shapes
             for dt in (torch.float32, torch.bfloat16)]
    # ragged: M off the 128-row tile, K odd, N = 10 (off the 64-column
    # tile), row strides past K
    cases += [(m, k, n, dt, pad) for m, k, n, pad in
              ((1000, 33, 10, 3), (6271, 255, 70, 1), (129, 1, 10, 0))
              for dt in (torch.float32, torch.bfloat16)]
    for m, k, n, dt, pad in cases:
        x, w = fused_bn_case(g, m, k, n, dt, pad)
        got = fb.fused_bn(x, w, impl="cuda")
        torch.cuda.synchronize()
        ref = fb.fused_bn(x, w, impl="torch")
        err = check_fused_bn(
            f"fused_bn[{str(dt)[6:]} ({m}, {k}, {n}) stride {k + pad}]",
            got, ref)
        worst[dt] = tuple(max(a, b) for a, b in zip(worst[dt], err))
        del x, w, got, ref
    say(f"fused_bn parity: {len(cases)} cases ({len(shapes)} path shapes "
        f"of ResNet-50 at batch {RESNET_BATCH} and 3 ragged, f32 and "
        f"bf16); y max abs err f32 {worst[torch.float32][0]:.3e} (atol, "
        f"rtol {FUSED_BN_TOL[torch.float32]}), bf16 "
        f"{worst[torch.bfloat16][0]:.3e} ({FUSED_BN_TOL[torch.bfloat16]}); "
        f"sums max err relative to Σ|y|, Σy² f32 "
        f"{worst[torch.float32][1]:.3e}, bf16 {worst[torch.bfloat16][1]:.3e}"
        f" (rtol {STATS_RTOL})")
    # the probe shape in f32: a repeat and the planted faults
    m, k, n = PROBE_SHAPE
    x, w = fused_bn_case(g, m, k, n, torch.float32)
    got = fb.fused_bn(x, w, impl="cuda")
    again = fb.fused_bn(x, w, impl="cuda")
    ref = fb.fused_bn(x, w, impl="torch")
    check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
          "fused_bn: two launches gave different results")
    planted = []
    with planted_partials(lambda y, part, site, sites: part[7].zero_(), 1):
        dropped = fb.fused_bn(x, w, impl="cuda")
    for tag, bad in (("y x 1.001", (got[0] * (1 + PLANTED_SCALE_ERR),
                                    got[1])),
                     ("tile 7's partials dropped", dropped)):
        try:
            check_fused_bn("planted", bad, ref)
        except SmokeFailure as e:
            planted.append(f"{tag} rejected ({str(e).split(': ', 1)[0]})")
        else:
            raise SmokeFailure(f"fused_bn: the planted fault '{tag}' passes "
                               "the parity check")
    say(f"fused_bn[probe {PROBE_SHAPE} f32]: two launches bitwise equal; "
        f"planted faults: {'; '.join(planted)}")
    return worst


def fused_bn_time(x, w, iters: int) -> dict:
    """The kernel, torch.matmul alone (the probe's xla_matmul: y only) and
    torch.matmul + a separate stats pass over y (its xla_matmul_stats) on
    the same operands."""
    def matmul_stats():
        y = torch.matmul(x, w).float()
        return torch.stack([y.sum(0), (y * y).sum(0)])
    return {"ms": cuda_ms(lambda: fb.fused_bn(x, w, impl="cuda"),
                          iters=iters),
            "library_matmul_ms": cuda_ms(lambda: torch.matmul(x, w),
                                         iters=iters),
            "library_ms": cuda_ms(matmul_stats, iters=iters)}


def fused_bn_timing(seed: int, shapes: dict, iters=20,
                    probe_iters=50) -> dict:
    """f32 at every path shape (``shapes``: (M, K, N) -> pairs a step) and
    the sum over a step's launches beside the sum of their bounds; then
    the probe shape in bf16; the plain version at the probe shape in
    both.  The probe shape, the one the kernels line reports, takes
    ``probe_iters`` graph iterations, the other shapes ``iters``."""
    g = np.random.default_rng(seed + 81)
    rows = []
    for (m, k, n), pairs in shapes.items():
        x, w = fused_bn_case(g, m, k, n, torch.float32)
        if (m, k, n) == PROBE_SHAPE:
            t = fused_bn_time(x, w, probe_iters)
            t["plain_ms"] = cuda_ms(lambda: fb.fused_bn(x, w, impl="torch"),
                                    iters=probe_iters)
        else:
            t = fused_bn_time(x, w, iters)
        b = fused_bn_bound(m, k, n, torch.float32)
        rows.append(dict(shape=[m, k, n], pairs=pairs, **t,
                         bound_ms=b["bound_ms"], bound_by=b["bound_by"]))
        say(f"fused_bn timing ({m}, {k}) @ ({k}, {n}) float32 x {pairs}: "
            f"kernel {t['ms']:.4f} ms, torch.matmul alone "
            f"{t['library_matmul_ms']:.4f} ms, torch.matmul + stats pass "
            f"{t['library_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}: {b['bytes']} B, {b['ops']} flop)")
        del x, w
    step = {key: sum(r[key] * r["pairs"] for r in rows)
            for key in ("ms", "library_matmul_ms", "library_ms", "bound_ms")}
    say(f"fused_bn timing, a ResNet-50 step's {sum(shapes.values())} "
        f"launches in f32: kernel {step['ms']:.3f} ms, torch.matmul alone "
        f"{step['library_matmul_ms']:.3f} ms, torch.matmul + stats "
        f"{step['library_ms']:.3f} ms, bounds {step['bound_ms']:.3f} ms "
        f"({100 * step['bound_ms'] / step['ms']:.1f}% of the kernel's)")
    probe = next(r for r in rows if tuple(r["shape"]) == PROBE_SHAPE)
    m, k, n = PROBE_SHAPE
    x, w = fused_bn_case(g, m, k, n, torch.bfloat16)
    tb = fused_bn_time(x, w, probe_iters)
    tb["plain_ms"] = cuda_ms(lambda: fb.fused_bn(x, w, impl="torch"),
                             iters=probe_iters)
    b = fused_bn_bound(m, k, n, torch.bfloat16)
    tb.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
    say(f"fused_bn timing ({m}, {k}) @ ({k}, {n}) bfloat16: kernel "
        f"{tb['ms']:.4f} ms, plain {tb['plain_ms']:.4f} ms, torch.matmul "
        f"alone {tb['library_matmul_ms']:.4f} ms, torch.matmul + stats pass "
        f"{tb['library_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}: {b['bytes']} B, {b['ops']} flop); f32 plain "
        f"{probe['plain_ms']:.4f} ms")
    return {"f32": probe, "shapes": rows, "step": step, "bf16": tb}


def fused_bn_phase(seed: int, model) -> dict:
    """Parity and timing of fused_bn; its record (launches filled by the
    training phase)."""
    shapes = fused_bn_shapes(model, RESNET_BATCH)
    say(f"fused_bn path shapes (M, K, N): pairs = "
        + ", ".join(f"{s}: {c}" for s, c in shapes.items()))
    worst = fused_bn_parity(seed, list(shapes))
    t = fused_bn_timing(seed, shapes)
    torch.cuda.empty_cache()
    lib = ("torch.matmul + y.sum(0), (y*y).sum(0) (the probe's "
           "xla_matmul_stats)")
    p, tb = t["f32"], t["bf16"]
    return {"name": "fused_bn[f32]", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/fused_bn.cu",
            "replaces": "tools/fused_bn_probe.py:37", "launches": None,
            "max_abs_err": worst[torch.float32][0],
            "sums_max_rel_err": worst[torch.float32][1],
            "shape": list(PROBE_SHAPE),
            "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": p["library_ms"], "library_call": lib,
            "library_matmul_ms": p["library_matmul_ms"],
            "library_matmul_call": "torch.matmul alone, y only (the "
                                   "probe's xla_matmul)",
            "shapes": [{k: r[k] for k in ("shape", "pairs", "ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "library_matmul_ms")}
                       for r in t["shapes"]],
            "step": t["step"],
            "bf16": dict({k: tb[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms",
                                             "library_matmul_ms")},
                         max_abs_err=worst[torch.bfloat16][0],
                         sums_max_rel_err=worst[torch.bfloat16][1])}


def resnet_data(seed: int):
    """``RESNET_STEPS + 2`` batches of 224x224x3 f32 images (the last batch
    held out) of ``RESNET_CLASSES`` classes drawn from the 1000: each class
    a per-channel offset ~ N(0, 1) under unit noise."""
    g = np.random.default_rng(seed + 90)
    n = (RESNET_STEPS + 1) * RESNET_BATCH
    classes = g.choice(RESNET["num_classes"], RESNET_CLASSES, replace=False)
    offsets = g.standard_normal((RESNET_CLASSES, 3)).astype(np.float32)
    pick = g.integers(0, RESNET_CLASSES, n)
    x = g.standard_normal((n,) + RESNET["input_shape"], dtype=np.float32)
    x += offsets[pick][:, None, None, :]
    y = classes[pick].astype(np.int64)
    b = RESNET_STEPS * RESNET_BATCH
    return x[:b], y[:b], x[b:], y[b:]


def resnet_run(model, x, y, x_eval, y_eval, seed: int) -> dict:
    """One warm-up step (the first batch), then ``Estimator.fit`` over (x,
    y): losses of every step (the warm-up's first), the host-clock time of
    the 8 steps, fused launches over all 9, peak device memory, and
    ``evaluate`` on the held-out batch."""
    dev = next(model.parameters()).device
    est = Estimator(model, optimizer=SGD(lr=RESNET_LR,
                                         momentum=RESNET_MOMENTUM),
                    loss="sparse_categorical_crossentropy",
                    metrics=["accuracy"], registry=MetricsRegistry(),
                    ctx=ZooContext(ZooConf(seed=seed, device=str(dev))))
    losses = []
    est._listeners.append(lambda step, loss: losses.append(loss))
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    est.fit(x[:RESNET_BATCH], y[:RESNET_BATCH], batch_size=RESNET_BATCH,
            epochs=1, verbose=False)
    sync(dev)
    t0 = time.perf_counter()
    est.fit(x, y, batch_size=RESNET_BATCH, epochs=1, verbose=False)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = fb.launches
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ev = est.evaluate(x_eval, y_eval, batch_size=RESNET_BATCH)
    return {"losses": [float(v) for v in losses], "wall_s": wall,
            "fused": launches, "peak_bytes": peak, "eval": ev,
            "estimator": est}


def check_resnet(tag: str, run: dict, plan_len: int, kernels: bool) -> None:
    """1 + 8 finite losses, the 8 steps' loss falling, fused launches =
    plan x 9 (0 for the plain run), a finite eval loss."""
    ls = run["losses"]
    check(len(ls) == RESNET_STEPS + 1 and all(math.isfinite(v) for v in ls),
          f"resnet[{tag}]: losses {ls}")
    check(ls[-1] < ls[1], f"resnet[{tag}]: the loss did not fall ({ls})")
    want = plan_len * (RESNET_STEPS + 1) if kernels else 0
    check(run["fused"] == want,
          f"resnet[{tag}]: fused_bn launches {run['fused']} != {want}")
    check(math.isfinite(run["eval"]["loss"]),
          f"resnet[{tag}]: eval {run['eval']}")
    n_img = RESNET_STEPS * RESNET_BATCH
    say(f"resnet[{tag}]: warm-up + {RESNET_STEPS} steps of {RESNET_BATCH} "
        f"images; the {RESNET_STEPS} in {run['wall_s']:.3f} s (host clock) "
        f"= {run['wall_s'] / RESNET_STEPS * 1e3:.1f} ms/step, "
        f"{n_img / run['wall_s']:.1f} images/s; losses "
        f"{[round(v, 5) for v in ls]}; fused_bn launches {run['fused']}"
        f"{f' (= {plan_len} x {RESNET_STEPS + 1})' if kernels else ''}; "
        f"peak device memory {run['peak_bytes'] / 2 ** 30:.2f} GiB; eval "
        f"loss {run['eval']['loss']:.6f}, accuracy "
        f"{run['eval']['accuracy']:.4f}")


def resnet_phase(seed: int, records: dict, profile: bool) -> None:
    """ImageClassifier("resnet50") trained through the kernel and through
    its plain version from the same weights; the free-running routes'
    drift against f32's own gradient error; the lockstep comparison and
    its planted faults."""
    t0 = time.perf_counter()
    ic = ImageClassifier(**RESNET)
    host = ic.model.init_weights(seed)
    plan_len = len(host.fusion_plan)
    x, y, x_eval, y_eval = resnet_data(seed)
    say(f"model: ImageClassifier({RESNET}).model, resnet(50) "
        f"({host.param_count()} params, {plan_len} fused conv+BN pairs) "
        f"built in {time.perf_counter() - t0:.2f} s; data {len(x)} + "
        f"{len(x_eval)} held-out images of {RESNET_CLASSES} classes")
    check(plan_len == 33, f"resnet: fusion plan of {plan_len} pairs, not 33")
    records["fused_bn"] = fused_bn_phase(seed, host)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for tag, impl in (("kernel", None), ("plain", "torch")):
            model = copy.deepcopy(host)
            set_impl(model, impl)
            runs[tag] = resnet_run(model, x, y, x_eval, y_eval, seed)
            check_resnet(tag, runs[tag], plan_len, kernels=impl is None)
            if profile and impl is None:
                profile_resnet(runs[tag]["estimator"], x, y)
            del model, runs[tag]["estimator"]
            torch.cuda.empty_cache()
        records["fused_bn"]["launches"] = runs["kernel"]["fused"]
        ev = [runs[t]["eval"]["loss"] for t in ("kernel", "plain")]
        say("resnet: free-running kernel vs plain loss (reported, not "
            "checked), per step " + ", ".join(
                f"{abs(a - b):.1e}" for a, b in zip(
                    runs["kernel"]["losses"], runs["plain"]["losses"]))
            + f"; eval loss {abs(ev[0] - ev[1]):.3e}")
        resnet_f64_reading(host, x, y)
        sound = resnet_lockstep(host, x, y, x_eval, y_eval, seed)
        check_lockstep("lockstep", sound, None)
        check([b for _, b in sound["pairs"]] == runs["plain"]["losses"],
              "resnet[lockstep]: its plain losses differ from "
              "resnet[plain]'s")
        for tag, spoil, must_reject in RESNET_FAULTS:
            with planted_partials(spoil, plan_len):
                bad = resnet_lockstep(host, x, y, x_eval, y_eval, seed)
            check_lockstep(f"planted {tag}", bad, must_reject)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del host, ic
    torch.cuda.empty_cache()


def resnet_lockstep(host, x, y, x_eval, y_eval, seed: int) -> dict:
    """The plain route's training over the warm-up batch and the 8 batches
    in ``fit``'s order (the Estimator's own step); before each step, the
    training forward's loss through the kernel from the same weights and
    BN state (the state restored after it).  Then ``evaluate`` of the
    trained model on the held-out batch through each route."""
    model = copy.deepcopy(host)
    dev = next(model.parameters()).device
    est = Estimator(model, optimizer=SGD(lr=RESNET_LR,
                                         momentum=RESNET_MOMENTUM),
                    loss="sparse_categorical_crossentropy",
                    metrics=["accuracy"], registry=MetricsRegistry(),
                    ctx=ZooContext(ZooConf(seed=seed, device=str(dev))))
    est._ensure_init()
    batches = []
    for xs, ys in ((x[:RESNET_BATCH], y[:RESNET_BATCH]), (x, y)):
        batches += list(ArrayFeatureSet(xs, ys).batches(
            RESNET_BATCH, shuffle=True, rng=np.random.default_rng(seed),
            pad_final=True))
    pairs = []
    model.train()
    for batch in batches:
        sx, sy, sw, *_ = est._transfer(batch)
        state = [b.clone() for b in model.buffers()]
        set_impl(model, None)
        with torch.no_grad():
            lk = est._loss_sum(model(sx), sy, sw) / sw.sum()
        with torch.no_grad():
            for b, s in zip(model.buffers(), state):
                b.copy_(s)
        set_impl(model, "torch")
        lp = est._train_step(sx, sy, sw)
        est.global_step += 1
        pairs.append((float(lk), float(lp)))
    evals = {}
    for tag, impl in (("kernel", None), ("plain", "torch")):
        set_impl(model, impl)
        reset_launches()
        evals[tag] = est.evaluate(x_eval, y_eval, batch_size=RESNET_BATCH)
        evals[tag + "_fused"] = fb.launches
    del model, est
    torch.cuda.empty_cache()
    return {"pairs": pairs, "eval": evals}


def check_lockstep(tag: str, run: dict, must_reject) -> None:
    """Sound run (``must_reject`` None): kernel and plain losses within
    ``RESNET_LOSS_TOL`` at every step, and ``evaluate`` (moving statistics,
    nothing fused) equal on both routes with no fused launch.  Planted
    fault: reported, and rejected by the same tolerance where it must
    be."""
    gaps = [abs(a - b) for a, b in run["pairs"]]
    ev = run["eval"]
    say(f"resnet[{tag}]: kernel vs plain training-forward loss at the same "
        f"weights, per step " + ", ".join(f"{g:.2e}" for g in gaps)
        + f" (max {max(gaps):.3e}, tolerance {RESNET_LOSS_TOL}); plain "
        f"losses {[round(b, 5) for _, b in run['pairs']]}; evaluate: kernel "
        f"route {ev['kernel']}, plain {ev['plain']}, fused launches "
        f"{ev['kernel_fused']} / {ev['plain_fused']}")
    check(all(math.isfinite(a) and math.isfinite(b)
              for a, b in run["pairs"]), f"resnet[{tag}]: {run['pairs']}")
    if must_reject is None:
        check(max(gaps) <= RESNET_LOSS_TOL,
              f"resnet[{tag}]: kernel and plain losses differ by "
              f"{max(gaps):.3e} > {RESNET_LOSS_TOL}")
        check(ev["kernel"] == ev["plain"] and ev["kernel_fused"] == 0
              and ev["plain_fused"] == 0,
              f"resnet[{tag}]: evaluate differs between the routes or "
              f"launched fused_bn ({ev})")
    elif must_reject:
        check(max(gaps) > RESNET_LOSS_TOL,
              f"resnet: the planted fault '{tag}' passes the loss check "
              f"({max(gaps):.3e} <= {RESNET_LOSS_TOL})")


def resnet_f64_reading(host, x, y) -> None:
    """How far one f32 training step's gradients are from float64 on each
    route: the first batch's loss and gradients through the kernel and
    through the plain version in f32, and through the plain (unfused)
    graph in float64; per parameter tensor, |g - g64| / |g64|."""
    dev = next(host.parameters()).device
    xb = torch.from_numpy(x[:RESNET_BATCH]).to(dev)
    yb = torch.from_numpy(y[:RESNET_BATCH]).to(dev)
    loss_fn = objectives.get("sparse_categorical_crossentropy")

    def grads(model, dt):
        model.train()
        loss = loss_fn(model(xb.to(dt)), yb).mean()
        loss.backward()
        return float(loss.detach()), [p.grad.double()
                                      for p in model.parameters()]
    out = {}
    for tag, impl in (("kernel", None), ("plain", "torch")):
        model = copy.deepcopy(host)
        set_impl(model, impl)
        out[tag] = grads(model, torch.float32)
        del model
    model = copy.deepcopy(host).double()
    model.fusion_plan = ()
    dtypes.set_policy(None, torch.float64)
    try:
        loss64, g64 = grads(model, torch.float64)
    finally:
        dtypes.set_policy(None)
    del model
    torch.cuda.empty_cache()
    for tag, (loss, g) in out.items():
        rel = sorted(float((a - b).norm() / b.norm()) for a, b in zip(g, g64))
        say(f"resnet[f32 vs f64, {tag} route]: first-batch loss {loss:.9f} "
            f"vs {loss64:.9f}; gradient error per parameter tensor median "
            f"{rel[len(rel) // 2]:.3e}, max {rel[-1]:.3e}")


def kernel_family(name: str) -> str:
    """The profile share a ResNet step's kernel counts toward."""
    low = name.lower()
    if "fused_bn" in low:
        return "fused_bn"
    if any(t in low for t in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                              "winograd", "implicit", "xmma")):
        return "cuDNN conv"
    if "gemm" in low:
        return "GEMM (fused_bn backward, fc)"
    if "foreach" in low or "multi_tensor" in low:
        return "SGD (foreach)"
    if "pool" in low:
        return "pooling"
    if any(t in low for t in ("elementwise", "reduce", "vectorized",
                              "unrolled")):
        return "BN and other elementwise / reductions"
    return "other"


def profile_resnet(est, x, y) -> None:
    """One more optimizer step under ``torch.profiler``: busy share and the
    shares of cuDNN convs, fused_bn, BN elementwise and SGD."""
    from torch.profiler import ProfilerActivity, profile
    dev = est.device
    batch = est._transfer((x[:RESNET_BATCH], y[:RESNET_BATCH],
                           np.ones(RESNET_BATCH, np.float32)))
    est.model.train()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est._train_step(*batch[:3])
        sync(dev)
        wall = time.perf_counter() - t0
    est.model.eval()
    rows, busy = kernel_rows(prof)
    say(f"profile[resnet]: one step of {RESNET_BATCH} images in "
        f"{wall * 1e3:.2f} ms under the profiler, kernels "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% of the wall)")
    shares = {}
    for name, count, ms in rows:
        fam = kernel_family(name)
        shares[fam] = shares.get(fam, 0.0) + ms
    for fam, ms in sorted(shares.items(), key=lambda kv: -kv[1]):
        say(f"profile[resnet]   {ms:9.3f} ms  {100 * ms / (busy * 1e3):5.1f}%"
            f"  {fam}")
    for name, count, ms in rows[:14]:
        say(f"profile[resnet]   {ms:9.3f} ms  {count:4d} calls  "
            f"{name[:90]}")


# -- phase 7: image classification --------------------------------------------

def conv_inventory(model, batch: int) -> dict:
    """The quantized forward's convolutions at ``batch``, in graph order:
    ``spatial`` (x shape, (kh, kw, cin/g, cout), strides, pads, dilation,
    groups) for the ``w8a8_conv2d`` kernel, and ``matmuls`` (M, K, N) for
    the matmul kernels: the pointwise convolutions, then the Dense head."""
    spatial, matmuls = [], []
    for node in model.nodes:
        layer, ins = node.layer, node.inputs
        if isinstance(layer, Convolution2D):
            shape = tuple(ins[0].shape)
            pads = tuple(tuple(p) for p in layer._pads(shape[:-1]))
            kshape = layer.kernel_size + (shape[-1] // layer.groups,
                                          layer.nb_filter)
            if qm._is_pointwise(kshape, layer.subsample, layer.dilation,
                                layer.groups, pads):
                matmuls.append((batch * math.prod(shape[:-1]), shape[-1],
                                layer.nb_filter))
            else:
                spatial.append(((batch,) + shape, kshape, layer.subsample,
                                pads, layer.dilation, layer.groups))
        elif isinstance(layer, Dense):
            shape = tuple(ins[0].shape)
            matmuls.append((batch * math.prod(shape[:-1]), shape[-1],
                            layer.output_dim))
    return {"spatial": spatial, "matmuls": matmuls}


def distinct(items) -> list:
    """[(item, times it occurs)] in order of first occurrence."""
    counts = {}
    for it in items:
        counts[it] = counts.get(it, 0) + 1
    return list(counts.items())


def conv_case(g, xshape, kshape, extremes=False, x_offset=0,
              device="cuda"):
    """x, w and scale of one w8a8_conv2d call: s8 values over all of
    [-128, 127], or (``extremes``) only -128 and 127; ``x_offset`` puts x
    that many bytes into its buffer."""
    if extremes:
        ends = np.array([-128, 127], np.int8)
        x, w = g.choice(ends, xshape), g.choice(ends, kshape)
    else:
        x = g.integers(-128, 128, xshape, dtype=np.int8)
        w = g.integers(-128, 128, kshape, dtype=np.int8)
    s = torch.from_numpy(g.uniform(1e-4, 1e-2, kshape[-1]).astype(
        np.float32)).to(device)
    xt = torch.from_numpy(x).to(device)
    if x_offset:
        buf = torch.zeros(x.size + x_offset, dtype=torch.int8, device=device)
        buf[x_offset:] = xt.flatten()
        xt = buf[x_offset:].view(xshape)
    return xt, torch.from_numpy(w).to(device), s


def run_conv(case, geom, impl, pack=None, bn=None, split=None):
    """One w8a8_conv2d call; ``pack``: the weight's K-major pack made
    beforehand (the route a quantized layer takes); ``bn`` / ``split``
    force the kernel's tile and split of K (its own launch, on the card)."""
    x, w, s = case
    _, _, strides, pads, dilation, groups = geom
    if bn is not None or split is not None:
        return qm._w8a8_conv_cuda(x, w, s, strides, pads, dilation, groups,
                                  pack, bn, split)
    kw = {} if pack is None else {"w_pack": pack}
    return qm.w8a8_conv2d(x, w, s, strides=strides, pads=pads,
                          dilation=dilation, groups=groups, impl=impl, **kw)


def conv_pack(case, geom):
    """The weight's pack, in trees whose kernel reads one (None in
    earlier trees: ``--kernel-timing`` runs there too)."""
    if not hasattr(qm, "pack_conv_weight"):
        return None
    return qm.pack_conv_weight(case[1], geom[5])


def conv_mnk(geom):
    """(M, N a group, K) of a conv geometry."""
    (b, h, w, c), (kh, kw, cg, cout), strides, pads, dil, groups = geom
    ho = (h + sum(pads[0]) - (kh - 1) * dil[0] - 1) // strides[0] + 1
    wo = (w + sum(pads[1]) - (kw - 1) * dil[1] - 1) // strides[1] + 1
    return b * ho * wo, cout // groups, kh * kw * cg


def conv_config_of(geom, device="cuda"):
    """The rule's (tile channels, split) for ``geom`` on this card."""
    m, ng, k = conv_mnk(geom)
    return qm.conv_config(m, ng, k, geom[5], qm._sm_count(0)
                          if device == "cuda" else qm.H100_SMS)


def conv_parity(seed: int, shapes, device="cuda") -> int:
    """w8a8_conv2d bitwise against its plain version at every path shape
    (the weight packed beforehand, the rule's config) and every
    ``CONV_RAGGED`` case (packed on the call); then, on the card, every
    tile config and split forced at the ``CONV_FORCED`` path shapes and
    ragged cases.  Returns the number of cases."""
    g = np.random.default_rng(seed + 90)
    cases = [(geom, False, 0, True) for geom in shapes] + [
        (geom[:6], geom[6], geom[7], False) for geom in CONV_RAGGED]
    forced = []
    if device == "cuda":
        picks = [(shapes[i], 0) for i in CONV_FORCED if i < len(shapes)] + [
            (CONV_RAGGED[i][:6], CONV_RAGGED[i][7])
            for i in CONV_FORCED_RAGGED]
        forced = [(geom, off, bn, split) for geom, off in picks
                  for bn in qm.CONV_BNS for split in qm.CONV_SPLITS]
    impl = "cuda" if device == "cuda" else None
    for geom, extremes, off, packed in cases:
        case = conv_case(g, geom[0], geom[1], extremes, off, device)
        pack = conv_pack(case, geom) if packed and device == "cuda" else None
        got = run_conv(case, geom, impl, pack)
        sync(torch.device(device))
        ref = run_conv(case, geom, "torch")
        check(torch.equal(got, ref),
              f"w8a8_conv2d {geom}, extremes {extremes}, x offset {off}: "
              f"not bitwise equal to the plain version (max abs err "
              f"{float((got - ref).abs().max()):.3e})")
    refs = {}
    for geom, off, bn, split in forced:
        if geom not in refs:
            case = conv_case(g, geom[0], geom[1], x_offset=off, device=device)
            refs[geom] = (case, conv_pack(case, geom),
                          run_conv(case, geom, "torch"))
        case, pack, ref = refs[geom]
        got = run_conv(case, geom, impl, pack, bn, split)
        sync(torch.device(device))
        check(torch.equal(got, ref),
              f"w8a8_conv2d {geom} forced to tile {bn}, split {split}: not "
              f"bitwise equal to the plain version (max abs err "
              f"{float((got - ref).abs().max()):.3e})")
    return len(cases) + len(forced)


def conv_planted(seed: int, geom, device="cuda") -> list:
    """Three planted faults the bitwise check must reject: the kernel run
    with one 16-deep k piece of the weight dropped, with the pads shifted
    by one (top and left one more, bottom and right one less), and split
    CONV_PLANTED_SPLIT ways by a build whose merge leaves out the partial
    of the block after each block's own (CONV_MERGE_SKIP; on the CPU,
    which runs no kernel, the plain version with block 1's K slice of the
    weight zeroed)."""
    g = np.random.default_rng(seed + 91)
    case = conv_case(g, geom[0], geom[1], device=device)
    ref = run_conv(case, geom, "torch")
    x, w, s = case
    kh, kw, cg, cout = geom[1]
    k = kh * kw * cg
    dropped = w.clone().view(k, cout)
    dropped[16:32] = 0
    shifted = tuple((lo + 1, hi - 1) for lo, hi in geom[3])
    impl = "cuda" if device == "cuda" else None
    split = CONV_PLANTED_SPLIT
    if device == "cuda":
        real = qm._conv_kernel_fn()
        fn = _build.load(CONV_SOURCE, CONV_MERGE_SKIP).w8a8_conv2d
        fn.argtypes, fn.restype = real.argtypes, real.restype
        qm._conv_fn = fn
        try:
            lost = run_conv(case, geom, impl, conv_pack(case, geom), None,
                            split)
        finally:
            qm._conv_fn = real
    else:
        per = -(-(-(-k // qm.CONV_BK)) // split) * qm.CONV_BK
        sliced = w.clone().view(k, cout)
        sliced[per:2 * per] = 0
        lost = run_conv((x, sliced.view(w.shape), s), geom, impl)
    faults = (("k 16-31 of the weight dropped",
               run_conv((x, dropped.view(w.shape), s), geom, impl)),
              (f"pads {geom[3]} run as {shifted}",
               run_conv(case, geom[:3] + (shifted,) + geom[4:], impl)),
              (f"split {split}, each block's merge without the next "
               f"block's partial", lost))
    out = []
    for tag, bad in faults:
        check(not torch.equal(bad, ref),
              f"w8a8_conv2d {geom}: the planted fault '{tag}' passes the "
              f"bitwise check")
        out.append(f"{tag} rejected ({int((bad != ref).sum())} outputs "
                   f"differ)")
    return out


def conv_bound(geom) -> dict:
    """x, w and the scale read once, the f32 output written once;
    2·M·N·K operations at the int8 rate."""
    (b, h, w, c), (_, _, _, cout) = geom[:2]
    m, _, k = conv_mnk(geom)
    return bound(b * h * w * c + k * cout + 4 * cout + 4 * m * cout,
                 (2 * m * cout * k, INT8_OP_PER_S))


def conv_timing(seed: int, geom, iters: int = 200) -> dict:
    """The kernel at one path shape, cycling over input sets, beside its
    plain version and cuDNN's f32 convolution of the same shape (the
    yardstick: not the same function) on an input padded beforehand."""
    g = np.random.default_rng(seed + 92)
    b = conv_bound(geom)
    sets = [conv_case(g, geom[0], geom[1]) for _ in range(n_sets(b["bytes"]))]
    packs = [conv_pack(c, geom) for c in sets]
    ms = cuda_ms(cycled([lambda c=c, p=p: run_conv(c, geom, "cuda", p)
                         for c, p in zip(sets, packs)]), iters=iters)
    plain_ms = cuda_ms(lambda: run_conv(sets[0], geom, "torch"), iters=3,
                       warmup=1)
    _, _, strides, pads, dil, groups = geom
    cudnn = []
    for x, w, _ in sets:
        xf = qm._pad_nhwc(x.float(), pads).permute(0, 3, 1, 2)
        wf = w.float().permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        cudnn.append((xf, wf))
    lib_ms = cuda_ms(cycled([
        lambda xf=xf, wf=wf: F.conv2d(xf, wf, stride=strides, dilation=dil,
                                      groups=groups)
        for xf, wf in cudnn]), iters=iters)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **b}


def pointwise_parity(seed: int, matmuls) -> None:
    """The w8a8 (bitwise) and w4a16 (W4_TOL, f32 x) matmul kernels at
    every (M, K, N) the quantized forward gives them."""
    g = np.random.default_rng(seed + 93)
    for m, k, n in matmuls:
        x, w, s = w8a8_case(g, m, k, n)
        got = qm.w8a8_matmul(x, w, s, impl="cuda")
        torch.cuda.synchronize()
        check(torch.equal(got, qm.w8a8_matmul(x, w, s, impl="torch")),
              f"w8a8 ({m}, {k}, {n}): not bitwise equal to the plain version")
        x4, wq4, sg = w4a16_case(g, m, k, n, 64)
        got = qm.w4a16_matmul(x4, wq4, sg, impl="cuda")
        torch.cuda.synchronize()
        check_close(f"w4a16 ({m}, {k}, {n})", got,
                    qm.w4a16_matmul(x4, wq4, sg, impl="torch"), *W4_TOL)


def conv_record(seed: int, spatial, iters: int = 200) -> dict:
    """Timing of w8a8_conv2d at each distinct path shape (``iters``
    launches each) and summed over the forward's launches (kernel, plain,
    cuDNN f32 yardstick, bound)."""
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
             "bytes_ms": 0.0, "ops_ms": 0.0}
    per = []
    for geom, n in distinct(spatial):
        t = conv_timing(seed, geom, iters)
        b = t["bytes"] / HBM_BYTES_PER_S * 1e3
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            total[key] += n * t[key]
        total["bytes_ms" if t["bound_by"] == "bytes" else "ops_ms"] += \
            n * t["bound_ms"]
        (bb, hh, ww, cc), (kh, kw, cg, cout), st, pads = geom[:4]
        cfg = (" tile 128 x {}, split {},".format(*conv_config_of(geom))
               if hasattr(qm, "conv_config") else "")
        say(f"conv timing x ({bb}, {hh}, {ww}, {cc}) k {kh}x{kw}/{st[0]} "
            f"cout {cout} pads {pads} (x{n} a forward):{cfg} kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, cuDNN f32 "
            f"conv2d (not the same function) {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
            f"{t['bytes']} B, {b:.4f} ms of bytes), "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of bound")
        per.append({"x": list(geom[0]), "k": list(geom[1]), "launches": n,
                    **{k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")}})
    say(f"conv timing, a forward's {len(spatial)} launches: kernel "
        f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, cuDNN f32 "
        f"(not the same function) {total['library_ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms, "
        f"{100 * total['bound_ms'] / total['ms']:.1f}% of bound")
    return {"name": "w8a8_conv2d", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/quant_conv.cu",
            "replaces": "analytics_zoo_tpu/ops/quant_matmul.py:334 "
                        "(w8a8_conv, beside the TPU kernels)",
            "launches": None, "max_abs_err": 0.0, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"]
            else "operations",
            "library_ms": total["library_ms"],
            "library": "cuDNN f32 conv2d (not the same function)",
            "per_shape": per}


def conv_forced_timing(seed: int, spatial, min_k: int = 1152) -> dict:
    """w8a8_conv2d with every tile and split forced, at each distinct
    path shape of K >= ``min_k`` (the deep convs, whose tiles fill too
    few SMs): the readings the rule (qm.conv_config) is held to.
    Returns {shape: {"128 x bn / split": ms}}."""
    g = np.random.default_rng(seed + 94)
    out = {}
    for geom, _ in distinct(spatial):
        if conv_mnk(geom)[2] < min_k:
            continue
        sets = [conv_case(g, geom[0], geom[1])
                for _ in range(n_sets(conv_bound(geom)["bytes"]))]
        packs = [conv_pack(c, geom) for c in sets]
        row = {f"128 x {bn} / {split}": cuda_ms(cycled([
            lambda c=c, p=p, bn=bn, split=split: run_conv(
                c, geom, "cuda", p, bn, split)
            for c, p in zip(sets, packs)]))
            for bn in qm.CONV_BNS for split in qm.CONV_SPLITS}
        (bb, hh, ww, cc), (kh, kw, _, cout), st = geom[:3]
        key = f"x ({bb}, {hh}, {ww}, {cc}) k {kh}x{kw}/{st[0]} cout {cout}"
        bn, split = conv_config_of(geom)
        say(f"conv forced {key} (rule: 128 x {bn} / {split}): "
            + ", ".join(f"{cfg} {ms:.4f} ms" for cfg, ms in row.items()))
        out[key] = row
    return out


def pointwise_timing(seed: int, matmuls) -> dict:
    """The w8a8 and w4a16 (f32 x) kernels at each distinct (M, K, N) of
    the forward, summed over its launches, beside their bounds and, for
    w8a8, torch._int_mm + scale (M padded to 32, N to a multiple of 8)."""
    g = np.random.default_rng(seed + 94)
    tot = {"w8": 0.0, "w8_bound": 0.0, "w8_lib": 0.0, "w4": 0.0,
           "w4_bound": 0.0}
    for (m, k, n), count in distinct(matmuls):
        b8, b4 = w8a8_bound(m, k, n), w4a16_bound(m, k, n, -(-k // 64))
        sets = [w8a8_case(g, m, k, n) for _ in range(n_sets(b8["bytes"]))]
        ms8 = cuda_ms(cycled([lambda c=c: qm.w8a8_matmul(*c, impl="cuda")
                              for c in sets]), iters=100)
        mp, n8 = max(32, -(-m // 8) * 8), -(-n // 8) * 8
        padded = []
        for x, w, sc in sets:
            xp = torch.zeros(mp, k, dtype=torch.int8, device="cuda")
            xp[:m] = x
            wp = torch.zeros(k, n8, dtype=torch.int8, device="cuda")
            wp[:, :n] = w
            padded.append((xp, wp, sc))
        lib = cuda_ms(cycled([
            lambda c=c: torch._int_mm(c[0], c[1])[:m, :n].float() * c[2]
            for c in padded]), iters=100)
        sets4 = [w4a16_case(g, m, k, n, 64)
                 for _ in range(n_sets(b4["bytes"]))]
        ms4 = cuda_ms(cycled([lambda c=c: qm.w4a16_matmul(*c, impl="cuda")
                              for c in sets4]), iters=100)
        for key, v in (("w8", ms8), ("w8_bound", b8["bound_ms"]),
                       ("w8_lib", lib), ("w4", ms4),
                       ("w4_bound", b4["bound_ms"])):
            tot[key] += count * v
        say(f"pointwise timing ({m}, {k}, {n}) x{count} a forward: w8a8 "
            f"{ms8:.4f} ms (bound {b8['bound_ms']:.4f}, "
            f"{100 * b8['bound_ms'] / ms8:.1f}%; torch._int_mm + scale "
            f"{lib:.4f}), w4a16 f32 x {ms4:.4f} ms (bound "
            f"{b4['bound_ms']:.4f}, {100 * b4['bound_ms'] / ms4:.1f}%)")
        del sets, padded, sets4
    say(f"pointwise timing, a forward's {len(matmuls)} launches: w8a8 "
        f"{tot['w8']:.4f} ms (bound {tot['w8_bound']:.4f}, torch._int_mm + "
        f"scale {tot['w8_lib']:.4f}), w4a16 {tot['w4']:.4f} ms (bound "
        f"{tot['w4_bound']:.4f})")
    return tot


def image_params(seed: int, model, calib) -> tuple:
    """(params, state) numpy trees for ``model`` (a ResNet graph) from
    ``seed``: its initializer's weights, BatchNorm gamma / beta / moving
    statistics drawn, and the head scaled so that its logits have
    IMAGE_LOGIT_STD over ``calib``."""
    model.init_weights(seed)
    g = np.random.default_rng(seed + 110)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNormalization):
                d = m.gamma.shape[0]
                for t, v in ((m.gamma, g.uniform(0.5, 1.5, d)),
                             (m.beta, g.normal(0, 0.1, d)),
                             (m.mean, g.normal(0, 0.1, d)),
                             (m.var, g.uniform(0.5, 2.0, d))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    head = model.graph_layers[-1]
    seen = []
    hook = head.register_forward_pre_hook(
        lambda _m, args: seen.append(args[0]))
    dev = next(model.parameters()).device
    with torch.inference_mode():
        model.eval()(torch.from_numpy(calib).to(dev))
    hook.remove()
    with torch.no_grad():
        logits = seen[0].double() @ head.W.double()
    params = numpy_tree(export_params(model))
    params[head.name]["W"] = params[head.name]["W"] * np.float32(
        IMAGE_LOGIT_STD / float(logits.std()))
    return params, numpy_tree(export_state(model))


def numpy_tree(tree):
    """A tree of tensors as numpy leaves."""
    return {k: numpy_tree(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in tree.items()}


def image_sources(seed: int, n: int) -> list:
    """Seeded BGR uint8 images; the first holds a 255 pixel."""
    g = np.random.default_rng(seed + 111)
    imgs = [g.integers(0, 256, IMAGE_SOURCE, dtype=np.uint8)
            for _ in range(n)]
    imgs[0][0, 0] = 255
    return imgs


def image_records(seed: int, n: int = 0) -> list:
    """(uri, PNG bytes, u8) of ``n`` records (IMAGE_RECORDS by default):
    the first half on the float path, the second on the u8 path, so that
    most batches hold one kind and the u8 ones reach the device
    compact."""
    import cv2
    n = n or IMAGE_RECORDS
    out = []
    for i, img in enumerate(image_sources(seed, n)):
        ok, buf = cv2.imencode(".png", img)
        check(ok, "cv2 could not encode a PNG")
        out.append((f"img-{i:02d}", buf.tobytes(), i >= n // 2))
    return out


def decoded_inputs(records) -> np.ndarray:
    """What the engine's default_preprocess makes of each record, as the
    f32 batch the model sees (a u8 record dequantized by its scale 1.0)."""
    out = []
    for _, png, u8 in records:
        x = default_preprocess({"image": base64.b64encode(png).decode(),
                                "resize": list(IMAGE["input_shape"][:2]),
                                "u8": int(u8)})
        out.append(x.data.astype(np.float32) * x.scale
                   if isinstance(x, QuantizedTensor) else x)
    return np.stack(out)


def serve_images(im, records, params) -> dict:
    """ClusterServing in predict mode over InProcQueue, warmed first; the
    counts set to 0, then every record enqueued as an image record under a
    profiler trace of the card."""
    q = InProcQueue()
    serving = ClusterServing(im, q, params)     # quantizes here
    iq, oq = InputQueue(q), OutputQueue(q)
    rids = [rid for rid, _, _ in records]
    try:
        serving.start()
        warm = wait_warm(serving)
        sync(im.device)
        st0 = im.aot_stats()
        reset_launches()
        with _impl.card_launches(("w8a8_conv", "w8a8", "w4a16")) as card:
            t0 = time.perf_counter()
            for rid, png, u8 in records:
                iq.enqueue_image(rid, png,
                                 resize=IMAGE["input_shape"][:2],
                                 device_uint8=u8)
            results = oq.query_many(rids, timeout_s=600.0)
            wall = time.perf_counter() - t0
    finally:
        serving.shutdown(drain_s=5.0)
    sync(im.device)
    st = im.aot_stats()
    return {"rids": rids, "results": results, "wall_s": wall,
            "forwards": sum(st["programs"].values())
            - sum(st0["programs"].values()),
            "programs": {k: v - st0["programs"].get(k, 0)
                         for k, v in st["programs"].items()},
            "warm_hits": st["hits"] - st0["hits"], "warm": warm,
            "card": card, "wrapper": {"w8a8_conv": qm.launches_conv,
                                      "w8a8": qm.launches_w8a8,
                                      "w4a16": qm.launches_w4a16},
            "e2e_p50_s": serving._e2e.percentiles((50,))["p50"],
            "dead_lettered": serving.dead_lettered}


def plain_probs(im, X, impl) -> np.ndarray:
    """The model's probabilities over ``X`` in batches of IMAGE_BATCH with
    every kernel (``impl`` None) or every plain version (``"torch"``)."""
    set_impl(im._model, impl)
    try:
        return InferenceModel(max_batch=IMAGE_BATCH, device=im.device) \
            .do_load_model(im._model).do_predict(X, batch_size=IMAGE_BATCH)
    finally:
        set_impl(im._model, None)


# a forward's launches of each kernel, by precision
IMAGE_LAUNCHES = {"f32": {},
                  "int8": {"w8a8_conv": IMAGE_SPATIAL, "w8a8": IMAGE_MATMULS},
                  "int4": {"w4a16": IMAGE_MATMULS}}


def check_image(tag: str, run: dict, ref, tol) -> dict:
    """Every record answered; int8 (``tol`` None): each top-5, classes and
    probabilities, equal to the plain route's bit for bit; otherwise each
    top-5 log-probability within ``tol`` of the plain route's and top-1
    equal where the plain top-2 margin exceeds twice it.  Every forward's
    bucket warmed; each kernel launched IMAGE_LAUNCHES a forward on the
    card and by its wrapper, and no other."""
    n = len(run["rids"])
    check(run["dead_lettered"] == 0, f"image[{tag}]: records quarantined")
    worst, compared, top1 = 0.0, 0, []
    ref_logp = np.log(ref.astype(np.float64))
    for i, rid in enumerate(run["rids"]):
        r = run["results"].get(rid)
        check(r is not None and "value" in r,
              f"image[{tag}] {rid}: no result ({r})")
        top = r["value"]
        cls = [int(c) for c, _ in top]
        check(len(top) == 5 and all(0 <= c < IMAGE["num_classes"]
                                    for c in cls),
              f"image[{tag}] {rid}: malformed top-5 {top}")
        if tol is None:
            want = default_postprocess(ref[i], 5)
            check(top == want, f"image[{tag}] {rid}: top-5 {top} != the "
                               f"plain route's {want}")
        else:
            lp = np.log(np.asarray([p for _, p in top], np.float64))
            check(bool(np.isfinite(lp).all()),
                  f"image[{tag}] {rid}: non-finite {top}")
            err = float(np.abs(lp - ref_logp[i, cls]).max())
            worst = max(worst, err)
            check(err <= tol, f"image[{tag}] {rid}: log-prob error "
                              f"{err:.3e} > {tol:.3e}")
            order = np.sort(ref_logp[i])
            if order[-1] - order[-2] > 2 * tol:
                compared += 1
                check(cls[0] == int(np.argmax(ref_logp[i])),
                      f"image[{tag}] {rid}: top-1 {cls[0]} != plain "
                      f"{int(np.argmax(ref_logp[i]))}")
        top1.append(cls[0])
    fw = run["forwards"]
    check(run["warm_hits"] == fw > 0,
          f"image[{tag}]: {run['warm_hits']} of {fw} forwards found their "
          f"bucket warm")
    per = IMAGE_LAUNCHES[tag]
    for k in ("w8a8_conv", "w8a8", "w4a16"):
        want = fw * per.get(k, 0)
        check(run["card"][k] == run["wrapper"][k] == want,
              f"image[{tag}]: {k} launches on the card {run['card'][k]}, "
              f"by the wrapper {run['wrapper'][k]}, != {fw} forwards x "
              f"{per.get(k, 0)}")
    say(f"image[{tag}]: warm-up {run['warm']['total']} buckets in "
        f"{run['warm']['seconds']:.3f} s; {len(run['results'])}/{n} image "
        f"records served in {run['wall_s']:.3f} s = {n / run['wall_s']:.2f}"
        f" records/s (reading), e2e p50 {run['e2e_p50_s'] * 1e3:.1f} ms "
        f"(under the trace); {fw} forwards {run['programs']}, each of a "
        f"warmed bucket; launches on the card = by the wrappers: "
        + (", ".join(f"{k} {run['card'][k]}" for k in per) or "none")
        + ("; top-5 classes and probabilities bitwise equal to the plain "
           "route" if tol is None else
           f"; top-5 log-prob max err vs plain {worst:.3e} (tolerance "
           f"{tol:.1e}), top-1 checked on {compared}/{n}"))
    return {"top1": top1, "run": run, "worst": worst}


def images_per_s(im, X) -> float:
    """The model alone over ``X`` in batches of IMAGE_BATCH (do_predict,
    host clock around a synchronised run, after one warm pass)."""
    im.do_predict(X[:IMAGE_BATCH], batch_size=IMAGE_BATCH)
    sync(im.device)
    t0 = time.perf_counter()
    im.do_predict(X, batch_size=IMAGE_BATCH)
    sync(im.device)
    return len(X) / (time.perf_counter() - t0)


def profile_image(im, X) -> None:
    """One int8 batch of IMAGE_BATCH images of a warmed bucket under
    ``torch.profiler``: busy share and the kernels that take the most
    time."""
    from torch.profiler import ProfilerActivity, profile
    im.warm(len(X), X.shape[1:], dtype=X.dtype.str)
    sync(im.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        im.do_predict(X)
        sync(im.device)
        wall = time.perf_counter() - t0
    rows, busy = kernel_rows(prof)
    say(f"profile[image int8]: one batch of {len(X)} images in "
        f"{wall * 1e3:.2f} ms under the profiler, kernels {busy * 1e3:.2f} "
        f"ms ({100 * busy / wall:.1f}% of the wall)")
    for name, count, ms in rows[:14]:
        say(f"profile[image int8]   {ms:9.3f} ms  {count:4d} calls  "
            f"{name[:90]}")


def predict_image_set_check(params, state, dev, ref_im) -> None:
    """``ImageClassifier("resnet50").predict_image_set`` over seeded
    images through its default preprocessing (resize 256, center crop
    224, BGR means): top-5 ids and probabilities of every image equal to
    the served model's own predict of the same preprocessed arrays."""
    ic = ImageClassifier(**IMAGE, device=dev)
    ic.set_weights(params, state)
    imgs = [np.ascontiguousarray(a[:, :240]) for a in image_sources(7, 20)]
    t0 = time.perf_counter()
    ids, probs = ic.predict_image_set(ImageSet.from_arrays(imgs),
                                      batch_size=IMAGE_BATCH, top_k=5)
    wall = time.perf_counter() - t0
    X = ImageSet.from_arrays(imgs).transform(ic.preprocessor) \
        .to_feature_set().xs[0]
    ref = ref_im.do_predict(X, batch_size=IMAGE_BATCH)
    want = np.argsort(-ref, axis=-1)[:, :5]
    check(ids.shape == (len(imgs), 5) and np.isfinite(probs).all(),
          f"predict_image_set: ids {ids.shape}, probs finite "
          f"{np.isfinite(probs).all()}")
    check(np.array_equal(ids, want) and np.allclose(
        probs, np.take_along_axis(ref, want, -1), rtol=0, atol=1e-6),
        "predict_image_set: top-5 differ from the model's predict of the "
        "same preprocessed images")
    say(f"predict_image_set: {len(imgs)} images of {imgs[0].shape} through "
        f"{[type(t).__name__ for t in ic.preprocessor.stages]} in "
        f"{wall:.3f} s; top-5 ids equal to InferenceModel.do_predict of the "
        f"same arrays")


def image_phase(seed: int, records: dict, profile: bool) -> None:
    """The w8a8_conv2d kernel and the matmul kernels at ResNet-50's shapes;
    then ImageClassifier("resnet50") served over image records in f32,
    int8 and int4, each against the plain route; predict_image_set."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    ic = ImageClassifier(**IMAGE, device=dev)
    inv = conv_inventory(ic.model, IMAGE_BATCH)
    spatial, matmuls = inv["spatial"], inv["matmuls"]
    check((len(spatial), len(distinct(spatial)), len(matmuls)) ==
          (IMAGE_SPATIAL, IMAGE_SPATIAL_SHAPES, IMAGE_MATMULS),
          f"image: {len(spatial)} spatial convs at {len(distinct(spatial))} "
          f"shapes and {len(matmuls)} matmuls a forward")
    n = conv_parity(seed, [g for g, _ in distinct(spatial)])
    say(f"conv parity: w8a8_conv2d bitwise equal to w8a8_conv_torch in {n} "
        f"cases ({IMAGE_SPATIAL_SHAPES} path shapes of ResNet-50 at batch "
        f"{IMAGE_BATCH}, {len(CONV_RAGGED)} ragged)")
    say("conv planted faults: " + "; ".join(
        conv_planted(seed, distinct(spatial)[2][0])))
    pointwise_parity(seed, [m for m, _ in distinct(matmuls)])
    say(f"pointwise parity: w8a8 bitwise, w4a16 within {W4_TOL} at the "
        f"{len(distinct(matmuls))} distinct (M, K, N) of the forward")
    records["w8a8_conv2d"] = conv_record(seed, spatial)
    pw = pointwise_timing(seed, matmuls)
    records["w8a8"].update(image_forward_ms=pw["w8"],
                           image_forward_bound_ms=pw["w8_bound"],
                           image_forward_library_ms=pw["w8_lib"])
    records["w4a16"].update(image_forward_ms=pw["w4"],
                            image_forward_bound_ms=pw["w4_bound"])

    recs = image_records(seed)
    X = decoded_inputs(recs)
    params, state = image_params(seed, ic.model, X[:IMAGE_BATCH])
    del ic
    say(f"model: ImageClassifier({IMAGE}).model, resnet(50) with BN state "
        f"from seed {seed}; {len(recs)} PNG image records of "
        f"{IMAGE_SOURCE} (cv2 on this machine: float and u8 paths), "
        f"resized by the engine to {IMAGE['input_shape']}")
    with tempfile.TemporaryDirectory() as tmp:
        calib = os.path.join(tmp, "calib.npy")
        np.save(calib, decoded_inputs(image_records(seed + 1, IMAGE_BATCH)))
        out = {}
        for tag, spec in (("f32", None),
                          ("int8", {"bits": 8, "calib": calib}),
                          ("int4", "int4")):
            model = ImageClassifier(**IMAGE, device=dev).model
            im = InferenceModel(device=dev).do_load_model(model, params,
                                                          state)
            run = serve_images(im, recs, ServingParams(
                batch_size=IMAGE_BATCH, max_wait_ms=2.0, quantize=spec,
                warmup=IMAGE_WARMUP))
            ref = plain_probs(im, X, "torch")
            tol = None if tag == "int8" else IMAGE_LOGP_TOL[tag]
            out[tag] = check_image(tag, run, ref, tol)
            out[tag]["bytes"] = weight_bytes(im._params)
            # the spatial int8 convs' K-major packs, held beside the leaves
            packs = sum(m._pack[2].numel() for m in im._model.modules()
                        if getattr(m, "_pack", None) is not None)
            if tag == "int8":
                check(packs > 0, "image[int8]: no conv holds a weight pack")
                records["w8a8_conv2d"]["pack_bytes"] = packs
                say(f"image[int8]: K-major weight packs of the "
                    f"{IMAGE_SPATIAL} spatial convs resident beside the "
                    f"leaves: {packs} B")
            rate = images_per_s(im, X)
            say(f"image[{tag}]: weight bytes a forward {out[tag]['bytes']}"
                + (f" ({out['f32']['bytes'] / out[tag]['bytes']:.2f}x "
                   f"smaller than f32)" if tag != "f32" else "")
                + f"; the model alone {rate:.1f} images/s at batch "
                f"{IMAGE_BATCH} (reading)")
            if tag != "f32":
                agree = np.mean(np.asarray(out[tag]["top1"])
                                == np.asarray(out["f32"]["top1"]))
                say(f"image[{tag}]: top-1 agreement with the f32 path "
                    f"{agree:.3f}")
            if tag == "f32":
                predict_image_set_check(params, state, dev, im)
            if profile and tag == "int8":
                profile_image(im, X[:IMAGE_BATCH])
            del im, model
            torch.cuda.empty_cache()
    records["w8a8_conv2d"]["launches"] = out["int8"]["run"]["card"][
        "w8a8_conv"]
    records["w8a8"]["image_launches"] = out["int8"]["run"]["card"]["w8a8"]
    records["w4a16"]["image_launches"] = out["int4"]["run"]["card"]["w4a16"]
    say(f"image: phase wall {time.perf_counter() - t_phase:.2f} s")


# -- phase 8: the recommendation zoo ------------------------------------------

# NeuralCF at MovieLens-1M width (examples/ncf_train.py, RUNLOG_ncf_ml1m.md)
# on synthetic_ml1m's surrogate at ML-1M's dimensions
NCF = dict(user_embed=64, item_embed=64, hidden_layers=(128, 64, 32),
           mf_embed=64)
NCF_DATA = dict(n_users=6040, n_items=3706)
NCF_PARAMS = 1274786
NCF_EPOCHS = 2
NCF_BATCH = 4096
NCF_LR = 1e-3
NCF_NEG = 4
# the NCF protocol: 99 negatives the user has not seen, HR@10 / NDCG@10
NCF_EVAL = dict(num_neg=99, k=10, seed=123)
# after the last epoch; chance is ~0.10, and the JAX package's CPU run of
# the same protocol read 0.4474 and 0.5942 after epochs 1 and 2
NCF_HR_MIN = 0.50
# the predict batch of evaluate_ranking and recommend_for_user
RECO_BATCH = 8192
# a quantized route's HR@10 against f32's
RECO_HR_GAP = 0.02
RECO_USERS = 4
RECO_TOP = 10
# WideAndDeep at the Census example's columns (examples/wide_deep_census.py)
CENSUS_ROWS, CENSUS_TRAIN = 20000, 16000
WAD_HIDDEN = (64, 32, 16)
WAD_EPOCHS, WAD_BATCH, WAD_LR = 3, 256, 1e-3
WAD_PREDICT_BATCH = 1024
# the (K, N) of each model's Dense layers in graph order: NeuralCF's MLP
# and head (96 = the MF tower's 64 + the MLP's 32), WideAndDeep's
# unbiased wide layer (wide_dim 173), its MLP (34 = 16 indicator + 2 x 8
# embedded + 2 continuous) and its head
RECO_DENSE = {"ncf": ((128, 128), (128, 64), (64, 32), (96, 2)),
              "wad": ((173, 2), (34, 64), (64, 32), (32, 16), (16, 2))}
# rows of x in the parity cases: one, the predict bucket, a batch past it
RECO_M = (1, 8192, 9000)
# a forward's launches of each kernel, by route
RECO_LAUNCHES = {"f32": {}, "int8": {"w8a8": 1}, "int4": {"w4a16": 1}}


def reco_shapes():
    """The distinct (K, N) of both models' Dense layers."""
    return [kn for kn, _ in distinct(RECO_DENSE["ncf"] + RECO_DENSE["wad"])]


def poisoned_weight(w, pad: int = 48):
    """``w`` copied into the middle of a buffer whose other bytes are 127:
    a read past either end of the weight that reached the products would
    change them."""
    buf = torch.full((w.numel() + 2 * pad,), 127, dtype=torch.int8,
                     device=w.device)
    buf[pad:pad + w.numel()] = w.flatten()
    return buf[pad:pad + w.numel()].view(w.shape)


def reco_parity(seed: int, ms=RECO_M, shapes=None) -> float:
    """``w8a8`` bitwise and ``w4a16`` (group 64: ragged groups at K = 96
    and 173) within W4_TOL at every (M, K, N) of RECO_M x reco_shapes()
    (or ``ms`` x ``shapes``), each weight its own allocation of exactly
    its bytes; ``w8a8`` again with the weight inside a buffer of 127s.
    Returns w4a16's max error."""
    g = np.random.default_rng(seed + 140)
    worst = 0.0
    for m in ms:
        for k, n in shapes or reco_shapes():
            x, w, s = w8a8_case(g, m, k, n)
            ref = qm.w8a8_matmul(x, w, s, impl="torch")
            for tag, wt in (("exact", w), ("poisoned", poisoned_weight(w))):
                got = qm.w8a8_matmul(x, wt, s, impl="cuda")
                torch.cuda.synchronize()
                check(torch.equal(got, ref),
                      f"w8a8 ({m}, {k}, {n}, {tag} weight): not bitwise "
                      f"equal to the plain version")
            x, wq, sg = w4a16_case(g, m, k, n, 64)
            got = qm.w4a16_matmul(x, wq, sg, impl="cuda")
            torch.cuda.synchronize()
            worst = max(worst, check_close(
                f"w4a16 ({m}, {k}, {n}, G={sg.shape[0]})", got,
                qm.w4a16_matmul(x, wq, sg, impl="torch"), *W4_TOL))
    return worst


def reco_kernel_phase(seed: int) -> dict:
    """Parity at the recommendation shapes, then each distinct (K, N)
    timed at M = RECO_BATCH as rows 5 and 6 are, and summed over each
    model's forward."""
    worst = reco_parity(seed)
    say(f"reco parity: w8a8 bitwise (each weight exact and inside 127s) "
        f"and w4a16 within {W4_TOL} (max err {worst:.3e}) at M {RECO_M} x "
        f"(K, N) {reco_shapes()}")
    w8 = {kn: w8a8_timing(seed + 3, RECO_BATCH, *kn, plain=True)
          for kn in reco_shapes()}
    w4 = {kn: w4a16_timing(seed + 3, RECO_BATCH, *kn, 64, torch.float32)
          for kn in reco_shapes()}
    out = {"w4_max_abs_err": worst}
    for model, kns in RECO_DENSE.items():
        for name, t, keys in (("w8a8", w8, ("ms", "plain_ms", "library_ms",
                                            "bound_ms")),
                              ("w4a16", w4, ("ms", "plain_ms",
                                             "bound_ms"))):
            out[f"{name}_{model}"] = {key: sum(t[kn][key] for kn in kns)
                                      for key in keys}
            say(f"reco timing[{name}, {model} forward of {len(kns)} "
                f"launches at M={RECO_BATCH}]: " + ", ".join(
                    f"{key} {v:.4f}" for key, v in
                    out[f"{name}_{model}"].items()))
    out["shapes"] = {f"{k}x{n}": {"w8a8": {key: w8[(k, n)][key] for key in
                                            ("ms", "library_ms", "bound_ms")},
                                  "w4a16": {key: w4[(k, n)][key] for key in
                                            ("ms", "plain_ms", "bound_ms")}}
                     for k, n in reco_shapes()}
    return out


def dense_shapes(model) -> tuple:
    """(K, N) of every ``Dense`` of a graph model (in graph order) or of a
    ``Sequential``."""
    layers = getattr(model, "graph_layers", None) or model.layers_list
    return tuple((m.input_dim, m.output_dim) for m in layers
                 if isinstance(m, Dense))


def ncf_data(seed: int) -> dict:
    """The surrogate ratings at ML-1M's dimensions (``synthetic_ml1m``,
    seed 7 at ``--seed`` 0: the JAX package's runs' data), the
    leave-one-out split and each user's seen items."""
    t0 = time.perf_counter()
    ratings = synthetic_ml1m(**NCF_DATA, seed=7 + seed)
    train_pos, test_pos = leave_one_out(ratings)
    seen = {}
    for u, i in train_pos:
        seen.setdefault(int(u), set()).add(int(i))
    return {"ratings": ratings, "train_pos": train_pos, "test_pos": test_pos,
            "seen": seen, "n_items": int(ratings[:, 1].max()),
            "n_users": int(ratings[:, 0].max()),
            "seconds": time.perf_counter() - t0}


def ncf_train(ncf, data: dict, seed: int) -> list:
    """``Estimator.fit`` for NCF_EPOCHS epochs, each on its own
    ``training_arrays(..., seed=epoch)``, with ``evaluate_ranking`` after
    each.  Per epoch: the mean loss, HR@10, NDCG@10, the step count, the
    training wall (host clock, synchronised) and the host's data and
    evaluation seconds."""
    dev = ncf.device
    est = Estimator(ncf.model, optimizer=Adam(lr=NCF_LR),
                    loss="sparse_categorical_crossentropy",
                    metrics=["accuracy"], registry=MetricsRegistry(),
                    ctx=ZooContext(ZooConf(seed=seed, device=str(dev))))
    out = []
    for epoch in range(NCF_EPOCHS):
        t0 = time.perf_counter()
        users, items, labels = training_arrays(
            data["train_pos"], data["n_items"], n_neg=NCF_NEG, seed=epoch)
        t_data = time.perf_counter() - t0
        sync(dev)
        t0 = time.perf_counter()
        hist = est.fit([users, items], labels, batch_size=NCF_BATCH,
                       epochs=1, verbose=False,
                       steps_per_call=ZOO_STEPS_PER_CALL)
        sync(dev)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        m = evaluate_ranking(ncf, data["test_pos"], data["n_items"],
                             batch_size=RECO_BATCH,
                             exclude_pos=data["seen"], **NCF_EVAL)
        out.append({"loss": hist.history["loss"][-1],
                    "hr": m["hit_ratio"], "ndcg": m["ndcg"],
                    "samples": len(labels),
                    "steps": -(-len(labels) // NCF_BATCH), "wall_s": wall,
                    "data_s": t_data,
                    "eval_s": time.perf_counter() - t0})
    out[-1]["estimator"] = est
    return out


def check_ncf_train(epochs: list, hr_min: float = NCF_HR_MIN) -> None:
    """Finite losses that fall epoch by epoch, and HR@10 >= ``hr_min``
    after the last epoch."""
    ls = [e["loss"] for e in epochs]
    check(all(math.isfinite(v) for v in ls) and all(
        b < a for a, b in zip(ls, ls[1:])),
        f"ncf train: the per-epoch loss did not fall ({ls})")
    check(epochs[-1]["hr"] >= hr_min,
          f"ncf train: HR@10 {epochs[-1]['hr']:.4f} < {hr_min} after "
          f"{len(epochs)} epochs")
    for i, e in enumerate(epochs):
        say(f"ncf train[epoch {i + 1}]: loss {e['loss']:.4f}, HR@10 "
            f"{e['hr']:.4f}, NDCG@10 {e['ndcg']:.4f}; {e['samples']} "
            f"samples in {e['steps']} steps of {NCF_BATCH}, "
            f"{e['wall_s']:.3f} s = {e['samples'] / e['wall_s']:.0f} "
            f"samples/s, {e['wall_s'] / e['steps'] * 1e3:.3f} ms/step (host "
            f"clock, {ZOO_STEPS_PER_CALL} steps a call); host data {e['data_s']:.2f} s, ranking evaluation "
            f"{e['eval_s']:.2f} s")


class RankingRecorder:
    """What ``evaluate_ranking`` calls: ``predict`` through an
    InferenceModel's ``do_predict``, keeping the candidates, their
    probabilities and the predict's host-clock wall."""

    def __init__(self, im):
        self.im = im
        self.x = self.probs = None
        self.wall_s = 0.0

    def predict(self, x, batch_size=None):
        t0 = time.perf_counter()
        self.probs = self.im.do_predict(x, batch_size=batch_size)
        self.wall_s = time.perf_counter() - t0
        self.x = x
        return self.probs


def serve_ranking(im, data: dict) -> dict:
    """The NCF protocol's candidates ranked through ``im`` (batch
    RECO_BATCH) with the counts set to 0 just before and read just after,
    under a profiler trace of the card; then the model alone over the
    same candidates, untraced, for records/s."""
    sync(im.device)
    st0 = im.aot_stats()
    reset_launches()
    rec = RankingRecorder(im)
    with _impl.card_launches(("w8a8", "w4a16")) as card:
        m = evaluate_ranking(rec, data["test_pos"], data["n_items"],
                             batch_size=RECO_BATCH, exclude_pos=data["seen"],
                             **NCF_EVAL)
        sync(im.device)
    wrapper = {"w8a8": qm.launches_w8a8, "w4a16": qm.launches_w4a16}
    st = im.aot_stats()
    t0 = time.perf_counter()
    im.do_predict(rec.x, batch_size=RECO_BATCH)
    wall = time.perf_counter() - t0
    return {"hr": m["hit_ratio"], "ndcg": m["ndcg"], "x": rec.x,
            "probs": rec.probs, "traced_wall_s": rec.wall_s, "wall_s": wall,
            "forwards": sum(st["programs"].values())
            - sum(st0["programs"].values()), "card": card,
            "wrapper": wrapper}


def route_probs(im, x, impl, batch: int) -> np.ndarray:
    """The model's probabilities over ``x`` in batches of ``batch`` with
    every kernel (``impl`` None) or every plain version (``"torch"``)."""
    set_impl(im._model, impl)
    try:
        return InferenceModel(max_batch=batch, device=im.device) \
            .do_load_model(im._model).do_predict(x, batch_size=batch)
    finally:
        set_impl(im._model, None)


def check_launches(tag: str, run: dict, n_dense: int) -> None:
    """Each kernel launched RECO_LAUNCHES x ``n_dense`` a forward on the
    card and by its wrapper, and no other; at least one forward."""
    fw = run["forwards"]
    check(fw > 0, f"{tag}: no forward ran")
    per = RECO_LAUNCHES[tag.split("[")[1].rstrip("]")]
    for k in ("w8a8", "w4a16"):
        want = fw * n_dense * per.get(k, 0)
        check(run["card"][k] == run["wrapper"][k] == want,
              f"{tag}: {k} launches on the card {run['card'][k]}, by the "
              f"wrapper {run['wrapper'][k]}, != {fw} forwards x {n_dense} "
              f"x {per.get(k, 0)}")


def check_route(tag: str, got, plain, bits: int) -> float:
    """int8: the served probabilities bit for bit the plain route's;
    int4: within W4_TOL of it; f32 has no kernel.  Returns the max
    error."""
    check(got.shape == plain.shape and bool(np.isfinite(got).all()),
          f"{tag}: probabilities {got.shape} (plain {plain.shape}) or "
          f"non-finite")
    err = float(np.abs(got.astype(np.float64) - plain).max())
    if bits == 8:
        check(np.array_equal(got, plain),
              f"{tag}: probabilities not bitwise equal to the plain route "
              f"(max abs err {err:.3e})")
    elif bits == 4:
        check(bool(np.allclose(got, plain, atol=W4_TOL[0],
                               rtol=W4_TOL[1])),
              f"{tag}: probabilities off the plain route by {err:.3e} "
              f"(atol {W4_TOL[0]}, rtol {W4_TOL[1]})")
    return err


def recommend_check(ncf, im, users) -> None:
    """``recommend_for_user`` (through the zoo model's predict) returns
    for each user the RECO_TOP items of highest f32 score through ``im``:
    the same items, each probability within 1e-6 of ``im``'s, in
    non-increasing order (two scores within 1e-6 of each other may swap,
    and an item at the edge may trade places with one within 1e-6)."""
    items = np.arange(1, ncf.item_count + 1, dtype=np.float32)[:, None]
    recs = ncf.recommend_for_user(users, RECO_TOP, batch_size=RECO_BATCH)
    check(len(recs) == RECO_TOP * len(users),
          f"recommend_for_user: {len(recs)} recommendations")
    for j, uid in enumerate(users):
        probs = im.do_predict([np.full_like(items, float(uid)), items],
                              batch_size=RECO_BATCH)
        score = probs.max(-1)
        got = recs[j * RECO_TOP:(j + 1) * RECO_TOP]
        p = [r.probability for r in got]
        check(all(r.user_id == uid for r in got)
              and all(b <= a + 1e-6 for a, b in zip(p, p[1:])),
              f"recommend_for_user({uid}): {got}")
        edge = np.sort(score)[::-1][RECO_TOP - 1]
        for r in got:
            s = float(score[r.item_id - 1])
            check(abs(r.probability - s) <= 1e-6 and s >= edge - 1e-6,
                  f"recommend_for_user({uid}): item {r.item_id} at "
                  f"{r.probability} (f32 score {s}, top-{RECO_TOP} edge "
                  f"{edge})")
    say(f"recommend_for_user({list(users)}, {RECO_TOP}): each user's top "
        f"{RECO_TOP} of the f32 scores")


def ncf_serve(ncf, params: dict, data: dict, dev) -> dict:
    """The trained NCF (``params``) through InferenceModel in f32, int8
    and int4, each ranking the protocol's candidates; the quantized routes
    against the same model through every kernel's plain version; the
    trained zoo model's ``recommend_for_user`` against the f32 route."""
    out = {}
    f32_hr = None
    for tag, bits in (("f32", 0), ("int8", 8), ("int4", 4)):
        model = NeuralCF(ncf.user_count, ncf.item_count, 2, **NCF,
                         device=dev).model
        im = InferenceModel(max_batch=RECO_BATCH, device=dev) \
            .do_load_model(model, params)
        if bits == 8:
            x0 = out["f32"]["x"]
            im.do_quantize([(x0[0][:RECO_BATCH], x0[1][:RECO_BATCH])],
                           bits=8, force=True)
        elif bits == 4:
            im.do_quantize(None, bits=4, force=True, group_size=64)
        run = serve_ranking(im, data)
        check_launches(f"ncf[{tag}]", run, len(RECO_DENSE["ncf"]))
        plain = route_probs(im, run["x"], "torch", RECO_BATCH) if bits \
            else run["probs"]
        err = check_route(f"ncf[{tag}]", run["probs"], plain, bits)
        if f32_hr is None:
            f32_hr = run["hr"]
        check(abs(run["hr"] - f32_hr) <= RECO_HR_GAP,
              f"ncf[{tag}]: HR@10 {run['hr']:.4f} is more than "
              f"{RECO_HR_GAP} from f32's {f32_hr:.4f}")
        run["bytes"] = weight_bytes(im._params)
        n = len(run["probs"])
        say(f"ncf[{tag}]: {n} candidates ({len(data['test_pos'])} users x "
            f"{1 + NCF_EVAL['num_neg']}) in {run['forwards']} forwards of "
            f"{RECO_BATCH}: HR@10 {run['hr']:.4f}, NDCG@10 "
            f"{run['ndcg']:.4f}; {n / run['wall_s']:.0f} records/s "
            f"untraced, {n / run['traced_wall_s']:.0f} under the trace "
            f"(host clock, readings); launches on the card = by the "
            f"wrappers: w8a8 {run['card']['w8a8']}, w4a16 "
            f"{run['card']['w4a16']}; weight bytes {run['bytes']}"
            + ("" if bits == 0 else "; vs the plain route "
               + ("bitwise equal" if bits == 8 else
                  f"max abs err {err:.3e}")))
        if tag == "f32":
            recommend_check(ncf, im,
                            data["test_pos"][:RECO_USERS, 0].tolist())
        out[tag] = run
        del im, model
    return out


# the Census example's category names (examples/wide_deep_census.py), its
# education order for the label rule and its occupation bonuses
CENSUS_EDUCATION = ["Bachelors", "HS-grad", "11th", "Masters", "9th",
                    "Some-college", "Assoc-acdm", "Assoc-voc", "7th-8th",
                    "Doctorate", "Prof-school", "5th-6th", "10th", "1st-4th",
                    "Preschool", "12th"]
CENSUS_OCCUPATION = ["Tech-support", "Craft-repair", "Other-service", "Sales",
                     "Exec-managerial", "Prof-specialty", "Handlers-cleaners",
                     "Machine-op-inspct", "Adm-clerical", "Farming-fishing",
                     "Transport-moving", "Priv-house-serv",
                     "Protective-serv", "Armed-Forces"]
CENSUS_WORKCLASS = ["Private", "Self-emp-not-inc", "Self-emp-inc",
                    "Federal-gov", "Local-gov", "State-gov", "Without-pay",
                    "Never-worked"]
CENSUS_RELATIONSHIP = ["Wife", "Own-child", "Husband", "Not-in-family",
                       "Other-relative", "Unmarried"]
CENSUS_EDU_RANK = ["Preschool", "1st-4th", "5th-6th", "7th-8th", "9th",
                   "10th", "11th", "12th", "HS-grad", "Some-college",
                   "Assoc-voc", "Assoc-acdm", "Bachelors", "Masters",
                   "Prof-school", "Doctorate"]
CENSUS_OCC_BONUS = [0.2, 0.1, -0.4, 0.3, 0.9, 0.8, -0.5, -0.2, -0.1, -0.6,
                    0.0, -0.8, 0.1, 0.2]


def census_columns(n: int, seed: int):
    """The Census example's surrogate (``synth_census``: its draws, in its
    order, and its label rule) and its column engineering, in numpy: age
    and hours bucketed by its bins, categories coded by their rank in the
    sorted names (its codes when every name occurs), ages and hours
    normalised.  Returns (columns, labels (n,) f32)."""
    g = np.random.default_rng(seed)
    age = g.integers(17, 90, n)
    work = g.choice(len(CENSUS_WORKCLASS), n)
    edu = g.choice(len(CENSUS_EDUCATION), n)
    occ = g.choice(len(CENSUS_OCCUPATION), n)
    rel = g.choice(len(CENSUS_RELATIONSHIP), n)
    gender = g.choice(2, n)                   # ["Male", "Female"]
    hours = np.clip(g.normal(40, 12, n), 1, 99).astype(int)
    gain = np.where(g.random(n) < 0.08, g.integers(2000, 50000, n), 0)
    rank = np.array([CENSUS_EDU_RANK.index(e) for e in CENSUS_EDUCATION])
    z = (0.28 * rank[edu] + np.asarray(CENSUS_OCC_BONUS)[occ] * 1.2
         + 0.045 * (age - 38) - 0.0009 * (age - 45) ** 2
         + 0.03 * (hours - 40) + 0.00008 * gain - 3.2)
    p = 1.0 / (1.0 + np.exp(-(z + g.normal(0, 0.8, n))))
    labels = (g.random(n) < p).astype(np.float32)

    def code(names, drawn):
        order = np.argsort(np.argsort(names))   # rank of each name
        return order[drawn]
    cols = {"age_bucket": np.searchsorted([25, 35, 45, 55, 65], age),
            "hours_bucket": np.searchsorted([25, 39, 41, 50], hours),
            "gain_flag": (gain > 0).astype(np.int64),
            "workclass_id": code(CENSUS_WORKCLASS, work),
            "education_id": code(CENSUS_EDUCATION, edu),
            "occupation_id": code(CENSUS_OCCUPATION, occ),
            "relationship_id": code(CENSUS_RELATIONSHIP, rel),
            "gender_id": code(["Male", "Female"], gender),
            "age_norm": (age - 38.0) / 13.0,
            "hours_norm": (hours - 40.0) / 12.0}
    return cols, labels


def census_info() -> ColumnFeatureInfo:
    """The Census example's ``ColumnFeatureInfo``: wide_dim 173 (bases 6,
    16, 14, 5, 2 and crosses 100, 30), indicators 8 + 6 + 2, two 8-wide
    embeddings of 16 and 14 ids, two continuous columns."""
    return ColumnFeatureInfo(
        wide_base_cols=["age_bucket", "education_id", "occupation_id",
                        "hours_bucket", "gain_flag"],
        wide_base_dims=[6, len(CENSUS_EDUCATION), len(CENSUS_OCCUPATION),
                        5, 2],
        wide_cross_cols=["education_id_occupation_id",
                         "age_bucket_hours_bucket"],
        wide_cross_dims=[100, 30],
        indicator_cols=["workclass_id", "relationship_id", "gender_id"],
        indicator_dims=[len(CENSUS_WORKCLASS), len(CENSUS_RELATIONSHIP), 2],
        embed_cols=["education_id", "occupation_id"],
        embed_in_dims=[len(CENSUS_EDUCATION), len(CENSUS_OCCUPATION)],
        embed_out_dims=[8, 8],
        continuous_cols=["age_norm", "hours_norm"])


def wad_phase(seed: int, dev) -> dict:
    """WideAndDeep (wide_n_deep) at the Census columns: fit, test
    accuracy against the majority class, then int8 and int4 predict of
    the test rows through the kernels against the plain route."""
    cols, y = census_columns(CENSUS_ROWS, seed + 150)
    wad = WideAndDeep(2, census_info(), "wide_n_deep",
                      hidden_layers=WAD_HIDDEN, device=dev)
    wad.init_weights(seed + 1)
    check(dense_shapes(wad.model) == RECO_DENSE["wad"],
          f"wad: Dense shapes {dense_shapes(wad.model)}")
    x = wad.to_model_inputs(cols)
    perm = np.random.default_rng(seed + 151).permutation(CENSUS_ROWS)
    tr, te = perm[:CENSUS_TRAIN], perm[CENSUS_TRAIN:]
    xtr, xte = [a[tr] for a in x], [a[te] for a in x]
    est = Estimator(wad.model, optimizer=Adam(lr=WAD_LR),
                    loss="sparse_categorical_crossentropy",
                    metrics=["accuracy"], registry=MetricsRegistry(),
                    ctx=ZooContext(ZooConf(seed=seed, device=str(dev))))
    sync(dev)
    t0 = time.perf_counter()
    hist = est.fit(xtr, y[tr, None], batch_size=WAD_BATCH, epochs=WAD_EPOCHS,
                   verbose=False)
    sync(dev)
    wall = time.perf_counter() - t0
    ls = hist.history["loss"]
    check(all(math.isfinite(v) for v in ls) and ls[-1] < ls[0],
          f"wad: the loss did not fall ({ls})")
    acc = est.evaluate(xte, y[te, None], batch_size=WAD_PREDICT_BATCH)[
        "accuracy"]
    base = max(float(y[te].mean()), 1.0 - float(y[te].mean()))
    check(acc > base, f"wad: test accuracy {acc:.4f} not above the "
                      f"majority class's {base:.4f}")
    steps = WAD_EPOCHS * -(-CENSUS_TRAIN // WAD_BATCH)
    say(f"wad: WideAndDeep(wide_n_deep, hidden {WAD_HIDDEN}) "
        f"({wad.model.param_count()} params) on {CENSUS_TRAIN} Census "
        f"rows: losses {[round(v, 4) for v in ls]}, {steps} steps in "
        f"{wall:.3f} s = {wall / steps * 1e3:.3f} ms/step (host clock); "
        f"test accuracy {acc:.4f} on {len(te)} rows, majority class "
        f"{base:.4f}")
    params = numpy_tree(export_params(wad.model))
    out = {"accuracy": acc}
    for tag, bits in (("int8", 8), ("int4", 4)):
        model = WideAndDeep(2, census_info(), "wide_n_deep",
                            hidden_layers=WAD_HIDDEN, device=dev).model
        im = InferenceModel(max_batch=WAD_PREDICT_BATCH, device=dev) \
            .do_load_model(model, params)
        im.do_quantize([tuple(a[:WAD_PREDICT_BATCH] for a in xte)]
                       if bits == 8 else None, bits=bits, force=True)
        sync(dev)
        st0 = im.aot_stats()
        reset_launches()
        with _impl.card_launches(("w8a8", "w4a16")) as card:
            probs = im.do_predict(xte, batch_size=WAD_PREDICT_BATCH)
            sync(dev)
        st = im.aot_stats()
        run = {"card": card, "wrapper": {"w8a8": qm.launches_w8a8,
                                         "w4a16": qm.launches_w4a16},
               "forwards": sum(st["programs"].values())
               - sum(st0["programs"].values())}
        check_launches(f"wad[{tag}]", run, len(RECO_DENSE["wad"]))
        plain = route_probs(im, xte, "torch", WAD_PREDICT_BATCH)
        err = check_route(f"wad[{tag}]", probs, plain, bits)
        qacc = float((probs.argmax(-1) == y[te]).mean())
        say(f"wad[{tag}]: {len(te)} test rows in {run['forwards']} forwards "
            f"of {WAD_PREDICT_BATCH}: accuracy {qacc:.4f} (f32 {acc:.4f}); "
            f"launches on the card = by the wrappers: w8a8 "
            f"{card['w8a8']}, w4a16 {card['w4a16']}; vs the plain route "
            + ("bitwise equal" if bits == 8 else f"max abs err {err:.3e}")
            + f"; weight bytes {weight_bytes(im._params)}")
        out[tag] = run
        del im, model
    return out


def profile_ncf(est, data: dict, im, x) -> None:
    """One NCF training step and one int8 predict batch under
    ``torch.profiler``: busy share and the kernels that take the most
    time."""
    from torch.profiler import ProfilerActivity, profile
    users, items, labels = training_arrays(data["train_pos"][:NCF_BATCH],
                                           data["n_items"], n_neg=NCF_NEG)
    batch = est._transfer(([users[:NCF_BATCH], items[:NCF_BATCH]],
                           labels[:NCF_BATCH],
                           np.ones(NCF_BATCH, np.float32)))
    xb = [a[:RECO_BATCH] for a in x]
    im.do_predict(xb)
    for tag, fn in (("train", lambda: est._train_step(*batch[:3])),
                    ("predict/int8", lambda: im.do_predict(xb))):
        est.model.train(tag == "train")
        sync(est.device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync(est.device)
            wall = time.perf_counter() - t0
        rows, busy = kernel_rows(prof)
        n = NCF_BATCH if tag == "train" else RECO_BATCH
        say(f"profile[ncf {tag}]: one batch of {n} rows in "
            f"{wall * 1e3:.2f} ms under the profiler, kernels "
            f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% of the wall), "
            f"{sum(r[1] for r in rows)} kernel launches")
        for name, count, ms in rows[:10]:
            say(f"profile[ncf {tag}]   {ms:9.3f} ms  {count:4d} calls  "
                f"{name[:90]}")
    est.model.eval()


def reco_phase(seed: int, records: dict, profile: bool) -> None:
    """Phase 8: the kernels at the recommendation shapes; NeuralCF at
    MovieLens-1M width trained and ranked, then served in f32, int8 and
    int4; WideAndDeep at the Census columns trained and served in int8
    and int4."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    kt = reco_kernel_phase(seed)
    data = ncf_data(seed)
    ncf = NeuralCF(data["n_users"], data["n_items"], 2, **NCF, device=dev)
    ncf.init_weights(seed)
    check(ncf.model.param_count() == NCF_PARAMS
          and dense_shapes(ncf.model) == RECO_DENSE["ncf"],
          f"ncf: {ncf.model.param_count()} params, Dense shapes "
          f"{dense_shapes(ncf.model)}")
    say(f"model: NeuralCF({data['n_users']} users, {data['n_items']} "
        f"items, {NCF}) ({NCF_PARAMS} params) from seed {seed}; "
        f"synthetic_ml1m: {len(data['ratings'])} interactions, "
        f"{len(data['train_pos'])} training positives x {1 + NCF_NEG}, "
        f"{len(data['test_pos'])} held out (host {data['seconds']:.2f} s)")
    epochs = ncf_train(ncf, data, seed)
    check_ncf_train(epochs)
    params = numpy_tree(export_params(ncf.model))
    served = ncf_serve(ncf, params, data, dev)
    if profile:
        im = InferenceModel(max_batch=RECO_BATCH, device=dev).do_load_model(
            NeuralCF(ncf.user_count, ncf.item_count, 2, **NCF,
                     device=dev).model, params)
        x = served["int8"]["x"]
        im.do_quantize([(x[0][:RECO_BATCH], x[1][:RECO_BATCH])], bits=8,
                       force=True)
        profile_ncf(epochs[-1]["estimator"], data, im, x)
    wad = wad_phase(seed, dev)
    for name, bits_tag in (("w8a8", "int8"), ("w4a16", "int4")):
        rec = records[name]
        rec["reco_launches"] = {"ncf": served[bits_tag]["card"][name],
                                "wad": wad[bits_tag]["card"][name]}
        for model in RECO_DENSE:
            for key, v in kt[f"{name}_{model}"].items():
                rec[f"{model}_forward_{key}"] = v
        rec["reco_shapes"] = {kn: t[name] for kn, t in kt["shapes"].items()}
    records["w4a16"]["max_abs_err"] = max(records["w4a16"]["max_abs_err"],
                                          kt["w4_max_abs_err"])
    say(f"reco: phase wall {time.perf_counter() - t_phase:.2f} s")


# -- phase 9: the recurrent zoo -----------------------------------------------

# SessionRecommender at GRU4Rec's RSC15 training set's item count (Hidasi
# et al., ICLR 2016, Table 1) and SessionRecommender.scala's defaults
SESSION = dict(item_count=37483, item_embed=100, rnn_hidden_layers=(40, 20),
               session_length=10, include_history=True,
               mlp_hidden_layers=(40, 20), history_length=5)
SESSION_PARAMS = 9_096_568
SESSION_TRAIN, SESSION_TEST = 65536, 8192
SESSION_EPOCHS, SESSION_BATCH, SESSION_LR = 2, 1024, 1e-3
# the surrogate's sessions: each inside one of 64 item clusters, items
# drawn by a Zipf law of this exponent over the cluster's own ranking
SESSION_CLUSTERS, SESSION_ZIPF = 64, 2.0
SESSION_TOP = 20
# Recall@20 after the last epoch.  The JAX package's CPU runs of the same
# protocol (``session_reference.py``: the same data, model, optimizer and
# batches) from four seeded inits read 0.5924, 0.3270, 0.3467 and 0.5955
# (the popularity baseline 0.1938): the threshold sits below the least
# of them
SESSION_RECALL_MIN = 0.28
SESSION_CALIB_BATCHES = 4
SESSION_RECOMMEND = 4
# a quantized route's Recall@20 against f32's
SESSION_RECALL_GAP = 0.02
# AnomalyDetector at the example's configuration
# (examples/anomaly_detection.py) over NAB realKnownCause/nyc_taxi.csv's
# length of half-hourly points
ANOMALY = dict(feature_shape=(24, 1), hidden_layers=(8, 32, 15),
               dropouts=(0.2, 0.2, 0.2))
ANOMALY_POINTS, ANOMALY_PLANTED, ANOMALY_TOP = 10320, 12, 12
ANOMALY_EPOCHS, ANOMALY_BATCH, ANOMALY_LR = 3, 64, 2e-3
ANOMALY_PREDICT_BATCH = 256
# Seq2seq at ``tools/serving_bench.py --model seq2seq --generate``'s own
# geometry
SEQ2SEQ = dict(vocab_size=2048, embed_dim=64, hidden_sizes=(256,),
               bridge="dense")
SEQ2SEQ_REQUESTS = 64
SEQ2SEQ_BUDGETS = (4, 6, 8, 10, 12, 16, 24, 256)
SEQ2SEQ_GEN = dict(paged=False, max_active_slots=8, decode_quantum=8,
                   max_tokens=256, max_prompt_len=24, stream_interval=0,
                   eos_id=None, start_id=1)
# the (K, N) of each model's Dense layers in graph order:
# SessionRecommender's session head (the GRU's 20 onto 37,484 items), its
# history MLP (item_embed 100 -> 40 -> 20) and head; AnomalyDetector's
# head
RECURRENT_DENSE = {"session": ((20, 37484), (100, 40), (40, 20),
                               (20, 37484)),
                   "anomaly": ((15, 1),)}
# rows of x in the parity cases: one, the batch, a batch off a multiple
RECURRENT_M = (1, 1024, 1000)
RECURRENT_TIMED_M = 1024


def recurrent_shapes():
    return [kn for kn, _ in distinct(RECURRENT_DENSE["session"]
                                     + RECURRENT_DENSE["anomaly"])]


def recurrent_kernel_phase(seed: int) -> dict:
    """(a): ``w8a8`` bitwise (each weight exact and inside a buffer of
    127s) and ``w4a16`` within W4_TOL at RECURRENT_M x the recurrent zoo's
    (K, N); each (K, N) timed at M = RECURRENT_TIMED_M beside
    ``torch._int_mm`` + scale (w8a8) and the plain version, and summed over
    each model's forward."""
    worst = reco_parity(seed + 9, RECURRENT_M, recurrent_shapes())
    say(f"recurrent parity: w8a8 bitwise (each weight exact and inside "
        f"127s) and w4a16 within {W4_TOL} (max err {worst:.3e}) at M "
        f"{RECURRENT_M} x (K, N) {recurrent_shapes()}")
    m = RECURRENT_TIMED_M
    w8 = {kn: w8a8_timing(seed + 5, m, *kn, plain=True)
          for kn in recurrent_shapes()}
    w4 = {kn: w4a16_timing(seed + 5, m, *kn, 64, torch.float32)
          for kn in recurrent_shapes()}
    out = {"w4_max_abs_err": worst}
    for model, kns in RECURRENT_DENSE.items():
        for name, t, keys in (("w8a8", w8, ("ms", "plain_ms", "library_ms",
                                            "bound_ms")),
                              ("w4a16", w4, ("ms", "plain_ms",
                                             "bound_ms"))):
            out[f"{name}_{model}"] = {key: sum(t[kn][key] for kn in kns)
                                      for key in keys}
            say(f"recurrent timing[{name}, {model} forward of {len(kns)} "
                f"launches at M={m}]: " + ", ".join(
                    f"{key} {v:.4f}" for key, v in
                    out[f"{name}_{model}"].items()))
    out["shapes"] = {f"{k}x{n}": {"w8a8": {key: w8[(k, n)][key] for key in
                                            ("ms", "library_ms", "bound_ms")},
                                  "w4a16": {key: w4[(k, n)][key] for key in
                                            ("ms", "plain_ms", "bound_ms")}}
                     for k, n in recurrent_shapes()}
    return out


def session_data(seed: int) -> dict:
    """Seeded sessions at RSC15's item count: item ids 1..item_count dealt
    into SESSION_CLUSTERS clusters; a session, its next item (the label)
    and its history of purchases are all drawn from one cluster, each
    item by a Zipf law over a ranking of the cluster's items, so the next
    item is predictable from the session (its cluster) up to the law's
    spread.  The first SESSION_TRAIN rows train, the last SESSION_TEST
    are held out."""
    g = np.random.default_rng(seed + 160)
    L, Hl = SESSION["session_length"], SESSION["history_length"]
    n = SESSION_TRAIN + SESSION_TEST
    members = np.array_split(g.permutation(SESSION["item_count"]) + 1,
                             SESSION_CLUSTERS)
    cluster = g.integers(0, SESSION_CLUSTERS, n)
    rows = np.empty((n, L + 1 + Hl), np.int64)
    for c, items in enumerate(members):
        at = np.nonzero(cluster == c)[0]
        p = 1.0 / np.arange(1, len(items) + 1) ** SESSION_ZIPF
        rows[at] = items[g.choice(len(items), (len(at), rows.shape[1]),
                                  p=p / p.sum())]
    x = [rows[:, :L].astype(np.float32), rows[:, L + 1:].astype(np.float32)]
    y = rows[:, L]
    tr, te = slice(0, SESSION_TRAIN), slice(SESSION_TRAIN, n)
    return {"x_train": [a[tr] for a in x], "y_train": y[tr],
            "x_test": [a[te] for a in x], "y_test": y[te]}


def rank_metrics(probs: np.ndarray, y: np.ndarray, k: int = SESSION_TOP):
    """Sums of Recall@k and MRR@k over the rows: a label's rank is the
    count of items of higher probability."""
    p_label = probs[np.arange(len(y)), y]
    rank = (probs > p_label[:, None]).sum(1)
    hit = rank < k
    return float(hit.sum()), float((hit / (rank + 1.0)).sum())


def ranked(predict, x, y, keep: bool = False):
    """Recall@20 and MRR@20 of ``predict`` over ``x`` in chunks of
    SESSION_BATCH (one call each), and with ``keep`` the
    probabilities."""
    batch = SESSION_BATCH
    recall = mrr = 0.0
    kept = []
    for i in range(0, len(y), batch):
        probs = predict([a[i:i + batch] for a in x])
        r, m = rank_metrics(probs, y[i:i + batch])
        recall, mrr = recall + r, mrr + m
        if keep:
            kept.append(probs)
    out = {"recall": recall / len(y), "mrr": mrr / len(y)}
    if keep:
        out["probs"] = kept
    return out


def popularity_baseline(data: dict) -> dict:
    """The training labels' most frequent items for every session."""
    counts = np.bincount(data["y_train"],
                         minlength=SESSION["item_count"] + 1).astype(
        np.float32)
    y = data["y_test"]
    r, m = rank_metrics(np.broadcast_to(counts, (len(y), len(counts))), y)
    return {"recall": r / len(y), "mrr": m / len(y)}


def session_train(sr, data: dict, seed: int) -> list:
    """``Estimator.fit`` for SESSION_EPOCHS epochs (Adam, sparse
    categorical cross-entropy on the softmax), Recall@20 / MRR@20 on the
    held-out sessions after each."""
    dev = sr.device
    est = Estimator(sr.model, optimizer=Adam(lr=SESSION_LR),
                    loss="sparse_categorical_crossentropy",
                    registry=MetricsRegistry(),
                    ctx=ZooContext(ZooConf(seed=seed, device=str(dev))))
    out = []
    for _ in range(SESSION_EPOCHS):
        sync(dev)
        t0 = time.perf_counter()
        hist = est.fit(data["x_train"], data["y_train"][:, None],
                       batch_size=SESSION_BATCH, epochs=1, verbose=False,
                       steps_per_call=ZOO_STEPS_PER_CALL)
        sync(dev)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        m = ranked(lambda x: est.predict(x, batch_size=SESSION_BATCH),
                   data["x_test"], data["y_test"])
        out.append({"loss": hist.history["loss"][-1], **m, "wall_s": wall,
                    "steps": -(-SESSION_TRAIN // SESSION_BATCH),
                    "eval_s": time.perf_counter() - t0})
    return out


def check_session_train(epochs: list, base: dict,
                        recall_min: float = SESSION_RECALL_MIN) -> None:
    ls = [e["loss"] for e in epochs]
    check(all(math.isfinite(v) for v in ls)
          and all(b < a for a, b in zip(ls, ls[1:])),
          f"session train: the per-epoch loss did not fall ({ls})")
    check(epochs[-1]["recall"] >= recall_min,
          f"session train: Recall@{SESSION_TOP} "
          f"{epochs[-1]['recall']:.4f} < {recall_min} after "
          f"{len(epochs)} epochs")
    for i, e in enumerate(epochs):
        say(f"session train[epoch {i + 1}]: loss {e['loss']:.4f}, "
            f"Recall@{SESSION_TOP} {e['recall']:.4f}, MRR@{SESSION_TOP} "
            f"{e['mrr']:.4f} (popularity: {base['recall']:.4f}, "
            f"{base['mrr']:.4f}); {SESSION_TRAIN} sessions in {e['steps']} "
            f"steps of {SESSION_BATCH}, {e['wall_s']:.3f} s = "
            f"{SESSION_TRAIN / e['wall_s']:.0f} sessions/s, "
            f"{e['wall_s'] / e['steps'] * 1e3:.3f} ms/step (host clock, "
            f"{ZOO_STEPS_PER_CALL} steps a call); "
            f"evaluation {e['eval_s']:.2f} s")


def serve_sessions(im, data: dict) -> dict:
    """The held-out sessions through ``im`` (one ``do_predict`` a batch of
    SESSION_BATCH) with the counts set to 0 just before and read just
    after, under a profiler trace of the card; then again untraced, for
    sessions/s."""
    x, y = data["x_test"], data["y_test"]
    sync(im.device)
    st0 = im.aot_stats()
    reset_launches()
    with _impl.card_launches(("w8a8", "w4a16")) as card:
        m = ranked(lambda xb: im.do_predict(xb, batch_size=SESSION_BATCH),
                   x, y, keep=True)
        sync(im.device)
    wrapper = {"w8a8": qm.launches_w8a8, "w4a16": qm.launches_w4a16}
    st = im.aot_stats()
    sync(im.device)
    t0 = time.perf_counter()
    for i in range(0, len(y), SESSION_BATCH):
        im.do_predict([a[i:i + SESSION_BATCH] for a in x],
                      batch_size=SESSION_BATCH)
    wall = time.perf_counter() - t0
    return {**m, "wall_s": wall, "card": card, "wrapper": wrapper,
            "forwards": sum(st["programs"].values())
            - sum(st0["programs"].values())}


def session_recommend_check(sr, im, x) -> None:
    """``recommend_for_session`` (the trained zoo model's predict) gives
    for each session the SESSION_TOP items of highest probability through
    ``im``: each probability within 1e-6 of ``im``'s, in non-increasing
    order, and the same items where no two probabilities lie within 1e-6
    of each other across the cut (there, as a set)."""
    sessions, history = x[0][:SESSION_RECOMMEND], x[1][:SESSION_RECOMMEND]
    recs = sr.recommend_for_session(sessions, max_items=SESSION_TOP,
                                    history=history,
                                    batch_size=SESSION_BATCH)
    probs = im.do_predict([sessions, history], batch_size=SESSION_BATCH)
    check(len(recs) == SESSION_RECOMMEND
          and all(len(r) == SESSION_TOP for r in recs),
          f"recommend_for_session: {[len(r) for r in recs]}")
    for j, rec in enumerate(recs):
        p = [q for _, q in rec]
        check(all(b <= a + 1e-6 for a, b in zip(p, p[1:])),
              f"recommend_for_session[{j}]: {rec}")
        edge = np.sort(probs[j])[::-1][SESSION_TOP - 1]
        for item, q in rec:
            s = float(probs[j, item])
            check(abs(q - s) <= 1e-6 and s >= edge - 1e-6,
                  f"recommend_for_session[{j}]: item {item} at {q} (served "
                  f"{s}, top-{SESSION_TOP} edge {edge})")
    say(f"recommend_for_session({SESSION_RECOMMEND} sessions, "
        f"max_items={SESSION_TOP}): each session's top {SESSION_TOP} of the "
        f"f32 probabilities served by InferenceModel")


def session_serve(sr, params: dict, data: dict, dev) -> dict:
    """The trained SessionRecommender (``params``) through InferenceModel
    in f32, int8 (calibrated on SESSION_CALIB_BATCHES training batches)
    and int4 (groups of 64); the quantized routes against the same model
    through every kernel's plain version; each Recall@20 against f32's."""
    out = {}
    xtr = data["x_train"]
    calib = [tuple(a[i * SESSION_BATCH:(i + 1) * SESSION_BATCH]
                   for a in xtr) for i in range(SESSION_CALIB_BATCHES)]
    n_dense = len(RECURRENT_DENSE["session"])
    for tag, bits in (("f32", 0), ("int8", 8), ("int4", 4)):
        model = SessionRecommender(**SESSION, device=dev).model
        im = InferenceModel(max_batch=SESSION_BATCH, device=dev) \
            .do_load_model(model, params)
        if bits:
            im.do_quantize(calib if bits == 8 else None, bits=bits,
                           force=True, group_size=64)
        run = serve_sessions(im, data)
        check_launches(f"session[{tag}]", run, n_dense)
        err = 0.0
        if bits:
            x = data["x_test"]
            for j, i in enumerate(range(0, len(data["y_test"]),
                                        SESSION_BATCH)):
                plain = route_probs(im, [a[i:i + SESSION_BATCH] for a in x],
                                    "torch", SESSION_BATCH)
                err = max(err, check_route(f"session[{tag}] batch {j}",
                                           run["probs"][j], plain, bits))
        f32 = out.get("f32", run)["recall"]
        check(abs(run["recall"] - f32) <= SESSION_RECALL_GAP,
              f"session[{tag}]: Recall@{SESSION_TOP} {run['recall']:.4f} "
              f"is more than {SESSION_RECALL_GAP} from f32's {f32:.4f}")
        run["bytes"] = weight_bytes(im._params)
        n = len(data["y_test"])
        say(f"session[{tag}]: {n} held-out sessions in {run['forwards']} "
            f"forwards of {SESSION_BATCH}: Recall@{SESSION_TOP} "
            f"{run['recall']:.4f}, MRR@{SESSION_TOP} {run['mrr']:.4f}; "
            f"{n / run['wall_s']:.0f} sessions served/s untraced (host "
            f"clock, a reading); launches on the card = by the wrappers: "
            f"w8a8 {run['card']['w8a8']}, w4a16 {run['card']['w4a16']}; "
            f"weight bytes {run['bytes']}"
            + ("" if bits == 0 else "; vs the plain route "
               + ("bitwise equal" if bits == 8 else
                  f"max abs err {err:.3e}")))
        if tag == "f32":
            session_recommend_check(sr, im, data["x_test"])
        run.pop("probs")
        out[tag] = run
        del im, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def session_phase(seed: int, dev) -> dict:
    """(b): SessionRecommender at RSC15 width trained, ranked, served."""
    t0 = time.perf_counter()
    data = session_data(seed)
    t_data = time.perf_counter() - t0
    sr = SessionRecommender(**SESSION, device=dev)
    sr.init_weights(seed)
    check(sr.model.param_count() == SESSION_PARAMS
          and dense_shapes(sr.model) == RECURRENT_DENSE["session"],
          f"session: {sr.model.param_count()} params, Dense shapes "
          f"{dense_shapes(sr.model)}")
    base = popularity_baseline(data)
    say(f"model: SessionRecommender({SESSION}) ({SESSION_PARAMS} params) "
        f"from seed {seed}; {SESSION_TRAIN} training and {SESSION_TEST} "
        f"held-out sessions in {SESSION_CLUSTERS} item clusters (host "
        f"{t_data:.2f} s)")
    epochs = session_train(sr, data, seed)
    check_session_train(epochs, base)
    params = numpy_tree(export_params(sr.model))
    served = session_serve(sr, params, data, dev)
    return {"epochs": epochs, "served": served}


def synth_series(n=2000, anomaly_count=12, seed=3):
    """``examples/anomaly_detection.py``'s series: daily and weekly
    seasonality of half-hourly points, noise, and ``anomaly_count``
    planted spikes; returns the series and the spikes' indices."""
    g = np.random.default_rng(seed)
    t = np.arange(n)
    base = (10 + 4 * np.sin(2 * np.pi * t / 48)
            + 2 * np.sin(2 * np.pi * t / (48 * 7))
            + g.normal(0, 0.4, n))
    idx = g.choice(np.arange(100, n - 100), anomaly_count, replace=False)
    base[idx] += g.choice([-1, 1], anomaly_count) * g.uniform(5, 9,
                                                              anomaly_count)
    return base.astype(np.float32), np.sort(idx)


def anomaly_phase(seed: int, dev) -> dict:
    """(c): AnomalyDetector at the example's configuration over its
    series at nyc_taxi's length: standardized, unrolled, fit on the first
    70%, predicted at batch ANOMALY_PREDICT_BATCH; the top ANOMALY_TOP
    distances flagged and held against the planted anomalies; then int8
    and int4 predict through InferenceModel (the Dense(1) head on the
    kernels, one launch a forward), int8 bitwise the plain route's."""
    series, truth = synth_series(ANOMALY_POINTS, ANOMALY_PLANTED, seed + 3)
    norm = ((series - series.mean()) / (series.std() + 1e-8))[:, None]
    L = ANOMALY["feature_shape"][0]
    x, y = AnomalyDetector.unroll(norm, L)
    cut = int(0.7 * len(x))
    ad = AnomalyDetector(**ANOMALY, device=dev)
    ad.init_weights(seed)
    check(dense_shapes(ad.model) == RECURRENT_DENSE["anomaly"],
          f"anomaly: Dense shapes {dense_shapes(ad.model)}")
    est = Estimator(ad.model, optimizer=Adam(lr=ANOMALY_LR), loss="mse",
                    registry=MetricsRegistry(),
                    ctx=ZooContext(ZooConf(seed=seed, device=str(dev))))
    sync(dev)
    t0 = time.perf_counter()
    hist = est.fit(x[:cut], y[:cut], batch_size=ANOMALY_BATCH,
                   epochs=ANOMALY_EPOCHS, verbose=False,
                   steps_per_call=ZOO_STEPS_PER_CALL)
    sync(dev)
    wall = time.perf_counter() - t0
    ls = hist.history["loss"]
    check(all(math.isfinite(v) for v in ls) and ls[-1] < ls[0],
          f"anomaly: the loss did not fall ({ls})")
    pred = np.ravel(est.predict(x, batch_size=ANOMALY_PREDICT_BATCH))
    actual = np.ravel(y)
    idx, _, thr = AnomalyDetector.detect_anomalies(
        actual, pred, anomaly_fraction=ANOMALY_TOP / len(actual))
    flagged = np.sort(np.asarray(idx) + L)
    hits = sum(1 for a in truth if np.any(np.abs(flagged - a) <= 1))
    steps = ANOMALY_EPOCHS * -(-cut // ANOMALY_BATCH)
    say(f"anomaly: AnomalyDetector({ANOMALY}) "
        f"({ad.model.param_count()} params) on {ANOMALY_POINTS} points, "
        f"{len(x)} windows, {cut} to train: losses "
        f"{[round(v, 4) for v in ls]}, {steps} steps in {wall:.3f} s = "
        f"{wall / steps * 1e3:.3f} ms/step (host clock, "
        f"{ZOO_STEPS_PER_CALL} steps a call); "
        f"{len(flagged)} flagged, planted anomalies recalled {hits}/"
        f"{len(truth)} (threshold {thr:.4f})")
    params = numpy_tree(export_params(ad.model))
    out = {"recalled": hits}
    for tag, bits in (("int8", 8), ("int4", 4)):
        model = AnomalyDetector(**ANOMALY, device=dev).model
        im = InferenceModel(max_batch=ANOMALY_PREDICT_BATCH, device=dev) \
            .do_load_model(model, params)
        im.do_quantize([x[:ANOMALY_PREDICT_BATCH]] if bits == 8 else None,
                       bits=bits, force=True)
        sync(dev)
        st0 = im.aot_stats()
        reset_launches()
        with _impl.card_launches(("w8a8", "w4a16")) as card:
            got = im.do_predict(x, batch_size=ANOMALY_PREDICT_BATCH)
            sync(dev)
        st = im.aot_stats()
        run = {"card": card, "wrapper": {"w8a8": qm.launches_w8a8,
                                         "w4a16": qm.launches_w4a16},
               "forwards": sum(st["programs"].values())
               - sum(st0["programs"].values())}
        check_launches(f"anomaly[{tag}]", run, 1)
        plain = route_probs(im, x, "torch", ANOMALY_PREDICT_BATCH)
        err = check_route(f"anomaly[{tag}]", got, plain, bits)
        qidx, _, _ = AnomalyDetector.detect_anomalies(
            actual, np.ravel(got), anomaly_fraction=ANOMALY_TOP / len(actual))
        qflag = np.sort(np.asarray(qidx) + L)
        qhits = sum(1 for a in truth if np.any(np.abs(qflag - a) <= 1))
        say(f"anomaly[{tag}]: {len(x)} windows in {run['forwards']} forwards "
            f"of {ANOMALY_PREDICT_BATCH}: planted anomalies recalled "
            f"{qhits}/{len(truth)} (f32 {hits}); launches on the card = by "
            f"the wrappers: w8a8 {card['w8a8']}, w4a16 {card['w4a16']}; vs "
            f"the plain route "
            + ("bitwise equal" if bits == 8 else f"max abs err {err:.3e}")
            + f"; weight bytes {weight_bytes(im._params)}")
        out[tag] = run
        del im, model
    return out


def seq2seq_requests(seed: int) -> list:
    """SEQ2SEQ_REQUESTS prompts of 4-24 tokens, budgets cycling
    SEQ2SEQ_BUDGETS."""
    g = np.random.default_rng(seed + 170)
    return [(f"s2s-{i:02d}",
             g.integers(2, SEQ2SEQ["vocab_size"], int(g.integers(4, 25)))
             .astype(np.int32), SEQ2SEQ_BUDGETS[i % len(SEQ2SEQ_BUDGETS)])
            for i in range(SEQ2SEQ_REQUESTS)]


def seq2seq_serve(im, reqs) -> dict:
    """ClusterServing over InProcQueue in generation mode with
    ``warmup``: the requests sent once the warm-up is ``ready``."""
    q = InProcQueue()
    serving = ClusterServing(im, q, ServingParams(
        max_batch=SEQ2SEQ_GEN["max_active_slots"], max_wait_ms=2.0,
        generation=SEQ2SEQ_GEN, warmup=True))
    b = serving._batcher
    oq = OutputQueue(q)
    try:
        serving.start()
        warm = wait_warm(serving)
        sync(im.device)
        before = b.stats()
        t0 = time.perf_counter()
        for rid, prompt, budget in reqs:
            enqueue_generation(q, rid, prompt, budget)
        res = oq.query_many([r[0] for r in reqs], timeout_s=600.0)
        wall = time.perf_counter() - t0
    finally:
        serving.shutdown(drain_s=5.0)
    return {"results": res, "wall_s": wall, "warm": warm, "before": before,
            "stats": b.stats(),
            "ttft_p50_s": serving._m_ttft.percentiles((50,))["p50"]}


def enqueue_generation(q, rid, prompt, budget) -> None:
    arr = np.ascontiguousarray(np.asarray(prompt, "<f4"))
    q.xadd({"uri": rid, "b64": base64.b64encode(arr).decode("ascii"),
            "dtype": "<f4", "shape": list(arr.shape),
            "gen": {"max_tokens": int(budget)}})


@torch.inference_mode()
def seq2seq_margin(model, prompt, tokens, d: int):
    """(top-2 logit margin, argmax) of the step that picks token ``d``
    after ``tokens[:d]``, on the model's plain decode from its prompt."""
    st = model.init_decode(prompt[None].astype(np.float32))
    tok = torch.full((1,), SEQ2SEQ_GEN["start_id"], dtype=torch.int32,
                     device=model.device)
    for i in range(d + 1):
        logits, st = model.decode_step(st, tok)
        if i < d:
            tok = torch.tensor([tokens[i]], dtype=torch.int32,
                               device=model.device)
    top2 = logits[0].topk(2)
    return float(top2.values[0] - top2.values[1]), int(top2.indices[0])


def seq2seq_check_infer(model, reqs, got: dict, tag: str) -> None:
    """Each request's tokens equal its own ``Seq2seq.infer`` from
    ``start_id`` for its budget, or part from it only at a near tie."""
    diverged = 0
    for rid, prompt, budget in reqs:
        want = [int(t) for t in model.infer(
            prompt[None].astype(np.float32),
            start_sign=SEQ2SEQ_GEN["start_id"], max_seq_len=budget)[0]]
        toks = got[rid]
        check(len(toks) == budget, f"{tag} {rid}: {len(toks)} tokens, "
                                   f"budget {budget}")
        if toks == want:
            continue
        d = next(i for i, (a, b) in enumerate(zip(toks, want)) if a != b)
        margin, top = seq2seq_margin(model, prompt, toks, d)
        say(f"{tag} {rid}: diverges from infer at token {d} (got "
            f"{toks[d]}, infer {want[d]}), top-2 logit margin "
            f"{margin:.3e}")
        check(top in (toks[d], want[d]) and margin < TIE_MARGIN,
              f"{tag} {rid}: divergence at token {d} is not a near tie "
              f"(margin {margin:.3e}, replay {top})")
        diverged += 1
    say(f"{tag}: {len(reqs) - diverged}/{len(reqs)} token sequences equal "
        f"their own Seq2seq.infer, {diverged} diverged at a near tie")


def seq2seq_batcher(im, reqs, warm: bool) -> dict:
    """A bare batcher, warmed (graph route) or not (eager route), over the
    requests submitted at once: the same admissions on both routes."""
    b = ContinuousBatcher(im, GenerationParams(**SEQ2SEQ_GEN))
    doc = b.warm() if warm else None
    for rid, prompt, budget in reqs:
        check(b.submit(GenRequest(rid, prompt, max_tokens=budget)),
              "waiting room full")
    done = {}
    sync(im.device)
    t0 = time.perf_counter()
    while len(done) < len(reqs):
        for ev in b.step():
            check(ev.kind not in ("shed", "quarantine"),
                  f"seq2seq batcher {ev.kind} on {ev.rid}: {ev.error}")
            if ev.kind == "finish":
                done[ev.rid] = list(ev.tokens)
    wall = time.perf_counter() - t0
    return {"tokens": done, "wall_s": wall, "stats": b.stats(), "doc": doc}


def seq2seq_reclaim(im, seq, tmp: str) -> dict:
    """A record claimed by a dead owner over a FileQueue, its partial in
    the result store and a checkpoint of it in the dead owner's spool:
    the survivor attaches the snapshot (``gen_resume``), the batcher
    cannot replay bare state and restarts it from 0
    (``gen_resume_failed``)."""
    rid, prompt, budget = seq
    qdir = os.path.join(tmp, "q")
    q = FileQueue(qdir)
    enqueue_generation(q, rid, prompt, budget)
    q.consumer = "dead"
    check([r for r, _ in q.read_batch(8, timeout_s=1.0)] == [rid],
          "seq2seq reclaim: the dead owner claimed nothing")
    prefix = [1, 2, 3]
    q.put_partial(rid, {"partial": True, "tokens": prefix,
                        "n": len(prefix)})
    snap = {"rid": rid, "epoch": 0, "prompt": [int(t) for t in prompt],
            "tokens": prefix, "n": len(prefix), "tenant": None,
            "trace_id": None, "deadline_ns": None, "max_tokens": budget,
            "sampler": "greedy", "ts": time.monotonic()}
    snap["crc"] = tracecollect.snapshot_checksum(snap)
    spool = os.path.join(tmp, "dead.gensnap.jsonl")
    tracecollect.append_snapshots(spool, [snap], source="dead")
    q.annotate(rid, {"spool": spool, "epoch": 0, "replica": "dead"})
    time.sleep(RESUME_LEASE_S + 0.2)
    gen = dict(SEQ2SEQ_GEN, checkpoint_interval=8, resume=True)
    serving = ClusterServing(im, FileQueue(qdir), ServingParams(
        max_batch=8, max_wait_ms=2.0, generation=gen, lease_s=RESUME_LEASE_S,
        reclaim_interval_s=0.05))
    serving.snapshot_path = os.path.join(tmp, "survivor.gensnap.jsonl")
    try:
        serving.start()
        res = OutputQueue(FileQueue(qdir)).query_many([rid], timeout_s=120.0)
    finally:
        serving.shutdown(drain_s=5.0)
    events = {name: [e for e in serving.recorder.events()
                     if e.get("event") == name
                     and e.get("replica") == serving.replica_id]
              for name in ("gen_resume", "gen_resume_failed")}
    return {"tokens": res[rid]["value"]["tokens"], "events": events,
            "stats": serving._batcher.stats()}


def seq2seq_phase(seed: int, dev) -> None:
    """(d): Seq2seq served by ClusterServing in generation mode on
    bare-state lanes, warmed (each lane's quantum a CUDA graph)."""
    model = Seq2seq(**SEQ2SEQ, device=dev)
    model.init_weights(seed)
    im = InferenceModel(device=dev).do_load_model(model)
    reqs = seq2seq_requests(seed)
    say(f"model: Seq2seq({SEQ2SEQ}) ({model.param_count()} params) from "
        f"seed {seed}; {len(reqs)} requests, prompts 4-24 tokens, budgets "
        f"cycling {SEQ2SEQ_BUDGETS}")
    run = seq2seq_serve(im, reqs)
    st, st0, warm = run["stats"], run["before"], run["warm"]
    got = {}
    for rid, _, budget in reqs:
        r = run["results"].get(rid)
        check(r is not None and "value" in r
              and not OutputQueue.is_partial(r),
              f"seq2seq {rid}: no terminal result ({r})")
        got[rid] = list(r["value"]["tokens"])
    steps = st["decode_steps"] - st0["decode_steps"]
    replays = st["replays"] - st0["replays"]
    eager = st["eager_quanta"] - st0["eager_quanta"]
    check(warm["compile_stats"]["captures"] == 1 == st["captures"]
          and eager == 0
          and replays * SEQ2SEQ_GEN["decode_quantum"] == steps > 0,
          f"seq2seq: captures {warm['compile_stats']} / {st['captures']}, "
          f"{eager} eager quanta, {replays} replays for {steps} steps")
    check(st["can_resume"] is False and st["checkpoints"] == 0,
          f"seq2seq: bare-state stats {st}")
    n_tok = sum(len(t) for t in got.values())
    say(f"seq2seq[served]: warm-up {warm['total']} entries in "
        f"{warm['seconds']:.3f} s, {warm['compile_stats']['captures']} graph "
        f"capture; {len(got)}/{len(reqs)} terminal results, {n_tok} tokens "
        f"in {run['wall_s']:.3f} s = {n_tok / run['wall_s']:.1f} tokens/s, "
        f"TTFT p50 {run['ttft_p50_s'] * 1e3:.2f} ms (host clock, "
        f"readings), {steps} decode steps in {replays} graph replays, "
        f"eager quanta {eager}")
    seq2seq_check_infer(model, reqs, got, "seq2seq[served]")
    eager_run = seq2seq_batcher(im, reqs, warm=False)
    graph_run = seq2seq_batcher(im, reqs, warm=True)
    gs, es = graph_run["stats"], eager_run["stats"]
    check(graph_run["tokens"] == eager_run["tokens"],
          "seq2seq: the graph route's tokens differ from the eager route's")
    check(gs["eager_quanta"] == 0 and gs["replays"] > 0
          and es["replays"] == 0,
          f"seq2seq routes: graph {gs}, eager {es}")
    ms = {tag: r["wall_s"] / r["stats"]["decode_steps"] * 1e3
          for tag, r in (("eager", eager_run), ("graph", graph_run))}
    say(f"seq2seq[graph vs eager]: {len(reqs)} requests, tokens equal; "
        f"{gs['decode_steps']} decode steps of "
        f"{SEQ2SEQ_GEN['max_active_slots']} rows: {ms['graph']:.4f} ms a "
        f"step on the graph route, "
        f"{ms['eager']:.4f} on the eager route (host clock)")
    tmp = tempfile.mkdtemp(prefix="zoo-s2s-")
    try:
        rec = seq2seq_reclaim(im, reqs[1], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fails = rec["events"]["gen_resume_failed"]
    check(len(rec["events"]["gen_resume"]) == 1 and len(fails) == 1
          and fails[0].get("reason")
          == "bare-state model cannot replay decode state"
          and rec["stats"]["resume_failed"] == 1,
          f"seq2seq reclaim: events {rec['events']}, stats {rec['stats']}")
    check(rec["tokens"] == eager_run["tokens"][reqs[1][0]],
          "seq2seq reclaim: the restarted record's tokens differ from the "
          "uninterrupted run's")
    say(f"seq2seq[reclaim]: {reqs[1][0]}'s snapshot attached (gen_resume), "
        f"then restarted from 0 ({fails[0]['reason']!r}, wasted "
        f"{fails[0].get('wasted')}); tokens equal the uninterrupted run's")
    del im, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def recurrent_phase(seed: int, records: dict) -> None:
    """Phase 9: the w8a8 / w4a16 kernels at the recurrent zoo's shapes;
    SessionRecommender at RSC15 width trained and served in f32, int8
    and int4; AnomalyDetector trained and served in int8 and int4;
    Seq2seq served by ClusterServing on bare-state lanes."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    kt = recurrent_kernel_phase(seed)
    session = session_phase(seed, dev)
    anomaly = anomaly_phase(seed, dev)
    seq2seq_phase(seed, dev)
    for name, bits_tag in (("w8a8", "int8"), ("w4a16", "int4")):
        rec = records.setdefault(name, {})
        rec["recurrent_launches"] = {
            "session": session["served"][bits_tag]["card"][name],
            "anomaly": anomaly[bits_tag]["card"][name]}
        for model in RECURRENT_DENSE:
            for key, v in kt[f"{name}_{model}"].items():
                rec[f"{model}_forward_{key}"] = v
        rec["recurrent_shapes"] = {kn: t[name]
                                   for kn, t in kt["shapes"].items()}
    rec = records["w4a16"]
    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0),
                             kt["w4_max_abs_err"])
    say(f"recurrent: phase wall {time.perf_counter() - t_phase:.2f} s")


# -- phase 10: the text zoo ---------------------------------------------------

# TextClassifier at the JAX class defaults, which are the reference
# example's (news20 with GloVe 6B 200d): embedding 200, sequence 500,
# encoder 256; 20 classes; a vocabulary of 5000 words plus padding
TEXT_CLS = dict(class_num=20, vocab_size=5001, embedding_dim=200,
                sequence_length=500, encoder_output_dim=256)
TEXT_CLS_PARAMS = 1_291_932
TEXT_MAX_WORDS = 5000
# the surrogate of 20 Newsgroups: 20 topics of TEXT_TOPIC_WORDS words
# each; a document of TEXT_DOC_LEN tokens takes a TEXT_TOPIC_SHARE of them
# from its topic and the rest from a Zipf law over TEXT_WORDS general
# words, with punctuation and capitals for the tokenizer to strip
TEXT_WORDS, TEXT_TOPIC_WORDS, TEXT_TOPIC_SHARE = 20000, 40, 0.2
TEXT_DOC_LEN = (50, 300)
TEXT_TRAIN, TEXT_TEST = 8192, 1024
TEXT_EPOCHS, TEXT_BATCH, TEXT_LR = 2, 128, 1e-3
# the lstm and gru encoders: one step each at the same width (a depth
# cut: 3 before the multi-GPU phase needed the room), then served over
# the first TEXT_RNN_SERVE held-out documents
TEXT_RNN_STEPS, TEXT_RNN_SERVE = 1, 128
# held-out accuracy of the cnn encoder after 2 epochs: below the least of
# the JAX package's CPU runs of the same protocol
# (``tests/text_reference.py``: 1.0 from each of three seeded inits)
TEXT_ACC_MIN = 0.9
# a quantized route's accuracy against f32's
TEXT_ACC_GAP = 0.02
TEXT_CALIB_BATCHES = 2
# ClusterServing: records of TEXT_CLS's 500 ids, batch 16, buckets warmed
TEXT_RECORDS, TEXT_SERVE_BATCH = 64, 16
# kernel launches a forward in each route: the cnn encoder's conv, and
# the two Dense heads
TEXT_LAUNCHES = {"cnn": {"f32": {}, "int8": {"w8a8_conv": 1, "w8a8": 2},
                         "int4": {"w4a16": 2}},
                 "lstm": {"f32": {}, "int8": {"w8a8": 2},
                          "int4": {"w4a16": 2}},
                 "gru": {"f32": {}, "int8": {"w8a8": 2},
                         "int4": {"w4a16": 2}},
                 "knrm": {"f32": {}, "int8": {"w8a8": 1},
                          "int4": {"w4a16": 1}}}
# the classifier's int8 conv as w8a8_conv2d runs it: the (1, 5) conv of
# (B, 1, T, C), (x, (kh, kw, cin, cout), strides, pads, dilation, groups)
TEXT_CONV = ((128, 1, 500, 200), (1, 5, 200, 256), (1, 1), ((0, 0), (0, 0)),
             (1, 1), 1)
# and beside it: an odd T under ``same``, an even kernel (pads (1, 2)),
# 300 channels (GloVe 300d), 16 channels (the copied route), dilation 2
TEXT_CONV_CASES = (
    TEXT_CONV,
    ((128, 1, 499, 200), (1, 5, 200, 256), (1, 1), ((0, 0), (2, 2)), (1, 1),
     1),
    ((128, 1, 500, 200), (1, 4, 200, 256), (1, 1), ((0, 0), (1, 2)), (1, 1),
     1),
    ((16, 1, 500, 300), (1, 5, 300, 256), (1, 1), ((0, 0), (2, 2)), (1, 1),
     1),
    ((16, 1, 77, 16), (1, 5, 16, 64), (1, 1), ((0, 0), (0, 0)), (1, 1), 1),
    ((16, 1, 500, 200), (1, 5, 200, 256), (1, 1), ((0, 0), (4, 4)), (1, 2),
     1),
    ((3, 1, 501, 16), (1, 5, 16, 256), (1, 1), ((0, 0), (4, 4)), (1, 2), 1),
)
# NER at the reference's widths (pyzoo/zoo/tfpark/text/keras/ner.py, the
# JAX defaults): CoNLL-2003's 9 BIO tags over PER / LOC / ORG / MISC;
# 20,000 words and 100 characters; sentences padded to 40
NER_GEO = dict(num_entities=9, word_vocab_size=20000, char_vocab_size=100,
               word_length=12, word_emb_dim=100, char_emb_dim=30,
               tagger_lstm_dim=100, dropout=0.5)
NER_LEN, NER_TRAIN, NER_TEST = 40, 4096, 512
NER_EPOCHS, NER_BATCH = 2, 32
# the surrogate: NER_ENTITY_WORDS words a type, spans of 1-3 of them
NER_ENTITY_WORDS, NER_SPAN_P = 200, 0.15
NER_TAGS = ("O", "B-PER", "I-PER", "B-LOC", "I-LOC", "B-ORG", "I-ORG",
            "B-MISC", "I-MISC")
# entity-span F1 of the Viterbi paths after 2 epochs: below the least of
# the JAX package's CPU runs (0.9583, 0.8745 and 0.9739 from three inits)
NER_F1_MIN = 0.8
# SequenceTagger (CoNLL-2000's 45 POS and 23 chunk tags) and IntentEntity
# (SNIPS's 7 intents and 72 slot tags) on the same trunk: a few steps each
TAGGER_POS, TAGGER_CHUNK, INTENTS, SLOTS = 45, 23, 7, 72
TAGGER_ROWS, TAGGER_EPOCHS = 256, 2
# KNRM at the reference QA ranker's widths (WikiQA): question 10, answer
# 40, embedding 300, 21 kernels, sigma 0.1, exact sigma 0.001; 20,000
# words; Adam at 1e-2, as the JAX package's own KNRM test trains it
KNRM_GEO = dict(text1_length=10, text2_length=40, vocab_size=20000,
                embed_size=300, kernel_num=21, sigma=0.1, exact_sigma=0.001)
KNRM_TRAIN, KNRM_EPOCHS, KNRM_BATCH, KNRM_LR = 16384, 2, 256, 1e-2
# held-out query groups: KNRM_CANDIDATES answers each, 1-3 relevant ones
# sharing 2-5 tokens with the question; NDCG@3 and MAP after 2 epochs
# below the least of the JAX package's CPU runs (PERF.md section 6)
KNRM_GROUPS, KNRM_CANDIDATES = 256, 10
KNRM_NDCG_MIN, KNRM_MAP_MIN = 0.85, 0.85
KNRM_GAP = 0.02
# the Dense (K, N) of the classifier's heads and KNRM's
TEXT_DENSE = {"classifier": ((256, 128), (128, 20)), "knrm": ((21, 1),)}
TEXT_M = (1, 16, 128, 1000)
# (M, K, N) timed: the heads at the classifier's batch, KNRM's at 1024
# candidates (its ranking forwards are buckets of 16 rows, whose few bytes
# would take ~10^5 input sets to fill L2_FLUSH_BYTES)
TEXT_TIMED = ((TEXT_BATCH, 256, 128), (TEXT_BATCH, 128, 20), (1024, 21, 1))


def text_shapes():
    return [kn for kn, _ in distinct(TEXT_DENSE["classifier"]
                                     + TEXT_DENSE["knrm"])]


def text_conv_bound_check(geom) -> None:
    """The one-row conv's geometry is the classifier's: output
    (B, 1, T - 4, 256)."""
    m, n, k = conv_mnk(geom)
    check((m, n, k) == (128 * 496, 256, 1000),
          f"text conv: (M, N, K) {(m, n, k)}")


def text_kernel_phase(seed: int) -> dict:
    """(a): ``w8a8_conv2d`` bitwise at the one-row geometries, timed at the
    classifier's; ``w8a8`` / ``w4a16`` at the heads' shapes."""
    g = np.random.default_rng(seed + 200)
    for geom in TEXT_CONV_CASES:
        for extremes in (False, True):
            case = conv_case(g, geom[0], geom[1], extremes)
            got = run_conv(case, geom, "cuda", conv_pack(case, geom))
            sync(torch.device("cuda"))
            ref = run_conv(case, geom, "torch")
            check(torch.equal(got, ref),
                  f"w8a8_conv2d one-row {geom}, extremes {extremes}: not "
                  f"bitwise equal to the plain version (max abs err "
                  f"{float((got - ref).abs().max()):.3e})")
    say(f"text conv parity: w8a8_conv2d bitwise equal to w8a8_conv_torch "
        f"at {len(TEXT_CONV_CASES)} one-row geometries x (s8 over "
        f"[-128, 127], all -128 / 127): "
        + "; ".join(f"x {g_[0]} k {g_[1]} pads {g_[3][1]} dilation "
                    f"{g_[4][1]} (tile 128 x {conv_config_of(g_)[0]}, "
                    f"split {conv_config_of(g_)[1]})"
                    for g_ in TEXT_CONV_CASES))
    t = conv_timing(seed, TEXT_CONV)
    smem = _build.load(CONV_SOURCE).w8a8_conv2d_smem
    smem.argtypes = [ctypes.c_int] * 19
    smem.restype = ctypes.c_int
    say(f"text conv timing x {TEXT_CONV[0]} k {TEXT_CONV[1]} (the "
        f"classifier's int8 Convolution1D at batch {TEXT_BATCH}; tile 128 x "
        f"{conv_config_of(TEXT_CONV)[0]}, split "
        f"{conv_config_of(TEXT_CONV)[1]}, A gathered byte by byte: rows of "
        f"200 bytes are off 16): kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, cuDNN f32 conv of the same shape (not the "
        f"same function) {t['library_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} B, "
        f"{t['ops']} int8 operations), {100 * t['bound_ms'] / t['ms']:.1f}% "
        f"of bound; dynamic shared memory "
        f"{smem(*conv_args(TEXT_CONV), *conv_config_of(TEXT_CONV), 1)} B")
    worst = reco_parity(seed + 11, TEXT_M, text_shapes())
    say(f"text parity: w8a8 bitwise (each weight exact and inside 127s) "
        f"and w4a16 within {W4_TOL} (max err {worst:.3e}) at M {TEXT_M} x "
        f"(K, N) {text_shapes()}")
    w8 = {mkn: w8a8_timing(seed + 7, *mkn, plain=True)
          for mkn in TEXT_TIMED}
    w4 = {mkn: w4a16_timing(seed + 7, *mkn, 64, torch.float32)
          for mkn in TEXT_TIMED}
    return {"conv": t, "w8a8": w8, "w4a16": w4, "w4_max_abs_err": worst}


# -- the classifier ---------------------------------------------------------

def text_corpus(seed: int, n: int):
    """``n`` documents of the 20-topic surrogate and their topics.  Words
    are strings (``w<i>``), topic words ``t<topic>x<j>``; a document's
    tokens carry random punctuation and capitals, which ``TextSet``'s
    tokenizer and normalizer strip."""
    g = np.random.default_rng(seed + 300)
    general = np.array([f"w{i}" for i in range(TEXT_WORDS)])
    zipf = 1.0 / np.arange(1, TEXT_WORDS + 1)
    zipf /= zipf.sum()
    punct = np.array(["", "", "", ",", ".", "!", "?", ";"])
    topics = g.integers(0, TEXT_CLS["class_num"], n)
    texts = []
    for t in topics:
        length = int(g.integers(*TEXT_DOC_LEN))
        own = g.random(length) < TEXT_TOPIC_SHARE
        words = general[g.choice(TEXT_WORDS, length, p=zipf)]
        words[own] = [f"t{t}x{j}" for j in
                      g.integers(0, TEXT_TOPIC_WORDS, int(own.sum()))]
        caps = g.random(length) < 0.1
        words[caps] = np.char.upper(words[caps])
        texts.append(" ".join(np.char.add(words, punct[g.integers(
            0, len(punct), length)])))
    return texts, topics


def text_data(seed: int) -> dict:
    """The corpus through the port's ``TextSet``: tokenize, normalize,
    ``word2idx(max_words_num=5000)`` on the training documents (the test
    documents indexed by the same map), ``shape_sequence(500)``,
    ``gen_sample``; and the seeded embedding table in GloVe's place."""
    t0 = time.perf_counter()
    texts, topics = text_corpus(seed, TEXT_TRAIN + TEXT_TEST)
    tr = TextSet.from_texts(texts[:TEXT_TRAIN], topics[:TEXT_TRAIN]) \
        .tokenize().normalize().word2idx(max_words_num=TEXT_MAX_WORDS) \
        .shape_sequence(TEXT_CLS["sequence_length"])
    te = TextSet.from_texts(texts[TEXT_TRAIN:], topics[TEXT_TRAIN:]) \
        .tokenize().normalize().word2idx(existing_map=tr.get_word_index()) \
        .shape_sequence(TEXT_CLS["sequence_length"])
    (x, y), (xt, yt) = tr.gen_sample(), te.gen_sample()
    g = np.random.default_rng(seed + 301)
    table = (0.3 * g.normal(size=(TEXT_CLS["vocab_size"],
                                  TEXT_CLS["embedding_dim"]))).astype(
        np.float32)
    return {"x": x, "y": y, "x_test": xt, "y_test": yt, "embedding": table,
            "words": len(tr.get_word_index()),
            "seconds": time.perf_counter() - t0}


def text_classifier(encoder: str, data: dict, dev, seed: int):
    tc = TextClassifier(**TEXT_CLS, encoder=encoder,
                        embedding_weights=data["embedding"], device=dev)
    tc.init_weights(seed)
    return tc


def text_train(tc, data: dict, seed: int, steps=None) -> dict:
    """``compile(Adam)`` / ``fit`` at TEXT_BATCH for TEXT_EPOCHS epochs
    (or ``steps`` steps), then ``evaluate`` on the held-out documents."""
    dev = tc.device
    tc.model._estimator = Estimator(
        tc.model, optimizer=Adam(lr=TEXT_LR),
        loss="sparse_categorical_crossentropy", metrics=["accuracy"],
        registry=MetricsRegistry(),
        ctx=ZooContext(ZooConf(seed=seed, device=str(dev))))
    n = TEXT_TRAIN if steps is None else steps * TEXT_BATCH
    losses = []
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(TEXT_EPOCHS if steps is None else 1):
        hist = tc.fit(data["x"][:n], data["y"][:n], batch_size=TEXT_BATCH,
                      nb_epoch=1, verbose=False)
        losses.append(hist.history["loss"][-1])
    sync(dev)
    wall = time.perf_counter() - t0
    n_steps = -(-n // TEXT_BATCH) * len(losses)
    out = {"losses": losses, "wall_s": wall, "steps": n_steps}
    if steps is None:
        ev = tc.evaluate(data["x_test"], data["y_test"],
                         batch_size=TEXT_BATCH)
        out.update(accuracy=ev["accuracy"], eval_loss=ev["loss"])
    return out


def serve_text(im, x, y) -> dict:
    """The held-out documents through ``im`` (one ``do_predict`` a batch of
    TEXT_BATCH) with the counts set to 0 just before and read just after,
    under a profiler trace of the card."""
    sync(im.device)
    st0 = im.aot_stats()
    reset_launches()
    kernels = ("w8a8", "w4a16", "w8a8_conv")
    with _impl.card_launches(kernels) as card:
        t0 = time.perf_counter()
        probs = im.do_predict(x, batch_size=TEXT_BATCH)
        sync(im.device)
        wall = time.perf_counter() - t0
    st = im.aot_stats()
    return {"probs": probs, "wall_s": wall, "card": card,
            "wrapper": {"w8a8": qm.launches_w8a8, "w4a16": qm.launches_w4a16,
                        "w8a8_conv": qm.launches_conv},
            "forwards": sum(st["programs"].values())
            - sum(st0["programs"].values()),
            "accuracy": float(np.mean(np.argmax(probs, -1)
                                      == np.asarray(y).reshape(-1)))}


def check_text_launches(tag: str, run: dict, per: dict) -> None:
    """Each kernel launched ``per[kernel]`` times a forward on the card and
    by its wrapper, and no other; at least one forward."""
    fw = run["forwards"]
    check(fw > 0, f"{tag}: no forward ran")
    for k in ("w8a8", "w4a16", "w8a8_conv"):
        want = fw * per.get(k, 0)
        check(run["card"][k] == run["wrapper"][k] == want,
              f"{tag}: {k} launches on the card {run['card'][k]}, by the "
              f"wrapper {run['wrapper'][k]}, != {fw} forwards x "
              f"{per.get(k, 0)}")


def text_serve(encoder: str, params: dict, data: dict, dev,
               n=None) -> dict:
    """The trained classifier (``params``) through InferenceModel in f32,
    int8 (calibrated on TEXT_CALIB_BATCHES TextSet batches) and int4: the
    held-out documents (the first ``n``) served, each quantized route
    against the plain route, each accuracy against f32's."""
    out = {}
    data = dict(data, x_test=data["x_test"][:n], y_test=data["y_test"][:n])
    calib = [data["x"][i * TEXT_BATCH:(i + 1) * TEXT_BATCH]
             for i in range(TEXT_CALIB_BATCHES)]
    for tag, bits in (("f32", 0), ("int8", 8), ("int4", 4)):
        model = TextClassifier(**TEXT_CLS, encoder=encoder,
                               device=dev).model
        im = InferenceModel(max_batch=TEXT_BATCH, device=dev) \
            .do_load_model(model, params)
        if bits:
            im.do_quantize(calib if bits == 8 else None, bits=bits,
                           force=True, group_size=64)
        run = serve_text(im, data["x_test"], data["y_test"])
        check_text_launches(f"text[{encoder}/{tag}]", run,
                            TEXT_LAUNCHES[encoder][tag])
        err = 0.0
        if bits:
            plain = route_probs(im, data["x_test"], "torch", TEXT_BATCH)
            err = check_route(f"text[{encoder}/{tag}]", run["probs"], plain,
                              bits)
        f32 = out.get("f32", run)["accuracy"]
        check(abs(run["accuracy"] - f32) <= TEXT_ACC_GAP,
              f"text[{encoder}/{tag}]: accuracy {run['accuracy']:.4f} is "
              f"more than {TEXT_ACC_GAP} from f32's {f32:.4f}")
        run["bytes"] = weight_bytes(im._params)
        n = len(data["y_test"])
        say(f"text[{encoder}/{tag}]: {n} held-out documents in "
            f"{run['forwards']} forwards of {TEXT_BATCH}: accuracy "
            f"{run['accuracy']:.4f}; {n / run['wall_s']:.0f} documents/s "
            f"under the trace (host clock, a reading); launches on the card "
            f"= by the wrappers: " + ", ".join(
                f"{k} {run['card'][k]}" for k in run["card"])
            + f"; weight bytes {run['bytes']}"
            + ("" if bits == 0 else "; vs the plain route "
               + ("bitwise equal" if bits == 8 else
                  f"max abs err {err:.3e}")))
        run.pop("probs")
        out[tag] = run
        del im, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def check_text_records(tag: str, run: dict, ref, bits: int) -> None:
    """Every record answered with a top-5 of its document's probabilities:
    int8 the plain route's top-5 bit for bit, f32 and int4 each
    log-probability within IMAGE_LOGP_TOL of the plain route's; every
    forward's bucket warmed; the launches as TEXT_LAUNCHES says."""
    check(run["dead_lettered"] == 0, f"{tag}: records quarantined")
    ref_logp = np.log(ref.astype(np.float64))
    worst = 0.0
    for i, rid in enumerate(run["rids"]):
        r = run["results"].get(rid)
        check(r is not None and "value" in r
              and len(r["value"]) == min(5, ref.shape[-1]),
              f"{tag} {rid}: no top-5 ({r})")
        cls = [int(c) for c, _ in r["value"]]
        p = np.asarray([v for _, v in r["value"]], np.float32)
        if bits == 8:
            want = default_postprocess(ref[i])
            check(r["value"] == want,
                  f"{tag} {rid}: top-5 {r['value']} not bitwise the plain "
                  f"route's {want}")
        err = float(np.abs(np.log(p.astype(np.float64))
                           - ref_logp[i, cls]).max())
        worst = max(worst, err)
        if bits != 8:
            tol = IMAGE_LOGP_TOL["f32" if bits == 0 else "int4"]
            check(err <= tol, f"{tag} {rid}: log-prob error {err:.3e} > "
                              f"{tol}")
    fw = run["forwards"]
    check(run["warm_hits"] == fw > 0,
          f"{tag}: {run['warm_hits']} of {fw} forwards found their bucket "
          f"warm")
    check_text_launches(tag, run, TEXT_LAUNCHES["cnn"][
        tag.split("/")[-1].rstrip("]")])
    n = len(run["rids"])
    say(f"{tag}: warm-up {run['warm']['total']} buckets in "
        f"{run['warm']['seconds']:.3f} s; {len(run['results'])}/{n} records "
        f"served in {run['wall_s']:.3f} s = {n / run['wall_s']:.2f} "
        f"records/s, e2e p50 {run['e2e_p50_s'] * 1e3:.1f} ms (under the "
        f"trace); {fw} forwards, each of a warmed bucket; launches on the "
        f"card = by the wrappers: " + ", ".join(
            f"{k} {run['card'][k]}" for k in run["card"])
        + f"; top-5 log-prob max err vs the plain route {worst:.3e}")


def text_records_phase(params: dict, data: dict, dev) -> dict:
    """The cnn classifier served by ClusterServing over TEXT_RECORDS tensor
    records of held-out ids, in f32, int8 (``quantize`` calibrated from a
    ``.npy`` of TextSet batches) and int4."""
    X = data["x_test"][:TEXT_RECORDS]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        calib = os.path.join(tmp, "calib.npy")
        np.save(calib, data["x"][:TEXT_CALIB_BATCHES * TEXT_BATCH])
        for tag, spec, bits in (("f32", None, 0),
                                ("int8", {"bits": 8, "calib": calib}, 8),
                                ("int4", "int4", 4)):
            model = TextClassifier(**TEXT_CLS, device=dev).model
            im = InferenceModel(max_batch=TEXT_SERVE_BATCH, device=dev) \
                .do_load_model(model, params)
            run = serve_predict(im, X, ServingParams(
                batch_size=TEXT_SERVE_BATCH, max_wait_ms=2.0, quantize=spec,
                warmup={"max_batch": TEXT_SERVE_BATCH, "scales": "off"}),
                kernels=("w8a8", "w4a16", "w8a8_conv"))
            ref = route_probs(im, X, "torch", TEXT_SERVE_BATCH)
            check_text_records(f"text served[cnn/{tag}]", run, ref, bits)
            out[tag] = run
            del im, model
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def check_text_train(encoder: str, run: dict, acc_min: float) -> None:
    ls = run["losses"]
    check(all(math.isfinite(v) for v in ls)
          and all(b < a for a, b in zip(ls, ls[1:])),
          f"text[{encoder}] train: the per-epoch loss did not fall ({ls})")
    check(run["accuracy"] >= acc_min,
          f"text[{encoder}] train: held-out accuracy {run['accuracy']:.4f} "
          f"< {acc_min}")
    say(f"text[{encoder}] train: losses {[round(v, 4) for v in ls]}, "
        f"held-out accuracy {run['accuracy']:.4f} (loss "
        f"{run['eval_loss']:.4f}); {run['steps']} steps of {TEXT_BATCH} in "
        f"{run['wall_s']:.3f} s = {run['wall_s'] / run['steps'] * 1e3:.3f} "
        f"ms/step, {run['steps'] * TEXT_BATCH / run['wall_s']:.0f} "
        f"documents/s (host clock)")


def classifier_phase(seed: int, dev) -> dict:
    """(b): TextClassifier at news20 width: cnn trained and evaluated,
    lstm and gru stepped; all three served in f32 / int8 / int4; the cnn
    one also through ClusterServing."""
    data = text_data(seed)
    say(f"text data: {TEXT_TRAIN} + {TEXT_TEST} documents of "
        f"{TEXT_CLS['class_num']} topics through TextSet (tokenize, "
        f"normalize, word2idx of {data['words']} words, shape_sequence("
        f"{TEXT_CLS['sequence_length']})) in {data['seconds']:.2f} s (host)")
    out = {}
    for encoder in ("cnn", "lstm", "gru"):
        t0 = time.perf_counter()
        tc = text_classifier(encoder, data, dev, seed)
        if encoder == "cnn":
            check(tc.model.param_count() == TEXT_CLS_PARAMS
                  and dense_shapes(tc.model) == TEXT_DENSE["classifier"],
                  f"text: {tc.model.param_count()} params, Dense shapes "
                  f"{dense_shapes(tc.model)}")
            say(f"model: TextClassifier({TEXT_CLS}, encoder=cnn) "
                f"({TEXT_CLS_PARAMS} params) from seed {seed}, a seeded "
                f"embedding table in GloVe's place")
            run = text_train(tc, data, seed)
            check_text_train(encoder, run, TEXT_ACC_MIN)
        else:
            run = text_train(tc, data, seed, steps=TEXT_RNN_STEPS)
            check(all(math.isfinite(v) for v in run["losses"]),
                  f"text[{encoder}] train: loss {run['losses']}")
            say(f"text[{encoder}] train: {run['steps']} steps of "
                f"{TEXT_BATCH} ({TEXT_CLS['sequence_length']} Python time "
                f"steps each way), loss {run['losses'][-1]:.4f}, "
                f"{run['wall_s'] / run['steps'] * 1e3:.1f} ms/step (host "
                f"clock)")
        params = numpy_tree(export_params(tc.model))
        run["served"] = text_serve(encoder, params, data, dev,
                                   None if encoder == "cnn"
                                   else TEXT_RNN_SERVE)
        if encoder == "cnn":
            run["records"] = text_records_phase(params, data, dev)
        say(f"text[{encoder}]: {time.perf_counter() - t0:.2f} s, trained "
            f"and served")
        out[encoder] = run
        del tc
    return out


# -- the taggers ------------------------------------------------------------

def ner_data(seed: int, n: int, shift: int = 0) -> dict:
    """Seeded sentences of 8-40 tokens: entity spans of 1-3 words of one
    type (each type's NER_ENTITY_WORDS words; B- then I- tags) with
    probability NER_SPAN_P at each position, otherwise an O word drawn
    by a Zipf law over the rest of the vocabulary; a span is followed by
    an O word.  Each word id has a fixed spelling of 2-12 characters."""
    V, L = NER_GEO["word_vocab_size"], NER_LEN
    g = np.random.default_rng(seed + 400)
    spell_len = g.integers(2, NER_GEO["word_length"] + 1, V)
    spell = g.integers(1, NER_GEO["char_vocab_size"],
                       (V, NER_GEO["word_length"]))
    spell[np.arange(NER_GEO["word_length"])[None, :] >= spell_len[:, None]] \
        = 0
    spell[0] = 0
    first_o = 1 + 4 * NER_ENTITY_WORDS
    zipf = 1.0 / np.arange(1, V - first_o + 1)
    zipf /= zipf.sum()
    g = np.random.default_rng(seed + 401 + shift)
    # the draws in bulk, consumed in order: span or not, its kind, length
    # and words, the O words
    span_at = g.random((n, L)) < NER_SPAN_P
    kinds = g.integers(0, 4, (n, L))
    spans = g.integers(1, 4, (n, L))
    members = g.integers(0, NER_ENTITY_WORDS, (n, L, 3))
    o_words = first_o + g.choice(V - first_o, (n, L), p=zipf)
    lengths = g.integers(8, L + 1, n)
    words = np.zeros((n, L), np.int64)
    tags = np.zeros((n, L), np.int64)
    for i in range(n):
        length, t = int(lengths[i]), 0
        while t < length:
            if span_at[i, t]:
                kind = int(kinds[i, t])
                span = min(int(spans[i, t]), length - t)
                words[i, t:t + span] = 1 + kind * NER_ENTITY_WORDS \
                    + members[i, t, :span]
                tags[i, t] = 1 + 2 * kind
                tags[i, t + 1:t + span] = 2 + 2 * kind
                t += span
            if t < length:
                words[i, t] = o_words[i, t]
            t += 1
    return {"x": [words.astype(np.float32),
                  spell[words].astype(np.float32)],
            "y": tags.astype(np.float32), "lengths": (words > 0).sum(1)}


def entity_spans(tags, length: int) -> set:
    """(start, end, type) of every BIO span in ``tags[:length]``; an I-
    that does not continue a span of its type starts one."""
    spans, start, kind = set(), None, None
    for i in range(length + 1):
        tag = int(tags[i]) if i < length else 0
        cont = tag > 0 and tag % 2 == 0 and kind == (tag - 1) // 2
        if start is not None and not cont:
            spans.add((start, i, kind))
            start = kind = None
        if tag > 0 and not cont:
            start, kind = i, (tag - 1) // 2
    return spans


def ner_scores(pred, data: dict) -> dict:
    """Token accuracy over the valid tokens and entity-span F1 of the
    paths ``pred`` against the data's tags."""
    y = data["y"].astype(np.int64)
    valid = np.arange(y.shape[1])[None, :] < data["lengths"][:, None]
    acc = float((pred == y)[valid].mean())
    tp = n_pred = n_gold = 0
    for p, t, n in zip(pred, y, data["lengths"]):
        ps, ts = entity_spans(p, int(n)), entity_spans(t, int(n))
        tp += len(ps & ts)
        n_pred += len(ps)
        n_gold += len(ts)
    prec, rec = tp / max(n_pred, 1), tp / max(n_gold, 1)
    return {"accuracy": acc, "precision": prec, "recall": rec,
            "f1": 2 * prec * rec / max(prec + rec, 1e-12)}


def ner_phase(seed: int, dev, f1_min: float = NER_F1_MIN) -> dict:
    """(c): NER at the reference's widths trained for NER_EPOCHS epochs
    (Adam 1e-3, batch 32, the CRF loss), then ``predict``'s Viterbi paths
    scored on held-out sentences."""
    train = ner_data(seed, NER_TRAIN)
    test = ner_data(seed, NER_TEST, shift=1)
    ner = NER(**NER_GEO, device=dev,
              ctx=ZooContext(ZooConf(seed=seed, device=str(dev))))
    ner.estimator._obs_registry = MetricsRegistry()
    ner.model.init_weights(seed)
    n_params = ner.model.param_count()
    say(f"model: NER({NER_GEO}) ({n_params} params) from seed {seed}; "
        f"{NER_TRAIN} training and {NER_TEST} held-out sentences of up to "
        f"{NER_LEN} tokens, tags {NER_TAGS}")
    losses = []
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(NER_EPOCHS):
        hist = ner.fit(train["x"], train["y"], batch_size=NER_BATCH,
                       epochs=1, verbose=False,
                       steps_per_call=ZOO_STEPS_PER_CALL)
        losses.append(hist.history["loss"][-1])
    sync(dev)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = ner.predict(test["x"], batch_size=NER_BATCH)
    t_pred = time.perf_counter() - t0
    check(pred.shape == (NER_TEST, NER_LEN) and pred.dtype == np.int32
          and ((pred >= 0) & (pred < len(NER_TAGS))).all(),
          f"ner: predict gave {pred.shape} {pred.dtype}")
    s = ner_scores(pred, test)
    check(all(math.isfinite(v) for v in losses)
          and all(b < a for a, b in zip(losses, losses[1:])),
          f"ner train: the per-epoch loss did not fall ({losses})")
    check(s["f1"] >= f1_min, f"ner: entity F1 {s['f1']:.4f} < {f1_min}")
    steps = NER_EPOCHS * -(-NER_TRAIN // NER_BATCH)
    say(f"ner train: losses {[round(v, 4) for v in losses]}; {steps} steps "
        f"of {NER_BATCH} in {wall:.3f} s = {wall / steps * 1e3:.2f} ms/step "
        f"(host clock, {ZOO_STEPS_PER_CALL} steps a call); Viterbi paths of {NER_TEST} held-out sentences in "
        f"{t_pred:.3f} s: token accuracy {s['accuracy']:.4f}, entity "
        f"precision {s['precision']:.4f}, recall {s['recall']:.4f}, F1 "
        f"{s['f1']:.4f} (threshold {f1_min})")
    return {"losses": losses, **s, "ms_step": wall / steps * 1e3,
            "params": n_params}


def tagger_data(seed: int, kind: str) -> dict:
    """TAGGER_ROWS NER-style sentences relabelled: SequenceTagger's POS
    tag is the word's id mod 45 and its chunk tag the POS tag's mod 23;
    IntentEntity's intent is the first word's id mod 7 and a word's slot
    its id mod 72 (0 on padding)."""
    d = ner_data(seed, TAGGER_ROWS, shift=2)
    w = d["x"][0].astype(np.int64)
    if kind == "pos":
        pos = w % TAGGER_POS
        y = np.stack([pos, pos % TAGGER_CHUNK], -1)
    else:
        y = np.concatenate([w[:, :1] % INTENTS, w % SLOTS], 1)
    return {"x": d["x"], "y": y.astype(np.float32)}


def taggers_phase(seed: int, dev) -> dict:
    """(d): SequenceTagger and IntentEntity at the same trunk's widths,
    trained TAGGER_EPOCHS epochs over TAGGER_ROWS sentences: the loss
    on them falls."""
    out = {}
    geo = {k: v for k, v in NER_GEO.items() if k != "num_entities"}
    for kind, build in (
            ("pos", lambda **kw: SequenceTagger(TAGGER_POS, TAGGER_CHUNK,
                                                **geo, **kw)),
            ("intent", lambda **kw: IntentEntity(INTENTS, SLOTS, **geo,
                                                 **kw))):
        data = tagger_data(seed, kind)
        m = build(device=dev, ctx=ZooContext(ZooConf(seed=seed,
                                                     device=str(dev))))
        m.estimator._obs_registry = MetricsRegistry()
        m.model.init_weights(seed)
        before = m.estimator.evaluate(data["x"], data["y"],
                                      batch_size=NER_BATCH)["loss"]
        sync(dev)
        t0 = time.perf_counter()
        m.fit(data["x"], data["y"], batch_size=NER_BATCH,
              epochs=TAGGER_EPOCHS, verbose=False)
        sync(dev)
        wall = time.perf_counter() - t0
        after = m.estimator.evaluate(data["x"], data["y"],
                                     batch_size=NER_BATCH)["loss"]
        name = type(m).__name__
        check(math.isfinite(after) and after < before,
              f"{name}: the loss did not fall ({before:.4f} -> "
              f"{after:.4f})")
        steps = TAGGER_EPOCHS * -(-TAGGER_ROWS // NER_BATCH)
        say(f"{name}: {steps} steps of {NER_BATCH}: loss on its "
            f"{TAGGER_ROWS} sentences {before:.4f} -> {after:.4f}; "
            f"{wall / steps * 1e3:.2f} ms/step (host clock)")
        out[kind] = {"before": before, "after": after}
    return out


# -- KNRM ---------------------------------------------------------------------

def knrm_pairs(seed: int, n: int):
    """``n`` (question, answer, label) rows: questions of content words
    (uniform over the vocabulary), answers of words drawn by a Zipf law
    (the frequent ones stand for function words); half the answers
    relevant (2-5 of the question's words placed in them), half not."""
    Tq, Td, V = (KNRM_GEO[k] for k in ("text1_length", "text2_length",
                                        "vocab_size"))
    g = np.random.default_rng(seed + 500)
    zipf = 1.0 / np.arange(1, V)
    zipf /= zipf.sum()
    q = g.integers(1, V, (n, Tq))
    d = 1 + g.choice(V - 1, (n, Td), p=zipf)
    rel = g.random(n) < 0.5
    for i in np.nonzero(rel)[0]:
        k = int(g.integers(2, min(6, Tq + 1)))
        d[i, g.choice(Td, k, replace=False)] = q[i, g.choice(Tq, k,
                                                              replace=False)]
    return q.astype(np.float32), d.astype(np.float32), \
        rel.astype(np.float32)[:, None]


def knrm_groups(seed: int) -> list:
    """KNRM_GROUPS held-out (question, answers, labels) groups of
    KNRM_CANDIDATES answers, 1-3 of them relevant."""
    q, d, _ = knrm_pairs(seed + 1, KNRM_GROUPS * KNRM_CANDIDATES)
    Tq, Td = KNRM_GEO["text1_length"], KNRM_GEO["text2_length"]
    g = np.random.default_rng(seed + 501)
    groups = []
    for i in range(KNRM_GROUPS):
        qi = q[i * KNRM_CANDIDATES]
        docs = d[i * KNRM_CANDIDATES:(i + 1) * KNRM_CANDIDATES].copy()
        labels = np.zeros(KNRM_CANDIDATES)
        for j in g.choice(KNRM_CANDIDATES, int(g.integers(1, 4)),
                          replace=False):
            k = int(g.integers(2, min(6, Tq + 1)))
            docs[j, g.choice(Td, k, replace=False)] = qi[g.choice(
                Tq, k, replace=False)]
            labels[j] = 1.0
        groups.append((qi, docs, labels))
    return groups


class GroupScores:
    """What ``evaluate_ndcg`` / ``evaluate_map`` call: one group's scores
    a ``predict``, cut in turn from one batched ``do_predict`` of every
    group's candidates; each call's question and answers must be the
    group's."""

    def __init__(self, groups, scores):
        self.groups, self.scores, self.calls = groups, scores, 0

    def predict(self, x, batch_size=None):
        g = self.calls % len(self.groups)
        self.calls += 1
        q, docs, _ = self.groups[g]
        check(np.array_equal(x[0][0], q) and np.array_equal(x[1], docs),
              f"knrm: ranking call {self.calls} is not group {g}'s")
        n = len(docs)
        return self.scores[g * n:(g + 1) * n]


def knrm_candidates(groups):
    """Every group's (question, answer) pairs, group by group."""
    return [np.concatenate([np.repeat(q[None], len(d), 0)
                            for q, d, _ in groups]),
            np.concatenate([d for _, d, _ in groups])]


def knrm_rank(im, groups) -> dict:
    """Every group's candidates scored through ``im`` (batches of
    KNRM_BATCH) with the counts set to 0 just before and read just after,
    under a profiler trace of the card; then NDCG@3 and MAP of those
    scores by ``evaluate_ndcg`` / ``evaluate_map``."""
    x = knrm_candidates(groups)
    sync(im.device)
    st0 = im.aot_stats()
    reset_launches()
    with _impl.card_launches(("w8a8", "w4a16", "w8a8_conv")) as card:
        t0 = time.perf_counter()
        scores = im.do_predict(x, batch_size=KNRM_BATCH)
        sync(im.device)
        wall = time.perf_counter() - t0
    st = im.aot_stats()
    ranker = GroupScores(groups, scores)
    ndcg = evaluate_ndcg(ranker, groups, k=3, batch_size=KNRM_CANDIDATES)
    mp = evaluate_map(ranker, groups, batch_size=KNRM_CANDIDATES)
    check(ranker.calls == 2 * len(groups), f"knrm: {ranker.calls} ranking "
                                           f"calls for {len(groups)} groups")
    return {"ndcg": ndcg, "map": mp, "scores": scores, "x": x,
            "wall_s": wall, "card": card,
            "wrapper": {"w8a8": qm.launches_w8a8, "w4a16": qm.launches_w4a16,
                        "w8a8_conv": qm.launches_conv},
            "forwards": sum(st["programs"].values())
            - sum(st0["programs"].values())}


def knrm_phase(seed: int, dev, ndcg_min: float = KNRM_NDCG_MIN,
               map_min: float = KNRM_MAP_MIN) -> dict:
    """(e): KNRM at WikiQA's widths trained (binary cross-entropy, Adam)
    on seeded question-answer pairs, then ranking held-out groups in f32,
    int8 and int4 through InferenceModel."""
    q, d, y = knrm_pairs(seed, KNRM_TRAIN)
    groups = knrm_groups(seed)
    kn = KNRM(**KNRM_GEO, device=dev)
    kn.init_weights(seed)
    say(f"model: KNRM({KNRM_GEO}) ({kn.model.param_count()} params) from "
        f"seed {seed}; {KNRM_TRAIN} training pairs, {KNRM_GROUPS} held-out "
        f"groups of {KNRM_CANDIDATES} answers")
    est = Estimator(kn.model, optimizer=Adam(lr=KNRM_LR),
                    loss="binary_crossentropy", registry=MetricsRegistry(),
                    ctx=ZooContext(ZooConf(seed=seed, device=str(dev))))
    sync(dev)
    t0 = time.perf_counter()
    hist = est.fit([q, d], y, batch_size=KNRM_BATCH, epochs=KNRM_EPOCHS,
                   verbose=False)
    sync(dev)
    wall = time.perf_counter() - t0
    ls = hist.history["loss"]
    check(all(math.isfinite(v) for v in ls)
          and all(b < a for a, b in zip(ls, ls[1:])),
          f"knrm train: the per-epoch loss did not fall ({ls})")
    steps = KNRM_EPOCHS * -(-KNRM_TRAIN // KNRM_BATCH)
    say(f"knrm train: losses {[round(v, 4) for v in ls]}; {steps} steps of "
        f"{KNRM_BATCH} in {wall:.3f} s = {wall / steps * 1e3:.2f} ms/step "
        f"(host clock)")
    params = numpy_tree(export_params(kn.model))
    calib = [(q[:KNRM_BATCH], d[:KNRM_BATCH])]
    out = {"losses": ls}
    for tag, bits in (("f32", 0), ("int8", 8), ("int4", 4)):
        model = KNRM(**KNRM_GEO, device=dev).model
        im = InferenceModel(max_batch=KNRM_BATCH, device=dev) \
            .do_load_model(model, params)
        if bits:
            im.do_quantize(calib if bits == 8 else None, bits=bits,
                           force=True, group_size=64)
        run = knrm_rank(im, groups)
        check_text_launches(f"knrm[{tag}]", run, TEXT_LAUNCHES["knrm"][tag])
        err = 0.0
        if bits:
            plain = route_probs(im, run["x"], "torch", KNRM_BATCH)
            err = check_route(f"knrm[{tag}]", run["scores"], plain, bits)
        if tag == "f32":
            check(run["ndcg"] >= ndcg_min and run["map"] >= map_min,
                  f"knrm: NDCG@3 {run['ndcg']:.4f} (min {ndcg_min}), MAP "
                  f"{run['map']:.4f} (min {map_min})")
        f32 = out.get("f32", run)
        check(abs(run["ndcg"] - f32["ndcg"]) <= KNRM_GAP
              and abs(run["map"] - f32["map"]) <= KNRM_GAP,
              f"knrm[{tag}]: NDCG@3 {run['ndcg']:.4f} / MAP "
              f"{run['map']:.4f} more than {KNRM_GAP} from f32's")
        say(f"knrm[{tag}]: {KNRM_GROUPS} groups' {len(run['scores'])} "
            f"candidates scored in {run['forwards']} forwards of "
            f"{KNRM_BATCH}: NDCG@3 {run['ndcg']:.4f}, MAP {run['map']:.4f}; "
            f"{run['wall_s']:.3f} s (host clock, under the trace); launches "
            f"on the card = by the wrappers: w8a8 "
            f"{run['card']['w8a8']}, w4a16 {run['card']['w4a16']}; weight "
            f"bytes {weight_bytes(im._params)}"
            + ("" if bits == 0 else "; vs the plain route "
               + ("bitwise equal" if bits == 8 else
                  f"max abs err {err:.3e}")))
        run.pop("scores")
        run.pop("x")
        out[tag] = run
        del im, model
    return out


def text_phase(seed: int, records: dict) -> None:
    """Phase 10: w8a8_conv2d at the one-row geometries of a 1-D conv and
    the w8a8 / w4a16 kernels at the text heads' shapes; TextClassifier at
    news20 width trained and served in f32, int8 and int4 (InferenceModel
    and ClusterServing); NER trained and decoded; SequenceTagger and
    IntentEntity stepped; KNRM trained and ranking."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    text_conv_bound_check(TEXT_CONV)
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t0, 2)
        return out
    kt = timed("kernels", text_kernel_phase, seed)
    cls = timed("classifier", classifier_phase, seed, dev)
    ner = timed("ner", ner_phase, seed, dev)
    timed("taggers", taggers_phase, seed, dev)
    knrm = timed("knrm", knrm_phase, seed, dev)
    rec = records["w8a8_conv2d"]
    rec["text_launches"] = {
        "classifier": cls["cnn"]["served"]["int8"]["card"]["w8a8_conv"],
        "served": cls["cnn"]["records"]["int8"]["card"]["w8a8_conv"]}
    t = kt["conv"]
    rec["text_conv"] = {"x": list(TEXT_CONV[0]), "k": list(TEXT_CONV[1]),
                        **{k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")}}
    for name, bits_tag in (("w8a8", "int8"), ("w4a16", "int4")):
        rec = records[name]
        rec["text_launches"] = {
            enc: cls[enc]["served"][bits_tag]["card"][name]
            for enc in ("cnn", "lstm", "gru")}
        rec["text_launches"]["served"] = \
            cls["cnn"]["records"][bits_tag]["card"][name]
        rec["text_launches"]["knrm"] = knrm[bits_tag]["card"][name]
        keys = ("ms", "plain_ms", "bound_ms") + (
            ("library_ms",) if name == "w8a8" else ())
        rec["text_shapes"] = {"x".join(map(str, mkn)): {
            k: v[k] for k in keys} for mkn, v in kt[name].items()}
    rec = records["w4a16"]
    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0),
                             kt["w4_max_abs_err"])
    say(f"text: phase wall {time.perf_counter() - t_phase:.2f} s ({walls} "
        f"s; NER F1 {ner['f1']:.4f})")


# -- phase 11: zouwu's forecasters and automl ---------------------------------

# NAB realKnownCause/nyc_taxi.csv's length and cadence: 10,320 half-hourly
# points from 2014-07-01 (the file is not in the repository: a seeded
# surrogate with its daily and weekly seasonality stands in)
FORECAST_POINTS = 10320
FORECAST_START = "2014-07-01"
FORECAST_FREQ = "30min"
FORECAST_DAY = 48
FORECAST_NOISE = 2500.0
# the first 80% train, the next 10% validate, the last 10% test
FORECAST_TRAIN, FORECAST_VAL = 0.8, 0.1
# AutoTS: LSTMGridRandomRecipe's own grid (lstm_1_units drawn from 16-128,
# lstm_2_units 16 / 32 / 64 x batch 32 / 64, parallelism 2) with epochs
# cut from its default 5 to 1
FORECAST_RECIPE = dict(epochs=1)
FORECAST_TRIALS = 6
# the parallelism-1 repeat of the search trains the grid's first configs
AUTOTS_REPEAT_TRIALS = 2
# the pipeline's test MSE over the better of the persistence and the
# seasonal-naive forecast's must not exceed this.  The JAX package's CPU
# runs of the same protocol (``forecast_reference.py``, context seeds
# 0-2) read 0.8416, 0.6227 and 0.7106: the limit sits above the largest
# of them, and below 1, so the pipeline beats both
FORECAST_RATIO_MAX = 0.95
# MTNetForecaster at the JAX defaults, 2 epochs at batch 64
MTNET = dict(lookback=16, long_num=3, cnn_filters=32, cnn_kernel=3,
             uni_size=32, ar_window=4)
MTNET_EPOCHS, MTNET_BATCH, MTNET_LR = 2, 64, 1e-3
# the MTNetSmokeRecipe fit trains on the first six weeks (cut)
MTNET_SMOKE_POINTS = 2016
SEQ2SEQ_FORECAST_STEPS = 16
# PopulationTrainer: K = 8 LSTMForecaster-shaped members (lookback 8,
# LSTM 16 / 8, dropout 0.2), lrs log-spaced over 1e-3 to 3e-2
POP_K, POP_LR_RANGE = 8, (1e-3, 3e-2)
POP_EPOCHS, POP_BATCH = 2, 64
# the best member's eval-mode MSE over the training windows in a plain
# model against its reported final loss, relative.  The reported loss is
# the mean of the last epoch's training-mode step losses (dropout 0.2 on,
# the weights moving through the epoch), so the two differ by more than
# rounding; the plain model's MSE must also fall below its MSE at the
# member's initial weights
POP_REPRO_RTOL = 0.75
FORECAST_BATCH = 1024
FORECAST_RECORDS, FORECAST_SERVE_BATCH = 64, 16
# the (K, N) of the forecasting heads: the AutoTS grid's lstm_2_units onto
# a horizon of 1, LSTMForecaster's default lstm_2_units 8, Seq2Seq's
# latent 32
FORECAST_DENSE = ((16, 1), (32, 1), (64, 1), (8, 1))
FORECAST_M = (1, 32, 64, FORECAST_BATCH)


def forecast_series(seed: int, n: int = 0):
    """``n`` half-hourly points from FORECAST_START: a level of 15,000
    (nyc_taxi's passengers a half hour), daily and weekly seasonality and
    i.i.d. noise of FORECAST_NOISE (a learnable surrogate: a forecaster
    can average noise that the naive forecasts carry twice), as a
    ``datetime`` / ``value`` frame."""
    import pandas as pd
    n = n or FORECAST_POINTS
    g = np.random.default_rng(seed + 170)
    day = 2 * np.pi * np.arange(n) / FORECAST_DAY
    value = (15000 + 7000 * np.sin(day - 2.0) + 1500 * np.sin(2 * day)
             + 2500 * np.sin(day / 7) + g.normal(0.0, FORECAST_NOISE, n))
    return pd.DataFrame({
        "datetime": pd.date_range(FORECAST_START, periods=n,
                                  freq=FORECAST_FREQ),
        "value": value})


def forecast_split(df):
    """(train, validation, test): the first FORECAST_TRAIN, the next
    FORECAST_VAL, the rest."""
    a = int(FORECAST_TRAIN * len(df))
    b = a + int(FORECAST_VAL * len(df))
    return df[:a], df[a:b], df[b:]


def naive_forecasts(df, test_start: int, lookback: int) -> dict:
    """The persistence (the previous value) and seasonal-naive (a day
    earlier) forecasts of the targets ``TSPipeline.evaluate`` scores over
    the test split (rows lookback.. of it): their MSE and sMAPE."""
    v = df["value"].to_numpy(np.float64)
    idx = np.arange(test_start + lookback, len(v))
    y = v[idx]
    out = {}
    for name, lag in (("persistence", 1), ("seasonal_naive", FORECAST_DAY)):
        p = v[idx - lag]
        out[name] = {"mse": float(np.mean((y - p) ** 2)),
                     "smape": float(100 * np.mean(
                         2 * np.abs(p - y) / (np.abs(p) + np.abs(y) + 1e-9)))}
    return out


def forecast_ratio(metrics: dict, naive: dict) -> float:
    """The pipeline's MSE over the better naive forecast's."""
    return metrics["mse"] / min(n["mse"] for n in naive.values())


def check_forecast(tag: str, metrics: dict, naive: dict) -> float:
    """The pipeline beats both naive forecasts, its MSE at most
    FORECAST_RATIO_MAX of the better one's."""
    ratio_max = FORECAST_RATIO_MAX
    check(all(math.isfinite(v) for v in metrics.values()),
          f"{tag}: metrics {metrics}")
    ratio = forecast_ratio(metrics, naive)
    check(ratio <= ratio_max,
          f"{tag}: MSE {metrics['mse']:.1f} is {ratio:.4f} of the better "
          f"naive forecast's ({naive}), above {ratio_max}")
    return ratio


def autots_run(trainer_cls, recipe_cls, train, val, parallelism=None,
               **kw) -> dict:
    """``trainer_cls(dt_col="datetime", target_col="value", horizon=1,
    recipe=recipe_cls(**FORECAST_RECIPE))`` fit on ``train`` / ``val``
    (the JAX package's classes or the port's): the pipeline, each trial's
    config, validation MSE and training wall time, and the fit's wall."""
    recipe = recipe_cls(**FORECAST_RECIPE)
    if parallelism is not None:
        recipe.parallelism = parallelism
    trainer = trainer_cls(dt_col="datetime", target_col="value", horizon=1,
                          recipe=recipe, **kw)
    pred = trainer._predictor
    walls = []
    train_one = pred._train_one

    def timed(cfg, df):
        t0 = time.perf_counter()
        out = train_one(cfg, df)
        walls.append((json.dumps(cfg, sort_keys=True, default=str),
                      time.perf_counter() - t0))
        return out
    pred._train_one = timed
    t0 = time.perf_counter()
    pipe = trainer.fit(train, val)
    wall = time.perf_counter() - t0
    trial_walls = dict(walls[:-1])
    trials = [{"config": t.config, "mse": t.metric,
               "wall_s": trial_walls.get(json.dumps(
                   t.config, sort_keys=True, default=str))}
              for t in pred._last_trials]
    return {"pipeline": pipe, "trials": trials, "wall_s": wall,
            "retrain_s": walls[-1][1]}


def trial_steps(cfg: dict, n_rows: int) -> int:
    return int(cfg["epochs"]) * -(-n_rows // int(cfg["batch_size"]))


def check_grid(trials) -> None:
    """LSTMGridRandomRecipe's grid: lstm_units 16 / 32 / 64 x batch 32 /
    64, each with lstm_1_units drawn from 16-128."""
    check(len(trials) == FORECAST_TRIALS
          and sorted((t["config"]["lstm_units"], t["config"]["batch_size"])
                     for t in trials) == sorted(
              (u, b) for u in (16, 32, 64) for b in (32, 64))
          and all(t["config"]["lstm_1_units"] in (16, 32, 64, 128)
                  for t in trials),
          f"autots: the grid's trials {[t['config'] for t in trials]}")


def check_same_trials(two, one) -> None:
    """The trials at parallelism 1 are the first of those at 2: the same
    configs in the same order and bit for bit the same validation
    MSEs."""
    two = two[:len(one)]
    check([repr(t["config"]) for t in two] == [repr(t["config"])
                                               for t in one]
          and [t["mse"] for t in two] == [t["mse"] for t in one],
          f"autots: trial metrics at parallelism 2 {[t['mse'] for t in two]}"
          f" != at 1 {[t['mse'] for t in one]}")


class _TrialsDone(Exception):
    """Ends ``autots_repeat``'s search once its trials are trained, before
    the predictor retrains the best config."""

    def __init__(self, trials):
        super().__init__(len(trials))
        self.trials = trials


def autots_repeat(recipe_cls, train, val, n: int, **kw) -> dict:
    """The first ``n`` configs of the recipe's search trained again one at
    a time (parallelism 1) through the predictor's own trial function;
    the search ends there, without the best config's retrain."""
    from analytics_zoo_tpu_torch.automl.search import SearchEngine, Trial
    from analytics_zoo_tpu_torch.zouwu import AutoTSTrainer

    class FirstTrials(SearchEngine):
        def __init__(self, inner):
            super().__init__(inner.mode)
            self.inner = inner

        def run(self, train_fn, space):
            raise _TrialsDone([Trial(c, float(train_fn(c))) for c in
                               self.inner.sample_all(space)[:n]])

    class Recipe(recipe_cls):
        def engine(self):
            return FirstTrials(super().engine())

    recipe = Recipe(**FORECAST_RECIPE)
    recipe.parallelism = 1
    trainer = AutoTSTrainer(dt_col="datetime", target_col="value",
                            horizon=1, recipe=recipe, **kw)
    t0 = time.perf_counter()
    try:
        trainer.fit(train, val)
    except _TrialsDone as done:
        return {"trials": [{"config": t.config, "mse": t.metric}
                           for t in done.trials],
                "wall_s": time.perf_counter() - t0}
    raise AssertionError("autots: the repeat's search did not run")


def forecast_shapes():
    return list(FORECAST_DENSE)


def forecast_kernel_phase(seed: int) -> dict:
    """(a): ``w8a8`` bitwise (each weight exact and inside a buffer of
    127s) and ``w4a16`` within W4_TOL at FORECAST_M x the heads' (K, N);
    each (K, N) timed at M = FORECAST_BATCH beside ``torch._int_mm`` +
    scale (w8a8) and the plain version."""
    worst = reco_parity(seed + 11, FORECAST_M, forecast_shapes())
    say(f"forecast parity: w8a8 bitwise (each weight exact and inside "
        f"127s) and w4a16 within {W4_TOL} (max err {worst:.3e}) at M "
        f"{FORECAST_M} x (K, N) {forecast_shapes()}")
    m = FORECAST_BATCH
    keys8 = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    keys4 = ("ms", "plain_ms", "bound_ms", "bound_by")
    shapes = {}
    for k, n in forecast_shapes():
        w8 = w8a8_timing(seed + 7, m, k, n, plain=True)
        w4 = w4a16_timing(seed + 7, m, k, n, 64, torch.float32)
        shapes[f"{m}x{k}x{n}"] = {"w8a8": {key: w8[key] for key in keys8},
                                  "w4a16": {key: w4[key] for key in keys4}}
    return {"w4_max_abs_err": worst, "shapes": shapes}


def autots_phase(seed: int, dev, data: dict) -> dict:
    """(b): AutoTS over the nyc_taxi-length series: LSTMGridRandomRecipe's
    grid at parallelism 2, each trial's config, validation MSE and wall;
    TSPipeline.evaluate on the test split beside the persistence and
    seasonal-naive forecasts; save / load predicting bit for bit; the same
    trials at parallelism 1 with identical metrics."""
    from analytics_zoo_tpu_torch.automl import LSTMGridRandomRecipe
    from analytics_zoo_tpu_torch.zouwu import AutoTSTrainer, TSPipeline
    train, val, test = data["train"], data["val"], data["test"]
    run = autots_run(AutoTSTrainer, LSTMGridRandomRecipe, train, val,
                     parallelism=2, device=dev)
    rows = len(train) - 8
    for i, t in enumerate(run["trials"]):
        c = t["config"]
        steps = trial_steps(c, rows)
        say(f"autots[parallelism 2] trial {i}: lstm_1_units "
            f"{c['lstm_1_units']}, lstm_units {c['lstm_units']}, batch "
            f"{c['batch_size']}, lr {c['lr']:.5f}, dropout "
            f"{c['dropout']:.3f}, features {list(map(str, c.get('selected_features', [])))}: "
            f"validation MSE {t['mse']:.6f}; trained in "
            f"{t['wall_s']:.3f} s = {t['wall_s'] / steps * 1e3:.2f} "
            f"ms/step over {steps} steps (host clock)")
    say(f"autots[parallelism 2]: {len(run['trials'])} trials + the best "
        f"retrained ({run['retrain_s']:.3f} s) in {run['wall_s']:.3f} s")
    two = run["trials"]
    check_grid(two)
    # the repeat at parallelism 1 trains only the grid's first configs:
    # its pipeline would go unused (quality and save / load are judged on
    # the run above)
    one = autots_repeat(LSTMGridRandomRecipe, train, val,
                        AUTOTS_REPEAT_TRIALS, device=dev)
    check_same_trials(two, one["trials"])
    say(f"autots[parallelism 1]: the grid's first {AUTOTS_REPEAT_TRIALS} "
        f"configs trained again in {one['wall_s']:.3f} s, no retrain; their "
        f"validation MSEs equal those at parallelism 2 exactly")
    pipe = run["pipeline"]
    cfg = pipe._p.config
    metrics = pipe.evaluate(test, ("mse", "smape"))
    naive = naive_forecasts(data["df"], len(train) + len(val),
                            int(cfg["lookback"]))
    ratio = check_forecast("autots", metrics, naive)
    say(f"autots: best config lstm_1_units {cfg['lstm_1_units']}, "
        f"lstm_units {cfg['lstm_units']}, batch {cfg['batch_size']}; test "
        f"MSE {metrics['mse']:.1f}, sMAPE {metrics['smape']:.4f}; "
        f"persistence MSE {naive['persistence']['mse']:.1f}, sMAPE "
        f"{naive['persistence']['smape']:.4f}; seasonal-naive MSE "
        f"{naive['seasonal_naive']['mse']:.1f}, sMAPE "
        f"{naive['seasonal_naive']['smape']:.4f}; ratio to the better "
        f"{ratio:.4f} (limit {FORECAST_RATIO_MAX})")
    path = os.path.join(data["tmp"], "pipeline")
    pipe.save(path)
    back = TSPipeline.load(path, device=dev)
    want = pipe.predict(test)
    got = back.predict(test)
    check(got.shape == want.shape and np.array_equal(got, want),
          f"autots: the reloaded pipeline's predictions part from the "
          f"saved one's (max abs err "
          f"{float(np.abs(got - want).max()) if got.shape == want.shape else 'shape'})")
    say(f"autots: TSPipeline.save / load round trip, {len(got)} "
        f"predictions bit for bit equal")
    return {"pipeline": pipe, "path": path, "metrics": metrics,
            "naive": naive, "ratio": ratio,
            "trials": [{k: v for k, v in t.items() if k != "config"}
                       for t in two]}


def forecasters_phase(seed: int, dev, data: dict) -> dict:
    """(c): MTNetForecaster at the JAX defaults trained (the loss falls);
    one TimeSequencePredictor fit with MTNetSmokeRecipe; Seq2SeqForecaster
    stepped; PopulationTrainer with POP_K LSTMForecaster-shaped members
    (each member's loss falls; the best member's parameters in a plain
    model reproduce its final loss within POP_REPRO_RTOL)."""
    from analytics_zoo_tpu_torch.automl import (
        MTNetSmokeRecipe, PopulationTrainer, TimeSequenceFeatureTransformer,
        TimeSequencePredictor)
    from analytics_zoo_tpu_torch.zouwu import (
        LSTMForecaster, MTNetForecaster, Seq2SeqForecaster)
    train, val = data["train"], data["val"]
    out = {}
    ft = TimeSequenceFeatureTransformer()
    x16, y16 = ft.fit_transform(train, lookback=MTNET["lookback"])
    mt = MTNetForecaster(feature_dim=x16.shape[-1], **MTNET, device=dev)
    mt.init_weights(seed)
    mt.compile(Adam(lr=MTNET_LR), "mse")
    sync(dev)
    t0 = time.perf_counter()
    ls = mt.fit(x16, y16, batch_size=MTNET_BATCH, nb_epoch=MTNET_EPOCHS,
                steps_per_call=ZOO_STEPS_PER_CALL).history["loss"]
    sync(dev)
    wall = time.perf_counter() - t0
    steps = MTNET_EPOCHS * -(-len(x16) // MTNET_BATCH)
    check(all(math.isfinite(v) for v in ls) and ls[-1] < ls[0],
          f"mtnet: the loss did not fall ({ls})")
    out["mtnet_ms_per_step"] = wall / steps * 1e3
    say(f"mtnet: MTNetForecaster({MTNET}) ({mt.model.param_count()} params) "
        f"on {len(x16)} windows: losses {[round(v, 6) for v in ls]}, "
        f"{steps} steps in {wall:.3f} s = {out['mtnet_ms_per_step']:.2f} "
        f"ms/step (host clock, {ZOO_STEPS_PER_CALL} steps a call)")
    out["mtnet"] = mt
    out["mtnet_x"], _ = ft.transform(data["test"], lookback=MTNET["lookback"])
    p = TimeSequencePredictor(recipe=MTNetSmokeRecipe(), device=dev)
    t0 = time.perf_counter()
    pipe = p.fit(train[:MTNET_SMOKE_POINTS], val)
    wall = time.perf_counter() - t0
    trial = p._last_trials[0]
    check(pipe.config["model"] == "MTNet" and math.isfinite(trial.metric)
          and type(pipe.model.layers_list[0]).__name__ == "MTNetLayer",
          f"mtnet smoke: config {pipe.config}, metric {trial.metric}")
    say(f"mtnet smoke: TimeSequencePredictor(MTNetSmokeRecipe) on the first "
        f"{MTNET_SMOKE_POINTS} points: validation MSE {trial.metric:.6f}, "
        f"the MTNet branch of _build_trial_model, fit in {wall:.3f} s")
    ft8 = TimeSequenceFeatureTransformer()
    x8, y8 = ft8.fit_transform(train, lookback=8)
    n = SEQ2SEQ_FORECAST_STEPS * POP_BATCH
    s2s = Seq2SeqForecaster(feature_dim=x8.shape[-1], lookback=8,
                            device=dev)
    s2s.init_weights(seed)
    s2s.compile(Adam(lr=1e-3), "mse")
    sync(dev)
    t0 = time.perf_counter()
    ls = s2s.fit(x8[:n], y8[:n], batch_size=POP_BATCH,
                 nb_epoch=1).history["loss"]
    sync(dev)
    wall = time.perf_counter() - t0
    check(all(math.isfinite(v) for v in ls), f"seq2seq forecaster: {ls}")
    say(f"seq2seq forecaster: {SEQ2SEQ_FORECAST_STEPS} steps of "
        f"{POP_BATCH}, loss {ls[-1]:.6f}, "
        f"{wall / SEQ2SEQ_FORECAST_STEPS * 1e3:.2f} ms/step (host clock)")
    lrs = [float(v) for v in np.geomspace(*POP_LR_RANGE, POP_K)]
    members = LSTMForecaster(feature_dim=x8.shape[-1], lookback=8,
                             device=dev)
    sync(dev)
    t0 = time.perf_counter()
    pop = PopulationTrainer(members.model).fit(
        x8, y8, lrs, epochs=POP_EPOCHS, batch_size=POP_BATCH, seed=seed)
    sync(dev)
    wall = time.perf_counter() - t0
    losses = pop["losses"]
    check(losses.shape == (POP_EPOCHS, POP_K) and np.isfinite(losses).all()
          and bool((losses[-1] < losses[0]).all()),
          f"population: a member's loss did not fall ({losses.tolist()})")
    plain = LSTMForecaster(feature_dim=x8.shape[-1], lookback=8, device=dev)
    plain.init_weights(split_seed(seed, pop["best_index"]))
    start = float(np.mean((plain.predict(x8, batch_size=FORECAST_BATCH)
                           - y8) ** 2))
    plain.set_weights(pop["best_params"])
    pred = plain.predict(x8, batch_size=FORECAST_BATCH)
    repro = float(np.mean((pred - y8) ** 2))
    final = float(pop["final_losses"][pop["best_index"]])
    check(abs(repro - final) <= POP_REPRO_RTOL * final and repro < start,
          f"population: the best member's MSE in a plain model {repro:.6f} "
          f"is more than {POP_REPRO_RTOL} from its final loss {final:.6f}, "
          f"or not below its initial weights' {start:.6f}")
    steps = POP_EPOCHS * (len(x8) // POP_BATCH)
    out["pop_ms_per_step"] = wall / steps * 1e3
    say(f"population: {POP_K} LSTMForecaster members, lrs "
        f"{[round(v, 5) for v in lrs]}, {steps} steps of {POP_BATCH} in "
        f"{wall:.3f} s = {out['pop_ms_per_step']:.2f} ms/step for all "
        f"{POP_K} (host clock); losses {losses.round(6).tolist()}; best "
        f"member {pop['best_index']} (lr {pop['best_lr']:.5f}), final loss "
        f"{final:.6f}, its weights in a plain model {repro:.6f} (eval mode; "
        f"its initial weights {start:.6f})")
    out["pop_params"] = pop["best_params"]
    out["x8"] = x8
    out["x8_test"], _ = ft8.transform(data["test"], lookback=8)
    return out


def serve_windows(im, x) -> dict:
    """The windows through ``im`` (``do_predict`` at FORECAST_BATCH) with
    the counts set to 0 just before and read just after, under a profiler
    trace of the card."""
    sync(im.device)
    st0 = im.aot_stats()
    reset_launches()
    with _impl.card_launches(("w8a8", "w4a16")) as card:
        t0 = time.perf_counter()
        y = im.do_predict(x, batch_size=FORECAST_BATCH)
        sync(im.device)
        wall = time.perf_counter() - t0
    st = im.aot_stats()
    return {"y": y, "wall_s": wall, "card": card,
            "wrapper": {"w8a8": qm.launches_w8a8, "w4a16": qm.launches_w4a16},
            "forwards": sum(st["programs"].values())
            - sum(st0["programs"].values())}


def forecast_serve(name: str, build, params: dict, x, calib, n_dense: int,
                   dev) -> dict:
    """``build()``'s model with ``params`` through InferenceModel in f32,
    int8 (calibrated on ``calib``) and int4: launches on the card = by the
    wrappers = ``n_dense`` x forwards of the route's kernel; int8 bit for
    bit and int4 within W4_TOL of the plain route; with no Dense head
    (MTNet) every route launches nothing and predicts as f32."""
    out = {}
    for tag, bits in (("f32", 0), ("int8", 8), ("int4", 4)):
        im = InferenceModel(max_batch=FORECAST_BATCH, device=dev) \
            .do_load_model(build(), params)
        if bits:
            im.do_quantize([calib] if bits == 8 else None, bits=bits,
                           force=True, group_size=64)
        run = serve_windows(im, x)
        check_launches(f"forecast {name}[{tag}]", run, n_dense)
        err = 0.0
        if bits and n_dense:
            plain = route_probs(im, x, "torch", FORECAST_BATCH)
            err = check_route(f"forecast {name}[{tag}]", run["y"], plain,
                              bits)
        elif bits:
            check(np.array_equal(run["y"], out["f32"]["y"]),
                  f"forecast {name}[{tag}]: quantizes nothing, yet parts "
                  f"from f32")
        run["bytes"] = weight_bytes(im._params)
        say(f"forecast {name}[{tag}]: {len(x)} windows in "
            f"{run['forwards']} forwards of {FORECAST_BATCH}, "
            f"{len(x) / run['wall_s']:.0f} windows/s under the trace (host "
            f"clock); launches on the card = by the wrappers: w8a8 "
            f"{run['card']['w8a8']}, w4a16 {run['card']['w4a16']}; weight "
            f"bytes {run['bytes']}"
            + ("" if bits == 0 else "; vs the plain route " + (
                "bitwise equal" if bits == 8 and n_dense else
                f"max abs err {err:.3e}" if n_dense else
                "(no kernel) equal to f32")))
        out[tag] = run
        del im
    return out


def forecast_records(build, params: dict, x, calib, dev, tmp: str) -> dict:
    """The int8 model served by ClusterServing over FORECAST_RECORDS
    tensor records of windows (``quantize`` calibrated from a ``.npy``):
    every record's value bit for bit ``do_predict``'s."""
    X = x[:FORECAST_RECORDS]
    path = os.path.join(tmp, "forecast_calib.npy")
    np.save(path, calib)
    im = InferenceModel(max_batch=FORECAST_SERVE_BATCH, device=dev) \
        .do_load_model(build(), params)
    run = serve_predict(im, X, ServingParams(
        batch_size=FORECAST_SERVE_BATCH, max_wait_ms=20.0,
        quantize={"bits": 8, "calib": path},
        warmup={"max_batch": FORECAST_SERVE_BATCH, "scales": "off"}),
        kernels=("w8a8", "w4a16"))
    ref = im.do_predict(X, batch_size=FORECAST_SERVE_BATCH)
    check(run["dead_lettered"] == 0, "forecast served: records quarantined")
    for i, rid in enumerate(run["rids"]):
        r = run["results"].get(rid)
        check(r is not None and r.get("value") == default_postprocess(ref[i]),
              f"forecast served {rid}: {r} != do_predict's "
              f"{default_postprocess(ref[i])}")
    fw = run["forwards"]
    per = RECO_LAUNCHES["int8"].get("w8a8", 0)
    check(run["warm_hits"] == fw > 0
          and run["card"]["w8a8"] == run["wrapper"]["w8a8"] == fw * per
          and run["card"]["w4a16"] == run["wrapper"]["w4a16"] == 0,
          f"forecast served: {fw} forwards ({run['warm_hits']} warm), "
          f"launches on the card {run['card']}, by the wrappers "
          f"{run['wrapper']}")
    n = len(X)
    say(f"forecast served[int8]: {n}/{n} records of "
        f"{tuple(X.shape[1:])} windows in {run['wall_s']:.3f} s = "
        f"{n / run['wall_s']:.2f} records/s, e2e p50 "
        f"{run['e2e_p50_s'] * 1e3:.1f} ms (under the trace); {fw} forwards, "
        f"each of a warmed bucket; w8a8 launches on the card = by the "
        f"wrapper = {run['card']['w8a8']}; every value bit for bit "
        f"do_predict's")
    return run


def forecast_serve_phase(dev, data: dict, auto: dict, fc: dict) -> dict:
    """(d): the best pipeline's model, the population's best member in an
    LSTMForecaster and the trained MTNet through InferenceModel in f32 /
    int8 / int4 over the test windows; the int8 pipeline model through
    ClusterServing."""
    from analytics_zoo_tpu_torch.zouwu import (LSTMForecaster,
                                               MTNetForecaster, TSPipeline)
    pipe = auto["pipeline"]._p
    lookback = int(pipe.config["lookback"])
    x, _ = pipe.ft.transform(data["test"], lookback=lookback, horizon=1,
                             dt_features=pipe._dt_features())
    xtr, _ = pipe.ft.transform(data["train"], lookback=lookback, horizon=1,
                               dt_features=pipe._dt_features())
    params = numpy_tree(export_params(pipe.model))

    def pipe_model():
        return TSPipeline.load(auto["path"], device=dev)._p.model
    served = {"pipeline": forecast_serve(
        "pipeline", pipe_model, params, x, xtr[:FORECAST_BATCH], 1, dev)}
    x8 = fc["x8"]
    served["lstm_forecaster"] = forecast_serve(
        "lstm_forecaster", lambda: LSTMForecaster(
            feature_dim=x8.shape[-1], lookback=8, device=dev).model,
        fc["pop_params"], fc["x8_test"], x8[:FORECAST_BATCH], 1, dev)
    x16 = fc["mtnet_x"]
    served["mtnet"] = forecast_serve(
        "mtnet", lambda: MTNetForecaster(feature_dim=x16.shape[-1],
                                         **MTNET, device=dev).model,
        numpy_tree(export_params(fc["mtnet"].model)), x16,
        x16[:FORECAST_BATCH], 0, dev)
    served["records"] = forecast_records(pipe_model, params, x,
                                         xtr[:FORECAST_BATCH], dev,
                                         data["tmp"])
    return served


def forecast_data(seed: int, tmp: str) -> dict:
    df = forecast_series(seed)
    train, val, test = forecast_split(df)
    return {"df": df, "train": train, "val": val, "test": test, "tmp": tmp}


def forecast_phase(seed: int, records: dict) -> None:
    """Phase 11: the w8a8 / w4a16 kernels at the forecasting heads' shapes;
    AutoTS over a nyc_taxi-length series; MTNet, the MTNet smoke recipe,
    Seq2Seq and the population trainer; the best pipeline's model, an
    LSTMForecaster and MTNet served in f32 / int8 / int4 (InferenceModel)
    and the int8 pipeline model through ClusterServing."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t0, 2)
        return out
    kt = timed("kernels", forecast_kernel_phase, seed)
    with tempfile.TemporaryDirectory() as tmp:
        data = forecast_data(seed, tmp)
        say(f"forecast data: {FORECAST_POINTS} points every "
            f"{FORECAST_FREQ} from {FORECAST_START} (nyc_taxi's length and "
            f"cadence), train / validation / test {len(data['train'])} / "
            f"{len(data['val'])} / {len(data['test'])}")
        auto = timed("autots", autots_phase, seed, dev, data)
        fc = timed("forecasters", forecasters_phase, seed, dev, data)
        served = timed("served", forecast_serve_phase, dev, data, auto, fc)
    for name, bits_tag in (("w8a8", "int8"), ("w4a16", "int4")):
        rec = records[name]
        rec["forecast_launches"] = {
            model: served[model][bits_tag]["card"][name]
            for model in ("pipeline", "lstm_forecaster", "mtnet")}
        rec["forecast_launches"]["served"] = served["records"]["card"][name]
        rec["forecast_shapes"] = {s: t[name] for s, t in kt["shapes"].items()}
    rec = records["w4a16"]
    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0),
                             kt["w4_max_abs_err"])
    say(f"forecast: phase wall {time.perf_counter() - t_phase:.2f} s "
        f"({walls} s; AutoTS MSE ratio {auto['ratio']:.4f})")


# -- phase 12: the front door: gateway, admission, brownout, metering --------

# two tenants whose buckets differ: acme far above the traffic, slowco at
# 2 records/s with a burst of 4 (the burst that step 2 drains)
GATEWAY_ADMISSION = {"rate": 100.0, "burst": 200.0, "tenants": {
    "acme": {"rate": 1000.0, "burst": 1000.0},
    "slowco": {"rate": 2.0, "burst": 4.0}}}
# a loose objective keeps the main engine's ladder at stage 0; the brownout
# engine's tight one (1 ms, which every record misses) climbs it
GATEWAY_SLO = {"latency_ms": 60000.0, "window_s": 30.0, "target": 0.99}
TIGHT_SLO = {"latency_ms": 1.0, "window_s": 30.0, "target": 0.99}
GATEWAY_BROWNOUT = {"dwell_s": 0.2, "hold_s": 60.0, "batch_max_tokens": 16}
GATEWAY_CLIENTS = 4
# slowco's posts in the admission burst (its bucket holds at most 4)
SLOW_POSTS = 8
PROFILE_S = 2.0
# every result long-poll: short, so that streamed partials are seen
POLL_S = 0.05
PREDICT_CLIENTS = 4


def http_call(url: str, data=None, headers=None, method=None,
              timeout: float = 120.0):
    """(status, headers, body bytes) of one HTTP request; an error status
    is a reply too."""
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class GatewayClient:
    """An HTTP client of one engine's gateway: posts records, long-polls
    results, and keeps every reply's status and ``X-Replica-Id``, the
    partials it saw and the terminal results (thread-safe)."""

    def __init__(self, url: str):
        self.url = url
        self.lock = threading.Lock()
        self.replies = []                 # (endpoint, status, replica id)
        self.results = {}
        self.partials = {}

    def _note(self, endpoint, status, headers) -> None:
        with self.lock:
            self.replies.append((endpoint, status,
                                 headers.get("X-Replica-Id")))

    def post_frame(self, rid, prompt, tenant, priority):
        frame = wire.encode_tensor_frame(rid, np.asarray(prompt, "<f4"))
        st, hd, body = http_call(
            self.url + "/v1/enqueue", frame,
            {"Content-Type": "application/octet-stream",
             "X-Tenant": tenant, "X-Priority": priority})
        self._note("enqueue", st, hd)
        return st, hd, json.loads(body)

    def post_json(self, rec, tenant="acme", priority="interactive"):
        st, hd, body = http_call(
            self.url + "/v1/enqueue", json.dumps(rec).encode(),
            {"Content-Type": "application/json", "X-Tenant": tenant,
             "X-Priority": priority})
        self._note("enqueue", st, hd)
        return st, hd, json.loads(body)

    def fetch(self, rid, deadline_s: float = 300.0) -> dict:
        """Long-poll ``rid`` until its terminal result, keeping every
        partial the polls returned."""
        t_end = time.monotonic() + deadline_s
        while True:
            check(time.monotonic() < t_end, f"gateway: no result for {rid}")
            st, hd, body = http_call(
                self.url + f"/v1/result/{rid}?timeout_s={POLL_S}")
            self._note("result", st, hd)
            if st == 404:
                continue
            check(st == 200, f"gateway: GET result {rid} -> {st} {body!r}")
            doc = json.loads(body)
            if doc.get("partial"):
                with self.lock:
                    self.partials.setdefault(rid, []).append(
                        list(doc["tokens"]))
                continue
            with self.lock:
                self.results[rid] = doc
            return doc


def gateway_items(waves, tag: str):
    """Phase 3's 16 prompts as gateway posts: rid, prompt, tenant,
    priority.  slowco posts 4 (its burst), acme 12; priorities
    alternate."""
    items = []
    for i, (rid, prompt) in enumerate(p for w in waves for p in w):
        items.append((f"{tag}-{rid}", prompt,
                      "slowco" if i % 4 == 3 else "acme",
                      "interactive" if i % 2 == 0 else "batch"))
    return items


def post_and_fetch(client, items, n_threads: int = GATEWAY_CLIENTS):
    """Each of ``n_threads`` clients posts its share of ``items`` as binary
    frames, then long-polls its results.  Returns the wall seconds."""
    shares = [items[i::n_threads] for i in range(n_threads)]
    errors = []

    def run(share):
        try:
            for rid, prompt, tenant, prio in share:
                st, _, doc = client.post_frame(rid, prompt, tenant, prio)
                check(st == 200, f"gateway: enqueue {rid} -> {st} {doc}")
            for rid, *_ in share:
                client.fetch(rid)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(s,)) for s in shares]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "gateway: a client hung")
    if errors:
        raise errors[0]
    return wall


def gateway_client_main(spec_path: str) -> int:
    """``--gateway-client SPEC``: the HTTP round's clients in a process of
    their own, so that only the gateway's handler threads share the
    serving process's interpreter lock.  SPEC names the gateway, the items
    and the output file, where the wall, results, partials and replies
    land."""
    with open(spec_path) as f:
        spec = json.load(f)
    client = GatewayClient(spec["url"])
    items = [(rid, np.asarray(p, np.int32), ten, prio)
             for rid, p, ten, prio in spec["items"]]
    wall = post_and_fetch(client, items)
    with open(spec["out"], "w") as f:
        json.dump({"wall_s": wall, "results": client.results,
                   "partials": client.partials,
                   "replies": client.replies}, f)
    return 0


def http_round_process(url: str, items, tmp: str) -> dict:
    """The HTTP round with its clients in a fresh interpreter
    (``subprocess``, never a fork of this process, which holds a CUDA
    context); the wall is the client's, first post to last result."""
    here = os.path.dirname(os.path.abspath(__file__))
    spec = os.path.join(tmp, "client.json")
    out = os.path.join(tmp, "client.out.json")
    with open(spec, "w") as f:
        json.dump({"url": url, "out": out, "items": [
            (rid, [int(t) for t in p], ten, prio)
            for rid, p, ten, prio in items]}, f)
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "chip_smoke.py"),
         "--gateway-client", spec], cwd=here, capture_output=True,
        text=True, timeout=600)
    check(proc.returncode == 0,
          f"gateway client exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(out) as f:
        return json.load(f)


def untagged(tokens: dict, tag: str) -> dict:
    n = len(tag) + 1
    return {rid[n:]: toks for rid, toks in tokens.items()
            if rid.startswith(tag + "-")}


def boundaries(serving) -> tuple:
    """(decode boundaries, their seconds) so far: the engine's predict
    stage timer, one sample a boundary of the generation plane."""
    st = serving._stages["predict"]
    return st.count, st.sum


def boundary_line(before: tuple, after: tuple) -> str:
    n, s = after[0] - before[0], after[1] - before[1]
    return f"{n} boundaries of {s / max(n, 1) * 1e3:.2f} ms"


def ttft_p50(serving, n: int) -> float:
    """p50 of the engine's TTFT over its last ``n`` first tokens."""
    vals = sorted(serving._m_ttft.recent()[-n:])
    return vals[len(vals) // 2]


def queue_round(serving, q, waves, tag: str) -> dict:
    """The same engine fed straight from its queue: all 16 prompts
    enqueued at once, results polled."""
    iq, oq = InputQueue(q), OutputQueue(q)
    rids = []
    b0 = boundaries(serving)
    t0 = time.perf_counter()
    for rid, prompt in (p for w in waves for p in w):
        rids.append(iq.enqueue_tensor(f"{tag}-{rid}",
                                      prompt.astype(np.float32)))
    got = oq.query_many(rids, timeout_s=300.0)
    wall = time.perf_counter() - t0
    tokens = {}
    for rid in rids:
        r = got.get(rid)
        check(r is not None and "value" in r, f"[{tag}] {rid}: {r}")
        tokens[rid] = list(r["value"]["tokens"])
    n_tok = sum(len(t) for t in tokens.values())
    return {"tokens": tokens, "wall_s": wall, "tok_s": n_tok / wall,
            "ttft_p50_s": ttft_p50(serving, len(rids)), "results": got,
            "boundaries": boundary_line(b0, boundaries(serving))}


def gateway_serving(im, q, slo, admission=None, warmup=True):
    return ClusterServing(im, q, ServingParams(
        max_batch=N_REQUESTS, max_wait_ms=2.0,
        generation=dict(GENERATION, kv_quant="off"), warmup=warmup,
        http_port=0, admission=admission, brownout=GATEWAY_BROWNOUT,
        serving_slo=slo, profiling=True))


def wait_event(serving, kinds, timeout_s: float = 120.0) -> dict:
    """The first flight-recorder event of ``kinds`` from this engine."""
    t0 = time.monotonic()
    while True:
        evs = [e for e in serving.recorder.events()
               if e.get("event") in kinds
               and e.get("replica") == serving.replica_id]
        if evs:
            return evs[-1]
        check(time.monotonic() - t0 < timeout_s,
              f"gateway: no {kinds} event in {timeout_s} s")
        time.sleep(0.05)


def admission_step(serving, client, waves) -> dict:
    """Step 2: slowco posts past its bucket, acme interleaved.  Every 429
    carries ``Retry-After`` = the bucket's refill time to one token
    ((1 - tokens) / rate, at least 0.05 s); nothing of slowco's
    rejected records reaches the queue; acme's all pass."""
    bucket_key = ("slowco", "interactive")
    prompts = [p for w in waves for p in w]
    admitted, rejected, acme = [], [], []
    xadds = []
    real_xadd = serving.queue.xadd

    def logged_xadd(rec, *a, **kw):
        xadds.append(rec.get("uri") if isinstance(rec, dict) else None)
        return real_xadd(rec, *a, **kw)

    serving.queue.xadd = logged_xadd
    try:
        for i in range(SLOW_POSTS):
            rid, prompt = prompts[i]
            st, hd, doc = client.post_frame(f"adm-slow-{rid}", prompt,
                                            "slowco", "interactive")
            if st == 200:
                admitted.append(f"adm-slow-{rid}")
            else:
                b = serving._admission._buckets[bucket_key]
                want = max(0.05, (1.0 - b.tokens) / b.rate)
                check(st == 429 and doc["reason"] == "tenant_rate"
                      and doc["tenant"] == "slowco",
                      f"admission: {st} {doc}")
                check(hd.get("Retry-After") == f"{want:.3f}",
                      f"admission: Retry-After {hd.get('Retry-After')} != "
                      f"the bucket's refill time {want:.3f} s")
                rejected.append((f"adm-slow-{rid}",
                                 float(hd["Retry-After"])))
            st, _, doc = client.post_frame(f"adm-acme-{rid}", prompt,
                                           "acme", "interactive")
            check(st == 200, f"admission: acme {rid} -> {st} {doc}")
            acme.append(f"adm-acme-{rid}")
    finally:
        serving.queue.xadd = real_xadd
    check(rejected, "admission: slowco's burst drew no 429")
    check(not set(r for r, _ in rejected) & set(xadds),
          "admission: a rejected record reached the queue")
    for rid in admitted + acme:
        client.fetch(rid)
    for rid, _ in rejected:
        check(serving.queue.get_result(rid) is None,
              f"admission: rejected {rid} has a result")
    return {"admitted": len(admitted), "rejected": rejected,
            "acme": len(acme)}


def profile_step(serving, client, waves, tmp: str, card: bool = True) -> dict:
    """Step 3: POST /debug/profile during a wave (202), a second POST while
    it runs (409), the trace's device events, read from its Chrome trace
    (on the card they must hold the paged kernel); traffic keeps flowing
    until the trace has ended."""
    stop = threading.Event()
    errors = []
    prompts = [p for w in waves for p in w][:8]

    def traffic():
        k = 0
        try:
            while not stop.is_set():
                items = [(f"prof{k}-{rid}", p, "acme", "interactive")
                         for rid, p in prompts]
                for rid, p, ten, prio in items:
                    st, _, doc = client.post_frame(rid, p, ten, prio)
                    check(st == 200, f"profile traffic: {st} {doc}")
                for rid, *_ in items:
                    client.fetch(rid)
                k += 1
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    serving.profile_dir = tmp
    th = threading.Thread(target=traffic)
    th.start()
    try:
        time.sleep(0.2)
        st, hd, body = http_call(
            serving._http.url + f"/debug/profile?seconds={PROFILE_S}",
            b"", method="POST")
        check(st == 202, f"profile: POST -> {st} {body!r}")
        doc = json.loads(body)
        st2, hd2, body2 = http_call(
            serving._http.url + f"/debug/profile?seconds={PROFILE_S}",
            b"", method="POST")
        check(st2 == 409 and hd2.get("Retry-After") == "5",
              f"profile: second POST -> {st2} {body2!r}")
        ev = wait_event(serving, ("profile_done", "profile_error"))
    finally:
        stop.set()
        th.join(600)
    if errors:
        raise errors[0]
    check(ev["event"] == "profile_done", f"profile: {ev}")
    path = os.path.join(doc["path"], "trace.json")
    check(os.path.exists(path), f"profile: no trace at {path}")
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    paged = [e for e in kernels
             if _impl.KERNEL_NAMES["paged"] in str(e.get("name"))]
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    check(paged or not card, f"profile: the trace holds {len(kernels)} "
                             f"kernel events, none of the paged kernel")
    return {"path": path, "bytes": os.path.getsize(path),
            "kernels": len(kernels), "paged": len(paged),
            "cpu_ops": len(cpu_ops),
            "cpu_threads": len({e.get("tid") for e in cpu_ops}),
            "device_events": ev["device_events"],
            "device_work": ev["device_work"]}


def traced_gateway_wave(serving, client, waves) -> dict:
    """Outside the trace window ``card_launches`` counts as in phase 3:
    a wave over the gateway, paged launches on the card = decode steps x
    layers."""
    b = serving._batcher
    items = [(f"traced-{rid}", p, "acme", "interactive")
             for rid, p in waves[0]]
    torch.cuda.synchronize()
    steps0 = b.decode_steps
    with _impl.card_launches(("paged",)) as card:
        post_and_fetch(client, items)
    steps = b.decode_steps - steps0
    layers = serving.model._model.n_layers
    check(card["paged"] == steps * layers > 0,
          f"traced gateway wave: paged launches on the card "
          f"{card['paged']} != decode steps {steps} x {layers}")
    return {"launches": card["paged"], "steps": steps}


def ledger_step(serving, card: bool = True) -> dict:
    """Step 4: the documents over HTTP and the ledger: weights = the stored
    parameters and buffers, kv_state = the batcher's state bytes and, on
    the card, weights + kv_state + the CUDA-graph pools within the
    allocator's allocated bytes."""
    url = serving._http.url
    st, hd, body = http_call(url + "/healthz")
    check(st == 200, f"/healthz -> {st}")
    h = json.loads(body)
    want = {"resources", "process", "knobs", "usage", "admission",
            "brownout"}
    check(want <= set(h), f"/healthz lacks {sorted(want - set(h))}")
    st, _, body = http_call(url + "/readyz")
    check(st == 200, f"/readyz -> {st} {body!r}")
    st, _, prom = http_call(url + "/metrics?format=prom")
    prom = prom.decode()
    for series in ('gateway_request_seconds_count{endpoint="enqueue"}',
                   'gateway_request_seconds_count{endpoint="result"}',
                   'serving_device_seconds_total{tenant="acme",'
                   'model="default"}',
                   'serving_hbm_bytes{component="weights"}',
                   'serving_hbm_bytes{component="kv_state"}',
                   'serving_hbm_bytes{component="executables"}'):
        check(series in prom, f"/metrics?format=prom lacks {series}")
    res = h["resources"]
    module = serving.model._model
    stored = {t.data_ptr(): t.numel() * t.element_size()
              for t in list(module.parameters()) + list(module.buffers())}
    check(res["weights_bytes"] == sum(stored.values()),
          f"ledger: weights {res['weights_bytes']} != the stored "
          f"parameters and buffers {sum(stored.values())}")
    kv = serving._batcher.state_bytes()
    check(res["kv_state_bytes"] == kv,
          f"ledger: kv_state {res['kv_state_bytes']} != state_bytes {kv}")
    code = res["executables"]["code_bytes"]
    allocated = reserved = None
    if card:
        check(code is not None and code > 0,
              f"ledger: code_bytes {code} with a captured decode graph")
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        held = res["weights_bytes"] + res["kv_state_bytes"]
        check(held + code <= allocated,
              f"ledger: weights + kv_state + code_bytes {held + code} > "
              f"memory_allocated {allocated}")
    else:
        check(code is None, f"ledger: code_bytes {code} without a card")
    return {"weights": res["weights_bytes"], "kv": kv, "code": code,
            "allocated": allocated, "reserved": reserved,
            "programs": res["executables"]["count"]}


def usage_step(serving, walls: list, delivered: dict) -> dict:
    """Step 5: ``drain_usage()``'s device seconds sum to the walls the
    meter was charged; each tenant's records are its results, and its
    tokens the tokens delivered to them less the one each request's
    prefill emits (the reference meter charges tokens at decode
    boundaries, and the prefill token outside them)."""
    drained = serving.drain_usage()
    dev_s = sum(r["device_s"] for r in drained)
    wall_s = sum(walls)
    check(abs(dev_s - wall_s) <= 1e-6 * (len(drained) + 1),
          f"usage: device seconds {dev_s} != charged walls {wall_s}")
    by_tenant = {r["tenant"]: r for r in drained}
    for ten, lens in delivered.items():
        r = by_tenant.get(ten)
        check(r is not None, f"usage: no record for tenant {ten}")
        check(r["records"] == len(lens),
              f"usage: {ten} records {r['records']} != {len(lens)}")
        check(r["tokens"] == sum(n - 1 for n in lens),
              f"usage: {ten} tokens {r['tokens']} != delivered "
              f"{sum(lens)} - {len(lens)} prefill tokens")
    check(set(by_tenant) == set(delivered),
          f"usage: tenants {sorted(by_tenant)} != {sorted(delivered)}")
    return {"device_s": dev_s, "wall_s": wall_s, "tenants": by_tenant}


class PartialLog(InProcQueue):
    """InProcQueue that remembers the streamed partials written to it."""

    def __init__(self):
        super().__init__()
        self.partial_rids = []

    def put_partial(self, rid, value):
        self.partial_rids.append(rid)
        return super().put_partial(rid, value)


def brownout_step(im, waves) -> dict:
    """Step 6: an engine whose objective every record misses: its ladder
    climbs; once at stage 2, batch-priority records end at
    ``batch_max_tokens`` and interactive ones at their budget, and no
    partial is written while the ladder suppresses them."""
    q = PartialLog()
    serving = gateway_serving(im, q, TIGHT_SLO)
    try:
        serving.start()
        wait_warm(serving)
        client = GatewayClient(serving._http.url)
        first = [(f"bo1-{rid}", p, "acme", "interactive")
                 for rid, p in waves[0]]
        post_and_fetch(client, first)
        before = len(q.partial_rids)
        t0 = time.monotonic()
        while serving.brownout_stage < 2:
            check(time.monotonic() - t0 < 30.0,
                  f"brownout: stage {serving.brownout_stage} after 30 s "
                  f"({serving.health()['brownout']})")
            time.sleep(0.05)
        second = [(f"bo2-{rid}", p, "acme",
                   "batch" if i % 2 else "interactive")
                  for i, (rid, p) in enumerate(waves[1])]
        post_and_fetch(client, second)
        stage = serving.brownout_stage
        doc = serving.health()["brownout"]
    finally:
        serving.shutdown(drain_s=5.0)
    for rid, p, _, prio in second:
        r = client.results[rid]["value"]
        want = GATEWAY_BROWNOUT["batch_max_tokens"] if prio == "batch" \
            else min(GENERATION["max_tokens"], LANE - len(p))
        check(r["length"] == want and r["finish_reason"] == "length",
              f"brownout: {prio} {rid} ended at {r['length']}, want {want}")
    late = [r for r in q.partial_rids if r.startswith("bo2-")]
    check(before > 0 and not late,
          f"brownout: {before} partials at stage 0, {len(late)} while "
          f"suppressed")
    check(stage >= 2, f"brownout: stage fell to {stage}")
    return {"partials_before": before, "stage": stage,
            "transitions": doc["transitions"]}


def predict_http_step(seed: int, dev, tmp: str,
                      launches: bool = True) -> dict:
    """Step 7: phase 4's model with its int8 head, served over the gateway
    from JSON records; every top-5 bit for bit the one
    ``InferenceModel.predict`` gives on the batch the engine formed; the
    flash forward and w8a8 launches on the card = by the wrappers."""
    model = build_predict_model(seed)
    im = InferenceModel(device=dev).do_load_model(model)
    X = predict_records(seed)
    calib = os.path.join(tmp, "calib.npy")
    np.save(calib, predict_records(seed + 1, PREDICT_BATCH))
    q = InProcQueue()
    serving = ClusterServing(im, q, ServingParams(
        batch_size=PREDICT_BATCH, max_wait_ms=2.0, warmup=PREDICT_WARMUP,
        quantize={"bits": 8, "calib": calib}, http_port=0))
    batches = []
    hook = im._model.register_forward_pre_hook(
        lambda _m, args: batches.append(args[0].detach().clone()))
    rids = [f"pred-{i:02d}" for i in range(len(X))]
    try:
        serving.start()
        wait_warm(serving)
        sync(dev)
        batches.clear()
        client = GatewayClient(serving._http.url)
        st0 = im.aot_stats()
        reset_launches()
        errors = []

        def run(share):
            try:
                for i in share:
                    rec = {"uri": rids[i], "dtype": "<f4", "shape":
                           [PREDICT["seq_len"]], "b64": base64.b64encode(
                               X[i].astype("<f4").tobytes()).decode()}
                    st, _, doc = client.post_json(rec)
                    check(st == 200, f"predict: enqueue -> {st} {doc}")
                for i in share:
                    client.fetch(rids[i])
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        with _impl.card_launches(("flash_fwd", "w8a8")) as card:
            t0 = time.perf_counter()
            threads = [threading.Thread(
                target=run, args=(range(k, len(X), PREDICT_CLIENTS),))
                for k in range(PREDICT_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        sync(dev)
        st = im.aot_stats()
        wrapper = {"flash_fwd": fa.launches, "w8a8": qm.launches_w8a8}
    finally:
        hook.remove()
        serving.shutdown(drain_s=5.0)
    check(im._model.layers_list[-1].bits == 8, "predict: head not int8")
    fw = sum(st["programs"].values()) - sum(st0["programs"].values())
    check(len(batches) == fw > 0,
          f"predict: {len(batches)} forwards seen, {fw} counted")
    for k, per in (("flash_fwd", PREDICT["n_block"]), ("w8a8", 1)):
        per = per if launches else 0
        check(card[k] == wrapper[k] == fw * per,
              f"predict: {k} launches on the card {card[k]}, by the "
              f"wrapper {wrapper[k]}, != {fw} forwards x {per}")
    # the reference: InferenceModel.predict of each batch the engine formed
    row_of = {X[i].tobytes(): i for i in range(len(X))}
    seen = 0
    for xb in batches:
        rows = [row_of[r.tobytes()] for r in
                xb.to(torch.float32).cpu().numpy() if r.tobytes() in row_of]
        probs = im.predict(X[rows])
        for j, i in enumerate(rows):
            want = default_postprocess(probs[j], 5)
            got = client.results[rids[i]]["value"]
            check(got == want, f"predict: {rids[i]} top-5 {got} != "
                               f"InferenceModel.predict {want}")
            seen += 1
    check(seen == len(X), f"predict: {seen} of {len(X)} records compared")
    return {"records_s": len(X) / wall, "wall_s": wall, "forwards": fw,
            "card": card, "e2e_p50_s":
                serving._e2e.percentiles((50,))["p50"]}


def gateway_generation(im, waves, ref_tokens, card: bool = True) -> dict:
    """Steps 1-5 on one engine: the queue-fed round, the HTTP round (with a
    retune under its traffic), admission, the profile, on the card a
    traced wave, the documents and the ledger, then the usage drain."""
    q = InProcQueue()
    serving = gateway_serving(im, q, GATEWAY_SLO, GATEWAY_ADMISSION)
    walls = []
    real_charge = serving.meter.device_seconds

    def charge(rows_by_tenant, wall_s):
        if rows_by_tenant and wall_s > 0:
            walls.append(wall_s)
        return real_charge(rows_by_tenant, wall_s)

    serving.meter.device_seconds = charge
    delivered = {}

    def deliver(results):
        for r in results.values():
            ten = r.get("tenant") or "unknown"
            delivered.setdefault(ten, []).append(len(r["value"]["tokens"]))

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            serving.start()
            warm = wait_warm(serving)
            client = GatewayClient(serving._http.url)
            # the same engine fed straight from its queue, then over HTTP
            qa = queue_round(serving, q, waves, "qa")
            deliver(qa["results"])
            compare_tokens(im, waves, untagged(qa["tokens"], "qa"),
                           ref_tokens, "off", "queue[off]",
                           "phase 3's paged f32 run")
            # the HTTP round, its clients in a process of their own
            b0 = boundaries(serving)
            ext = http_round_process(serving._http.url,
                                     gateway_items(waves, "ext"), tmp)
            ext_ttft = ttft_p50(serving, N_REQUESTS)
            ext_b = boundary_line(b0, boundaries(serving))
            deliver(ext["results"])
            client.replies += [tuple(r) for r in ext["replies"]]
            # the same round with the clients on threads of this process,
            # and a retune under its traffic, once slowco's bucket has
            # refilled its burst
            slow = GATEWAY_ADMISSION["tenants"]["slowco"]
            time.sleep(slow["burst"] / slow["rate"])
            items = gateway_items(waves, "http")
            knobs0 = serving.knobs()
            retuned = {}

            def retune_mid():
                time.sleep(0.05)
                retuned.update(serving.retune(max_batch=8, max_wait_ms=1.0))

            rt = threading.Thread(target=retune_mid)
            rt.start()
            b0 = boundaries(serving)
            wall = post_and_fetch(client, items)
            thr_b = boundary_line(b0, boundaries(serving))
            rt.join(60)
            knobs = serving.knobs()
            http_ttft = ttft_p50(serving, len(items))
            prompts = {rid: p for rid, p, *_ in items}
            got = {rid: list(client.results[rid]["value"]["tokens"])
                   for rid in prompts}
            ext_got = {rid: list(r["value"]["tokens"])
                       for rid, r in ext["results"].items()}
            check(untagged(ext_got, "ext") == untagged(got, "http"),
                  "http: the two rounds' tokens differ")
            partials = {"http-" + rid[4:]: list(parts)
                        for rid, parts in ext["partials"].items()}
            for rid, parts in client.partials.items():
                partials.setdefault(rid, []).extend(parts)
            for rid, toks in got.items():
                want = min(GENERATION["max_tokens"],
                           LANE - len(prompts[rid]))
                check(len(toks) == want, f"http {rid}: {len(toks)} tokens")
                for part in partials.get(rid, []):
                    check(part == toks[:len(part)],
                          f"http {rid}: a partial is not a prefix")
            compare_tokens(im, waves, untagged(got, "http"), ref_tokens,
                           "off", "http[off]", "phase 3's paged f32 run")
            n_tok = sum(len(t) for t in got.values())
            check(retuned == {"max_batch": 8, "max_wait_ms": 1.0}
                  and knobs["max_batch"] == 8
                  and knobs["max_wait_ms"] == 1.0,
                  f"retune: staged {retuned}, knobs {knobs0} -> {knobs}")
            qb = queue_round(serving, q, waves, "qb")
            deliver(qb["results"])
            ev = [e for e in serving.recorder.events()
                  if e.get("event") == "retune"
                  and e.get("replica") == serving.replica_id]
            check(ev and ev[-1]["max_batch"] == 8.0
                  and serving.params.max_batch == 8,
                  f"retune: events {ev}, params.max_batch "
                  f"{serving.params.max_batch}")
            out["http"] = {"tok_s": n_tok / wall, "ttft_p50_s": http_ttft,
                           "ext_tok_s": n_tok / ext["wall_s"],
                           "ext_ttft_p50_s": ext_ttft}
            out["queue"] = [qa, qb]
            say(f"gateway[generation]: warm-up {warm['total']} entries in "
                f"{warm['seconds']:.3f} s; over HTTP ({GATEWAY_CLIENTS} "
                f"clients, binary frames, tenants acme / slowco, results "
                f"polled every {POLL_S} s): {len(got)} records, {n_tok} "
                f"tokens; clients in another process "
                f"{ext['wall_s']:.3f} s = {n_tok / ext['wall_s']:.1f} "
                f"tokens/s, TTFT p50 {ext_ttft * 1e3:.2f} ms, {ext_b}; "
                f"clients on threads of this process {wall:.3f} s = "
                f"{n_tok / wall:.1f} tokens/s, TTFT p50 "
                f"{http_ttft * 1e3:.2f} ms, {thr_b}; fed from the queue: "
                f"{qa['tok_s']:.1f} and {qb['tok_s']:.1f} tokens/s, TTFT "
                f"p50 {qa['ttft_p50_s'] * 1e3:.2f} and "
                f"{qb['ttft_p50_s'] * 1e3:.2f} ms, {qa['boundaries']} and "
                f"{qb['boundaries']}; partials seen "
                f"{sum(len(v) for v in partials.values())}, each "
                f"a prefix; retune under traffic: "
                f"{knobs0['max_batch']} -> {knobs['max_batch']} records a "
                f"read, {knobs0['max_wait_ms']} -> {knobs['max_wait_ms']} "
                f"ms, a retune event")
            adm = admission_step(serving, client, waves)
            say(f"gateway[admission]: slowco (2/s, burst 4) "
                f"{adm['admitted']} admitted, {len(adm['rejected'])} "
                f"x 429 with Retry-After "
                f"{[ra for _, ra in adm['rejected']]} s (the bucket's "
                f"refill time), none queued; acme {adm['acme']} of "
                f"{adm['acme']} admitted")
            prof = profile_step(serving, client, waves,
                                os.path.join(tmp, "profiles"), card=card)
            say(f"gateway[profile]: 202, then 409 while it ran; "
                f"{prof['bytes']} B trace: {prof['kernels']} kernel events "
                f"({prof['paged']} of the paged kernel), {prof['cpu_ops']} "
                f"CPU op events on {prof['cpu_threads']} thread(s); the "
                f"profiler counted {prof['device_events']} device events "
                f"over {prof['device_work']} decode steps")
            if card:
                tw = traced_gateway_wave(serving, client, waves)
                say(f"gateway[traced]: after the trace, card_launches "
                    f"counts {tw['launches']} paged launches = "
                    f"{tw['steps']} decode steps x "
                    f"{im._model.n_layers}")
            led = ledger_step(serving, card=card)
            mem = ""
            if card:
                mem = (f"; their sum "
                       f"{led['weights'] + led['kv'] + led['code']} <= "
                       f"memory_allocated {led['allocated']} <= "
                       f"memory_reserved {led['reserved']}")
            say(f"gateway[ledger]: weights {led['weights']} B (= the "
                f"stored parameters), kv_state {led['kv']} B (= "
                f"state_bytes), CUDA-graph pools {led['code']} B"
                f"{mem}; {led['programs']} programs")
            lat = serving.registry.histogram(
                "gateway_request_seconds", labels=("endpoint",))
            p50 = {ep: lat.labels(endpoint=ep).percentiles((50,))["p50"]
                   for ep in ("enqueue", "result")}
            ids = {r for _, _, r in client.replies}
            check(ids == {serving.replica_id},
                  f"X-Replica-Id {ids} != {serving.replica_id}")
        finally:
            serving.shutdown(drain_s=5.0)
    deliver(client.results)
    use = usage_step(serving, walls, delivered)
    say(f"gateway[usage]: device seconds {use['device_s']:.6f} = "
        f"charged walls {use['wall_s']:.6f} over {len(walls)} charges; "
        + "; ".join(f"{t}: {r['records']} records, {r['tokens']} "
                    f"tokens, {r['bytes']} B, {r['device_s']:.6f} s"
                    for t, r in sorted(use["tenants"].items()))
        + f"; gateway p50 enqueue {p50['enqueue'] * 1e3:.2f} ms, "
        f"result {p50['result'] * 1e3:.2f} ms; "
        f"{len(client.replies)} replies, each with X-Replica-Id")
    out.update(usage=use, gateway_p50_s=p50)
    return out


def gateway_phase(seed: int, ref_tokens=None) -> None:
    """Phase 12: GPT-2-small generation and the int8 predict head served
    through the front door (see the module docstring).  ``ref_tokens``:
    phase 3's paged f32 tokens (served again here when not given)."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    lm = TransformerLM(**GPT2_SMALL, seed=seed, device=dev)
    im = InferenceModel(device=dev).do_load_model(lm)
    waves = make_requests(seed, GPT2_SMALL["vocab_size"])
    if ref_tokens is None:
        run = serve(im, waves, dict(GENERATION, kv_quant="off"))
        ref_tokens = check_served(run, waves, GPT2_SMALL["vocab_size"],
                                  "off")
    gateway_generation(im, waves, ref_tokens)
    bo = brownout_step(im, waves)
    say(f"gateway[brownout]: tight objective -> stage {bo['stage']} "
        f"({[(t['from'], t['to']) for t in bo['transitions']]}); batch "
        f"records end at {GATEWAY_BROWNOUT['batch_max_tokens']} tokens, "
        f"interactive at their budget; partials {bo['partials_before']} at "
        f"stage 0, none while suppressed")
    del im, lm
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        pr = predict_http_step(seed, dev, tmp)
    say(f"gateway[predict int8]: {N_RECORDS} JSON records over HTTP in "
        f"{pr['wall_s']:.3f} s = {pr['records_s']:.2f} records/s, e2e p50 "
        f"{pr['e2e_p50_s'] * 1e3:.1f} ms (under the trace); "
        f"{pr['forwards']} forwards, launches on the card = by the "
        f"wrappers: flash_fwd {pr['card']['flash_fwd']}, w8a8 "
        f"{pr['card']['w8a8']}; every top-5 bit for bit "
        f"InferenceModel.predict's")
    torch.cuda.empty_cache()
    say(f"gateway: phase wall {time.perf_counter() - t_phase:.2f} s")


# -- phase 13: the fleet control plane -----------------------------------------

# phase 4's model under names that do not depend on what this process built
# before it: a topology file builds the same keys in a fresh process
FLEET_PREDICT_NAMES = ("fleet_tl", "fleet_pool", "fleet_head")
FLEET_CLIENTS = 4
FLEET_TIMEOUT_S = 300.0
FLEET_PROFILE_S = 2.0
# the crash wave: phase 3's prompts three times over, so that generations
# are in flight with checkpoints spooled for long enough to pick a victim
CRASH_COPIES = 3
# a short canary dwell: the rollout's state machine, not a soak
FLEET_ROLLOUT = {"canary_dwell_s": 2.0, "ready_timeout_s": 180.0,
                 # the canary's own boot loads and warms v2; a pre-warm
                 # pass of v2 first would block the supervisor ~12 s
                 "prewarm": False}
# the autoscaler runs (--autoscale) with dwells far past the phase, so the
# replica counts are the ones the steps set
FLEET_AUTOSCALER = {"min_replicas": 1, "max_replicas": 3,
                    "dwell_up_s": 3600, "dwell_down_s": 3600,
                    "knob_dwell_s": 3600, "heartbeat_stale_s": 3600}
MANAGER = (sys.executable, "-m", "analytics_zoo_tpu_torch.serving.manager")


def fleet_predict_model(seed=None) -> Sequential:
    T = PREDICT["seq_len"]
    tl, pool, head = FLEET_PREDICT_NAMES
    m = Sequential([
        TransformerLayer(**PREDICT, input_shape=(T,), name=tl),
        GlobalAveragePooling1D(name=pool),
        Dense(PREDICT["vocab"], activation="softmax", name=head)])
    return m if seed is None else m.init_weights(seed)


def predict_topology() -> str:
    tl, pool, head = FLEET_PREDICT_NAMES
    return (
        "from analytics_zoo_tpu_torch.nn.layers.attention import "
        "TransformerLayer\n"
        "from analytics_zoo_tpu_torch.nn.layers.core import Dense\n"
        "from analytics_zoo_tpu_torch.nn.layers.pooling import "
        "GlobalAveragePooling1D\n"
        "from analytics_zoo_tpu_torch.nn.models import Sequential\n\n\n"
        "def build_model():\n"
        f"    return Sequential([TransformerLayer(**{PREDICT!r}, "
        f"input_shape=({PREDICT['seq_len']},), name={tl!r}), "
        f"GlobalAveragePooling1D(name={pool!r}), "
        f"Dense({PREDICT['vocab']}, activation='softmax', "
        f"name={head!r})])\n")


def lm_topology() -> str:
    """GPT-2 small built on the host; the config's ``model.device`` moves
    it to the card, where the store's leaves are copied in."""
    return ("from analytics_zoo_tpu_torch.models.textmodels import "
            "TransformerLM\n\n\n"
            "def build_model():\n"
            f"    return TransformerLM(**{GPT2_SMALL!r}, device='cpu')\n")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def write_config(path: str, doc: dict) -> str:
    """A manager config, written as JSON, which is YAML too."""
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path


def last_json(text: str):
    docs = [ln for ln in (text or "").splitlines()
            if ln.strip().startswith("{")]
    return json.loads(docs[-1]) if docs else None


def pid_of(path: str):
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def pid_alive(pid) -> bool:
    if pid is None:
        return False
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:                              # a zombie is not alive
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")", 1)[1].split()[0] != "Z"
    except OSError:
        return True


def prom_buckets(prom: str, name: str) -> dict:
    """``{le: cumulative count}`` of the ``name`` histogram in a
    (merged) Prometheus text, summed over its label sets."""
    out = {}
    for m in re.finditer(rf'^{name}_bucket{{.*?le="([^"]+)".*?}} (\S+)$',
                         prom, re.M):
        le = float("inf") if m.group(1) == "+Inf" else float(m.group(1))
        out[le] = out.get(le, 0.0) + float(m.group(2))
    return out


def histogram_p50(after: dict, before: dict):
    """``histogram_quantile(0.5)`` over the bucket counts ``after`` less
    ``before`` (two ``prom_buckets`` readings): linear within the bucket,
    as Prometheus interpolates; None with no sample."""
    counts = {le: c - before.get(le, 0.0) for le, c in after.items()}
    total = counts.get(float("inf"), 0.0)
    if total <= 0:
        return None
    rank, lo, prev = 0.5 * total, 0.0, 0.0
    for le in sorted(counts):
        if counts[le] >= rank:
            if le == float("inf"):
                return lo
            return lo + (le - lo) * (rank - prev) / max(counts[le] - prev,
                                                         1e-12)
        lo, prev = le, counts[le]
    return lo


def prom_value(prom: str, name: str) -> float:
    return sum(float(m.group(1)) for m in re.finditer(
        rf"^{name}(?:{{[^}}]*}})? (\S+)$", prom, re.M))


class Fleet:
    """One deployment of ``python -m analytics_zoo_tpu_torch.serving.
    manager`` in subprocesses of this script (never a fork of it: this
    process holds a CUDA context), under ``tmp``: the CLI actions, the
    replica probes on ``port + i`` and the front door on ``lb_port``.
    ``kill`` takes down the whole process group on the way out."""

    def __init__(self, tmp: str, config: str, port: int, lb_port=None,
                 pidfile="cs.pid"):
        self.tmp = tmp
        self.config = config
        self.port = port
        self.lb_port = lb_port
        self.pidfile = os.path.join(tmp, pidfile)
        here = os.path.dirname(os.path.abspath(__file__))
        self.env = dict(os.environ, PYTHONPATH=here)
        self.proc = None
        self.log_path = self.pidfile + ".supervisor.log"
        self.pids = set()

    def cli_popen(self, *args, config=None):
        """One manager action in a process of its own (those that load a
        model: ``warmup``, ``publish``); ``cli_wait`` reads its (exit
        code, last JSON line printed, completed process)."""
        return subprocess.Popen(
            list(MANAGER) + list(args) + ["-c", config or self.config,
                                          "--pidfile", self.pidfile],
            cwd=self.tmp, env=self.env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    @staticmethod
    def cli_wait(proc, timeout: float = 600.0):
        out, err = proc.communicate(timeout=timeout)
        done = subprocess.CompletedProcess(proc.args, proc.returncode, out,
                                           err)
        return proc.returncode, last_json(out) or last_json(err), done

    def action(self, *args):
        """One manager action that reads files, signals processes or calls
        the replicas over HTTP (``status``, ``scale``, ``metrics``,
        ``profile``, ``incident``, ``versions``, ``rollout``), through
        ``manager.main`` in this process: no interpreter to start, and no
        fork (those actions make none).  Returns (exit code, the last JSON
        line printed, everything printed)."""
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = manager.main(list(args) + ["-c", self.config,
                                            "--pidfile", self.pidfile])
        return rc, last_json(out.getvalue()) or last_json(err.getvalue()), \
            out.getvalue() + err.getvalue()

    def start(self, replicas: int, *extra):
        args = ["start", "-c", self.config, "--pidfile", self.pidfile,
                "--foreground", "--replicas", str(replicas)]
        if self.lb_port is not None:
            args += ["--lb-port", str(self.lb_port)]
        self._log = open(self.log_path, "w")
        self.t_start = time.perf_counter()
        self.proc = subprocess.Popen(
            list(MANAGER) + args + list(extra), cwd=self.tmp, env=self.env,
            stdout=self._log, stderr=subprocess.STDOUT,
            start_new_session=True)
        return self

    def log_tail(self, n: int = 3000) -> str:
        try:
            with open(self.log_path) as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def url(self, i: int) -> str:
        return f"http://127.0.0.1:{self.port + i}"

    @property
    def lb_url(self) -> str:
        return f"http://127.0.0.1:{self.lb_port}"

    def health(self, i: int):
        try:
            st, _, body = http_call(self.url(i) + "/healthz", timeout=10)
        except OSError:
            return None
        return json.loads(body) if st == 200 else None

    def ready(self, i: int) -> bool:
        try:
            return http_call(self.url(i) + "/readyz", timeout=5)[0] == 200
        except OSError:
            return False

    def replica_pid(self, i: int):
        pid = pid_of(f"{self.pidfile}.r{i}")
        if pid is not None:
            self.pids.add(pid)
        return pid

    def wait_ready(self, indices, t0: float, timeout_s=FLEET_TIMEOUT_S,
                   not_pid=None) -> dict:
        """Seconds from ``t0`` (perf_counter) to each replica's first
        ``/readyz`` 200 (a replica other than pid ``not_pid``)."""
        out = {}
        while len(out) < len(indices):
            check(self.proc is None or self.proc.poll() is None,
                  f"fleet: the supervisor exited: {self.log_tail()}")
            check(time.perf_counter() - t0 < timeout_s,
                  f"fleet: replicas {sorted(set(indices) - set(out))} not "
                  f"ready in {timeout_s} s: {self.log_tail()}")
            for i in indices:
                if i in out:
                    continue
                pid = self.replica_pid(i)
                if pid is None or pid == not_pid:
                    continue
                if self.ready(i):
                    out[i] = time.perf_counter() - t0
            time.sleep(0.1)
        return out

    def status(self) -> dict:
        return self.action("status")[1] or {}

    def stop(self) -> None:
        """``manager stop`` while this process reaps the supervisor; every
        process the deployment ran is gone after it."""
        stop = subprocess.Popen(
            list(MANAGER) + ["stop", "--pidfile", self.pidfile],
            cwd=self.tmp, env=self.env, stdout=subprocess.PIPE, text=True)
        try:
            self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            pass
        out, _ = stop.communicate(timeout=120)
        check(last_json(out) == {"stopped": True}, f"fleet: stop -> {out}")
        check(self.proc.poll() is not None,
              f"fleet: the supervisor outlived stop: {self.log_tail()}")
        left = sorted(p for p in self.pids if pid_alive(p))
        check(not left, f"fleet: processes {left} outlived stop")
        self._log.close()

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except OSError:
                pass
            self.proc.wait(timeout=60)
        for pid in self.pids:
            if pid_alive(pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass


def fleet_store_step(seed: int, dev, tmp: str, during=None) -> dict:
    """Step 1: phase 4's model with its int8 head from a seeded ``.npz``
    and a topology file; ``manager warmup`` quantizes on a seeded
    calibration batch and exports the store, a second ``warmup`` skips it;
    this process restores it (``do_load``, ``load_mmap``) and its top-5
    equals, bit for bit, the int8 predict of the same model quantized here
    on the same batch, through 12 flash forward launches and one ``w8a8``
    a forward on the card and by the wrappers.  ``during()`` runs here
    while the first ``warmup`` does; what it returns is ``"during"``."""
    npz = os.path.join(tmp, "predict.npz")
    fleet_predict_model(seed).save_weights(npz)
    topo = os.path.join(tmp, "predict_topology.py")
    with open(topo, "w") as f:
        f.write(predict_topology())
    calib = os.path.join(tmp, "calib.npy")
    np.save(calib, predict_records(seed + 1, PREDICT_BATCH))
    cfg = write_config(os.path.join(tmp, "predict.yaml"), {
        "model": {"path": npz, "type": "zoo", "topology": topo,
                  "device": dev.type},
        "data": {"src": "file:" + os.path.join(tmp, "pq")},
        "params": {"batch_size": PREDICT_BATCH, "warmup": PREDICT_WARMUP,
                   "quantize": {"bits": 8, "calib": calib}}})
    fl = Fleet(tmp, cfg, 0, pidfile="predict.pid")
    walls, docs, side = [], [], None
    for k in range(2):
        t0 = time.perf_counter()
        proc = fl.cli_popen("warmup")
        if k == 0 and during is not None:
            side = during()
        rc, doc, out = fl.cli_wait(proc)
        walls.append(time.perf_counter() - t0)
        check(rc == 0 and doc is not None,
              f"store: warmup exited {rc}: {out.stderr[-2000:]}")
        docs.append(doc)
    w1, w2 = docs
    check(w1["store_exported"] and w1["quantized_bits"] == 8
          and not w1["load_mmap"] and w1["failed"] == 0
          and w1["cache_dir"] is None, f"store: first warmup {w1}")
    check(not w2["store_exported"] and w2["load_mmap"]
          and w2["quantized_bits"] == 8 and w2["failed"] == 0,
          f"store: second warmup {w2}")
    check(w1["kernels_built"] == [] == w2["kernels_built"],
          f"store: the warm-up passes ran nvcc: {w1['kernels_built']}, "
          f"{w2['kernels_built']}")
    store = fl.pidfile + ".weights"
    im = InferenceModel(device=dev).do_load(fleet_predict_model, store)
    check(im.load_mmap and im.load_seconds is not None,
          "store: do_load did not map the store")
    ref = InferenceModel(device=dev).do_load(fleet_predict_model, npz)
    check(not ref.load_mmap, "store: the .npz load mapped a store")
    ref.do_quantize(np.load(calib), force=True, bits=8)
    X = predict_records(seed)[:PREDICT_BATCH]
    want = ref.do_predict(X)
    sync(dev)
    with _impl.card_launches(("flash_fwd", "w8a8")) as card:
        reset_launches()
        got = im.do_predict(X)
        sync(dev)
    wrapper = {"flash_fwd": fa.launches, "w8a8": qm.launches_w8a8}
    on_card = dev.type == "cuda"     # a CPU rehearsal launches no kernel
    for k, per in (("flash_fwd", PREDICT["n_block"]), ("w8a8", 1)):
        per = per if on_card else 0
        check(card[k] == wrapper[k] == per,
              f"store: {k} launches on the card {card[k]}, by the wrapper "
              f"{wrapper[k]}, != {per} a forward")
    top = np.argsort(-got, -1, kind="stable")[:, :5]
    check(np.array_equal(top, np.argsort(-want, -1, kind="stable")[:, :5])
          and np.array_equal(got, want),
          "store: the restored int8 model's predict differs from the one "
          "quantized here")
    out = {"warmup_s": walls, "w1": w1, "w2": w2, "during": side,
           "load_store_s": im.load_seconds, "load_npz_s": ref.load_seconds,
           "store_bytes": sum(os.path.getsize(os.path.join(store, f))
                              for f in os.listdir(store)),
           "card": card}
    del im, ref
    torch.cuda.empty_cache()
    return out


def lm_config(tmp: str, name: str, npz: str, topo: str, port: int,
              dev) -> str:
    params = {"batch_size": 4, "max_batch": N_REQUESTS, "max_wait_ms": 2.0,
              "http_port": port, "warmup": True, "drain_s": 10,
              "lease_s": RESUME_LEASE_S, "reclaim_interval_s": 0.5,
              "generation": dict(GENERATION, kv_quant="off", **RESUME)}
    return write_config(os.path.join(tmp, name), {
        "model": {"path": npz, "type": "zoo", "topology": topo,
                  "device": dev.type},
        "data": {"src": "file:" + os.path.join(tmp, "q")},
        "params": params,
        "rollout": FLEET_ROLLOUT,
        "autoscaler": FLEET_AUTOSCALER,
        "incident": {"on_crash": True, "cooldown_s": 1.0}})


def lb_round(fl: Fleet, waves, tag: str, copies: int = 1) -> dict:
    """Phase 3's prompts (``copies`` times) through the front door from
    ``FLEET_CLIENTS`` client threads: every one answered; returns the
    untagged tokens, the wall and the client."""
    client = GatewayClient(fl.lb_url)
    items = []
    for c in range(copies):
        t = f"{tag}{c}" if copies > 1 else tag
        items += [(f"{t}-{rid}", p, "acme", "interactive")
                  for rid, p in (x for w in waves for x in w)]
    wall = post_and_fetch(client, items, FLEET_CLIENTS)
    tokens = {rid: list(doc["value"]["tokens"])
              for rid, doc in client.results.items()}
    check(len(tokens) == len(items) and all(
        st == 200 for ep, st, _ in client.replies if ep == "enqueue"),
          f"[{tag}] {len(tokens)}/{len(items)} answered")
    return {"tokens": tokens, "wall_s": wall, "client": client,
            "n_tok": sum(len(t) for t in tokens.values())}


def fleet_profile(fl: Fleet, waves, card: bool = True) -> dict:
    """``manager profile 0 --seconds 2`` while waves run: its trace's
    kernel events hold the paged kernel's.  The waves go straight onto
    the shared queue: writing the trace holds replica 0's interpreter
    for seconds, the front door marks it out meanwhile, and its retry
    budget is not what this step measures."""
    stop = threading.Event()
    errors = []

    def traffic():
        q = FileQueue(os.path.join(fl.tmp, "q"))
        iq, oq = InputQueue(q), OutputQueue(q)
        k = 0
        try:
            while not stop.is_set():
                rids = [iq.enqueue_tensor(f"prof{k}-{rid}",
                                          p.astype(np.float32))
                        for rid, p in waves[0]]
                got = oq.query_many(rids, timeout_s=FLEET_TIMEOUT_S)
                check(all(got.get(r) is not None and "value" in got[r]
                          for r in rids), f"fleet profile: wave {k} {got}")
                k += 1
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    th = threading.Thread(target=traffic)
    th.start()
    try:
        time.sleep(0.3)
        rc, doc, out = fl.action("profile", "0", "--seconds",
                              str(FLEET_PROFILE_S))
        check(rc == 0 and doc and doc.get("path"),
              f"fleet profile: {rc} {doc} {out[-1000:]}")
        path = os.path.join(doc["path"], "trace.json")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            check(time.perf_counter() - t0 < 120,
                  f"fleet profile: no trace at {path}")
            time.sleep(0.2)
        time.sleep(0.5)
    finally:
        stop.set()
        th.join(600)
    if errors:
        raise errors[0]
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    paged = [e for e in kernels
             if _impl.KERNEL_NAMES["paged"] in str(e.get("name"))]
    check(paged or not card, f"fleet profile: {len(kernels)} kernel "
                             f"events, none of the paged kernel")
    return {"path": path, "kernels": len(kernels), "paged": len(paged)}


def fleet_crash(fl: Fleet, im, waves, ref_tokens) -> dict:
    """Step 4: a wave through the front door; the replica that owns
    in-flight generations with checkpoints spooled is SIGKILLed; the
    supervisor respawns it, the front door routes around it, no client
    request fails, and the generations it held resume elsewhere: every
    token list equals phase 3's or parts at a near tie."""
    base = {i: (fl.health(i) or {}).get("generation", {}) for i in (0, 1)}
    res = {}
    errors = []

    def wave():
        try:
            res.update(lb_round(fl, waves, "crash", copies=CRASH_COPIES))
            res["t_done"] = time.perf_counter()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    th = threading.Thread(target=wave)
    th.start()
    victim = None
    t0 = time.perf_counter()
    while victim is None:
        check(time.perf_counter() - t0 < 120 and th.is_alive(),
              "crash: no replica held a checkpointed generation")
        for i in (0, 1):
            g = (fl.health(i) or {}).get("generation", {})
            if g.get("active_slots", 0) > 0 and g.get(
                    "checkpoints", 0) > base[i].get("checkpoints", 0):
                victim = i
                break
        time.sleep(0.02)
    pid = fl.replica_pid(victim)
    os.kill(pid, signal.SIGKILL)
    t_kill = time.perf_counter()
    ready = fl.wait_ready([victim], t_kill, not_pid=pid)[victim]
    th.join(600)
    if errors:
        raise errors[0]
    check("t_done" in res, "crash: the wave never finished")
    for c in range(CRASH_COPIES):
        compare_tokens(im, waves, untagged(res["tokens"], f"crash{c}"),
                       ref_tokens, "off", f"fleet[crash{c}]",
                       "phase 3 paged f32 run")
    resumed = sum((fl.health(i) or {}).get("generation", {}).get(
        "resumed", 0) for i in (0, 1))
    check(resumed > 0, "crash: no generation was resumed")
    return {"victim": victim, "pid": pid, "ready_s": ready,
            "answered_s": res["t_done"] - t_kill, "resumed": resumed,
            "wall_s": res["wall_s"]}


def fleet_incident(fl: Fleet, victim: int) -> dict:
    """The crash's bundle in ``incident --list``; an operator capture
    after the recovery renders a timeline that holds the victim's
    checkpoints and the resume."""
    rc, doc, _ = fl.action("incident", "--list")
    reasons = [b["reason"] for b in (doc or {}).get("incidents", [])]
    check(f"replica-{victim}-crash" in reasons,
          f"incident: no crash bundle in {reasons}")
    time.sleep(1.5)                  # one spool drain past the recovery
    rc, doc, _ = fl.action("incident")
    check(rc == 0 and doc and doc.get("captured"), f"incident: {doc}")
    rc, doc, _ = fl.action("incident", "--show", "--last", "20")
    kinds = (doc or {}).get("events_by_kind", {})
    check(kinds.get("gen_checkpoint", 0) > 0 and kinds.get("gen_resume", 0)
          > 0, f"incident: the timeline holds {kinds}")
    return {"reasons": reasons, "checkpoints": kinds["gen_checkpoint"],
            "resumes": kinds["gen_resume"]}


def fleet_scale(fl: Fleet, waves) -> dict:
    """Step 5: ``scale 3`` — the new replica boots from the store (mapped,
    no nvcc, warm-up clean) and serves; ``scale 2`` — it retires by
    SIGUSR1 while a wave goes through the front door, every enqueue
    answered 200, and the shared queue stays open."""
    rc, doc, _ = fl.action("scale", "3")
    check(rc == 0 and doc == {"replicas": 3}, f"scale 3: {doc}")
    t0 = time.perf_counter()
    ready = fl.wait_ready([2], t0)[2]
    h = fl.health(2)
    check(h["load"]["mmap"] and h["load"]["nvcc"] == []
          and h["warmup"]["failed"] == 0,
          f"scale 3: replica 2 load {h['load']} warm-up {h['warmup']}")
    before = h["generation"]["finished"]
    lb_round(fl, waves, "s3", copies=3)
    served = fl.health(2)["generation"]["finished"] - before
    check(served > 0, "scale 3: replica 2 served nothing")
    pid2 = fl.replica_pid(2)
    res, errors = {}, []

    def wave():
        try:
            res.update(lb_round(fl, waves, "s2"))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    th = threading.Thread(target=wave)
    th.start()
    time.sleep(0.2)
    rc, doc, _ = fl.action("scale", "2")
    check(rc == 0 and doc == {"replicas": 2}, f"scale 2: {doc}")
    th.join(600)
    if errors:
        raise errors[0]
    t0 = time.perf_counter()
    while pid_alive(pid2):
        check(time.perf_counter() - t0 < 120,
              "scale 2: replica 2 never retired")
        time.sleep(0.1)
    q = FileQueue(os.path.join(fl.tmp, "q"))
    check(q.health().get("admission_open", True),
          "scale 2: the retiring replica closed the shared admission")
    return {"ready_s": ready, "served": served,
            "drain_wave": len(res.get("tokens", {}))}


def fleet_rollout(fl: Fleet, dev, seed: int, waves, publish) -> dict:
    """Step 6: ``v1`` (this deployment's weights) and ``v2`` (another
    seed's, from a second config) published; ``rollout v2`` moves the
    fleet through its canary; results carry ``model_version`` v2 and four
    prompts' tokens equal v2's own in-process tokens (or part at a near
    tie)."""
    publish.join(900)
    check(publish.result == [0, 0], f"publish: {publish.result} "
                                    f"{publish.docs}")
    rc, doc, _ = fl.action("versions")
    check(sorted(v["version"] for v in doc["versions"]) == ["v1", "v2"],
          f"versions: {doc}")
    t0 = time.perf_counter()
    rc, doc, out = fl.action("rollout", "v2")
    check(rc == 0, f"rollout: {doc} {out[-1000:]}")
    while True:
        st = fl.status()
        ro = st.get("rollout") or {}
        members = (st.get("replicas") or {}).get("members", {})
        if ro.get("phase") == "idle" and ro.get("base") == "v2" and \
                members and all(m.get("model_version") == "v2"
                                and m.get("ready")
                                for m in members.values()):
            break
        check(time.perf_counter() - t0 < FLEET_TIMEOUT_S,
              f"rollout: stuck at {ro} {members}")
        check(not ro.get("last_rollback"), f"rollout: rolled back {ro}")
        time.sleep(0.3)
    wall = time.perf_counter() - t0
    for i in (0, 1):
        fl.replica_pid(i)
    four = [[r for r in waves[0][:4]]]
    res = lb_round(fl, four, "v2")
    for rid, doc in res["client"].results.items():
        check(doc.get("model_version") == "v2",
              f"rollout: {rid} served by {doc.get('model_version')}")
    lm2 = TransformerLM(**GPT2_SMALL, seed=seed + 1, device=dev)
    im2 = InferenceModel(device=dev).do_load_model(lm2)
    want = batcher_tokens(im2, four, "off", "auto")
    compare_tokens(im2, four, untagged(res["tokens"], "v2"), want, "off",
                   "fleet[v2]", "v2 in process")
    del im2, lm2
    torch.cuda.empty_cache()
    return {"wall_s": wall, "events": st.get("rollout", {})}


class Publisher(threading.Thread):
    """``manager publish v1`` and ``v2`` (the second config), each in a
    process of its own, both at once, while the fleet serves."""

    def __init__(self, fl: Fleet, cfg2: str):
        super().__init__(daemon=True)
        self.fl, self.cfg2 = fl, cfg2
        self.result, self.docs = [], []

    def run(self):
        procs = [self.fl.cli_popen("publish", ver, config=cfg)
                 for ver, cfg in (("v1", self.fl.config), ("v2", self.cfg2))]
        for proc in procs:
            rc, doc, out = self.fl.cli_wait(proc)
            self.result.append(rc)
            self.docs.append(doc or out.stderr[-1000:])


def fleet_memory() -> str:
    """``nvidia-smi``'s used memory of the card and of each process."""
    try:
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used,memory.total",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"
    return f"card {gpu}; processes {apps or 'not listed'}"


def cold_boot(tmp: str, npz: str, topo: str, store, tag: str,
              dev) -> tuple:
    """A single ``start --foreground`` replica from the ``.npz`` or (with
    ``store``, linked as its pidfile's weight store) from the store:
    seconds from the launch to ``/readyz`` 200, warm-up included."""
    port = free_port()
    sub = os.path.join(tmp, tag)
    os.makedirs(sub)
    cfg = lm_config(sub, "boot.yaml", npz, topo, port, dev)
    fl = Fleet(sub, cfg, port, pidfile="boot.pid")
    if store:
        os.symlink(store, fl.pidfile + ".weights")
    fl._log = open(fl.log_path, "w")
    t0 = time.perf_counter()
    fl.proc = subprocess.Popen(
        list(MANAGER) + ["start", "-c", cfg, "--pidfile", fl.pidfile,
                         "--foreground"], cwd=sub, env=fl.env,
        stdout=fl._log, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        while not fl.ready(0):
            check(fl.proc.poll() is None and time.perf_counter() - t0
                  < FLEET_TIMEOUT_S, f"boot[{tag}]: {fl.log_tail()}")
            time.sleep(0.05)
        wall = time.perf_counter() - t0
        h = fl.health(0)
        check(h["load"]["mmap"] == bool(store) and h["load"]["nvcc"] == [],
              f"boot[{tag}]: load {h['load']}")
        fl.pids.add(fl.proc.pid)
        fl.stop()
    finally:
        fl.kill()
    return wall, h["load"]["seconds"], h["warmup"]["seconds"]


def fleet_phase(seed: int, ref_tokens=None, single=None,
                dev=torch.device("cuda", 0)) -> None:
    """Phase 13: the fleet control plane on the card (see the module
    docstring).  ``ref_tokens``: phase 3's paged f32 tokens (served again
    here when not given); ``single``: phase 3's single engine's tokens/s
    and TTFT p50; ``dev``: the CPU only for a rehearsal at a small size
    (no kernel runs, no launch is counted)."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="zoo-fleet-")
    fl = None
    try:
        waves = make_requests(seed, GPT2_SMALL["vocab_size"])
        npz = os.path.join(tmp, "lm.npz")
        npz2 = os.path.join(tmp, "lm2.npz")

        def lm_weights():
            """Phase 3's model here (for the replays of a near tie) and its
            weights, and another seed's (v2), written as ``.npz`` files."""
            lm = TransformerLM(**GPT2_SMALL, seed=seed, device=dev)
            lm.save_weights(npz)
            TransformerLM(**GPT2_SMALL, seed=seed + 1, device="cpu") \
                .save_weights(npz2)
            return lm

        st = fleet_store_step(seed, dev, tmp, during=lm_weights)
        lm = st["during"]
        say(f"fleet[store]: manager warmup (int8, calibrated on a seeded "
            f"batch) exported {st['store_bytes']} B in "
            f"{st['warmup_s'][0]:.2f} s while this process wrote the LM's "
            f"weights (store_exported "
            f"{st['w1']['store_exported']}, quantized_bits "
            f"{st['w1']['quantized_bits']}, {st['w1']['programs']} "
            f"programs warmed, failed {st['w1']['failed']}, nvcc "
            f"{st['w1']['kernels_built']}); a second warmup skipped it in "
            f"{st['warmup_s'][1]:.2f} s (store_exported "
            f"{st['w2']['store_exported']}, load_mmap "
            f"{st['w2']['load_mmap']}); do_load here: load_mmap True, "
            f"top-5 (and every probability) bit for bit the int8 predict "
            f"of the model quantized here; launches on the card = by the "
            f"wrappers: flash_fwd {st['card']['flash_fwd']}, w8a8 "
            f"{st['card']['w8a8']} a forward; load_seconds from the store "
            f"{st['load_store_s']:.3f} s (page cache warm), from the .npz "
            f"{st['load_npz_s']:.3f} s")
        im = InferenceModel(device=dev).do_load_model(lm)
        if ref_tokens is None:
            ref_tokens = batcher_tokens(im, waves, "off", "auto")
        topo = os.path.join(tmp, "lm_topology.py")
        with open(topo, "w") as f:
            f.write(lm_topology())
        port, lb_port = free_port(), free_port()
        cfg = lm_config(tmp, "fleet.yaml", npz, topo, port, dev)
        cfg2 = lm_config(tmp, "fleet_v2.yaml", npz2, topo, port, dev)
        fl = Fleet(tmp, cfg, port, lb_port).start(2, "--autoscale")
        ready = fl.wait_ready([0, 1], fl.t_start)
        docs = {i: fl.health(i) for i in (0, 1)}
        for i, h in docs.items():
            check(h["load"]["mmap"] and h["load"]["nvcc"] == []
                  and h["warmup"]["state"] == "ready"
                  and h["warmup"]["failed"] == 0
                  and dev.type in h["device"],
                  f"fleet: replica {i} load {h['load']} warm-up "
                  f"{h['warmup']} device {h['device']}")
        prewarm = next((json.loads(ln) for ln in fl.log_tail(10 ** 6)
                        .splitlines() if '"prewarm done"' in ln), None)
        check(prewarm and prewarm["warmup"]["store_exported"]
              and prewarm["warmup"]["failed"] == 0,
              f"fleet: the pre-warm did not export the store "
              f"({prewarm}): {fl.log_tail()}")
        say(f"fleet[start]: manager start --replicas 2 --lb-port "
            f"--autoscale; the pre-warm exported the store "
            f"(load {prewarm['warmup']['load_seconds']:.3f} s from the "
            f".npz, {prewarm['warmup']['programs']} programs warmed, "
            f"failed 0); replicas ready "
            + ", ".join(f"r{i} {ready[i]:.2f} s" for i in sorted(ready))
            + " after the start (load_mmap true, store load "
            + ", ".join(f"{docs[i]['load']['seconds']:.3f}"
                        for i in (0, 1))
            + " s, warm-up "
            + ", ".join(f"{docs[i]['warmup']['seconds']:.3f}"
                        for i in (0, 1))
            + " s, warm-up failed 0, nvcc run by a replica: none)")
        for i, h in docs.items():
            res = h.get("resources") or {}
            say(f"fleet[ledger r{i}]: " + json.dumps(
                {k: res.get(k) for k in sorted(res)
                 if not isinstance(res.get(k), dict)}))
        say(f"fleet[memory]: {fleet_memory()}")
        # step 3: the same tokens through the front door
        ttft = "serving_time_to_first_token_seconds"
        before = {}
        for i in (0, 1):
            for le, c in prom_buckets(replica_prom(fl, i), ttft).items():
                before[le] = before.get(le, 0.0) + c
        lb = lb_round(fl, waves, "lb")
        prom1, per_replica = fleet_prom(fl)
        compare_tokens(im, waves, untagged(lb["tokens"], "lb"), ref_tokens,
                       "off", "fleet[lb]", "phase 3 paged f32 run")
        finished = {i: fl.health(i)["generation"]["finished"]
                    for i in (0, 1)}
        check(all(v > 0 for v in finished.values()),
              f"fleet: a replica served nothing: {finished}")
        steps = prom_value(prom1, "serving_decode_steps_total")
        check(steps > 0 and steps == sum(
            prom_value(t, "serving_decode_steps_total")
            for t in per_replica),
              "fleet: metrics --all-replicas --prom does not sum the "
              "replicas' decode steps")
        p50 = histogram_p50(prom_buckets(prom1, ttft), before)
        check(p50 is not None, "fleet: no TTFT sample in the merged text")
        ids = sorted({r for ep, _, r in lb["client"].replies
                      if ep == "enqueue" and r})
        tok_s = lb["n_tok"] / lb["wall_s"]
        one = (f"; phase 3's single engine from its queue "
               f"{single['tokens_s']:.1f} tokens/s, TTFT p50 "
               f"{single['ttft_p50_s'] * 1e3:.2f} ms (exact)"
               if single else "")
        say(f"fleet[lb]: {len(lb['tokens'])} prompts through the front "
            f"door from {FLEET_CLIENTS} clients: {lb['n_tok']} tokens in "
            f"{lb['wall_s']:.3f} s = {tok_s:.1f} tokens/s, TTFT p50 "
            f"{p50 * 1e3:.1f} ms (histogram_quantile over the fleet's "
            f"merged buckets){one}; records finished by replica "
            f"{finished}, enqueue replies from {ids}; metrics "
            f"--all-replicas --prom: decode steps {steps:.0f} = the "
            f"replicas' sum")
        pr = fleet_profile(fl, waves, dev.type == "cuda")
        say(f"fleet[profile]: manager profile 0 --seconds "
            f"{FLEET_PROFILE_S:g} during a wave: {pr['kernels']} kernel "
            f"events, {pr['paged']} of the paged kernel")
        cr = fleet_crash(fl, im, waves, ref_tokens)
        # v1 and v2 are published while the fleet scales
        publish = Publisher(fl, cfg2)
        publish.start()
        inc = fleet_incident(fl, cr["victim"])
        say(f"fleet[crash]: SIGKILL of replica {cr['victim']} holding "
            f"checkpointed generations mid-decode; no client request "
            f"failed, {cr['resumed']} generation(s) resumed, every token "
            f"list phase 3's (or parting at a near tie); recovered: "
            f"respawn ready {cr['ready_s']:.2f} s and the wave's last "
            f"result {cr['answered_s']:.2f} s after the kill; incident "
            f"bundles {inc['reasons']}, the timeline holds "
            f"{inc['checkpoints']} gen_checkpoint and {inc['resumes']} "
            f"gen_resume events")
        sc = fleet_scale(fl, waves)
        say(f"fleet[scale]: scale 3 -> replica 2 ready {sc['ready_s']:.2f} "
            f"s after the command (store mapped, no nvcc) and served "
            f"{sc['served']} records; scale 2 -> it retired by SIGUSR1 "
            f"while {sc['drain_wave']} prompts went through the front "
            f"door, every enqueue 200, the shared queue open")
        ro = fleet_rollout(fl, dev, seed, waves, publish)
        say(f"fleet[rollout]: published v1, v2; rollout v2 through its "
            f"canary (dwell {FLEET_ROLLOUT['canary_dwell_s']:g} s) to "
            f"promote in {ro['wall_s']:.2f} s; results carry model_version "
            f"v2 and four prompts' tokens equal v2's in-process tokens")
        fl.stop()
        fl = None
        say("fleet[stop]: manager stop left no process behind")
        del im, lm
        torch.cuda.empty_cache()
        boots, errors = {}, []

        def boot(tag, store):
            try:
                boots[tag] = cold_boot(tmp, npz, topo, store, tag, dev)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
        threads = [threading.Thread(target=boot, args=a) for a in (
            ("npz", None), ("store", os.path.join(tmp, "cs.pid.weights")))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(FLEET_TIMEOUT_S + 120)
        if errors:
            raise errors[0]
        check(set(boots) == {"npz", "store"}, f"boot: {sorted(boots)}")
        nb, sb = boots["npz"], boots["store"]
        say(f"fleet[boot]: one replica (start --foreground, warm-up on; "
            f"the two started together) ready {nb[0]:.2f} s from the .npz "
            f"(load {nb[1]:.3f} s, warm-up {nb[2]:.3f} s), {sb[0]:.2f} s "
            f"from the store (load {sb[1]:.3f} s, warm-up {sb[2]:.3f} s)")
    finally:
        if fl is not None:
            fl.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"fleet: phase wall {time.perf_counter() - t_phase:.2f} s")


def replica_prom(fl: Fleet, i: int) -> str:
    st, _, body = http_call(fl.url(i) + "/metrics?format=prom")
    check(st == 200, f"metrics of replica {i}: {st}")
    return body.decode()


def fleet_prom(fl: Fleet):
    """(``manager metrics --all-replicas --prom``, each replica's own
    Prometheus text)."""
    rc, _, out = fl.action("metrics", "--all-replicas", "--prom")
    check(rc == 0, f"metrics --all-replicas --prom: {out[-1000:]}")
    return out, [replica_prom(fl, i) for i in (0, 1)]


# -- main ---------------------------------------------------------------------

# -- phase 14: the Estimator's leftovers -----------------------------------------

# the k-step graph route at TRAIN's widths: K_SEQS sequences make a
# 10-step epoch, run as groups of 4, 4 and 2; of K_EPOCHS epochs the last
# replays only (the first group of the first is the eager warm-up)
K_STEPS = 4
K_SEQS = 80
K_EPOCHS = 2
# the preemption, retry, TensorBoard and profile runs: every epoch is the
# same one group of K_STEPS batches (RESUME_SEQS sequences), so a fit
# resumed or retried at a group's end sees the batches of an
# uninterrupted one; RESUME_STEPS steps in all
RESUME_SEQS = 32
RESUME_STEPS = 16
# the retry run: RETRY_EPOCHS one-group epochs, checkpointed at each
# epoch's end; the listener of step RETRY_FAIL_AT raises once
RETRY_EPOCHS = 2
RETRY_FAIL_AT = 6
# the same steps on two routes, or across processes, run the same kernels
# in the same order: the weights agree to this (f32 parameters <= ~1)
K_WEIGHT_TOL = 1e-5
K_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def k_data(seed: int):
    """``K_SEQS`` sequences of ``train_data``'s kind: its own, then the
    next seeds' as needed."""
    xs, ys, i = [], [], 0
    while sum(len(a) for a in xs) < K_SEQS:
        x, y = train_data(seed + i)
        xs.append(x)
        ys.append(y)
        i += 1
    return np.concatenate(xs)[:K_SEQS], np.concatenate(ys)[:K_SEQS]


def resume_data(seed: int):
    x, y = train_data(seed)
    return x[:RESUME_SEQS], y[:RESUME_SEQS]


def k_estimator(model, seed: int, ckpt=None, trigger=None) -> Estimator:
    """``train_run``'s Estimator (Adam, global-norm clipping), with
    checkpoints under ``ckpt`` on ``trigger`` (default: never, so only a
    preemption snapshots)."""
    dev = next(model.parameters()).device
    est = Estimator(model, optimizer=Adam(lr=TRAIN_LR),
                    loss="sparse_categorical_crossentropy",
                    clip_norm=TRAIN_CLIP, registry=MetricsRegistry(),
                    ctx=ZooContext(ZooConf(seed=seed, device=str(dev))))
    if ckpt is not None:
        est.set_checkpoint(ckpt, trigger=trigger or SeveralIteration(
            10 ** 9))
    return est


def k_fit(est, data, k: int, epochs: int, marks=(), **kw) -> dict:
    """``est.fit(data)`` at ``TRAIN_BATCH``, unshuffled, ``k`` steps a
    call: each step's loss (device tensors kept by a listener, read after
    the run; a step run twice keeps its last), the host clock after a
    device sync at each step in ``marks``, and the wall."""
    dev = est.device
    losses, times = {}, {}

    def listen(step, loss):
        losses[step] = loss
        if step in marks:
            sync(dev)
            times[step] = time.perf_counter()

    est._listeners.append(listen)
    sync(dev)
    t0 = time.perf_counter()
    try:
        est.fit(data, batch_size=TRAIN_BATCH, epochs=epochs, verbose=False,
                shuffle=False, steps_per_call=k, **kw)
        sync(dev)
    finally:
        est._listeners.remove(listen)
    return {"losses": {s: float(v) for s, v in sorted(losses.items())},
            "times": times, "wall_s": time.perf_counter() - t0}


def losses_gap(a: dict, b: dict) -> float:
    """Largest loss difference over the steps both runs hold."""
    steps = sorted(set(a) & set(b))
    check(steps, "no common steps to compare")
    return max(abs(a[s] - b[s]) for s in steps)


def weights_gap(a, b) -> float:
    return max(float((u - v).abs().max()) for u, v in zip(a, b))


def free(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def graph_vs_eager(host, seed: int, dev, card: bool = True) -> dict:
    """The same weights and data trained ``K_EPOCHS`` epochs eagerly and
    with ``steps_per_call=K_STEPS`` (CUDA graphs on the card): each
    step's loss within ``TRAIN_LOSS_TOL``, the weights within
    ``K_WEIGHT_TOL``, one capture for each group size, a replay for
    every later group; ms a step over the last epoch (replays only on
    the graph route).  Then one epoch through the graph route under a
    trace of the card: each flash kernel launched ``n_block`` x steps
    times, the wrappers counting only the eager warm-up group's."""
    from analytics_zoo_tpu_torch.inference import aot
    x, y = k_data(seed)
    n = x.shape[0] // TRAIN_BATCH
    steps = K_EPOCHS * n
    sizes = {K_STEPS, n % K_STEPS or K_STEPS}
    groups = -(-n // K_STEPS)
    runs = {}
    for tag, k in (("eager", 1), ("graph", K_STEPS)):
        model = copy.deepcopy(host).to(dev)
        est = k_estimator(model, seed)
        cap0 = aot.CAPTURE_STATS.snapshot()
        run = k_fit(est, ArrayFeatureSet(x, y), k, K_EPOCHS,
                    marks=(n, steps))
        cap = aot.CAPTURE_STATS.snapshot()
        run["captures"] = cap["captures"] - cap0["captures"]
        run["replays"] = cap["replays"] - cap0["replays"]
        run["params"] = [p.detach().clone() for p in model.parameters()]
        run["ms"] = (run["times"][steps] - run["times"][n]) / n * 1e3
        check(sorted(run["losses"]) == list(range(1, steps + 1)),
              f"estimator[{tag}]: steps {sorted(run['losses'])}")
        runs[tag] = run
        del model, est
        free(dev)
    graph, eager = runs["graph"], runs["eager"]
    if dev.type == "cuda":
        check(graph["captures"] == len(sizes)
              and graph["replays"] == K_EPOCHS * groups - 1,
              f"estimator[graph]: {graph['captures']} captures, "
              f"{graph['replays']} replays (want {len(sizes)}, "
              f"{K_EPOCHS * groups - 1})")
    gap = losses_gap(graph["losses"], eager["losses"])
    wgap = weights_gap(graph["params"], eager["params"])
    check(gap <= TRAIN_LOSS_TOL,
          f"estimator: graph and eager losses differ by {gap:.3e} > "
          f"{TRAIN_LOSS_TOL}")
    check(wgap <= K_WEIGHT_TOL,
          f"estimator: graph and eager weights differ by {wgap:.3e} > "
          f"{K_WEIGHT_TOL}")
    ls = [eager["losses"][s] for s in range(1, steps + 1)]
    check(all(math.isfinite(v) for v in ls) and ls[-1] < ls[0],
          f"estimator: losses {ls}")
    say(f"estimator[graph vs eager]: {steps} steps of {TRAIN_BATCH} x "
        f"{TRAIN['seq_len']} tokens, steps_per_call {K_STEPS} (groups of "
        f"{sorted(sizes, reverse=True)}): {graph['captures']} captures, "
        f"{graph['replays']} replays; loss max abs diff {gap:.3e} "
        f"(tolerance {TRAIN_LOSS_TOL}), weights {wgap:.3e} (tolerance "
        f"{K_WEIGHT_TOL}); loss {ls[0]:.4f} -> {ls[-1]:.4f}; epoch "
        f"{K_EPOCHS} ms/step (host clock, synced): graph "
        f"{graph['ms']:.2f}, eager {eager['ms']:.2f}; walls "
        f"{graph['wall_s']:.2f} / {eager['wall_s']:.2f} s")
    out = {"graph_ms": graph["ms"], "eager_ms": eager["ms"],
           "loss_gap": gap, "weight_gap": wgap}
    if not card:
        return out
    model = copy.deepcopy(host).to(dev)
    est = k_estimator(model, seed)
    reset_launches()
    with _impl.card_launches(K_KERNELS) as counts:
        traced = k_fit(est, ArrayFeatureSet(x, y), K_STEPS, 1)
    del model, est
    free(dev)
    want = TRAIN["n_block"] * n
    first = TRAIN["n_block"] * min(K_STEPS, n)
    wrappers = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
                "flash_bwd_dkv": fa.dkv_launches}
    check(all(counts[k] == want for k in K_KERNELS),
          f"estimator[traced]: launches on the card {dict(counts)}, want "
          f"{want} each")
    check(all(wrappers[k] == first for k in K_KERNELS),
          f"estimator[traced]: launches by the wrappers {wrappers}, want "
          f"{first} each (the eager warm-up group)")
    tgap = losses_gap(traced["losses"], graph["losses"])
    check(tgap <= TRAIN_LOSS_TOL,
          f"estimator[traced]: losses {tgap:.3e} from the timed run's")
    say(f"estimator[traced]: one epoch of {n} steps through the graph "
        f"route under a trace of the card: flash forward / dq / dk/dv "
        f"launches on the card {counts['flash_fwd']} / "
        f"{counts['flash_bwd_dq']} / {counts['flash_bwd_dkv']} (= "
        f"{TRAIN['n_block']} blocks x {n} steps), by the wrappers "
        f"{wrappers['flash_fwd']} / {wrappers['flash_bwd_dq']} / "
        f"{wrappers['flash_bwd_dkv']} (the eager warm-up group); losses "
        f"{tgap:.3e} from the timed run's")
    out["card"] = dict(counts)
    return out


def resume_reference(host, seed: int, dev) -> dict:
    """The uninterrupted run the preemption, retry and TensorBoard steps
    are held to: ``RESUME_STEPS`` steps of one-group epochs through the
    graph route, with the weights after ``RETRY_EPOCHS`` epochs."""
    x, y = resume_data(seed)
    model = copy.deepcopy(host).to(dev)
    est = k_estimator(model, seed)
    kept = {}

    def keep(step, loss):
        if step == RETRY_EPOCHS * K_STEPS:
            kept["params"] = [p.detach().clone() for p in model.parameters()]

    est._listeners.append(keep)
    run = k_fit(est, ArrayFeatureSet(x, y), K_STEPS,
                RESUME_STEPS // K_STEPS)
    del model, est
    free(dev)
    check(sorted(run["losses"]) == list(range(1, RESUME_STEPS + 1)),
          f"estimator[reference]: steps {sorted(run['losses'])}")
    run["params"] = kept["params"]
    return run


def fit_victim(tmp: str, seed: int, resume: bool = False, device=None,
               wait_s: float = 600.0) -> int:
    """``--fit-victim DIR``: ``resume_reference``'s fit in a fresh
    process, checkpointing into ``DIR/ckpt`` only when preempted, printing
    a JSON line a step; with ``--resume``, ``fit(resume=True)`` from the
    snapshot there.  The model is built on the host first; then the
    process prints ``ready`` and waits for ``DIR/go`` (``DIR/go-resume``)
    before it touches the card, so its start costs the phase no time.
    Exits 1 without a go within ``wait_s``."""
    dev = device or torch.device("cuda", 0)
    # a resumed fit restores every weight: the seeded draw is skipped
    model = train_layers() if resume else build_train_model(seed)
    go = os.path.join(tmp, "go-resume" if resume else "go")
    say(json.dumps({"phase": "ready", "resume": resume}))
    t0 = time.monotonic()
    while not os.path.exists(go):
        if time.monotonic() - t0 > wait_s:
            say(f"fit victim: no {go} within {wait_s} s")
            return 1
        time.sleep(0.02)
    model = model.to(dev)
    x, y = resume_data(seed)
    est = k_estimator(model, seed, ckpt=os.path.join(tmp, "ckpt"))
    est._listeners.append(lambda step, loss: say(json.dumps(
        {"step": step, "loss": float(loss)})))
    say(json.dumps({"phase": "start", "resume": resume}))
    est.fit(x, y, batch_size=TRAIN_BATCH, epochs=RESUME_STEPS,
            verbose=False, shuffle=False, steps_per_call=K_STEPS,
            resume=resume, end_trigger=MaxIteration(RESUME_STEPS))
    say(json.dumps({"phase": "done", "step": est.global_step}))
    return 0


def step_lines(lines) -> dict:
    docs = [json.loads(line) for line in lines
            if line.startswith('{"step"')]
    return {d["step"]: d["loss"] for d in docs}


def start_fit_victims(seed: int, tmp: str, victim_cmd=None) -> dict:
    """The preempted fit's process and the one that resumes it
    (``--fit-victim DIR [--resume]``), started now; each builds its model
    on the host and waits for its go file."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = victim_cmd or [sys.executable, os.path.join(here, "chip_smoke.py"),
                         "--fit-victim", tmp, "--seed", str(seed)]
    procs = {"t0": time.perf_counter()}
    for tag, extra in (("victim", []), ("resumed", ["--resume"])):
        log = open(os.path.join(tmp, f"fit-{tag}.log"), "w")
        procs[tag] = (subprocess.Popen(cmd + extra, cwd=here,
                                       stdout=subprocess.PIPE, stderr=log,
                                       text=True), log)
    return procs


def stop_fit_victims(procs: dict) -> None:
    for tag in ("victim", "resumed"):
        proc, log = procs[tag]
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def read_until(proc, prefix: str, lines: list) -> None:
    """Read ``proc``'s output into ``lines`` up to and including the
    first line that starts with ``prefix``."""
    for line in proc.stdout:
        lines.append(line)
        if line.startswith(prefix):
            return
    check(False, f"estimator[preempt]: the process ended (exit "
                 f"{proc.wait()}) before a line starting {prefix!r}")


def preemption_step(seed: int, ref: dict, tmp: str, procs: dict,
                    timeout_s: float = 300.0) -> dict:
    """The victim (``start_fit_victims``) is let go and gets SIGTERM once
    its first step's loss is out: it must exit 128 + 15 leaving a whole
    snapshot at the last step it printed; then the waiting process
    resumes from it to ``RESUME_STEPS``; every loss either prints is the
    reference's."""
    from analytics_zoo_tpu_torch.estimator.checkpoint import \
        CheckpointManager
    victim, resumed = procs["victim"][0], procs["resumed"][0]
    lines, lines2 = [], []
    read_until(victim, '{"phase": "ready"', lines)
    read_until(resumed, '{"phase": "ready"', lines2)
    t_ready = time.perf_counter() - procs["t0"]
    t0 = time.perf_counter()
    open(os.path.join(tmp, "go"), "w").close()
    read_until(victim, '{"step"', lines)
    t_signal = time.perf_counter() - t0
    victim.send_signal(signal.SIGTERM)
    out, _ = victim.communicate(timeout=timeout_s)
    lines += out.splitlines()
    t_exit = time.perf_counter() - t0
    open(os.path.join(tmp, "go-resume"), "w").close()
    out2, _ = resumed.communicate(timeout=timeout_s)
    t_resume = time.perf_counter() - t0 - t_exit
    seen = step_lines(lines)
    steps = CheckpointManager(os.path.join(tmp, "ckpt")).steps()
    check(victim.returncode == 128 + signal.SIGTERM,
          f"estimator[preempt]: the victim exited {victim.returncode}, not "
          f"143 (log {os.path.join(tmp, 'fit-victim.log')})")
    check(seen and steps and steps[-1] == max(seen) < RESUME_STEPS,
          f"estimator[preempt]: snapshots {steps} after steps "
          f"{sorted(seen)}")
    check(resumed.returncode == 0,
          f"estimator[preempt]: the resumed fit exited {resumed.returncode}"
          f" (log {os.path.join(tmp, 'fit-resumed.log')})")
    done = step_lines(out2.splitlines())
    check(sorted(done) == list(range(steps[-1] + 1, RESUME_STEPS + 1)),
          f"estimator[preempt]: resumed steps {sorted(done)} after the "
          f"snapshot at {steps[-1]}")
    gap = max(losses_gap(seen, ref["losses"]),
              losses_gap(done, ref["losses"]))
    check(gap <= TRAIN_LOSS_TOL,
          f"estimator[preempt]: losses {gap:.3e} from the uninterrupted "
          f"run's")
    snap_bytes = sum(os.path.getsize(os.path.join(root, f))
                     for root, _, files in os.walk(os.path.join(tmp, "ckpt"))
                     for f in files)
    say(f"estimator[preempt]: both processes ready (model built on the "
        f"host) {t_ready:.2f} s after their start; the victim's step 1 "
        f"{t_signal:.2f} s after its go, then SIGTERM: exit "
        f"{victim.returncode} {t_exit - t_signal:.2f} s later with a "
        f"snapshot at step {steps[-1]} ({snap_bytes} B); fit(resume=True) "
        f"in the other process ran steps {steps[-1] + 1}-{RESUME_STEPS} in "
        f"{t_resume:.2f} s after its go; losses of both processes "
        f"{gap:.3e} from the uninterrupted run's (tolerance "
        f"{TRAIN_LOSS_TOL})")
    return {"snapshot_step": steps[-1], "gap": gap,
            "snapshot_bytes": snap_bytes}


def retry_step(host, seed: int, dev, ref: dict, tmp: str) -> dict:
    """``RETRY_EPOCHS`` one-group epochs checkpointed at each epoch's
    end; a ``FaultInjector`` raises in the listener of step
    ``RETRY_FAIL_AT``: the fit restores the last snapshot, runs the
    epoch again and ends on the reference's weights."""
    from analytics_zoo_tpu_torch.common.triggers import EveryEpoch
    from analytics_zoo_tpu_torch.utils.chaos import FaultInjector
    x, y = resume_data(seed)
    model = copy.deepcopy(host).to(dev)
    est = k_estimator(model, seed, ckpt=os.path.join(tmp, "retry"),
                      trigger=EveryEpoch())
    inj = FaultInjector().fail_at("step", indices=[RETRY_FAIL_AT - 1])
    est._listeners.append(lambda step, loss: inj.maybe_fail("step"))
    run = k_fit(est, ArrayFeatureSet(x, y), K_STEPS, RETRY_EPOCHS)
    params = [p.detach().clone() for p in model.parameters()]
    saved = est._ckpt_mgr.steps()
    del model, est
    free(dev)
    want = RETRY_EPOCHS * K_STEPS
    check(inj.fired == [f"step#{RETRY_FAIL_AT - 1}"],
          f"estimator[retry]: the fault fired {inj.fired}")
    check(sorted(run["losses"]) == list(range(1, want + 1)),
          f"estimator[retry]: steps {sorted(run['losses'])}")
    gap = losses_gap(run["losses"], ref["losses"])
    wgap = weights_gap(params, ref["params"])
    check(gap <= TRAIN_LOSS_TOL and wgap <= K_WEIGHT_TOL,
          f"estimator[retry]: losses {gap:.3e}, weights {wgap:.3e} from "
          f"the uninterrupted run's")
    say(f"estimator[retry]: the fault in step {RETRY_FAIL_AT}'s listener "
        f"restored step {(RETRY_FAIL_AT - 1) // K_STEPS * K_STEPS}'s "
        f"snapshot; {want} steps in {run['wall_s']:.2f} s, snapshots "
        f"kept {saved}; losses {gap:.3e}, weights {wgap:.3e} from the "
        f"uninterrupted run's")
    return {"gap": gap, "weight_gap": wgap}


def trace_kernels(path: str) -> dict:
    """Kernel events of a Chrome trace by ``K_KERNELS``' names."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {k: 0 for k in K_KERNELS}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for k in K_KERNELS:
            if _impl.KERNEL_NAMES[k] in str(e.get("name")):
                counts[k] += 1
    return counts


def tensorboard_step(host, seed: int, dev, ref: dict, tmp: str,
                     card: bool = True) -> dict:
    """Two one-group epochs fed from a ``NativeFeatureSet`` (its batches
    those of an ``ArrayFeatureSet``, shuffled and not), with TensorBoard
    summaries and a ``profile_dir`` trace: losses the reference's; the
    event files read back (``Loss`` at every group and epoch end,
    ``Throughput`` and ``StepTime_ms_mean`` an epoch, the ``StepTime_s``
    histogram holding every step); the trace holding each flash kernel
    ``n_block`` x steps times."""
    from analytics_zoo_tpu_torch.feature.dataset import NativeFeatureSet
    from analytics_zoo_tpu_torch.utils.tbwriter import (read_histograms,
                                                         read_scalars)
    x, y = resume_data(seed)
    native = NativeFeatureSet(x, y)
    try:
        for shuffle in (False, True):
            a = native.batches(TRAIN_BATCH, shuffle=shuffle,
                               rng=np.random.default_rng(1))
            b = ArrayFeatureSet(x, y).batches(
                TRAIN_BATCH, shuffle=shuffle, rng=np.random.default_rng(1))
            for u, v in zip(a, b):
                check(all(np.array_equal(p, q) for p, q in zip(u, v)),
                      "estimator[native]: a batch differs from "
                      "ArrayFeatureSet's")
        model = copy.deepcopy(host).to(dev)
        est = k_estimator(model, seed)
        est.set_tensorboard(os.path.join(tmp, "tb"), "phase14")
        est.ctx.conf.profile_dir = os.path.join(tmp, "profile")
        epochs = 2
        run = k_fit(est, native, K_STEPS, epochs, log_every=K_STEPS)
        trace = est.profile_path
        del model, est
        free(dev)
    finally:
        native.close()
    steps = epochs * K_STEPS
    gap = losses_gap(run["losses"], ref["losses"])
    check(sorted(run["losses"]) == list(range(1, steps + 1))
          and gap <= TRAIN_LOSS_TOL,
          f"estimator[tensorboard]: steps {sorted(run['losses'])}, losses "
          f"{gap:.3e} from the reference's")
    logdir = os.path.join(tmp, "tb", "phase14", "train")
    scalars, hists = read_scalars(logdir), read_histograms(logdir)
    ends = [K_STEPS * (e + 1) for e in range(epochs)]
    got = {t: [s for s, _ in v] for t, v in scalars.items()}
    check(got == {"Loss": sorted(ends + ends), "Throughput": ends,
                  "StepTime_ms_mean": ends}
          and [(s, h["num"]) for s, h in hists["StepTime_s"]]
          == [(s, float(s)) for s in ends],
          f"estimator[tensorboard]: scalars {got}, histograms "
          f"{[(s, h['num']) for s, h in hists.get('StepTime_s', [])]}")
    t0 = time.perf_counter()
    kernels = trace_kernels(trace)
    want = TRAIN["n_block"] * steps if card else 0
    check(all(kernels[k] == want for k in K_KERNELS),
          f"estimator[profile]: the trace's kernels {kernels}, want {want}"
          f" each")
    say(f"estimator[tensorboard]: {steps} steps fed from a NativeFeatureSet"
        f" (its batches ArrayFeatureSet's), losses {gap:.3e} from the "
        f"reference's; event file {sum(len(v) for v in got.values())} "
        f"scalars {got}, StepTime_s histograms of "
        f"{[h['num'] for _, h in hists['StepTime_s']]} steps; profile "
        f"{os.path.getsize(trace)} B (read in "
        f"{time.perf_counter() - t0:.2f} s): flash forward / dq / dk/dv "
        f"kernels {kernels['flash_fwd']} / {kernels['flash_bwd_dq']} / "
        f"{kernels['flash_bwd_dkv']}")
    return {"kernels": kernels}


def estimator_phase(seed: int, records: dict, host=None) -> dict:
    """Phase 14: the k-step graph route against eager steps, preemption,
    failure retry, TensorBoard, profile_dir and NativeFeatureSet, all on
    ``TRAIN``'s model from the same seeded weights (``host``, phase 5's
    host copy, when given).  The preemption's two processes start after
    the timed graph-vs-eager runs and build their models while the
    reference and retry runs go on."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    host = host if host is not None else build_train_model(seed)
    walls = {}
    out = {"graph": graph_vs_eager(host, seed, dev)}
    walls["graph"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="phase14-") as tmp:
        procs = start_fit_victims(seed, tmp)
        try:
            t = time.perf_counter()
            ref = resume_reference(host, seed, dev)
            out["retry"] = retry_step(host, seed, dev, ref, tmp)
            walls["reference+retry"] = time.perf_counter() - t
            t = time.perf_counter()
            out["preempt"] = preemption_step(seed, ref, tmp, procs)
            walls["preempt"] = time.perf_counter() - t
        finally:
            stop_fit_victims(procs)
        t = time.perf_counter()
        out["tensorboard"] = tensorboard_step(host, seed, dev, ref, tmp)
        walls["tensorboard"] = time.perf_counter() - t
    for key, name in (("flash", "flash_fwd"),
                      ("flash_bwd_dq", "flash_bwd_dq"),
                      ("flash_bwd_dkv", "flash_bwd_dkv")):
        records[key]["graph_launches"] = out["graph"]["card"][name]
    say(f"estimator: phase wall {time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()) + ")")
    return out


# -- phase 15: the remaining layers; MobileNet v1 trained and served ----------

# MobileNet v1 (Howard et al. 2017, arXiv:1704.04861, Table 1; the topology
# of tf.keras.applications.MobileNet) at alpha 1.0, 224x224, 1000 classes
MOBILENET = dict(alpha=1.0, input_shape=(224, 224, 3), classes=1000)
MOBILENET_PARAMS = 4_231_976
# (pointwise filters, depthwise stride) of the 13 separable blocks
MOBILENET_BLOCKS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                    (512, 2), (512, 1), (512, 1), (512, 1), (512, 1),
                    (512, 1), (1024, 2), (1024, 1))
MOBILENET_PAIRS = 13
MOBILENET_BATCH = 128
MOBILENET_BATCHES = 10             # an epoch; the fit runs two
MOBILENET_EPOCHS = 2
MOBILENET_K = 4                    # steps a CUDA graph
MOBILENET_LR = 0.05
MOBILENET_MOMENTUM = 0.9
MOBILENET_CLASSES = 100            # planted classes among the 1000
MOBILENET_LOCKSTEP = 3
# kernel vs plain training-forward loss at the same weights: ResNet's
MOBILENET_LOSS_TOL = RESNET_LOSS_TOL
MOBILENET_SERVE_BATCH = 16
MOBILENET_RECORDS = 64
# a forward's launches of each kernel, by precision: the 13 pointwise
# convs and the head on the matmul kernels, the stem on w8a8_conv2d
MOBILENET_LAUNCHES = {"f32": {},
                      "int8": {"w8a8": 14, "w8a8_conv": 1},
                      "int4": {"w4a16": 14}}
# the other new layers on the card against their CPU results: f32 summed
# in another order by cuDNN / cuBLAS than by oneDNN / ATen on the CPU
CARD_LAYER_TOL = (1e-4, 1e-4)
# MixtureOfExperts at GPT-2-small width: D 768, H 3072, 8 experts, top 2,
# 8 x 1024 tokens (its CPU reference takes the first sequence: each token
# is computed alone)
MOE = dict(num_experts=8, hidden_dim=3072, top_k=2)
MOE_X = (8, 1024, 768)
LAYERS_WALL_S = 60.0


def mobilenet_v1(alpha=1.0, input_shape=(224, 224, 3), classes=1000,
                 k2=keras2, graph=tgraph, models=tmodels):
    """MobileNet v1 through ``k2``'s constructors (the port's ``keras2`` by
    default; the tests pass the JAX package's): a 3x3/2 stem conv, 13
    depthwise-3x3 + BN + ReLU6 and pointwise-1x1 + BN + ReLU6 pairs,
    global average pooling, dropout 1e-3 and Dense(classes, softmax).
    Widths are ``int(filters * alpha)``; every layer is named as in
    tf.keras's MobileNet, so two packages' param trees match."""
    def width(n):
        return int(n * alpha)
    x = graph.Input(tuple(input_shape), name="input")
    h = k2.Conv2D(width(32), 3, strides=2, padding="same", use_bias=False,
                  name="conv1")(x)
    h = k2.BatchNormalization(name="conv1_bn")(h)
    h = k2.Activation("relu6", name="conv1_relu")(h)
    for i, (filters, stride) in enumerate(MOBILENET_BLOCKS, 1):
        h = k2.DepthwiseConv2D(3, strides=stride, padding="same",
                               use_bias=False, name=f"conv_dw_{i}")(h)
        h = k2.BatchNormalization(name=f"conv_dw_{i}_bn")(h)
        h = k2.Activation("relu6", name=f"conv_dw_{i}_relu")(h)
        h = k2.Conv2D(width(filters), 1, padding="same", use_bias=False,
                      name=f"conv_pw_{i}")(h)
        h = k2.BatchNormalization(name=f"conv_pw_{i}_bn")(h)
        h = k2.Activation("relu6", name=f"conv_pw_{i}_relu")(h)
    h = k2.GlobalAveragePooling2D(name="global_pool")(h)
    h = k2.Dropout(1e-3, name="dropout")(h)
    y = k2.Dense(classes, activation="softmax", name="predictions")(h)
    return models.Model(input=x, output=y,
                        name=f"mobilenet_{alpha:.2f}_{input_shape[0]}")


def mobilenet_data(seed: int, batches: int = MOBILENET_BATCHES):
    """``batches`` batches of MOBILENET_BATCH 224x224x3 f32 images (and
    one held out) of MOBILENET_CLASSES classes drawn from the 1000: each
    class a per-channel offset ~ N(0, 1) under unit noise."""
    g = np.random.default_rng(seed + 150)
    shape = MOBILENET["input_shape"]
    n = (batches + 1) * MOBILENET_BATCH
    classes = g.choice(MOBILENET["classes"], MOBILENET_CLASSES,
                       replace=False)
    offsets = g.standard_normal((MOBILENET_CLASSES, 3)).astype(np.float32)
    pick = g.integers(0, MOBILENET_CLASSES, n)
    x = g.standard_normal((n,) + tuple(shape), dtype=np.float32)
    x += offsets[pick][:, None, None, :]
    y = classes[pick].astype(np.int64)
    b = batches * MOBILENET_BATCH
    return x[:b], y[:b], x[b:], y[b:]


def mobilenet_estimator(model, seed: int) -> Estimator:
    dev = next(model.parameters()).device
    return Estimator(model, optimizer=SGD(lr=MOBILENET_LR,
                                          momentum=MOBILENET_MOMENTUM),
                     loss="sparse_categorical_crossentropy",
                     metrics=["accuracy"], registry=MetricsRegistry(),
                     ctx=ZooContext(ZooConf(seed=seed, device=str(dev))))


def mobilenet_train(model, x, y, seed: int) -> dict:
    """``Estimator.fit`` for MOBILENET_EPOCHS epochs with
    ``steps_per_call=MOBILENET_K`` (on the card the first group runs
    eagerly, every later one as a CUDA-graph replay), the counts set to 0
    just before and read just after, under a trace of the card: each
    step's loss, the host clock after a device sync at each epoch's last
    step, fused_bn launches on the card and by the wrapper."""
    dev = next(model.parameters()).device
    est = mobilenet_estimator(model, seed)
    losses, times = {}, {}

    def listen(step, loss):
        losses[step] = loss
        if step % MOBILENET_BATCHES == 0:
            sync(dev)
            times[step] = time.perf_counter()
    est._listeners.append(listen)
    sync(dev)
    reset_launches()
    with _impl.card_launches(("fused_bn",)) as on_card:
        t0 = time.perf_counter()
        est.fit(x, y, batch_size=MOBILENET_BATCH, epochs=MOBILENET_EPOCHS,
                verbose=False, steps_per_call=MOBILENET_K)
        sync(dev)
    marks = [t0] + [times[s] for s in sorted(times)]
    return {"losses": [float(losses[s]) for s in sorted(losses)],
            "walls": [b - a for a, b in zip(marks, marks[1:])],
            "card": on_card["fused_bn"], "wrapper": fb.launches}


def check_mobilenet_train(run: dict, card: bool = True) -> None:
    """Finite losses, one a step; the second epoch's mean below the first
    step's and below the first epoch's mean; fused_bn launches on the card
    = 13 x steps (none off the card)."""
    ls = run["losses"]
    steps = MOBILENET_EPOCHS * MOBILENET_BATCHES
    check(len(ls) == steps and all(math.isfinite(v) for v in ls),
          f"mobilenet train: losses {ls}")
    half = len(ls) // 2
    first, second = np.mean(ls[:half]), np.mean(ls[half:])
    check(second < first and second < ls[0],
          f"mobilenet train: the loss did not fall ({ls})")
    want = MOBILENET_PAIRS * steps if card else 0
    check(run["card"] == want,
          f"mobilenet train: fused_bn launches on the card {run['card']} "
          f"!= {MOBILENET_PAIRS} x {steps}")
    img = MOBILENET_BATCHES * MOBILENET_BATCH
    last = run["walls"][-1]
    say(f"mobilenet train: {steps} steps of {MOBILENET_BATCH} images in "
        f"{MOBILENET_EPOCHS} epochs, {MOBILENET_K} steps a CUDA graph; the "
        f"last epoch {last:.3f} s (host clock) = "
        f"{last / MOBILENET_BATCHES * 1e3:.2f} ms/step, "
        f"{img / last:.1f} images/s (first epoch {run['walls'][0]:.3f} s, "
        f"with the eager group and the capture); losses "
        f"{[round(v, 4) for v in ls]}; fused_bn launches on the card "
        f"{run['card']} (= {MOBILENET_PAIRS} x {steps}), by the wrapper "
        f"{run['wrapper']} (the eager group's)")


def mobilenet_lockstep(host, x, y, seed: int) -> list:
    """MOBILENET_LOCKSTEP steps of the plain route (the Estimator's own
    step, ``impl="torch"``); before each, the training forward's loss
    through the kernel from the same weights, BN state and dropout seed
    (the state restored after it).  Returns (kernel, plain) loss pairs and
    the fused launches of the kernel forwards."""
    model = copy.deepcopy(host)
    est = mobilenet_estimator(model, seed)
    est._ensure_init()
    batches = list(ArrayFeatureSet(x, y).batches(
        MOBILENET_BATCH, shuffle=True, rng=np.random.default_rng(seed),
        pad_final=True))[:MOBILENET_LOCKSTEP]
    pairs = []
    model.train()
    reset_launches()
    for batch in batches:
        sx, sy, sw, *_ = est._transfer(batch)
        state = [b.clone() for b in model.buffers()]
        set_impl(model, None)
        est._seed_step(est.global_step)
        with torch.no_grad():
            lk = est._loss_sum(model(sx), sy, sw) / sw.sum()
        with torch.no_grad():
            for b, s in zip(model.buffers(), state):
                b.copy_(s)
        set_impl(model, "torch")
        lp = est._train_step(sx, sy, sw)
        est.global_step += 1
        pairs.append((float(lk), float(lp)))
    fused = fb.launches
    del model, est
    return pairs, fused


def mobilenet_kernel_phase(seed: int, model) -> dict:
    """fused_bn at the fusion plan's shapes at batch 128 (K = 32 to 1024)
    and the quantized forward's kernels at batch 16: the stem on
    w8a8_conv2d (cin 3, 3x3/2, the byte-gather route), the 13 pointwise
    convs and the head on w8a8 / w4a16; each against its plain version,
    then timed and summed over a step's or a forward's launches."""
    shapes = fused_bn_shapes(model, MOBILENET_BATCH)
    check(sum(shapes.values()) == MOBILENET_PAIRS,
          f"mobilenet: fusion plan shapes {shapes}")
    g = np.random.default_rng(seed + 151)
    rows, worst = [], (0.0, 0.0)
    for (m, k, n), pairs in shapes.items():
        x, w = fused_bn_case(g, m, k, n, torch.float32)
        got = fb.fused_bn(x, w, impl="cuda")
        sync(x.device)
        ref = fb.fused_bn(x, w, impl="torch")
        err = check_fused_bn(f"fused_bn[mobilenet ({m}, {k}, {n})]", got,
                             ref)
        worst = tuple(max(a, b) for a, b in zip(worst, err))
        t = fused_bn_time(x, w, 20)
        t["plain_ms"] = cuda_ms(lambda: fb.fused_bn(x, w, impl="torch"),
                                iters=5, warmup=1)
        b = fused_bn_bound(m, k, n, torch.float32)
        rows.append(dict(shape=[m, k, n], pairs=pairs, **t,
                         bound_ms=b["bound_ms"], bound_by=b["bound_by"]))
        say(f"fused_bn[mobilenet] ({m}, {k}) @ ({k}, {n}) x {pairs}: y max "
            f"abs err {err[0]:.3e}, sums {err[1]:.3e}; kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.matmul "
            f"+ stats pass {t['library_ms']:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}), "
            f"{100 * b['bound_ms'] / t['ms']:.1f}% of bound")
        del x, w, got, ref
    step = {key: sum(r[key] * r["pairs"] for r in rows)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    say(f"fused_bn[mobilenet] a step's {MOBILENET_PAIRS} launches: kernel "
        f"{step['ms']:.3f} ms, plain {step['plain_ms']:.3f} ms, "
        f"torch.matmul + stats {step['library_ms']:.3f} ms, bounds "
        f"{step['bound_ms']:.3f} ms "
        f"({100 * step['bound_ms'] / step['ms']:.1f}% of the kernel's)")
    inv = conv_inventory(model, MOBILENET_SERVE_BATCH)
    spatial, matmuls = inv["spatial"], inv["matmuls"]
    check((len(spatial), len(matmuls)) == (1, 14),
          f"mobilenet: {len(spatial)} spatial convs and {len(matmuls)} "
          f"matmuls a quantized forward")
    n = conv_parity(seed, [geom for geom, _ in distinct(spatial)])
    pointwise_parity(seed, [mk for mk, _ in distinct(matmuls)])
    say(f"mobilenet parity: w8a8_conv2d bitwise at the stem "
        f"{spatial[0][:2]} ({n} cases with the ragged ones), w8a8 bitwise "
        f"and w4a16 within {W4_TOL} at the {len(distinct(matmuls))} "
        f"distinct (M, K, N) of a forward at batch {MOBILENET_SERVE_BATCH}")
    stem = conv_record(seed, spatial)
    pw = pointwise_timing(seed, matmuls)
    return {"fused_bn": {"shapes": rows, "step": step,
                         "max_abs_err": worst[0],
                         "sums_max_rel_err": worst[1]},
            "stem": {k: stem[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "per_shape")},
            "pointwise": pw}


def mobilenet_serve(im, X, tag: str) -> dict:
    """MOBILENET_RECORDS images through ``do_predict`` in batches of
    MOBILENET_SERVE_BATCH, after one warm batch, the counts set to 0 just
    before and read just after, under a trace of the card: the outputs,
    records/s, each batch's latency (host clock, synchronised) and the
    launches on the card and by the wrappers."""
    b = MOBILENET_SERVE_BATCH
    im.do_predict(X[:b], batch_size=b)
    sync(im.device)
    reset_launches()
    outs, lat = [], []
    with _impl.card_launches(("w8a8_conv", "w8a8", "w4a16",
                              "fused_bn")) as card:
        t_all = time.perf_counter()
        for i in range(0, len(X), b):
            t0 = time.perf_counter()
            outs.append(im.do_predict(X[i:i + b], batch_size=b))
            lat.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t_all
    return {"probs": np.concatenate(outs), "wall_s": wall,
            "p50_s": float(np.median(lat)), "forwards": len(lat),
            "card": dict(card),
            "wrapper": {"w8a8_conv": qm.launches_conv,
                        "w8a8": qm.launches_w8a8,
                        "w4a16": qm.launches_w4a16,
                        "fused_bn": fb.launches}}


def check_mobilenet_serve(tag: str, run: dict, ref, card: bool = True
                          ) -> None:
    """Finite (N, 1000) probabilities; int8: every top-5 (classes and
    probabilities) bit for bit the plain route's; int4: every probability
    within W4_TOL of the plain route's; launches a forward as
    MOBILENET_LAUNCHES says on the card and by the wrappers, no fused_bn
    (eval mode)."""
    p = run["probs"]
    check(p.shape == (MOBILENET_RECORDS, MOBILENET["classes"])
          and np.isfinite(p).all(), f"mobilenet[{tag}]: probs {p.shape}")
    detail = ""
    if tag == "int8":
        for i in range(len(p)):
            got, want = default_postprocess(p[i], 5), \
                default_postprocess(ref[i], 5)
            check(got == want, f"mobilenet[int8] record {i}: top-5 {got} "
                               f"!= the plain route's {want}")
        detail = (f"; top-5 bitwise equal to the plain route (whole rows "
                  f"{'bitwise equal' if np.array_equal(p, ref) else 'differ'}"
                  f")")
    elif tag == "int4":
        err = float(np.abs(p - ref).max())
        check(np.allclose(p, ref, atol=W4_TOL[0], rtol=W4_TOL[1]),
              f"mobilenet[int4]: max abs err {err:.3e} vs the plain route "
              f"outside {W4_TOL}")
        detail = f"; max abs err vs the plain route {err:.3e} ({W4_TOL})"
    per = MOBILENET_LAUNCHES[tag] if card else {}
    fw = run["forwards"]
    for k in ("w8a8_conv", "w8a8", "w4a16", "fused_bn"):
        want = fw * per.get(k, 0)
        check(run["card"][k] == run["wrapper"][k] == want,
              f"mobilenet[{tag}]: {k} launches on the card "
              f"{run['card'][k]}, by the wrapper {run['wrapper'][k]}, != "
              f"{fw} forwards x {per.get(k, 0)}")
    n = len(p)
    say(f"mobilenet[{tag}]: {n} records in {fw} forwards of "
        f"{MOBILENET_SERVE_BATCH}: {n / run['wall_s']:.1f} records/s, e2e "
        f"p50 {run['p50_s'] * 1e3:.2f} ms a batch (under the trace); "
        f"launches a forward on the card = by the wrappers "
        + (", ".join(f"{k} {v}" for k, v in per.items()) or "none")
        + detail)


def mobilenet_serve_phase(seed: int, host, x_eval, dev) -> dict:
    """The trained model served in f32, int8 (calibrated on one batch of
    the held-out images) and int4, each route against the same model's
    plain route."""
    X = x_eval[:MOBILENET_RECORDS]
    calib = x_eval[MOBILENET_RECORDS:MOBILENET_RECORDS
                   + MOBILENET_SERVE_BATCH]
    out = {}
    for tag, bits in (("f32", 0), ("int8", 8), ("int4", 4)):
        im = InferenceModel(max_batch=MOBILENET_SERVE_BATCH, device=dev) \
            .do_load_model(copy.deepcopy(host))
        if bits:
            im.do_quantize(calib if bits == 8 else None, force=True,
                           bits=bits)
        run = mobilenet_serve(im, X, tag)
        set_impl(im._model, "torch")
        ref = im.do_predict(X, batch_size=MOBILENET_SERVE_BATCH)
        set_impl(im._model, None)
        check_mobilenet_serve(tag, run, ref, dev.type == "cuda")
        out[tag] = run
        del im
    for tag in ("int8", "int4"):
        agree = np.mean(out[tag]["probs"].argmax(1)
                        == out["f32"]["probs"].argmax(1))
        say(f"mobilenet[{tag}]: top-1 agreement with f32 {agree:.3f}")
    return out


def card_layer_cases(seed: int) -> list:
    """(tag, port layer built on the CPU with seeded weights, its input)
    for the new layers that phase 15's model does not run; the int8 ones
    quantized by the port's quantizer leaves."""
    g = np.random.default_rng(seed + 152)

    def x(*shape):
        return g.standard_normal(shape, dtype=np.float32)

    def quantized(layer, xin, bits=8):
        w = layer.W.detach().numpy()
        leaves = _quantize_w8(w, float(np.abs(xin).max())) if bits == 8 \
            else _quantize_w4(w, 64)
        leaves["b"] = layer.b.detach().numpy()
        load_jax_params(layer, leaves)
        return layer

    def seeded(layer):
        layer.init_weights(seed)
        return layer
    cases = []
    xin = x(4, 8, 16, 16, 24)
    cases.append(("Convolution3D f32", seeded(Convolution3D(
        32, 3, border_mode="same", subsample=(1, 2, 2),
        input_shape=(8, 16, 16, 24))), xin))
    cases.append(("Convolution3D int8", quantized(seeded(Convolution3D(
        32, 3, border_mode="same", subsample=(1, 2, 2),
        input_shape=(8, 16, 16, 24))), xin), xin))
    xin = x(8, 32, 32, 48)
    cases.append(("AtrousConvolution2D int8", quantized(seeded(
        AtrousConvolution2D(64, 3, atrous_rate=(2, 2), border_mode="same",
                            input_shape=(32, 32, 48))), xin), xin))
    cases += [
        ("Deconvolution2D", seeded(Deconvolution2D(
            32, 3, subsample=2, border_mode="same",
            input_shape=(16, 16, 48))), x(8, 16, 16, 48)),
        ("SeparableConvolution2D", seeded(SeparableConvolution2D(
            64, 3, depth_multiplier=2, border_mode="same", subsample=2,
            input_shape=(32, 32, 32))), x(8, 32, 32, 32)),
        ("LocallyConnected2D", seeded(LocallyConnected2D(
            16, 3, input_shape=(12, 12, 8))), x(8, 12, 12, 8)),
        ("ResizeBilinear", ResizeBilinear(45, 61), x(8, 32, 40, 16)),
        ("LRN2D", LRN2D(), x(8, 16, 16, 64)),
        ("MaxPooling3D", MaxPooling3D(3, strides=2, border_mode="same"),
         x(4, 8, 16, 16, 32)),
        ("AveragePooling3D", AveragePooling3D(2), x(4, 8, 16, 16, 32)),
        ("GlobalAveragePooling3D", GlobalAveragePooling3D(),
         x(4, 8, 16, 16, 32)),
        ("MaxoutDense", seeded(MaxoutDense(128, nb_feature=4,
                                           input_shape=(256,))),
         x(512, 256)),
    ]
    idx = g.integers(-1, 10000, (256, 32))
    cases.append(("SparseDense", seeded(SparseDense(10000, 64)),
                  [idx, x(256, 32)]))
    return cases


def other_layers_phase(seed: int, dev) -> dict:
    """Each case of card_layer_cases run on the card against its own CPU
    result (int8: bitwise, through the w8a8_conv2d kernel: one launch);
    then MixtureOfExperts at GPT-2-small width in f32, its first sequence
    against the CPU."""
    def put(v, d):
        if isinstance(v, list):
            return [put(a, d) for a in v]
        return torch.from_numpy(np.asarray(v)).to(d)
    rows = {}
    for tag, layer, xin in card_layer_cases(seed):
        with torch.inference_mode():
            want = layer(put(xin, "cpu"))
            card = copy.deepcopy(layer).to(dev)
            reset_launches()
            got = card(put(xin, dev))
            sync(dev)
            launches = qm.launches_conv
            got = got.cpu()
        int8 = tag.endswith("int8")
        err = float((got - want).abs().max())
        if int8:
            check(torch.equal(got, want) and launches == 1,
                  f"{tag}: card vs CPU max abs err {err:.3e}, "
                  f"w8a8_conv2d launches {launches}")
        else:
            check(torch.allclose(got, want, atol=CARD_LAYER_TOL[0],
                                 rtol=CARD_LAYER_TOL[1]),
                  f"{tag}: card vs CPU max abs err {err:.3e} outside "
                  f"{CARD_LAYER_TOL}")
        rows[tag] = {"shape": list(got.shape), "max_abs_err": err}
        say(f"layer[{tag}]: output {tuple(got.shape)} on the card vs the "
            f"CPU: max abs err {err:.3e}"
            + (f", bitwise, {launches} w8a8_conv2d launch" if int8 else
               f" (atol, rtol {CARD_LAYER_TOL})"))
    moe = MixtureOfExperts(**MOE, input_shape=MOE_X[1:])
    moe.init_weights(seed)
    x = torch.from_numpy(np.random.default_rng(seed + 153).standard_normal(
        MOE_X, dtype=np.float32))
    with torch.inference_mode():
        want = moe(x[:1])
        card = copy.deepcopy(moe).to(dev)
        xd = x.to(dev)
        card(xd)
        sync(dev)
        t0 = time.perf_counter()
        got = card(xd)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        aux = float(card.aux_load_balance_loss(card.gates(xd)))
    err = float((got[:1].cpu() - want).abs().max())
    check(got.shape == x.shape and bool(torch.isfinite(got).all())
          and torch.allclose(got[:1].cpu(), want, atol=CARD_LAYER_TOL[0],
                             rtol=CARD_LAYER_TOL[1]),
          f"MixtureOfExperts: card vs CPU max abs err {err:.3e}")
    say(f"layer[MixtureOfExperts {MOE} on {MOE_X}]: f32, {ms:.2f} ms a "
        f"forward (host clock, synchronised); first sequence vs the CPU "
        f"max abs err {err:.3e}; aux load-balance loss {aux:.4f}")
    rows["MixtureOfExperts"] = {"ms": ms, "max_abs_err": err}
    return rows


def layers_phase(seed: int, records: dict) -> dict:
    """Phase 15: MobileNet v1 at ImageNet width built from the port's
    keras2 constructors, trained through fused_bn (13 fused pairs) with
    the k-step CUDA-graph route, held in lockstep with the plain route,
    served in f32, int8 and int4; the phase's kernel shapes; every other
    new layer once on the card."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    walls = {}
    t = time.perf_counter()
    host = mobilenet_v1(**MOBILENET).to(dev)
    host.init_weights(seed)
    plan = len(host.fusion_plan)
    n_params = host.param_count()
    check(plan == MOBILENET_PAIRS and n_params == MOBILENET_PARAMS,
          f"mobilenet: {plan} fused pairs, {n_params} parameters")
    x, y, x_eval, _ = mobilenet_data(seed)
    walls["build+data"] = time.perf_counter() - t
    say(f"model: mobilenet_v1({MOBILENET}) from keras2 ({n_params} "
        f"trainable params, {plan} fused conv+BN pairs); data {len(x)} + "
        f"{len(x_eval)} held-out images of {MOBILENET_CLASSES} classes")
    t = time.perf_counter()
    kern = mobilenet_kernel_phase(seed, host)
    walls["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    pairs, fused = mobilenet_lockstep(host, x, y, seed)
    gaps = [abs(a - b) for a, b in pairs]
    check(all(math.isfinite(a) and math.isfinite(b) for a, b in pairs)
          and max(gaps) <= MOBILENET_LOSS_TOL
          and fused == MOBILENET_PAIRS * len(pairs),
          f"mobilenet[lockstep]: kernel vs plain losses {pairs}, fused "
          f"launches {fused}")
    say(f"mobilenet[lockstep]: kernel vs plain training-forward loss at the "
        f"same weights over {len(pairs)} steps, per step "
        + ", ".join(f"{gap:.2e}" for gap in gaps)
        + f" (tolerance {MOBILENET_LOSS_TOL}); fused launches {fused}")
    walls["lockstep"] = time.perf_counter() - t
    t = time.perf_counter()
    model = copy.deepcopy(host)
    run = mobilenet_train(model, x, y, seed)
    check_mobilenet_train(run)
    walls["train"] = time.perf_counter() - t
    del x, y
    torch.cuda.empty_cache()
    t = time.perf_counter()
    served = mobilenet_serve_phase(seed, model.eval(), x_eval, dev)
    walls["serve"] = time.perf_counter() - t
    del model, host
    torch.cuda.empty_cache()
    t = time.perf_counter()
    layers = other_layers_phase(seed, dev)
    walls["layers"] = time.perf_counter() - t
    last = run["walls"][-1]
    fbk = kern["fused_bn"]
    records["fused_bn"]["mobilenet"] = dict(
        fbk, launches=run["card"],
        ms_per_step=last / MOBILENET_BATCHES * 1e3,
        images_s=MOBILENET_BATCHES * MOBILENET_BATCH / last)
    pw = kern["pointwise"]
    records["w8a8"].update(
        mobilenet_launches=served["int8"]["card"]["w8a8"],
        mobilenet_forward_ms=pw["w8"], mobilenet_forward_bound_ms=pw[
            "w8_bound"], mobilenet_forward_library_ms=pw["w8_lib"])
    records["w4a16"].update(
        mobilenet_launches=served["int4"]["card"]["w4a16"],
        mobilenet_forward_ms=pw["w4"],
        mobilenet_forward_bound_ms=pw["w4_bound"])
    records["w8a8_conv2d"]["mobilenet_stem"] = dict(
        kern["stem"], launches=served["int8"]["card"]["w8a8_conv"])
    records["w8a8_conv2d"]["layers"] = {
        k: v for k, v in layers.items() if k.endswith("int8")}
    wall = time.perf_counter() - t_phase
    say(f"layers: phase wall {wall:.2f} s (limit {LAYERS_WALL_S:.0f} s; "
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()) + ")")
    return {"served": served, "layers": layers, "wall_s": wall}


# -- phase 16: object detection; SSD-VGG16-300 trained and served -------------

# SSD300 (Liu et al. 2016, arXiv:1512.02325, Fig. 2 and Table 1; the
# reference's SSD.scala vgg16 + SSDGraph.scala) at its full widths: 8732
# priors, VOC's 20 classes + background in the facade, and the
# example's protocol (examples/ssd_voc_eval.py --arch vgg16): 48 seeded
# 300x300 images of planted rectangles of 3 classes, Adam 2e-3, batch 16,
# 12 epochs, detections above 0.25 scored with the background included
SSD_RESOLUTION = 300
SSD_CLASSES = 4
SSD_PARAMS = 24_013_232
SSD_FACADE = "ssd-vgg16-300x300"
SSD_FACADE_PARAMS = 26_285_486
SSD_PRIORS = 8732
SSD_IMAGES = 48
SSD_BATCH = 16
SSD_EPOCHS = 12
SSD_LR = 2e-3
SSD_SCORE = 0.25
# the SSD paper's evaluation threshold (Liu et al. 2016, Sec. 3): at the
# example's 0.25 the protocol's 12 epochs leave no detection, in JAX too
SSD_EVAL_SCORE = 0.01
# VOC07 mAP gate above SSD_EVAL_SCORE, below the least of the JAX CPU
# runs of the protocol (ssd_reference.py --init 0 1 2: 0.0526, 0.0054,
# 0.0004; --port-weights --init 0, the phase's own start: 0.00005).  12
# epochs leave SSD-VGG16 far from trained in either package, and the
# readings spread 1000-fold with the start, so no positive gate below
# them measures a detection quality: the training is gated by its loss
SSD_MAP_MIN = 0.0
# the last epoch's mean loss: 1.1 x the JAX run from the same seeded
# weights (ssd_reference.py --port-weights --init 0: 6.8174; its runs
# from JAX's own inits end at 5.8298-6.7993)
SSD_LOSS_MAX = 7.5
# quantized mAP (VOC07 and VOC12) against f32's, from the served outputs
SSD_MAP_GAP = 0.02
SSD_SERVE_BATCH = 16
# a forward's launches of each kernel, by precision: the 30 spatial convs
# (VGG16's 13, fc6, conv6_2 to conv9_2, the 12 heads) on w8a8_conv2d, the
# 5 pointwise ones (fc7, conv6_1 to conv9_1) on the matmul kernels
SSD_LAUNCHES = {"f32": {},
                "int8": {"w8a8_conv": 30, "w8a8": 5},
                "int4": {"w4a16": 5}}
# the facade's loc / conf on the card against its CPU result at the same
# weights: f32 sums in other orders through 23 convolutions (K up to
# 9216); (atol as a share of the output's largest magnitude, rtol)
SSD_CARD_TOL = (1e-4, 1e-4)
SSD_FACADE_IMAGES = 4
DETECT_WALL_S = 60.0
# uncounted launches at the head of a traced serving block (trace_lead)
TRACE_LEAD_LAUNCHES = 100
# launches a timing of w8a8_conv2d (and of cuDNN's f32 conv) cycles
# through at each of SSD's 20 shapes: 7 us to 0.45 ms a launch
SSD_TIMING_ITERS = 60


def ssd_fixture(seed: int = 0, n: int = SSD_IMAGES,
                image_size: int = SSD_RESOLUTION, n_classes: int = 3):
    """The example's planted-rectangle fixture (its ``synth_fixture``,
    copied): ``n`` images, each with 1-2 rectangles whose class is the
    colour channel they fill, exact ground-truth boxes (x1, y1, x2, y2)
    normalised to [0, 1], N(0, 0.03) noise, clipped to [0, 1]."""
    g = np.random.default_rng(seed)
    images = np.zeros((n, image_size, image_size, 3), np.float32)
    gts = []
    for i in range(n):
        k = int(g.integers(1, 3))
        boxes, labels = [], []
        for _ in range(k):
            cls = int(g.integers(1, n_classes + 1))
            w, h = g.uniform(0.25, 0.5, 2)
            x0 = g.uniform(0.05, 0.9 - w)
            y0 = g.uniform(0.05, 0.9 - h)
            px = slice(int(y0 * image_size), int((y0 + h) * image_size))
            py = slice(int(x0 * image_size), int((x0 + w) * image_size))
            images[i, px, py, cls - 1] = g.uniform(0.7, 1.0)
            boxes.append([x0, y0, x0 + w, y0 + h])
            labels.append(cls)
        gts.append((np.asarray(boxes, np.float32),
                    np.asarray(labels, np.int64)))
    images += g.normal(0, 0.03, images.shape).astype(np.float32)
    return images.clip(0, 1), gts


def ssd_model(dev):
    return SSDVGG(SSD_CLASSES, resolution=SSD_RESOLUTION, device=dev)


def ssd_estimator(model, seed: int) -> Estimator:
    dev = next(model.parameters()).device
    return Estimator(model, optimizer=Adam(lr=SSD_LR),
                     loss=functools.partial(multibox_loss,
                                            class_num=SSD_CLASSES),
                     registry=MetricsRegistry(),
                     ctx=ZooContext(ZooConf(seed=seed, device=str(dev))))


def ssd_train(model, x, targets, seed: int) -> dict:
    """``Estimator.fit`` with ``multibox_loss`` for SSD_EPOCHS epochs of
    SSD_BATCH: each step's loss and the host clock after a device sync at
    each epoch's last step.  cuDNN takes its deterministic algorithms for
    the fit, so that a run's losses, and the mAP they reach, repeat on one
    card and software stack: the protocol's first steps see losses of
    ~1e4, and the trajectory after them is sensitive to the order of the
    convolutions' backward sums."""
    dev = next(model.parameters()).device
    est = ssd_estimator(model, seed)
    per_epoch = -(-len(x) // SSD_BATCH)
    losses, times = {}, {}

    def listen(step, loss):
        losses[step] = loss
        if step % per_epoch == 0:
            sync(dev)
            times[step] = time.perf_counter()
    est._listeners.append(listen)
    sync(dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        est.fit(x, targets, batch_size=SSD_BATCH, epochs=SSD_EPOCHS,
                verbose=False)
        sync(dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    marks = [t0] + [times[s] for s in sorted(times)]
    return {"losses": [float(losses[s]) for s in sorted(losses)],
            "walls": [b - a for a, b in zip(marks, marks[1:])],
            "per_epoch": per_epoch}


def check_ssd_train(run: dict) -> dict:
    """Finite losses, one a step; the last epoch's mean below the first
    epoch's, below the first step's and at most SSD_LOSS_MAX.  Returns
    ms/step and images/s of the last epoch (the first one holds cuDNN's
    algorithm search)."""
    ls, per = run["losses"], run["per_epoch"]
    check(len(ls) == SSD_EPOCHS * per and all(math.isfinite(v) for v in ls),
          f"ssd train: losses {ls}")
    first, last = np.mean(ls[:per]), np.mean(ls[-per:])
    check(last < first and last < ls[0],
          f"ssd train: the loss did not fall ({ls})")
    check(last <= SSD_LOSS_MAX,
          f"ssd train: the last epoch's mean loss {last:.4f} is above "
          f"{SSD_LOSS_MAX} (ssd_reference.py)")
    wall = run["walls"][-1]
    out = {"ms_per_step": wall / per * 1e3, "images_s": SSD_IMAGES / wall,
           "first_epoch_s": run["walls"][0], "epoch_loss": [
               float(np.mean(ls[i:i + per])) for i in range(0, len(ls), per)]}
    say(f"ssd train: {len(ls)} steps of {SSD_BATCH} images in {SSD_EPOCHS} "
        f"epochs (Adam {SSD_LR}, f32, TF32 off); the last epoch "
        f"{wall:.3f} s (host clock) = {out['ms_per_step']:.2f} ms/step, "
        f"{out['images_s']:.1f} images/s (first epoch "
        f"{run['walls'][0]:.3f} s); epoch mean losses "
        f"{[round(v, 4) for v in out['epoch_loss']]} (the last at most "
        f"{SSD_LOSS_MAX})")
    return out


def voc_maps(dets, gts, num_classes: int = SSD_CLASSES) -> dict:
    """VOC07 (11-point) and VOC12 (all-point) mAP over classes 1 ..
    num_classes - 1 (the background counted in ``num_classes``)."""
    return {tag: PascalVocEvaluator(num_classes, use_07_metric=use07)
            .evaluate(dets, gts)["mAP"]
            for tag, use07 in (("voc07", True), ("voc12", False))}


def served_detections(priors, loc, conf, class_num: int,
                      score_threshold: float = SSD_EVAL_SCORE,
                      iou_threshold: float = 0.45, top_k: int = 100):
    """Per-image [(class, score, box)] from an ``InferenceModel``'s
    outputs: the class softmax of ``conf`` on the host, then
    ``decode_boxes`` and ``nms`` as ``detect`` applies them."""
    z = np.exp(conf - conf.max(-1, keepdims=True))
    probs = z / z.sum(-1, keepdims=True)
    out = []
    for b in range(loc.shape[0]):
        boxes = decode_boxes(priors, loc[b])
        dets = []
        for c in range(1, class_num):
            sc = probs[b, :, c]
            idx = np.where(sc > score_threshold)[0]
            if idx.size:
                for i in nms(boxes[idx], sc[idx], iou_threshold, top_k):
                    dets.append((c, float(sc[idx[i]]), boxes[idx[i]]))
        out.append(dets)
    return out


def trace_lead(dev, n: int = TRACE_LEAD_LAUNCHES) -> None:
    """``n`` small launches, finished, at the head of a traced block: a
    trace can lose the records of the first kernels it sees
    (``trace_probe.py``), and these are not counted."""
    if dev.type == "cuda":
        lead = torch.zeros(16, device=dev)
        for _ in range(n):
            lead.add_(1)
        torch.cuda.synchronize(dev)


def ssd_serve(im, X, tag: str) -> dict:
    """``X`` through ``do_predict`` in batches of SSD_SERVE_BATCH, after
    one warm batch, the counts set to 0 just before and read just after,
    under a trace of the card: loc and conf, records/s, each batch's
    latency (host clock, the outputs read back) and the launches on the
    card and by the wrappers."""
    b = SSD_SERVE_BATCH
    im.do_predict(X[:b], batch_size=b)
    sync(im.device)
    reset_launches()
    outs, lat = [], []
    with _impl.card_launches(("w8a8_conv", "w8a8", "w4a16")) as card:
        trace_lead(im.device)
        t_all = time.perf_counter()
        for i in range(0, len(X), b):
            t0 = time.perf_counter()
            outs.append(im.do_predict(X[i:i + b], batch_size=b))
            lat.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t_all
    return {"loc": np.concatenate([o[0] for o in outs]),
            "conf": np.concatenate([o[1] for o in outs]), "wall_s": wall,
            "p50_s": float(np.median(lat)), "forwards": len(lat),
            "card": dict(card),
            "wrapper": {"w8a8_conv": qm.launches_conv,
                        "w8a8": qm.launches_w8a8,
                        "w4a16": qm.launches_w4a16}}


def check_ssd_serve(tag: str, run: dict, ref, n_priors: int,
                    card: bool = True) -> str:
    """Finite loc (N, P, 4) and conf (N, P, classes); int8: both bitwise
    the plain route's; int4: within W4_TOL of it; launches a forward as
    SSD_LAUNCHES says, on the card and by the wrappers (none off the
    card)."""
    loc, conf = run["loc"], run["conf"]
    n = len(loc)
    check(loc.shape == (n, n_priors, 4) and conf.shape[:2] == (n, n_priors)
          and np.isfinite(loc).all() and np.isfinite(conf).all(),
          f"ssd[{tag}]: loc {loc.shape}, conf {conf.shape}")
    detail = ""
    if tag == "int8":
        check(np.array_equal(loc, ref[0]) and np.array_equal(conf, ref[1]),
              f"ssd[int8]: loc / conf differ from the plain route (max abs "
              f"err {float(np.abs(loc - ref[0]).max()):.3e} / "
              f"{float(np.abs(conf - ref[1]).max()):.3e})")
        detail = "; loc and conf bitwise equal to the plain route"
    elif tag == "int4":
        err = max(float(np.abs(loc - ref[0]).max()),
                  float(np.abs(conf - ref[1]).max()))
        check(np.allclose(loc, ref[0], atol=W4_TOL[0], rtol=W4_TOL[1])
              and np.allclose(conf, ref[1], atol=W4_TOL[0], rtol=W4_TOL[1]),
              f"ssd[int4]: max abs err {err:.3e} vs the plain route outside "
              f"{W4_TOL}")
        detail = f"; max abs err vs the plain route {err:.3e} ({W4_TOL})"
    per = SSD_LAUNCHES[tag] if card else {}
    fw = run["forwards"]
    for k in ("w8a8_conv", "w8a8", "w4a16"):
        want = fw * per.get(k, 0)
        check(run["card"][k] == run["wrapper"][k] == want,
              f"ssd[{tag}]: {k} launches on the card {run['card'][k]}, by "
              f"the wrapper {run['wrapper'][k]}, != {fw} forwards x "
              f"{per.get(k, 0)}")
    return detail


def ssd_serve_phase(ssd, X, gts, calib, dev) -> dict:
    """The trained model through ``InferenceModel`` in f32, int8
    (calibrated on ``calib``, a list of batches) and int4, each route
    against the same model's plain route; each route's detections
    (``served_detections``) scored; the quantized mAP within SSD_MAP_GAP
    of f32's."""
    out = {}
    for tag, bits in (("f32", 0), ("int8", 8), ("int4", 4)):
        im = InferenceModel(max_batch=SSD_SERVE_BATCH, device=dev) \
            .do_load_model(copy.deepcopy(ssd.model))
        if bits:
            im.do_quantize(calib if bits == 8 else None, force=True,
                           bits=bits)
        run = ssd_serve(im, X, tag)
        set_impl(im._model, "torch")
        ref = im.do_predict(X, batch_size=SSD_SERVE_BATCH)
        set_impl(im._model, None)
        detail = check_ssd_serve(tag, run, ref, len(ssd.priors),
                                 dev.type == "cuda")
        run["maps"] = voc_maps(served_detections(
            ssd.priors, run["loc"], run["conf"], ssd.class_num), gts)
        per = SSD_LAUNCHES[tag] if dev.type == "cuda" else {}
        n = len(X)
        say(f"ssd[{tag}]: {n} records in {run['forwards']} forwards of "
            f"{SSD_SERVE_BATCH}: {n / run['wall_s']:.1f} records/s, e2e p50 "
            f"{run['p50_s'] * 1e3:.2f} ms a batch (under the trace); VOC07 "
            f"mAP {run['maps']['voc07']:.4f}, VOC12 "
            f"{run['maps']['voc12']:.4f}; launches a forward on the card = "
            f"by the wrappers "
            + (", ".join(f"{k} {v}" for k, v in per.items()) or "none")
            + detail)
        out[tag] = run
        del im
    for tag in ("int8", "int4"):
        gaps = {k: abs(out[tag]["maps"][k] - out["f32"]["maps"][k])
                for k in ("voc07", "voc12")}
        check(max(gaps.values()) <= SSD_MAP_GAP,
              f"ssd[{tag}]: mAP {out[tag]['maps']} is more than "
              f"{SSD_MAP_GAP} from f32's {out['f32']['maps']}")
        say(f"ssd[{tag}]: mAP gap to f32 VOC07 {gaps['voc07']:.4f}, VOC12 "
            f"{gaps['voc12']:.4f} (limit {SSD_MAP_GAP})")
    return out


def ssd_facade_phase(seed: int, dev, tmp: str) -> dict:
    """``ObjectDetector(SSD_FACADE)`` on ``dev`` with seeded weights:
    ``save`` -> ``load_model`` restores every parameter bitwise;
    ``predict_image_set`` over SSD_FACADE_IMAGES seeded PNG files read by
    ``ImageSet.read``; loc / conf of the loaded model on ``dev`` against
    the same weights file loaded on the CPU, each within SSD_CARD_TOL
    (atol as a share of the output's largest magnitude, rtol)."""
    import cv2
    od = ObjectDetector(SSD_FACADE, device=dev)
    od.ssd.model.init_weights(seed + 160)
    n_params = od.ssd.model.param_count()
    check(n_params == SSD_FACADE_PARAMS,
          f"ObjectDetector({SSD_FACADE!r}): {n_params} parameters")
    path = os.path.join(tmp, "ssd_weights.npz")
    t0 = time.perf_counter()
    od.save(path)
    back = ObjectDetector.load_model(SSD_FACADE, path, device=dev)
    io_s = time.perf_counter() - t0
    for tree in (export_params, export_state):
        a, b = tree(od.ssd.model), tree(back.ssd.model)
        check(sorted(a) == sorted(b) and all(
            torch.equal(x, y) for x, y in zip(
                flat_leaves(a), flat_leaves(b))),
            f"ObjectDetector: load_model did not restore the saved "
            f"{tree.__name__} bitwise")
    del od
    d = os.path.join(tmp, "images")
    os.makedirs(d)
    g = np.random.default_rng(seed + 161)
    for i in range(SSD_FACADE_IMAGES):
        img = g.integers(0, 256, (240 + 20 * i, 320, 3), dtype=np.uint8)
        check(cv2.imwrite(os.path.join(d, f"img-{i}.png"), img),
              "cv2 could not write a PNG")
    iset = ImageSet.read(d)
    check(len(iset.features) == SSD_FACADE_IMAGES,
          f"ImageSet.read: {len(iset.features)} images")
    t0 = time.perf_counter()
    dets = back.predict_image_set(iset, score_threshold=0.3)
    wall = time.perf_counter() - t0
    check(len(dets) == SSD_FACADE_IMAGES and all(
        0 < c < back.cfg["class_num"] and 0.3 < s <= 1.0
        and np.isfinite(box).all() for im in dets for c, s, box in im),
        f"predict_image_set: detections {dets}")
    s = back.cfg["image_size"]
    x = torch.from_numpy(back._preprocess(np.stack([
        cv2.resize(np.asarray(f.image, np.float32), (s, s))
        for f in iset.features])))
    cpu = ObjectDetector.load_model(SSD_FACADE, path, device="cpu")
    with torch.no_grad():
        got = [t.cpu().numpy() for t in back.ssd.model.eval()(x.to(dev))]
        want = [t.numpy() for t in cpu.ssd.model.eval()(x)]
    errs = {}
    for name, a, b in zip(("loc", "conf"), got, want):
        scale = float(np.abs(b).max())
        errs[name] = float(np.abs(a - b).max()) / scale
        check(np.all(np.abs(a - b) <= SSD_CARD_TOL[0] * scale
                     + SSD_CARD_TOL[1] * np.abs(b)),
              f"ObjectDetector: {name} on {dev} vs the CPU, max abs err "
              f"{errs[name]:.3e} of the largest |{name}| {scale:.3e}, "
              f"outside {SSD_CARD_TOL}")
    say(f"ssd facade: ObjectDetector({SSD_FACADE!r}) ({n_params} params) "
        f"save + load_model {io_s:.2f} s, bitwise; predict_image_set over "
        f"{len(dets)} PNG files of {[f.image.shape for f in iset.features]}"
        f" in {wall:.3f} s: {sum(len(v) for v in dets)} detections above "
        f"0.3; loc / conf on {dev} vs the CPU: max abs err "
        f"{errs['loc']:.3e} / {errs['conf']:.3e} of their largest "
        f"magnitudes (tolerance {SSD_CARD_TOL})")
    return {"params": n_params, "detections": sum(len(v) for v in dets),
            "card_vs_cpu": errs}


def flat_leaves(tree) -> list:
    """The tensors of a nested dict tree in sorted key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in flat_leaves(tree[k])]
    return [tree]


def ssd_conv_parity(seed: int, shapes) -> None:
    """w8a8_conv2d bitwise against its plain version at each distinct
    spatial shape of SSD's quantized forward (the weight packed
    beforehand, the rule's tile and split)."""
    g = np.random.default_rng(seed + 162)
    for geom in shapes:
        case = conv_case(g, geom[0], geom[1])
        got = run_conv(case, geom, "cuda", conv_pack(case, geom))
        torch.cuda.synchronize()
        ref = run_conv(case, geom, "torch")
        check(torch.equal(got, ref),
              f"w8a8_conv2d {geom}: not bitwise equal to the plain version "
              f"(max abs err {float((got - ref).abs().max()):.3e})")
        del case, got, ref


def ssd_kernel_phase(seed: int, model) -> dict:
    """The quantized forward's kernels at SSD-VGG16-300's shapes at batch
    SSD_SERVE_BATCH: w8a8_conv2d at the 30 spatial convs (the 3-channel
    stem at 300x300, the dilated fc6, the valid conv8_2 / conv9_2, the
    12 heads of cout 16 / 24 and K up to 9216), w8a8 and w4a16 at the 5
    pointwise ones; each against its plain version, then timed and summed
    over a forward's launches, the worst shapes by share of bound named."""
    inv = conv_inventory(model, SSD_SERVE_BATCH)
    spatial, matmuls = inv["spatial"], inv["matmuls"]
    want = (SSD_LAUNCHES["int8"]["w8a8_conv"], SSD_LAUNCHES["int8"]["w8a8"])
    check((len(spatial), len(matmuls)) == want,
          f"ssd: {len(spatial)} spatial convs and {len(matmuls)} matmuls a "
          f"quantized forward, not {want}")
    shapes = [geom for geom, _ in distinct(spatial)]
    ssd_conv_parity(seed, shapes)
    pointwise_parity(seed, [mk for mk, _ in distinct(matmuls)])
    say(f"ssd parity: w8a8_conv2d bitwise at the {len(shapes)} distinct "
        f"spatial shapes of a forward at batch {SSD_SERVE_BATCH}, w8a8 "
        f"bitwise and w4a16 within {W4_TOL} at the "
        f"{len(distinct(matmuls))} distinct (M, K, N)")
    conv = conv_record(seed, spatial, SSD_TIMING_ITERS)
    worst = sorted(conv["per_shape"], key=lambda t: t["bound_ms"] / t["ms"])
    say("ssd conv: the worst shares of bound: " + "; ".join(
        f"x {tuple(t['x'])} k {tuple(t['k'])} {t['ms']:.4f} ms, "
        f"{100 * t['bound_ms'] / t['ms']:.1f}% of bound" for t in worst[:3]))
    pw = pointwise_timing(seed, matmuls)
    return {"conv": {k: conv[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "per_shape")}, "pointwise": pw}


def detection_phase(seed: int, records: dict) -> dict:
    """Phase 16: SSD-VGG16-300 at full width, its kernels at its shapes,
    trained with ``multibox_loss`` by ``Estimator.fit`` on the example's
    fixture, ``detect`` scored against SSD_MAP_MIN, served in f32, int8
    and int4, and the ``ObjectDetector`` facade."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    walls = {}
    t = time.perf_counter()
    ssd = ssd_model(dev)
    ssd.model.init_weights(seed)
    n_params = ssd.model.param_count()
    check(n_params == SSD_PARAMS and len(ssd.priors) == SSD_PRIORS
          and not ssd.model.fusion_plan,
          f"ssd: {n_params} parameters, {len(ssd.priors)} priors, fusion "
          f"plan {len(ssd.model.fusion_plan)}")
    x, gts = ssd_fixture()
    targets = ssd.encode_targets([b for b, _ in gts], [lab for _, lab in gts])
    walls["build+data"] = time.perf_counter() - t
    say(f"model: SSDVGG({SSD_CLASSES}, resolution={SSD_RESOLUTION}) "
        f"({n_params} params, {len(ssd.priors)} priors); data "
        f"{len(x)} planted-rectangle images of 3 classes, "
        f"{sum(len(lab) for _, lab in gts)} boxes, "
        f"{int((targets[..., 0] > 0).sum())} positive priors")
    t = time.perf_counter()
    kern = ssd_kernel_phase(seed, ssd.model)
    walls["kernels"] = time.perf_counter() - t
    untrained = voc_maps(ssd.detect(x, score_threshold=SSD_EVAL_SCORE), gts)
    say(f"ssd detect before training (the seeded weights): VOC07 mAP "
        f"{untrained['voc07']:.4f}, VOC12 {untrained['voc12']:.4f} above "
        f"{SSD_EVAL_SCORE}")
    t = time.perf_counter()
    train = check_ssd_train(ssd_train(ssd.model, x, targets, seed))
    walls["train"] = time.perf_counter() - t
    t = time.perf_counter()
    dets = {score: ssd.detect(x, score_threshold=score)
            for score in (SSD_SCORE, SSD_EVAL_SCORE)}
    walls["detect"] = time.perf_counter() - t
    maps = {score: voc_maps(d, gts) for score, d in dets.items()}
    gate = maps[SSD_EVAL_SCORE]["voc07"]
    check(gate >= SSD_MAP_MIN,
          f"ssd detect: VOC07 mAP {gate:.4f} above {SSD_EVAL_SCORE} is "
          f"below {SSD_MAP_MIN}")
    say(f"ssd detect over {len(x)} images in {walls['detect']:.2f} s, "
        f"PascalVocEvaluator(num_classes={SSD_CLASSES}): "
        + "; ".join(f"above {score}: {sum(len(v) for v in dets[score])} "
                    f"detections, VOC07 mAP {m['voc07']:.4f}, VOC12 "
                    f"{m['voc12']:.4f}" for score, m in maps.items())
        + f" (gate: VOC07 above {SSD_EVAL_SCORE} >= {SSD_MAP_MIN})")
    t = time.perf_counter()
    calib = [x[i:i + SSD_SERVE_BATCH] for i in range(0, len(x),
                                                      SSD_SERVE_BATCH)]
    served = ssd_serve_phase(ssd, x, gts, calib, dev)
    walls["serve"] = time.perf_counter() - t
    del ssd
    torch.cuda.empty_cache()
    t = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ssd_facade_")
    try:
        facade = ssd_facade_phase(seed, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    walls["facade"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    pw = kern["pointwise"]
    records["w8a8"].update(
        ssd_launches=served["int8"]["card"]["w8a8"],
        ssd_forward_ms=pw["w8"], ssd_forward_bound_ms=pw["w8_bound"],
        ssd_forward_library_ms=pw["w8_lib"])
    records["w4a16"].update(
        ssd_launches=served["int4"]["card"]["w4a16"],
        ssd_forward_ms=pw["w4"], ssd_forward_bound_ms=pw["w4_bound"])
    records["w8a8_conv2d"]["ssd"] = dict(
        kern["conv"], launches=served["int8"]["card"]["w8a8_conv"])
    wall = time.perf_counter() - t_phase
    say(f"detection: phase wall {wall:.2f} s (limit {DETECT_WALL_S:.0f} s; "
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()) + ")")
    return {"train": train, "maps": maps, "untrained": untrained,
            "served": served, "facade": facade, "wall_s": wall}


# -- phase 17: multi-GPU training, rehearsed by 4 ranks on one card ----------

# the world: 4 processes (``--parallel-rank r``) on cuda:0 over gloo, the
# only backend that puts several ranks on one device (NCCL refuses two
# ranks a card); NCCL runs as a world of one in the parent
PAR_RANKS = 4
# each layout's fit: PAR_STEPS steps of TRAIN_BATCH sequences of phase 5's
# data, from phase 5's seeded weights
PAR_STEPS = 4
# GPT-2 small's layouts over the 4 ranks: (tag, mesh axes, mesh shape,
# param plan)
PAR_LAYOUTS = (
    ("data 4", ("data",), (4,), None),
    ("seq 4", ("seq",), (4,), None),
    ("model 4", ("model",), (4,), "megatron"),
    ("data 2 x seq 2", ("data", "seq"), (2, 2), None),
    ("pipe 4", ("pipe",), (4,), "pipe"))
# the pipeline: TRAIN's blocks as 4 stages, 8 microbatches of one
# sequence (GPipe: M + S - 1 = 11 ticks a step)
PAR_MICRO = 8
TRAIN_LOSS = "sparse_categorical_crossentropy"
PIPE_LOSS = "sparse_categorical_crossentropy_from_logits"
# ring attention at GPT-2 small's heads and full context, seq 4
PAR_RING = (8, 12, 1024, 64)
RING_TOL = dict(atol=2e-5, rtol=1e-5)
# a layout against the one-rank fit from the same weights: each step's
# loss (relative) and every weight after the steps (absolute).  Adam's
# first step moves a weight by lr·g1 / (|g1| + eps): where the first
# gradient g1 is within f32 rounding of 0 (|g1| < PAR_G1_FLOOR, ten times
# eps), that step follows the rounding, which the layouts' summation
# orders differ in, so those weights are held to one Adam step (lr)
PAR_LOSS_RTOL = 1e-5
PAR_WEIGHT_TOL = 1e-5
PAR_G1_FLOOR = 1e-7
PAR_NEAR_ZERO_TOL = TRAIN_LR
# MixtureOfExperts at GPT-2 small's width, its E axis over expert 4
PAR_MOE = dict(num_experts=4, hidden_dim=3072)
PAR_MOE_TOKENS = (2, 1024)
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
# the phase from the rendezvous to its end, and the longest a rank waits
# for its go or a peer's collective
PAR_WALL_S = 90.0
PAR_TIMEOUT_S = 900.0


def pipe_model(seed: int, pipelined: bool = True):
    """GPT-2 small as a ``PipelinedTransformer``: TRAIN's widths and
    blocks, PAR_RANKS stages of the blocks in order, PAR_MICRO
    microbatches, the tied embedding head; seeded."""
    from analytics_zoo_tpu_torch.parallel.pipeline_model import \
        PipelinedTransformer
    return PipelinedTransformer(
        vocab=TRAIN["vocab"], hidden_size=TRAIN["hidden_size"],
        n_head=TRAIN["n_head"], seq_len=TRAIN["seq_len"],
        n_stages=PAR_RANKS, blocks_per_stage=TRAIN["n_block"] // PAR_RANKS,
        n_micro=PAR_MICRO, pipelined=pipelined,
        name="gpt2_pipe").init_weights(seed)


def par_data(seed: int):
    x, y = train_data(seed)
    n = PAR_STEPS * TRAIN_BATCH
    return x[:n], y[:n]


def par_fit(model, x, y, ctx, plan=None, loss=TRAIN_LOSS, k: int = 1,
            epochs: int = 1) -> dict:
    """``train_run``'s Estimator (Adam, global-norm clipping) over
    ``ctx``'s mesh with ``plan``, unshuffled, ``k`` steps a call: each
    step's loss, the wall, ms a step on the host clock after the first (a
    device sync after each step), and at ``k`` = 1 the first step's
    gradients as Adam took them (clipped), by parameter ``data_ptr``."""
    dev = ctx.device
    est = Estimator(model, optimizer=Adam(lr=TRAIN_LR), loss=loss,
                    clip_norm=TRAIN_CLIP, registry=MetricsRegistry(),
                    ctx=ctx, param_plan=plan)
    losses, marks, g1 = {}, {}, {}

    def listen(step, value):
        losses[step] = value
        if step == 1 and k == 1:
            # Adam's first moment after one step is (1 - b1)·g1
            st = adam_state(est.opt_state)
            g1.update({p.data_ptr(): m / (1 - ADAM_B1)
                       for p, m in zip(est.params, st["mu"])})
        sync(dev)
        marks[step] = time.perf_counter()

    est._listeners.append(listen)
    sync(dev)
    t0 = time.perf_counter()
    try:
        est.fit(x, y, batch_size=TRAIN_BATCH, epochs=epochs, verbose=False,
                shuffle=False, steps_per_call=k)
        sync(dev)
    finally:
        est._listeners.remove(listen)
    steps = sorted(marks)
    return {"losses": [float(losses[s]) for s in steps],
            "wall_s": time.perf_counter() - t0,
            "ms": (marks[steps[-1]] - marks[steps[0]])
            / max(1, len(steps) - 1) * 1e3,
            "route": est.fit_summary()["route"], "est": est, "g1": g1}


ADAM_B1 = 0.9


def adam_state(state):
    """The Adam transform's state (``mu``, ``nu``, ``count``) inside an
    optimizer's state tree."""
    if isinstance(state, dict):
        if "mu" in state and "count" in state:
            return state
        state = list(state.values())
    if isinstance(state, (list, tuple)):
        for v in state:
            found = adam_state(v)
            if found is not None:
                return found
    return None


def host_tree(model) -> dict:
    from analytics_zoo_tpu_torch.parallel.sharding import leaf_paths
    return {p: t.detach().cpu().clone() for p, t in leaf_paths(model)}


def nccl_step(seed: int, dev, host, x, y, ref_losses,
              backend: str = "nccl") -> dict:
    """A world of one (``backend``, a ``HashStore``): the LM's fit on
    ``data`` 1 with its all-reduces launched (counted at
    ``torch.distributed.all_reduce``), 2 epochs eagerly, then 2 epochs at
    ``steps_per_call=PAR_STEPS``, whose second group is one CUDA graph
    holding the all-reduces; the group is destroyed on the way out."""
    import torch.distributed as dist
    from analytics_zoo_tpu_torch.inference import aot
    calls = {"eager": 0, "captured": 0}
    orig = dist.all_reduce

    def counting(*a, **kw):
        capturing = dev.type == "cuda" \
            and torch.cuda.is_current_stream_capturing()
        calls["captured" if capturing else "eager"] += 1
        return orig(*a, **kw)

    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    dist.all_reduce = counting
    runs = {}
    try:
        ctx = ZooContext(ZooConf(seed=seed, device=str(dev)))
        check(ctx.mesh.group("data") is dist.group.WORLD,
              "parallel[nccl]: the data axis does not hold the world")
        for tag, k in (("eager", 1), ("graph", PAR_STEPS)):
            before = dict(calls)
            cap0 = aot.CAPTURE_STATS.snapshot()
            run = par_fit(copy.deepcopy(host).to(dev), x, y, ctx, k=k,
                          epochs=2)
            cap = aot.CAPTURE_STATS.snapshot()
            run.update(calls={c: calls[c] - before[c] for c in calls},
                       captures=cap["captures"] - cap0["captures"],
                       replays=cap["replays"] - cap0["replays"])
            del run["est"], run["g1"]
            par_free(dev)
            runs[tag] = run
    finally:
        dist.all_reduce = orig
        dist.destroy_process_group()
    eager, graph = runs["eager"], runs["graph"]
    n = len(ref_losses)
    check(eager["losses"][:n] == ref_losses,
          f"parallel[nccl]: the world of one's losses "
          f"{eager['losses'][:n]} are not the no-world fit's {ref_losses}")
    check(eager["calls"]["eager"] > 0,
          "parallel[nccl]: the fit launched no all-reduce")
    check(graph["losses"] == eager["losses"],
          f"parallel[nccl]: the graph route's losses {graph['losses']} "
          f"are not its eager steps' {eager['losses']}")
    if dev.type == "cuda":
        check(graph["route"] == "graph" and graph["captures"] == 1
              and graph["replays"] == 1 and graph["calls"]["captured"] > 0,
              f"parallel[nccl]: route {graph['route']}, "
              f"{graph['captures']} captures, {graph['replays']} replays, "
              f"{graph['calls']['captured']} all-reduces captured")
    say(f"parallel[nccl]: a {backend} world of one, data 1: {2 * n} eager "
        f"steps with {eager['calls']['eager']} all-reduces launched, "
        f"losses bitwise the no-world fit's over its {n} steps; "
        f"steps_per_call {PAR_STEPS} ({graph['route']} route, "
        f"{graph['captures']} capture, {graph['replays']} replay, "
        f"{graph['calls']['captured']} all-reduces inside the graph, "
        f"{graph['calls']['eager']} in the eager first group): losses "
        f"bitwise the eager steps'; ms/step (host clock) eager "
        f"{eager['ms']:.2f}, graph {graph['ms']:.2f}")
    return runs


def parallel_references(seed: int, dev, host, pipe_host, tmp: str) -> dict:
    """The one-rank fits the layouts are held to: the LM from ``host``
    (no world) and the pipelined LM's ``pipelined=False`` fit from
    ``pipe_host``; each one's losses and trained weights go to ``tmp``
    for the ranks, and ``tmp/refs`` tells them the files are whole."""
    x, y = par_data(seed)
    ctx = ZooContext(ZooConf(seed=seed, device=str(dev)))
    out, walls = {}, {}
    for tag, base, loss in (("lm", host, TRAIN_LOSS),
                            ("pipe", pipe_host, PIPE_LOSS)):
        t = time.perf_counter()
        model = copy.deepcopy(base).to(dev)
        run = par_fit(model, x, y, ctx, loss=loss)
        torch.save({"losses": run["losses"], "tree": host_tree(model)},
                   os.path.join(tmp, f"ref-{tag}.pt"))
        del model, run["est"], run["g1"]
        par_free(dev)
        out[tag] = run
        walls[f"reference {tag}"] = time.perf_counter() - t
    with open(os.path.join(tmp, "refs"), "w"):
        pass
    for tag, run in out.items():
        ls = run["losses"]
        check(len(ls) == PAR_STEPS and all(math.isfinite(v) for v in ls)
              and ls[-1] < ls[0], f"parallel[reference {tag}]: losses {ls}")
        say(f"parallel[reference {tag}]: one rank, {PAR_STEPS} steps of "
            f"{TRAIN_BATCH} x {TRAIN['seq_len']} tokens, losses "
            f"{[round(v, 5) for v in ls]}; {run['ms']:.2f} ms/step (host "
            f"clock)")
    out["walls"] = walls
    out["data"] = (x, y)
    return out


def par_free(dev) -> None:
    """``free`` after collecting cycles: a fit's Estimator, its optimizer
    state and a CUDA graph's pool go back to the card before the next
    fit, in this process or beside the other ranks'."""
    gc.collect()
    free(dev)


def _err(got, want) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def _close(got, want, tol) -> bool:
    return all(torch.allclose(a, b, **tol) for a, b in zip(got, want))


def par_ring(mesh, dev, seed: int) -> dict:
    """Ring attention over ``seq`` (PAR_RANKS hops) at PAR_RING, causal
    and full: this rank's output block and the gradients of Σ(out·ct) for
    its q, k and v blocks, on the flash body (its wrappers' launches and
    the card's counted) and the einsum body, against the flash kernel
    over the whole sequence; ms of the flash body's forward and
    backward."""
    from analytics_zoo_tpu_torch.parallel.ring_attention import \
        ring_attention
    B, H, T, D = PAR_RING
    n, i = mesh.size("seq"), mesh.index("seq")
    sl = slice(i * T // n, (i + 1) * T // n)
    g = torch.Generator().manual_seed(seed + 170)
    q, k, v, ct = (torch.randn(B, H, T, D, generator=g).to(dev)
                   for _ in range(4))
    out = {}
    for causal in (True, False):
        whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fa.flash_attention(*whole, causal=causal)
        (o * ct).sum().backward()
        ref = [o.detach()[:, :, sl]] + [t.grad[:, :, sl] for t in whole]
        del o, whole
        res = {}

        def ring(impl):
            blocks = [t[:, :, sl].clone().requires_grad_(True)
                      for t in (q, k, v)]
            o = ring_attention(*blocks, mesh, causal=causal, impl=impl)
            (o * ct[:, :, sl]).sum().backward()
            return [o.detach()] + [b.grad for b in blocks]

        reset_launches()
        with _impl.card_launches(K_KERNELS) as card:
            res["flash"] = ring("flash")
        wrappers = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
                    "flash_bwd_dkv": fa.dkv_launches}
        res["xla"] = ring("xla")
        sync(dev)
        t0 = time.perf_counter()
        ring("flash")
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        out["causal" if causal else "full"] = dict(
            kernel_err=_err(res["flash"], ref),
            kernel_close=_close(res["flash"], ref, RING_TOL),
            bodies_err=_err(res["flash"], res["xla"]),
            bodies_close=_close(res["flash"], res["xla"], RING_TOL),
            wrappers=wrappers, card=dict(card), ms=ms)
        del res, ref
    return out


class _Notes(logging.Handler):
    """Keeps the messages of the records it is handed."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def par_layout_fit(tag: str, axes, shape, plan, dev, seed: int, host,
                   pipe_host, x, y, refs: dict) -> dict:
    """One layout's fit on this rank (its process-local rows of the
    global batches) against the one-rank reference (``refs``, read from
    the parent's files): the losses, the largest relative loss gap, the
    largest gaps of this rank's weights from its slices of the
    reference's (where the first step's gradient was off 0, and where it
    was within rounding of it), ms a step, seconds in the collectives,
    the flash wrappers' launches and the sharding plan's warnings."""
    from analytics_zoo_tpu_torch.common.context import init_context
    from analytics_zoo_tpu_torch.parallel import sharding as tsh
    from analytics_zoo_tpu_torch.parallel.pipeline_model import \
        PipelinedTransformer
    ctx = init_context(mesh_axes=axes, mesh_shape=shape, device=str(dev),
                       seed=seed)
    rows = tsh.process_rows(len(x), TRAIN_BATCH, ctx)
    pipe = plan == "pipe"
    model = copy.deepcopy(pipe_host if pipe else host).to(dev)
    plan_obj = (PipelinedTransformer.sharding_plan() if pipe
                else tsh.megatron_plan() if plan == "megatron" else None)
    notes = _Notes()
    log = logging.getLogger(tsh.__name__)
    log.addHandler(notes)
    reset_launches()
    try:
        with comm_clock() as comm_s:
            run = par_fit(model, x[rows], y[rows], ctx, plan_obj,
                          loss=PIPE_LOSS if pipe else TRAIN_LOSS)
    finally:
        log.removeHandler(notes)
    launches = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
                "flash_bwd_dkv": fa.dkv_launches}
    ref = refs["pipe" if pipe else "lm"]
    want = tsh.local_tree(model, ref["tree"], ctx.mesh)
    rows_fed = int(len(rows))
    gaps = {"off_zero": 0.0, "near_zero": 0.0}
    held, near, worst = 0, 0, None
    for path, t in tsh.leaf_paths(model):
        d = (t - want[path].to(dev)).abs()
        small = run["g1"][t.data_ptr()].abs() < PAR_G1_FLOOR
        held += t.numel()
        near += int(small.sum())
        for key, part in (("off_zero", d[~small]), ("near_zero", d[small])):
            if part.numel():
                gaps[key] = max(gaps[key], float(part.max()))
        if worst is None or float(d.max()) > worst["gap"]:
            i = int(d.argmax())
            worst = {"path": path, "gap": float(d.max()), "g1": float(
                run["g1"][t.data_ptr()].reshape(-1)[i])}
    lgap = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                   ref["losses"]))
    del model, run["est"], run["g1"], want
    par_free(dev)
    return {"losses": run["losses"], "loss_rgap": lgap, "gaps": gaps,
            "near_zero": near, "worst": worst, "ms": run["ms"],
            "wall_s": run["wall_s"], "comm_s": dict(comm_s),
            "route": run["route"], "launches": launches,
            "warnings": notes.messages, "rows": rows_fed,
            "params_held": held, "coords": ctx.mesh.coords}


@contextlib.contextmanager
def comm_clock():
    """Host seconds inside the collectives of ``parallel/comm.py`` (their
    host staging included, and the wait for the other ranks), by kind:
    all-reduces and point-to-point hand-offs."""
    from analytics_zoo_tpu_torch.parallel import comm
    spent = {"all_reduce": 0.0, "p2p": 0.0, "gather": 0.0}
    saved = {n: getattr(comm, n) for n in ("_reduce", "all_reduce_",
                                           "_shift", "_gather")}
    kinds = {"_reduce": "all_reduce", "all_reduce_": "all_reduce",
             "_shift": "p2p", "_gather": "gather"}

    def timed(name):
        fn = saved[name]

        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[kinds[name]] += time.perf_counter() - t0
        return call

    for n in saved:
        setattr(comm, n, timed(n))
    try:
        yield spent
    finally:
        for n, fn in saved.items():
            setattr(comm, n, fn)


def par_moe(dev, seed: int) -> dict:
    """``MixtureOfExperts`` (PAR_MOE) at TRAIN's width: the one-rank
    forward, then the layer's expert-parallel form over ``expert``
    PAR_RANKS (its E axis placed ``P("expert")``) on the same tokens."""
    from analytics_zoo_tpu_torch.common.context import P, init_context
    from analytics_zoo_tpu_torch.parallel.sharding import ShardingPlan
    ctx = init_context(mesh_axes=("expert",), mesh_shape=(PAR_RANKS,),
                       device=str(dev), seed=seed)
    B, T = PAR_MOE_TOKENS
    H = TRAIN["hidden_size"]
    layer = MixtureOfExperts(**PAR_MOE, input_shape=(T, H),
                             name="moe").init_weights(seed).to(dev)
    g = torch.Generator().manual_seed(seed + 171)
    x = torch.randn(B, T, H, generator=g).to(dev)
    with torch.no_grad():
        want = layer(x)
        ShardingPlan([(r"^experts/", P("expert"))]).shard(layer, ctx.mesh)
        sync(dev)
        t0 = time.perf_counter()
        got = layer(x)
        sync(dev)
    return {"max_abs_err": float((got - want).abs().max()),
            "close": bool(torch.allclose(got, want, **MOE_TOL)),
            "experts_held": int(layer.W1.shape[0]),
            "ms": (time.perf_counter() - t0) * 1e3}


def parallel_worker(tmp: str, rank: int, port: int, seed: int,
                    device=None) -> int:
    """``--parallel-rank R``: rank R of phase 17's world.  The models are
    built on the host and the gloo world is joined (127.0.0.1:``port``)
    first; then the rank writes ``tmp/ready-R`` and waits for
    ``tmp/go``, so its start costs the phase no time.  Then, on every
    rank in one order: the ring, the layouts' fits, the MoE; one JSON
    line (``{"parallel": ...}``) reports them.  The group is destroyed on
    the way out, failed or not."""
    import datetime

    import torch.distributed as dist
    from analytics_zoo_tpu_torch.common.context import init_context
    dev = device or torch.device("cuda", 0)
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    host = build_train_model(seed)
    pipe_host = pipe_model(seed)
    x, y = par_data(seed)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=PAR_RANKS,
        timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    try:
        par_warm_up(dev)
        ready = time.perf_counter() - t0
        with open(os.path.join(tmp, f"ready-{rank}.tmp"), "w") as f:
            f.write(f"{ready}")
        os.replace(os.path.join(tmp, f"ready-{rank}.tmp"),
                   os.path.join(tmp, f"ready-{rank}"))
        go = os.path.join(tmp, "go")
        while not os.path.exists(go):
            check(time.perf_counter() - t0 < PAR_TIMEOUT_S,
                  f"parallel rank {rank}: no go within {PAR_TIMEOUT_S} s")
            time.sleep(0.02)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        report, walls = {"rank": rank, "ready_s": ready}, {}
        t = time.perf_counter()
        ctx = init_context(mesh_axes=("seq",), mesh_shape=(PAR_RANKS,),
                           device=str(dev), seed=seed)
        report["ring"] = par_ring(ctx.mesh, dev, seed)
        report["seq_index"] = ctx.mesh.index("seq")
        walls["ring"] = time.perf_counter() - t
        t = time.perf_counter()
        report["moe"] = par_moe(dev, seed)
        walls["moe"] = time.perf_counter() - t
        # the parent's one-rank fits ran meanwhile
        t = time.perf_counter()
        while not os.path.exists(os.path.join(tmp, "refs")):
            check(time.perf_counter() - t < PAR_TIMEOUT_S,
                  f"parallel rank {rank}: no references within "
                  f"{PAR_TIMEOUT_S} s")
            time.sleep(0.02)
        refs = {k: torch.load(os.path.join(tmp, f"ref-{k}.pt"),
                              mmap=True, weights_only=True)
                for k in ("lm", "pipe")}
        walls["references wait + read"] = time.perf_counter() - t
        report["fits"] = {}
        for tag, axes, shape, plan in PAR_LAYOUTS:
            t = time.perf_counter()
            report["fits"][tag] = par_layout_fit(
                tag, axes, shape, plan, dev, seed, host, pipe_host, x, y,
                refs)
            walls[f"fit {tag}"] = time.perf_counter() - t
        del refs
        report["walls"] = walls
        report["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
        say(json.dumps({"parallel": report}))
        return 0
    finally:
        dist.destroy_process_group()


def par_warm_up(dev) -> None:
    """What a rank's first case would otherwise pay inside the phase: the
    kernel libraries, cuBLAS, the profiler's first session and a staged
    collective of the world."""
    import torch.distributed as dist
    q = torch.randn(1, 1, 64, 64, device=dev, requires_grad=True)
    fa.flash_attention(q, q, q, causal=True).sum().backward()
    (q[0, 0] @ q[0, 0]).sum().backward()
    with _impl.card_launches(K_KERNELS):
        q.detach().add_(1)
    from analytics_zoo_tpu_torch.parallel import comm
    comm._reduce(torch.ones(8, device=dev), dist.group.WORLD)
    sync(dev)
    dist.barrier()


def start_parallel_workers(seed: int, tmp: str, cmd=None) -> dict:
    """Phase 17's ranks, started now (``cmd(rank, port)`` replaces the
    command line); each builds its models on the host, joins the world
    and waits for ``tmp/go``.  The parent's own pipelined reference model
    is built on a thread meanwhile."""
    import concurrent.futures
    pool = concurrent.futures.ThreadPoolExecutor(1)
    pipe_host = pool.submit(pipe_model, seed, False)
    pool.shutdown(wait=False)
    here = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    procs = []
    for r in range(PAR_RANKS):
        argv = cmd(r, port) if cmd else [
            sys.executable, os.path.join(here, "chip_smoke.py"),
            "--parallel-rank", str(r), "--parallel-dir", tmp,
            "--parallel-port", str(port), "--seed", str(seed)]
        log = open(os.path.join(tmp, f"rank-{r}.log"), "w")
        procs.append((subprocess.Popen(argv, cwd=here, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return {"t0": time.perf_counter(), "procs": procs, "tmp": tmp,
            "pipe_host": pipe_host}


def stop_parallel_workers(workers: dict) -> None:
    workers["pipe_host"].cancel()
    for proc, log in workers["procs"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def rank_log(workers: dict, r: int) -> str:
    with open(os.path.join(workers["tmp"], f"rank-{r}.log")) as f:
        return f.read()


def wait_ranks(workers: dict, what: str, done, timeout_s: float) -> None:
    """Wait until ``done()``; a rank that exits first, or the timeout,
    fails the phase with the end of the ranks' logs."""
    t0 = time.perf_counter()
    while not done():
        dead = [r for r, (p, _) in enumerate(workers["procs"])
                if p.poll() not in (None, 0)]
        if dead or time.perf_counter() - t0 > timeout_s:
            tails = "\n".join(f"-- rank {r}:\n{rank_log(workers, r)[-3000:]}"
                              for r in range(PAR_RANKS))
            check(False, f"parallel: {what}: ranks {dead} failed (or "
                         f"{timeout_s} s passed)\n{tails}")
        time.sleep(0.05)


def par_expected_launches(tag: str, coords: dict) -> int:
    """A layout's flash forward launches on one rank (and as many dq and
    dk/dv): TRAIN's blocks a step, the causal ring's s + 1 hops at seq
    coordinate s, a pipeline stage's blocks over M + S - 1 ticks."""
    nb = TRAIN["n_block"]
    if tag == "pipe 4":
        return nb // PAR_RANKS * (PAR_MICRO + PAR_RANKS - 1) * PAR_STEPS
    return nb * PAR_STEPS * (coords.get("seq", 0) + 1)


def check_parallel(reports: list, refs: dict, card: bool) -> dict:
    """Every rank's report against the contract; prints each case."""
    for rep in reports:
        r, s = rep["rank"], rep["seq_index"]
        for mode, hops in (("causal", s + 1), ("full", PAR_RANKS)):
            c = rep["ring"][mode]
            check(c["kernel_close"] and c["bodies_close"],
                  f"parallel[ring] rank {r} {mode}: max err vs the whole "
                  f"kernel {c['kernel_err']:.3e}, vs the einsum body "
                  f"{c['bodies_err']:.3e} (atol {RING_TOL['atol']}, rtol "
                  f"{RING_TOL['rtol']})")
            want = {k: hops if card else 0 for k in K_KERNELS}
            check(c["wrappers"] == want and c["card"] == want,
                  f"parallel[ring] rank {r} {mode}: launches by the "
                  f"wrappers {c['wrappers']}, on the card {c['card']}, "
                  f"want {hops} each")
        cz, fl = rep["ring"]["causal"], rep["ring"]["full"]
        say(f"parallel[ring] rank {r} (tokens {s * PAR_RING[2] // PAR_RANKS}"
            f"-{(s + 1) * PAR_RING[2] // PAR_RANKS - 1} of {PAR_RING}): "
            f"causal out/dq/dk/dv max err {cz['kernel_err']:.3e} vs the "
            f"whole-sequence kernel, {cz['bodies_err']:.3e} vs the einsum "
            f"body; launches fwd/dq/dkv by the wrappers "
            f"{list(cz['wrappers'].values())} = on the card "
            f"{list(cz['card'].values())}; full {fl['kernel_err']:.3e} / "
            f"{fl['bodies_err']:.3e}, launches "
            f"{list(fl['wrappers'].values())} = "
            f"{list(fl['card'].values())}; forward + backward "
            f"{cz['ms']:.2f} / {fl['ms']:.2f} ms (host clock)")
    for tag, _, _, plan in PAR_LAYOUTS:
        ref = refs["pipe" if plan == "pipe" else "lm"]["losses"]
        fits = [rep["fits"][tag] for rep in reports]
        worst = max((f["worst"] for f in fits), key=lambda w: w["gap"])
        for rep, f in zip(reports, fits):
            r = rep["rank"]
            g = f["gaps"]
            check(len(f["losses"]) == PAR_STEPS
                  and f["loss_rgap"] <= PAR_LOSS_RTOL
                  and g["off_zero"] <= PAR_WEIGHT_TOL
                  and g["near_zero"] <= PAR_NEAR_ZERO_TOL,
                  f"parallel[fit {tag}] rank {r}: losses {f['losses']} vs "
                  f"one rank's {ref} (max relative gap "
                  f"{f['loss_rgap']:.3e}, limit {PAR_LOSS_RTOL}), weights "
                  f"{g['off_zero']:.3e} (limit {PAR_WEIGHT_TOL}), those "
                  f"whose first gradient was within {PAR_G1_FLOOR} of 0 "
                  f"{g['near_zero']:.3e} (limit {PAR_NEAR_ZERO_TOL})")
            want = par_expected_launches(tag, f["coords"]) if card else 0
            check(all(v == want for v in f["launches"].values()),
                  f"parallel[fit {tag}] rank {r}: flash launches "
                  f"{f['launches']}, want {want} each")
            check(f["route"] == "eager",
                  f"parallel[fit {tag}] rank {r}: route {f['route']}")
            if plan == "megatron":
                check(len(f["warnings"]) == 1 and "wte" in f["warnings"][0],
                      f"parallel[fit {tag}] rank {r}: the plan's warnings "
                      f"{f['warnings']} (want the vocabulary's one)")
        say(f"parallel[fit {tag}]: losses {[round(v, 6) for v in ref]} "
            f"(one rank), ranks' max relative gap "
            f"{max(f['loss_rgap'] for f in fits):.3e} (limit "
            f"{PAR_LOSS_RTOL}), weights "
            f"{max(f['gaps']['off_zero'] for f in fits):.3e} (limit "
            f"{PAR_WEIGHT_TOL}) and, of the "
            f"{max(f['near_zero'] for f in fits)} whose first gradient was "
            f"within {PAR_G1_FLOOR} of 0, "
            f"{max(f['gaps']['near_zero'] for f in fits):.3e} (limit "
            f"{PAR_NEAR_ZERO_TOL}); ms/step by rank (host clock) "
            f"{[round(f['ms'], 1) for f in fits]}; rows fed "
            f"{[f['rows'] for f in fits]}; parameters held "
            f"{[f['params_held'] for f in fits]}; flash launches a rank "
            f"{[f['launches']['flash_fwd'] for f in fits]}; in the "
            f"collectives (host s, all-reduce / p2p / gather) "
            f"{[[round(v, 2) for v in f['comm_s'].values()] for f in fits]}"
            f"; the worst weight, of {worst['path']} ({worst['gap']:.3e}), "
            f"had a first gradient of {worst['g1']:.3e}"
            + (f"; the plan's warning: {fits[0]['warnings'][0]!r}"
               if plan == "megatron" else ""))
    for rep in reports:
        m = rep["moe"]
        check(m["close"] and m["experts_held"] == PAR_MOE["num_experts"]
              // PAR_RANKS,
              f"parallel[moe] rank {rep['rank']}: max err "
              f"{m['max_abs_err']:.3e} (atol {MOE_TOL['atol']}, rtol "
              f"{MOE_TOL['rtol']}), {m['experts_held']} experts held")
    say(f"parallel[moe]: MixtureOfExperts({PAR_MOE}) at width "
        f"{TRAIN['hidden_size']} on {PAR_MOE_TOKENS} tokens, one expert a "
        f"rank over expert {PAR_RANKS}: max err vs the one-rank forward "
        f"{max(rep['moe']['max_abs_err'] for rep in reports):.3e}; "
        f"{[round(rep['moe']['ms'], 2) for rep in reports]} ms a forward")
    say(f"parallel: peak device memory by rank "
        f"{[round(rep['peak_bytes'] / 2 ** 30, 2) for rep in reports]} GiB")
    return {tag: [rep["fits"][tag]["ms"] for rep in reports]
            for tag, *_ in PAR_LAYOUTS}


def parallel_phase(seed: int, records: dict, workers: dict, host,
                   dev=None, backend: str = "nccl") -> dict:
    """Phase 17: the references and the NCCL world of one here, then the
    4 ranks (``start_parallel_workers``) let go: ring attention, GPT-2
    small's fits under 5 layouts, the MoE's expert parallelism; their
    reports checked.  Its wall counts from the rendezvous (the ranks
    ready) to the end."""
    dev = dev or torch.device("cuda", 0)
    card = dev.type == "cuda"
    tmp = workers["tmp"]
    lead = time.perf_counter() - workers["t0"]
    wait_ranks(workers, "ready", lambda: all(os.path.exists(os.path.join(
        tmp, f"ready-{r}")) for r in range(PAR_RANKS)), PAR_TIMEOUT_S)
    t_phase = time.perf_counter()
    ready = [float(open(os.path.join(tmp, f"ready-{r}")).read())
             for r in range(PAR_RANKS)]
    say(f"parallel: {PAR_RANKS} ranks (chip_smoke.py --parallel-rank r) on "
        f"{dev} over gloo, each ready (models built on the host, world "
        f"joined) {max(ready):.2f} s after its start, started "
        f"{lead:.2f} s before this phase")
    par_free(dev)
    if card:
        free_b, total_b = torch.cuda.mem_get_info(dev)
        say(f"parallel: this process holds "
            f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB "
            f"allocated, {torch.cuda.memory_reserved(dev) / 2 ** 30:.2f} "
            f"reserved; the card has {free_b / 2 ** 30:.2f} of "
            f"{total_b / 2 ** 30:.2f} GiB free, the ranks' processes "
            f"included")
    # the ranks run the ring and the MoE while the one-rank references
    # are made here, and their fits while the NCCL world of one runs here
    with open(os.path.join(tmp, "go"), "w"):
        pass
    refs = parallel_references(seed, dev, host,
                               workers["pipe_host"].result(), tmp)
    walls = dict(refs["walls"])
    t = time.perf_counter()
    refs["nccl"] = nccl_step(seed, dev, host, *refs["data"],
                             refs["lm"]["losses"], backend)
    walls["nccl"] = time.perf_counter() - t
    par_free(dev)
    wait_ranks(workers, "the ranks' run",
               lambda: all(p.poll() is not None for p, _ in
                           workers["procs"]), PAR_TIMEOUT_S)
    walls["ranks, from the go"] = time.perf_counter() - t_phase
    reports = []
    for r in range(PAR_RANKS):
        line = [ln for ln in rank_log(workers, r).splitlines()
                if ln.startswith('{"parallel"')]
        check(len(line) == 1, f"parallel: rank {r} printed no report")
        reports.append(json.loads(line[0])["parallel"])
    for k, v in reports[0]["walls"].items():
        walls[f"rank 0: {k}"] = v
    say("parallel: walls so far " + ", ".join(
        f"{k} {v:.2f}" for k, v in walls.items()))
    ms = check_parallel(reports, refs, card)
    for name in K_KERNELS:
        rec = records.get({"flash_fwd": "flash", "flash_bwd_dq":
                           "flash_bwd_dq", "flash_bwd_dkv":
                           "flash_bwd_dkv"}[name])
        if rec is not None:
            rec["ring_launches"] = {
                mode: [rep["ring"][mode]["card"][name] for rep in reports]
                for mode in ("causal", "full")}
            rec["tensor_parallel_launches"] = [
                rep["fits"]["model 4"]["launches"][name] for rep in reports]
    wall = time.perf_counter() - t_phase
    say(f"parallel: phase wall {wall:.2f} s (limit {PAR_WALL_S:.0f} s; "
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()) + ")")
    check(wall <= PAR_WALL_S or not card,
          f"parallel: phase wall {wall:.2f} s over {PAR_WALL_S} s")
    return {"refs": refs, "reports": reports, "ms": ms, "wall_s": wall}


def ptxas_summary(log: str) -> str:
    """``kernel<template args>: N regs[, spills]`` for every compiled entry
    point (names taken from the mangled symbol)."""
    out, entry = [], "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.strip()
            # the symbol's <length><name> piece that names a *_kernel (a
            # length may follow digits of the namespace's hash)
            for m in re.finditer(r"\d+(?=[A-Za-z_])", ln):
                names = [ln[m.end():m.end() + int(m.group(0)[i:])]
                         for i in range(len(m.group(0)))]
                name = next((n for n in names if n.endswith("_kernel")),
                            None)
                if name:
                    args = re.match(r"I(.*?)E(?=[Ev])",
                                    ln[m.end() + len(name):])
                    entry = name + (f"<{args.group(1)}>" if args else "")
                    break
        elif "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{entry}: {regs} regs"
                       + (f", {smem.group(1)} B static smem" if smem else ""))
        elif "spill" in ln and not re.search(r"\b0 bytes spill stores", ln):
            out.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
    return "; ".join(out)


def spill_bytes(log: str) -> int:
    """Bytes of spill stores and loads over every entry point of a ptxas
    ``-v`` log."""
    return sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))


def kernel_timing(seed: int) -> None:
    """The timings of the paged, w8a8 and w4a16 kernels alone, with their
    parity at the timed shapes, and in trees that have it w8a8_conv2d
    summed over a ResNet-50 forward (and every tile and split forced at
    its deep shapes), through the entry points that earlier
    trees of the port share: a copy of this script run from the root of
    such a tree times that tree's kernels the same way."""
    conv = hasattr(qm, "w8a8_conv2d")       # not in earlier trees
    t0 = time.perf_counter()
    _build.build_all((pa.KERNEL, qm.KERNEL) + ((CONV_SOURCE,) if conv
                                               else ()))
    say(f"build: {time.perf_counter() - t0:.2f} s")
    ms = {}
    for variant in ("f32", "int8"):
        for shape, (lens, n_table) in paged_timing_lengths(seed).items():
            ms[f"paged[{variant}/{shape}]"] = paged_timing(
                seed + 100, variant, shape, lens, n_table)["ms"]
    w8 = w8a8_phase(seed)
    ms["w8a8"] = w8["ms"]
    ms.update({f"w8a8[M={m}]": w8[f"m{m}_ms"] for m in W8_TIMED_M if m != 8})
    for name, dt, s in (("f32", torch.float32, seed),
                        ("bf16", torch.bfloat16, seed + 1)):
        ms[f"w4a16[{name}]"] = w4a16_timing(s, 8, 768, 50257, 64, dt)["ms"]
    if conv:
        ic = ImageClassifier(**IMAGE, device="cpu")
        spatial = conv_inventory(ic.model, IMAGE_BATCH)["spatial"]
        rec = conv_record(seed, spatial)
        ms["w8a8_conv2d[forward]"] = rec["ms"]
        for t in rec["per_shape"]:
            ms["w8a8_conv2d[x {} k {}]".format(
                "x".join(map(str, t["x"])), "x".join(map(str, t["k"])))] = \
                t["ms"]
        if hasattr(qm, "conv_config"):        # not in earlier trees
            for key, row in conv_forced_timing(seed, spatial).items():
                ms.update({f"w8a8_conv2d[{key}, {cfg}]": t
                           for cfg, t in row.items()})
    say(json.dumps({"kernel_ms": ms}))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile a decode step, a predict batch, "
                         "a training step and a ResNet-50 training step "
                         "(torch.profiler)")
    ap.add_argument("--kernel-timing", action="store_true",
                    help="only time the paged, w8a8 and w4a16 kernels "
                         "(see kernel_timing)")
    ap.add_argument("--gateway-client", metavar="SPEC",
                    help="phase 12's HTTP clients in their own process "
                         "(see gateway_client_main)")
    ap.add_argument("--resume-victim", metavar="DIR",
                    help="serve DIR/q as the continuity phase's victim "
                         "until its armed fault kills the process (see "
                         "resume_victim)")
    ap.add_argument("--fit-victim", metavar="DIR",
                    help="phase 14's preempted fit, checkpointing into "
                         "DIR/ckpt (see fit_victim)")
    ap.add_argument("--resume", action="store_true",
                    help="with --fit-victim: fit(resume=True) from the "
                         "snapshot in DIR/ckpt")
    ap.add_argument("--parallel-rank", type=int, metavar="R",
                    help="rank R of phase 17's world (see "
                         "parallel_worker); with --parallel-dir and "
                         "--parallel-port")
    ap.add_argument("--parallel-dir", metavar="DIR",
                    help="with --parallel-rank: the phase's directory")
    ap.add_argument("--parallel-port", type=int, metavar="PORT",
                    help="with --parallel-rank: rank 0's port on "
                         "127.0.0.1")
    return ap.parse_args(argv)


# a hang dumps every thread's stack and exits non-zero before the run's
# 1200 s limit, rather than being killed without a word
WATCHDOG_S = 1150


def main(argv=None) -> int:
    t_main = time.perf_counter()
    args = parse_args(argv)
    if args.gateway_client:
        return gateway_client_main(args.gateway_client)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.resume_victim:
        return resume_victim(args.resume_victim, args.seed)
    if args.fit_victim:
        return fit_victim(args.fit_victim, args.seed, args.resume)
    if args.parallel_rank is not None:
        return parallel_worker(args.parallel_dir, args.parallel_rank,
                               args.parallel_port, args.seed)

    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    say(f"card: {card_line()}")
    if args.kernel_timing:
        kernel_timing(args.seed)
        return 0
    b = build_kernels()
    say(f"build: {b['wall_s']:.2f} s (nvcc {b['nvcc_s']})")
    for name, log in b["ptxas"].items():
        say(f"ptxas[{name}]: {ptxas_summary(log)}")
    conv_log = b["ptxas"][CONV_SOURCE]
    check("registers" in conv_log and spill_bytes(conv_log) == 0,
          f"ptxas[{CONV_SOURCE}]: w8a8_conv2d_kernel spills "
          f"{spill_bytes(conv_log)} B (or was not built in this run)")
    say(f"ptxas[{CONV_SOURCE}]: every w8a8_conv2d_kernel instantiation "
        f"0 B of spills")
    say(f"smem: {smem_line()}")
    sass_check()

    records = kernel_phase(args.seed)
    records.update(predict_kernel_phase(args.seed))
    bwd = flash_bwd_phase(args.seed)
    records.update(flash_bwd_dq=bwd["dq"], flash_bwd_dkv=bwd["dkv"])

    t0 = time.perf_counter()
    lm = TransformerLM(**GPT2_SMALL, seed=args.seed, device=dev)
    im = InferenceModel(device=dev).do_load_model(lm)
    say(f"model: TransformerLM {GPT2_SMALL} ({lm.param_count()} params) built and "
        f"loaded in {time.perf_counter() - t0:.2f} s")
    waves = make_requests(args.seed, GPT2_SMALL["vocab_size"])
    lm.generate(waves[0][0][1][None, :16], max_tokens=2)   # CUDA warm-up
    torch.cuda.synchronize()
    served = {}
    for kv_quant, variant in (("off", "f32"), ("int8", "int8")):
        # a timed run, then the main path's counted run under the trace
        for tag in ("timed", "traced"):
            run = serve(im, waves, dict(GENERATION, kv_quant=kv_quant),
                        trace=tag == "traced")
            served.setdefault(kv_quant, {})[tag] = check_served(
                run, waves, GPT2_SMALL["vocab_size"], kv_quant)
            if (kv_quant, tag) == ("off", "timed"):
                # phase 13 sets the fleet beside this single engine
                single = {"tokens_s": sum(
                    len(t) for t in served["off"]["timed"].values())
                    / run["wall_s"], "ttft_p50_s": run["ttft_p50_s"]}
        records[variant]["launches"] = run["launches"]
    for kv_quant in ("off", "int8"):
        cross_check(im, waves, served[kv_quant]["timed"], kv_quant)
        compare_tokens(im, waves, served[kv_quant]["traced"],
                       served[kv_quant]["timed"], kv_quant,
                       f"traced[{kv_quant}]", "timed run")
    run = serve(im, waves, MONOLITHIC)
    mono = check_served(run, waves, GPT2_SMALL["vocab_size"], "mono",
                        paged=False)
    compare_tokens(im, waves, mono, served["off"]["timed"], "off", "mono",
                   "paged f32 lane")
    t0 = time.perf_counter()
    resume_phase(im, waves, served, mono, args.seed)
    say(f"resume: phase wall {time.perf_counter() - t0:.2f} s")
    if args.profile:
        for kv_quant in ("off", "int8"):
            profile_decode(im, waves, kv_quant)
    del lm, im
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = build_predict_model(args.seed)
    pim = InferenceModel(device=dev).do_load_model(model)
    X = predict_records(args.seed)
    pim.do_predict(X[:PREDICT_BATCH])                    # CUDA warm-up
    torch.cuda.synchronize()
    say(f"model: Sequential[TransformerLayer {PREDICT}, "
        f"GlobalAveragePooling1D, Dense({PREDICT['vocab']}, softmax)] "
        f"({model.param_count()} params) built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    if args.profile:
        profile_predict(pim, X[:PREDICT_BATCH])
    predict_phase(args.seed, model, records)
    del pim, model
    torch.cuda.empty_cache()

    train_host = train_phase(args.seed, records, args.profile)
    resnet_phase(args.seed, records, args.profile)
    image_phase(args.seed, records, args.profile)
    reco_phase(args.seed, records, args.profile)
    recurrent_phase(args.seed, records)
    text_phase(args.seed, records)
    forecast_phase(args.seed, records)
    gateway_phase(args.seed, served["off"]["timed"])
    fleet_phase(args.seed, served["off"]["timed"], single)
    estimator_phase(args.seed, records, train_host)
    # phase 17's ranks build their models on the host while phases 15
    # and 16 run
    par_tmp = tempfile.mkdtemp(prefix="parallel_")
    workers = start_parallel_workers(args.seed, par_tmp)
    try:
        layers_phase(args.seed, records)
        detection_phase(args.seed, records)
        parallel_phase(args.seed, records, workers, train_host)
    finally:
        stop_parallel_workers(workers)
        shutil.rmtree(par_tmp, ignore_errors=True)
    say(f"wall: {time.perf_counter() - t_main:.2f} s, the whole script")

    say(json.dumps({"kernels": [records[k] for k in (
        "f32", "int8", "flash", "w8a8", "w4a16", "flash_bwd_dq",
        "flash_bwd_dkv", "fused_bn", "w8a8_conv2d")]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
