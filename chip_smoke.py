#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``tensorflowonspark_torch/csrc/``, holds each kernel against its plain
PyTorch version at the shapes the serving and training paths give it (and
at head_dim 32, 64 and 128, fp32 and bf16, causal and not) and times both
(and one PyTorch library call as a yardstick): CUDA events around the
calls, and the kernels' own device time from ``torch.profiler``.  Each row
names the variant that ran, its product path (``wgmma`` on the tensor cores
or ``fma``) and its ptxas registers.  Then it drives the flagship transformer LM (vocab 32000, 8
layers, 16 heads x 64, 1024 tokens, bf16, ``attention="flash"``, random
weights from a seed) along both paths:

- serve: ``serving.ModelServer`` answers requests; every attention went
  through the forward kernel and the logits agree with the same weights
  served with ``attention="full"``;
- train: ``train.Trainer.fit_feed`` takes 30 Adam steps on a learnable
  token stream with async checkpoints every 10; every attention went
  through the forward and both backward kernels, the loss falls, the flash
  gradients agree with full attention's, a Trainer restored from the last
  checkpoint steps exactly as the original, and the trained export serves
  the trained model's logits; the steady step is timed on batches already
  on the card, the Trainer's capturable Adam interleaved with a trainer
  made with ``capturable=False`` (whose losses at steps 10, 20 and 30 are
  reported beside);
- train at K = 5: the same init and stream through ``fit_feed(max_steps=30,
  steps_per_call=5)``: every step after two eager warm-ups is a replay of
  one captured CUDA graph; the kernels' launches (the counters, which a
  replay advances by the launches its capture recorded, held to the flash
  kernels ``torch.profiler`` saw the card execute), the losses at steps 10,
  20 and 30 against K = 1's, a steady step and a profile of warm groups of
  5 on device-resident stacks, the capture time, the step-time attribution
  at K = 1 and K = 5, and a restore into the trainer that captured;
- cluster: the Spark-style lifecycle in SPARK input mode, ``cluster.run``
  on a one-executor ``LocalBackend``: the node forks its manager and its
  user-fn child, which loads the kernels this process built, trains the
  same LM from rows that ``TPUCluster.train`` pushes through the node's
  queue (``DataFeed`` -> ``ShardedFeed``: pinned copies to the card on a
  side stream -> ``Trainer.fit_feed``) and exports it as the chief; after
  ``shutdown()`` this process serves the export.  Every row trained once,
  every attention went through the three kernels in the child, the loss
  falls, and the served logits are the trained model's.  This process
  initialized CUDA in the phases before; the executor is a spawned
  process, so nothing forks from here.  Then again with
  ``TFOS_STEPS_PER_CALL=5`` in the executor's environment: 4 groups of 5
  and a padded single, all graph replays after the warm-ups, with the
  losses at steps 10 and 20 against the K = 1 cluster run's.  In both
  cluster runs the node's ``fit_feed`` runs under ``torch.profiler`` (CUDA
  activity only), and its launch counters are held to the flash kernels
  the card executed;
- dataservice: the disaggregated data service feeding the same LM.  12
  TFRecord splits of 8 rows (a row id and 1024 tokens) are served by a
  journaled dispatcher and two feed workers, each a ``python -m`` process
  of the port (``--reader tfrecord --fields id,tokens --cache-bytes``),
  one armed to SIGKILL itself mid-split in epoch 1; ``cluster.run`` in
  FILES mode with ``data_service=`` on a one-executor ``LocalBackend``
  trains from ``ctx.get_service_feed`` (DYNAMIC, two epochs) through
  ``ShardedFeed`` and ``fit_feed`` at K = 1 under ``torch.profiler``,
  keeping each batch's row ids.  Every row once an epoch across the kill
  (no dupes, 24 splits committed), the killed worker fenced and its split
  re-pooled and streamed by the survivor, epoch 2 served from the
  workers' caches, colv1 frames on the wire, layers x steps launches of
  each kernel (the profiler agreeing), the losses within 1e-3 of the same
  batches fed device-resident through ``Trainer.step`` here from the same
  init, and a split's trace flow ended at ``train_dispatch`` in the node.
  Its processes start, and its node brings the model up, beside the
  gateway phase; the service's job and the steps run after it;
- segmentation: the U-Net twin
  (``examples/segmentation/segmentation_torch.py``) at the JAX example's
  full width (128 px, batch 64, encoder widths 32 to
  256, bf16, 512 synthetic examples) through ``cluster.run`` in FILES mode
  on a one-executor ``LocalBackend``: 40 Adam steps in the node, the
  chief's export, which this process serves with ``ModelServer`` (the
  encoder widths rebuilt from the params' shapes).  The losses are finite
  and fall, the first within 2e-2 of the same init and batch through the
  port on the CPU in fp32, the served logits within 2e-2 of the largest of
  the trainer's forward at the exported params, the descriptor the JAX
  example's, and no flash kernel launches (the U-Net has no attention).
  Its node brings CUDA up beside the gateway and dataservice phases and
  trains after them;
- supervised: the same LM, init and stream at K = 5 through
  ``train.fit_supervised`` with checkpoints every 10 steps: (a) a feed
  that fails (retryably) after step 15, resumed from step 10, ends at step
  30 with the params of the train-at-K = 5 phase's uninterrupted run; (b)
  the same after the ``corrupt_checkpoint`` fault garbled the newest step,
  which is quarantined as ``<step>.corrupt``; (c) a NaN batch at step 16
  poisons the params, the ``train_rollback`` knob pushed through
  ``node.apply_knobs`` halts the run, the poisoned step is quarantined and
  training resumes from the last valid one; (d) ``accum_steps=2`` and (e)
  ``remat=True`` at K = 1 and K = 5 beside plain runs on the same batches,
  with their peak memory and steady step (remat's losses equal the plain
  run's; accum's one step from the same params equals the full batch's,
  and its K = 5 run its K = 1 run); (f) ``Trainer.evaluate`` of the
  trained params over 20 held-out rows (two full batches and a padded
  one), flash against full attention.  The launch counters of (a), (d),
  (e) and (f) are held to the flash kernels the profiler saw the card
  execute;
- gateway: the serving tier in this process.  A ``ModelServer(batch_size=8)``
  behind a ``gateway.GatewayServer(max_wait_ms=5)`` (rungs 1, 2, 4 and 8
  warmed) answers 3 concurrent ``GatewayChannel`` clients, each sending
  two requests of one row; once half of them have replies, the
  ``serving_load_version`` knob swaps the weights in place to a second
  export (another seed), then a swap to an export of another depth is
  refused.  Every reply matches a lone ``predict_feed`` of its rows on
  exactly one version, and on the second when it was sent after the swap;
  a lone request sent twice gives equal bytes; no compile after warmup, no
  shed, fewer batches than requests; the forward kernel's launches equal
  layers x batches and the kernels the profiler saw run.  The request
  time by stage (queue, coalesce, dispatch, serialize) is recorded;
- serve_cli: ``python -m tensorflowonspark_torch.inference_cli --serve``
  as a subprocess on the LM export: its ready line, a 2-row request
  against ``predict_feed``, exit 0 on SIGTERM, its launches; then the
  CLI's batch mode on 256 TFRecord rows through the MNIST CNN, each JSON
  line against ``ModelServer`` on the same rows;
- pipeline: ``pipeline.TFEstimator.fit`` trains the LM in SPARK mode on a
  one-executor ``LocalBackend`` (40 rows, 5 steps; the three kernels'
  launches counted and profiled in the node's child) and the chief
  exports; ``TFModel.transform`` then serves 2 rows on that executor's
  card, in row order and equal to this process's ``ModelServer`` on the
  export; a ``fit`` after it on the same executor, which has initialized
  CUDA, is refused with the reason;
- resnet_train: ResNet-50 v1.5 at full width (stages [3, 4, 6, 3], 1000
  classes, the s2d stem, bf16 over fp32 params, random weights from a seed)
  trained on one device-resident batch of 256 x 224 x 224 learnable
  synthetic rows, the shape of bench.py's resnet leg, with the BatchNorm
  running averages as the Trainer's extra state: 30 steps at K = 1, then
  from the same init 30 at K = 5 (graph replays); the loss falls, K = 5's
  losses within 1e-3 nats of K = 1's, every running average moved and is
  finite; the steady step at each K, images/s, the counted FLOPs and MFU,
  device time by kernel group, the idle share and peak memory;
- resnet_card_vs_cpu: a one-bottleneck-a-stage fp32 ResNet from one seed
  on the card and on the CPU, TF32 off, both stems: train-mode logits, the
  updated running averages and one SGD step;
- resnet_files: the ResNet twin (``examples/resnet/resnet_imagenet_torch.py``)
  through ``cluster.run`` in FILES mode on a one-executor ``LocalBackend``:
  the node runs it inline in its executor process, where CUDA comes up; 4
  predecoded train shards of 256 rows at 256 px written here,
  ``data.FileFeed`` -> ``ShardedFeed`` -> ``fit_feed`` at K = 4 with the
  crop and flip on the card, 16 steps, saves every 8, the exact eval of 256
  validation rows and the chief's export; a fresh Trainer's validated
  restore equals the run's last params and running averages, and the
  card's crop equals the host crop byte for byte.  These paths run no
  hand-written kernel (the convs and BatchNorm are cuDNN's and ATen's, as
  they are XLA's in the JAX package); each row carries the flash kernels'
  counts, zeroed before it and 0 after;
- moe_train: the flagship LM's MoE variant (``mlp="moe"``, 8 experts,
  capacity factor 1.25; bench.py's LM leg) trained on the train phase's
  stream: 30 Adam steps at K = 1, then from the same init 30 at K = 5
  (graph replays); the loss falls, K = 5's losses within 1e-3 nats of K =
  1's, the load-balance term finite, the flash kernels' launches equal to
  layers x steps and to the kernels the profiler saw run; the steady step
  at each K, tokens/s, counted and analytic FLOPs (dispatch, combine,
  expert FFN), MFU, device time by kernel group with the MoE products
  split out, the idle share, peak memory and the share of tokens past
  capacity;
- moe_card_vs_cpu: a 2-layer fp32 MoE LM from one seed on the card and
  on the CPU, TF32 off: identical routing, logits, the load-balance term
  and one SGD step;
- moe_serve: the trained MoE LM exported, loaded by ``ModelServer`` and
  served in requests of 4, 3 and 1 rows: the logits equal the in-memory
  model's, a row alone equals the same row in the batch (routing is per
  row), the forward kernel's launches counted;
- lm_example: the LM twin (``examples/transformer/transformer_lm_torch.py``)
  through ``cluster.run`` in FILES mode on a one-executor ``LocalBackend``
  at the flagship's widths and depth with ``--mlp moe --attention flash
  --dtype bfloat16``, 20 steps on the synthetic stream and 20 on byte
  files written here (``--data_dir``); the flash kernels' launches, the
  bring-up and steady step, and each export served by this process as
  the MoE LM;
- parallel: ``Trainer(mesh=build_mesh(keep_trivial_axes=True),
  param_sharding="fsdp")`` (a one-process NCCL world, every axis of size
  1) trains the flash LM 10 steps at K = 1 and at K = 5 from the train
  phase's init and stream: its loss at step 10 within 1e-3 nats of the
  train phase's, its flash launches equal to layers x steps
  and to the kernels the profiler saw run; ``ring_attention`` and
  ``ulysses_attention(impl="flash")`` forward and backward at [8, 1024,
  16, 64] bf16 causal against ``reference_attention`` and the flash op,
  and the ring recurrence chained over 4 sequence chunks against full
  attention, each within 2e-2 of the largest value or gradient.  The
  four-card cases of the slice are ``tests/test_torch_nccl_cuda.py``'s.
- parallel_j2: the tensor-parallel LM and the ``shard_map`` MoE LM on a
  mesh whose every axis is 1, 10 steps at K = 1 and K = 5 each, their
  step-10 losses against the train and moe_train phases'; ``moe_ffn`` and
  one-stage ``gpipe``.
- observability: the flagship LM in one SPARK-mode executor under
  ``cluster.run(observatory=True, telemetry=True, profiler=True)`` (the
  watchtower on, as ``watchtower=None`` follows the observatory), from
  rows a driver thread streams until the phase is done: a K = 1 stretch
  until the driver's switch, then K = 5 (graph replays) to the end of the
  feed.  ``/metrics`` is scraped mid-run at heartbeat cadence: every line
  parses as text exposition 0.0.4, ``tfos_up`` is 1, the step-time
  histogram and the ``*_per_sec`` rates are there, and the MFU gauge of one
  closed window agrees within 5% with the analytic FLOPs over that window's
  step time; ``/status`` lists the node's profiler address; ``GET
  /profile?steps=5`` at K = 1 and during the K = 5 stretch each land a
  manifest and a trace that ``profiling.merge_capture`` merges with the
  telemetry host traces, holding all three flash kernels (their counts,
  the dispatches the window held, the capture's seconds, its bytes and the
  profiler's start-up printed); the node's ``/capture`` dialed directly
  holds them too; the step at K = 1 and K = 5 with the observatory on and
  with a capture in flight, beside the cluster phases' (neither).  Then on
  this card: ``fit_supervised(profiler=StepProfiler(dir, "10,12"))`` at K
  = 1, whose trace holds exactly the flash kernels the launch counters
  counted over its window (3 x 8 of each); ``fit_feed(transfer_guard=
  "disallow")`` at K = 1 and K = 5 on device-resident batches equal to the
  unguarded runs bit for bit (at K = 5 with a capture asked for during the
  graph capture, which waits for it and then sees the replays); a loss
  with one implicit host-to-device copy raising under ``"disallow"`` and
  logged under ``"log"``; and the guard's cost a step at K = 1.
- control: the alerting and control planes behind ``cluster.run(...,
  telemetry=True, observatory=True, watchtower={...})`` on the flagship
  LM, SPARK-mode ``LocalBackend`` executors on this card, one leg a loop:
  control_rollback (``remediator=``): ``fit_supervised`` at K = 1 with a
  checkpoint every 5 steps, the fault injector's NaN batch at step 12, the
  watchtower's ``nonfinite`` crit -> ``rollback_poison`` ->
  ``train_rollback`` -> ``PoisonRollback`` -> ``restore_latest_valid``
  (the poisoned steps quarantined as ``<step>.corrupt``): the run reaches
  its 25 steps and its params equal an uninterrupted run's over the same
  steps and batches to the bit (this leg runs earlier, beside the
  serve_cli phase); control_evict (two executors,
  ``remediator=`` with one eviction): executor 1 sleeps before every step,
  the watchtower names it alone, ``evict_straggler`` goes proposed ->
  applied -> effect, the node drains through its SIGTERM path (BYE
  preempted, no death) and one replacement executor trains in its slot at
  its peer's step; control_autopilot (``autopilot=``, only
  ``train_steps_per_call`` free): fed by ``TPUCluster.train`` at K = 1,
  the dispatch gap a step raises K, the feed regroups and the Trainer
  captures a graph mid-run, the action is judged kept or reverted, the
  heartbeat gauge shows the pushed K and the losses across the switch
  equal a K = 1 run's on this card within 1e-3 nats.  Each leg's seconds
  from its fault to the alert, to the action and to recovery are printed.
- fleet: the supervised phase's crash run publishes its final params
  (``fit_supervised(publish=)``) into a registry; here a fresh
  ``fleet.ModelRegistry`` holds version 1 (random weights from a seed,
  live), two replicas ``python -m tensorflowonspark_torch.inference_cli
  --serve --registry R --model transformer_lm --roster ...`` resolve it
  and join the roster, a ``FleetRouter`` maps them, a
  ``CanaryController`` and the observatory's ``/fleet`` run beside, and
  two ``FleetClient``s send one-row requests.  A poisoned version 2 (the
  final LayerNorm's scale 3e38: finite params, nonfinite logits) is
  proposed on one replica, swapped in place, rolled back on its
  ``serving_nonfinite`` delta and retired; the trained version, published
  as staging, goes proposed -> swapped -> canary -> kept and then serves
  on both replicas.  Every answer matches an in-process ``ModelServer``
  on one version's export (the poisoned one's nonfinite, and none sent
  after its rollback), each replica answers from the trained version
  after the promote, no compile after warmup, ``/fleet`` shows the
  default move, the journal replays to the same decisions, and each
  replica's forward launches equal layers x (its warm rung + its
  ``serving_batches``).  Printed: seconds from each publish to swapped,
  canary and kept or rolled back, each replica's ready seconds, latency
  p50/p99 by version, requests a replica.
- warmstart: the warm-start compile plane.  Serving: ``inference_cli
  --serve --max-batch 1 --warm-cache-dir W`` on a fresh ``W`` compiles
  its rung with AOTInductor (verdict ``compiled``, one compile; the
  package calls the flash forward kernel as the ``tfos::flash_fwd`` op)
  and answers one row; a second replica through ``--registry R --model
  transformer_lm``, whose entry carries ``warm_dir=W``, loads it
  (``loaded``, no compile) and answers bit for bit as the first, both
  within the serve tolerance of an eager ``ModelServer``.  Training:
  ``cluster.run(compile_cache_dir=C)`` on a fresh ``C``, the flash LM
  through ``fit_supervised`` at K = 5 for 10 steps with the Trainer's
  store under ``C``: ``nvcc`` builds the kernels (misses, verdict
  ``compiled``); a second cluster on ``C`` with a fresh checkpoint root
  installs them (hits on a live ``/metrics``, no miss, no ``nvcc``,
  ``loaded``) and trains to the first run's losses bit for bit.  Printed:
  each replica's ready and warm-up seconds, each cluster's seconds from
  ``cluster.run`` to its first dispatch's end and ``train_compile_us_max``.
- export: the exported serving artifact and the C++ runner.  A process of
  its own, started before ``pipeline`` so that its compiles run beside
  the phases from there to ``parallel_j2`` (it is joined before
  ``observability``), builds the runner (``csrc/aoti_runner.cpp``) and
  the operator library (``csrc/flash_ops.cpp``) with the host's ``g++``
  against torch, and exports the LM with ``export_model(..., model=,
  embed_batch_size=4)``: ``apply.pt2`` (``torch.export``, the params as
  inputs) and ``apply_embedded.pt2`` (AOTInductor, the params baked in).
  Here ``ModelServer`` serves the requests from the artifact
  (``from_artifact``; rungs 4, 4, 4 and 1) within the serve tolerance of
  an eager registry ``ModelServer`` on the same params, with layers x
  dispatches forward launches by the counter and by the profiler; beside
  it, the runner serves the embedded package with no Python (two batches
  of 4, its launches layers x batches by the C++ binding's counter),
  ``inference_cli --native`` answers TFRecord rows of a one-layer LM (JSON
  lines of the flagship's logits would be hundreds of MB a row), and the
  C++ binding equals the Python op bit for bit at four shapes.  The
  kernels line's ``launches`` for the forward is this phase's (the
  artifact, the runner and the CLI's runner); the backward kernels keep
  the warm-start clusters'.

A line before the kernels line gives the script's wall time and each
phase's seconds.

Each phase prints one JSON line; any failure raises and the exit code is
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  It needs
one card; without CUDA, or without the package beside it, it fails.
"""

import gzip
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the flagship LM (bench.py's LM leg) at full width, served in batches of 4
LM_CONFIG = {"vocab_size": 32000, "num_layers": 8, "num_heads": 16,
             "head_dim": 64, "max_seq_len": 1024, "attention": "flash",
             "dtype": "bfloat16"}
SEQ = 1024
SERVE_BATCH = 4
REQUESTS = (4, 4, 3, 1)
# the bench LM leg's training run: batch 8 x 1024 tokens, Adam lr 1e-3,
# fp32 params under bf16 compute
TRAIN_BATCH = 8
TRAIN_STEPS = 30
LOG_STEPS = 10
LR = 1e-3
STEADY_STEPS = 10    # warm steps timed after the checks
PROFILE_STEPS = 3    # warm steps under torch.profiler
# the steady K = 1 step with capturable Adam (the Trainer's default on the
# card) and with capturable=False, runs of STEADY_STEPS interleaved
AB_ROUNDS = 3

# kernel vs plain, same inputs.  O: fp32 sums in another order (1e-4 at
# |O| <= 4); bf16 O rounds to 8 mantissa bits (2e-2 is one bf16 step below
# |O| = 4).  L is fp32 on both sides.
O_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
L_TOL = 5e-4
# served logits, flash vs full attention, same bf16 weights: the two paths
# round the attention output to bf16 from fp32 values that differ in the
# last fp32 bits, and 8 bf16 layers amplify an occasional one-step flip;
# 3e-2 of max|logit| holds that with margin, while a wrong kernel moves
# logits by O(max|logit|)
LOGIT_TOL = 3e-2

# backward kernels vs plain, same inputs, relative to the largest
# gradient: dQ, dK, dV are sums of up to S products; fp32 kernels sum in
# another order than the plain einsums (1e-4 covers it), bf16 gradients
# round to 8 mantissa bits (1e-2 is about two bf16 steps of the largest).
# delta is fp32 on both sides from the same O and dO.
G_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
DELTA_TOL = 1e-4
# training checks.  Loss: the token stream is learnable (each token is the
# previous one plus 1), so 30 Adam steps take the loss at least 0.1 nats
# (1% of ln 32000) below the first step's.  Gradients, flash vs full
# attention, same bf16 weights and batch: both round attention outputs and
# gradients to bf16 from fp32 values that differ in the last bits, and 8
# layers carry that to under 1% per tensor (a CPU rehearsal at this depth
# gave 0.9%); 5e-2 of each tensor's norm holds it, a wrong kernel is off by
# O(1).  Resume: the kernels use no atomics and one process picks the same
# cuBLAS algorithms for the same shapes, so a restored Trainer's step
# should match bit for bit; 1e-6 is the stated limit.  Handoff: the server
# runs the same kernels on the same params and batch: 1e-3 of max|logit|.
LOSS_DROP = 0.1
GRAD_RTOL = 5e-2
RESUME_TOL = 1e-6
HANDOFF_TOL = 1e-3

# the cluster phase: 164 rows of 1024 tokens, fed as 4 partitions, make 20
# full steps of 8 rows and a padded final step of 4 valid rows; windows of
# 5 steps (the steady figure is the median of the windows after the first)
CLUSTER_ROWS = 164
CLUSTER_PARTS = 4
CLUSTER_LOG_STEPS = 5
CLUSTER_STEPS = -(-CLUSTER_ROWS // TRAIN_BATCH)
# the cluster node trains the train phase's init on the same token stream in
# the same order, so its loss at steps 10 and 20 is the train phase's window
# loss there; another process may pick other cuBLAS algorithms, so 1e-3
# nats, while a row out of order or corrupt moves it by O(0.1)
CLUSTER_LOSS_TOL = 1e-3
# how long the driver waits, after shutdown(), for the node's last step,
# export and report
CLUSTER_REPORT_SECS = 300

# K steps a dispatch: the train and cluster phases again at K = 5.  Graph
# replays run the same kernels on the same data; Adam in capturable mode
# computes its bias corrections as fp32 tensors, not Python floats, and
# another process may pick other cuBLAS algorithms, so the losses at steps
# 10, 20 and 30 are held to K = 1's at 1e-3 nats, while a replay that read
# a stale batch or stale optimizer state moves them by O(0.1)
MEGA_K = 5
MEGA_LOSS_TOL = 1e-3
MEGA_STEADY_GROUPS = 4     # warm groups of 5 timed on device-resident stacks
MEGA_PROFILE_GROUPS = 2    # warm groups of 5 under torch.profiler

# the supervised phase: fit_supervised at K = 5 with a save every 10 steps;
# the first feed fails after step 15 ((a); (b) after step 25, once a save
# of step 20 was garbled); a NaN batch at step 16 for (c).  A resumed run
# replays the uninterrupted run's kernels, graph and data from a restored
# state that is a bit copy, so its params are held to RESUME_TOL.
SUPERVISED_SAVE_STEPS = 10
CRASH_STEP = 15
CORRUPT_CRASH_STEP = 25
NAN_STEP = 12          # the first group at or after it: steps 16-20
# accum_steps=2 splits a batch of 8 into two of 4, and each micro-batch's
# bf16 weight gradients are rounded on their own: a different arithmetic,
# which 30 Adam steps at lr 1e-3 amplify like any other (on the card,
# Adam with capturable=False, an fp32 bias-correction difference, ends
# 5e-5, 0.026 and 0.135 nats off at steps 10, 20 and 30; PERF.md).  So the accum run's losses there
# are reported beside the plain run's, not held; what is held is one step
# from the same params and batch: the loss within 1e-3 nats and each
# gradient within GRAD_RTOL of its norm (about two bf16 steps; a
# micro-batch weighted wrongly is off by O(1)), and the K = 5 run against
# the K = 1 run at MEGA_LOSS_TOL.  remat runs the same forward twice with
# the same kernels: its losses are held to the plain run's at RESUME_TOL.
ACCUM_STEPS = 2
ACCUM_LOSS_TOL = 1e-3
REMAT_LOSS_TOL = RESUME_TOL
SUPERVISED_STEADY_GROUPS = 2
# steps of the plain, accum_steps=2 and remat runs at each K: the window
# loss at step 10 held against the train phases' and K = 5 against K = 1
VARIANT_STEPS = 10
# evaluate: 20 held-out rows in batches of 8; the mean token loss and top-1
# accuracy through the flash forward against full attention on the same
# params.  LOGIT_TOL bounds a logit's difference relative to max|logit|;
# the means over 20 x 1023 tokens move far less, so both are held to
# LOGIT_TOL absolute (nats, and a share of tokens)
EVAL_ROWS = 20
EVAL_TOL = LOGIT_TOL

# (shape [B, S, H, D], dtype, causal, fused): the serving shape first, then
# the training shape
FLASH_CASES = [
    ((SERVE_BATCH, SEQ, 16, 64), "bfloat16", True, True),
    ((TRAIN_BATCH, SEQ, 16, 64), "bfloat16", True, True),
    ((2, 256, 4, 64), "float32", True, False),
    ((2, 256, 4, 64), "float32", False, False),
    ((2, 256, 4, 128), "bfloat16", True, False),
    ((2, 256, 4, 128), "float32", False, False),
    ((2, 256, 4, 32), "bfloat16", True, False),   # head_dim 32: wgmma
    ((2, 256, 4, 32), "float32", False, False),   # head_dim 32: padded to 64
    ((1, 96, 2, 64), "bfloat16", True, False),    # ragged last tile
    ((2, 256, 4, 64), "bfloat16", False, False),
    # the fleet replicas' one-row requests (FLEET_BATCH rows)
    ((1, SEQ, 16, 64), "bfloat16", True, True),
]
# the backward kernels: the training shape first
BWD_CASES = [
    ((TRAIN_BATCH, SEQ, 16, 64), "bfloat16", True, True),
    ((2, 256, 4, 64), "float32", True, False),
    ((2, 256, 4, 64), "float32", False, False),
    ((2, 256, 4, 128), "bfloat16", True, False),
    ((2, 256, 4, 128), "float32", False, False),
    ((1, 96, 2, 64), "float32", True, False),     # ragged last tile
    ((2, 256, 4, 32), "bfloat16", True, False),   # head_dim 32
    ((2, 256, 4, 32), "float32", True, False),
    ((1, 96, 2, 64), "bfloat16", True, False),    # ragged, tensor cores
    ((2, 256, 4, 64), "bfloat16", False, False),
    ((1, 96, 2, 64), "bfloat16", False, False),   # ragged, not causal
    # the training token count and width (8 x 1024 tokens, 1024 channels)
    # at the other head_dims: the same FLOPs and bytes as the training shape
    ((TRAIN_BATCH, SEQ, 32, 32), "bfloat16", True, True),
    ((TRAIN_BATCH, SEQ, 8, 128), "bfloat16", True, True),
]


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the traces this process read with trace_records: windows, records, and
# the seconds the reads took (the wall line reports them)
TRACE_READS = {"windows": 0, "records": 0, "seconds": 0.0}


class TraceKernel(object):
    """One name's device-side records in a trace: ``key``, ``count`` and
    ``self_device_time_total`` (microseconds), as ``key_averages()`` gives
    them."""

    def __init__(self, key):
        self.key = key
        self.count = 0
        self.self_device_time_total = 0.0


def trace_records(prof, device_type):
    """The records of ``device_type`` in a finished ``torch.profiler``
    trace, by name (demangled, as ``key_averages()`` names them), less the
    ranges of user annotations such as "Optimizer.step#Adam.step", which
    overlap the kernels they enclose.  Read from the profiler's raw
    records: ``key_averages()`` first parses every record into an event
    tree, most of a counting window's time for LM steps on the card.  The
    reads are tallied in :data:`TRACE_READS`."""
    from torch.autograd import profiler_util

    t0 = time.perf_counter()
    demangle = getattr(profiler_util, "_demangle", lambda name: name)
    by_name = {}
    events = prof.profiler.kineto_results.events()
    for e in events:
        if e.device_type() != device_type:
            continue
        if getattr(e, "is_user_annotation", lambda: False)() or getattr(
                e, "is_hidden_event", lambda: False)():
            continue
        raw = e.name()
        kernel = by_name.get(raw)
        if kernel is None:
            kernel = by_name[raw] = TraceKernel(
                demangle(raw) if len(raw) > 1 else raw)
        kernel.count += 1
        if not (e.is_async() or e.start_thread_id() != e.end_thread_id()):
            kernel.self_device_time_total += e.duration_ns() / 1e3
    merged = {}
    for kernel in by_name.values():
        if "#" in kernel.key:
            continue
        into = merged.setdefault(kernel.key, TraceKernel(kernel.key))
        into.count += kernel.count
        into.self_device_time_total += kernel.self_device_time_total
    TRACE_READS["windows"] += 1
    TRACE_READS["records"] += len(events)
    TRACE_READS["seconds"] += time.perf_counter() - t0
    return list(merged.values())


def device_kernels(prof):
    """The device-side records of a ``torch.profiler`` trace, by kernel
    name (see :func:`trace_records`)."""
    from torch.profiler import DeviceType

    return trace_records(prof, DeviceType.CUDA)


# trailing work before a counting profiler stops (see counted_on_device)
TRACE_TAIL_KERNELS = 256
TRACE_TAIL_SECS = 0.5

# the flash kernels' names in a trace (each fragment covers the fp32 and
# the bf16 variant), by the names of the kernels line
FLASH_KERNELS = {"flash_fwd": "flash_fwd_", "flash_bwd_dq": "flash_bwd_dq_",
                 "flash_bwd_dkv": "flash_bwd_dkv_"}


def counted_on_device(torch, fn, with_busy=False):
    """Run ``fn()`` under ``torch.profiler`` (CUDA activity only) and count
    the flash kernels the card executed, by name, whether a wrapper
    launched them or a CUDA graph replay ran them again.  Returns ``(fn's
    result, {name: executions})``, and with ``with_busy`` the milliseconds
    the card spent in kernels besides."""
    from torch.profiler import ProfilerActivity, profile

    def pad():
        other = torch.zeros(1, device="cuda")
        for _ in range(TRACE_TAIL_KERNELS):
            other.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(TRACE_TAIL_SECS)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the trace can miss the records of the first kernels after the
        # profiler starts (seen on the card: the first flash forward of
        # each profiled window of MoE steps) and of the last ones before
        # it stops (the last layers' backward kernels of a 30-step run):
        # kernels of another name and a pause before and after fn()
        pad()
        result = fn()
        torch.cuda.synchronize()
        pad()
    counts = dict.fromkeys(FLASH_KERNELS, 0)
    kernels = device_kernels(prof)
    for e in kernels:
        for name, fragment in FLASH_KERNELS.items():
            if fragment in e.key:
                counts[name] += e.count
    if with_busy:
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        return result, counts, busy_ms
    return result, counts


# the kernels that pad a device_ms window's edges: of a name no timed
# function launches, and left out of the sum by that name; and the pause
# after each edge (a window holds one function's calls, shorter than the
# counting profiles' steps)
DEVICE_MS_PAD = "bitwise_not"
DEVICE_MS_PAD_SECS = 0.05


def device_ms(torch, fn, iters=10, warmup=2, match=None):
    """Mean device milliseconds per call of ``fn``: the time of the kernels
    it launches, summed from a ``torch.profiler`` trace, so the host's time
    between launches is left out.  ``match`` keeps the kernels whose
    lowercased name holds it.  The window's edges run kernels of another
    name and a pause (as :func:`counted_on_device` does: a trace can miss
    the records of its first and last kernels), which the sum leaves out;
    a window that still holds no device time is run once more, and a
    second empty one raises."""
    from torch.profiler import ProfilerActivity, profile

    def pad():
        other = torch.zeros(1, dtype=torch.int32, device="cuda")
        for _ in range(TRACE_TAIL_KERNELS):
            other.bitwise_not_()
        torch.cuda.synchronize()
        time.sleep(DEVICE_MS_PAD_SECS)

    for _ in range(warmup):
        fn()
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            pad()
        total = sum(e.self_device_time_total for e in device_kernels(prof)
                    if DEVICE_MS_PAD not in e.key.lower()
                    and (match is None or match in e.key.lower()))
        if total:
            return total / 1e3 / iters
    raise AssertionError("two profiler windows of {} calls of {} held no "
                         "device time{}".format(
                             iters, getattr(fn, "__name__", fn),
                             "" if match is None else
                             " of kernels named *{}*".format(match)))


def warm_clocks(torch, seconds=1.0):
    """Keep the card busy with bf16 matmuls for about ``seconds``, so that
    its clocks have risen before the first kernel is timed."""
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def phase_device(torch, device):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    report = device.device_report()
    info = {"phase": "device", "kind": report["name"],
            "count": report["count"], "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def ptxas_usage(log):
    """``{entry function: {"registers", "spill_stores"}}`` from a build's
    ``-Xptxas -v`` output."""
    usage, entry = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = found.group(1)
            usage[entry] = {}
        elif entry and "spill stores" in line:
            usage[entry]["spill_stores"] = int(
                re.search(r"(\d+) bytes spill stores", line).group(1))
        elif entry and "registers" in line:
            usage[entry]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return usage


def phase_build(build):
    t0 = time.perf_counter()
    results = build.build()
    usage = {}
    for r in results.values():
        usage.update(ptxas_usage(r["log"]))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": r["seconds"], "cached": r["cached"]}
                      for n, r in results.items()},
          "ptxas": usage})
    return usage


def variant(torch, fa, usage, kernel, dtype_name, head_dim):
    """``{"product_path", "kernel_head_dim", "registers", "spill_stores"}``
    of the kernel variant that runs ``kernel`` at this dtype and head_dim,
    from the ptxas entries of the build (mangled names)."""
    dtype = getattr(torch, dtype_name)
    path = fa.product_path(kernel, dtype)
    dim = fa.kernel_head_dim(kernel, dtype, head_dim)
    symbol = kernel + ("_sm90_kernel" if path == "wgmma" else "_kernel") + "I"
    names = [n for n in usage if symbol in n and "Li{}E".format(dim) in n]
    if len(names) != 1:
        raise AssertionError("no single ptxas entry for {} {} D={}: {}".format(
            kernel, dtype_name, dim, names))
    return dict(usage[names[0]], product_path=path, kernel_head_dim=dim)


def make_qkv(torch, shape, dtype, fused):
    """q, k, v on the card from a numpy seed; ``fused`` makes them strided
    views of one [B, S, 3, H, D] buffer, as the transformer gives them."""
    import numpy as np

    b, s, h, d = shape
    x = np.random.default_rng(0).standard_normal((b, s, 3, h, d))
    qkv = torch.from_numpy(x.astype(np.float32)).to("cuda", dtype)
    if fused:
        return qkv.unbind(2)
    return tuple(qkv[:, :, i].contiguous() for i in range(3))


def flash_case(torch, F, fa, metrics, kind, usage, shape, dtype_name, causal,
               fused):
    """Check one flash_fwd case against the plain version; time kernel,
    plain and the library call; compute the roofline bound."""
    b, s, h, d = shape
    q, k, v = make_qkv(torch, shape, getattr(torch, dtype_name), fused)
    scale = 1.0 / d ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_plain(q, k, v, causal, scale)
    err_o = (out.float() - want_out).abs().max().item()
    err_l = (lse - want_lse).abs().max().item()
    ok = (bool(torch.isfinite(out.float()).all()) and err_o < O_TOL[dtype_name]
          and err_l < L_TOL)

    def kernel():
        return fa._flash_fwd_cuda(q, k, v, scale, causal)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              scale=scale)

    kernel_ms = time_ms(torch, kernel)
    kernel_device_ms = device_ms(torch, kernel, match="flash_fwd_")
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal, scale), iters=5)
    library_ms = device_ms(torch, sdpa)
    library_events_ms = time_ms(torch, sdpa)

    pairs = s * (s + 1) // 2 if causal else s * s    # (query, key) pairs
    flops = 4 * d * pairs * b * h                    # QK^T and PV
    elt = q.element_size()
    nbytes = 4 * b * s * h * d * elt + b * h * s * 4  # q, k, v, O; L fp32
    bound_ms = 1e3 * metrics.roofline_seconds(flops, nbytes, kind, dtype_name)
    row = {"phase": "kernel", "name": "flash_fwd", "shape": list(shape),
           "dtype": dtype_name, "causal": causal, "fused_qkv": fused,
           "max_abs_err_o": err_o, "max_abs_err_l": err_l,
           "tol_o": O_TOL[dtype_name], "tol_l": L_TOL, "ok": ok,
           "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_events_ms": library_events_ms,
           "library": "scaled_dot_product_attention forward",
           "bound_ms": bound_ms,
           "bound_by": metrics.roofline_bound_by(flops, nbytes, kind,
                                                 dtype_name),
           "flops": flops, "bytes": nbytes,
           "bound_share": bound_ms / (kernel_device_ms or kernel_ms)}
    row.update(variant(torch, fa, usage, "flash_fwd", dtype_name, d))
    emit(row)
    if not ok:
        raise AssertionError("flash_fwd disagrees with its plain version: "
                             "{}".format(row))
    return row


def bwd_case(torch, F, fa, metrics, kind, usage, shape, dtype_name, causal,
             fused):
    """Check the two backward kernels against their plain versions on one
    case; time kernels, plain versions and the library backward; compute
    each kernel's roofline bound."""
    import numpy as np

    b, s, h, d = shape
    dtype = getattr(torch, dtype_name)
    q, k, v = make_qkv(torch, shape, dtype, fused)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        shape).astype(np.float32)).to("cuda", dtype)
    scale = 1.0 / d ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    dq, delta = fa._flash_bwd_dq_cuda(q, k, v, out, lse, g, scale, causal)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, scale, causal)
    torch.cuda.synchronize()
    want_dq, want_delta = fa.flash_bwd_dq_plain(q, k, v, out, lse, g, causal,
                                                scale)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, g, lse, want_delta,
                                              causal, scale)
    errs, limits = {}, {}
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        errs[name] = (got.float() - want).abs().max().item()
        limits[name] = G_TOL[dtype_name] * want.abs().max().item()
    err_delta = (delta - want_delta).abs().max().item()
    limit_delta = DELTA_TOL * max(want_delta.abs().max().item(), 1.0)
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (dq, dk, dv))
    ok = (finite and all(errs[n] <= limits[n] for n in errs)
          and err_delta <= limit_delta)

    def dq_kernel():
        return fa._flash_bwd_dq_cuda(q, k, v, out, lse, g, scale, causal)

    def dkv_kernel():
        return fa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, scale, causal)

    dq_ms = time_ms(torch, dq_kernel)
    dkv_ms = time_ms(torch, dkv_kernel)
    device = {"flash_bwd_dq": device_ms(torch, dq_kernel,
                                        match="flash_bwd_dq_"),
              "flash_bwd_dkv": device_ms(torch, dkv_kernel,
                                         match="flash_bwd_dkv_")}
    plain_dq_ms = time_ms(torch, lambda: fa.flash_bwd_dq_plain(
        q, k, v, out, lse, g, causal, scale), iters=3, warmup=1)
    plain_dkv_ms = time_ms(torch, lambda: fa.flash_bwd_dkv_plain(
        q, k, v, g, lse, delta, causal, scale), iters=3, warmup=1)
    # the library yardstick: SDPA's backward alone (dQ, dK and dV
    # together), run again and again through one retained forward graph;
    # its kernels' device time, and CUDA events around the calls
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    gt = g.transpose(1, 2)
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              scale=scale)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qt, kt, vt), gt,
                                   retain_graph=True)

    library_ms = device_ms(torch, sdpa_bwd)
    library_events_ms = time_ms(torch, sdpa_bwd)
    del sdpa_out

    pairs = s * (s + 1) // 2 if causal else s * s    # (query, key) pairs
    elt = q.element_size()
    tile = b * s * h * d * elt                       # one [B, S, H, D] tensor
    stat = b * h * s * 4                             # L or delta, fp32
    cost = {
        # S and dP recomputed, dQ: 3 products; q, k, v, O, dO and L in,
        # dQ and delta out
        "flash_bwd_dq": (6 * d * pairs * b * h, 6 * tile + 2 * stat),
        # S and dP recomputed, dK and dV: 4 products; q, k, v, dO, L and
        # delta in, dK and dV out
        "flash_bwd_dkv": (8 * d * pairs * b * h, 6 * tile + 2 * stat),
    }
    rows = []
    for name, kernel_ms, plain_ms, err in (
            ("flash_bwd_dq", dq_ms, plain_dq_ms, errs["dq"]),
            ("flash_bwd_dkv", dkv_ms, plain_dkv_ms, max(errs["dk"],
                                                        errs["dv"]))):
        flops, nbytes = cost[name]
        bound_ms = 1e3 * metrics.roofline_seconds(flops, nbytes, kind,
                                                  dtype_name)
        rows.append({
            "phase": "kernel", "name": name, "shape": list(shape),
            "dtype": dtype_name, "causal": causal, "fused_qkv": fused,
            "max_abs_err": err, "ok": ok, "kernel_ms": kernel_ms,
            "kernel_device_ms": device[name],
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_events_ms": library_events_ms,
            "library": "scaled_dot_product_attention backward (dQ, dK, dV)",
            "bound_ms": bound_ms,
            "bound_by": metrics.roofline_bound_by(flops, nbytes, kind,
                                                  dtype_name),
            "flops": flops, "bytes": nbytes,
            "bound_share": bound_ms / (device[name] or kernel_ms),
            **variant(torch, fa, usage, name, dtype_name, d)})
    rows[0].update({"max_abs_err_delta": err_delta,
                    "tol_delta": limit_delta})
    for row in rows:
        row["errors"] = errs
        row["limits"] = limits
        emit(row)
    if not ok:
        raise AssertionError("flash backward kernels disagree with their "
                             "plain versions: {}".format(rows))
    return rows


def phase_serve(torch, np, fa):
    """Export the flagship LM, serve it through ModelServer on the default
    device and count the kernel's launches."""
    from tensorflowonspark_torch import checkpoint, serving
    from tensorflowonspark_torch.models import get_model

    model = get_model("transformer_lm", **LM_CONFIG)
    model.init_weights(torch.Generator().manual_seed(0))
    signature = {"tokens": {"shape": [None, SEQ], "dtype": "int32"}}
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, LM_CONFIG["vocab_size"], (n, SEQ),
                             dtype=np.int32) for n in REQUESTS]
    with tempfile.TemporaryDirectory() as tmp:
        flash_dir = os.path.join(tmp, "flash")
        full_dir = os.path.join(tmp, "full")
        checkpoint.export_model(flash_dir, model, "transformer_lm",
                                model_config=LM_CONFIG,
                                input_signature=signature)
        checkpoint.export_model(full_dir, model, "transformer_lm",
                                model_config=dict(LM_CONFIG,
                                                  attention="full"),
                                input_signature=signature)
        del model

        torch.cuda.reset_peak_memory_stats()
        fa.fwd_launches = 0                          # the main path starts
        t0 = time.perf_counter()
        server = serving.ModelServer(flash_dir, batch_size=SERVE_BATCH)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warmed = server.warmup()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        latencies, outputs = [], []
        for tokens in requests:
            t0 = time.perf_counter()
            out = server.predict_feed({"tokens": tokens}, len(tokens))
            latencies.append(time.perf_counter() - t0)
            outputs.append(out["output"])
        launches = fa.fwd_launches                   # the main path ends
        peak_bytes = torch.cuda.max_memory_allocated()

        # where a request's time goes: the forward at the top rung on the
        # device (CUDA events), then the fp32 logits' copy back to the host
        x = torch.from_numpy(requests[0]).to(server.device)
        with torch.inference_mode():
            forward_ms = time_ms(torch, lambda: server.model(x), iters=5,
                                 warmup=1)
            logits = server.model(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serving._to_numpy(logits)
            readback_ms = 1e3 * (time.perf_counter() - t0)
            readback_bytes = logits.numel() * logits.element_size()
            del logits

        batches = warmed + len(requests)
        expected = LM_CONFIG["num_layers"] * batches
        finite = all(bool(np.isfinite(o).all()) for o in outputs)
        shapes_ok = all(o.shape == (n, SEQ, LM_CONFIG["vocab_size"])
                        for o, n in zip(outputs, REQUESTS))

        check = 2   # the 3-row request: a padded rung
        full = serving.ModelServer(full_dir, batch_size=SERVE_BATCH)
        ref = full.predict_feed({"tokens": requests[check]},
                                len(requests[check]))["output"]
        del full
        diff = float(np.abs(outputs[check] - ref).max())
        scale = float(np.abs(ref).max())
    row = {"phase": "serve", "config": LM_CONFIG, "device": str(server.device),
           "load_s": load_s, "warmup_rungs": warmed, "warmup_s": warmup_s,
           "requests": [{"rows": n, "ms": 1e3 * t,
                         "tokens_per_s": n * SEQ / t}
                        for n, t in zip(REQUESTS, latencies)],
           "max_memory_allocated": peak_bytes,
           "forward_ms": forward_ms, "readback_ms": readback_ms,
           "readback_bytes": readback_bytes,
           "fwd_launches": launches, "expected_launches": expected,
           "logits_finite": finite, "shapes_ok": shapes_ok,
           "vs_full_max_abs_diff": diff, "max_abs_logit": scale,
           "vs_full_tol": LOGIT_TOL * scale, "compile_count":
           server.compile_count}
    emit(row)
    if not (finite and shapes_ok):
        raise AssertionError("served logits are not finite or misshapen")
    if launches != expected:
        raise AssertionError("flash_fwd launched {} times, expected {} "
                             "(layers x batches)".format(launches, expected))
    if not diff <= LOGIT_TOL * scale:
        raise AssertionError("flash-served logits differ from full attention "
                             "by {} (max |logit| {})".format(diff, scale))
    return row


def device_batches(torch, feed, n, device):
    """``n`` of ``feed``'s batches, already on the card (as the K = 5
    groups are timed), so a timed step makes no host copy."""
    out = []
    for _ in range(n):
        batch, mask = feed.next_batch()
        out.append(({"tokens": torch.from_numpy(batch["tokens"]).to(device)},
                    torch.from_numpy(mask).to(device)))
    return out


def time_steps(torch, trainer, batches, first=None):
    """Mean ms of one Trainer step on each of ``batches``, host clock from a
    synchronised start to a synchronised end; ``first()`` runs after the
    first step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (batch, mask) in enumerate(batches):
        trainer.step(batch, mask)
        if i == 0 and first is not None:
            first()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / len(batches)


def interleaved_steady(torch, trainers, batches, rounds):
    """``{name: [ms/step of each run]}``: ``rounds`` runs of
    :func:`time_steps` per trainer on the same batches, in the order
    A B, B A, A B, ... so that drift of the host or the clocks falls on
    both alike."""
    names = list(trainers)
    runs = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            runs[name].append(time_steps(torch, trainers[name], batches))
    return runs


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


# lowercased kernel-name fragments -> the group a step's device time is
# reported under (first match wins)
KERNEL_GROUPS = (
    ("flash_fwd", ("flash_fwd_",)),
    ("flash_bwd_dq", ("flash_bwd_dq_",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv_",)),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass", "sm90")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("softmax / cross entropy", ("softmax", "nll_loss", "cross_entropy")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("memcpy", "memset", "copy_kernel")),
    ("elementwise", ("elementwise",)),
)


def profile_steps(torch, trainer, batches):
    """Device time of a Trainer step on each of ``batches``, by kernel
    group (see :func:`profile_run`)."""
    n = len(batches)

    def run():
        for batch, mask in batches:
            trainer.step(batch, mask)

    return profile_run(torch, run, n)


def profile_run(torch, run, n, groups=KERNEL_GROUPS, ops=None):
    """Device time of ``run()``, which takes ``n`` steps, by kernel group
    (``groups``: the LM's by default), from ``torch.profiler`` (CUDA
    activity): per-step ms by group, the device-busy sum against the
    profiled wall time, and the top kernels.  ``ops(prof, n)``, when given,
    reads the trace (recorded with input shapes) for more keys."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=ops is not None) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_group, top = {}, []
    for e in device_kernels(prof):
        ms = e.self_device_time_total / 1e3 / n
        name = e.key.lower()
        group = next((g for g, keys in groups
                      if any(k in name for k in keys)), "other")
        by_group[group] = by_group.get(group, 0.0) + ms
        top.append((ms, e.key[:90], e.count // n))
    busy = sum(by_group.values())
    result = {"steps": n, "wall_ms_per_step": wall_ms / n,
              "device_busy_ms_per_step": busy,
              # None when the trace holds no device time (not measured)
              "device_idle_share": (1.0 - busy / (wall_ms / n)) if busy
              else None,
              "ms_per_step_by_group": dict(sorted(by_group.items(),
                                                  key=lambda kv: -kv[1])),
              "top_kernels": [{"ms_per_step": ms, "name": name,
                               "launches_per_step": c}
                              for ms, name, c in sorted(top)[::-1][:12]]}
    if ops is not None:
        result.update(ops(prof, n))
    return result


class NgramFeed(object):
    """The JAX LM example's learnable token stream
    (examples/transformer/transformer_lm.py): each row counts up by one
    from a random offset.  ``batches()`` yields ``(batch, mask)`` as
    ``Trainer.fit_feed`` takes them; ``terminate()`` ends it."""

    def __init__(self, np, seed, batch, seq, vocab):
        self.np = np
        self.rng = np.random.default_rng(seed)
        self.shape = (batch, seq)
        self.vocab = vocab
        self.terminated = False

    def next_batch(self):
        np = self.np
        offs = self.rng.integers(0, self.vocab, (self.shape[0], 1))
        tokens = (np.arange(self.shape[1])[None] + offs) % self.vocab
        return ({"tokens": tokens.astype(np.int32)},
                np.ones(self.shape[0], np.float32))

    def batches(self):
        while not self.terminated:
            yield self.next_batch()

    def next_group(self, k):
        """``k`` batches as ``(K, B, S)`` / ``(K, B)`` numpy stacks."""
        np = self.np
        items = [self.next_batch() for _ in range(k)]
        return ({"tokens": np.stack([b["tokens"] for b, _ in items])},
                np.stack([m for _, m in items]))

    def grouped_batches(self, k):
        while not self.terminated:
            yield ("multi",) + self.next_group(k)

    def terminate(self):
        self.terminated = True


class LossCurve(object):
    """A summary writer that keeps the Trainer's per-step loss curve
    (``TimeHistory`` writes one point per step of a K-step dispatch)."""

    def __init__(self):
        self.losses = {}

    def add_scalars(self, scalars, step):
        if "loss" in scalars:
            self.losses[int(step)] = float(scalars["loss"])

    def flush(self):
        pass


def phase_train(torch, np, fa, metrics, kind, kernel_ms):
    """Train the flagship LM through ``Trainer.fit_feed`` with async
    checkpoints on the default device, count the kernels' launches, then
    check the gradients against full attention, the resume and the
    handoff to serving."""
    import functools

    from tensorflowonspark_torch import checkpoint, serving, train
    from tensorflowonspark_torch.models import get_model, transformer

    vocab, layers = LM_CONFIG["vocab_size"], LM_CONFIG["num_layers"]
    heads, head_dim = LM_CONFIG["num_heads"], LM_CONFIG["head_dim"]
    d_model = heads * head_dim
    model = get_model("transformer_lm", **LM_CONFIG)
    model.init_weights(torch.Generator().manual_seed(0))
    init = dict(model.state_dict())
    with torch.device("meta"):   # its params always come from a dict
        full_model = get_model("transformer_lm",
                               **dict(LM_CONFIG, attention="full"))
    loss_fn = transformer.loss_fn(model)
    # the flash kernels' FLOPs, which FlopCounterMode cannot see: causal
    # forward 2 and backward 5 S^2 D products per (batch, head, layer)
    flash_flops = 7 * SEQ * SEQ * head_dim * TRAIN_BATCH * heads * layers
    # model FLOPs for comparison: 3 x the forward's matmuls, plus the above
    analytic_flops = (3 * TRAIN_BATCH * SEQ * (24 * d_model * d_model * layers
                                              + 2 * d_model * vocab)
                      + flash_flops)

    def new_trainer(**adam):
        return train.Trainer(loss_fn, init,
                             functools.partial(torch.optim.Adam, lr=LR,
                                               **adam),
                             compute_dtype=torch.bfloat16,
                             batch_size=TRAIN_BATCH, log_steps=LOG_STEPS,
                             extra_step_flops=flash_flops)

    trainer = new_trainer()
    feed = NgramFeed(np, 0, TRAIN_BATCH, SEQ, vocab)
    # the first step's loss: the initial params on the feed's first batch
    batch0, mask0 = NgramFeed(np, 0, TRAIN_BATCH, SEQ, vocab).next_batch()
    with torch.no_grad():
        first_loss = loss_fn(trainer.state.params,
                             {"tokens": torch.from_numpy(
                                 batch0["tokens"]).to(trainer.device)},
                             torch.from_numpy(mask0).to(trainer.device))[0]
        first_loss = first_loss.item()

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = checkpoint.CheckpointManager(
            os.path.join(tmp, "ckpt"), save_interval_steps=LOG_STEPS,
            max_to_keep=2, async_save=True)
        window_losses = []

        def on_steps(step):
            if step % LOG_STEPS == 0:   # a window closed in this step
                window_losses.append(trainer.history.last_synced_value)
            ckpt.maybe_save(step, trainer.state)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        t0 = time.perf_counter()                      # the main path starts
        stats = trainer.fit_feed(feed, max_steps=TRAIN_STEPS,
                                 on_steps=on_steps)
        fit_s = time.perf_counter() - t0
        launches = {"flash_fwd": fa.fwd_launches,
                    "flash_bwd_dq": fa.bwd_dq_launches,
                    "flash_bwd_dkv": fa.bwd_dkv_launches}  # ... and ends
        peak_bytes = torch.cuda.max_memory_allocated()
        log = trainer.history.timestamp_log
        window_ms = [1e3 * (t1 - t0_) / (s1 - s0)
                     for (s0, t0_), (s1, t1) in zip(log, log[1:])]
        step_ms = sorted(window_ms)[len(window_ms) // 2]
        step_flops = trainer.history.step_flops
        # where fit_feed's closed windows went (the Trainer's report)
        attribution = trainer.attribution_report()
        mfu = metrics.mfu_from_step_time(step_flops, step_ms / 1e3)
        flash_ms = sum(layers * kernel_ms[name] for name in launches)

        # gradients of one step, flash against full attention, on the
        # trained weights and a fresh batch
        fixed, fixed_mask = NgramFeed(np, 1, TRAIN_BATCH, SEQ,
                                      vocab).next_batch()
        dev = trainer.device
        tokens = {"tokens": torch.from_numpy(fixed["tokens"]).to(dev)}
        mask = torch.from_numpy(fixed_mask).to(dev)
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in trainer.state.params.items()}
        g_flash = torch.autograd.grad(loss_fn(params, tokens, mask)[0],
                                      list(params.values()))
        g_full = torch.autograd.grad(
            transformer.loss_fn(full_model)(params, tokens, mask)[0],
            list(params.values()))
        grad_rel = {name: ((a.float() - b.float()).norm()
                           / b.float().norm().clamp_min(1e-30)).item()
                    for name, a, b in zip(params, g_flash, g_full)}
        del params, g_flash, g_full
        worst_grad = max(grad_rel, key=grad_rel.get)

        # resume: a fresh Trainer restored from the last checkpoint takes
        # the same step as the original on the same batch
        ckpt.wait_until_finished()
        saved = ckpt.latest_step()
        resumed = new_trainer()
        restored = resumed.restore_latest(ckpt)
        want_loss, _ = trainer.step(fixed, fixed_mask)
        got_loss, _ = resumed.step(fixed, fixed_mask)
        resume_loss_diff = abs(got_loss.item() - want_loss.item())
        resume_param_diff = max(
            (resumed.state.params[k] - t).abs().max().item()
            for k, t in trainer.state.params.items())
        ckpt.close()
        del resumed

        # handoff: the trained params exported and served
        export_dir = os.path.join(tmp, "export")
        checkpoint.export_model(
            export_dir, trainer.state.params, "transformer_lm",
            model_config=LM_CONFIG,
            input_signature={"tokens": {"shape": [None, SEQ],
                                        "dtype": "int32"}})
        server = serving.ModelServer(export_dir, batch_size=SERVE_BATCH)
        request = np.random.default_rng(2).integers(
            0, vocab, (SERVE_BATCH, SEQ), dtype=np.int32)
        served = server.predict_feed({"tokens": request},
                                     SERVE_BATCH)["output"]
        with torch.inference_mode():
            trained = torch.func.functional_call(
                model, trainer.state.params,
                (torch.from_numpy(request).to(dev),)).float().cpu().numpy()
        del server
        handoff_diff = float(np.abs(served - trained).max())
        handoff_scale = float(np.abs(trained).max())

        # the Trainer's default on the card is capturable Adam (eager and
        # graph steps share its arithmetic); the same 30 steps with
        # capturable=False, as a caller may ask, for the loss difference
        plain = new_trainer(capturable=False)
        plain_losses = []

        def on_plain_steps(step):
            if step % LOG_STEPS == 0:
                plain_losses.append(plain.history.last_synced_value)

        plain.fit_feed(NgramFeed(np, 0, TRAIN_BATCH, SEQ, vocab),
                       max_steps=TRAIN_STEPS, on_steps=on_plain_steps)

        # where a step's time goes, once warm, on batches already on the
        # card: steps with no checkpoint in flight (capturable Adam and
        # capturable=False interleaved), the same with one async save in
        # flight, and a profile
        more = NgramFeed(np, 3, TRAIN_BATCH, SEQ, vocab)
        steady = interleaved_steady(
            torch, {"capturable": trainer, "not_capturable": plain},
            device_batches(torch, more, STEADY_STEPS, dev), AB_ROUNDS)
        del plain
        steady_ms = median(steady["capturable"])
        ckpt2 = checkpoint.CheckpointManager(
            os.path.join(tmp, "ckpt2"), save_interval_steps=0,
            async_save=True)
        inflight_ms = time_steps(
            torch, trainer, device_batches(torch, more, STEADY_STEPS, dev),
            first=lambda: ckpt2.maybe_save(trainer.state.step,
                                           trainer.state, force=True))
        ckpt2.close()
        profile = profile_steps(
            torch, trainer, device_batches(torch, more, PROFILE_STEPS, dev))
        # the profiler slows the host; against the unprofiled steady step
        busy = profile["device_busy_ms_per_step"]
        profile["device_idle_share_of_steady_step"] = (
            1.0 - busy / steady_ms if busy else None)

    steps = stats["global_steps"]
    expected = layers * steps
    losses_finite = all(np.isfinite(x) for x in window_losses + [first_loss])
    row = {"phase": "train", "config": LM_CONFIG, "device": str(dev),
           "batch": TRAIN_BATCH, "seq": SEQ, "steps": steps,
           "optimizer": "torch.optim.Adam(lr={}), capturable".format(LR),
           "first_step_loss": first_loss,
           "window_losses": window_losses, "loss_drop": LOSS_DROP,
           "window_ms_per_step": window_ms, "ms_per_step": step_ms,
           "tokens_per_s": TRAIN_BATCH * SEQ / (step_ms / 1e3),
           "fit_feed_s": fit_s, "step_flops": step_flops,
           "analytic_step_flops": analytic_flops, "mfu": mfu,
           "trainer_mfu_pct": stats["overlap"].get("train_mfu_pct_max"),
           "max_memory_allocated": peak_bytes,
           "launches": launches, "expected_launches": expected,
           "flash_ms_per_step": flash_ms,
           "flash_share": flash_ms / step_ms,
           "steady_ms_per_step": steady_ms,
           "capturable_ab": {
               "runs_ms_per_step": steady,
               "median_ms_per_step": {k: median(v)
                                      for k, v in steady.items()},
               "spread_ms": {k: max(v) - min(v) for k, v in steady.items()},
               "not_capturable_window_losses": plain_losses,
               "loss_diff": [abs(a - b) for a, b in zip(plain_losses,
                                                        window_losses)]},
           "steady_tokens_per_s": TRAIN_BATCH * SEQ / (steady_ms / 1e3),
           "steady_mfu": metrics.mfu_from_step_time(step_flops,
                                                    steady_ms / 1e3),
           "steady_flash_share": flash_ms / steady_ms,
           "save_in_flight_ms_per_step": inflight_ms,
           "profile": profile,
           "overlap": stats["overlap"],
           "attribution": attribution,
           "step_bytes": stats["overlap"].get("train_step_bytes_max"),
           "grad_rel_err_max": grad_rel[worst_grad],
           "grad_rel_err_worst_tensor": worst_grad, "grad_rtol": GRAD_RTOL,
           "checkpoint_latest": saved, "restored_step": restored,
           "resume_loss_diff": resume_loss_diff,
           "resume_param_max_diff": resume_param_diff,
           "resume_tol": RESUME_TOL,
           "handoff_max_abs_diff": handoff_diff,
           "handoff_max_abs_logit": handoff_scale,
           "handoff_tol": HANDOFF_TOL * handoff_scale}
    emit(row)
    if not losses_finite or len(window_losses) != TRAIN_STEPS // LOG_STEPS:
        raise AssertionError("training loss not finite at every window: "
                             "{}".format(window_losses))
    if not window_losses[-1] <= first_loss - LOSS_DROP:
        raise AssertionError("loss did not fall: first step {}, windows "
                             "{}".format(first_loss, window_losses))
    if any(n != expected for n in launches.values()):
        raise AssertionError("kernel launches {} over fit_feed, expected {} "
                             "each (layers x steps)".format(launches,
                                                            expected))
    if not grad_rel[worst_grad] <= GRAD_RTOL:
        raise AssertionError("flash gradients differ from full attention's: "
                             "{} at {}".format(grad_rel[worst_grad],
                                               worst_grad))
    if saved != TRAIN_STEPS or restored != TRAIN_STEPS:
        raise AssertionError("checkpoint at step {}, restored {}, expected "
                             "{}".format(saved, restored, TRAIN_STEPS))
    if not (resume_loss_diff <= RESUME_TOL
            and resume_param_diff <= RESUME_TOL):
        raise AssertionError("the resumed step differs: loss {}, params "
                             "{}".format(resume_loss_diff, resume_param_diff))
    if not handoff_diff <= HANDOFF_TOL * handoff_scale:
        raise AssertionError("the served export differs from the trained "
                             "model by {} (max |logit| {})".format(
                                 handoff_diff, handoff_scale))
    return row


def phase_train_megastep(torch, np, fa, metrics, k1):
    """The train phase at K = 5: the same init, stream and async
    checkpoints through ``fit_feed(steps_per_call=5)``, each step after two
    eager warm-ups a replay of one captured CUDA graph.  Counts the
    kernels' launches, holds the losses at steps 10, 20 and 30 to K = 1's,
    times warm groups on device-resident stacks with and without the
    profiler, and restores a checkpoint into the trainer that captured."""
    import functools

    from tensorflowonspark_torch import checkpoint, train
    from tensorflowonspark_torch.models import get_model, transformer

    vocab, layers = LM_CONFIG["vocab_size"], LM_CONFIG["num_layers"]
    heads, head_dim = LM_CONFIG["num_heads"], LM_CONFIG["head_dim"]
    model = get_model("transformer_lm", **LM_CONFIG)
    model.init_weights(torch.Generator().manual_seed(0))
    init = dict(model.state_dict())
    loss_fn = transformer.loss_fn(model)
    flash_flops = 7 * SEQ * SEQ * head_dim * TRAIN_BATCH * heads * layers

    def new_trainer(**kwargs):
        return train.Trainer(loss_fn, init,
                             functools.partial(torch.optim.Adam, lr=LR),
                             compute_dtype=torch.bfloat16,
                             batch_size=TRAIN_BATCH, log_steps=LOG_STEPS,
                             extra_step_flops=flash_flops, **kwargs)

    curve = LossCurve()
    trainer = new_trainer(summary_writer=curve)
    feed = NgramFeed(np, 0, TRAIN_BATCH, SEQ, vocab)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = checkpoint.CheckpointManager(
            os.path.join(tmp, "ckpt"), save_interval_steps=LOG_STEPS,
            max_to_keep=2, async_save=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        t0 = time.perf_counter()                      # the main path starts
        # under the profiler: the flash kernels the card executed, against
        # the counters (which a replay advances by its capture's launches)
        stats, executed = counted_on_device(torch, lambda: trainer.fit_feed(
            feed, max_steps=TRAIN_STEPS, steps_per_call=MEGA_K,
            on_steps=lambda step: ckpt.maybe_save(step, trainer.state)))
        fit_s = time.perf_counter() - t0
        launches = {"flash_fwd": fa.fwd_launches,
                    "flash_bwd_dq": fa.bwd_dq_launches,
                    "flash_bwd_dkv": fa.bwd_dkv_launches}  # ... and ends
        fit_steps = trainer.state.step
        peak_bytes = torch.cuda.max_memory_allocated()
        # the uninterrupted run's params, for the supervised phase
        final_params = {k: v.detach().cpu()
                        for k, v in trainer.state.params.items()}
        attribution = trainer.attribution_report()
        snap = trainer.counters_snapshot()
        log = trainer.history.timestamp_log
        window_ms = [1e3 * (t1 - t0_) / (s1 - s0)
                     for (s0, t0_), (s1, t1) in zip(log, log[1:])]
        checked = [LOG_STEPS * (i + 1) for i in range(TRAIN_STEPS // LOG_STEPS)]
        losses = {str(step): curve.losses.get(step) for step in checked}
        vs_k1 = {str(step): (abs(curve.losses[step] - want)
                             if step in curve.losses else None)
                 for step, want in zip(checked, k1["window_losses"])}

        # warm groups of 5 on device-resident stacks: host clock from a
        # synchronised start to a synchronised end, then a profile; the
        # last async save lands first (its copies would share the card)
        ckpt.wait_until_finished()
        more = NgramFeed(np, 3, TRAIN_BATCH, SEQ, vocab)
        groups = []
        for _ in range(MEGA_STEADY_GROUPS + MEGA_PROFILE_GROUPS):
            batch, mask = more.next_group(MEGA_K)
            groups.append(({"tokens": torch.from_numpy(
                batch["tokens"]).to(trainer.device)},
                torch.from_numpy(mask).to(trainer.device)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch, mask in groups[:MEGA_STEADY_GROUPS]:
            trainer.multi_step(batch, mask)
        torch.cuda.synchronize()
        steady_ms = 1e3 * (time.perf_counter() - t0) / (
            MEGA_STEADY_GROUPS * MEGA_K)

        def profiled():
            for batch, mask in groups[MEGA_STEADY_GROUPS:]:
                trainer.multi_step(batch, mask)

        profile = profile_run(torch, profiled, MEGA_PROFILE_GROUPS * MEGA_K)
        busy = profile["device_busy_ms_per_step"]
        profile["device_idle_share_of_steady_step"] = (
            1.0 - busy / steady_ms if busy else None)

        # a checkpoint restored into the trainer that captured: its next
        # step (a graph replay) against a fresh trainer's eager step
        ckpt.wait_until_finished()
        saved = ckpt.latest_step()
        restored = trainer.restore_latest(ckpt)
        fresh = new_trainer()
        fresh.restore_latest(ckpt)
        fixed, fixed_mask = NgramFeed(np, 1, TRAIN_BATCH, SEQ,
                                      vocab).next_batch()
        got = trainer.repeat_step(fixed, fixed_mask, 1)
        want, _ = fresh.step(fixed, fixed_mask)
        restore_loss_diff = abs(got.item() - want.item())
        restore_param_diff = max(
            (fresh.state.params[k] - t).abs().max().item()
            for k, t in trainer.state.params.items())
        ckpt.close()
        del fresh

    expected = layers * TRAIN_STEPS
    row = {"phase": "train_megastep", "steps_per_call": MEGA_K,
           "steps": fit_steps, "fit_feed_s": fit_s,
           "megastep": stats["megastep"],
           "launches": launches, "device_launches": executed,
           "expected_launches": expected,
           "losses": losses, "k1_window_losses": k1["window_losses"],
           "loss_diff_vs_k1": vs_k1, "loss_tol_vs_k1": MEGA_LOSS_TOL,
           "window_ms_per_step": window_ms,
           "steady_ms_per_step": steady_ms,
           "k1_steady_ms_per_step": k1["steady_ms_per_step"],
           "steady_tokens_per_s": TRAIN_BATCH * SEQ / (steady_ms / 1e3),
           "steady_mfu": metrics.mfu_from_step_time(
               trainer.history.step_flops, steady_ms / 1e3),
           "profile": profile,
           "k1_profile_device_busy_ms_per_step":
               k1["profile"]["device_busy_ms_per_step"],
           "capture_s": snap.get("train_compile_us_max", 0) / 1e6,
           "graphs": len(trainer._graphs),
           "attribution": attribution, "k1_attribution": k1["attribution"],
           "overlap": stats["overlap"],
           "max_memory_allocated": peak_bytes,
           "checkpoint_latest": saved, "restored_step": restored,
           "restore_loss_diff": restore_loss_diff,
           "restore_param_max_diff": restore_param_diff,
           "restore_tol": RESUME_TOL}
    emit(row)
    if fit_steps != TRAIN_STEPS:
        raise AssertionError("fit_feed took {} steps at K = {}, expected "
                             "{}".format(fit_steps, MEGA_K, TRAIN_STEPS))
    if any(n != expected for n in list(launches.values())
           + list(executed.values())):
        raise AssertionError("kernel launches {} counted and {} executed on "
                             "the card over fit_feed at K = {}, expected {} "
                             "each".format(launches, executed, MEGA_K,
                                           expected))
    if trainer.state.step != restored + 1:
        raise AssertionError("the restored trainer is at step {}, expected "
                             "{}".format(trainer.state.step, restored + 1))
    if not all(d is not None and d <= MEGA_LOSS_TOL for d in vs_k1.values()):
        raise AssertionError("the K = {} losses differ from K = 1's: "
                             "{}".format(MEGA_K, vs_k1))
    if saved != TRAIN_STEPS or restored != TRAIN_STEPS:
        raise AssertionError("checkpoint at step {}, restored {}, expected "
                             "{}".format(saved, restored, TRAIN_STEPS))
    if not (restore_loss_diff <= RESUME_TOL
            and restore_param_diff <= RESUME_TOL):
        raise AssertionError("the step after a restore into the captured "
                             "trainer differs: loss {}, params {}".format(
                                 restore_loss_diff, restore_param_diff))
    return row, final_params


class TokenRows(object):
    """Rows of tokens served like a DataFeed's columnar path
    (``next_batch_arrays``), for a :class:`ShardedFeed`."""

    def __init__(self, tokens):
        self.tokens = tokens
        self.pos = 0
        self.done = False

    def next_batch_arrays(self, n):
        rows = self.tokens[self.pos:self.pos + n]
        self.pos += len(rows)
        if len(rows) < n:
            self.done = True
        return {"tokens": rows}, len(rows)

    def should_stop(self):
        return self.done

    def interrupt(self):
        pass

    def terminate(self):
        pass


class SupervisedFeed(NgramFeed):
    """The phase stream from the step a trainer resumes at (the batches
    before it are drawn and dropped), in groups of K.  ``crash_at``: raise
    a retryable injected failure once the trainer reached that step.
    ``row_weight``: every batch carries a float ``row_weight`` of ones (a
    NaN batch then has something to poison).  ``rollback``: once the
    trainer's health counters saw a nonfinite loss, drop the fault spec
    (the poison was in the data) and push the ``train_rollback`` knob
    through ``node.apply_knobs``, as the remediator does."""

    def __init__(self, np, trainer, crash_at=None, row_weight=False,
                 rollback=None):
        super().__init__(np, 0, TRAIN_BATCH, SEQ, LM_CONFIG["vocab_size"])
        self.trainer = trainer
        self.crash_at = crash_at
        self.row_weight = row_weight
        self.rollback = rollback
        for _ in range(trainer.state.step):
            self.next_batch()

    def next_batch(self):
        batch, mask = super().next_batch()
        if self.row_weight:
            batch["row_weight"] = self.np.ones(TRAIN_BATCH, self.np.float32)
        return batch, mask

    def next_group(self, k):
        items = [self.next_batch() for _ in range(k)]
        return ({name: self.np.stack([b[name] for b, _ in items])
                 for name in items[0][0]},
                self.np.stack([m for _, m in items]))

    def grouped_batches(self, k):
        from tensorflowonspark_torch import fault, node

        while not self.terminated:
            if (self.crash_at is not None
                    and self.trainer.state.step >= self.crash_at):
                fault.fail("injected feed loss after step {}".format(
                    self.trainer.state.step))
            if (self.rollback is not None and self.trainer.counters_snapshot()
                    .get("train_nonfinite_loss", 0)):
                os.environ.pop(fault.FAULT_SPEC_ENV, None)
                node.apply_knobs({"train_rollback": self.rollback})
                self.rollback = None
            yield ("multi",) + self.next_group(k)


def launches_of(fa):
    return {"flash_fwd": fa.fwd_launches, "flash_bwd_dq": fa.bwd_dq_launches,
            "flash_bwd_dkv": fa.bwd_dkv_launches}


def phase_supervised(torch, np, fa, k1, k5, uninterrupted, publish_root):
    """Supervised training at full width and depth (the train phases'
    config, init, stream and optimizer): ``fit_supervised`` at K = 5
    through a crash, a corrupt newest checkpoint and a poison rollback;
    ``accum_steps=2`` and ``remat=True`` at K = 1 and K = 5; and
    ``Trainer.evaluate`` of the trained params.  ``k1`` and ``k5`` are the
    train phases' rows, ``uninterrupted`` the params of the K = 5 run's 30
    steps (on the host).  The crash run publishes its final params
    (``fit_supervised(publish=)``) into a registry at ``publish_root``,
    for the fleet phase."""
    import functools
    import gc
    import shutil

    from tensorflowonspark_torch import checkpoint, fault, train
    from tensorflowonspark_torch.models import get_model, transformer
    from tensorflowonspark_torch.parallel.infeed import ShardedFeed

    vocab, layers = LM_CONFIG["vocab_size"], LM_CONFIG["num_layers"]
    heads, head_dim = LM_CONFIG["num_heads"], LM_CONFIG["head_dim"]
    model = get_model("transformer_lm", **LM_CONFIG)
    model.init_weights(torch.Generator().manual_seed(0))
    init = dict(model.state_dict())
    flash_flops = 7 * SEQ * SEQ * head_dim * TRAIN_BATCH * heads * layers
    checked = [LOG_STEPS * (i + 1)
               for i in range(VARIANT_STEPS // LOG_STEPS)]

    def new_trainer(loss_fn=None, **kwargs):
        return train.Trainer(loss_fn or transformer.loss_fn(model), init,
                             functools.partial(torch.optim.Adam, lr=LR),
                             compute_dtype=torch.bfloat16,
                             batch_size=TRAIN_BATCH, log_steps=LOG_STEPS,
                             extra_step_flops=flash_flops, **kwargs)

    def release():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def param_diff(trainer):
        return max((trainer.state.params[k].detach().cpu() - t).abs().max()
                   .item() for k, t in uninterrupted.items())

    def supervised(trainer, directory, max_steps=TRAIN_STEPS, counted=True,
                   publish=None, **feed_kwargs):
        """fit_supervised at K = 5 from fresh SupervisedFeeds, under the
        profiler when ``counted`` (the run whose launches are held to the
        kernels the card executed), publishing to the fleet with
        ``publish``; returns what it measured."""
        ckpt = checkpoint.CheckpointManager(
            directory, save_interval_steps=SUPERVISED_SAVE_STEPS,
            max_to_keep=2, async_save=True)
        starts = []

        def factory():
            starts.append(trainer.state.step)
            kwargs = dict(feed_kwargs)
            if len(starts) > 1:
                kwargs.pop("crash_at", None)
            return SupervisedFeed(np, trainer, **kwargs)

        policy = fault.RetryPolicy(max_attempts=3, initial_backoff=0.05,
                                   extra_retryable=["injected"])
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        t0 = time.perf_counter()                  # the main path starts
        def run():
            return train.fit_supervised(trainer, factory, ckpt,
                                        retry_policy=policy,
                                        max_steps=max_steps,
                                        steps_per_call=MEGA_K,
                                        publish=publish)

        stats, executed = (counted_on_device(torch, run) if counted
                           else (run(), None))
        wall_s = time.perf_counter() - t0
        launches = launches_of(fa)                # ... and ends
        snap = trainer.counters_snapshot()
        out = {"feed_starts": starts, "steps": trainer.state.step,
               "wall_s": wall_s, "final_loss": stats["loss"],
               "recovery_us": snap.get("goodput_recovery_us", 0),
               "rollbacks": snap.get("train_rollbacks_total", 0),
               "checkpoints": sorted(os.listdir(ckpt.directory)),
               "launches": launches, "device_launches": executed}
        if publish is not None:
            out["published"] = stats.get("published")
            out["publish_error"] = stats.get("publish_error")
        ckpt.close()
        return out

    def plain_fit(trainer, k):
        """fit_feed of the phase stream, ``VARIANT_STEPS`` at K = ``k``,
        under the profiler: the loss at step 10, peak memory and
        launches."""
        curve, window = LossCurve(), {}
        trainer.summary_writer = curve   # read at the first step

        def on_steps(step):
            if k == 1 and step % LOG_STEPS == 0:
                window[step] = trainer.history.last_synced_value

        release()
        torch.cuda.reset_peak_memory_stats()
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        _, executed = counted_on_device(torch, lambda: trainer.fit_feed(
            NgramFeed(np, 0, TRAIN_BATCH, SEQ, vocab), max_steps=VARIANT_STEPS,
            steps_per_call=k, on_steps=on_steps))
        launches = launches_of(fa)
        peak = torch.cuda.max_memory_allocated()
        losses = window if k == 1 else {s: curve.losses.get(s)
                                        for s in checked}
        return {"losses": {str(s): losses.get(s) for s in checked},
                "max_memory_allocated": peak, "launches": launches,
                "device_launches": executed}

    def accum_step_check(trainer):
        """One step's loss and gradients at ``accum_steps=2`` against
        ``accum_steps=1`` (the trainer's own ``_grads``, the work of a
        step before the optimizer) on the trainer's params and a fresh
        batch."""
        batch, mask = trainer._prepare(*NgramFeed(
            np, 1, TRAIN_BATCH, SEQ, vocab).next_batch())
        names = list(trainer.state.params)
        out = {}
        for a in (1, ACCUM_STEPS):
            trainer.accum_steps = a
            loss, _ = trainer._grads(batch, mask)
            out[a] = (loss.item(), [trainer.state.params[n].grad.float()
                                    for n in names])
        trainer.state.optimizer.zero_grad(set_to_none=True)
        rel = {n: ((g - g1).norm() / g1.norm().clamp_min(1e-30)).item()
               for n, g1, g in zip(names, out[1][1], out[ACCUM_STEPS][1])}
        worst = max(rel, key=rel.get)
        return {"loss_accum1": out[1][0], "loss_accum2": out[ACCUM_STEPS][0],
                "loss_diff": abs(out[ACCUM_STEPS][0] - out[1][0]),
                "grad_rel_err_max": rel[worst],
                "grad_rel_err_worst_tensor": worst, "grad_rtol": GRAD_RTOL}

    def steady(trainer, k):
        """ms per step of warm steps on batches already on the card: 10
        single steps at K = 1, groups of 5 at K = 5."""
        more = NgramFeed(np, 3, TRAIN_BATCH, SEQ, vocab)
        dev = trainer.device
        if k == 1:
            return time_steps(torch, trainer,
                              device_batches(torch, more, STEADY_STEPS, dev))
        groups = []
        for _ in range(SUPERVISED_STEADY_GROUPS):
            batch, mask = more.next_group(k)
            groups.append(({"tokens": torch.from_numpy(
                batch["tokens"]).to(dev)}, torch.from_numpy(mask).to(dev)))
        trainer.multi_step(*groups[0])          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch, mask in groups:
            trainer.multi_step(batch, mask)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (len(groups) * k)

    def group_profile(trainer):
        """Device time of one warm group of K steps, by kernel group."""
        batch, mask = NgramFeed(np, 4, TRAIN_BATCH, SEQ,
                                vocab).next_group(MEGA_K)
        dev = trainer.device
        batch = {"tokens": torch.from_numpy(batch["tokens"]).to(dev)}
        mask = torch.from_numpy(mask).to(dev)
        prof = profile_run(torch, lambda: trainer.multi_step(batch, mask),
                           MEGA_K)
        return {"device_busy_ms_per_step": prof["device_busy_ms_per_step"],
                "ms_per_step_by_group": prof["ms_per_step_by_group"]}

    k1_losses = {str(s): v for s, v in zip(checked, k1["window_losses"])}
    k5_losses = k5["losses"]
    row = {"phase": "supervised", "steps_per_call": MEGA_K,
           "save_interval_steps": SUPERVISED_SAVE_STEPS,
           "resume_tol": RESUME_TOL}
    tmp = tempfile.mkdtemp()
    try:
        # (a) crash -> resume
        trainer = new_trainer()
        a = supervised(trainer, os.path.join(tmp, "a"), crash_at=CRASH_STEP,
                       publish=fleet_publish_spec(publish_root))
        a["param_max_diff_vs_uninterrupted"] = param_diff(trainer)
        row["crash_resume"] = a
        final = {k: v.detach().cpu() for k, v in
                 trainer.state.params.items()}   # evaluated in (f)
        del trainer
        release()

        # (b) the newest checkpoint corrupt -> quarantined
        trainer = new_trainer()
        first = supervised(trainer, os.path.join(tmp, "b"),
                           max_steps=SUPERVISED_SAVE_STEPS, counted=False)
        os.environ[fault.FAULT_SPEC_ENV] = json.dumps(
            {"corrupt_checkpoint": True})
        try:
            # the manager resolves its fault injector once, when made
            b = supervised(trainer, os.path.join(tmp, "b"),
                           crash_at=CORRUPT_CRASH_STEP, counted=False)
        finally:
            os.environ.pop(fault.FAULT_SPEC_ENV, None)
        b["first_run_checkpoints"] = first["checkpoints"]
        b["param_max_diff_vs_uninterrupted"] = param_diff(trainer)
        row["corrupt_quarantine"] = b
        del trainer
        release()

        # (c) poison -> rollback
        lm_loss = transformer.loss_fn(model)

        def weighted_loss(params, batch, mask):
            return lm_loss(params, {"tokens": batch["tokens"]},
                           mask * batch["row_weight"])

        trainer = new_trainer(weighted_loss)
        os.environ[fault.FAULT_SPEC_ENV] = json.dumps(
            {"nan_batch_at_step": NAN_STEP})
        try:
            c = supervised(trainer, os.path.join(tmp, "c"), row_weight=True,
                           rollback="poison-1", counted=False)
        finally:
            os.environ.pop(fault.FAULT_SPEC_ENV, None)
        c["param_max_diff_vs_uninterrupted"] = param_diff(trainer)
        c["nonfinite_loss_windows"] = trainer.counters_snapshot().get(
            "train_nonfinite_loss")
        row["poison_rollback"] = c
        del trainer
        release()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) accum_steps=2 and (e) remat=True, at K = 1 and K = 5, against the
    # plain step on the same batches, all without checkpoints (so that
    # their peak memory compares)
    with torch.device("meta"):   # its params always come from a dict
        remat_model = get_model("transformer_lm",
                                **dict(LM_CONFIG, remat=True))
    variants = {}
    for name, make in (
            ("plain", new_trainer),
            ("accum2", lambda: new_trainer(accum_steps=ACCUM_STEPS)),
            ("remat", lambda: new_trainer(transformer.loss_fn(remat_model)))):
        for k in (1, MEGA_K):
            trainer = make()
            run = plain_fit(trainer, k)
            run["steady_ms_per_step"] = steady(trainer, k)
            if name == "accum2" and k == 1:
                run["one_step_vs_accum1"] = accum_step_check(trainer)
            if k > 1:
                run["profile"] = group_profile(trainer)
            if k > 1:
                k1_run = variants[name + "_k1"]["losses"]
                run["loss_diff_vs_k1"] = {
                    s: abs(v - k1_run[s]) for s, v in run["losses"].items()}
            want = (variants["plain_k{}".format(k)]["losses"]
                    if name != "plain" else k1_losses if k == 1
                    else k5_losses)
            run["loss_diff_vs_plain"] = {
                s: (abs(v - want[s]) if v is not None else None)
                for s, v in run["losses"].items()}
            variants["{}_k{}".format(name, k)] = run
            del trainer
            release()
    row["accum_steps"] = ACCUM_STEPS
    row["accum_loss_tol"] = ACCUM_LOSS_TOL
    row["remat_loss_tol"] = REMAT_LOSS_TOL
    row["variants"] = variants
    row["train_phases"] = {
        "k1": {"max_memory_allocated": k1["max_memory_allocated"],
               "steady_ms_per_step": k1["steady_ms_per_step"]},
        "k5": {"max_memory_allocated": k5["max_memory_allocated"],
               "steady_ms_per_step": k5["steady_ms_per_step"]}}

    # (f) evaluate the trained params over held-out rows, flash and full
    trainer = new_trainer()
    with torch.no_grad():
        for name, t in trainer.state.params.items():
            t.copy_(final[name])
    del final
    with torch.device("meta"):   # its params always come from a dict
        full_model = get_model("transformer_lm",
                               **dict(LM_CONFIG, attention="full"))
    rows = lm_rows(np, 5, EVAL_ROWS, SEQ, vocab)
    seen = []

    def lm_metric(net):
        def metric(params, batch, mask):
            tokens = batch["tokens"].long()
            logits = torch.func.functional_call(net, params, (tokens,))
            targets = torch.roll(tokens, -1, dims=1)
            pos = (torch.arange(SEQ, device=tokens.device)
                   < SEQ - 1).float()
            ce = torch.nn.functional.cross_entropy(
                logits.reshape(-1, vocab), targets.reshape(-1),
                reduction="none").reshape(tokens.shape)
            hit = (logits.argmax(-1) == targets).float()
            row_ce = (ce * pos).sum(-1) / pos.sum()
            row_acc = (hit * pos).sum(-1) / pos.sum()
            seen.append(mask.sum())
            return ({"loss": (row_ce * mask).sum(),
                     "accuracy": (row_acc * mask).sum()}, mask.sum())
        return metric

    fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    t0 = time.perf_counter()                      # the main path starts
    got, executed = counted_on_device(torch, lambda: trainer.evaluate(
        ShardedFeed(TokenRows(rows), TRAIN_BATCH), lm_metric(model)))
    eval_s = time.perf_counter() - t0
    eval_launches = launches_of(fa)               # ... and ends
    eval_rows = [float(m) for m in seen]
    want = trainer.evaluate(ShardedFeed(TokenRows(rows), TRAIN_BATCH),
                            lm_metric(full_model))
    row["evaluate"] = {
        "rows": EVAL_ROWS, "batch_rows": eval_rows, "flash": got,
        "full": want, "tol": EVAL_TOL, "wall_s": eval_s,
        "diff": {k: abs(got[k] - want[k]) for k in got},
        "launches": eval_launches, "device_launches": executed}
    del trainer
    release()
    emit(row)

    # the checks
    steps_a = (CRASH_STEP + TRAIN_STEPS - SUPERVISED_SAVE_STEPS) * layers
    expected = {
        "crash_resume": dict.fromkeys(launches_of(fa), steps_a),
        "accum2_k1": dict.fromkeys(launches_of(fa),
                                   ACCUM_STEPS * layers * VARIANT_STEPS),
        "remat_k1": {"flash_fwd": 2 * layers * VARIANT_STEPS,
                     "flash_bwd_dq": layers * VARIANT_STEPS,
                     "flash_bwd_dkv": layers * VARIANT_STEPS},
        "evaluate": {"flash_fwd": layers * 3, "flash_bwd_dq": 0,
                     "flash_bwd_dkv": 0}}
    expected["accum2_k5"] = expected["accum2_k1"]
    expected["remat_k5"] = expected["remat_k1"]
    expected["plain_k1"] = expected["plain_k5"] = dict.fromkeys(
        launches_of(fa), layers * VARIANT_STEPS)
    counted = {"crash_resume": row["crash_resume"],
               "evaluate": row["evaluate"]}
    counted.update(variants)
    for name, want_n in expected.items():
        got_n = counted[name]
        if got_n["launches"] != want_n or got_n["device_launches"] != want_n:
            raise AssertionError(
                "{}: kernel launches {} counted and {} executed on the "
                "card, expected {}".format(name, got_n["launches"],
                                           got_n["device_launches"], want_n))
    for name, starts in (("crash_resume", [0, SUPERVISED_SAVE_STEPS]),
                         ("corrupt_quarantine", [SUPERVISED_SAVE_STEPS] * 2),
                         ("poison_rollback", [0, SUPERVISED_SAVE_STEPS])):
        r = row[name]
        if r["feed_starts"] != starts or r["steps"] != TRAIN_STEPS:
            raise AssertionError(
                "{}: feeds started at steps {} and ended at step {}, "
                "expected {} and {}".format(name, r["feed_starts"],
                                            r["steps"], starts, TRAIN_STEPS))
        if not math.isfinite(r["final_loss"]):
            raise AssertionError("{}: final loss {}".format(
                name, r["final_loss"]))
    for name in ("crash_resume", "corrupt_quarantine"):
        diff = row[name]["param_max_diff_vs_uninterrupted"]
        if not diff <= RESUME_TOL:
            raise AssertionError(
                "{}: the params differ from the uninterrupted run's by "
                "{}".format(name, diff))
    entry = row["crash_resume"]["published"]
    if not (entry and entry["version"] == "step-%d" % TRAIN_STEPS
            and entry["status"] == "staging"):
        raise AssertionError("fit_supervised(publish=) published {} ({})"
                             .format(entry,
                                     row["crash_resume"]["publish_error"]))
    if "20.corrupt" not in row["corrupt_quarantine"]["checkpoints"]:
        raise AssertionError("the garbled step 20 was not quarantined: "
                             "{}".format(row["corrupt_quarantine"]))
    c = row["poison_rollback"]
    if c["rollbacks"] != 1 or "20.corrupt" not in c["checkpoints"]:
        raise AssertionError("the poisoned step 20 was not rolled back: "
                             "{}".format(c))
    for name, run in variants.items():
        # plain: the train phases' runs again, in the same process; accum:
        # reported, and held one step at a time below
        tol = {"plain": RESUME_TOL, "remat": REMAT_LOSS_TOL}.get(
            name.split("_")[0])
        if tol is not None and not all(
                d is not None and d <= tol
                for d in run["loss_diff_vs_plain"].values()):
            raise AssertionError("{}: losses differ from the plain run's "
                                 "(plain: the train phases'): {}".format(
                                     name, run["loss_diff_vs_plain"]))
        diff = run.get("loss_diff_vs_k1", {})
        if not all(d <= MEGA_LOSS_TOL for d in diff.values()):
            raise AssertionError("{}: the K = {} losses differ from K = "
                                 "1's: {}".format(name, MEGA_K, diff))
    one = variants["accum2_k1"]["one_step_vs_accum1"]
    if not (one["loss_diff"] <= ACCUM_LOSS_TOL
            and one["grad_rel_err_max"] <= GRAD_RTOL):
        raise AssertionError("accum_steps={}: one step differs from the "
                             "full batch's: {}".format(ACCUM_STEPS, one))
    ev = row["evaluate"]
    if ev["batch_rows"] != [TRAIN_BATCH, TRAIN_BATCH,
                            EVAL_ROWS - 2 * TRAIN_BATCH]:
        raise AssertionError("evaluate saw batches of {} rows".format(
            ev["batch_rows"]))
    if not (all(math.isfinite(v) for v in got.values())
            and all(d <= EVAL_TOL for d in ev["diff"].values())):
        raise AssertionError("evaluate: flash {} against full {}".format(
            got, want))
    return row


def lm_rows(np, seed, n, seq, vocab):
    """``n`` rows of the JAX LM example's learnable token stream
    (examples/transformer/transformer_lm.py): each row counts up by one
    from a random offset."""
    base = np.arange(seq) % vocab
    offs = np.random.default_rng(seed).integers(0, vocab, (n, 1))
    return ((base[None, :] + offs) % vocab).astype(np.int32)


class RowCounter(object):
    """Passes a ShardedFeed on to ``fit_feed`` (single or grouped) and
    keeps each dispatch's valid rows as device scalars."""

    def __init__(self, feed):
        self.feed = feed
        self.rows = []

    def batches(self):
        for batch, mask in self.feed.batches():
            self.rows.append(mask.sum())
            yield batch, mask

    def grouped_batches(self, k):
        for kind, batch, mask in self.feed.grouped_batches(k):
            self.rows.append(mask.sum())
            yield kind, batch, mask

    def __getattr__(self, name):
        return getattr(self.feed, name)


def cluster_main(args, ctx):
    """The cluster phase's user fn, run by the node in the child it forked:
    the first CUDA call of that process is ``ctx.initialize_distributed()``.
    Trains the LM from the node's feed (K steps a dispatch when the
    executor's ``TFOS_STEPS_PER_CALL`` says so), exports it as the chief,
    writes the trained model's logits next to the export, and reports to
    ``args["report"]`` (the traceback too when it fails, then re-raises)."""
    import functools
    import importlib
    import traceback

    report = {"child_started": time.time()}
    try:
        import numpy as np
        import torch

        from tensorflowonspark_torch import checkpoint, train
        from tensorflowonspark_torch.models import get_model, transformer
        from tensorflowonspark_torch.ops import _build
        from tensorflowonspark_torch.parallel import infeed

        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        device = ctx.initialize_distributed(device=args["device"])
        report["device"] = str(device)
        report["distributed_ready"] = time.time()
        if device.type == "cuda":
            # the parent built every kernel: this loads, it does not build
            t0 = time.perf_counter()
            built = _build.build()
            for name in built:
                _build.load(name)
            report["kernel_libs"] = {n: {"cached": r["cached"],
                                         "build_s": r["seconds"]}
                                     for n, r in built.items()}
            report["kernel_load_s"] = time.perf_counter() - t0
        cfg = args["config"]
        model = get_model("transformer_lm", **cfg)
        model.init_weights(torch.Generator().manual_seed(0))
        lm_loss = transformer.loss_fn(model)
        losses = []
        # the per-step loss curve: K-step dispatches write every step's
        curve = LossCurve()

        def loss_fn(params, batch, mask):
            # keeps each eager step's loss as a device scalar (no sync):
            # read once training is over
            loss, aux = lm_loss(params, batch, mask)
            losses.append(loss.detach())
            return loss, aux

        trainer = train.Trainer(
            loss_fn, dict(model.state_dict()),
            functools.partial(torch.optim.Adam, lr=args["lr"]),
            compute_dtype=getattr(torch, cfg["dtype"]),
            batch_size=args["batch"], log_steps=args["log_steps"],
            extra_step_flops=args["flash_flops"], summary_writer=curve,
            device=device)
        feed = RowCounter(infeed.ShardedFeed(
            ctx.get_data_feed(), args["batch"],
            transform=lambda t: {"tokens": t}, device=device))
        report["model_ready"] = time.time()
        first, step_ends = {}, []

        def on_steps(step):
            # host clock as each step's dispatch returns: the gaps show
            # where the step loop waited on the feed
            step_ends.append(time.perf_counter())
            if step == 1:
                first["t"] = time.time()

        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0

        def main_path():
            return trainer.fit_feed(feed, on_steps=on_steps)

        if device.type == "cuda":
            # under the profiler: the flash kernels the card executed
            stats, report["device_launches"] = counted_on_device(
                torch, main_path)
        else:
            stats = main_path()
        launches = {"flash_fwd": fa.fwd_launches,
                    "flash_bwd_dq": fa.bwd_dq_launches,
                    "flash_bwd_dkv": fa.bwd_dkv_launches}  # ... ends here
        if device.type == "cuda":
            torch.cuda.synchronize()
        report["fit_feed_end"] = time.time()
        log = trainer.history.timestamp_log
        window_ms = [1e3 * (t1 - t0_) / (s1 - s0)
                     for (s0, t0_), (s1, t1) in zip(log, log[1:])]
        later = sorted(window_ms[1:])
        if checkpoint.should_export(ctx):
            checkpoint.export_model(
                args["export_dir"], trainer.state.params, "transformer_lm",
                model_config=cfg,
                input_signature={"tokens": {"shape": [None, cfg["max_seq_len"]],
                                            "dtype": "int32"}})
            request = np.random.default_rng(args["request_seed"]).integers(
                0, cfg["vocab_size"], (1, cfg["max_seq_len"]), dtype=np.int32)
            with torch.inference_mode():
                logits = torch.func.functional_call(
                    model, trainer.state.params,
                    (torch.from_numpy(request).to(device),))
            np.save(os.path.join(args["export_dir"], "trained_logits.npy"),
                    logits.float().cpu().numpy())
        k = stats["megastep"]["steps_per_call"]
        report.update({
            "rows": float(sum(r.item() for r in feed.rows)),
            "steps": trainer.state.step,
            # eager steps: the loss_fn's own; K > 1: the per-step curve
            "losses": ([x.item() for x in losses] if k == 1 else
                       [curve.losses.get(s) for s in
                        range(1, trainer.state.step + 1)]),
            "megastep": stats["megastep"],
            "graphs": len(trainer._graphs),
            "launches": launches,
            "window_ms_per_step": window_ms,
            "steady_ms_per_step": later[len(later) // 2] if later else None,
            "first_step_end": first.get("t"),
            "step_interval_ms": [1e3 * (b - a) for a, b in
                                 zip(step_ends, step_ends[1:])],
            "infeed": feed.counters_snapshot(),
            "datafeed": feed.feed.feed.counters_snapshot(),
            "wire_formats": feed.wire_formats(),
            "overlap": stats["overlap"],
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if device.type == "cuda" else None)})
    except Exception:
        report["error"] = traceback.format_exc()
        raise
    finally:
        with open(args["report"] + ".tmp", "w") as f:
            json.dump(report, f)
        os.replace(args["report"] + ".tmp", args["report"])


def wait_for_report(path, seconds):
    """The node's report, once its child wrote it; raises after ``seconds``
    or when the report carries the child's traceback."""
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise AssertionError("the cluster node wrote no report within "
                                 "{} s".format(seconds))
        time.sleep(0.2)
    with open(path) as f:
        report = json.load(f)
    if "error" in report:
        raise AssertionError("the cluster node failed:\n" + report["error"])
    return report


def phase_cluster(torch, np, train_row, config=LM_CONFIG, device=None,
                  steps_per_call=1, k1_cluster=None):
    """Train the LM through the cluster lifecycle in SPARK input mode on a
    one-executor LocalBackend, serve the chief's export here, and check
    rows, steps, kernel launches in the node, loss and handoff.  With
    ``steps_per_call`` > 1 the executor's ``TFOS_STEPS_PER_CALL`` arms K
    steps a dispatch, and the losses are held to ``k1_cluster``'s."""
    from tensorflowonspark_torch import backend, cluster, serving

    vocab, layers = config["vocab_size"], config["num_layers"]
    seq = config["max_seq_len"]
    heads, head_dim = config["num_heads"], config["head_dim"]
    parts = backend.partition(list(lm_rows(np, 0, CLUSTER_ROWS, seq, vocab)),
                              CLUSTER_PARTS)
    if device is None:
        torch.cuda.empty_cache()   # the earlier phases' cached blocks
    with tempfile.TemporaryDirectory() as tmp:
        args = {"config": config, "device": device, "lr": LR,
                "batch": TRAIN_BATCH, "log_steps": CLUSTER_LOG_STEPS,
                "flash_flops": 7 * seq * seq * head_dim * TRAIN_BATCH
                * heads * layers,
                "export_dir": os.path.join(tmp, "export"),
                "report": os.path.join(tmp, "report.json"),
                "request_seed": 2}
        b = backend.LocalBackend(1)
        try:
            t_run = time.time()
            env = ({"TFOS_STEPS_PER_CALL": str(steps_per_call)}
                   if steps_per_call > 1 else None)
            c = cluster.run(b, cluster_main, args, num_executors=1,
                            input_mode=cluster.InputMode.SPARK,
                            executor_env=env)
            t_ready = time.time()
            c.train(parts, num_epochs=1)
            t_fed = time.time()
            c.shutdown(grace_secs=1)
            report = wait_for_report(args["report"], CLUSTER_REPORT_SECS)
        finally:
            b.stop()
        t_reported = time.time()
        request = np.random.default_rng(args["request_seed"]).integers(
            0, vocab, (1, seq), dtype=np.int32)
        server = serving.ModelServer(args["export_dir"],
                                     batch_size=SERVE_BATCH, device=device)
        served = server.predict_feed({"tokens": request}, 1)["output"]
        del server
        trained = np.load(os.path.join(args["export_dir"],
                                       "trained_logits.npy"))
    handoff_diff = float(np.abs(served - trained).max())
    handoff_scale = float(np.abs(trained).max())
    losses = report["losses"]
    if steps_per_call == 1:
        # steps 10 and 20 against the train phase's windows
        want_at = {LOG_STEPS * (i + 1): want for i, want in
                   enumerate(train_row.get("window_losses", []))}
    else:
        # steps 10 and 20 against the K = 1 cluster run's
        want_at = {step: k1_cluster["losses"][step - 1]
                   for step in (LOG_STEPS, 2 * LOG_STEPS)}
    vs_train = {str(step): (abs(losses[step - 1] - want)
                            if losses[step - 1] is not None else None)
                for step, want in want_at.items() if step <= len(losses)}
    expected = layers * CLUSTER_STEPS if report["device"] != "cpu" else 0
    steady = report["steady_ms_per_step"]
    row = {"phase": "cluster" if steps_per_call == 1 else "cluster_megastep",
           "config": config, "device": report["device"],
           "backend": "LocalBackend(1)", "input_mode": "SPARK",
           "steps_per_call_env": steps_per_call,
           "megastep": report["megastep"], "graphs": report["graphs"],
           "train_steps_per_call_max": report["overlap"].get(
               "train_steps_per_call_max"),
           "rows_fed": CLUSTER_ROWS, "partitions": CLUSTER_PARTS,
           "rows_trained": report["rows"], "steps": report["steps"],
           "expected_steps": CLUSTER_STEPS,
           "first_step_loss": losses[0] if losses else None,
           "last_step_loss": losses[-1] if losses else None,
           "losses": losses,
           "loss_diff_vs_" + ("train_phase" if steps_per_call == 1
                              else "k1_cluster"): vs_train,
           "loss_tol": CLUSTER_LOSS_TOL,
           "launches": report["launches"],
           "device_launches": report.get("device_launches"),
           "expected_launches": expected,
           "window_ms_per_step": report["window_ms_per_step"],
           "steady_ms_per_step": steady,
           "train_phase_steady_ms_per_step": train_row.get(
               "steady_ms_per_step"),
           "train_phase_ms_per_step": train_row.get("ms_per_step"),
           "feed_cost_ms_per_step": (
               steady - train_row["steady_ms_per_step"]
               if steady is not None
               and train_row.get("steady_ms_per_step") is not None else None),
           "bring_up_s": {
               "cluster_run": t_ready - t_run,
               "to_child_start": report["child_started"] - t_run,
               "to_distributed_ready": report["distributed_ready"] - t_run,
               "child_kernel_load_s": report.get("kernel_load_s"),
               "to_model_ready": report["model_ready"] - t_run,
               "to_first_step": (report["first_step_end"] - t_run
                                 if report["first_step_end"] else None)},
           "child_kernel_libs": report.get("kernel_libs"),
           "feed_s": t_fed - t_ready,
           "end_of_feed_to_report_s": t_reported - t_fed,
           "rows_per_s_fed": CLUSTER_ROWS / (t_fed - t_ready),
           "step_interval_ms": report["step_interval_ms"],
           "infeed": report["infeed"], "datafeed": report["datafeed"],
           "wire_formats": report["wire_formats"],
           "overlap": report["overlap"],
           "max_memory_allocated": report["max_memory_allocated"],
           "handoff_max_abs_diff": handoff_diff,
           "handoff_max_abs_logit": handoff_scale,
           "handoff_tol": HANDOFF_TOL * handoff_scale}
    emit(row)
    if report["rows"] != CLUSTER_ROWS or report["steps"] != CLUSTER_STEPS:
        raise AssertionError("the node trained {} rows in {} steps, expected "
                             "{} in {}".format(report["rows"], report["steps"],
                                               CLUSTER_ROWS, CLUSTER_STEPS))
    executed = report.get("device_launches") or {}
    if any(n != expected for n in list(report["launches"].values())
           + list(executed.values())) or (expected and not executed):
        raise AssertionError("kernel launches {} counted and {} executed on "
                             "the card in the node, expected {} each (layers "
                             "x steps)".format(report["launches"], executed,
                                               expected))
    if report["megastep"]["steps_per_call"] != steps_per_call:
        raise AssertionError("the node dispatched {} steps a call, expected "
                             "{}".format(report["megastep"], steps_per_call))
    if not (len(losses) == CLUSTER_STEPS and None not in losses
            and np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("cluster training loss not finite and falling: "
                             "{}".format(losses))
    if not all(d is not None and d <= CLUSTER_LOSS_TOL
               for d in vs_train.values()) or len(vs_train) != len(
                   [s for s in want_at if s <= CLUSTER_STEPS]):
        raise AssertionError("the cluster node's losses differ from the "
                             "reference run's on the same stream: {}".format(
                                 vs_train))
    if not handoff_diff <= HANDOFF_TOL * handoff_scale:
        raise AssertionError("the served cluster export differs from the "
                             "trained model by {} (max |logit| {})".format(
                                 handoff_diff, handoff_scale))
    return row


# ---------------------------------------------------------------------------
# the disaggregated data service: a dispatcher and two feed-worker processes
# serve TFRecord splits to the flash LM's node through ctx.get_service_feed
# ---------------------------------------------------------------------------

# 12 TFRecord splits of 8 rows (a row id and SEQ tokens), two epochs: 24
# steps of TRAIN_BATCH rows, each row once an epoch
DS_SPLITS = 12
DS_SPLIT_ROWS = 8
DS_EPOCHS = 2
DS_ROWS = DS_SPLITS * DS_SPLIT_ROWS
DS_STEPS = DS_EPOCHS * DS_ROWS // TRAIN_BATCH
DS_SEED = 3
DS_JOB = "chip-ds"
# the armed worker SIGKILLs itself once it streamed 12 rows: in its second
# split (a split is one block of 8 rows), after the block and before the
# split's split_end, in epoch 1
DS_KILL_AFTER_ITEMS = 12
# the workers beat every 0.25 s; the dispatcher fences one after 8 silent
# beats (2 s), so a host that holds a healthy worker's beat thread off for
# a second does not fence it
DS_WORKER_BEAT_SECS = 0.25
DS_DISPATCHER_MISSES = 8
DS_CACHE_BYTES = 256 << 20
# the node's beats: it pauses them while it brings CUDA up
DS_HEARTBEAT_SECS = 0.5
DS_HEARTBEAT_MISSES = 60
DS_READY_SECS = 120      # the dispatcher's ready line; both workers listed
DS_RUN_SECS = 600        # the cluster's end
DS_FEED_TIMEOUT_SECS = 300   # the node's ServiceFeed watchdog
DS_POLL_SECS = 0.05      # this process's poll of the job's status


def write_ds_splits(out_dir, rows):
    """``DS_SPLITS`` TFRecord files of ``DS_SPLIT_ROWS`` rows each, a row
    ``{"id": i, "tokens": rows[i]}``; returns their paths."""
    from tensorflowonspark_torch import dfutil

    files = []
    for s in range(DS_SPLITS):
        ids = range(s * DS_SPLIT_ROWS, (s + 1) * DS_SPLIT_ROWS)
        files += dfutil.save_as_tfrecords(
            [{"id": i, "tokens": rows[i].tolist()} for i in ids],
            os.path.join(out_dir, "split-%02d" % s),
            schema={"id": "int64", "tokens": "array<int64>"})
    return files


def dataservice_main(args, ctx):
    """The dataservice phase's user fn, run inline in the FILES-mode
    executor (its first CUDA call is ``ctx.initialize_distributed()``):
    brings the model and the trainer up, waits for ``args["go"]`` to exist
    (the host-bound bring-up runs beside the previous phase, the service's
    job and the steps after it), then trains the LM at K = 1 from
    ``ctx.get_service_feed`` (DYNAMIC, two epochs) through ``ShardedFeed``
    and ``fit_feed``, keeps the row ids of each batch in the order the
    batches dispatch, and reports to ``args["report"]`` (the traceback too
    when it fails, then re-raises)."""
    import functools
    import importlib
    import traceback

    report = {"node_started": time.time(), "pid": os.getpid()}
    try:
        import numpy as np
        import torch

        from tensorflowonspark_torch import dataservice, train
        from tensorflowonspark_torch.models import get_model, transformer
        from tensorflowonspark_torch.ops import _build
        from tensorflowonspark_torch.parallel import infeed

        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        device = ctx.initialize_distributed(device=args["device"])
        report["device"] = str(device)
        report["distributed_ready"] = time.time()
        if device.type == "cuda":
            # the parent built every kernel: this loads, it does not build
            for name in _build.build():
                _build.load(name)
        cfg = args["config"]
        model = get_model("transformer_lm", **cfg)
        model.init_weights(torch.Generator().manual_seed(args["init_seed"]))
        lm_loss = transformer.loss_fn(model)
        losses = []

        def loss_fn(params, batch, mask):
            # each step's loss as a device scalar (no sync), read at the end
            loss, aux = lm_loss(params, batch, mask)
            losses.append(loss.detach())
            return loss, aux

        trainer = train.Trainer(
            loss_fn, dict(model.state_dict()),
            functools.partial(torch.optim.Adam, lr=args["lr"]),
            compute_dtype=getattr(torch, cfg["dtype"]),
            batch_size=args["batch"], log_steps=args["log_steps"],
            extra_step_flops=args["flash_flops"], device=device)
        report["model_ready"] = time.time()
        deadline = time.monotonic() + args["go_secs"]
        while not os.path.exists(args["go"]):
            if time.monotonic() > deadline:
                raise AssertionError("no go within {} s".format(
                    args["go_secs"]))
            time.sleep(0.05)
        report["go_seen"] = time.time()
        feed = ctx.get_service_feed(
            args["files"], job_name=args["job"],
            mode=dataservice.SHARD_DYNAMIC, num_epochs=args["epochs"],
            timeout=args["feed_timeout"])
        ids = []

        def to_batch(cols):
            # the (id, tokens) columns; batches are assembled in the order
            # they dispatch, so ids holds each dispatch's rows in order
            ids.append([int(i) for i in cols[0]])
            return {"tokens": np.asarray(cols[1], np.int32)}

        sharded = infeed.ShardedFeed(feed, args["batch"], transform=to_batch,
                                     device=device)
        report["feed_ready"] = time.time()
        first = {}

        def on_steps(step):
            if step == 1:
                first["t"] = time.time()

        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        fit = {}

        def main_path():
            t0 = time.time()
            stats = trainer.fit_feed(sharded, on_steps=on_steps)
            if device.type == "cuda":
                torch.cuda.synchronize()
            fit["s"] = time.time() - t0
            return stats

        if device.type == "cuda":
            # under the profiler: the flash kernels the card executed
            stats, report["device_launches"] = counted_on_device(
                torch, main_path)
        else:
            stats = main_path()
        report["launches"] = {"flash_fwd": fa.fwd_launches,
                              "flash_bwd_dq": fa.bwd_dq_launches,
                              "flash_bwd_dkv": fa.bwd_dkv_launches}
        log = trainer.history.timestamp_log
        window_ms = [1e3 * (t1 - t0) / (s1 - s0)
                     for (s0, t0), (s1, t1) in zip(log, log[1:])]
        later = sorted(window_ms[1:])
        counters = trainer.counters_snapshot()
        report.update({
            "ids": ids, "steps": trainer.state.step,
            "losses": [x.item() for x in losses],
            "megastep": stats["megastep"],
            "fit_feed_s": fit["s"],
            "first_step_end": first.get("t"),
            "window_ms_per_step": window_ms,
            "steady_ms_per_step": later[len(later) // 2] if later else None,
            "infeed_starved_us": counters.get(
                "goodput_infeed_starved_us", 0),
            "service": feed.counters_snapshot(),
            "wire_formats": dict(feed.wire_formats),
            "split_dupes": feed.split_dupes,
            "splits_committed": feed.splits_committed,
            "splits_discarded": feed.splits_discarded,
            "cache_hits": feed.cache_hits,
            "items_consumed": feed.items_consumed,
            "infeed": sharded.counters_snapshot(),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if device.type == "cuda" else None)})
    except Exception:
        report["error"] = traceback.format_exc()
        raise
    finally:
        with open(args["report"] + ".tmp", "w") as f:
            json.dump(report, f)
        os.replace(args["report"] + ".tmp", args["report"])


def _ds_watch(started):
    """Timestamps of the job's turns, polled from the dispatcher: the armed
    worker's death, its fence, the re-pool of its split, the re-pooled
    split handed on (``pending`` back to 0), the job's end."""
    from tensorflowonspark_torch import dataservice

    events, client = started["events"], None
    armed = started["procs"]["ds-w0"]
    while not started["stop"].is_set():
        now = time.time()
        if "kill" not in events and armed.poll() is not None:
            events["kill"] = now
        status = None
        try:
            if client is None:
                client = dataservice.DispatcherClient(started["addr"])
            status = client.status(DS_JOB)
        except dataservice.DispatchError:
            pass   # the node has not registered the job yet
        except Exception:
            if client is not None:
                client.close()
            client = None
        if status:
            if status.get("dead_workers"):
                events.setdefault("fence", now)
            if status.get("reassigned"):
                events.setdefault("repool", now)
            if "repool" in events and not status.get("pending"):
                events.setdefault("restream", now)
            if status.get("done"):
                events.setdefault("done", now)
        time.sleep(DS_POLL_SECS)
    if client is not None:
        client.close()


def _ds_cluster(started, args):
    """``cluster.run`` in FILES mode with the data service, to its end."""
    from tensorflowonspark_torch import backend, cluster

    b = backend.LocalBackend(1)
    try:
        started["t_run"] = time.time()
        c = cluster.run(b, dataservice_main, args, num_executors=1,
                        input_mode=cluster.InputMode.FILES,
                        data_service={"dispatcher": started["addr"]},
                        telemetry=True, telemetry_dir=started["tdir"],
                        heartbeat_interval=DS_HEARTBEAT_SECS,
                        heartbeat_misses=DS_HEARTBEAT_MISSES)
        started["t_ready"] = time.time()
        c.shutdown(grace_secs=1)
    except BaseException:   # noqa: B036 — shutdown's sys.exit included
        import traceback

        started["errors"].append(traceback.format_exc())
    finally:
        b.stop()


def start_dataservice(torch, np, config=LM_CONFIG, device=None):
    """Write the splits, start the dispatcher (journaled) and the two
    workers as ``python -m`` processes (``ds-w0`` armed to die mid-split),
    wait for both on the roster, then run the cluster and the status
    watcher on threads.  The node brings its model up beside the next
    phase and waits for :func:`phase_dataservice` to let it train."""
    from tensorflowonspark_torch import dataservice

    vocab, seq = config["vocab_size"], config["max_seq_len"]
    tmp = tempfile.mkdtemp(prefix="chip-ds-")
    started = {"tmp": tmp, "procs": {}, "events": {}, "errors": [],
               "stop": threading.Event(), "threads": {}, "config": config,
               "device": device, "tdir": os.path.join(tmp, "telemetry")}
    try:
        t0 = time.perf_counter()
        rows = lm_rows(np, DS_SEED, DS_ROWS, seq, vocab)
        files = write_ds_splits(os.path.join(tmp, "data"), rows)
        started["write_s"] = time.perf_counter() - t0
        env = dict(os.environ, TFOS_TELEMETRY="1",
                   TFOS_TELEMETRY_DIR=started["tdir"],
                   PYTHONPATH=os.pathsep.join(
                       p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
        env.pop("TFOS_FAULT_SPEC", None)
        t1 = time.perf_counter()
        with open(os.path.join(tmp, "dispatcher.log"), "w") as log:
            disp = subprocess.Popen(
                [sys.executable, "-m",
                 "tensorflowonspark_torch.dataservice_dispatcher",
                 "--host", "127.0.0.1",
                 "--heartbeat", str(DS_WORKER_BEAT_SECS),
                 "--misses", str(DS_DISPATCHER_MISSES),
                 "--journal-dir", os.path.join(tmp, "journal")],
                cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=log,
                text=True)
        started["procs"]["dispatcher"] = disp
        line = read_line(disp.stdout, DS_READY_SECS)
        if not line or "dispatcher ready on " not in line:
            raise AssertionError("no ready line from the dispatcher: {!r}"
                                 .format(line))
        # the port it bound: "dispatcher ready on HOST:PORT"
        host, port = line.split("dispatcher ready on ", 1)[1].strip() \
            .rsplit(":", 1)
        started["addr"] = (host, int(port))
        started["dispatcher_ready_s"] = time.perf_counter() - t1
        for i in range(2):
            wid = "ds-w%d" % i
            wenv = dict(env)
            if i == 0:
                wenv["TFOS_FAULT_SPEC"] = json.dumps(
                    {"kill_after_items": DS_KILL_AFTER_ITEMS})
            with open(os.path.join(tmp, wid + ".log"), "w") as log:
                started["procs"][wid] = subprocess.Popen(
                    [sys.executable, "-m",
                     "tensorflowonspark_torch.dataservice_worker",
                     "--dispatcher", "%s:%d" % started["addr"],
                     "--reader", "tfrecord", "--fields", "id,tokens",
                     "--worker-id", wid,
                     "--heartbeat", str(DS_WORKER_BEAT_SECS),
                     "--cache-bytes", str(DS_CACHE_BYTES)],
                    cwd=HERE, env=wenv, stdout=subprocess.DEVNULL,
                    stderr=log)
        # both workers listed before the job starts, so the armed one wins
        # splits of epoch 1
        client = dataservice.DispatcherClient(started["addr"])
        try:
            deadline = time.monotonic() + DS_READY_SECS
            while len(client.workers()) < 2:
                if time.monotonic() > deadline:
                    raise AssertionError("the workers did not register")
                time.sleep(DS_POLL_SECS)
        finally:
            client.close()
        started["workers_ready_s"] = time.perf_counter() - t1
        heads, head_dim = config["num_heads"], config["head_dim"]
        args = {"config": config, "device": device, "lr": LR,
                "init_seed": 0, "batch": TRAIN_BATCH,
                "log_steps": CLUSTER_LOG_STEPS, "files": files,
                "job": DS_JOB, "epochs": DS_EPOCHS,
                "feed_timeout": DS_FEED_TIMEOUT_SECS,
                "go": os.path.join(tmp, "go"), "go_secs": DS_RUN_SECS,
                "flash_flops": 7 * seq * seq * head_dim * TRAIN_BATCH
                * heads * config["num_layers"],
                "report": os.path.join(tmp, "report.json")}
        started["args"], started["rows"] = args, rows
        for name, target, targs in (("watch", _ds_watch, (started,)),
                                    ("cluster", _ds_cluster,
                                     (started, args))):
            t = threading.Thread(target=target, args=targs, daemon=True)
            t.start()
            started["threads"][name] = t
    except BaseException:
        stop_dataservice(started)
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return started


def stop_dataservice(started):
    """Stop the watcher and every process the phase started (SIGTERM, so a
    worker and the dispatcher flush their traces); returns the exit
    codes.  A node still waiting to train is let go, to fail on the
    stopped dispatcher."""
    started["stop"].set()
    if "args" in started:
        open(started["args"]["go"], "a").close()
    codes = {}
    for name, proc in started["procs"].items():
        if proc.poll() is None:
            proc.terminate()
        try:
            codes[name] = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            codes[name] = proc.wait()
        if proc.stdout is not None:
            proc.stdout.close()
    return codes


def ds_flows(tdir, node_pid):
    """The ``dataservice/split_flow`` flow events of every process's trace
    under ``tdir``: counts by phase and leg, and the flows the node ended at
    ``train_dispatch``."""
    import glob

    legs, ended = {}, 0
    for path in glob.glob(os.path.join(tdir, "trace-*.json")):
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        for e in events:
            if e.get("name") != "dataservice/split_flow":
                continue
            key = "{}:{}".format(e.get("ph"), (e.get("args") or {}).get(
                "leg", "dispatch"))
            legs[key] = legs.get(key, 0) + 1
            if (e.get("ph") == "f" and e.get("pid") == node_pid
                    and (e.get("args") or {}).get("leg") == "train_dispatch"):
                ended += 1
    return legs, ended


def phase_dataservice(torch, np, started, card=None):
    """Let the node train from the data service (its bring-up ran beside
    the previous phase), join the run, replay its batches here and check
    it:
    every row once an epoch across the kill (no dupes, 24 splits
    committed), the killed worker fenced and its split re-pooled and
    streamed by the survivor, epoch 2 from the workers' caches, colv1 on
    the wire, the flash launches in the node (layers x steps each, as the
    profiler counted them), the losses within ``CLUSTER_LOSS_TOL`` of the
    same batches fed device-resident through ``Trainer.step`` from the
    same init, and a split's flow ended at ``train_dispatch``."""
    import functools

    from tensorflowonspark_torch import dataservice, train
    from tensorflowonspark_torch.models import get_model, transformer

    config, device = started["config"], started["device"]
    t_join = time.perf_counter()
    try:
        open(started["args"]["go"], "w").close()
        t_go = time.time()
        started["threads"]["cluster"].join(DS_RUN_SECS)
        if started["threads"]["cluster"].is_alive():
            raise AssertionError("the data-service cluster did not end "
                                 "within {} s".format(DS_RUN_SECS))
        join_s = time.perf_counter() - t_join
        if started["errors"]:
            raise AssertionError("the data-service cluster failed:\n"
                                 + started["errors"][0])
        report = wait_for_report(started["args"]["report"], 5)
        client = dataservice.DispatcherClient(started["addr"])
        try:
            status = client.status(DS_JOB)
            workers = sorted(w["worker_id"] for w in client.workers())
        finally:
            client.close()
    finally:
        codes = stop_dataservice(started)
        started["threads"]["watch"].join(10)
    try:
        legs, ended = ds_flows(started["tdir"], report["pid"])
    finally:
        shutil.rmtree(started["tmp"], ignore_errors=True)
    # the replay: the same init and batches, device-resident, eager steps
    if device is None:
        torch.cuda.empty_cache()
    dev = device or "cuda"
    rows = started["rows"]
    batches = [({"tokens": torch.from_numpy(rows[ids]).to(dev)},
                torch.ones(len(ids), device=dev)) for ids in report["ids"]]
    model = get_model("transformer_lm", **config)
    model.init_weights(torch.Generator().manual_seed(0))
    lm_loss = transformer.loss_fn(model)
    replay_losses = []

    def loss_fn(params, batch, mask):
        loss, aux = lm_loss(params, batch, mask)
        replay_losses.append(loss.detach())
        return loss, aux

    trainer = train.Trainer(
        loss_fn, dict(model.state_dict()),
        functools.partial(torch.optim.Adam, lr=LR),
        compute_dtype=getattr(torch, config["dtype"]),
        batch_size=TRAIN_BATCH, log_steps=CLUSTER_LOG_STEPS, device=dev)
    for batch, mask in batches[:2]:
        trainer.step(batch, mask)
    replay_ms = None
    if dev == "cpu":
        for batch, mask in batches[2:]:
            trainer.step(batch, mask)
    else:
        replay_ms = time_steps(torch, trainer, batches[2:])
    replay = [x.item() for x in replay_losses]
    del trainer, model, batches
    losses = report["losses"]
    diffs = [abs(a - b) for a, b in zip(losses, replay)]
    flat = [i for ids in report["ids"] for i in ids]
    events, t_run = started["events"], started.get("t_run", 0.0)
    kill = events.get("kill")

    def since_kill(name):
        return (events[name] - kill) if kill and name in events else None

    layers = config["num_layers"]
    expected = layers * DS_STEPS if report["device"] != "cpu" else 0
    executed = report.get("device_launches") or {}
    colv1 = sum(n for fmt, n in report["wire_formats"].items()
                if fmt.startswith("colv1"))
    service = report["service"]
    row = {"phase": "dataservice", "card": card, "config": config,
           "device": report["device"],
           "backend": "LocalBackend(1)", "input_mode": "FILES",
           "splits": DS_SPLITS, "split_rows": DS_SPLIT_ROWS,
           "epochs": DS_EPOCHS, "mode": "dynamic",
           "steps": report["steps"], "expected_steps": DS_STEPS,
           "rows_trained": len(flat), "rows_per_epoch": DS_ROWS,
           "split_dupes": report["split_dupes"],
           "splits_committed": report["splits_committed"],
           "splits_discarded": report["splits_discarded"],
           "cache_hits": report["cache_hits"],
           "wire_formats": report["wire_formats"],
           "dataservice_counters": {k: v for k, v in service.items()
                                    if k.startswith("dataservice_")},
           "job_status": status, "workers_listed": workers,
           "exit_codes": codes,
           "s_kill_to_fence": since_kill("fence"),
           "s_kill_to_repool": since_kill("repool"),
           "s_kill_to_restream": since_kill("restream"),
           "launches": report["launches"], "device_launches": executed,
           "expected_launches": expected,
           "losses": losses, "replay_losses": replay,
           "max_loss_diff_vs_replay": max(diffs) if diffs else None,
           "loss_tol": CLUSTER_LOSS_TOL,
           "steady_ms_per_step": report["steady_ms_per_step"],
           "window_ms_per_step": report["window_ms_per_step"],
           "replay_ms_per_step": replay_ms,
           "rows_per_s_fed": len(flat) / report["fit_feed_s"],
           "fit_feed_s": report["fit_feed_s"],
           "infeed_starved_us": report["infeed_starved_us"],
           "infeed": report["infeed"],
           "bring_up_s": {
               "write_splits": started.get("write_s"),
               "dispatcher_ready": started.get("dispatcher_ready_s"),
               "workers_listed": started.get("workers_ready_s"),
               "cluster_run": started.get("t_ready", t_run) - t_run,
               "to_distributed_ready": report["distributed_ready"] - t_run,
               "to_model_ready": report["model_ready"] - t_run,
               "node_waited_for_go": report["go_seen"]
               - report["model_ready"],
               "go_to_feed_ready": report["feed_ready"] - t_go,
               "go_to_first_step": (report["first_step_end"] - t_go
                                    if report["first_step_end"] else None)},
           "join_wait_s": join_s,
           "flows": legs, "flows_ended_at_dispatch": ended,
           "max_memory_allocated": report["max_memory_allocated"]}
    emit(row)
    epoch_ids = [sorted(flat[e * DS_ROWS:(e + 1) * DS_ROWS])
                 for e in range(DS_EPOCHS)]
    if len(flat) != DS_EPOCHS * DS_ROWS or any(
            ids != list(range(DS_ROWS)) for ids in epoch_ids):
        raise AssertionError("the node's rows are not each row once an "
                             "epoch: {} rows".format(len(flat)))
    if report["split_dupes"] or report["splits_committed"] != \
            DS_EPOCHS * DS_SPLITS:
        raise AssertionError("splits committed {}, dupes {}: expected {} "
                             "and 0".format(report["splits_committed"],
                                            report["split_dupes"],
                                            DS_EPOCHS * DS_SPLITS))
    if not (status.get("done") and status.get("dead_workers") == 1
            and status.get("reassigned", 0) >= 1 and codes.get("ds-w0")
            and "restream" in events and workers == ["ds-w1"]):
        raise AssertionError("the killed worker was not fenced, or its "
                             "split not re-pooled and streamed by the "
                             "survivor: {} {} exit codes {} workers {}"
                             .format(status, events, codes, workers))
    if not (report["cache_hits"] > 0
            and service.get("dataservice_cache_hit", 0) > 0):
        raise AssertionError("epoch 2 served nothing from the workers' "
                             "caches: {}".format(service))
    if not colv1:
        raise AssertionError("no colv1 frames on the wire: {}".format(
            report["wire_formats"]))
    if report["steps"] != DS_STEPS or any(
            n != expected for n in list(report["launches"].values())
            + list(executed.values())) or (expected and not executed):
        raise AssertionError("{} steps, kernel launches {} counted and {} "
                             "executed in the node, expected {} steps and "
                             "{} each (layers x steps)".format(
                                 report["steps"], report["launches"],
                                 executed, DS_STEPS, expected))
    if not (len(losses) == len(replay) == DS_STEPS
            and np.isfinite(losses).all()
            and max(diffs) <= CLUSTER_LOSS_TOL):
        raise AssertionError("the node's losses differ from the replay's "
                             "on the same batches: {} vs {}".format(
                                 losses, replay))
    if ended < 1:
        raise AssertionError("no dataservice/split_flow flow ended at "
                             "train_dispatch in the node: {}".format(legs))
    return row


# ---------------------------------------------------------------------------
# the serving tier: the gateway, the inference CLI, the Spark ML pipeline
# ---------------------------------------------------------------------------

# the segmentation phase: the U-Net twin (examples/segmentation/) at the JAX
# example's full width (128 px, batch 64, encoder 32-256, bf16, 512
# synthetic examples) for SEG_STEPS Adam steps through a FILES-mode cluster
# of one executor, its export served on the card; no flash kernel on this
# path.  The node's bring-up runs beside the gateway phase; its steps after
# the dataservice phase, alone on the card
SEG_STEPS = 40
SEG_LOG_STEPS = 10
SEG_FLAGS = ["--cluster_size", "1", "--image_size", "128",
             "--batch_size", "64", "--encoder_filters", "32,64,128,256",
             "--dtype", "bfloat16", "--synthetic_examples", "512",
             "--train_steps", str(SEG_STEPS), "--log_steps",
             str(SEG_LOG_STEPS)]
# the first loss on the card (bf16 compute) against the same init and
# batch through the port on the CPU in fp32: relative, bf16's 2e-2
SEG_LOSS_RTOL = 2e-2
# the served logits against the trainer's forward at the exported params,
# both on the card in bf16: of the largest logit
SEG_SERVE_TOL = 2e-2
SEG_SERVE_ROWS = 8
SEG_GO_SECS = 900
SEG_REPORT_SECS = 600


def segmentation_example():
    """The segmentation twin (examples/segmentation/), imported from this
    checkout."""
    path = os.path.join(HERE, "examples", "segmentation")
    if path not in sys.path:
        sys.path.insert(0, path)
    import segmentation_torch

    return segmentation_torch


def segmentation_main(args, ctx):
    """The segmentation phase's node fn, run by the node inline in its
    executor process (FILES mode): brings CUDA up, waits for
    ``args["go"]``, then runs the twin's ``train_segmentation`` (each
    step's loss kept on the device), and reports the losses, the window
    times, the flash launches (none expected), the peak memory and the
    trainer's forward at the exported params on ``SEG_SERVE_ROWS`` rows of
    the first batch (``args["logits"]``) to ``args["report"]``, the
    traceback too when it fails."""
    import traceback

    report = {"node_started": time.time()}
    try:
        import numpy as np
        import torch

        sys.path.insert(0, args["example_dir"])
        import segmentation_torch as twin

        report["cuda_initialized_at_start"] = torch.cuda.is_initialized()
        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        device = ctx.initialize_distributed(device=args["twin"].device)
        torch.zeros(1, device=device)     # the context up before the go
        report["device_ready"] = time.time()
        deadline = time.monotonic() + args["go_secs"]
        while not os.path.exists(args["go"]):
            if time.monotonic() > deadline:
                raise AssertionError("no go within {} s".format(
                    args["go_secs"]))
            time.sleep(0.05)
        with open(args["go"]) as f:
            if f.read().strip() == "abort":
                raise AssertionError("the phase was stopped before its go")
        report["go_seen"] = time.time()
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        losses = []
        model, trainer, stats = twin.train_segmentation(
            args["twin"], ctx,
            on_step=lambda step, loss, aux: losses.append(loss.detach()))
        report["launches"] = launches_of(fa)
        if device.type == "cuda":
            torch.cuda.synchronize()
            report["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        report.update({
            "device": str(trainer.device), "steps": trainer.state.step,
            "losses": [float(v) for v in losses],
            "timestamp_log": trainer.history.timestamp_log, "stats": stats,
            "step_flops": trainer.history.step_flops})
        images = twin.first_batch(args["twin"])["image"][:SEG_SERVE_ROWS]
        with torch.no_grad():
            logits = torch.func.functional_call(
                model, trainer.state.params,
                (torch.from_numpy(images).to(trainer.device),))
        np.save(args["logits"], logits.float().cpu().numpy())
    except Exception:
        report["error"] = traceback.format_exc()
        raise
    finally:
        with open(args["report"] + ".tmp", "w") as f:
            json.dump(report, f, default=float)
        os.replace(args["report"] + ".tmp", args["report"])


def start_segmentation(torch, np, flags=SEG_FLAGS, device=None):
    """Start the twin's cluster on a thread: the node brings CUDA up beside
    the next phase and waits for :func:`phase_segmentation` to let it
    train."""
    from tensorflowonspark_torch import backend, cluster
    # what cluster.run imports at first use, imported before the leg's
    # thread (two threads importing one module at once can fail)
    from tensorflowonspark_torch import fault, manager, util  # noqa: F401

    twin = segmentation_example()
    tmp = tempfile.mkdtemp(prefix="chip-seg-")
    argv = list(flags) + ["--export_dir", os.path.join(tmp, "export")]
    if device is not None:
        argv += ["--device", device]
    args = {"twin": twin.parse_args(argv),
            "example_dir": os.path.dirname(twin.__file__),
            "go": os.path.join(tmp, "go"), "go_secs": SEG_GO_SECS,
            "logits": os.path.join(tmp, "logits.npy"),
            "report": os.path.join(tmp, "report.json")}
    started = {"tmp": tmp, "args": args, "twin": twin, "flags": argv}

    def run():
        b = backend.LocalBackend(1)
        try:
            started["t_run"] = time.time()
            c = cluster.run(b, segmentation_main, args, num_executors=1,
                            input_mode=cluster.InputMode.FILES)
            c.shutdown(grace_secs=1)
            started["t_done"] = time.time()
        finally:
            b.stop()

    started["leg"] = Leg(run, SEG_GO_SECS + SEG_REPORT_SECS)
    return started


def stop_segmentation(started):
    """Release a node still waiting for its go, to fail, and join it."""
    if not os.path.exists(started["args"]["go"]):
        with open(started["args"]["go"], "w") as f:
            f.write("abort")
    started["leg"].thread.join(SEG_REPORT_SECS)
    shutil.rmtree(started["tmp"], ignore_errors=True)


def phase_segmentation(torch, np, started, card=None):
    """Let the twin's node train (its bring-up ran beside the previous
    phases), join its cluster, then check it: every step taken, the
    losses finite and falling, no flash launch on this path, the export's
    descriptor the JAX example's; serve the export with ``ModelServer`` on
    the node's device (rebuilt by ``widths=``) against the trainer's
    forward at the exported params; and the first step's loss against the
    same init and batch through the port on the CPU in fp32."""
    from tensorflowonspark_torch import checkpoint, serving
    from tensorflowonspark_torch.models import unet

    args, twin = started["args"], started["twin"]
    targs = args["twin"]
    try:
        t_go = time.time()
        with open(args["go"], "w") as f:
            f.write("go")
        try:
            started["leg"].result()
        except BaseException:
            if os.path.exists(args["report"]):   # the node's traceback
                wait_for_report(args["report"], 0)
            raise
        report = wait_for_report(args["report"], SEG_REPORT_SECS)
        t_joined = time.time()
        export_dir = targs.export_dir
        _, descriptor = checkpoint.load_model(export_dir, validate=True)
        want_descriptor = {
            "model_name": "unet",
            "model_config": {"num_classes": 3, "dtype": targs.dtype},
            "input_signature": {"image": [None, targs.image_size,
                                          targs.image_size, 3]}}
        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        batch = twin.first_batch(targs)
        t0 = time.perf_counter()
        server = serving.ModelServer(export_dir, batch_size=SEG_SERVE_ROWS,
                                     device=targs.device)
        served = server.predict_feed(
            {"image": batch["image"][:SEG_SERVE_ROWS]},
            SEG_SERVE_ROWS)["output"]
        serve_s = time.perf_counter() - t0
        served_widths = [int(b.conv.weight.shape[0])
                         for b in server.model.down]
        serve_launches = launches_of(fa)
        del server
        trained = np.load(args["logits"])
        serve_abs, serve_max = logit_diff(np, served, trained)
        serve_gap = serve_abs / serve_max
        # the first step's loss on the CPU in fp32 from the same init
        t1 = time.perf_counter()
        filters = tuple(int(f) for f in targs.encoder_filters.split(","))
        model = unet.build_unet(num_classes=3, dtype="float32",
                                encoder_filters=filters)
        model.init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():
            cpu_loss, _ = unet.loss_fn(model)(
                dict(model.named_parameters()),
                {k: torch.from_numpy(v) for k, v in batch.items()},
                torch.ones(len(batch["image"])))
        cpu_s = time.perf_counter() - t1
    finally:
        stop_segmentation(started)
    losses = report["losses"]
    first_gap = abs(losses[0] - float(cpu_loss)) / abs(float(cpu_loss))
    log = report["timestamp_log"]
    window_ms = [1e3 * (t1_ - t0_) / (s1 - s0)
                 for (s0, t0_), (s1, t1_) in zip(log, log[1:])]
    later = sorted(window_ms[1:])
    steady = later[len(later) // 2] if later else None
    row = {"phase": "segmentation", "input_mode": "FILES",
           "backend": "LocalBackend(1)", "card": card,
           "flags": " ".join(started["flags"]),
           "image_size": targs.image_size, "batch_size": targs.batch_size,
           "encoder_filters": targs.encoder_filters, "dtype": targs.dtype,
           "steps": report["steps"], "device": report["device"],
           "cuda_initialized_at_node_start":
               report["cuda_initialized_at_start"],
           "bring_up_s": {
               "to_node_start": report["node_started"] - started["t_run"],
               "to_device_ready": report["device_ready"] - started["t_run"],
               "go_to_first_step": log[0][1] - report["go_seen"]},
           "go_to_joined_s": t_joined - t_go,
           "window_ms_per_step": window_ms, "steady_ms_per_step": steady,
           "images_per_s": (targs.batch_size * 1e3 / steady
                            if steady else None),
           "step_flops": report["step_flops"],
           "max_memory_allocated": report.get("max_memory_allocated"),
           "first_loss": losses[0], "last_loss": losses[-1],
           "cpu_fp32_first_loss": float(cpu_loss),
           "first_loss_rel_gap": first_gap,
           "first_loss_rtol": SEG_LOSS_RTOL, "cpu_reference_s": cpu_s,
           "served_logit_gap": serve_gap, "served_logit_tol": SEG_SERVE_TOL,
           "served_widths": served_widths, "serve_s": serve_s,
           "descriptor": descriptor,
           "flash_launches_in_node": report["launches"],
           "flash_launches_serving": serve_launches,
           "flash_launches_note": "no flash kernel on this path: the U-Net "
                                  "has no attention"}
    emit(row)
    if report["cuda_initialized_at_start"]:
        raise AssertionError("CUDA was up in the executor before the "
                             "segmentation twin's node fn ran")
    if report["steps"] != targs.train_steps or len(losses) != \
            targs.train_steps:
        raise AssertionError("the twin trained {} steps ({} losses), "
                             "expected {}".format(report["steps"],
                                                  len(losses),
                                                  targs.train_steps))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("the twin's losses did not fall: first {}, "
                             "last {}".format(losses[0], losses[-1]))
    if any(report["launches"].values()) or any(serve_launches.values()):
        raise AssertionError("a flash kernel launched on the U-Net's path: "
                             "{} {}".format(report["launches"],
                                            serve_launches))
    if descriptor != want_descriptor:
        raise AssertionError("the export's descriptor {} is not the JAX "
                             "example's {}".format(descriptor,
                                                   want_descriptor))
    if served_widths != list(filters):
        raise AssertionError("the server rebuilt widths {}, trained {}"
                             .format(served_widths, filters))
    if not first_gap <= SEG_LOSS_RTOL:
        raise AssertionError("the first loss {} is {} from the CPU's fp32 "
                             "{} (tolerance {})".format(
                                 losses[0], first_gap, float(cpu_loss),
                                 SEG_LOSS_RTOL))
    if not (np.isfinite(served).all() and serve_gap <= SEG_SERVE_TOL):
        raise AssertionError("the served logits are {} from the trainer's "
                             "forward (tolerance {})".format(
                                 serve_gap, SEG_SERVE_TOL))
    return row


# the gateway: a ModelServer(batch_size=8) warmed over rungs 1, 2, 4, 8;
# 3 concurrent clients, each sending two one-row requests in turn (each
# row's reply is 131 MB of fp32 logits that the gateway compresses,
# seconds a row); the serving_load_version push once half of the 6
# requests have their replies, so the last client's second request goes
# out after it
GATEWAY_BATCH = 8
GATEWAY_WAIT_MS = 5.0
GATEWAY_CLIENTS = 3
GATEWAY_REQUESTS = (1, 1)
SWAP_AFTER = GATEWAY_CLIENTS * len(GATEWAY_REQUESTS) // 2
GATEWAY_TIMEOUT_SECS = 600
# the --serve replica: ladder 1, 2, 4; seconds to its ready line (torch,
# kernel load, the LM's load and warmup) and from SIGTERM to exit 0
CLI_BATCH = 4
CLI_READY_SECS = 300
CLI_EXIT_SECS = 60
# batch mode on the MNIST CNN: JSON lines against ModelServer on the same
# rows; the same fp32 model and batches on both sides, and JSON keeps
# every float32 digit, so 1e-5 is loose
MNIST_ROWS = 256
MNIST_BATCH = 64
MNIST_TOL = 1e-5
# the pipeline: TFEstimator.fit on 40 rows of 1024 tokens, batch 8 (5
# steps), then TFModel.transform of 2 rows on the executor's card (each
# row's logits come back as Python values: seconds a row)
PIPELINE_ROWS = 40
PIPELINE_STEPS = PIPELINE_ROWS // TRAIN_BATCH
TRANSFORM_ROWS = 2
PIPELINE_REPORT_SECS = 300

# runs ``python -m tensorflowonspark_torch.inference_cli`` (the same
# runpy entry), then prints the forward kernel's launches in that process
CLI_WRAPPER = """
import importlib, json, runpy, sys
sys.argv = ["tensorflowonspark_torch.inference_cli"] + sys.argv[1:]
runpy.run_module("tensorflowonspark_torch.inference_cli", run_name="__main__",
                 alter_sys=True)
fa = importlib.import_module("tensorflowonspark_torch.ops.flash_attention")
print(json.dumps({"fwd_launches": fa.fwd_launches}), flush=True)
"""


def lm_signature(config):
    return {"tokens": {"shape": [None, config["max_seq_len"]],
                       "dtype": "int32"}}


def export_lm(torch, path, seed, config=LM_CONFIG):
    """Export the LM at ``config`` with random weights from ``seed``."""
    from tensorflowonspark_torch import checkpoint
    from tensorflowonspark_torch.models import get_model

    model = get_model("transformer_lm", **config)
    model.init_weights(torch.Generator().manual_seed(seed))
    checkpoint.export_model(path, model, "transformer_lm",
                            model_config=config,
                            input_signature=lm_signature(config))
    return path


def logit_diff(np, got, want):
    """``(max |got - want|, max |want|)``."""
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def on_card(torch, fn, device):
    """``(fn(), the flash kernels the card executed, the card's busy
    milliseconds)`` with ``device`` None (the card); on the CPU, where no
    kernel launches, zeros and None."""
    if device is None:
        return counted_on_device(torch, fn, with_busy=True)
    return fn(), dict.fromkeys(FLASH_KERNELS, 0), None


def card_memory(torch, device, reset=False):
    """The card's peak allocation (reset first with ``reset``); None on
    the CPU."""
    if device is not None:
        return None
    if reset:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated()


def phase_gateway(torch, np, fa, config=LM_CONFIG, device=None):
    """Serve the LM through the continuous-batching gateway to concurrent
    clients, swap its weights to a second export halfway through (the
    ``serving_load_version`` knob), then refuse a swap to an export of
    another depth.  ``device="cpu"`` rehearses it on the CPU (no kernel
    launches there)."""
    import threading
    import traceback

    from tensorflowonspark_torch import gateway, serving

    layers, vocab = config["num_layers"], config["vocab_size"]
    seq = config["max_seq_len"]
    rng = np.random.default_rng(3)
    requests = [[rng.integers(0, vocab, (n, seq), dtype=np.int32)
                 for n in GATEWAY_REQUESTS] for _ in range(GATEWAY_CLIENTS)]
    lone = rng.integers(0, vocab, (2, seq), dtype=np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        v1 = export_lm(torch, os.path.join(tmp, "v1"), 0, config)
        v2 = export_lm(torch, os.path.join(tmp, "v2"), 1, config)
        shallow = export_lm(torch, os.path.join(tmp, "shallow"), 2,
                            dict(config, num_layers=1))
        card_memory(torch, device, reset=True)
        server = serving.ModelServer(v1, batch_size=GATEWAY_BATCH,
                                     device=device)
        gw = gateway.GatewayServer(server, max_wait_ms=GATEWAY_WAIT_MS,
                                   model_version="1",
                                   replica_id="chip-gateway")
        t0 = time.perf_counter()
        gw.start()                     # warms rungs 8, 4, 2 and 1
        warm_s = time.perf_counter() - t0
        compiles = server.compile_count
        replies, errors = {}, []
        lock = threading.Lock()
        halfway = threading.Event()

        def client(c):
            try:
                ch = gateway.GatewayChannel(
                    (gw.host, gw.port), timeout=GATEWAY_TIMEOUT_SECS,
                    client_id="client-{}".format(c))
                try:
                    for i, tokens in enumerate(requests[c]):
                        sent = time.monotonic()
                        out = ch.predict({"tokens": tokens}, len(tokens))
                        with lock:
                            replies[(c, i)] = (sent, out["output"])
                            if len(replies) >= SWAP_AFTER:
                                halfway.set()
                finally:
                    ch.close()
            except Exception:
                errors.append(traceback.format_exc())
                halfway.set()

        def main_path():
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(GATEWAY_CLIENTS)]
            t_start = time.perf_counter()
            for t in threads:
                t.start()
            halfway.wait(GATEWAY_TIMEOUT_SECS)
            gw._on_beat_reply({"knobs": {"serving_load_version": {
                "model": "transformer_lm", "version": "2",
                "export_dir": v2, "token": "v2"}}})
            deadline = time.monotonic() + GATEWAY_TIMEOUT_SECS
            while (gw.model_version != "2" and not gw.swap_failed_total
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            swapped_at = time.monotonic()
            for t in threads:
                t.join(GATEWAY_TIMEOUT_SECS)
            return swapped_at, time.perf_counter() - t_start

        fa.fwd_launches = 0                          # the main path starts
        (swapped_at, traffic_s), executed, busy_ms = on_card(torch, main_path,
                                                             device)
        launches = fa.fwd_launches                   # the main path ends
        peak_bytes = card_memory(torch, device)
        beat = gw.heartbeat_metrics()
        exemplars = gw.slow_requests()
        swapped_compiles = server.compile_count
        if errors:
            gw.stop()
            raise AssertionError("gateway clients failed:\n" + errors[0])

        # a swap to an export of another depth: refused, v2 still served
        gw._on_beat_reply({"knobs": {"serving_load_version": {
            "model": "transformer_lm", "version": "3",
            "export_dir": shallow, "token": "v3"}}})
        deadline = time.monotonic() + GATEWAY_TIMEOUT_SECS
        while not gw.swap_failed_total and time.monotonic() < deadline:
            time.sleep(0.005)
        # the same lone request twice: equal bytes
        ch = gateway.GatewayChannel((gw.host, gw.port),
                                    timeout=GATEWAY_TIMEOUT_SECS)
        try:
            lone_a = ch.predict({"tokens": lone}, len(lone))["output"]
            lone_b = ch.predict({"tokens": lone}, len(lone))["output"]
        finally:
            ch.close()
        final = gw.heartbeat_metrics()
        gw.stop()

        # lone predict_feed of each request's rows on either version
        refs = {2: server}
        refs[1] = serving.ModelServer(v1, batch_size=GATEWAY_BATCH,
                                      device=device)
        checks = []
        for (c, i), (sent, got) in sorted(replies.items()):
            tokens = requests[c][i]
            match = {}
            for version, ref_server in sorted(refs.items()):
                want = ref_server.predict_feed({"tokens": tokens},
                                               len(tokens))["output"]
                diff, scale = logit_diff(np, got, want)
                match[version] = (diff, scale, diff <= LOGIT_TOL * scale)
                del want
            checks.append({"client": c, "request": i, "rows": len(tokens),
                           "after_swap": sent > swapped_at,
                           "version": [v for v in match if match[v][2]],
                           "max_abs_diff": {str(v): m[0]
                                            for v, m in match.items()},
                           "max_abs_logit": {str(v): m[1]
                                             for v, m in match.items()},
                           "finite": bool(np.isfinite(got).all()),
                           "shape_ok": got.shape == (len(tokens), seq,
                                                     vocab)})
        want_lone = refs[2].predict_feed({"tokens": lone}, len(lone))["output"]
        lone_diff, lone_scale = logit_diff(np, lone_a, want_lone)
        del refs, server

    def median_of(key):
        return median([r[key] for r in exemplars])

    n_requests = GATEWAY_CLIENTS * len(GATEWAY_REQUESTS)
    batches = beat["serving_batches"]
    expected = layers * batches if device is None else 0
    served = [c["version"] for c in checks]
    row = {"phase": "gateway", "config": config,
           "max_batch": GATEWAY_BATCH, "max_wait_ms": GATEWAY_WAIT_MS,
           "clients": GATEWAY_CLIENTS, "requests": n_requests,
           "rows": sum(GATEWAY_REQUESTS) * GATEWAY_CLIENTS,
           "warmup": server_report(gw, warm_s, compiles),
           "serving_requests": beat["serving_requests"],
           "serving_rows": beat["serving_rows"],
           "serving_batches": batches,
           "batch_rows": sorted(r["batch_rows"] for r in exemplars),
           "serving_shed": final["serving_shed"],
           "serving_compiles": {"after_warmup": compiles,
                                "after_traffic": swapped_compiles,
                                "at_end": final["serving_compiles"]},
           "request_us": {"p50": beat["serving_p50_us_max"],
                          "p99": beat["serving_p99_us_max"]},
           "stage_us_median": {s: median_of(s + "_us") for s in (
               "queue", "coalesce", "dispatch", "serialize", "latency")},
           "traffic_s": traffic_s,
           "device_busy_ms": busy_ms,
           "device_idle_share": (None if busy_ms is None
                                 else 1 - busy_ms / (1e3 * traffic_s)),
           "rows_per_s": sum(GATEWAY_REQUESTS) * GATEWAY_CLIENTS / traffic_s,
           "max_memory_allocated": peak_bytes,
           "fwd_launches": launches, "device_launches": executed,
           "expected_launches": expected,
           "swap": {"swaps_total": final["serving_swaps"],
                    "swap_failed_total": final["serving_swap_failed"],
                    "version": final["serving_model_version"],
                    "replies_v1": served.count([1]),
                    "replies_v2": served.count([2]),
                    "sent_after_swap": sum(c["after_swap"] for c in checks)},
           "lone_bytes_equal": lone_a.tobytes() == lone_b.tobytes(),
           "lone_vs_predict_feed": lone_diff,
           "lone_tol": LOGIT_TOL * lone_scale,
           "logit_tol": LOGIT_TOL, "checks": checks}
    emit(row)
    if len(checks) != n_requests or beat["serving_requests"] != n_requests:
        raise AssertionError("{} of {} gateway requests answered".format(
            len(checks), n_requests))
    if not all(c["finite"] and c["shape_ok"] for c in checks):
        raise AssertionError("gateway replies not finite or misshapen")
    if any(len(c["version"]) != 1 for c in checks):
        raise AssertionError("a gateway reply matches no version, or both, "
                             "within LOGIT_TOL of a lone predict_feed")
    if any(c["after_swap"] and c["version"] != [2] for c in checks):
        raise AssertionError("a request sent after the swap got v1's answer")
    if not (row["swap"]["replies_v1"] >= SWAP_AFTER
            and row["swap"]["replies_v2"] >= 1):
        raise AssertionError("the swap did not land halfway: {}".format(
            row["swap"]))
    if (final["serving_swaps"], final["serving_swap_failed"],
            final["serving_model_version"]) != (1, 1, "2"):
        raise AssertionError("swaps {} (one applied, one refused, v2 "
                             "served expected)".format(row["swap"]))
    if not (compiles == swapped_compiles == final["serving_compiles"]
            == len(serving.bucket_ladder(GATEWAY_BATCH))):
        raise AssertionError("serving_compiles moved after warmup: "
                             "{}".format(row["serving_compiles"]))
    if final["serving_shed"]:
        raise AssertionError("the gateway shed {} requests".format(
            final["serving_shed"]))
    if not batches < n_requests:
        raise AssertionError("the batcher coalesced nothing: {} batches for "
                             "{} requests".format(batches, n_requests))
    if not (launches == expected == executed["flash_fwd"]):
        raise AssertionError(
            "flash_fwd launched {} times and executed {} on the card, "
            "expected {} (layers x batches)".format(
                launches, executed["flash_fwd"], expected))
    if not (row["lone_bytes_equal"] and lone_diff <= LOGIT_TOL * lone_scale):
        raise AssertionError("the same lone request gave different bytes, "
                             "or differs from predict_feed")
    return row


def server_report(gw, warm_s, compiles):
    report = gw.server.warmup_report or {}
    return {"seconds": warm_s, "compile_count": compiles,
            "rungs": [(b["bucket"], b["verdict"], b["micros"])
                      for b in report.get("buckets", [])]}


def read_line(stream, seconds):
    """One line of ``stream`` within ``seconds``, or None."""
    import select

    ready, _, _ = select.select([stream], [], [], seconds)
    return stream.readline() if ready else None


def phase_serve_cli(torch, np, config=LM_CONFIG, device=None):
    """``inference_cli --serve`` as a subprocess on the LM export: its ready
    line, one 2-row request, SIGTERM and exit 0; then the CLI's batch
    TFRecord mode on the MNIST CNN in this process."""
    import signal

    from tensorflowonspark_torch import (checkpoint, dfutil, gateway,
                                         inference_cli, serving)
    from tensorflowonspark_torch.models import get_model

    layers, vocab = config["num_layers"], config["vocab_size"]
    on = [] if device is None else ["--device", device]
    request = np.random.default_rng(5).integers(
        0, vocab, (2, config["max_seq_len"]), dtype=np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        lm = export_lm(torch, os.path.join(tmp, "lm"), 0, config)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
        log_path = os.path.join(tmp, "serve.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-c", CLI_WRAPPER, "--serve",
                 "--export_dir", lm, "--max-batch", str(CLI_BATCH),
                 "--port", "0"] + on,
                cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=log,
                text=True)
        try:
            ready = read_line(proc.stdout, CLI_READY_SECS)
            ready_s = time.perf_counter() - t0
            if not ready or "ready on" not in ready:
                raise AssertionError("no ready line from --serve: {!r}\n"
                                     "{}".format(ready, open(log_path).read()[
                                         -4000:]))
            addr = ready.split("ready on ")[1].split()[0]
            ch = gateway.GatewayChannel(addr, timeout=CLI_READY_SECS)
            try:
                t1 = time.perf_counter()
                got = ch.predict({"tokens": request}, len(request))["output"]
                request_ms = 1e3 * (time.perf_counter() - t1)
            finally:
                ch.close()
            t2 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(CLI_EXIT_SECS)
            exit_s = time.perf_counter() - t2
            tail = proc.stdout.read()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        counted = json.loads(tail.strip().splitlines()[-1])
        server = serving.ModelServer(lm, batch_size=CLI_BATCH, device=device)
        want = server.predict_feed({"tokens": request}, len(request))["output"]
        diff, scale = logit_diff(np, got, want)
        del server, want

        # batch mode on the card: TFRecords -> JSON lines
        torch.manual_seed(0)
        cnn_dir = os.path.join(tmp, "mnist")
        checkpoint.export_model(cnn_dir, get_model("mnist_cnn"), "mnist_cnn",
                                model_config={},
                                input_signature={"image": [None, 28, 28, 1]})
        images = np.random.default_rng(6).random((MNIST_ROWS, 784),
                                                 np.float32)
        data_dir, out_path = os.path.join(tmp, "tfr"), \
            os.path.join(tmp, "preds.jsonl")
        dfutil.save_as_tfrecords([{"image": images[i].tolist()}
                                  for i in range(MNIST_ROWS)], data_dir,
                                 schema={"image": "array<float32>"})
        t3 = time.perf_counter()
        inference_cli.main(["--export_dir", cnn_dir, "--input", data_dir,
                            "--schema_hint", "struct<image:array<float>>",
                            "--input_mapping", json.dumps({"image": "image"}),
                            "--batch_size", str(MNIST_BATCH),
                            "--output", out_path] + on)
        batch_s = time.perf_counter() - t3
        with open(out_path) as f:
            preds = [json.loads(line) for line in f]
        server = serving.ModelServer(cnn_dir, batch_size=MNIST_BATCH,
                                     device=device)
        feed = images.reshape(-1, 28, 28, 1)
        want = np.concatenate([
            server.predict_feed({"image": feed[i:i + MNIST_BATCH]},
                                len(feed[i:i + MNIST_BATCH]))["output"]
            for i in range(0, MNIST_ROWS, MNIST_BATCH)])
        got_cnn = np.asarray([p["prediction"] for p in preds], np.float32)
        cnn_err = (float(np.abs(got_cnn - want).max())
                   if got_cnn.shape == want.shape else None)
    expected = (layers * (len(serving.bucket_ladder(CLI_BATCH)) + 1)
                if device is None else 0)
    row = {"phase": "serve_cli", "config": config, "max_batch": CLI_BATCH,
           "ready_s": ready_s, "ready_line": ready.strip(),
           "request_rows": len(request), "request_ms": request_ms,
           "vs_predict_feed_max_abs_diff": diff, "max_abs_logit": scale,
           "tol": LOGIT_TOL * scale, "exit_code": code, "exit_s": exit_s,
           "exit_tol_s": CLI_EXIT_SECS,
           "fwd_launches": counted["fwd_launches"],
           "expected_launches": expected,
           "batch_mode": {"model": "mnist_cnn", "rows": MNIST_ROWS,
                          "lines": len(preds), "seconds": batch_s,
                          "max_abs_err": cnn_err, "tol": MNIST_TOL}}
    emit(row)
    if code != 0:
        raise AssertionError("--serve exited {} after SIGTERM".format(code))
    if not diff <= LOGIT_TOL * scale:
        raise AssertionError("--serve answered {} away from predict_feed "
                             "(max |logit| {})".format(diff, scale))
    if counted["fwd_launches"] != expected:
        raise AssertionError("--serve launched flash_fwd {} times, expected "
                             "{} (layers x (warm rungs + 1))".format(
                                 counted["fwd_launches"], expected))
    if len(preds) != MNIST_ROWS or cnn_err is None or cnn_err > MNIST_TOL:
        raise AssertionError("batch mode wrote {} lines, max error {}".format(
            len(preds), cnn_err))
    return row


def pipeline_main(args, ctx):
    """The pipeline phase's ``train_fn``, run by the node in the child it
    forked: trains the LM from the node's feed under ``torch.profiler``,
    exports it as the chief, and reports to ``args.report``."""
    import functools
    import traceback

    report = {"child_started": time.time()}
    try:
        import torch

        from tensorflowonspark_torch import checkpoint, train
        from tensorflowonspark_torch.models import get_model, transformer
        from tensorflowonspark_torch.ops import _build
        from tensorflowonspark_torch.parallel import infeed

        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        device = ctx.initialize_distributed(device=args.device)
        report["device"] = str(device)
        report["distributed_ready"] = time.time()
        if device.type == "cuda":
            for name in _build.build():      # built by the driver: loads
                _build.load(name)
        cfg = args.config
        model = get_model("transformer_lm", **cfg)
        model.init_weights(torch.Generator().manual_seed(0))
        losses = []
        lm_loss = transformer.loss_fn(model)

        def loss_fn(params, batch, mask):
            loss, aux = lm_loss(params, batch, mask)
            losses.append(loss.detach())
            return loss, aux

        trainer = train.Trainer(
            loss_fn, dict(model.state_dict()),
            functools.partial(torch.optim.Adam, lr=args.lr),
            compute_dtype=getattr(torch, cfg["dtype"]),
            batch_size=args.batch_size, log_steps=args.log_steps,
            device=device)
        feed = infeed.ShardedFeed(ctx.get_data_feed(), args.batch_size,
                                  transform=lambda t: {"tokens": t},
                                  device=device)
        report["model_ready"] = time.time()
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        _, report["device_launches"], _ = on_card(
            torch, lambda: trainer.fit_feed(feed),
            None if device.type == "cuda" else "cpu")
        report["launches"] = {"flash_fwd": fa.fwd_launches,
                              "flash_bwd_dq": fa.bwd_dq_launches,
                              "flash_bwd_dkv": fa.bwd_dkv_launches}
        report["fit_feed_end"] = time.time()
        report["steps"] = trainer.state.step
        report["losses"] = [x.item() for x in losses]
        if checkpoint.should_export(ctx):
            checkpoint.export_model(
                args.export_dir, trainer.state.params, "transformer_lm",
                model_config=cfg, input_signature={"tokens": {
                    "shape": [None, cfg["max_seq_len"]], "dtype": "int32"}})
        report["exported"] = time.time()
    except Exception:
        report["error"] = traceback.format_exc()
        raise
    finally:
        with open(args.report + ".tmp", "w") as f:
            json.dump(report, f)
        os.replace(args.report + ".tmp", args.report)


def _executor_launches(zero):
    """A task for the executor: its process's forward-kernel launches
    (zeroed first when ``zero``)."""
    def task(iterator):
        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        if zero:
            fa.fwd_launches = 0
        return [fa.fwd_launches for _ in iterator]
    return task


def phase_pipeline(torch, np, config=LM_CONFIG, device=None):
    """``TFEstimator.fit`` trains the LM in SPARK mode on a one-executor
    LocalBackend, then ``TFModel.transform`` serves 2 rows on that
    executor's card; a ``fit`` after it on the same executor is refused
    (on the card: on the CPU nothing initializes CUDA)."""
    from tensorflowonspark_torch import backend, pipeline, serving

    layers, vocab = config["num_layers"], config["vocab_size"]
    seq = config["max_seq_len"]
    rows = list(lm_rows(np, 4, PIPELINE_ROWS, seq, vocab))
    card_memory(torch, device, reset=True)
    with tempfile.TemporaryDirectory() as tmp:
        args = {"config": config, "lr": LR, "log_steps": PIPELINE_STEPS,
                "device": device, "report": os.path.join(tmp, "report.json")}
        export_dir = os.path.join(tmp, "export")
        t0 = time.time()
        b = backend.LocalBackend(1)
        try:
            est = pipeline.TFEstimator(
                pipeline_main, args, b, device=device, cluster_size=1,
                batch_size=TRAIN_BATCH, epochs=1, export_dir=export_dir,
                grace_secs=1)
            model = est.fit(rows)
            t_fit = time.time()
            report = wait_for_report(args["report"], PIPELINE_REPORT_SECS)
            t_report = time.time()
            b.map_partitions([[0]], _executor_launches(True))
            t1 = time.perf_counter()
            outs = model.transform(rows[:TRANSFORM_ROWS])
            transform_s = time.perf_counter() - t1
            (transform_launches,), = b.map_partitions(
                [[0]], _executor_launches(False))
            # the reverse order on the same executor: refused, loudly
            t2 = time.perf_counter()
            refused = None
            if device is None:
                try:
                    pipeline.TFEstimator(
                        pipeline_main,
                        dict(args, report=args["report"] + "2"), b,
                        cluster_size=1, batch_size=TRAIN_BATCH, epochs=1,
                        export_dir=export_dir + "2", grace_secs=1).fit(
                            rows[:TRAIN_BATCH])
                except Exception as e:
                    refused = str(e)
            refuse_s = time.perf_counter() - t2
        finally:
            b.stop()
        got = np.asarray(outs, np.float32)
        del outs
        server = serving.ModelServer(export_dir, batch_size=TRAIN_BATCH,
                                     device=device)
        want = server.predict_feed({"tokens": np.stack(rows[:TRANSFORM_ROWS])},
                                   TRANSFORM_ROWS)["output"]
        del server
    shape_ok = got.shape == want.shape == (TRANSFORM_ROWS, seq, vocab)
    diff, scale = logit_diff(np, got, want) if shape_ok else (None, None)
    per_row = ([logit_diff(np, got[i], want[i])[0]
                for i in range(TRANSFORM_ROWS)] if shape_ok else None)
    on_cpu = device is not None
    expected = 0 if on_cpu else layers * PIPELINE_STEPS
    losses = report["losses"]
    row = {"phase": "pipeline", "config": config,
           "backend": "LocalBackend(1)", "rows": PIPELINE_ROWS,
           "batch": TRAIN_BATCH, "device": report["device"],
           "steps": report["steps"], "expected_steps": PIPELINE_STEPS,
           "losses": losses, "launches": report["launches"],
           "device_launches": report["device_launches"],
           "expected_launches": expected,
           "bring_up_s": {"to_child_start": report["child_started"] - t0,
                          "to_distributed_ready":
                          report["distributed_ready"] - t0,
                          "to_model_ready": report["model_ready"] - t0},
           "fit_s": t_fit - t0, "fit_to_export_s": report["exported"] - t0,
           "report_wait_s": t_report - t_fit,
           "transform_rows": TRANSFORM_ROWS, "transform_s": transform_s,
           "transform_launches": transform_launches,
           "expected_transform_launches": 0 if on_cpu else layers,
           "transform_vs_server_max_abs_diff": diff,
           "transform_vs_server_per_row": per_row,
           "max_abs_logit": scale,
           "tol": None if scale is None else LOGIT_TOL * scale,
           "fit_after_transform_refused": refused is not None
           and "initialized CUDA" in refused,
           "refusal_s": refuse_s,
           "refusal": None if refused is None else refused[-400:]}
    emit(row)
    if report["steps"] != PIPELINE_STEPS or not (
            len(losses) == PIPELINE_STEPS and np.isfinite(losses).all()):
        raise AssertionError("the pipeline node trained {} steps, losses "
                             "{}".format(report["steps"], losses))
    if any(n != expected for n in list(report["launches"].values())
           + list(report["device_launches"].values())):
        raise AssertionError("pipeline fit launches {} counted, {} executed, "
                             "expected {} each (layers x steps)".format(
                                 report["launches"],
                                 report["device_launches"], expected))
    if not shape_ok or not diff <= LOGIT_TOL * scale:
        raise AssertionError("TFModel.transform differs from the driver's "
                             "ModelServer: {} (max |logit| {})".format(
                                 diff, scale))
    if transform_launches != row["expected_transform_launches"]:
        raise AssertionError("transform launched flash_fwd {} times on the "
                             "executor, expected {}".format(
                                 transform_launches, layers))
    if not (on_cpu or row["fit_after_transform_refused"]):
        raise AssertionError("fit after a CUDA transform was not refused by "
                             "name: {!r}".format(refused))
    return row


# ---------------------------------------------------------------------------
# ResNet-50 v1.5 with BatchNorm state, and the FILES-mode data plane
# ---------------------------------------------------------------------------

# the bench.py resnet leg's shape (bench.py:271-309): ResNet-50 v1.5 at full
# width, s2d stem, bf16 over fp32 params, batch 256 of 224 x 224 x 3 on the
# card; SGD lr 0.1, momentum 0.9, weight decay 1e-4, label smoothing 0.1
RESNET_BATCH = 256
RESNET_PX = 224
RESNET_CLASSES = 1000
RESNET_STEPS = 30
RESNET_LOG_STEPS = 10
RESNET_K = 5
RESNET_LR = 0.1
RESNET_TIMED_RUNS = 3     # timed runs after the checked steps, at each K
RESNET_TIMED_STEPS = 5    # steps a timed run (one group at K = 5)
RESNET_PROFILE_STEPS = 5
# K = 5 replays the K = 1 step's kernels on the same batch from the same
# init; the losses are held to K = 1's at 1e-3 nats, while a replay that
# read a stale batch or stale statistics moves them by O(0.1)
RESNET_LOSS_TOL = 1e-3
# device time by kernel group (lowercased name fragments, first match)
RESNET_KERNEL_GROUPS = (
    ("BatchNorm", ("batch_norm", "bn_fw", "bn_bw")),
    ("SGD", ("sgd", "multi_tensor_apply")),
    ("conv (cuDNN)", ("conv", "xmma", "cudnn", "implicit", "fprop", "dgrad",
                      "wgrad", "cutlass", "nhwc", "gemm", "sm90", "nvjet")),
    ("elementwise", ("elementwise", "copy_kernel", "vectorized", "unrolled",
                     "fill")),
)
# the card against the CPU: blocks_per_stage=1, 64 px, batch 16, fp32, TF32
# off.  cuDNN may pick Winograd or FFT algorithms for fp32, which round
# differently from the CPU's direct convolution (the CPU arithmetic is the
# one tests/test_torch_resnet.py holds to flax at 1e-4): logits and running
# averages within 1e-3 of their largest value; one SGD step's update within
# 1e-2 of its norm over all params (a pre-activation within rounding of a
# ReLU's kink may take the other side on the other device and move one
# kernel's gradient by percents)
RVC_BATCH, RVC_PX = 16, 64
RVC_TOL = 1e-3
RVC_STEP_RTOL = 1e-2
# FILES mode: 4 train shards of 256 rows at store_px 256 (201326592 B of
# pixels), 2 validation shards of 128 rows, batch 256 at 224 px, crop on the
# card, 4 epochs = 16 steps at K = 4, windows of 4 steps, saves every 8
FILES_SHARDS, FILES_ROWS, FILES_STORE_PX = 4, 256, 256
FILES_VAL_SHARDS, FILES_VAL_ROWS = 2, 128
FILES_EPOCHS, FILES_K, FILES_SAVE_STEPS = 4, 4, 8
FILES_STEPS = FILES_SHARDS * FILES_ROWS * FILES_EPOCHS // RESNET_BATCH
FILES_CLASSES = 32        # learnable: class templates plus noise
FILES_REPORT_SECS = 600
BF16_PEAK = 989e12        # H100 SXM dense bf16, for the MFU


def resnet_example():
    """The ResNet twin and its input module (examples/resnet/), imported
    from this checkout."""
    path = os.path.join(HERE, "examples", "resnet")
    if path not in sys.path:
        sys.path.insert(0, path)
    import imagenet_input_torch
    import resnet_imagenet_torch

    return resnet_imagenet_torch, imagenet_input_torch


def resnet_trainer(torch, model, device, compute_dtype="bfloat16",
                   **kwargs):
    """A Trainer of ``model`` (ResNet, from its own init) on the bench
    leg's loss and optimizer, the running averages its extra state."""
    import functools

    from tensorflowonspark_torch import train
    from tensorflowonspark_torch.models import resnet

    params, extra = resnet.split_state(model)
    return train.Trainer(
        resnet.loss_fn(model, weight_decay=1e-4, label_smoothing=0.1),
        params, functools.partial(torch.optim.SGD, lr=RESNET_LR,
                                  momentum=0.9),
        extra_state=extra,
        compute_dtype=compute_dtype and getattr(torch, compute_dtype),
        batch_size=RESNET_BATCH, device=device, **kwargs)


def stats_moved(torch, extra, init):
    """Whether every running average moved from ``init`` and is finite."""
    return all(not torch.equal(t.cpu(), init[k]) and bool(
        torch.isfinite(t).all()) for k, t in extra.items())


def phase_resnet_train(torch, np, fa):
    """ResNet-50 v1.5 (s2d, bf16) trained on one device-resident batch of
    256 x 224 x 224 learnable synthetic rows: 30 steps at K = 1, then from
    the same init 30 steps at K = 5 (two eager warm-ups, one capture,
    replays); the losses, the running averages, the steady step at each K,
    the counted FLOPs and bytes, the device time by kernel group and the
    peak memory."""
    from tensorflowonspark_torch.models import resnet

    twin, _ = resnet_example()
    images, labels = twin.synthetic_imagenet(RESNET_BATCH, RESNET_PX)
    batch = {"image": torch.from_numpy(images).cuda(),
             "label": torch.from_numpy(labels).cuda()}
    mask = torch.ones(RESNET_BATCH, device="cuda")
    model = resnet.build_resnet50(num_classes=RESNET_CLASSES,
                                  dtype="bfloat16", stem="s2d")
    model.init_weights(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in resnet.split_state(model)[1].items()}
    torch.cuda.empty_cache()
    rows = {}
    for k in (1, RESNET_K):
        torch.cuda.reset_peak_memory_stats()
        curve = LossCurve()
        tr = resnet_trainer(torch, model, "cuda", log_steps=RESNET_LOG_STEPS,
                            summary_writer=curve)
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        t0 = time.perf_counter()
        if k == 1:
            losses = torch.stack([tr.step(batch, mask)[0]
                                  for _ in range(RESNET_STEPS)]).tolist()
        else:
            for _ in range(RESNET_STEPS // k):
                tr.repeat_step(batch, mask, k)
            torch.cuda.synchronize()
            losses = [curve.losses.get(s) for s in range(1, RESNET_STEPS + 1)]
        torch.cuda.synchronize()
        checked_s = time.perf_counter() - t0
        launches = launches_of(fa)
        peak = torch.cuda.max_memory_allocated()
        moved = stats_moved(torch, tr.state.extra, init)
        finite = all(bool(torch.isfinite(p).all())
                     for p in tr.state.params.values())

        def timed_run(tr=tr, k=k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if k == 1:
                for _ in range(RESNET_TIMED_STEPS):
                    tr.step(batch, mask)
            else:
                tr.repeat_step(batch, mask, RESNET_TIMED_STEPS)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t) / RESNET_TIMED_STEPS

        timed = [timed_run() for _ in range(RESNET_TIMED_RUNS)]

        def run_profiled(tr=tr, k=k):
            if k == 1:
                for _ in range(RESNET_PROFILE_STEPS):
                    tr.step(batch, mask)
            else:
                tr.repeat_step(batch, mask, RESNET_PROFILE_STEPS)

        profile = profile_run(torch, run_profiled, RESNET_PROFILE_STEPS,
                              groups=RESNET_KERNEL_GROUPS)
        steady = median(timed)
        flops = tr.history.step_flops
        rows[k] = {
            "steps_per_call": k, "steps": RESNET_STEPS, "losses": losses,
            "first_loss": losses[0], "last_loss": losses[-1],
            "checked_s": checked_s, "graphs": len(tr._graphs),
            "train_compile_us_max": tr.counters_snapshot().get(
                "train_compile_us_max"),
            "steady_ms_per_step_runs": timed,
            "steady_ms_per_step": steady,
            "steady_spread_ms": max(timed) - min(timed),
            "images_per_s": RESNET_BATCH / steady * 1e3,
            "step_flops": flops, "step_bytes": tr._step_bytes,
            "mfu_vs_989_tflops": (flops / (steady / 1e3) / BF16_PEAK
                                  if flops else None),
            "bound_ms": (1e3 * tr._roofline["ideal_step_seconds"]
                         if tr._roofline else None),
            "bound_by": {"memory": "bytes", "compute": "operations"}.get(
                (tr._roofline or {}).get("bound")),
            "profile": profile, "max_memory_allocated": peak,
            "running_averages_moved_and_finite": moved,
            "params_finite": finite, "flash_launches": launches,
            "extra": {n: t.float().cpu() for n, t in tr.state.extra.items()}}
        del tr
        torch.cuda.empty_cache()
    k1, k5 = rows[1], rows[RESNET_K]
    diffs = [abs(a - b) for a, b in zip(k1["losses"], k5["losses"])
             if a is not None and b is not None]
    stats_diff = max(float((k5["extra"][n] - t).abs().max())
                     for n, t in k1["extra"].items())
    row = {"phase": "resnet_train", "model": "resnet50 v1.5, s2d, bf16",
           "batch": [RESNET_BATCH, RESNET_PX, RESNET_PX, 3],
           "optimizer": "SGD lr {} momentum 0.9, weight decay 1e-4, label "
                        "smoothing 0.1".format(RESNET_LR),
           "k1": {k: v for k, v in k1.items() if k != "extra"},
           "k5": {k: v for k, v in k5.items() if k != "extra"},
           "k5_vs_k1_max_loss_diff": max(diffs) if diffs else None,
           "k5_vs_k1_max_running_average_diff": stats_diff,
           "loss_tol": RESNET_LOSS_TOL}
    emit(row)
    for k, r in rows.items():
        losses = r["losses"]
        if not (None not in losses and np.isfinite(losses).all()
                and losses[-1] < losses[0] and r["params_finite"]):
            raise AssertionError("ResNet-50 at K = {}: loss not finite and "
                                 "falling: {}".format(k, losses))
        if not r["running_averages_moved_and_finite"]:
            raise AssertionError("ResNet-50 at K = {}: a running average "
                                 "did not move or is not finite".format(k))
        if any(r["flash_launches"].values()):
            raise AssertionError("the ResNet path launched flash kernels: "
                                 "{}".format(r["flash_launches"]))
    if k5["graphs"] != 1:
        raise AssertionError("K = 5 captured {} graphs, expected 1".format(
            k5["graphs"]))
    if len(diffs) != RESNET_STEPS or max(diffs) > RESNET_LOSS_TOL:
        raise AssertionError("K = 5 losses differ from K = 1's by {} (tol "
                             "{})".format(max(diffs) if diffs else None,
                                          RESNET_LOSS_TOL))
    return row


def phase_resnet_card_vs_cpu(torch, np):
    """The same fp32 ResNet (one bottleneck a stage, both stems) from one
    seed on the card and on the CPU, TF32 off: train-mode logits, the
    updated running averages, and one SGD step's params."""
    from tensorflowonspark_torch.models import resnet

    rng = np.random.default_rng(5)
    x = rng.standard_normal((RVC_BATCH, RVC_PX, RVC_PX, 3)).astype(np.float32)
    labels = rng.integers(0, RESNET_CLASSES, RVC_BATCH).astype(np.int32)
    assert not torch.backends.cudnn.allow_tf32
    cases = {}
    for stem in ("conv7", "s2d"):
        out = {}
        for device in ("cpu", "cuda"):
            model = resnet.build_resnet50(num_classes=RESNET_CLASSES,
                                          blocks_per_stage=1, stem=stem,
                                          dtype="float32")
            model.init_weights(torch.Generator().manual_seed(0))
            model.to(device)
            params, extra = resnet.split_state(model)
            xb = torch.from_numpy(x).to(device)
            with torch.no_grad():
                logits, stats = torch.func.functional_call(
                    model, {**params, **extra}, (xb,), {"train": True})
            tr = resnet_trainer(torch, model, device, compute_dtype=None)
            tr.step({"image": x, "label": labels})
            out[device] = (logits.cpu(), {k: v.cpu() for k, v in stats.items()},
                           {k: v.detach().cpu() for k, v in params.items()},
                           {k: v.detach().cpu()
                            for k, v in tr.state.params.items()},
                           {k: v.cpu() for k, v in tr.state.extra.items()})
        (lc, sc, p0, pc, ec), (lg, sg, _, pg, eg) = out["cpu"], out["cuda"]
        logit_err = float((lg - lc).abs().max() / lc.abs().max())
        stats_err = max(float((sg[k] - v).abs().max() / v.abs().max())
                        for k, v in sc.items())
        step_stats_err = max(float((eg[k] - v).abs().max() / v.abs().max())
                             for k, v in ec.items())
        upd_c = torch.cat([(pc[k] - p0[k]).flatten() for k in p0])
        upd_g = torch.cat([(pg[k] - p0[k]).flatten() for k in p0])
        step_err = float((upd_g - upd_c).norm() / upd_c.norm())
        worst = max(((float(((pg[k] - p0[k]) - (pc[k] - p0[k])).norm()
                            / max(float((pc[k] - p0[k]).norm()), 1e-30)), k)
                     for k in p0))
        cases[stem] = {"logits_rel_err": logit_err,
                       "running_average_rel_err": stats_err,
                       "step_running_average_rel_err": step_stats_err,
                       "step_update_rel_err": step_err,
                       "worst_tensor_update_rel_err": worst[0],
                       "worst_tensor": worst[1]}
    row = {"phase": "resnet_card_vs_cpu",
           "model": "resnet50 v1.5, 1 block a stage, fp32, TF32 off",
           "batch": [RVC_BATCH, RVC_PX, RVC_PX, 3], "cases": cases,
           "tol": RVC_TOL, "step_update_rtol": RVC_STEP_RTOL}
    emit(row)
    for stem, c in cases.items():
        if not (c["logits_rel_err"] <= RVC_TOL
                and c["running_average_rel_err"] <= RVC_TOL
                and c["step_running_average_rel_err"] <= RVC_TOL
                and c["step_update_rel_err"] <= RVC_STEP_RTOL):
            raise AssertionError("the card's ResNet ({}) differs from the "
                                 "CPU's: {}".format(stem, c))
    return row


def write_predecoded(np, out_dir, split, shards, rows, seed):
    """``shards`` ``<split>-*.raw`` files of ``rows`` predecoded rows each
    (the ``image_raw``/``label`` records of ``predecode_shards``) at
    ``FILES_STORE_PX``, written with the port's ``example_proto`` and
    ``tfrecord``: class templates plus noise, so the rows are learnable.
    Returns the paths."""
    from tensorflowonspark_torch import example_proto, tfrecord

    os.makedirs(out_dir, exist_ok=True)
    px = FILES_STORE_PX
    templates = np.random.default_rng(99).integers(
        0, 256, (FILES_CLASSES, px, px, 3), np.int16)
    paths = []
    for s in range(shards):
        rng = np.random.default_rng((seed, s))
        labels = rng.integers(0, FILES_CLASSES, rows)
        path = os.path.join(out_dir, "{}-{:05d}-of-{:05d}.raw".format(
            split, s, shards))
        with tfrecord.TFRecordWriter(path) as w:
            for i in range(rows):
                img = templates[labels[i]] + rng.integers(
                    -24, 25, (px, px, 3), np.int16)
                w.write(example_proto.encode_example({
                    "image_raw": ("bytes", [np.clip(img, 0, 255).astype(
                        np.uint8).tobytes()]),
                    "label": ("int64", [int(labels[i])])}))
        paths.append(path)
    return paths


def resnet_files_main(args, ctx):
    """The resnet_files phase's node fn, run by the node inline in its
    executor process (FILES mode): the twin's ``train_resnet`` (CUDA comes
    up in it), then the trainer's window times, counters and final running
    averages into ``args["report"]`` (the traceback too when it fails)."""
    import traceback

    report = {"node_started": time.time()}
    try:
        import torch

        sys.path.insert(0, args["example_dir"])
        import resnet_imagenet_torch as twin

        report["cuda_initialized_at_start"] = torch.cuda.is_initialized()
        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        trainer, stats = twin.train_resnet(args["twin"], ctx)
        report["flash_launches"] = launches_of(fa)
        torch.cuda.synchronize()
        report["done"] = time.time()
        log = trainer.history.timestamp_log
        torch.save({k: v.cpu() for k, v in trainer.state.extra.items()},
                   args["extra_path"])
        report.update({
            "device": str(trainer.device), "steps": trainer.state.step,
            "timestamp_log": log, "stats": stats,
            "graphs": len(trainer._graphs),
            "max_memory_allocated": torch.cuda.max_memory_allocated()})
    except Exception:
        report["error"] = traceback.format_exc()
        raise
    finally:
        with open(args["report"] + ".tmp", "w") as f:
            json.dump(report, f, default=float)
        os.replace(args["report"] + ".tmp", args["report"])


def phase_resnet_files(torch, np, fa, train_row):
    """The twin's FILES-mode path through ``cluster.run`` on a one-executor
    LocalBackend: predecoded shards written here, the crop on the card, K =
    4, checkpoints every 8 steps, the exact eval and the chief's export;
    then a fresh Trainer's validated restore against the run's last state,
    and the card's crop against the host crop, byte for byte."""
    from tensorflowonspark_torch import backend, checkpoint, cluster, train
    from tensorflowonspark_torch.models import resnet

    twin, imagenet_input = resnet_example()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = os.path.join(tmp, "raw")
        train_files = write_predecoded(np, data, "train", FILES_SHARDS,
                                       FILES_ROWS, 1)
        write_predecoded(np, data, "validation", FILES_VAL_SHARDS,
                         FILES_VAL_ROWS, 2)
        write_s = time.perf_counter() - t0
        args = twin.parse_args([
            "--cluster_size", "1", "--batch_size", str(RESNET_BATCH),
            "--image_size", str(RESNET_PX), "--stem", "s2d",
            "--train_steps", str(FILES_STEPS),
            "--train_epochs", str(FILES_EPOCHS), "--predecoded",
            "--store_px", str(FILES_STORE_PX), "--data_dir", data,
            "--eval_data_dir", data, "--steps_per_call", str(FILES_K),
            "--log_steps", str(FILES_K), "--shuffle_buffer", "512",
            "--model_dir", os.path.join(tmp, "model"),
            "--save_interval", str(FILES_SAVE_STEPS),
            "--export_dir", os.path.join(tmp, "export")])
        node_args = {"twin": args, "example_dir": os.path.dirname(
                         twin.__file__),
                     "report": os.path.join(tmp, "report.json"),
                     "extra_path": os.path.join(tmp, "extra.pt")}
        b = backend.LocalBackend(1)
        try:
            t_run = time.time()
            c = cluster.run(b, resnet_files_main, node_args, num_executors=1,
                            input_mode=cluster.InputMode.FILES)
            t_ready = time.time()
            c.shutdown(grace_secs=1)
            t_done = time.time()
            report = wait_for_report(node_args["report"], FILES_REPORT_SECS)
        finally:
            b.stop()
        # a fresh Trainer on the card, restored from the run's checkpoints
        model = resnet.build_resnet50(num_classes=twin.NUM_CLASSES,
                                      dtype="bfloat16", stem="s2d")
        params, extra = resnet.split_state(model)
        base_lr, warmup, bounds, _ = twin.lr_schedule(args)
        fresh = train.Trainer(resnet.loss_fn(model), params,
                              twin.scheduled_sgd(base_lr, warmup, bounds),
                              extra_state=extra, device="cuda")
        ckpt = checkpoint.CheckpointManager(args.model_dir)
        saved_steps = ckpt.latest_step(), sorted(os.listdir(args.model_dir))
        restored = fresh.restore_latest(ckpt, validate=True)
        exported, descriptor = checkpoint.load_model(args.export_dir,
                                                     validate=True)
        last_extra = torch.load(node_args["extra_path"], weights_only=True)
        params_equal = all(torch.equal(fresh.state.params[k].detach().cpu(), v)
                           for k, v in exported.items())
        extra_equal = all(torch.equal(fresh.state.extra[k].cpu(), v)
                          for k, v in last_extra.items())
        # the card's crop against the host crop of the same rows and seed
        def rows(device_crop):
            reader = imagenet_input.predecoded_reader(
                train=True, image_size=RESNET_PX, store_px=FILES_STORE_PX,
                seed=0, device_crop=device_crop)
            return list(reader(train_files[0]))

        host, dev = rows(False), rows(True)
        crop = twin_crop(torch, np, dev)
        crop_equal = bool(np.array_equal(
            crop, np.stack([r["image"] for r in host])))
        flips = int(sum(r["flip"] for r in dev))
    log = report["timestamp_log"]
    window_ms = [1e3 * (t1 - t0_) / (s1 - s0)
                 for (s0, t0_), (s1, t1) in zip(log, log[1:])]
    later = sorted(window_ms[1:])
    steady = later[len(later) // 2] if later else None
    fed_s = log[-1][1] - log[0][1]
    stats = report["stats"]
    overlap = stats.get("overlap", {})
    k5_steady = train_row["k5"]["steady_ms_per_step"]
    row = {"phase": "resnet_files", "input_mode": "FILES",
           "backend": "LocalBackend(1)",
           "model": "resnet50 v1.5, s2d, bf16 (the twin's 1001 classes)",
           "train_rows": FILES_SHARDS * FILES_ROWS,
           "pixel_bytes": FILES_SHARDS * FILES_ROWS * FILES_STORE_PX ** 2 * 3,
           "feed_bytes_per_step": RESNET_BATCH * FILES_STORE_PX ** 2 * 3,
           "write_shards_s": write_s,
           "steps": report["steps"], "expected_steps": FILES_STEPS,
           "steps_per_call": FILES_K, "graphs": report["graphs"],
           "cuda_initialized_at_node_start":
               report["cuda_initialized_at_start"],
           "bring_up_s": {
               "cluster_run": t_ready - t_run,
               "to_node_start": report["node_started"] - t_run,
               "to_first_step": log[0][1] - t_run},
           "run_to_shutdown_done_s": t_done - t_run,
           "rows_per_s_fed": (FILES_STEPS * RESNET_BATCH / fed_s
                              if fed_s > 0 else None),
           "window_ms_per_step": window_ms,
           "steady_ms_per_step": steady,
           "resnet_train_k5_steady_ms_per_step": k5_steady,
           "steady_vs_resnet_train_k5": (steady / k5_steady
                                         if steady and k5_steady else None),
           "goodput_infeed_starved_us": overlap.get(
               "goodput_infeed_starved_us"),
           "goodput_dispatch_us": overlap.get("goodput_dispatch_us"),
           "infeed": {k: v for k, v in overlap.items()
                      if k.startswith("infeed_")},
           "final_loss": stats.get("loss"),
           "eval_rows": stats.get("eval_rows"),
           "expected_eval_rows": FILES_VAL_SHARDS * FILES_VAL_ROWS,
           "eval_accuracy_top_1": stats.get("eval_accuracy_top_1"),
           "checkpoint_steps": saved_steps[1],
           "restored_step": restored,
           "restored_params_equal_export": params_equal,
           "restored_extra_equal_last": extra_equal,
           "export_descriptor": descriptor,
           "crop_rows": len(dev), "crop_flips": flips,
           "crop_equal_host_crop": crop_equal,
           "flash_launches": report["flash_launches"],
           "max_memory_allocated": report["max_memory_allocated"]}
    emit(row)
    if report["cuda_initialized_at_start"]:
        raise AssertionError("CUDA was up in the executor before the node "
                             "fn ran")
    if report["steps"] != FILES_STEPS or not np.isfinite(
            stats.get("loss", float("nan"))):
        raise AssertionError("the FILES node trained {} steps (expected {}), "
                             "final loss {}".format(report["steps"],
                                                    FILES_STEPS,
                                                    stats.get("loss")))
    if row["eval_rows"] != row["expected_eval_rows"]:
        raise AssertionError("the exact eval saw {} rows of {}".format(
            row["eval_rows"], row["expected_eval_rows"]))
    if restored != FILES_STEPS or not (params_equal and extra_equal):
        raise AssertionError("the validated restore gave step {} (expected "
                             "{}), params equal {}, extra equal {}".format(
                                 restored, FILES_STEPS, params_equal,
                                 extra_equal))
    if not crop_equal or not 0 < flips < len(dev):
        raise AssertionError("crop_and_flip on the card differs from the "
                             "host crop ({} flips of {})".format(
                                 flips, len(dev)))
    if any(report["flash_launches"].values()):
        raise AssertionError("the ResNet FILES path launched flash kernels: "
                             "{}".format(report["flash_launches"]))
    if report["graphs"] != 1:
        raise AssertionError("the FILES node captured {} graphs, expected "
                             "1".format(report["graphs"]))
    return row


def twin_crop(torch, np, rows):
    """``ops.augment.crop_and_flip`` on the card over device-crop rows, back
    on the host."""
    from tensorflowonspark_torch.ops import augment

    images = torch.from_numpy(np.stack([r["image"] for r in rows])).cuda()
    offsets = [torch.tensor([r[k] for r in rows], device="cuda")
               for k in ("cropx", "cropy", "flip")]
    return augment.crop_and_flip(images, *offsets, RESNET_PX).cpu().numpy()


# ---------------------------------------------------------------------------
# The Switch MoE LM and the LM twin
# ---------------------------------------------------------------------------

# the flagship LM's MoE variant (bench.py:84-85): the dense LM's widths,
# depth and flash attention, 8 experts at capacity factor 1.25 (160 slots
# an expert in a row of 1024 tokens)
MOE_CONFIG = dict(LM_CONFIG, mlp="moe", num_experts=8, capacity_factor=1.25)
MOE_STEPS = 30
# the checked steps run under the profiler in windows of 10 steps, each
# window's flash kernels reported apart
MOE_PROFILED_STEPS = 10
MOE_TIMED_RUNS = 5     # timed runs after the checked steps, at each K
MOE_TIMED_STEPS = 5    # steps a timed and a profiled run (a group at K = 5)
# K = 5 against K = 1: the same kernels, cuBLAS calls and capturable Adam
# on the same card, held at MEGA_LOSS_TOL like the dense LM.  Served
# against the in-memory model and a row alone against the same row in a
# batch of 4: the same bf16 kernels on the same params, but cuBLAS may
# pick another algorithm for another row count; HANDOFF_TOL of max|logit|
# as the dense handoff
# the card against the CPU: a 2-layer fp32 MoE LM, TF32 off.  The logits
# sum in another order on each device (1e-4 of max|logit|, the fp32
# logit tolerance of tests/test_torch_transformer.py); the routing must
# be identical; the load-balance term and the loss to 1e-5 relative; one
# SGD step's update within 1e-3 of its norm
MVC_CONFIG = {"vocab_size": 256, "num_layers": 2, "num_heads": 2,
              "head_dim": 64, "max_seq_len": 128, "attention": "flash",
              "dtype": "float32", "mlp": "moe", "num_experts": 4,
              "capacity_factor": 1.25}
MVC_BATCH, MVC_SEQ = 4, 128
MVC_TOL = 1e-4
MVC_SCALAR_RTOL = 1e-5
MVC_STEP_RTOL = 1e-3
MOE_SERVE_REQUESTS = (4, 3, 1)
# lm_example: the LM twin at the flagship's widths and depth with --mlp moe
# --attention flash --dtype bfloat16, 20 steps in windows of 5, on the
# synthetic stream and on 4 byte files of 64 KiB written here (256 rows of
# 1024 tokens)
EXAMPLE_STEPS = 20
EXAMPLE_LOG_STEPS = 5
EXAMPLE_FILES, EXAMPLE_FILE_BYTES = 4, 1 << 16
EXAMPLE_REPORT_SECS = 600


def moe_step_flops(config, batch, seq):
    """Analytic FLOPs of one training step's MoE products, by part.  A
    product of ``[G, S, E, C]`` one-hots with ``[G, S, D]`` is 2 G S E C D
    FLOPs: dispatch runs it forward and for the input's gradient (the
    one-hots take none), combine forward and for both operands' gradients;
    the expert FFN's two products of 2 G E C D H each run three times."""
    layers, e = config["num_layers"], config["num_experts"]
    d = config["num_heads"] * config["head_dim"]
    capacity = max(int(config["capacity_factor"] * seq / e), 1)
    one_hot = 2 * batch * seq * e * capacity * d
    ffn = 2 * (2 * batch * e * capacity * d * 4 * d)
    return {"capacity": capacity, "dispatch": 2 * one_hot * layers,
            "combine": 3 * one_hot * layers, "expert_ffn": 3 * ffn * layers}


def moe_ops(hidden):
    """A :func:`profile_run` reader: device ms a step of the MoE layers'
    batched products (``aten::bmm``, forward and backward: nothing else
    in the MoE LM calls it), split by shape into the expert FFN (an
    operand holds the hidden width) and dispatch / combine."""
    def read(prof, n):
        split = {"dispatch_combine": 0.0, "expert_ffn": 0.0}
        calls = 0
        for e in prof.key_averages(group_by_input_shape=True):
            if e.key != "aten::bmm":
                continue
            part = ("expert_ffn" if any(hidden in shape for shape in
                                        e.input_shapes) else
                    "dispatch_combine")
            split[part] += e.device_time_total / 1e3 / n
            calls += e.count
        measured = calls and sum(split.values())
        return {"moe_ms_per_step": split if measured else None,
                "moe_bmm_calls_per_step": calls / n}
    return read


def moe_dropped_share(torch, model, params, tokens):
    """Per MoE layer, the share of ``tokens``' positions routed past their
    expert's capacity under ``params`` (device tensors, read once after
    the forward)."""
    shares = []

    def hook(layer, args):
        x = args[0]
        pos = layer.route(x)[3]
        shares.append((pos >= layer.capacity(x.shape[1])).float().mean())

    hooks = [b.moe.register_forward_pre_hook(hook) for b in model.blocks]
    try:
        with torch.no_grad():
            torch.func.functional_call(model, params, (tokens,))
    finally:
        for h in hooks:
            h.remove()
    return torch.stack(shares).tolist()


def phase_moe_train(torch, np, fa, metrics, dense_k5):
    """The MoE LM (``MOE_CONFIG``) trained on the dense LM's stream: 30
    Adam steps at K = 1, then from the same init 30 at K = 5 (two eager
    warm-ups, one capture, replays), each under the profiler for the flash
    kernels the card executed; the losses and load-balance terms, the
    steady step at each K on device-resident batches, the counted and
    analytic FLOPs, device time by kernel group with the MoE products
    split out, the share of tokens dropped at capacity, peak memory.
    Returns the row, the model and the K = 5 run's params."""
    import functools

    from tensorflowonspark_torch import train
    from tensorflowonspark_torch.models import get_model, transformer

    vocab, layers = MOE_CONFIG["vocab_size"], MOE_CONFIG["num_layers"]
    heads, head_dim = MOE_CONFIG["num_heads"], MOE_CONFIG["head_dim"]
    model = get_model("transformer_lm", **MOE_CONFIG)
    model.init_weights(torch.Generator().manual_seed(0))
    init = dict(model.state_dict())
    n_params = sum(t.numel() for t in init.values())
    loss_fn = transformer.loss_fn(model)
    flash_flops = 7 * SEQ * SEQ * head_dim * TRAIN_BATCH * heads * layers
    analytic = moe_step_flops(MOE_CONFIG, TRAIN_BATCH, SEQ)
    fixed = torch.from_numpy(NgramFeed(np, 1, TRAIN_BATCH, SEQ, vocab)
                             .next_batch()[0]["tokens"]).cuda()
    dropped_init = moe_dropped_share(
        torch, model, {k: v.cuda() for k, v in init.items()}, fixed)
    torch.cuda.empty_cache()
    runs = {}
    for k in (1, MEGA_K):
        torch.cuda.reset_peak_memory_stats()
        curve = LossCurve()
        tr = train.Trainer(loss_fn, init,
                           functools.partial(torch.optim.Adam, lr=LR),
                           compute_dtype=torch.bfloat16,
                           batch_size=TRAIN_BATCH, log_steps=LOG_STEPS,
                           extra_step_flops=flash_flops,
                           summary_writer=curve)
        feed = NgramFeed(np, 0, TRAIN_BATCH, SEQ, vocab)

        def window(tr=tr, feed=feed, k=k):
            if k == 1:
                return [tr.step(*feed.next_batch())
                        for _ in range(MOE_PROFILED_STEPS)]
            for _ in range(MOE_PROFILED_STEPS // k):
                tr.multi_step(*feed.next_group(k))
            return []

        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        t0 = time.perf_counter()                      # the main path starts
        out, windows = [], []
        for _ in range(MOE_STEPS // MOE_PROFILED_STEPS):
            steps, counts = counted_on_device(torch, window)
            out += steps
            windows.append(counts)
        executed = {name: sum(w[name] for w in windows)
                    for name in FLASH_KERNELS}
        checked_s = time.perf_counter() - t0
        launches = launches_of(fa)                    # ... and ends
        checked_steps = tr.state.step
        peak = torch.cuda.max_memory_allocated()
        if k == 1:
            losses = torch.stack([loss for loss, _ in out]).tolist()
            aux = torch.stack([a["moe_aux_loss"] for _, a in out]).tolist()
        else:
            losses = [curve.losses.get(s) for s in range(1, MOE_STEPS + 1)]
            aux = None
        params = {n: v.detach() for n, v in tr.state.params.items()}
        dropped = moe_dropped_share(torch, model, params, fixed)

        more = NgramFeed(np, 3, TRAIN_BATCH, SEQ, vocab)
        if k == 1:
            batches = device_batches(torch, more, MOE_TIMED_STEPS, "cuda")

            def timed_steps(tr=tr, batches=batches):
                for batch, mask in batches:
                    tr.step(batch, mask)
        else:
            stack, masks = more.next_group(k)
            group = ({"tokens": torch.from_numpy(stack["tokens"]).cuda()},
                     torch.from_numpy(masks).cuda())

            def timed_steps(tr=tr, group=group):
                tr.multi_step(*group)

        def timed_run():
            torch.cuda.synchronize()
            t = time.perf_counter()
            timed_steps()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t) / MOE_TIMED_STEPS

        timed = [timed_run() for _ in range(MOE_TIMED_RUNS)]
        steady = median(timed)
        profile = profile_run(torch, timed_steps, MOE_TIMED_STEPS,
                              ops=moe_ops(4 * heads * head_dim)
                              if k == 1 else None)
        busy = profile["device_busy_ms_per_step"]
        profile["device_idle_share_of_steady_step"] = (
            1.0 - busy / steady if busy else None)
        flops = tr.history.step_flops
        runs[k] = {
            "steps_per_call": k, "steps": checked_steps, "losses": losses,
            "moe_aux_losses": aux, "checked_s": checked_s,
            "graphs": len(tr._graphs),
            "train_compile_us_max": tr.counters_snapshot().get(
                "train_compile_us_max"),
            "launches": launches, "device_launches": executed,
            "device_launches_by_window": windows,
            "steady_ms_per_step_runs": timed, "steady_ms_per_step": steady,
            "steady_spread_ms": max(timed) - min(timed),
            "tokens_per_s": TRAIN_BATCH * SEQ / (steady / 1e3),
            "step_flops": flops, "step_bytes": tr._step_bytes,
            "mfu_vs_989_tflops": (flops / (steady / 1e3) / BF16_PEAK
                                  if flops else None),
            "profile": profile, "max_memory_allocated": peak,
            "dropped_share_by_layer": dropped}
        if k == MEGA_K:
            final = params
        del tr, params
        torch.cuda.empty_cache()
    k1, k5 = runs[1], runs[MEGA_K]
    diffs = [abs(a - b) for a, b in zip(k1["losses"], k5["losses"])
             if a is not None and b is not None]
    expected = layers * MOE_STEPS
    dense_steady = dense_k5["steady_ms_per_step"]
    row = {"phase": "moe_train", "config": MOE_CONFIG, "params": n_params,
           "batch": TRAIN_BATCH, "seq": SEQ,
           "optimizer": "torch.optim.Adam(lr={}), capturable".format(LR),
           "k1": k1, "k5": k5,
           "k5_vs_k1_max_loss_diff": max(diffs) if diffs else None,
           "loss_tol_vs_k1": MEGA_LOSS_TOL, "loss_drop": LOSS_DROP,
           "expected_launches": expected,
           "analytic_moe_flops": analytic,
           "flash_flops": flash_flops,
           "dropped_share_by_layer_at_init": dropped_init,
           "dense_k5_steady_ms_per_step": dense_steady,
           "k5_steady_vs_dense_k5": k5["steady_ms_per_step"] / dense_steady}
    emit(row)
    for k, r in runs.items():
        losses = r["losses"]
        if r["steps"] != MOE_STEPS:
            raise AssertionError("the MoE LM at K = {} took {} steps, "
                                 "expected {}".format(k, r["steps"],
                                                      MOE_STEPS))
        if not (None not in losses and np.isfinite(losses).all()
                and losses[-1] <= losses[0] - LOSS_DROP):
            raise AssertionError("the MoE LM at K = {}: loss not finite and "
                                 "falling: {}".format(k, losses))
        if any(n != expected for n in list(r["launches"].values())
               + list(r["device_launches"].values())):
            raise AssertionError(
                "the MoE LM at K = {}: kernel launches {} counted and {} "
                "executed on the card, expected {} each (layers x steps)"
                .format(k, r["launches"], r["device_launches"], expected))
    if not np.isfinite(k1["moe_aux_losses"]).all():
        raise AssertionError("the MoE load-balance term is not finite: "
                             "{}".format(k1["moe_aux_losses"]))
    if k5["graphs"] != 1:
        raise AssertionError("the MoE LM at K = 5 captured {} graphs, "
                             "expected 1".format(k5["graphs"]))
    if len(diffs) != MOE_STEPS or max(diffs) > MEGA_LOSS_TOL:
        raise AssertionError("the MoE LM's K = 5 losses differ from K = 1's "
                             "by {} (tol {})".format(
                                 max(diffs) if diffs else None,
                                 MEGA_LOSS_TOL))
    return row, model, final


def phase_moe_card_vs_cpu(torch, np):
    """A 2-layer fp32 MoE LM from one seed on the CPU and on the card, TF32
    off: each layer's routing, the logits, the load-balance term, and one
    SGD step's loss and update."""
    import functools

    from tensorflowonspark_torch import train
    from tensorflowonspark_torch.models import get_model, transformer

    assert not torch.backends.cuda.matmul.allow_tf32
    tokens = np.random.default_rng(7).integers(
        0, MVC_CONFIG["vocab_size"], (MVC_BATCH, MVC_SEQ), dtype=np.int32)
    model = get_model("transformer_lm", **MVC_CONFIG)
    model.init_weights(torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out = {}
    for device in ("cpu", "cuda"):
        routed = []
        hooks = [b.moe.router.register_forward_hook(
            lambda mod, args, logits: routed.append(logits.argmax(-1)))
            for b in model.blocks]
        try:
            with torch.no_grad():
                logits, balance = torch.func.functional_call(
                    model, {k: v.to(device) for k, v in init.items()},
                    (torch.from_numpy(tokens).to(device),),
                    {"return_aux": True})
        finally:
            for h in hooks:
                h.remove()
        tr = train.Trainer(transformer.loss_fn(model), init,
                           functools.partial(torch.optim.SGD, lr=0.1),
                           device=device)
        loss, aux = tr.step({"tokens": tokens})
        out[device] = (logits.cpu(), balance.item(),
                       torch.stack(routed).cpu(), loss.item(),
                       aux["moe_aux_loss"].item(),
                       {k: v.detach().cpu() for k, v in
                        tr.state.params.items()})
    (lc, bc, rc, loss_c, aux_c, pc), (lg, bg, rg, loss_g, aux_g, pg) = (
        out["cpu"], out["cuda"])
    upd_c = torch.cat([(pc[k] - init[k]).flatten() for k in init])
    upd_g = torch.cat([(pg[k] - init[k]).flatten() for k in init])
    row = {"phase": "moe_card_vs_cpu", "config": MVC_CONFIG,
           "batch": [MVC_BATCH, MVC_SEQ],
           "routing_equal": bool(torch.equal(rc, rg)),
           "routing_agreement": float((rc == rg).float().mean()),
           "logits_rel_err": float((lg - lc).abs().max() / lc.abs().max()),
           "moe_aux_rel_err": abs(bg - bc) / abs(bc),
           "loss_rel_err": abs(loss_g - loss_c) / abs(loss_c),
           "step_moe_aux_rel_err": abs(aux_g - aux_c) / abs(aux_c),
           "step_update_rel_err": float((upd_g - upd_c).norm()
                                        / upd_c.norm()),
           "tol": MVC_TOL, "scalar_rtol": MVC_SCALAR_RTOL,
           "step_update_rtol": MVC_STEP_RTOL}
    emit(row)
    if not (row["routing_equal"] and row["logits_rel_err"] <= MVC_TOL
            and max(row["moe_aux_rel_err"], row["loss_rel_err"],
                    row["step_moe_aux_rel_err"]) <= MVC_SCALAR_RTOL
            and row["step_update_rel_err"] <= MVC_STEP_RTOL):
        raise AssertionError("the card's MoE LM differs from the CPU's: "
                             "{}".format(row))
    return row


def phase_moe_serve(torch, np, fa, model, params):
    """The trained MoE LM exported, loaded by ``ModelServer`` and served in
    requests of 4, 3 and 1 rows (the 1-row request is the 4-row request's
    second row): the logits against the in-memory model on the same params,
    and a row alone against the same row in the batch."""
    from tensorflowonspark_torch import checkpoint, serving

    layers = MOE_CONFIG["num_layers"]
    rng = np.random.default_rng(11)
    four = rng.integers(0, MOE_CONFIG["vocab_size"], (4, SEQ),
                        dtype=np.int32)
    three = rng.integers(0, MOE_CONFIG["vocab_size"], (3, SEQ),
                         dtype=np.int32)
    requests = [four, three, four[1:2]]
    with tempfile.TemporaryDirectory() as tmp:
        export_dir = os.path.join(tmp, "export")
        t0 = time.perf_counter()
        checkpoint.export_model(
            export_dir, params, "transformer_lm", model_config=MOE_CONFIG,
            input_signature={"tokens": {"shape": [None, SEQ],
                                        "dtype": "int32"}})
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        server = serving.ModelServer(export_dir, batch_size=SERVE_BATCH)
        load_s = time.perf_counter() - t0
        fa.fwd_launches = 0                           # the main path starts
        latencies, outputs = [], []
        for tokens in requests:
            t0 = time.perf_counter()
            outputs.append(server.predict_feed({"tokens": tokens},
                                               len(tokens))["output"])
            latencies.append(time.perf_counter() - t0)
        launches = fa.fwd_launches                    # ... and ends
        del server
    diffs, scale = [], 0.0
    with torch.inference_mode():
        for tokens, got in zip(requests, outputs):
            want = torch.func.functional_call(
                model, params, (torch.from_numpy(tokens).cuda(),)).cpu()
            want = want.numpy()
            scale = max(scale, float(np.abs(want).max()))
            diffs.append(float(np.abs(got - want).max()))
    alone = float(np.abs(outputs[2][0] - outputs[0][1]).max())
    finite = all(bool(np.isfinite(o).all()) for o in outputs)
    expected = layers * len(requests)
    row = {"phase": "moe_serve", "config": MOE_CONFIG,
           "requests": [{"rows": len(t), "ms": 1e3 * s}
                        for t, s in zip(requests, latencies)],
           "export_s": export_s, "load_s": load_s,
           "vs_in_memory_max_abs_diff": diffs, "max_abs_logit": scale,
           "row_alone_vs_in_batch_max_abs_diff": alone,
           "tol": HANDOFF_TOL * scale, "logits_finite": finite,
           "fwd_launches": launches, "expected_launches": expected}
    emit(row)
    if not finite:
        raise AssertionError("the served MoE logits are not finite")
    if launches != expected:
        raise AssertionError("flash_fwd launched {} times serving the MoE LM,"
                             " expected {}".format(launches, expected))
    if max(diffs + [alone]) > HANDOFF_TOL * scale:
        raise AssertionError(
            "the served MoE LM differs from the in-memory model ({}) or a "
            "row alone from the same row in a batch ({}); max |logit| "
            "{}".format(diffs, alone, scale))
    return row


def lm_example():
    """The LM twin (examples/transformer/), imported from this checkout."""
    path = os.path.join(HERE, "examples", "transformer")
    if path not in sys.path:
        sys.path.insert(0, path)
    import transformer_lm_torch

    return transformer_lm_torch


def lm_example_main(args, ctx):
    """The lm_example phase's node fn, run by the node inline in its
    executor process (FILES mode): the twin's ``train_lm`` (CUDA comes up
    in it), then the trainer's window times and the flash kernels' launches
    into ``args["report"]`` (the traceback too when it fails)."""
    import traceback

    report = {"node_started": time.time()}
    try:
        import torch

        sys.path.insert(0, args["example_dir"])
        import transformer_lm_torch as twin

        report["cuda_initialized_at_start"] = torch.cuda.is_initialized()
        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        trainer, stats = twin.train_lm(args["twin"], ctx)
        report["launches"] = launches_of(fa)
        torch.cuda.synchronize()
        report.update({
            "device": str(trainer.device), "steps": trainer.state.step,
            "timestamp_log": trainer.history.timestamp_log, "stats": stats,
            "step_flops": trainer.history.step_flops,
            "max_memory_allocated": torch.cuda.max_memory_allocated()})
    except Exception:
        report["error"] = traceback.format_exc()
        raise
    finally:
        with open(args["report"] + ".tmp", "w") as f:
            json.dump(report, f, default=float)
        os.replace(args["report"] + ".tmp", args["report"])


def write_text_files(np, out_dir):
    """``EXAMPLE_FILES`` files of ``EXAMPLE_FILE_BYTES`` bytes of seeded
    text (words of a small vocabulary), for the twin's ``--data_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    words = [w.encode() for w in (
        "the of and to in is was for on that with as by at from this be "
        "are or an it his which has had not but were have their its one "
        "two three first new after all also been more other when into "
        "spark cluster node feed train serve card kernel expert token").split()]
    for i in range(EXAMPLE_FILES):
        rng = np.random.default_rng((13, i))
        text = b" ".join(words[j] for j in rng.integers(
            0, len(words), EXAMPLE_FILE_BYTES // 3))
        with open(os.path.join(out_dir, "part-{:05d}.txt".format(i)),
                  "wb") as f:
            f.write(text[:EXAMPLE_FILE_BYTES])


def phase_lm_example(torch, np, moe_row):
    """The LM twin through ``cluster.run`` in FILES mode on a one-executor
    LocalBackend, at the flagship's widths and depth with ``--mlp moe
    --attention flash --dtype bfloat16``: on the synthetic stream, then on
    byte files written here (``--data_dir``); each run's export is loaded
    and served in this process."""
    from tensorflowonspark_torch import backend, checkpoint, cluster, serving
    # what cluster.run imports at first use, imported before the two runs'
    # threads (two threads importing one module at once can fail)
    from tensorflowonspark_torch import fault, manager, util  # noqa: F401

    twin = lm_example()
    layers = MOE_CONFIG["num_layers"]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "text")
        write_text_files(np, data)

        def train(mode):
            """The twin's cluster on ``mode``'s stream: ``(its export, the
            node's report, when cluster.run was called, when shutdown
            returned)``."""
            export_dir = os.path.join(tmp, "export_" + mode)
            argv = ["--cluster_size", "1", "--batch_size", str(TRAIN_BATCH),
                    "--train_steps", str(EXAMPLE_STEPS),
                    "--vocab_size", str(MOE_CONFIG["vocab_size"]),
                    "--num_layers", str(layers),
                    "--num_heads", str(MOE_CONFIG["num_heads"]),
                    "--head_dim", str(MOE_CONFIG["head_dim"]),
                    "--seq_len", str(SEQ), "--mlp", "moe",
                    "--num_experts", str(MOE_CONFIG["num_experts"]),
                    "--attention", "flash", "--dtype", "bfloat16",
                    "--log_steps", str(EXAMPLE_LOG_STEPS),
                    "--export_dir", export_dir]
            if mode == "files":
                argv += ["--data_dir", data, "--shuffle_buffer", "64"]
            node_args = {"twin": twin.parse_args(argv),
                         "example_dir": os.path.dirname(twin.__file__),
                         "report": os.path.join(tmp, mode + ".json")}
            b = backend.LocalBackend(1)
            try:
                t_run = time.time()
                c = cluster.run(b, lm_example_main, node_args,
                                num_executors=1,
                                input_mode=cluster.InputMode.FILES)
                c.shutdown(grace_secs=1)
                t_done = time.time()
                report = wait_for_report(node_args["report"],
                                         EXAMPLE_REPORT_SECS)
            finally:
                b.stop()
            return export_dir, report, t_run, t_done

        # the two runs' clusters side by side on the card (their bring-up
        # and step times are each other's neighbours')
        torch.cuda.empty_cache()
        modes = ("synthetic", "files")
        legs = {mode: Leg(lambda mode=mode: train(mode),
                          EXAMPLE_REPORT_SECS + CLUSTER_REPORT_SECS)
                for mode in modes}
        for mode in modes:
            export_dir, report, t_run, t_done = legs[mode].result()
            _, descriptor = checkpoint.load_model(export_dir, validate=True)
            t0 = time.perf_counter()
            server = serving.ModelServer(export_dir, batch_size=SERVE_BATCH)
            request = np.random.default_rng(5).integers(
                0, 256, (2, SEQ), dtype=np.int32)
            served = server.predict_feed({"tokens": request}, 2)["output"]
            serve_s = time.perf_counter() - t0
            moe_served = server.model.blocks[0].moe is not None
            del server
            log = report["timestamp_log"]
            window_ms = [1e3 * (t1 - t0_) / (s1 - s0)
                         for (s0, t0_), (s1, t1) in zip(log, log[1:])]
            later = sorted(window_ms[1:])
            runs[mode] = {
                "steps": report["steps"], "launches": report["launches"],
                "final_loss": report["stats"].get("loss"),
                "cuda_initialized_at_node_start":
                    report["cuda_initialized_at_start"],
                "bring_up_s": {"to_node_start": report["node_started"]
                               - t_run,
                               "to_first_step": log[0][1] - t_run},
                "run_to_shutdown_done_s": t_done - t_run,
                "window_ms_per_step": window_ms,
                "steady_ms_per_step": later[len(later) // 2] if later
                else None,
                "step_flops": report["step_flops"],
                "max_memory_allocated": report["max_memory_allocated"],
                "export_model_config": descriptor["model_config"],
                "served_moe": moe_served, "serve_s": serve_s,
                "served_finite": bool(np.isfinite(served).all()),
                "served_shape": list(served.shape)}
    expected = layers * EXAMPLE_STEPS
    row = {"phase": "lm_example", "input_mode": "FILES",
           "backend": "LocalBackend(1)",
           "flags": "--mlp moe --attention flash --dtype bfloat16, {} steps "
                    "of {} x {}".format(EXAMPLE_STEPS, TRAIN_BATCH, SEQ),
           "text_bytes": EXAMPLE_FILES * EXAMPLE_FILE_BYTES,
           "expected_launches": expected,
           "moe_train_k1_steady_ms_per_step":
               moe_row["k1"]["steady_ms_per_step"],
           "runs": runs}
    emit(row)
    for mode, r in runs.items():
        config = r["export_model_config"]
        if r["cuda_initialized_at_node_start"]:
            raise AssertionError("CUDA was up in the executor before the "
                                 "LM twin's node fn ran")
        if r["steps"] != EXAMPLE_STEPS or not np.isfinite(
                r["final_loss"] if r["final_loss"] is not None
                else float("nan")):
            raise AssertionError("the twin ({}) trained {} steps (expected "
                                 "{}), final loss {}".format(
                                     mode, r["steps"], EXAMPLE_STEPS,
                                     r["final_loss"]))
        if any(n != expected for n in r["launches"].values()):
            raise AssertionError("the twin ({}) launched {}, expected {} "
                                 "each".format(mode, r["launches"],
                                               expected))
        if not (config.get("mlp") == "moe" and config.get("num_experts")
                == MOE_CONFIG["num_experts"] and r["served_moe"]
                and r["served_finite"]
                and r["served_shape"] == [2, SEQ, MOE_CONFIG["vocab_size"]]):
            raise AssertionError("the twin's export ({}) did not serve as "
                                 "the MoE LM: {}".format(mode, r))
    return row


# the parallel phase: the flagship's attention per card, and its
# tolerance against the plain contraction and the flash op (bf16: 2e-2 of
# the largest value or gradient, the public contract's)
PARALLEL_SHAPE = (TRAIN_BATCH, SEQ, LM_CONFIG["num_heads"],
                  LM_CONFIG["head_dim"])
PARALLEL_TOL = 2e-2
PARALLEL_LOSS_TOL = 1e-3
RING_CHUNKS = 4
# steps of each Trainer run of the parallel and parallel_j2 phases: the
# window loss at step 10 held against the train
# phases', and at K = 5 two groups (two eager warm-ups, the capture, and
# replays after it)
PARALLEL_STEPS = 10


def attention_check(torch, fn, want_fn, inputs, cotangent):
    """``fn`` and ``want_fn`` forward and backward on the same inputs: the
    largest difference of the output and of each gradient, each over the
    largest magnitude of the reference's."""
    errs = {}
    results = []
    for f in (fn, want_fn):
        q, k, v = (t.detach().clone().requires_grad_() for t in inputs)
        out = f(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), cotangent)
        results.append([out.detach()] + [g.detach() for g in grads])
    for name, got, want in zip(("out", "dq", "dk", "dv"), *results):
        got, want = got.float(), want.float()
        scale = want.abs().max().clamp_min(1e-30)
        errs[name] = ((got - want).abs().max() / scale).item()
        if not torch.isfinite(got).all():
            errs[name] = float("inf")
    return errs


def phase_parallel(torch, np, fa, k1, k5):
    """The parallelism slice on one card: ``Trainer(mesh=build_mesh(
    keep_trivial_axes=True), param_sharding="fsdp")`` trains the flash LM
    10 steps at K = 1 and at K = 5 from the train phase's init and stream
    (the mesh is a one-process world, every axis of size 1, so every leaf
    replicates), its loss at step 10 against the dense runs'
    and its flash launches against the kernels the card executed; then
    ``ring_attention`` and ``ulysses_attention(impl="flash")`` forward and
    backward on the flagship's attention shape against the plain
    contraction and the flash op, and the ring recurrence chained over 4
    sequence chunks against full attention."""
    import functools

    import torch.distributed as dist

    from tensorflowonspark_torch import train
    from tensorflowonspark_torch.models import get_model, transformer
    from tensorflowonspark_torch.parallel import mesh as mesh_mod, ring

    t_start = time.perf_counter()
    vocab, layers = LM_CONFIG["vocab_size"], LM_CONFIG["num_layers"]
    heads, head_dim = LM_CONFIG["num_heads"], LM_CONFIG["head_dim"]
    mesh = mesh_mod.build_mesh(keep_trivial_axes=True)
    try:
        model = get_model("transformer_lm", mesh=mesh, **LM_CONFIG)
        model.init_weights(torch.Generator().manual_seed(0))
        init = dict(model.state_dict())
        flash_flops = 7 * SEQ * SEQ * head_dim * TRAIN_BATCH * heads * layers
        runs = {}
        for k in (1, MEGA_K):
            curve = LossCurve()
            trainer = train.Trainer(
                transformer.loss_fn(model), init,
                functools.partial(torch.optim.Adam, lr=LR),
                compute_dtype=torch.bfloat16, batch_size=TRAIN_BATCH,
                log_steps=LOG_STEPS, extra_step_flops=flash_flops,
                summary_writer=curve, mesh=mesh, param_sharding="fsdp")
            feed = NgramFeed(np, 0, TRAIN_BATCH, SEQ, vocab)
            torch.cuda.synchronize()
            fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
            t0 = time.perf_counter()                  # the path starts
            _, executed = counted_on_device(torch, lambda: trainer.fit_feed(
                feed, max_steps=PARALLEL_STEPS, steps_per_call=k))
            fit_s = time.perf_counter() - t0
            launches = launches_of(fa)                # ... and ends
            checked = [LOG_STEPS * (i + 1)
                       for i in range(PARALLEL_STEPS // LOG_STEPS)]
            losses = [curve.losses.get(step) for step in checked]
            runs["k%d" % k] = {
                "steps": trainer.state.step, "fit_feed_s": fit_s,
                "launches": launches, "device_launches": executed,
                "losses": losses,
                "loss_diff_vs_train": [
                    None if a is None else abs(a - b)
                    for a, b in zip(losses, k1["window_losses"])],
                "graphs": len(trainer._graphs),
                "sharded_leaves": (0 if trainer.state.sharding is None
                                   else len(trainer.state.sharding.names))}
            del trainer

        # the sequence-parallel contractions on this card's mesh (seq axis
        # of 1) at the flagship's attention shape
        gen = torch.Generator(device="cuda").manual_seed(11)
        inputs = [torch.randn(PARALLEL_SHAPE, device="cuda", generator=gen,
                              dtype=torch.bfloat16) for _ in range(3)]
        cotangent = torch.randn(PARALLEL_SHAPE, device="cuda", generator=gen,
                                dtype=torch.bfloat16)

        def full(q, k, v):
            return ring.reference_attention(q, k, v, causal=True)

        def flash(q, k, v):
            return fa.flash_attention(q, k, v, causal=True)

        def ring_fn(q, k, v):
            return ring.ring_attention(q, k, v, mesh, causal=True)

        def ulysses_flash(q, k, v):
            return ring.ulysses_attention(q, k, v, mesh, causal=True,
                                          impl="flash")

        def chained(q, k, v):
            return ring.chained_ring_attention(q, k, v, RING_CHUNKS,
                                               causal=True)

        checks = {"ring_vs_full": attention_check(torch, ring_fn, full,
                                                  inputs, cotangent),
                  "chained_ring_vs_full": attention_check(
                      torch, chained, full, inputs, cotangent),
                  "ulysses_flash_vs_flash": attention_check(
                      torch, ulysses_flash, flash, inputs, cotangent),
                  "ulysses_flash_vs_full": attention_check(
                      torch, ulysses_flash, full, inputs, cotangent)}
        torch.cuda.synchronize()
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0

        def ulysses_step():
            q, k, v = (t.detach().clone().requires_grad_() for t in inputs)
            torch.autograd.grad(ulysses_flash(q, k, v), (q, k, v), cotangent)

        _, ulysses_executed = counted_on_device(torch, ulysses_step)
        ulysses_launches = launches_of(fa)
        times = {name: time_ms(torch, lambda f=f: f(*inputs), iters=5)
                 for name, f in (("ring_fwd", ring_fn),
                                 ("ulysses_flash_fwd", ulysses_flash),
                                 ("chained_ring_fwd", chained),
                                 ("full_fwd", full))}
        del inputs, cotangent
    finally:
        dist.destroy_process_group()

    expected = layers * PARALLEL_STEPS
    row = {"phase": "parallel", "mesh": dict(zip(mesh.mesh_dim_names,
                                                 mesh.shape)),
           "param_sharding": "fsdp", "runs": runs,
           "train_window_losses": k1["window_losses"],
           "train_k5_losses": k5["losses"],
           "loss_tol": PARALLEL_LOSS_TOL, "expected_launches": expected,
           "attention_shape": list(PARALLEL_SHAPE), "dtype": "bfloat16",
           "checks": checks, "tol": PARALLEL_TOL,
           "ring_chunks": RING_CHUNKS,
           "ulysses_flash_launches": ulysses_launches,
           "ulysses_flash_device_launches": ulysses_executed,
           "forward_ms": times, "seconds": time.perf_counter() - t_start}
    emit(row)
    for name, run in runs.items():
        if run["steps"] != PARALLEL_STEPS:
            raise AssertionError("the fsdp trainer ({}) took {} steps, "
                                 "expected {}".format(name, run["steps"],
                                                      PARALLEL_STEPS))
        if any(n != expected for n in list(run["launches"].values())
               + list(run["device_launches"].values())):
            raise AssertionError(
                "the fsdp trainer ({}) launched {} and the card executed "
                "{}, expected {} each".format(name, run["launches"],
                                              run["device_launches"],
                                              expected))
        if not all(d is not None and d <= PARALLEL_LOSS_TOL
                   for d in run["loss_diff_vs_train"]):
            raise AssertionError("the fsdp trainer's losses ({}) differ "
                                 "from the train phase's: {}".format(
                                     name, run["loss_diff_vs_train"]))
    bad = {(check, name): err for check, errs in checks.items()
           for name, err in errs.items() if not err <= PARALLEL_TOL}
    if bad:
        raise AssertionError("sequence-parallel attention disagrees: "
                             "{}".format(bad))
    if any(n != 1 for n in list(ulysses_launches.values())
           + list(ulysses_executed.values())):
        raise AssertionError("ulysses_attention(impl='flash') launched {} "
                             "and the card executed {}, expected 1 "
                             "each".format(ulysses_launches,
                                           ulysses_executed))
    return row


# the parallelism slice's second half on one card: gpipe's microbatches of
# the LM's blocks, and the MoE layer checks' tolerance (bf16 products in
# another order or on another batch split: 2e-2 of the largest value or
# gradient, the parallel phase's)
GPIPE_MICRO = 4
J2_TOL = PARALLEL_TOL
# the MoE run's rows go over data, fsdp and expert (the LM twin's layout)
J2_EP_BATCH_AXES = ("data", "fsdp", "expert")


def _max_rel(torch, got, want):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return float("inf")
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def _j2_train(torch, np, fa, model, init, tree, mesh, config, k, feed_seed):
    """``Trainer(mesh=mesh, param_sharding=tree)`` on ``model`` from
    ``init``: ``PARALLEL_STEPS`` of the train phases' stream through
    ``fit_feed`` at ``k`` steps a dispatch, under the launch-counting
    profiler; the per-step losses, the counters and the kernels the card
    executed, peak memory and the K-step dispatch's graphs."""
    import functools

    from tensorflowonspark_torch import train
    from tensorflowonspark_torch.models import transformer

    heads, head_dim = config["num_heads"], config["head_dim"]
    flash_flops = (7 * SEQ * SEQ * head_dim * TRAIN_BATCH * heads
                   * config["num_layers"])
    curve = LossCurve()
    torch.cuda.reset_peak_memory_stats()
    trainer = train.Trainer(
        transformer.loss_fn(model), init,
        functools.partial(torch.optim.Adam, lr=LR),
        compute_dtype=torch.bfloat16, batch_size=TRAIN_BATCH,
        log_steps=LOG_STEPS, extra_step_flops=flash_flops,
        summary_writer=curve, mesh=mesh, param_sharding=tree)
    feed = NgramFeed(np, feed_seed, TRAIN_BATCH, SEQ, config["vocab_size"])
    torch.cuda.synchronize()
    fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    t0 = time.perf_counter()                          # the path starts
    _, executed = counted_on_device(torch, lambda: trainer.fit_feed(
        feed, max_steps=PARALLEL_STEPS, steps_per_call=k))
    fit_s = time.perf_counter() - t0
    launches = launches_of(fa)                        # ... and ends
    run = {"steps": trainer.state.step, "fit_feed_s": fit_s,
           "launches": launches, "device_launches": executed,
           "losses": [curve.losses.get(step)
                      for step in range(1, PARALLEL_STEPS + 1)],
           "graphs": len(trainer._graphs),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "sharded_leaves": (0 if trainer.state.sharding is None
                              else len(trainer.state.sharding.names))}
    del trainer
    torch.cuda.empty_cache()
    return run


def phase_parallel_j2(torch, np, fa, k1, moe):
    """The parallelism slice's second half on one card, in a one-process
    world whose every axis is 1 (the code paths and the kernels; the
    collectives run on four cards, tests/test_torch_nccl_cuda.py): the
    flagship flash LM under ``Trainer(mesh=build_mesh(MeshSpec(tensor=1,
    pipe=1), keep_trivial_axes=True), param_sharding=tp_param_shardings(
    ...))`` (its heads- and MLP-split path) and the MoE flash LM with
    ``ep_mode="shard_map"`` under ``merge_ep_shardings``, each 10 steps at
    K = 1 and K = 5 from the train phases' inits and stream, their losses at
    step 10 against the train and ``moe_train`` phases' and
    their flash launches against the kernels the card executed; then
    ``moe_ffn`` forward and backward at the flagship MoE layer's shape
    against ``MoEMlp`` (gspmd) and its fp32 products, and ``gpipe`` with
    one stage over the LM's blocks against the blocks in sequence."""
    import torch.distributed as dist

    from tensorflowonspark_torch.models import get_model, transformer
    from tensorflowonspark_torch.parallel import ep, pp, tp
    from tensorflowonspark_torch.parallel import mesh as mesh_mod

    t_start = time.perf_counter()
    mesh = mesh_mod.build_mesh(mesh_mod.MeshSpec(tensor=1, pipe=1),
                               keep_trivial_axes=True)
    checked = [LOG_STEPS * (i + 1) for i in range(PARALLEL_STEPS // LOG_STEPS)]
    moe_ref = [moe["k1"]["losses"][step - 1] for step in checked]
    try:
        runs = {}
        model = get_model("transformer_lm", mesh=mesh, **LM_CONFIG)
        model.init_weights(torch.Generator().manual_seed(0))
        init = dict(model.state_dict())
        tree = tp.tp_param_shardings(init, mesh, views=model.flax_views())
        for k in (1, MEGA_K):
            runs["tp_k%d" % k] = _j2_train(torch, np, fa, model, init, tree,
                                           mesh, LM_CONFIG, k, 0)
        del model, init
        # rows over data, fsdp and expert (the LM twin's layout): the
        # model's choice, which the Trainer adopts
        moe_model = get_model("transformer_lm", mesh=mesh,
                              ep_mode="shard_map",
                              ep_batch_axes=J2_EP_BATCH_AXES, **MOE_CONFIG)
        moe_model.init_weights(torch.Generator().manual_seed(0))
        moe_init = dict(moe_model.state_dict())
        moe_tree = ep.merge_ep_shardings({}, moe_init, mesh)
        for k in (1, MEGA_K):
            runs["ep_k%d" % k] = _j2_train(
                torch, np, fa, moe_model, moe_init, moe_tree, mesh,
                MOE_CONFIG, k, 0)
        del moe_model, moe_init
        for name, run in runs.items():
            ref = k1["window_losses"] if name.startswith("tp") else moe_ref
            run["losses_at"] = [run["losses"][step - 1] for step in checked]
            run["loss_diff_vs_ref"] = [
                None if a is None or b is None else abs(a - b)
                for a, b in zip(run["losses_at"], ref)]

        # moe_ffn against MoEMlp (gspmd) and its fp32 products at the
        # flagship MoE layer's shape
        d_model = MOE_CONFIG["num_heads"] * MOE_CONFIG["head_dim"]
        experts = MOE_CONFIG["num_experts"]
        gen = torch.Generator(device="cuda").manual_seed(12)
        layer = transformer.MoEMlp(d_model, experts, dtype=torch.bfloat16)
        layer = layer.cuda()
        with torch.no_grad():
            layer.router.reset_parameters(gen)
            layer.reset_parameters(gen)
        x = torch.randn(TRAIN_BATCH, SEQ, d_model, device="cuda",
                        generator=gen).to(torch.bfloat16)
        cot = torch.randn(TRAIN_BATCH, SEQ, d_model, device="cuda",
                          generator=gen).to(torch.bfloat16)
        names = ("router.weight", "router.bias", "w1", "b1", "w2", "b2")

        def layer_grads(fn, dtype):
            params = {n: p.detach().clone().requires_grad_()
                      for n, p in layer.named_parameters()}
            xs = x.detach().to(dtype).requires_grad_()
            y, aux = fn(xs, params)
            grads = torch.autograd.grad(
                (y.float() * cot.float()).sum() + aux,
                [xs] + [params[n] for n in names])
            return [y.detach(), aux.detach()] + [g.detach() for g in grads]

        def shard_map_fn(xs, params):
            return ep.moe_ffn(xs, params, mesh, experts, dtype=torch.bfloat16,
                              batch_axes=J2_EP_BATCH_AXES)

        def gspmd_fn(xs, params):
            return torch.func.functional_call(layer, params, (xs,))

        def plain_fn(xs, params):
            fp32 = {n: p.float() for n, p in params.items()}
            dispatch, prob, (fraction, mean_prob) = ep._route(
                xs, ep.router_logits(xs, fp32["router.weight"],
                                     fp32["router.bias"]),
                experts, layer.capacity(SEQ))
            expert_in = torch.einsum("gsec,gsd->gecd", dispatch, xs)
            out = ep.expert_ffn(expert_in, fp32["w1"], fp32["b1"],
                                fp32["w2"], fp32["b2"], torch.float32)
            combine = dispatch * prob[..., None, None]
            y = torch.einsum("gsec,gecd->gsd", combine, out)
            return y, experts * (fraction * mean_prob).sum()

        got = layer_grads(shard_map_fn, torch.bfloat16)
        refs = {"gspmd": layer_grads(gspmd_fn, torch.bfloat16),
                "plain_fp32": layer_grads(plain_fn, torch.float32)}
        labels = ("y", "aux", "x") + names
        moe_checks = {ref: {label: _max_rel(torch, a, b)
                            for label, a, b in zip(labels, got, want)}
                      for ref, want in refs.items()}
        moe_ms = {
            "moe_ffn_fwd": time_ms(torch, lambda: shard_map_fn(
                x, dict(layer.named_parameters())), iters=5),
            "moe_mlp_fwd": time_ms(torch, lambda: layer(x), iters=5)}
        del layer, got, refs

        # gpipe with one stage: the LM's blocks as the stage, microbatches
        # of the batch, against the blocks applied to the whole batch
        lm = get_model("transformer_lm", **LM_CONFIG)
        lm.init_weights(torch.Generator().manual_seed(0))
        blocks = lm.blocks.cuda()

        def stage_fn(params, h):
            for i, block in enumerate(blocks):
                prefix = "%d." % i
                h, _ = torch.func.functional_call(
                    block, {n[len(prefix):]: v for n, v in params.items()
                            if n.startswith(prefix)}, (h,))
            return h

        params = {n: p.detach() for n, p in blocks.named_parameters()}
        h0 = torch.randn(TRAIN_BATCH, SEQ, d_model, device="cuda",
                         generator=gen).to(torch.bfloat16)
        hcot = torch.randn(TRAIN_BATCH, SEQ, d_model, device="cuda",
                           generator=gen).to(torch.bfloat16)
        probe = ("0.attn.qkv.weight", "%d.mlp_out.weight" % (
            len(blocks) - 1))

        def pipe_run(pipelined):
            leaves = {n: v.clone().requires_grad_() for n, v in
                      params.items()}
            hs = h0.detach().clone().requires_grad_()
            if pipelined:
                stacked = pp.stack_stage_params([leaves])
                out = pp.gpipe(stage_fn, stacked, pp.split_microbatches(
                    hs, GPIPE_MICRO), mesh).reshape(hs.shape)
            else:
                out = stage_fn(leaves, hs)
            grads = torch.autograd.grad(out, [hs] + [leaves[n]
                                                     for n in probe], hcot)
            return [out.detach()] + [g.detach() for g in grads]

        want = pipe_run(False)
        torch.cuda.synchronize()
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        got, gpipe_executed = counted_on_device(torch,
                                                lambda: pipe_run(True))
        gpipe_launches = launches_of(fa)
        gpipe_checks = {label: _max_rel(torch, a, b) for label, a, b in zip(
            ("out", "dx") + probe, got, want)}
        del blocks, lm, params, got, want
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    expected = {"tp": LM_CONFIG["num_layers"] * PARALLEL_STEPS,
                "ep": MOE_CONFIG["num_layers"] * PARALLEL_STEPS}
    gpipe_expected = LM_CONFIG["num_layers"] * GPIPE_MICRO
    # K = 1 writes the loss at window ends, K = 5 every step: the steps
    # both wrote
    k5_vs_k1 = {kind: max([abs(a - b) for a, b in zip(
        runs[kind + "_k1"]["losses"], runs[kind + "_k5"]["losses"])
        if a is not None and b is not None] or [float("inf")])
        for kind in ("tp", "ep")}
    row = {"phase": "parallel_j2",
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "runs": runs, "checked_steps": checked,
           "train_window_losses": k1["window_losses"],
           "moe_train_losses": moe_ref, "loss_tol": PARALLEL_LOSS_TOL,
           "expected_launches": expected,
           "k5_vs_k1_max_loss_diff": k5_vs_k1,
           "k5_equals_k1_bitwise": {
               kind: k5_vs_k1[kind] == 0.0 for kind in ("tp", "ep")},
           "moe_ffn_shape": [TRAIN_BATCH, SEQ, d_model],
           "moe_ffn_checks": moe_checks, "moe_ffn_ms": moe_ms,
           "gpipe": {"stages": 1, "microbatches": GPIPE_MICRO,
                     "shape": [TRAIN_BATCH, SEQ, d_model],
                     "checks": gpipe_checks, "launches": gpipe_launches,
                     "device_launches": gpipe_executed,
                     "expected_launches": gpipe_expected},
           "tol": J2_TOL, "seconds": time.perf_counter() - t_start}
    emit(row)
    for name, run in runs.items():
        want = expected[name[:2]]
        if run["steps"] != PARALLEL_STEPS:
            raise AssertionError("parallel_j2 {} took {} steps, expected "
                                 "{}".format(name, run["steps"],
                                             PARALLEL_STEPS))
        if any(n != want for n in list(run["launches"].values())
               + list(run["device_launches"].values())):
            raise AssertionError(
                "parallel_j2 {} launched {} and the card executed {}, "
                "expected {} each".format(name, run["launches"],
                                          run["device_launches"], want))
        if not all(d is not None and d <= PARALLEL_LOSS_TOL
                   for d in run["loss_diff_vs_ref"]):
            raise AssertionError("parallel_j2 {}: losses {} differ from "
                                 "the reference's: {}".format(
                                     name, run["losses_at"],
                                     run["loss_diff_vs_ref"]))
    for name in ("tp_k%d" % MEGA_K, "ep_k%d" % MEGA_K):
        if runs[name]["graphs"] != 1:
            raise AssertionError("parallel_j2 {} captured {} graphs, "
                                 "expected 1".format(name,
                                                     runs[name]["graphs"]))
    if any(d > MEGA_LOSS_TOL for d in k5_vs_k1.values()):
        raise AssertionError("parallel_j2: K = 5 losses differ from K = "
                             "1's by {}".format(k5_vs_k1))
    bad = {(ref, label): err for ref, errs in moe_checks.items()
           for label, err in errs.items() if not err <= J2_TOL}
    bad.update({("gpipe", label): err for label, err in gpipe_checks.items()
                if not err <= J2_TOL})
    if bad:
        raise AssertionError("parallel_j2: moe_ffn / gpipe disagree: "
                             "{}".format(bad))
    if any(n != gpipe_expected for n in list(gpipe_launches.values())
           + list(gpipe_executed.values())):
        raise AssertionError("gpipe launched {} and the card executed {}, "
                             "expected {} each".format(
                                 gpipe_launches, gpipe_executed,
                                 gpipe_expected))
    return row


# ---------------------------------------------------------------------------
# device observability: the observatory, cluster captures, the step
# profiler and the transfer guard
# ---------------------------------------------------------------------------

# the observed cluster: one SPARK-mode executor trains the flagship LM from
# rows that a driver thread streams in partitions of 64 until the phase is
# done; windows of 20 steps; beats every 0.5 s, and 60 missed beats (30 s)
# before a node counts as dead, as the first capture's profiler start-up
# in a fresh process can hold the node for seconds
OBS_PART_ROWS = 64
OBS_LOG_STEPS = 20
OBS_HEARTBEAT_SECS = 0.5
OBS_HEARTBEAT_MISSES = 60
# the K = 1 stretch runs until the driver's switch (after its captures at
# K = 1) or this many steps; each capture spans this many dispatches
OBS_K1_MAX_STEPS = 1500
OBS_CAPTURE_STEPS = 5
# dispatches at K = 5 before its capture: the first warms up and captures
# the graph, the rest replay it (3 windows of OBS_LOG_STEPS, for the step
# time with the observatory on)
OBS_K5_DISPATCHES = 12
OBS_DIRECT_CAPTURE_MS = 500
# the driver's waits: to the first steady windows (bring-up included), for
# a capture to land, for K = 5's graph to replay
OBS_READY_SECS = 300
OBS_CAPTURE_SECS = 180
OBS_SCRAPE_SECS = 0.1
# the MFU gauge against the analytic count over the same window: the
# gauge's FLOPs are FlopCounterMode's count plus the flash kernels'
# analytic ones, and the analytic model count is 3 x the forward's matmuls
# plus the same flash figure: on the card both came out equal (PERF.md), so
# 5% holds any timing rounding and a wrong count or peak is off by far more
OBS_MFU_RTOL = 0.05
# the step profiler over steps 10-12 of a fit_supervised run at K = 1: its
# trace holds exactly the kernels of those three dispatches
STEP_PROFILE = "10,12"
STEP_PROFILE_STEPS = 15
# then, late in this long-lived process, more step-profiler windows of
# three eager steps each, alternately with the profiler's edge kernels (as
# shipped, every one held exact) and with its idle edges alone (counted)
EDGE_WINDOWS = 1
EDGE_WINDOW = "1,3"
# the guarded train path at K = 1 and K = 5 on device-resident batches,
# against the same path unguarded: the same kernels on the same data, so
# the losses and params are held bit for bit
GUARD_STEPS = 10
GUARD_TIMED_STEPS = 10
GUARD_ROUNDS = 2


# text exposition 0.0.4: metric names and one sample line
METRIC_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
METRIC_SAMPLE_RE = re.compile(
    r'([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (-?[0-9.e+-]+|[+-]Inf|NaN)\Z')


def parse_exposition(text):
    """``({family: type}, {sample line name + labels: value})`` of a
    Prometheus text exposition (0.0.4); raises on any line that is neither
    a well-formed HELP/TYPE comment nor a sample, on a family typed twice
    and on a family with HELP but no TYPE."""
    families, helped, samples = {}, set(), {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            name = line.split()[2]
            if not METRIC_NAME_RE.match(name):
                raise AssertionError("bad HELP line: %r" % line)
            helped.add(name)
        elif line.startswith("# TYPE "):
            _, _, name, mtype = line.split()[:4]
            if (not METRIC_NAME_RE.match(name) or name in families
                    or mtype not in ("counter", "gauge", "histogram")):
                raise AssertionError("bad TYPE line: %r" % line)
            families[name] = mtype
        else:
            found = METRIC_SAMPLE_RE.match(line)
            if not found:
                raise AssertionError("unparseable sample line: %r" % line)
            samples[found.group(1) + (found.group(2) or "")] = float(
                found.group(3))
    if helped != set(families):
        raise AssertionError("HELP and TYPE families differ: {}".format(
            sorted(helped ^ set(families))))
    return families, samples


def flash_kernel_counts(events):
    """The flash kernels a Chrome trace's device events hold, by the names
    of the kernels line (fp32 and bf16 variants together)."""
    counts = dict.fromkeys(FLASH_KERNELS, 0)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            for name, fragment in FLASH_KERNELS.items():
                if fragment in str(e.get("name", "")):
                    counts[name] += 1
    return counts


class Stretches(object):
    """One ShardedFeed's K-step groups for two ``fit_feed`` calls on one
    node: :meth:`batches` takes the groups apart into single steps (the K =
    1 stretch) until the driver's ``switch`` file exists at a group
    boundary (or ``max_steps``); :meth:`grouped_batches` then hands on the
    rest as they come (the K = 5 stretch).  Nothing is dropped between the
    two: one prefetch thread, one consumer."""

    def __init__(self, sharded, k, switch, max_steps):
        self.groups = sharded.grouped_batches(k)
        self.switch, self.max_steps = switch, max_steps

    def batches(self):
        steps = 0
        for kind, batch, mask in self.groups:
            if kind == "multi":
                for i in range(mask.shape[0]):
                    yield {n: t[i] for n, t in batch.items()}, mask[i]
                steps += mask.shape[0]
            else:
                yield batch, mask
                steps += 1
            if os.path.exists(self.switch) or steps >= self.max_steps:
                return

    def grouped_batches(self, k):
        yield from self.groups


def observe_main(args, ctx):
    """The observed node's user fn, run in the child the node forked: the
    LM from the node's feed, steady at K = 1 until the driver's switch,
    then K = 5 to the end of the feed; the flash launch counters zeroed
    before and read after both; reports each dispatch's wall-clock end and
    each stretch's windows to ``args["report"]``."""
    import functools
    import importlib
    import traceback

    import faulthandler

    # a crash of this process (seen twice: its /capture endpoint gone
    # mid-request) prints every thread's Python stack to stderr
    faulthandler.enable(all_threads=True)
    report = {}
    try:
        import torch

        from tensorflowonspark_torch import profiler, train
        from tensorflowonspark_torch.models import get_model, transformer
        from tensorflowonspark_torch.ops import _build
        from tensorflowonspark_torch.parallel import infeed

        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        # the node warmed the profiler before this fn (its seconds)
        report["profiler_preload_s"] = profiler.preload_secs
        device = ctx.initialize_distributed(device=args["device"])
        if device.type == "cuda":
            for name in _build.build():     # the parent built them: loads
                _build.load(name)
        cfg = args["config"]
        model = get_model("transformer_lm", **cfg)
        model.init_weights(torch.Generator().manual_seed(0))
        trainer = train.Trainer(
            transformer.loss_fn(model), dict(model.state_dict()),
            functools.partial(torch.optim.Adam, lr=args["lr"]),
            compute_dtype=getattr(torch, cfg["dtype"]),
            batch_size=args["batch"], log_steps=args["log_steps"],
            extra_step_flops=args["flash_flops"], device=device)
        feed = Stretches(infeed.ShardedFeed(
            ctx.get_data_feed(), args["batch"],
            transform=lambda t: {"tokens": t}, device=device),
            MEGA_K, args["switch"], OBS_K1_MAX_STEPS)
        ends = []

        def on_steps(step):
            ends.append((time.time(), step))

        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        trainer.fit_feed(feed, on_steps=on_steps)          # the path starts
        k1_steps = trainer.state.step
        k1_windows = len(trainer.history.timestamp_log)
        stats = trainer.fit_feed(feed, steps_per_call=MEGA_K,
                                 on_steps=on_steps)
        launches = launches_of(fa)                         # ... and ends
        report.update({"launches": launches, "k1_steps": k1_steps,
                       "steps": trainer.state.step, "dispatch_ends": ends,
                       "windows": trainer.history.timestamp_log,
                       "k1_windows": k1_windows,
                       "megastep": stats["megastep"],
                       "graphs": len(trainer._graphs),
                       "step_flops": trainer.history.step_flops})
        # the last beats carry the final counters before the roster BYEs
        time.sleep(3 * OBS_HEARTBEAT_SECS)
    except Exception:
        report["error"] = traceback.format_exc()
        raise
    finally:
        with open(args["report"] + ".tmp", "w") as f:
            json.dump(report, f)
        os.replace(args["report"] + ".tmp", args["report"])


#: the GETs that failed and were tried again (see http_get); the wall line
#: reports them
HTTP_RETRIES = []
HTTP_TRIES = 3


def http_get(url, timeout=60):
    """``(body, headers)`` of one GET.  A connection the server dropped
    unanswered, or a 5xx answer, is printed with its body, kept in
    ``HTTP_RETRIES`` and tried again, ``HTTP_TRIES`` times in all; a
    ``/profile`` trigger, which starts a capture, is tried once."""
    import urllib.error
    import urllib.request

    tries = 1 if "/profile?" in url else HTTP_TRIES
    for attempt in range(1, tries + 1):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                return r.read(), dict(r.headers)
        except urllib.error.HTTPError as e:
            if e.code < 500:
                raise
            error = "HTTP {}: {}".format(e.code, e.read()[:2000].decode(
                "utf-8", "replace"))
            last = e
        except ConnectionResetError as e:   # RemoteDisconnected too
            error, last = repr(e), e
        print("chip_smoke: GET {} failed on try {} of {}: {}".format(
            url, attempt, tries, error), file=sys.stderr, flush=True)
        if attempt == tries:
            raise last
        HTTP_RETRIES.append({"url": url, "try": attempt, "error": error})
        time.sleep(0.5)


def node_metrics(base):
    """One ``/metrics`` scrape: the text and its parsed families and
    samples (raises if any line does not parse)."""
    text = http_get(base + "/metrics")[0].decode()
    families, samples = parse_exposition(text)
    return text, families, samples


def wait_until(what, fn, seconds, every=OBS_SCRAPE_SECS):
    deadline = time.monotonic() + seconds
    while True:
        got = fn()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError("waited {} s for {}".format(seconds, what))
        time.sleep(every)


def cluster_capture(base, steps):
    """``GET /profile?steps=`` and wait until its manifest is written;
    returns the trigger's answer, the manifest and the seconds to it."""
    t0 = time.perf_counter()
    out = json.loads(http_get(base + "/profile?steps=%d" % steps)[0])

    def done():
        last = json.loads(http_get(base + "/status")[0]).get("last_capture")
        return (last if last and last["capture_id"] == out["capture_id"]
                and last["complete"] else None)

    wait_until("capture " + out["capture_id"], done, OBS_CAPTURE_SECS, 0.2)
    with open(os.path.join(out["dir"], "capture.json")) as f:
        manifest = json.load(f)
    return out, manifest, time.perf_counter() - t0


def median_or_none(xs):
    return median(xs) if xs else None


def step_costs(report, captures):
    """Per-step ms of the node's dispatches at K = 1 and K = 5: the
    windows (of OBS_LOG_STEPS) that overlap no capture, its profiler's
    start-up included, the first window of each stretch left out; and the
    dispatch intervals wholly inside a capture's window.  ``captures``
    hold each capture's wall-clock ``window`` and ``start_secs``."""
    spans = [(c["window"][0] - c["start_secs"], c["window"][1])
             for c in captures]

    def overlaps(a, b):
        return any(a < hi and b > lo for lo, hi in spans)

    out = {}
    ends = report["dispatch_ends"]
    k1_steps = report["k1_steps"]
    log, n1 = report["windows"], report["k1_windows"]
    for name, log in (("k1", log[:n1]), ("k5", log[n1 - 1:])):
        clean = [1e3 * (t1 - t0) / (s1 - s0)
                 for (s0, t0), (s1, t1) in list(zip(log, log[1:]))[1:]
                 if not overlaps(t0, t1)]
        inside = [1e3 * (t1 - t0) / (s1 - s0)
                  for (t0, s0), (t1, s1) in zip(ends, ends[1:])
                  if (s1 <= k1_steps) == (name == "k1") and s1 > s0
                  and any(lo <= t0 and t1 <= hi for lo, hi in spans)]
        out[name] = {"observatory_on_ms_per_step": median_or_none(clean),
                     "observatory_on_windows": len(clean),
                     "capture_in_flight_ms_per_step": median_or_none(inside),
                     "capture_in_flight_dispatches": len(inside)}
    return out


def phase_observability_cluster(torch, np, metrics, clustered, mega_cluster,
                                device=None):
    """The flagship LM in one SPARK-mode executor under ``cluster.run(
    observatory=True, telemetry=True, profiler=True)``: ``/metrics``
    scraped mid-run (it parses; ``tfos_up`` 1; the step-time histogram and
    the rates; the MFU gauge against the analytic count over the same
    window), ``/status``'s profiler address, ``GET /profile?steps=5`` at K
    = 1 and during a K = 5 stretch (graph replays), each merged with the
    telemetry host traces and holding all three flash kernels, and the
    node's ``/capture`` dialed directly."""
    import threading

    from tensorflowonspark_torch import backend, cluster, profiling

    vocab, layers = LM_CONFIG["vocab_size"], LM_CONFIG["num_layers"]
    heads, head_dim = LM_CONFIG["num_heads"], LM_CONFIG["head_dim"]
    d_model = heads * head_dim
    flash_flops = 7 * SEQ * SEQ * head_dim * TRAIN_BATCH * heads * layers
    analytic_flops = (3 * TRAIN_BATCH * SEQ * (24 * d_model * d_model * layers
                                              + 2 * d_model * vocab)
                      + flash_flops)
    peak = metrics.peak_flops_per_device(device)
    if device is None:
        torch.cuda.empty_cache()   # the earlier phases' cached blocks
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        log_dir = os.path.join(tmp, "logs")
        args = {"config": LM_CONFIG, "device": device, "lr": LR,
                "batch": TRAIN_BATCH, "log_steps": OBS_LOG_STEPS,
                "flash_flops": flash_flops,
                "switch": os.path.join(tmp, "switch"),
                "report": os.path.join(tmp, "report.json")}
        stop_feed = threading.Event()
        fed = {"rows": 0}

        def partitions():
            seed = 100
            while not stop_feed.is_set():
                seed += 1
                fed["rows"] += OBS_PART_ROWS
                yield list(lm_rows(np, seed, OBS_PART_ROWS, SEQ, vocab))

        b = backend.LocalBackend(1)
        try:
            c = cluster.run(b, observe_main, args, num_executors=1,
                            input_mode=cluster.InputMode.SPARK,
                            log_dir=log_dir, telemetry=True,
                            observatory=True, profiler=True,
                            heartbeat_interval=OBS_HEARTBEAT_SECS,
                            heartbeat_misses=OBS_HEARTBEAT_MISSES)
            base = "http://127.0.0.1:%d" % c.observatory.addr[1]
            feed_errors = []

            def feed():
                try:
                    c.train(partitions())
                except Exception as e:
                    feed_errors.append(repr(e))

            feeder = threading.Thread(target=feed, daemon=True)
            feeder.start()
            try:
                def windows_closed(n):
                    return node_metrics(base)[2].get(
                        'tfos_step_ms_count{executor="0"}', 0) >= (
                            n * OBS_LOG_STEPS)

                wait_until("two steady windows at K = 1",
                           lambda: windows_closed(2), OBS_READY_SECS)
                # scrapes at heartbeat cadence until two consecutive
                # samples differ by one closed window: its step time and
                # the MFU gauge folded from that same window
                scrapes, pair = [], None
                deadline = time.monotonic() + 60
                while pair is None and time.monotonic() < deadline:
                    scrapes.append(node_metrics(base)[2])
                    if len(scrapes) > 1:
                        key = 'tfos_step_ms_count{executor="0"}'
                        if (scrapes[-1].get(key, 0) - scrapes[-2].get(key, 0)
                                == OBS_LOG_STEPS):
                            pair = scrapes[-2:]
                    time.sleep(OBS_SCRAPE_SECS)
                if pair is None:
                    raise AssertionError("no two scrapes one window apart")
                before, after = pair
                window_ms = (after['tfos_step_ms_sum{executor="0"}']
                             - before['tfos_step_ms_sum{executor="0"}']) / (
                                 OBS_LOG_STEPS)
                gauge = after.get('tfos_train_mfu_pct_max{executor="0"}')
                analytic_mfu = (100.0 * analytic_flops / peak / (
                    window_ms / 1e3) if peak else None)
                status = json.loads(http_get(base + "/status")[0])
                addresses = status.get("profiler_addresses")
                cap1, man1, cap1_s = cluster_capture(base,
                                                     OBS_CAPTURE_STEPS)
                # one more closed window before the direct capture, so
                # that it starts on a node back at steady steps
                closed = node_metrics(base)[2].get(
                    'tfos_step_ms_count{executor="0"}', 0) // OBS_LOG_STEPS
                wait_until("a window after the cluster capture",
                           lambda: windows_closed(closed + 1),
                           OBS_READY_SECS)
                try:
                    body, headers = http_get(
                        "http://%s/capture?duration_ms=%d" % (
                            addresses[0], OBS_DIRECT_CAPTURE_MS))
                except Exception as e:
                    node = (open(args["report"]).read()[-4000:]
                            if os.path.exists(args["report"])
                            else "no report")
                    raise AssertionError(
                        "the node's direct /capture failed ({!r}); the "
                        "node's report: {}".format(e, node))
                direct = flash_kernel_counts(json.loads(
                    gzip.decompress(body))["traceEvents"])
                direct_info = {k[len("X-Tfos-Capture-"):]: v
                               for k, v in headers.items()
                               if k.startswith("X-Tfos-Capture-")}
                # the K = 5 stretch: past the switch, and two dispatches
                # after the first at K = 5 (which warms up and captures)
                open(args["switch"], "w").close()
                dispatches = 'tfos_dispatch_count_total{executor="0"}'

                def at_k5():
                    s = node_metrics(base)[2]
                    return (s.get(dispatches) if s.get(
                        'tfos_train_steps_per_call_max{executor="0"}')
                        == MEGA_K else None)

                first_k5 = wait_until("K = 5", at_k5, OBS_READY_SECS)
                wait_until("K = 5 replays",
                           lambda: (node_metrics(base)[2].get(dispatches, 0)
                                    >= first_k5 + OBS_K5_DISPATCHES),
                           OBS_READY_SECS)
                cap2, man2, cap2_s = cluster_capture(base,
                                                     OBS_CAPTURE_STEPS)
                _, last_families, last_samples = node_metrics(base)
            finally:
                stop_feed.set()
                feeder.join(timeout=120)
            c.shutdown(grace_secs=1)
            report = wait_for_report(args["report"], CLUSTER_REPORT_SECS)
        finally:
            b.stop()
        merged = {}
        for name, cap in (("k1", cap1), ("k5", cap2)):
            payload = profiling.merge_capture(
                cap["dir"], telemetry_dir=os.path.join(log_dir, "telemetry"))
            events = payload["traceEvents"]
            merged[name] = {
                "flash_kernels": flash_kernel_counts(events),
                "events": len(events),
                "host_spans": sum(1 for e in events
                                  if e.get("name") == "train/dispatch"),
                "sources": payload["otherData"]["sources"]}
    phase_s = time.perf_counter() - t_start
    captures = {}
    for name, cap, man, secs in (("k1", cap1, man1, cap1_s),
                                 ("k5", cap2, man2, cap2_s)):
        node = man["nodes"]["0"]
        k = 1 if name == "k1" else MEGA_K
        captures[name] = dict(
            merged[name], capture_id=cap["capture_id"],
            request=cap["request"], errors=man["errors"],
            dispatches=node.get("steps"), steps=(node.get("steps") or 0) * k,
            expected_flash_kernels=layers * (node.get("steps") or 0) * k,
            elapsed_secs=node.get("elapsed_secs"),
            profiler_start_secs=node.get("start_secs"),
            artifact_bytes=node.get("artifact_bytes"),
            files_dropped=node.get("files_dropped", 0),
            all_threads=node.get("all_threads"),
            trigger_to_manifest_s=secs)
    direct_info["window"] = json.loads(direct_info["window"])
    direct_info["start-secs"] = float(direct_info["start-secs"])
    costs = step_costs(report, [man1["nodes"]["0"], man2["nodes"]["0"],
                                {"window": direct_info["window"],
                                 "start_secs": direct_info["start-secs"]}])
    costs["k1"]["neither_ms_per_step"] = clustered["steady_ms_per_step"]
    costs["k5"]["neither_ms_per_step"] = mega_cluster["steady_ms_per_step"]
    rates = sorted(n for n in last_families if n.endswith("_per_sec"))
    row = {"phase": "observability_cluster", "config": LM_CONFIG,
           "backend": "LocalBackend(1)", "input_mode": "SPARK",
           "rows_fed": fed["rows"], "feed_errors": feed_errors,
           "steps": report["steps"],
           "k1_steps": report["k1_steps"], "graphs": report["graphs"],
           "megastep": report["megastep"], "launches": report["launches"],
           "node_profiler_preload_s": report["profiler_preload_s"],
           "scrapes": len(scrapes) + 1,
           "metric_families": len(last_families),
           "tfos_up": last_samples.get('tfos_up{executor="0"}'),
           "step_histogram": last_families.get("tfos_step_ms"),
           "rate_gauges": len(rates),
           "mfu": {"gauge_pct": gauge, "window_ms_per_step": window_ms,
                   "analytic_step_flops": analytic_flops,
                   "counted_step_flops": report["step_flops"],
                   "peak_flops": peak, "analytic_pct": analytic_mfu,
                   "rtol": OBS_MFU_RTOL},
           "profiler_addresses": addresses,
           "captures": captures,
           "direct_capture": {"flash_kernels": direct,
                              "gzip_bytes": len(body), "info": direct_info},
           "step_cost": costs, "phase_s": phase_s}
    emit(row)
    if feed_errors:
        raise AssertionError("feeding the observed node failed: {}".format(
            feed_errors))
    if last_samples.get('tfos_up{executor="0"}') != 1:
        raise AssertionError("/metrics does not say the node is up")
    if (last_families.get("tfos_step_ms") != "histogram" or not rates
            or len(scrapes) < 2):
        raise AssertionError("/metrics lacks the step histogram or the "
                             "rates: {}".format(sorted(last_families)))
    if not (gauge and analytic_mfu
            and abs(gauge / analytic_mfu - 1) <= OBS_MFU_RTOL):
        raise AssertionError("the MFU gauge {} disagrees with the analytic "
                             "count's {} over the same window".format(
                                 gauge, analytic_mfu))
    if not (isinstance(addresses, list) and len(addresses) == 1):
        raise AssertionError("/status lists profiler addresses {}".format(
            addresses))
    for name, cap in list(captures.items()) + [("direct", {
            "flash_kernels": direct, "errors": {}})]:
        if cap["errors"] or not all(cap["flash_kernels"].values()):
            raise AssertionError("the {} capture holds flash kernels {}, "
                                 "errors {}".format(name,
                                                    cap["flash_kernels"],
                                                    cap["errors"]))
    if report["megastep"]["steps_per_call"] != MEGA_K or not report["graphs"]:
        raise AssertionError("the K = 5 stretch did not replay a graph: "
                             "{}".format(report["megastep"]))
    return row


class OnCard(object):
    """An NgramFeed's batches (and K-step stacks) moved to the card as the
    loop pulls them, outside the dispatch: what an infeed hands a guarded
    ``fit_feed``."""

    def __init__(self, torch, feed, device):
        self.torch, self.feed, self.device = torch, feed, device

    def _on_card(self, batch, mask):
        return ({"tokens": self.torch.from_numpy(batch["tokens"]).to(
            self.device)}, self.torch.from_numpy(mask).to(self.device))

    def batches(self):
        for batch, mask in self.feed.batches():
            yield self._on_card(batch, mask)

    def grouped_batches(self, k):
        while True:
            yield ("multi",) + self._on_card(*self.feed.next_group(k))


class Guarded(object):
    """A trainer whose ``step`` runs under the transfer guard, for
    :func:`interleaved_steady`."""

    def __init__(self, train, trainer):
        self.train, self.trainer = train, trainer

    def step(self, batch, mask):
        with self.train._TransferGuard("disallow"):
            return self.trainer.step(batch, mask)


def phase_observability(torch, np, fa, metrics, clustered, mega_cluster,
                        device=None):
    """Device observability: the observed cluster (above); then on this
    card the step profiler over steps 10-12 of ``fit_supervised`` at K = 1
    (the trace's flash kernels against the launch counters over the same
    dispatches), and the transfer guard: the guarded train path at K = 1
    and K = 5 against the unguarded one, bit for bit (at K = 5 with a
    cluster-style capture landing during the graph capture, held off until
    it ends), a loss with one implicit host->device copy raising under
    ``"disallow"`` and logged under ``"log"``, and the guard's cost a step
    at K = 1."""
    import functools
    import logging
    import threading

    from tensorflowonspark_torch import checkpoint, profiler, profiling, train
    from tensorflowonspark_torch.models import get_model, transformer

    cluster_row = phase_observability_cluster(torch, np, metrics, clustered,
                                              mega_cluster, device)
    t_start = time.perf_counter()
    vocab, layers = LM_CONFIG["vocab_size"], LM_CONFIG["num_layers"]
    heads, head_dim = LM_CONFIG["num_heads"], LM_CONFIG["head_dim"]
    model = get_model("transformer_lm", **LM_CONFIG)
    model.init_weights(torch.Generator().manual_seed(0))
    init = dict(model.state_dict())
    lm_loss = transformer.loss_fn(model)
    flash_flops = 7 * SEQ * SEQ * head_dim * TRAIN_BATCH * heads * layers
    dev = torch.device(device or "cuda")

    def new_trainer(loss=lm_loss, **kwargs):
        return train.Trainer(loss, init,
                             functools.partial(torch.optim.Adam, lr=LR),
                             compute_dtype=torch.bfloat16,
                             batch_size=TRAIN_BATCH, log_steps=LOG_STEPS,
                             extra_step_flops=flash_flops, device=dev,
                             **kwargs)

    def stream(seed=0):
        return OnCard(torch, NgramFeed(np, seed, TRAIN_BATCH, SEQ, vocab),
                      dev)

    # the step profiler: fit_supervised at K = 1, steps 10-12 traced
    class Counted(profiler.StepProfiler):
        """The step profiler, reading the launch counters as it starts and
        stops (after the card ran every queued step)."""

        def _start(self):
            super()._start()
            self.at_start = launches_of(fa)

        def stop(self):
            if self._active:
                profiler.synchronize()
                self.at_stop = launches_of(fa)
            super().stop()

    with tempfile.TemporaryDirectory() as tmp:
        prof = Counted(os.path.join(tmp, "trace"), STEP_PROFILE)
        ckpt = checkpoint.CheckpointManager(os.path.join(tmp, "ckpt"),
                                            save_interval_steps=0)
        trainer = new_trainer()
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        train.fit_supervised(trainer, stream, ckpt,          # path starts
                             max_steps=STEP_PROFILE_STEPS, profiler=prof)
        step_profiler_launches = launches_of(fa)            # ... and ends
        ckpt.close()
        del trainer
        with gzip.open(prof.trace_path, "rt") as f:
            traced = flash_kernel_counts(json.load(f)["traceEvents"])
        trace_bytes = os.path.getsize(prof.trace_path)
    window = {n: prof.at_stop[n] - prof.at_start[n] for n in traced}

    # more windows: the edge kernels against the idle edges alone
    trainer = new_trainer()
    batches = device_batches(torch, NgramFeed(np, 4, TRAIN_BATCH, SEQ,
                                              vocab), 5, dev)
    trainer.step(*batches[0])
    edge_kernels = profiler.EDGE_KERNELS
    edges = {"padded": [], "idle_only": []}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for i in range(2 * EDGE_WINDOWS):
                arm = "padded" if i % 2 == 0 else "idle_only"
                profiler.EDGE_KERNELS = edge_kernels if i % 2 == 0 else 0
                extra = Counted(os.path.join(tmp, str(i)), EDGE_WINDOW)
                for batch, mask in batches:
                    extra.on_step_begin()
                    trainer.step(batch, mask)
                    extra.on_step_end()
                with gzip.open(extra.trace_path, "rt") as f:
                    got = flash_kernel_counts(json.load(f)["traceEvents"])
                moved = {n: extra.at_stop[n] - extra.at_start[n]
                         for n in got}
                edges[arm].append({"moved": moved, "traced": got})
    finally:
        profiler.EDGE_KERNELS = edge_kernels
    del trainer, batches
    edge_lost = {arm: sum(w["moved"][n] - w["traced"][n]
                          for w in ws for n in w["moved"])
                 for arm, ws in edges.items()}

    # the guarded train path against the unguarded one, K = 1 and K = 5;
    # at K = 5 a capture asked for while the graph is captured (the first
    # hold of cuda_graph_lock: the warm-ups before it take no lock)
    guard_runs, landed = {}, {}
    for k in (1, MEGA_K):
        run = {}
        for guard in (None, "disallow"):
            curve = LossCurve()
            trainer = new_trainer(summary_writer=curve)
            capture = None
            if k > 1 and guard and dev.type == "cuda":
                def during_graph_capture():
                    deadline = time.monotonic() + 120
                    while (not profiling.cuda_graph_lock.locked()
                           and time.monotonic() < deadline):
                        time.sleep(0.0005)
                    landed["during_graph_capture"] = (
                        profiling.cuda_graph_lock.locked())
                    body, info = profiling.capture_bytes(duration_ms=500)
                    landed.update(info, flash_kernels=flash_kernel_counts(
                        json.loads(gzip.decompress(body))["traceEvents"]))
                capture = threading.Thread(target=during_graph_capture)
                capture.start()
            fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
            trainer.fit_feed(stream(), max_steps=GUARD_STEPS,  # path starts
                             steps_per_call=k, transfer_guard=guard)
            launches = launches_of(fa)                       # ... and ends
            if capture is not None:
                capture.join(timeout=180)
            run[guard or "unguarded"] = {
                "losses": [curve.losses.get(s)
                           for s in range(1, GUARD_STEPS + 1)
                           if s in curve.losses],
                "params": {n: t.detach().clone()
                           for n, t in trainer.state.params.items()},
                "launches": launches, "graphs": len(trainer._graphs)}
            del trainer
        params_equal = all(torch.equal(run["disallow"]["params"][n], t)
                           for n, t in run["unguarded"]["params"].items())
        guard_runs["k%d" % k] = {
            "losses": run["disallow"]["losses"],
            "unguarded_losses": run["unguarded"]["losses"],
            "losses_equal": (run["disallow"]["losses"]
                             == run["unguarded"]["losses"]),
            "params_equal": params_equal,
            "launches": run["disallow"]["launches"],
            "graphs": run["disallow"]["graphs"]}
        del run

    # the planted copy: raises under "disallow", logged under "log"
    def planted(params, batch, mask):
        weights = torch.ones(batch["tokens"].shape[0]).to(dev)
        return lm_loss(params, batch, mask * weights)

    raised = None
    try:
        new_trainer(planted).fit_feed(stream(), max_steps=1,
                                      transfer_guard="disallow")
    except RuntimeError as err:
        raised = str(err)

    class Records(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    records = Records()
    train.logger.addHandler(records)
    try:
        new_trainer(planted).fit_feed(stream(), max_steps=2,
                                      transfer_guard="log")
    finally:
        train.logger.removeHandler(records)
    logged = [m for m in records.messages if "host->device copy" in m]

    # the guard's cost a step at K = 1: eager steps on batches already on
    # the card, guarded and not, interleaved
    trainer = new_trainer()
    batches = device_batches(torch, NgramFeed(np, 3, TRAIN_BATCH, SEQ,
                                              vocab), GUARD_TIMED_STEPS, dev)
    trainer.step(*batches[0])
    timed = interleaved_steady(
        torch, {"unguarded": trainer, "guarded": Guarded(train, trainer)},
        batches, GUARD_ROUNDS)
    del trainer
    row = {"phase": "observability", "config": LM_CONFIG,
           "step_profiler": {
               "profile_steps": STEP_PROFILE, "steps": STEP_PROFILE_STEPS,
               "launches": step_profiler_launches,
               "trace_flash_kernels": traced,
               "counter_delta_over_window": window,
               "trace_bytes": trace_bytes,
               "edge_windows": {"windows_each": EDGE_WINDOWS,
                                "profile_steps": EDGE_WINDOW,
                                "by_window": edges,
                                "lost": edge_lost}},
           "transfer_guard": {
               "runs": guard_runs,
               "capture_during_graph_capture": landed,
               "planted_raised": raised, "planted_logged": len(logged),
               "k1_ms_per_step": {n: median(v) for n, v in timed.items()},
               "k1_ms_runs": timed},
           "card_s": time.perf_counter() - t_start}
    emit(row)
    expected = 3 * layers
    if not (traced == window and all(n == expected
                                     for n in traced.values())):
        raise AssertionError("the step profiler's trace holds flash "
                             "kernels {}, the counters moved {} over its "
                             "window, expected {} each".format(
                                 traced, window, expected))
    if not all(w["traced"] == w["moved"]
               and all(n == expected for n in w["moved"].values())
               for w in edges["padded"]):
        raise AssertionError("step-profiler windows with edge kernels, "
                             "flash kernels traced against the counters' "
                             "moves (expected {} each): {}".format(
                                 expected, edges["padded"]))
    for name, run in guard_runs.items():
        # K = 1 writes the loss at each window's end, K = 5 every step's
        want = GUARD_STEPS // (LOG_STEPS if name == "k1" else 1)
        if not (run["losses_equal"] and run["params_equal"]
                and len(run["losses"]) == want):
            raise AssertionError("the guarded run ({}) differs from the "
                                 "unguarded one: {} against {}".format(
                                     name, run["losses"],
                                     run["unguarded_losses"]))
    if not guard_runs["k%d" % MEGA_K]["graphs"]:
        raise AssertionError("the guarded K = 5 run captured no graph")
    if not (landed.get("during_graph_capture")
            and all(landed.get("flash_kernels", {0: 0}).values())):
        raise AssertionError("the capture asked for during the graph "
                             "capture did not land on the replays: "
                             "{}".format(landed))
    if raised is None or "host->device copy" not in raised or len(
            logged) != 2:
        raise AssertionError("the planted copy raised {!r} under disallow "
                             "and was logged {} times under log (2 "
                             "steps)".format(raised, len(logged)))
    return cluster_row, row


# the control phase: the alerting and control planes (watchtower,
# guardrails, autopilot, remediator) behind cluster.run, each closing its
# detect -> act loop on the flagship LM
CONTROL_HEARTBEAT_SECS = 0.5
# beats a node may miss before it is declared dead: a node's child pauses
# its beats while it brings CUDA up (as in the observability phase)
CONTROL_HEARTBEAT_MISSES = 60
# the driver's waits: to each loop's close after its fault, and for a
# node's report after its run
CONTROL_LOOP_SECS = 180
CONTROL_REPORT_SECS = 300
# the rule engine's tick and window, as the JAX remediator gate runs it
CONTROL_WATCHTOWER = {"interval_secs": 0.5, "window_secs": 8.0,
                      "cooldown_secs": 1.0, "journal_snapshot_secs": 1.0}
# control_rollback: fit_supervised at K = 1 with a checkpoint every 5
# steps (all kept, so the last clean one survives however late the
# rollback lands); the batch dispatched at step 12 is NaN'd (saves 5 and
# 10 clean); windows of 2 steps, so the nonfinite tally reaches a beat
# within two steps; the feed paced on the host so the alert lands before
# the run's end (on one H100 the halt came 4 steps after the NaN)
ROLLBACK_STEPS = 25
ROLLBACK_SAVE_STEPS = 5
ROLLBACK_NAN_STEP = 12
ROLLBACK_LOG_STEPS = 2
ROLLBACK_PACE_SECS = 0.25
CONTROL_REMEDIATOR_ROLLBACK = {
    "interval_secs": 0.25, "confirm_windows": {"rollback_poison": 1},
    "settle_ticks": 2, "cooldown_secs": 5.0, "max_rollbacks": 1,
    "max_evictions": 0, "journal_snapshot_secs": 1.0}
# control_evict: two nodes train their own LM on device-resident batches
# until the driver's stop file; executor 1 sleeps before every dispatch,
# several times the step of two nodes sharing the card (about 88 ms each
# there, twice the lone step), so its windows of 5 steps are 2.5 s and
# more.  A straggler must stand at 5x its peer's step, not the default 2x
# (straggler_rel_floor 1.0): the replacement's first windows share the
# card with a peer whose recent windows ran alone (147 ms against 43.6 on
# one H100), and they must not read as a second straggler
EVICT_LOG_STEPS = 5
EVICT_STRAGGLER_SECS = 0.5
EVICT_WATCHTOWER = dict(CONTROL_WATCHTOWER, straggler_rel_floor=1.0)
EVICT_BATCHES = 4
# windows the replacement trains before the stop, and how far its step
# may stray from its healthy peer's over the same time
EVICT_REPLACEMENT_WINDOWS = 2
EVICT_PEER_RATIO = 1.5
CONTROL_REMEDIATOR_EVICT = {
    "interval_secs": 0.25, "window_secs": 6.0, "settle_ticks": 4,
    "cooldown_secs": 3.0, "confirm_windows": {"evict_straggler": 2},
    "max_evictions": 1, "max_rollbacks": 0,
    "replacement_grace_secs": 120.0, "alert_ttl_secs": 10.0,
    "journal_snapshot_secs": 1.0}
# control_autopilot: the LM fed by TPUCluster.train at K = 1 (eager) until
# the autopilot's train_steps_per_call push regroups the node's feed; only
# that knob can move (infeed_prefetch pinned at its depth), and one action
# a leg (the cooldown outlasts it)
AUTOPILOT_LOG_STEPS = 10
AUTOPILOT_PART_ROWS = 64
AUTOPILOT_GAP_HI_US = 1500.0   # the autopilot's default threshold
# steps after the switch before the driver stops the feed, so the
# judged effect and the losses across the switch are both there
AUTOPILOT_STEPS_AFTER = 20


class PacedFeed(SupervisedFeed):
    """The supervised phase's stream from the step ``trainer`` resumes at
    (each batch a function of its step, with a float ``row_weight`` leaf
    for the NaN batch to poison), one batch at a time, ``pace`` seconds
    before each; ``pulls`` records each batch's step, when it was asked
    for (the previous dispatch's end) and when it was handed over (its
    dispatch's start)."""

    def __init__(self, np, trainer, pace, pulls):
        super().__init__(np, trainer, row_weight=True)
        self.step, self.pace, self.pulls = trainer.state.step, pace, pulls

    def batches(self):
        while not self.terminated:
            asked = time.time()
            if self.pace:
                time.sleep(self.pace)
            self.pulls.append((self.step, asked, time.time()))
            yield self.next_batch()
            self.step += 1


def control_lm(torch, config, device):
    """The control legs' LM, its random weights drawn from seed 0 on
    ``device`` (on the card in a fraction of a second; the host takes about
    10 s for the flagship's 168M params)."""
    from tensorflowonspark_torch.models import get_model

    with torch.device(device):
        model = get_model("transformer_lm", **config)
    return model.init_weights(torch.Generator(device=device).manual_seed(0))


def control_node(args, ctx):
    """What each control leg's user fn starts with, in the child the node
    forked: CUDA up (in a one-node world; ``args["independent"]``: no
    world, as the eviction leg's nodes share no collective and an evicted
    node must not break its peer's), the kernels loaded, the LM."""
    import torch

    from tensorflowonspark_torch.ops import _build

    if args.get("independent"):
        device = torch.device(args["device"] or "cuda")
    else:
        device = ctx.initialize_distributed(device=args["device"])
    if device.type == "cuda":
        for name in _build.build():     # the parent built them: loads
            _build.load(name)
    return device, control_lm(torch, args["config"], device)


def control_trainer(args, loss, init, device, log_steps, **kwargs):
    import functools

    import torch

    from tensorflowonspark_torch import train

    return train.Trainer(loss, init,
                         functools.partial(torch.optim.Adam, lr=args["lr"]),
                         compute_dtype=getattr(torch,
                                               args["config"]["dtype"]),
                         batch_size=TRAIN_BATCH, log_steps=log_steps,
                         device=device, **kwargs)


def write_report(path, report):
    with open(path + ".tmp", "w") as f:
        json.dump(report, f)
    os.replace(path + ".tmp", path)


def control_rollback_main(args, ctx):
    """The rollback leg's user fn: ``fit_supervised`` at K = 1 with a
    checkpoint every 5 steps over batches that are a function of their
    step, paced on the host; the executor's fault spec NaNs one batch, and
    the remediator's ``train_rollback`` push halts the run, which restores
    the last clean checkpoint and replays.  Then a fresh trainer runs the
    same steps and batches uninterrupted, and the two runs' params are
    compared to the bit.  Reports to ``args["report"]``."""
    import importlib
    import traceback

    report = {}
    try:
        import numpy as np
        import torch

        from tensorflowonspark_torch import checkpoint, fault, train
        from tensorflowonspark_torch.models import transformer

        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        device, model = control_node(args, ctx)
        init = dict(model.state_dict())
        lm_loss = transformer.loss_fn(model)

        def weighted_loss(params, batch, mask):
            return lm_loss(params, {"tokens": batch["tokens"]},
                           mask * batch["row_weight"])

        trainer = control_trainer(args, weighted_loss, init, device,
                                  ROLLBACK_LOG_STEPS)
        ckpt = checkpoint.CheckpointManager(
            args["ckpt_dir"], save_interval_steps=ROLLBACK_SAVE_STEPS,
            max_to_keep=ROLLBACK_STEPS // ROLLBACK_SAVE_STEPS,
            async_save=True)
        attempts = []

        def factory():
            if attempts:
                # the poison was in the data: the replay reads clean
                # batches (the spec would arm the next attempt's injector)
                os.environ.pop(fault.FAULT_SPEC_ENV, None)
            pulls = []
            attempts.append({"start": trainer.state.step, "pulls": pulls})
            return PacedFeed(np, trainer, ROLLBACK_PACE_SECS, pulls)

        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        stats = train.fit_supervised(trainer, factory, ckpt,   # path starts
                                     max_steps=ROLLBACK_STEPS)
        report["launches"] = launches_of(fa)                 # ... and ends
        snap = trainer.counters_snapshot()
        report.update({
            "steps": trainer.state.step, "attempts": attempts,
            "dispatches": snap["dispatch_count"],
            "final_loss": stats.get("loss"),
            "rollbacks": snap.get("train_rollbacks_total", 0),
            "nonfinite_loss": snap.get("train_nonfinite_loss", 0),
            "recovery_us": snap.get("goodput_recovery_us", 0),
            "checkpoints": sorted(os.listdir(ckpt.directory))})
        ckpt.close()
        # the same steps and batches, uninterrupted
        plain = control_trainer(args, weighted_loss, init, device,
                                ROLLBACK_LOG_STEPS)
        plain.fit_feed(PacedFeed(np, plain, 0, []), max_steps=ROLLBACK_STEPS)
        differ = [n for n, t in trainer.state.params.items()
                  if not torch.equal(t, plain.state.params[n])]
        report.update({
            "uninterrupted_steps": plain.state.step,
            "params_equal_bitwise": not differ,
            "params_differing": differ[:8],
            "param_max_abs_diff": max(
                (trainer.state.params[n].float()
                 - plain.state.params[n].float()).abs().max().item()
                for n in trainer.state.params)})
    except Exception:
        report["error"] = traceback.format_exc()
        raise
    finally:
        write_report(args["report"], report)


class UntilStopped(object):
    """Device-resident batches, cycled until the driver's stop file."""

    def __init__(self, batches, stop):
        self.items, self.stop = batches, stop

    def batches(self):
        i = 0
        while not os.path.exists(self.stop):
            yield self.items[i % len(self.items)]
            i += 1


def control_evict_main(args, ctx):
    """The eviction leg's user fn, on each node and on the replacement:
    the LM trained on device-resident batches until the driver's stop
    file, no collective across nodes (a warm-up forward and backward first,
    outside the loop, so that the windows the watchtower scores hold
    steady steps).  An evicted node ends in the SIGTERM drain's
    ``SystemExit``; the report is written on every way out."""
    import importlib
    import traceback

    from tensorflowonspark_torch import node

    report = {"executor": ctx.executor_id, "started": time.time()}
    path = args["report"] + str(ctx.executor_id)
    trainer = None
    try:
        import numpy as np
        import torch

        from tensorflowonspark_torch.models import transformer

        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        device, model = control_node(args, ctx)
        trainer = control_trainer(args, transformer.loss_fn(model),
                                  dict(model.state_dict()), device,
                                  EVICT_LOG_STEPS)
        batches = device_batches(
            torch, NgramFeed(np, 10 + ctx.executor_id, TRAIN_BATCH,
                                      args["seq"],
                                      args["config"]["vocab_size"]),
            EVICT_BATCHES, device)
        trainer._grads(*trainer._prepare(*batches[0]))      # warm-up
        trainer.state.optimizer.zero_grad(set_to_none=True)
        ends = report["ends"] = []
        report["ready"] = time.time()
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        try:
            trainer.fit_feed(UntilStopped(batches, args["stop"]),
                             on_steps=lambda s: ends.append((time.time(), s)))
        finally:
            report["launches"] = launches_of(fa)
    except BaseException as e:
        if not isinstance(e, SystemExit):
            report["error"] = traceback.format_exc()
        raise
    finally:
        report["preempted"] = node.preempted()
        if trainer is not None:
            report["steps"] = trainer.state.step
            if trainer.history is not None:
                report["windows"] = trainer.history.timestamp_log
        write_report(path, report)


class Regrouped(object):
    """One ShardedFeed's grouped items for two ``fit_feed`` calls:
    :meth:`batches` hands on K = 1 groups as single eager steps until the
    feed regroups (an autopilot ``train_steps_per_call`` push lands at a
    group boundary); :meth:`grouped_batches` then hands on that group and
    the rest.  One prefetch thread, one consumer: nothing is dropped."""

    def __init__(self, sharded):
        self.groups = sharded.grouped_batches(1)
        self.held, self.k, self.switched = None, 1, None

    def batches(self):
        for kind, batch, mask in self.groups:
            if kind == "multi" and mask.shape[0] > 1:
                self.held, self.k = (kind, batch, mask), int(mask.shape[0])
                self.switched = time.time()
                return
            if kind == "multi":
                yield {n: t[0] for n, t in batch.items()}, mask[0]
            else:
                yield batch, mask

    def grouped_batches(self, k):
        if self.held is not None:
            held, self.held = self.held, None
            yield held
        yield from self.groups


def control_autopilot_main(args, ctx):
    """The autopilot leg's user fn: the LM from the node's feed at K = 1
    (eager) until the autopilot's push regroups the feed, then at the
    pushed K (a CUDA graph captured mid-run) to the end of the feed; every
    step's loss of the K > 1 stretch and each window's at K = 1 reported
    with the launches."""
    import importlib
    import traceback

    report = {}
    try:
        from tensorflowonspark_torch.models import transformer
        from tensorflowonspark_torch.parallel import infeed

        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        device, model = control_node(args, ctx)
        curve = LossCurve()
        trainer = control_trainer(args, transformer.loss_fn(model),
                                  dict(model.state_dict()), device,
                                  AUTOPILOT_LOG_STEPS, summary_writer=curve)
        feed = Regrouped(infeed.ShardedFeed(
            ctx.get_data_feed(), TRAIN_BATCH,
            transform=lambda t: {"tokens": t}, device=device))
        ends = []

        def on_steps(step):
            ends.append((time.time(), step))

        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        trainer.fit_feed(feed, on_steps=on_steps)          # the path starts
        k1_steps = trainer.state.step
        k1 = trainer.counters_snapshot()
        report["k1_gap_us_per_step"] = (k1.get("dispatch_gap_us", 0)
                                        / max(k1.get("train_steps_total", 0),
                                              1))
        stats = None
        if feed.k > 1:
            stats = trainer.fit_feed(feed, steps_per_call=feed.k,
                                     on_steps=on_steps)
        report.update({"launches": launches_of(fa),        # ... and ends
                       "k1_steps": k1_steps, "k": feed.k,
                       "switched": feed.switched,
                       "steps": trainer.state.step,
                       "losses": curve.losses, "dispatch_ends": ends,
                       "megastep": stats and stats["megastep"],
                       "graphs": len(trainer._graphs),
                       "counters": trainer.counters_snapshot()})
    except Exception:
        report["error"] = traceback.format_exc()
        raise
    finally:
        write_report(args["report"], report)


def journal(log_dir, plane):
    from tensorflowonspark_torch import watchtower

    path = os.path.join(log_dir, plane, "journal.jsonl")
    return watchtower.read_journal(path) if os.path.exists(path) else []


def first_time(records, **match):
    """The time of the first journal record whose fields hold ``match``."""
    for r in records:
        if all(str(r.get(k)) == str(v) for k, v in match.items()):
            return r.get("time")
    return None


def stages_of(records, action):
    return sorted({r.get("stage") for r in records
                   if r.get("kind") == "action"
                   and r.get("action", r.get("knob")) == action})


def since(t0, t):
    return None if t is None or t0 is None else t - t0


def control_cluster(backend_mod, cluster_mod, n, fn, args, log_dir, env=None,
                    **planes):
    b = backend_mod.LocalBackend(n, env_per_executor=env)
    t0 = time.time()
    c = cluster_mod.run(b, fn, args, num_executors=n,
                        input_mode=cluster_mod.InputMode.SPARK,
                        log_dir=log_dir, telemetry=True, observatory=True,
                        heartbeat_interval=CONTROL_HEARTBEAT_SECS,
                        heartbeat_misses=CONTROL_HEARTBEAT_MISSES, **planes)
    return b, c, time.time() - t0


def control_rollback(torch, np, config, device, tmp):
    """The rollback leg: one executor under ``remediator=``; the
    watchtower's ``nonfinite`` crit -> ``rollback_poison`` ->
    ``train_rollback`` -> ``PoisonRollback`` -> ``restore_latest_valid``."""
    from tensorflowonspark_torch import backend, cluster, fault

    log_dir = os.path.join(tmp, "rollback")
    args = {"config": config, "device": device, "lr": LR,
            "ckpt_dir": os.path.join(tmp, "rollback_ckpt"),
            "report": os.path.join(tmp, "rollback.json")}
    spec = json.dumps({"nan_batch_at_step": ROLLBACK_NAN_STEP})
    b, c, run_s = control_cluster(
        backend, cluster, 1, control_rollback_main, args, log_dir,
        env=[{fault.FAULT_SPEC_ENV: spec}], watchtower=CONTROL_WATCHTOWER,
        remediator=CONTROL_REMEDIATOR_ROLLBACK)
    try:
        report = wait_for_report(args["report"], CONTROL_REPORT_SECS)
        c.shutdown(grace_secs=1)
    finally:
        b.stop()
    alerts, actions = journal(log_dir, "watchtower"), journal(
        log_dir, "remediator")
    first = report["attempts"][0]["pulls"]
    # the NaN batch's dispatch starts when it is handed over
    nan_t = next((t for s, _, t in first if s == ROLLBACK_NAN_STEP), None)
    replay = report["attempts"][-1]["pulls"]
    # the replay's first dispatch ends when its second batch is asked for
    restored_t = replay[1][1] if len(replay) > 1 else None
    layers = config["num_layers"]
    row = {"steps": report["steps"], "rollbacks": report["rollbacks"],
           "feed_starts": [a["start"] for a in report["attempts"]],
           "halted_at_step": (first[-1][0] if len(report["attempts"]) > 1
                              else None),
           "dispatches": report["dispatches"],
           "checkpoints": report["checkpoints"],
           "corrupt": [e for e in report["checkpoints"]
                       if e.endswith(".corrupt")],
           "nonfinite_loss_windows": report["nonfinite_loss"],
           "recovery_us": report["recovery_us"],
           "final_loss": report["final_loss"],
           "params_equal_bitwise": report["params_equal_bitwise"],
           "params_differing": report["params_differing"],
           "param_max_abs_diff": report["param_max_abs_diff"],
           "uninterrupted_steps": report["uninterrupted_steps"],
           "rollback_stages": stages_of(actions, "rollback_poison"),
           "alerts": sorted({(r.get("rule"), str(r.get("executor")))
                             for r in alerts if r.get("kind") == "alert"}),
           "s_nan_to_alert": since(nan_t, first_time(
               alerts, kind="alert", rule="nonfinite")),
           "s_nan_to_applied": since(nan_t, first_time(
               actions, kind="action", action="rollback_poison",
               stage="applied")),
           "s_nan_to_first_step_after_restore": since(nan_t, restored_t),
           "tf_status": {k: c.tf_status.get(k) for k in (
               "alerts", "remediations", "dead_nodes", "error")},
           "cluster_run_s": run_s, "launches": report["launches"]}
    if not ("applied" in row["rollback_stages"] and row["corrupt"]
            and report["steps"] == ROLLBACK_STEPS
            and report["rollbacks"] == 1
            and report["params_equal_bitwise"]
            and report["uninterrupted_steps"] == ROLLBACK_STEPS
            and (device == "cpu" or all(
                n == layers * report["dispatches"]
                for n in report["launches"].values()))):
        raise AssertionError("control_rollback: the loop did not close: "
                             "{}".format(row))
    return row


def control_evict(torch, np, config, device, tmp):
    """The eviction leg: two executors under ``remediator=`` with
    ``max_evictions: 1``; executor 1 straggles (``sleep_per_step_secs``),
    the watchtower's ``straggler_step_time`` names it, the remediator's
    ``evict_straggler`` drains it through its SIGTERM path and a
    replacement executor trains in its slot."""
    from tensorflowonspark_torch import backend, cluster, fault

    log_dir = os.path.join(tmp, "evict")
    args = {"config": config, "device": device, "lr": LR,
            "seq": SEQ if device is None else config["max_seq_len"],
            "stop": os.path.join(tmp, "evict_stop"), "independent": True,
            "report": os.path.join(tmp, "evict-")}
    slow = json.dumps({"sleep_per_step_secs": EVICT_STRAGGLER_SECS})
    b, c, run_s = control_cluster(
        backend, cluster, 2, control_evict_main, args, log_dir,
        env=[{}, {fault.FAULT_SPEC_ENV: slow}],
        watchtower=EVICT_WATCHTOWER, remediator=CONTROL_REMEDIATOR_EVICT)
    base = "http://127.0.0.1:%d" % c.observatory.addr[1]
    try:
        try:
            def evicted():
                doc = json.loads(http_get(base + "/remediations?limit=100")[0])
                got = stages_of(doc.get("actions") or [], "evict_straggler")
                return got if {"proposed", "applied", "effect"} <= set(
                    got) else None

            wait_until("evict_straggler to close its loop", evicted,
                       CONTROL_LOOP_SECS, 0.3)
            applied = [a for a in json.loads(http_get(
                base + "/remediations?limit=100")[0])["actions"]
                if a["action"] == "evict_straggler"
                and a["stage"] == "applied"]
            wait_until("the replacement", lambda: c.tf_status.get(
                "replacements"), CONTROL_LOOP_SECS, 0.2)

            def replacement_windows():
                nodes = c.metrics_snapshot().get("nodes") or {}
                got = [n for n in nodes if n not in ("0", "1")]
                return got if got and nodes[got[0]].get(
                    "step_ms_count", 0) >= (EVICT_REPLACEMENT_WINDOWS
                                            * EVICT_LOG_STEPS) else None

            new = wait_until("the replacement's steps", replacement_windows,
                             CONTROL_REPORT_SECS, 0.2)[0]
        finally:
            open(args["stop"], "w").close()
        reports = {e: wait_for_report(args["report"] + e,
                                      CONTROL_REPORT_SECS)
                   for e in ("0", "1", new)}
        c.shutdown(grace_secs=1)
    finally:
        if not os.path.exists(args["stop"]):
            open(args["stop"], "w").close()
        b.stop()
    alerts, actions = journal(log_dir, "watchtower"), journal(
        log_dir, "remediator")
    stragglers = sorted({str(r.get("executor")) for r in alerts
                         if r.get("kind") == "alert"
                         and str(r.get("rule")).startswith("straggler")})

    def window_ms(report, lo=None, hi=None):
        """Median ms a step of a node's windows (its first left out),
        those inside ``[lo, hi]`` when given."""
        log = report.get("windows") or []
        ms = [1e3 * (t1 - t0) / (s1 - s0)
              for (s0, t0), (s1, t1) in list(zip(log, log[1:]))[1:]
              if s1 > s0 and (lo is None or t0 >= lo)
              and (hi is None or t1 <= hi)]
        return median(ms) if ms else None

    layers = config["num_layers"]
    rep = reports[new]
    rep_span = ((rep.get("windows") or [[0, None]])[0][1],
                (rep.get("windows") or [[0, None]])[-1][1])
    new_ms = window_ms(rep)
    peer_ms = window_ms(reports["0"], *rep_span)
    onset = (reports["1"].get("ends") or [[None]])[0][0]
    first_new = (rep.get("ends") or [[None]])[0][0]
    launches = {name: sum(r.get("launches", {}).get(name, 0)
                          for r in reports.values())
                for name in FLASH_KERNELS}
    row = {"straggler_secs": EVICT_STRAGGLER_SECS,
           "evict_stages": stages_of(actions, "evict_straggler"),
           "evicted": [str(a.get("executor")) for a in applied],
           "replaced": [a.get("detail", {}).get("replaced")
                        for a in applied],
           "straggler_alert_executors": stragglers,
           "alerts": sorted({(r.get("rule"), str(r.get("executor")))
                             for r in alerts if r.get("kind") == "alert"}),
           "replacements": c.tf_status.get("replacements"),
           "byes": c.tf_status.get("byes"),
           "dead_nodes": c.tf_status.get("dead_nodes"),
           "replacement_executor": new,
           "straggler_ms_per_step": window_ms(reports["1"]),
           "peer_ms_per_step_before": window_ms(reports["0"], None,
                                                rep_span[0]),
           "replacement_ms_per_step": new_ms,
           "peer_ms_per_step_beside_replacement": peer_ms,
           "steps": {e: r.get("steps") for e, r in reports.items()},
           "preempted": {e: r.get("preempted") for e, r in reports.items()},
           "first_straggler_rule": next(
               (r.get("rule") for r in alerts if r.get("kind") == "alert"
                and str(r.get("rule")).startswith("straggler")), None),
           "s_onset_to_alert": since(onset, next(
               (r.get("time") for r in alerts if r.get("kind") == "alert"
                and str(r.get("rule")).startswith("straggler")
                and str(r.get("executor")) == "1"), None)),
           "s_onset_to_step_time_alert": since(onset, first_time(
               alerts, kind="alert", rule="straggler_step_time",
               executor="1")),
           "s_onset_to_applied": since(onset, first_time(
               actions, kind="action", action="evict_straggler",
               stage="applied")),
           "s_onset_to_replacement_first_step": since(onset, first_new),
           "launches_by_node": {e: r.get("launches")
                                for e, r in reports.items()},
           "cluster_run_s": run_s, "launches": launches}
    if not ({"proposed", "applied", "effect"} <= set(row["evict_stages"])
            and row["evicted"] == ["1"] and all(row["replaced"])
            and stragglers == ["1"]
            and len(row["replacements"] or []) == 1
            and (row["byes"] or {}).get("1") == "preempted"
            and not row["dead_nodes"] and reports["1"]["preempted"]
            and new_ms and peer_ms and new_ms <= EVICT_PEER_RATIO * peer_ms
            and (device == "cpu" or all(
                reports[e]["launches"][n] == layers * reports[e]["steps"]
                for e in ("0", new) for n in FLASH_KERNELS))):
        raise AssertionError("control_evict: the loop did not close: "
                             "{}".format(row))
    return row


def control_autopilot(torch, np, config, device, tmp, gap_hi_us):
    """The autopilot leg: one executor fed by ``TPUCluster.train`` under
    ``autopilot=`` with only ``train_steps_per_call`` free to move; the
    dispatch gap per step at K = 1 raises K, the node's feed regroups and
    the Trainer captures a graph for the new K mid-run; the losses across
    the switch against a K = 1 run on this card over the same rows."""
    import threading

    from tensorflowonspark_torch import backend, cluster
    from tensorflowonspark_torch.models import transformer

    vocab = config["vocab_size"]
    seq = SEQ if device is None else config["max_seq_len"]
    log_dir = os.path.join(tmp, "autopilot")
    args = {"config": config, "device": device, "lr": LR,
            "report": os.path.join(tmp, "autopilot.json")}
    planes = {"watchtower": CONTROL_WATCHTOWER, "autopilot": {
        "interval_secs": 0.5, "window_secs": 4.0, "confirm_ticks": 2,
        "settle_ticks": 3, "cooldown_secs": 600.0, "min_events": 5,
        "journal_snapshot_secs": 1.0,
        "steps_per_call_gap_hi_us": gap_hi_us,
        "knobs": {"train_steps_per_call": {"initial": 1, "max": MEGA_K},
                  "infeed_prefetch": {"initial": 2, "min": 2, "max": 2}}}}
    parts = []
    stop_feed = threading.Event()

    def partitions():
        seed = 300
        while not stop_feed.is_set():
            seed += 1
            parts.append(seed)
            yield list(lm_rows(np, seed, AUTOPILOT_PART_ROWS, seq, vocab))

    b, c, run_s = control_cluster(backend, cluster, 1,
                                  control_autopilot_main, args, log_dir,
                                  **planes)
    base = "http://127.0.0.1:%d" % c.observatory.addr[1]
    try:
        feed_errors = []

        def feed():
            try:
                c.train(partitions())
            except Exception as e:
                feed_errors.append(repr(e))

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        try:
            def judged():
                doc = json.loads(http_get(base + "/autopilot")[0])
                got = stages_of(doc.get("actions") or [],
                                "train_steps_per_call")
                return got if {"applied", "effect"} <= set(got) and (
                    {"kept", "reverted"} & set(got)) else None

            wait_until("the train_steps_per_call action to be judged",
                       judged, CONTROL_LOOP_SECS, 0.3)
            dispatches = 'tfos_dispatch_count_total{executor="0"}'
            at = node_metrics(base)[2].get(dispatches, 0)
            wait_until("steps after the switch", lambda: node_metrics(
                base)[2].get(dispatches, 0) >= at + AUTOPILOT_STEPS_AFTER
                // MEGA_K, CONTROL_LOOP_SECS)
            gauge = node_metrics(base)[2].get(
                'tfos_train_steps_per_call_max{executor="0"}')
            pilot = json.loads(http_get(base + "/autopilot")[0])
        finally:
            stop_feed.set()
            feeder.join(timeout=120)
        c.shutdown(grace_secs=1)
        report = wait_for_report(args["report"], CONTROL_REPORT_SECS)
    finally:
        b.stop()
    actions = journal(log_dir, "autopilot")
    applied = [r for r in actions if r.get("kind") == "action"
               and r.get("stage") == "applied"]
    # the same rows, in the order the node trained them, at K = 1 here
    dev = torch.device(device or "cuda")
    model = control_lm(torch, config, dev)
    ref = control_trainer({"lr": LR, "config": config},
                          transformer.loss_fn(model),
                          dict(model.state_dict()), dev, AUTOPILOT_LOG_STEPS)
    rows = np.concatenate([lm_rows(np, s, AUTOPILOT_PART_ROWS, seq, vocab)
                           for s in parts])
    losses = {int(s): v for s, v in report["losses"].items()}
    diffs = {}
    for i in range(report["steps"]):
        tokens = rows[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
        if len(tokens) < TRAIN_BATCH:
            break
        loss, _ = ref.step({"tokens": torch.from_numpy(tokens)},
                           np.ones(TRAIN_BATCH, np.float32))
        if i + 1 in losses:
            diffs[i + 1] = abs(float(loss) - losses[i + 1])
    del ref, model
    ends = report["dispatch_ends"]
    gaps = [t1 - t0 for (t0, _), (t1, _) in zip(ends, ends[1:])]
    k_changed = report["switched"]
    row = {"gap_hi_us": gap_hi_us,
           "k1_gap_us_per_step": report["k1_gap_us_per_step"],
           "k": report["k"],
           "k1_steps": report["k1_steps"], "steps": report["steps"],
           "graphs": report["graphs"], "megastep": report["megastep"],
           "stages": stages_of(actions, "train_steps_per_call"),
           "applied": [{k: a.get(k) for k in ("knob", "frm", "to", "sensed",
                                               "objective_before")}
                       for a in applied],
           "live_actions": len(pilot.get("actions") or []),
           "train_steps_per_call_max_gauge": gauge,
           "loss_diff_vs_k1": {str(s): d for s, d in sorted(diffs.items())},
           "loss_tol": MEGA_LOSS_TOL, "feed_errors": feed_errors,
           "s_applied_to_k_changed": since(first_time(
               actions, kind="action", knob="train_steps_per_call",
               stage="applied"), k_changed),
           "max_dispatch_interval_s": max(gaps) if gaps else None,
           "cluster_run_s": run_s, "launches": report["launches"]}
    pushed = [a.get("to") for a in applied]
    if not (pushed and report["k"] == pushed[0]
            and (device == "cpu" or report["graphs"])
            and gauge == max(pushed) and diffs
            and all(d <= MEGA_LOSS_TOL for d in diffs.values())
            and not feed_errors
            and len([s for s in diffs if s > report["k1_steps"]])
            and (device == "cpu" or all(
                n == config["num_layers"] * report["steps"]
                for n in report["launches"].values()))):
        raise AssertionError("control_autopilot: the loop did not close: "
                             "{}".format(row))
    return row


def start_control_rollback(torch, np, config=LM_CONFIG, device=None):
    """Run the control phase's rollback leg on a thread, beside the next
    phases (its cluster's bring-up and its paced steps are host-bound, and
    its node makes every check in its own process); :func:`phase_control`
    takes its row from :func:`join_control_rollback`."""
    started = {"tmp": tempfile.mkdtemp(prefix="chip-rollback-")}

    def run():
        t0 = time.perf_counter()
        try:
            started["row"] = control_rollback(torch, np, config, device,
                                              started["tmp"])
            started["row"]["leg_s"] = time.perf_counter() - t0
        except BaseException as e:   # noqa: B036 — re-raised by the join
            started["error"] = e

    started["thread"] = threading.Thread(target=run, daemon=True)
    started["thread"].start()
    return started


def join_control_rollback(started):
    """The rollback leg's row, once its thread ended (its error raised)."""
    try:
        started["thread"].join(CONTROL_LOOP_SECS + CONTROL_REPORT_SECS)
        if started["thread"].is_alive():
            raise AssertionError("control_rollback did not end within "
                                 "{} s".format(CONTROL_LOOP_SECS
                                               + CONTROL_REPORT_SECS))
        if "error" in started:
            raise started["error"]
        return started["row"]
    finally:
        shutil.rmtree(started["tmp"], ignore_errors=True)


def phase_control(torch, np, clustered, rollback, config=LM_CONFIG,
                  device=None):
    """The alerting and control planes behind ``cluster.run`` on the
    flagship LM, one leg each: the remediator's poison rollback, its
    straggler eviction with a replacement, and the autopilot's
    ``train_steps_per_call``.  ``rollback``: the rollback leg's row, which
    ran earlier on a thread (:func:`start_control_rollback`,
    :func:`join_control_rollback`); the other two legs run here."""
    t_start = time.perf_counter()
    if device is None:
        torch.cuda.empty_cache()   # the earlier phases' cached blocks
    # the autopilot's threshold: a quarter of the K = 1 cluster run's
    # dispatch gap a step, at most its default.  The leg's own gap need not
    # follow the cluster run's: on a host where the cluster run's gap was
    # above the default (1764.7 us a step) the leg's sat at 503.8, and at
    # the default threshold the autopilot waited 1291 steps (161 s) for a
    # window above it
    overlap = clustered.get("overlap") or {}
    steps = overlap.get("train_steps_total") or clustered.get("steps") or 1
    gap_us = overlap.get("dispatch_gap_us", 0) / steps
    gap_hi_us = min(AUTOPILOT_GAP_HI_US, gap_us / 4)
    legs = {"control_rollback": rollback}
    emit(dict({"phase": "control_rollback"}, **rollback))
    with tempfile.TemporaryDirectory() as tmp:
        for name, leg in (("control_evict", lambda: control_evict(
                               torch, np, config, device, tmp)),
                          ("control_autopilot", lambda: control_autopilot(
                              torch, np, config, device, tmp, gap_hi_us))):
            t0 = time.perf_counter()
            legs[name] = leg()
            legs[name]["leg_s"] = time.perf_counter() - t0
            emit(dict({"phase": name}, **legs[name]))
    row = {"phase": "control", "config": config,
           "cluster_k1_gap_us_per_step": gap_us,
           "autopilot_gap_hi_us": gap_hi_us,
           "autopilot_default_gap_hi_us": AUTOPILOT_GAP_HI_US,
           "launches": {n: legs[n]["launches"] for n in legs},
           "phase_s": time.perf_counter() - t_start}
    emit(row)
    return legs


# -- fleet: registry, router, canary controller, replicas ---------------------

# the fleet's model: its registry name is the export's descriptor name,
# which each replica registers on the roster
FLEET_MODEL = "transformer_lm"
NONFINITE = "nonfinite"     # an answer's label until its window is checked
FLEET_BATCH = 1            # one-row requests: each replica warms rung 1 only
FLEET_CLIENTS = 2
FLEET_ROWS = 2             # distinct request rows, each referenced by version
FLEET_HEARTBEAT_SECS = 0.5
FLEET_HEARTBEAT_MISSES = 60
FLEET_READY_SECS = 300
FLEET_LEG_SECS = 240
FLEET_POLL_SECS = 0.1      # the walk's poll of the roster's metrics
# the poisoned version: the final LayerNorm's scale set to this finite
# value, so that every normalized activation above 1.13 overflows and the
# logits go nonfinite while the params pass the finiteness validation
FLEET_POISON_SCALE = 3.0e38
# the canary, sized for one-row requests of about 5 s each (the gateway's
# zlib of a row's fp32 logits): a window counts with one completed canary
# request, two clean windows keep a version, a nonfinite delta reverts it
# at once; all traffic goes to the canary while it is judged, so that the
# walk needs two canary rows (at half the traffic a draw that left the
# canary idle for a minute came up on the card)
FLEET_CANARY = {"interval_secs": 0.5, "canary_weight": 1.0,
                "min_requests": 1, "clean_windows": 2, "confirm_windows": 1,
                "cooldown_secs": 1.0, "revert_cooldown_secs": 1.0,
                "swap_timeout_secs": 120.0}


def fleet_publish_spec(root, config=LM_CONFIG):
    """``fit_supervised(publish=...)``'s spec: the trained LM, published
    into the registry at ``root`` as ``transformer_lm@step-<N>``,
    staging."""
    return {"registry": root, "model": FLEET_MODEL,
            "model_config": config, "input_signature": lm_signature(config)}


def percentiles(xs):
    """``{"n", "p50", "p99"}`` of ``xs`` (nearest rank)."""
    xs = sorted(xs)
    if not xs:
        return {"n": 0, "p50": None, "p99": None}
    return {"n": len(xs), "p50": xs[(len(xs) - 1) // 2],
            "p99": xs[min(len(xs) - 1, int(math.ceil(0.99 * len(xs))) - 1)]}


def read_ready_lines(procs, seconds, t0):
    """Each process's ready line within ``seconds``, and its seconds from
    ``t0``, read as they come."""
    import select

    lines, ready_s = {}, {}
    deadline = time.monotonic() + seconds
    while len(lines) < len(procs):
        pending = {p.stdout: name for name, p in procs.items()
                   if name not in lines}
        left = deadline - time.monotonic()
        ready, _, _ = select.select(list(pending), [], [], max(left, 0))
        if not ready:
            raise AssertionError("no ready line from {} in {} s".format(
                sorted(pending.values()), seconds))
        for stream in ready:
            name = pending[stream]
            lines[name] = stream.readline()
            ready_s[name] = time.perf_counter() - t0
            if "ready on" not in lines[name]:
                raise AssertionError("{}: no ready line: {!r}".format(
                    name, lines[name]))
    return lines, ready_s


def phase_fleet(torch, np, published, config=LM_CONFIG, device=None):
    """The model fleet on the card: two ``inference_cli --serve --registry
    --model transformer_lm`` replicas behind the roster, a
    ``FleetRouter``, a live ``CanaryController`` and the observatory's
    ``/fleet``, while
    ``FleetClient``s send one-row requests.  A poisoned version ``2`` is rolled
    back and retired; ``published`` (the supervised phase's
    ``fit_supervised(publish=)`` entry) is published here as staging and
    walked to live on both replicas.  ``device="cpu"`` rehearses it on the
    CPU (no kernel launches there)."""
    import shutil
    import signal
    import threading

    from tensorflowonspark_torch import (checkpoint, fleet, gateway,
                                         observatory, reservation, serving)

    t_start = time.perf_counter()
    layers, vocab = config["num_layers"], config["vocab_size"]
    seq = config["max_seq_len"]
    trained = published["version"]
    on = [] if device is None else ["--device", device]
    rows = np.random.default_rng(9).integers(0, vocab, (FLEET_ROWS, 1, seq),
                                             dtype=np.int32)
    if device is None:
        torch.cuda.empty_cache()   # the earlier phases' cached blocks
    tmp = tempfile.mkdtemp()
    procs, threads, logs = {}, [], []
    stop_clients = threading.Event()
    registry = resv = obs = ctl = None
    try:
        registry = fleet.ModelRegistry(os.path.join(tmp, "registry"),
                                       publisher="chip-smoke")
        v1 = export_lm(torch, os.path.join(tmp, "v1"), 7, config)
        state, desc = checkpoint.load_model(v1)
        state["ln_f.weight"] = torch.full_like(state["ln_f.weight"],
                                               FLEET_POISON_SCALE)
        v2 = os.path.join(tmp, "v2")
        checkpoint.export_model(v2, state, desc["model_name"],
                                model_config=desc["model_config"],
                                input_signature=desc["input_signature"])
        del state
        registry.publish(FLEET_MODEL, "1", v1, model_config=config,
                         status="live")

        # in-process references: a ModelServer on each served export
        refs = {}
        for version, path in (("1", v1), (trained, published["export_dir"])):
            server = serving.ModelServer(path, batch_size=FLEET_BATCH,
                                         device=device)
            refs[version] = [server.predict_feed({"tokens": r}, 1)["output"]
                             for r in rows]
            del server
        if device is None:
            torch.cuda.empty_cache()
        scale = max(float(np.abs(r).max()) for rs in refs.values()
                    for r in rs)
        tol = LOGIT_TOL * scale

        def classify(i, got):
            """The version whose reference ``got`` matches, "nonfinite"
            for nonfinite logits (held to the poisoned version's window
            once the walk is over), None for no version."""
            if not np.isfinite(got).all():
                return NONFINITE
            for version, outs in refs.items():
                if float(np.abs(got - outs[i]).max()) <= tol:
                    return version
            return None

        resv = reservation.Server(2, heartbeat_interval=FLEET_HEARTBEAT_SECS,
                                  heartbeat_misses=FLEET_HEARTBEAT_MISSES)
        roster = resv.start()
        router = fleet.FleetRouter(registry=registry)
        journal_path = os.path.join(tmp, "canary.jsonl")
        ctl = fleet.CanaryController(
            registry, router, metrics_fn=resv.metrics_snapshot,
            push_knobs=resv.push_knobs, journal_path=journal_path,
            config=FLEET_CANARY)
        obs = observatory.ObservatoryServer(
            resv.metrics_snapshot, host="127.0.0.1",
            fleet={"registry": registry, "router": router, "canary": ctl})
        obs.start()
        base = "http://127.0.0.1:%d" % obs.addr[1]

        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        for i in range(2):
            rid = "lm-%d" % i
            logs.append(open(os.path.join(tmp, rid + ".log"), "w"))
            procs[rid] = subprocess.Popen(
                [sys.executable, "-c", CLI_WRAPPER, "--serve",
                 "--registry", registry.root, "--model", FLEET_MODEL,
                 "--roster", "%s:%d" % tuple(roster[:2]),
                 "--replica-id", rid, "--task-index", str(i),
                 "--max-batch", str(FLEET_BATCH),
                 "--heartbeat", str(FLEET_HEARTBEAT_SECS), "--port", "0"]
                + on, cwd=HERE, env=env, stdout=subprocess.PIPE,
                stderr=logs[-1], text=True)
        ready_lines, ready_s = read_ready_lines(procs, FLEET_READY_SECS, t0)
        rc = reservation.Client(roster)
        try:
            info = rc.await_reservations(timeout=FLEET_READY_SECS)
        finally:
            rc.close()
        router.sync_roster(info)
        rids = sorted(router.replicas(FLEET_MODEL))
        if rids != sorted(procs):
            raise AssertionError("the router mapped {} to lm: {}".format(
                rids, router.status()))

        def metrics():
            return resv.metrics_snapshot()["nodes"]

        nodes0 = wait_until("the replicas' first metric beats", lambda: (
            lambda n: n if all("serving_compiles" in n.get(r, {})
                               for r in rids) else None)(metrics()),
            FLEET_READY_SECS, FLEET_POLL_SECS)
        compiles0 = {r: nodes0[r]["serving_compiles"] for r in rids}
        fleet_before = json.loads(http_get(base + "/fleet")[0])

        results, errors, lock = [], [], threading.Lock()

        def drive(ci):
            client = fleet.FleetClient(router, timeout=FLEET_LEG_SECS,
                                       client_id="chip-c%d" % ci)
            n = 0
            try:
                while not stop_clients.is_set():
                    i = (ci + n) % FLEET_ROWS
                    n += 1
                    sent = time.time()
                    got = client.predict(FLEET_MODEL, {"tokens": rows[i]}, 1)[
                        "output"]
                    done = time.time()
                    version = classify(i, got)
                    with lock:
                        results.append({"row": i, "version": version,
                                        "sent": sent, "done": done,
                                        "latency_s": done - sent})
            except Exception as e:
                with lock:
                    errors.append("client {}: {!r}".format(ci, e))
            finally:
                client.close()

        threads = [threading.Thread(target=drive, args=(ci,), daemon=True)
                   for ci in range(FLEET_CLIENTS)]
        for t in threads:
            t.start()
        ctl.start()

        current = {r: str(nodes0[r].get("serving_model_version"))
                   for r in rids}
        flips = []   # (time, replica, version) as the metrics showed them

        def walk_until(what, pred):
            deadline = time.monotonic() + FLEET_LEG_SECS
            while not pred():
                if errors:
                    raise AssertionError("{} during {}".format(errors, what))
                if time.monotonic() > deadline:
                    raise AssertionError("waited {} s for {}: {}".format(
                        FLEET_LEG_SECS, what, json.dumps(ctl.status())))
                time.sleep(FLEET_POLL_SECS)
                now, nodes = time.time(), metrics()
                for r in rids:
                    v = str(nodes.get(r, {}).get("serving_model_version"))
                    if v != current[r]:
                        current[r] = v
                        flips.append((now, r, v))
            return time.time()

        # the rollback leg: a poisoned version 2
        t_poison = time.time()
        registry.publish(FLEET_MODEL, "2", v2, model_config=config,
                         status="staging")
        walk_until("the poisoned version's rollback",
                   lambda: ("reverted", FLEET_MODEL, "2") in ctl.decisions)
        t_back = walk_until("the canary replica back on version 1",
                            lambda: all(v == "1" for v in current.values()))
        # the promotion leg: the trained version, published by
        # fit_supervised(publish=), published here as staging
        t_publish = time.time()
        registry.publish(FLEET_MODEL, trained, published["export_dir"],
                         model_config=config, status="staging")
        walk_until("the trained version kept",
                   lambda: ("kept", FLEET_MODEL, trained) in ctl.decisions)
        t_live = walk_until("both replicas on the trained version",
                            lambda: all(v == trained
                                        for v in current.values()))
        fleet_after = json.loads(http_get(base + "/fleet")[0])
        stop_clients.set()
        for t in threads:
            t.join(FLEET_LEG_SECS)
        if any(t.is_alive() for t in threads) or errors:
            raise AssertionError("clients: {}".format(errors or "hung"))
        ctl.stop()

        # each replica answers on its own, from the trained version
        direct = {}

        def ask(i, rid):
            ch = gateway.GatewayChannel(router.replicas()[rid]["addr"],
                                        timeout=FLEET_LEG_SECS)
            try:
                got = ch.predict({"tokens": rows[i]}, 1)["output"]
            finally:
                ch.close()
            direct[rid] = {"row": i, "version": classify(i, got),
                           "max_abs_diff": float(np.abs(
                               got - refs[trained][i]).max())}

        askers = [threading.Thread(target=ask, args=(i, rid))
                  for i, rid in enumerate(rids)]
        for t in askers:
            t.start()
        for t in askers:
            t.join(FLEET_LEG_SECS)
        served = len(results) + len(direct)
        nodes = wait_until("the replicas' last beats", lambda: (
            lambda n: n if sum(n[r].get("serving_requests", 0)
                               for r in rids) >= served else None)(metrics()),
            FLEET_LEG_SECS, FLEET_POLL_SECS)
        launches, exit_codes = {}, {}
        for rid, proc in procs.items():
            proc.send_signal(signal.SIGTERM)
        for rid, proc in procs.items():
            exit_codes[rid] = proc.wait(CLI_EXIT_SECS)
            tail = proc.stdout.read().strip().splitlines()
            launches[rid] = json.loads(tail[-1])["fwd_launches"]
        statuses = {v: registry.resolve(FLEET_MODEL, v)["status"]
                    for v in ("1", "2", trained)}
        replay = fleet.replay_journal(journal_path)
        with open(journal_path) as f:
            stages = [r for r in map(json.loads, f)
                      if r.get("kind") == "stage"]
    finally:
        stop_clients.set()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
        if ctl is not None:
            ctl.stop()
        if obs is not None:
            obs.stop()
        if resv is not None:
            resv.stop()
        if registry is not None:
            registry.close()
        shutil.rmtree(tmp, ignore_errors=True)

    def stage_time(stage, version):
        return next((r["time"] for r in stages if r["stage"] == stage
                     and r["version"] == version), None)

    def since(t0, t):
        return None if t is None else t - t0

    def first_flip(version, after):
        return next((t for t, _, v in flips if v == version and t >= after),
                    None)

    canary_replica = next(r["replica"] for r in stages
                          if r["stage"] == "proposed"
                          and r["version"] == trained)
    # a nonfinite answer is version 2's only if it was answered after the
    # controller proposed version 2 and asked for before the canary replica
    # was seen back on version 1; any other stays NONFINITE and fails below
    poison_replica = next((r["replica"] for r in stages
                           if r["stage"] == "proposed"
                           and r["version"] == "2"), None)
    t_proposed = stage_time("proposed", "2")
    for r in results:
        if (r["version"] == NONFINITE and t_proposed is not None
                and r["done"] >= t_proposed and r["sent"] < t_back):
            r["version"] = "2"
    rungs = len(serving.bucket_ladder(FLEET_BATCH))
    batches = {r: nodes[r]["serving_batches"] for r in rids}
    expected = {r: (layers * (rungs + batches[r]) if device is None else 0)
                for r in rids}
    by_version = {}
    for r in results:
        by_version.setdefault(str(r["version"]), []).append(r["latency_s"])
    row = {"phase": "fleet", "config": config, "max_batch": FLEET_BATCH,
           "clients": FLEET_CLIENTS, "canary": FLEET_CANARY,
           "poison_ln_f_scale": FLEET_POISON_SCALE,
           "trained_version": trained,
           "replica_ready_s": ready_s,
           "ready_lines": {r: line.strip() for r, line in ready_lines.items()},
           "poisoned": {
               "canary_replica": poison_replica,
               "s_publish_to_swapped": since(t_poison, first_flip(
                   "2", t_poison)),
               "s_publish_to_proposed": since(t_poison, stage_time(
                   "proposed", "2")),
               "s_publish_to_canary": since(t_poison, stage_time(
                   "applied", "2")),
               "s_publish_to_rolled_back": since(t_poison, stage_time(
                   "reverted", "2")),
               "s_publish_to_replica_back_on_1": t_back - t_poison},
           "registry_statuses": statuses,
           "trained": {
               "canary_replica": canary_replica,
               "s_publish_to_swapped": since(t_publish, first_flip(
                   trained, t_publish)),
               "s_publish_to_canary": since(t_publish, stage_time(
                   "applied", trained)),
               "s_publish_to_kept": since(t_publish, stage_time(
                   "kept", trained)),
               "s_publish_to_live_on_both": t_live - t_publish},
           "flips_s_after_poison_publish": [(t - t_poison, r, v)
                                            for t, r, v in flips],
           "requests": len(results),
           "answers_by_version": {v: len(xs) for v, xs in by_version.items()},
           "latency_s_by_version": {v: percentiles(xs)
                                    for v, xs in by_version.items()},
           "requests_served_by_replica": {
               r: nodes[r].get("serving_requests") for r in rids},
           "router_picks": dict(router.picks),
           "serving_batches": batches,
           "serving_nonfinite": {r: nodes[r].get("serving_nonfinite")
                                 for r in rids},
           "serving_swaps": {r: nodes[r].get("serving_swaps") for r in rids},
           "serving_compiles": {r: (compiles0[r],
                                    nodes[r].get("serving_compiles"))
                                for r in rids},
           "direct_after_promote": direct, "tol": tol,
           "fwd_launches": launches, "expected_launches": expected,
           "exit_codes": exit_codes,
           "fleet_default": (fleet_before["registry"][FLEET_MODEL]["default"],
                             fleet_after["registry"][FLEET_MODEL]["default"]),
           "decisions": [list(d) for d in replay["journaled"]],
           "replay_matches": replay["matches"],
           "phase_s": time.perf_counter() - t_start}
    emit(row)

    if replay["journaled"] != [("reverted", FLEET_MODEL, "2"),
                               ("kept", FLEET_MODEL, trained)] \
            or not replay["matches"]:
        raise AssertionError("canary decisions {} (replayed {})".format(
            replay["journaled"], replay["decisions"]))
    unmatched = [r for r in results if r["version"] is None]
    if unmatched:
        raise AssertionError("{} answers match no version's reference "
                             "within {}: {}".format(len(unmatched), tol,
                                                    unmatched[:3]))
    stray = [r for r in results if r["version"] == NONFINITE]
    if stray:
        raise AssertionError("{} nonfinite answers outside version 2's "
                             "canary window: {}".format(len(stray),
                                                        stray[:3]))
    # only the replica that held version 2 may have served nonfinite rows
    if not row["serving_nonfinite"].get(poison_replica) or any(
            n for r, n in row["serving_nonfinite"].items()
            if r != poison_replica):
        raise AssertionError("nonfinite rows by replica {} (version 2 on "
                             "{})".format(row["serving_nonfinite"],
                                          poison_replica))
    late_poison = [r for r in results if r["version"] == "2"
                   and r["sent"] >= t_back]
    if late_poison:
        raise AssertionError("version 2 answered after its rollback: "
                             "{}".format(late_poison[:3]))
    stale = [r for r in results if r["sent"] >= t_live
             and r["version"] != trained]
    if stale or not all(d["version"] == trained
                        and d["max_abs_diff"] <= tol
                        for d in direct.values()) or len(direct) != 2:
        raise AssertionError("after the promote: {} {}".format(stale[:3],
                                                               direct))
    if row["fleet_default"] != ("1", trained) or statuses != {
            "1": "retired", "2": "retired", trained: "live"}:
        raise AssertionError("/fleet showed the default {}; statuses "
                             "{}".format(row["fleet_default"], statuses))
    if any(c[0] != c[1] for c in row["serving_compiles"].values()):
        raise AssertionError("a replica compiled through the swaps: "
                             "{}".format(row["serving_compiles"]))
    if launches != expected:
        raise AssertionError("replica flash_fwd launches {}, expected "
                             "layers x (warm rungs + serving_batches) "
                             "{}".format(launches, expected))
    if any(c != 0 for c in exit_codes.values()):
        raise AssertionError("replica exit codes {}".format(exit_codes))
    return row


# -- the warm-start compile plane (compilecache): a served rung compiled by
# AOTInductor then loaded, a cluster's kernels built then installed
WARM_STEPS = 10               # two K = 5 dispatches a cluster
WARM_LOG_STEPS = 5
WARM_READY_SECS = 900         # the cold replica compiles its rung first
WARM_REPORT_SECS = 300
WARM_SCRAPE_SECS = 60
WARM_HEARTBEAT_SECS = 0.5
WARM_HEARTBEAT_MISSES = 60


class WarmFeed(NgramFeed):
    """The warm-start leg's stream in groups of K (the config's vocab and
    sequence), each group's pull time kept: the second pull comes when the
    first dispatch is over."""

    def __init__(self, np, config, pulls):
        super().__init__(np, 0, TRAIN_BATCH, config["max_seq_len"],
                         config["vocab_size"])
        self.pulls = pulls

    def grouped_batches(self, k):
        while not self.terminated:
            self.pulls.append(time.time())
            yield ("multi",) + self.next_group(k)


def warmstart_main(args, ctx):
    """The warm-start leg's user fn, in the child the node forked, which
    configured the compile root from ``cluster_meta`` before this ran:
    ``fit_supervised`` at K = 5 on a fresh checkpoint root, the Trainer's
    store under the compile root.  Nothing here builds a kernel: the
    store's resolution builds or installs them.  Reports the losses, the
    verdicts, the compile plane's counters, the launches, the first
    dispatch's end and ``train_compile_us_max``, then stays up (beating)
    until the stop file appears."""
    import importlib
    import traceback

    report = {"fn_start": time.time()}
    try:
        import numpy as np
        import torch

        from tensorflowonspark_torch import checkpoint, compilecache, train
        from tensorflowonspark_torch.models import transformer
        from tensorflowonspark_torch.ops import _build

        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        device = ctx.initialize_distributed(device=args["device"])
        model = control_lm(torch, args["config"], device)
        curve, pulls = LossCurve(), []
        root = compilecache.configured_dir()
        trainer = control_trainer(
            args, transformer.loss_fn(model), dict(model.state_dict()),
            device, WARM_LOG_STEPS, summary_writer=curve,
            aot_cache=os.path.join(root, "aot"))
        del model
        ckpt = checkpoint.CheckpointManager(args["ckpt_dir"],
                                            save_interval_steps=WARM_STEPS)
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        train.fit_supervised(trainer, lambda: WarmFeed(np, args["config"],
                                                       pulls),
                             ckpt, max_steps=WARM_STEPS,
                             steps_per_call=MEGA_K)              # the path
        report["launches"] = launches_of(fa)                    # its end
        ckpt.close()
        snap = trainer.counters_snapshot()
        report.update({
            "compile_root": root, "steps": trainer.state.step,
            "losses": {str(k): v for k, v in sorted(curve.losses.items())},
            "verdicts": dict(trainer._aot_verdicts),
            "cache": compilecache.stats.counters_snapshot(),
            "nvcc_runs": _build.nvcc_runs, "kernels_loaded": _build.loaded(),
            "first_dispatch_end": pulls[1] if len(pulls) > 1 else None,
            "train_compile_us_max": snap.get("train_compile_us_max")})
    except Exception:
        report["error"] = traceback.format_exc()
        raise
    finally:
        write_report(args["report"], report)
    deadline = time.monotonic() + WARM_REPORT_SECS
    while not os.path.exists(args["stop"]) and time.monotonic() < deadline:
        time.sleep(0.2)


def warmstart_cluster(np, config, device, root, tmp, name):
    """One SPARK cluster of one executor over the compile root ``root``:
    ``warmstart_main``'s report, the seconds (this process's clock) from
    ``cluster.run`` to the first dispatch's end, and
    ``tfos_compile_cache_hit_total`` from a live ``/metrics`` scrape."""
    from tensorflowonspark_torch import backend, cluster

    args = {"config": config, "device": device, "lr": LR,
            "ckpt_dir": os.path.join(tmp, name + "_ckpt"),
            "report": os.path.join(tmp, name + ".json"),
            "stop": os.path.join(tmp, name + ".stop")}
    b = backend.LocalBackend(1)
    try:
        t0 = time.time()
        c = cluster.run(b, warmstart_main, args, num_executors=1,
                        input_mode=cluster.InputMode.SPARK,
                        log_dir=os.path.join(tmp, name), telemetry=True,
                        observatory=True, compile_cache_dir=root,
                        heartbeat_interval=WARM_HEARTBEAT_SECS,
                        heartbeat_misses=WARM_HEARTBEAT_MISSES)
        try:
            report = wait_for_report(args["report"], WARM_REPORT_SECS)
            base = "http://127.0.0.1:%d" % c.observatory.addr[1]
            hits = wait_until(
                "tfos_compile_cache_hit_total on /metrics",
                lambda: node_metrics(base)[2].get(
                    'tfos_compile_cache_hit_total{executor="0"}'),
                WARM_SCRAPE_SECS) if report["cache"][
                    "compile_cache_hit"] else 0.0
        finally:
            with open(args["stop"], "w"):
                pass
        c.shutdown(grace_secs=1)
    finally:
        b.stop()
    first = report["first_dispatch_end"]
    report.update({"first_dispatch_s": None if first is None else first - t0,
                   "metrics_hits": hits})
    return report


class Replica(object):
    """One ``inference_cli --serve`` replica on the roster: started at
    once; a thread reads its ready line as it comes, so its ready seconds
    hold while this process does other work."""

    def __init__(self, argv, rid, roster, env, log_path):
        import threading

        self.rid, self.log_path = rid, log_path
        self.t0 = time.perf_counter()
        with open(log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", CLI_WRAPPER, "--serve",
                 "--max-batch", "1", "--port", "0", "--roster", roster,
                 "--replica-id", rid, "--heartbeat",
                 str(WARM_HEARTBEAT_SECS)] + argv,
                cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=log,
                text=True)
        self.ready, self.ready_s = None, None
        self.reader = threading.Thread(target=self._read_ready, daemon=True)
        self.reader.start()

    def _read_ready(self):
        self.ready = self.proc.stdout.readline()
        self.ready_s = time.perf_counter() - self.t0

    def finish(self, feed, resv):
        """Its ready seconds, its roster registration's rung verdicts and
        a beat's counters, its answer to the one-row ``feed``, and the
        flash launches it printed at exit (SIGTERM)."""
        import signal

        from tensorflowonspark_torch import gateway

        try:
            self.reader.join(WARM_READY_SECS)
            if not self.ready or "ready on" not in self.ready:
                raise AssertionError("{}: no ready line: {!r}\n{}".format(
                    self.rid, self.ready, open(self.log_path).read()[-4000:]))

            def beat_of():
                snap = resv.metrics_snapshot()["nodes"].get(self.rid, {})
                return snap if "serving_compiles" in snap else None

            beat = wait_until(self.rid + "'s counters in a beat", beat_of,
                              WARM_SCRAPE_SECS)
            report = next(r for r in resv.reservations.get()
                          if r["executor_id"] == self.rid)["warmup"]
            ch = gateway.GatewayChannel(
                self.ready.split("ready on ")[1].split()[0],
                timeout=WARM_READY_SECS)
            try:
                t1 = time.perf_counter()
                got = ch.predict(feed, 1)["output"]
                request_s = time.perf_counter() - t1
            finally:
                ch.close()
            self.proc.send_signal(signal.SIGTERM)
            code = self.proc.wait(CLI_EXIT_SECS)
            tail = self.proc.stdout.read()
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        return {"ready_s": self.ready_s, "request_s": request_s,
                "exit_code": code,
                "verdicts": [b["verdict"] for b in report["buckets"]],
                "warmup_s": report["buckets"][0]["micros"] / 1e6,
                "compiles": beat.get("serving_compiles"),
                "cache": {k: v for k, v in beat.items()
                          if k.startswith("compile_cache_")},
                "fwd_launches": json.loads(tail.strip().splitlines()[-1])[
                    "fwd_launches"]}, got

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def start_warmstart(torch, np, config=LM_CONFIG, device=None):
    """The warm-start phase's first step, taken before the fleet phase so
    that the cold replica's AOTInductor compile runs beside it: the LM
    export, a registry entry carrying ``warm_dir=W``, the roster, and
    ``inference_cli --serve --warm-cache-dir W`` on a fresh ``W``.  Returns
    what :func:`phase_warmstart` continues from (:func:`stop_warmstart`
    ends it where that never runs)."""
    from tensorflowonspark_torch import fleet, reservation

    started = {"config": config, "device": device, "cold": None,
               "resv": None, "tmp": tempfile.mkdtemp(prefix="chip-warm-")}
    try:
        tmp = started["tmp"]
        started["on"] = [] if device is None else ["--device", device]
        started["env"] = env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
        env.pop("TFOS_COMPILE_CACHE_DIR", None)
        started["lm"] = lm = export_lm(torch, os.path.join(tmp, "lm"), 0,
                                       config)
        started["warm_dir"] = warm_dir = os.path.join(tmp, "serve_root")
        registry = fleet.ModelRegistry(os.path.join(tmp, "registry"),
                                       publisher="chip-smoke")
        registry.publish(FLEET_MODEL, "1", lm, model_config=config,
                         warm_dir=warm_dir, status="live")
        registry.close()
        started["registry"] = registry.root
        started["resv"] = resv = reservation.Server(
            2, heartbeat_interval=WARM_HEARTBEAT_SECS,
            heartbeat_misses=WARM_HEARTBEAT_MISSES)
        started["roster"] = roster = "%s:%d" % resv.start()
        started["cold"] = Replica(
            ["--export_dir", lm, "--warm-cache-dir", warm_dir]
            + started["on"], "warm-cold", roster, env,
            os.path.join(tmp, "cold.log"))
    except BaseException:
        stop_warmstart(started)
        raise
    return started


def stop_warmstart(started, replicas=()):
    """Stop what :func:`start_warmstart` (and the phase) started."""
    for replica in (started.get("cold"),) + tuple(replicas):
        if replica is not None:
            replica.stop()
    if started.get("resv") is not None:
        started["resv"].stop()
        started["resv"] = None
    shutil.rmtree(started["tmp"], ignore_errors=True)


def phase_warmstart(torch, np, started):
    """The warm-start compile plane on the card.  Serving: the cold
    ``inference_cli --serve --warm-cache-dir W`` replica of
    :func:`start_warmstart` compiled its rung with AOTInductor (verdict
    ``compiled``, one compile); a second replica through ``--registry R
    --model`` whose entry carries ``warm_dir=W`` loads it (``loaded``, no
    compile) and answers bit for bit as the cold one, both within the
    serve tolerance of an eager ``ModelServer``.  Training: a cluster on a
    fresh compile root ``C`` builds the kernels (misses, ``nvcc``;
    verdicts ``compiled``), a second cluster on ``C`` with a fresh
    checkpoint root installs them (hits, no ``nvcc``; ``loaded``; the hits
    on a live ``/metrics``) and trains to the cold run's losses bit for
    bit.  The cold replica compiles while the fleet phase runs, and the
    replicas' part runs on a thread beside the eager reference and the
    clusters: their seconds are taken beside one another.
    ``device="cpu"`` rehearses it on the CPU (no kernels there: no misses
    or hits to hold)."""
    from tensorflowonspark_torch import serving as serving_mod

    config, device = started["config"], started["device"]
    layers, seq = config["num_layers"], config["max_seq_len"]
    feed = {"tokens": np.random.default_rng(11).integers(
        0, config["vocab_size"], (1, seq), dtype=np.int32)}
    if device is None:
        torch.cuda.empty_cache()
    tmp, cold, resv = started["tmp"], started["cold"], started["resv"]
    replicas, serve, outs, failed = [], {}, {}, []

    def serving():
        """The replicas' part, beside the clusters: once the cold replica
        is ready (its rung stored), the warm one starts; each answers one
        row and exits."""
        try:
            cold.reader.join(WARM_READY_SECS)
            replicas.append(Replica(
                ["--registry", started["registry"], "--model",
                 FLEET_MODEL] + started["on"], "warm-registry",
                started["roster"], started["env"],
                os.path.join(tmp, "warm.log")))
            serve["cold"], outs["cold"] = cold.finish(feed, resv)
            serve["warm"], outs["warm"] = replicas[0].finish(feed, resv)
        except BaseException:
            import traceback

            failed.append(traceback.format_exc())

    import threading

    thread = threading.Thread(target=serving, daemon=True)
    try:
        thread.start()
        server = serving_mod.ModelServer(started["lm"], batch_size=1,
                                         device=device)
        want = server.predict_feed(feed, 1)["output"]
        del server
        if device is None:
            torch.cuda.empty_cache()
        train_root = os.path.join(tmp, "train_root")
        runs = {name: warmstart_cluster(np, config, device, train_root, tmp,
                                        name)
                for name in ("cold", "warm")}
        thread.join(2 * WARM_READY_SECS)
        if failed or thread.is_alive():
            raise AssertionError("warmstart: the replicas failed: {}".format(
                failed or "still running"))
        diff_cold, scale = logit_diff(np, outs["cold"], want)
        diff_warm, _ = logit_diff(np, outs["warm"], want)
        serve.update({
            "bit_equal": bool(np.array_equal(outs["cold"], outs["warm"])),
            "vs_eager_max_abs_diff": {"cold": diff_cold, "warm": diff_warm},
            "max_abs_logit": scale, "tol": LOGIT_TOL * scale,
            "artifact_bytes": os.path.getsize(os.path.join(
                started["warm_dir"], "serving_b1.aotx"))})
    finally:
        stop_warmstart(started, tuple(replicas))
        thread.join(CLI_EXIT_SECS)
    cold, warm = runs["cold"], runs["warm"]
    train = {name: {k: run.get(k) for k in (
        "verdicts", "nvcc_runs", "kernels_loaded", "first_dispatch_s",
        "train_compile_us_max", "metrics_hits", "launches", "steps")}
        for name, run in runs.items()}
    for name, run in runs.items():
        train[name]["cache"] = {k: run["cache"][k] for k in (
            "compile_cache_hit", "compile_cache_miss",
            "compile_cache_saved_us", "compile_cache_retrieval_us",
            "compile_cache_aot_load", "compile_cache_aot_save",
            "compile_cache_aot_load_us", "compile_cache_aot_compile_us",
            "compile_cache_fallback")}
    train["losses_bit_equal"] = cold["losses"] == warm["losses"]
    train["losses"] = cold["losses"]
    row = {"phase": "warmstart", "config": config, "serve": serve,
           "train": train}
    emit(row)
    steps = WARM_STEPS
    failures = []
    card = device is None
    if serve["cold"]["verdicts"] != ["compiled"] or \
            serve["cold"]["compiles"] != 1:
        failures.append("the cold replica did not compile its rung")
    if serve["warm"]["verdicts"] != ["loaded"] or \
            serve["warm"]["compiles"] != 0:
        failures.append("the warm replica did not load its rung")
    if not serve["bit_equal"]:
        failures.append("warm logits differ from the cold replica's")
    if not max(serve["vs_eager_max_abs_diff"].values()) <= serve["tol"]:
        failures.append("a replica is off the eager forward")
    if any(serve[n]["exit_code"] != 0 for n in ("cold", "warm")):
        failures.append("a replica did not exit 0 on SIGTERM")
    if card and any(serve[n]["fwd_launches"] != layers
                    for n in ("cold", "warm")):
        failures.append("a replica did not launch flash_fwd once a layer")
    program = "multi_%d" % MEGA_K
    if cold["verdicts"] != {program: "compiled"} or \
            warm["verdicts"] != {program: "loaded"}:
        failures.append("train verdicts {} then {}".format(
            cold["verdicts"], warm["verdicts"]))
    if card and not (cold["cache"]["compile_cache_miss"] >= 2
                     and cold["nvcc_runs"] >= 2):
        failures.append("the cold cluster built no kernels")
    if card and not (warm["cache"]["compile_cache_hit"] >= 2
                     and warm["cache"]["compile_cache_miss"] == 0
                     and warm["nvcc_runs"] == 0
                     and warm["metrics_hits"] > 0):
        failures.append("the warm cluster did not install its kernels")
    if not train["losses_bit_equal"] or len(cold["losses"]) != steps:
        failures.append("warm losses differ from the cold run's")
    if card and any(n != layers * steps for run in (cold, warm)
                    for n in run["launches"].values()):
        failures.append("a cluster's launches are not layers x steps")
    if failures:
        raise AssertionError("warmstart: {}: {}".format(
            "; ".join(failures), row))
    return row


# -- export: the serving artifact and the C++ runner ---------------------------

# the embedded package's fixed batch: the serve phase's top rung; the
# runner serves EXPORT_NATIVE_ROWS rows in batches of it (two batches, the
# last three rows of the second padding)
EXPORT_EMBED_BATCH = SERVE_BATCH
EXPORT_NATIVE_ROWS = 5
# inference_cli --native writes each row's logits as JSON numbers: at the
# flagship's vocab a row is 32.8M of them (hundreds of MB of text), so the
# CLI leg serves a one-layer LM of the flagship's attention width with a
# 256-token vocab (the kernel at the serve shape, a row 262144 numbers)
EXPORT_CLI_CONFIG = dict(LM_CONFIG, num_layers=1, vocab_size=256)
EXPORT_CLI_ROWS = 3
# the export process's budget: the native builds, two torch.export runs,
# two AOTInductor compiles, and the runner, CLI and binding legs
EXPORT_SECS = 1200
EXPORT_LEG_SECS = 600
# the C++ binding against the Python op, bit for bit (one kernel, the same
# inputs): the serve shape, head_dim 32 and 128 on the tensor cores, and
# fp32 head_dim 32 (zero-padded to 64 by both wrappers)
BINDING_CASES = [
    ((SERVE_BATCH, SEQ, 16, 64), "bfloat16", True, True),
    ((2, 256, 4, 32), "bfloat16", True, False),
    ((2, 256, 4, 128), "bfloat16", True, False),
    ((2, 256, 4, 32), "float32", False, False),
]

# ``python -m tensorflowonspark_torch.inference_cli`` (the same runpy
# entry) with INFO logging on stderr, where the runner's own line lands
NATIVE_CLI_WRAPPER = """
import logging, runpy, sys
logging.basicConfig(level=logging.INFO)
sys.argv = ["tensorflowonspark_torch.inference_cli"] + sys.argv[1:]
runpy.run_module("tensorflowonspark_torch.inference_cli", run_name="__main__",
                 alter_sys=True)
"""

# a process with no Python op: the C++ registration (argv[1]) computes
# the forward of every case in argv[2] on the cases' device and saves
# the outputs and its launch and call counts to argv[3]
BINDING_CHILD = """
import ctypes, sys
import torch
torch.ops.load_library(sys.argv[1])
lib = ctypes.CDLL(sys.argv[1])
lib.tfos_flash_fwd_launches.restype = ctypes.c_longlong
lib.tfos_flash_fwd_calls.restype = ctypes.c_longlong
outs = []
for qkv, fused, scale, causal, device in torch.load(sys.argv[2]):
    qkv = qkv.to(device)
    q, k, v = (qkv.unbind(2) if fused else
               [qkv[:, :, i].contiguous() for i in range(3)])
    o, lse = torch.ops.tfos.flash_fwd(q, k, v, scale, causal)
    outs.append((o.cpu(), lse.cpu()))
torch.save({"outs": outs, "launches": lib.tfos_flash_fwd_launches(),
            "calls": lib.tfos_flash_fwd_calls()}, sys.argv[3])
"""


def registry_view(export_dir, path):
    """``export_dir`` without its serialized programs (its params linked):
    what a ``ModelServer`` rebuilds from the registry."""
    os.makedirs(path)
    os.symlink(os.path.join(export_dir, "params.pt"),
               os.path.join(path, "params.pt"))
    with open(os.path.join(export_dir, "export.json")) as f:
        desc = json.load(f)
    for key in ("exported", "embedded_pt2"):
        desc.pop(key, None)
    with open(os.path.join(path, "export.json"), "w") as f:
        json.dump(desc, f)
    return path


def worst_diff(np, got, want):
    """``(max |got - want|, max |want|)`` over pairs of arrays."""
    return max(logit_diff(np, g, w) for g, w in zip(got, want))


def native_leg(np, export_dir, tmp, device):
    """The C++ runner on the LM's embedded package: :data:`EXPORT_NATIVE_ROWS`
    rows in batches of :data:`EXPORT_EMBED_BATCH` through one runner
    process, against an eager registry ``ModelServer`` on the same padded
    batches."""
    from tensorflowonspark_torch import serving

    with open(os.path.join(export_dir, "export.json")) as f:
        desc = json.load(f)
    vocab = desc["model_config"]["vocab_size"]
    seq = desc["embedded_pt2"]["inputs"][0]["shape"][1]
    batches = -(-EXPORT_NATIVE_ROWS // EXPORT_EMBED_BATCH)
    padded = np.zeros((batches * EXPORT_EMBED_BATCH, seq), np.int32)
    padded[:EXPORT_NATIVE_ROWS] = np.random.default_rng(10).integers(
        0, vocab, (EXPORT_NATIVE_ROWS, seq), dtype=np.int32)
    feeds = [{"tokens": padded[i:i + EXPORT_EMBED_BATCH]}
             for i in range(0, len(padded), EXPORT_EMBED_BATCH)]
    report = {}
    t0 = time.perf_counter()
    outs = serving.run_embedded_native_many(export_dir, feeds, device=device,
                                            report=report)
    seconds = time.perf_counter() - t0
    eager = serving.ModelServer(registry_view(
        export_dir, os.path.join(tmp, "native_eager")),
        batch_size=EXPORT_EMBED_BATCH, device=device)
    diff, scale = worst_diff(
        np, [o["output"] for o in outs],
        [eager.predict_feed(f, EXPORT_EMBED_BATCH)["output"] for f in feeds])
    return {"rows": EXPORT_NATIVE_ROWS, "batches": batches,
            "report": report, "seconds": seconds,
            "eager_from_artifact": eager.from_artifact,
            "vs_eager_max_abs_diff": diff, "max_abs_logit": scale}


def cli_leg(np, export_dir, tmp, device):
    """``inference_cli --native`` over :data:`EXPORT_CLI_ROWS` TFRecord
    rows of the CLI leg's LM, its JSON lines against an eager registry
    ``ModelServer`` on the same rows."""
    from tensorflowonspark_torch import dfutil, serving

    with open(os.path.join(export_dir, "export.json")) as f:
        desc = json.load(f)
    vocab = desc["model_config"]["vocab_size"]
    seq = desc["embedded_pt2"]["inputs"][0]["shape"][1]
    tokens = np.random.default_rng(11).integers(
        0, vocab, (EXPORT_CLI_ROWS, seq), dtype=np.int32)
    data, out = os.path.join(tmp, "tfr"), os.path.join(tmp, "cli.jsonl")
    dfutil.save_as_tfrecords([{"tokens": t.tolist()} for t in tokens], data,
                             schema={"tokens": "array<int64>"})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", NATIVE_CLI_WRAPPER,
         "--export_dir", export_dir, "--input", data, "--schema_hint",
         "struct<tokens:array<bigint>>", "--native", "--output", out,
         "--device", device or "cuda"], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=EXPORT_LEG_SECS)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("inference_cli --native failed:\n"
                             + proc.stderr[-3000:])
    reports = [json.loads(line.split("aoti_runner report: ", 1)[1])
               for line in proc.stderr.splitlines()
               if "aoti_runner report: " in line]
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    eager = serving.ModelServer(registry_view(
        export_dir, os.path.join(tmp, "cli_eager")),
        batch_size=EXPORT_EMBED_BATCH, device=device)
    want = eager.predict_feed({"tokens": tokens}, len(tokens))["output"]
    diff, scale = worst_diff(
        np, [np.asarray(line["output"], np.float32) for line in lines],
        list(want))
    return {"config": desc["model_config"], "rows": EXPORT_CLI_ROWS,
            "lines": len(lines), "rows_kept": all(
                line["tokens"] == t.tolist() for line, t in zip(lines, tokens)),
            "runner_reports": reports, "seconds": seconds,
            "vs_eager_max_abs_diff": diff, "max_abs_logit": scale}


def binding_leg(torch, np, lib, tmp, device):
    """The C++ registration (``lib``) against the Python op on
    :data:`BINDING_CASES`: the C++ side in a process with no Python op
    (:data:`BINDING_CHILD`), the Python side here, bit for bit."""
    cases = []
    for shape, dtype_name, causal, fused in BINDING_CASES:
        b, s, h, d = shape
        x = np.random.default_rng(d).standard_normal((b, s, 3, h, d))
        cases.append((torch.from_numpy(x.astype(np.float32)).to(
            getattr(torch, dtype_name)), fused, 1.0 / math.sqrt(d), causal,
            "cpu" if device == "cpu" else "cuda"))
    src, dst = os.path.join(tmp, "cases.pt"), os.path.join(tmp, "outs.pt")
    torch.save(cases, src)
    proc = subprocess.run([sys.executable, "-c", BINDING_CHILD, lib, src,
                           dst], cwd=HERE, capture_output=True, text=True,
                          timeout=EXPORT_LEG_SECS)
    if proc.returncode != 0:
        raise AssertionError("the C++ binding's process failed:\n"
                             + proc.stderr[-3000:])
    bound = torch.load(dst)
    equal = []
    for (qkv, fused, scale, causal, dev), (o, lse) in zip(cases,
                                                         bound["outs"]):
        qkv = qkv.to(dev)
        q, k, v = (qkv.unbind(2) if fused else
                   [qkv[:, :, i].contiguous() for i in range(3)])
        want_o, want_lse = torch.ops.tfos.flash_fwd(q, k, v, scale, causal)
        equal.append(bool(torch.equal(o, want_o.cpu())
                          and torch.equal(lse, want_lse.cpu())))
    return {"cases": [list(c) for c in BINDING_CASES], "bit_equal": equal,
            "launches": bound["launches"], "calls": bound["calls"]}


def export_main(out, device=None, config=LM_CONFIG,
                cli_config=EXPORT_CLI_CONFIG):
    """The export process (:func:`start_export`), at ``nice`` 10 so that
    the phases beside it keep the host's cores: builds the runner and the
    operator library, exports the LM at ``config`` and the CLI leg's LM,
    each with its artifact and its embedded package for ``device``'s type
    (the card's unless ``"cpu"``), then runs the legs that need no count
    of this process's launches, side by side: the runner
    (:func:`native_leg`), the CLI (:func:`cli_leg`) and the binding
    (:func:`binding_leg`), each in processes of its own.  Writes what it
    took and found to ``out/report.json``."""
    import numpy as np
    import torch

    # dfutil too: the legs' threads import nothing a second time at once
    from tensorflowonspark_torch import checkpoint, dfutil, serving  # noqa
    from tensorflowonspark_torch.models import get_model
    from tensorflowonspark_torch.ops import _build

    os.nice(10)
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {}
    t0 = time.perf_counter()
    built = _build.build_native()
    report["native_build_s"] = time.perf_counter() - t0
    report["native_build"] = {n: {k: r[k] for k in ("seconds", "cached")}
                              for n, r in built.items()}
    seconds = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = time.perf_counter() - t
        return run

    plain = serving.serialize_apply, serving.serialize_embedded
    serving.serialize_apply = timed("torch_export_s", plain[0])
    serving.serialize_embedded = timed("embedded_s", plain[1])
    try:
        for name, cfg, seed in (("lm", config, 0), ("cli", cli_config, 1)):
            path = os.path.join(out, name)
            model = get_model("transformer_lm", **cfg)
            model.init_weights(torch.Generator().manual_seed(seed))
            seconds.clear()
            t = time.perf_counter()
            checkpoint.export_model(
                path, model, "transformer_lm", model_config=cfg,
                input_signature=lm_signature(cfg), model=model,
                embed_batch_size=EXPORT_EMBED_BATCH,
                embed_platform="cpu" if device == "cpu" else "cuda")
            report[name] = dict(seconds, export_s=time.perf_counter() - t,
                                bytes={f: os.path.getsize(
                                    os.path.join(path, f))
                                    for f in sorted(os.listdir(path))})
            del model
    finally:
        serving.serialize_apply, serving.serialize_embedded = plain
    def leg(fn, *args):
        def run():
            t = time.perf_counter()
            return dict(fn(*args), leg_s=time.perf_counter() - t)
        return Leg(run, EXPORT_LEG_SECS)

    with tempfile.TemporaryDirectory() as tmp:
        # the three legs side by side, each in processes of its own
        legs = {"native": leg(native_leg, np, os.path.join(out, "lm"), tmp,
                              device),
                "cli": leg(cli_leg, np, os.path.join(out, "cli"), tmp,
                           device),
                "binding": leg(binding_leg, torch, np,
                               built["flash_ops"]["path"], tmp, device)}
        for name, running in legs.items():
            report[name] = running.result()
    report["process_s"] = time.perf_counter() - t0
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f)


def start_export(torch, np, config=LM_CONFIG, device=None):
    """The export phase's first step, started early so that its compiles
    and its runner, CLI and binding legs run beside the phases before it:
    :func:`export_main` in a process of its own.  Returns what
    :func:`phase_export` continues from."""
    out = tempfile.mkdtemp(prefix="chip-export-")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    code = ("import sys, chip_smoke; chip_smoke.export_main(sys.argv[1], "
            "{!r}, {!r}, {!r})".format(
                device, config, dict(EXPORT_CLI_CONFIG, **{
                    k: config[k] for k in ("head_dim", "num_heads",
                                           "max_seq_len", "dtype")})))
    log = open(os.path.join(out, "export.log"), "w")
    proc = subprocess.Popen([sys.executable, "-c", code, out], cwd=HERE,
                            env=env, stdout=log, stderr=subprocess.STDOUT)
    return {"proc": proc, "log": log, "out": out, "config": config,
            "device": device, "t0": time.perf_counter()}


def join_export(started):
    """Wait for the export process (at most :data:`EXPORT_SECS` after its
    start) and raise with its log's tail unless it succeeded.  The main
    path calls it before ``observability``, so that the phases from there
    on share the host with no compile."""
    if "waited_s" not in started:
        try:
            rc = started["proc"].wait(max(1.0, EXPORT_SECS - (
                time.perf_counter() - started["t0"])))
        except subprocess.TimeoutExpired:
            rc = None
        started["waited_s"] = time.perf_counter() - started["t0"]
        started["rc"] = rc
        started["log"].close()
    if started["rc"] != 0:
        with open(os.path.join(started["out"], "export.log")) as f:
            tail = f.read()[-4000:]
        raise AssertionError("the export process ended with {}:\n{}".format(
            started["rc"], tail))


def stop_export(started):
    """End what :func:`start_export` started."""
    if started["proc"].poll() is None:
        started["proc"].kill()
        started["proc"].wait()
    started["log"].close()
    shutil.rmtree(started["out"], ignore_errors=True)


class Leg(object):
    """``fn()`` on a thread, which :meth:`result` joins within ``seconds``
    and re-raises from: work in other processes beside this process's."""

    def __init__(self, fn, seconds):
        import threading

        self.value, self.error, self.seconds = None, None, seconds

        def run():
            try:
                self.value = fn()
            except BaseException as e:   # re-raised by result()
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def result(self):
        self.thread.join(self.seconds)
        if self.thread.is_alive():
            raise AssertionError("a leg ran past {} s".format(self.seconds))
        if self.error is not None:
            raise self.error
        return self.value


def export_launches(row):
    """The forward's launches on the export phase's main path: the
    artifact served in this process, the runner's and the CLI's runner's."""
    made = row["export_process"]
    return (row["artifact"]["fwd_launches"]
            + made["native"]["report"]["flash_fwd_launches"]
            + sum(r["flash_fwd_launches"]
                  for r in made["cli"]["runner_reports"]))


def phase_export(torch, np, fa, started):
    """The exported serving artifact and the C++ runner, on the LM of
    :func:`start_export` (``export_model(..., model=, embed_batch_size=4)``
    in its own process).  Here ``ModelServer`` serves every request of
    :data:`REQUESTS` from ``apply.pt2`` (``from_artifact``; rungs 4, 4, 4
    and 1), its logits within :data:`LOGIT_TOL` of an eager registry
    ``ModelServer`` on the same params and its forward launches equal to
    layers x dispatches, by the counter and by the profiler.  From the
    export process's report: the C++ runner served the embedded package
    with no Python (two batches of 4, launches layers x batches, logits
    within the same tolerance), ``inference_cli --native`` answered
    TFRecord rows as the eager server does, and the C++ binding equals the
    Python op bit for bit (``device="cpu"`` rehearses it all on the CPU,
    where nothing launches)."""
    from tensorflowonspark_torch import serving

    device, config = started["device"], started["config"]
    layers, vocab = config["num_layers"], config["vocab_size"]
    seq = config["max_seq_len"]
    join_export(started)
    with open(os.path.join(started["out"], "report.json")) as f:
        made = json.load(f)
    lm_dir = os.path.join(started["out"], "lm")
    with open(os.path.join(lm_dir, "export.json")) as f:
        desc = json.load(f)
    if not ("exported" in desc and "embedded_pt2" in desc):
        raise AssertionError("the export holds no artifact or no embedded "
                             "package: {}".format(sorted(desc)))
    rng = np.random.default_rng(9)
    requests = [rng.integers(0, vocab, (n, seq), dtype=np.int32)
                for n in REQUESTS]
    with tempfile.TemporaryDirectory() as tmp:
        card_memory(torch, device, reset=True)
        fa.fwd_launches = 0                          # the main path starts
        t0 = time.perf_counter()
        server = serving.ModelServer(lm_dir, batch_size=SERVE_BATCH,
                                     device=device)
        load_s = time.perf_counter() - t0
        latencies = []

        def main_path():
            outs = []
            for tokens in requests:
                t = time.perf_counter()
                outs.append(server.predict_feed({"tokens": tokens},
                                                len(tokens))["output"])
                latencies.append(time.perf_counter() - t)
            return outs

        outputs, executed, busy_ms = on_card(torch, main_path, device)
        launches = fa.fwd_launches                   # the main path ends
        peak_bytes = card_memory(torch, device)
        rungs = [serving.bucket_for(n, server.buckets) for n in REQUESTS]
        from_artifact, compiles = server.from_artifact, server.compile_count
        del server
        eager = serving.ModelServer(registry_view(
            lm_dir, os.path.join(tmp, "eager")), batch_size=SERVE_BATCH,
            device=device)
        eager_artifact = eager.from_artifact
        served = worst_diff(np, outputs, [
            eager.predict_feed({"tokens": t}, len(t))["output"]
            for t in requests])
        del eager
    native, cli, binding = made["native"], made["cli"], made["binding"]
    expected = layers * len(REQUESTS)
    expected_native = layers * native["batches"]
    on_the_card = device is None
    row = {"phase": "export", "config": config,
           "export_process": dict(made, waited_s=started["waited_s"]),
           "artifact": {"from_artifact": from_artifact, "load_s": load_s,
                        "rungs": rungs, "compile_count": compiles,
                        "requests": [{"rows": n, "ms": 1e3 * t}
                                     for n, t in zip(REQUESTS, latencies)],
                        "fwd_launches": launches,
                        "device_launches": executed,
                        "expected_launches": expected, "busy_ms": busy_ms,
                        "max_memory_allocated": peak_bytes,
                        "vs_eager_max_abs_diff": served[0],
                        "max_abs_logit": served[1],
                        "eager_from_artifact": eager_artifact},
           "expected_native_launches": expected_native, "tol": LOGIT_TOL}
    emit(row)
    if not (from_artifact and not eager_artifact
            and not native["eager_from_artifact"]
            and rungs == [SERVE_BATCH, SERVE_BATCH, SERVE_BATCH, 1]
            and compiles == 2):
        raise AssertionError("the artifact did not serve rungs {} "
                             "(from_artifact {}, compiles {})".format(
                                 rungs, from_artifact, compiles))
    if launches != (expected if on_the_card else 0) or (
            on_the_card and executed["flash_fwd"] != expected):
        raise AssertionError("the artifact's forward launched {} (the card "
                             "ran {}), expected {}".format(
                                 launches, executed["flash_fwd"], expected))
    for name, (diff, scale) in (
            ("artifact", served),
            ("native", (native["vs_eager_max_abs_diff"],
                        native["max_abs_logit"])),
            ("cli", (cli["vs_eager_max_abs_diff"], cli["max_abs_logit"]))):
        if not diff <= LOGIT_TOL * scale:
            raise AssertionError("{} logits differ from the eager server's "
                                 "by {} (max |logit| {})".format(
                                     name, diff, scale))
    report = native["report"]
    if (report.get("flash_fwd_launches")
            != (expected_native if on_the_card else 0)
            or report.get("flash_fwd_calls") != expected_native):
        raise AssertionError("the runner reported {}, expected {} calls, "
                             "launches on the card".format(report,
                                                           expected_native))
    cli_layers = cli["config"]["num_layers"]
    if (cli["lines"] != EXPORT_CLI_ROWS or not cli["rows_kept"]
            or len(cli["runner_reports"]) != 1
            or cli["runner_reports"][0]["flash_fwd_calls"] != cli_layers
            or cli["runner_reports"][0]["flash_fwd_launches"]
            != (cli_layers if on_the_card else 0)):
        raise AssertionError("inference_cli --native: {}".format(cli))
    if not all(binding["bit_equal"]) or (
            binding["calls"] != len(BINDING_CASES)) or (
            binding["launches"]
            != (len(BINDING_CASES) if on_the_card else 0)):
        raise AssertionError("the C++ binding against the Python op: "
                             "{}".format(binding))
    shutil.rmtree(started["out"], ignore_errors=True)
    return row


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a "
              "CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch.nn.functional as F

    import tensorflowonspark_torch as tt
    if not os.path.abspath(tt.__file__).startswith(HERE + os.sep):
        raise RuntimeError("tensorflowonspark_torch imported from {}, not "
                           "from this checkout".format(tt.__file__))
    from tensorflowonspark_torch import device as device_mod, metrics
    from tensorflowonspark_torch.ops import _build as build

    fa = importlib.import_module("tensorflowonspark_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    started = time.perf_counter()
    phase_seconds = {}

    def timed(name, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, its seconds kept under ``name``."""
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            phase_seconds[name] = time.perf_counter() - t0

    device = timed("device", phase_device, torch, device_mod)
    usage = timed("build", phase_build, build)
    timed("warm_clocks", warm_clocks, torch)
    fwd_rows = timed("kernel_fwd", lambda: [
        flash_case(torch, F, fa, metrics, device["kind"], usage, *case)
        for case in FLASH_CASES])
    bwd_rows = timed("kernel_bwd", lambda: [
        bwd_case(torch, F, fa, metrics, device["kind"], usage, *case)
        for case in BWD_CASES])
    serve = timed("serve", phase_serve, torch, np, fa)
    # the training shape: FLASH_CASES[1] and BWD_CASES[0]
    at_train = {"flash_fwd": fwd_rows[1], "flash_bwd_dq": bwd_rows[0][0],
                "flash_bwd_dkv": bwd_rows[0][1]}
    trained = timed("train", phase_train, torch, np, fa, metrics,
                    device["kind"],
                    {n: r["kernel_ms"] for n, r in at_train.items()})
    mega, mega_params = timed("train_megastep", phase_train_megastep, torch,
                              np, fa, metrics, trained)
    fleet_root = tempfile.mkdtemp(prefix="chip-fleet-")
    supervised = timed("supervised", phase_supervised, torch, np, fa,
                       trained, mega, mega_params, fleet_root)
    del mega_params
    clustered = timed("cluster", phase_cluster, torch, np, trained)
    mega_cluster = timed("cluster_k5", phase_cluster, torch, np, trained,
                         steps_per_call=MEGA_K, k1_cluster=clustered)
    # the data service's dispatcher and workers start, and its node brings
    # the model up, beside the gateway phase (host-bound: its replies'
    # zlib); the node's job and steps, the replay and the checks follow it
    ds_started = timed("dataservice_start", start_dataservice, torch, np)
    # the segmentation twin's node brings CUDA up beside the gateway and
    # dataservice phases too; its steps run after them, alone on the card
    try:
        seg_started = timed("segmentation_start", start_segmentation, torch,
                            np)
    except BaseException:
        stop_dataservice(ds_started)
        raise
    try:
        gatewayed = timed("gateway", phase_gateway, torch, np, fa)
    except BaseException:
        stop_dataservice(ds_started)
        stop_segmentation(seg_started)
        raise
    try:
        dataserved = timed("dataservice", phase_dataservice, torch, np,
                           ds_started, device["nvidia_smi"])
    except BaseException:
        stop_segmentation(seg_started)
        raise
    segmented = timed("segmentation", phase_segmentation, torch, np,
                      seg_started, device["nvidia_smi"])
    # the control phase's rollback leg (a cluster's bring-up and paced
    # steps, host-bound) runs beside serve_cli (a replica process's)
    rollback_started = timed("control_rollback_start",
                             start_control_rollback, torch, np)
    try:
        served_cli = timed("serve_cli", phase_serve_cli, torch, np)
    except BaseException:
        rollback_started["thread"].join(CONTROL_REPORT_SECS)
        raise
    rolled_back = timed("control_rollback_join", join_control_rollback,
                        rollback_started)
    # the export phase's builds, compiles and no-Python legs run in a
    # process of their own beside the phases from here to parallel_j2
    export_started = timed("export_start", start_export, torch, np)
    try:
        piped = timed("pipeline", phase_pipeline, torch, np)
        resnet_trained = timed("resnet_train", phase_resnet_train, torch, np,
                               fa)
        timed("resnet_card_vs_cpu", phase_resnet_card_vs_cpu, torch, np)
        timed("resnet_files", phase_resnet_files, torch, np, fa,
              resnet_trained)
        moe, moe_model, moe_params = timed("moe_train", phase_moe_train,
                                           torch, np, fa, metrics, mega)
        timed("moe_card_vs_cpu", phase_moe_card_vs_cpu, torch, np)
        moe_served = timed("moe_serve", phase_moe_serve, torch, np, fa,
                           moe_model, moe_params)
        del moe_model, moe_params
        example = timed("lm_example", phase_lm_example, torch, np, moe)
        parallel = timed("parallel", phase_parallel, torch, np, fa, trained,
                         mega)
        j2 = timed("parallel_j2", phase_parallel_j2, torch, np, fa, trained,
                   moe)
        # the export process ends before the observed and controlled
        # clusters, whose planes time their nodes' beats and steps
        timed("export_join", join_export, export_started)
        observed, observed_card = timed("observability", phase_observability,
                                        torch, np, fa, metrics, clustered,
                                        mega_cluster)
        control = timed("control", phase_control, torch, np, clustered,
                        rolled_back)
        # the warm-start phase's cold replica compiles beside the fleet
        # phase
        warm_started = timed("warmstart_start", start_warmstart, torch, np)
        try:
            fleet_row = timed("fleet", phase_fleet, torch, np,
                              supervised["crash_resume"]["published"])
        except BaseException:
            stop_warmstart(warm_started)
            raise
        finally:
            shutil.rmtree(fleet_root, ignore_errors=True)
        warm = timed("warmstart", phase_warmstart, torch, np, warm_started)
        exported = timed("export", phase_export, torch, np, fa,
                         export_started)
    finally:
        stop_export(export_started)
    emit({"phase": "wall", "seconds": time.perf_counter() - started,
          "phase_seconds": phase_seconds, "http_retries": HTTP_RETRIES,
          "trace_reads": TRACE_READS})

    serve_row = fwd_rows[0]
    head_dim_train = LM_CONFIG["head_dim"]
    replaces = {
        "flash_fwd": "tensorflowonspark_tpu/ops/flash_attention.py:49",
        "flash_bwd_dq": "tensorflowonspark_tpu/ops/flash_attention.py:158",
        "flash_bwd_dkv": "tensorflowonspark_tpu/ops/flash_attention.py:192",
    }
    sources = {"flash_fwd": "tensorflowonspark_torch/csrc/flash_fwd.cu",
               "flash_bwd_dq": "tensorflowonspark_torch/csrc/flash_bwd.cu",
               "flash_bwd_dkv": "tensorflowonspark_torch/csrc/flash_bwd.cu"}
    variants = supervised["variants"]
    supervised_paths = {
        "supervised_k5": supervised["crash_resume"],
        "accum2": variants["accum2_k1"], "accum2_k5": variants["accum2_k5"],
        "remat": variants["remat_k1"], "remat_k5": variants["remat_k5"],
        "eval": supervised["evaluate"]}
    kernels = []
    for name, row in at_train.items():
        entry = {
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name],
            # this slice's main path, the data service feeding the LM's
            # node: each kernel's launches in the node's fit_feed (the
            # counters zeroed before, read after)
            "launches": dataserved["launches"][name],
            "device_launches_by_path": dict(
                {"parallel_fsdp": parallel["runs"]["k1"][
                    "device_launches"][name],
                 "parallel_fsdp_k5": parallel["runs"]["k5"][
                     "device_launches"][name],
                 "ulysses_flash": parallel[
                     "ulysses_flash_device_launches"][name],
                 "parallel_j2_tp": j2["runs"]["tp_k1"][
                     "device_launches"][name],
                 "parallel_j2_tp_k5": j2["runs"]["tp_k5"][
                     "device_launches"][name],
                 "parallel_j2_ep": j2["runs"]["ep_k1"][
                     "device_launches"][name],
                 "parallel_j2_ep_k5": j2["runs"]["ep_k5"][
                     "device_launches"][name],
                 "gpipe_s1": j2["gpipe"]["device_launches"][name],
                 "moe_train": moe["k1"]["device_launches"][name],
                 "moe_train_k5": moe["k5"]["device_launches"][name],
                 "train_k5": mega["device_launches"][name],
                 "cluster": clustered["device_launches"][name],
                 "cluster_k5": mega_cluster["device_launches"][name],
                 "dataservice": dataserved["device_launches"][name],
                 "pipeline_fit": piped["device_launches"][name]},
                **{path: run["device_launches"][name]
                   for path, run in supervised_paths.items()}),
            "launches_by_path": dict(
                {"observability_cluster": observed["launches"][name],
                 "observability_step_profiler": observed_card[
                     "step_profiler"]["launches"][name],
                 "observability_guard_k1": observed_card["transfer_guard"][
                     "runs"]["k1"]["launches"][name],
                 "observability_guard_k5": observed_card["transfer_guard"][
                     "runs"]["k%d" % MEGA_K]["launches"][name],
                 "warmstart_train_cold": warm["train"]["cold"][
                     "launches"][name],
                 "warmstart_train_warm": warm["train"]["warm"][
                     "launches"][name],
                 "control_rollback": control["control_rollback"][
                     "launches"][name],
                 "control_evict": control["control_evict"]["launches"][name],
                 "control_autopilot": control["control_autopilot"][
                     "launches"][name],
                 "parallel_fsdp": parallel["runs"]["k1"]["launches"][name],
                 "parallel_fsdp_k5": parallel["runs"]["k5"]["launches"][
                     name],
                 "ulysses_flash": parallel["ulysses_flash_launches"][name],
                 "parallel_j2_tp": j2["runs"]["tp_k1"]["launches"][name],
                 "parallel_j2_tp_k5": j2["runs"]["tp_k5"]["launches"][name],
                 "parallel_j2_ep": j2["runs"]["ep_k1"]["launches"][name],
                 "parallel_j2_ep_k5": j2["runs"]["ep_k5"]["launches"][name],
                 "gpipe_s1": j2["gpipe"]["launches"][name],
                 "moe_train": moe["k1"]["launches"][name],
                 "moe_train_k5": moe["k5"]["launches"][name],
                 "lm_example_synthetic":
                     example["runs"]["synthetic"]["launches"][name],
                 "lm_example_files":
                     example["runs"]["files"]["launches"][name],
                 "train": trained["launches"][name],
                 "train_k5": mega["launches"][name],
                 "cluster": clustered["launches"][name],
                 "cluster_k5": mega_cluster["launches"][name],
                 "dataservice": dataserved["launches"][name],
                 # the U-Net's path has no attention: zero, checked
                 "segmentation": segmented["flash_launches_in_node"][name],
                 "pipeline_fit": piped["launches"][name]},
                **{path: run["launches"][name]
                   for path, run in supervised_paths.items()}),
            # device time per step inside the replayed graph (K = 5) and
            # in eager steps (K = 1), from the two phases' profiles
            "graph_device_ms_per_step": mega["profile"][
                "ms_per_step_by_group"].get(name),
            "eager_device_ms_per_step": trained["profile"][
                "ms_per_step_by_group"].get(name),
            "max_abs_err": row.get("max_abs_err", row.get("max_abs_err_o")),
            "ms": row["kernel_ms"], "device_ms": row["kernel_device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            "product_path": row["product_path"],
            "registers": row["registers"],
            "checked_shapes": (len(fwd_rows) if name == "flash_fwd"
                               else len(bwd_rows))}
        if name == "flash_fwd":
            entry["launches_by_path"].update({
                "export_artifact": exported["artifact"]["fwd_launches"],
                "export_native": exported["export_process"]["native"][
                    "report"]["flash_fwd_launches"],
                "export_cli_native": exported["export_process"]["cli"][
                    "runner_reports"][0]["flash_fwd_launches"],
                "warmstart_serve_cold": warm["serve"]["cold"]["fwd_launches"],
                "warmstart_serve_warm": warm["serve"]["warm"]["fwd_launches"],
                "fleet_replicas": sum(fleet_row["fwd_launches"].values()),
                "serve": serve["fwd_launches"],
                "gateway": gatewayed["fwd_launches"],
                "serve_cli": served_cli["fwd_launches"],
                "pipeline_transform": piped["transform_launches"],
                "moe_serve": moe_served["fwd_launches"]})
            entry["device_launches_by_path"]["gateway"] = \
                gatewayed["device_launches"][name]
            entry["device_launches_by_path"]["export_artifact"] = \
                exported["artifact"]["device_launches"][name]
            # the C++ binding (csrc/flash_ops.cpp) against the Python op
            entry["cpp_binding"] = exported["export_process"]["binding"]
            entry["serve_shape"] = {
                k: serve_row[k] for k in ("shape", "max_abs_err_o",
                                          "kernel_ms", "kernel_device_ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "product_path",
                                          "registers")}
        if name == "flash_bwd_dq":   # the training width at head_dim 32, 128
            entry["other_head_dims"] = {
                str(r[0]["shape"][3]): {
                    k: r[0].get(k) for k in (
                        "shape", "max_abs_err", "kernel_ms",
                        "kernel_device_ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "product_path",
                        "registers", "spill_stores")}
                for r in bwd_rows
                if r[0]["shape"][:2] == [TRAIN_BATCH, SEQ]
                and r[0]["shape"][3] != head_dim_train}
        kernels.append(entry)
    emit({"kernels": kernels})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
