"""Smoke run of the PyTorch port's serving, training, evaluation,
prediction and data-parallel paths, its tools and its file loaders on one
NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure raises and the exit code is not 0:

1. The card (nvidia-smi name and power limit), torch and CUDA versions;
   whether tensorstore and TensorFlow import (child processes).
2. Build the CUDA kernels from gvcnn_tf_tpu_torch/csrc with nvcc.
3. The stem kernel against its plain PyTorch version, without and with
   its epilogue (scale in [0.5, 2], mixed-sign shift, ReLU), at the serving
   shapes, one H % 4 == 2 shape and one width that is not a multiple of 8;
   kernel, plain and cuDNN times; the whole `Stem` module (conv + BN + ReLU
   in the kernel) against the plain conv -> BatchNorm -> ReLU sequence.
4. The grouping-head kernel against its plain version, both weight modes,
   M in {1, 8, 16}, V in {1, 8, 12}, scores on the j/M edges, empty groups;
   kernel and plain times.
5. The slice: the mn40_12view inference server (seeded weights, folded BN,
   full width, 12 views of 224x224, bf16) on an HTTP port; a B=1 uint8, a
   B=8 float and a B=11 request, with the kernels' launch counts over those
   requests; the card's logits and scores for a B=2 request against the
   same weights run in fp32 on the CPU through the plain versions; request
   latency at B=1 and B=8.
6. The stem kernel's op and its gradient (kernel forward, cuDNN weight
   gradient backward) against autograd through the plain version: dw at the
   B=8 training shape (96, 224, 224, 3) and at (2, 30, 30, 3) and
   (3, 8, 130, 3), and dx where x needs a gradient; the op's forward
   + backward, its backward alone, and cuDNN's weight gradient alone.
7. The grouping kernel's op and its gradient against autograd through the
   plain version: both modes, M in {1, 8, 16}, scores on the j/M edges,
   empty groups; forward + backward and backward alone.
8. The training slice: `train()` of mn40_12view at full width (B=8, 12
   views of 224x224, bf16, momentum SGD, dropout 0.8, the synthetic stream)
   into a scratch train_logdir for TRAIN_STEPS steps, then a second call
   that resumes from its last checkpoint for RESUME_STEPS more; the loss
   finite, parameters and BN statistics moved, one launch of each kernel a
   step, the resume at the right step.  One train step at B=2, full width,
   on the card (bf16) against the same seeded weights and batch in fp32 on
   the CPU through the plain versions: loss, grad_norm, each parameter
   tensor's gradient norm, and the gradient cosines (all, `Logits`, and the
   late layer groups).  Overfit: Adam at lr 1e-3, 30 steps
   on one fixed B=8 batch; the last loss below half the first.  The step
   time (CUDA events, median of 20 steps on a batch already on the card)
   and views/s.
9. Evaluation and prediction: mn40_12view at full width on the procedural
   split (40 classes, PROC_SHAPES shapes a split, raw uint8 views on the
   wire), both splits rendered first and timed.  `train()` for 10 steps
   with `eval_every` 5: the val split scored at steps 5 and 10 (6 padded
   batches of 8, one launch of each kernel a batch, 10 + 2 x 6 in all).
   `evaluate()` of the step-5 and step-10 checkpoints with a fresh model on
   the card gives the in-training results and argmaxes exactly.  The
   step-10 checkpoint on the card (bf16) against the CPU (fp32, plain
   versions) over the first CPU_SHAPES val shapes: logits within
   LOGIT_REL_TOL of max|logit| batch by batch, argmax equal wherever the
   CPU's top-2 margin is above that bound, counts equal up to the shapes
   under it.  `predict()` of three OFF meshes (and its CLI's CSV), and of a
   B=2 uint8 array card against CPU.  Times: eval views/s end to end (host
   clock, checkpoint load included, rendering excluded) and on the device
   (CUDA events over the 6 forwards of batches already on the card), and
   `train()` views/s on the procedural uint8 stream (10 resumed steps,
   without evaluations).  Its `train()` streams (`device_resident="off"`),
   as in the runs before phase 15 existed, so its readings compare.

10. The other families and backbones (`phase_families`), at full width
   (224x224, B = 8, 12 views, 1 for mn10_single_view, the config's compute
   dtype): the fp32 stem kernel (3xTF32 on the tensor cores) against its
   plain version (TF32 off for the reference), without and with its
   epilogue, at mn10_single_view's (8, 224, 224, 3), an odd shape, an
   unaligned width with a ragged band, 96 images and a row of two strips,
   timed against cuDNN's fp32 and TF32 convs, with its bound on the tensor
   cores and on the CUDA cores;
   its op's dw (and dx at the other shapes) against autograd
   through the plain version with TF32 off, and its forward + backward,
   backward alone and cuDNN's fp32 weight gradient timed;
   the grouping kernel at C = 1536 (Inception-v4) and 2048 (ResNet-50)
   against its plain version in phase 4's cases, timed; then for each of
   mn40_12view_resnet50, mn40_12view_inception_v4, mn40_12view_mvcnn,
   mn10_single_view and mn40_12view_inception_resnet_v2: the inference engine (seeded weights, folded BN) at
   B = 1 and B = 8 (request p50 and each kernel's launches), B = 2 card
   vs CPU (fp32, plain versions) logits, argmax and scores, one B = 8 train
   step (CUDA events, peak memory, launches) and a B = 2 card-vs-CPU train
   step (loss, grad_norm, the Logits gradient's cosine), each held to a
   bound set beforehand from `measure.py serve-drift` / `train-drift` on
   the CPU; and one B = 1 forward through GVCNN on Inception-v2 and v3
   (`--backbone`) from seeded weights with BatchNorm statistics calibrated
   to the request's views, card against CPU.  The average-pool kernels'
   launches on these main paths (engine forwards, the train step, the
   v2/v3 forward) are counted from zero and held to FAMILY_AVG_POOLS a
   forward (forward and backward kernel each a train step), the train-mode
   BatchNorm kernels' to BN_LAYERS (stats, apply, backward reduce and
   elementwise once a BatchNorm a train step; none in a served forward),
   the residual join's to FAMILY_JOINS (its forward kernel once a join a
   served forward; forward, backward and bias-gradient kernels once a join
   a train step).
11. Warm start (`phase_warm_start`): a slim-named Inception-v1 checkpoint
   made from a seed (1001-class head) written by the port's importer, then
   `train()` of mn40_12view at full width with `checkpoint_path` and the
   default exclude scopes for WARM_STEPS steps: the weights on the card
   before step 1 bit for bit the checkpoint's (Inception-v1) and the seeded
   init (`Logits`, `GroupingModule`), the loss finite, one launch of each
   kernel a step, the warm start's host time and the steps' CUDA-event
   times; then a Flax-layout tree (what `read_orbax` returns) of seeded
   weights served at B = 8 through `model_state` -> `load_model`, card
   against CPU within the serving bounds.
12. Data parallelism (`phase_parallel`), mn40_12view_dp8's model at its
   per-card batch (B = 8 a rank), full width, bf16, dropout 0.8.  (a) A
   world of one rank over NCCL on cuda:0: DP_STEPS steps through the
   data-parallel step (the gradient, loss and accuracy all-reduce) equal
   the plain step's bit for bit (same seed and batches, cuDNN
   deterministic), one launch of each bf16 kernel a step, and both steps'
   times.  (b) A world of 2 ranks over gloo sharing the one card (NCCL
   refuses two ranks on one GPU; each rank names cuda:0), spawned with a
   timeout: the global-mode step against one process's step on the B = 16
   batch (loss, grad_norm, the Logits gradient's cosine, within
   DP_GLOBAL_TOL); the local-mode step on a tiled batch against one
   process on one tile, max|dparam| 0 (cuDNN deterministic); the replicas
   bitwise equal after DP_STEPS steps (an all-reduced checksum); the
   procedural split's evaluation over 2 ranks equal to one process's; each
   kernel launched once a step on each rank; each rank's step time (CUDA
   events) and the gradient all-reduce's (host clock).  A world of 2 on one
   card over gloo: none of these times measures scaling across cards.
13. The tools (`phase_tools`).  (a) Export: mn40_12view at full width
   (seeded weights, folded BN, bf16, B = EXPORT_B) through
   `tools/export_model.export_model`, its wall time and size; the bytes
   loaded and run on a B = 8 float32 request in a child process that
   imports only the export module, the logits within EXPORT_LOGIT_REL_TOL
   of the inference engine's for the same views; loaded in this process,
   one launch of each bf16 kernel a forward and no call of their plain
   versions; the artifact's B = 8 forward and the eager model's (CUDA
   events, median of EXPORT_TIMED_RUNS, in turns) and the device kernels
   each launches (torch.profiler); mn40_12view_mvcnn exported and checked
   the same way (the stem, no grouping head).  (b) `tools/loadgen.run_load`
   on the mn40_12view engine: LOAD_CLIENTS clients, sizes LOAD_SIZES,
   closed loop for LOAD_S s after LOAD_WARMUP_S s, then open loop at half
   the closed loop's achieved request rate (p50/p99 overall and per size,
   views/s, offered and achieved rates).  (c) `tools/retrieval`: descriptors
   of phase 9's step-10 checkpoint over its val split on the card, norms 1,
   the first CPU_SHAPES against fp32 on the CPU per shape (cosine at least
   RETRIEVAL_COS_MIN), mAP and p@1/5/10.  (d) `tools/proc_benchmark.run_one`
   for GVCNN and MVCNN, seed 0, at the study's 64x64, 8 views, hard,
   cut to STUDY_ARGV's few steps: the JAX tool's keys, and every forward
   through the kernels.
14. The file loaders (`phase_loaders`), mn40_12view at full width (B = 8,
   12 views of 224x224, bf16, the uint8 wire).  A probe line first:
   libjpeg's and libpng's headers and libraries, PIL, g++, and whether the
   native decode pool and the TFRecord CRC library build.  A 40-class tree
   rendered by the port's tools: `render_tree` PNGs of demo meshes
   (LOADER_TRAIN_SHAPES train, LOADER_VAL_SHAPES validation: a ragged last
   batch) and `export_tree` JPEGs of the procedural split, with the render
   time (over LOADER_RENDER_BUDGET_S the train shapes drop to
   LOADER_CUT_SHAPES, said in the log); TFRecords built from the PNG trees.
   A loader the machine cannot run (the pool without libjpeg or libpng; the
   TFRecord reader without the pool or PIL) must refuse, and its refusal is
   printed; without both the pool and PIL the decoded loader reads a cache
   written here from the procedural arrays, in the cache's layout.  Each
   loader that runs: `train()` for LOADER_STEPS steps (one launch of each
   bf16 kernel a step; the decoded loader flips on the card every step:
   the masks of its eager warm-up and of its captured step, read after the
   run, are steps 0's and LOADER_STEPS - 1's `flip_mask`);
   `evaluate()` of the validation tree from one of those checkpoints on the
   card and in fp32 on the CPU (counts equal up to the shapes whose top-2
   margin is under LOGIT_REL_TOL of max|logit|; one launch of each kernel a
   batch); `tools/bench_input` views/s (LOADER_BENCH_BATCHES batches,
   num_threads 0) beside the views/s that phase 8's B=8 step consumes.
15. The card-resident train split and the profiled window
   (`phase_resident`, `phase_profiled`), mn40_12view at full width (B = 8,
   12 views of 224x224, bf16, the uint8 wire) on the procedural train
   split (the config's 128 shapes, or PROC_SHAPES if rendering them would
   pass RESIDENT_RENDER_BUDGET_S; said in the log).  (a) The first
   RESIDENT_CHECK_BATCHES resident batches out of the prefetcher (the
   staged tensors by reference) gathered on the card equal the stream's
   byte for byte; then `train()` for RESIDENT_STEPS steps streaming,
   resident, resident, streaming: wall and views/s end to end, the loop's
   views/s over its last RESIDENT_LOG_EVERY steps, staging time and bytes,
   peak memory, one launch of each bf16 kernel a step; the trained weights
   of the two transports within RESIDENT_GAP_ROOM x the spread of two runs
   of one transport; a resident run resumed from the last streaming run's
   checkpoint (step count, launches).  (b) `train(profile_steps=
   PROFILE_WINDOW)` on the resident split, in a process of its own (as a
   trainer runs it; see `phase_profiled`): the Chrome trace holds exactly
   the spans `train_step 3` and `train_step 4`, and exactly 2 device
   events of each kernel by its `__global__` name; its size and the
   device's idle share over the window.  Phase 13's study smoke trains on
   the resident split too (`device_resident="auto"`).
16. Rematerialization (`phase_remat`), mn40_12view at full width (12
   views of 224x224, bf16), three train states from one seed: no remat,
   `remat_until` REMAT_UNTIL and `remat_backbone`.  (a) One step each on
   one B = 8 batch made on the card: loss and every BatchNorm running
   statistic bit-equal to the plain step's, the gradients' cosine and
   per-tensor norm ratios within REMAT_GRAD_COS_MIN and
   REMAT_GRAD_LOGRATIO_MAX (whether bit-equal printed); the B = 2
   card-vs-CPU train step of phase 8 (`check_train_drift`, same bounds)
   with `remat_until`.  (b) The launches a step of each kernel, held to
   REMAT_LAUNCHES: the stem twice under remat (the backward recomputes
   it), the grouping head once.  (c) Step time (CUDA events, median of 10
   after 3 warm steps) and peak memory at B = 8, in the turns of
   REMAT_TURNS.  (d) One step's time and peak memory at B = REMAT_BIG_B
   for each.  (e) mn40_12view_resnet50, one B = 8 step with and without
   `remat_backbone`: loss equal, peak memory of each.
17. The step-analysis tools (`phase_analysis`).  (a) `tools/bench_layers`
   in train mode, marginal method, at LAYERS_B images (8 shapes x 12
   views, 224x224, bf16) over LAYERS_ENDPOINTS, and the whole tower: each
   row's time (CUDA events), device time (torch.profiler), FLOPs and bytes
   (`count_work`) and share of its bound; every row's
   `frac_of_bound_device` in (0, BOUND_FRAC_MAX], and `frac_of_bound` at
   most BOUND_FRAC_MAX where the A/B delta is not noisy (|delta| >= 2
   sigma; the eager step's host jitter makes late rows' deltas noisy, and
   a noisy delta near 0 reads any share): a reading over it means the
   count is wrong; the stem kernel launched once per execution of
   the stem in each timed call (A and B of every row, 2 in B of the stem's
   own row).  (b) The count of one mn40_12view train forward + backward
   (COUNT_SHAPE, bf16, channels-last parameters) on the card, through both
   kernels, equals its count on the CPU, through their plain versions:
   FLOPs, bytes and every op's calls.  (c) `tools/bench_phases` at B = 8
   and B = 32: fwd, grad and full by CUDA events, each call launching the
   bf16 stem and the grouping kernel once.  (d) `tools/analyze_collectives`
   on 2 gloo ranks (on the CPU), both `bn_sync` modes: local one device
   all-reduce a step (the 22.8 MB flat buffer), global 1 + 2 per
   train-mode BatchNorm; the NVLink model weighed with B = 32's full_ms.
18. The last step-analysis tools (`phase_step_tools`), mn40_12view, bf16.
   (a) `tools/profile_step` on the B = TOOLS_B train step (12 views of
   224x224), in a process of its own as phase 15's window: at least ATTRIBUTED_MIN of the window's kernel time tied to a
   layer or a bucket, the stem kernel once under Conv2d_1a_7x7's forward
   and the grouping kernel once in its op's row; the residual buckets, the
   idle share of a plain window and the activation saves printed.  (b) Its
   op counts by layer and phase at TOOLS_TINY on the card equal those on
   the CPU (bf16, channels-last parameters) and the B = TOOLS_B step's.
   (c) `tools/check_wire_fusion` at TOOLS_TINY: the card's two tables and
   its extra buffers equal the CPU's; its verdict and bytes at B =
   TOOLS_B.  (d) `tools/dump_ops` on Mixed_3b in train mode at DUMP_B
   images: its op histogram equals the CPU's at 64x64.  (e)
   `tools/bench_stem` at 384 x 224x224: both stem kernels against cuDNN,
   `rel_dev` within STEM_TOL's rtol (bf16) and STEM_F32_REL_TOL (fp32,
   against cuDNN with TF32 off).  (f) `tools/bench_variants`, the
   TOOLS_VARIANTS rows at B = TOOLS_B (merge_1x1 the same program as the
   baseline, every first loss finite).  (g) `tools/bench_backend_flags` at
   B = TOOLS_B, every setting timed and `torch.backends` as it was after.
   The phase's launches of each kernel are counted.
19. The compiled step (`phase_compiled`), mn40_12view at full width, bf16,
   seeded weights.  The earlier phases' `train()` (one rank),
   `evaluate()` and engines replay CUDA graphs (`utils/graphs.py`); the
   tools and the direct `train_step` calls stay eager.  (a) From a state
   COMPILED_WARM steps past init, COMPILED_STEPS steps at each of
   COMPILED_B through the eager step twice and the compiled step once: the
   uint8 wire with dropout, then the card-resident split with the on-card
   flip, accumulate_steps = 2 and remat_until; parameters, BatchNorm
   statistics and every step's metrics bit-equal to the first eager run,
   or within COMPILED_SPREAD x the two eager runs' spread; launches a step
   equal to the eager step's through the replays, the max-pool kernels'
   counted from zero before the steps and held to COMPILED_POOL_LAUNCHES,
   the BatchNorm kernels' to BN_LAYERS (with the remat recompute's
   REMAT_BATCH_NORMS forwards again under remat_until);
   the step (CUDA events, median of 2 x COMPILED_RUNS in turns), the
   device's idle share over a
   profiled window and peak memory, eager beside compiled.  (b) The
   engine's B=1 and B=8 replays against its model run eagerly, bit for
   bit; engine (graphs and eager) and HTTP p50 / p99 over SERVE_SAMPLES
   uint8 requests, no BatchNorm kernel launched.  (c) `evaluate()` of the
   PROC_SHAPES-shape procedural split through its graph against eager:
   counts and logits equal, views/s end to end and of the forwards on the
   card, no BatchNorm kernel launched.  (d) mn10_single_view (fp32 K2) and
   ResNet-50, FAMILY_B shapes: 3 compiled steps against eager, launches a
   step (the max pool's and BatchNorm's too).
20. The max-pool kernels (`phase_pool`, csrc/max_pool.cu) at every pool of
   Inception-v1 and ResNet-50 at POOL_IMAGES images of 224x224 (B = 32 of
   12 views), bf16: the forward without and with its record, bit-equal to
   `F.pad` + `F.max_pool2d` and to the plain record; the backward from
   that record within one bf16 ulp of the plain gather (bit-equal where an
   input wins one window); each timed beside its bytes bound, its plain
   version and one PyTorch call on the pre-padded input
   (`F.max_pool2d` with indices; its backward), with the sums over
   Inception-v1's 13 pools.  Then the main path's entry, `pool.max_pool`
   under autograd at MaxPool_3a_3x3 (B = 32), against `F.pad` +
   `F.max_pool2d` and autograd's gradient: one launch each way.
21. The average-pool kernels (`phase_avg_pool`, csrc/avg_pool.cu) at
   Inception-v4's 3x3/1 'SAME' pools at AVG_POOL_IMAGES images of 299x299
   (B = 32 of 12 views), bf16: the forward within one bf16 ulp of
   `F.avg_pool2d` counting the pads, the backward within one ulp of the
   plain box sum of dy and of PyTorch's backward on fp32 NCHW copies,
   rounded once (1e-6 more where a window cancels); each timed beside its
   bytes bound, its plain version and one PyTorch call (`F.avg_pool2d` on
   the channels-last input, and its backward), summed over the 14 pools
   (3.90 ms bound a step).  How far
   PyTorch's channels-last backward lies from the NCHW gradient is printed.
   Then `pool.avg_pool` under autograd at Mixed_5b's pool: one launch each
   way, and the launch counters.
22. The train-mode BatchNorm kernels (`phase_batch_norm`,
   csrc/batch_norm.cu) over every BatchNorm of one B = 32 train step of
   each train cell's configuration (Inception-v1 and ResNet-50 at 224,
   Inception-v4 and Inception-ResNet-v2 at 299, as the cells run them), their shapes taken from a
   B = 1 step's BatchNorm calls and run at BN_IMAGES images, bf16: the
   forward (stats + apply, the running statistics moved) and the backward
   (reduce + elementwise), each layer's ReLU as the model has it, each
   side captured in one CUDA graph and
   timed over BN_REPLAYS replays, beside the 8-pass bytes bound (x read,
   x read and y written; dy and x read, dy and x read and dx written) and
   PyTorch's `native_batch_norm` + `F.relu` and their backward
   (`threshold_backward` + `native_batch_norm_backward`) as the yardstick
   (`library_*_ms`; the port never calls them in train mode).  Before the
   timing, each layer's four kernels run once eagerly and are held to the
   plain versions on fp32 copies on the card (`_check_bn_layer`): mean,
   invstd and the running statistics within BN_STATS_REL, y within one
   ulp, dx within one bf16 ulp plus BN_GRAD_REL of max|dx|, dbeta and
   dgamma within BN_GRAD_REL of the channel's sum of |terms|; the largest
   gaps are printed.
23. The residual join's kernels (`phase_join`, csrc/residual_join.cu)
   through their ops at Inception-ResNet-v2's joins at JOIN_IMAGES images
   of 299x299 (B = 32 of 12 views), bf16: at each of block35 (35x35x320),
   block17 (17x17x1088) and block8 (8x8x2080), with and without the ReLU,
   one launch of each kernel, y, dx and du bit-equal to
   `residual_join_plain` / `residual_join_backward_plain` and dbias within
   JOIN_DBIAS_REL of the channel's sum of |du|, raising on a miss.  Then
   each published join (block35 0.17, block17 0.10, block8 0.20, the last
   `Block8` 1.0 without the ReLU) timed, forward and backward (backward
   and bias-gradient kernels): CUDA events, device time, the plain
   versions on the card, beside the bytes bound a way (x and u read, y
   written; dy read, dx and du written, dx not where there is no ReLU;
   the ReLU's mask read from y left out); no one PyTorch call
   computes the join, so there is no library time.  Last, the 40 joins of
   one B = 32 step (JOIN_SHAPES' counts), forward and backward each
   captured in one CUDA graph and timed over BN_REPLAYS replays, against
   the 6-pass bound (`join_roofline.train`'s, 15.87 ms).

TF32: PyTorch's defaults, as the port runs (fp32 matmuls in full fp32;
fp32 cuDNN convs, those of mn10_single_view outside its stem kernel, in
TF32); the fp32 references of the kernels' checks turn it off around
themselves only.  Times are CUDA-event medians of 30 runs after 5 warm-up
runs (kernels; `ms`), torch.profiler kernel durations (`device_ms`), or
host-clock medians of 20 requests (serving; 10 in phase 10).  `bound_ms`
is the larger of the bytes the function must move (inputs read once,
outputs written once) over 3.35 TB/s and its operations over the peak rate
for their type (bf16 tensor cores 989 TFLOP/s; fp32 67 TFLOP/s; the fp32
stem's three TF32 products at 495 TFLOP/s; `bench_layers.PEAKS`, keyed on
the card's name), from this run's shapes.  A line gives each phase's
seconds.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a card, or outside a
checkout, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import sys
import time
import urllib.request

import numpy as np
import torch

REQUESTS = 20
# (N, H, W, 3): the B=8 and B=1 serving shapes (N = B x 12 views), then
# one with H % 4 == 2 and one whose rows are not 16-byte aligned
# (W % 8 != 0: the kernel's 2-byte copy path).  The first is the one timed.
STEM_SHAPES = [(96, 224, 224, 3), (12, 224, 224, 3), (2, 30, 30, 3),
               (3, 8, 130, 3)]
STEM_TOL = dict(rtol=1e-2, atol=1e-2)      # bf16 out: one rounding apart
FORWARDS = 4                               # B=1, 8, 11: 1 + 1 + 2 chunks
# Slice on the card (bf16 through ~60 conv layers) vs the CPU in fp32.
# Predicted from a bf16-vs-fp32 run on the CPU at 112x112: logits drift
# ~0.6% of max|logit|, scores ~3e-4.  The bounds leave 5x / 15x room.
LOGIT_REL_TOL = 3e-2
SCORE_ABS_TOL = 5e-3
# One train step, card (bf16) vs CPU (fp32).  Predicted from
# `measure.py train-drift` (bf16 vs fp32 on the CPU, 64x64, 4 views, B=2):
# loss 1.58% apart, grad_norm 1.58%, the Logits gradient's cosine 0.9900.
# Bounds with 3x room or more: 5%, 6%, 1 - cos <= 0.03.  The cosine of all
# gradients was 0.50 on the CPU (0.57 in the JAX package): at random init
# the early convs' gradients, which dominate its norm, swing with any
# rounding of the activations (a 1e-3 perturbation of the input alone gives
# 0.89 in fp32), so 3x room leaves no bound; it is printed and held to > 0.
TRAIN_LOSS_REL_TOL = 5e-2
TRAIN_GNORM_REL_TOL = 6e-2
TRAIN_LOGITS_COS_MIN = 0.97
# Per layer, from the four `train-drift` runs (12 views; 64x64 seeds 0-2,
# 96x96 seed 0).  Every parameter tensor's gradient norm, card over CPU:
# the worst |ln ratio| read 0.494 (a Mixed block's BatchNorm bias), so the
# bound, at 3x, is a ratio in [0.22, 4.5]; a gradient lost or scaled on
# the card fails it in any layer.  Tensors whose gradient is rounding noise
# on both sides (`measure.NOISE_REL`) are left out: at 12 views every
# view's score falls in the first group at init, so no loss gradient
# reaches the scoring FCN.  Cosines of the groups that keep their
# direction under bf16 rounding, at 1 - 3 x (1 - the worst reading):
# Mixed_5c's BatchNorm biases 0.954, `Logits.bias` 0.9997.  The earlier
# groups read 0.29-0.69, which leaves no bound with that room.
TRAIN_LAYER_LOGRATIO_MAX = 1.5
TRAIN_GROUP_COS_MIN = {"Mixed_5c/bn_bias": 0.86, "Logits/bias": 0.999}
TRAIN_STEPS, RESUME_STEPS = 20, 4
OVERFIT_STEPS = 30
WARM_STEPS = 3                   # phase 11: warm-started train() steps
# Phase 9: 44 shapes a split give 5 train steps an epoch and 5 full val
# batches of 8 plus one of 4 (padded); the first 16 val shapes go through
# the CPU.
PROC_SHAPES, EVAL_EVERY, EVAL_TRAIN_STEPS = 44, 5, 10
EVAL_FORWARDS = -(-PROC_SHAPES // 8)
CPU_SHAPES = 16
STEM_GRAD_SHAPES = [(96, 224, 224, 3), (2, 30, 30, 3), (3, 8, 130, 3)]
# Phase 10.  The fp32 stem at mn10_single_view's B = 8, one odd shape, an
# unaligned width (W % 4 != 0: the kernel's 4-byte copy path) with a ragged
# band, 96 images (many tiles a block) and a row wider than one strip; the
# kernel's 3xTF32 against cuDNN's fp32 conv, 147 products summed in another
# order (one TF32 product misses this bound, tests/test_torch_stem.py).
STEM_F32_SHAPES = [(8, 224, 224, 3), (3, 31, 45, 3), (1, 18, 226, 3),
                   (96, 224, 224, 3), (2, 20, 300, 3)]
STEM_F32_REL_TOL = 1e-5
# The fp32 stem op's dw (and dx) against the plain version's, both cuDNN
# fp32 conv gradients with TF32 off, summed in whatever order cuDNN picks
# (TF32 would round the inputs to 10 bits, ~1e-3).
STEM_F32_GRAD_REL_TOL = 1e-4
WIDE_C = (1536, 2048)            # K1: Inception-v4 Mixed_7d, ResNet-50 block4
# Phase 13.  The artifact and the engine run the same kernels and the same
# cuDNN convs on the same inputs, in bf16: predicted equal, and at worst a
# few bf16 roundings apart (2^-8 of max|logit| each).
EXPORT_B = 8
EXPORT_LOGIT_REL_TOL = 1e-2
EXPORT_TIMED_RUNS = 20
# run_load on the mn40_12view engine: closed loop, then open loop at half
# the closed loop's achieved request rate.
LOAD_CLIENTS, LOAD_SIZES, LOAD_S, LOAD_WARMUP_S = 4, (1, 8), 5.0, 1.0
# Descriptors card (bf16) vs CPU (fp32), per shape.  `measure.py
# retrieval-drift` (bf16 vs fp32 on the CPU, seeded weights at init BN
# statistics, 8 procedural val shapes, 12 views; 64, 96 and 160 square,
# seeds 0-2) read at worst 1 - cos = 1.36e-5; the bound leaves 7x room.
RETRIEVAL_COS_MIN = 1 - 1e-4
# The study tool at the study's shape (64x64, 8 views, hard), cut to a
# few steps on 16 shapes a split: one forward each for evaluate and
# extract_descriptors at B = 16.
STUDY_ARGV = ["--height", "64", "--num_views", "8", "--hard",
              "--train_shapes", "16", "--eval_shapes", "16", "--steps", "4"]
STUDY_KEYS = ["model", "seed", "top1", "count", "retrieval_mAP",
              "precision@5", "final_train_acc", "train_seconds", "steps"]
FAMILY_REQUESTS = 10
# (bf16 stem, fp32 stem, grouping) launches a forward.
FAMILY_LAUNCHES = {"mn40_12view_resnet50": (0, 0, 1),
                   "mn40_12view_inception_v4": (0, 0, 1),
                   "mn40_12view_mvcnn": (1, 0, 0),
                   "mn10_single_view": (0, 1, 0),
                   "mn40_12view_inception_resnet_v2": (0, 0, 1)}
# The 3x3/1 'SAME' average pools a forward (csrc/avg_pool.cu): a serving
# forward launches that many forward kernels, a train step that many of
# each kernel.  Inception-v4: Mixed_5b-5e, 6b-6h and 7b-7d; v2: 7; v3: 9.
FAMILY_AVG_POOLS = {"mn40_12view_resnet50": 0,
                    "mn40_12view_inception_v4": 14,
                    "mn40_12view_mvcnn": 0,
                    "mn10_single_view": 0,
                    "mn40_12view_inception_resnet_v2": 1,
                    "inception_v2": 7,
                    "inception_v3": 9}
# The residual joins a forward (csrc/residual_join.cu): a serving forward
# launches that many forward kernels, a train step that many of each of
# the forward, backward and bias-gradient kernels.  Inception-ResNet-v2:
# 10 block35, 20 block17, 9 block8 and Block8.
FAMILY_JOINS = {"mn40_12view_resnet50": 0,
                "mn40_12view_inception_v4": 0,
                "mn40_12view_mvcnn": 0,
                "mn10_single_view": 0,
                "mn40_12view_inception_resnet_v2": 40,
                "inception_v2": 0,
                "inception_v3": 0}
# mn10_single_view: fp32 on the card (TF32 convs outside the stem kernel)
# against fp32 on the CPU, read at 224x224 with only the forward's conv
# inputs TF32-rounded (the card's dgrad and wgrad run in TF32 too): worst
# loss 2.76e-4, grad_norm 9.46e-3, Logits cosine 0.99997; bounds with 5x
# room or more for the unemulated backward.
SINGLE_VIEW_TRAIN_TOL = (2e-3, 5e-2, 0.999)
# GVCNN on Inception-v2 and v3 (`--backbone`), B = 1, BatchNorm statistics
# calibrated to the request's views (`measure.calibrate_bn`; with init
# statistics max|logit| read 1.6e5 on v2 and 9e-4 on v3, so the checks
# exercised little of the network).  Worst `serve-drift --calibrate
# --size 224` readings (seeds 0-2, the card's size): v2 2.66e-2 / 8.83e-5,
# v3 3.30e-2 / 7.55e-5 (at 96x96: v2 4.27e-2 / 2.00e-4, v3 9.63e-2 /
# 2.22e-4).  Bounds with 3x room over the 224x224 readings.
FAMILY_BACKBONE_TOL = {"inception_v2": (8e-2, 3e-4),
                       "inception_v3": (1e-1, 3e-4)}
# Serving, card vs CPU: (max|dlogit| / max|logit|, max|dscore|), set from
# `measure.py serve-drift` (the compute dtype against fp32 on the CPU, 96x96,
# B = 2, seeds 0-2; fp32 configs against TF32-rounded conv inputs).  Worst
# readings: ResNet-50 3.20e-3 / 1.60e-4; Inception-v4 9.58e-3 / 2.13e-6;
# MVCNN 6.70e-3; single view 1.24e-3; Inception-ResNet-v2 1.30e-2 /
# 2.37e-5; GVCNN on v2 and v3 in FAMILY_BACKBONE_TOL.  Bounds with 3x room
# or more.
FAMILY_SERVE_TOL = {"mn40_12view_resnet50": (1e-2, 1e-3),
                    "mn40_12view_inception_v4": (3e-2, 1e-4),
                    "mn40_12view_mvcnn": (2e-2, None),
                    "mn10_single_view": (5e-3, None),
                    "mn40_12view_inception_resnet_v2": (4e-2, 1e-4)}
# One B = 2 train step, card vs CPU: (loss rel, grad_norm rel, Logits
# gradient cosine), from `measure.py train-drift` (bf16 vs fp32 on the CPU;
# 64x64 seeds 0-2 and 96x96, v4 and Inception-ResNet-v2 at 80x80 and
# 96x96, the latter at 128x128 seeds 0-2 too; mn10_single_view fp32
# against TF32-rounded conv inputs at 224x224, seeds 0-2).  Worst
# readings: ResNet-50 5.87e-2, 5.46e-2, 0.9711; Inception-v4 9.02e-2,
# 5.01e-2, 0.8911; MVCNN 2.50e-2, 2.45e-2, 0.9913; Inception-ResNet-v2
# 3.88e-2, 4.40e-2, 0.99565; single view in FAMILY_TRAIN_TOL's comment.
# Bounds: 2.5-3x the worst gap, 1 - 3 x (1 - the worst cosine).
FAMILY_TRAIN_TOL = {"mn40_12view_resnet50": (0.15, 0.15, 0.91),
                    "mn40_12view_inception_v4": (0.25, 0.15, 0.67),
                    "mn40_12view_mvcnn": (0.075, 0.075, 0.97),
                    "mn10_single_view": SINGLE_VIEW_TRAIN_TOL,
                    "mn40_12view_inception_resnet_v2": (0.1, 0.12, 0.987)}


# Phase 12: data parallelism at mn40_12view_dp8's per-card batch (64 over 8
# cards), full width.  DP_STEPS steps a world; the 2-rank evaluation scores
# DP_EVAL_SHAPES procedural val shapes.  Every collective of a rank times
# out after DP_GROUP_TIMEOUT s and the spawned world is killed after
# DP_TIMEOUT s.
DP_RANK_BATCH, DP_STEPS, DP_EVAL_SHAPES = 8, 3, 20
DP_GROUP_TIMEOUT, DP_TIMEOUT = 120, 300
# Global mode, 2 ranks x B=8 over gloo against one process at B=16, both
# bf16 on the card: (loss rel, grad_norm rel, Logits gradient cosine).
# `measure.py dp-drift` (the same comparison in bf16 on the CPU, 64x64, 4
# views, 2 x B=2 against B=4, seeds 0-2) read at worst 6.79e-3, 1.82e-2,
# 0.99799: the BatchNorm statistics rounded another way (Flax's fast
# variance over the ranks, PyTorch's Welford pass in one process) and convs
# at another batch size perturb bf16 activations by an ulp, and that grows
# through the network as any bf16 rounding does.  Bounds with 3x room or
# more.
DP_GLOBAL_TOL = (2.5e-2, 6e-2, 0.99)

# Phase 14: the file loaders at full width (224x224, 12 views, B = 8, bf16,
# the uint8 wire).  A 40-class tree: 80 train shapes (cut to 48, one of
# each class and a second of the first 8, if rendering would pass
# LOADER_RENDER_BUDGET_S) and 44 validation shapes (one of each class and
# a second of the first 4: a ragged last batch of 4 at B = 8).  Each loader
# the probe allows trains LOADER_STEPS steps; bench_input times
# LOADER_BENCH_BATCHES batches after its 3 warm-up batches.
LOADER_TRAIN_SHAPES, LOADER_CUT_SHAPES, LOADER_VAL_SHAPES = 80, 48, 44
LOADER_RENDER_BUDGET_S = 60
LOADER_STEPS, LOADER_BENCH_BATCHES = 5, 20
LOADER_EVAL_FORWARDS = -(-LOADER_VAL_SHAPES // 8)

# Phase 15: the card-resident train split and the profiled window, on
# mn40_12view at full width (B = 8, 12 views of 224x224, bf16, the uint8
# wire) over the procedural train split: the config's own 128 shapes (231
# MB), or phase 9's PROC_SHAPES if rendering 128 would pass
# RESIDENT_RENDER_BUDGET_S (extrapolated from the first 8).  Four train()
# runs of RESIDENT_STEPS steps in turns (streaming, resident, resident,
# streaming), logging every RESIDENT_LOG_EVERY; then RESIDENT_RESUME_STEPS
# resident steps resumed from the last streaming run's checkpoint.
RESIDENT_STEPS, RESIDENT_LOG_EVERY, RESIDENT_RESUME_STEPS = 40, 10, 5
RESIDENT_RENDER_BUDGET_S = 60
RESIDENT_CHECK_BATCHES = 5
# The trained parameters of the two transports: ||a - b|| over every
# parameter and BatchNorm statistic, relative to how far training moved
# them (||b - init||).  cuDNN's weight gradients and max-pool's backward
# are not bitwise deterministic on the card, so two runs of one transport
# already differ: every resident-vs-streaming gap must stay within
# RESIDENT_GAP_ROOM x the larger same-transport gap, plus
# RESIDENT_GAP_FLOOR (so that bit-for-bit runs pass).  A wrong batch moves
# the weights elsewhere altogether: a gap of order 1.
RESIDENT_GAP_ROOM, RESIDENT_GAP_FLOOR = 3.0, 1e-6
# train(profile_steps=PROFILE_WINDOW) over PROFILE_WINDOW[1] + 1 steps.
PROFILE_WINDOW = (3, 5)
# The kernels' __global__ names (csrc/stem_conv.cu, csrc/grouping.cu).
STEM_KERNEL_NAME, GROUPING_KERNEL_NAME = ("stem_conv_mma_kernel",
                                          "group_and_fuse_kernel")

# Phase 16: rematerialization, mn40_12view at full width (12 views of
# 224x224, bf16), B = 8 and REMAT_BIG_B.  The variants: none, `remat_until`
# REMAT_UNTIL (the prefix whose activations are the largest) and
# `remat_backbone`.  A remat step runs the same ops on the same inputs as
# the plain step, and BatchNorm moves its statistics once, so loss and
# every running statistic are held bit-equal.  Gradients: the all-tensor
# cosine at least REMAT_GRAD_COS_MIN and every tensor's |ln(norm ratio)|
# at most REMAT_GRAD_LOGRATIO_MAX (tensors whose gradient is rounding noise
# on both sides, `measure.NOISE_REL`, left out): the room of a summation
# order cuDNN might pick anew, though repeated runs of the step on the card
# have been bit-equal; whether they are bit-equal is printed.  The stem
# kernel runs inside both regions, so the backward's recompute launches
# it again; the grouping kernel runs outside them: (bf16 stem, fp32 stem,
# grouping) launches a step in REMAT_LAUNCHES.  Step times at B = 8 in the
# turns of REMAT_TURNS.
REMAT_UNTIL = "MaxPool_3a_3x3"
REMAT_VARIANTS = (("none", {}), ("until", dict(remat_until=REMAT_UNTIL)),
                  ("backbone", dict(remat_backbone=True)))
REMAT_LAUNCHES = {"none": (1, 0, 1), "until": (2, 0, 1),
                  "backbone": (2, 0, 1)}
REMAT_TURNS = ("none", "until", "backbone", "backbone", "until", "none")
REMAT_BIG_B = 64
REMAT_GRAD_COS_MIN, REMAT_GRAD_LOGRATIO_MAX = 0.9999, 1e-3

# Phase 20: the max-pool kernels at the B = 32 train step's pools
# (POOL_IMAGES images): (pool, H = W, C, k, s), Inception-v1's 13 in order,
# then ResNet-50's.
POOL_IMAGES = 384
POOL_SHAPES = (
    ("MaxPool_2a_3x3", 112, 64, 3, 2), ("MaxPool_3a_3x3", 56, 192, 3, 2),
    ("Mixed_3b", 28, 192, 3, 1), ("Mixed_3c", 28, 256, 3, 1),
    ("MaxPool_4a_3x3", 28, 480, 3, 2), ("Mixed_4b", 14, 480, 3, 1),
    ("Mixed_4c", 14, 512, 3, 1), ("Mixed_4d", 14, 512, 3, 1),
    ("Mixed_4e", 14, 512, 3, 1), ("Mixed_4f", 14, 528, 3, 1),
    ("MaxPool_5a_2x2", 14, 832, 2, 2), ("Mixed_5b", 7, 832, 3, 1),
    ("Mixed_5c", 7, 832, 3, 1), ("resnet50_pool1", 112, 64, 3, 2))

# Phase 21: the average-pool kernels at the B = 32 Inception-v4 train
# step's pools (AVG_POOL_IMAGES images): (blocks, H = W, C, pools).
AVG_POOL_IMAGES = 384
AVG_POOL_SHAPES = (("Mixed_5b-5e", 35, 384, 4), ("Mixed_6b-6h", 17, 1024, 7),
                   ("Mixed_7b-7d", 8, 1536, 3))

# Phase 22: the train-mode BatchNorm kernels over every BatchNorm of one
# B = 32 train step (BN_IMAGES images) of each train cell's configuration,
# each at its published size; BN_REPLAYS timed graph replays a side.
BN_IMAGES = 384
BN_CONFIGS = {"mn40_12view": 224, "mn40_12view_resnet50": 224,
              "mn40_12view_inception_v4": 299,
              "mn40_12view_inception_resnet_v2": 299}
BN_REPLAYS = 10
# Its check of each layer against the plain versions (the card tests'
# tolerances, `tests/test_torch_cuda_kernels.py`): statistics relative to
# the largest channel std (the mean) or to themselves, gradients relative
# to max|dx| or to the channel's sum of |terms|.
BN_STATS_REL, BN_GRAD_REL = 1e-4, 1e-4
# Train-mode BatchNorm calls a forward (counted by hooks on the CPU): each
# launches the stats and apply kernels in a train forward and the backward
# reduce and elementwise kernels in its backward; a served or eval forward
# launches none.  remat_until = REMAT_UNTIL recomputes REMAT_BATCH_NORMS
# of them (Conv2d_1a-2c) in the backward: forward kernels only.
BN_LAYERS = {"mn40_12view": 58, "mn40_12view_mvcnn": 57,
             "mn10_single_view": 57, "mn40_12view_resnet50": 57,
             "mn40_12view_inception_v4": 150,
             "mn40_12view_inception_resnet_v2": 205}
REMAT_BATCH_NORMS = 3

# Phase 23: the residual join's kernels at Inception-ResNet-v2's joins of
# one B = 32 train step (JOIN_IMAGES images of 299x299): (join, H = W, C,
# scale, ReLU, joins a forward).
JOIN_IMAGES = 384
JOIN_SHAPES = (("block35", 35, 320, 0.17, True, 10),
               ("block17", 17, 1088, 0.10, True, 20),
               ("block8", 8, 2080, 0.20, True, 9),
               ("Block8", 8, 2080, 1.0, False, 1))
# dbias against the plain version's: within this share of the channel's
# sum of |du| (fp32 sums in another order; the card tests' bound).
JOIN_DBIAS_REL = 1e-4

# Phase 17: the step-analysis tools.  bench_layers at the flagship's folded
# B = 8 step (96 images of 224x224, bf16); a row whose time is under its
# bound by more than 5% means the work count is wrong.  The count's
# card-vs-CPU check at COUNT_SHAPE (B, V, H, W).  bench_phases at
# PHASES_B shapes, PHASES_ITERS calls a variant.
LAYERS_B, LAYERS_HW = 96, 224
LAYERS_ENDPOINTS = ("Conv2d_1a_7x7", "MaxPool_2a_3x3", "Mixed_3b",
                    "Mixed_4e", "Mixed_5c")
LAYERS_ITERS = 30
BOUND_FRAC_MAX = 1.05
COUNT_SHAPE = (2, 12, 64, 64)
PHASES_B = (8, 32)
PHASES_ITERS = 10

# Phase 18: the last step-analysis tools.  profile_step's train step at
# TOOLS_B shapes (12 views of 224x224, bf16) on the card; at least
# ATTRIBUTED_MIN of its kernel time tied to a layer or a bucket.  The CPU
# references run at TOOLS_TINY (B, V, H, W) in bf16 with channels-last
# parameters, as the card's are (phase 17's count check), and the card runs
# the same tiny step to compare with.  dump_ops on Mixed_3b at DUMP_B
# images; bench_stem at its default 384 images; bench_variants and
# bench_backend_flags at TOOLS_B shapes, TOOLS_ITERS steps.
TOOLS_B = 8
TOOLS_TINY = (2, 4, 64, 64)
ATTRIBUTED_MIN = 0.99
DUMP_B = 96
TOOLS_VARIANTS = ("baseline", "merge_1x1", "wire_uint8", "wire_uint8_flip")
TOOLS_ITERS = 10
# Phase 19, the compiled step: states COMPILED_WARM eager steps past init
# (so that the scoring FCN has a gradient), COMPILED_STEPS steps a run at
# each of COMPILED_B, the resident split staged at COMPILED_SPLIT shapes;
# times in turns (eager, compiled, compiled, eager) of COMPILED_RUNS
# samples after 2 warm-up calls: the median of 2 x COMPILED_RUNS each; a
# profiled window of COMPILED_WINDOW steps; SERVE_SAMPLES requests at B =
# 1 and 8 (an eager engine's every EAGER_SERVE_EVERY-th turn, beside them);
# the other families' steps at FAMILY_B.  A run whose eager
# repeat is not bit-equal holds the compiled run's largest difference from
# the first eager run to COMPILED_SPREAD x the two eager runs' own.
COMPILED_WARM, COMPILED_STEPS, COMPILED_B = 5, 10, (8, 32)
COMPILED_SPLIT, COMPILED_RUNS, COMPILED_WINDOW = 64, 10, 3
COMPILED_SPREAD = 2.0
COMPILED_FAMILIES = {"mn10_single_view": (0, 1, 0),
                     "mn40_12view_resnet50": (0, 0, 1)}
# The max-pool kernels' (forward, backward) launches a step: Inception-v1's
# 13 pools a microbatch, and with remat_until = REMAT_UNTIL the recompute
# of MaxPool_2a and _3a (2 microbatches: 2 x (13 + 2) forwards); ResNet-50
# has one pool.
COMPILED_POOL_LAUNCHES = {"uint8_dropout": (13, 13),
                          "resident_flip_acc2_remat": (30, 26),
                          "mn10_single_view": (13, 13),
                          "mn40_12view_resnet50": (1, 1)}
SERVE_SAMPLES, EAGER_SERVE_EVERY, FAMILY_B = 200, 4, 8


def log(msg):
    print(msg, flush=True)


def bound(nbytes, flops, kind):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the operations over its peak rate for `kind` ("bfloat16",
    "tf32" or "float32"), from `bench_layers.PEAKS` (NVIDIA's data sheet
    for the H100 SXM; another card raises)."""
    from gvcnn_tf_tpu_torch.tools.bench_layers import PEAKS

    rates = PEAKS[torch.cuda.get_device_name(0)]
    t_bytes, t_ops = nbytes / rates["bytes"], flops / rates[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_card():
    from gvcnn_tf_tpu_torch.tools.measure import card_line

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible; TF32 as PyTorch's defaults "
        f"(cuDNN {torch.backends.cudnn.allow_tf32}, matmul "
        f"{torch.backends.cuda.matmul.allow_tf32})")
    return card


def phase_build():
    from gvcnn_tf_tpu_torch.ops import _build

    info = _build.build()
    _build.library()
    log(f"kernels: {info['path']} compiled={info['compiled']} in "
        f"{info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _bf16_ulp(t):
    """Spacing of bf16 numbers at |t| (t float32)."""
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _check_stem_epilogue(got, want, conv, scale):
    """The kernel rounds relu(acc * scale + shift) once; the plain version
    rounds the conv, then the result.  They may differ by |scale| x one bf16
    ulp of the conv output, plus one ulp of the result, plus |scale| x 1e-5
    for fp32 sums taken in another order."""
    tol = scale.abs() * (_bf16_ulp(conv) + 1e-5) + _bf16_ulp(want)
    excess = ((got.float() - want).abs() - tol).max().item()
    if excess > 0:
        raise AssertionError(f"stem epilogue off by {excess:.3g} past its "
                             "bound")


def phase_stem(dev):
    import torch.nn.functional as F

    from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import Stem
    from gvcnn_tf_tpu_torch.ops.pool import same_pads
    from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv, stem_conv_plain
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms, kernel_us

    rs = np.random.RandomState(0)
    w = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(np.float32))
    w = w.to(dev, torch.bfloat16)
    scale = torch.from_numpy(rs.uniform(0.5, 2.0, 64).astype(np.float32))
    shift = torch.from_numpy(rs.uniform(-1.0, 1.0, 64).astype(np.float32))
    scale, shift = scale.to(dev), shift.to(dev)
    max_err, timed = 0.0, None
    for shape in STEM_SHAPES:
        x = torch.from_numpy(rs.uniform(-1, 1, shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        with torch.inference_mode():
            got = stem_conv(x, w)
            fused = stem_conv(x, w, scale, shift, relu=True)
            torch.cuda.synchronize()
            want = stem_conv_plain(x, w)
            torch.testing.assert_close(got.float(), want.float(), **STEM_TOL)
            want_fused = stem_conv_plain(x, w, scale, shift, relu=True)
            _check_stem_epilogue(fused, want_fused.float(), want.float(),
                                 scale)
            err = (got.float() - want.float()).abs().max().item()
            efused = (fused.float() - want_fused.float()).abs().max().item()
        max_err = max(max_err, err, efused)
        log(f"stem {shape}: max|err| {err:.3g} (epilogue {efused:.3g})")
        if timed is not None:
            continue
        n, h, wd, _ = shape
        ph, pw = same_pads(h, 7, 2), same_pads(wd, 7, 2)
        with torch.inference_mode():
            xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
            timed = dict(
                ms=cuda_ms(lambda: stem_conv(x, w)),
                epilogue_ms=cuda_ms(
                    lambda: stem_conv(x, w, scale, shift, relu=True)),
                plain_ms=cuda_ms(lambda: stem_conv_plain(x, w)),
                library_ms=cuda_ms(lambda: F.conv2d(xn, w, stride=2)),
                device_ms=kernel_us(lambda: stem_conv(x, w),
                                    "stem_conv")[0] / 1e3)
        out_bytes = got.numel() * 2
        timed["bound_ms"], timed["bound_by"] = bound(
            x.numel() * 2 + w.numel() * 2 + out_bytes,
            2 * got.numel() * 147, "bfloat16")
        log(f"stem {shape}: kernel {timed['ms']:.4f} ms (with epilogue "
            f"{timed['epilogue_ms']:.4f}, device {timed['device_ms']:.4f}), "
            f"plain {timed['plain_ms']:.4f} ms, cuDNN conv on pre-padded "
            f"input {timed['library_ms']:.4f} ms, bound "
            f"{timed['bound_ms']:.4f} ms ({timed['bound_by']})")

        # The whole Conv2d_1a_7x7 layer: conv + BN + ReLU in the kernel, vs
        # the plain conv, then BatchNorm and ReLU as two more passes.
        stem = Stem().eval()
        with torch.no_grad():
            stem.conv.weight.copy_(w.float().cpu())
            stem.BatchNorm.bias.copy_(torch.from_numpy(
                rs.randn(64).astype(np.float32)))
            stem.BatchNorm.running_mean.copy_(torch.from_numpy(
                rs.randn(64).astype(np.float32)))
            stem.BatchNorm.running_var.copy_(torch.from_numpy(
                rs.uniform(0.25, 4.0, 64).astype(np.float32)))
        stem.conv.to(torch.bfloat16)
        stem.to(dev)

        def plain_layer():
            y = stem_conv_plain(x, stem.conv.weight).permute(0, 3, 1, 2)
            return F.relu(stem.BatchNorm(y))

        with torch.inference_mode():
            layer = stem(x)
            ref = plain_layer()
            torch.testing.assert_close(layer.float(), ref.float(),
                                       rtol=2e-2, atol=5e-2)
            timed["layer_ms"] = cuda_ms(lambda: stem(x))
            timed["plain_layer_ms"] = cuda_ms(plain_layer)
        log(f"Stem module {shape}: {timed['layer_ms']:.4f} ms; plain conv "
            f"-> BatchNorm -> ReLU {timed['plain_layer_ms']:.4f} ms")
    return dict(max_abs_err=max_err, **timed)


def phase_pool(dev):
    """Phase 20: the max-pool kernels against their plain versions at the
    B = 32 pools, timed (see the module docstring)."""
    import torch.nn.functional as F

    from gvcnn_tf_tpu_torch.ops import pool_kernel as pk
    from gvcnn_tf_tpu_torch.ops.pool import _pads
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms

    rows, rs = [], np.random.RandomState(0)
    for name, h, c, k, s in POOL_SHAPES:
        x = torch.from_numpy(rs.randn(POOL_IMAGES // 4, c, h, h).astype(
            np.float32)).to(dev, torch.bfloat16).repeat(4, 1, 1, 1)
        x = x.contiguous(memory_format=torch.channels_last)
        geo = ((k, k), (s, s), _pads(x, (k, k), (s, s), "SAME"))
        (pt, pb), (pl, pr) = geo[2]
        xp = F.pad(x, (pl, pr, pt, pb), value=-torch.inf)
        with torch.no_grad():
            y, _ = pk._forward(x, *geo, False)
            y2, slot = pk._forward(x, *geo, True)
            want = pk.max_pool_plain(x, *geo)
            want_y, want_slot = pk.max_pool_record_plain(x, *geo)
            if not (torch.equal(y, want) and torch.equal(y2, want)
                    and torch.equal(want_y, want)
                    and torch.equal(slot, want_slot)):
                raise AssertionError(f"max pool {name}: the kernel's output "
                                     "or record is not the plain one")
            del want_y, want_slot
            dy = torch.randn_like(y)
            dx = pk._backward(dy, slot, (h, h), *geo)
            want_dx = pk.max_pool_backward_plain(dy, slot, (h, h), *geo)
            wins = pk.max_pool_backward_plain(
                torch.ones_like(dy, dtype=torch.float32), slot, (h, h), *geo)
            gap = (dx.float() - want_dx.float()).abs()
            if not (bool((gap[wins <= 1] == 0).all()) and bool(
                    (gap <= _bf16_ulp(want_dx.float())).all())):
                raise AssertionError(f"max pool {name}: dx off the plain "
                                     f"gather by {gap.max().item():.3g}")
            del want_dx, wins, gap
            lib_y, idx = F.max_pool2d(xp, k, s, return_indices=True)
            row = dict(
                pool=name, shape=[POOL_IMAGES, c, h, h], k=k, s=s,
                pads=[pt, pb, pl, pr],
                fwd_ms=cuda_ms(lambda: pk._forward(x, *geo, False)),
                fwd_record_ms=cuda_ms(lambda: pk._forward(x, *geo, True)),
                bwd_ms=cuda_ms(lambda: pk._backward(dy, slot, (h, h), *geo)),
                plain_fwd_ms=cuda_ms(lambda: pk.max_pool_plain(x, *geo)),
                plain_fwd_record_ms=cuda_ms(
                    lambda: pk.max_pool_record_plain(x, *geo)),
                plain_bwd_ms=cuda_ms(lambda: pk.max_pool_backward_plain(
                    dy, slot, (h, h), *geo)),
                library_fwd_ms=cuda_ms(
                    lambda: F.max_pool2d(xp, k, s, return_indices=True)),
                library_bwd_ms=cuda_ms(
                    lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                        dy, xp, [k, k], [s, s], [0, 0], [1, 1], False, idx)))
        io_bytes = (x.numel() + y.numel()) * 2
        row["fwd_bound_ms"] = bound(io_bytes, 0, "bfloat16")[0]
        row["fwd_record_bound_ms"] = bound(io_bytes + y.numel(), 0,
                                           "bfloat16")[0]
        row["bwd_bound_ms"] = bound(io_bytes + y.numel(), 0, "bfloat16")[0]
        for way in ("fwd", "fwd_record", "bwd"):
            row[f"{way}_share"] = row[f"{way}_bound_ms"] / row[f"{way}_ms"]
        log("max pool " + json.dumps(row))
        rows.append(row)
        del x, xp, y, y2, slot, dy, dx, lib_y, idx, want
    inception = rows[:13]
    total = {key: sum(r[key] for r in inception) for key in rows[0]
             if key.endswith("_ms")}
    for way in ("fwd", "fwd_record", "bwd"):
        total[f"{way}_share"] = total[f"{way}_bound_ms"] / total[f"{way}_ms"]
    total["train_ms"] = total["fwd_record_ms"] + total["bwd_ms"]
    total["train_bound_ms"] = (total["fwd_record_bound_ms"]
                               + total["bwd_bound_ms"])
    total["library_train_ms"] = (total["library_fwd_ms"]
                                 + total["library_bwd_ms"])
    log("max pool, Inception-v1's 13 pools at B = 32: " + json.dumps(total))
    return dict(inception=total, resnet50=rows[13],
                autograd=_pool_autograd(dev, rs))


def _pool_autograd(dev, rs):
    """The main path's entry under autograd at one asymmetric B = 32 pool
    (MaxPool_3a_3x3, pads (0, 1)): `pool.max_pool` (through the pool's
    op and its registered gradient: one forward and one backward launch)
    against
    `F.pad` + `F.max_pool2d` and autograd's gradient of it; the output bit
    for bit, dx bit-equal where an input wins one window and within one
    bf16 ulp where it wins several."""
    from gvcnn_tf_tpu_torch.ops import pool_kernel as pk
    from gvcnn_tf_tpu_torch.ops.pool import _pads, max_pool

    name, h, c, k, s = POOL_SHAPES[1]
    x = torch.from_numpy(rs.randn(POOL_IMAGES, c, h, h).astype(
        np.float32)).to(dev, torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    before = _pool_counts()
    y = max_pool(xa, (k, k), (s, s), "SAME")
    dy = torch.randn_like(y)
    y.backward(dy)
    torch.cuda.synchronize(dev)
    moved = tuple(a - b for a, b in zip(_pool_counts(), before))
    geo = ((k, k), (s, s), _pads(x, (k, k), (s, s), "SAME"))
    want = pk.max_pool_plain(xb, *geo)
    want.backward(dy)
    with torch.no_grad():
        _, slot = pk.max_pool_record_plain(x, *geo)
        wins = pk.max_pool_backward_plain(
            torch.ones_like(dy, dtype=torch.float32), slot, (h, h), *geo)
        got, ref = xa.grad.float(), xb.grad.float()
        gap = (got - ref).abs()
        out = dict(pool=name, shape=[POOL_IMAGES, c, h, h],
                   grad_fn=type(y.grad_fn).__name__, launches=list(moved),
                   y_equal=bool(torch.equal(y, want)),
                   dx_max_abs_gap=gap.max().item(),
                   dx_single_win_equal=bool((gap[wins <= 1] == 0).all()),
                   dx_within_ulp=bool((gap <= _bf16_ulp(ref)).all()))
    log("max pool under autograd, pool.max_pool against F.max_pool2d: "
        + json.dumps(out))
    if not (out["y_equal"] and out["dx_single_win_equal"]
            and out["dx_within_ulp"] and moved == (1, 1)
            and "gvcnn_max_pool_same" in out["grad_fn"]):
        raise AssertionError(f"max pool {name} under autograd: {out}")
    return out


def phase_avg_pool(dev):
    """Phase 21: the average-pool kernels against their plain versions at
    the B = 32 Inception-v4 pools, timed (see the module docstring)."""
    import torch.nn.functional as F

    from gvcnn_tf_tpu_torch.ops import pool_kernel as pk
    from gvcnn_tf_tpu_torch.ops.pool import avg_pool
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms

    gen = torch.Generator(device=dev).manual_seed(21)

    def draw(h, c):
        return torch.randn(AVG_POOL_IMAGES, c, h, h, generator=gen,
                           device=dev).to(torch.bfloat16).contiguous(
                               memory_format=torch.channels_last)

    def within_ulp(got, want):
        """(max gap, within one bf16 ulp of want, plus 1e-6 where a window
        cancels toward 0)."""
        gap = (got.float() - want.float()).abs()
        return gap.max().item(), bool(
            (gap <= _bf16_ulp(want.float()) + 1e-6).all())

    start = _avg_counts()
    rows = []
    for name, h, c, count in AVG_POOL_SHAPES:
        x, dy = draw(h, c), draw(h, c)
        with torch.no_grad():
            y = pk._box(x, False)
            dx = pk._box(dy, True)
            checks = dict(
                fwd=within_ulp(y, pk.avg_pool_plain(x)),
                bwd_plain=within_ulp(dx, pk.avg_pool_backward_plain(dy)),
                bwd_nchw=within_ulp(dx, torch.ops.aten.avg_pool2d_backward(
                    dy.float().contiguous(), x.float().contiguous(), [3, 3],
                    [1, 1], [1, 1], False, True, None).to(dx.dtype)))
            lib_dx = torch.ops.aten.avg_pool2d_backward(
                dy, x, [3, 3], [1, 1], [1, 1], False, True, None)
            library_cl_bwd_gap = (lib_dx.float()
                                  - dx.float()).abs().max().item()
            if not all(ok for _, ok in checks.values()):
                raise AssertionError(f"avg pool {name}: {checks}")
            row = dict(
                pools=name, shape=[AVG_POOL_IMAGES, c, h, h], count=count,
                fwd_ms=cuda_ms(lambda: pk._box(x, False)),
                bwd_ms=cuda_ms(lambda: pk._box(dy, True)),
                plain_fwd_ms=cuda_ms(lambda: pk.avg_pool_plain(x)),
                plain_bwd_ms=cuda_ms(
                    lambda: pk.avg_pool_backward_plain(dy)),
                library_fwd_ms=cuda_ms(lambda: F.avg_pool2d(
                    x, 3, 1, padding=1, count_include_pad=True)),
                library_bwd_ms=cuda_ms(
                    lambda: torch.ops.aten.avg_pool2d_backward(
                        dy, x, [3, 3], [1, 1], [1, 1], False, True, None)),
                max_gap={k: v[0] for k, v in checks.items()},
                library_cl_bwd_gap=library_cl_bwd_gap)
        row["bound_ms"] = bound((x.numel() + y.numel()) * 2, 0,
                                "bfloat16")[0]
        for way in ("fwd", "bwd"):
            row[f"{way}_share"] = row["bound_ms"] / row[f"{way}_ms"]
        log("avg pool " + json.dumps(row))
        rows.append(row)
        del x, dy, y, dx, lib_dx
    total = {key: sum(r[key] * r["count"] for r in rows)
             for key in rows[0] if key.endswith("_ms")}
    total["train_ms"] = total["fwd_ms"] + total["bwd_ms"]
    total["train_bound_ms"] = 2 * total["bound_ms"]
    total["train_share"] = total["train_bound_ms"] / total["train_ms"]
    total["plain_train_ms"] = total["plain_fwd_ms"] + total["plain_bwd_ms"]
    total["library_train_ms"] = (total["library_fwd_ms"]
                                 + total["library_bwd_ms"])
    log("avg pool, Inception-v4's 14 pools at B = 32: " + json.dumps(total))

    # The main path's entry under autograd at Mixed_5b's pool.
    _, h, c, _ = AVG_POOL_SHAPES[0]
    xa = draw(h, c).requires_grad_()
    before = _avg_counts()
    y = avg_pool(xa, (3, 3), (1, 1), "SAME")
    dy = draw(h, c)
    y.backward(dy)
    torch.cuda.synchronize(dev)
    moved = tuple(a - b for a, b in zip(_avg_counts(), before))
    with torch.no_grad():
        autograd = dict(
            grad_fn=type(y.grad_fn).__name__, launches=list(moved),
            y=within_ulp(y, pk.avg_pool_plain(xa.detach())),
            dx=within_ulp(xa.grad, pk.avg_pool_backward_plain(dy)))
    log("avg pool under autograd, pool.avg_pool: " + json.dumps(autograd))
    if not (moved == (1, 1) and "gvcnn_avg_pool_same" in autograd["grad_fn"]
            and autograd["y"][1] and autograd["dx"][1]):
        raise AssertionError(f"avg pool under autograd: {autograd}")
    end = _avg_counts()
    launches = dict(launches=end[0] - start[0], launches_bwd=end[1] - start[1])
    log("avg pool launch counters over phase 21: " + json.dumps(launches))
    return dict(inception_v4=total, by_shape=rows, autograd=autograd,
                **launches)


def _bn_layers(config, size, dev):
    """[(C, H, W, relu, scale)] of every train-mode BatchNorm call of one
    forward of `config`'s model at size x size, in order: an eager B = 1
    train step on the card with a pre-hook on each BatchNorm."""
    import dataclasses

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.models.backbones.layers import BatchNorm
    from gvcnn_tf_tpu_torch.tools.measure import train_batch
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    base = get_config(config)
    cfg = base.replace(data=dataclasses.replace(
        base.data, batch_size=1, height=size, width=size))
    state = create_train_state(cfg, dev)
    calls = []

    def hook(module, args, kwargs):
        x = args[0]
        calls.append((x.shape[1], x.shape[2], x.shape[3],
                      bool(kwargs.get("relu", False)),
                      module.scale is not None, x.shape[0]))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in state.model.modules() if isinstance(m, BatchNorm)]
    train_step(state, train_batch(cfg, np.random.RandomState(0), dev), cfg)
    for h in handles:
        h.remove()
    views = cfg.data.num_views
    if any(c[5] != views for c in calls):
        raise AssertionError(
            f"{config}: a BatchNorm saw another batch than {views} views: "
            f"{sorted(set(c[5] for c in calls))}")
    return [c[:5] for c in calls]


def _graph_ms(fn, dev, replays=BN_REPLAYS):
    """Median ms of one replay of fn() captured in a CUDA graph (warmed up
    eagerly on a side stream first), CUDA events around each replay."""
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(2):
        graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)


def _gap_over(got, want, bound):
    """max |got - want| / bound (bound a number or a tensor that
    broadcasts): 1 or less is inside it."""
    gap = (got.float() - want.float()).abs()
    bound = torch.as_tensor(bound, dtype=torch.float32, device=gap.device)
    return float((gap / bound.clamp_min(1e-30)).max())


def _check_bn_layer(k, momentum=0.9, eps=1e-3):
    """Phase 22's check of one layer's case `k`: its four kernels run once
    eagerly (the running statistics moved on copies), against the plain
    versions on fp32 copies on the card -> {quantity: its largest gap over
    its bound} (see the module docstring).  y and the gradients are taken
    from the kernels' own statistics, so the ReLU's mask is the same."""
    from gvcnn_tf_tpu_torch.ops import batch_norm_kernel as bk

    x, dy, weight, bias, relu = (k["x"], k["dy"], k["weight"], k["bias"],
                                 k["relu"])
    mask = [True, weight is not None, True]
    rm, rv = k["rm"].clone(), k["rv"].clone()
    mean, invstd = torch.ops.gvcnn.batch_norm_stats(x, rm, rv, momentum, eps,
                                                    True)
    y = torch.ops.gvcnn.batch_norm_apply(x, weight, bias, mean, invstd, relu)
    dx, dw, db = torch.ops.gvcnn.batch_norm_backward(
        dy, x, weight, bias, mean, invstd, relu, mask)
    xf, gf = x.float(), dy.float()
    mean_p, invstd_p = bk.stats_plain(xf, eps)
    rm_p, rv_p = k["rm"].clone(), k["rv"].clone()
    bk.update_plain(rm_p, rv_p, mean_p, bk.var_plain(invstd_p, eps), momentum)
    tol = BN_STATS_REL * float(invstd_p.reciprocal().max())
    out = dict(mean=_gap_over(mean, mean_p, tol),
               invstd=_gap_over(invstd, invstd_p, BN_STATS_REL * invstd_p),
               running_mean=_gap_over(rm, rm_p, tol),
               running_var=_gap_over(rv, rv_p, BN_STATS_REL * rv_p))
    want = bk.apply_plain(xf, weight, bias, mean, invstd, relu)
    out["y"] = _gap_over(y, want, _bf16_ulp(want))
    want = bk.backward_plain(gf, xf, weight, bias, mean, invstd, relu, mask)
    out["dx"] = _gap_over(dx, want[0], BN_GRAD_REL * float(
        want[0].abs().max()) + _bf16_ulp(want[0]))
    if relu:
        gf = torch.where(bk.apply_plain(xf, weight, bias, mean, invstd,
                                        False) > 0, gf, 0.0)
    out["dbeta"] = _gap_over(db, want[2],
                             BN_GRAD_REL * gf.abs().sum((0, 2, 3)))
    if weight is not None:
        xhat = (xf - mean[:, None, None]) * invstd[:, None, None]
        out["dgamma"] = _gap_over(dw, want[1], BN_GRAD_REL * (
            gf * xhat).abs().sum((0, 2, 3)))
    return out


def phase_batch_norm(dev):
    """Phase 22: the train-mode BatchNorm kernels over one B = 32 step's
    BatchNorms of each train cell's configuration (see the module
    docstring)."""
    import torch.nn.functional as F

    from gvcnn_tf_tpu_torch.ops import launched

    rates = bound(1, 0, "bfloat16")[0]  # ms a byte
    out = {}
    for config, size in BN_CONFIGS.items():
        layers = _bn_layers(config, size, dev)
        n = BN_IMAGES
        sizes = [n * c * h * w for c, h, w, _, _ in layers]
        gen = torch.Generator(device=dev).manual_seed(22)
        xbuf = torch.randn(max(sizes), generator=gen, device=dev).mul_(
            1.5).add_(0.3).to(torch.bfloat16)
        dybuf = torch.randn(max(sizes), generator=gen, device=dev).to(
            torch.bfloat16)

        def nchw(buf, c, h, w):
            return buf[:n * c * h * w].view(n, h, w, c).permute(0, 3, 1, 2)

        cases = []
        for c, h, w, relu, scale in layers:
            weight = (torch.rand(c, generator=gen, device=dev) + 0.5
                      if scale else None)
            bias = torch.randn(c, generator=gen, device=dev) * 0.5
            cases.append(dict(
                x=nchw(xbuf, c, h, w), dy=nchw(dybuf, c, h, w), relu=relu,
                weight=weight, bias=bias, rm=torch.zeros(c, device=dev),
                rv=torch.ones(c, device=dev),
                unit=torch.ones(c, device=dev)))
        for k in cases:
            k["mean"], k["invstd"] = torch.ops.gvcnn.batch_norm_stats(
                k["x"], k["rm"], k["rv"], 0.9, 1e-3, False)
            y, k["lmean"], k["linvstd"] = torch.native_batch_norm(
                k["x"], k["weight"] if k["weight"] is not None else k["unit"],
                k["bias"], None, None, True, 0.0, 1e-3)
            k["ly"] = F.relu(y) if k["relu"] else y
        worst = {}
        for k in cases:
            for q, r in _check_bn_layer(k).items():
                worst[q] = max(worst.get(q, 0.0), r)
        log(f"batch norm, {config}'s {len(layers)} BatchNorms at B = 32 "
            "against the plain versions on fp32 copies, the largest gap "
            "over its bound (1 or less passes): " + json.dumps(worst))
        if not all(r <= 1.0 for r in worst.values()):
            raise AssertionError(f"{config}: the BatchNorm kernels miss the "
                                 f"plain versions: {worst}")

        def forward():
            for k in cases:
                mean, invstd = torch.ops.gvcnn.batch_norm_stats(
                    k["x"], k["rm"], k["rv"], 0.9, 1e-3, True)
                torch.ops.gvcnn.batch_norm_apply(k["x"], k["weight"],
                                                 k["bias"], mean, invstd,
                                                 k["relu"])

        def backward():
            for k in cases:
                torch.ops.gvcnn.batch_norm_backward(
                    k["dy"], k["x"], k["weight"], k["bias"], k["mean"],
                    k["invstd"], k["relu"],
                    [True, k["weight"] is not None, True])

        def library_forward():
            for k in cases:
                y = torch.native_batch_norm(
                    k["x"], k["weight"] if k["weight"] is not None
                    else k["unit"], k["bias"], None, None, True, 0.0,
                    1e-3)[0]
                if k["relu"]:
                    F.relu(y)

        def library_backward():
            for k in cases:
                g = (torch.ops.aten.threshold_backward(k["dy"], k["ly"], 0)
                     if k["relu"] else k["dy"])
                torch.ops.aten.native_batch_norm_backward(
                    g, k["x"], k["weight"] if k["weight"] is not None
                    else k["unit"], None, None, k["lmean"], k["linvstd"],
                    True, 1e-3, [True, k["weight"] is not None, True])

        before = {w: launched(f"batch_norm_{w}") for w in
                  ("stats", "apply", "bwd_reduce", "bwd_elemt")}
        row = dict(
            layers=len(layers), elements=sum(sizes),
            relu_layers=sum(c[3] for c in layers),
            worst_gap_over_bound=worst,
            fwd_ms=_graph_ms(forward, dev), bwd_ms=_graph_ms(backward, dev),
            library_fwd_ms=_graph_ms(library_forward, dev),
            library_bwd_ms=_graph_ms(library_backward, dev))
        moved = {w: launched(f"batch_norm_{w}") - b
                 for w, b in before.items()}
        # Warm-up and capture: two calls of each.
        if set(moved.values()) != {2 * len(layers)}:
            raise AssertionError(f"{config}: launches {moved}, expected "
                                 f"{2 * len(layers)} of each")
        row["bound_fwd_ms"] = 3 * 2 * sum(sizes) * rates
        row["bound_bwd_ms"] = 5 * 2 * sum(sizes) * rates
        row["train_ms"] = row["fwd_ms"] + row["bwd_ms"]
        row["library_train_ms"] = row["library_fwd_ms"] + row["library_bwd_ms"]
        row["train_bound_ms"] = row["bound_fwd_ms"] + row["bound_bwd_ms"]
        for way, key in (("fwd", "bound_fwd_ms"), ("bwd", "bound_bwd_ms"),
                         ("train", "train_bound_ms")):
            row[f"{way}_share"] = row[key] / row[f"{way}_ms"]
        log(f"batch norm, {config}'s {len(layers)} BatchNorms at B = 32: "
            + json.dumps(row))
        out[config] = row
        del xbuf, dybuf, cases
        torch.cuda.empty_cache()
    return out


def _join_counts():
    """(forward, backward, bias-gradient) launches of the residual join's
    kernels."""
    from gvcnn_tf_tpu_torch.ops import launched

    return (launched("residual_join_fwd"), launched("residual_join_bwd"),
            launched("residual_join_bias_grad"))


def _check_join(x, u, dy, b, scale, relu):
    """Phase 23's check of one join: its three kernels once, through their
    ops, against the plain versions -> {quantity: True where bit-equal,
    or dbias's largest gap over its bound; launches}."""
    from gvcnn_tf_tpu_torch.ops import residual_join as rj

    before = _join_counts()
    y = torch.ops.gvcnn.residual_join(x, u, b, scale, relu)
    saved = y if relu else None
    dx, du, db = torch.ops.gvcnn.residual_join_backward(dy, saved, scale,
                                                        relu)
    moved = tuple(a - c for a, c in zip(_join_counts(), before))
    want_dx, want_du, want_db = rj.residual_join_backward_plain(
        dy, saved, scale, relu)
    terms = scale * (want_dx if relu else dy).float().abs()
    return dict(
        launches=list(moved),
        y=torch.equal(y, rj.residual_join_plain(x, u, b, scale, relu)),
        dx=torch.equal(dx, want_dx) if relu else dx.numel() == 0,
        du=torch.equal(du, want_du),
        dbias=_gap_over(db, want_db, JOIN_DBIAS_REL * terms.sum((0, 2, 3))))


def phase_join(dev):
    """Phase 23: the residual join's kernels against their plain versions
    at Inception-ResNet-v2's B = 32 joins, each timed, then one step's 40
    joins in CUDA graphs (see the module docstring)."""
    from gvcnn_tf_tpu_torch.ops import residual_join as rj
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms, kernel_us

    rates = bound(1, 0, "bfloat16")[0]  # ms a byte
    gen = torch.Generator(device=dev).manual_seed(23)
    start = _join_counts()
    checks, rows, cases = {}, [], []
    for name, hw, c, scale, relu, count in JOIN_SHAPES:
        x, u, dy = (torch.randn(JOIN_IMAGES, c, hw, hw, generator=gen,
                                device=dev).to(torch.bfloat16).contiguous(
                                    memory_format=torch.channels_last)
                    for _ in range(3))
        b = torch.randn(c, generator=gen, device=dev)
        if relu:          # block35, block17 and block8 with and without it
            for with_relu in (True, False):
                check = _check_join(x, u, dy, b, scale, with_relu)
                checks[f"{name}_relu_{int(with_relu)}"] = check
                if not (check["launches"] == [1, 1, 1] and check["y"]
                        and check["dx"] and check["du"]
                        and check["dbias"] <= 1.0):
                    raise AssertionError(f"join {name}, relu {with_relu}: "
                                         f"the kernels miss the plain "
                                         f"versions: {check}")
        y = torch.ops.gvcnn.residual_join(x, u, b, scale, relu)
        saved = y if relu else None

        def fwd():
            return torch.ops.gvcnn.residual_join(x, u, b, scale, relu)

        def bwd():
            return torch.ops.gvcnn.residual_join_backward(dy, saved, scale,
                                                          relu)

        us_fwd, n_fwd = kernel_us(fwd, "residual_join_fwd")
        us_bwd, n_bwd = kernel_us(bwd, "residual_join_bwd")
        us_sum, n_sum = kernel_us(bwd, "residual_join_bias_grad")
        row = dict(
            join=name, shape=[JOIN_IMAGES, c, hw, hw], scale=scale,
            relu=relu, count=count,
            fwd_ms=cuda_ms(fwd), bwd_ms=cuda_ms(bwd),
            fwd_device_ms=us_fwd * n_fwd / 1e3,
            bwd_device_ms=(us_bwd * n_bwd + us_sum * n_sum) / 1e3,
            plain_fwd_ms=cuda_ms(
                lambda: rj.residual_join_plain(x, u, b, scale, relu)),
            plain_bwd_ms=cuda_ms(lambda: rj.residual_join_backward_plain(
                dy, saved, scale, relu)),
            library_ms=None,
            bound_fwd_ms=3 * 2 * x.numel() * rates,
            bound_bwd_ms=(3 if relu else 2) * 2 * x.numel() * rates)
        for way in ("fwd", "bwd"):
            row[f"{way}_share"] = (row[f"bound_{way}_ms"]
                                   / row[f"{way}_device_ms"])
        log("join " + json.dumps(row))
        rows.append(row)
        cases.append(dict(x=x, u=u, dy=dy, b=b, y=saved, scale=scale,
                          relu=relu, count=count))
    worst = max(k["dbias"] for k in checks.values())
    log(f"join, {len(checks)} checks at B = 32 against the plain versions: "
        f"y, dx and du bit-equal, dbias's largest gap over its bound "
        f"{worst:.4g} (1 or less passes)")

    def forward():
        for k in cases:
            for _ in range(k["count"]):
                torch.ops.gvcnn.residual_join(k["x"], k["u"], k["b"],
                                              k["scale"], k["relu"])

    def backward():
        for k in cases:
            for _ in range(k["count"]):
                torch.ops.gvcnn.residual_join_backward(
                    k["dy"], k["y"], k["scale"], k["relu"])

    joins = sum(k["count"] for k in cases)
    before = _join_counts()
    step = dict(joins=joins, fwd_ms=_graph_ms(forward, dev),
                bwd_ms=_graph_ms(backward, dev))
    moved = [a - c for a, c in zip(_join_counts(), before)]
    # Warm-up and capture: two calls of each.
    if moved != [2 * joins] * 3:
        raise AssertionError(f"join step: launches {moved}, expected "
                             f"{2 * joins} of each kernel")
    step["elements"] = sum(k["x"].numel() * k["count"] for k in cases)
    step["train_ms"] = step["fwd_ms"] + step["bwd_ms"]
    step["train_bound_ms"] = 6 * 2 * step["elements"] * rates
    step["train_share"] = step["train_bound_ms"] / step["train_ms"]
    log(f"join, one B = 32 step's {joins} joins in CUDA graphs: "
        + json.dumps(step))
    end = _join_counts()
    launches = [a - c for a, c in zip(end, start)]
    log("join launch counters over phase 23 (forward, backward, bias "
        f"gradient): {launches}")
    del cases
    torch.cuda.empty_cache()
    return dict(by_shape=rows, checks=checks, worst_dbias_gap=worst,
                step_b32=step, launches=launches)


def _clear_scores(rs, b, v, m):
    while True:
        s = rs.dirichlet(np.ones(v) * 0.7, size=b).astype(np.float32)
        if m == 1 or np.abs(s[..., None] - np.arange(1, m) / m).min() > 1e-5:
            return s


def _edge_scores(b, v, m):
    grid = np.arange(0, m + 1, dtype=np.float32) / np.float32(m)
    return grid[np.arange(b * v).reshape(b, v) * 3 % (m + 1)]


def phase_grouping(dev, c=1024):
    """The grouping kernel against its plain version at C = `c` channels
    (Inception-v1 and v2: 1024; v4: 1536; ResNet-50 and v3: 2048)."""
    from gvcnn_tf_tpu_torch.ops.grouping_kernel import (
        group_and_fuse,
        group_and_fuse_plain,
    )
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms, kernel_us

    rs = np.random.RandomState(1)
    cases = [(8, 12, c, 8, mode, False) for mode in ("mean", "ceil_sum")]
    cases += [(8, v, c, m, "mean", False) for m in (1, 8, 16)
              for v in (1, 8, 12)]
    cases += [(8, 12, c, m, mode, True) for m in (1, 8, 16)
              for mode in ("mean", "ceil_sum")]
    max_err, empty_seen = 0.0, False
    for b, v, c, m, mode, edges in cases:
        scores = _edge_scores(b, v, m) if edges else _clear_scores(rs, b, v, m)
        s = torch.from_numpy(scores).to(dev)
        d = torch.from_numpy(rs.randn(b, v, c).astype(np.float32)).to(dev)
        with torch.inference_mode():
            got = [t.cpu().numpy() for t in group_and_fuse(s, d, m, mode)]
            want = [t.cpu().numpy() for t in group_and_fuse_plain(s, d, m,
                                                                 mode)]
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
        empty_seen |= bool((want[2].sum(-1) == 0).any())
        max_err = max(max_err, float(np.abs(got[0] - want[0]).max()),
                      float(np.abs(got[1] - want[1]).max()))
    if not empty_seen:
        raise AssertionError("no case had an empty group")
    log(f"grouping (C={c}): {len(cases)} cases match, max|err| "
        f"{max_err:.3g}")

    b, v, m = 8, 12, 8
    s = torch.from_numpy(_clear_scores(rs, b, v, m)).to(dev)
    d = torch.from_numpy(rs.randn(b, v, c).astype(np.float32)).to(dev)
    with torch.inference_mode():
        ms = cuda_ms(lambda: group_and_fuse(s, d, m))
        device_ms = kernel_us(lambda: group_and_fuse(s, d, m),
                              "group_and_fuse")[0] / 1e3
        plain_ms = cuda_ms(lambda: group_and_fuse_plain(s, d, m))
    # Reads scores and descriptors, writes fused, weights and scheme; per
    # channel V compares and maxima and M multiply-adds in fp32.
    bound_ms, bound_by = bound(
        4 * (b * v + b * v * c + b * c + b * m + b * m * v),
        b * c * (2 * v + 2 * m), "float32")
    log(f"grouping ({b}, {v}, {c}, M={m}): kernel {ms:.4f} ms (device "
        f"{device_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} "
        f"ms ({bound_by})")
    return dict(max_abs_err=max_err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def _post(url, views):
    buf = io.BytesIO()
    np.savez(buf, views=views)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            raise AssertionError(f"/predict returned {r.status}")
        return json.loads(r.read())


def _check_results(results, n, num_views):
    if len(results) != n:
        raise AssertionError(f"{len(results)} results for {n} shapes")
    for r in results:
        if not 0 <= r["class_index"] < 40:
            raise AssertionError(f"class_index {r['class_index']}")
        if not 0 < r["probability"] <= 1:
            raise AssertionError(f"probability {r['probability']}")
        if len(r["view_scores"]) != num_views or not np.all(
                np.isfinite(r["view_scores"])):
            raise AssertionError(f"view_scores {r['view_scores']}")
        if abs(sum(r["view_scores"]) - 1.0) > 1e-4:
            raise AssertionError(f"view_scores sum {sum(r['view_scores'])}")


def phase_slice(card):
    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
    from gvcnn_tf_tpu_torch.serve import serve
    from gvcnn_tf_tpu_torch.utils import fold_batch_norm

    cfg = get_config("mn40_12view")
    t0 = time.perf_counter()
    httpd, thread, engine = serve(cfg, port=0, serve_batch_size=8,
                                  block=False, device="cuda")
    try:
        log(f"engine up in {time.perf_counter() - t0:.1f} s, buckets "
            f"{engine.buckets}")
        url = f"http://127.0.0.1:{httpd.server_address[1]}/predict"
        rs = np.random.RandomState(2)
        d = cfg.data
        shape = (d.num_views, d.height, d.width, 3)
        u8 = lambda n: rs.randint(0, 256, (n,) + shape).astype(np.uint8)
        fl = lambda n: rs.uniform(-1, 1, (n,) + shape).astype(np.float32)

        _zero_counts()
        for n, views in [(1, u8(1)), (8, fl(8)), (11, fl(11))]:
            _check_results(_post(url, views), n, d.num_views)
        launches = _by_kernel()
        log(f"launches over the B=1, 8, 11 requests: {launches} in "
            f"{FORWARDS} forwards")
        # 1 + 1 + 2 chunks (11 = 8 + 3 padded to 8), one launch each.
        if launches != {"stem": FORWARDS, "grouping": FORWARDS}:
            raise AssertionError(f"expected {FORWARDS} launches of each "
                                 f"kernel, got {launches}")

        views2 = fl(2)
        logits, scores = engine.logits_and_scores(views2)
        ref = fold_batch_norm(init_weights(build_model(
            cfg.replace(compute_dtype="float32")), cfg.train.seed)).eval()
        with torch.inference_mode():
            ref_logits, ep = ref(torch.from_numpy(views2))
        ref_logits = ref_logits.numpy()
        ref_scores = ep["view_discrimination_scores"].numpy()
        for a in (logits, scores):
            if not np.all(np.isfinite(a)):
                raise AssertionError("non-finite output on the card")
        scale = float(np.abs(ref_logits).max())
        dlogit = float(np.abs(logits - ref_logits).max())
        dscore = float(np.abs(scores - ref_scores).max())
        log(f"B=2 card (bf16) vs CPU (fp32): max|dlogit| {dlogit:.4g} of "
            f"max|logit| {scale:.4g} (rel {dlogit / scale:.3g}, bound "
            f"{LOGIT_REL_TOL}); max|dscore| {dscore:.3g} (bound "
            f"{SCORE_ABS_TOL}); argmax {logits.argmax(-1).tolist()} vs "
            f"{ref_logits.argmax(-1).tolist()}")
        if dlogit > LOGIT_REL_TOL * scale or dscore > SCORE_ABS_TOL:
            raise AssertionError("card and CPU reference disagree")
        if not np.array_equal(logits.argmax(-1), ref_logits.argmax(-1)):
            raise AssertionError("card and CPU reference argmax differ")

        for n in (1, 8):
            views = u8(n)
            http, eng = [], []
            for _ in range(REQUESTS):
                t = time.perf_counter()
                _post(url, views)
                http.append(time.perf_counter() - t)
                t = time.perf_counter()
                engine.predict(views)
                eng.append(time.perf_counter() - t)
            h50, e50 = statistics.median(http), statistics.median(eng)
            log(f"B={n} uint8 request p50: HTTP {h50 * 1e3:.2f} ms, engine "
                f"{e50 * 1e3:.2f} ms; {n * d.num_views / e50:.1f} views/s "
                f"engine, {n * d.num_views / h50:.1f} views/s HTTP [{card}]")
        log(f"/stats: {json.dumps(engine.latency_stats())}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
        thread.join(timeout=60)
    return launches


def phase_stem_backward(dev):
    import torch.nn.functional as F

    from gvcnn_tf_tpu_torch.ops.pool import same_pads
    from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv, stem_conv_plain
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms

    rs = np.random.RandomState(6)
    w32 = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(
        np.float32)).to(dev)
    max_err, timed = 0.0, None
    for shape in STEM_GRAD_SHAPES:
        n, h, wd, _ = shape
        x = torch.from_numpy(rs.uniform(-1, 1, shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        g = torch.from_numpy(rs.randn(n, -(-h // 2), -(-wd // 2), 64).astype(
            np.float32)).to(dev, torch.bfloat16)
        need_dx = shape != STEM_GRAD_SHAPES[0]
        grads = []
        for fn in (stem_conv, stem_conv_plain):
            xg = x.clone().requires_grad_(need_dx)
            w = w32.clone().requires_grad_()
            fn(xg, w.to(torch.bfloat16)).backward(g)
            grads.append((w.grad, xg.grad))
        torch.cuda.synchronize()
        errs = []
        for got, want in zip(grads[0], grads[1]):
            if want is None:
                continue
            tol = 1e-2 * want.abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"stem gradient {shape}: max|err| "
                                     f"{err:.4g} past {tol:.4g}")
            errs.append(err / want.abs().max().item())
        max_err = max(max_err, *errs)
        log(f"stem backward {shape}: dw{' and dx' if need_dx else ''} match "
            f"autograd through the plain version (max|err| / max "
            f"{max(errs):.3g}, bound 1e-2)")
        if timed is not None:
            continue
        w = w32.clone().requires_grad_()
        wb = w.to(torch.bfloat16)

        def fwd_bwd():
            w.grad = None
            stem_conv(x, w.to(torch.bfloat16)).backward(g)

        y = stem_conv(x, wb)
        ph, pw = same_pads(h, 7, 2), same_pads(wd, 7, 2)
        xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
        gn = g.permute(0, 3, 1, 2)
        wbd = wb.detach()
        timed = dict(
            fwd_bwd_ms=cuda_ms(fwd_bwd),
            backward_ms=cuda_ms(lambda: torch.autograd.grad(
                y, wb, g, retain_graph=True)),
            plain_fwd_bwd_ms=cuda_ms(lambda: stem_conv_plain(
                x, w.to(torch.bfloat16)).backward(g)),
            backward_library_ms=cuda_ms(
                lambda: torch.ops.aten.convolution_backward(
                    gn, xn, wbd, None, [2, 2], [0, 0], [1, 1], False, [0, 0],
                    1, [False, True, False])))
        # dw: reads x and the output gradient, writes dw; 147 multiply-adds
        # per element of the output gradient.
        timed["backward_bound_ms"], timed["backward_bound_by"] = bound(
            x.numel() * 2 + g.numel() * 2 + w32.numel() * 2,
            2 * g.numel() * 147, "bfloat16")
        log(f"stem backward {shape}: op forward + backward "
            f"{timed['fwd_bwd_ms']:.4f} ms (plain "
            f"{timed['plain_fwd_bwd_ms']:.4f}"
            f"), backward alone {timed['backward_ms']:.4f} ms, cuDNN weight "
            f"gradient on pre-padded input {timed['backward_library_ms']:.4f}"
            f" ms, bound {timed['backward_bound_ms']:.4f} ms "
            f"({timed['backward_bound_by']})")
    return dict(grad_max_rel_err=max_err, **timed)


def phase_grouping_backward(dev):
    from gvcnn_tf_tpu_torch.ops.grouping_kernel import (
        group_and_fuse,
        group_and_fuse_plain,
    )
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms

    rs = np.random.RandomState(7)
    cases = [(8, 12, 1024, m, mode, edges) for m in (1, 8, 16)
             for mode in ("mean", "ceil_sum") for edges in (False, True)]
    max_err, empty_seen = 0.0, False
    for b, v, c, m, mode, edges in cases:
        scores = _edge_scores(b, v, m) if edges else _clear_scores(rs, b, v, m)
        d = rs.randn(b, v, c).astype(np.float32)
        gf = torch.from_numpy(rs.randn(b, c).astype(np.float32)).to(dev)
        gw = torch.from_numpy(rs.randn(b, m).astype(np.float32)).to(dev)
        grads = []
        for fn in (group_and_fuse, group_and_fuse_plain):
            s = torch.from_numpy(scores).to(dev).requires_grad_()
            dd = torch.from_numpy(d).to(dev).requires_grad_()
            fused, weights, scheme = fn(s, dd, m, mode)
            ((fused * gf).sum() + (weights * gw).sum()).backward()
            grads.append((s.grad, dd.grad))
        empty_seen |= bool((scheme.sum(-1) == 0).any())
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            max_err = max(max_err, (got - want).abs().max().item())
    if not empty_seen:
        raise AssertionError("no case had an empty group")
    log(f"grouping backward: {len(cases)} cases match autograd through the "
        f"plain version, max|err| {max_err:.3g}")

    b, v, c, m = 8, 12, 1024, 8
    s = torch.from_numpy(_clear_scores(rs, b, v, m)).to(dev).requires_grad_()
    d = torch.from_numpy(rs.randn(b, v, c).astype(np.float32)).to(dev)
    d.requires_grad_()
    gf = torch.ones(b, c, device=dev)

    def fwd_bwd(fn):
        s.grad = d.grad = None
        fn(s, d, m)[0].backward(gf)

    fused = group_and_fuse(s, d, m)[0]
    timed = dict(
        fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(group_and_fuse)),
        plain_fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(group_and_fuse_plain)),
        backward_ms=cuda_ms(lambda: torch.autograd.grad(
            fused, (s, d), gf, retain_graph=True)))
    # The VJP reads scores, descs and d_fused once and writes d_scores and
    # d_descs once (fp32); its work is the masked max's B*M*V*C compares.
    timed["backward_bound_ms"], timed["backward_bound_by"] = bound(
        4 * (2 * b * v + 2 * b * v * c + b * c), b * m * v * c, "float32")
    log(f"grouping backward ({b}, {v}, {c}, M={m}): op forward + "
        f"backward {timed['fwd_bwd_ms']:.4f} ms (plain "
        f"{timed['plain_fwd_bwd_ms']:.4f}), backward alone (the plain "
        f"version's VJP replayed) {timed['backward_ms']:.4f} ms, bound "
        f"{timed['backward_bound_ms']:.5f} ms "
        f"({timed['backward_bound_by']})")
    return dict(grad_max_abs_err=max_err, **timed)


def _moved(a, b):
    return [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]


def phase_train(card, dev):
    import dataclasses
    import shutil
    from pathlib import Path

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
    from gvcnn_tf_tpu_torch.tools.measure import (
        cuda_ms,
        train_batch,
        train_step_drift,
    )
    from gvcnn_tf_tpu_torch.train import create_train_state, train, train_step

    logdir = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(logdir, ignore_errors=True)
    base = get_config("mn40_12view")
    cfg = base.replace(train=dataclasses.replace(
        base.train, train_logdir=str(logdir), log_every=10,
        checkpoint_every=10))
    d = cfg.data
    views = d.batch_size * d.num_views

    # The main path: train(), then a second train() that resumes.
    t0 = time.perf_counter()
    _zero_counts()
    state, mets = train(cfg, num_steps=TRAIN_STEPS, device="cuda")
    launches = _by_kernel()
    wall = time.perf_counter() - t0
    log(f"train(): {TRAIN_STEPS} steps in {wall:.1f} s "
        f"({TRAIN_STEPS * views / wall:.1f} views/s end to end, first step "
        f"and the synthetic stream's host time included); last {mets}")
    if not all(np.isfinite(v) for v in mets.values()):
        raise AssertionError(f"non-finite train metrics {mets}")
    if launches != {"stem": TRAIN_STEPS, "grouping": TRAIN_STEPS}:
        raise AssertionError(f"expected {TRAIN_STEPS} launches of each "
                             f"kernel in {TRAIN_STEPS} steps, got {launches}")
    init = init_weights(build_model(cfg), cfg.train.seed).state_dict()
    trained = state.model.state_dict()
    moved = _moved(init, trained)
    stats = [k for k in init if k.endswith(("running_mean", "running_var"))]
    if set(stats) - set(moved) or len(moved) < len(init) // 2:
        raise AssertionError(f"only {len(moved)} of {len(init)} tensors "
                             "moved")
    log(f"{len(moved)} of {len(init)} parameters and statistics moved, every "
        f"BN statistic among them")

    _zero_counts()
    resumed, _ = train(cfg, num_steps=TRAIN_STEPS + RESUME_STEPS,
                       device="cuda")
    got = (resumed.step, *_by_kernel().values())
    if got != (TRAIN_STEPS + RESUME_STEPS, RESUME_STEPS, RESUME_STEPS):
        raise AssertionError(f"resume: (step, stem, grouping launches) "
                             f"{got}")
    log(f"resumed at step {TRAIN_STEPS} and ran {RESUME_STEPS} steps "
        f"(launches {got[1:]})")
    shutil.rmtree(logdir, ignore_errors=True)

    # Card vs CPU, one step at B=2.
    small = cfg.replace(data=dataclasses.replace(d, batch_size=2))
    drift = train_step_drift(small, dev)
    check_train_drift(drift)

    # Overfit one fixed batch with Adam.
    ocfg = cfg.replace(train=dataclasses.replace(
        cfg.train, optimizer="adam", learning_rate=1e-3, weight_decay=0.0))
    ostate = create_train_state(ocfg, dev)
    batch = train_batch(ocfg, np.random.RandomState(8), dev)
    losses = [float(train_step(ostate, batch, ocfg)["loss"])
              for _ in range(OVERFIT_STEPS)]
    log(f"overfit (Adam 1e-3, B=8): loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        f" in {OVERFIT_STEPS} steps")
    if not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"overfit: {losses[0]} -> {losses[-1]}")

    # Step time on a batch already on the card (no input pipeline).
    tstate = create_train_state(cfg, dev)
    batch = train_batch(cfg, np.random.RandomState(9), dev)
    _zero_counts()
    step_ms = cuda_ms(lambda: train_step(tstate, batch, cfg), runs=20,
                      warmup=5)
    per_step = {k: n / 25 for k, n in _by_kernel().items()}
    log(f"train step B=8: {step_ms:.3f} ms median, {views / step_ms * 1e3:.1f}"
        f" views/s, launches per step {per_step} [{card}]")
    return dict(launches=launches, per_step=per_step, step_ms=step_ms,
                views_per_s=views / step_ms * 1e3, drift=drift)


def eval_logits():
    """The fp32 logits (on the host) of every batch `evaluate()` scores
    while the context is open, in a list, also inside `train()`: the
    logits its CUDA graph computed on the card (`eval.recorded_logits`)."""
    from gvcnn_tf_tpu_torch.eval import recorded_logits

    return recorded_logits()


@contextlib.contextmanager
def predict_logits():
    """The fp32 logits (on the host) of every GVCNN forward run in eval
    mode while the context is open, in a list: a global module hook, for
    `predict()`, whose forwards run eagerly."""
    from gvcnn_tf_tpu_torch.models.gvcnn import GVCNN

    seen = []

    def hook(module, args, out):
        if isinstance(module, GVCNN) and not module.training:
            seen.append(out[0].detach().float().cpu())

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def check_card_vs_cpu(card, cpu, what, hold_dlogit=True):
    """card and CPU logits (N, K): max|dlogit| within LOGIT_REL_TOL of the
    CPU's max|logit| (printed only, with `hold_dlogit` false), argmax equal
    wherever the CPU's top-2 margin exceeds that bound.  Returns the shapes
    under the margin."""
    scale = float(cpu.abs().max())
    bound = LOGIT_REL_TOL * scale
    dlogit = float((card - cpu).abs().max())
    top2 = cpu.topk(2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > bound
    agree = card.argmax(-1) == cpu.argmax(-1)
    log(f"{what}, card (bf16) vs CPU (fp32): max|dlogit| {dlogit:.4g} of "
        f"max|logit| {scale:.4g} (rel {dlogit / scale:.3g}, "
        f"{'bound' if hold_dlogit else 'not held; margin'} "
        f"{LOGIT_REL_TOL}); argmax equal on {int(agree.sum())} of "
        f"{len(agree)}, {int((~clear).sum())} under the margin")
    if not all(np.isfinite(card.numpy()).ravel()):
        raise AssertionError(f"{what}: non-finite logits on the card")
    if (hold_dlogit and dlogit > bound) or not bool(agree[clear].all()):
        raise AssertionError(f"{what}: card and CPU disagree")
    return int((~clear).sum())


def phase_eval(card, dev):
    import csv
    import dataclasses
    import importlib
    import itertools
    import shutil
    from pathlib import Path

    from gvcnn_tf_tpu_torch import evaluate, get_config, predict, train
    from gvcnn_tf_tpu_torch.checkpoint import Checkpointer, load_model
    from gvcnn_tf_tpu_torch.data import make_dataset
    from gvcnn_tf_tpu_torch.data.procedural import class_table
    from gvcnn_tf_tpu_torch.tools.make_demo_meshes import write_off
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms, kernel_durations_us
    from gvcnn_tf_tpu_torch.utils import normalize_views

    train_mod = importlib.import_module("gvcnn_tf_tpu_torch.train")
    predict_mod = importlib.import_module("gvcnn_tf_tpu_torch.predict")
    counts = _by_kernel

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_eval"
    shutil.rmtree(root, ignore_errors=True)
    logdir = root / "train"
    base = get_config("mn40_12view")
    cfg = base.replace(
        # Streamed, as before phase 15 existed, so that its train()
        # readings compare with the earlier ones; phase 15 times the
        # card-resident split.
        data=dataclasses.replace(base.data, dataset="procedural",
                                 transfer_dtype="uint8",
                                 synthetic_num_shapes=PROC_SHAPES,
                                 device_resident="off"),
        train=dataclasses.replace(base.train, train_logdir=str(logdir),
                                  log_every=EVAL_EVERY,
                                  checkpoint_every=EVAL_EVERY,
                                  eval_every=EVAL_EVERY))
    cfg32 = cfg.replace(compute_dtype="float32")
    d, seed = cfg.data, cfg.train.seed
    views_per_eval = PROC_SHAPES * d.num_views

    # 1. Both splits, rendered once and kept by the split cache.
    t0 = time.perf_counter()
    for split in (True, False):
        make_dataset(d, train=split, seed=seed)
    log(f"rendered the procedural train and val splits (2 x {PROC_SHAPES} "
        f"shapes, {d.num_views} views of {d.height}x{d.width}) in "
        f"{time.perf_counter() - t0:.1f} s")

    # 2. train() with an evaluation every EVAL_EVERY steps; the in-training
    # evaluations' results, logits and times are taken as they run.
    real_evaluate, in_training = train_mod.evaluate, []

    def recorded_evaluate(*args, **kw):
        with eval_logits() as seen:
            t = time.perf_counter()
            res = real_evaluate(*args, **kw)
            dt = time.perf_counter() - t
        in_training.append((res, torch.cat(seen)[:PROC_SHAPES], dt))
        return res

    train_mod.evaluate = recorded_evaluate
    _zero_counts()
    t0 = time.perf_counter()
    try:
        state, mets = train(cfg, num_steps=EVAL_TRAIN_STEPS, device="cuda")
    finally:
        train_mod.evaluate = real_evaluate
    wall = time.perf_counter() - t0
    train_eval_launches = counts()
    want = EVAL_TRAIN_STEPS + EVAL_TRAIN_STEPS // EVAL_EVERY * EVAL_FORWARDS
    with open(logdir / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    vals = [(r["step"], r["val_count"]) for r in recs if "val_count" in r]
    log(f"train() with eval_every {EVAL_EVERY}: {EVAL_TRAIN_STEPS} steps "
        f"and {len(in_training)} evaluations in {wall:.1f} s (the "
        f"evaluations {', '.join(f'{e[2]:.2f}' for e in in_training)} s); "
        f"val records {vals}, accuracy "
        f"{[e[0]['accuracy'] for e in in_training]}; launches "
        f"{train_eval_launches}; last {mets}")
    if train_eval_launches != {"stem": want, "grouping": want}:
        raise AssertionError(f"expected {want} launches of each kernel, got "
                             f"{train_eval_launches}")
    if vals != [(s, PROC_SHAPES) for s in range(
            EVAL_EVERY, EVAL_TRAIN_STEPS + 1, EVAL_EVERY)]:
        raise AssertionError(f"in-training evaluation records {vals}")
    if not state.model.training:
        raise AssertionError("the model stayed in eval mode after train()")

    # 3. Fresh models from the step-5 and step-10 checkpoints.
    ckpt = Checkpointer(str(logdir))
    for (want_res, want_logits, _), step in zip(
            in_training, range(EVAL_EVERY, EVAL_TRAIN_STEPS + 1, EVAL_EVERY)):
        one = root / f"step{step}"
        one.mkdir()
        shutil.copy(ckpt.path(step), one)
        _zero_counts()
        with eval_logits() as seen:
            res = evaluate(cfg, str(one), device="cuda")
        eval_launches = counts()
        logits = torch.cat(seen)[:PROC_SHAPES]
        same = bool(torch.equal(logits.argmax(-1), want_logits.argmax(-1)))
        log(f"evaluate() of the step-{step} checkpoint, fresh model: {res} "
            f"(in training: {want_res}); argmax equal on every shape: "
            f"{same}; max|dlogit| {float((logits - want_logits).abs().max())}"
            f"; launches {eval_launches}")
        if res != want_res or not same:
            raise AssertionError(f"step {step}: a fresh model scores "
                                 "otherwise than the training model did")
        if eval_launches != {"stem": EVAL_FORWARDS,
                             "grouping": EVAL_FORWARDS}:
            raise AssertionError(f"expected {EVAL_FORWARDS} launches of each "
                                 f"kernel, got {eval_launches}")
    # The end-to-end time, without the hook's copies: the main path.
    _zero_counts()
    t0 = time.perf_counter()
    res = evaluate(cfg, str(one), device="cuda")
    eval_wall = time.perf_counter() - t0
    eval_launches = counts()
    if res != want_res or eval_launches != {"stem": EVAL_FORWARDS,
                                            "grouping": EVAL_FORWARDS}:
        raise AssertionError(f"evaluate() {res}, launches {eval_launches}")
    eval_vps = views_per_eval / eval_wall

    # 4. Card against CPU, the step-10 checkpoint, first CPU_SHAPES shapes.
    def first():
        return itertools.islice(make_dataset(d, train=False, seed=seed),
                                CPU_SHAPES // d.batch_size)

    with eval_logits() as card_seen:
        card_res = evaluate(cfg, str(logdir), dataset_iter=first(),
                            device="cuda")
    with eval_logits() as cpu_seen:
        cpu_res = evaluate(cfg32, str(logdir), dataset_iter=first(),
                           device="cpu")
    near = sum(check_card_vs_cpu(a, b, f"eval batch {i}")
               for i, (a, b) in enumerate(zip(card_seen, cpu_seen)))
    log(f"first {CPU_SHAPES} val shapes: card {card_res}, CPU {cpu_res}")
    if (not card_res["count"] == cpu_res["count"] == CPU_SHAPES
            or abs(card_res["correct"] - cpu_res["correct"]) > near):
        raise AssertionError("card and CPU counts disagree")

    # 5. Predict: meshes, the CLI's CSV, and a uint8 array card vs CPU.
    table = dict(class_table(d.num_classes))
    meshes = []
    for i, name in enumerate(("chair", "bottle", "lamp")):
        meshes.append(str(root / f"{name}.off"))
        write_off(meshes[-1], *table[name](np.random.RandomState(i)))
    _zero_counts()
    recs = predict(cfg, str(logdir), mesh_files=meshes, device="cuda")
    got = [(r["shape"], r["class_index"], r["probability"]) for r in recs]
    log(f"predict() of 3 meshes: {got}; launches {counts()}")
    _check_results(recs, 3, d.num_views)
    if counts() != {"stem": 1, "grouping": 1}:
        raise AssertionError(f"predict of 3 shapes: launches {counts()}")
    out = root / "preds.csv"
    argv = ["--checkpoint_dir", str(logdir), "--output_csv", str(out)]
    for m in meshes:
        argv += ["--mesh_file", m]
    predict_mod.main(argv)
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    log(f"predict CLI: {rows}")
    if (rows[0] != ["shape", "class_index", "probability"]
            or [r[0] for r in rows[1:]] != ["chair", "bottle", "lamp"]):
        raise AssertionError(f"predict CSV {rows}")
    u8 = np.random.RandomState(10).randint(
        0, 256, (2, d.num_views, d.height, d.width, 3)).astype(np.uint8)
    with predict_logits() as card_seen:
        card_recs = predict(cfg, str(logdir), views=u8, device="cuda")
    with predict_logits() as cpu_seen:
        predict(cfg32, str(logdir), views=u8, device="cpu")
    _check_results(card_recs, 2, d.num_views)
    check_card_vs_cpu(card_seen[0], cpu_seen[0], "predict B=2 uint8")

    # 6. Times: the forwards alone on batches already on the card, then
    # train() on the procedural uint8 stream, resumed, without evaluations.
    model = load_model(cfg, str(logdir), "cuda")
    batches = []
    for batch in make_dataset(d, train=False, seed=seed, num_epochs=1):
        v = batch["views"]
        pad = np.zeros((d.batch_size - len(v),) + v.shape[1:], v.dtype)
        batches.append(torch.from_numpy(np.concatenate([v, pad])).to(dev))

    def forwards():
        for x in batches:
            model(normalize_views(x))

    with torch.no_grad():
        eval_ms = cuda_ms(forwards, runs=10, warmup=2)
        busy_ms = sum(sum(v) for v in kernel_durations_us(
            forwards, calls=3).values()) / 3 / 1e3
    # No evaluation, and no checkpoint inside the last logging window.
    rcfg = cfg.replace(train=dataclasses.replace(
        cfg.train, eval_every=0, checkpoint_every=EVAL_TRAIN_STEPS))
    _zero_counts()
    t0 = time.perf_counter()
    resumed, rmets = train(rcfg, num_steps=2 * EVAL_TRAIN_STEPS,
                           device="cuda")
    rwall = time.perf_counter() - t0
    resume_launches = counts()
    if (resumed.step != 2 * EVAL_TRAIN_STEPS or resume_launches != {
            "stem": EVAL_TRAIN_STEPS, "grouping": EVAL_TRAIN_STEPS}):
        raise AssertionError(f"resume without evaluations: step "
                             f"{resumed.step}, launches {resume_launches}")
    train_vps = EVAL_TRAIN_STEPS * d.batch_size * d.num_views / rwall
    with open(logdir / "metrics.jsonl") as f:
        last = [json.loads(line) for line in f][-1]
    steady_vps = last["shapes_per_sec"] * d.num_views
    in_vps = [views_per_eval / e[2] for e in in_training]
    log(f"eval of {PROC_SHAPES} shapes ({views_per_eval} views): "
        f"{eval_vps:.1f} views/s end to end ({eval_wall:.3f} s, checkpoint "
        f"load included; in training {', '.join(f'{v:.1f}' for v in in_vps)}"
        f"), {views_per_eval / eval_ms * 1e3:.1f} views/s on the device "
        f"({len(batches)} forwards of B={d.batch_size}, {eval_ms:.3f} ms "
        f"by CUDA events; device busy {busy_ms:.3f} ms, idle "
        f"{1 - busy_ms / eval_ms:.1%}); train() on the procedural uint8 "
        f"stream: "
        f"{EVAL_TRAIN_STEPS} resumed steps in {rwall:.2f} s, "
        f"{train_vps:.1f} views/s end to end (start-up included), "
        f"{steady_vps:.1f} views/s over its last {EVAL_EVERY} steps (the "
        f"loop's clock); last {rmets} [{card}]")
    # The split cache and the step-10 checkpoint stay for phase 13, which
    # removes them.
    return dict(logdir=str(logdir), eval_launches=eval_launches,
                train_eval_launches=train_eval_launches,
                eval_views_per_s=eval_vps,
                eval_device_views_per_s=views_per_eval / eval_ms * 1e3,
                eval_busy_ms=busy_ms,
                train_views_per_s=train_vps,
                train_steady_views_per_s=steady_vps)


def _no_tf32():
    """cuDNN with TF32 off, around an fp32 reference only."""
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=b.benchmark,
                   deterministic=b.deterministic, allow_tf32=False)


def phase_stem_f32(dev):
    import torch.nn.functional as F

    from gvcnn_tf_tpu_torch.ops.pool import same_pads
    from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv, stem_conv_plain
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms, kernel_us

    rs = np.random.RandomState(11)
    w = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(
        np.float32)).to(dev)
    scale = torch.from_numpy(rs.uniform(0.5, 2.0, 64).astype(np.float32))
    shift = torch.from_numpy(rs.uniform(-1.0, 1.0, 64).astype(np.float32))
    scale, shift = scale.to(dev), shift.to(dev)
    max_err, timed = 0.0, None
    for shape in STEM_F32_SHAPES:
        x = torch.from_numpy(rs.uniform(-1, 1, shape).astype(
            np.float32)).to(dev)
        errs = []
        with torch.inference_mode():
            for args in ((), (scale, shift)):
                got = stem_conv(x, w, *args, relu=bool(args))
                torch.cuda.synchronize()
                with _no_tf32():
                    want = stem_conv_plain(x, w, *args, relu=bool(args))
                err = (got - want).abs().max().item()
                if got.dtype != torch.float32 or not err <= (
                        STEM_F32_REL_TOL * want.abs().max().item()):
                    raise AssertionError(
                        f"fp32 stem {shape}: max|err| {err:.3g}, max|ref| "
                        f"{want.abs().max().item():.3g}")
                errs.append(err)
        max_err = max(max_err, *errs)
        log(f"fp32 stem {shape}: max|err| {errs[0]:.3g} (epilogue "
            f"{errs[1]:.3g}), bound {STEM_F32_REL_TOL} x max|ref|")
        if timed is not None:
            continue
        n, h, wd, _ = shape
        ph, pw = same_pads(h, 7, 2), same_pads(wd, 7, 2)
        with torch.inference_mode():
            xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
            y = stem_conv(x, w)
            with _no_tf32():
                timed = dict(
                    ms=cuda_ms(lambda: stem_conv(x, w)),
                    epilogue_ms=cuda_ms(
                        lambda: stem_conv(x, w, scale, shift, relu=True)),
                    plain_ms=cuda_ms(lambda: stem_conv_plain(x, w)),
                    library_ms=cuda_ms(lambda: F.conv2d(xn, w, stride=2)),
                    device_ms=kernel_us(lambda: stem_conv(x, w),
                                        "stem_conv_f32")[0] / 1e3)
            timed["library_tf32_ms"] = cuda_ms(
                lambda: F.conv2d(xn, w, stride=2))
        # The kernel's work: three TF32 products on the tensor cores; the
        # same conv once in fp32 on the CUDA cores beside it.
        nbytes = (x.numel() + w.numel() + y.numel()) * 4
        timed["bound_ms"], timed["bound_by"] = bound(
            nbytes, 3 * 2 * y.numel() * 147, "tf32")
        timed["bound_fp32_cores_ms"] = bound(
            nbytes, 2 * y.numel() * 147, "float32")[0]
        log(f"fp32 stem {shape}: kernel {timed['ms']:.4f} ms (with epilogue "
            f"{timed['epilogue_ms']:.4f}, device {timed['device_ms']:.4f}), "
            f"plain {timed['plain_ms']:.4f} ms, cuDNN fp32 conv on pre-padded "
            f"input {timed['library_ms']:.4f} ms (TF32 "
            f"{timed['library_tf32_ms']:.4f}), bound {timed['bound_ms']:.4f} "
            f"ms ({timed['bound_by']}, 3xTF32; "
            f"{timed['bound_fp32_cores_ms']:.4f} ms on the CUDA cores)")
    return dict(max_abs_err=max_err, **timed, **stem_f32_backward(dev, w))


def stem_f32_backward(dev, w32):
    """The fp32 stem's op and gradient (fp32 kernel forward, cuDNN's fp32
    weight gradient) against autograd through the plain version, TF32 off
    on both sides: dw at mn10_single_view's (8, 224, 224, 3), dw and dx at
    the other STEM_F32_SHAPES; then its times at the first, TF32 off."""
    import torch.nn.functional as F

    from gvcnn_tf_tpu_torch.ops.pool import same_pads
    from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv, stem_conv_plain
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms

    rs = np.random.RandomState(16)
    max_err, timed = 0.0, None
    for shape in STEM_F32_SHAPES:
        n, h, wd, _ = shape
        x = torch.from_numpy(rs.uniform(-1, 1, shape).astype(
            np.float32)).to(dev)
        g = torch.from_numpy(rs.randn(n, -(-h // 2), -(-wd // 2), 64).astype(
            np.float32)).to(dev)
        need_dx = shape != STEM_F32_SHAPES[0]
        grads = []
        with _no_tf32():
            for fn in (stem_conv, stem_conv_plain):
                xg = x.clone().requires_grad_(need_dx)
                w = w32.clone().requires_grad_()
                fn(xg, w).backward(g)
                grads.append((w.grad, xg.grad))
        torch.cuda.synchronize()
        errs = []
        for got, want in zip(*grads):
            if want is None:
                continue
            tol = STEM_F32_GRAD_REL_TOL * want.abs().max().item()
            err = (got - want).abs().max().item()
            if got.dtype != torch.float32 or not err <= tol:
                raise AssertionError(f"fp32 stem gradient {shape}: max|err| "
                                     f"{err:.4g} past {tol:.4g}")
            errs.append(err / want.abs().max().item())
        max_err = max(max_err, *errs)
        log(f"fp32 stem backward {shape}: dw{' and dx' if need_dx else ''} "
            f"match autograd through the plain version, TF32 off (max|err| "
            f"/ max {max(errs):.3g}, bound {STEM_F32_GRAD_REL_TOL})")
        if timed is not None:
            continue
        w = w32.clone().requires_grad_()

        def fwd_bwd():
            w.grad = None
            stem_conv(x, w).backward(g)

        y = stem_conv(x, w)
        ph, pw = same_pads(h, 7, 2), same_pads(wd, 7, 2)
        xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
        gn = g.permute(0, 3, 1, 2)
        wd_ = w.detach()

        def wgrad():
            return torch.ops.aten.convolution_backward(
                gn, xn, wd_, None, [2, 2], [0, 0], [1, 1], False, [0, 0], 1,
                [False, True, False])

        with _no_tf32():
            timed = dict(
                fwd_bwd_ms=cuda_ms(fwd_bwd),
                backward_ms=cuda_ms(lambda: torch.autograd.grad(
                    y, w, g, retain_graph=True)),
                plain_fwd_bwd_ms=cuda_ms(
                    lambda: stem_conv_plain(x, w).backward(g)),
                backward_library_ms=cuda_ms(wgrad))
        timed["backward_library_tf32_ms"] = cuda_ms(wgrad)
        # dw: reads x and the output gradient, writes dw; 147 multiply-adds
        # per element of the output gradient, in fp32.
        timed["backward_bound_ms"], timed["backward_bound_by"] = bound(
            (x.numel() + g.numel() + w32.numel()) * 4,
            2 * g.numel() * 147, "float32")
        log(f"fp32 stem backward {shape}, TF32 off: op forward + "
            f"backward {timed['fwd_bwd_ms']:.4f} ms (plain "
            f"{timed['plain_fwd_bwd_ms']:.4f}), backward alone "
            f"{timed['backward_ms']:.4f} ms, cuDNN fp32 weight gradient on "
            f"pre-padded input {timed['backward_library_ms']:.4f} ms (TF32 "
            f"{timed['backward_library_tf32_ms']:.4f}), bound "
            f"{timed['backward_bound_ms']:.4f} ms "
            f"({timed['backward_bound_by']})")
    return dict(grad_max_rel_err=max_err, **timed)


def _counts():
    """(bf16 stem, fp32 stem, grouping) launches (`ops.launches`)."""
    from gvcnn_tf_tpu_torch.ops import launches

    return (launches["stem_conv7x7s2_bf16"], launches["stem_conv7x7s2_f32"],
            launches["group_and_fuse_f32"])


def _avg_counts():
    """(forward, backward) launches of the average-pool kernels."""
    from gvcnn_tf_tpu_torch.ops import launched

    return launched("avg_pool_same_fwd"), launched("avg_pool_same_bwd")


def _by_kernel():
    """{"stem": both stems' launches, "grouping": the grouping kernel's}."""
    from gvcnn_tf_tpu_torch.ops import launched

    return {"stem": launched("stem_conv7x7s2"),
            "grouping": launched("group_and_fuse")}


def _pool_counts():
    """(forward, backward) launches of the max-pool kernels."""
    from gvcnn_tf_tpu_torch.ops import launched

    return launched("max_pool_same_fwd"), launched("max_pool_same_bwd")


def _bn_counts():
    """(stats, apply, backward reduce, backward elementwise) launches of
    the train-mode BatchNorm kernels."""
    from gvcnn_tf_tpu_torch.ops import launched

    return tuple(launched(f"batch_norm_{k}_")
                 for k in ("stats", "apply", "bwd_reduce", "bwd_elemt"))


def _zero_counts():
    """Every kernel's launch count back to 0."""
    from gvcnn_tf_tpu_torch.ops import launches

    launches.clear()


def _card_vs_cpu_serving(engine, cfg, views, tol, what, variables=None):
    """The engine's logits (and scores) for `views` against the same
    weights (seeded, or the JAX-layout `variables` the engine was given),
    folded, in fp32 on the CPU -> (max|dlogit| / max|logit|, the kernels'
    launch counts right after the engine's forward)."""
    from gvcnn_tf_tpu_torch.bridge import jax_to_state_dict
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
    from gvcnn_tf_tpu_torch.utils import fold_batch_norm

    logits, scores = engine.logits_and_scores(views)
    launches = _counts()
    ref = build_model(cfg.replace(compute_dtype="float32"))
    if variables is None:
        init_weights(ref, cfg.train.seed)
    else:
        ref.load_state_dict(jax_to_state_dict(variables))
    ref = fold_batch_norm(ref).eval()
    with torch.inference_mode():
        ref_logits, ep = ref(torch.from_numpy(views))
    ref_logits = ref_logits.numpy()
    scale = float(np.abs(ref_logits).max())
    dlogit = float(np.abs(logits - ref_logits).max())
    top2 = np.sort(ref_logits, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > tol[0] * scale
    agree = logits.argmax(-1) == ref_logits.argmax(-1)
    msg = (f"{what} B={len(views)}, card vs CPU (fp32): max|dlogit| "
           f"{dlogit:.4g} of max|logit| {scale:.4g} (rel {dlogit / scale:.3g}"
           f", bound {tol[0]}); argmax equal on {int(agree.sum())} of "
           f"{len(agree)}, {int((~clear).sum())} under the margin")
    if not np.all(np.isfinite(logits)):
        raise AssertionError(f"{what}: non-finite logits on the card")
    if dlogit > tol[0] * scale or not agree[clear].all():
        raise AssertionError(f"{msg}: card and CPU disagree")
    if (scores is None) != (tol[1] is None):
        raise AssertionError(f"{what}: scores {scores is not None}")
    if scores is not None:
        dscore = float(np.abs(scores - ep["view_discrimination_scores"]
                              .numpy()).max())
        msg += f"; max|dscore| {dscore:.3g} (bound {tol[1]})"
        if not dscore <= tol[1]:
            raise AssertionError(f"{msg}: scores disagree")
    log(msg)
    return dlogit / scale, launches


def _calibrated_variables(cfg, views):
    """JAX-layout variables of cfg's seeded fp32 model with its BatchNorm
    statistics calibrated to `views` (`measure.calibrate_bn`)."""
    from gvcnn_tf_tpu_torch.bridge import state_dict_to_jax
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
    from gvcnn_tf_tpu_torch.tools.measure import calibrate_bn

    model = init_weights(build_model(cfg.replace(compute_dtype="float32")),
                         cfg.train.seed)
    calibrate_bn(model, torch.from_numpy(views))
    return state_dict_to_jax(model.state_dict())


def phase_families(card, dev):
    import dataclasses

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.serve import InferenceEngine
    from gvcnn_tf_tpu_torch.tools.measure import (
        cuda_ms,
        train_batch,
        train_step_drift,
    )
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    rows = {}
    for name in FAMILY_LAUNCHES:
        cfg = get_config(name)
        d = cfg.data
        rs = np.random.RandomState(13)
        shape = (d.num_views, d.height, d.width, 3)
        t0 = time.perf_counter()
        engine = InferenceEngine(cfg, serve_batch_size=8, device="cuda")
        try:
            up = time.perf_counter() - t0
            row = dict(engine_up_s=up)
            _zero_counts()
            for n in (1, 8):
                views = rs.randint(0, 256, (n,) + shape).astype(np.uint8)
                recs = engine.predict(views)
                if len(recs) != n or any(
                        ("view_scores" in r) != (FAMILY_LAUNCHES[name][2] > 0)
                        for r in recs):
                    raise AssertionError(f"{name}: records {recs[:1]}")
                lat = []
                for _ in range(FAMILY_REQUESTS):
                    t = time.perf_counter()
                    engine.predict(views)
                    lat.append(time.perf_counter() - t)
                row[f"p50_ms_b{n}"] = statistics.median(lat) * 1e3
            forwards = 2 * (FAMILY_REQUESTS + 1)
            want = tuple(k * forwards for k in FAMILY_LAUNCHES[name])
            if _counts() != want:
                raise AssertionError(f"{name}: launches (bf16 stem, fp32 "
                                     f"stem, grouping) {_counts()} over "
                                     f"{forwards} forwards, want {want}")
            row["serve_launches"] = _counts()
            row["serve_avg_launches"] = _avg_counts()
            row["serve_bn_launches"] = _bn_counts()
            if any(row["serve_bn_launches"]):
                raise AssertionError(
                    f"{name}: train-mode BatchNorm launches "
                    f"{row['serve_bn_launches']} over {forwards} served "
                    "forwards, want none")
            if row["serve_avg_launches"] != (
                    FAMILY_AVG_POOLS[name] * forwards, 0):
                raise AssertionError(
                    f"{name}: average-pool launches (forward, backward) "
                    f"{row['serve_avg_launches']} over {forwards} forwards, "
                    f"want {FAMILY_AVG_POOLS[name]} a forward")
            row["serve_join_launches"] = _join_counts()
            if row["serve_join_launches"] != (
                    FAMILY_JOINS[name] * forwards, 0, 0):
                raise AssertionError(
                    f"{name}: residual-join launches (forward, backward, "
                    f"bias gradient) {row['serve_join_launches']} over "
                    f"{forwards} forwards, want {FAMILY_JOINS[name]} a "
                    "forward")
            views2 = rs.uniform(-1, 1, (2,) + shape).astype(np.float32)
            row["logit_rel"] = _card_vs_cpu_serving(
                engine, cfg, views2, FAMILY_SERVE_TOL[name], name)[0]
        finally:
            engine.close()
        log(f"{name}: engine up in {up:.1f} s; p50 B=1 "
            f"{row['p50_ms_b1']:.2f} ms, B=8 {row['p50_ms_b8']:.2f} ms "
            f"({8 * d.num_views / row['p50_ms_b8'] * 1e3:.1f} views/s); "
            f"launches (bf16 stem, fp32 stem, grouping) over {forwards} "
            f"forwards {row['serve_launches']}, average pool (forward, "
            f"backward) {row['serve_avg_launches']}, BatchNorm "
            f"{row['serve_bn_launches']}, residual join "
            f"{row['serve_join_launches']} [{card}]")

        # One B = 8 train step on the card.
        state = create_train_state(cfg, dev)
        batch = train_batch(cfg, rs, dev, getattr(torch, cfg.compute_dtype))
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        row["step_ms"] = cuda_ms(lambda: train_step(state, batch, cfg),
                                 runs=5, warmup=2)
        row["step_launches"] = tuple(k / 7 for k in _counts())
        row["step_avg_launches"] = tuple(k / 7 for k in _avg_counts())
        row["step_bn_launches"] = tuple(k / 7 for k in _bn_counts())
        row["step_join_launches"] = tuple(k / 7 for k in _join_counts())
        row["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        if row["step_launches"] != FAMILY_LAUNCHES[name]:
            raise AssertionError(f"{name}: launches a step "
                                 f"{row['step_launches']}")
        if row["step_avg_launches"] != (FAMILY_AVG_POOLS[name],) * 2:
            raise AssertionError(f"{name}: average-pool launches a step "
                                 f"{row['step_avg_launches']}")
        if row["step_bn_launches"] != (BN_LAYERS[name],) * 4:
            raise AssertionError(f"{name}: BatchNorm launches a step (stats, "
                                 f"apply, bwd_reduce, bwd_elemt) "
                                 f"{row['step_bn_launches']}, want "
                                 f"{BN_LAYERS[name]} each")
        if row["step_join_launches"] != (FAMILY_JOINS[name],) * 3:
            raise AssertionError(f"{name}: residual-join launches a step "
                                 f"(forward, backward, bias gradient) "
                                 f"{row['step_join_launches']}, want "
                                 f"{FAMILY_JOINS[name]} each")
        del state, batch
        vps = d.batch_size * d.num_views / row["step_ms"] * 1e3
        log(f"{name}: train step B={d.batch_size} {row['step_ms']:.3f} ms "
            f"median of 5 ({vps:.1f} views/s), peak memory {row['peak_gb']:.3f} GB, launches a "
            f"step {row['step_launches']}, average pool "
            f"{row['step_avg_launches']}, BatchNorm "
            f"{row['step_bn_launches']}, residual join "
            f"{row['step_join_launches']} [{card}]")

        # One B = 2 train step, card vs CPU.
        drift = train_step_drift(
            cfg.replace(data=dataclasses.replace(d, batch_size=2)), dev)
        tol = FAMILY_TRAIN_TOL[name]
        row["drift"] = {k: drift[k] for k in (
            "loss_rel", "grad_norm_rel", "logits_grad_cosine",
            "grad_cosine")}
        log(f"{name}: B=2 train step, card vs CPU (fp32): loss "
            f"{drift['loss']:.6g} vs {drift['loss_ref']:.6g} (rel "
            f"{drift['loss_rel']:.3g}, bound {tol[0]}); grad_norm rel "
            f"{drift['grad_norm_rel']:.3g} (bound {tol[1]}); Logits "
            f"gradient cosine {drift['logits_grad_cosine']:.5f} (bound "
            f"{tol[2]}); all gradients' cosine {drift['grad_cosine']:.4f}")
        if not (np.isfinite(drift["loss"]) and drift["loss_rel"] <= tol[0]
                and drift["grad_norm_rel"] <= tol[1]
                and drift["logits_grad_cosine"] >= tol[2]):
            raise AssertionError(f"{name}: card and CPU train steps "
                                 "disagree")
        rows[name] = row

    # Inception-v2 and v3 through --backbone: one B = 1 forward each, from
    # seeded weights whose BatchNorm statistics are calibrated to the views
    # (with init statistics the logits reach 1e5 on v2 and 1e-3 on v3).
    for backbone in FAMILY_BACKBONE_TOL:
        cfg = get_config("mn40_12view").replace(backbone=backbone)
        views = np.random.RandomState(14).uniform(
            -1, 1, (1, cfg.data.num_views, 224, 224, 3)).astype(np.float32)
        variables = _calibrated_variables(cfg, views)
        engine = InferenceEngine(cfg, variables=variables,
                                 serve_batch_size=1, device="cuda")
        try:
            _zero_counts()
            rel, launches = _card_vs_cpu_serving(
                engine, cfg, views, FAMILY_BACKBONE_TOL[backbone],
                f"mn40_12view --backbone {backbone} (calibrated BN)",
                variables)
            avg, bn, join = _avg_counts(), _bn_counts(), _join_counts()
            rows[backbone] = dict(logit_rel=rel, launches=launches,
                                  avg_launches=avg, bn_launches=bn,
                                  join_launches=join)
            if launches != (0, 0, 1) or avg != (FAMILY_AVG_POOLS[backbone],
                                                0) or any(bn) or join != (
                                                    FAMILY_JOINS[backbone],
                                                    0, 0):
                raise AssertionError(f"{backbone}: launches {launches}, "
                                     f"average pool {avg}, BatchNorm {bn}, "
                                     f"residual join {join}")
        finally:
            engine.close()
    return rows


def phase_packages():
    """Whether tensorstore (the Orbax reader) and TensorFlow (the slim
    importer's reader) import on this machine, each probed in a child
    process so that neither is loaded here."""
    import subprocess

    procs = {name: subprocess.Popen([sys.executable, "-c", f"import {name}"],
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.DEVNULL)
             for name in ("tensorstore", "tensorflow")}
    have = {}
    try:
        for name, proc in procs.items():
            have[name] = proc.wait(timeout=300) == 0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log("packages: " + ", ".join(
        f"{k} {'imports' if v else 'does not import'}"
        for k, v in have.items()))
    return have


def _slim_variables(rs):
    """A slim-named Inception-v1 checkpoint's variables (the importer's
    list, a 1001-class head), from a seed: conv weights N(0, 1/fan_in),
    BatchNorm beta and moving mean N(0, 0.1), moving variance U(0.5, 2)."""
    from gvcnn_tf_tpu_torch.tools.import_slim_checkpoint import (
        slim_variable_shapes,
    )

    out = {}
    for name, shape in slim_variable_shapes(1001):
        if name.endswith("weights"):
            a = rs.normal(0, (1.0 / np.prod(shape[:-1])) ** 0.5, shape)
        elif name.endswith("moving_variance"):
            a = rs.uniform(0.5, 2.0, shape)
        else:
            a = rs.normal(0, 0.1, shape)
        out[name] = a.astype(np.float32)
    return out


def phase_warm_start(card, dev):
    """(a) `train()` of mn40_12view at full width warm-started from a
    slim-named Inception-v1 checkpoint written by the port's importer,
    default exclude scopes, WARM_STEPS steps: before step 1 every
    Inception-v1 parameter and BN statistic on the card is the slim array
    bit for bit, `Logits` and `GroupingModule` the port's seeded init; the
    loss finite, one launch of each kernel a step.  (b) A Flax-layout tree
    (the form `read_orbax` returns) of seeded weights, as a checkpoint,
    through `model_state` -> `load_model` into the engine on the card:
    B = 8 against the same weights in fp32 on the CPU."""
    import dataclasses
    import importlib
    import shutil
    from pathlib import Path

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.bridge import state_dict_to_jax
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
    from gvcnn_tf_tpu_torch.serve import InferenceEngine
    from gvcnn_tf_tpu_torch.tools.import_slim_checkpoint import (
        convert_slim_vars,
        save_variables,
        slim_name_to_flax_path,
    )

    train_mod = importlib.import_module("gvcnn_tf_tpu_torch.train")
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_warm"
    shutil.rmtree(root, ignore_errors=True)
    rs = np.random.RandomState(15)
    slim = _slim_variables(rs)
    t0 = time.perf_counter()
    n = save_variables(convert_slim_vars(slim), str(root / "imagenet_v1"))
    import_s = time.perf_counter() - t0
    base = get_config("mn40_12view")
    cfg = base.replace(train=dataclasses.replace(
        base.train, train_logdir=str(root / "train"),
        checkpoint_path=str(root / "imagenet_v1"), log_every=WARM_STEPS,
        checkpoint_every=WARM_STEPS))

    real_warm, real_step_fn, seen, step_ms = (
        train_mod.warm_start_model, train_mod._step_function, {}, [])

    def warm(*args, **kw):
        t = time.perf_counter()
        out = real_warm(*args, **kw)
        torch.cuda.synchronize()
        seen["warm_s"] = time.perf_counter() - t
        return out

    def step_function(state, config, batch):
        # The loop's step (the compiled one on the card), timed.
        real_step = real_step_fn(state, config, batch)

        def step(state, batch, config):
            if "before" not in seen:
                seen["before"] = {k: v.detach().cpu().clone()
                                  for k, v in state.model.state_dict().items()}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real_step(state, batch, config)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            return out

        return step

    train_mod.warm_start_model, train_mod._step_function = (warm,
                                                            step_function)
    _zero_counts()
    try:
        state, mets = train_mod.train(cfg, num_steps=WARM_STEPS,
                                      device="cuda")
    finally:
        train_mod.warm_start_model, train_mod._step_function = (
            real_warm, real_step_fn)
    launches = _counts()
    before = state_dict_to_jax(seen["before"])
    copied = 0
    for name, a in slim.items():
        coll, path = slim_name_to_flax_path(name)
        if path[0] != "InceptionV1":
            continue
        node = before[coll]
        for k in path:
            node = node[k]
        if not np.array_equal(node, a):
            raise AssertionError(f"warm start: {name} differs on the card")
        copied += 1
    want = sum(k.startswith("InceptionV1.") for k in seen["before"])
    fresh = init_weights(build_model(cfg), cfg.train.seed).state_dict()
    head = [k for k in fresh if k.startswith(("Logits.", "GroupingModule."))]
    same_head = all(torch.equal(seen["before"][k], fresh[k]) for k in head)
    log(f"warm start (a): {n} arrays imported in {import_s:.2f} s; "
        f"warm_start_model {seen['warm_s']:.2f} s (host, read and copy to the "
        f"card); {copied} of {want} Inception-v1 tensors equal the slim "
        f"arrays bit for bit before step 1, Logits and GroupingModule "
        f"({len(head)} tensors) the seeded init: {same_head}; {WARM_STEPS} "
        f"steps, CUDA events {', '.join(f'{t:.3f}' for t in step_ms)} ms; "
        f"launches (bf16 stem, fp32 stem, grouping) {launches}; last {mets} "
        f"[{card}]")
    if copied != want or not same_head:
        raise AssertionError("warm start: the card's weights are not the "
                             "checkpoint's and the seeded init")
    if not all(np.isfinite(v) for v in mets.values()):
        raise AssertionError(f"warm start: non-finite metrics {mets}")
    if launches != (WARM_STEPS, 0, WARM_STEPS):
        raise AssertionError(f"warm start: launches {launches} in "
                             f"{WARM_STEPS} steps")

    # (b) Seeded weights under another seed than the engine's config, so
    # only a loaded checkpoint agrees with the CPU reference.
    other = cfg.replace(train=dataclasses.replace(
        cfg.train, seed=cfg.train.seed + 17))
    tree = state_dict_to_jax(init_weights(build_model(other),
                                          other.train.seed).state_dict())
    save_variables(tree, str(root / "jax_layout"))
    engine = InferenceEngine(cfg, str(root / "jax_layout"),
                             serve_batch_size=8, device="cuda")
    try:
        d = cfg.data
        views = rs.uniform(-1, 1, (8, d.num_views, d.height, d.width,
                                   3)).astype(np.float32)
        _zero_counts()
        rel, serve_launches = _card_vs_cpu_serving(
            engine, other, views, (LOGIT_REL_TOL, SCORE_ABS_TOL),
            "served from a Flax-layout tree")
    finally:
        engine.close()
    if serve_launches != (1, 0, 1):
        raise AssertionError(f"served from a Flax-layout tree: launches "
                             f"{serve_launches}")
    shutil.rmtree(root, ignore_errors=True)
    return dict(launches=launches, warm_s=seen["warm_s"], import_s=import_s,
                step_ms=step_ms, serve_logit_rel=rel,
                serve_launches=serve_launches)


def _state_checksum(state):
    """sha256 of every parameter and statistic of `state`'s model, bit for
    bit, as an int64."""
    import hashlib

    h = hashlib.sha256()
    for k, v in state.model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().cpu().numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


def _dp_rank(init_method, out_dir):
    """One of the 2 ranks of phase 12 (b): gloo, both ranks on cuda:0."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    from gvcnn_tf_tpu_torch import evaluate, get_config
    from gvcnn_tf_tpu_torch.parallel import (
        initialize_distributed,
        rank_rows,
        shutdown,
    )
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    world = initialize_distributed(
        "gloo", datetime.timedelta(seconds=DP_GROUP_TIMEOUT),
        device="cuda:0", init_method=init_method)
    dev, main = world.device, world.is_main
    dp8 = get_config("mn40_12view_dp8")
    cfg = dp8.replace(num_devices=world.size, data=dataclasses.replace(
        dp8.data, batch_size=world.size * DP_RANK_BATCH))
    d = cfg.data
    out = {"launches": [0, 0, 0], "steps": 0, "rank": world.rank}

    def host_batch(rs, n):
        return {"views": rs.uniform(-1, 1, (n, d.num_views, d.height,
                                            d.width, 3)).astype(np.float32),
                "label": rs.randint(0, d.num_classes, n)}

    def on_card(batch):     # views in bf16, as the loader's wire sends them
        return {"views": torch.from_numpy(batch["views"]).to(
                    dev, torch.bfloat16),
                "label": torch.from_numpy(batch["label"]).to(dev)}

    def dp_step(state, batch, c):
        """The path: one data-parallel step, its launches counted."""
        _zero_counts()
        mets = train_step(state, batch, c)
        torch.cuda.synchronize()
        out["launches"] = [a + b for a, b in zip(out["launches"],
                                                 _counts())]
        out["steps"] += 1
        return {k: float(v) for k, v in mets.items()}

    # 1. Global mode (dropout on) against one process on the whole batch.
    g = host_batch(np.random.RandomState(30), d.batch_size)
    state = create_train_state(cfg, world=world)
    out["global"] = dp_step(state, on_card(rank_rows(g, world)), cfg)
    grad = state.model.Logits.weight.grad.float()
    if main:
        ref = create_train_state(cfg, dev)
        want = train_step(ref, on_card(g), cfg)
        ref_grad = ref.model.Logits.weight.grad.float()
        out["global_ref"] = {k: float(v) for k, v in want.items()}
        out["global_cos"] = float((grad * ref_grad).sum()
                                  / (grad.norm() * ref_grad.norm()))
        del ref
    del state

    # 2. Local mode on a tiled batch (every rank the same rows, dropout
    # off, cuDNN deterministic) against one process on one tile.
    torch.backends.cudnn.deterministic = True
    lcfg = cfg.replace(bn_sync="local", dropout_keep_prob=1.0)
    tile = on_card(host_batch(np.random.RandomState(31), DP_RANK_BATCH))
    state = create_train_state(lcfg, world=world)
    out["local"] = dp_step(state, tile, lcfg)
    if main:
        ref = create_train_state(lcfg, dev)
        out["local_ref"] = {k: float(v) for k, v in
                            train_step(ref, tile, lcfg).items()}
        a, b = state.model.state_dict(), ref.model.state_dict()
        out["local_max_abs_diff"] = max(float((a[k].float() - b[k].float())
                                              .abs().max()) for k in a)
        del ref
    del state
    torch.backends.cudnn.deterministic = False

    # 3. Replicas: DP_STEPS global-mode steps, each timed by CUDA events;
    # then the gradient all-reduce alone (host clock, synchronized).
    state = create_train_state(cfg, world=world)
    times = []
    for i in range(DP_STEPS):
        batch = on_card(rank_rows(host_batch(
            np.random.RandomState(40 + i), d.batch_size), world))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out["replica_mets"] = dp_step(state, batch, cfg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    out["step_ms"] = times
    check = torch.tensor([_state_checksum(state)] * 2, dtype=torch.int64)
    check[1].neg_()
    dist.all_reduce(check, op=dist.ReduceOp.MAX, group=world.host_group)
    out["replicas_equal"] = bool(check[0] == -check[1])
    flat = torch.zeros(sum(p.numel() for p in state.optimizer.params),
                       device=dev)
    ar = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat, group=world.group)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = statistics.median(ar[1:])
    out["allreduce_mb"] = flat.numel() * 4 / 1e6

    # 4. Evaluation of the procedural split over the 2 ranks, and (rank 0)
    # over one process at the rank's batch.
    ecfg = cfg.replace(data=dataclasses.replace(
        d, dataset="procedural", transfer_dtype="uint8",
        synthetic_num_shapes=DP_EVAL_SHAPES))
    out["eval"] = evaluate(ecfg, state=state, per_class=True, world=world)
    if main:
        out["eval_alone"] = evaluate(ecfg.replace(
            num_devices=None, data=dataclasses.replace(
                ecfg.data, batch_size=DP_RANK_BATCH)),
            state=state, per_class=True)
    dist.all_reduce(torch.zeros(1), group=world.host_group)
    torch.save(out, f"{out_dir}/rank{world.rank}.pt")
    shutdown(world)


def phase_parallel(card, dev):
    """Phase 12: (a) a world of one rank over NCCL against the plain step,
    (b) a world of 2 ranks over gloo sharing the one card."""
    import dataclasses
    import datetime
    import shutil
    from pathlib import Path

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.parallel import (
        initialize_distributed,
        shutdown,
        spawn,
    )
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms, train_batch
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_dp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    dp8 = get_config("mn40_12view_dp8")
    cfg = dp8.replace(num_devices=1, data=dataclasses.replace(
        dp8.data, batch_size=DP_RANK_BATCH))
    views = DP_RANK_BATCH * cfg.data.num_views

    # (a) The same seed and batches through the plain step and through the
    # data-parallel step in a world of one over NCCL; cuDNN deterministic.
    batches = [train_batch(cfg, np.random.RandomState(20 + i), dev)
               for i in range(DP_STEPS)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = create_train_state(cfg, dev)
        want = [train_step(plain, b, cfg) for b in batches]
        world = initialize_distributed(
            timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT),
            device=dev, init_method=f"file://{root}/rendezvous_1", rank=0,
            world_size=1)
        try:
            if (world.backend, world.size) != ("nccl", 1):
                raise AssertionError(f"world {world}")
            dp = create_train_state(cfg, world=world)
            _zero_counts()
            got = [train_step(dp, b, cfg) for b in batches]
            torch.cuda.synchronize()
            launches = _counts()
            same = all(torch.equal(g[k], w[k]) for g, w in zip(got, want)
                       for k in w)
            a, b = plain.model.state_dict(), dp.model.state_dict()
            same_state = all(torch.equal(a[k], b[k]) for k in a)
            step_ms = cuda_ms(lambda: train_step(dp, batches[0], cfg),
                              runs=5, warmup=1)
            plain_ms = cuda_ms(lambda: train_step(plain, batches[0], cfg),
                               runs=5, warmup=1)
        finally:
            shutdown(world)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"phase 12 (a) world of 1 over NCCL, mn40_12view_dp8's model at "
        f"B={DP_RANK_BATCH} a rank: {DP_STEPS} steps equal the plain step's "
        f"bit for bit: metrics {same}, every parameter and statistic "
        f"{same_state}; launches (bf16 stem, fp32 stem, grouping) "
        f"{launches}; step {step_ms:.3f} ms (plain {plain_ms:.3f} ms, CUDA "
        f"events, median of 5) [{card}]")
    if not (same and same_state):
        raise AssertionError("world of one: the data-parallel step is not "
                             "the plain step")
    if launches != (DP_STEPS, 0, DP_STEPS):
        raise AssertionError(f"world of one: launches {launches}")
    del plain, dp, batches

    # (b) 2 ranks over gloo on the one card (NCCL refuses two ranks on one
    # GPU), each with its device named.
    t0 = time.perf_counter()
    spawn(_dp_rank, 2, args=(str(root),), timeout=DP_TIMEOUT,
          rendezvous_dir=str(root))
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    world2_s = time.perf_counter() - t0
    r0 = ranks[0]
    got, ref = r0["global"], r0["global_ref"]
    loss_rel = abs(got["loss"] - ref["loss"]) / ref["loss"]
    gnorm_rel = abs(got["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    log(f"phase 12 (b) world of 2 over gloo on one card, B={DP_RANK_BATCH} a "
        f"rank, full width (ran {world2_s:.1f} s with start-up): global mode "
        f"vs one process at B={2 * DP_RANK_BATCH}: loss {got['loss']:.6g} vs "
        f"{ref['loss']:.6g} (rel {loss_rel:.3g}, bound {DP_GLOBAL_TOL[0]}), "
        f"grad_norm {got['grad_norm']:.6g} vs {ref['grad_norm']:.6g} (rel "
        f"{gnorm_rel:.3g}, bound {DP_GLOBAL_TOL[1]}), Logits gradient "
        f"cosine {r0['global_cos']:.6f} (bound {DP_GLOBAL_TOL[2]})")
    if not (np.isfinite(got["loss"]) and loss_rel <= DP_GLOBAL_TOL[0]
            and gnorm_rel <= DP_GLOBAL_TOL[1]
            and r0["global_cos"] >= DP_GLOBAL_TOL[2]):
        raise AssertionError("global mode disagrees with one process")
    log(f"  local mode, tiled batch vs one process on one tile (cuDNN "
        f"deterministic): max|dparam| {r0['local_max_abs_diff']:.3g}, loss "
        f"{r0['local']['loss']:.6g} vs {r0['local_ref']['loss']:.6g}")
    if r0["local_max_abs_diff"] != 0 or r0["local"] != r0["local_ref"]:
        raise AssertionError("local mode on a tiled batch is not one process "
                             "on one tile")
    if not all(r["replicas_equal"] for r in ranks) \
            or ranks[0]["replica_mets"] != ranks[1]["replica_mets"]:
        raise AssertionError("the replicas differ after "
                             f"{DP_STEPS} steps")
    ev, alone = r0["eval"], r0["eval_alone"]
    log(f"  replicas bitwise equal after {DP_STEPS} steps (all-reduced "
        f"checksum); evaluation of {DP_EVAL_SHAPES} procedural shapes over 2 "
        f"ranks {ev['correct']}/{ev['count']}, over 1 "
        f"{alone['correct']}/{alone['count']}")
    if not (ev == alone == ranks[1]["eval"]
            and ev["count"] == DP_EVAL_SHAPES):
        raise AssertionError(f"evaluation over 2 ranks {ev}, over 1 {alone}")
    per_step = []
    for r in ranks:
        per = [n / r["steps"] for n in r["launches"]]
        per_step.append(per)
        log(f"  rank {r['rank']}: launches a step (bf16 stem, fp32 stem, "
            f"grouping) {per} over {r['steps']} steps; step "
            f"{', '.join(f'{t:.1f}' for t in r['step_ms'])} ms (CUDA "
            f"events); gradient all-reduce of {r['allreduce_mb']:.1f} MB "
            f"{r['allreduce_ms']:.2f} ms (host clock, synchronized) -- a "
            f"world of 2 on one card over gloo: no figure here measures "
            f"scaling [{card}]")
        if per != [1.0, 0.0, 1.0]:
            raise AssertionError(f"rank {r['rank']}: launches a step {per}")
    shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"phase 12 in {seconds:.1f} s")
    return dict(
        world1=dict(launches=launches, step_ms=step_ms, plain_ms=plain_ms),
        world2=dict(loss_rel=loss_rel, grad_norm_rel=gnorm_rel,
                    logits_grad_cosine=r0["global_cos"],
                    local_max_abs_diff=r0["local_max_abs_diff"],
                    step_ms=[r["step_ms"] for r in ranks],
                    allreduce_ms=[r["allreduce_ms"] for r in ranks],
                    allreduce_mb=r0["allreduce_mb"], eval=ev,
                    launches_per_step=per_step, seconds=world2_s),
        seconds=seconds)


_EXPORT_CHILD = """
import sys
import numpy as np
import torch
from gvcnn_tf_tpu_torch.tools.export_model import deserialize_and_call
with open(sys.argv[1], "rb") as f:
    blob = f.read()
x = torch.from_numpy(np.load(sys.argv[2])).to("cuda")
logits, probs = deserialize_and_call(blob, x)
np.save(sys.argv[3], logits.float().cpu().numpy())
assert "jax" not in sys.modules and "gvcnn_tf_tpu" not in sys.modules
print("child: artifact of", len(blob), "bytes run on", torch.cuda.get_device_name(0))
"""


@contextlib.contextmanager
def _plain_calls():
    """{"stem", "grouping"}: calls of the kernels' plain versions while the
    context is open (the wrappers' module globals, counted)."""
    from gvcnn_tf_tpu_torch.ops import grouping_kernel, stem_kernel

    calls = {"stem": 0, "grouping": 0}
    real = (stem_kernel.stem_conv_plain, grouping_kernel.group_and_fuse_plain)

    def counted(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    stem_kernel.stem_conv_plain = counted("stem", real[0])
    grouping_kernel.group_and_fuse_plain = counted("grouping", real[1])
    try:
        yield calls
    finally:
        stem_kernel.stem_conv_plain, grouping_kernel.group_and_fuse_plain = \
            real


def _artifact_forward_checked(module, x, want_counts, what):
    """One forward of a loaded artifact -> its logits on the host; the
    kernels' launches in it equal `want_counts` (bf16 stem, fp32 stem,
    grouping) and their plain versions run no time."""
    _zero_counts()
    with _plain_calls() as plain, torch.inference_mode():
        logits, probs = module(x)
        torch.cuda.synchronize()
    launches = _counts()
    log(f"{what}: one artifact forward launched (bf16 stem, fp32 stem, "
        f"grouping) {launches}, plain versions {plain}")
    if launches != want_counts or any(plain.values()):
        raise AssertionError(f"{what}: expected launches {want_counts} and "
                             f"no plain call, got {launches}, {plain}")
    if tuple(probs.shape) != tuple(logits.shape):
        raise AssertionError(f"{what}: outputs {tuple(logits.shape)}, "
                             f"{tuple(probs.shape)}")
    return logits.float().cpu().numpy(), launches


def _check_same(got, want, what):
    """Logits of the artifact against the engine's: max|dlogit| within
    EXPORT_LOGIT_REL_TOL of max|logit|, argmax equal where the margin is
    above it."""
    scale = float(np.abs(want).max())
    d = float(np.abs(got - want).max())
    top2 = np.sort(want, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > EXPORT_LOGIT_REL_TOL * scale
    agree = got.argmax(-1) == want.argmax(-1)
    log(f"{what}: max|dlogit| {d:.4g} of max|logit| {scale:.4g} (rel "
        f"{d / scale:.3g}, bound {EXPORT_LOGIT_REL_TOL}); argmax equal on "
        f"{int(agree.sum())} of {len(agree)}")
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{what}: non-finite logits")
    if d > EXPORT_LOGIT_REL_TOL * scale or not agree[clear].all():
        raise AssertionError(f"{what}: the artifact and the engine disagree")
    return d / scale


def _phase_export(card, dev, root):
    """Phase 13 (a): export mn40_12view and its MVCNN, load, check, time.
    Returns (the results, the mn40_12view engine, left open)."""
    import os
    import subprocess

    from gvcnn_tf_tpu_torch import InferenceEngine, get_config
    from gvcnn_tf_tpu_torch.tools.export_model import export_model
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms, kernel_durations_us

    out = {}
    cfg = get_config("mn40_12view")
    d = cfg.data
    rs = np.random.RandomState(13)
    u8 = rs.randint(0, 256, (EXPORT_B, d.num_views, d.height, d.width, 3))
    # uint8 views normalized as the engine does it, in float32 on the host:
    # the artifact and the engine get the same floats.
    x = (u8.astype(np.float32) / np.float32(255.0) * np.float32(2.0)
         - np.float32(1.0)).astype(np.float32)
    t0 = time.perf_counter()
    blob = export_model(cfg, batch_size=EXPORT_B, device="cuda")
    out["export_s"] = time.perf_counter() - t0
    out["artifact_bytes"] = len(blob)
    log(f"exported mn40_12view (seeded weights, folded BN, bf16, B="
        f"{EXPORT_B}) in {out['export_s']:.2f} s: {len(blob)} bytes")
    engine = InferenceEngine(cfg, device="cuda")
    try:
        want, _ = engine.logits_and_scores(x)
        # The artifact loaded and run in a child process that imports only
        # the export module.
        art, xin, got_path = (root / "gvcnn.pt2", root / "x.npy",
                              root / "child_logits.npy")
        art.write_bytes(blob)
        np.save(xin, x)
        repo = str(root.parents[1])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _EXPORT_CHILD, str(art), str(xin),
             str(got_path)], cwd=repo, capture_output=True, text=True,
            timeout=600, env=dict(os.environ, PYTHONPATH=repo))
        log(f"child process ({time.perf_counter() - t0:.1f} s, rc "
            f"{proc.returncode}): {proc.stdout.strip()}")
        if proc.returncode != 0:
            raise AssertionError(f"the artifact failed in a child process:\n"
                                 f"{proc.stderr[-4000:]}")
        child = np.load(got_path)
        out["child_logit_rel"] = _check_same(child, want,
                                             "artifact in a child process vs "
                                             "the engine, B=8")
        module = torch.export.load(io.BytesIO(blob)).module()
        xd = torch.from_numpy(x).to(dev)
        got, launches = _artifact_forward_checked(
            module, xd, (1, 0, 1), "mn40_12view artifact")
        out["launches_per_forward"] = launches
        if not np.array_equal(got, child):
            log("note: the in-process artifact's logits differ from the "
                f"child's by {float(np.abs(got - child).max()):.3g}")
        _check_same(got, want, "artifact in this process vs the engine")
        with torch.inference_mode():
            fwd_art = lambda: module(xd)               # noqa: E731
            fwd_eager = lambda: engine.model(xd)       # noqa: E731
            times = {}
            for name, fn in (("artifact", fwd_art), ("eager", fwd_eager),
                             ("eager2", fwd_eager), ("artifact2", fwd_art)):
                times[name] = cuda_ms(fn, runs=EXPORT_TIMED_RUNS, warmup=5)
            kernels = {name: sum(len(v) for v in kernel_durations_us(
                fn, calls=3).values()) / 3
                for name, fn in (("artifact", fwd_art), ("eager", fwd_eager))}
        out.update(artifact_ms=min(times["artifact"], times["artifact2"]),
                   eager_ms=min(times["eager"], times["eager2"]),
                   times_ms=times, device_kernels_per_forward=kernels)
        log(f"B={EXPORT_B} forward, CUDA events, median of "
            f"{EXPORT_TIMED_RUNS} (artifact, eager, eager, artifact): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
            + f"; device kernels a forward: {kernels} [{card}]")

        mv = get_config("mn40_12view_mvcnn")
        t0 = time.perf_counter()
        blob_mv = export_model(mv, batch_size=EXPORT_B, device="cuda")
        out["mvcnn_export_s"] = time.perf_counter() - t0
        out["mvcnn_artifact_bytes"] = len(blob_mv)
        log(f"exported mn40_12view_mvcnn in {out['mvcnn_export_s']:.2f} s: "
            f"{len(blob_mv)} bytes")
        mv_engine = InferenceEngine(mv, device="cuda", buckets=[EXPORT_B])
        try:
            want_mv, _ = mv_engine.logits_and_scores(x)
        finally:
            mv_engine.close()
        got_mv, mv_launches = _artifact_forward_checked(
            torch.export.load(io.BytesIO(blob_mv)).module(), xd, (1, 0, 0),
            "mn40_12view_mvcnn artifact")
        out["mvcnn_launches_per_forward"] = mv_launches
        out["mvcnn_logit_rel"] = _check_same(got_mv, want_mv,
                                             "MVCNN artifact vs its engine")
    except BaseException:
        engine.close()
        raise
    return out, engine


def _phase_loadgen(card, engine):
    """Phase 13 (b): run_load on the engine, closed then open loop."""
    from gvcnn_tf_tpu_torch.tools.loadgen import run_load

    closed = run_load(engine, num_clients=LOAD_CLIENTS, duration_s=LOAD_S,
                      request_sizes=LOAD_SIZES, warmup_s=LOAD_WARMUP_S)
    log(f"loadgen closed loop: {json.dumps(closed)} [{card}]")
    rate = 0.5 * closed["requests"] / LOAD_S
    opened = run_load(engine, num_clients=LOAD_CLIENTS, duration_s=LOAD_S,
                      request_sizes=LOAD_SIZES, warmup_s=LOAD_WARMUP_S,
                      rate_rps=rate)
    log(f"loadgen open loop at {rate:.2f} requests/s: {json.dumps(opened)} "
        f"[{card}]")
    for rep in (closed, opened):
        sizes = [f"b{n}_p99_ms" for n in LOAD_SIZES]
        if not (rep["requests"] > 0 and all(k in rep for k in sizes)
                and 0 < rep["p50_ms"] <= rep["p99_ms"]):
            raise AssertionError(f"loadgen report {rep}")
    return {"closed": closed, "open": opened}


def _phase_retrieval(card, dev, logdir):
    """Phase 13 (c): descriptors of phase 9's step-10 checkpoint on the
    procedural val split, card against CPU, and the retrieval metrics."""
    import dataclasses
    import itertools

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.data import make_dataset
    from gvcnn_tf_tpu_torch.tools.retrieval import (
        extract_descriptors,
        retrieval_metrics,
    )

    base = get_config("mn40_12view")
    cfg = base.replace(data=dataclasses.replace(
        base.data, dataset="procedural", transfer_dtype="uint8",
        synthetic_num_shapes=PROC_SHAPES))
    d, seed = cfg.data, cfg.train.seed
    _zero_counts()
    t0 = time.perf_counter()
    descs, labels = extract_descriptors(cfg, logdir, device="cuda")
    wall = time.perf_counter() - t0
    launches = _counts()
    first = itertools.islice(make_dataset(d, train=False, seed=seed),
                             CPU_SHAPES // d.batch_size)
    cpu, cpu_labels = extract_descriptors(
        cfg.replace(compute_dtype="float32"), logdir, dataset_iter=first,
        device="cpu")
    norms = np.linalg.norm(descs, axis=1)
    cos = (descs[:CPU_SHAPES] * cpu).sum(-1)
    others = cpu @ cpu.T
    metrics = retrieval_metrics(descs, labels)
    log(f"retrieval of the step-10 checkpoint, {len(labels)} val shapes on "
        f"the card in {wall:.2f} s, launches {launches}: norms "
        f"{norms.min():.7f}-{norms.max():.7f}; card vs CPU per-shape cosine "
        f"min {cos.min():.7f} (bound {RETRIEVAL_COS_MIN}), mean "
        f"{cos.mean():.7f}; the CPU's cosine between different shapes min "
        f"{others[~np.eye(len(cpu), dtype=bool)].min():.5f}; {metrics} "
        f"[{card}]")
    if (len(labels) != PROC_SHAPES
            or not np.array_equal(labels[:CPU_SHAPES], cpu_labels)):
        raise AssertionError("retrieval labels disagree")
    if not np.allclose(norms, 1.0, atol=1e-5) or cos.min() < (
            RETRIEVAL_COS_MIN):
        raise AssertionError("card and CPU descriptors disagree")
    if launches != (EVAL_FORWARDS, 0, EVAL_FORWARDS):
        raise AssertionError(f"retrieval launches {launches}")
    return dict(metrics, cos_min=float(cos.min()), seconds=wall,
                launches=launches)


def _phase_study(card):
    """Phase 13 (d): the study tool, both families, seed 0, cut short."""
    from gvcnn_tf_tpu_torch.tools import proc_benchmark

    a = proc_benchmark._parser().parse_args(STUDY_ARGV)
    a.width = a.height
    out = {}
    for model in ("gvcnn", "mvcnn"):
        _zero_counts()
        r = proc_benchmark.run_one(model, a, 0)
        launches = _counts()
        forwards = a.steps + 2          # the steps, evaluate, descriptors
        want = (forwards, 0, forwards if model == "gvcnn" else 0)
        log(f"study smoke, {model}: {json.dumps(r)}; launches {launches} "
            f"[{card}]")
        if list(r) != STUDY_KEYS or r["count"] != 16 or launches != want:
            raise AssertionError(f"study smoke {model}: {r}, launches "
                                 f"{launches} (expected {want})")
        if not all(np.isfinite(r[k]) for k in STUDY_KEYS[2:]):
            raise AssertionError(f"study smoke {model}: {r}")
        out[model] = r
    return out


def phase_tools(card, dev, eval_logdir):
    """Phase 13: export, the load generator, retrieval, the study."""
    import shutil
    from pathlib import Path

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_tools"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    try:
        export, engine = _phase_export(card, dev, root)
        try:
            load = _phase_loadgen(card, engine)
        finally:
            engine.close()
        retrieval = _phase_retrieval(card, dev, eval_logdir)
        study = _phase_study(card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(Path(eval_logdir).parent, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"phase 13 in {seconds:.1f} s")
    return dict(export=export, loadgen=load, retrieval=retrieval,
                study=study, seconds=seconds)


def phase_loader_probe():
    """What the file loaders need on this machine, printed on one line:
    libjpeg's and libpng's headers and libraries, whether PIL imports, the
    compiler, and whether the native decode pool and
    the TFRecord CRC library build."""
    import os
    import shutil
    import subprocess

    from gvcnn_tf_tpu_torch.data import native_loader

    headers = {h: [d for d in ("/usr/include", "/usr/local/include")
                   if os.path.exists(os.path.join(d, h))]
               for h in ("jpeglib.h", "png.h")}
    try:
        ld = subprocess.run(["ldconfig", "-p"], capture_output=True,
                            text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        ld = f"(ldconfig: {e})"
    libs = sorted({line.split()[0] for line in ld.splitlines()
                   if "libjpeg" in line or "libpng" in line})
    try:
        import PIL  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    status = {}
    for name in (native_loader.LIB_NAME, native_loader.RECORDS_LIB):
        try:
            native_loader.library(name)
            status[name] = "builds"
        except RuntimeError as e:
            status[name] = str(e).splitlines()[0]
    log(f"loader probe: headers {headers}; ldconfig "
        f"{libs or 'lists no libjpeg or libpng'}; PIL "
        f"{'imports' if pil else 'does not import'}; g++ "
        f"{shutil.which('g++')}; decode pool ({native_loader.LIB_NAME}): "
        f"{status[native_loader.LIB_NAME]}; TFRecord CRC library "
        f"({native_loader.RECORDS_LIB}): {status[native_loader.RECORDS_LIB]}")
    return dict(pool=status[native_loader.LIB_NAME] == "builds",
                records=status[native_loader.RECORDS_LIB] == "builds",
                pil=pil, pool_status=status[native_loader.LIB_NAME])


def _write_decoded_cache(tree, views, labels, names):
    """Without the decode pool and PIL: the tree as PNG (written here) and
    its decode-once cache in the cache's documented layout, from the
    procedural arrays the PNGs hold."""
    import json
    import os

    from gvcnn_tf_tpu_torch.data.decoded_cache import cache_paths
    from gvcnn_tf_tpu_torch.utils.png import write_png

    for i, (vs, lbl) in enumerate(zip(views, labels)):
        d = os.path.join(tree, names[lbl], f"{names[lbl]}_{i:04d}")
        os.makedirs(d, exist_ok=True)
        for k, img in enumerate(vs):
            write_png(os.path.join(d, f"view_{k:02d}.png"), img)
    shapes, classes, data_path, meta_path = cache_paths(
        tree, num_views=views.shape[1], height=views.shape[2],
        width=views.shape[3])
    order = {f"{names[lbl]}/{names[lbl]}_{i:04d}": i
             for i, lbl in enumerate(labels)}
    idx = [order[sid] for sid, _, _ in shapes]
    mm = np.memmap(data_path, np.uint8, mode="w+",
                   shape=(len(idx),) + views.shape[1:])
    mm[:] = views[idx]
    mm.flush()
    del mm
    with open(meta_path, "w") as f:
        json.dump({"labels": [int(lbl) for _, lbl, _ in shapes],
                   "shape_ids": [sid for sid, _, _ in shapes],
                   "classes": classes,
                   "geometry": [len(idx)] + list(views.shape[1:])}, f)


def _render_loader_trees(root, probe, res, views):
    """The phase's trees at res x res, `views` views -> (dirs by loader and
    split, train shapes, seconds)."""
    import os

    from gvcnn_tf_tpu_torch.data.procedural import (build_procedural_split,
                                                    class_table)
    from gvcnn_tf_tpu_torch.data.tfrecord import build_tfrecords
    from gvcnn_tf_tpu_torch.tools.export_renders import export_tree
    from gvcnn_tf_tpu_torch.tools.make_demo_meshes import generate
    from gvcnn_tf_tpu_torch.tools.render_meshes import render_tree

    names = [n for n, _ in class_table(40)]
    t0 = time.perf_counter()
    meshes = root / "meshes"
    generate(str(meshes), 2, 2, num_classes=40)

    def keep(split, n):
        # One mesh of each class, a second of the first n - 40.
        for i, name in enumerate(names):
            if i >= n - 40:
                base = 1 if split == "train" else 10_001
                os.remove(meshes / name / split / f"{name}_{base:04d}.off")

    keep("test", LOADER_VAL_SHAPES)
    dirs = {"png_val": str(root / "png" / "val"),
            "png_train": str(root / "png" / "train")}
    n_val = render_tree(str(meshes), dirs["png_val"], split="test",
                        num_views=views, res=res)
    per_shape = (time.perf_counter() - t0) / n_val
    n_train = LOADER_TRAIN_SHAPES
    projected = per_shape * (n_val + 2 * n_train + n_val)
    if projected > LOADER_RENDER_BUDGET_S:
        n_train = LOADER_CUT_SHAPES
        log(f"rendering projected at {projected:.1f} s (over "
            f"{LOADER_RENDER_BUDGET_S} s): {n_train} train shapes, not "
            f"{LOADER_TRAIN_SHAPES}")
    keep("train", n_train)
    render_tree(str(meshes), dirs["png_train"], split="train",
                num_views=views, res=res)
    t_png = time.perf_counter() - t0
    if probe["pool"] or probe["pil"]:
        for split, n in (("train", n_train), ("val", n_val)):
            dirs[f"jpg_{split}"] = str(root / "jpg" / split)
            export_tree(dirs[f"jpg_{split}"], num_classes=40,
                        num_views=views, height=res, width=res,
                        num_shapes=n, train_split=split == "train")
    else:
        # No decoder: the decoded loader's cache is written here.
        dirs["png_train"] = str(root / "arrays" / "train")
        dirs["png_val"] = str(root / "arrays" / "val")
        for split, n in (("train", n_train), ("val", n_val)):
            arrays, labels = build_procedural_split(
                num_views=views, height=res, width=res, num_shapes=n,
                seed=0, train_split=split == "train", num_classes=40)
            _write_decoded_cache(dirs[f"png_{split}"], arrays, labels, names)
    seconds = time.perf_counter() - t0
    if probe["records"]:
        dirs["tfr"] = str(root / "tfr")
        build_tfrecords(dirs["png_train"], dirs["tfr"], views,
                        split_name="train", num_shards=4)
        build_tfrecords(dirs["png_val"], dirs["tfr"], views,
                        split_name="validation", num_shards=2)
    log(f"rendered the loader trees in {seconds:.1f} s (render_tree PNG of "
        f"{n_train} + {n_val} meshes in {t_png:.1f} s, then "
        f"{'export_tree JPEG' if 'jpg_train' in dirs else 'the arrays'} of "
        f"{n_train} + {n_val} procedural shapes), {res}x{res}, {views} "
        f"views; "
        f"TFRecords built in {time.perf_counter() - t0 - seconds:.1f} s")
    return dirs, n_train, seconds


def phase_loaders(card, dev, step_views_per_s):
    """Phase 14: the file loaders at full width."""
    import dataclasses
    import importlib
    import shutil
    from pathlib import Path

    from gvcnn_tf_tpu_torch import evaluate, get_config, train
    from gvcnn_tf_tpu_torch.data import make_dataset
    from gvcnn_tf_tpu_torch.tools.bench_input import bench_input

    train_mod = importlib.import_module("gvcnn_tf_tpu_torch.train")
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_loaders"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    probe = phase_loader_probe()
    base = get_config("mn40_12view")
    allowed = {"native": probe["pool"],
               "decoded": True,
               "tfrecord": probe["records"] and (probe["pool"]
                                                 or probe["pil"])}

    def config(loader, split_dir, logdir=None, **kw):
        return base.replace(
            data=dataclasses.replace(base.data, loader=loader,
                                     dataset_dir=split_dir,
                                     transfer_dtype="uint8"),
            train=dataclasses.replace(
                base.train, train_logdir=str(logdir or root / "unused"),
                log_every=LOADER_STEPS, checkpoint_every=LOADER_STEPS), **kw)

    try:
        dirs, n_train, render_s = _render_loader_trees(
            root, probe, base.data.height, base.data.num_views)
        train_dirs = {"native": dirs.get("jpg_train"),
                      "decoded": dirs["png_train"], "tfrecord": dirs.get("tfr")}
        eval_dirs = {"native": dirs.get("png_val"),
                     "decoded": dirs["png_val"], "tfrecord": dirs.get("tfr")}
        for loader, ok in allowed.items():
            if not ok:
                try:
                    make_dataset(config(loader, train_dirs[loader]
                                        or dirs["png_train"]).data,
                                 train=True)
                except RuntimeError as e:
                    log(f"{loader} loader refused on this machine: "
                        f"{str(e).splitlines()[0]}")
                else:
                    raise AssertionError(f"{loader}: expected a refusal")

        # 1. train() through each allowed loader.
        trained, flips = {}, []
        real_flip = train_mod.device_flip

        def counted_flip(views, mask):
            # The mask, read after the run: the compiled step calls this at
            # its eager warm-up (step 0) and at its capture, whose mask is
            # the graph's buffer, which every replay rewrites (the last
            # step's after the run).
            flips.append(mask)
            return real_flip(views, mask)

        train_mod.device_flip = counted_flip
        try:
            for loader in (k for k, ok in allowed.items() if ok):
                logdir = root / f"train_{loader}"
                cfg = config(loader, train_dirs[loader], logdir)
                flips.clear()
                _zero_counts()
                t0 = time.perf_counter()
                state, mets = train(cfg, num_steps=LOADER_STEPS,
                                    device="cuda")
                wall = time.perf_counter() - t0
                launches = _counts()
                shares = [float(m.float().mean()) for m in flips]
                # Each recorded mask is the one its step drew.
                same = []
                for m, step in zip(flips, (0, LOADER_STEPS - 1)):
                    state.step = step
                    same.append(bool(torch.equal(
                        m, train_mod.flip_mask(state, cfg, tuple(m.shape)))))
                state.step = LOADER_STEPS
                log(f"train() through the {loader} loader ({n_train} "
                    f"shapes): {LOADER_STEPS} steps in {wall:.1f} s (the "
                    f"first loads or builds the input); launches (bf16 "
                    f"stem, fp32 stem, grouping) {launches}; on-card flips "
                    f"in the warm-up and the captured step {len(flips)} "
                    f"(share flipped at steps 0 and {LOADER_STEPS - 1} "
                    f"{', '.join(f'{f:.2f}' for f in shares) or '-'}, each "
                    f"that step's mask: {same}); last {mets}")
                if launches != (LOADER_STEPS, 0, LOADER_STEPS):
                    raise AssertionError(f"{loader}: launches {launches}")
                if not (state.step == LOADER_STEPS and all(
                        np.isfinite(v) for v in mets.values())):
                    raise AssertionError(f"{loader}: step {state.step}, "
                                         f"{mets}")
                want_flips = 2 if loader == "decoded" else 0
                if len(flips) != want_flips or not all(
                        0 < f < 1 for f in shares) or not all(same):
                    raise AssertionError(f"{loader}: on-card flips {shares}, "
                                         f"each its step's mask {same}")
                trained[loader] = dict(launches=launches, seconds=wall,
                                       loss=mets["loss"], logdir=str(logdir))
        finally:
            train_mod.device_flip = real_flip

        # 2. The validation tree on the card against fp32 on the CPU, the
        # checkpoint of the TFRecord run (or of the decoded one).
        ckpt = trained.get("tfrecord", trained["decoded"])["logdir"]
        evals = {}
        for loader in trained:
            cfg = config(loader, eval_dirs[loader])
            _zero_counts()
            with eval_logits() as card_seen:
                card_res = evaluate(cfg, ckpt, device="cuda")
            launches = _counts()
            with eval_logits() as cpu_seen:
                cpu_res = evaluate(cfg.replace(compute_dtype="float32"),
                                   ckpt, device="cpu")
            # Counts are held as the phase states: equal, or apart only where
            # the CPU's top-2 margin is under the serve-drift bound.  The
            # checkpoint is 5 steps from random weights, its BatchNorm
            # statistics barely moved: logits reach ~1e3-1e4 and bf16
            # drifts past that bound on some batches (8.7% in a CPU
            # rehearsal at 64x64), so max|dlogit| is printed, not held.
            near = sum(check_card_vs_cpu(a, b, f"{loader} eval batch {i}",
                                         hold_dlogit=False)
                       for i, (a, b) in enumerate(zip(card_seen, cpu_seen)))
            log(f"evaluate() through the {loader} loader: card {card_res}, "
                f"CPU {cpu_res}, {near} shapes under the margin; launches "
                f"{launches}")
            if (not card_res["count"] == cpu_res["count"]
                    == LOADER_VAL_SHAPES
                    or abs(card_res["correct"] - cpu_res["correct"]) > near):
                raise AssertionError(f"{loader}: card and CPU counts "
                                     "disagree")
            if launches != (LOADER_EVAL_FORWARDS, 0, LOADER_EVAL_FORWARDS):
                raise AssertionError(f"{loader} eval: launches {launches}")
            evals[loader] = dict(card=card_res, cpu=cpu_res, near=near,
                                 launches=launches)

        # 3. What each loader feeds, against what the B=8 step consumes.
        bench = {}
        for loader in trained:
            rep = bench_input(config(loader, train_dirs[loader]),
                              num_batches=LOADER_BENCH_BATCHES)
            bench[loader] = rep
            log(f"bench_input {loader}: {rep['views_per_sec']} views/s "
                f"({rep['batches_per_sec']} batches/s of "
                f"{rep['batch_geometry']}, uint8, num_threads 0) against "
                f"{step_views_per_s:.1f} views/s that the B=8 train step "
                f"consumes (phase 8, this run) [{card}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"phase 14 in {seconds:.1f} s")
    return dict(probe=probe, train_shapes=n_train, render_s=render_s,
                train={k: {kk: vv for kk, vv in v.items() if kk != "logdir"}
                       for k, v in trained.items()},
                eval=evals, bench=bench, step_views_per_s=step_views_per_s,
                seconds=seconds)


def _param_vector(model_state):
    return torch.cat([v.detach().float().flatten().cpu()
                      for _, v in sorted(model_state.items())
                      if v.is_floating_point()])


def _resident_split(base):
    """The procedural train split phase 15 trains on: (num_shapes, render
    seconds)."""
    from gvcnn_tf_tpu_torch.data.procedural import build_procedural_split

    d = base.data

    def render(n):
        t0 = time.perf_counter()
        build_procedural_split(num_views=d.num_views, height=d.height,
                               width=d.width, num_shapes=n,
                               seed=base.train.seed, train_split=True,
                               hard=False, num_classes=d.num_classes)
        return time.perf_counter() - t0

    predicted = render(8) * d.synthetic_num_shapes / 8
    n = (d.synthetic_num_shapes if predicted <= RESIDENT_RENDER_BUDGET_S
         else PROC_SHAPES)
    render_s = render(n)
    whose = ("the config's own" if n == d.synthetic_num_shapes
             else "phase 9's: rendering the config's would pass "
                  f"{RESIDENT_RENDER_BUDGET_S} s")
    log(f"phase 15 split: {n} shapes ({whose}), rendered in {render_s:.1f} "
        f"s ({d.synthetic_num_shapes} predicted at {predicted:.1f} s from "
        f"the first 8)")
    return n, render_s


def phase_resident(card, dev):
    """Phase 15 (a): train() with the procedural uint8 split streamed and
    resident on the card, in turns; the first batches byte for byte; a
    resident run resumed from a streaming checkpoint."""
    import dataclasses
    import importlib
    import shutil
    from pathlib import Path

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.configs import resolve_transfer_dtype
    from gvcnn_tf_tpu_torch.data import DevicePrefetcher, make_dataset
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights

    # What the earlier phases left with the allocator: each capture below
    # returns the cached part to the device first (`utils/graphs.py`).
    log(f"allocator at phase 15: {torch.cuda.memory_allocated(dev)} B "
        f"allocated, {torch.cuda.memory_reserved(dev)} B reserved")
    train_mod = importlib.import_module("gvcnn_tf_tpu_torch.train")
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_resident"
    shutil.rmtree(root, ignore_errors=True)
    base = get_config("mn40_12view")
    n_shapes, render_s = _resident_split(base)
    views_per_step = base.data.batch_size * base.data.num_views

    def config(mode, logdir):
        return base.replace(
            data=dataclasses.replace(base.data, dataset="procedural",
                                     transfer_dtype="uint8",
                                     synthetic_num_shapes=n_shapes,
                                     device_resident=mode),
            train=dataclasses.replace(
                base.train, train_logdir=str(logdir),
                log_every=RESIDENT_LOG_EVERY,
                checkpoint_every=RESIDENT_STEPS))

    # 1. The first batches through the prefetcher, resident against the
    # stream, byte for byte; the staged split passed by reference.
    cfg = config("on", root / "unused")
    seed = cfg.train.seed
    it = make_dataset(cfg.data, train=True, seed=seed, device=dev)
    stream = make_dataset(dataclasses.replace(cfg.data,
                                              device_resident="off"),
                          train=True, seed=seed)
    if type(it).__name__ != "DeviceResidentIter":
        raise AssertionError(f"device_resident='on' gave {type(it)}")
    with DevicePrefetcher(it, dev, resolve_transfer_dtype(cfg)) as pf:
        for i in range(RESIDENT_CHECK_BATCHES):
            b, want = next(pf), next(stream)
            if (b["views"].data_ptr() != it.views.data_ptr()
                    or b["label"].data_ptr() != it.labels.data_ptr()
                    or b["idx"].device != it.views.device):
                raise AssertionError("a resident batch left the prefetcher "
                                     "without its staged tensors")
            got = b["views"].index_select(0, b["idx"]).cpu().numpy()
            lab = b["label"].index_select(0, b["idx"]).cpu().numpy()
            if (got.tobytes() != want["views"].tobytes()
                    or not np.array_equal(lab, want["label"])):
                raise AssertionError(f"resident batch {i} differs from the "
                                     "stream's")
    log(f"the first {RESIDENT_CHECK_BATCHES} resident batches equal the "
        f"stream's byte for byte (views and labels; staged "
        f"{it.staged_bytes / 1e6:.1f} MB in {it.stage_seconds:.3f} s)")
    del it, pf, b

    # 2. Streaming and resident in turns.
    def run(mode, logdir, steps):
        staged = {"kind": None, "s": 0.0, "bytes": 0}
        real = train_mod.make_dataset

        def spy(*args, **kw):
            out = real(*args, **kw)
            staged.update(kind=type(out).__name__,
                          s=getattr(out, "stage_seconds", 0.0),
                          bytes=getattr(out, "staged_bytes", 0))
            return out

        train_mod.make_dataset = spy
        _zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        try:
            state, mets = train_mod.train(config(mode, logdir),
                                          num_steps=steps, device="cuda")
        finally:
            train_mod.make_dataset = real
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(logdir / "metrics.jsonl") as f:
            last = [json.loads(line) for line in f][-1]
        # Only the trained weights, on the host, outlive the run, so that
        # each run's peak memory is its own.
        return dict(step=state.step, mets=mets, wall=wall, launches=_counts(),
                    params=_param_vector(state.model.state_dict()),
                    staged=staged, peak=torch.cuda.max_memory_allocated(dev),
                    loop_vps=last["shapes_per_sec"] * base.data.num_views)

    runs = []
    for i, mode in enumerate(("off", "on", "on", "off")):
        r = run(mode, root / f"run{i}_{mode}", RESIDENT_STEPS)
        r["mode"] = mode
        ran = r["step"]
        want_kind = "DeviceResidentIter" if mode == "on" else (
            "ProceduralStream")
        vps = RESIDENT_STEPS * views_per_step / r["wall"]
        log(f"train() {'resident' if mode == 'on' else 'streaming'} "
            f"(device_resident={mode!r}), {RESIDENT_STEPS} steps: wall "
            f"{r['wall']:.3f} s, {vps:.1f} views/s end to end, "
            f"{r['loop_vps']:.1f} views/s over the loop's last "
            f"{RESIDENT_LOG_EVERY} steps; staged {r['staged']['bytes']} B "
            f"in {r['staged']['s']:.3f} s; peak memory "
            f"{r['peak'] / 1e9:.3f} GB; launches {r['launches']}; last "
            f"{r['mets']} [{card}]")
        if r["staged"]["kind"] != want_kind or ran != RESIDENT_STEPS:
            raise AssertionError(f"{mode}: {r['staged']['kind']}, {ran} "
                                 "steps")
        if r["launches"] != (RESIDENT_STEPS, 0, RESIDENT_STEPS):
            raise AssertionError(f"{mode}: launches {r['launches']}, "
                                 "expected one of each bf16 kernel a step")
        if not all(np.isfinite(v) for v in r["mets"].values()):
            raise AssertionError(f"{mode}: metrics {r['mets']}")
        r["views_per_s"] = vps
        runs.append(r)

    # 3. The trained parameters: resident against streaming, beside two
    # runs of one transport.
    init = _param_vector(init_weights(build_model(base),
                                      base.train.seed).state_dict())
    vecs = [r["params"] for r in runs]

    def gap(i, j):
        return float((vecs[i] - vecs[j]).norm() / (vecs[j] - init).norm())

    same = [gap(0, 3), gap(1, 2)]
    cross = [gap(i, j) for i in (1, 2) for j in (0, 3)]
    bound = RESIDENT_GAP_ROOM * max(same) + RESIDENT_GAP_FLOOR
    log(f"trained parameters, ||a - b|| / ||b - init||: resident vs "
        f"streaming {[f'{g:.3e}' for g in cross]}; streaming vs streaming "
        f"{same[0]:.3e}, resident vs resident {same[1]:.3e}; bound "
        f"{bound:.3e}")
    if max(cross) > bound:
        raise AssertionError("the transports trained different weights")

    # 4. A resident run resumed from the last streaming run's checkpoint.
    total = RESIDENT_STEPS + RESIDENT_RESUME_STEPS
    r = run("on", root / "run3_off", total)
    log(f"resident run resumed from a streaming checkpoint at step "
        f"{RESIDENT_STEPS}: step {r['step']}, launches {r['launches']}, "
        f"staged {r['staged']['bytes']} B")
    if (r["step"] != total or r["staged"]["kind"] != "DeviceResidentIter"
            or r["launches"] != (RESIDENT_RESUME_STEPS, 0,
                                 RESIDENT_RESUME_STEPS)):
        raise AssertionError(f"resume: step {r['step']}, "
                             f"{r['staged']['kind']}, {r['launches']}")
    shutil.rmtree(root, ignore_errors=True)
    summary = [{k: r[k] for k in ("mode", "wall", "views_per_s", "loop_vps",
                                  "peak", "launches")}
               | {"stage_s": r["staged"]["s"],
                  "staged_bytes": r["staged"]["bytes"]} for r in runs]
    return dict(shapes=n_shapes, render_s=render_s, runs=summary,
                gaps={"cross": cross, "same": same, "bound": bound},
                launches_per_step=(runs[1]["launches"][0] / RESIDENT_STEPS,
                                   runs[1]["launches"][2] / RESIDENT_STEPS))


def _busy_us(intervals, lo, hi):
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    busy, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


def read_trace(path):
    """What phase 15 reads in a Chrome trace of `train(profile_steps=...)`:
    the `train_step` spans in order, the device events (kernels, copies,
    memsets), each kernel's launches, and the device's busy time and idle
    share from the first span's start to the last event's end."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("train_step ")),
                   key=lambda e: e["ts"])
    kernels = [e for e in device if e["cat"] == "kernel"]
    out = dict(events=len(events), spans=[e["name"] for e in spans],
               device_events=len(device), kernels=len(kernels),
               stem_events=sum(STEM_KERNEL_NAME in e["name"]
                               for e in kernels),
               grouping_events=sum(GROUPING_KERNEL_NAME in e["name"]
                                   for e in kernels))
    if not device or not spans:
        return out | dict(window_ms=None, busy_ms=None, idle=None)
    lo = spans[0]["ts"]
    hi = max(e["ts"] + e.get("dur", 0) for e in device + spans)
    busy = _busy_us([(e["ts"], e["ts"] + e.get("dur", 0)) for e in device],
                    lo, hi)
    return out | dict(window_ms=(hi - lo) / 1e3, busy_ms=busy / 1e3,
                      idle=1 - busy / (hi - lo))


_PROFILE_CHILD = """
import dataclasses, importlib, json, sys
from gvcnn_tf_tpu_torch import get_config
from gvcnn_tf_tpu_torch.ops import launches
logdir, n_shapes, start, stop = sys.argv[1], *map(int, sys.argv[2:5])
train = importlib.import_module("gvcnn_tf_tpu_torch.train").train
base = get_config("mn40_12view")
# device_resident "auto": the card-resident split, the default here.
cfg = base.replace(
    data=dataclasses.replace(base.data, dataset="procedural",
                             transfer_dtype="uint8",
                             synthetic_num_shapes=n_shapes),
    train=dataclasses.replace(base.train, train_logdir=logdir,
                              log_every=stop + 1, checkpoint_every=stop + 1))
state, mets = train(cfg, num_steps=stop + 1, profile_steps=(start, stop),
                    device="cuda")
assert "jax" not in sys.modules and "gvcnn_tf_tpu" not in sys.modules
print(json.dumps({"step": state.step, "mets": mets, "launches": [
    launches["stem_conv7x7s2_bf16"], launches["stem_conv7x7s2_f32"],
    launches["group_and_fuse_f32"]]}))
"""


def phase_profiled(card, dev, n_shapes):
    """Phase 15 (b): train(profile_steps=PROFILE_WINDOW) in a process of
    its own, as a trainer runs it, and its Chrome trace: the steps' spans,
    each kernel's device events, the idle share.  (Traced in this process,
    after phases 1-14, the window lost kernel records, one of the stem's
    launches among them, in both chip runs that tried it; `tools/measure.py
    trace-windows` finds such losses only after 20 or more profiler
    sessions in one process; PERF.md §6 and §7.)"""
    import importlib
    import os
    import shutil
    import subprocess
    from pathlib import Path

    from gvcnn_tf_tpu_torch.parallel import World
    from gvcnn_tf_tpu_torch.tools.measure import PROFILE_TRIES

    train_mod = importlib.import_module("gvcnn_tf_tpu_torch.train")
    repo = Path(__file__).resolve().parent
    root = repo / "build" / "chip_smoke_profile"
    shutil.rmtree(root, ignore_errors=True)
    start, stop = PROFILE_WINDOW
    for attempt in range(PROFILE_TRIES):
        logdir = root / f"try{attempt}"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _PROFILE_CHILD, str(logdir),
             str(n_shapes), str(start), str(stop)], cwd=repo,
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(repo)))
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the profiled train() failed in its "
                                 f"process:\n{proc.stderr[-4000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        path = logdir / train_mod.trace_name(PROFILE_WINDOW, World())
        tr = read_trace(path)
        if tr["device_events"]:
            break
        log(f"the profiler saw no device activity in {path.name}; "
            "profiling again")
    else:
        raise AssertionError(f"no device activity in {PROFILE_TRIES} traces")
    size = path.stat().st_size
    log(f"train(profile_steps={PROFILE_WINDOW}) over {stop + 1} steps in a "
        f"process of its own ({wall:.1f} s with start-up and rendering): "
        f"trace {path.name}, {size} B, {tr['events']} events; spans "
        f"{tr['spans']}; device events {tr['device_events']} "
        f"({tr['kernels']} kernels), {STEM_KERNEL_NAME} x{tr['stem_events']}"
        f", {GROUPING_KERNEL_NAME} x{tr['grouping_events']}; window "
        f"{tr['window_ms']:.3f} ms, device busy {tr['busy_ms']:.3f} ms, "
        f"idle {tr['idle']:.1%}; step {child['step']}, launches "
        f"{child['launches']}; last {child['mets']} [{card}]")
    want = [f"train_step {s}" for s in range(start, stop)]
    if tr["spans"] != want:
        raise AssertionError(f"trace spans {tr['spans']}, expected {want}")
    if not tr["stem_events"] == tr["grouping_events"] == stop - start:
        raise AssertionError(f"trace holds {tr['stem_events']} stem and "
                             f"{tr['grouping_events']} grouping launches, "
                             f"expected {stop - start} of each")
    if (child["launches"] != [stop + 1, 0, stop + 1]
            or child["step"] != stop + 1):
        raise AssertionError(f"profiled run: step {child['step']}, launches "
                             f"{child['launches']}")
    shutil.rmtree(root, ignore_errors=True)
    return tr | dict(trace_bytes=size, wall_s=wall, attempts=attempt + 1)


def _grads(state):
    return {n: p.grad.detach().double().flatten().cpu()
            for n, p in state.model.named_parameters()}


def _bn_stats(state):
    return {k: v.detach().cpu().clone()
            for k, v in state.model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def grad_agreement(got, want, noise_rel):
    """(cosine of all gradients flattened, the worst tensor's |ln(norm
    ratio)|, that tensor, whether all are bit-equal), leaving out of the
    ratios the tensors whose gradient norm is under noise_rel x the global
    norm on both sides."""
    import math

    names = list(want)
    flat = [torch.cat([g[n] for n in names]) for g in (got, want)]
    cos = float(torch.nn.functional.cosine_similarity(*flat, dim=0))
    floor = noise_rel * float(flat[1].norm())
    ratios = {}
    for n in names:
        a, r = float(got[n].norm()), float(want[n].norm())
        if max(a, r) >= floor:
            ratios[n] = (0.0 if a == r else math.inf if 0 in (a, r)
                         else abs(math.log(a / r)))
    worst = max(ratios, key=ratios.get)
    return (cos, ratios[worst], worst,
            all(torch.equal(got[n], want[n]) for n in names))


def phase_remat(card, dev):
    """Phase 16 (see the module docstring)."""
    import dataclasses

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.tools.measure import (
        NOISE_REL,
        cuda_ms,
        device_batch,
        release_memory,
        train_step_drift,
    )
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    t0 = time.perf_counter()
    base = get_config("mn40_12view")
    d = base.data
    cfgs = {k: base.replace(**kw) for k, kw in REMAT_VARIANTS}
    states = {k: create_train_state(c, dev) for k, c in cfgs.items()}
    init = states["none"].model.state_dict()
    for k, st in states.items():
        if any(not torch.equal(v, init[n])
               for n, v in st.model.state_dict().items()):
            raise AssertionError(f"remat {k}: the seeded init differs")

    # (a) and (b): one step of each variant on one batch on the card.
    batch = device_batch(base, d.batch_size, dev, seed=16)
    out = {}
    for k, st in states.items():
        _zero_counts()
        mets = train_step(st, batch, cfgs[k])
        torch.cuda.synchronize(dev)
        out[k] = dict(launches=_counts(), mets={n: v.cpu() for n, v in
                                               mets.items()},
                      grads=_grads(st), stats=_bn_stats(st))
        if out[k]["launches"] != REMAT_LAUNCHES[k]:
            raise AssertionError(f"remat {k}: launches (bf16 stem, fp32 "
                                 f"stem, grouping) a step "
                                 f"{out[k]['launches']}, want "
                                 f"{REMAT_LAUNCHES[k]}")
    for k in ("until", "backbone"):
        got, want = out[k], out["none"]
        if not torch.equal(got["mets"]["loss"], want["mets"]["loss"]):
            raise AssertionError(f"remat {k}: loss {got['mets']['loss']} vs "
                                 f"{want['mets']['loss']}")
        moved = [n for n, v in want["stats"].items()
                 if not torch.equal(got["stats"][n], v)]
        if moved:
            raise AssertionError(f"remat {k}: {len(moved)} BatchNorm "
                                 f"statistics differ, e.g. {moved[:3]}")
        cos, ratio, worst, equal = grad_agreement(got["grads"],
                                                  want["grads"], NOISE_REL)
        got["grad"] = dict(cosine=cos, logratio=ratio, worst=worst,
                           bit_equal=equal)
        log(f"remat {k}: loss {float(got['mets']['loss']):.6g} and all "
            f"{len(want['stats'])} BatchNorm statistics bit-equal to the "
            f"plain step's; gradients' cosine {cos:.9f} (bound "
            f"{REMAT_GRAD_COS_MIN}), worst |ln norm ratio| {ratio:.3g} "
            f"({worst}, bound {REMAT_GRAD_LOGRATIO_MAX}), bit-equal "
            f"{equal}; launches a step {got['launches']}")
        if cos < REMAT_GRAD_COS_MIN or ratio > REMAT_GRAD_LOGRATIO_MAX:
            raise AssertionError(f"remat {k}: gradients disagree")
    check_train_drift(train_step_drift(cfgs["until"].replace(
        data=dataclasses.replace(d, batch_size=2)), dev))

    # (c) Step time and peak memory at B = 8, in turns.
    b8 = {k: dict(step_ms=[], peak_gb=[], over_resident_gb=[])
          for k in cfgs}
    for k in REMAT_TURNS:
        st, cfg = states[k], cfgs[k]
        release_memory(dev)
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        b8[k]["step_ms"].append(cuda_ms(lambda: train_step(st, batch, cfg),
                                        runs=10, warmup=3))
        peak = torch.cuda.max_memory_allocated(dev)
        b8[k]["peak_gb"].append(peak / 1e9)
        b8[k]["over_resident_gb"].append((peak - resident) / 1e9)
    for k, row in b8.items():
        log(f"remat {k}, B={d.batch_size}: step {row['step_ms']} ms "
            f"(median of 10 after 3, in turns), peak "
            f"{row['peak_gb']} GB, of it above what was resident "
            f"{row['over_resident_gb']} GB [{card}]")

    # (d) One step at B = REMAT_BIG_B after one warm step.
    del batch
    big = device_batch(base, REMAT_BIG_B, dev, seed=17)
    b64 = {}
    for k, st in states.items():
        cfg = cfgs[k]
        release_memory(dev)
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(lambda: train_step(st, big, cfg), runs=1, warmup=1)
        peak = torch.cuda.max_memory_allocated(dev)
        b64[k] = dict(step_ms=ms, peak_gb=peak / 1e9,
                      over_resident_gb=(peak - resident) / 1e9)
        log(f"remat {k}, B={REMAT_BIG_B} ({REMAT_BIG_B * d.num_views} "
            f"views): one step {ms:.3f} ms after one warm step, peak "
            f"{peak / 1e9:.3f} GB, {b64[k]['over_resident_gb']:.3f} GB above "
            f"what was resident [{card}]")
    del big, states
    release_memory(dev)

    # (e) ResNet-50 with remat_backbone against no remat, one B = 8 step.
    rbase = get_config("mn40_12view_resnet50")
    rbatch = device_batch(rbase, rbase.data.batch_size, dev, seed=18)
    resnet = {}
    for k, kw in (REMAT_VARIANTS[0], REMAT_VARIANTS[2]):
        cfg = rbase.replace(**kw)
        st = create_train_state(cfg, dev)
        release_memory(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        mets = train_step(st, rbatch, cfg)
        torch.cuda.synchronize(dev)
        resnet[k] = dict(loss=mets["loss"].cpu(), launches=_counts(),
                         peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        del st
    if not torch.equal(resnet["backbone"]["loss"], resnet["none"]["loss"]):
        raise AssertionError(f"mn40_12view_resnet50 remat_backbone: loss "
                             f"{resnet['backbone']['loss']} vs "
                             f"{resnet['none']['loss']}")
    for row in resnet.values():
        row["loss"] = float(row["loss"])
    log(f"mn40_12view_resnet50, B=8, one step: loss equal under "
        f"remat_backbone ({resnet['none']['loss']:.6g}); peak memory "
        f"{resnet['none']['peak_gb']:.3f} GB without remat, "
        f"{resnet['backbone']['peak_gb']:.3f} GB with; launches "
        f"{resnet['none']['launches']} / {resnet['backbone']['launches']} "
        f"[{card}]")
    return dict(
        launches={k: v["launches"] for k, v in out.items()},
        grad={k: out[k]["grad"] for k in ("until", "backbone")},
        b8=b8, b64=b64, resnet50=resnet,
        seconds=time.perf_counter() - t0)


def _count_train_call(dev, seed=0):
    """`count_work` of one mn40_12view train-mode forward + backward at
    COUNT_SHAPE in bf16 on `dev`, the model seeded and channels-last (as
    `to_device` places it on a card; on the CPU too, so that autograd's
    layouts are the card's)."""
    import dataclasses

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
    from gvcnn_tf_tpu_torch.tools.bench_layers import count_work

    b, v, h, w = COUNT_SHAPE
    cfg = get_config("mn40_12view")
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, batch_size=b, num_views=v, height=h, width=w))
    model = init_weights(build_model(cfg), seed).to(
        dev, memory_format=torch.channels_last).train()
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand((b, v, h, w, 3), generator=g) * 2 - 1).to(
        dev, torch.bfloat16)

    def call():
        model.zero_grad(set_to_none=True)
        logits, _ = model(x, generator=torch.Generator(
            device=dev).manual_seed(seed))
        logits.float().sum().backward()

    return count_work(call)


def phase_analysis(card, dev):
    """Phase 17 (see the module docstring)."""
    from gvcnn_tf_tpu_torch.tools import (
        analyze_collectives,
        bench_layers,
        bench_phases,
    )

    t0 = time.perf_counter()
    # (a) Per-layer roofline attribution.
    _zero_counts()
    rows, summary = bench_layers.run(
        "inception_v1", batch=LAYERS_B, height=LAYERS_HW, width=LAYERS_HW,
        dtype="bfloat16", mode="train", iters=LAYERS_ITERS,
        endpoints=list(LAYERS_ENDPOINTS), method="marginal", device=dev)
    layer_launches = _counts()
    tower = dict(endpoint="whole tower", frac_of_bound=summary[
        "total_frac_of_bound"], frac_of_bound_device=summary[
        "total_frac_of_bound_device"], k2_launches=summary[
        "total_k2_launches"])
    for r in rows + [tower]:
        dev_frac, frac = r["frac_of_bound_device"], r["frac_of_bound"]
        if dev_frac is None or not 0 < dev_frac <= BOUND_FRAC_MAX or (
                not r.get("noisy") and frac > BOUND_FRAC_MAX):
            raise AssertionError(f"bench_layers {r['endpoint']}: "
                                 f"frac_of_bound {frac} (noisy: "
                                 f"{r.get('noisy')}), frac_of_bound_device "
                                 f"{dev_frac}; want each at most "
                                 f"{BOUND_FRAC_MAX}, the device's above 0")
        want = ([1, 2] if r["endpoint"] == "Conv2d_1a_7x7"
                else 1 if r is tower else [1, 1])
        if r["k2_launches"] != want:
            raise AssertionError(f"bench_layers {r['endpoint']}: stem "
                                 f"kernel launches {r['k2_launches']} in "
                                 f"the counted calls, want {want}")
    if layer_launches[0] == 0 or layer_launches[1:] != (0, 0):
        raise AssertionError(f"bench_layers launches {layer_launches}")
    log(f"bench_layers, B={LAYERS_B} images, {LAYERS_HW}x{LAYERS_HW}, bf16, "
        "train: "
        + "; ".join(f"{r['endpoint']} {r['ms']} ms (device "
                    f"{r['device_ms']} ms), {r['gflops']} GFLOP, "
                    f"{r['gbytes']} GB, bound {r['bound_ms']} ms "
                    f"({r['bound_by']}), frac_of_bound {r['frac_of_bound']}"
                    f" / device {r['frac_of_bound_device']}" for r in rows)
        + f"; whole tower {summary['total_ms']} ms (device "
        f"{summary['total_device_ms']} ms), MFU {summary['mfu']} [{card}]")

    # (b) The count on the card equals the count on the CPU.
    got, want = _count_train_call(dev), _count_train_call(
        torch.device("cpu"))
    diff = {k: (got.by_op.get(k), want.by_op.get(k))
            for k in set(got.by_op) | set(want.by_op)
            if got.by_op.get(k) != want.by_op.get(k)}
    if diff or (got.flops, got.bytes) != (want.flops, want.bytes):
        raise AssertionError(f"work count card vs CPU: {got.flops} / "
                             f"{got.bytes} vs {want.flops} / {want.bytes}; "
                             f"ops that differ: {diff}")
    if got.k2_launches != 1:
        raise AssertionError(f"counted train call: {got.k2_launches} stem "
                             "launches, want 1")
    log(f"work count of a {COUNT_SHAPE} mn40_12view train call: card "
        f"(kernels) = CPU (plain versions): {got.flops} FLOPs, {got.bytes} "
        f"bytes, {sum(r[0] for r in got.by_op.values())} ops")

    # (c) The measured phase split.
    phases = {}
    for b in PHASES_B:
        _zero_counts()
        out = bench_phases.run("mn40_12view", b, PHASES_ITERS, device=dev)
        per_call = out["launches_per_call"]
        want = {"stem_conv7x7s2_bf16": 1, "stem_conv7x7s2_f32": 0,
                "group_and_fuse_f32": 1}
        if any({k: v.get(k, 0) for k in want} != want
               for v in per_call.values()):
            raise AssertionError(f"bench_phases B={b}: launches a call "
                                 f"{per_call}, want {want} each")
        calls = len(per_call) * (1 + bench_phases.WARMUP + PHASES_ITERS)
        if _counts() != (calls, 0, calls):
            raise AssertionError(f"bench_phases B={b}: launches {_counts()},"
                                 f" want {calls} of each kernel")
        phases[b] = out
        log(f"bench_phases B={b}: fwd {out['fwd_ms']} ms, grad "
            f"{out['grad_ms']} ms, full {out['full_ms']} ms; bwd - fwd "
            f"{out['bwd_minus_fwd_ms']} ms, optimizer + state "
            f"{out['optimizer_state_ms']} ms [{card}]")

    # (d) The collective audit, weighed with the B = 32 step.
    step_ms = phases[PHASES_B[-1]]["full_ms"]
    recorded = analyze_collectives.audit(2, ("local", "global"),
                                         timeout=300)
    audits = {}
    for mode, rec in recorded.items():
        rep = analyze_collectives.report(
            rec, 2, mode, step_ms,
            step_source=f"bench_phases full, B={PHASES_B[-1]}, {card}")
        want = 1 if mode == "local" else 1 + 2 * rec["train_bn_calls"]
        if rep["collective_ops"] != want:
            raise AssertionError(f"analyze_collectives {mode}: "
                                 f"{rep['collective_ops']} device "
                                 f"all-reduces a step, want {want}")
        audits[mode] = {k: rep[k] for k in (
            "collective_ops", "allreduce_bytes_total", "allreduce_mbytes",
            "train_bn_calls", "step_ms_measured", "nvlink_gbps_assumed",
            "hop_us_assumed", "scaling_model_worst_case")}
        log(f"analyze_collectives {mode}: {rep['collective_ops']} device "
            f"all-reduces a step, {rep['allreduce_mbytes']} MB; modelled "
            f"efficiency (not measured) " + ", ".join(
                f"{r['devices']} cards {r['dp_efficiency']}"
                for r in rep["scaling_model_worst_case"]))
    return dict(layers=rows, layers_summary=summary,
                layer_launches=layer_launches,
                count=dict(flops=got.flops, bytes=got.bytes),
                phases=phases, collectives=audits,
                seconds=time.perf_counter() - t0)


def _tools_config(shape=None):
    """mn40_12view at TOOLS_B shapes, or at `shape` (B, V, H, W)."""
    import dataclasses

    from gvcnn_tf_tpu_torch import get_config

    cfg = get_config("mn40_12view")
    b, v, h, w = shape or (TOOLS_B, cfg.data.num_views, cfg.data.height,
                           cfg.data.width)
    return cfg.replace(data=dataclasses.replace(
        cfg.data, batch_size=b, num_views=v, height=h, width=w))


def _quiet(fn, *args, **kw):
    """fn(*args, **kw) with its standard output (the tools' JSON) kept out
    of this script's."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def phase_step_tools(card, dev):
    """Phase 18 (see the module docstring)."""
    from gvcnn_tf_tpu_torch.tools import (
        bench_backend_flags,
        bench_stem,
        bench_variants,
        check_wire_fusion,
        dump_ops,
        profile_step,
    )

    import os
    import subprocess
    from pathlib import Path

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    _zero_counts()
    # (a) profile_step: the B = TOOLS_B train step by layer and phase, in a
    # process of its own, as phase 15 profiles: after the earlier phases'
    # profiler sessions a window in this process loses kernel records (the
    # stem kernel's among them, in the first full run of this phase).
    repo = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, "-m", "gvcnn_tf_tpu_torch.tools.profile_step",
         "--batch", str(TOOLS_B), "--residual", "--top", "1000"],
        cwd=repo, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(repo)))
    if proc.returncode != 0:
        raise AssertionError(f"profile_step failed in its process:\n"
                             f"{proc.stderr[-4000:]}")
    prof = json.loads(proc.stdout[proc.stdout.index("{"):])
    share = prof["attributed_share"]
    where = prof["hand_written_kernels"]
    if share is None or share < ATTRIBUTED_MIN:
        raise AssertionError(f"profile_step: {share} of the kernel time "
                             f"tied to a layer or a bucket, want at least "
                             f"{ATTRIBUTED_MIN}")
    if where != {"stem": {"Conv2d_1a_7x7:fwd": 1},
                 "grouping": {"(gvcnn::group_and_fuse):fwd": 1}}:
        raise AssertionError(f"profile_step: the hand-written kernels ran "
                             f"under {where}; want the stem kernel once "
                             "under Conv2d_1a_7x7's forward and the "
                             "grouping kernel once in its op's row "
                             f"(launches a step {prof['launches_per_step']},"
                             f" device events a window "
                             f"{prof['window_events']})")
    res = prof["residual"]
    by = {r["layer"]: r for r in prof["layers_top"]}
    log(f"profile_step mn40_12view train B={TOOLS_B}: {prof['kernels']} "
        f"device events, {prof['device_ms']} ms of kernels, "
        f"{share:.6f} tied to a layer or bucket; idle "
        f"{res['device_idle']} (plain window); buckets "
        f"{json.dumps(res['buckets_ms'])}; activation saves "
        f"{res['activation_save']['mb']} MB in "
        f"{res['activation_save']['tensors']} tensors; top layers "
        + ", ".join(f"{r['layer']} {r['fwd_ms']}/{r['bwd_ms']} ms"
                    for r in prof["layers_top"][:6])
        + f"; stem kernel under Conv2d_1a_7x7 fwd "
        f"({by['Conv2d_1a_7x7']['fwd_ms']} ms fwd), grouping kernel in "
        f"(gvcnn::group_and_fuse) [{card}]")
    # (b) The card's op count by layer and phase equals the CPU's.
    tiny = _tools_config(TOOLS_TINY)
    counts = {}
    for where_, d in (("card", dev), ("cpu", cpu)):
        fn, model, data = profile_step.make_step(tiny, "train", d,
                                                 channels_last=True)
        fn()
        with profile_step.LayerTracker(model, exclude=data) as tracker:
            fn()
        counts[where_] = tracker.op_counts()
    if counts["card"] != counts["cpu"] or counts["card"] != prof[
            "op_counts"]:
        diff = {k: (counts["card"].get(k), counts["cpu"].get(k),
                    prof["op_counts"].get(k))
                for k in set(counts["card"]) | set(counts["cpu"])
                if len({json.dumps(c.get(k), sort_keys=True) for c in (
                    counts["card"], counts["cpu"], prof["op_counts"])}) > 1}
        raise AssertionError(f"profile_step op counts by layer, card / CPU "
                             f"/ card at B={TOOLS_B}, differ: {diff}")
    log(f"profile_step op counts at {TOOLS_TINY}: card = CPU, "
        f"{sum(sum(v.values()) for v in counts['card'].values())} ops in "
        f"{len(counts['card'])} rows (= the card's at B={TOOLS_B})")
    # (c) check_wire_fusion: the card's tables equal the CPU's.
    wires = {w: _quiet(check_wire_fusion.run, tiny, TOOLS_TINY[0],
                       device=d, channels_last=True)
             for w, d in (("card", dev), ("cpu", cpu))}
    for key in ("wire_bfloat16", "wire_uint8",
                "uint8_extra_materializations", "uint8_extra_bytes"):
        if wires["card"][key] != wires["cpu"][key]:
            raise AssertionError(f"check_wire_fusion {key}: card "
                                 f"{wires['card'][key]}, CPU "
                                 f"{wires['cpu'][key]}")
    wire = _quiet(check_wire_fusion.run, _tools_config(), TOOLS_B,
                  device=dev)
    log(f"check_wire_fusion at {TOOLS_TINY}: card tables = CPU's; at "
        f"B={TOOLS_B}: {wire['verdict']} ({wire['uint8_extra_bytes']} "
        f"bytes) [{card}]")
    # (d) dump_ops: Mixed_3b's segment, train mode; op for op the CPU's.
    seg = dict(batch=DUMP_B, height=224, width=224, mode="train")
    rec = dump_ops.segment_ops("inception_v1", "Mixed_3b", "MaxPool_3a_3x3",
                               device=dev, **seg)
    ref = dump_ops.segment_ops("inception_v1", "Mixed_3b", "MaxPool_3a_3x3",
                               device=cpu, **dict(seg, batch=2, height=64,
                                                  width=64))
    dump = dump_ops.summarize(rec)
    if dump["op_histogram"] != dump_ops.summarize(ref)["op_histogram"]:
        raise AssertionError("dump_ops Mixed_3b: the card's op histogram "
                             "differs from the CPU's")
    log(f"dump_ops Mixed_3b train, {DUMP_B} images: {dump['ops']} ops (= "
        f"the CPU's), relayout MB by kind "
        f"{json.dumps(dump['relayout_mbytes_by_kind'])}, "
        f"{dump['total_gbytes']} GB moved in all [{card}]")
    # (e) bench_stem: K2 against cuDNN at the tool's default shape.
    stems = _quiet(bench_stem.run, device=dev)
    bounds = {"bfloat16": STEM_TOL["rtol"], "float32": STEM_F32_REL_TOL}
    for r in stems:
        if not r["rel_dev"] <= bounds[r["dtype"]] or not r[
                "kernel_launches"]:
            raise AssertionError(f"bench_stem {r['dtype']}: rel_dev "
                                 f"{r['rel_dev']:.3g} (bound "
                                 f"{bounds[r['dtype']]}), launches "
                                 f"{r['kernel_launches']}")
    log("bench_stem, 384 x 224x224: " + "; ".join(
        f"{r['kernel']} {r['kernel_ms']} ms vs cuDNN {r['library_ms']} ms "
        f"(speedup {r['speedup']}, rel_dev {r['rel_dev']:.3g})"
        for r in stems) + f" [{card}]")
    # (f) bench_variants: a few rows at B = TOOLS_B.
    rows = _quiet(bench_variants.run, _tools_config(), TOOLS_B, TOOLS_ITERS,
                  TOOLS_VARIANTS, device=dev)
    by = {r["variant"]: r for r in rows}
    if (list(by) != list(TOOLS_VARIANTS)
            or by["merge_1x1"].get("same_program_as") != "baseline"
            or not all(np.isfinite(r["first_loss"]) for r in rows)):
        raise AssertionError(f"bench_variants rows: {rows}")
    log(f"bench_variants B={TOOLS_B}: " + ", ".join(
        f"{r['variant']} {r['step_ms']} ms" for r in rows) + f" [{card}]")
    # (g) bench_backend_flags: every setting timed, every one restored.
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    settings = _quiet(bench_backend_flags.run, _tools_config(), TOOLS_B,
                      TOOLS_ITERS, device=dev)
    after = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if after != flags or not all("step_ms" in r for r in settings):
        raise AssertionError(f"bench_backend_flags: {settings}; backends "
                             f"{flags} before, {after} after")
    log(f"bench_backend_flags B={TOOLS_B}: " + ", ".join(
        f"{r['name']} {r['step_ms']} ms" for r in settings) + f" [{card}]")
    launches = _counts()
    if launches[0] == 0 or launches[1] == 0 or launches[2] == 0:
        raise AssertionError(f"phase 18 launches {launches}")
    return dict(profile=dict(kernels=prof["kernels"],
                             device_ms=prof["device_ms"],
                             attributed_share=share,
                             launches_per_step=prof["launches_per_step"],
                             buckets_ms=res["buckets_ms"],
                             device_idle=res["device_idle"]),
                wire_extra_bytes=wire["uint8_extra_bytes"],
                stem=stems, variants=rows, settings=settings,
                launches=launches, seconds=time.perf_counter() - t0)


def _load_state(dst, src):
    """`dst` (a train state of the same model and optimizer) given `src`'s
    weights, statistics, optimizer and step, in place."""
    dst.model.load_state_dict(src.model.state_dict())
    dst.optimizer.load_state_dict(src.optimizer.state_dict())
    dst.step = src.step
    return dst


def _max_diff(a, b):
    """The largest |a - b| over two state dicts' (or metric dicts') floating
    tensors (0.0: bit-equal)."""
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in a if a[k].is_floating_point())


def _hold_spread(what, eager, again, compiled):
    """(the eager repeat's spread, the compiled run's difference) over the
    states and each step's metrics; bit-equal where the eager step repeats
    bit for bit, else within COMPILED_SPREAD x its spread."""
    spread = max(_max_diff(eager[0], again[0]),
                 *(_max_diff(x, y) for x, y in zip(eager[1], again[1])))
    diff = max(_max_diff(eager[0], compiled[0]),
               *(_max_diff(x, y) for x, y in zip(eager[1], compiled[1])))
    ok = diff == 0 or diff <= COMPILED_SPREAD * spread
    held = ("bit-equal" if diff == 0
            else f"held to {COMPILED_SPREAD} x the eager spread")
    log(f"{what}: compiled against eager max|d| {diff:.4g}, two eager runs "
        f"{spread:.4g} ({held})")
    if not ok:
        raise AssertionError(f"{what}: the compiled step is not the eager "
                             "step")
    return spread, diff


def _run_steps(fn, state, batches, cfg):
    """(final model state dict, each step's metrics, launches a step,
    the max-pool kernels' (forward, backward) launches a step, the
    BatchNorm kernels' (`_bn_counts`) a step), the counters taken from
    zero just before the steps."""
    _zero_counts()
    mets = [{k: v.detach().clone() for k, v in fn(state, b, cfg).items()}
            for b in batches]
    torch.cuda.synchronize()
    launches = tuple(n / len(batches) for n in _counts())
    pool = tuple(n / len(batches) for n in _pool_counts())
    bn = tuple(n / len(batches) for n in _bn_counts())
    return ({k: v.detach().clone()
             for k, v in state.model.state_dict().items()}, mets, launches,
            pool, bn)


def _profiled_idle(fn, steps, root, name):
    """The device's idle share over `steps` calls of fn(i), each in a
    `train_step i` span, read as phase 15 reads a trainer's trace."""
    from torch.profiler import record_function

    from gvcnn_tf_tpu_torch.utils import profile_trace

    torch.cuda.synchronize()
    with profile_trace(str(root), name, device="cuda"):
        for i in range(steps):
            with record_function(f"train_step {i}"):
                fn(i)
    return read_trace(root / name)


def _nearest_rank(lats, p):
    lats = sorted(lats)
    return lats[min(max(-(-p * len(lats) // 100) - 1, 0), len(lats) - 1)]


def _compiled_steps(card, dev, root):
    """Phase 19 (a) and (d)."""
    import dataclasses

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.tools.measure import cuda_samples, release_memory
    from gvcnn_tf_tpu_torch.train import (
        compile_train_step,
        create_train_state,
        train_step,
    )

    base = get_config("mn40_12view")
    d = base.data
    plain = base.replace(data=dataclasses.replace(d, transfer_dtype="uint8"))
    flip = base.replace(
        data=dataclasses.replace(d, loader="decoded", augment=True,
                                 device_flip=True, transfer_dtype="uint8"),
        train=dataclasses.replace(base.train, accumulate_steps=2),
        remat_until=REMAT_UNTIL)
    g = torch.Generator(device=dev).manual_seed(19)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.uint8)

    def labels(n):
        return torch.randint(0, d.num_classes, (n,), generator=g, device=dev)

    shape = (d.num_views, d.height, d.width, 3)
    warm = create_train_state(plain, dev)
    for _ in range(COMPILED_WARM):
        train_step(warm, {"views": u8(8, *shape), "label": labels(8)}, plain)
    split = {"views": u8(COMPILED_SPLIT, *shape),
             "label": labels(COMPILED_SPLIT)}
    out = {}
    # (bf16 K2, fp32 K2, K1) a step: K2 once a microbatch, twice under
    # remat_until (its recompute); the BatchNorm kernels (stats, apply,
    # bwd_reduce, bwd_elemt) once a BatchNorm a microbatch, the recompute's
    # forwards again.
    n_bn = BN_LAYERS["mn40_12view"]
    for variant, cfg, launches, bn_launches in (
            ("uint8_dropout", plain, (1, 0, 1), (n_bn,) * 4),
            ("resident_flip_acc2_remat", flip, (4, 0, 2),
             (2 * (n_bn + REMAT_BATCH_NORMS),) * 2 + (2 * n_bn,) * 2)):
        # The variant's models (remat is built in), each run reloading
        # `warm`.
        states = {k: create_train_state(cfg, dev)
                  for k in ("eager", "again", "compiled", "ref")}
        for b in COMPILED_B:
            cfg_b = cfg.replace(data=dataclasses.replace(cfg.data,
                                                         batch_size=b))
            if variant == "uint8_dropout":
                batches = [{"views": u8(b, *shape), "label": labels(b)}
                           for _ in range(COMPILED_STEPS)]
            else:
                batches = [dict(split, idx=torch.randperm(
                    COMPILED_SPLIT, generator=g, device=dev)[:b])
                    for _ in range(COMPILED_STEPS)]
            what = f"{variant} B={b}"
            eager = _run_steps(train_step, _load_state(states["eager"], warm),
                               batches, cfg_b)
            again = _run_steps(train_step, _load_state(states["again"], warm),
                               batches, cfg_b)
            state = _load_state(states["compiled"], warm)
            step = compile_train_step(state, cfg_b, batches[0])
            # The graph's pool: what the capture reserved and keeps.
            release_memory(dev)
            reserved = torch.cuda.memory_reserved(dev)
            compiled = _run_steps(step, state, batches, cfg_b)
            release_memory(dev)
            pool_gb = (torch.cuda.memory_reserved(dev) - reserved) / 1e9
            spread, diff = _hold_spread(what, eager, again, compiled)
            if not compiled[2] == eager[2] == launches:
                raise AssertionError(f"{what}: launches a step (bf16 stem, "
                                     f"fp32 stem, grouping) {compiled[2]}, "
                                     f"eager {eager[2]}, want {launches}")
            if not compiled[3] == eager[3] == COMPILED_POOL_LAUNCHES[variant]:
                raise AssertionError(
                    f"{what}: max-pool launches a step (forward, backward) "
                    f"{compiled[3]}, eager {eager[3]}, want "
                    f"{COMPILED_POOL_LAUNCHES[variant]}")
            if not compiled[4] == eager[4] == bn_launches:
                raise AssertionError(
                    f"{what}: BatchNorm launches a step (stats, apply, "
                    f"bwd_reduce, bwd_elemt) {compiled[4]}, eager "
                    f"{eager[4]}, want {bn_launches}")
            if (step.graph.captures, step.graph.replays) != (
                    1, COMPILED_STEPS - 1):
                raise AssertionError(f"{what}: {step.graph.captures} "
                                     f"captures, {step.graph.replays} "
                                     "replays")
            ref = _load_state(states["ref"], warm)
            fns = {"eager": lambda: train_step(ref, batches[0], cfg_b),
                   "compiled": lambda: step(state, batches[0], cfg_b)}
            times = {"eager": [], "compiled": []}
            for k in ("eager", "compiled", "compiled", "eager"):
                times[k] += cuda_samples(fns[k], runs=COMPILED_RUNS,
                                         warmup=2)
            ms = {k: statistics.median(v) for k, v in times.items()}
            idle, above = {}, {}
            for k in ("eager", "compiled"):
                tr = _profiled_idle(lambda i: fns[k](), COMPILED_WINDOW,
                                    root, f"{variant}_{b}_{k}.json")
                idle[k] = tr["idle"]
                # What a step allocates above what was resident: an eager
                # step's activations; a replay's live in the graph's pool.
                release_memory(dev)
                resident = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                for _ in range(2):
                    fns[k]()
                torch.cuda.synchronize(dev)
                above[k] = (torch.cuda.max_memory_allocated(dev)
                            - resident) / 1e9
            log(f"{what}: step {ms['eager']:.3f} ms eager, "
                f"{ms['compiled']:.3f} ms compiled (CUDA events, median of "
                f"{2 * COMPILED_RUNS} in turns); device idle "
                f"{idle['eager']:.1%} eager, {idle['compiled']:.1%} compiled "
                f"(a profiled window of {COMPILED_WINDOW} steps); memory: "
                f"an eager step's peak {above['eager']:.3f} GB above what "
                f"was resident, the graph's pool {pool_gb:.3f} GB reserved "
                f"between steps (a replay's peak above resident "
                f"{above['compiled']:.3f} GB); launches a step "
                f"{compiled[2]}, max pool (forward, backward) {compiled[3]}, "
                f"BatchNorm {compiled[4]} [{card}]")
            out[what] = dict(spread=spread, diff=diff, launches=compiled[2],
                             pool_launches=compiled[3],
                             bn_launches=compiled[4],
                             eager_ms=ms["eager"],
                             compiled_ms=ms["compiled"],
                             eager_idle=idle["eager"],
                             compiled_idle=idle["compiled"],
                             eager_step_gb=above["eager"],
                             compiled_step_gb=above["compiled"],
                             graph_pool_gb=pool_gb)
            step.close()
            del eager, again, compiled, step, fns, batches
            release_memory(dev)
        del states
    del warm
    release_memory(dev)

    # (d) The other families: the warm-up, a capture and its replay, one
    # more replay, against the eager step.
    for name, want in COMPILED_FAMILIES.items():
        fcfg = get_config(name)
        fcfg = fcfg.replace(data=dataclasses.replace(
            fcfg.data, batch_size=FAMILY_B, transfer_dtype="uint8"))
        fd = fcfg.data
        batches = [{"views": u8(FAMILY_B, fd.num_views, fd.height, fd.width,
                                3), "label": torch.randint(
                        0, fd.num_classes, (FAMILY_B,), generator=g,
                        device=dev)} for _ in range(3)]
        # Two seeded states: `state` stays at init until the compiled run.
        other, state = (create_train_state(fcfg, dev) for _ in range(2))
        eager = _run_steps(train_step, other, batches, fcfg)
        again = _run_steps(train_step, _load_state(other, state), batches,
                           fcfg)
        step = compile_train_step(state, fcfg, batches[0])
        compiled = _run_steps(step, state, batches, fcfg)
        spread, diff = _hold_spread(f"{name} B={FAMILY_B}", eager, again,
                                    compiled)
        if compiled[2] != eager[2] or compiled[2] != want:
            raise AssertionError(f"{name}: launches a step {compiled[2]}, "
                                 f"eager {eager[2]}, want {want}")
        if not compiled[3] == eager[3] == COMPILED_POOL_LAUNCHES[name]:
            raise AssertionError(f"{name}: max-pool launches a step "
                                 f"{compiled[3]}, eager {eager[3]}, want "
                                 f"{COMPILED_POOL_LAUNCHES[name]}")
        if not compiled[4] == eager[4] == (BN_LAYERS[name],) * 4:
            raise AssertionError(f"{name}: BatchNorm launches a step "
                                 f"{compiled[4]}, eager {eager[4]}, want "
                                 f"{BN_LAYERS[name]} each")
        out[name] = dict(spread=spread, diff=diff, launches=compiled[2],
                         pool_launches=compiled[3], bn_launches=compiled[4],
                         replays=step.graph.replays)
        step.close()
        del eager, again, compiled, state, step, other
        release_memory(dev)
    return out


def _compiled_serving(card, dev):
    """Phase 19 (b)."""
    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.serve import InferenceEngine, serve
    from gvcnn_tf_tpu_torch.utils import graphs, normalize_views

    cfg = get_config("mn40_12view")
    d = cfg.data
    rs = np.random.RandomState(19)
    shape = (d.num_views, d.height, d.width, 3)
    httpd, thread, engine = serve(cfg, port=0, serve_batch_size=8,
                                  block=False, device="cuda")
    real = graphs.capturable
    graphs.capturable = lambda device: False
    try:
        eager = InferenceEngine(cfg, serve_batch_size=8, device="cuda")
    finally:
        graphs.capturable = real
    out = {}
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/predict"
        _zero_counts()
        for n in (1, 8):
            views = rs.randint(0, 256, (n,) + shape).astype(np.uint8)
            logits, scores = engine.logits_and_scores(views)

            def by_hand():
                with torch.inference_mode():
                    y, ep = engine.model(normalize_views(
                        torch.from_numpy(views).to(dev)))
                    return (y.cpu().numpy(),
                            ep["view_discrimination_scores"].cpu().numpy())

            want = engine._device_thread.submit(by_hand).result()
            same = (np.array_equal(logits, want[0])
                    and np.array_equal(scores, want[1])
                    and np.array_equal(eager.logits_and_scores(views)[0],
                                       want[0]))
            g = engine.graphs[(n, np.dtype(np.uint8))]
            lat = {"engine": [], "eager_engine": [], "http": []}
            for i in range(SERVE_SAMPLES):
                for k, fn in (("engine", lambda: engine.predict(views)),
                              ("eager_engine", lambda: eager.predict(views)),
                              ("http", lambda: _post(url, views))):
                    if k == "eager_engine" and i % EAGER_SERVE_EVERY:
                        continue
                    t = time.perf_counter()
                    fn()
                    lat[k].append((time.perf_counter() - t) * 1e3)
            row = {f"{k}_{p}": _nearest_rank(v, q) for k, v in lat.items()
                   for p, q in (("p50", 50), ("p99", 99))}
            out[f"B={n}"] = dict(row, replay_equals_eager=same,
                                 replays=g.replays)
            log(f"serving B={n}: the replayed forward equals the eager one "
                f"bit for bit: {same}; over {SERVE_SAMPLES} uint8 requests "
                f"p50 / p99 ms: engine {row['engine_p50']:.3f} / "
                f"{row['engine_p99']:.3f} (graph replayed {g.replays} "
                f"times), eager engine (every {EAGER_SERVE_EVERY}th turn) "
                f"{row['eager_engine_p50']:.3f} / "
                f"{row['eager_engine_p99']:.3f}, HTTP "
                f"{row['http_p50']:.3f} / {row['http_p99']:.3f} [{card}]")
            if not same:
                raise AssertionError(f"serving B={n}: the replay is not the "
                                     "eager forward")
        out["bn_launches"] = _bn_counts()
        if any(out["bn_launches"]):
            raise AssertionError(f"serving: train-mode BatchNorm launches "
                                 f"{out['bn_launches']}, want none")
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
        eager.close()
        thread.join(timeout=60)
    return out


def _compiled_eval(card, dev, root):
    """Phase 19 (c)."""
    import dataclasses

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch import eval as eval_mod
    from gvcnn_tf_tpu_torch.data import make_dataset
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms
    from gvcnn_tf_tpu_torch.train import create_train_state
    from gvcnn_tf_tpu_torch.utils import graphs

    base = get_config("mn40_12view")
    cfg = base.replace(data=dataclasses.replace(
        base.data, dataset="procedural", transfer_dtype="uint8",
        synthetic_num_shapes=PROC_SHAPES, device_resident="off"),
        train=dataclasses.replace(base.train, train_logdir=str(root)))
    d = cfg.data
    state = create_train_state(cfg, dev)
    val = list(make_dataset(d, train=False, seed=cfg.train.seed,
                            num_epochs=1))
    runs, walls = {}, {"compiled": [], "eager": []}
    real = graphs.capturable
    _zero_counts()
    for k in ("compiled", "eager", "compiled", "eager"):
        graphs.capturable = (real if k == "compiled"
                             else (lambda device: False))
        try:
            with eval_mod.recorded_logits() as seen:
                t = time.perf_counter()
                res = eval_mod.evaluate(cfg, state=state,
                                        dataset_iter=iter(val))
                walls[k].append(time.perf_counter() - t)
        finally:
            graphs.capturable = real
        runs.setdefault(k, (res, torch.cat(seen)))
    bn_launches = _bn_counts()
    if any(bn_launches):
        raise AssertionError(f"eval: train-mode BatchNorm launches "
                             f"{bn_launches}, want none")
    (got, got_logits), (want, want_logits) = runs["compiled"], runs["eager"]
    same = got == want and torch.equal(got_logits, want_logits)
    [g] = eval_mod._GRAPHS[state.model].values()
    views = PROC_SHAPES * d.num_views
    padded = []
    for batch in val:
        v, lab = batch["views"], batch["label"]
        n = d.batch_size - len(v)
        padded.append({
            "views": torch.from_numpy(np.concatenate(
                [v, np.zeros((n,) + v.shape[1:], v.dtype)])).to(dev),
            "label": torch.from_numpy(np.concatenate(
                [lab, np.zeros(n, lab.dtype)])).to(dev, torch.int64)})
    model = state.model.eval()
    with torch.no_grad():
        dev_ms = {
            "compiled": cuda_ms(lambda: [g(**b) for b in padded], runs=10,
                                warmup=2),
            "eager": cuda_ms(lambda: [eval_mod._scores(model, b["views"],
                                                       b["label"])
                                      for b in padded], runs=10, warmup=2)}
    state.model.train()
    row = dict(counts_equal=got == want, logits_equal=same, result=got,
               replays=g.replays, bn_launches=bn_launches,
               **{f"{k}_views_per_s": views / min(v) for k, v in
                  walls.items()},
               **{f"{k}_device_views_per_s": views / v * 1e3 for k, v in
                  dev_ms.items()})
    log(f"eval of the {PROC_SHAPES}-shape procedural split ({len(val)} "
        f"padded batches of {d.batch_size}): compiled {got}, eager {want}, "
        f"logits bit-equal {same}; end to end (host clock, best of 2) "
        f"{row['compiled_views_per_s']:.1f} views/s compiled, "
        f"{row['eager_views_per_s']:.1f} eager; the forwards on the card "
        f"(CUDA events, median of 10) {dev_ms['compiled']:.3f} ms "
        f"({row['compiled_device_views_per_s']:.1f} views/s) compiled, "
        f"{dev_ms['eager']:.3f} ms ({row['eager_device_views_per_s']:.1f}) "
        f"eager [{card}]")
    if not same or got["count"] != PROC_SHAPES:
        raise AssertionError("eval: the compiled forward scores otherwise "
                             "than the eager one")
    return row


def phase_compiled(card, dev):
    """Phase 19 (see the module docstring)."""
    import shutil
    from pathlib import Path

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_compiled"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    steps = _compiled_steps(card, dev, root)
    serving = _compiled_serving(card, dev)
    ev = _compiled_eval(card, dev, root)
    shutil.rmtree(root, ignore_errors=True)
    return dict(steps=steps, serving=serving, eval=ev,
                seconds=time.perf_counter() - t0)


def check_train_drift(drift):
    """Print the card-vs-CPU train step readings (`train_step_drift`) and
    raise unless each is inside its bound."""
    log(f"B=2 train step, card (bf16) vs CPU (fp32): loss {drift['loss']:.6g}"
        f" vs {drift['loss_ref']:.6g} (rel {drift['loss_rel']:.3g}, bound "
        f"{TRAIN_LOSS_REL_TOL}); grad_norm {drift['grad_norm']:.6g} vs "
        f"{drift['grad_norm_ref']:.6g} (rel {drift['grad_norm_rel']:.3g}, "
        f"bound {TRAIN_GNORM_REL_TOL}); Logits gradient cosine "
        f"{drift['logits_grad_cosine']:.5f} (bound {TRAIN_LOGITS_COS_MIN}); "
        f"all gradients' cosine {drift['grad_cosine']:.4f} (held > 0); worst "
        f"layer's gradient-norm |ln ratio| {drift['layer_logratio']:.4f} "
        f"({drift['layer_worst']}, bound {TRAIN_LAYER_LOGRATIO_MAX}); "
        f"least gradient held {drift['layer_min_rel']:.3g} of the norm; left "
        f"out as rounding noise (< {drift['noise_max_rel']:.3g}): "
        f"{drift['noise']}")
    group_cos = drift["group_cosines"]
    log("  gradient cosine by group: " + ", ".join(
        f"{k} {v:.4f}" + (f" (bound {TRAIN_GROUP_COS_MIN[k]})"
                          if k in TRAIN_GROUP_COS_MIN else "")
        for k, v in group_cos.items()))
    if not (drift["loss_rel"] <= TRAIN_LOSS_REL_TOL
            and drift["grad_norm_rel"] <= TRAIN_GNORM_REL_TOL
            and drift["logits_grad_cosine"] >= TRAIN_LOGITS_COS_MIN
            and drift["grad_cosine"] > 0
            and drift["layer_logratio"] <= TRAIN_LAYER_LOGRATIO_MAX
            and all(group_cos[k] >= v
                    for k, v in TRAIN_GROUP_COS_MIN.items())):
        raise AssertionError("card and CPU train steps disagree")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # Fails here, before any output, outside a checkout of the repository.
    import gvcnn_tf_tpu_torch  # noqa: F401

    dev = torch.device("cuda", 0)
    seconds, since = {}, [time.perf_counter()]

    def mark(phase):
        """Record the seconds since the previous mark as `phase`'s."""
        now = time.perf_counter()
        seconds[phase] = round(now - since[0], 1)
        since[0] = now

    card = phase_card()
    phase_packages()
    mark(1)
    phase_build()
    mark(2)
    stem = phase_stem(dev)
    mark(3)
    grouping = phase_grouping(dev)
    mark(4)
    launches = phase_slice(card)
    mark(5)
    stem_bwd = phase_stem_backward(dev)
    mark(6)
    grouping_bwd = phase_grouping_backward(dev)
    mark(7)
    tr = phase_train(card, dev)
    mark(8)
    ev = phase_eval(card, dev)
    mark(9)
    stem32 = phase_stem_f32(dev)
    wide = {c: phase_grouping(dev, c) for c in WIDE_C}
    fam = phase_families(card, dev)
    single = fam["mn10_single_view"]
    log("phase 10 summary: " + json.dumps(fam))
    mark(10)
    warm = phase_warm_start(card, dev)
    log("phase 11 summary: " + json.dumps(warm))
    mark(11)
    dp = phase_parallel(card, dev)
    log("phase 12 summary: " + json.dumps(dp))
    mark(12)
    tools = phase_tools(card, dev, ev["logdir"])
    log("phase 13 summary: " + json.dumps(tools))
    mark(13)
    loaders = phase_loaders(card, dev, tr["views_per_s"])
    log("phase 14 summary: " + json.dumps(loaders))
    mark(14)
    resident = phase_resident(card, dev)
    profiled = phase_profiled(card, dev, resident["shapes"])
    mark(15)
    log(f"phase 15 summary ({seconds[15]:.1f} s): "
        + json.dumps({"resident": resident, "profiled": profiled}))
    remat = phase_remat(card, dev)
    log("phase 16 summary: " + json.dumps(remat))
    mark(16)
    analysis = phase_analysis(card, dev)
    log("phase 17 summary: " + json.dumps(analysis))
    mark(17)
    step_tools = phase_step_tools(card, dev)
    log("phase 18 summary: " + json.dumps(step_tools))
    mark(18)
    compiled = phase_compiled(card, dev)
    log("phase 19 summary: " + json.dumps(compiled))
    mark(19)
    pool = phase_pool(dev)
    mark(20)
    avg = phase_avg_pool(dev)
    mark(21)
    bn = phase_batch_norm(dev)
    mark(22)
    join = phase_join(dev)
    mark(23)
    replayed = compiled["steps"]
    log(f"seconds by phase: {json.dumps(seconds)}; {sum(seconds.values()):.1f}"
        " s in all")
    phase_launches = {b: v["launches_per_call"]
                      for b, v in analysis["phases"].items()}
    remat_launches = remat["launches"]
    loader_launches = {k: v["launches"] for k, v in loaders["train"].items()}
    loader_eval = {k: v["launches"] for k, v in loaders["eval"].items()}
    per_fwd = tools["export"]["launches_per_forward"]
    dp_per_step = dp["world2"]["launches_per_step"][0]
    kernels = [
        dict(name="stem_conv7x7s2_bf16", route="cuda",
             source="gvcnn_tf_tpu_torch/csrc/stem_conv.cu",
             replaces="gvcnn_tf_tpu/ops/pallas_stem.py:93",
             launches=launches["stem"],
             launches_per_forward=launches["stem"] / FORWARDS,
             train_launches=tr["launches"]["stem"],
             launches_per_step=tr["per_step"]["stem"],
             eval_launches=ev["eval_launches"]["stem"],
             warm_start_launches=warm["launches"][0],
             dp_launches_per_step=dp_per_step[0],
             dp_world1_launches=dp["world1"]["launches"][0],
             export_launches_per_forward=per_fwd[0],
             loader_train_launches={k: v[0] for k, v in
                                    loader_launches.items()},
             loader_eval_launches={k: v[0] for k, v in loader_eval.items()},
             resident_launches_per_step=resident["launches_per_step"][0],
             profiled_window_events=profiled["stem_events"],
             remat_launches_per_step={k: v[0] for k, v in
                                      remat_launches.items()},
             bench_layers_launches=analysis["layer_launches"][0],
             bench_layers_launches_per_call={
                 r["endpoint"]: r["k2_launches"]
                 for r in analysis["layers"]},
             bench_phases_launches_per_call={
                 b: {k: v.get("stem_conv7x7s2_bf16", 0)
                     for k, v in calls.items()}
                 for b, calls in phase_launches.items()},
             step_tools_launches=step_tools["launches"][0],
             profile_step_launches_per_step=step_tools["profile"][
                 "launches_per_step"].get("stem_conv7x7s2_bf16", 0),
             compiled_launches_per_step={
                 k: v["launches"][0] for k, v in replayed.items()},
             **stem, **stem_bwd),
        dict(name="group_and_fuse_f32", route="cuda",
             source="gvcnn_tf_tpu_torch/csrc/grouping.cu",
             replaces="gvcnn_tf_tpu/ops/pallas_grouping.py:80",
             launches=launches["grouping"],
             launches_per_forward=launches["grouping"] / FORWARDS,
             train_launches=tr["launches"]["grouping"],
             launches_per_step=tr["per_step"]["grouping"],
             eval_launches=ev["eval_launches"]["grouping"],
             warm_start_launches=warm["launches"][2],
             dp_launches_per_step=dp_per_step[2],
             dp_world1_launches=dp["world1"]["launches"][2],
             export_launches_per_forward=per_fwd[2],
             loader_train_launches={k: v[2] for k, v in
                                    loader_launches.items()},
             loader_eval_launches={k: v[2] for k, v in loader_eval.items()},
             resident_launches_per_step=resident["launches_per_step"][1],
             profiled_window_events=profiled["grouping_events"],
             remat_launches_per_step={k: v[2] for k, v in
                                      remat_launches.items()},
             bench_phases_launches_per_call={
                 b: {k: v.get("group_and_fuse_f32", 0)
                     for k, v in calls.items()}
                 for b, calls in phase_launches.items()},
             step_tools_launches=step_tools["launches"][2],
             profile_step_launches_per_step=step_tools["profile"][
                 "launches_per_step"].get("group_and_fuse_f32", 0),
             compiled_launches_per_step={
                 k: v["launches"][2] for k, v in replayed.items()},
             backward_library_ms=None,
             wide_c={str(c): {k: v for k, v in t.items()
                              if k not in ("library_ms", "max_abs_err")}
                     for c, t in wide.items()},
             wide_c_max_abs_err=max(t["max_abs_err"] for t in wide.values()),
             family_launches_per_step={
                 k: v["step_launches"][2] for k, v in fam.items()
                 if "step_launches" in v},
             **grouping, **grouping_bwd),
        dict(name="stem_conv7x7s2_f32", route="cuda",
             source="gvcnn_tf_tpu_torch/csrc/stem_conv.cu",
             replaces="gvcnn_tf_tpu/ops/pallas_stem.py:93",
             launches=single["serve_launches"][1],
             launches_per_forward=FAMILY_LAUNCHES["mn10_single_view"][1],
             launches_per_step=single["step_launches"][1],
             dp_launches_per_step=dp_per_step[1],
             step_tools_launches=step_tools["launches"][1],
             compiled_launches_per_step=replayed["mn10_single_view"][
                 "launches"][1], **stem32),
        dict(name="max_pool_same_bf16", route="cuda",
             source="gvcnn_tf_tpu_torch/csrc/max_pool.cu",
             replaces=None,
             compiled_launches_per_step={
                 k: v["pool_launches"] for k, v in replayed.items()},
             autograd_b32=pool["autograd"],
             inception_b32=pool["inception"], resnet50_b32=pool["resnet50"]),
        dict(name="avg_pool_same_bf16", route="cuda",
             source="gvcnn_tf_tpu_torch/csrc/avg_pool.cu", replaces=None,
             serve_launches={k: v["serve_avg_launches"] for k, v in
                             fam.items() if "serve_avg_launches" in v},
             family_launches_per_step={
                 k: v["step_avg_launches"] for k, v in fam.items()
                 if "step_avg_launches" in v},
             backbone_launches_per_forward={
                 k: v["avg_launches"] for k, v in fam.items()
                 if "avg_launches" in v},
             autograd_b32=avg["autograd"],
             inception_v4_b32=avg["inception_v4"]),
        dict(name="batch_norm_bf16", route="cuda",
             source="gvcnn_tf_tpu_torch/csrc/batch_norm.cu", replaces=None,
             serve_launches={k: v["serve_bn_launches"] for k, v in
                             fam.items() if "serve_bn_launches" in v},
             family_launches_per_step={
                 k: v["step_bn_launches"] for k, v in fam.items()
                 if "step_bn_launches" in v},
             backbone_launches_per_forward={
                 k: v["bn_launches"] for k, v in fam.items()
                 if "bn_launches" in v},
             compiled_launches_per_step={
                 k: v["bn_launches"] for k, v in replayed.items()},
             compiled_serve_launches=compiled["serving"]["bn_launches"],
             compiled_eval_launches=compiled["eval"]["bn_launches"],
             step_b32=bn),
        dict(name="residual_join_bf16", route="cuda",
             source="gvcnn_tf_tpu_torch/csrc/residual_join.cu",
             replaces=None,
             serve_launches={k: v["serve_join_launches"] for k, v in
                             fam.items() if "serve_join_launches" in v},
             family_launches_per_step={
                 k: v["step_join_launches"] for k, v in fam.items()
                 if "step_join_launches" in v},
             backbone_launches_per_forward={
                 k: v["join_launches"] for k, v in fam.items()
                 if "join_launches" in v},
             launches=join["launches"], checks=join["checks"],
             worst_dbias_gap=join["worst_dbias_gap"],
             by_shape=join["by_shape"], step_b32=join["step_b32"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
