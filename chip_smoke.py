#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
nvidia-smi. It imports the port (``semi_seg_ecg_tpu_torch``) and nothing of
JAX or of the JAX package. Phases, each of which stops the script with a
non-zero exit when it fails:

1. build every CUDA kernel of the ported paths from ``csrc/`` (one nvcc per
   source, all started together), print the build time and the compiler's
   register report, and count each flash kernel's tensor-core (HMMA)
   instructions in its SASS: every flash kernel must have some (bf16
   m16n8k16, and TF32 m16n8k8 for the 3xTF32 fp32 kernels);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving and training paths give it (q, k, v contiguous and
   as the ViT hands them over) and at long and ragged shapes, in both
   dtypes: fp32 flash within atol (+ rtol) of the plain version, bf16
   within its error bound; time kernel, plain version and the one-call
   PyTorch equivalent, and compute the card's bound for the same work;
3. serve the full-width ``vit_tiny`` + FCNHead recipe
   (``configs/base/vit_tiny/scratch.yaml``, ``attention_impl: flash``) on a
   synthetic test split through ``inference_main``, at fp32 and under bf16
   autocast, with launch counters zeroed just before and read just after;
   check the probabilities, and hold the fp32 outputs against the dense
   attention path on the card and against the plain path on the CPU;
4. train the full-width ``vit_tiny`` FixMatch recipe
   (``configs/base/vit_tiny/fixmatch.yaml`` with ``attention_impl: flash``
   and ``device_augment: true``, bf16, batch 16) through ``train_main`` on a
   synthetic split for two epochs, with the launch counters zeroed just
   before and read just after and held to the counts the code implies;
   serve the trained checkpoint; hold the flash path's gradients and three
   fp32 FixMatch steps against the dense path on the card, and the card's
   augmentation against the CPU's on the same draws; profile one bf16 and
   one fp32 train step (device events, copy and elementwise kernels);
5. ResNet18 at full width (``configs/base/resnet18/*.yaml``: stem and base
   64, four stages, FCN head 512 -> 128): serve the scratch recipe with
   seed-0 weights through ``inference_main`` (fp32 against the CPU, bf16
   autocast against fp32, the phase-3 profile columns); train the FixMatch
   recipe with ``device_augment: true`` through ``train_main`` (3 gather
   launches per step, no flash), serve its checkpoint, hold three fp32
   steps on the card against the CPU, profile a bf16 and an fp32 step; the
   stem pool's gradient on a tie-heavy input equal to the CPU's bit for
   bit;
6. Mean Teacher and CPS: ``train_main`` on
   ``configs/base/{vit_tiny,resnet18}/{mean_teacher,cps}.yaml`` (flash
   attention for the ViT, ``device_augment: true``) with exact launch
   counts, the teacher or the peer in the checkpoint, and the trained
   checkpoint served;
7. ReCo and ST++: ``train_main`` on
   ``configs/base/{vit_tiny,resnet18}/{reco,stpp}.yaml`` as in phase 6, with
   exact launch counts (ST++: per stage and in the ranking pass), ST++'s
   stage files, the teacher in the checkpoint and the checkpoint served;
   the ReCo loss at the recipe's shape: one call with host syncs raising,
   the card's loss core on the CPU's indices against the CPU (value and
   latent gradient within 1e-5 relative), the card's own sampler against
   the CPU's on the same draws, its time; a profile of a ViT ReCo bf16
   step;
8. long-record serving through ``infer-longrec`` (``infer_longrec_main``)
   with phase 4's ViT checkpoint (flash attention) and phase 5's ResNet18,
   on synthetic records at 250 Hz, windows of 2,500 at hop 1,250, 64 a
   batch: 1 hour at fp32 and under bf16 autocast (ViT) and at fp32
   (ResNet18), each held to its exact launches (12 flash forwards per ViT
   batch), its probabilities, labels and files, and to sensitivity 1.0
   when ``--eval-labels`` scores it against its own labels; 2 minutes on
   the card against the CPU; the single-cover identity (hop = window, flat
   taper); 8 live streams of 10 minutes through ``StreamingSegmenter``
   against the offline stitcher; a 6-hour record per model with its
   throughput, the filter chain's host time and peak device memory; a
   profile of one hour;
9. the serving deployment: ``export_serving`` (``torch.export``, the flash
   forward as the PyTorch operator) of phase 4's trained ViT and phase 5's
   ResNet18 with a symbolic batch, no launch while tracing, ``load_serving``
   at batches 1, 16, 37 and 64 with ``DEPTH`` flash forwards a ViT call,
   within 1e-5 of ``ServingFn``; a pinned batch that refuses another; a
   bf16 autocast artifact that says so and agrees with fp32 on >= 90% of
   the argmaxes; int8, the ViT with dynamic and ResNet18 with calibrated
   scales (card against the CPU, int8 against fp32 by the JAX package's rule, no
   activation reduction in a calibrated call, one per int8 layer in a
   dynamic one); ``make_http_server`` (metadata, a POST of 37 rows within
   1e-6 of the artifact, 400 on a wrong shape, round trips); the 1 h record
   under int8; windows/s, busy, idle share, events and top kernel of
   ``ServingFn`` and each artifact at batches 16 and 64;
10. data-parallel training through the port's own path (``parallel/``,
   ``train_main`` under a process group), two ranks: over NCCL on two
   cards (``torch.distributed.run``) where there are two, else over gloo
   with CUDA tensors on one card (two rank processes this script starts,
   ``chip_smoke.py --rank``; NCCL refuses two ranks on one device).
   Three fp32 FixMatch steps of each backbone (ViT with flash attention,
   device augmentation, SGD with momentum), 2 ranks x 8 rows against one
   process holding both shards on the card: losses within 1e-5 relative,
   parameters and BN statistics within 5e-4 relative + 1e-5, exact
   launches per rank per step; ``train_main`` for one bf16 epoch of the
   ViT FixMatch, CPS and ReCo recipes: each rank's launches, finite
   losses, files from rank 0 only, the checkpoint served, the sharded
   validation metrics equal to one process's evaluation of it; ST++'s
   ranking under 2 ranks equal to one process's; with NCCL, the bf16 step's
   ms and its collectives' device time;
11. remat, layer decay and freezing, convergence. Three fp32 FixMatch
   steps of the full-width ViT (flash attention, device augmentation,
   dropout and drop-path on) and ResNet18 recipes with ``remat`` off and
   on: launches per step (the recompute adds a flash forward per block:
   36 / 12 / 3 against 24 / 12 / 3), ms per step and peak memory; under
   deterministic algorithms (switched on and off in this process, as
   phase 18 does) remat on equal to off bit for bit (losses, gradients, parameters, BatchNorm
   statistics), a second off run too. Three bf16 steps with
   ``layer_decay: 0.75`` and ``frozen_stages: 2`` (ViT) and with
   ``mode: freeze_backbone`` and ``frozen_stages: 1`` (ResNet18): frozen
   parameters and the eval-mode stages' BatchNorm statistics
   bit-unchanged and in no param group, every group's lr the schedule's
   times its scale, AdamW's last update replayed from its state.
   ``tools/validate_ssl``'s base and FixMatch at seed 0 (bf16, 25 epochs):
   fails when FixMatch lies outside its tolerance of the JAX row;
12. gradient accumulation, resume and the trace schedule on the
   full-width ``vit_tiny`` FixMatch recipe (flash attention, device
   augmentation, bf16) at micro-batch 8 with ``accum_iter: 2`` on a split
   of 3 micro-steps an epoch, so that a window spans the first epoch's
   end: (a) 2 epochs through ``run_training`` with exact launches (24 /
   12 / 3 a micro-step, 12 forwards an eval batch), 3 updates, the open
   window in the first epoch's snapshot, the logged lr of update
   ``global_step // 2``, and a Mean Teacher teacher that moves on the
   window's last micro-step only; (b) under deterministic algorithms,
   the same run and a second
   resumed from its first snapshot through ``--resume``: the resumed
   epoch's ``log.txt`` row and last snapshot (model, optimizer, open
   window, step, best) equal the straight run's bit for bit, with its
   launches; (c) four accumulated fp32 micro-steps, flash against the
   dense path, within phase 4's bounds; (d) ``profile`` on steps 2-3 of a
   4-micro-step ``train_main``: one trace file holding exactly those
   steps' ranges and their kernel events of the three kernels; (e) one
   window on phase 10's two ranks against one process holding both
   shards, one gradient all-reduce a rank; the micro-step's wall time at
   ``accum_iter`` 1 and 2, in turns;
13. the remaining device-augment ops, the device cache and ZeRO-1: (a)
   each op ported after the shipped chains' (flips, drop, cutout, shift,
   baseline shift, the whole-window noises, RandomApply) and each level
   override on the card against the CPU under the same draws (signals
   within 1e-5, labels exact, the gather launched once by shift, never by
   the others); (b) phase 4's FixMatch recipe with the weak chain
   [resize-crop, RandomApply(RandomShift)] and an 8-op strong RandAugment
   of new ops through ``train_main``, 24 / 12 / 6 launches a step; (c)
   the same run with ``device_cache: true``, both under deterministic
   algorithms: losses and the final
   model bit for bit, index batches, the traced steps' host-to-device
   copies (none larger than an index batch), the cache's bytes and the
   step's wall time both ways; (d) ZeRO-1 against the replicated
   optimizer on phase 10's two ranks under deterministic algorithms, 3
   fp32 steps of FixMatch (SGD with momentum) and CPS (AdamW, the peer's
   optimizer too): networks, losses and the gathered optimizer state,
   each rank's optimizer bytes (at most 0.6 of the replicated) and peak
   memory, and each run's checkpoint resumed in one unsharded process for
   a fourth step, the ZeRO-1 one against the replicated one;
14. tensor parallelism (``parallel.model_parallel``) and ``mesh=`` long
   records, on phase 10's rank layout (NCCL where the cards cover the
   ranks, else gloo with CUDA tensors on one card): (a) three fp32
   FixMatch steps of the full-width ViT (flash, device augmentation, SGD
   with momentum, 16 + 16 windows) at ``(data 1, model 3)`` (one head a
   rank) and ``(2, 2)`` (attention whole, MLP sliced) against one process
   on the global batch within phase 10's bounds, the ranks' gathered
   states equal, 24 / 12 / 3 launches a rank a step, rank 0's gathered
   checkpoint in one process's layout key for key; (b) ``train_main`` of
   the bf16 recipe at ``(1, 3)``, 2 epochs of 4 steps on phase 4's split
   (228 / 96 / 24 launches a rank), its checkpoint served on the ranks
   and in one process within 1e-4; (c) each rank's parameter and
   optimizer bytes and peak memory against one process, and its bf16
   step's ms, device events and all-reduce time (host ranges of the
   step's own trace; on one card at ``(2, 2)`` only); (d) phase 8's 1 h record through
   ``long_record_inference(mesh=)`` and 8 two-minute streams through
   ``StreamingSegmenter(mesh=)`` on the ``(2, 2)`` ranks (2 data ranks of
   2 model ranks, the serving model's MLP sliced), each against one
   process within 1e-5 (12 flash forwards a batch, half the batches a
   data rank); on one card both rank groups run at once. The log's last
   phase-14 line splits its seconds;
15. sequence parallelism (``parallel.seq_parallel``): (a) ring attention
   through the flash kernels (``ops/ring_attention.py``, the seq ranks as
   threads of this process) against the plain ring, forward and
   gradients, at (16, 3, 101, 64) over 2 ranks and (2, 3, 2049, 64) over
   2 and 4, in fp32 (``FWD_TOL_FP32``, ``BWD_TOL_FP32``) and bf16
   (``ring_forward_error_bound``, ``ring_backward_error_bound``), and one
   hop of each timed (kernel, plain, SDPA at the same query and key
   counts, bound); then two rank groups at once on phase 10's layout
   (gloo on one card, NCCL where the cards cover the ranks): (b) three
   fp32 FixMatch steps of the full-width ViT (the ring) and ResNet18
   with the head's dropout on, at ``(data 1, seq 2)`` and ``(2, 2)``,
   against one process on the global batch within phase 10's bounds, the
   ranks' states equal, 48 / 24 / 0 launches a ViT rank a step; (c)
   ``train_main`` of the bf16 ViT recipe at ``(1, 2)`` (device
   augmentation switched off as the JAX package does) with its exact
   launches, its checkpoint served at fp32 on the ranks against one
   process within 1e-4; (d) one fp32 base step of ResNet18 at 2^17
   samples and of a vit_tiny of 2,049 tokens on a rank against one
   process: activation memory, ms;
16. every algorithm and option on every ``(data, seq, model)`` mesh: (a)
   the kernel ring on one head a model rank, (16, 1, 101, 64) and
   (2, 1, 2049, 64) over 2 seq ranks in fp32 and bf16, against the plain
   ring, a hop of each timed as in phase 15; then three rank groups at
   once (gloo on one card, NCCL where the cards cover the ranks): (b) at
   ``(data 1, seq 2)`` three fp32 ReCo steps of each backbone (its loss's
   inputs gathered over the seq ranks, its contrastive term live) against
   one process within phase 10's bounds, both sides under PyTorch's
   deterministic algorithms (one process's two runs equal bit for bit),
   ST++'s ranking of phase 4's
   unlabeled split by three ViT snapshots against one process's, and an
   int8 serving batch of each backbone, dynamic and calibrated; (c) at
   ``(1, 2, 3)`` three fp32 FixMatch steps of the ViT (the ring on a model
   rank's one head) and an int8 ViT batch with its heads over the model
   axis (``(data 2, model 3)``, each data rank serving the whole batch),
   dynamic and calibrated; (d) at ``(1, 2, 2)`` three fp32 FixMatch steps
   of ResNet18. Every rank's launches a step or a batch are held to the
   code's count; every int8 layer's codes, joined over the ranks, to one
   process's, and the probabilities within 1e-5 (the ViT under seq: the
   codes up to the first attention output, whose ring rounds apart from
   the flash kernel, and then phase 9's int8 rule).

17. the checkpoint writer, the directory backend, the rest of serving: (a)
   phase 4's ViT FixMatch recipe through ``train_main`` with
   ``async_checkpoint`` on (the default) and off, each with the epoch
   loop's wall time, its launches (phase 4's) and rank 0's blocked ms per
   save, and a third run whose every save also writes the same call
   synchronously beside it: each file equal to its synchronous twin byte
   for byte; (b) ``checkpoint_backend: orbax``: after one fp32 step, every
   rank writes the directory (``torch.distributed.checkpoint``) and rank 0
   the pickle file, at data 2 with ZeRO-1 (a task on phase 13's ZeRO-1
   group) and at ``(1, 3)`` (a task on phase 14's ``(1, 3)`` group): no
   ``all_gather_object`` on the directory's path, each rank's bytes
   against the pickle file's, the directory loaded in one process equal
   to the pickle file's payload, and a one-process resume from each equal
   bit for bit; (c) a ``("cuda", "cpu")`` artifact of phase 4's ViT: its
   CUDA program (the process's platform) 12 flash launches a call and
   equal to phase 9's one-platform artifact, its CPU program within 1e-5
   of ``ServingFn`` on the CPU with no launch; (d) ``torch.library.opcheck``'s
   default checks of the flash forward and backward operators on CUDA
   tensors, fp32 and bf16;
18. ``train.scan_steps``, the step captured in a CUDA graph and replayed
   (``utils/captured_step.py``): under PyTorch's deterministic
   algorithms, so that a step repeats bit for bit, (a) phase 4's
   ViT FixMatch recipe at full width, 8 bf16 steps at ``scan_steps: 4``
   and 3 fp32 steps, each eager, eager with the captured path's
   optimizers, and captured: the launches of one replay read from the
   graph's kernel nodes (24 / 12 / 3), the host counters counting the
   warm-up and the capture only, the captured run against the others bit
   for bit or by difference, and the fp32 run held to phase 4's rule
   against the eager one; (b) the same for ResNet18's FixMatch (the
   fp32 run with SGD, as phase 5); (c) two captured steps of Mean Teacher,
   CPS (48 / 24 / 2 a replay), ReCo and an ST++ stage-2 step; then (d)
   ``train_main`` of phase 4's recipe at ``scan_steps: 3`` (a unit and a
   tail an epoch) with the device cache and a trace of the first replays,
   its log rows against phase 4's eager run, its checkpoint resumed
   eagerly and served by its test pass; (e) the bf16 ViT and ResNet18 FixMatch
   steps eager and captured: wall ms, the host's µs and device events per
   step, device busy and idle share. Each part's seconds are logged;
19. ``train.scan_steps`` with ``train.accum_iter`` > 1 and under NCCL
   ranks (a graph for the accumulating micro-step and one for the
   updating one, captured into one pool after an eager warm-up up to the
   run's first update): (a) under deterministic algorithms, the ViT
   FixMatch recipe in bf16 and fp32 at ``accum_iter`` 2 and 3, Mean
   Teacher and CPS at 2 and ResNet18's FixMatch at 2, each for three
   windows and a micro-step: the captured micro-steps equal to the same
   micro-steps taken eagerly with the capturable optimizers bit for bit,
   each graph's launches read from its nodes (24 / 12 / 3 a ViT FixMatch
   graph), the replays of each kind, the peak memory of both runs; (b)
   ``train_main`` of phase 12's recipe at ``scan_steps: 3`` and
   ``accum_iter: 2`` (windows across units and the epoch's end) against
   the same run taken eagerly with the capturable optimizers: log rows,
   test metrics, best checkpoint and launches equal; a captured run of
   its first epoch, whose checkpoint holds an open window, resumed into a
   captured run equal to the straight one (log row, networks, optimizer,
   step); (c) two gloo ranks with CUDA tensors on one card at
   ``scan_steps`` > 1 (started first, beside (a) and (b)): ``train_main``
   raises with the reason and launches nothing; (d) with two or more
   cards, NCCL ranks: data 2 (ViT bf16 and fp32, ResNet18), data 2 with
   ZeRO-1 and with ``accum_iter: 2``, seq (1, 2) of both backbones and,
   on three cards or more, model (1, 3): on each rank the captured steps
   against eager ones with the capturable optimizers, bit for bit where
   two eager runs already are (else within phase 10's bounds, the
   repeat's spread beside them), the ranks equal, each graph's launches;
   each rank's bf16 ViT step eager and captured with the idle share of
   the untraced wall. On one card (d) logs one line saying why it did
   not run. Each part's seconds are logged;
20. ``debug.nan_checks`` (``utils/nan_checks.py``, the JAX package's
   ``jax_debug_nans``), under ``train.scan_steps`` too, where a captured
   step is two graphs split at its gradients' NaN flags: (a) under
   deterministic algorithms, the bf16 ViT FixMatch (``accum_iter`` 1 and
   2), Mean Teacher, CPS and ResNet18 FixMatch captured with the checks
   equal to the same run without them bit for bit (metrics, networks,
   optimizers), the kernel nodes of a step's two graphs summing to its
   launches (24 / 12 / 3; CPS 48 / 24 / 2; ResNet18 0 / 0 / 3), all in
   the first; ms a step eager under anomaly mode, captured with the checks
   and without; (b) a NaN in one labeled row of a batch after the warm-up
   raises ``FloatingPointError`` from the step's eager rerun at a
   backward op, the parameters and optimizer as before the step (under
   deterministic algorithms); ``train_main`` at scan_steps 4 with a NaN
   in a validation record raises at epoch 0's validation with no
   ``best-*.ckpt``, with one in a test record in the test pass; (c) on
   phase 10's ranks (NCCL and captured on two cards or more, else gloo
   with CUDA tensors on one card and eager), a NaN in rank 1's rows: every
   rank raises at that step, none waits at a collective, no update
   applied. Each part's seconds are logged;
21. the measuring tools (``semi_seg_ecg_tpu_torch/tools/``), each tool's
   ``main`` in this process at short counts (``TOOL_RUNS``): the FLOP
   count, ``bench`` (20 eager steps and 2 units of 32 captured ones a
   trial, and the batch-64 row), ``bench_scale``, ``bench_matrix``,
   ``profile_step --augment``, ``bench_e2e`` (64 records, 3 epochs,
   ``host`` and ``cache+scan``), ``bench_inference``, ``bench_holter``,
   ``bench_streams`` and ``bench_longrec --mode card`` and ``--mode mem``;
   each line holds its keys and names the card, no device metric is null,
   MFU lies in (0, 1], losses are finite; the augmented trace window's
   gather events are the launches its counter counted, the long-record
   step launches 8 flash forwards and 4 backwards (depth 4 with remat),
   the device-augment run gathers and the host one does not; the flash
   kernels at the long-record step's (2, 3, 4097, 64) in bf16 and fp32
   against their plain versions, as in phase 2.

Phases 12 (e) and 13 (d), phase 17 (b)'s ZeRO-1 task and phase 20 (c)'s
task run on phase 10's rank processes. In the whole run phases 14-16 share rank groups,
since a group's start costs tens of seconds: phase 16's (a) runs on an
idle
card before phase 14; phase 15's ``(2, 2)`` tasks and phase 16's (d) run
on phase 14's ``(2, 2)`` group, phase 16's (b) on phase 15's ``(1, 2)``
group, and phase 16's ``(1, 2, 3)`` group starts after phase 15's (a).
Run alone, each phase starts its own groups. The log's last line before
the results lists each phase's seconds.

``python3 chip_smoke.py --tp-drift OUT`` is a diagnostic outside the run:
phase 14's fp32 steps with the optimizer's sync of the replicated
gradients from model rank 0 on or off, under PyTorch's default or
deterministic algorithms (``TP_DRIFT_RUNS``), reporting which replicated
parameters the model ranks hold apart.

The line before the last prints the card's name and power limit as
nvidia-smi gives them; the line before that, a JSON object with one entry
per kernel. The last line is ``{"ok": true, "device": {...}}``. Details go
to ``build/chip_smoke/chip_smoke.json``.
"""

import contextlib
import copy
import functools
import gc
import json
import math
import os
import pickle
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import yaml

from semi_seg_ecg_tpu_torch.tools.device_profile import (
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
    event_ms,
    kernel_ms,
    launch_counts,
    nvidia_smi,
    profile_forward,
    profile_step,
    trace_device,
)

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
OUT_JSON = os.path.join(WORK, "chip_smoke.json")

# the PEAK_FLOPS entry (tools/device_profile.py: the H100 SXM's dense peaks;
# the fp32 flash kernels' products are 3xTF32) each flash dtype is bounded by
FLASH_PEAK = {"float32": "3xtf32", "bfloat16": "bfloat16"}

STEMS = ("flash_attention_fwd", "flash_attention_bwd", "gather1d")
CSRC = "semi_seg_ecg_tpu_torch/csrc/{}.cu"
REPLACES = {
    "flash_attention_fwd": "semi_seg_ecg_tpu/ops/pallas/flash_attention.py:124",
    "flash_attention_bwd": "semi_seg_ecg_tpu/ops/pallas/flash_attention.py:209",
    "gather1d": "semi_seg_ecg_tpu/ops/pallas/gather1d.py:91",
}
# the phase-2 row each kernel's entry in the kernels line reports (named in
# the entry's "row"): the shape and dtype of the trained recipe's main path
# (bf16 autocast), whose run the launch counts come from
MAIN_ROW = {"flash_attention_fwd": "train_bf16",
            "flash_attention_bwd": "train_bf16",
            "gather1d": "train_resize_crop"}
# the fp32 row of each flash kernel's entry (its "fp32" object): the
# serving entry's shape for the forward (fp32 unless test.use_amp), the
# fp32 train step's for the backward
FP32_ROW = {"flash_attention_fwd": "slice_fp32",
            "flash_attention_bwd": "train_fp32"}
# the training shape once more, with q, k, v the transposed chunks of one
# (B, N, 3·H·D) projection and dO a (B, N, H, D) gradient, as the ViT hands
# them over
STRIDED = [("train_bf16_strided", (32, 3, 101, 64), "bfloat16"),
           ("train_fp32_strided", (32, 3, 101, 64), "float32")]
# a rank's heads at model_parallel 3 (phase 14): H/tp = 1
TP_ROWS = [("tp_rank_fp32", (16, 1, 101, 64), "float32"),
           ("tp_rank_bf16", (16, 1, 101, 64), "bfloat16"),
           ("tp_rank_train_bf16_strided", (32, 1, 101, 64), "bfloat16"),
           ("tp_rank_train_fp32_strided", (32, 1, 101, 64), "float32")]
# (label, (B, H, N, D), dtype): the serving shape of vit_tiny at batch 16
# first, in both precisions the entry runs; the training student pass
# (labeled + strong, 32 windows; fp32 under precision: fp32); then a long
# and ragged shapes
FLASH_SHAPES = [
    ("slice_fp32", (16, 3, 101, 64), "float32"),
    ("slice_bf16", (16, 3, 101, 64), "bfloat16"),
    ("train_bf16", (32, 3, 101, 64), "bfloat16"),
    ("train_fp32", (32, 3, 101, 64), "float32"),
    ("long_bf16", (8, 12, 2048, 64), "bfloat16"),
    ("ragged_fp32", (4, 3, 1000, 64), "float32"),
    ("ragged_bf16_d100", (2, 4, 257, 100), "bfloat16"),
    # one head of the serving shape: 2 CTAs instead of 96, the same work
    # per CTA, so its time against slice_fp32 shows what one CTA costs
    ("one_head_fp32", (1, 1, 101, 64), "float32"),
    ("one_head_bf16", (1, 1, 101, 64), "bfloat16"),
    *STRIDED,
    # phase 14: one of 3 model ranks' heads, the eval batch and the
    # training student pass as the ViT hands it over
    *TP_ROWS,
    # phase 8: a batch of 64 long-record windows, in both precisions the
    # entry runs, and one step of 8 live streams
    ("longrec_fp32", (64, 3, 101, 64), "float32"),
    ("longrec_bf16", (64, 3, 101, 64), "bfloat16"),
    ("stream_fp32", (8, 3, 101, 64), "float32"),
    # the 3xTF32 forward's error margin at long N, where attention_impl:
    # auto sends fp32 from N = 512
    ("long_fp32_2048", (2, 3, 2048, 64), "float32"),
    ("long_fp32_4096", (1, 3, 4096, 64), "float32"),
]
# the backward at the training step's shape (32 windows, bf16 under the
# recipe's autocast, fp32 in the fp32 checks) first, then long and ragged
BWD_SHAPES = [
    ("train_fp32", (32, 3, 101, 64), "float32"),
    ("train_bf16", (32, 3, 101, 64), "bfloat16"),
    ("long_bf16", (8, 12, 2048, 64), "bfloat16"),
    ("ragged_fp32", (4, 3, 1000, 64), "float32"),
    ("ragged_bf16_d100", (2, 4, 257, 100), "bfloat16"),
    # 2 + 2 CTAs with the training shape's work per CTA (see one_head_fp32)
    ("one_head_bf16", (1, 1, 101, 64), "bfloat16"),
    *STRIDED,
    *TP_ROWS,
]
# (label, kind, (B, C, T_in), J, slope): the training step's three calls
# (resize-crop of the signal and its labels in one launch, the signal alone
# as the unlabeled view takes it, the partial-sine roll over a doubled
# wave), the labels alone, and a 12-lead batch of long records
GATHER_SHAPES = [
    ("train_resize_crop", "lerp", (16, 1, 2500), 2500, 2.0),
    ("train_resize_crop_pair", "pair", (16, 1, 2500), 2500, 2.0),
    ("train_labels", "index", (16, 1, 2500), 2500, 2.0),
    ("train_sine_roll", "roll", (16, 1, 5000), 2500, 1.0),
    ("leads12_long", "lerp", (256, 12, 5000), 5000, 2.0),
]
# kernel vs plain, |kernel - plain| <= tolerance, element by element, from
# ops/flash_attention.forward_tolerance and backward_tolerance: fp32 atol +
# rtol |plain| (FWD_TOL_FP32, BWD_TOL_FP32; the kernels' 3xTF32 products
# are within a few fp32 roundings of fp32 ones); bf16 the error bound of
# forward_error_bound and backward_error_bound (the kernels round P and dS
# to bf16 as tensor-core operands; the bound is that rounding, doubled,
# plus one bf16 ulp of the result). lse within LSE_ATOL in both. Gather:
# bit for bit.
TOL_NAMES = {"float32": "fp32 atol + rtol |plain|",
             "bfloat16": "bf16 error bound"}

NUM_TEST, SIGNAL_LENGTH, BATCH, DEPTH = 64, 2500, 16, 12
# training split and run: 4 steps of 16 + 16 windows per epoch
TRAIN_LABELED, TRAIN_UNLABELED, TRAIN_VALID, TRAIN_TEST = 64, 64, 16, 16
TRAIN_EPOCHS = 2
# flash vs dense after LOCKSTEP_STEPS fp32 AdamW steps, in units of lr:
# the key bias has a gradient that is zero in exact arithmetic, so Adam
# turns its rounding noise into O(lr) updates of either sign
LOCKSTEP_STEPS = 3
LOCKSTEP_ATOL_LR = 2.0 * LOCKSTEP_STEPS
LOCKSTEP_TIGHT_ATOL_LR = 0.5
KEY_BIAS = "attn.fn.to_qkv.bias"
# a fresh random model is confident nowhere near the recipe's 0.8 on
# random inputs; the lockstep's threshold lets the unlabeled loss work
LOCKSTEP_CONF_THRESH = 0.5
# the fresh ResNet18's confidences on random inputs lie in 0.27-0.39
RESNET_LOCKSTEP_CONF_THRESH = 0.33
# the whole FixMatch augmentation, card vs CPU on the same draws: the two
# libraries' sin and standardize reductions round apart (check_augment)
CHAIN_ATOL = 1e-5
# flash vs dense gradients of one fp32 forward/backward of the full model:
# per parameter, max |difference| <= GRAD_RTOL x max |dense gradient|
GRAD_RTOL = 1e-3
# phases 5 and 6: the recipes trained through train_main; per step, flash
# forward passes of the ViT (pseudo-label or teacher pass and the student
# pass; CPS: both networks' of each) and backward passes, and the gather
# launches of the device augmentation (the labeled resize-crop's pair, the
# weak view's resize-crop, and with a strong view its partial-sine roll)
# (ReCo as Mean Teacher; ST++'s stage 1 is "base", its stages 2-3 "stpp":
# the teacher's and the student's pass, no strong view)
RECIPE_PASSES = {"fixmatch": (2, 1), "mean_teacher": (2, 1), "cps": (4, 2),
                 "reco": (2, 1), "base": (1, 1), "stpp": (2, 1)}
RECIPE_GATHERS = {"fixmatch": 3, "mean_teacher": 3, "cps": 2, "reco": 3,
                  "base": 1, "stpp": 2}
# what the checkpoint of each algorithm holds beside the model
CKPT_EXTRAS = {"fixmatch": set(), "mean_teacher": {"model_ema"},
               "cps": {"model_peer", "peer_optimizer"},
               "reco": {"model_ema"}, "stpp": {"model_ema"}}
# ST++'s ranking pass: one eval forward of each stage-1 snapshot per batch
STPP_SNAPSHOTS = 3
# a uniform within this of a CDF value may round to the other side of it;
# two class scores within this of each other may order either way
CDF_ROUNDING = 4 * 2.0 ** -23
SCORE_TIE = 1e-5
# the stem pool's tie-routing check: (B, C, T) of the ResNet18 stem output
POOL_SHAPE = (BATCH, 64, SIGNAL_LENGTH // 2)
# phase 8: records at 250 Hz (the shipped recipes' rate) through the
# long-record entry, windows of SIGNAL_LENGTH at 50% overlap, 64 a batch;
# one hour, two minutes, eight live streams of ten minutes fed a second at
# a time, and a 6-hour Holter record
FS = 250
LONGREC_BATCH, LONGREC_HOP = 64, SIGNAL_LENGTH // 2
HOUR_S, SHORT_S, STREAM_S, HOLTER_S = 3600, 120, 600, 6 * 3600
STREAMS, STREAM_CHUNK = 8, FS
# card against the CPU (the serving phases' bound); a stream against the
# offline stitcher on the card (the same arithmetic at batch 8 and 64)
LONGREC_CPU_ATOL, STREAM_ATOL = 1e-4, 1e-5
# phase 9: int8 serving, card against the CPU on the same weights and batch.
# Each int8 layer on the card's own input against the same layer on the CPU
# (the int8 op tolerance of tests/test_torch_cuda.py: the same codes, exact
# int32 sums, outputs within 1e-6 relative). The whole model: a code flips
# wherever the two devices' fp32 arithmetic ahead of a layer (3xTF32
# flash, cuBLAS's and cuDNN's sum orders) moves an activation across a .5
# boundary, and a flip moves everything after it by a quantization step,
# so the two int8 runs are two quantizations of one fp32 computation and
# are held to the rule that holds int8 against fp32
# (tests/test_quantization.py): argmax agreement above 0.9 overall and
# 0.995 where the fp32 margin is above its median, relative norm below 0.1
INT8_LAYER_RTOL = 1e-6
INT8_AGREE, INT8_AGREE_CONFIDENT, INT8_REL_NORM = 0.9, 0.995, 0.1
# the timed and traced calls of each of phase 9's 12 serving profiles (2
# models x 3 forms x 2 batches), cut from 10 to keep the script's time
SERVE_PROFILE_STEPS = 5


def log(*args):
    print("[chip_smoke]", *args, flush=True)


def bound(nbytes, flops, peak):
    """The card's least time in ms for moving ``nbytes`` and doing
    ``flops`` at ``PEAK_FLOPS[peak]``, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def attention_bound(shape, dtype):
    """softmax(q kᵀ) v plus its logsumexp: each of q, k, v, out moved once
    (lse too), against 4·B·H·N²·D flops at the dtype's FLASH_PEAK."""
    b, h, n, d = shape
    elem = 4 if dtype == "float32" else 2
    return bound(4 * b * h * n * d * elem + b * h * n * 4,
                 4 * b * h * n * n * d, FLASH_PEAK[dtype])


def attention_bwd_bound(shape, dtype):
    """dq, dk, dv: q, k, v, o, dO read and dq, dk, dv written once (and
    lse), against 10·B·H·N²·D flops (S, dP, dV, dQ, dK products) at the
    dtype's FLASH_PEAK."""
    b, h, n, d = shape
    elem = 4 if dtype == "float32" else 2
    return bound(8 * b * h * n * d * elem + b * h * n * 4,
                 10 * b * h * n * n * d, FLASH_PEAK[dtype])


def excess_over(got, want, tol):
    """The worst |got - want| and the worst |got - want| / tolerance, element
    by element (<= 1 passes)."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), (diff / tol).max().item()


def flash_inputs(torch, gen, label, shape, dtype, count):
    """``count`` random (B, H, N, D) operands: contiguous, or for a
    ``_strided`` label q, k, v as the transposed chunks of one (B, N,
    3·H·D) tensor and the rest as views of (B, N, H, D) memory."""
    b, h, n, d = shape
    make = lambda *size: torch.randn(size, generator=gen, device="cuda",
                                     dtype=dtype)
    if not label.endswith("_strided"):
        return [make(*shape) for _ in range(count)]
    qkv = make(b, n, 3 * h * d)
    return ([t.reshape(b, n, h, d).transpose(1, 2)
             for t in qkv.chunk(3, dim=-1)]
            + [make(b, n, h, d).transpose(1, 2) for _ in range(count - 3)])


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    from semi_seg_ecg_tpu_torch.ops import flash_attention as fa
    from semi_seg_ecg_tpu_torch.ops import gather1d
    from semi_seg_ecg_tpu_torch.ops.cuda_build import (
        build_library,
        library_path,
    )

    t0 = time.time()
    with ThreadPoolExecutor(len(STEMS)) as pool:
        list(pool.map(build_library, STEMS))
    fa.load_kernel()
    fa.load_backward_kernel()
    gather1d.load_kernels()
    seconds = time.time() - t0
    log(f"phase 1: built {', '.join(STEMS)} in {seconds:.2f} s")
    for stem in STEMS:
        with open(library_path(stem)[:-3] + ".log") as f:
            for line in f:
                if "Compiling entry" in line:
                    log(f"  ptxas {stem}:", line.split("'")[1][:90])
                elif "registers" in line or "spill" in line:
                    log("   ", line.strip())
    hmma = {stem: hmma_counts(library_path(stem)) for stem in STEMS[:2]}
    for stem, counts in hmma.items():
        log(f"  HMMA instructions in {stem}: {counts}")
        flash = [k for k in counts if k.startswith("flash_")]
        if (not any("_mma" in k for k in flash)
                or not any("_fp32" in k for k in flash)
                or not all(counts[k] for k in flash)):
            raise SystemExit(f"phase 1 failed: a flash kernel of {stem} "
                             f"holds no tensor-core instructions ({counts})")
    return seconds, hmma


def hmma_counts(path):
    """HMMA (tensor-core) instructions per kernel in a library's SASS, from
    ``cuobjdump --dump-sass``; kernels named by function and template
    arguments."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "--dump-sass", path], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            found = re.search(r"(flash_[fb]wd_[a-z0-9_]+?)I((?:Li\d+E)+)E",
                              mangled)
            name = mangled
            if found:
                args = re.findall(r"Li(\d+)E", found.group(2))
                name = f"{found.group(1)}<{','.join(args)}>"
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(torch):
    from semi_seg_ecg_tpu_torch.algorithms.common import full_fp32
    from semi_seg_ecg_tpu_torch.ops import flash_attention as fa
    from semi_seg_ecg_tpu_torch.ops import gather1d

    # TF32 off for the plain versions' fp32 matmuls here only: phases 3 and
    # 4 start from PyTorch's defaults, so that the entries set their own
    with full_fp32():
        log(f"phase 2: {tf32_flags(torch)}")
        floor_ms = launch_floor(torch, gather1d)
        log(f"  launch floor: an empty kernel, timed as the kernels are, "
            f"{floor_ms * 1e3:.3f} us")
        gen = torch.Generator(device="cuda").manual_seed(0)
        return {
            "flash_attention_fwd": [check_kernel(torch, fa, gen, *case)
                                    for case in FLASH_SHAPES],
            "flash_attention_bwd": [check_backward(torch, fa, gen, *case)
                                    for case in BWD_SHAPES],
            "gather1d": [check_gather(torch, gather1d, *case)
                         for case in GATHER_SHAPES],
        }, floor_ms


def launch_floor(torch, gather1d):
    """Device time per launch of a kernel that does nothing (1 block of 32
    threads), queued and timed as ``event_ms`` times every kernel: what a
    launch costs the card before any work."""
    lib = gather1d.load_kernels()

    def empty():
        err = lib.gather1d_empty(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"phase 2 failed: the empty kernel's launch "
                             f"returned CUDA error {err}")

    return event_ms(empty, 200)


def tf32_flags(torch):
    return ("torch.backends.cuda.matmul.allow_tf32 = "
            f"{torch.backends.cuda.matmul.allow_tf32}, "
            "torch.backends.cudnn.allow_tf32 = "
            f"{torch.backends.cudnn.allow_tf32}")


def check_kernel(torch, fa, gen, label, shape, dtype_name, phase=2):
    """One forward shape: the kernel against its plain version, then the
    times of kernel, plain version and SDPA, and the card's bound."""
    import torch.nn.functional as F

    dtype = getattr(torch, dtype_name)
    q, k, v = flash_inputs(torch, gen, label, shape, dtype, 3)
    scale = shape[-1] ** -0.5
    out, lse = fa.flash_attention_forward(q, k, v, scale)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, scale)
    tol_name = TOL_NAMES[dtype_name]
    err_out, ratio = excess_over(out, ref_out, fa.forward_tolerance(
        q, k, v, scale, ref_out))
    err_lse = (lse - ref_lse).abs().max().item()
    ok = (math.isfinite(err_out) and ratio <= 1
          and math.isfinite(err_lse) and err_lse <= fa.LSE_ATOL)
    long = shape[2] >= 1000
    kernel_ms = event_ms(lambda: fa.flash_attention_forward(
        q, k, v, scale), 20 if long else 200)
    plain_ms = event_ms(lambda: fa.flash_attention_plain(
        q, k, v, scale), 5 if long else 100)
    library_ms = event_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale), 20 if long else 200)
    bound_ms, bound_by = attention_bound(shape, dtype_name)
    log(f"  fwd {label} {shape} {dtype_name}: err out {err_out:.3g} "
        f"({ratio:.3g} of the tolerance, {tol_name}) lse {err_lse:.3g} | "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, "
        f"{FLASH_PEAK[dtype_name]})")
    if not ok:
        raise SystemExit(f"phase {phase} failed: forward {label} disagrees "
                         f"with the plain version (out {err_out}, {ratio} "
                         f"of the tolerance; lse {err_lse})")
    return {"shape": label, "bhnd": list(shape), "dtype": dtype_name,
            "max_abs_err": err_out, "max_abs_err_lse": err_lse,
            "tolerance": tol_name, "max_tolerance_ratio": ratio,
            "atol_lse": fa.LSE_ATOL, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_peak": FLASH_PEAK[dtype_name]}


def check_backward(torch, fa, gen, label, shape, dtype_name, phase=2):
    """One backward shape: ``flash_attention_backward`` (the two kernels, Δ
    included) against the plain backward on the kernel forward's ``(out,
    lse)``; times of the wrapper, the plain version and the backward of
    SDPA alone, and the card's bound."""
    import torch.nn.functional as F

    dtype = getattr(torch, dtype_name)
    q, k, v, dout = flash_inputs(torch, gen, label, shape, dtype, 4)
    scale = shape[-1] ** -0.5
    out, lse = fa.flash_attention_forward(q, k, v, scale)
    grads = fa.flash_attention_backward(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_backward_plain(q, k, v, out, lse, dout, scale)
    tols = fa.backward_tolerance(q, k, v, out, lse, dout, scale, want)
    tol_name = TOL_NAMES[dtype_name]
    errs, ratio = [], 0.0
    for got, ref, tol in zip(grads, want, tols):
        if got.dtype != dtype:
            raise SystemExit(f"phase {phase} failed: backward {label} "
                             f"returned {got.dtype}, not {dtype}")
        err, r = excess_over(got, ref, tol)
        errs.append(err)
        ratio = max(ratio, r)
    del tols
    # a reading only: no kernel sums in the plain version's order
    bit_equal = all(torch.equal(g, w) for g, w in zip(grads, want))
    long = shape[2] >= 1000
    kernel_ms = event_ms(lambda: fa.flash_attention_backward(
        q, k, v, out, lse, dout, scale), 20 if long else 200)
    plain_ms = event_ms(lambda: fa.flash_attention_backward_plain(
        q, k, v, out, lse, dout, scale), 3 if long else 50)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    library_ms = event_ms(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), dout, retain_graph=True), 20 if long else 200)
    bound_ms, bound_by = attention_bwd_bound(shape, dtype_name)
    err = max(errs)
    log(f"  bwd {label} {shape} {dtype_name}: err dq/dk/dv "
        f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} ({ratio:.3g} of the "
        f"tolerance, {tol_name}; bit-equal {bit_equal}) | kernel "
        f"{kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}, {FLASH_PEAK[dtype_name]})")
    if not (math.isfinite(err) and ratio <= 1):
        raise SystemExit(f"phase {phase} failed: backward {label} disagrees "
                         f"with the plain version (max error {err}, {ratio} "
                         "of the tolerance)")
    return {"shape": label, "bhnd": list(shape), "dtype": dtype_name,
            "max_abs_err": err, "max_abs_err_dq_dk_dv": errs,
            "tolerance": tol_name, "max_tolerance_ratio": ratio,
            "bit_equal": bit_equal, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_peak": FLASH_PEAK[dtype_name]}


def gather_positions(kind, b, t_in, j, slope):
    """Positions as the training path makes them: the resize-crop's
    monotone map from one draw of its scale (slope up to ``slope``), or the
    partial-sine roll's integral slope-1 map over a doubled wave."""
    rng = np.random.default_rng(0)
    if kind == "roll":
        start = rng.integers(0, j, (b, 1))
        pos = (np.arange(j)[None, :] - start + j).astype(np.float32)
    else:
        ratio = rng.uniform(1.0 / slope, 2.0, (b, 1))
        offset = rng.uniform(0.0, 1.0, (b, 1)) * np.maximum(
            t_in - 1 - (j - 1) / ratio, 0.0)
        pos = np.clip(offset + np.arange(j)[None, :] / ratio, 0,
                      t_in - 1).astype(np.float32)
        pos[:, -1] = t_in - 1  # the last position reads in bounds
        if kind == "index":
            pos = np.round(pos)
    return pos


def touched(rows):
    """Distinct elements that the rows of indices ``rows`` read, summed
    over the rows: each is read once in the bound."""
    return sum(len(np.unique(r)) for r in rows)


def check_gather(torch, gather1d, label, kind, shape, j, slope):
    """One gather shape: the kernel against its plain version, bit for bit;
    times of kernel, plain version and the one-call library equivalent
    (``F.grid_sample`` for the interpolation, ``torch.gather`` for labels;
    for the pair, the signal's and the labels' launches one after the
    other instead); the bound over the bytes this run's positions read."""
    import torch.nn.functional as F

    b, c, t = shape
    rng = np.random.default_rng(1)
    pos_np = gather_positions("lerp" if kind == "pair" else kind, b, t, j,
                              slope)
    pos = torch.from_numpy(pos_np).cuda()
    # elements of x the positions touch (i0 and its clamped neighbour) and
    # of y the rounded positions touch, each read once
    i0 = np.floor(pos_np).astype(np.int64)
    x_touched = touched(np.concatenate([i0, np.minimum(i0 + 1, t - 1)], 1))
    idx = torch.from_numpy(np.round(pos_np).astype(np.int32)).cuda()
    y_touched = touched(np.round(pos_np).astype(np.int64))
    x = torch.from_numpy(rng.standard_normal((b, c, t)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 4, (b, t))).cuda()
    idx64 = idx.long()
    lerp_bytes = x_touched * c * 4 + b * j * 4 + b * c * j * 4
    index_bytes = y_touched * 8 + b * j * (4 + 8)
    grid = torch.stack([pos / (t - 1) * 2 - 1, torch.zeros_like(pos)],
                       dim=-1)[:, None]
    x4 = x[:, :, None, :]
    grid_sample = lambda: F.grid_sample(x4, grid, mode="bilinear",
                                        padding_mode="border",
                                        align_corners=True)
    separate_ms = None
    if kind == "index":
        run = lambda: gather1d.monotonic_gather_int(y, idx, max_slope=slope)
        plain = lambda: torch.gather(y, 1, idx.long())
        library = lambda: torch.gather(y, 1, idx64)
        nbytes, flops = index_bytes, 0
    elif kind == "pair":
        run = lambda: gather1d.monotonic_gather_pair(x, pos, y, idx)
        plain = lambda: (gather1d.monotonic_gather_plain(x, pos),
                         torch.gather(y, 1, idx.long()))
        library = None
        nbytes, flops = lerp_bytes + index_bytes, 3 * b * c * j
    else:
        run = lambda: gather1d.monotonic_gather(x, pos, max_slope=slope)
        plain = lambda: gather1d.monotonic_gather_plain(x, pos)
        library = grid_sample
        nbytes, flops = lerp_bytes, 3 * b * c * j
    got, want = run(), plain()
    torch.cuda.synchronize()
    if kind != "pair":
        got, want = (got,), (want,)
    exact = all(g.dtype == w.dtype and torch.equal(g, w)
                for g, w in zip(got, want))
    err = max((g.double() - w.double()).abs().max().item()
              for g, w in zip(got, want))
    lib_err = None
    if kind != "index":
        lib_err = (grid_sample()[:, :, 0, :] - want[0]).abs().max().item()
    kernel_ms = event_ms(run, 200)
    plain_ms = event_ms(plain, 50)
    library_ms = event_ms(library, 200) if library else None
    if kind == "pair":
        separate_ms = event_ms(lambda: (
            gather1d.monotonic_gather(x, pos, max_slope=slope),
            gather1d.monotonic_gather_int(y, idx, max_slope=slope)), 200)
    bound_ms, bound_by = bound(nbytes, flops, "float32")
    versus = (f"library {library_ms * 1e3:.3f} us" if library else
              f"two separate launches {separate_ms * 1e3:.3f} us")
    log(f"  gather {label} x{tuple(shape)} -> {j} ({kind}, slope "
        f"{slope}): bit-equal {exact} (max err {err:.3g}; grid_sample err "
        f"{lib_err}) | kernel {kernel_ms * 1e3:.3f} us, plain "
        f"{plain_ms * 1e3:.3f} us, {versus}, bound {bound_ms * 1e3:.4f} us "
        f"({bound_by})")
    if not exact:
        raise SystemExit(f"phase 2 failed: gather {label} differs from the "
                         f"plain version (max error {err})")
    return {"shape": label, "kind": kind, "bct": list(shape), "j": j,
            "max_slope": slope, "max_abs_err": err,
            "library_max_abs_err": lib_err, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "separate_launches_ms": separate_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes}


# ---------------------------------------------------------------------------
# Phase 3: serving
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def synthetic_split(name, **sizes):
    """A synthetic dataset under ``WORK/name``, written once per run."""
    from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset

    return make_synthetic_dataset(os.path.join(WORK, name),
                                  length=SIGNAL_LENGTH, **sizes)


def write_slice_config(family="vit_tiny"):
    """The shipped scratch recipe of ``family`` (the ViT with flash
    attention) on a synthetic test split, batch 16."""
    from semi_seg_ecg_tpu_torch.config import load_config

    data = synthetic_split("data", num_train_labeled=1,
                           num_train_unlabeled=1, num_valid=1,
                           num_test=NUM_TEST, seed=0)
    config = load_config(os.path.join(REPO, "configs", "base", family,
                                      "scratch.yaml"))
    if family == "vit_tiny":
        config["backbone"]["vit_tiny"]["attention_impl"] = "flash"
    config["dataset"].update(data)
    config["dataloader"]["batch_size"] = BATCH
    config["output_dir"] = os.path.join(WORK, "exps")
    path = os.path.join(WORK, f"{family}_serving.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path, config


def write_random_weights(config, path, seed=0):
    """The config's model at full width, weights from ``seed``, as a
    .pth."""
    import torch

    from semi_seg_ecg_tpu_torch.config import normalize_config
    from semi_seg_ecg_tpu_torch.models import build_model_from_config
    from semi_seg_ecg_tpu_torch.utils.checkpoint import save_torch_checkpoint

    torch.manual_seed(seed)
    model = build_model_from_config(normalize_config(config))
    save_torch_checkpoint(path, model, epoch=0)
    return sum(p.numel() for p in model.parameters())


def reset_counts():
    from semi_seg_ecg_tpu_torch.ops import flash_attention as fa
    from semi_seg_ecg_tpu_torch.ops import gather1d

    fa.LAUNCHES = fa.BWD_LAUNCHES = gather1d.LAUNCHES = 0


def serve(config_path, model_path, name, **override):
    """One ``inference_main`` call with an override file; returns the
    outputs, the kernel launches it made (by kernel) and its wall
    seconds."""
    import torch

    from semi_seg_ecg_tpu_torch.cli import inference_main

    override_path = os.path.join(WORK, f"{name}.yaml")
    with open(override_path, "w") as f:
        yaml.safe_dump(override, f)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    outputs = inference_main(["-f", config_path, "-o", override_path,
                              "--model_path", model_path,
                              "--exp_name", name])
    seconds = time.time() - t0
    launches = launch_counts()
    saved = np.load(os.path.join(WORK, "exps", name, "test_outputs.npy"))
    if not np.array_equal(saved, outputs):
        raise SystemExit(f"{name}: test_outputs.npy differs from the "
                         "returned outputs")
    return outputs, launches, seconds


def check_probs(name, probs, n=NUM_TEST):
    expected = (n, 4, SIGNAL_LENGTH)
    if probs.shape != expected or not np.isfinite(probs).all():
        raise SystemExit(f"{name}: outputs {probs.shape} (expected "
                         f"{expected}) or not finite")
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    if row_err > 1e-5:
        raise SystemExit(f"{name}: probability rows sum to 1 +- {row_err}")
    return row_err


@contextlib.contextmanager
def reco_loss_region(torch):
    """Inside, ReCo's draws and loss run in host ranges ``reco_loss``, and
    the sequence numbers of the loss's autograd nodes (down to, not
    including, the latent's own node) gather in the yielded set: the
    ``region`` that :func:`trace_device` attributes."""
    from semi_seg_ecg_tpu_torch.ops import reco_loss as rl

    name, seqs = "reco_loss", set()
    draws_fn, loss_fn = rl.reco_draws, rl.compute_reco_loss

    def draws(*args, **kwargs):
        with torch.profiler.record_function(name):
            return draws_fn(*args, **kwargs)

    def loss(draws_, latent, *args, **kwargs):
        with torch.profiler.record_function(name):
            out = loss_fn(draws_, latent, *args, **kwargs)
        stack, seen = [out.grad_fn], set()
        while stack:
            node = stack.pop()
            if node is None or node is latent.grad_fn or node in seen:
                continue
            seen.add(node)
            seqs.add(node._sequence_nr())
            stack.extend(n for n, _ in node.next_functions)
        return out

    rl.reco_draws, rl.compute_reco_loss = draws, loss
    try:
        yield name, seqs
    finally:
        rl.reco_draws, rl.compute_reco_loss = draws_fn, loss_fn


def profile_model(torch, config, model_path, amp, steps=20):
    """Where one batch's time goes (``profile_forward``): host-clock wall
    time per forward of a (16, 1, 2500) batch (synchronized), and from a
    torch.profiler trace of the same loop the card's busy time, its idle
    share and the kernels that take the most device time."""
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        full_fp32,
        load_eval_model,
    )
    from semi_seg_ecg_tpu_torch.config import normalize_config

    cfg = normalize_config(dict(config, test={"model_path": model_path}))
    model = load_eval_model(cfg, torch.device("cuda"))
    x = torch.randn(BATCH, 1, SIGNAL_LENGTH, device="cuda")

    def forward():  # as run_inference runs the model
        with torch.inference_mode(), full_fp32(), torch.autocast(
                "cuda", dtype=torch.bfloat16, enabled=amp):
            model(x)

    return profile_forward(forward, BATCH, steps, x.device)


def profile_models(torch, config, model_path):
    """``profile_model`` at fp32 and under bf16 autocast, logged."""
    model = {"fp32": profile_model(torch, config, model_path, False),
             "bf16_autocast": profile_model(torch, config, model_path, True)}
    for name, m in model.items():
        log(f"  model forward, batch {BATCH}, {name}: "
            f"{m['wall_ms']:.3f} ms wall "
            f"({m['windows_per_s']:.1f} windows/s); traced: "
            f"{m['device_events']:.0f} device events "
            f"({m['copy_kernels']:.0f} copy, "
            f"{m['elementwise_kernels']:.0f} other elementwise), "
            "device busy "
            f"{m['device_busy_ms']} ms, idle share "
            f"{m['device_idle_share']}, flash kernel "
            f"{m['flash_kernel_ms']} ms")
        for kernel, ms in m["top_kernels"] or []:
            log(f"    {ms:.4f} ms  {kernel[:80]}")
    return model


def phase_slice(torch):
    config_path, config = write_slice_config()
    model_path = os.path.join(WORK, "vit_tiny_seed0.pth")
    n_params = write_random_weights(config, model_path)
    n_batches = math.ceil(NUM_TEST / BATCH)
    want = DEPTH * n_batches
    log(f"phase 3: vit_tiny + FCNHead ({n_params} parameters, depth "
        f"{DEPTH}, width 192, 3 heads x 64), {NUM_TEST} windows of "
        f"{SIGNAL_LENGTH} in {n_batches} batches of {BATCH}; entering "
        f"with {tf32_flags(torch)}")

    runs = {}
    for name, override in (
            ("flash_fp32", {}),
            ("flash_amp", {"test": {"use_amp": True}}),
            ("xla_fp32", {"backbone": {"vit_tiny": {"attention_impl":
                                                    "xla"}}}),
            ("flash_fp32_cpu", {"device": "cpu"}),
            # the first call in a process pays cuDNN/cuBLAS set-up; this
            # one reads the entry's warm cost
            ("flash_fp32_warm", {})):
        probs, counts, seconds = serve(config_path, model_path, name,
                                       **override)
        launches = counts["flash_attention_fwd"]
        row_err = check_probs(name, probs)
        runs[name] = {"probs": probs, "launches": launches,
                      "launches_by_kernel": counts,
                      "seconds": seconds, "windows_per_s": NUM_TEST / seconds,
                      "row_sum_err": row_err}
        log(f"  {name}: {launches} kernel launches, {seconds:.3f} s entry "
            f"wall time, {NUM_TEST / seconds:.2f} windows/s end to end")
        on_card_flash = name.startswith("flash") and not name.endswith("cpu")
        if launches != (want if on_card_flash else 0) or \
                counts["flash_attention_bwd"] or counts["gather1d"]:
            raise SystemExit(f"{name}: launches {counts}, expected "
                             f"{want if on_card_flash else 0} flash forward "
                             f"({DEPTH} blocks x {n_batches} batches) and "
                             "no other")

    ref = runs["flash_fp32"]["probs"]
    diffs = {
        "flash_vs_xla_fp32": float(np.abs(ref - runs["xla_fp32"]["probs"])
                                   .max()),
        "card_vs_cpu_fp32": float(np.abs(ref - runs["flash_fp32_cpu"]
                                         ["probs"]).max()),
        "amp_vs_fp32": float(np.abs(ref - runs["flash_amp"]["probs"]).max()),
    }
    agree = float((ref.argmax(1) == runs["flash_amp"]["probs"].argmax(1))
                  .mean())
    log(f"  max |diff|: {diffs}; bf16 autocast argmax agreement {agree:.5f}")
    for key in ("flash_vs_xla_fp32", "card_vs_cpu_fp32"):
        if diffs[key] > 1e-4:
            raise SystemExit(f"phase 3 failed: {key} = {diffs[key]} > 1e-4")
    if agree < 0.9:
        raise SystemExit(f"phase 3 failed: bf16 autocast agrees with fp32 "
                         f"on {agree:.3f} of the samples' classes")

    model = profile_models(torch, config, model_path)
    summary = {name: {k: v for k, v in r.items() if k != "probs"}
               for name, r in runs.items()}
    return {"runs": summary, "diffs": diffs, "amp_argmax_agreement": agree,
            "batches": n_batches, "launches_expected": want,
            "model": model}


# ---------------------------------------------------------------------------
# Phase 4: training
# ---------------------------------------------------------------------------


def write_train_config(family="vit_tiny", algorithm="fixmatch"):
    """The shipped ``family``/``algorithm`` recipe (the ViT with flash
    attention) with device augmentation, on a synthetic split, for
    ``TRAIN_EPOCHS`` epochs."""
    from semi_seg_ecg_tpu_torch.config import load_config

    data = synthetic_split("train_data", num_train_labeled=TRAIN_LABELED,
                           num_train_unlabeled=TRAIN_UNLABELED,
                           num_valid=TRAIN_VALID, num_test=TRAIN_TEST,
                           seed=1)
    config = load_config(os.path.join(REPO, "configs", "base", family,
                                      f"{algorithm}.yaml"))
    if family == "vit_tiny":
        config["backbone"]["vit_tiny"]["attention_impl"] = "flash"
    config["dataset"].update(data, device_augment=True)
    config["output_dir"] = os.path.join(WORK, "exps")
    config["exp_name"] = f"{family}_{algorithm}"
    config["train"].update(epochs=TRAIN_EPOCHS, warmup_epochs=0)
    path = os.path.join(WORK, f"{family}_{algorithm}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path, config


def launches_per_step(family, algorithm):
    """Kernel launches of one train step of a recipe (RECIPE_PASSES)."""
    depth = DEPTH if family == "vit_tiny" else 0
    fwd, bwd = RECIPE_PASSES[algorithm]
    return {"flash_attention_fwd": fwd * depth,
            "flash_attention_bwd": bwd * depth,
            "gather1d": RECIPE_GATHERS[algorithm]}


def recipe_launches(family, algorithm):
    """The launches a ``train_main`` run of a recipe makes, by part: the
    training (its steps and an eval pass per epoch) and the test pass; for
    ST++ its three stages (stage 2 on the reliable half) and the ranking
    pass in their place."""
    depth = DEPTH if family == "vit_tiny" else 0

    def training(step_kind, steps_per_epoch):
        steps = steps_per_epoch * TRAIN_EPOCHS
        want = {k: steps * v for k, v in
                launches_per_step(family, step_kind).items()}
        want["flash_attention_fwd"] += (TRAIN_EPOCHS * depth
                                        * math.ceil(TRAIN_VALID / BATCH))
        return want

    def forwards(n):
        return {"flash_attention_fwd": n * depth, "flash_attention_bwd": 0,
                "gather1d": 0}

    test = forwards(math.ceil(TRAIN_TEST / BATCH))
    if algorithm != "stpp":
        return {"train": training(algorithm, TRAIN_LABELED // BATCH),
                "test": test}
    return {"stage1": training("base", TRAIN_LABELED // BATCH),
            "ranking": forwards(STPP_SNAPSHOTS
                                * math.ceil(TRAIN_UNLABELED / BATCH)),
            "stage2": training("stpp", TRAIN_UNLABELED // 2 // BATCH),
            "stage3": training("stpp", TRAIN_UNLABELED // BATCH),
            "test": test}


@contextlib.contextmanager
def launches_by_part(algorithm, parts):
    """Inside, the algorithm's parts (``train`` and ``test``; ST++'s
    ``train_sup``, ``prepare_semisup`` and each ``train_semisup`` for
    ``train``) write the launches each made into ``parts``."""
    from semi_seg_ecg_tpu_torch.algorithms import get_algorithm

    module = get_algorithm(algorithm)
    names = {"train_sup": "stage1", "prepare_semisup": "ranking",
             "train_semisup": "stage", "test": "test"} if \
        algorithm == "stpp" else {"train": "train", "test": "test"}
    saved = {name: getattr(module, name) for name in names}

    def counted(name, fn):
        def call(*args, **kwargs):
            before = launch_counts()
            out = fn(*args, **kwargs)
            part = names[name]
            if part == "stage":
                part += str(kwargs["stage_id"])
            parts[part] = {k: v - before[k] for k, v in launch_counts().items()}
            return out
        return call

    for name, fn in saved.items():
        setattr(module, name, counted(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def train_recipe(torch, phase, family, algorithm):
    """``train_main`` on a recipe (``write_train_config``) with the launch
    counters zeroed just before and read just after, held to the counts
    per step and per eval batch, part by part (``recipe_launches``); then
    its files (ST++'s stage snapshots and best checkpoints too), its log,
    the parameters' move, what the checkpoint holds beside the model, and
    the trained checkpoint served through ``inference_main``. Returns the
    result and the normalized config."""
    from semi_seg_ecg_tpu_torch.algorithms.common import init_model
    from semi_seg_ecg_tpu_torch.cli import inference_main, train_main
    from semi_seg_ecg_tpu_torch.config import normalize_config
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    config_path, config = write_train_config(family, algorithm)
    name = config["exp_name"]
    steps_per_epoch = TRAIN_LABELED // BATCH
    steps = steps_per_epoch * TRAIN_EPOCHS
    eval_batches = (TRAIN_EPOCHS * math.ceil(TRAIN_VALID / BATCH)
                    + math.ceil(TRAIN_TEST / BATCH))
    eval_depth = DEPTH if family == "vit_tiny" else 0
    per_step = launches_per_step(family, algorithm)
    want_parts = recipe_launches(family, algorithm)
    want = {k: sum(p[k] for p in want_parts.values()) for k in per_step}
    log(f"phase {phase}: train_main, {name} (device_augment, "
        f"{config['precision']}, batch {BATCH} + {BATCH}), {TRAIN_EPOCHS} "
        f"epochs of {steps_per_epoch} steps, then the test pass; entering "
        f"with {tf32_flags(torch)}")
    parts = {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    with launches_by_part(algorithm, parts):
        test_metrics = train_main(["-f", config_path])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = launch_counts()
    log(f"  train_main: {seconds:.2f} s, launches {launches} (expected "
        f"{want}: per step {per_step}; {eval_depth} forward per eval batch); "
        f"by part {parts} (expected {want_parts}); test metrics "
        f"{test_metrics}")
    if launches != want or parts != want_parts:
        raise SystemExit(f"phase {phase} failed: {name} launches "
                         f"{launches} by part {parts}, expected {want} by "
                         f"part {want_parts}")

    out_dir = os.path.join(WORK, "exps", name)
    stage_files = ((*(f"stage1/checkpoint-{e}.ckpt"
                      for e in range(1, TRAIN_EPOCHS + 1)),
                    "stage1/best-MeanIoU.ckpt", "stage2/best-MeanIoU.ckpt")
                   if algorithm == "stpp" else ())
    for f in ("log.txt", "best-loss.ckpt", "best-MeanIoU.ckpt",
              "test_metrics.csv", "test_outputs.npy", "test_labels.npy",
              *stage_files):
        if not os.path.exists(os.path.join(out_dir, f)):
            raise SystemExit(f"phase {phase} failed: {name}: train_main "
                             f"wrote no {f}")
    with open(os.path.join(out_dir, "log.txt")) as f:
        epochs = [json.loads(line) for line in f]
    if len(epochs) != TRAIN_EPOCHS or not all(
            math.isfinite(e[k]) for e in epochs for k in e
            if "loss" in k):
        raise SystemExit(f"phase {phase} failed: {name} log.txt epochs "
                         f"{epochs}")
    log(f"  log.txt: {[{k: round(v, 4) for k, v in e.items()} for e in epochs]}")

    normalized = normalize_config(copy.deepcopy(config))
    init = dict(init_model(normalized, torch.device("cpu"))
                .named_parameters())
    payload = ckpt.load_checkpoint(os.path.join(out_dir, "best-loss.ckpt"))
    trained = ckpt.model_state_dict(payload["model"])
    moved = max((trained[k] - v.detach()).abs().max().item()
                for k, v in init.items())
    if not moved > 0:
        raise SystemExit(f"phase {phase} failed: {name}: the parameters "
                         "did not move")
    extras = {"model_ema", "model_peer", "peer_optimizer"} & set(payload)
    if extras != CKPT_EXTRAS[algorithm]:
        raise SystemExit(f"phase {phase} failed: {name}: the checkpoint "
                         f"holds {extras} beside the model, expected "
                         f"{CKPT_EXTRAS[algorithm]}")

    reset_counts()
    probs = inference_main(["-f", config_path, "--model_path",
                            os.path.join(out_dir, "best-MeanIoU.ckpt"),
                            "--exp_name", f"{name}_served"])
    served = launch_counts()
    check_probs(f"{name}: served trained ckpt", probs, TRAIN_TEST)
    want_served = {"flash_attention_fwd": eval_depth * math.ceil(
        TRAIN_TEST / BATCH), "flash_attention_bwd": 0, "gather1d": 0}
    if served != want_served:
        raise SystemExit(f"phase {phase} failed: serving {name}'s "
                         f"checkpoint made {served} launches, expected "
                         f"{want_served}")
    log(f"  parameters moved by up to {moved:.4g}; checkpoint holds "
        f"{sorted(extras) or 'the model only'}; inference_main served "
        f"best-MeanIoU.ckpt with {served['flash_attention_fwd']} forward "
        "launches")
    return {"seconds": seconds, "launches": launches,
            "launches_expected": want, "launches_per_step": per_step,
            "launches_by_part": parts,
            "steps": steps, "eval_batches": eval_batches,
            "test_metrics": test_metrics, "log": epochs,
            "max_param_move": moved, "checkpoint_extras": sorted(extras),
            "served_launches": served["flash_attention_fwd"]}, normalized


def phase_train(torch):
    result, normalized = train_recipe(torch, 4, "vit_tiny", "fixmatch")
    result["gradients"] = check_gradients(torch, normalized)
    result["lockstep"] = check_lockstep(torch, normalized)
    result["augment"] = check_augment(torch, normalized)
    result["profile"] = {
        "bf16": profile_train_step(torch, normalized, "bf16"),
        "fp32": profile_train_step(torch, normalized, "fp32")}
    return result


def set_attention(model, impl):
    from semi_seg_ecg_tpu_torch.models.backbones.vision_transformer import (
        Attention,
    )

    for module in model.modules():
        if isinstance(module, Attention):
            module.attention_impl = impl


def device_batch(torch, seed, n=BATCH):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = lambda: torch.randn((n, 1, SIGNAL_LENGTH), generator=gen,
                            device="cuda")
    return {"ecg": x(), "target": torch.randint(
                0, 4, (n, SIGNAL_LENGTH), generator=gen, device="cuda"),
            "ecg_u_w": x(), "ecg_u_s": x()}


def check_gradients(torch, config):
    """One fp32 forward/backward of the full model in train mode through
    the flash kernels and through the dense path: every parameter's
    gradient agrees within GRAD_RTOL of its largest element."""
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        full_fp32,
        init_model,
    )
    from semi_seg_ecg_tpu_torch.ops.losses import cross_entropy

    cfg = copy.deepcopy(config)
    cfg["decode_head"]["FCNHead"]["dropout_ratio"] = 0.0
    model = init_model(cfg, torch.device("cuda")).train()
    batch = device_batch(torch, 5, n=2 * BATCH)
    grads = {}
    with full_fp32():
        for impl in ("flash", "xla"):
            set_attention(model, impl)
            model.zero_grad(set_to_none=True)
            loss = cross_entropy(model(batch["ecg"])["seg_logits"],
                                 batch["target"])
            loss.backward()
            grads[impl] = {k: p.grad.clone()
                           for k, p in model.named_parameters()}
    worst = max(((grads["flash"][k] - g).abs().max().item()
                 / max(g.abs().max().item(), 1e-30), k)
                for k, g in grads["xla"].items())
    log(f"  gradients, fp32, batch {2 * BATCH}, flash vs dense: worst "
        f"max|diff| / max|grad| {worst[0]:.3g} ({worst[1]})")
    if not worst[0] <= GRAD_RTOL:
        raise SystemExit(f"phase 4 failed: flash gradients differ from the "
                         f"dense path's by {worst[0]} of {worst[1]}")
    return {"worst_relative": worst[0], "worst_param": worst[1],
            "rtol": GRAD_RTOL}


def check_lockstep(torch, config, runs=(("flash", "cuda"), ("xla", "cuda")),
                   phase=4, sgd=False, conf_thresh=LOCKSTEP_CONF_THRESH,
                   steps=LOCKSTEP_STEPS):
    """``steps`` fp32 FixMatch steps from one init, dropout 0, on
    fixed batches (micro-steps under the config's ``accum_iter``), in two
    runs: ``(attention_impl, device)`` each (phase 4:
    the flash kernels against the dense path on the card; phase 5: the
    ResNet on the card against the CPU, ``attention_impl`` unused). With
    ``sgd`` the steps take SGD with momentum instead of the recipe's AdamW,
    whose first update is lr·sign(g): a gradient element within rounding
    noise of 0, of which a ResNet's BatchNorm-fed convs have many, moves by
    up to 2 lr either way."""
    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        Trainer,
        full_fp32,
        init_model,
    )

    results = {}
    for impl, device_name in runs:
        device = torch.device(device_name)
        cfg = copy.deepcopy(config)
        cfg["precision"] = "fp32"
        cfg["decode_head"]["FCNHead"]["dropout_ratio"] = 0.0
        if "vit_tiny" in cfg["backbone"]:
            cfg["backbone"]["vit_tiny"]["attention_impl"] = impl
        cfg["dataset"]["device_augment"] = False
        cfg["train"]["conf_thresh"] = conf_thresh
        if sgd:
            cfg["train"].update(optimizer="sgd",
                                optimizer_kwargs={"momentum": 0.9})
        with full_fp32():
            model = init_model(cfg, device)
            trainer = Trainer(cfg, fixmatch.SPEC, device, 4, model=model)
            metrics = [{k: v.item() for k, v in trainer.train_step(
                {k: v.to(device) for k, v in device_batch(
                    torch, 10 + s).items()}).items()}
                for s in range(steps)]
        results[impl] = (metrics, {k: v.detach().cpu().clone() for k, v in
                                   model.state_dict().items()})
    (m_f, sd_f), (m_d, sd_d) = (results[impl] for impl, _ in runs)
    what = " vs ".join(f"{impl} on {dev}" for impl, dev in runs)
    lr = config["train"]["lr"]
    worst_key_bias = worst_other = 0.0
    worst_name = None
    for k, v in sd_d.items():
        if not v.is_floating_point():
            continue
        err = (sd_f[k] - v).abs().max().item()
        if "running" in k:
            if err > 1e-4 + 1e-4 * v.abs().max().item():
                raise SystemExit(f"phase {phase} failed: lockstep {k} "
                                 f"{err}")
            continue
        err /= lr
        if k.endswith(KEY_BIAS):
            worst_key_bias = max(worst_key_bias, err)
        elif err > worst_other:
            worst_other, worst_name = err, k
    loss_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                   for a, b in zip(m_f, m_d)
                   for k in ("loss_x", "loss_u_s"))
    pixels = [(round(a["mask_ratio"] * BATCH * SIGNAL_LENGTH),
               round(b["mask_ratio"] * BATCH * SIGNAL_LENGTH))
              for a, b in zip(m_f, m_d)]
    accum = config["train"].get("accum_iter", 1)
    log(f"  lockstep, {steps} fp32 FixMatch steps "
        f"({'SGD' if sgd else 'AdamW'}, accum_iter {accum}), {what}: "
        f"params within "
        f"{worst_other:.3g} lr ({worst_name}), key bias "
        f"{worst_key_bias:.3g} lr; losses within {loss_rel:.3g} relative; "
        f"confident pixels {pixels}")
    if not (worst_other <= LOCKSTEP_TIGHT_ATOL_LR
            and worst_key_bias <= LOCKSTEP_ATOL_LR and loss_rel <= 1e-4
            and any(a > 0 for a, _ in pixels)
            and all(abs(a - b) <= 4 for a, b in pixels)):
        raise SystemExit(f"phase {phase} failed: the training steps of "
                         f"{what} disagree")
    return {"runs": [list(r) for r in runs], "sgd": sgd, "steps": steps,
            "accum_iter": accum,
            "params_lr": worst_other, "param": worst_name,
            "key_bias_lr": worst_key_bias, "loss_rel": loss_rel,
            "confident_pixels": pixels, "metrics": [m_f, m_d],
            "tight_atol_lr": LOCKSTEP_TIGHT_ATOL_LR,
            "atol_lr": LOCKSTEP_ATOL_LR}


def ulps_of(torch, got, want, mag):
    """|got - want| in fp32 ulps of the interpolated magnitude."""
    spacing = (torch.nextafter(mag, torch.full_like(mag, math.inf))
               - mag).double()
    return ((got.double() - want.double()).abs() / spacing).max().item()


def check_augment(torch, config):
    """One set of draws made on a CPU generator, applied on the card (the
    gather kernel) and on the CPU (its plain version): the resize-crop
    bit-equal where it reads whole samples, within one ulp where it
    interpolates, labels exact; the whole FixMatch augmentation within
    CHAIN_ATOL (sin and the standardize reductions of two libraries)."""
    from semi_seg_ecg_tpu_torch.ops import gather1d
    from semi_seg_ecg_tpu_torch.ops import preprocess as pre

    plan = pre.plan_device_augment(config["dataset"])
    cpu = {k: v.cpu() for k, v in device_batch(torch, 20).items()}
    del cpu["ecg_u_s"]
    draws = plan.sample(torch.Generator().manual_seed(0), cpu)
    cuda = {k: v.cuda() for k, v in cpu.items()}
    before = gather1d.LAUNCHES
    on_card = plan.apply(draws, cuda)
    torch.cuda.synchronize()
    launched = gather1d.LAUNCHES - before
    on_cpu = plan.apply(draws, cpu)
    chain = {k: (on_card[k].cpu().double() - on_cpu[k].double()).abs()
             .max().item() for k in ("ecg", "ecg_u_w", "ecg_u_s")}
    whole = max(chain.values())
    # each strong op alone, card vs CPU, on the CPU's weak view
    ra = config["dataset"]["strong_augmentations"][0]["RandAugment"]
    u = pre._apply_chain(draws["unlab"], [pre._make_device_op(
        *pre._entry_name_kwargs(e)) for e in
        config["dataset"]["augmentations"]], cpu["ecg_u_w"])[0]
    per_op = {}
    for entry, op_draws in zip(ra["ops"], draws["strong"][0]["ops"]):
        name, kw = pre._entry_name_kwargs(entry)
        op = pre._make_device_op(name, kw, level=ra.get("level", 10))
        a = op.apply(op_draws, u.cuda(), None)[0].cpu()
        b = op.apply(op_draws, u, None)[0]
        per_op[name] = (a.double() - b.double()).abs().max().item()
    labels_equal = torch.equal(on_card["target"].cpu(), on_cpu["target"])

    rrc = draws["lab"][0]
    kw = config["dataset"]["augmentations"][0]["random_resize_crop"]
    x_card, y_card = pre.random_resize_crop_apply(rrc, cuda["ecg"],
                                                  cuda["target"], **kw)
    x_cpu, y_cpu = pre.random_resize_crop_apply(rrc, cpu["ecg"],
                                                cpu["target"], **kw)
    mag, _ = pre.random_resize_crop_apply(rrc, cpu["ecg"].abs(), None, **kw)
    rrc_ulps = ulps_of(torch, x_card.cpu(), x_cpu, mag)
    rrc_equal = torch.equal(x_card.cpu(), x_cpu)
    log(f"  augmentation, CPU draws: card vs CPU resize-crop bit-equal "
        f"{rrc_equal} ({rrc_ulps:.3g} ulp), labels equal "
        f"{torch.equal(y_card.cpu(), y_cpu)} / {labels_equal}; whole "
        f"FixMatch chain max |diff| {chain}; strong ops alone {per_op}; "
        f"{launched} gather launches")
    if not (rrc_ulps <= 1.0 and torch.equal(y_card.cpu(), y_cpu)
            and labels_equal and whole <= CHAIN_ATOL
            and launched == RECIPE_GATHERS["fixmatch"]):
        raise SystemExit("phase 4 failed: the card's augmentation differs "
                         "from the CPU's on the same draws")
    return {"resize_crop_bit_equal": rrc_equal, "resize_crop_ulps": rrc_ulps,
            "labels_equal": labels_equal, "chain_max_abs_diff": chain,
            "strong_op_max_abs_diff": per_op,
            "gather_launches": launched}


def profile_train_step(torch, config, precision, phase=4,
                       family="vit_tiny", steps=10, algorithm="fixmatch",
                       region=None):
    """Where one step of ``algorithm`` (FixMatch unless given) goes at full
    width (``profile_step``): synchronized host-clock ms per
    ``Trainer.train_step`` (device augmentation included), the peak of
    allocated device memory, the launches a step and, from a trace of as
    many steps, device busy time, idle share, the top kernels, the
    per-step ms of each ported kernel and, with ``region`` (a context
    manager factory yielding ``trace_device``'s region), the region's
    device ms per step."""
    from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        Trainer,
        full_fp32,
        init_model,
    )

    cfg = copy.deepcopy(config)
    cfg["precision"] = precision
    batch = device_batch(torch, 30)
    del batch["ecg_u_s"]
    with full_fp32():
        trainer = Trainer(cfg, get_algorithm(algorithm).SPEC,
                          torch.device("cuda"), 4,
                          model=init_model(cfg, torch.device("cuda")))
        out = profile_step(lambda: trainer.train_step(batch), steps,
                           torch.device("cuda"), warmup=3, region=region,
                           launches=launch_counts)
    wall_ms, per_step = out["wall_ms_per_step"], out["launches_per_step"]
    out = {"algorithm": algorithm,
           "windows_per_s": 2 * BATCH / (wall_ms / 1e3), **out}
    log(f"  {algorithm} train step, {precision}, {BATCH} + {BATCH} windows: "
        f"{wall_ms:.3f} ms wall ({out['windows_per_s']:.1f} windows/s), "
        f"peak memory {out['peak_memory_mb']:.1f} MiB, "
        f"launches/step {per_step}; traced: "
        f"{out['device_events_per_step']} device events "
        f"({out['copy_kernels_per_step']} copy, "
        f"{out['elementwise_kernels_per_step']} other elementwise), "
        f"device busy {out['device_busy_ms_per_step']} ms, idle share "
        f"{out['device_idle_share']}; flash fwd "
        f"{out['flash_fwd_ms_per_step']} ms, flash bwd "
        f"{out['flash_bwd_ms_per_step']} ms, gather "
        f"{out['gather_ms_per_step']} ms per step")
    for kernel, ms in out["top_kernels_ms_per_step"] or []:
        log(f"    {ms:.4f} ms  {kernel[:80]}")
    want = launches_per_step(family, algorithm)
    if per_step != want:
        raise SystemExit(f"phase {phase} failed: {precision} step launches "
                         f"{per_step}, expected {want}")
    # a trace with device events must find each launched kernel by its name
    traced = out["device_busy_ms_per_step"] is not None
    unnamed = [k for k, kernel in (
        ("flash_fwd_ms_per_step", "flash_attention_fwd"),
        ("flash_bwd_ms_per_step", "flash_attention_bwd"),
        ("gather_ms_per_step", "gather1d"))
        if traced and want[kernel] and not out[k]]
    if region and traced and not out["region_ms_per_step"]:
        unnamed.append("region")
    if unnamed:
        raise SystemExit(f"phase {phase} failed: the {precision} step's "
                         f"trace holds no time under {unnamed}")
    return out


# ---------------------------------------------------------------------------
# Phase 5: ResNet18
# ---------------------------------------------------------------------------


def phase_resnet(torch):
    """ResNet18 + FCNHead at full width: serving, FixMatch training, three
    steps on the card against the CPU, step profiles, and the stem pool's
    tie routing."""
    config_path, config = write_slice_config("resnet18")
    model_path = os.path.join(WORK, "resnet18_seed0.pth")
    n_params = write_random_weights(config, model_path)
    n_batches = math.ceil(NUM_TEST / BATCH)
    log(f"phase 5: resnet18 + FCNHead ({n_params} parameters, stem and "
        f"base 64, four stages, FCN head 512 -> 128), {NUM_TEST} windows "
        f"of {SIGNAL_LENGTH} in {n_batches} batches of {BATCH}")
    runs = {}
    for name, override in (
            ("resnet_fp32", {}),
            ("resnet_amp", {"test": {"use_amp": True}}),
            ("resnet_fp32_cpu", {"device": "cpu"}),
            ("resnet_fp32_warm", {})):
        probs, counts, seconds = serve(config_path, model_path, name,
                                       **override)
        row_err = check_probs(name, probs)
        runs[name] = {"probs": probs, "launches": counts,
                      "seconds": seconds, "windows_per_s": NUM_TEST / seconds,
                      "row_sum_err": row_err}
        log(f"  {name}: launches {counts}, {seconds:.3f} s entry wall time, "
            f"{NUM_TEST / seconds:.2f} windows/s end to end")
        if any(counts.values()):
            raise SystemExit(f"phase 5 failed: serving ResNet18 launched "
                             f"{counts}; its path holds no ported kernel")
    ref = runs["resnet_fp32"]["probs"]
    diffs = {
        "card_vs_cpu_fp32": float(np.abs(ref - runs["resnet_fp32_cpu"]
                                         ["probs"]).max()),
        "amp_vs_fp32": float(np.abs(ref - runs["resnet_amp"]["probs"])
                             .max())}
    agree = float((ref.argmax(1) == runs["resnet_amp"]["probs"].argmax(1))
                  .mean())
    log(f"  max |diff|: {diffs}; bf16 autocast argmax agreement {agree:.5f}")
    if diffs["card_vs_cpu_fp32"] > 1e-4:
        raise SystemExit(f"phase 5 failed: card vs CPU fp32 "
                         f"{diffs['card_vs_cpu_fp32']} > 1e-4")
    if agree < 0.9:
        raise SystemExit(f"phase 5 failed: bf16 autocast agrees with fp32 "
                         f"on {agree:.3f} of the samples' classes")
    model = profile_models(torch, config, model_path)
    serving = {"runs": {name: {k: v for k, v in r.items() if k != "probs"}
                        for name, r in runs.items()},
               "diffs": diffs, "amp_argmax_agreement": agree,
               "batches": n_batches, "model": model}

    train, normalized = train_recipe(torch, 5, "resnet18", "fixmatch")
    train["lockstep"] = check_lockstep(
        torch, normalized, runs=(("card", "cuda"), ("cpu", "cpu")),
        phase=5, sgd=True, conf_thresh=RESNET_LOCKSTEP_CONF_THRESH)
    train["profile"] = {
        precision: profile_train_step(torch, normalized, precision, phase=5,
                                      family="resnet18")
        for precision in ("bf16", "fp32")}
    return {"serving": serving, "train": train,
            "pool": check_pool_ties(torch)}


def check_pool_ties(torch):
    """The ResNet stem's max pool (k3/s2/p1) on a tie-heavy input, flat
    lines of 10 equal samples with a spike every 37: the card's gradient
    equals the CPU's bit for bit (ties to the earliest element)."""
    from semi_seg_ecg_tpu_torch.models.backbones.resnet import resnet18

    b, c, t = POOL_SHAPE
    rng = np.random.default_rng(2)
    levels = rng.integers(-2, 3, (b, c, t // 10 + 1)).astype(np.float32)
    x = np.repeat(levels, 10, axis=-1)[..., :t]
    x[:, :, ::37] += rng.standard_normal(x[:, :, ::37].shape).astype(
        np.float32)
    g = torch.from_numpy(rng.standard_normal((b, c, (t + 1) // 2)).astype(
        np.float32))
    pool = resnet18(1).maxpool
    grads = {}
    for device in ("cuda", "cpu"):
        xt = torch.from_numpy(x).to(device).requires_grad_()
        pool(xt).backward(g.to(device))
        grads[device] = xt.grad.cpu()
    equal = torch.equal(grads["cuda"], grads["cpu"])
    routed = (grads["cpu"] != 0).float().mean().item()
    log(f"  stem max pool {POOL_SHAPE}, flat-line input: card gradient "
        f"bit-equal to the CPU's {equal}; {routed:.3f} of the inputs "
        "receive a gradient")
    if not equal:
        raise SystemExit("phase 5 failed: the card's max-pool gradient "
                         "routes ties unlike the CPU's")
    return {"shape": list(POOL_SHAPE), "bit_equal": equal,
            "routed_share": routed}


# ---------------------------------------------------------------------------
# Phase 6: Mean Teacher and CPS
# ---------------------------------------------------------------------------


def phase_algorithms(torch):
    return {f"{family}_{algorithm}": train_recipe(torch, 6, family,
                                                  algorithm)[0]
            for family in ("vit_tiny", "resnet18")
            for algorithm in ("mean_teacher", "cps")}


# ---------------------------------------------------------------------------
# Phase 7: ReCo and ST++
# ---------------------------------------------------------------------------


def reco_inputs(torch, config, seed=7):
    """The ReCo loss's inputs at a recipe step's shape, on the CPU: the
    strong half's latents (B, D, T), teacher probabilities peaked at a
    random class (confident at most pixels), student probabilities, one
    call's draws, and the recipe's thresholds."""
    from semi_seg_ecg_tpu_torch.ops import reco_loss as rl

    train = config["train"]
    gen = torch.Generator().manual_seed(seed)
    shape = (BATCH, 4, SIGNAL_LENGTH)
    latent = torch.randn(BATCH, config["projection_out_dim"], SIGNAL_LENGTH,
                         generator=gen)
    logits_t = torch.randn(shape, generator=gen)
    logits_t.scatter_add_(1, torch.randint(0, 4, (BATCH, 1, SIGNAL_LENGTH),
                                           generator=gen),
                          torch.full((BATCH, 1, SIGNAL_LENGTH), 3.0))
    prob_t = torch.softmax(logits_t, dim=1)
    prob_s = torch.softmax(torch.randn(shape, generator=gen), dim=1)
    q, n = train["contr_num_queries"], train["contr_num_negatives"]
    draws = rl.reco_draws(gen, 4, q, n, torch.device("cpu"))
    args = (train["eash_conf_thresh"], train["hard_conf_thresh"],
            train["contr_temp"])
    return latent, prob_t, prob_s, draws, args


def check_reco_loss(torch, config):
    """The ReCo loss at the recipe's shape (``reco_inputs``): one call on
    the card with host syncs raising (the backward's syncs are counted, not
    refused); the card's loss core fed the CPU's indices against the CPU's,
    value and latent gradient within 1e-5 relative; the card's own sampler
    against the CPU's on the same draws, each difference at a CDF step or a
    tie of class scores; the time of one call with its backward."""
    import warnings

    from semi_seg_ecg_tpu_torch.algorithms.common import full_fp32
    from semi_seg_ecg_tpu_torch.ops import reco_loss as rl

    latent, prob_t, prob_s, draws, (easy, hard, temp) = reco_inputs(
        torch, config)
    cuda = torch.device("cuda")
    p = BATCH * SIGNAL_LENGTH

    def flat(x):
        return x.transpose(1, 2).reshape(p, x.shape[1])

    with full_fp32():
        card_draws = rl.reco_draws(torch.Generator(device=cuda).manual_seed(
            7), 4, *draws.gumbel.shape[1:3], cuda)
        lat = latent.detach().to(cuda).requires_grad_()
        pt, ps = prob_t.to(cuda), prob_s.to(cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss = rl.compute_reco_loss(card_draws, lat, pt, ps, easy, hard,
                                        temp)
        except RuntimeError as e:
            raise SystemExit(f"phase 7 failed: the ReCo loss waits on the "
                             f"card: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                loss.backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        backward_syncs = sum("synchroniz" in str(w.message) for w in caught)

        results = []
        for device in (torch.device("cpu"), cuda):
            x = flat(latent.to(device)).requires_grad_()
            regions = rl.reco_regions(x.detach(), flat(prob_t.to(device)),
                                      flat(prob_s.to(device)), easy, hard)
            dev_draws = rl.RecoDraws(*(d.to(device) for d in draws))
            if not results:  # the CPU's indices, for both
                cpu_idx = rl.reco_sample(dev_draws, regions, temp)
            core = rl.reco_loss_core(x, regions.protos,
                                     *(i.to(device) for i in cpu_idx),
                                     regions.active, regions.valid_seg, temp)
            core.backward()
            results.append({
                "loss": core.item(), "grad": x.grad.cpu(),
                "pools": rl.masked_sample(regions.valid,
                                           dev_draws.pool_u).cpu(),
                "anchors": rl.masked_sample(regions.hard,
                                             dev_draws.anchor_u).cpu(),
                "scores": rl.negative_class_scores(dev_draws, regions,
                                                   temp).cpu(),
                "negatives": rl.reco_sample(dev_draws, regions,
                                            temp)[1].cpu(),
                "valid": regions.valid.cpu(), "hard": regions.hard.cpu(),
                "valid_seg": int(regions.valid_seg)})
    cpu, card = results
    value_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_rel = ((card["grad"] - cpu["grad"]).abs().max()
                / cpu["grad"].abs().max()).item()

    def off_step(got, want, mask, u):
        """Differing indices, and those not at a CDF step of the CPU's."""
        cdf = rl.masked_cdf(mask)
        rows, cols = (got != want).nonzero(as_tuple=True)
        step = torch.minimum(got, want)[rows, cols]
        gap = (cdf[rows, step] - u[rows, cols]).abs()
        return len(rows), int((gap > CDF_ROUNDING).sum())

    pools = off_step(card["pools"], cpu["pools"], cpu["valid"], draws.pool_u)
    anchors = off_step(card["anchors"], cpu["anchors"], cpu["hard"],
                       draws.anchor_u)
    cls_cpu = cpu["scores"].argmax(-1)
    cls_card = card["scores"].argmax(-1)
    top2 = cpu["scores"].topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= SCORE_TIE
    classes = (int((cls_card != cls_cpu).sum()),
               int(((cls_card != cls_cpu) & ~tie).sum()))
    q, n = draws.gumbel.shape[1:3]
    slot = torch.arange(q * n).view(q, n)
    pool_diff = (card["pools"] != cpu["pools"]).view(-1)
    explained = (cls_card != cls_cpu) | pool_diff[cls_cpu * q * n + slot] \
        | pool_diff[cls_card * q * n + slot]
    neg_diff = card["negatives"] != cpu["negatives"]
    negatives = (int(neg_diff.sum()), int((neg_diff & ~explained).sum()))

    on_card = latent.to(cuda)

    def loss_and_backward():  # the inputs on the card, as in a step
        x = on_card.detach().requires_grad_()
        rl.compute_reco_loss(card_draws, x, pt, ps, easy, hard,
                             temp).backward()

    with full_fp32():
        # few calls: their host enqueue stays inside event_ms's sleep
        ms = event_ms(loss_and_backward, 5)
        traced_ms, per_kernel, events, _, _, _ = trace_device(loss_and_backward, 10)
    busy_ms = sum(per_kernel.values()) if per_kernel else None
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = {"loss_cpu": cpu["loss"], "loss_card": card["loss"],
           "valid_seg": cpu["valid_seg"], "value_rel": value_rel,
           "grad_rel": grad_rel, "backward_syncs": backward_syncs,
           "sampler_differences": {
               "pools": pools, "anchors": anchors, "classes": classes,
               "negatives": negatives, "of": {
                   "pools": cpu["pools"].numel(),
                   "anchors": cpu["anchors"].numel(),
                   "negatives": cpu["negatives"].numel()}},
           "ms_with_backward": ms, "busy_ms_with_backward": busy_ms,
           "device_events": events,
           "top_kernels_ms": [(k[:80], v) for k, v in top]}
    log(f"  ReCo loss, latent {tuple(latent.shape)},"
        f" Q {q}, Nn {n}: no host sync in the call; backward syncs "
        f"{backward_syncs}; card core on the CPU's indices: loss "
        f"{card['loss']:.7g} vs {cpu['loss']:.7g} ({value_rel:.3g} rel), "
        f"gradient {grad_rel:.3g} of its largest; the card's sampler vs the "
        f"CPU's (differing, of them off a CDF step or score tie): pools "
        f"{pools}, anchors {anchors}, classes {classes}, negatives "
        f"{negatives}; {ms:.4f} ms a call with its backward, {events:.0f} "
        f"device events, {busy_ms} ms busy")
    for kernel, kernel_ms_ in top:
        log(f"    {kernel_ms_:.4f} ms  {kernel[:80]}")
    if not (value_rel <= 1e-5 and grad_rel <= 1e-5 and cpu["loss"] > 0
            and cpu["valid_seg"] > 1 and pools[1] == anchors[1]
            == classes[1] == negatives[1] == 0):
        raise SystemExit(f"phase 7 failed: the card's ReCo loss differs "
                         f"from the CPU's: {out}")
    return out


def phase_reco_stpp(torch):
    """ReCo and ST++ on both backbones through ``train_main``; the ReCo loss
    on the card; a profile of the ViT ReCo bf16 step, with the share of its
    busy time that the loss's draws, forward and backward take in its own
    trace."""
    recipes, configs = {}, {}
    for family in ("vit_tiny", "resnet18"):
        for algorithm in ("reco", "stpp"):
            name = f"{family}_{algorithm}"
            recipes[name], configs[name] = train_recipe(torch, 7, family,
                                                        algorithm)
    loss = check_reco_loss(torch, configs["vit_tiny_reco"])
    profile = profile_train_step(torch, configs["vit_tiny_reco"], "bf16",
                                 phase=7, algorithm="reco",
                                 region=functools.partial(reco_loss_region,
                                                          torch))
    busy, region_ms = (profile["device_busy_ms_per_step"],
                       profile["region_ms_per_step"])
    profile["reco_loss_busy_share"] = region_ms / busy if busy else None
    log(f"  the ReCo loss in the step (draws, forward, backward): "
        f"{region_ms} ms a step, {profile['reco_loss_busy_share']} of the "
        f"step's busy time")
    return {"recipes": recipes, "reco_loss": loss, "profile": profile}


# ---------------------------------------------------------------------------
# Phase 8: long-record serving
# ---------------------------------------------------------------------------


def holter_record(seconds, seed):
    """A (1, T) ECG-shaped record at ``FS``: a sharp pulse every 0.8 s
    (75 bpm), 0.05 Hz baseline wander and noise, from ``seed`` (the
    generator of ``tools/bench_holter.py``, its time axis in float64 so
    that a 24-hour record keeps its shape)."""
    n = int(round(seconds * FS))
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / FS
    beat_phase = (t % 0.8) / 0.8
    qrs = np.exp(-((beat_phase - 0.5) ** 2) / 2e-4)
    wander = 0.2 * np.sin(2 * np.pi * 0.05 * t)
    noise = rng.normal(0.0, 0.05, n)
    return (qrs + wander + noise).astype(np.float32)[None, :]


def save_record(name, seconds, seed):
    path = os.path.join(WORK, "longrec", f"{name}.npy")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    record = holter_record(seconds, seed)
    np.save(path, record)
    return path, record


def longrec_launches(family, total, hop=LONGREC_HOP):
    """The launches of one long-record entry: ``DEPTH`` flash forwards per
    batch of windows for the ViT (the last batch may be short), none for
    ResNet18, nothing else."""
    from semi_seg_ecg_tpu_torch.ops.stitch import plan_windows

    n_win = plan_windows(total, SIGNAL_LENGTH, hop, LONGREC_BATCH)[0]
    depth = DEPTH if family == "vit_tiny" else 0
    return {"flash_attention_fwd": depth * math.ceil(n_win / LONGREC_BATCH),
            "flash_attention_bwd": 0, "gather1d": 0}, n_win


def longrec_entry(torch, family, config_path, model_path, record_path,
                  name, *args, override=None):
    """One ``infer_longrec_main`` call with the launch counters zeroed just
    before and read just after, held to ``longrec_launches``; its outputs
    checked (shape, finite, rows summing to 1 within 1e-5, labels the
    argmax, the files it wrote). Returns the outputs and the run's
    numbers."""
    from semi_seg_ecg_tpu_torch.cli import infer_longrec_main

    out_dir = os.path.join(WORK, "longrec", name)
    argv = ["-f", config_path, "--model_path", model_path, "--record",
            record_path, "--batch", str(LONGREC_BATCH), "--out-dir",
            out_dir, *args]
    if override:
        override_path = os.path.join(WORK, "longrec", f"{name}.yaml")
        with open(override_path, "w") as f:
            yaml.safe_dump(override, f)
        argv += ["-o", override_path]
    total = np.load(record_path, mmap_mode="r").shape[-1]
    hop = int(args[args.index("--hop") + 1]) if "--hop" in args \
        else LONGREC_HOP
    want, n_win = longrec_launches(family, total, hop)
    if (override or {}).get("device") == "cpu":  # no kernel off the card
        want = dict.fromkeys(want, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    out = infer_longrec_main(argv)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    probs, labels = out["probs"], out["labels"]
    if probs.shape != (4, total) or labels.shape != (total,) or \
            not np.isfinite(probs).all():
        raise SystemExit(f"phase 8 failed: {name}: probs {probs.shape}, "
                         f"labels {labels.shape} for {total} samples, or "
                         "not finite")
    row_err = float(np.abs(probs.sum(axis=0) - 1.0).max())
    if row_err > 1e-5:
        raise SystemExit(f"phase 8 failed: {name}: probabilities sum to 1 "
                         f"+- {row_err}")
    if not np.array_equal(labels, probs.argmax(axis=0)):
        raise SystemExit(f"phase 8 failed: {name}: labels are not the "
                         "argmax of the probabilities")
    if not np.array_equal(np.load(os.path.join(out_dir, "labels.npy")),
                          labels):
        raise SystemExit(f"phase 8 failed: {name}: labels.npy differs from "
                         "the returned labels")
    if "--intervals" in args and not os.path.exists(
            os.path.join(out_dir, "intervals.csv")):
        raise SystemExit(f"phase 8 failed: {name}: no intervals.csv")
    if launches != want:
        raise SystemExit(f"phase 8 failed: {name}: launches {launches}, "
                         f"expected {want} ({n_win} windows, batch "
                         f"{LONGREC_BATCH})")
    hours = total / FS / 3600
    result = {"samples": total, "windows": n_win, "seconds": seconds,
              "windows_per_s": n_win / seconds,
              "ecg_hours_per_s": hours / seconds, "launches": launches,
              "peak_allocated_mib": peak_mb, "row_sum_err": row_err}
    log(f"  {name}: {total} samples, {n_win} windows, {seconds:.3f} s entry "
        f"wall time, {n_win / seconds:.1f} windows/s, "
        f"{hours / seconds:.3f} h of ECG/s, peak allocated "
        f"{peak_mb:.1f} MiB, launches {launches}")
    return out, result


def self_score(torch, family, config_path, model_path, record_path, name,
               labels, override=None):
    """The entry once more with ``--eval-labels`` on its own labels (and no
    blip filter): every boundary must match, sensitivity 1.0."""
    truth = os.path.join(WORK, "longrec", f"{name}_truth.npy")
    np.save(truth, labels)
    out, _ = longrec_entry(torch, family, config_path, model_path,
                           record_path, f"{name}_self", "--eval-labels",
                           truth, "--min-duration-ms", "0",
                           override=override)
    overall = out["delineation"]["overall"]
    if overall["sensitivity"] != 1.0 or overall["ppv"] != 1.0:
        raise SystemExit(f"phase 8 failed: {name}: --eval-labels on its "
                         f"own labels scores {overall}")
    return overall


def top2_ties(probs, tol):
    top2 = np.sort(probs, axis=0)[-2:]
    return (top2[1] - top2[0]) <= tol


def labels_off(got, want, probs, tol):
    """Samples whose labels differ where the top two probabilities are
    more than ``tol`` apart."""
    return int(((got != want) & ~top2_ties(probs, tol)).sum())


def serving_fn(config_path, model_path):
    from semi_seg_ecg_tpu_torch.config import load_config, normalize_config
    from semi_seg_ecg_tpu_torch.serving import make_serving_fn

    config = normalize_config(load_config(config_path))
    config["test"] = dict(config.get("test") or {}, model_path=model_path)
    return make_serving_fn(config)[0], config


def filtered(config, record):
    from semi_seg_ecg_tpu_torch.data.transforms import (
        get_transforms_from_config,
    )

    for t in get_transforms_from_config(config["dataset"]["filter"]):
        record = t(record)
    return np.ascontiguousarray(record, dtype=np.float32)


def check_single_cover(torch, config_path, model_path, record_path):
    """``hop = window`` with the flat taper on the card: the stitched field
    is the model's softmax on the pre-cut, standardized windows (w/w = 1)
    within 1e-6; the card's standardization against numpy's."""
    from semi_seg_ecg_tpu_torch.ops.stitch import standardize_windows

    out, run = longrec_entry(torch, "vit_tiny", config_path, model_path,
                             record_path, "single_cover", "--hop",
                             str(SIGNAL_LENGTH), "--taper", "flat")
    infer, config = serving_fn(config_path, model_path)
    x = filtered(config, np.load(record_path))
    wins = np.ascontiguousarray(
        x.reshape(1, -1, SIGNAL_LENGTH).transpose(1, 0, 2))
    on_card = standardize_windows(torch.from_numpy(wins).cuda())
    want = infer(on_card).cpu().numpy().transpose(1, 0, 2).reshape(4, -1)
    err = float(np.abs(out["probs"] - want).max())
    ref = (wins - wins.mean(axis=(1, 2), keepdims=True, dtype=np.float64)) \
        / wins.std(axis=(1, 2), keepdims=True, dtype=np.float64)
    std_err = float(np.abs(on_card.cpu().numpy() - ref).max())
    log(f"  single cover (hop {SIGNAL_LENGTH}, flat): stitched vs the "
        f"model's softmax on the standardized windows {err:.3g}; the "
        f"card's standardization vs float64 numpy {std_err:.3g}")
    if err > 1e-6 or std_err > 1e-5:
        raise SystemExit(f"phase 8 failed: single cover {err} > 1e-6 or "
                         f"standardization {std_err} > 1e-5")
    return dict(run, max_abs_err=err, standardize_err=std_err)


def check_streaming(torch, config_path, model_path):
    """``STREAMS`` live records of ``STREAM_S`` seconds pushed
    ``STREAM_CHUNK`` samples at a time through ``StreamingSegmenter``, the
    counters zeroed just before and read just after (``DEPTH`` flash
    forwards per window step); each stream against the offline stitcher on
    its record within ``STREAM_ATOL``."""
    from semi_seg_ecg_tpu_torch.ops.stitch import (
        overlap_add_infer,
        plan_windows,
    )
    from semi_seg_ecg_tpu_torch.serving import StreamingSegmenter

    infer, config = serving_fn(config_path, model_path)
    records = np.stack([filtered(config, holter_record(STREAM_S, 10 + s))
                        for s in range(STREAMS)])  # (S, 1, T)
    total = records.shape[-1]
    n_win = plan_windows(total, SIGNAL_LENGTH, LONGREC_HOP, 1)[0]
    want = {"flash_attention_fwd": DEPTH * n_win, "flash_attention_bwd": 0,
            "gather1d": 0}
    seg = StreamingSegmenter(infer, window=SIGNAL_LENGTH, hop=LONGREC_HOP,
                             num_streams=STREAMS)
    probs, labels, pushes = [], [], []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    for off in range(0, total, STREAM_CHUNK):
        t_push = time.perf_counter()
        p, l = seg.push(records[:, :, off:off + STREAM_CHUNK])
        if p.shape[-1]:
            pushes.append(time.perf_counter() - t_push)
        probs.append(p)
        labels.append(l)
    p, l = seg.flush()
    seconds = time.time() - t0
    launches = launch_counts()
    probs = np.concatenate(probs + [p], axis=2)
    labels = np.concatenate(labels + [l], axis=1)
    if launches != want or probs.shape != (STREAMS, 4, total):
        raise SystemExit(f"phase 8 failed: streaming launches {launches} "
                         f"(expected {want}: {n_win} window steps), probs "
                         f"{probs.shape}")
    errs, off_labels = [], 0
    for s in range(STREAMS):
        ref, ref_labels = overlap_add_infer(
            infer, records[s], window=SIGNAL_LENGTH, hop=LONGREC_HOP,
            batch=LONGREC_BATCH)
        ref, ref_labels = ref.cpu().numpy(), ref_labels.cpu().numpy()
        errs.append(float(np.abs(probs[s] - ref).max()))
        off_labels += labels_off(labels[s], ref_labels, ref, STREAM_ATOL)
    result = {"streams": STREAMS, "samples_per_stream": total,
              "window_steps": n_win, "seconds": seconds,
              "step_ms_mean": float(np.mean(pushes)) * 1e3,
              "step_ms_max": float(np.max(pushes)) * 1e3,
              "ecg_hours_per_s": STREAMS * total / FS / 3600 / seconds,
              "launches": launches, "max_abs_err_by_stream": errs,
              "labels_off": off_labels}
    log(f"  streaming: {STREAMS} streams x {total} samples in chunks of "
        f"{STREAM_CHUNK}, {n_win} window steps, {seconds:.3f} s "
        f"({result['step_ms_mean']:.3f} ms a push that runs a step, max "
        f"{result['step_ms_max']:.3f}), launches {launches}; vs the "
        f"offline stitcher max |diff| {max(errs):.3g}, labels off "
        f"{off_labels}")
    if max(errs) > STREAM_ATOL or off_labels:
        raise SystemExit(f"phase 8 failed: a stream differs from the "
                         f"offline stitcher: {errs}, {off_labels} labels")
    return result


def profile_longrec(torch, config_path, model_path, record, reps=3):
    """Where one hour's ``long_record_inference`` goes (checkpoint loaded
    before). Each timed call runs the path in its two stages, the host
    filter chain and then the rest (``long_record_inference`` on the
    filtered record with an empty filter chain), so the filter's share and
    the wall time come from the same ``reps`` calls; a trace of the second
    stage (the filter runs on the host and launches nothing) gives device
    busy time, the idle share over the whole wall and over the wall after
    the filter, and device events per batch of windows."""
    from semi_seg_ecg_tpu_torch.ops.stitch import plan_windows
    from semi_seg_ecg_tpu_torch.serving import long_record_inference

    infer, config = serving_fn(config_path, model_path)
    bare = dict(config, dataset=dict(config["dataset"], filter=[]))
    rest = lambda ecg: long_record_inference(bare, ecg, batch=LONGREC_BATCH,
                                             infer=infer)
    rest(filtered(config, record))
    filter_s, rest_s = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        ecg = filtered(config, record)
        t1 = time.perf_counter()
        rest(ecg)  # ends in the fetch of the result
        filter_s.append(t1 - t0)
        rest_s.append(time.perf_counter() - t1)
    filter_ms = float(np.mean(filter_s)) * 1e3
    after_ms = float(np.mean(rest_s)) * 1e3
    wall_ms = filter_ms + after_ms
    _, per_kernel, events, kinds, _, _ = trace_device(lambda: rest(ecg), reps)
    busy_ms = sum(per_kernel.values())
    batches = math.ceil(plan_windows(record.shape[-1], SIGNAL_LENGTH,
                                     LONGREC_HOP, 1)[0] / LONGREC_BATCH)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    return {"reps": reps, "wall_ms": wall_ms,
            "wall_ms_each": [1e3 * (f + r) for f, r in zip(filter_s, rest_s)],
            "filter_ms": filter_ms, "after_filter_ms": after_ms,
            "device_busy_ms": busy_ms if per_kernel else None,
            "device_idle_share": (1 - busy_ms / wall_ms) if per_kernel
            else None,
            "device_idle_share_after_filter": (
                1 - busy_ms / after_ms) if per_kernel else None,
            "device_events_per_batch": events / batches,
            "copy_kernels_per_batch": kinds["copy"] / batches,
            "flash_kernel_ms": kernel_ms(per_kernel, "flash_fwd_"),
            "top_kernels_ms": [(k[:80], v) for k, v in top]}


def phase_longrec(torch):
    """Long-record serving through ``infer-longrec`` at full width: the
    phase-4 ViT FixMatch checkpoint with flash attention (fp32 and bf16
    autocast) and phase 5's ResNet18 (fp32) on a 1-hour record; card
    against CPU on 2 minutes; the single-cover identity; eight live
    streams; a 6-hour Holter record per model, and a profile of 1 hour."""
    from semi_seg_ecg_tpu_torch.config import load_config

    vit = (os.path.join(WORK, "vit_tiny_fixmatch.yaml"),
           os.path.join(WORK, "exps", "vit_tiny_fixmatch",
                        "best-MeanIoU.ckpt"))
    resnet = (os.path.join(WORK, "resnet18_serving.yaml"),
              os.path.join(WORK, "resnet18_seed0.pth"))
    hour_path, hour = save_record("hour", HOUR_S, 1)
    log(f"phase 8: infer-longrec, windows of {SIGNAL_LENGTH} at hop "
        f"{LONGREC_HOP}, batch {LONGREC_BATCH}; entering with "
        f"{tf32_flags(torch)}")
    runs, scores = {}, {}
    outs = {}
    for name, family, paths, override in (
            ("vit_hour_fp32", "vit_tiny", vit, None),
            ("vit_hour_bf16", "vit_tiny", vit, {"test": {"use_amp": True}}),
            ("resnet_hour_fp32", "resnet18", resnet, None)):
        outs[name], runs[name] = longrec_entry(
            torch, family, *paths, hour_path, name, "--intervals",
            override=override)
        scores[name] = self_score(torch, family, *paths, hour_path, name,
                                  outs[name]["labels"], override=override)
    fp32, bf16 = outs["vit_hour_fp32"], outs["vit_hour_bf16"]
    agree = float((fp32["labels"] == bf16["labels"]).mean())
    amp_diff = float(np.abs(fp32["probs"] - bf16["probs"]).max())
    sensitivity = {k: v["sensitivity"] for k, v in scores.items()}
    log(f"  bf16 autocast vs fp32 (1 hour): argmax agreement {agree:.5f}, "
        f"max |diff| {amp_diff:.3g}; --eval-labels on their own labels: "
        f"sensitivity {sensitivity}")
    if agree < 0.9:
        raise SystemExit(f"phase 8 failed: bf16 autocast agrees with fp32 "
                         f"on {agree:.3f} of the samples' classes")

    short_path, _ = save_record("two_minutes", SHORT_S, 3)
    card, runs["vit_2min_fp32"] = longrec_entry(torch, "vit_tiny", *vit,
                                                short_path, "vit_2min_fp32")
    cpu, runs["vit_2min_cpu"] = longrec_entry(
        torch, "vit_tiny", *vit, short_path, "vit_2min_cpu",
        override={"device": "cpu"})
    cpu_diff = float(np.abs(card["probs"] - cpu["probs"]).max())
    cpu_off = labels_off(card["labels"], cpu["labels"], cpu["probs"],
                         LONGREC_CPU_ATOL)
    log(f"  2 minutes, card vs the CPU's plain path: max |diff| "
        f"{cpu_diff:.3g}, labels off {cpu_off}")
    if cpu_diff > LONGREC_CPU_ATOL or cpu_off:
        raise SystemExit(f"phase 8 failed: card vs CPU {cpu_diff} > "
                         f"{LONGREC_CPU_ATOL} or {cpu_off} labels off")
    single = check_single_cover(torch, *vit, short_path)
    streaming = check_streaming(torch, *vit)

    holter_path, holter = save_record("holter", HOLTER_S, 2)
    t0 = time.perf_counter()
    filtered(load_config(resnet[0]), holter)
    filter_s = time.perf_counter() - t0
    log(f"  {HOLTER_S // 3600} h record: {holter.shape[-1]} samples; the "
        f"filter chain "
        f"alone {filter_s:.3f} s on the host")
    for name, family, paths in (("vit_holter_fp32", "vit_tiny", vit),
                                ("resnet_holter_fp32", "resnet18", resnet)):
        _, runs[name] = longrec_entry(torch, family, *paths, holter_path,
                                      name)
        runs[name]["filter_s"] = filter_s
    profile = {"vit_tiny_fp32": profile_longrec(torch, *vit, hour),
               "resnet18_fp32": profile_longrec(torch, *resnet, hour)}
    for name, m in profile.items():
        each = ", ".join(f"{w:.1f}" for w in m["wall_ms_each"])
        log(f"  profile, 1 hour, {name}: {m['wall_ms']:.1f} ms wall, mean "
            f"of {m['reps']} ({each}; filter {m['filter_ms']:.1f} ms), "
            f"device busy "
            f"{m['device_busy_ms']} ms, idle share {m['device_idle_share']} "
            f"({m['device_idle_share_after_filter']} after the filter), "
            f"{m['device_events_per_batch']:.1f} device events a batch "
            f"({m['copy_kernels_per_batch']:.1f} copy), flash "
            f"{m['flash_kernel_ms']} ms")
        for kernel, ms in m["top_kernels_ms"]:
            log(f"    {ms:.4f} ms  {kernel}")
    return {"runs": runs, "self_scores": scores,
            "amp_argmax_agreement": agree, "amp_max_abs_diff": amp_diff,
            "card_vs_cpu_max_abs_diff": cpu_diff, "single_cover": single,
            "streaming": streaming, "holter_filter_s": filter_s,
            "profile": profile}


# ---------------------------------------------------------------------------
# Phase 9: the serving deployment
# ---------------------------------------------------------------------------


def deploy_config(family, model_path, **override):
    """The serving config of ``family`` at full width (the ViT's with flash
    attention; the shipped scratch recipe's model, which is every recipe's)
    on phase 3's synthetic test split (``NUM_TEST`` windows, batch
    ``BATCH``), serving ``model_path``; ``override`` on top."""
    from semi_seg_ecg_tpu_torch.config import normalize_config

    _, config = write_slice_config(family)
    config = normalize_config(copy.deepcopy(config))
    config["test"] = dict(config.get("test") or {}, model_path=model_path)
    config["exp_name"] = f"deploy_{family}"
    return {**config, **override}


def timed_export(torch, config, path, flash=False, **kwargs):
    """``export_serving`` with the launch counters zeroed before and read
    after: tracing launches nothing, so the only launches are the
    calibration forwards of ``quantize_calibration`` batches (``DEPTH``
    flash forwards each for the ViT, ``flash``); returns the header and
    seconds."""
    from semi_seg_ecg_tpu_torch.serving import export_serving

    n_cal = int(config.get("quantize_calibration", 0) or 0) \
        if config.get("quantize") == "int8" else 0
    want = {"flash_attention_fwd": DEPTH * n_cal if flash else 0,
            "flash_attention_bwd": 0, "gather1d": 0}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    header = export_serving(config, path, **kwargs)
    seconds = time.perf_counter() - t0
    if launch_counts() != want:
        raise SystemExit(f"phase 9 failed: exporting {path} launched "
                         f"{launch_counts()}, expected {want} (the "
                         "calibration forwards; tracing launches none)")
    return header, seconds


def card_batch(torch, n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(n, 1, SIGNAL_LENGTH, generator=gen, device="cuda")


def served(torch, serve, x, flash):
    """``serve(x)`` with the counters zeroed before and read after: ``DEPTH``
    flash forwards a call for the ViT (``flash``), none for ResNet18, and
    no other launch."""
    torch.cuda.synchronize()
    reset_counts()
    out = serve(x)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {"flash_attention_fwd": DEPTH if flash else 0,
            "flash_attention_bwd": 0, "gather1d": 0}
    if counts != want:
        raise SystemExit(f"phase 9 failed: a call of batch {x.shape[0]} "
                         f"launched {counts}, expected {want}")
    return out


def int8_agreement(fp32, int8):
    """The JAX package's int8 rule (``tests/test_quantization.py``): argmax
    agreement overall, and where the fp32 margin (top two log-probabilities:
    the logits' margin) is above its median."""
    pred_fp, pred_q = fp32.argmax(1), int8.argmax(1)
    top2 = np.sort(np.log(np.maximum(fp32, 1e-30)), axis=1)[:, -2:, :]
    margin = top2[:, 1] - top2[:, 0]
    confident = margin > np.median(margin)
    return (float((pred_fp == pred_q).mean()),
            float((pred_fp == pred_q)[confident].mean()))


def int8_layers_on(model, fn, x):
    """``fn(x)`` with each int8 layer of ``model`` recording its input and
    output: ``(out, {name: (input, output)})``."""
    from semi_seg_ecg_tpu_torch.models.quant_layers import int8_modules

    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: seen.__setitem__(
            name, (args[0].detach(), out.detach())))
        for name, m in int8_modules(model)]
    try:
        out = fn(x)
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def int8_card_vs_cpu(torch, card, cpu, x):
    """The int8 model on the card (``ServingFn`` ``card``) against the same
    weights on the CPU (``cpu``) on batch ``x``: each int8 layer of the
    CPU model run on the card layer's own input (and the card's absmax,
    where calibrated) within ``INT8_LAYER_RTOL`` of the card layer's
    output; the codes of the layers' inputs in the two whole runs (flips
    from the fp32 arithmetic ahead of them); the whole outputs by the
    int8 rule (``int8_agreement``)."""
    from semi_seg_ecg_tpu_torch.models.quant_layers import int8_modules
    from semi_seg_ecg_tpu_torch.ops import quant

    got, card_seen = int8_layers_on(card.model, card, x)
    want, cpu_seen = int8_layers_on(cpu.model, cpu, x.cpu())
    cpu_layers = dict(int8_modules(cpu.model))
    layer_err, flips = 0.0, []
    with torch.no_grad():
        for name, (x_card, y_card) in card_seen.items():
            layer = cpu_layers[name]
            saved = layer.act_absmax
            card_absmax = dict(int8_modules(card.model))[name].act_absmax
            layer.act_absmax = (None if card_absmax is None
                                else card_absmax.cpu())
            try:
                y_cpu = layer(x_card.cpu())
            finally:
                layer.act_absmax = saved
            ref = y_card.cpu().float()
            layer_err = max(layer_err, ((y_cpu.float() - ref).abs().max()
                                        / ref.abs().max()).item())
            q_card, _ = quant.quantize_symmetric(x_card.cpu())
            q_cpu, _ = quant.quantize_symmetric(cpu_seen[name][0])
            flips.append(int((q_card != q_cpu).sum()))
    got, want = got.cpu().numpy(), want.numpy()
    agree, confident = int8_agreement(want, got)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    first = next((i for i, f in enumerate(flips) if f), None)
    return {"layer_max_rel_err": layer_err, "code_flips_by_layer": flips,
            "first_layer_with_flips": first, "rel_norm": rel,
            "argmax_agreement": agree, "argmax_agreement_confident":
            confident}


def activation_reductions(torch, fn, x):
    """``aten.amax`` calls over a whole tensor in one call of ``fn`` (the
    int8 layers' per-tensor activation scales; the weights' are per output
    channel), counted at the dispatcher."""
    from torch.utils._python_dispatch import TorchDispatchMode

    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.ops.aten.amax.default:
                dims = args[1] if len(args) > 1 else kwargs.get("dim", ())
                if len(dims) == args[0].dim():
                    count[0] += 1
            return func(*args, **kwargs)

    with Count():
        fn(x)
    torch.cuda.synchronize()
    return count[0]


def http_round_trip(port, x, reps=5):
    """POST ``x`` as ``.npy`` to the server ``reps`` times; the answer and
    the ms of each round trip."""
    import io
    import urllib.request

    buf = io.BytesIO()
    np.save(buf, x)
    body, ms = buf.getvalue(), []
    for _ in range(reps):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict",
                                     data=body, method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            out = np.load(io.BytesIO(r.read()))
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def check_http(torch, path, header):
    """``make_http_server`` on 127.0.0.1:0 in a thread: the metadata is the
    header, a POST of 37 rows answers the artifact's own ``serve_batched``
    within 1e-6, a wrong shape gets 400; round trips of 16 and 64 rows."""
    import json as json_
    import threading
    import urllib.error
    import urllib.request

    from semi_seg_ecg_tpu_torch.serving import (
        load_serving,
        make_http_server,
        serve_batched,
    )

    buckets = (16, 64)
    server = make_http_server(path, port=0, bucket_sizes=buckets)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/metadata", timeout=60) as r:
            meta = json_.loads(r.read())
        if {k: meta[k] for k in header} != header or \
                meta["bucket_sizes"] != list(buckets):
            raise SystemExit(f"phase 9 failed: /v1/metadata {meta} is not "
                             f"the header {header}")
        x = card_batch(torch, 37, 7).cpu().numpy()
        got, _ = http_round_trip(port, x, reps=1)
        serve, _ = load_serving(path)
        want = serve_batched(serve, x, buckets)
        err = float(np.abs(got - want).max())
        try:
            bad = np.zeros((2, 1, SIGNAL_LENGTH + 1), np.float32)
            http_round_trip(port, bad, reps=1)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        times = {n: http_round_trip(port, card_batch(torch, n, n).cpu()
                                    .numpy())[1] for n in (16, 64)}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    log(f"  HTTP: metadata = header, POST of 37 rows vs the artifact's "
        f"serve_batched max |diff| {err:.3g}, wrong shape -> {code}; round "
        f"trip ms: 16 rows {[round(t, 3) for t in times[16]]}, 64 rows "
        f"{[round(t, 3) for t in times[64]]}")
    if err > 1e-6 or code != 400:
        raise SystemExit(f"phase 9 failed: HTTP predict off by {err} or a "
                         f"wrong shape answered {code}")
    return {"predict_37_max_abs_diff": err, "wrong_shape_code": code,
            "round_trip_ms": {str(n): t for n, t in times.items()},
            "alive_after_shutdown": thread.is_alive()}


# phase 9's int8 artifacts: (family, flash, kind of scale, calibration
# batches)
INT8_FORMS = (("vit_tiny", True, "dynamic", 0),
              ("resnet18", False, "static", 2))


def phase_deploy(torch, vit_model, resnet_model):
    """The serving deployment at full width: ``export_serving`` of the ViT
    (``vit_model``, flash attention) and of ResNet18 (``resnet_model``),
    fp32, bf16 autocast, int8 with dynamic and calibrated scales;
    ``load_serving``; the HTTP server; the 1 h record under int8; the
    timings of each serving form at batches 16 and 64."""
    from semi_seg_ecg_tpu_torch.models.quant_layers import int8_modules
    from semi_seg_ecg_tpu_torch.serving import load_serving, make_serving_fn

    art = os.path.join(WORK, "artifacts")
    os.makedirs(art, exist_ok=True)
    t_phase = time.perf_counter()
    models = {"vit_tiny": vit_model, "resnet18": resnet_model}
    log(f"phase 9: the serving deployment; vit_tiny from {vit_model}, "
        f"resnet18 from {resnet_model}; entering with {tf32_flags(torch)}")
    result, exports, serve_fns = {}, {}, {}

    # fp32 artifacts of both backbones against ServingFn
    for family, flash in (("vit_tiny", True), ("resnet18", False)):
        config = deploy_config(family, models[family])
        path = os.path.join(art, f"{family}_fp32.pt2")
        header, seconds = timed_export(torch, config, path, flash)
        serve, loaded = load_serving(path)
        infer, _ = make_serving_fn(config)
        if loaded != header or header["input_shape"] != [
                None, 1, SIGNAL_LENGTH] or header["precision"] != "fp32":
            raise SystemExit(f"phase 9 failed: {family} header {header}, "
                             f"loaded {loaded}")
        errs = {}
        for n in (1, 16, 37, 64):
            x = card_batch(torch, n, n)
            got = served(torch, serve, x, flash)
            per_call = launch_counts()
            with torch.inference_mode():
                want = infer(x)
            errs[n] = (got - want).abs().max().item()
            row = (got.sum(dim=1) - 1).abs().max().item()
            if got.shape != (n, 4, SIGNAL_LENGTH) or errs[n] > 1e-5 or \
                    row > 1e-5:
                raise SystemExit(f"phase 9 failed: {family} artifact at "
                                 f"batch {n}: {tuple(got.shape)}, vs "
                                 f"ServingFn {errs[n]}, rows {row}")
        result.setdefault("launches_per_call", {})[family] = per_call
        log(f"  {family} fp32: exported in {seconds:.2f} s "
            f"({os.path.getsize(path)} bytes), no launch while tracing; "
            f"batches 1/16/37/64 with {DEPTH if flash else 0} flash "
            f"forwards a call; vs ServingFn max |diff| {errs}")
        exports[f"{family}_fp32"] = {"seconds": seconds,
                                     "bytes": os.path.getsize(path),
                                     "vs_serving_fn": errs}
        serve_fns[family] = {"serving_fn_fp32": infer, "artifact_fp32": serve}

    # a pinned batch refuses another; bf16 autocast states its precision
    config = deploy_config("resnet18", resnet_model)
    path = os.path.join(art, "resnet18_b16.pt2")
    header, _ = timed_export(torch, config, path, batch_size=BATCH)
    serve, _ = load_serving(path)
    served(torch, serve, card_batch(torch, BATCH, 1), False)
    try:
        serve(card_batch(torch, 37, 1))
        raise SystemExit("phase 9 failed: the pinned artifact served 37")
    except ValueError as e:
        refused = str(e)
    config = deploy_config("vit_tiny", vit_model, test={
        "model_path": vit_model, "use_amp": True})
    path = os.path.join(art, "vit_tiny_amp.pt2")
    header, seconds = timed_export(torch, config, path, True)
    amp, _ = load_serving(path)
    test_x = torch.from_numpy(np.concatenate(_test_batches(config))).cuda()
    probs_fp32 = serve_fns["vit_tiny"]["artifact_fp32"](test_x).cpu().numpy()
    probs_amp = served(torch, amp, test_x, True).cpu().numpy()
    amp_agree = float((probs_fp32.argmax(1) == probs_amp.argmax(1)).mean())
    log(f"  pinned batch {BATCH}: refuses 37 ({refused}); bf16 autocast "
        f"artifact: header precision {header['precision']}, exported in "
        f"{seconds:.2f} s, argmax agreement with fp32 {amp_agree:.5f} on "
        f"{test_x.shape[0]} test windows")
    if header["precision"] != "bf16" or amp_agree < 0.9:
        raise SystemExit(f"phase 9 failed: bf16 artifact header "
                         f"{header['precision']}, agreement {amp_agree}")
    result["pinned_refusal"] = refused
    result["amp"] = {"precision": header["precision"],
                     "argmax_agreement": amp_agree}

    # int8, each backbone once and each kind of scale once (the ViT's
    # dynamic, ResNet18's calibrated; phase 16 serves the other two forms
    # under its meshes): card against the CPU, int8 against fp32, the
    # calibrated graph without activation reductions
    int8 = {}
    for family, flash, kind, n_cal in INT8_FORMS:
        override = {"quantize": "int8", "quantize_calibration": n_cal}
        config = deploy_config(family, models[family], **override)
        path = os.path.join(art, f"{family}_int8_{kind}.pt2")
        header, seconds = timed_export(torch, config, path, flash)
        serve, _ = load_serving(path)
        infer, model = make_serving_fn(config)
        cpu, _ = make_serving_fn({**config, "device": "cpu"})
        x = torch.from_numpy(_test_batches(config)[0]).cuda()
        got = served(torch, serve, x, flash)
        with torch.inference_mode():
            eager = infer(x)
        vs_eager = (got - eager).abs().max().item()
        vs_cpu = int8_card_vs_cpu(torch, infer, cpu, x)
        n_layers = len(int8_modules(model))
        reductions = activation_reductions(torch, serve, x)
        entry = {"export_s": seconds, "act_scales": header["act_scales"],
                 "card_vs_cpu": vs_cpu,
                 "artifact_vs_serving_fn": vs_eager,
                 "int8_layers": n_layers,
                 "activation_reductions_per_call": reductions}
        if family == "vit_tiny":
            fp32 = serve_fns[family]["artifact_fp32"](test_x)
            q = served(torch, serve, test_x, flash)
            entry["vs_fp32_agreement"], entry["vs_fp32_confident"] = \
                int8_agreement(fp32.cpu().numpy(), q.cpu().numpy())
        log(f"  {family} int8 {kind}: exported in {seconds:.2f} s, "
            f"header act_scales {header['act_scales']}; card vs CPU: "
            f"each layer on the card's input within "
            f"{vs_cpu['layer_max_rel_err']:.3g} relative, code flips "
            f"from the first at layer {vs_cpu['first_layer_with_flips']}"
            f" ({sum(vs_cpu['code_flips_by_layer'])} in all), whole "
            f"model rel norm {vs_cpu['rel_norm']:.3g}, argmax agreement "
            f"{vs_cpu['argmax_agreement']:.5f}, "
            f"{vs_cpu['argmax_agreement_confident']:.5f} where "
            f"confident; artifact vs ServingFn {vs_eager:.3g}; "
            f"{reductions} activation reductions a call "
            f"({n_layers} int8 layers)"
            + (f"; vs fp32 agreement {entry['vs_fp32_agreement']:.5f}, "
               f"{entry['vs_fp32_confident']:.5f} where confident"
               if family == "vit_tiny" else ""))
        if header["act_scales"] != kind or vs_eager > 1e-5 or \
                vs_cpu["layer_max_rel_err"] > INT8_LAYER_RTOL or \
                vs_cpu["argmax_agreement"] <= INT8_AGREE or \
                vs_cpu["argmax_agreement_confident"] \
                <= INT8_AGREE_CONFIDENT or \
                vs_cpu["rel_norm"] >= INT8_REL_NORM or \
                reductions != (0 if n_cal else n_layers):
            raise SystemExit(f"phase 9 failed: {family} int8 {kind}: "
                             f"{entry}")
        if family == "vit_tiny" and (
                entry["vs_fp32_agreement"] <= INT8_AGREE
                or entry["vs_fp32_confident"] <= INT8_AGREE_CONFIDENT):
            raise SystemExit(f"phase 9 failed: int8 ViT vs fp32 "
                             f"{entry}")
        int8[f"{family}_{kind}"] = entry
        serve_fns[family][f"artifact_int8_{kind}"] = serve
    result["int8"] = int8

    result["http"] = check_http(
        torch, os.path.join(art, "vit_tiny_fp32.pt2"),
        load_serving(os.path.join(art, "vit_tiny_fp32.pt2"))[1])

    # the 1 h record under int8 (dynamic scales), both backbones
    hour_path, _ = save_record("hour_int8", HOUR_S, 1)
    longrec = {}
    for family in models:
        _, longrec[family] = longrec_entry(
            torch, family, write_slice_config(family)[0], models[family],
            hour_path, f"{family}_hour_int8", override={"quantize": "int8"})
    result["longrec_int8"] = longrec

    timings = {}
    for family, fns in serve_fns.items():
        for form, fn in fns.items():
            for n in (BATCH, 64):
                x = card_batch(torch, n, 90 + n)
                m = profile_forward(lambda: fn(x), n, SERVE_PROFILE_STEPS,
                                    x.device, top=1)
                timings[f"{family}/{form}/{n}"] = m
                log(f"  {family} {form} batch {n}: {m['wall_ms']:.3f} ms "
                    f"wall ({m['windows_per_s']:.1f} windows/s), busy "
                    f"{m['device_busy_ms']} ms, idle share "
                    f"{m['device_idle_share']}, {m['device_events']:.0f} "
                    f"device events ({m['copy_kernels']:.0f} copy), top "
                    f"{m['top_kernels']}")
    result["timings"] = timings
    result["exports"] = exports
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 9 in {result['seconds']:.1f} s")
    return result


def _test_batches(config):
    from semi_seg_ecg_tpu_torch.serving import _calibration_batches

    return _calibration_batches(config, NUM_TEST)


# ---------------------------------------------------------------------------
# Phase 10: data-parallel training
# ---------------------------------------------------------------------------

# two ranks; the step comparison gives each DP_ROWS rows of DP_STEPS global
# batches and trains by SGD with momentum, whose update is proportional to
# the gradient (AdamW's first update lr·sign(g) would move a parameter whose
# gradient is rounding noise, the ViT's key bias among them, by O(lr)
# either way); losses, parameters and BatchNorm statistics within the JAX
# package's bound for a sharded step against one device
# (tests/test_parallel.py)
DP_WORLD, DP_ROWS, DP_STEPS = 2, 8, 3
DP_LOSS_RTOL, DP_RTOL, DP_ATOL = 1e-5, 5e-4, 1e-5
# confident pixels may differ where the ranks' smaller eval batch rounds a
# confidence to the other side of the threshold
DP_PIXELS = 4
# the recipes trained by 2-rank train_main, one epoch each
DP_RECIPES = ("fixmatch", "cps", "reco")
DP_SNAPSHOT_SEEDS = (21, 22, 23)
DP_TIMEOUT = 600


def dp_layout(torch):
    """``(backend, description)``: NCCL over two cards where there are two,
    else gloo with CUDA tensors on one card (NCCL refuses two ranks on one
    device)."""
    if torch.cuda.device_count() >= DP_WORLD:
        return "nccl", (f"{DP_WORLD} ranks on cuda:0-{DP_WORLD - 1}, "
                        "launched by torch.distributed.run")
    return "gloo", (f"{DP_WORLD} ranks on cuda:0 (one card), each with "
                    "LOCAL_RANK=0, started by chip_smoke.py")


def dp_step_config(family, backend, algorithm="fixmatch"):
    """The family's FixMatch recipe (or ``algorithm``'s) for the step
    comparison: fp32, no dropout, no warmup, SGD with momentum, device
    augmentation (and flash attention for the ViT)."""
    from semi_seg_ecg_tpu_torch.config import normalize_config

    _, config = write_train_config(family, algorithm)
    cfg = normalize_config(copy.deepcopy(config))
    cfg["precision"] = "fp32"
    cfg["decode_head"]["FCNHead"]["dropout_ratio"] = 0.0
    cfg["train"].update(
        warmup_epochs=0, optimizer="sgd", optimizer_kwargs={"momentum": 0.9},
        conf_thresh=(LOCKSTEP_CONF_THRESH if family == "vit_tiny"
                     else RESNET_LOCKSTEP_CONF_THRESH))
    cfg["ddp"] = {"dist_backend": backend}
    return cfg


def dp_global_batches(seed):
    """DP_STEPS global batches of DP_WORLD x DP_ROWS rows, as the loader
    hands them to a device-augment step (the strong view is built on the
    card)."""
    rng = np.random.default_rng(seed)
    n = DP_WORLD * DP_ROWS
    x = lambda: rng.standard_normal((n, 1, SIGNAL_LENGTH)).astype(np.float32)
    return [{"ecg": x(), "target": rng.integers(0, 4, (n, SIGNAL_LENGTH)),
             "ecg_u_w": x()} for _ in range(DP_STEPS)]


def dp_steps(torch, config, batches, rows=None):
    """DP_STEPS steps of the config's algorithm (FixMatch in every recipe
    of ``dp_step_config`` but phase 16's ReCo) of the seed-0 model on
    ``rows`` of each global batch (default: this rank's data rank's share
    under the config's mesh): the metrics of each step (their mean over the data
    ranks under a process group), the launches of each step, the final
    state (gathered over the model axis), the checkpoint's layout (keys and
    shapes of the model and the optimizer state, as
    ``Trainer.checkpoint_state`` gathers them for rank 0 to write) and the
    rank's parameter and optimizer bytes and peak memory."""
    from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        Trainer,
        full_fp32,
        init_model,
    )
    from semi_seg_ecg_tpu_torch.parallel import mesh as pmesh
    from semi_seg_ecg_tpu_torch.parallel.dist import (
        all_reduce_mean,
        data_rank,
        data_size,
    )
    from semi_seg_ecg_tpu_torch.parallel.sharding_rules import (
        full_state_dict,
    )

    if rows is None:
        pmesh.make_mesh(config)
        per = batches[0]["ecg"].shape[0] // data_size()
        rows = slice(data_rank() * per, (data_rank() + 1) * per)
    device = torch.device("cuda", torch.cuda.current_device())
    metrics, launches = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with full_fp32():
        trainer = Trainer(copy.deepcopy(config),
                          get_algorithm(config["algorithm"]).SPEC, device, 4,
                          model=init_model(config, device))
        for batch in batches:
            on_card = {k: torch.from_numpy(v[rows]).to(device)
                       for k, v in batch.items()}
            torch.cuda.synchronize()
            reset_counts()
            step = trainer.train_step(on_card)
            launches.append(launch_counts())
            metrics.append({k: all_reduce_mean(v).item()
                            for k, v in step.items()})
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    state = {k: v.detach().cpu().numpy()
             for k, v in full_state_dict(trainer.model).items()}
    saved = trainer.checkpoint_state()
    layout = {"model": {k: list(v.shape) for k, v in saved["model"].items()},
              "optimizer": {int(i): {k: list(np.shape(v)) for k, v in
                                     entry.items()}
                            for i, entry in saved["optimizer"][
                                "state"].items()}}
    opt_state = trainer.optimizer.optimizer.state.values()
    memory = {"param_bytes": sum(p.numel() * p.element_size()
                                 for p in trainer.model.parameters()),
              "optimizer_bytes": sum(v.numel() * v.element_size()
                                     for entry in opt_state
                                     for v in entry.values()
                                     if torch.is_tensor(v)),
              "peak_memory_mb": peak_mb}
    return {"metrics": metrics, "launches": launches, "state": state,
            "checkpoint_layout": layout, "memory": memory}


def dp_entry_config(algorithm, backend):
    """The vit_tiny recipe of ``algorithm`` as phase 4 trains it (bf16,
    flash, device augmentation, phase 4's split), for one epoch, with the
    layout's backend."""
    _, config = write_train_config("vit_tiny", algorithm)
    config["train"]["epochs"] = 1
    config["exp_name"] = f"dp_vit_tiny_{algorithm}"
    config["ddp"] = {"dist_backend": backend}
    path = os.path.join(WORK, f"dp_vit_tiny_{algorithm}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def dp_entry_launches(algorithm):
    """A rank's launches in one epoch of ``algorithm``'s train_main: its
    steps, and one eval batch of its shards of the validation and the test
    splits."""
    steps = TRAIN_LABELED // (DP_WORLD * BATCH)
    evals = (math.ceil(TRAIN_VALID / DP_WORLD / BATCH)
             + math.ceil(TRAIN_TEST / DP_WORLD / BATCH))
    want = {k: steps * v for k, v in
            launches_per_step("vit_tiny", algorithm).items()}
    want["flash_attention_fwd"] += DEPTH * evals
    return want


def dp_train(torch, config_path):
    from semi_seg_ecg_tpu_torch.cli import train_main

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    metrics = train_main(["-f", config_path])
    torch.cuda.synchronize()
    return {"seconds": time.time() - t0, "launches": launch_counts(),
            "test_metrics": metrics}


def dp_snapshots():
    """Three seeded vit_tiny models saved as ST++ stage-1 snapshots, and
    the config that ranks phase 4's unlabeled split with them."""
    from semi_seg_ecg_tpu_torch.algorithms.common import init_model
    from semi_seg_ecg_tpu_torch.config import normalize_config
    from semi_seg_ecg_tpu_torch.utils.checkpoint import save_torch_checkpoint

    import torch

    _, config = write_train_config("vit_tiny", "stpp")
    config = normalize_config(copy.deepcopy(config))
    paths = []
    for seed in DP_SNAPSHOT_SEEDS:
        path = os.path.join(WORK, f"dp_snapshot_{seed}.pth")
        save_torch_checkpoint(path, init_model(config, torch.device("cpu"),
                                               train=False, seed=seed))
        paths.append(path)
    return config, paths


def dp_rank(torch, config, paths):
    """ST++'s reliability ranking of the unlabeled split (each rank on its
    shards): the reliable ids and the reliabilities."""
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        amp_context,
        eval_loader,
        full_fp32,
        load_eval_weights,
    )
    from semi_seg_ecg_tpu_torch.algorithms.stpp import select_reliable
    from semi_seg_ecg_tpu_torch.data.dataset import build_seg_dataset
    from semi_seg_ecg_tpu_torch.models import build_model_from_config

    device = torch.device("cuda", torch.cuda.current_device())
    models = []
    for path in paths:
        model = build_model_from_config(config)
        load_eval_weights(model, path)
        models.append(model.to(device))
    ds = build_seg_dataset(config["dataset"], split="train_unlabeled",
                           mode="eval")
    loader = eval_loader(config, ds, mode="eval")
    try:
        with full_fp32():
            reliable, _, reliability = select_reliable(
                models, loader, config["metric"]["num_classes"], device,
                amp_context(config, device))
    finally:
        loader.close()
    return {"reliable": reliable, "reliability": reliability}


def dp_profile_config(algorithm="fixmatch"):
    from semi_seg_ecg_tpu_torch.config import normalize_config

    _, config = write_train_config("vit_tiny", algorithm)
    return normalize_config(config)


def dp_profiles(torch):
    """The recipe's bf16 vit_tiny FixMatch and ReCo steps (BATCH + BATCH
    windows): ms per step, peak memory and, from the trace, the
    collectives' device time."""
    return {algorithm: profile_train_step(
        torch, dp_profile_config(algorithm), "bf16", phase=10,
        algorithm=algorithm) for algorithm in ("fixmatch", "reco")}


def dp_reco_sync_free(torch):
    """One ReCo loss call on the inputs gathered from every rank
    (``gather_batch``, as the ReCo step calls it), with host syncs raising;
    the syncs of its backward counted."""
    import warnings

    from semi_seg_ecg_tpu_torch.algorithms.common import full_fp32
    from semi_seg_ecg_tpu_torch.ops import reco_loss as rl
    from semi_seg_ecg_tpu_torch.parallel.dist import gather_batch, get_rank

    config = dp_profile_config("reco")
    # each rank's own rows; one call's draws, the same on every rank
    latent, prob_t, prob_s, _, (easy, hard, temp) = reco_inputs(
        torch, config, seed=8 + get_rank())
    draws = reco_inputs(torch, config)[3]
    cuda = torch.device("cuda", torch.cuda.current_device())
    with full_fp32():
        card_draws = rl.RecoDraws(*(d.to(cuda) for d in draws))
        lat = latent.to(cuda).requires_grad_()
        pt, ps = prob_t.to(cuda), prob_s.to(cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss = rl.compute_reco_loss(card_draws, gather_batch(lat),
                                        gather_batch(pt), gather_batch(ps),
                                        easy, hard, temp)
        except RuntimeError as e:
            raise SystemExit(f"phase 10 failed: the gathered ReCo loss "
                             f"waits on the card: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                loss.backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return {"loss": loss.item(), "backward_syncs": sum(
        "synchroniz" in str(w.message) for w in caught),
        "rows": DP_WORLD * BATCH}


def dp_profile(torch, reps=20):
    """On each rank: :func:`dp_profiles` (the collectives' device time
    includes a rank's wait for the other); the gradient all-reduce alone
    (``all_reduce_grads_`` on the model's gradients: flatten, NCCL, divide,
    copy back) and NCCL's all-reduce of the same bytes as one flat buffer,
    each by ``event_ms`` after a barrier; :func:`dp_reco_sync_free`."""
    import torch.distributed as dist

    from semi_seg_ecg_tpu_torch.models import build_model_from_config
    from semi_seg_ecg_tpu_torch.parallel.dist import all_reduce_grads_

    out = dp_profiles(torch)
    model = build_model_from_config(dp_profile_config(), train=True).cuda()
    params = list(model.parameters())
    for p in params:
        p.grad = torch.ones_like(p)
    flat = torch.ones(sum(p.numel() for p in params), device="cuda")
    out["grad_allreduce_alone_ms"] = event_ms(
        lambda: all_reduce_grads_(params), reps, warmup=1, sleep=False,
        before=barrier)
    out["nccl_allreduce_ms"] = event_ms(
        lambda: dist.all_reduce(flat), reps, warmup=1, sleep=False,
        before=barrier)
    out["grad_allreduce_bytes"] = 4 * flat.numel()
    out["reco_loss_gathered"] = dp_reco_sync_free(torch)
    return out


def dp_accum_steps(torch, config, batches):
    """A rank's :func:`dp_steps` with the gradient all-reduce counted."""
    from semi_seg_ecg_tpu_torch.utils import optimizer

    calls = []
    reduce = optimizer.all_reduce_grads_

    def counted(params):
        calls.append(1)
        reduce(params)

    optimizer.all_reduce_grads_ = counted
    try:
        result = dp_steps(torch, config, batches)
    finally:
        optimizer.all_reduce_grads_ = reduce
    result["all_reduces"] = len(calls)
    return result


RANK_TASKS = {"tp_drift": lambda torch, **kw: tp_drift(torch, **kw),
              "steps": dp_steps, "train": dp_train, "rank": dp_rank,
              "profile": dp_profile, "accum_steps": dp_accum_steps,
              "z1_steps": lambda torch, **kw: z1_steps(torch, **kw),
              "tp_profile": lambda torch, **kw: profile_train_step(
                  torch, precision="bf16", phase=14, **kw),
              "tp_infer": lambda torch, **kw: tp_infer(torch, **kw),
              "tp_longrec": lambda torch, **kw: tp_longrec(torch, **kw),
              "seq_long": lambda torch, **kw: seq_long(torch, **kw),
              "so_steps": dp_steps,
              "so_steps_strict": lambda torch, **kw: strict_steps(torch,
                                                                  **kw),
              "so_stpp_rank": lambda torch, **kw: so_stpp_rank(torch, **kw),
              "so_int8_serve": lambda torch, **kw: so_int8_serve(torch,
                                                                 **kw),
              "ckpt_backends": lambda torch, **kw: ckpt_backends(torch,
                                                                 **kw),
              "scan_refusal": lambda torch, **kw: scan_refusal(torch, **kw),
              "scan_rank_case": lambda torch, **kw: scan_rank_case(torch,
                                                                   **kw),
              "scan_rank_profile": lambda torch, **kw: scan_rank_profile(
                  torch, **kw),
              "nan_rank": lambda torch, **kw: nan_rank(torch, **kw)}


def rank_main(job, out_dir):
    """One rank of phase 10 (``chip_smoke.py --rank JOB OUT_DIR``, with
    torchrun's variables): its output to ``OUT_DIR/rank{RANK}.log``, the
    group joined with the job's backend, the job's tasks run in order and
    their results written to ``OUT_DIR/rank{RANK}.pkl``."""
    import torch

    from semi_seg_ecg_tpu_torch.parallel import dist as pdist

    rank = int(os.environ["RANK"])
    with open(os.path.join(out_dir, f"rank{rank}.log"), "w") as f:
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
    with open(job, "rb") as f:
        spec = pickle.load(f)
    pdist.init_distributed_mode({"dist_backend": spec["backend"]}, "cuda")
    results = []
    for name, kwargs in spec["tasks"]:
        t0 = time.perf_counter()
        results.append(RANK_TASKS[name](torch, **kwargs))
        print(f"[rank task] {name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    pdist.destroy_process_group()
    return 0


def dp_run_ranks(tasks, backend, phase=10, env=None, world=DP_WORLD):
    """Phase 10's ranks (``world`` of them) on ``tasks`` (``env`` added to
    their environment), each task's results by rank; fails ``phase`` if a
    rank fails or the group outlives DP_TIMEOUT (then every process of it
    is killed)."""
    return finish_ranks(start_ranks(tasks, backend, env, world), phase)


def start_ranks(tasks, backend, env=None, world=DP_WORLD, name="dp",
                timeout=DP_TIMEOUT):
    """Start a rank group of ``world`` processes on ``tasks`` in
    ``WORK/name`` (its own rendezvous port); :func:`finish_ranks` waits,
    at most ``timeout`` seconds from now."""
    work = os.path.join(WORK, name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    job = os.path.join(work, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"backend": backend, "tasks": tasks}, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = [os.path.abspath(__file__), "--rank", job, work]
    if backend == "nccl":
        commands = [([sys.executable, "-m", "torch.distributed.run",
                      f"--nproc_per_node={world}",
                      "--master_addr=127.0.0.1", f"--master_port={port}",
                      *args], {})]
    else:
        commands = [([sys.executable, *args],
                     {"RANK": str(r), "WORLD_SIZE": str(world),
                      "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                      "MASTER_PORT": str(port)}) for r in range(world)]
    procs = []
    with open(os.path.join(work, "launcher.log"), "w") as out:
        for cmd, rank_env in commands:
            procs.append(subprocess.Popen(
                cmd, cwd=REPO, env={**os.environ, **(env or {}), **rank_env},
                stdout=out,
                stderr=subprocess.STDOUT, start_new_session=True))
    return {"work": work, "procs": procs, "world": world,
            "timeout": timeout, "deadline": time.monotonic() + timeout}


def finish_ranks(group, phase):
    """Wait for a group of :func:`start_ranks` (every process is killed past
    its timeout); fails ``phase`` if a rank failed. Returns each task's
    results by rank and the logs."""
    work, procs, world = group["work"], group["procs"], group["world"]
    try:
        for p in procs:
            p.wait(timeout=max(group["deadline"] - time.monotonic(), 0.01))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    logs = {}
    for name in ["launcher"] + [f"rank{r}" for r in range(world)]:
        path = os.path.join(work, f"{name}.log")
        logs[name] = open(path).read() if os.path.exists(path) else ""
    codes = [p.returncode for p in procs]
    if codes != [0] * len(procs):
        for name, text in logs.items():
            log(f"  {name}'s output ends:\n{text[-3000:]}")
        raise SystemExit(f"phase {phase} failed: the ranks exited {codes} "
                         f"(timeout {group['timeout']} s)")
    results = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return [list(by_task) for by_task in zip(*results)], logs


def dp_check_steps(family, ranks, single, steps=DP_STEPS, phase=10,
                   layout=None, want_launches=None, algorithm="FixMatch",
                   atol=DP_ATOL):
    """The ranks' ``steps`` steps against one process holding both shards:
    losses (ReCo's contrastive one too), confident pixels, launches per
    step (``want_launches``, else one process's), the state; the ranks'
    states equal. ``layout`` names the ranks' layout in the log."""
    want_launches = want_launches or launches_per_step(family, "fixmatch")
    for r, got in enumerate(ranks):
        if got["launches"] != [want_launches] * steps:
            raise SystemExit(f"phase {phase} failed: {family} rank {r} "
                             f"launched {got['launches']}, expected "
                             f"{want_launches} a step")
    first = ranks[0]
    for other in ranks[1:]:
        for k, v in first["state"].items():
            if not np.array_equal(v, other["state"][k]):
                raise SystemExit(f"phase {phase} failed: {family}: the "
                                 f"ranks' {k} differ")
    loss_rel, pixels = 0.0, []
    n = DP_WORLD * DP_ROWS * SIGNAL_LENGTH
    for a, b in zip(first["metrics"], single["metrics"]):
        for k in ("loss", "loss_x", "loss_u_s", "loss_total",
                  "contr_loss"):
            if k in b:
                loss_rel = max(loss_rel, abs(a[k] - b[k])
                               / max(abs(b[k]), 1e-12))
        pixels.append((round(a["mask_ratio"] * n),
                       round(b["mask_ratio"] * n)))
    worst, worst_key = 0.0, None
    for k, want in single["state"].items():
        if want.dtype.kind != "f":
            continue
        excess = float((np.abs(first["state"][k] - want)
                        - DP_RTOL * np.abs(want)).max())
        if excess > worst or worst_key is None:
            worst, worst_key = excess, k
    layout = layout or f"{DP_WORLD} ranks x {DP_ROWS} rows"
    log(f"  {family} {algorithm}, {steps} fp32 SGD steps, {layout} against "
        f"one process holding the global batch: losses within "
        f"{loss_rel:.3g} relative; parameters "
        f"and BN statistics: max(|diff| - {DP_RTOL} |one process|) = "
        f"{worst:.3g} ({worst_key}); confident pixels {pixels}; launches "
        f"per rank per step {want_launches}")
    if not (loss_rel <= DP_LOSS_RTOL and worst <= atol
            and all(abs(a - b) <= DP_PIXELS for a, b in pixels)):
        raise SystemExit(f"phase {phase} failed: {family}: {layout} "
                         "disagrees with one process")
    return {"loss_rel": loss_rel, "state_excess": worst,
            "state_worst": worst_key, "confident_pixels": pixels,
            # measured: rank 0's first step (every step of every rank
            # was checked equal to it above)
            "launches_per_rank_step": first["launches"][0],
            "metrics": [first["metrics"], single["metrics"]]}


def dp_evaluate(torch, config_path, checkpoint):
    """One process's validation of ``checkpoint``, as the training loop
    evaluates: the loss and the metrics."""
    from semi_seg_ecg_tpu_torch.algorithms import common
    from semi_seg_ecg_tpu_torch.config import load_config, normalize_config
    from semi_seg_ecg_tpu_torch.data.dataset import build_seg_dataset
    from semi_seg_ecg_tpu_torch.ops.metrics import build_metric_fn

    config = normalize_config(load_config(config_path))
    config["test"] = dict(config["test"], model_path=checkpoint)
    device = torch.device("cuda")
    ds = build_seg_dataset(config["dataset"], split="valid")
    loader = common.eval_loader(config, ds, mode="valid")
    metric_fn, _ = build_metric_fn(config["metric"])
    try:
        with common.full_fp32():
            stats, metrics, _, _ = common.evaluate(
                common.load_eval_model(config, device), loader, metric_fn,
                config["metric"]["num_classes"], device,
                common.amp_context(config, device), collect_outputs=False)
    finally:
        loader.close()
    return {"loss": stats["loss"], **metrics}


def dp_check_entry(torch, algorithm, config_path, ranks):
    """A 2-rank train_main run: each rank's launches, losses finite, one
    log.txt line, rank 1 silent, the checkpoint served by phase 3's path
    and its recorded validation metrics equal to one process's evaluation
    of it."""
    name = f"dp_vit_tiny_{algorithm}"
    want = dp_entry_launches(algorithm)
    for r, got in enumerate(ranks):
        if got["launches"] != want:
            raise SystemExit(f"phase 10 failed: {name} rank {r} launched "
                             f"{got['launches']}, expected {want}")
    out_dir = os.path.join(WORK, "exps", name)
    for f in ("log.txt", "best-loss.ckpt", "best-MeanIoU.ckpt",
              "test_metrics.csv", "test_outputs.npy"):
        if not os.path.exists(os.path.join(out_dir, f)):
            raise SystemExit(f"phase 10 failed: {name} wrote no {f}")
    with open(os.path.join(out_dir, "log.txt")) as f:
        epochs = [json.loads(line) for line in f]
    if len(epochs) != 1 or not all(math.isfinite(v) for k, v in
                                   epochs[0].items() if "loss" in k):
        raise SystemExit(f"phase 10 failed: {name} log.txt {epochs}")
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    checkpoint = os.path.join(out_dir, "best-loss.ckpt")
    recorded = ckpt.load_checkpoint(checkpoint)["metrics"]
    single = dp_evaluate(torch, config_path, checkpoint)
    if recorded != single:
        raise SystemExit(f"phase 10 failed: {name}: the sharded validation "
                         f"{recorded} differs from one process's {single}")
    probs, served, _ = serve(config_path, checkpoint, f"{name}_served")
    check_probs(f"{name}: served", probs, TRAIN_TEST)
    want_served = {"flash_attention_fwd": DEPTH * math.ceil(
        TRAIN_TEST / BATCH), "flash_attention_bwd": 0, "gather1d": 0}
    if served != want_served:
        raise SystemExit(f"phase 10 failed: serving {name} made {served}")
    log(f"  train_main {name}, {DP_WORLD} ranks, 1 epoch bf16: "
        f"{ranks[0]['seconds']:.2f} s; launches per rank {want}; log.txt "
        f"{ {k: round(v, 4) for k, v in epochs[0].items()} }; sharded "
        f"validation equals one process's: {single}; served with "
        f"{served['flash_attention_fwd']} forward launches")
    return {"seconds": [r["seconds"] for r in ranks],
            "launches_per_rank": want, "log": epochs[0],
            "validation": single, "test_metrics": ranks[0]["test_metrics"]}


def phase_parallel(torch, extra=()):
    """Phase 10: data-parallel training through the port's own path
    (``parallel/``, ``train_main`` under a process group), two ranks.
    ``extra`` tasks (later phases') run on the same rank processes after
    phase 10's, a group's start costing tens of seconds; their results
    and the logs are ``result["extra"]``. The group runs with the cuBLAS
    workspace setting deterministic algorithms ask for (phase 13 (d)
    switches them on in its tasks)."""
    t_phase = time.perf_counter()
    backend, layout = dp_layout(torch)
    smi = nvidia_smi().replace("\n", "; ")
    log(f"phase 10: {torch.cuda.device_count()} card(s), {smi}; "
        f"backend {backend}; {layout}")
    batches = dp_global_batches(40)
    step_configs = {family: dp_step_config(family, backend)
                    for family in ("vit_tiny", "resnet18")}
    entry_paths = {algorithm: dp_entry_config(algorithm, backend)
                   for algorithm in DP_RECIPES}
    rank_config, snapshots = dp_snapshots()
    # one process holding both shards (num_shards=2, local_shards=2), on
    # the card, before the ranks start
    single_steps = {family: dp_steps(torch, cfg, batches, slice(None))
                    for family, cfg in step_configs.items()}
    single_rank = dp_rank(torch, rank_config, snapshots)
    one_rank = dp_profiles(torch) if backend == "nccl" else None

    tasks = ([("steps", {"config": cfg, "batches": batches})
              for cfg in step_configs.values()]
             + [("train", {"config_path": path})
                for path in entry_paths.values()]
             + [("rank", {"config": rank_config, "paths": snapshots})]
             + ([("profile", {})] if backend == "nccl" else []))
    t0 = time.perf_counter()
    by_task, logs = dp_run_ranks(tasks + list(extra), backend,
                                 env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    ranks_s = time.perf_counter() - t0
    extra_results = by_task[len(tasks):]
    by_task = by_task[:len(tasks)]
    printed = re.findall(r"^\[\d{4}-\d\d-\d\d [\d:]+\] (.*)$",
                         logs["rank1"], re.MULTILINE)
    if len(printed) != 1 or "distributed init" not in printed[0]:
        raise SystemExit(f"phase 10 failed: rank 1 printed {printed}")

    result = {"backend": backend, "layout": layout,
              "device_count": torch.cuda.device_count(),
              "nvidia_smi": smi, "ranks_seconds": ranks_s,
              "steps": {}, "entries": {}}
    for i, family in enumerate(step_configs):
        result["steps"][family] = dp_check_steps(family, by_task[i],
                                                 single_steps[family])
    for i, (algorithm, path) in enumerate(entry_paths.items()):
        result["entries"][algorithm] = dp_check_entry(
            torch, algorithm, path, by_task[len(step_configs) + i])
    ranked = by_task[len(step_configs) + len(entry_paths)]
    for r, got in enumerate(ranked):
        if got["reliable"] != single_rank["reliable"] or not np.array_equal(
                got["reliability"], single_rank["reliability"]):
            raise SystemExit(f"phase 10 failed: rank {r}'s ST++ ranking "
                             "differs from one process's")
    log(f"  ST++ ranking of {len(single_rank['reliability'])} unlabeled "
        f"windows by {len(snapshots)} snapshots: every rank keeps one "
        f"process's {len(single_rank['reliable'])} reliable ids")
    result["stpp_reliable"] = len(single_rank["reliable"])
    if backend == "nccl":
        profiles = by_task[-1]
        result["profile"] = {"ranks": profiles, "one_rank": one_rank}
        for who, p in [("one process", one_rank)] + [
                (f"rank {r}", p) for r, p in enumerate(profiles)]:
            for algorithm in ("fixmatch", "reco"):
                m = p[algorithm]
                log(f"  {who}: bf16 {algorithm} step "
                    f"{m['wall_ms_per_step']:.3f} ms wall, busy "
                    f"{m['device_busy_ms_per_step']} ms, peak memory "
                    f"{m['peak_memory_mb']:.1f} MiB, collectives "
                    f"{m['collectives_ms_per_step']} ms of device time "
                    f"(all-reduce {m['allreduce_ms_per_step']} ms)")
            if who != "one process":
                log(f"  {who}: the gradient all-reduce alone "
                    f"({p['grad_allreduce_bytes']} bytes) "
                    f"{p['grad_allreduce_alone_ms']:.4f} ms, NCCL's "
                    f"all-reduce of one flat buffer of as many bytes "
                    f"{p['nccl_allreduce_ms']:.4f} ms; the ReCo loss "
                    f"on {p['reco_loss_gathered']['rows']} gathered rows: "
                    "no host sync in the call, backward syncs "
                    f"{p['reco_loss_gathered']['backward_syncs']}")
    if extra:
        result["extra"] = (extra_results, logs)
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 10 in {result['seconds']:.1f} s (ranks {ranks_s:.1f} s, "
        f"{len(extra)} later phases' tasks among them)")
    return result


# ---------------------------------------------------------------------------
# Phase 11: remat, layer decay and freezing, the convergence gate
# ---------------------------------------------------------------------------

# remat on against off: REMAT_STEPS fp32 FixMatch steps of each recipe from
# seed 0 on the same batches, dropout and drop-path on. Equality: under
# PyTorch's deterministic algorithms (and cuBLAS's fixed workspace,
# CUBLAS_WORKSPACE_CONFIG; scan_determinism), because the card's default
# algorithms need not repeat a run bit for bit (atomics in some backward
# kernels, which FixMatch's mask amplifies); there the recompute runs the
# same kernels on the same inputs, so remat on must equal off bit for bit
# (losses, the last step's gradients, parameters, BatchNorm statistics),
# and a second off run equal the first. Launches, step times and peak
# memory: in this process, on the default algorithms
REMAT_STEPS = 3
REMAT_FAMILIES = ("vit_tiny", "resnet18")
VIT_DROPOUT = {"drop_out_rate": 0.1, "drop_path_rate": 0.1}
# the optimizer options: OPTION_STEPS bf16 steps; the ViT with layer decay
# and its first blocks frozen, ResNet18 with its backbone frozen and its
# stem and first stage in eval mode; AdamW's last update replayed from its
# state and the group's lr within OPTION_REPLAY_RTOL of max |parameter|
OPTION_STEPS = 3
LAYER_DECAY, VIT_FROZEN_STAGES, RESNET_FROZEN_STAGES = 0.75, 2, 1
OPTION_REPLAY_RTOL = 1e-6
# the convergence gate: tools/validate_ssl's recipe at seed 0; the phase
# fails when FixMatch lies outside its tolerance
SSL_GATE, SSL_SEED, SSL_EPOCHS = ("base", "fixmatch"), 0, 25


@contextlib.contextmanager
def cudnn_deterministic(torch):
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def remat_batches(torch, seed, steps):
    """Device batches of the FixMatch step with device augmentation (the
    strong view is made on the card)."""
    return [{k: v for k, v in device_batch(torch, seed + s).items()
             if k != "ecg_u_s"} for s in range(steps)]


def option_steps(torch, cfg, batches, model=None):
    """FixMatch steps of ``cfg`` on the card (a model from seed 0 unless
    given): per step the metrics, the kernel launches (counted from 0 just
    before the step and read just after) and the wall ms; the peak memory
    of the steps and the trainer."""
    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
    from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, init_model

    device = torch.device("cuda")
    if model is None:
        model = init_model(cfg, device)
    trainer = Trainer(copy.deepcopy(cfg), fixmatch.SPEC, device, 4,
                      model=model)
    # an earlier run's trainer (a reference cycle through its step) goes
    # before the peak is reset
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for batch in batches:
        reset_counts()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append({"launches": launch_counts(), "ms": ms,
                      "metrics": {k: v.item() for k, v in metrics.items()}})
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    return steps, peak, trainer


def state_excess(got, want):
    """The worst tensor of two state_dicts: max |got - want| / max |want|
    (integers: equal or inf)."""
    worst, name = 0.0, None
    for k, v in want.items():
        if v.is_floating_point():
            err = ((got[k] - v).abs().max().item()
                   / max(v.abs().max().item(), 1e-30))
        else:
            err = 0.0 if torch_equal(got[k], v) else math.inf
        if err > worst or name is None:
            worst, name = err, k
    return worst, name


def torch_equal(a, b):
    return bool((a == b).all().item())


def remat_base(family):
    """The family's FixMatch recipe of phase 11 (``write_train_config``),
    normalized, with the lockstep's confidence threshold."""
    from semi_seg_ecg_tpu_torch.config import normalize_config

    _, config = write_train_config(family, "fixmatch")
    base = normalize_config(config)
    base["train"]["conf_thresh"] = (RESNET_LOCKSTEP_CONF_THRESH
                                    if family == "resnet18"
                                    else LOCKSTEP_CONF_THRESH)
    return base


def remat_run(torch, family, base, remat, batches):
    """REMAT_STEPS fp32 FixMatch steps with remat on or off: the steps
    (launches held to the prediction: the recompute adds one flash
    forward per block of the student pass), the peak memory and the
    trainer."""
    from semi_seg_ecg_tpu_torch.algorithms.common import full_fp32

    cfg = copy.deepcopy(base)
    cfg["precision"] = "fp32"
    cfg["backbone"][family]["remat"] = remat
    if family == "vit_tiny":
        cfg["backbone"][family].update(VIT_DROPOUT)
    with full_fp32():
        steps, peak, trainer = option_steps(torch, cfg, batches)
    depth = DEPTH if family == "vit_tiny" else 0
    want = {"flash_attention_fwd": (3 if remat else 2) * depth,
            "flash_attention_bwd": depth, "gather1d": 3}
    got = [s["launches"] for s in steps]
    if any(g != want for g in got):
        raise SystemExit(f"phase 11 failed: {family} remat {remat} "
                         f"launched {got}, not {want} a step")
    return steps, peak, trainer


def check_remat(torch, family, base):
    """Remat off and on on the card's default algorithms: launches per
    step, ms per step and peak memory of each."""
    batches = remat_batches(torch, 20, REMAT_STEPS)
    result = {}
    for label, remat in (("off", False), ("on", True)):
        steps, peak, trainer = remat_run(torch, family, base, remat,
                                         batches)
        del trainer
        result[label] = {"peak_mib": peak,
                         "ms_per_step": [s["ms"] for s in steps],
                         "launches_per_step": steps[-1]["launches"]}
        log(f"  remat {label}, {family} FixMatch fp32: launches per step "
            f"{steps[-1]['launches']}, peak {peak:.1f} MiB, ms per step "
            f"{[round(s['ms'], 3) for s in steps]}")
    return result


def remat_equal(torch, family):
    """Remat off, on and off again under deterministic algorithms
    (:func:`scan_determinism`, in this process): every loss, the last step's gradients and the
    whole state of on and of off again equal off's bit for bit."""
    base = remat_base(family)
    batches = remat_batches(torch, 20, REMAT_STEPS)
    runs = {}
    for label, remat in (("off", False), ("on", True), ("off_again", False)):
        with cudnn_deterministic(torch):
            steps, _, trainer = remat_run(torch, family, base, remat,
                                          batches)
        model = trainer.model
        runs[label] = ([s["metrics"] for s in steps], {
            **{k: v.detach().clone() for k, v in model.state_dict().items()},
            **{f"{k}.grad": p.grad.detach().clone()
               for k, p in model.named_parameters() if p.grad is not None}})
        del trainer, model
    result = {}
    for other in ("off_again", "on"):
        losses_equal = runs[other][0] == runs["off"][0]
        worst, name = state_excess(runs[other][1], runs["off"][1])
        result[other] = {"losses_equal": losses_equal, "state_rel": worst,
                         "state_key": name}
        log(f"  remat {other} vs off, {family}, deterministic algorithms: "
            f"losses {'equal' if losses_equal else 'DIFFER'}, state and "
            f"gradients within {worst:.3g} of max|off| ({name})")
        if not (losses_equal and worst == 0.0):
            raise SystemExit(f"phase 11 failed: {family} remat {other} "
                             f"differs from remat off ({name}: {worst})")
    return result


def check_options(torch, family, base):
    """OPTION_STEPS bf16 FixMatch steps with the optimizer options: the
    frozen parameters (and the BatchNorm statistics of the stages in eval
    mode) bit-unchanged and out of the optimizer, the rest moved; every
    group's lr the schedule's times its ``lr_scale``, which is the layer
    decay factor of each of its parameters; AdamW's last update replayed
    from its state and the group's lr."""
    from semi_seg_ecg_tpu_torch.algorithms.common import init_model
    from semi_seg_ecg_tpu_torch.utils.lr_decay import param_lr_scales_and_wd
    from semi_seg_ecg_tpu_torch.utils.optimizer import frozen_parameter_names

    cfg = copy.deepcopy(base)
    cfg["precision"] = "bf16"
    if family == "vit_tiny":
        cfg["train"]["layer_decay"] = LAYER_DECAY
        cfg["backbone"][family]["frozen_stages"] = VIT_FROZEN_STAGES
        eval_prefixes = ()
    else:
        cfg["mode"] = "freeze_backbone"
        cfg["backbone"][family]["frozen_stages"] = RESNET_FROZEN_STAGES
        eval_prefixes = ("backbone.stem.", "backbone.layer1.")
    device = torch.device("cuda")
    model = init_model(cfg, device)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    frozen = frozen_parameter_names(cfg, model)
    scales = (param_lr_scales_and_wd(model, LAYER_DECAY)
              if family == "vit_tiny" else {})
    batches = remat_batches(torch, 30, OPTION_STEPS)
    steps, peak, trainer = option_steps(torch, cfg, batches[:-1], model)
    opt = trainer.optimizer
    name_of = {id(p): n for n, p in model.named_parameters()}
    prev = {n: p.detach().clone() for n, p in model.named_parameters()}
    reset_counts()
    last = trainer.train_step(batches[-1])
    torch.cuda.synchronize()
    launches_last = launch_counts()
    in_groups = set()
    worst_replay, worst_name = -1.0, None
    b1, b2 = opt.optimizer.defaults["betas"]
    eps = opt.optimizer.defaults["eps"]
    for group in opt.optimizer.param_groups:
        want_lr = opt.schedule(opt.count - 1) * group["lr_scale"]
        if group["lr"] != want_lr:
            raise SystemExit(f"phase 11 failed: a group's lr {group['lr']} "
                             f"is not {want_lr}")
        for p in group["params"]:
            name = name_of[id(p)]
            in_groups.add(name)
            if scales and scales[name][0] != group["lr_scale"]:
                raise SystemExit(f"phase 11 failed: {name} has lr scale "
                                 f"{group['lr_scale']}, not "
                                 f"{scales[name][0]}")
            st = opt.optimizer.state[p]
            t = float(st["step"])
            lr, wd = group["lr"], group["weight_decay"]
            denom = (st["exp_avg_sq"].sqrt() / math.sqrt(1 - b2 ** t)) + eps
            replay = (prev[name] * (1 - lr * wd)
                      - (lr / (1 - b1 ** t)) * st["exp_avg"] / denom)
            err = ((replay - p.detach()).abs().max().item()
                   / max(p.detach().abs().max().item(), 1e-30))
            if err > worst_replay:
                worst_replay, worst_name = err, name
    after = model.state_dict()
    moved_frozen = [k for k in frozen if not torch_equal(after[k], before[k])]
    moved_eval_stats = [k for k in after if k.startswith(eval_prefixes)
                        and "running" in k
                        and not torch_equal(after[k], before[k])]
    trainable = [n for n, _ in model.named_parameters() if n not in frozen]
    still = [n for n in trainable if torch_equal(after[n], before[n])]
    moved_stats = sorted({k.rsplit(".", 2)[0] for k in after
                          if "running_mean" in k and k.startswith("backbone.")
                          and not torch_equal(after[k], before[k])})
    options = (f"layer_decay {LAYER_DECAY}, " if scales else
               "mode: freeze_backbone, ")
    log(f"  {family} {options}"
        f"frozen_stages {cfg['backbone'][family]['frozen_stages']}, bf16: "
        f"{len(frozen)} frozen tensors unchanged and in no group "
        f"({len(in_groups)} in {len(opt.optimizer.param_groups)} groups), "
        f"{len(trainable) - len(still)}/{len(trainable)} trainable moved, "
        f"AdamW's last update replayed within {worst_replay:.3g} "
        f"({worst_name}); backbone BN stats moved in {len(moved_stats)} "
        f"norms; last step's launches {launches_last}; peak {peak:.1f} MiB")
    if (moved_frozen or moved_eval_stats or in_groups & frozen
            or any(p.requires_grad for n, p in model.named_parameters()
                   if n in frozen)
            or not frozen or worst_replay > OPTION_REPLAY_RTOL
            or not math.isfinite(last["loss"].item())
            or (family == "vit_tiny"
                and "backbone.cls_embedding" in still)):
        raise SystemExit(f"phase 11 failed: {family} options: frozen moved "
                         f"{moved_frozen[:3]}, eval-mode stats moved "
                         f"{moved_eval_stats[:3]}, replay {worst_replay}, "
                         f"unmoved trainable {still[:3]}")
    return {"frozen_tensors": len(frozen), "groups": [
                {"lr_scale": g["lr_scale"], "weight_decay": g["weight_decay"],
                 "lr": g["lr"], "params": len(g["params"])}
                for g in opt.optimizer.param_groups],
            "unmoved_trainable": still, "replay_rel": worst_replay,
            "replay_param": worst_name, "bn_stats_moved": moved_stats,
            "launches_last_step": launches_last, "peak_mib": peak,
            "metrics": [s["metrics"] for s in steps]
            + [{k: v.item() for k, v in last.items()}]}


def check_convergence(torch):
    """``tools/validate_ssl``'s runs of SSL_GATE at SSL_SEED for
    SSL_EPOCHS epochs on the card (bf16, the JAX rows' global batch):
    fails when FixMatch lies outside its tolerance of the JAX row."""
    from semi_seg_ecg_tpu_torch.tools import validate_ssl

    root = os.path.join(WORK, "ssl")
    t0 = time.perf_counter()
    data = validate_ssl.make_split(root)
    lines = [validate_ssl.run(algo, SSL_SEED, root, data, SSL_EPOCHS,
                              "cuda") for algo in SSL_GATE]
    rows = validate_ssl.summarize({line["algorithm"]: [line["MeanIoU"]]
                                   for line in lines})
    wall = time.perf_counter() - t0
    for line in lines:
        row = rows[line["algorithm"]]
        log(f"  validate_ssl {line['algorithm']} seed {SSL_SEED}, "
            f"{SSL_EPOCHS} epochs, batch {line['batch_size']}, bf16: test "
            f"MeanIoU {line['MeanIoU']:.4f} against the JAX package's "
            f"{row['jax_mean']} (tolerance {row['tol']:.4f}: "
            f"{'within' if row['within'] else 'OUTSIDE'}), "
            f"{line['wall_s']:.1f} s")
    log(f"  convergence gate in {wall:.1f} s")
    if not rows["fixmatch"]["within"]:
        raise SystemExit("phase 11 failed: FixMatch's test MeanIoU "
                         f"{rows['fixmatch']['mean']:.4f} lies outside "
                         f"{rows['fixmatch']['tol']} of the JAX package's "
                         f"{rows['fixmatch']['jax_mean']}")
    return {"runs": lines, "rows": rows, "seconds": wall}


def phase_remat(torch):
    """Phase 11: remat on and off at full width, the optimizer options,
    the convergence gate."""
    t_phase = time.perf_counter()
    log("phase 11: remat, layer decay and freezing, convergence")
    result = {"remat": {}, "options": {}}
    for family in REMAT_FAMILIES:
        base = remat_base(family)
        result["remat"][family] = check_remat(torch, family, base)
        result["options"][family] = check_options(torch, family, base)
    with scan_determinism(torch):
        result["remat_equal"] = {family: remat_equal(torch, family)
                                 for family in REMAT_FAMILIES}
    result["convergence"] = check_convergence(torch)
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 11 in {result['seconds']:.1f} s")
    return result


# ---------------------------------------------------------------------------
# Phase 12: gradient accumulation, resume, the trace schedule
# ---------------------------------------------------------------------------

# the vit_tiny FixMatch recipe (flash, device augmentation, bf16) at
# micro-batch ACCUM_BATCH with accum_iter ACCUM_ITER, on a split of
# ACCUM_STEPS micro-steps an epoch, so that a window spans the first
# epoch's end; ACCUM_EPOCHS epochs make 3 updates
ACCUM_BATCH, ACCUM_ITER, ACCUM_STEPS, ACCUM_EPOCHS = 8, 2, 3, 2
ACCUM_VALID = ACCUM_TEST = 8
# the micro-step's wall time at accum_iter 1 and 2, in turns, after
# ACCUM_WARM_STEPS untimed ones
ACCUM_TIMED_STEPS, ACCUM_WARM_STEPS = 20, 4
# the trace: profile's window of global steps 2-3 in one epoch of 4
# micro-steps; each ported kernel's name in the trace, and its kernel
# events per launch (the backward launches a dQ and a dK/dV kernel)
TRACE_START, TRACE_STEPS, TRACE_EPOCH_STEPS = 2, 2, 4
TRACE_KERNELS = {"flash_attention_fwd": ("flash_fwd", 1),
                 "flash_attention_bwd": ("flash_bwd", 2),
                 "gather1d": ("gather1d", 1)}


def write_accum_config(name, algorithm="fixmatch",
                       steps_per_epoch=ACCUM_STEPS, epochs=ACCUM_EPOCHS,
                       train=None, **extra):
    """The shipped vit_tiny ``algorithm`` recipe with flash attention and
    device augmentation at micro-batch ACCUM_BATCH and accum_iter
    ACCUM_ITER, on a split of ``steps_per_epoch`` micro-steps an epoch,
    for ``epochs`` epochs (``train`` overrides keys of ``train``, ``extra``
    top-level keys)."""
    from semi_seg_ecg_tpu_torch.config import load_config

    rows = steps_per_epoch * ACCUM_BATCH
    data = synthetic_split(f"accum_data_{rows}", num_train_labeled=rows,
                           num_train_unlabeled=rows, num_valid=ACCUM_VALID,
                           num_test=ACCUM_TEST, seed=12)
    config = load_config(os.path.join(REPO, "configs", "base", "vit_tiny",
                                      f"{algorithm}.yaml"))
    config["backbone"]["vit_tiny"]["attention_impl"] = "flash"
    config["dataset"].update(data, device_augment=True)
    config["dataloader"]["batch_size"] = ACCUM_BATCH
    config["output_dir"] = os.path.join(WORK, "exps")
    config["exp_name"] = name
    config["train"].update(epochs=epochs, warmup_epochs=0,
                           accum_iter=ACCUM_ITER, **(train or {}))
    config.update(extra)
    path = os.path.join(WORK, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path, config


def accum_launches(micro_steps, eval_batches):
    """The launches of ``micro_steps`` FixMatch micro-steps and
    ``eval_batches`` eval batches."""
    want = {k: micro_steps * v for k, v in
            launches_per_step("vit_tiny", "fixmatch").items()}
    want["flash_attention_fwd"] += DEPTH * eval_batches
    return want


def accum_run(torch, argv, snapshot_epochs):
    """``run_training`` of the command line ``argv`` (FixMatch) with the
    launch counters zeroed just before and read just after; the
    snapshots after the epochs in ``snapshot_epochs``."""
    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
    from semi_seg_ecg_tpu_torch.algorithms.common import run_training
    from semi_seg_ecg_tpu_torch.config import parse_train_args

    config = parse_train_args(argv)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    run_training(config, fixmatch.SPEC, snapshot_epochs=snapshot_epochs)
    torch.cuda.synchronize()
    return {"launches": launch_counts(), "seconds": time.perf_counter() - t0,
            "start_epoch": config["start_epoch"], "train": config["train"]}


def read_log(name):
    """An experiment's ``log.txt`` rows without the wall clock."""
    with open(os.path.join(WORK, "exps", name, "log.txt")) as f:
        rows = [json.loads(line) for line in f]
    for row in rows:
        row.pop("wall_s")
    return rows


def payload_diff(got, want, path=""):
    """The worst difference of two checkpoint payloads, ``(max |got -
    want|, where)``: 0.0 when equal array for array, inf where the
    structure, a dtype or a plain value differs."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            return math.inf, path
        return max((payload_diff(got[k], want[k], f"{path}/{k}")
                    for k in want), default=(0.0, path))
    if isinstance(want, np.ndarray):
        if got.dtype != want.dtype or got.shape != want.shape:
            return math.inf, path
        if np.array_equal(got, want):
            return 0.0, path
        return float(np.abs(got.astype(np.float64)
                            - want.astype(np.float64)).max()), path
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return math.inf, path
        return max((payload_diff(g, w, f"{path}/{i}")
                    for i, (g, w) in enumerate(zip(got, want))),
                   default=(0.0, path))
    return (0.0 if got == want else math.inf), path


def accum_straight(torch):
    """(a) ACCUM_EPOCHS epochs of the recipe through ``run_training``:
    exact launches, 3 updates in the last snapshot, an open window in the
    first, the logged lr of update ``global_step // accum_iter``."""
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt
    from semi_seg_ecg_tpu_torch.utils.optimizer import (
        make_lr_schedule,
        updates_per_epoch,
    )

    path, _ = write_accum_config("accum_straight")
    run = accum_run(torch, ["-f", path], {1, 2})
    micro = ACCUM_STEPS * ACCUM_EPOCHS
    want = accum_launches(micro, ACCUM_EPOCHS
                          * math.ceil(ACCUM_VALID / ACCUM_BATCH))
    first, last = (ckpt.load_checkpoint(os.path.join(
        WORK, "exps", "accum_straight", f"checkpoint-{e}.ckpt"))
        for e in (1, 2))
    rows = read_log("accum_straight")
    lr_fn = make_lr_schedule(run["train"], updates_per_epoch(
        {"train": run["train"]}, ACCUM_STEPS))
    lr_want = [float(np.mean([lr_fn(g // ACCUM_ITER) for g in range(
        e * ACCUM_STEPS, (e + 1) * ACCUM_STEPS)]))
        for e in range(ACCUM_EPOCHS)]
    lr_got = [r["train_lr"] for r in rows]
    log(f"  (a) run_training, vit_tiny FixMatch bf16, micro-batch "
        f"{ACCUM_BATCH} + {ACCUM_BATCH}, accum_iter {ACCUM_ITER}, "
        f"{ACCUM_EPOCHS} epochs of {ACCUM_STEPS} micro-steps: "
        f"{run['seconds']:.2f} s, launches {run['launches']} (expected "
        f"{want}); updates {last['optimizer']['count']}, the first "
        f"snapshot's window at micro-step "
        f"{first['optimizer']['micro_step']}; logged lr {lr_got} "
        f"(expected {lr_want})")
    if (run["launches"] != want or last["optimizer"]["count"] != 3
            or last["step"] != micro
            or first["optimizer"]["micro_step"] != 1
            or not first["optimizer"].get("acc_grads")
            or any(abs(a - b) > 1e-12 * max(abs(b), 1e-30)
                   for a, b in zip(lr_got, lr_want))
            or not all(math.isfinite(r["train_loss"]) for r in rows)):
        raise SystemExit("phase 12 failed: the accumulated run's launches, "
                         "updates, window or logged lr")
    return {"seconds": run["seconds"], "launches": run["launches"],
            "launches_expected": want, "updates": last["optimizer"]["count"],
            "logged_lr": lr_got, "log": rows}


def accum_teacher(torch):
    """(a) The Mean Teacher's teacher over three micro-steps of its
    recipe at accum_iter ACCUM_ITER: unchanged but after the window's
    last micro-step (the second)."""
    from semi_seg_ecg_tpu_torch.algorithms import mean_teacher
    from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, init_model
    from semi_seg_ecg_tpu_torch.config import normalize_config

    _, config = write_accum_config("accum_teacher", "mean_teacher")
    cfg = normalize_config(config)
    device = torch.device("cuda")
    trainer = Trainer(cfg, mean_teacher.SPEC, device, 4,
                      model=init_model(cfg, device))
    moved, launches = [], []
    for s in range(3):
        batch = device_batch(torch, 60 + s, n=ACCUM_BATCH)
        del batch["ecg_u_s"]
        before = [t.clone() for t in trainer.teacher.state_dict().values()]
        reset_counts()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        launches.append(launch_counts())
        moved.append(any(not torch_equal(a, b) for a, b in zip(
            trainer.teacher.state_dict().values(), before)))
    want = launches_per_step("vit_tiny", "mean_teacher")
    log(f"  (a) Mean Teacher, 3 micro-steps at accum_iter {ACCUM_ITER}: "
        f"the teacher moved {moved} (expected [False, True, False]), "
        f"launches {launches[-1]} a micro-step")
    if moved != [False, True, False] or any(g != want for g in launches):
        raise SystemExit(f"phase 12 failed: the teacher moved {moved}, "
                         f"launches {launches}")
    return {"teacher_moved": moved, "launches_per_step": want}


def accum_resume_runs(torch):
    """(b)'s runs under deterministic algorithms (:func:`scan_determinism`,
    in this process): the recipe for ACCUM_EPOCHS epochs, then a run
    resumed from its first snapshot through ``--resume``; the resumed
    epoch's ``log.txt`` row and the last snapshots against each other, its
    launches."""
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    path, _ = write_accum_config("accum_det")
    with scan_determinism(torch):
        straight = accum_run(torch, ["-f", path], {1, 2})
        resumed = accum_run(torch, [
            "-f", path, "--exp_name", "accum_resumed", "--resume",
            os.path.join(WORK, "exps", "accum_det", "checkpoint-1.ckpt")],
            {2})
    want, got = (ckpt.load_checkpoint(os.path.join(
        WORK, "exps", name, "checkpoint-2.ckpt"))
        for name in ("accum_det", "accum_resumed"))
    for payload in (want, got):
        payload.pop("config")
    diff, where = payload_diff(got, want)
    rows = read_log("accum_resumed")
    return {"straight_launches": straight["launches"],
            "launches": resumed["launches"],
            "start_epoch": resumed["start_epoch"],
            "seconds": resumed["seconds"],
            "rows_equal": rows == read_log("accum_det")[1:],
            "epochs": [r["epoch"] for r in rows],
            "state_max_diff": diff, "state_where": where}


def accum_resume(torch):
    """(b) :func:`accum_resume_runs`: the resumed epoch equals the straight
    run's second bit for bit and launches the kernels of its 3 micro-steps
    and its eval batch."""
    result = accum_resume_runs(torch)
    want = accum_launches(ACCUM_STEPS, math.ceil(ACCUM_VALID / ACCUM_BATCH))
    log(f"  (b) --resume of the first snapshot, deterministic algorithms: "
        f"starts at epoch {result['start_epoch']}, {result['seconds']:.2f} "
        f"s, launches {result['launches']} (expected {want}); its log.txt "
        f"row {'equals' if result['rows_equal'] else 'DIFFERS FROM'} the "
        f"straight run's; last snapshot (model, optimizer, open window, "
        f"step, best) within {result['state_max_diff']} of the straight "
        f"run's ({result['state_where']})")
    if not (result["launches"] == want and result["rows_equal"]
            and result["epochs"] == [1] and result["state_max_diff"] == 0.0
            and result["straight_launches"] == accum_launches(
                ACCUM_STEPS * ACCUM_EPOCHS,
                ACCUM_EPOCHS * math.ceil(ACCUM_VALID / ACCUM_BATCH))):
        raise SystemExit("phase 12 failed: the resumed run differs from "
                         "the straight one")
    return result


def accum_trace(torch):
    """(d) ``train_main`` of the recipe for one epoch of TRACE_EPOCH_STEPS
    micro-steps with ``profile`` on global steps TRACE_START to
    TRACE_START + TRACE_STEPS - 1: one trace file, which holds exactly
    those steps' ranges and exactly their kernel events of the three
    ported kernels."""
    from semi_seg_ecg_tpu_torch.cli import train_main

    trace_dir = os.path.join(WORK, "accum_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    path, _ = write_accum_config(
        "accum_profiled", steps_per_epoch=TRACE_EPOCH_STEPS, epochs=1,
        test=False, profile={"trace_dir": trace_dir,
                             "start_step": TRACE_START,
                             "num_steps": TRACE_STEPS})
    train_main(["-f", path])
    last = TRACE_START + TRACE_STEPS - 1
    files = sorted(os.listdir(trace_dir))
    want_file = f"rank0_steps{TRACE_START}-{last}.pt.trace.json"
    with open(os.path.join(trace_dir, want_file)) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted({e["name"] for e in events
                    if e.get("name", "").startswith("ProfilerStep#")})
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    per_step = launches_per_step("vit_tiny", "fixmatch")
    got = {k: sum(needle in name for name in kernels)
           for k, (needle, _) in TRACE_KERNELS.items()}
    want = {k: TRACE_STEPS * per_step[k] * n
            for k, (_, n) in TRACE_KERNELS.items()}
    want_steps = [f"ProfilerStep#{s}" for s in range(TRACE_START, last + 1)]
    log(f"  (d) profile steps {TRACE_START}-{last}: {files}, ranges "
        f"{steps}, {len(kernels)} kernel events, of the ported kernels "
        f"{got} (expected {want})")
    if files != [want_file] or steps != want_steps or got != want:
        raise SystemExit("phase 12 failed: the trace does not hold "
                         "exactly the scheduled steps")
    return {"file": want_file, "steps": steps, "kernel_events": len(kernels),
            "ported_kernel_events": got}


def accum_rank_tasks(torch):
    """(e)'s rank task: one window of ACCUM_ITER fp32 FixMatch micro-steps
    (phase 10's step configuration)."""
    backend, _ = dp_layout(torch)
    cfg = dp_step_config("vit_tiny", backend)
    cfg["train"]["accum_iter"] = ACCUM_ITER
    return [("accum_steps", {"config": cfg,
                             "batches": dp_global_batches(41)[:ACCUM_ITER]})]


def accum_ranks(torch, shared=None):
    """(e) :func:`accum_rank_tasks` on DP_WORLD ranks (``shared``: its
    results from phase 10's group; alone, a group of its own) against one
    process holding both shards, with one gradient all-reduce a rank in
    the window."""
    backend, layout = dp_layout(torch)
    tasks = accum_rank_tasks(torch)
    cfg, batches = tasks[0][1]["config"], tasks[0][1]["batches"]
    single = dp_steps(torch, cfg, batches, slice(None))
    if shared is None:
        shared, _ = dp_run_ranks(tasks, backend)
    ranks = shared[0]
    checked = dp_check_steps("vit_tiny", ranks, single, steps=ACCUM_ITER,
                             phase=12)
    reduces = [r["all_reduces"] for r in ranks]
    log(f"  (e) {layout}: one window of {ACCUM_ITER} micro-steps, gradient "
        f"all-reduces a rank {reduces} (expected 1)")
    if reduces != [1] * DP_WORLD:
        raise SystemExit(f"phase 12 failed: the ranks all-reduced "
                         f"{reduces} times in one window")
    return {"backend": backend, "all_reduces": reduces, **checked}


def accum_step_times(torch):
    """The bf16 FixMatch micro-step's wall time at micro-batch ACCUM_BATCH
    with accum_iter 1 and ACCUM_ITER, in turns (1, k, k, 1): ms per
    micro-step over ACCUM_TIMED_STEPS after ACCUM_WARM_STEPS."""
    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
    from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, init_model
    from semi_seg_ecg_tpu_torch.config import normalize_config

    _, config = write_accum_config("accum_timed")
    device = torch.device("cuda")
    batch = device_batch(torch, 70, n=ACCUM_BATCH)
    del batch["ecg_u_s"]
    times = []
    for accum in (1, ACCUM_ITER, ACCUM_ITER, 1):
        cfg = normalize_config(config)
        cfg["train"]["accum_iter"] = accum
        trainer = Trainer(cfg, fixmatch.SPEC, device, 4,
                          model=init_model(cfg, device))
        for _ in range(ACCUM_WARM_STEPS):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ACCUM_TIMED_STEPS):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append((accum, (time.perf_counter() - t0) * 1e3
                      / ACCUM_TIMED_STEPS))
    log(f"  bf16 FixMatch micro-step, batch {ACCUM_BATCH} + {ACCUM_BATCH}, "
        f"ms by accum_iter in turns: "
        f"{[(a, round(ms, 3)) for a, ms in times]}")
    return [{"accum_iter": a, "ms_per_micro_step": ms} for a, ms in times]


def phase_accum(torch, shared=None):
    """Phase 12: gradient accumulation, resume and the trace schedule on
    the full-width vit_tiny FixMatch recipe (``shared``: (e)'s rank
    results from phase 10's group)."""
    from semi_seg_ecg_tpu_torch.config import normalize_config

    t_phase = time.perf_counter()
    log("phase 12: gradient accumulation, resume, the trace schedule")
    result = {"straight": accum_straight(torch),
              "teacher": accum_teacher(torch),
              "resume": accum_resume(torch)}
    _, config = write_accum_config("accum_lockstep")
    result["lockstep"] = check_lockstep(torch, normalize_config(config),
                                        phase=12, steps=2 * ACCUM_ITER)
    result["trace"] = accum_trace(torch)
    result["ranks"] = accum_ranks(torch, shared)
    result["step_times"] = accum_step_times(torch)
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 12 in {result['seconds']:.1f} s")
    return result


# ---------------------------------------------------------------------------
# Phase 13: the remaining device-augment ops, the device cache, ZeRO-1
# ---------------------------------------------------------------------------

# (a) each device op ported after the shipped chains' and each level
# override: (config entry, RandAugment level, gather launches a call);
# signals within NEW_OP_TOL absolute and relative of the CPU, labels exact
NEW_OPS = [
    ("xflip", None, 0), ("yflip", None, 0), ("YFlip", 10, 0),
    ({"drop": {"mask_ratio": 0.3}}, None, 0),
    ({"cutout": {"mask_ratio": 0.3}}, None, 0),
    ({"shift": {"mask_ratio": 0.3}}, None, 1),
    ({"random_baseline_shift": {"ratio": 0.5, "scale": 3.0}}, None, 0),
    ("RandomBaselineShift", 10, 0),
    ({"sine_noise": {"amplitude": 1.0, "freq": 0.5}}, None, 0),
    ("SineNoise", 10, 0),
    ({"square_noise": {"amplitude": 1.0, "freq": 0.5}}, None, 0),
    ("SquareNoise", 10, 0),
    ({"white_noise": {"amplitude": 1.0}}, None, 0), ("WhiteNoise", 10, 0),
    ({"RandomApply": {"transform": "RandomShift", "prob": 0.5}}, None, 1),
    ({"RandomApply": {"transform": "RandomBaselineShift", "prob": 0.5}}, 7,
     0),
]
NEW_OP_TOL = 1e-5
# (b) phase 4's FixMatch recipe with the weak chain [resize-crop,
# RandomApply(RandomShift)] and a strong RandAugment of new ops; gathers a
# step: the labeled resize-crop and shift (pairs), the unlabeled view's
# resize-crop and shift, the strong view's shift and partial-sine roll (a
# gated op launches every step)
NEW_WEAK = [{"RandomApply": {"transform": "RandomShift", "prob": 0.5}}]
NEW_STRONG_OPS = [{"AmplitudeScaling": {"sigma": 0.5}}, "RandomShift",
                  "Cutout", "YFlip", "RandomMask", "RandomBaselineShift",
                  "SineNoise",
                  {"RandomPartialSineNoise": {"amplitude": 1, "ratio": 0.5}}]
NEW_GATHERS = 6
# (c) the recipe streaming and with the device cache, under deterministic
# algorithms; the trace of the first CACHE_TRACE_STEPS steps holds the
# host-to-device copies of as many batches (each batch is copied a step
# ahead of its use)
CACHE_TRACE_START, CACHE_TRACE_STEPS = 0, 2
# (d) ZeRO-1 against the replicated optimizer on DP_WORLD ranks under
# deterministic algorithms: phase 10's fp32 FixMatch step (SGD with
# momentum) and the CPS recipe's (AdamW, the peer's optimizer too), bit
# for bit or within tests/test_zero1.py's bounds; a rank's optimizer state
# at most Z1_BYTES_RATIO of the replicated one's
Z1_ALGORITHMS = ("fixmatch", "cps")
Z1_PARAM_ATOL, Z1_LOSS_RTOL, Z1_BYTES_RATIO = 5e-4, 1e-4, 0.6


def check_new_ops(torch):
    """(a) Each op of NEW_OPS under one set of draws made on a CPU
    generator, on the card against the CPU, with labels and without."""
    from semi_seg_ecg_tpu_torch.ops import gather1d
    from semi_seg_ecg_tpu_torch.ops import preprocess as pre

    gen = torch.Generator().manual_seed(13)
    x = torch.randn((BATCH, 1, SIGNAL_LENGTH), generator=gen)
    y = torch.randint(0, 4, (BATCH, SIGNAL_LENGTH), generator=gen)
    result, bad = [], []
    for entry, level, gathers in NEW_OPS:
        name, kwargs = pre._entry_name_kwargs(entry)
        op = pre._make_device_op(name, kwargs, level)
        draws = op.sample(gen, tuple(x.shape))
        row = {"op": name, "kwargs": kwargs, "level": level,
               "label_changeable": op.label_changeable}
        for labels in (y, None):
            part = "labels" if labels is not None else "signal"
            before = gather1d.LAUNCHES
            cx, cy = op.apply(draws, x.cuda(), None if labels is None
                              else labels.cuda())
            torch.cuda.synchronize()
            launched = gather1d.LAUNCHES - before
            px, py = op.apply(draws, x, labels)
            excess = float(((cx.cpu() - px).abs() - NEW_OP_TOL
                            - NEW_OP_TOL * px.abs()).max())
            labels_equal = (cy is None and py is None) or torch.equal(
                cy.cpu(), py)
            row[part] = {"gather_launches": launched,
                         "max_abs_diff": float((cx.cpu() - px).abs().max()),
                         "labels_equal": labels_equal}
            if excess > 0 or not labels_equal or launched != gathers:
                bad.append((name, level, part, excess, labels_equal,
                            launched))
        result.append(row)
        log(f"  (a) {name} level {level}: card vs CPU max |diff| "
            f"{row['labels']['max_abs_diff']:.3g} / "
            f"{row['signal']['max_abs_diff']:.3g} (with labels / without), "
            f"labels equal {row['labels']['labels_equal']}, gather launches "
            f"{row['labels']['gather_launches']} / "
            f"{row['signal']['gather_launches']}")
    if bad:
        raise SystemExit(f"phase 13 failed: new ops on the card differ from "
                         f"the CPU or launch other counts: {bad}")
    return result


def write_new_ops_config(name, cache=False, trace_dir=None):
    """Phase 4's vit_tiny FixMatch recipe (flash attention, device
    augmentation, bf16, 2 epochs of 4 steps) with the new ops' chains,
    streaming or with ``device_cache``, tracing CACHE_TRACE_STEPS steps
    into ``trace_dir``."""
    _, config = write_train_config("vit_tiny", "fixmatch")
    ds = config["dataset"]
    ds["augmentations"] = ds["augmentations"][:1] + NEW_WEAK
    ra = ds["strong_augmentations"][0]["RandAugment"]
    ds["strong_augmentations"] = [{"RandAugment": dict(
        ra, ops=NEW_STRONG_OPS)}]
    ds["device_cache"] = cache
    config["exp_name"] = name
    if trace_dir:
        config["profile"] = {"trace_dir": trace_dir,
                             "start_step": CACHE_TRACE_START,
                             "num_steps": CACHE_TRACE_STEPS}
    path = os.path.join(WORK, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def new_ops_launches():
    """The launches of the new ops' train_main: 24 / 12 flash and
    NEW_GATHERS gathers a step, 12 flash forwards an eval batch."""
    steps = TRAIN_EPOCHS * (TRAIN_LABELED // BATCH)
    evals = (TRAIN_EPOCHS * math.ceil(TRAIN_VALID / BATCH)
             + math.ceil(TRAIN_TEST / BATCH))
    per_step = launches_per_step("vit_tiny", "fixmatch")
    return {"flash_attention_fwd": steps * per_step["flash_attention_fwd"]
            + DEPTH * evals,
            "flash_attention_bwd": steps * per_step["flash_attention_bwd"],
            "gather1d": steps * NEW_GATHERS}


def h2d_copies(trace_path):
    """The bytes of each host-to-device copy in a Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [int(e.get("args", {}).get("bytes", 0)) for e in events
            if "memcpy" in str(e.get("cat", "")).lower()
            and "HtoD" in e.get("name", "")]


def cache_run(torch, name, cache):
    """``train_main`` of the new ops' recipe: its launches, each step's
    loss and batch keys, the final model, the cache's bytes, the traced
    steps' host-to-device copies, and the median wall ms between the
    second epoch's step starts."""
    from semi_seg_ecg_tpu_torch.algorithms import common
    from semi_seg_ecg_tpu_torch.cli import train_main

    trace_dir = os.path.join(WORK, f"{name}_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    path = write_new_ops_config(name, cache, trace_dir)
    calls, trainers = [], []
    real = common.Trainer.train_step

    def recorded(self, batch):
        t0 = time.perf_counter()
        metrics = real(self, batch)
        calls.append((t0, metrics["loss"].item(), sorted(batch)))
        trainers[:] = [self]
        return metrics

    common.Trainer.train_step = recorded
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        test_metrics = train_main(["-f", path])
    finally:
        common.Trainer.train_step = real
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    trainer = trainers[0]
    copies = [c for f in sorted(os.listdir(trace_dir))
              for c in h2d_copies(os.path.join(trace_dir, f))]
    starts = [c[0] for c in calls[TRAIN_LABELED // BATCH:]]
    with open(os.path.join(WORK, "exps", name, "log.txt")) as f:
        epochs = [json.loads(line) for line in f]
    return {"launches": launches, "seconds": seconds,
            "losses": [c[1] for c in calls], "keys": calls[0][2],
            "test_metrics": test_metrics, "log": epochs,
            "state": {k: v.detach().cpu().numpy() for k, v in
                      trainer.model.state_dict().items()},
            "bytes_uploaded": (trainer.cache.bytes_uploaded
                               if trainer.cache is not None else 0),
            "index_batch_bytes": 4 * BATCH,
            "h2d_copies": len(copies),
            "h2d_bytes_per_step": sum(copies) / CACHE_TRACE_STEPS,
            "h2d_max_copy": max(copies, default=0),
            "step_ms": float(np.median(np.diff(starts)) * 1e3)}


def cache_runs(torch):
    """(b, c) under deterministic algorithms (:func:`scan_determinism`, in
    this process): the new ops' recipe streaming, then with the device
    cache; the comparison."""
    with scan_determinism(torch):
        runs = {"stream": cache_run(torch, "new_ops_stream", False),
                "cache": cache_run(torch, "new_ops_cache", True)}
    diff, where = payload_diff(runs["cache"].pop("state"),
                               runs["stream"].pop("state"))
    return {**runs, "state_max_diff": diff, "state_where": where,
            "losses_equal": runs["cache"]["losses"]
            == runs["stream"]["losses"]}


def check_cache(torch):
    """(b, c) :func:`cache_runs`: both runs launch the predicted kernels
    (the streaming run is (b)), and the cached one equals the streaming
    one bit for bit, steps on index batches and copies no more than one
    index batch to the card at a time."""
    result = cache_runs(torch)
    want = new_ops_launches()
    stream, cached = result["stream"], result["cache"]
    for label, run in (("stream", stream), ("cache", cached)):
        log(f"  ({'b' if label == 'stream' else 'c'}) train_main, new ops, "
            f"{label}: {run['seconds']:.2f} s, launches {run['launches']} "
            f"(expected {want}: {NEW_GATHERS} gathers a step); batch keys "
            f"{run['keys']}; uploaded {run['bytes_uploaded']} B; traced "
            f"host-to-device {run['h2d_bytes_per_step']:.0f} B a step in "
            f"{run['h2d_copies']} copies, the largest {run['h2d_max_copy']} "
            f"B; {run['step_ms']:.2f} ms a step (epoch 2, median); losses "
            f"{[round(v, 5) for v in run['losses']]}")
    log(f"  (c) cache = stream: losses equal {result['losses_equal']}, "
        f"final model within {result['state_max_diff']} "
        f"({result['state_where']})")
    finite = all(math.isfinite(v) for run in (stream, cached)
                 for v in run["losses"])
    if not (stream["launches"] == want and cached["launches"] == want
            and finite and result["losses_equal"]
            and result["state_max_diff"] == 0.0
            and cached["keys"] == ["idx", "idx_u"]
            and stream["h2d_max_copy"] >= 4 * BATCH * SIGNAL_LENGTH
            and cached["h2d_max_copy"] <= cached["index_batch_bytes"]):
        raise SystemExit("phase 13 failed: the new ops' recipe or the "
                         "device cache")
    return result


def z1_config(algorithm, backend, on):
    """The vit_tiny step of ZeRO-1's comparison: FixMatch as phase 10
    steps it (fp32, SGD with momentum), CPS as its recipe (AdamW) at fp32
    without dropout; ``parallel.shard_optimizer`` ``on``."""
    from semi_seg_ecg_tpu_torch.config import normalize_config

    if algorithm == "fixmatch":
        cfg = dp_step_config("vit_tiny", backend)
    else:
        _, config = write_train_config("vit_tiny", algorithm)
        cfg = normalize_config(copy.deepcopy(config))
        cfg["precision"] = "fp32"
        cfg["decode_head"]["FCNHead"]["dropout_ratio"] = 0.0
        cfg["train"]["warmup_epochs"] = 0
        cfg["ddp"] = {"dist_backend": backend}
    cfg["parallel"] = dict(cfg.get("parallel") or {}, shard_optimizer=on)
    return cfg


def z1_steps(torch, config, algorithm, batches, checkpoint):
    """A rank's steps of ``algorithm`` (the seed-0 model, and peer) on its
    DP_ROWS rows of each batch: the metrics (the ranks' mean), launches,
    final networks, the bytes of this rank's optimizer state, its peak
    memory; the gathered state written to ``checkpoint`` by rank 0."""
    from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        Trainer,
        full_fp32,
        init_model,
    )
    from semi_seg_ecg_tpu_torch.parallel.dist import all_reduce_mean, get_rank
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    rows = slice(get_rank() * DP_ROWS, (get_rank() + 1) * DP_ROWS)
    device = torch.device("cuda", torch.cuda.current_device())
    # the backward's atomics (index_select's gradient) would make two runs
    # of one step differ in the last bits
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, launches = [], []
    with full_fp32():
        trainer = Trainer(copy.deepcopy(config),
                          get_algorithm(algorithm).SPEC, device, 4,
                          model=init_model(config, device))
        for batch in batches:
            on_card = {k: torch.from_numpy(v[rows]).to(device)
                       for k, v in batch.items()}
            torch.cuda.synchronize()
            reset_counts()
            step = trainer.train_step(on_card)
            launches.append(launch_counts())
            metrics.append({k: all_reduce_mean(v).item()
                            for k, v in step.items()})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    opts = {role: opt for role, opt in (("model", trainer.optimizer),
                                        ("peer", trainer.peer_optimizer))
            if opt is not None}
    opt_bytes = {role: sum(v.numel() * v.element_size()
                           for entry in opt.optimizer.state.values()
                           for v in entry.values() if torch.is_tensor(v))
                 for role, opt in opts.items()}
    states = {role: opt.state_dict() for role, opt in opts.items()}
    if get_rank() == 0:
        ckpt.save_checkpoint(checkpoint, 0, trainer.model, states["model"],
                             config=config, step=trainer.step,
                             peer_model=trainer.peer,
                             peer_optimizer=states.get("peer"))
    nets = {role: {k: v.detach().cpu().numpy()
                   for k, v in module.state_dict().items()}
            for role, module in (("model", trainer.model),
                                 ("peer", trainer.peer)) if module is not None}
    return {"metrics": metrics, "launches": launches, "nets": nets,
            "opt_bytes": opt_bytes, "peak_mib": peak,
            "sharded": trainer.optimizer.sharded}


def z1_resume(torch, config, algorithm, path, batch):
    """One process, unsharded, resumed from ``path``: one step on both
    shards' rows of ``batch``; its loss, launches and model."""
    from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
    from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, full_fp32

    cfg = copy.deepcopy(config)
    cfg["parallel"]["shard_optimizer"] = False
    cfg["resume"] = path
    device = torch.device("cuda")
    with full_fp32():
        trainer = Trainer(cfg, get_algorithm(algorithm).SPEC, device, 4)
        torch.cuda.synchronize()
        reset_counts()
        metrics = trainer.train_step({k: torch.from_numpy(v).to(device)
                                      for k, v in batch.items()})
        launches = launch_counts()
    return {"loss": metrics["loss"].item(), "launches": launches,
            "step": trainer.step,
            "model": {k: v.detach().cpu().numpy()
                      for k, v in trainer.model.state_dict().items()}}


def z1_rank_tasks(torch):
    """(d)'s rank tasks: 3 steps of each of Z1_ALGORITHMS with ZeRO-1 on
    and off, each run's checkpoint written by rank 0."""
    backend, _ = dp_layout(torch)
    batches = dp_global_batches(50)
    return [("z1_steps", {
        "config": z1_config(algorithm, backend, on), "algorithm": algorithm,
        "batches": batches,
        "checkpoint": os.path.join(WORK, f"z1_{algorithm}_{on}.ckpt")})
        for algorithm in Z1_ALGORITHMS for on in (True, False)]


def check_zero1(torch, extra=(), shared=None):
    """(d) ZeRO-1 against the replicated optimizer on DP_WORLD ranks
    (:func:`z1_rank_tasks`), then each run's checkpoint resumed in one
    unsharded process for a fourth step. ``extra`` tasks (another
    phase's) run on the same group after; their results are
    ``result["extra"]``. ``shared``: the results of both and the logs,
    from phase 10's group; alone, a group of its own."""
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    backend, layout = dp_layout(torch)
    resume_batch = dp_global_batches(51)[0]
    tasks = z1_rank_tasks(torch)
    configs = {(kw["algorithm"], kw["config"]["parallel"]["shard_optimizer"]):
               kw["config"] for _, kw in tasks}
    if shared is None:
        shared = dp_run_ranks(tasks + list(extra), backend, phase=13,
                              env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    by_task, logs = shared
    runs = {key: ranks for key, ranks in zip(configs, by_task)}
    result, bad = {"backend": backend, "layout": layout}, []
    if extra:
        result["extra"] = (by_task[len(tasks):], logs)
    for algorithm in Z1_ALGORITHMS:
        on, off = runs[algorithm, True], runs[algorithm, False]
        per_step = launches_per_step("vit_tiny", algorithm)
        loss_rel = max(abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-12)
                       for a, b in zip(on[0]["metrics"], off[0]["metrics"]))
        nets = {role: payload_diff(on[0]["nets"][role], want)
                for role, want in off[0]["nets"].items()}
        ranks_equal = all(payload_diff(on[1]["nets"][role], want)[0] == 0.0
                          for role, want in on[0]["nets"].items())
        files = [ckpt.load_checkpoint(os.path.join(
            WORK, f"z1_{algorithm}_{flag}.ckpt")) for flag in (True, False)]
        opt_diff = {key: payload_diff(files[0][key], files[1][key])
                    for key in ("optimizer", "peer_optimizer")
                    if key in files[1]}
        ratios = {role: [r["opt_bytes"][role] / off[0]["opt_bytes"][role]
                         for r in on] for role in off[0]["opt_bytes"]}
        resumed = [z1_resume(torch, configs[algorithm, flag], algorithm,
                             os.path.join(WORK, f"z1_{algorithm}_{flag}.ckpt"),
                             resume_batch) for flag in (True, False)]
        resume_loss_rel = abs(resumed[0]["loss"] - resumed[1]["loss"]) / max(
            abs(resumed[1]["loss"]), 1e-12)
        resume_diff = payload_diff(resumed[0]["model"], resumed[1]["model"])
        launches_ok = all(l == per_step for r in on + off
                          for l in r["launches"]) and all(
            r["launches"] == per_step for r in resumed)
        row = {"loss_rel": loss_rel, "nets_max_diff": nets,
               "ranks_equal": ranks_equal, "optimizer_max_diff": opt_diff,
               "opt_bytes": {"zero1": [r["opt_bytes"] for r in on],
                             "replicated": off[0]["opt_bytes"]},
               "opt_bytes_ratio": ratios,
               "peak_mib": {"zero1": [r["peak_mib"] for r in on],
                            "replicated": [r["peak_mib"] for r in off]},
               "sharded": [r["sharded"] for r in on + off],
               "launches_per_rank_step": on[0]["launches"][0],
               "resume": {"loss_rel": resume_loss_rel,
                          "model_max_diff": resume_diff,
                          "launches": resumed[0]["launches"],
                          "step": resumed[0]["step"]},
               "metrics": [on[0]["metrics"], off[0]["metrics"]]}
        result[algorithm] = row
        log(f"  (d) {algorithm}, {layout}: ZeRO-1 against replicated, "
            f"{DP_STEPS} fp32 steps: losses within {loss_rel:.3g} relative, "
            f"networks within {nets}, ranks equal {ranks_equal}; gathered "
            f"optimizer state within {opt_diff}; a rank's optimizer bytes "
            f"{row['opt_bytes']['zero1']} against "
            f"{row['opt_bytes']['replicated']} (ratio {ratios}); peak MiB "
            f"a rank {row['peak_mib']}; launches a rank step "
            f"{on[0]['launches'][0]}; resumed unsharded: step "
            f"{resumed[0]['step']} -> loss within {resume_loss_rel:.3g}, "
            f"model within {resume_diff} of the replicated run's resume")
        if not (loss_rel <= Z1_LOSS_RTOL and ranks_equal and launches_ok
                and all(d <= Z1_PARAM_ATOL for d, _ in nets.values())
                and all(d <= Z1_PARAM_ATOL for d, _ in opt_diff.values())
                and all(r <= Z1_BYTES_RATIO for rs in ratios.values()
                        for r in rs)
                and row["sharded"] == [True] * DP_WORLD + [False] * DP_WORLD
                and resume_loss_rel <= Z1_LOSS_RTOL
                and resume_diff[0] <= Z1_PARAM_ATOL
                and resumed[0]["step"] == DP_STEPS + 1):
            bad.append(algorithm)
    if bad:
        raise SystemExit(f"phase 13 failed: ZeRO-1 differs from the "
                         f"replicated optimizer: {bad}")
    return result


def phase_zero_cache(torch, extra=(), shared=None):
    """Phase 13: the remaining device-augment ops on the card, the new
    ops' recipe through train_main streaming and with the device cache,
    and ZeRO-1 against the replicated optimizer (``extra``: other phases'
    tasks on its group; ``shared``: (d)'s and their results from phase
    10's group)."""
    t_phase = time.perf_counter()
    log("phase 13: the new device-augment ops, the device cache, ZeRO-1")
    result = {"ops": check_new_ops(torch), "cache": check_cache(torch),
              "zero1": check_zero1(torch, extra, shared)}
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 13 in {result['seconds']:.1f} s")
    return result


# ---------------------------------------------------------------------------
# Phase 14: tensor parallelism and mesh-sharded long records
# ---------------------------------------------------------------------------

# the (data, model) layouts of the step comparison: 3 model ranks hold one
# head each; at model 2 the 3 heads do not divide, so attention stays whole
# and the MLP is sliced
TP_LAYOUTS = ((1, 3), (2, 2))
# the recipe run: train_main at (1, 3), 2 epochs of 4 steps, bf16
TP_RECIPE_LAYOUT = (1, 3)
# the long records: on the ranks of the (2, 2) layout, 2 data ranks of 2
# model ranks each (the serving model's MLP sliced); the streams: STREAMS
# of TP_STREAM_S s
TP_LONGREC_LAYOUT, TP_STREAM_S = (2, 2), 120
# the bf16 step's timed and traced steps a rank: NCCL, and gloo (its
# all-reduces of CUDA tensors go through the host, and the ranks share
# one card, so its times are the layout's, not the program's)
TP_PROFILE_STEPS = {"nccl": 10, "gloo": 3}


def tp_layout(torch, world):
    """``(backend, description)`` for ``world`` ranks: NCCL where the
    cards cover them (one card a rank), else gloo with CUDA tensors on one
    card."""
    if torch.cuda.device_count() >= world:
        return "nccl", f"{world} ranks on cuda:0-{world - 1}, NCCL"
    return "gloo", (f"{world} ranks on cuda:0 (one card), gloo with CUDA "
                    "tensors")


def tp_step_config(layout, backend, family="vit_tiny"):
    """Phase 10's step configuration on the ``(data, model)`` layout."""
    cfg = dp_step_config(family, backend)
    cfg["parallel"] = dict(cfg.get("parallel") or {},
                           model_parallel=layout[1])
    return cfg


def tp_recipe_config(backend):
    """Phase 4's FixMatch recipe (bf16, flash, device augmentation, phase
    4's split, 2 epochs of 4 steps) at TP_RECIPE_LAYOUT."""
    _, config = write_train_config("vit_tiny", "fixmatch")
    config["exp_name"] = "tp_vit_tiny_fixmatch"
    config["ddp"] = {"dist_backend": backend}
    config["parallel"] = dict(config.get("parallel") or {},
                              model_parallel=TP_RECIPE_LAYOUT[1])
    path = os.path.join(WORK, "tp_vit_tiny_fixmatch.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path, config


def tp_recipe_launches():
    """A rank's launches in the recipe run: its steps (every rank takes
    every row at data 1), an eval batch of the validation split per epoch
    and the test pass."""
    steps = TRAIN_EPOCHS * TRAIN_LABELED // BATCH
    want = {k: steps * v for k, v in
            launches_per_step("vit_tiny", "fixmatch").items()}
    want["flash_attention_fwd"] += DEPTH * (
        TRAIN_EPOCHS * math.ceil(TRAIN_VALID / BATCH)
        + math.ceil(TRAIN_TEST / BATCH))
    return want


def tp_infer(torch, config_path, model_path, name):
    """``inference_main`` of ``model_path`` at fp32 under the config's
    mesh: the outputs and this rank's launches."""
    from semi_seg_ecg_tpu_torch.cli import inference_main

    torch.cuda.synchronize()
    reset_counts()
    probs = inference_main(["-f", config_path, "--model_path", model_path,
                            "--exp_name", name])
    torch.cuda.synchronize()
    return {"probs": probs, "launches": launch_counts()}


def tp_longrec(torch, config_path, model_path, record_path, streams_path):
    """On the data ranks of TP_LONGREC_LAYOUT: the 1 h record through
    ``long_record_inference(mesh=)`` (probabilities, labels, launches, wall
    seconds) and the streams through ``StreamingSegmenter(mesh=)`` pushed a
    second at a time (probabilities, launches)."""
    from semi_seg_ecg_tpu_torch.parallel.dist import barrier
    from semi_seg_ecg_tpu_torch.parallel.mesh import make_mesh
    from semi_seg_ecg_tpu_torch.serving import (
        StreamingSegmenter,
        long_record_inference,
    )

    mesh = make_mesh({"parallel": {"model_parallel": TP_LONGREC_LAYOUT[1]}})
    infer, config = serving_fn(config_path, model_path)
    record, streams = np.load(record_path), np.load(streams_path)
    long_record_inference(config, record[:, :SHORT_S * FS], infer=infer,
                          mesh=mesh)   # warm
    barrier()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = long_record_inference(config, record, infer=infer, mesh=mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    result = {"probs": out["probs"], "labels": out["labels"],
              "launches": launch_counts(), "seconds": seconds}
    seg = StreamingSegmenter(infer, window=SIGNAL_LENGTH, hop=LONGREC_HOP,
                             num_streams=streams.shape[0], mesh=mesh)
    reset_counts()
    pushed = [seg.push(streams[:, :, off:off + STREAM_CHUNK])
              for off in range(0, streams.shape[-1], STREAM_CHUNK)]
    pushed.append(seg.flush())
    result["stream_launches"] = launch_counts()
    result["streams"] = np.concatenate([p[0] for p in pushed], axis=2)
    return result


def tp_check_layout(ranks, single, name):
    """Rank 0's gathered checkpoint layout against one process's, key for
    key (the model's keys and shapes, the optimizer's entries)."""
    got = ranks[0]["checkpoint_layout"]
    want = single["checkpoint_layout"]
    if got != want:
        diff = sorted(k for k in set(got["model"]) | set(want["model"])
                      if got["model"].get(k) != want["model"].get(k))
        raise SystemExit(f"phase 14 failed: {name}'s gathered checkpoint "
                         f"differs from one process's layout: {diff[:5]}")


def tp_memory(ranks, single, layout):
    """Each rank's parameter and optimizer bytes and peak memory against
    one process's."""
    base = single["memory"]
    rows = [{**r["memory"],
             "param_share": r["memory"]["param_bytes"] / base["param_bytes"],
             "optimizer_share": r["memory"]["optimizer_bytes"]
             / base["optimizer_bytes"],
             "peak_share": r["memory"]["peak_memory_mb"]
             / base["peak_memory_mb"]} for r in ranks]
    for r, row in enumerate(rows):
        log(f"    {layout} rank {r}: parameters {row['param_bytes']} B "
            f"({row['param_share']:.4f} of one process's "
            f"{base['param_bytes']}), optimizer {row['optimizer_bytes']} B "
            f"({row['optimizer_share']:.4f}), peak "
            f"{row['peak_memory_mb']:.1f} MiB ({row['peak_share']:.4f} of "
            f"{base['peak_memory_mb']:.1f})")
    return rows


def tp_check_longrec(torch, ranks, config_path, model_path, record,
                     streams):
    """(d): each rank's 1 h record and streams against one process: the
    record within STREAM_ATOL with DEPTH flash forwards per batch of
    LONGREC_BATCH and half the batches a rank; each stream against itself
    alone."""
    from semi_seg_ecg_tpu_torch.ops.stitch import plan_windows
    from semi_seg_ecg_tpu_torch.serving import (
        StreamingSegmenter,
        long_record_inference,
    )

    infer, config = serving_fn(config_path, model_path)
    long_record_inference(config, record[:, :SHORT_S * FS], infer=infer)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    want = long_record_inference(config, record, infer=infer)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_launches = launch_counts()
    total = record.shape[-1]
    data, model = TP_LONGREC_LAYOUT
    n_win, n_pad, _, _ = plan_windows(total, SIGNAL_LENGTH, LONGREC_HOP,
                                      LONGREC_BATCH * data)
    w_per = n_pad // data
    errs, offs = [], []
    for r, got in enumerate(ranks):
        # rank r is data rank r // model
        mine = max(0, min(w_per, n_win - r // model * w_per))
        expect = {"flash_attention_fwd": DEPTH * math.ceil(
            mine / LONGREC_BATCH), "flash_attention_bwd": 0, "gather1d": 0}
        if got["launches"] != expect:
            raise SystemExit(f"phase 14 failed: long record rank {r} "
                             f"launched {got['launches']}, expected "
                             f"{expect} ({mine} windows)")
        errs.append(float(np.abs(got["probs"] - want["probs"]).max()))
        offs.append(labels_off(got["labels"], want["labels"],
                               want["probs"], STREAM_ATOL))
    alone, stream_errs = [], []
    for s in range(streams.shape[0]):
        seg = StreamingSegmenter(infer, window=SIGNAL_LENGTH,
                                 hop=LONGREC_HOP)
        pushed = [seg.push(streams[s, :, off:off + STREAM_CHUNK])
                  for off in range(0, streams.shape[-1], STREAM_CHUNK)]
        pushed.append(seg.flush())
        alone.append(np.concatenate([p[0] for p in pushed], axis=1))
    for got in ranks:
        stream_errs.append(max(float(np.abs(got["streams"][s] - a).max())
                               for s, a in enumerate(alone)))
    steps = plan_windows(streams.shape[-1], SIGNAL_LENGTH, LONGREC_HOP,
                         1)[0]
    want_stream = {"flash_attention_fwd": DEPTH * steps,
                   "flash_attention_bwd": 0, "gather1d": 0}
    bad_streams = [r for r, got in enumerate(ranks)
                   if got["stream_launches"] != want_stream]
    result = {"windows": n_win, "windows_per_rank": w_per,
              "launches_one_process": one_launches,
              "launches_by_rank": [g["launches"] for g in ranks],
              "max_abs_err_by_rank": errs, "labels_off_by_rank": offs,
              "one_process_s": one_s,
              "ranks_s": [g["seconds"] for g in ranks],
              "streams": streams.shape[0],
              "stream_samples": streams.shape[-1],
              "stream_launches_per_rank": ranks[0]["stream_launches"],
              "stream_max_abs_err_by_rank": stream_errs}
    log(f"  (d) 1 h record ({n_win} windows) on {data} data ranks of "
        f"{model} model ranks: launches {result['launches_by_rank']} against one "
        f"process's {one_launches}; max |diff| {errs}, labels off {offs}; "
        f"{streams.shape[0]} streams of {TP_STREAM_S} s: each rank "
        f"{ranks[0]['stream_launches']['flash_attention_fwd']} flash "
        f"forwards, max |diff| against each stream alone {stream_errs}")
    if max(errs) > STREAM_ATOL or any(offs) or max(stream_errs) > \
            STREAM_ATOL or bad_streams:
        raise SystemExit(f"phase 14 failed: mesh-sharded long records "
                         f"disagree with one process ({errs}, {offs}, "
                         f"{stream_errs}, stream launches of ranks "
                         f"{bad_streams})")
    return result


def phase_tensor_parallel(torch, extra=None):
    """Phase 14: ``parallel.model_parallel`` through the port's own path
    (head-parallel flash attention on each rank's heads, the sliced MLP,
    the gathered checkpoint) and ``mesh=`` long records. ``extra``
    (layout: tasks) appends other phases' tasks to a rank group; their
    results and the group's logs are ``result["extra"][layout]``."""
    t_phase = time.perf_counter()
    smi = nvidia_smi().replace("\n", "; ")
    log(f"phase 14: {torch.cuda.device_count()} card(s), {smi}")
    batches = dp_global_batches(41)
    layouts = {layout: tp_layout(torch, layout[0] * layout[1])
               for layout in TP_LAYOUTS}
    # one process, on the card, before the ranks start: the steps on the
    # global batch, the recipe's bf16 step
    single = dp_steps(torch, tp_step_config((1, 1), "gloo"), batches,
                      slice(None))
    one_profile = profile_train_step(torch, dp_profile_config(), "bf16",
                                     phase=14, steps=TP_PROFILE_STEPS["nccl"])
    # (d)'s inputs: seed-0 weights, the 1 h record, the streams
    slice_path, slice_cfg = write_slice_config()
    model_path = os.path.join(WORK, "tp_vit_tiny_seed0.pth")
    write_random_weights(slice_cfg, model_path)
    record_path, record = save_record("tp_hour", HOUR_S, 14)
    infer_cfg = serving_fn(slice_path, model_path)[1]
    streams = np.stack([filtered(infer_cfg, holter_record(
        TP_STREAM_S, 40 + s)) for s in range(STREAMS)])
    streams_path = os.path.join(WORK, "longrec", "tp_streams.npy")
    np.save(streams_path, streams)
    # where the phase's seconds go: the parent's parts, each rank group's
    # tasks (rank 0's)
    spans = {"one_process": time.perf_counter() - t_phase}
    result = {"layouts": {}, "nvidia_smi": smi, "spans": spans}
    recipe_path, _ = tp_recipe_config(layouts[TP_RECIPE_LAYOUT][0])
    best = os.path.join(WORK, "exps", "tp_vit_tiny_fixmatch",
                        "best-MeanIoU.ckpt")

    def launch(layout):
        backend = layouts[layout][0]
        world = layout[0] * layout[1]
        config = tp_step_config(layout, backend)
        tasks = [("steps", {"config": config, "batches": batches})]
        if backend == "nccl" or layout != TP_RECIPE_LAYOUT:
            # on one card the (1, 3) group's recipe run is the phase's
            # longest: its bf16 step's profile (gloo through the host, the
            # layout's time, not the program's) is taken at (2, 2) only
            tasks.append(("tp_profile", {"config": dict(
                dp_profile_config(), parallel={
                    "model_parallel": layout[1]},
                ddp={"dist_backend": backend}),
                "steps": TP_PROFILE_STEPS[backend]}))
        if layout == TP_RECIPE_LAYOUT:
            tasks += [("train", {"config_path": recipe_path}),
                      ("tp_infer", {"config_path": recipe_path,
                                    "model_path": best,
                                    "name": "tp_vit_tiny_fixmatch_served"})]
        if layout == TP_LONGREC_LAYOUT:
            tasks.append(("tp_longrec", {
                "config_path": slice_path, "model_path": model_path,
                "record_path": record_path, "streams_path": streams_path}))
        index[layout] = {name: i for i, (name, _) in enumerate(tasks)}
        tasks += (extra or {}).get(layout, [])
        return start_ranks(tasks, backend, world=world,
                           name=f"tp{layout[0]}x{layout[1]}")

    index = {}
    result["extra"] = {}

    # on one card (gloo) both rank groups at once, since a group's start
    # costs about 12 s; over NCCL one after the other, each timed alone
    together = all(b == "gloo" for b, _ in layouts.values())
    groups = {layout: launch(layout) for layout in layouts} if together \
        else {}
    t_ranks = time.perf_counter()
    for layout, (backend, description) in layouts.items():
        world = layout[0] * layout[1]
        if not together:
            t_ranks = time.perf_counter()
        by_task, logs = finish_ranks(groups.get(layout) or launch(layout),
                                     14)
        name = f"(data {layout[0]}, model {layout[1]})"
        key = f"{layout[0]}x{layout[1]}"
        spans[key] = time.perf_counter() - t_ranks
        spans[f"{key}_tasks"] = rank_task_seconds(logs)
        log(f"  {name}: {description}, ranks done {spans[key]:.1f} s after "
            f"the groups started (rank 0's tasks {spans[f'{key}_tasks']})")
        t0 = time.perf_counter()
        own = index[layout]
        result["extra"][layout] = (by_task[len(own):], logs)
        entry = {"backend": backend, "layout": description,
                 "steps": dp_check_steps("vit_tiny", by_task[0], single,
                                         phase=14, layout=name)}
        tp_check_layout(by_task[0], single, name)
        entry["memory"] = tp_memory(by_task[0], single, name)
        profiles = by_task[own["tp_profile"]] if "tp_profile" in own else []
        if profiles:
            entry["profile"] = profiles
        for r, p in enumerate(profiles):
            log(f"    {name} rank {r}: bf16 step {p['wall_ms_per_step']:.3f} "
                f"ms wall, busy {p['device_busy_ms_per_step']} ms, "
                f"{p['device_events_per_step']:.0f} device events, "
                f"all-reduce {p['allreduce_host_ms_per_step']:.3f} ms on "
                f"the host ({p['allreduce_ms_per_step']} ms of "
                f"NCCL kernels); one process "
                f"{one_profile['wall_ms_per_step']:.3f} ms, "
                f"{one_profile['device_events_per_step']:.0f} events")
        if layout == TP_RECIPE_LAYOUT:
            entry["recipe"] = tp_check_recipe(
                torch, recipe_path, best, by_task[own["train"]],
                by_task[own["tp_infer"]])
        if layout == TP_LONGREC_LAYOUT:
            # (d) long records on the layout's two data ranks
            result["longrec"] = tp_check_longrec(
                torch, by_task[own["tp_longrec"]], slice_path, model_path,
                record, streams)
            result["longrec"]["layout"] = description
            if backend == "nccl":
                log(f"  1 h record wall time: {world} ranks "
                    f"{result['longrec']['ranks_s']} s against one process "
                    f"{result['longrec']['one_process_s']:.3f} s")
        result["layouts"][key] = entry
        spans[f"{key}_checks"] = time.perf_counter() - t0
    result["one_process_profile"] = one_profile
    result["one_process_memory"] = single["memory"]
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 14 in {result['seconds']:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in spans.items()
                    if not isinstance(v, dict)))
    return result


# ``chip_smoke.py --tp-drift``: the step comparison's runs with the
# optimizer's sync of the replicated gradients from model rank 0 off or on:
# (family, layout, deterministic algorithms, sync)
TP_DRIFT_RUNS = (("vit_tiny", (1, 3), False, False),
                 ("vit_tiny", (1, 3), True, False),
                 ("resnet18", (1, 2), False, False),
                 ("resnet18", (1, 2), False, True))


def tp_drift(torch, config, batches, deterministic, sync):
    """:func:`dp_steps` on the config's mesh under PyTorch's default or
    deterministic algorithms, with the optimizer's sync of the replicated
    gradients (its ``broadcast_from_owners_`` over the model group; ZeRO-1
    is off) on or off: the gathered state and the names of the kernels the
    steps launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from semi_seg_ecg_tpu_torch.parallel import dist as pdist

    torch.use_deterministic_algorithms(deterministic)
    real = pdist.broadcast_from_owners_
    if not sync:
        pdist.broadcast_from_owners_ = lambda *args, **kwargs: None
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = dp_steps(torch, config, batches)
    finally:
        pdist.broadcast_from_owners_ = real
    return {"state": out["state"], "kernels": sorted(
        {e.name for e in prof.events() if e.device_type == DeviceType.CUDA})}


def tp_drift_main(out_path):
    """Whether the model ranks' copies of the replicated parameters drift
    apart in phase 14's 3 fp32 steps, for each of TP_DRIFT_RUNS: the
    tensors of the gathered state that differ across the ranks and the
    largest difference, and the kernels launched only under the default
    algorithms; the report to ``out_path`` and one JSON line."""
    import torch

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    phase_build()
    batches = dp_global_batches(41)
    report, kernels = [], {}
    for family, layout, deterministic, sync in TP_DRIFT_RUNS:
        backend, description = tp_layout(torch, layout[0] * layout[1])
        env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"} if deterministic \
            else None
        by_task, _ = dp_run_ranks(
            [("tp_drift", {"config": tp_step_config(layout, backend, family),
                           "batches": batches,
                           "deterministic": deterministic, "sync": sync})],
            backend, phase="tp-drift", env=env, world=layout[0] * layout[1])
        ranks = by_task[0]
        first = ranks[0]["state"]
        apart = {k: max(float(np.abs(r["state"][k].astype(np.float64)
                                     - v).max()) for r in ranks[1:])
                 for k, v in first.items()
                 if any(not np.array_equal(r["state"][k], v)
                        for r in ranks[1:])}
        kernels[(family, deterministic)] = set(ranks[0]["kernels"])
        row = {"family": family, "layout": list(layout),
               "deterministic": deterministic, "sync": sync,
               "ranks": description, "tensors": len(first),
               "tensors_apart": len(apart),
               "max_abs_diff": max(apart.values(), default=0.0),
               "apart": sorted(apart, key=lambda k: -apart[k])[:8]}
        report.append(row)
        log(f"tp-drift {row}")
    only_default = sorted(kernels[("vit_tiny", False)]
                          - kernels[("vit_tiny", True)])
    result = {"nvidia_smi": nvidia_smi(), "runs": report,
              "vit_kernels_only_default": only_default}
    log(f"tp-drift: kernels of the ViT run only under the default "
        f"algorithms: {[k[:100] for k in only_default]}")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


def rank_task_seconds(logs):
    """Rank 0's seconds in each task of a rank group (its log's ``[rank
    task]`` lines)."""
    return {name: float(sec) for name, sec in re.findall(
        r"\[rank task\] (\S+) in ([0-9.]+) s", logs["rank0"])}


def tp_check_recipe(torch, config_path, best, trained, served):
    """(b): each rank's launches in the recipe run, finite losses, moved
    parameters, and the checkpoint served tensor-parallel on the ranks and
    in one process alike (within phase 3's 1e-4)."""
    want = tp_recipe_launches()
    for r, got in enumerate(trained):
        if got["launches"] != want:
            raise SystemExit(f"phase 14 failed: recipe rank {r} launched "
                             f"{got['launches']}, expected {want}")
    out_dir = os.path.join(WORK, "exps", "tp_vit_tiny_fixmatch")
    with open(os.path.join(out_dir, "log.txt")) as f:
        epochs = [json.loads(line) for line in f]
    if len(epochs) != TRAIN_EPOCHS or not all(
            math.isfinite(v) for e in epochs for k, v in e.items()
            if "loss" in k):
        raise SystemExit(f"phase 14 failed: recipe log.txt {epochs}")
    from semi_seg_ecg_tpu_torch.algorithms.common import init_model
    from semi_seg_ecg_tpu_torch.config import load_config, normalize_config
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    config = normalize_config(load_config(config_path))
    start = init_model(dict(config, parallel={"model_parallel": 1}),
                       torch.device("cpu")).state_dict()
    trained_state = ckpt.load_checkpoint(best)["model"]
    moved = sum(not np.array_equal(trained_state[k], v.numpy())
                for k, v in start.items() if v.is_floating_point())
    if moved == 0 or set(trained_state) != set(start):
        raise SystemExit(f"phase 14 failed: the recipe's checkpoint moved "
                         f"{moved} tensors, keys {len(trained_state)}")
    probs, launches, _ = serve(config_path, best,
                               "tp_vit_tiny_fixmatch_one_process",
                               parallel={"model_parallel": 1})
    check_probs("tp recipe served", probs, TRAIN_TEST)
    want_served = {"flash_attention_fwd": DEPTH * math.ceil(
        TRAIN_TEST / BATCH), "flash_attention_bwd": 0, "gather1d": 0}
    diffs = [float(np.abs(s["probs"] - probs).max()) for s in served]
    log(f"  (b) train_main at {TP_RECIPE_LAYOUT}, {TRAIN_EPOCHS} epochs "
        f"bf16: launches per rank {trained[0]['launches']}; log.txt "
        f"{[round(e['train_loss'], 4) for e in epochs]}; {moved} tensors "
        f"moved; served tensor-parallel (launches {served[0]['launches']}) "
        f"and in one process ({launches}): max |diff| {diffs}")
    if launches != want_served or any(s["launches"] != want_served
                                      for s in served) or max(diffs) > 1e-4:
        raise SystemExit(f"phase 14 failed: serving the recipe's checkpoint "
                         f"({launches}, {diffs})")
    return {"launches_per_rank": trained[0]["launches"], "log": epochs,
            "moved": moved,
            "served_max_abs_diff": diffs,
            "seconds": [t["seconds"] for t in trained]}


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 15: sequence parallelism
# ---------------------------------------------------------------------------

# (b): the step comparison's (data, seq) layouts
SEQ_LAYOUTS = ((1, 2), (2, 2))
# (c): the recipe run and its serving
SEQ_RECIPE_LAYOUT = (1, 2)
SEQ_RECIPE_BEST = os.path.join(WORK, "exps", "seq_vit_tiny_fixmatch",
                               "best-MeanIoU.ckpt")
# (a): (label, (B, H, N, D), seq ranks); each in fp32 and bf16
SEQ_RING_CASES = [("ring_n101_s2", (16, 3, 101, 64), 2),
                  ("ring_n2049_s2", (2, 3, 2049, 64), 2),
                  ("ring_n2049_s4", (2, 3, 2049, 64), 4)]
# (d): one fp32 base step on a long window, (batch, samples, patch):
# ResNet18 at 2^17 samples, and vit_tiny at 51,200 (2,049 tokens)
SEQ_LONG = {"resnet18": (4, 2 ** 17, None), "vit_tiny": (4, 51200, 25)}
# (c): fp32 serving on the ranks against one process
SEQ_SERVE_ATOL = 1e-4


def hop_bound(b, h, nq, nkv, d, dtype, backward=False):
    """One hop: q (and out, lse; dO and dq in the backward) of nq rows, k
    and v (dk, dv) of nkv moved once, against 4 (10) · B·H·nq·nkv·D
    flops."""
    elem = 4 if dtype == "float32" else 2
    rows = (4 * nq + 4 * nkv) if backward else (2 * nq + 2 * nkv)
    return bound(rows * b * h * d * elem + b * h * nq * 4,
                 (10 if backward else 4) * b * h * nq * nkv * d,
                 FLASH_PEAK[dtype])


def seq_ring_case(torch, gen, label, shape, size, dtype_name, phase=15):
    """(a): the kernel ring against the plain ring on one input (the seq
    ranks as threads), forward and gradients; then one hop of rank 0 over
    rank 1's padded chunk timed (kernel, plain, SDPA at the same nq and
    n_kv, bound), forward and backward."""
    import torch.nn.functional as F

    from semi_seg_ecg_tpu_torch.ops import flash_attention as fa
    from semi_seg_ecg_tpu_torch.ops import ring_attention as ra
    from semi_seg_ecg_tpu_torch.parallel.seq_shard import block, run_threads

    dtype = getattr(torch, dtype_name)
    b, h, n, d = shape
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda",
                              dtype=dtype) for _ in range(4))
    scale = d ** -0.5
    blocks = [block(n, size, j) for j in range(size)]
    counts = [hi - lo for lo, hi in blocks]

    def ring(kernel):
        def rank(comm):
            lo, hi = blocks[comm.rank]
            qi, ki, vi, gi = (t[:, :, lo:hi].contiguous()
                              for t in (q, k, v, g))
            out, lse = ra.ring_forward(qi, ki, vi, comm, scale, counts,
                                       kernel)
            return out, ra.ring_backward(qi, ki, vi, out, lse, gi, comm,
                                         scale, counts, kernel)
        res = run_threads(size, rank)
        torch.cuda.synchronize()
        return (torch.cat([r[0] for r in res], 2),
                [torch.cat([r[1][i] for r in res], 2) for i in range(3)])

    fwd0, bwd0 = fa.LAUNCHES, fa.BWD_LAUNCHES
    out, grads = ring(True)
    launches = (fa.LAUNCHES - fwd0, fa.BWD_LAUNCHES - bwd0)
    out_p, grads_p = ring(False)
    if dtype_name == "float32":
        tol_out = fa.forward_tolerance(q, k, v, scale, out_p)
        tols = fa.backward_tolerance(q, k, v, out_p, None, g, scale, grads_p)
    else:
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, scale)
        tol_out = ra.ring_forward_error_bound(q, k, v, scale)
        tols = ra.ring_backward_error_bound(q, k, v, ref_out, ref_lse, g,
                                            scale)
    err_out, ratio_out = excess_over(out, out_p, tol_out)
    errs, ratio_bwd = [], 0.0
    for got, want, tol in zip(grads, grads_p, tols):
        e, r = excess_over(got, want, tol)
        errs.append(e)
        ratio_bwd = max(ratio_bwd, r)
    del tol_out, tols
    ok = (math.isfinite(err_out) and ratio_out <= 1
          and all(math.isfinite(e) for e in errs) and ratio_bwd <= 1)
    # one hop: rank 0's queries over rank 1's chunk, padded to the longest
    width = max(counts)
    q0 = q[:, :, :counts[0]].contiguous()
    kc, vc = (torch.nn.functional.pad(t[:, :, blocks[1][0]:blocks[1][1]],
                                      (0, 0, 0, width - counts[1]))
              for t in (k, v))
    nkv = counts[1]
    ks, vs = kc[:, :, :nkv], vc[:, :, :nkv]
    long = n >= 1000
    reps = 20 if long else 200
    hop_out, hop_lse = fa.flash_attention_hop_forward(q0, kc, vc, scale, nkv)
    dout = g[:, :, :counts[0]].contiguous()
    fwd_ms = event_ms(lambda: fa.flash_attention_hop_forward(
        q0, kc, vc, scale, nkv), reps)
    fwd_plain = event_ms(lambda: fa.flash_attention_plain(
        q0, ks, vs, scale), reps // 4)
    fwd_sdpa = event_ms(lambda: F.scaled_dot_product_attention(
        q0, ks, vs, scale=scale), reps)
    bwd_ms = event_ms(lambda: fa.flash_attention_hop_backward(
        q0, kc, vc, hop_out, hop_lse, dout, scale, nkv), reps)
    bwd_plain = event_ms(lambda: fa.flash_attention_backward_plain(
        q0, ks, vs, hop_out, hop_lse, dout, scale), reps // 4)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q0, ks, vs))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    bwd_sdpa = event_ms(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), dout, retain_graph=True), reps)
    fwd_bound = hop_bound(b, h, counts[0], nkv, d, dtype_name)
    bwd_bound = hop_bound(b, h, counts[0], nkv, d, dtype_name, True)
    name = f"{label}_{'fp32' if dtype_name == 'float32' else 'bf16'}"
    log(f"  (a) {name} {shape} over {size} ranks: kernel ring vs plain "
        f"ring: out {err_out:.3g} ({ratio_out:.3g} of the tolerance), "
        f"dq/dk/dv {errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} "
        f"({ratio_bwd:.3g}); launches {launches} (fwd, bwd) | hop "
        f"(nq {counts[0]}, n_kv {nkv} of {width}): fwd kernel "
        f"{fwd_ms:.4f} ms, plain {fwd_plain:.4f}, sdpa {fwd_sdpa:.4f}, "
        f"bound {fwd_bound[0]:.5f} ({fwd_bound[1]}); bwd kernel "
        f"{bwd_ms:.4f} ms, plain {bwd_plain:.4f}, sdpa {bwd_sdpa:.4f}, "
        f"bound {bwd_bound[0]:.5f} ({bwd_bound[1]})")
    if not ok:
        raise SystemExit(f"phase {phase} failed: {name}: the kernel ring "
                         f"disagrees with the plain ring (out {ratio_out}, "
                         f"gradients {ratio_bwd} of the tolerance)")
    common = {"shape": f"hop_{name}", "bhnd": list(shape), "seq": size,
              "nq": counts[0], "n_kv": nkv, "chunk": width,
              "dtype": dtype_name, "tolerance": TOL_NAMES[dtype_name],
              "bound_peak": FLASH_PEAK[dtype_name],
              "ring_launches": launches}
    return (dict(common, max_abs_err=err_out, max_tolerance_ratio=ratio_out,
                 ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_sdpa,
                 bound_ms=fwd_bound[0], bound_by=fwd_bound[1]),
            dict(common, max_abs_err=max(errs), max_abs_err_dq_dk_dv=errs,
                 max_tolerance_ratio=ratio_bwd, ms=bwd_ms,
                 plain_ms=bwd_plain, library_ms=bwd_sdpa,
                 bound_ms=bwd_bound[0], bound_by=bwd_bound[1]))


def seq_step_config(family, layout, backend, head_dropout=0.1,
                    algorithm="fixmatch"):
    """Phase 10's step configuration with the head's dropout on, host
    batches (no device augmentation) and the ``(data, seq)`` layout (a
    third entry: the model axis); the ViT's attention ``auto`` (the ring)
    under seq, flash in one process."""
    cfg = dp_step_config(family, backend, algorithm)
    cfg["dataset"]["device_augment"] = False
    cfg["decode_head"]["FCNHead"]["dropout_ratio"] = head_dropout
    if family == "vit_tiny":
        cfg["backbone"]["vit_tiny"]["attention_impl"] = (
            "auto" if layout[1] > 1 else "flash")
    cfg["parallel"] = dict(cfg.get("parallel") or {},
                           seq_parallel=layout[1])
    if len(layout) > 2:
        cfg["parallel"]["model_parallel"] = layout[2]
    return cfg


def seq_batches(seed):
    """DP_STEPS global batches of DP_WORLD x DP_ROWS rows with the strong
    view made on the host."""
    rng = np.random.default_rng(seed)
    n = DP_WORLD * DP_ROWS
    x = lambda: rng.standard_normal((n, 1, SIGNAL_LENGTH)).astype(np.float32)
    return [{"ecg": x(), "target": rng.integers(0, 4, (n, SIGNAL_LENGTH)),
             "ecg_u_w": x(), "ecg_u_s": x()} for _ in range(DP_STEPS)]


def seq_launches(family, size, steps=1):
    """A seq rank's launches in ``steps`` FixMatch steps: each attention
    of the eval and the student forward a hop per seq rank, each backward
    too; no gather (the augmentation runs on the host under seq)."""
    depth = DEPTH if family == "vit_tiny" else 0
    fwd, bwd = RECIPE_PASSES["fixmatch"]
    return {"flash_attention_fwd": steps * fwd * depth * size,
            "flash_attention_bwd": steps * bwd * depth * size,
            "gather1d": 0}


def seq_recipe_config(backend):
    """Phase 4's FixMatch recipe (bf16, device augmentation asked for, 2
    epochs of 4 steps) at SEQ_RECIPE_LAYOUT with ``auto`` attention."""
    _, config = write_train_config("vit_tiny", "fixmatch")
    config["backbone"]["vit_tiny"]["attention_impl"] = "auto"
    config["exp_name"] = "seq_vit_tiny_fixmatch"
    config["ddp"] = {"dist_backend": backend}
    config["parallel"] = {"seq_parallel": SEQ_RECIPE_LAYOUT[1]}
    path = os.path.join(WORK, "seq_vit_tiny_fixmatch.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path, config


def seq_recipe_launches():
    """A seq rank's launches in the recipe's ``train_main``: its steps, an
    eval batch per epoch and the test pass, each attention a hop per
    rank."""
    size = SEQ_RECIPE_LAYOUT[1]
    steps = TRAIN_EPOCHS * TRAIN_LABELED // BATCH
    want = seq_launches("vit_tiny", size, steps)
    want["flash_attention_fwd"] += DEPTH * size * (
        TRAIN_EPOCHS * math.ceil(TRAIN_VALID / BATCH)
        + math.ceil(TRAIN_TEST / BATCH))
    return want


def seq_long_config(family, seq):
    """(d): the family's scratch recipe at SEQ_LONG's length, fp32, dropout
    off, ``auto`` attention (the ring under seq, flash in one process)."""
    from semi_seg_ecg_tpu_torch.config import load_config, normalize_config

    batch, length, patch = SEQ_LONG[family]
    cfg = normalize_config(load_config(os.path.join(
        REPO, "configs", "base", family, "scratch.yaml")))
    cfg["precision"] = "fp32"
    cfg["dataset"]["signal_length"] = length
    cfg["decode_head"]["FCNHead"]["dropout_ratio"] = 0.0
    if family == "vit_tiny":
        cfg["backbone"]["vit_tiny"].update(seq_len=length, patch_size=patch,
                                           attention_impl="auto")
    cfg["parallel"] = {"seq_parallel": seq}
    return cfg


def seq_long(torch, families=tuple(SEQ_LONG)):
    """(d): one fp32 base step a family on a long window (after a warm
    step): peak memory above what the step starts with, and its ms."""
    from semi_seg_ecg_tpu_torch.algorithms import base
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        Trainer,
        full_fp32,
        init_model,
    )
    from semi_seg_ecg_tpu_torch.parallel.dist import barrier, get_world_size

    device = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for family in families:
        cfg = seq_long_config(family, get_world_size())
        batch, length, _ = SEQ_LONG[family]
        rng = np.random.default_rng(15)
        host = {"ecg": rng.standard_normal((batch, 1, length)).astype(
                    np.float32),
                "target": rng.integers(0, 4, (batch, length))}
        with full_fp32():
            trainer = Trainer(cfg, base.SPEC, device, 4,
                              model=init_model(cfg, device))
            on_card = {k: torch.from_numpy(v).to(device)
                       for k, v in host.items()}
            trainer.train_step(on_card)
            barrier()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            metrics = trainer.train_step(on_card)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        out[family] = {"activation_mb": (torch.cuda.max_memory_allocated()
                                         - before) / 2 ** 20,
                       "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
                       "ms": ms, "loss": loss, "launches": launch_counts()}
        del trainer, on_card
        gc.collect()
        torch.cuda.empty_cache()
    return out


def seq_check_recipe(torch, config_path, best, trained, served):
    """(c): the recipe's launches a rank, its checkpoint served on the
    ranks (fp32) against one process within SEQ_SERVE_ATOL."""
    want = seq_recipe_launches()
    for r, got in enumerate(trained):
        if got["launches"] != want:
            raise SystemExit(f"phase 15 failed: the recipe's rank {r} "
                             f"launched {got['launches']}, expected {want}")
    # one process: the same config without the seq axis
    with open(config_path) as f:
        config = yaml.safe_load(f)
    config["parallel"] = {}
    one_path = os.path.join(WORK, "seq_vit_tiny_fixmatch_one.yaml")
    with open(one_path, "w") as f:
        yaml.safe_dump(config, f)
    one = tp_infer(torch, one_path, best, "seq_one_process")
    err = max(float(np.abs(s["probs"] - one["probs"]).max())
              for s in served)
    log(f"  (c) train_main at (data 1, seq {SEQ_RECIPE_LAYOUT[1]}), bf16: "
        f"{want} launches a rank, test {trained[0]['test_metrics']}; served "
        f"at fp32 on the ranks ({served[0]['launches']} a rank) against one "
        f"process ({one['launches']}): max |diff| {err:.3g}")
    if not err <= SEQ_SERVE_ATOL:
        raise SystemExit(f"phase 15 failed: the ranks' serving is {err} "
                         "off one process's")
    return {"launches_per_rank": want, "served_max_abs_diff": err,
            "serve_launches_per_rank": served[0]["launches"],
            "one_process_launches": one["launches"],
            "test_metrics": trained[0]["test_metrics"]}


def seq_parallel_tasks(torch, layout):
    """Phase 15's rank tasks at ``layout``: (b)'s steps of both backbones,
    and at SEQ_RECIPE_LAYOUT (c) and (d)."""
    backend = tp_layout(torch, layout[0] * layout[1])[0]
    batches = seq_batches(51)
    tasks = [("steps", {"config": seq_step_config(family, layout, backend),
                        "batches": batches})
             for family in ("vit_tiny", "resnet18")]
    if layout == SEQ_RECIPE_LAYOUT:
        recipe_path, _ = seq_recipe_config(backend)
        tasks += [("train", {"config_path": recipe_path}),
                  ("tp_infer", {"config_path": recipe_path,
                                "model_path": SEQ_RECIPE_BEST,
                                "name": "seq_vit_tiny_fixmatch_served"}),
                  ("seq_long", {})]
    return tasks


def phase_seq_parallel(torch, extra=None, after_ring=None, shared=None):
    """Phase 15: ``parallel.seq_parallel`` through the port's own path (the
    time-split ResNet18, ViT and FCN head, ring attention on the flash
    kernels). ``extra`` (layout: tasks) appends another phase's tasks to a
    rank group (a group's start costs tens of seconds); their results are
    ``result["extra"][layout]``. ``shared`` (layout: results and logs)
    holds the results of a layout's tasks (:func:`seq_parallel_tasks`, then
    its extra ones) run on another phase's rank group, whose group then
    does not start here. ``after_ring`` is called once (a) has left the
    card idle (another phase starts its groups beside these)."""
    t_phase = time.perf_counter()
    smi = nvidia_smi().replace("\n", "; ")
    log(f"phase 15: {torch.cuda.device_count()} card(s), {smi}")
    spans = {}
    # (a) on an idle card, before the ranks start
    from semi_seg_ecg_tpu_torch.algorithms.common import full_fp32

    gen = torch.Generator(device="cuda").manual_seed(15)
    hops = {"flash_attention_fwd": [], "flash_attention_bwd": []}
    with full_fp32():
        for label, shape, size in SEQ_RING_CASES:
            for dtype_name in ("float32", "bfloat16"):
                f, b = seq_ring_case(torch, gen, label, shape, size,
                                     dtype_name)
                hops["flash_attention_fwd"].append(f)
                hops["flash_attention_bwd"].append(b)
    spans["ring"] = time.perf_counter() - t_phase
    if after_ring is not None:
        after_ring()
    # the rank groups, both at once (the card is shared from here on)
    batches = seq_batches(51)
    shared = shared or {}
    groups = {}
    for layout in SEQ_LAYOUTS:
        world = layout[0] * layout[1]
        backend, description = tp_layout(torch, world)
        tasks = seq_parallel_tasks(torch, layout)
        own = len(tasks)
        tasks += (extra or {}).get(layout, [])
        groups[layout] = (backend, description, own, None if layout in shared
                          else start_ranks(
                              tasks, backend, world=world,
                              name=f"seq{layout[0]}x{layout[1]}"))
    # one process on the global batch, while the ranks run
    t0 = time.perf_counter()
    single = {family: dp_steps(torch, seq_step_config(family, (1, 1),
                                                      "gloo"),
                               batches, slice(None))
              for family in ("vit_tiny", "resnet18")}
    one_long = seq_long(torch)
    spans["one_process"] = time.perf_counter() - t0
    result = {"nvidia_smi": smi, "spans": spans, "layouts": {},
              "hops": hops, "extra": {}}
    for layout, (backend, description, own, group) in groups.items():
        name = f"(data {layout[0]}, seq {layout[1]})"
        key = f"{layout[0]}x{layout[1]}"
        if group is None:
            by_task, logs = shared[layout]
            where = "on phase 14's rank group"
        else:
            by_task, logs = finish_ranks(group, 15)
            spans[key] = time.perf_counter() - t_phase
            where = f"done {spans[key]:.1f} s into the phase"
        result["extra"][layout] = (by_task[own:], logs)
        spans[f"{key}_tasks"] = rank_task_seconds(logs)
        log(f"  {name}: {description}, {where} (rank 0's tasks "
            f"{spans[f'{key}_tasks']})")
        entry = {"backend": backend, "layout": description, "steps": {}}
        for i, family in enumerate(("vit_tiny", "resnet18")):
            entry["steps"][family] = dp_check_steps(
                family, by_task[i], single[family], phase=15, layout=name,
                want_launches=seq_launches(family, layout[1]))
        if layout == SEQ_RECIPE_LAYOUT:
            entry["recipe"] = seq_check_recipe(
                torch, seq_recipe_config(backend)[0], SEQ_RECIPE_BEST,
                by_task[2], by_task[3])
            # (d) a rank's long-window step against one process's
            entry["long"] = {}
            for family, one in one_long.items():
                ranks = [r[family] for r in by_task[4]]
                share = max(r["activation_mb"] for r in ranks) / one[
                    "activation_mb"]
                entry["long"][family] = {"ranks": ranks, "one_process": one,
                                         "activation_share": share}
                log(f"  (d) {family} {SEQ_LONG[family][:2]} fp32 base "
                    f"step: a rank's activation peak "
                    f"{[round(r['activation_mb'], 1) for r in ranks]} MiB "
                    f"against one process's {one['activation_mb']:.1f} "
                    f"({share:.3f}); peaks "
                    f"{[round(r['peak_mb'], 1) for r in ranks]} / "
                    f"{one['peak_mb']:.1f} MiB; step "
                    f"{[round(r['ms'], 1) for r in ranks]} ms a rank "
                    f"against {one['ms']:.1f} ms (the card shared with the "
                    f"other rank group); launches {ranks[0]['launches']} / "
                    f"{one['launches']}; loss {ranks[0]['loss']:.6f} / "
                    f"{one['loss']:.6f}")
                if not math.isfinite(ranks[0]["loss"]) or abs(
                        ranks[0]["loss"] - one["loss"]) > 1e-4 * abs(
                            one["loss"]):
                    raise SystemExit(f"phase 15 failed: (d) {family}'s "
                                     "loss under seq differs from one "
                                     "process's")
        result["layouts"][key] = entry
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 15 in {result['seconds']:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in spans.items()
                    if not isinstance(v, dict)))
    return result


# Phase 16: every algorithm and option on every mesh. (a) the kernel ring
# on a model rank's one head, (label, (B, H, N, D), seq ranks), each in
# fp32 and bf16
SO_RING_CASES = [("ring_h1_n101_s2", (16, 1, 101, 64), 2),
                 ("ring_h1_n2049_s2", (2, 1, 2049, 64), 2)]
# the rank groups: (data, seq) for ReCo, ST++'s ranking and int8 at seq 2;
# (data, seq, model) for the ViT (one head a model rank) and ResNet18
SO_SEQ_LAYOUT = (1, 2)
SO_VIT_LAYOUT = (1, 2, 3)
SO_RESNET_LAYOUT = (1, 2, 2)
# int8 serving through the model group: the ViT's three heads over
# SO_INT8_MODEL ranks, each data rank of the 6-rank group serving the
# whole batch
SO_INT8_MODEL = 3
# ReCo's thresholds on random weights: every pixel easy (no softmax of 4
# classes peaks below 0.25) and hard, so its contrastive term is live
SO_RECO_TRAIN = {"easy_conf_thresh": 0.25, "eash_conf_thresh": 0.25,
                 "hard_conf_thresh": 0.99}
# ReCo's steps, on the seq ranks and in one process, run under PyTorch's
# deterministic algorithms (:func:`strict_determinism`) and are held by
# phase 10's bounds: under PyTorch's default one process's ResNet18 ReCo
# steps are not repeatable on the card (``--reco-noise``: 2e-7 to 5.5e-6
# beyond 5e-4 relative at the stem, so the ranks' excess over one process
# wandered from 5.7e-6 to 1.2e-5), under the deterministic algorithms they
# repeat bit for bit and the ranks' excess is one number
# ``--reco-noise``: repeats of each of its rank runs and ulp moves
SO_NOISE_REPEATS = 3
# ST++'s ranking: seeds of the three snapshots
SO_SNAPSHOT_SEEDS = (61, 62, 63)
# int8 ViT under seq: the ring's attention output rounds apart from one
# process's flash kernel, so a code of the layer after it (the first
# block's to_out.0, the third int8 call) may cross a .5 boundary, and a
# moved code moves the layers after it by a quantization step: through 12
# blocks the two int8 models part as the card's and the CPU's do (phase
# 9). So the calls before it (the patch embedding, the first qkv) must
# give one process's codes, every one, and the probabilities meet phase
# 9's int8 rule (the JAX package's: INT8_AGREE, INT8_AGREE_CONFIDENT,
# INT8_REL_NORM). Where no rounding differs (ResNet18 under seq, the
# ViT's heads over the model axis, whose int32 partial sums add exactly)
# every code is one process's and the probabilities are within 1e-5
SO_INT8_EXACT_CALLS = 2


def so_reco_config(family, layout, backend):
    """Phase 15's step configuration of the family's ReCo recipe with
    SO_RECO_TRAIN."""
    cfg = seq_step_config(family, layout, backend, algorithm="reco")
    cfg["train"].update(SO_RECO_TRAIN)
    return cfg


def so_stpp_config(seq):
    """The ViT ST++ recipe at fp32 on phase 4's split (its unlabeled half
    ranked), ``auto`` attention (the ring) under seq, flash in one
    process."""
    from semi_seg_ecg_tpu_torch.config import normalize_config

    _, config = write_train_config("vit_tiny", "stpp")
    cfg = normalize_config(copy.deepcopy(config))
    cfg["precision"] = "fp32"
    cfg["backbone"]["vit_tiny"]["attention_impl"] = (
        "auto" if seq > 1 else "flash")
    cfg["parallel"] = {"seq_parallel": seq}
    return cfg


@contextlib.contextmanager
def recording_codes():
    """Inside, every int8 layer's input codes are recorded in call order
    (``ops/quant.quantize_input`` and its import in
    ``models/quant_layers.py``); yields the list."""
    from semi_seg_ecg_tpu_torch.models import quant_layers
    from semi_seg_ecg_tpu_torch.ops import quant

    codes, inner = [], quant.quantize_input

    def recorded(x, act_scale):
        q, scale = inner(x, act_scale)
        codes.append(q.cpu().numpy())
        return q, scale

    quant.quantize_input = quant_layers.quantize_input = recorded
    try:
        yield codes
    finally:
        quant.quantize_input = quant_layers.quantize_input = inner


def so_stpp_rank(torch, config, snapshots):
    """ST++'s ranking (``stpp.select_reliable``) of the unlabeled split by
    the ``snapshots`` (.pth paths) under the config's mesh, each rank on
    its data rank's shards and its seq rank's time block: the
    reliabilities, the reliable ids and the launches."""
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        amp_context,
        eval_loader,
        full_fp32,
        load_eval_weights,
        shard_for_mesh,
    )
    from semi_seg_ecg_tpu_torch.algorithms.stpp import select_reliable
    from semi_seg_ecg_tpu_torch.data.dataset import build_seg_dataset
    from semi_seg_ecg_tpu_torch.models import build_model_from_config
    from semi_seg_ecg_tpu_torch.parallel.mesh import make_mesh

    make_mesh(config)
    device = torch.device("cuda", torch.cuda.current_device())
    models = []
    for path in snapshots:
        model = build_model_from_config(config)
        load_eval_weights(model, path)
        models.append(shard_for_mesh(model.to(device)))
    loader = eval_loader(config, build_seg_dataset(
        config["dataset"], split="train_unlabeled", mode="eval"),
        mode="eval")
    try:
        with full_fp32():
            torch.cuda.synchronize()
            reset_counts()
            reliable, _, reliability = select_reliable(
                models, loader, config["metric"]["num_classes"], device,
                amp_context(config, device))
            torch.cuda.synchronize()
            launches = launch_counts()
    finally:
        loader.close()
    return {"reliable": reliable, "reliability": reliability,
            "launches": launches}


def so_int8_serve(torch, config, x):
    """``make_serving_fn`` of an int8 config under its mesh (calibrating
    on the ranks where it says so) and one batch ``x`` through it, split
    over the seq axis (``seq_shard.sharded_call``, as ``run_inference``
    serves): the probabilities, every int8 layer's input codes (this
    rank's pieces) and the batch's launches."""
    from semi_seg_ecg_tpu_torch.parallel import seq_shard
    from semi_seg_ecg_tpu_torch.parallel.mesh import make_mesh
    from semi_seg_ecg_tpu_torch.serving import make_serving_fn

    make_mesh(config)
    infer, _ = make_serving_fn(config)
    batch = torch.from_numpy(x).to(infer.device)
    torch.cuda.synchronize()
    reset_counts()
    with recording_codes() as codes:
        probs = seq_shard.sharded_call(infer, batch)
    torch.cuda.synchronize()
    return {"probs": probs.cpu().numpy(), "codes": codes,
            "launches": launch_counts()}


def so_join_codes(pieces, whole):
    """The ranks' pieces of one layer's codes joined along the axis they
    split (the first whose length differs from the whole's); where none
    does, every rank holds the whole, which must agree (else None)."""
    dims = [d for d in range(whole.ndim)
            if pieces[0].shape[d] != whole.shape[d]]
    if not dims:
        if any(not np.array_equal(p, pieces[0]) for p in pieces[1:]):
            return None
        return pieces[0]
    return np.concatenate(pieces, axis=dims[0])


def so_check_int8(name, ranks, one, flips_allowed):
    """Each int8 layer's codes of ``ranks`` (the ranks of one data rank)
    joined against one process's, and every rank's probabilities: every
    code equal and the probabilities within 1e-5, or with
    ``flips_allowed`` (SO_INT8_EXACT_CALLS) the first calls' codes equal
    and phase 9's int8 rule. Returns the codes that differ, the first call
    where one does, the probabilities' largest difference and the rule's
    numbers."""
    differ = total = worst_move = 0
    first = None
    for i, whole in enumerate(one["codes"]):
        joined = so_join_codes([r["codes"][i] for r in ranks], whole)
        if joined is None or joined.shape != whole.shape:
            raise SystemExit(f"phase 16 failed: int8 {name}: layer call "
                             f"{i}'s codes do not join into one process's")
        moved = joined.astype(np.int32) - whole.astype(np.int32)
        if first is None and (moved != 0).any():
            first = i
        differ += int((moved != 0).sum())
        total += whole.size
        worst_move = max(worst_move, int(np.abs(moved).max()))
    probs_err = max(float(np.abs(r["probs"] - one["probs"]).max())
                    for r in ranks)
    agree, confident = (min(v) for v in zip(*(
        int8_agreement(one["probs"], r["probs"]) for r in ranks)))
    rel_norm = max(float(np.linalg.norm(r["probs"] - one["probs"])
                         / np.linalg.norm(one["probs"])) for r in ranks)
    log(f"  (e) int8 {name}: {len(one['codes'])} int8 layer calls, "
        f"{differ} of {total} codes differ from one process's (the first "
        f"in call {first}, largest move {worst_move}), probabilities within "
        f"{probs_err:.3g} (relative norm {rel_norm:.3g}), argmax agreement "
        f"{agree:.6f}, {confident:.6f} where confident; a rank's launches "
        f"{ranks[0]['launches']}, one process's {one['launches']}")
    if flips_allowed:
        ok = ((first is None or first >= SO_INT8_EXACT_CALLS)
              and agree > INT8_AGREE and confident > INT8_AGREE_CONFIDENT
              and rel_norm < INT8_REL_NORM)
    else:
        ok = differ == 0 and probs_err <= 1e-5
    if not ok:
        raise SystemExit(f"phase 16 failed: int8 {name} differs from one "
                         f"process's: {differ} codes from call {first}, "
                         f"probabilities {probs_err}")
    return {"codes": total, "codes_differ": differ, "first_call": first,
            "largest_move": worst_move, "probs_max_abs_diff": probs_err,
            "argmax_agreement": agree, "argmax_agreement_confident":
            confident, "rel_norm": rel_norm,
            "launches_per_rank": ranks[0]["launches"],
            "one_process_launches": one["launches"]}


def so_check_ranking(ranks, one, want_launches):
    """ST++'s ranking on the seq ranks against one process's: the
    reliabilities within 1e-3 (a few pixels of 2,500 whose argmax the
    ring's rounding moves), and the reliable half, where a window whose
    reliability lies within twice the largest difference of the cut may
    cross it."""
    err = max(float(np.abs(r["reliability"] - one["reliability"]).max())
              for r in ranks)
    want = one["reliability"]
    cut = np.sort(want)[::-1][len(want) // 2 - 1]
    for r, got in enumerate(ranks):
        if got["launches"] != want_launches:
            raise SystemExit(f"phase 16 failed: ST++'s ranking on rank {r} "
                             f"launched {got['launches']}, expected "
                             f"{want_launches}")
        moved = set(got["reliable"]) ^ set(one["reliable"])
        if any(abs(want[i] - cut) > 2 * err for i in moved):
            raise SystemExit(f"phase 16 failed: ST++'s reliable half on "
                             f"rank {r} differs from one process's: "
                             f"{sorted(moved)}")
    same = set(ranks[0]["reliable"]) == set(one["reliable"])
    log(f"  (b) ST++'s ranking of {len(want)} unlabeled windows by "
        f"{STPP_SNAPSHOTS} ViT snapshots at (data {SO_SEQ_LAYOUT[0]}, seq "
        f"{SO_SEQ_LAYOUT[1]}): reliabilities within {err:.3g} of one "
        f"process's, the reliable half "
        f"{'the same' if same else 'the same but for swaps at the cut'}; "
        f"a rank's launches {ranks[0]['launches']}")
    if not err <= 1e-3:
        raise SystemExit(f"phase 16 failed: ST++'s reliabilities {err} "
                         "off one process's")
    return {"max_abs_diff": err, "reliable_same": same,
            "launches_per_rank": ranks[0]["launches"]}


def state_noise(a, b):
    """max(|a - b| - DP_RTOL |b|) over the float tensors of two runs'
    states, at least 0."""
    return max([0.0] + [float((np.abs(a[k] - v) - DP_RTOL * np.abs(v)).max())
                        for k, v in b.items() if v.dtype.kind == "f"])


def so_layout_name(layout):
    return ("(data {}, seq {})" if len(layout) == 2 else
            "(data {}, seq {}, model {})").format(*layout)


def seq_options_plan(torch):
    """Phase 16's part (a) on an idle card (the kernel ring on one head a
    model rank, each case's hop timed), its inputs (seed-0 serving weights,
    ST++'s three snapshots, an int8 batch, phase 15's step batches) and its
    rank tasks by layout: ``{"hops": ..., "tasks": {layout: [(task,
    kwargs)]}, "names": {layout: [(kind, what)]}, ...}``. In the whole run
    the ``(1, 2)`` and ``(1, 2, 2)`` tasks ride on phase 15's ``(1, 2)``
    and ``(2, 2)`` rank groups (world 2 and 4), and the ``(1, 2, 3)`` group
    starts beside them (:func:`so_start`): a group's start costs tens of
    seconds."""
    from semi_seg_ecg_tpu_torch.algorithms.common import full_fp32

    gen = torch.Generator(device="cuda").manual_seed(16)
    hops = {"flash_attention_fwd": [], "flash_attention_bwd": []}
    with full_fp32():
        for label, shape, size in SO_RING_CASES:
            for dtype_name in ("float32", "bfloat16"):
                f, b = seq_ring_case(torch, gen, label, shape, size,
                                     dtype_name, phase=16)
                hops["flash_attention_fwd"].append(f)
                hops["flash_attention_bwd"].append(b)
    weights = {}
    for family in ("vit_tiny", "resnet18"):
        weights[family] = os.path.join(WORK, f"so_{family}_seed0.pth")
        write_random_weights(write_slice_config(family)[1], weights[family])
    stpp_cfg = so_stpp_config(SO_SEQ_LAYOUT[1])
    snapshots = []
    for seed in SO_SNAPSHOT_SEEDS:
        snapshots.append(os.path.join(WORK, f"so_snapshot{seed}.pth"))
        write_random_weights(stpp_cfg, snapshots[-1], seed)
    int8_x = np.random.default_rng(16).standard_normal(
        (BATCH, 1, SIGNAL_LENGTH)).astype(np.float32)

    def int8_config(family, calibrate, **parallel):
        cfg = deploy_config(family, weights[family], quantize="int8",
                            quantize_calibration=2 if calibrate else 0)
        if family == "vit_tiny":
            cfg["backbone"]["vit_tiny"]["attention_impl"] = (
                "auto" if parallel.get("seq_parallel", 1) > 1 else "flash")
        cfg["parallel"] = parallel
        return cfg

    # (e): (its group's layout, family, calibrated, its own mesh)
    int8_cases = {
        **{f"{family}_{kind}_seq2": (SO_SEQ_LAYOUT, family, kind == "cal",
                                     {"seq_parallel": 2})
           for family in ("vit_tiny", "resnet18")
           for kind in ("dyn", "cal")},
        **{f"vit_tiny_{kind}_model3": (SO_VIT_LAYOUT, "vit_tiny",
                                       kind == "cal",
                                       {"model_parallel": SO_INT8_MODEL})
           for kind in ("dyn", "cal")}}
    batches = seq_batches(16)
    tasks, names = {}, {}
    for layout in (SO_SEQ_LAYOUT, SO_VIT_LAYOUT, SO_RESNET_LAYOUT):
        backend = tp_layout(torch, int(np.prod(layout)))[0]
        tasks[layout], names[layout] = [], []
        if layout == SO_SEQ_LAYOUT:
            for family in ("vit_tiny", "resnet18"):
                tasks[layout].append(("so_steps_strict", {
                    "config": so_reco_config(family, layout, backend),
                    "batches": batches}))
                names[layout].append(("reco", family))
            tasks[layout].append(("so_stpp_rank", {"config": dict(
                stpp_cfg, ddp={"dist_backend": backend}),
                "snapshots": snapshots}))
            names[layout].append(("stpp", None))
        else:
            family = "vit_tiny" if layout == SO_VIT_LAYOUT else "resnet18"
            tasks[layout].append(("so_steps", {"config": seq_step_config(
                family, layout, backend), "batches": batches}))
            names[layout].append(("steps", family))
        for case, (case_layout, family, cal, parallel) in int8_cases.items():
            if case_layout == layout:
                tasks[layout].append(("so_int8_serve", {"config": dict(
                    int8_config(family, cal, **parallel),
                    ddp={"dist_backend": backend}), "x": int8_x}))
                names[layout].append(("int8", case))
    return {"hops": hops, "tasks": tasks, "names": names,
            "int8_cases": int8_cases, "int8_config": int8_config,
            "int8_x": int8_x, "snapshots": snapshots, "batches": batches}


def so_start(torch, plan, layouts):
    """Start the rank groups of ``layouts`` on the plan's tasks (gloo on one
    card, NCCL where the cards cover the ranks), into ``plan["groups"]``."""
    plan.setdefault("groups", {})
    for layout in layouts:
        world = int(np.prod(layout))
        plan["groups"][layout] = start_ranks(
            plan["tasks"][layout], tp_layout(torch, world)[0], world=world,
            name="so" + "x".join(str(a) for a in layout))


def phase_seq_options(torch, plan=None, shared=None):
    """Phase 16: every algorithm and option on every ``(data, seq, model)``
    mesh: ReCo and ST++'s ranking under seq, the ring on a model rank's
    heads under ``seq × model``, ResNet18 under ``seq × model``, int8
    serving under seq and under the model axis. ``plan`` is
    :func:`seq_options_plan`'s (part (a) and the inputs; made here when
    None); ``shared`` maps a layout to the results and logs of its tasks
    run on another phase's rank group (phase 15's); the groups of the
    other layouts are the plan's, or start here, at once."""
    t_phase = time.perf_counter()
    smi = nvidia_smi().replace("\n", "; ")
    log(f"phase 16: {torch.cuda.device_count()} card(s), {smi}")
    spans = {}
    plan = plan or seq_options_plan(torch)
    shared = shared or {}
    if "groups" not in plan:
        so_start(torch, plan, [layout for layout in plan["tasks"]
                               if layout not in shared])
    groups, hops = plan["groups"], plan["hops"]
    # one process, while the ranks run
    t0 = time.perf_counter()
    batches, snapshots = plan["batches"], plan["snapshots"]
    single = {}
    repeats = {}
    for family in ("vit_tiny", "resnet18"):
        with strict_determinism(torch):
            single[("reco", family)], again = (dp_steps(
                torch, so_reco_config(family, (1, 1), "gloo"), batches,
                slice(None)) for _ in range(2))
        repeats[family] = all(
            np.array_equal(v, again["state"][k])
            for k, v in single[("reco", family)]["state"].items())
        single[("steps", family)] = dp_steps(
            torch, seq_step_config(family, (1, 1), "gloo"), batches,
            slice(None))
    single[("stpp", None)] = so_stpp_rank(torch, so_stpp_config(1),
                                          snapshots)
    for case, (_, family, cal, _) in plan["int8_cases"].items():
        single[("int8", case)] = so_int8_serve(
            torch, plan["int8_config"](family, cal), plan["int8_x"])
    spans["one_process"] = time.perf_counter() - t0
    result = {"nvidia_smi": smi, "spans": spans, "hops": hops,
              "reco": {}, "steps": {}, "int8": {}, "groups": {}}
    for layout, names in plan["names"].items():
        key = "x".join(str(a) for a in layout)
        name = so_layout_name(layout)
        world = int(np.prod(layout))
        backend, description = tp_layout(torch, world)
        if layout in shared:
            by_task, logs = shared[layout]
            where = "on another phase's rank group"
        else:
            by_task, logs = finish_ranks(groups[layout], 16)
            spans[key] = time.perf_counter() - t_phase
            where = f"done {spans[key]:.1f} s into the phase"
        result["groups"][key] = where
        log(f"  {name}: {description}, {where} (rank 0's tasks "
            f"{rank_task_seconds(logs)})")
        for (kind, what), ranks in zip(names, by_task):
            ranks = ranks[:world]
            one = single[(kind, what)]
            if kind == "reco":
                for r, got in enumerate(ranks):
                    if not all(m["contr_loss"] > 0 for m in got["metrics"]):
                        raise SystemExit(f"phase 16 failed: {what} ReCo on "
                                         f"rank {r}: no contrastive term")
                log(f"  {what} ReCo under deterministic algorithms: one "
                    f"process repeats bit for bit: {repeats[what]}")
                if not repeats[what]:
                    raise SystemExit(f"phase 16 failed: {what} ReCo: one "
                                     "process's steps under deterministic "
                                     "algorithms do not repeat")
                result["reco"][what] = dict(dp_check_steps(
                    what, ranks, one, phase=16, layout=name,
                    want_launches=seq_launches(what, layout[1]),
                    algorithm="ReCo"), one_process_repeats=True)
            elif kind == "steps":
                result["steps"][what] = dict(dp_check_steps(
                    what, ranks, one, phase=16, layout=name,
                    want_launches=seq_launches(what, layout[1])),
                    layout=list(layout))
            elif kind == "stpp":
                result["stpp"] = so_check_ranking(ranks, one, {
                    "flash_attention_fwd": STPP_SNAPSHOTS * DEPTH
                    * layout[1] * math.ceil(TRAIN_UNLABELED / BATCH),
                    "flash_attention_bwd": 0, "gather1d": 0})
            else:
                # every data rank of the case's own mesh served the whole
                # batch: the ranks of data rank 0 (its seq × model ranks)
                # make one process's codes, the others repeat theirs
                per = int(np.prod(list(plan["int8_cases"][what][3]
                                       .values())))
                for r in range(per, len(ranks)):
                    if any(not np.array_equal(a, b) for a, b in zip(
                            ranks[r % per]["codes"], ranks[r]["codes"])):
                        raise SystemExit(f"phase 16 failed: int8 {what}: "
                                         f"rank {r}'s codes differ from "
                                         f"rank {r % per}'s")
                result["int8"][what] = so_check_int8(
                    what, ranks[:per], one,
                    flips_allowed=what.startswith("vit_tiny")
                    and what.endswith("seq2"))
    # ReCo's gathered inputs on a rank at (data 1, seq 2): the latent
    # (B, D, T) and the two probability maps (B, C, T), fp32
    latent_dim = so_reco_config("vit_tiny", (1, 1), "gloo")[
        "projection_out_dim"]
    rows = DP_WORLD * DP_ROWS
    result["reco_gather_bytes_per_rank"] = {
        "latent_whole": rows * latent_dim * SIGNAL_LENGTH * 4,
        "latent_block": rows * latent_dim * SIGNAL_LENGTH * 4
        // SO_SEQ_LAYOUT[1],
        "probabilities_whole": 2 * rows * 4 * SIGNAL_LENGTH * 4}
    log(f"  ReCo's gathered inputs on a rank at (data 1, seq 2), (B, D, T) "
        f"= ({rows}, {latent_dim}, {SIGNAL_LENGTH}): "
        f"{result['reco_gather_bytes_per_rank']} bytes")
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 16 in {result['seconds']:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in spans.items()
                    if not isinstance(v, dict)))
    return result


@contextlib.contextmanager
def strict_determinism(torch):
    """PyTorch's deterministic algorithms (cuDNN's too) inside, warning
    where an op has none; yields the list of the warnings' first lines."""
    import warnings

    saved = torch.are_deterministic_algorithms_enabled()
    saved_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    with cudnn_deterministic(torch), warnings.catch_warnings(
            record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        seen = []
        try:
            yield seen
        finally:
            torch.use_deterministic_algorithms(saved, warn_only=saved_warn)
            seen.extend(sorted({str(w.message).splitlines()[0][:160]
                                for w in caught}))


def strict_steps(torch, **kwargs):
    """:func:`dp_steps` under :func:`strict_determinism`, the warnings'
    first lines under ``"nondeterministic"``."""
    with strict_determinism(torch) as seen:
        result = dp_steps(torch, **kwargs)
    result["nondeterministic"] = seen
    return result


def so_noise_main(out_path):
    """``chip_smoke.py --reco-noise OUT``, a diagnostic outside the run: one
    process's three fp32 ReCo (and FixMatch) steps of each backbone taken
    twice on the card, under PyTorch's default, under cuDNN's deterministic
    algorithms and under all of PyTorch's (``strict``), and the two runs'
    worst state excess over phase 10's relative bound (``dp_check_steps``'s
    measure): the run-to-run noise that phase 16's comparison of the seq
    ranks with one process sits on. Then ResNet18 ReCo at phase 16's
    ``(data 1, seq 2)`` on gloo ranks, SO_NOISE_REPEATS times in each mode,
    each against one process of its mode; and one strict process fed the
    batches with each sample moved by an ulp, against the unmoved run."""
    import torch

    os.makedirs(WORK, exist_ok=True)
    phase_build()
    batches = seq_batches(16)
    out = {"nvidia_smi": nvidia_smi()}
    modes = {"default": contextlib.nullcontext,
             "deterministic": lambda: cudnn_deterministic(torch),
             "strict": lambda: strict_determinism(torch)}
    single = {}
    for algorithm in ("reco", "fixmatch"):
        for family in ("resnet18", "vit_tiny"):
            cfg = (so_reco_config(family, (1, 1), "gloo")
                   if algorithm == "reco"
                   else seq_step_config(family, (1, 1), "gloo"))
            for label, ctx in modes.items():
                with ctx() as seen:
                    a, b = (dp_steps(torch, cfg, batches, slice(None))
                            for _ in range(2))
                name = f"{family}_{algorithm}_{label}"
                single[name] = a
                out[name] = state_noise(a["state"], b["state"])
                out[name + "_bitwise"] = all(
                    np.array_equal(v, b["state"][k])
                    for k, v in a["state"].items())
                if seen:
                    out[name + "_nondeterministic"] = seen
                log(f"  {name}: two one-process runs, max(|diff| - "
                    f"{DP_RTOL} |b|, 0) = {out[name]:.3g}, bit for bit "
                    f"{out[name + '_bitwise']}"
                    + (f"; ops without a deterministic version: {seen}"
                       if seen else ""))
    cfg = so_reco_config("resnet18", (1, 1), "gloo")
    rng = np.random.default_rng(17)
    for seed in range(SO_NOISE_REPEATS):
        moved = [{k: (v * (1 + np.float32(2 ** -23) * rng.choice(
            [-1, 1], v.shape)).astype(np.float32) if v.dtype == np.float32
            else v) for k, v in batch.items()} for batch in batches]
        with strict_determinism(torch):
            got = dp_steps(torch, cfg, moved, slice(None))
        name = f"resnet18_reco_strict_ulp{seed}"
        out[name] = state_noise(got["state"],
                                single["resnet18_reco_strict"]["state"])
        log(f"  {name}: inputs an ulp apart, max(|diff| - {DP_RTOL} |b|, "
            f"0) = {out[name]:.3g}")
    tasks = []
    for mode in ("so_steps", "so_steps_strict"):
        tasks += [(mode, {"config": so_reco_config(
            "resnet18", SO_SEQ_LAYOUT, "gloo"), "batches": batches})] * (
            SO_NOISE_REPEATS)
    by_task, _ = finish_ranks(start_ranks(
        tasks, "gloo", world=int(np.prod(SO_SEQ_LAYOUT)), name="noise"), 16)
    for i, ((mode, _), ranks) in enumerate(zip(tasks, by_task)):
        label = "strict" if mode.endswith("strict") else "default"
        one = single[f"resnet18_reco_{label}"]
        name = f"resnet18_reco_{label}_seq2_{i % SO_NOISE_REPEATS}"
        out[name] = state_noise(ranks[0]["state"], one["state"])
        out[name + "_nondeterministic"] = ranks[0].get("nondeterministic")
        log(f"  {name}: (data 1, seq 2) against one process, max(|diff| - "
            f"{DP_RTOL} |b|, 0) = {out[name]:.3g}")
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    return 0


# ---------------------------------------------------------------------------
# Phase 17: the checkpoint writer, the directory backend, the cross-platform
# artifact, the flash operators under opcheck
# ---------------------------------------------------------------------------

CKPT_BACKENDS = ("pickle", "orbax")
# (b)'s layouts: phase 13's ZeRO-1 group and phase 14's (1, 3) group
CKPT_TP_LAYOUT = (1, 3)
# (d): opcheck's cases, (dtype, the ViT's strided layout)
CKPT_OPCHECK = (("float32", False), ("bfloat16", True))


def ckpt_backends(torch, config, batch, out_dir):
    """A rank's part of (b): one step of ``config`` (seed-0 weights) on its
    data rank's rows of ``batch``, then the checkpoint written with each
    backend as the training loop writes it (``algorithms/common._save``,
    the writer thread): rank 0 the pickle file, every rank its part of the
    directory. Returns each write's blocked ms and ``all_gather_object``
    calls, and the bytes of this rank's optimizer state."""
    from semi_seg_ecg_tpu_torch.algorithms import common, get_algorithm
    from semi_seg_ecg_tpu_torch.parallel import dist as pdist
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    device = torch.device("cuda", torch.cuda.current_device())
    n = batch["ecg"].shape[0] // pdist.data_size()
    rows = slice(pdist.data_rank() * n, (pdist.data_rank() + 1) * n)
    with common.full_fp32():
        trainer = common.Trainer(
            copy.deepcopy(config), get_algorithm(config["algorithm"]).SPEC,
            device, 4, model=common.init_model(config, device))
        trainer.train_step({k: torch.from_numpy(v[rows]).to(device)
                            for k, v in batch.items()})
    torch.cuda.synchronize()
    gather, calls, blocked = pdist.all_gather_object, {}, {}
    try:
        for backend in CKPT_BACKENDS:
            calls[backend] = 0

            def counted(*args, backend=backend, **kwargs):
                calls[backend] += 1
                return gather(*args, **kwargs)

            pdist.all_gather_object = counted
            t0 = time.perf_counter()
            common._save(trainer, [os.path.join(out_dir, f"{backend}.ckpt")],
                         0, config, backend, True, pdist.is_main_process(),
                         metrics={"loss": 1.0}, best={"loss": 1.0})
            blocked[backend] = (time.perf_counter() - t0) * 1e3
    finally:
        pdist.all_gather_object = gather
    t0 = time.perf_counter()
    ckpt.wait_for_pending()
    flush_ms = (time.perf_counter() - t0) * 1e3
    pdist.barrier()
    opt_bytes = sum(v.numel() * v.element_size()
                    for entry in trainer.optimizer.optimizer.state.values()
                    for v in entry.values() if torch.is_tensor(v))
    return {"blocked_ms": blocked, "flush_ms": flush_ms,
            "all_gather_object": calls, "opt_bytes": opt_bytes}


def ckpt_layout_configs(torch):
    """(b)'s configs: phase 13's ZeRO-1 FixMatch step at data 2, phase 14's
    step at (1, 3); and each group's out directory."""
    backend_z1, _ = dp_layout(torch)
    backend_tp, _ = tp_layout(torch, CKPT_TP_LAYOUT[0] * CKPT_TP_LAYOUT[1])
    return {"zero1": (z1_config("fixmatch", backend_z1, True),
                      os.path.join(WORK, "ckpt_zero1")),
            "1x3": (tp_step_config(CKPT_TP_LAYOUT, backend_tp),
                    os.path.join(WORK, "ckpt_1x3"))}


def ckpt_rank_tasks(torch):
    """(b)'s rank task for each layout, on ``dp_global_batches(70)[0]``."""
    batch = dp_global_batches(70)[0]
    tasks = {}
    for key, (config, out_dir) in ckpt_layout_configs(torch).items():
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        tasks[key] = [("ckpt_backends", {"config": config, "batch": batch,
                                         "out_dir": out_dir})]
    return tasks


def ckpt_writer_run(torch, mode):
    """(a): ``train_main`` of phase 4's recipe, with ``async_checkpoint``
    on (``async``), off (``sync``), or on with every save also written
    synchronously to ``path + ".sync"`` first (``twin``): its launches,
    seconds, the epoch loop's wall time and rank 0's blocked ms per save."""
    from semi_seg_ecg_tpu_torch.cli import train_main
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    _, config = write_train_config("vit_tiny", "fixmatch")
    config = dict(config, exp_name=f"ckpt_{mode}", test=False)
    if mode == "sync":
        config["async_checkpoint"] = False
    path = os.path.join(WORK, f"ckpt_{mode}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    save, blocked = ckpt.save_checkpoint, []

    def timed_save(paths, epoch, *args, **kwargs):
        if mode == "twin":
            save([p + ".sync" for p in paths], epoch, *args,
                 **dict(kwargs, async_write=False))
        t0 = time.perf_counter()
        save(paths, epoch, *args, **kwargs)
        blocked.append((time.perf_counter() - t0) * 1e3)

    ckpt.save_checkpoint = timed_save
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        train_main(["-f", path])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        ckpt.save_checkpoint = save
    out_dir = os.path.join(WORK, "exps", f"ckpt_{mode}")
    with open(os.path.join(out_dir, "log.txt")) as f:
        epochs = [json.loads(line) for line in f]
    return {"seconds": seconds, "launches": launches,
            "epoch_loop_s": epochs[-1]["wall_s"], "blocked_ms": blocked,
            "out_dir": out_dir}


def ckpt_writer(torch):
    """(a) the writer, on and off, and the files against their twins."""
    training = recipe_launches("vit_tiny", "fixmatch")["train"]
    # the twins first: the first run pays the process's first pinned
    # allocations and file writes
    runs = {mode: ckpt_writer_run(torch, mode)
            for mode in ("twin", "async", "sync")}
    twins = {}
    out_dir = runs["twin"]["out_dir"]
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".ckpt"):
            with open(os.path.join(out_dir, name), "rb") as a, \
                    open(os.path.join(out_dir, name + ".sync"), "rb") as b:
                twins[name] = a.read() == b.read()
    bad = [mode for mode, r in runs.items() if r["launches"] != training]
    for mode, r in runs.items():
        log(f"  (a) async_checkpoint {mode}: train_main {r['seconds']:.2f} s,"
            f" epoch loop {r['epoch_loop_s']:.3f} s, rank 0 blocked "
            f"{[round(ms, 2) for ms in r['blocked_ms']]} ms per save, "
            f"launches {r['launches']} (phase 4's {training})")
    log(f"  (a) each async file against the same call written "
        f"synchronously, byte for byte: {twins}")
    if bad or not twins or not all(twins.values()):
        raise SystemExit(f"phase 17 failed: the writer's runs {bad} launched "
                         f"other than {training}, or files differ from "
                         f"their synchronous twins {twins}")
    return {"runs": {m: {k: v for k, v in r.items() if k != "out_dir"}
                     for m, r in runs.items()},
            "twins_equal": twins}


def ckpt_resumed(torch, config, path):
    """A one-process Trainer on the card resumed from ``path``: its state
    (model, optimizer, step) at resume, as NumPy, and after one step on
    ``dp_global_batches(71)[0]`` the model's."""
    from semi_seg_ecg_tpu_torch.algorithms import common, get_algorithm
    from semi_seg_ecg_tpu_torch.utils.checkpoint import _to_numpy

    cfg = copy.deepcopy(config)
    cfg.update(resume=path, parallel={})
    device = torch.device("cuda")
    with common.full_fp32():
        trainer = common.Trainer(cfg, get_algorithm(cfg["algorithm"]).SPEC,
                                 device, 4)
        state = _to_numpy({"model": trainer.model.state_dict(),
                           "optimizer": trainer.optimizer.state_dict(),
                           "step": trainer.step})
        trainer.train_step({k: torch.from_numpy(v).to(device) for k, v in
                            dp_global_batches(71)[0].items()})
    return state, _to_numpy(trainer.model.state_dict())


def ckpt_check_layout(torch, key, config, out_dir, ranks):
    """(b) for one layout, from its ranks' results: the directory's path
    gathered nothing, each rank's bytes against the pickle file's, the
    payloads equal, the resumes equal."""
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    files = {b: os.path.join(out_dir, f"{b}.ckpt") for b in CKPT_BACKENDS}
    written = ckpt.directory_bytes(files["orbax"])
    pickle_bytes = os.path.getsize(files["pickle"])
    payload = payload_diff(ckpt.load_checkpoint(files["orbax"]),
                           ckpt.load_checkpoint(files["pickle"]))
    resumed = {b: ckpt_resumed(torch, config, files[b])
               for b in CKPT_BACKENDS}
    resume = payload_diff(resumed["orbax"][0], resumed["pickle"][0])
    stepped = payload_diff(resumed["orbax"][1], resumed["pickle"][1])
    row = {"ranks": len(ranks), "written_bytes": written,
           "pickle_bytes": pickle_bytes,
           "rank_bytes_over_pickle": [written.get(f"rank{r}", 0)
                                      / pickle_bytes
                                      for r in range(len(ranks))],
           "opt_bytes_per_rank": [r["opt_bytes"] for r in ranks],
           "blocked_ms": [{k: round(v, 3) for k, v in r["blocked_ms"].items()}
                          for r in ranks],
           "flush_ms": [round(r["flush_ms"], 3) for r in ranks],
           "all_gather_object": [r["all_gather_object"] for r in ranks],
           "payload_max_diff": payload, "resume_max_diff": resume,
           "resumed_step_max_diff": stepped}
    log(f"  (b) {key}: {len(ranks)} ranks wrote {written} (pickle file "
        f"{pickle_bytes} bytes: each rank "
        f"{[round(x, 3) for x in row['rank_bytes_over_pickle']]} of it); "
        f"blocked ms by rank {row['blocked_ms']}; all_gather_object calls "
        f"{row['all_gather_object']}; directory against pickle payload "
        f"{payload}, one-process resume {resume}, after a step {stepped}")
    if payload[0] != 0.0 or resume[0] != 0.0 or any(
            r["all_gather_object"]["orbax"] for r in ranks) or any(
            written.get(f"rank{r}", 0) <= 0 for r in range(len(ranks))):
        raise SystemExit(f"phase 17 failed: the {key} directory: payload "
                         f"{payload}, resume {resume}, gathers "
                         f"{row['all_gather_object']}, bytes {written}")
    return row


def ckpt_artifact(torch, vit_model):
    """(c) the ``("cuda", "cpu")`` artifact of the ViT ``vit_model``,
    exported through the ``export`` entry (``--platforms cuda cpu``)."""
    import io

    from semi_seg_ecg_tpu_torch.cli import export_main
    from semi_seg_ecg_tpu_torch.serving import (
        export_serving,
        load_serving,
        make_serving_fn,
    )

    art = os.path.join(WORK, "artifacts")
    os.makedirs(art, exist_ok=True)
    config = deploy_config("vit_tiny", vit_model)
    single_path = os.path.join(art, "vit_tiny_fp32.pt2")
    if not os.path.exists(single_path):  # phase 17 alone
        export_serving(config, single_path)
    path = os.path.join(art, "vit_tiny_cuda_cpu.pt2")
    slice_path, _ = write_slice_config("vit_tiny")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    line = io.StringIO()  # the entry's JSON line goes to the log
    with contextlib.redirect_stdout(line):
        header = export_main(["-f", slice_path, "--model_path", vit_model,
                              "--out", path, "--platforms", "cuda", "cpu"])
    seconds = time.perf_counter() - t0
    log(f"  (c) ecg-torch-export printed {line.getvalue().strip()[:300]}")
    traced = launch_counts()
    serve, _ = load_serving(path)
    single, _ = load_serving(single_path)
    cpu_serve, _ = load_serving(path, "cpu")
    infer_cpu, _ = make_serving_fn({**config, "device": "cpu"})
    equal, per_call = {}, None
    for n in (1, 16, 37):
        x = card_batch(torch, n, 170 + n)
        torch.cuda.synchronize()
        reset_counts()
        got = serve(x)
        torch.cuda.synchronize()
        per_call = launch_counts()
        if per_call != {"flash_attention_fwd": DEPTH,
                        "flash_attention_bwd": 0, "gather1d": 0}:
            raise SystemExit(f"phase 17 failed: the cross-platform "
                             f"artifact's CUDA program launched {per_call}")
        equal[n] = bool(torch.equal(got, single(x)))
    x = card_batch(torch, 2, 172).cpu()
    reset_counts()
    on_cpu = cpu_serve(x)
    cpu_launches = launch_counts()
    with torch.inference_mode():
        cpu_err = (on_cpu - infer_cpu(x)).abs().max().item()
    result = {"platforms": header["platforms"],
              "programs": header["programs"], "bytes": os.path.getsize(path),
              "export_s": seconds, "launches_while_tracing": traced,
              "launches_per_call": per_call,
              "equal_to_one_platform": equal, "cpu_max_abs_err": cpu_err,
              "cpu_launches": cpu_launches}
    log(f"  (c) ('cuda', 'cpu') artifact: {result['bytes']} bytes, exported "
        f"in {seconds:.2f} s ({traced} while tracing), programs "
        f"{header['programs']}; the CUDA program {per_call} a call, equal to "
        f"phase 9's one-platform artifact {equal}; the CPU program within "
        f"{cpu_err:.3g} of ServingFn on the CPU, launches {cpu_launches}")
    if not all(equal.values()) or cpu_err > 1e-5 or any(
            cpu_launches.values()) or any(traced.values()) or \
            header["platforms"] != ["cuda", "cpu"]:
        raise SystemExit(f"phase 17 failed: the cross-platform artifact: "
                         f"{result}")
    return result


def ckpt_opcheck(torch):
    """(d) opcheck's default checks of both flash operators on CUDA tensors
    at the training path's per-block shape."""
    from semi_seg_ecg_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(17)
    b, h, n, d = (16, 3, 101, 64)
    out = {}
    for dtype_name, strided in CKPT_OPCHECK:
        dtype = getattr(torch, dtype_name)
        if strided:
            x = torch.randn(b, n, 3 * h * d, generator=gen, device="cuda")
            q, k, v = (t.reshape(b, n, h, d).transpose(1, 2).to(dtype)
                       for t in x.chunk(3, dim=-1))
        else:
            q, k, v = (torch.randn(b, h, n, d, generator=gen, device="cuda",
                                   dtype=dtype).requires_grad_()
                       for _ in range(3))
        t0 = time.perf_counter()
        torch.library.opcheck(fa._forward_op, (q, k, v, 0.125))
        o, lse = fa._forward_op(q, k, v, 0.125)
        dout = torch.randn(b, h, n, d, generator=gen, device="cuda",
                           dtype=dtype)
        torch.library.opcheck(fa._backward_op, (
            q.detach(), k.detach(), v.detach(), o.detach(), lse, dout,
            0.125))
        label = f"{dtype_name}_{'strided' if strided else 'contiguous'}"
        out[label] = time.perf_counter() - t0
    log(f"  (d) opcheck's default checks pass for the forward and backward "
        f"operators on the card: {out} s")
    return out


def phase_checkpoint(torch, shared=None, vit_model=None):
    """Phase 17: the checkpoint writer, the directory backend, the
    cross-platform artifact, opcheck on the card. ``shared`` holds (b)'s
    rank results from phases 13 and 14 (``{"zero1": ..., "1x3": ...}``);
    alone, the phase starts its own groups. ``vit_model``: phase 4's
    checkpoint, or seed-0 weights when that is missing."""
    t_phase = time.perf_counter()
    smi = nvidia_smi().replace("\n", "; ")
    log(f"phase 17: the checkpoint writer, the directory backend, the "
        f"cross-platform artifact, opcheck; {smi}")
    configs = ckpt_layout_configs(torch)
    if shared is None:
        tasks = ckpt_rank_tasks(torch)
        groups = {"zero1": start_ranks(tasks["zero1"], dp_layout(torch)[0],
                                       name="ckpt_zero1_ranks"),
                  "1x3": start_ranks(tasks["1x3"], configs["1x3"][0][
                      "ddp"]["dist_backend"], world=3,
                      name="ckpt_1x3_ranks")}
    result = {"nvidia_smi": smi, "writer": ckpt_writer(torch)}
    if shared is None:
        shared = {k: finish_ranks(g, 17) for k, g in groups.items()}
    result["directory"] = {
        key: ckpt_check_layout(torch, key, configs[key][0], configs[key][1],
                               shared[key][0][0])
        for key in ("zero1", "1x3")}
    if vit_model is None:
        vit_model = os.path.join(WORK, "exps", "vit_tiny_fixmatch",
                                 "best-MeanIoU.ckpt")
    if not os.path.exists(vit_model):
        _, cfg = write_slice_config("vit_tiny")
        vit_model = os.path.join(WORK, "vit_tiny_seed0.pth")
        write_random_weights(cfg, vit_model)
    result["artifact"] = ckpt_artifact(torch, vit_model)
    result["opcheck_s"] = ckpt_opcheck(torch)
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 17 in {result['seconds']:.1f} s")
    return result


# ---------------------------------------------------------------------------
# Phase 18: train.scan_steps, the captured step
# ---------------------------------------------------------------------------

# (a, b): bf16 steps at scan_steps SCAN_K (two units), fp32 steps held to
# phase 4's rule; (c): captured steps of the other algorithms; (e): steps
# a profile times, in windows of equal length (their spread), and the
# steps it traces
SCAN_K = 4
SCAN_STEPS = 8
SCAN_ALGO_STEPS = 2
SCAN_PROFILE_STEPS = {"eager": 20, "captured": 50}
SCAN_PROFILE_CHUNKS = 5
SCAN_TRACE_STEPS = 5
# each ported kernel's name among a graph's kernel nodes (the backward
# launches a dQ and a dK/dV kernel: its dQ kernel counts the launch)
SCAN_NEEDLES = {"flash_attention_fwd": "flash_fwd_",
                "flash_attention_bwd": "flash_bwd_dq",
                "gather1d": "gather1d_kernel"}
# (d): train_main of phase 4's recipe at scan_steps 3 (each epoch of 4
# steps a unit of 3 and a tail of 1), with the device cache and a trace of
# steps 1-3 (the first three replays)
SCAN_RECIPE_K = 3
SCAN_TRACE = (1, 3)
# the ported kernels' host counters of a run that captures: its warm-up
# step and the capture's pass of the step's host code
SCAN_HOST_PASSES = 2


def scan_run(torch, cfg, algorithm, mode, steps, seed=40, accum=1):
    """``steps`` steps of a Trainer of ``cfg`` (full width) from one init on
    fixed card batches at ``train.accum_iter`` ``accum``, ``mode``
    ``eager`` (scan_steps 1), ``capturable`` (eager, with the captured
    path's optimizers: tensor lr, AdamW's step on the card, SGD's fused
    update) or ``captured`` (scan_steps SCAN_K, the graphs' nodes kept).
    Returns the per-step metrics, the states and the optimizers' on the
    host, the host counters, the peak memory and, captured, each graph's
    kernel launches a replay (summed over a step's graphs, and each graph's
    apart: ``debug.nan_checks`` splits a step in two), the replays, the
    eager reruns and the warm-up's steps."""
    from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        Trainer,
        full_fp32,
        init_model,
    )
    from semi_seg_ecg_tpu_torch.utils.captured_step import (
        CapturedStep,
        count_kernels,
    )

    device = torch.device("cuda")
    cfg = copy.deepcopy(cfg)
    cfg["train"]["scan_steps"] = SCAN_K if mode == "captured" else 1
    cfg["train"]["accum_iter"] = accum
    module = get_algorithm(algorithm)
    spec = module.SEMISUP_SPEC if algorithm == "stpp" else module.SPEC
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with full_fp32():
        trainer = Trainer(cfg, spec, device, 4, model=init_model(cfg, device))
        if mode == "captured":
            trainer.captured = CapturedStep(trainer, keep_graph=True)
        elif mode == "capturable":
            for opt in (trainer.optimizer, trainer.peer_optimizer):
                if opt is not None:
                    opt.make_capturable_()
        batches = []
        for s in range(steps):
            batch = device_batch(torch, seed + s)
            del batch["ecg_u_s"]  # the device augmentation makes it
            batches.append(batch)
        reset_counts()
        metrics = [{k: v.item() for k, v in trainer.train_step(b).items()}
                   for b in batches]
        torch.cuda.synchronize()
    out = {"metrics": metrics, "host_counts": launch_counts(),
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
           "states": {name: {k: v.detach().cpu().clone() for k, v in
                             net.state_dict().items()}
                      for name, net in (("model", trainer.model),
                                        ("teacher", trainer.teacher),
                                        ("peer", trainer.peer))
                      if net is not None},
           "optimizers": [host_copy(torch, opt.state_dict())
                          for opt in trainer.optimizers]}
    if mode == "captured":
        captured = trainer.captured
        out["replays"] = captured.replays
        out["reruns"] = captured.reruns
        out["graph_launches_by_segment"] = {
            kind: [count_kernels(names, SCAN_NEEDLES)
                   for names in captured.segment_kernel_names(kind)]
            for kind in captured.graphs}
        out["graph_launches"] = count_kernels(captured.kernel_names,
                                              SCAN_NEEDLES)
        out["graph_kernel_nodes"] = len(captured.kernel_names)
        out["warm_up_steps"] = captured.warm_up_steps
        out["replays_by_kind"] = dict(captured.replays_by_kind)
        out["graph_launches_by_kind"] = {
            kind: count_kernels(captured.kernel_names_of(kind), SCAN_NEEDLES)
            for kind in captured.graphs}
        out["graph_kernel_nodes_by_kind"] = {
            kind: len(captured.kernel_names_of(kind))
            for kind in captured.graphs}
    return out


def host_copy(torch, obj):
    """``obj`` with each tensor copied to the host, through dicts and
    lists."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: host_copy(torch, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(torch, v) for v in obj)
    return obj


def scan_diff(a, b):
    """Bit equality of two :func:`scan_run` results, and the largest
    difference of a metric (relative) and of a state tensor."""
    metric_rel = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12)
                     for x, y in zip(a["metrics"], b["metrics"]) for k in y)
    state_abs = max(((sa[k].float() - v.float()).abs().max().item()
                     for name, sb in b["states"].items()
                     for sa in [a["states"][name]] for k, v in sb.items()),
                    default=0.0)
    equal = a["metrics"] == b["metrics"] and all(
        torch_equal(a["states"][name][k], v)
        for name, sb in b["states"].items() for k, v in sb.items())
    return {"bit_equal": equal, "metric_rel": metric_rel,
            "state_abs": state_abs}


def scan_rule(cfg, got, want):
    """Phase 4's rule on two fp32 runs: every parameter within
    LOCKSTEP_TIGHT_ATOL_LR lr (the key bias within LOCKSTEP_ATOL_LR lr),
    BN statistics within 1e-4 + 1e-4 relative, the losses within 1e-4
    relative; returns the worst of each and whether they hold."""
    lr = cfg["train"]["lr"]
    worst = {"params_lr": 0.0, "key_bias_lr": 0.0, "running": 0.0}
    ok = True
    for name, state in want["states"].items():
        for k, v in state.items():
            if not v.is_floating_point():
                continue
            err = (got["states"][name][k] - v).abs().max().item()
            if "running" in k:
                worst["running"] = max(worst["running"], err)
                ok &= err <= 1e-4 + 1e-4 * v.abs().max().item()
            elif k.endswith(KEY_BIAS):
                worst["key_bias_lr"] = max(worst["key_bias_lr"], err / lr)
            else:
                worst["params_lr"] = max(worst["params_lr"], err / lr)
    worst["loss_rel"] = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                            for a, b in zip(got["metrics"], want["metrics"])
                            for k in b if k.startswith("loss"))
    ok &= (worst["params_lr"] <= LOCKSTEP_TIGHT_ATOL_LR
           and worst["key_bias_lr"] <= LOCKSTEP_ATOL_LR
           and worst["loss_rel"] <= 1e-4)
    return dict(worst, holds=bool(ok))


def scan_case(torch, label, cfg, algorithm, steps, rule=False):
    """One case of (a)-(c): the eager, capturable and captured runs; the
    captured run equal bit for bit to the capturable one (eager steps with
    the same optimizers); the captured one's launches read from its graph,
    against one step's; the host counters against the warm-up and the
    capture; the captured run against the eager one (``rule``: held to
    :func:`scan_rule`)."""
    family = "vit_tiny" if "vit_tiny" in cfg["backbone"] else "resnet18"
    runs = {mode: scan_run(torch, cfg, algorithm, mode, steps)
            for mode in ("eager", "capturable", "captured")}
    captured = runs["captured"]
    per_step = launches_per_step(family, algorithm)
    host_want = {k: SCAN_HOST_PASSES * v for k, v in per_step.items()}
    out = {"steps": steps, "replays": captured["replays"],
           "graph_launches": captured["graph_launches"],
           "graph_kernel_nodes": captured["graph_kernel_nodes"],
           "host_counts": captured["host_counts"],
           "vs_capturable": scan_diff(captured, runs["capturable"]),
           "vs_eager": scan_diff(captured, runs["eager"]),
           "capturable_vs_eager": scan_diff(runs["capturable"],
                                            runs["eager"]),
           "losses": {mode: [m.get("loss") for m in r["metrics"]]
                      for mode, r in runs.items()}}
    if rule:
        out["rule"] = scan_rule(cfg, captured, runs["eager"])
    log(f"  ({label}) {algorithm} {cfg['precision']}, {steps} steps: "
        f"{captured['replays']} replays, launches a replay "
        f"{captured['graph_launches']} of {captured['graph_kernel_nodes']} "
        f"kernel nodes (a step {per_step}), host counters "
        f"{captured['host_counts']}; captured vs capturable "
        f"{out['vs_capturable']}, vs eager {out['vs_eager']}, capturable "
        f"vs eager {out['capturable_vs_eager']}"
        + (f"; phase 4's rule {out['rule']}" if rule else ""))
    failed = []
    if not out["vs_capturable"]["bit_equal"]:
        failed.append(f"captured vs capturable {out['vs_capturable']}")
    if captured["graph_launches"] != per_step:
        failed.append(f"graph launches {captured['graph_launches']}")
    if captured["host_counts"] != host_want:
        failed.append(f"host counters {captured['host_counts']}")
    if captured["replays"] != steps - 1:
        failed.append(f"{captured['replays']} replays")
    if not all(math.isfinite(v) for m in captured["metrics"]
               for v in m.values()):
        failed.append("non-finite metrics")
    if rule and not out["rule"]["holds"]:
        failed.append(f"phase 4's rule {out['rule']}")
    if failed:
        raise SystemExit(f"phase 18 failed: ({label}) {algorithm} "
                         f"{cfg['precision']}: {', '.join(failed)}")
    return out


def scan_config(family, algorithm, precision, sgd=False):
    """Phase 4's recipe of ``family`` / ``algorithm`` at full width
    (``write_train_config``), normalized, in ``precision``; dropout as
    shipped, the confidence threshold of phase 4's lockstep; ``sgd``: SGD
    with momentum, as phase 5's ResNet18 lockstep."""
    from semi_seg_ecg_tpu_torch.config import normalize_config

    _, config = write_train_config(family, algorithm)
    cfg = normalize_config(copy.deepcopy(config))
    cfg["precision"] = precision
    cfg["train"]["conf_thresh"] = (RESNET_LOCKSTEP_CONF_THRESH
                                   if family == "resnet18"
                                   else LOCKSTEP_CONF_THRESH)
    if sgd:
        cfg["train"].update(optimizer="sgd",
                            optimizer_kwargs={"momentum": 0.9})
    return cfg


@contextlib.contextmanager
def scan_determinism(torch, warn_only=False):
    """PyTorch's deterministic algorithms (cuDNN's too) inside, with the
    cuBLAS workspace setting they ask for, so that a step repeats bit for
    bit on the card; ``warn_only``: an op without one warns
    (:func:`strict_determinism`) instead of raising. Yields the warnings'
    first lines; the process's settings come back on exit."""
    saved_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        if warn_only:
            with strict_determinism(torch) as seen:
                yield seen
        else:
            saved = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(True)
            try:
                with cudnn_deterministic(torch):
                    yield []
            finally:
                torch.use_deterministic_algorithms(saved)
    finally:
        if saved_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved_env


def scan_equal(torch):
    """Phase 18 (a)-(c) under :func:`scan_determinism`: each case of
    :func:`scan_case`, with each part's seconds."""
    result = {"a": {}, "b": {}, "c": {}, "seconds": {}}
    with scan_determinism(torch):
        for part, family in (("a", "vit_tiny"), ("b", "resnet18")):
            t = time.time()
            result[part]["bf16"] = scan_case(
                torch, part, scan_config(family, "fixmatch", "bf16"),
                "fixmatch", SCAN_STEPS)
            result[part]["fp32"] = scan_case(
                torch, part, scan_config(family, "fixmatch", "fp32",
                                         sgd=family == "resnet18"),
                "fixmatch", LOCKSTEP_STEPS, rule=True)
            result["seconds"][part] = time.time() - t
        t = time.time()
        for algorithm in ("mean_teacher", "cps", "reco", "stpp"):
            result["c"][algorithm] = scan_case(
                torch, "c", scan_config("vit_tiny", algorithm, "bf16"),
                algorithm, SCAN_ALGO_STEPS)
        result["seconds"]["c"] = time.time() - t
    return result


@contextlib.contextmanager
def built_trainers(capturable=False, keep_graph=False):
    """Every ``Trainer`` built inside, in the list yielded; ``capturable``:
    each with the captured path's optimizers from its start
    (``make_capturable_``), an eager run that updates as a captured run
    does; ``keep_graph``: a trainer that captures keeps its graphs' nodes
    (``CapturedStep.kernel_names_of``)."""
    from semi_seg_ecg_tpu_torch.algorithms import common
    from semi_seg_ecg_tpu_torch.utils.captured_step import CapturedStep

    init = common.Trainer.__init__
    built = []

    def hooked(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if capturable:
            for opt in (self.optimizer, self.peer_optimizer):
                if opt is not None:
                    opt.make_capturable_()
        if keep_graph and self.capture:
            self.captured = CapturedStep(self, keep_graph=True)
        built.append(self)

    common.Trainer.__init__ = hooked
    try:
        yield built
    finally:
        common.Trainer.__init__ = init


def payloads_equal(torch, a, b, keys):
    """Whether two checkpoint payloads hold the same ``keys``, every tensor
    and array equal bit for bit and every other value equal."""
    def same(x, y):
        if torch.is_tensor(x) or torch.is_tensor(y):
            return (torch.is_tensor(x) and torch.is_tensor(y)
                    and x.shape == y.shape and x.dtype == y.dtype
                    and torch_equal(x, y))
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            return (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
                    and x.dtype == y.dtype
                    and np.array_equal(x, y, equal_nan=x.dtype.kind in "fc"))
        if isinstance(x, dict) and isinstance(y, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
            return len(x) == len(y) and all(map(same, x, y))
        return x == y

    return all(same(a.get(k), b.get(k)) for k in keys)


def scan_recipe(torch, eager_log=None):
    """(d) ``train_main`` of phase 4's recipe at scan_steps SCAN_RECIPE_K
    with the device cache and a trace of the replays SCAN_TRACE, and the
    same recipe eager with the captured path's optimizers
    (:func:`built_trainers`), both under deterministic algorithms: their
    log rows, test metrics and best checkpoints equal bit for bit. Its
    launches (host counters: the warm-up and the capture, and the eval and
    test forwards; the trace: the replays' kernels; the run's own: the
    warm-up's, the evals' and the replays' at the trace's count a replay,
    equal to the eager run's).
    Its checkpoint resumed eagerly for one epoch and served by the test
    pass (the other way round, an eager optimizer state resumed captured:
    ``tests/test_torch_cuda.py``). Phase 4's eager log (``eager_log``,
    default algorithms and optimizers) only reported against."""
    from semi_seg_ecg_tpu_torch.cli import train_main
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    _, config = write_train_config()
    trace_dir = os.path.join(WORK, "scan_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)

    def write(name, **over):
        cfg = copy.deepcopy(config)
        cfg["exp_name"] = name
        cfg["dataset"]["device_cache"] = True
        for key, value in over.items():
            if key in ("scan_steps", "epochs"):
                cfg["train"][key] = value
            else:
                cfg[key] = value
        path = os.path.join(WORK, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    runs = {}
    steps_per_epoch = TRAIN_LABELED // BATCH
    per_step = launches_per_step("vit_tiny", "fixmatch")
    eval_batches = (math.ceil(TRAIN_VALID / BATCH),
                    math.ceil(TRAIN_TEST / BATCH))

    def best(name):
        return os.path.join(WORK, "exps", name, "best-loss.ckpt")

    profile = {"trace_dir": trace_dir, "start_step": SCAN_TRACE[0],
               "num_steps": SCAN_TRACE[1]}
    warned = []
    for name, k, resume in (("scan_fixmatch", SCAN_RECIPE_K, None),
                            ("scan_eager_capturable", 1, None),
                            ("scan_resumed_eagerly", 1,
                             best("scan_fixmatch"))):
        over = {"scan_steps": k}
        determinism = contextlib.nullcontext([])
        if resume is None:
            # the test pass serves the run's checkpoint
            over["epochs"] = TRAIN_EPOCHS
            if k > 1:
                over["profile"] = profile
            start, epochs, test_batches = 0, TRAIN_EPOCHS, eval_batches[1]
            determinism = scan_determinism(torch, warn_only=True)
        else:
            # one epoch past the file's; the resumed run keeps the file's
            # best thresholds, so it may write no checkpoint of its own
            start = ckpt.load_checkpoint(resume)["epoch"] + 1
            epochs, test_batches = start + 1, 0
            over.update(epochs=epochs, resume=resume, test=False)
        path = write(name, **over)
        t = time.time()
        reset_counts()
        with determinism as seen, built_trainers(
                capturable=name == "scan_eager_capturable") as trainers:
            test_metrics = train_main(["-f", path])
            torch.cuda.synchronize()
        warned.extend(w for w in seen if w not in warned)
        counts = launch_counts()
        replays = sum(t.captured.replays for t in trainers
                      if t.captured is not None)
        del trainers
        ran = epochs - start
        # the host counts each eager step, or a captured run's first step
        # and its capture; each epoch's eval batches and the test pass
        passes = ran * steps_per_epoch if k == 1 else SCAN_HOST_PASSES
        want = {key: passes * v for key, v in per_step.items()}
        want["flash_attention_fwd"] += DEPTH * (ran * eval_batches[0]
                                                + test_batches)
        with open(os.path.join(WORK, "exps", name, "log.txt")) as f:
            rows = [json.loads(line) for line in f]
        runs[name] = {"seconds": time.time() - t, "host_counts": counts,
                      "host_counts_expected": want, "replays": replays,
                      "log": rows, "test_metrics": test_metrics,
                      "epochs": [start, epochs]}
        log(f"  (d) {name}: {runs[name]['seconds']:.1f} s, epochs "
            f"{start}-{epochs - 1}, {replays} replays, host counters "
            f"{counts} (expected {want}), log {rows}, test metrics "
            f"{test_metrics}")
        if counts != want or [r["epoch"] for r in rows] != list(
                range(start, epochs)) or not all(
                math.isfinite(v) for r in rows for key, v in r.items()
                if "loss" in key):
            raise SystemExit(f"phase 18 failed: (d) {name}: host counters "
                             f"{counts}, expected {want}, or its log rows")
    captured, eager = runs["scan_fixmatch"], runs["scan_eager_capturable"]
    payload = ckpt.load_checkpoint(best("scan_fixmatch"))
    captured["checkpoint_step"] = payload["step"]
    if not isinstance(captured["test_metrics"], dict):
        raise SystemExit("phase 18 failed: (d) no test metrics from the "
                         "captured run's checkpoint")

    def without_wall(rows):
        return [{k: v for k, v in r.items() if k != "wall_s"} for r in rows]

    equal = {"log": without_wall(captured["log"])
             == without_wall(eager["log"]),
             "test_metrics": captured["test_metrics"]
             == eager["test_metrics"],
             "checkpoint": payloads_equal(
                 torch, payload, ckpt.load_checkpoint(best("scan_eager_capturable")),
                 ("model", "model_ema", "model_peer", "optimizer",
                  "peer_optimizer", "step", "epoch"))}
    # against phase 4's eager run (default algorithms, eager optimizers):
    # reported, not held
    worst = {"rel": None, "metric": None}
    if eager_log is not None and len(eager_log) == len(captured["log"]):
        worst = {"rel": 0.0, "metric": 0.0}
        for a, b in zip(captured["log"], eager_log):
            for k, v in b.items():
                if k in ("epoch", "wall_s") or k not in a:
                    continue
                if "loss" in k or k.startswith("train_"):
                    worst["rel"] = max(worst["rel"],
                                       abs(a[k] - v) / max(abs(v), 1e-12))
                else:
                    worst["metric"] = max(worst["metric"], abs(a[k] - v))
    # the trace of the first replays: its ranges and the ported kernels'
    # events, as a replay launches them
    files = sorted(os.listdir(trace_dir))
    first, count = SCAN_TRACE
    want_file = f"rank0_steps{first}-{first + count - 1}.pt.trace.json"
    with open(os.path.join(trace_dir, want_file)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    traced = {k: sum(needle in name for name in kernels)
              for k, (needle, _) in TRACE_KERNELS.items()}
    traced_want = {k: count * per_step[k] * n
                   for k, (_, n) in TRACE_KERNELS.items()}
    # the run's launches: the host counters less the capture's pass (it
    # records, and launches nothing), and each replay's from the trace
    launches = {k: captured["host_counts"][k] - per_step[k]
                + captured["replays"] * traced[k] // (count * n)
                for k, (_, n) in TRACE_KERNELS.items()}
    # the eager run launches what the captured run does
    equal["launches"] = launches == eager["host_counts"]
    log(f"  (d) captured against eager with the captured optimizers, bit "
        f"for bit: {equal}; warnings {warned}; against phase "
        f"4's eager log: losses within {worst['rel']} relative, metrics "
        f"within {worst['metric']}; trace {files}: {len(kernels)} kernel "
        f"events, of the ported kernels {traced} (expected {traced_want}); "
        f"the run's launches {launches}")
    replays_want = TRAIN_EPOCHS * steps_per_epoch - 1
    if not all(equal.values()) or files != [want_file] or \
            traced != traced_want or captured["replays"] != replays_want:
        raise SystemExit(f"phase 18 failed: (d) the captured run against "
                         f"the eager one {equal}, its trace {traced} or its "
                         f"{captured['replays']} replays")
    return {"runs": runs, "equal": equal, "warnings": warned,
            "vs_phase4_log_rel": worst["rel"],
            "vs_phase4_log_metric": worst["metric"],
            "trace_file": want_file, "trace_kernel_events": len(kernels),
            "trace_ported_kernel_events": traced, "launches": launches}


def scan_step_profile(step, steps):
    """``steps`` calls of ``step`` (after two untimed ones: a captured
    run's warm-up and capture) in SCAN_PROFILE_CHUNKS windows, and a trace
    of SCAN_TRACE_STEPS more (``profile_step``)."""
    import torch

    return profile_step(step, steps, torch.device(
        "cuda", torch.cuda.current_device()), chunks=SCAN_PROFILE_CHUNKS,
        traced=SCAN_TRACE_STEPS)


def scan_profile(torch, family):
    """(e) The bf16 FixMatch step of ``family`` eager and captured
    (``profile_step`` of SCAN_PROFILE_STEPS steps)."""
    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        Trainer,
        full_fp32,
        init_model,
    )

    out = {}
    for mode in ("eager", "captured"):
        cfg = scan_config(family, "fixmatch", "bf16")
        cfg["train"]["scan_steps"] = SCAN_K if mode == "captured" else 1
        batch = device_batch(torch, 30)
        del batch["ecg_u_s"]
        with full_fp32():
            trainer = Trainer(cfg, fixmatch.SPEC, torch.device("cuda"), 4,
                              model=init_model(cfg, torch.device("cuda")))
            out[mode] = scan_step_profile(lambda: trainer.train_step(batch),
                                          SCAN_PROFILE_STEPS[mode])
        log(f"  (e) {family} bf16 step, {mode}: {out[mode]}")
    return out


def phase_scan(torch, eager_log=None):
    """``train.scan_steps``: (a)-(c) under deterministic algorithms
    (:func:`scan_equal`), (d) the recipe through ``train_main``, (e) the
    profiles; each part's seconds."""
    result = scan_equal(torch)
    t = time.time()
    result["d"] = scan_recipe(torch, eager_log)
    result["seconds"]["d"] = time.time() - t
    t = time.time()
    result["e"] = {family: scan_profile(torch, family)
                   for family in ("vit_tiny", "resnet18")}
    result["seconds"]["e"] = time.time() - t
    log(f"  phase 18 seconds by part: {result['seconds']}")
    return result


# ---------------------------------------------------------------------------
# Phase 19: train.scan_steps across accumulation windows and ranks
# ---------------------------------------------------------------------------

# (a): (family, algorithm, precision, accum_iter) of each case, each run
# for three windows and one micro-step more: the warm-up's window, then
# each graph replayed at least twice
SCAN_ACCUM_CASES = (("vit_tiny", "fixmatch", "bf16", 2),
                    ("vit_tiny", "fixmatch", "bf16", 3),
                    ("vit_tiny", "fixmatch", "fp32", 2),
                    ("vit_tiny", "fixmatch", "fp32", 3),
                    ("vit_tiny", "mean_teacher", "bf16", 2),
                    ("vit_tiny", "cps", "bf16", 2),
                    ("resnet18", "fixmatch", "bf16", 2))
# (b): phase 12's recipe (ACCUM_STEPS micro-steps an epoch, accum_iter
# ACCUM_ITER) at scan_steps SCAN_ACCUM_K, a unit an epoch, so that a window
# spans units and the first epoch's end
SCAN_ACCUM_K = 3
# (d): the steps of each rank case (the warm-up and replays of both kinds
# at accum_iter 2), and the steps the bf16 ViT profile times
SCAN_RANK_STEPS = 5
SCAN_RANK_PROFILE_STEPS = {"eager": 10, "captured": 30}
SCAN_RANK_TIMEOUT = 300


def scan_accum_case(torch, family, algorithm, precision, accum):
    """(a) One case: the captured micro-steps against the same micro-steps
    taken eagerly with the capturable optimizers, bit for bit; each
    graph's launches read from its nodes, against one step's; the host
    counters (the warm-up's window and the two captures), the replays of
    each kind, the peak memory of both runs."""
    label = f"{family}_{algorithm}_{precision}_accum{accum}"
    cfg = scan_config(family, algorithm, precision)
    steps = 3 * accum + 1
    runs = {mode: scan_run(torch, cfg, algorithm, mode, steps, accum=accum)
            for mode in ("capturable", "captured")}
    captured = runs["captured"]
    per_step = launches_per_step(family, algorithm)
    updates = sum(j % accum == accum - 1 for j in range(accum, steps))
    replays_want = {"accumulate": steps - accum - updates, "update": updates}
    out = {"steps": steps, "accum_iter": accum,
           "warm_up_steps": captured["warm_up_steps"],
           "replays_by_kind": captured["replays_by_kind"],
           "graph_launches_by_kind": captured["graph_launches_by_kind"],
           "graph_kernel_nodes_by_kind":
               captured["graph_kernel_nodes_by_kind"],
           "host_counts": captured["host_counts"],
           "peak_mib": {mode: r["peak_mib"] for mode, r in runs.items()},
           "vs_capturable": scan_diff(captured, runs["capturable"]),
           "losses": [m.get("loss") for m in captured["metrics"]]}
    log(f"  (a) {label}, {steps} micro-steps: warm-up "
        f"{out['warm_up_steps']} steps, replays {out['replays_by_kind']}, "
        f"launches a replay {out['graph_launches_by_kind']} of "
        f"{out['graph_kernel_nodes_by_kind']} kernel nodes (a step "
        f"{per_step}), host counters {out['host_counts']}; peak MiB "
        f"{out['peak_mib']}; captured vs capturable {out['vs_capturable']}")
    failed = []
    if not out["vs_capturable"]["bit_equal"]:
        failed.append(f"captured vs capturable {out['vs_capturable']}")
    if out["graph_launches_by_kind"] != {"accumulate": per_step,
                                         "update": per_step}:
        failed.append(f"graph launches {out['graph_launches_by_kind']}")
    if out["host_counts"] != {k: (accum + 2) * v
                              for k, v in per_step.items()}:
        failed.append(f"host counters {out['host_counts']}")
    if out["warm_up_steps"] != accum or \
            out["replays_by_kind"] != replays_want:
        failed.append(f"warm-up {out['warm_up_steps']}, replays "
                      f"{out['replays_by_kind']}")
    if not all(math.isfinite(v) for m in captured["metrics"]
               for v in m.values()):
        failed.append("non-finite metrics")
    if failed:
        raise SystemExit(f"phase 19 failed: (a) {label}: "
                         f"{', '.join(failed)}")
    return label, out


def scan_run_launches(counts, captured, per_step):
    """A captured run's launches: its host counters less its captures'
    passes (they record, and launch nothing), and each replay's read from
    its graph."""
    return {k: counts[k] - len(captured.graphs) * per_step[k]
            + sum(captured.replays_by_kind[kind]
                  * count_graph(captured, kind)[k]
                  for kind in captured.graphs) for k in per_step}


def count_graph(captured, kind):
    from semi_seg_ecg_tpu_torch.utils.captured_step import count_kernels

    return count_kernels(captured.kernel_names_of(kind), SCAN_NEEDLES)


def scan_accum_recipe(torch):
    """(b) ``train_main`` of phase 12's recipe at scan_steps SCAN_ACCUM_K
    and accum_iter ACCUM_ITER, captured and eager with the capturable
    optimizers (:func:`built_trainers`), both under deterministic
    algorithms: log rows, test metrics, best checkpoint and launches equal.
    Then a captured run of the first epoch, whose checkpoint holds an open
    window, resumed into a captured run of the second: its log row and
    final trainer (networks, optimizer with its window and count, step)
    equal the straight captured run's."""
    from semi_seg_ecg_tpu_torch.cli import train_main
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    per_step = launches_per_step("vit_tiny", "fixmatch")
    eval_batches = math.ceil(ACCUM_VALID / ACCUM_BATCH)
    test_batches = math.ceil(ACCUM_TEST / ACCUM_BATCH)

    def best(name):
        return os.path.join(WORK, "exps", name, "best-loss.ckpt")

    # name, scan_steps, epochs run, resume, the test pass
    plans = (("scan_accum_open", SCAN_ACCUM_K, 1, None, False),
             ("scan_accum", SCAN_ACCUM_K, ACCUM_EPOCHS, None, True),
             ("scan_accum_eager", 1, ACCUM_EPOCHS, None, True),
             ("scan_accum_resumed", SCAN_ACCUM_K, ACCUM_EPOCHS,
              best("scan_accum_open"), False))
    runs, trainers_by_run, warned = {}, {}, []
    for name, k, epochs, resume, test in plans:
        extra = {"test": test}
        if resume is not None:
            extra["resume"] = resume
        path, _ = write_accum_config(name, epochs=epochs,
                                     train={"scan_steps": k}, **extra)
        t = time.time()
        reset_counts()
        with scan_determinism(torch, warn_only=True) as seen, \
                built_trainers(capturable=k == 1,
                               keep_graph=True) as trainers:
            test_metrics = train_main(["-f", path])
            torch.cuda.synchronize()
        warned.extend(w for w in seen if w not in warned)
        counts = launch_counts()
        trainer = trainers[0]
        start = 0 if resume is None else 1
        run = {"seconds": time.time() - t, "host_counts": counts,
               "test_metrics": test_metrics, "log": read_log(name)}
        # the host counts each eager step, or a captured run's warm-up
        # steps and its captures; each epoch's eval batches and the test
        # pass
        if k == 1:
            passes = (epochs - start) * ACCUM_STEPS
        else:
            captured = trainer.captured
            run.update(warm_up_steps=captured.warm_up_steps,
                       replays_by_kind=dict(captured.replays_by_kind),
                       graph_launches_by_kind={
                           kind: count_graph(captured, kind)
                           for kind in captured.graphs},
                       launches=scan_run_launches(counts, captured,
                                                  per_step))
            passes = captured.warm_up_steps + len(captured.graphs)
        want = {key: passes * v for key, v in per_step.items()}
        want["flash_attention_fwd"] += DEPTH * (
            (epochs - start) * eval_batches + (test_batches if test else 0))
        run["host_counts_expected"] = want
        runs[name] = run
        trainers_by_run[name] = trainer
        log(f"  (b) {name}: {run['seconds']:.1f} s, scan_steps {k}, "
            f"epochs {start}-{epochs - 1}, host counters {counts} "
            f"(expected {want}), "
            + (f"warm-up {run['warm_up_steps']} steps, replays "
               f"{run['replays_by_kind']}, launches a replay "
               f"{run['graph_launches_by_kind']}, the run's launches "
               f"{run['launches']}; " if k > 1 else "")
            + f"log {run['log']}, test metrics {test_metrics}")
        if counts != want or [r["epoch"] for r in run["log"]] != list(
                range(start, epochs)) or not all(
                math.isfinite(v) for r in run["log"] for key, v in r.items()
                if "loss" in key):
            raise SystemExit(f"phase 19 failed: (b) {name}: host counters "
                             f"{counts}, expected {want}, or its log rows")
    opened = ckpt.load_checkpoint(best("scan_accum_open"))["optimizer"]
    captured, eager = runs["scan_accum"], runs["scan_accum_eager"]
    resumed = runs["scan_accum_resumed"]

    def final(trainer):
        return {"model": trainer.model.state_dict(),
                "optimizer": trainer.optimizer.state_dict(),
                "step": trainer.step}

    equal = {"log": captured["log"] == eager["log"],
             "test_metrics": captured["test_metrics"]
             == eager["test_metrics"],
             "checkpoint": payloads_equal(
                 torch, ckpt.load_checkpoint(best("scan_accum")),
                 ckpt.load_checkpoint(best("scan_accum_eager")),
                 ("model", "model_ema", "model_peer", "optimizer",
                  "peer_optimizer", "step", "epoch")),
             "launches": captured["launches"] == eager["host_counts"],
             "graph_launches": all(
                 v == per_step for r in (captured, resumed)
                 for v in r["graph_launches_by_kind"].values()),
             "open_window": opened["micro_step"] == 1
             and bool(opened.get("acc_grads")),
             "resumed_log": resumed["log"] == captured["log"][1:],
             "resumed_state": payloads_equal(
                 torch, final(trainers_by_run["scan_accum_resumed"]),
                 final(trainers_by_run["scan_accum"]),
                 ("model", "optimizer", "step"))}
    trainers_by_run.clear()
    log(f"  (b) captured against eager with the capturable optimizers, "
        f"and the resumed open window against the straight run, bit for "
        f"bit: {equal}; determinism warnings {warned}")
    if not all(equal.values()):
        raise SystemExit(f"phase 19 failed: (b) {equal}")
    return {"runs": runs, "equal": equal, "warnings": warned,
            "launches": captured["launches"]}


def scan_refusal_config():
    """(c)'s config: phase 4's recipe at scan_steps SCAN_K."""
    _, config = write_train_config()
    config = copy.deepcopy(config)
    config["exp_name"] = "scan_refusal"
    config["train"]["scan_steps"] = SCAN_K
    path = os.path.join(WORK, "scan_refusal.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def scan_refusal(torch, config_path):
    """(c) on a rank of a gloo group with CUDA tensors: ``train_main`` of
    ``config_path`` (scan_steps > 1); the ValueError's message (None when
    nothing raised) and the launches made."""
    from semi_seg_ecg_tpu_torch.cli import train_main

    reset_counts()
    try:
        train_main(["-f", config_path])
    except ValueError as e:
        return {"raised": str(e), "launches": launch_counts()}
    return {"raised": None, "launches": launch_counts()}


def scan_check_refusal(by_task):
    """(c): every rank raised with the reason and launched nothing."""
    ranks = by_task[0]
    log(f"  (c) two gloo ranks with CUDA tensors on cuda:0 at scan_steps "
        f"{SCAN_K}: {ranks}")
    for r, got in enumerate(ranks):
        if got["raised"] is None or "gloo process group of 2 ranks with " \
                "CUDA tensors" not in got["raised"] or any(
                got["launches"].values()):
            raise SystemExit(f"phase 19 failed: (c) rank {r}: {got}")
    return ranks


def scan_rank_batches(seed, strong=False):
    """SCAN_RANK_STEPS global batches of DP_WORLD x DP_ROWS rows; with
    ``strong`` the strong view made on the host (the seq layouts)."""
    rng = np.random.default_rng(seed)
    n = DP_WORLD * DP_ROWS
    x = lambda: rng.standard_normal((n, 1, SIGNAL_LENGTH)).astype(np.float32)
    out = []
    for _ in range(SCAN_RANK_STEPS):
        batch = {"ecg": x(), "target": rng.integers(0, 4, (n, SIGNAL_LENGTH)),
                 "ecg_u_w": x()}
        if strong:
            batch["ecg_u_s"] = x()
        out.append(batch)
    return out


def scan_rank_trainer(torch, config, mode):
    """A rank's Trainer of ``config`` (the seed-0 model): ``captured`` at
    scan_steps SCAN_K with its graphs' nodes kept, else eager, with the
    capturable optimizers when ``mode`` is ``capturable``."""
    from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
    from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, init_model
    from semi_seg_ecg_tpu_torch.utils.captured_step import CapturedStep

    device = torch.device("cuda", torch.cuda.current_device())
    cfg = copy.deepcopy(config)
    cfg["train"]["scan_steps"] = SCAN_K if mode == "captured" else 1
    trainer = Trainer(cfg, get_algorithm(cfg["algorithm"]).SPEC, device, 4,
                      model=init_model(cfg, device))
    if mode == "captured":
        trainer.captured = CapturedStep(trainer, keep_graph=True)
    elif mode == "capturable":
        for opt in (trainer.optimizer, trainer.peer_optimizer):
            if opt is not None:
                opt.make_capturable_()
    return trainer


def scan_rank_case(torch, config, batches):
    """(d) on a rank, under deterministic algorithms (an op without one
    warns): the config's steps on this rank's rows of each batch, eager
    with the capturable optimizers twice and captured once: per run the
    metrics (the data ranks' mean) and the final networks (unsliced);
    captured, each graph's launches and the replays; the warnings."""
    from semi_seg_ecg_tpu_torch.algorithms.common import full_fp32
    from semi_seg_ecg_tpu_torch.parallel import mesh as pmesh
    from semi_seg_ecg_tpu_torch.parallel.dist import (
        all_reduce_mean,
        data_rank,
        data_size,
    )
    from semi_seg_ecg_tpu_torch.parallel.sharding_rules import (
        full_state_dict,
    )

    pmesh.make_mesh(config)
    per = batches[0]["ecg"].shape[0] // data_size()
    rows = slice(data_rank() * per, (data_rank() + 1) * per)
    device = torch.device("cuda", torch.cuda.current_device())
    out = {}
    with scan_determinism(torch, warn_only=True) as seen, full_fp32():
        for mode in ("capturable", "capturable_again", "captured"):
            trainer = scan_rank_trainer(torch, config, mode.split("_")[0])
            metrics = []
            for batch in batches:
                step = trainer.train_step({
                    k: torch.from_numpy(v[rows]).to(device)
                    for k, v in batch.items()})
                metrics.append({k: all_reduce_mean(v).item()
                                for k, v in step.items()})
            torch.cuda.synchronize()
            run = {"metrics": metrics,
                   "states": {role: {k: v.detach().cpu().numpy() for k, v in
                                     full_state_dict(module).items()}
                              for role, module in (("model", trainer.model),
                                                   ("teacher",
                                                    trainer.teacher),
                                                   ("peer", trainer.peer))
                              if module is not None}}
            if mode == "captured":
                captured = trainer.captured
                run.update(warm_up_steps=captured.warm_up_steps,
                           replays_by_kind=dict(captured.replays_by_kind),
                           graph_launches_by_kind={
                               kind: count_graph(captured, kind)
                               for kind in captured.graphs})
            out[mode] = run
            del trainer
    # (the graphs' DOT dumps warn too)
    out["warnings"] = [w for w in seen if "determinis" in w]
    return out


def scan_rank_profile(torch, config, batch):
    """(d) a rank's bf16 step on its rows of ``batch``, eager (the default
    optimizers) and captured (:func:`scan_step_profile`)."""
    from semi_seg_ecg_tpu_torch.algorithms.common import full_fp32
    from semi_seg_ecg_tpu_torch.parallel.dist import data_rank, data_size

    per = batch["ecg"].shape[0] // data_size()
    rows = slice(data_rank() * per, (data_rank() + 1) * per)
    device = torch.device("cuda", torch.cuda.current_device())
    on_card = {k: torch.from_numpy(v[rows]).to(device)
               for k, v in batch.items()}
    out = {}
    with full_fp32():
        for mode in ("eager", "captured"):
            trainer = scan_rank_trainer(torch, config, mode)
            out[mode] = scan_step_profile(
                lambda: trainer.train_step(on_card),
                SCAN_RANK_PROFILE_STEPS[mode])
            del trainer
    return out


def scan_rank_cases(torch):
    """(d)'s cases by rank group: ``{world: {name: (config, batches,
    launches a step)}}``, NCCL; the model layout where the cards cover
    three ranks."""
    vit_bf16 = dp_step_config("vit_tiny", "nccl")
    vit_bf16["precision"] = "bf16"
    accum = dp_step_config("vit_tiny", "nccl")
    accum["train"]["accum_iter"] = ACCUM_ITER
    host = scan_rank_batches(91, strong=True)
    device = scan_rank_batches(90)
    vit = launches_per_step("vit_tiny", "fixmatch")
    cases = {DP_WORLD: {
        "data2_vit_tiny_bf16": (vit_bf16, device, vit),
        "data2_vit_tiny_fp32": (dp_step_config("vit_tiny", "nccl"), device,
                                vit),
        "data2_resnet18_fp32": (dp_step_config("resnet18", "nccl"), device,
                                launches_per_step("resnet18", "fixmatch")),
        "data2_zero1_vit_tiny_fp32": (z1_config("fixmatch", "nccl", True),
                                      device, vit),
        "data2_accum2_vit_tiny_fp32": (accum, device, vit),
        "seq1x2_vit_tiny_fp32": (seq_step_config("vit_tiny", (1, 2),
                                                 "nccl"), host,
                                 seq_launches("vit_tiny", 2)),
        "seq1x2_resnet18_fp32": (seq_step_config("resnet18", (1, 2),
                                                 "nccl"), host,
                                 seq_launches("resnet18", 2))}}
    if torch.cuda.device_count() >= 3:
        cases[3] = {"model1x3_vit_tiny_fp32": (
            tp_step_config((1, 3), "nccl"), device, vit)}
    return cases


def scan_check_rank_case(name, ranks, per_step):
    """(d) one case's ranks: captured against eager with the capturable
    optimizers, bit for bit where the eager repeat is (else within phase
    10's bounds, the repeat's own spread beside them); the ranks' captured
    states equal; each graph's launches a step's."""
    accum = 2 if "accum2" in name else 1
    out = {"repeat_equal": [], "captured_vs_capturable": [],
           "repeat_spread": [], "warnings": [r["warnings"] for r in ranks],
           "graph_launches_by_kind": [
               r["captured"]["graph_launches_by_kind"] for r in ranks],
           "replays_by_kind": [r["captured"]["replays_by_kind"]
                               for r in ranks]}
    ok = True
    for r in ranks:
        a, b, c = (r[m] for m in ("capturable", "capturable_again",
                                  "captured"))
        repeat = a["metrics"] == b["metrics"] and all(
            payload_diff(b["states"][role], v)[0] == 0.0
            for role, v in a["states"].items())
        diff = max(payload_diff(c["states"][role], v)[0]
                   for role, v in a["states"].items())
        loss_rel = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12)
                       for x, y in zip(c["metrics"], a["metrics"]) for k in y)
        spread = max(payload_diff(b["states"][role], v)[0]
                     for role, v in a["states"].items())
        equal = diff == 0.0 and c["metrics"] == a["metrics"]
        out["repeat_equal"].append(repeat)
        out["captured_vs_capturable"].append(
            {"bit_equal": equal, "state_max_diff": diff,
             "loss_rel": loss_rel})
        out["repeat_spread"].append(spread)
        if repeat:
            ok &= equal
        else:
            ok &= loss_rel <= DP_LOSS_RTOL and all(
                np.allclose(c["states"][role][k], v, rtol=DP_RTOL,
                            atol=DP_ATOL)
                for role, state in a["states"].items()
                for k, v in state.items() if v.dtype.kind == "f")
    first = ranks[0]["captured"]["states"]
    out["ranks_equal"] = all(
        payload_diff(r["captured"]["states"][role], v)[0] == 0.0
        for r in ranks[1:] for role, v in first.items())
    steps = SCAN_RANK_STEPS
    updates = sum(j % accum == accum - 1 for j in range(accum, steps))
    kinds = ("accumulate", "update") if accum > 1 else ("update",)
    ok &= out["ranks_equal"] and all(
        g == {kind: per_step for kind in kinds}
        for g in out["graph_launches_by_kind"]) and all(
        rep == {"accumulate": steps - accum - updates, "update": updates}
        for rep in out["replays_by_kind"])
    log(f"  (d) {name}: {out}")
    out["holds"] = bool(ok)
    return out


def scan_ranks(torch):
    """(d) On two or more cards: each case of :func:`scan_rank_cases` on
    NCCL ranks (:func:`scan_check_rank_case`), and each rank's bf16 ViT
    step at data 2 eager and captured. On one card, says why it did not
    run."""
    if torch.cuda.device_count() < DP_WORLD:
        reason = (f"{torch.cuda.device_count()} card: NCCL takes one card "
                  "a rank and refuses two ranks on one device, and gloo's "
                  "collectives, which a graph cannot hold, refuse scan_steps "
                  "> 1 on a card ((c))")
        log(f"  (d) did not run: {reason}")
        return {"ran": False, "reason": reason}
    result = {"ran": True, "cases": {}, "groups": {}}
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    for world, cases in scan_rank_cases(torch).items():
        tasks = [("scan_rank_case", {"config": cfg, "batches": batches})
                 for cfg, batches, _ in cases.values()]
        if world == DP_WORLD:
            profile_cfg = cases["data2_vit_tiny_bf16"][0]
            tasks.append(("scan_rank_profile", {
                "config": profile_cfg,
                "batch": cases["data2_vit_tiny_bf16"][1][0]}))
        t0 = time.perf_counter()
        by_task, logs = finish_ranks(start_ranks(
            tasks, "nccl", env, world=world, name=f"scan_ranks{world}",
            timeout=SCAN_RANK_TIMEOUT), 19)
        result["groups"][world] = {"seconds": time.perf_counter() - t0,
                                   "task_seconds": rank_task_seconds(logs)}
        for (name, (_, _, per_step)), ranks in zip(cases.items(), by_task):
            result["cases"][name] = scan_check_rank_case(name, ranks,
                                                         per_step)
        if world == DP_WORLD:
            result["profile"] = by_task[len(cases)]
            for r, prof in enumerate(result["profile"]):
                for mode, p in prof.items():
                    log(f"  (d) rank {r} of data 2, bf16 ViT FixMatch step "
                        f"{mode}: {p['wall_ms_per_step']:.3f} ms wall "
                        f"(windows {p['wall_ms_per_step_windows']}), host "
                        f"{p['host_us_per_step']:.0f} us, busy "
                        f"{p['device_busy_ms_per_step']} ms, idle of the "
                        f"untraced wall {p['device_idle_share']}, events "
                        f"{p['device_events_per_step']}")
    bad = [name for name, c in result["cases"].items() if not c["holds"]]
    if bad:
        raise SystemExit(f"phase 19 failed: (d) {bad}")
    return result


def phase_scan_accum(torch):
    """Phase 19: ``train.scan_steps`` with ``accum_iter`` > 1 and under
    NCCL: (a) the accumulating and updating graphs against the
    capturable eager micro-steps, (b) ``train_main`` and the resumed open
    window, (c) gloo with CUDA tensors refused (its two ranks start first
    and run beside (a) and (b)), (d) NCCL ranks where the cards allow;
    each part's seconds."""
    t_phase = time.perf_counter()
    log(f"phase 19: scan_steps across accumulation windows and NCCL ranks; "
        f"{torch.cuda.device_count()} card(s)")
    refusal = start_ranks([("scan_refusal",
                            {"config_path": scan_refusal_config()})],
                          "gloo", name="scan_refusal")
    result = {"seconds": {}}
    t = time.perf_counter()
    with scan_determinism(torch):
        result["a"] = dict(scan_accum_case(torch, *case)
                           for case in SCAN_ACCUM_CASES)
    result["seconds"]["a"] = time.perf_counter() - t
    t = time.perf_counter()
    result["b"] = scan_accum_recipe(torch)
    result["seconds"]["b"] = time.perf_counter() - t
    t = time.perf_counter()
    result["c"] = scan_check_refusal(finish_ranks(refusal, 19)[0])
    result["seconds"]["c (the wait)"] = time.perf_counter() - t
    t = time.perf_counter()
    result["d"] = scan_ranks(torch)
    result["seconds"]["d"] = time.perf_counter() - t
    result["seconds"]["all"] = time.perf_counter() - t_phase
    log(f"  phase 19 seconds by part: {result['seconds']}")
    return result


# ---------------------------------------------------------------------------
# Phase 20: debug.nan_checks, under train.scan_steps too
# ---------------------------------------------------------------------------

# (a): (family, algorithm, precision, accum_iter) of each clean case, its
# captured run with debug.nan_checks against the same run without: at
# accum_iter 1 the warm-up step and two replays, at 2 three windows and a
# micro-step
NAN_CASES = (("vit_tiny", "fixmatch", "bf16", 1),
             ("vit_tiny", "fixmatch", "bf16", 2),
             ("vit_tiny", "mean_teacher", "bf16", 1),
             ("vit_tiny", "cps", "bf16", 1),
             ("resnet18", "fixmatch", "bf16", 1))
# (a): each mode's ms a step, over this many steps after two untimed ones
# (an eager step under anomaly mode takes about 0.7 s)
NAN_TIMED_STEPS = {"eager_anomaly": 3, "captured_checked": 20,
                   "captured": 20}
# (b), (c): the step whose batch holds the NaN (after the warm-up and a
# replay), and the sample made NaN in one labeled row
NAN_BAD_STEP, NAN_BAD_SAMPLE = 2, 1000
# (b): train_main of phase 4's recipe for one epoch of 4 steps at
# scan_steps SCAN_K (a unit of 4), a validation and a test batch
NAN_SPLIT = {"num_train_labeled": 4 * BATCH, "num_train_unlabeled": 4 * BATCH,
             "num_valid": BATCH, "num_test": BATCH}
# a FloatingPointError at a backward op: anomaly mode's error in one
# process, the op found after the backward under a process group
NAN_AT_OP = re.compile(r"debug\.nan_checks: train step (\d+): Function "
                       r"'\w+Backward\d*' returned nan values")


def nan_config(cfg):
    """``cfg`` (a copy) with ``debug.nan_checks``."""
    return dict(copy.deepcopy(cfg), debug={"nan_checks": True})


def nan_case(torch, family, algorithm, precision, accum):
    """(a) One clean case under deterministic algorithms: the captured run
    with ``debug.nan_checks`` against the same run without it, bit for bit
    (metrics, networks, optimizers); each step two graphs (the split at
    the gradients' flags) whose kernel nodes sum to a step's launches, all
    in the first; no eager rerun."""
    label = f"{family}_{algorithm}_{precision}_accum{accum}"
    cfg = scan_config(family, algorithm, precision)
    steps = 3 * accum + 1 if accum > 1 else 3
    runs = {mode: scan_run(torch, c, algorithm, "captured", steps,
                           accum=accum)
            for mode, c in (("checked", nan_config(cfg)),
                            ("unchecked", cfg))}
    checked, unchecked = runs["checked"], runs["unchecked"]
    per_step = launches_per_step(family, algorithm)
    kinds = ("accumulate", "update") if accum > 1 else ("update",)
    none = {k: 0 for k in per_step}
    out = {"steps": steps, "accum_iter": accum,
           "vs_unchecked": scan_diff(checked, unchecked),
           "optimizers_equal": payloads_equal(
               torch, {"o": checked["optimizers"]},
               {"o": unchecked["optimizers"]}, ("o",)),
           "graph_launches_by_kind": checked["graph_launches_by_kind"],
           "graph_launches_by_segment": checked["graph_launches_by_segment"],
           "unchecked_segments": {k: len(v) for k, v in unchecked[
               "graph_launches_by_segment"].items()},
           "replays_by_kind": checked["replays_by_kind"],
           "reruns": checked["reruns"],
           "peak_mib": {mode: r["peak_mib"] for mode, r in runs.items()}}
    log(f"  (a) {label}, {steps} steps: captured with nan_checks vs without "
        f"{out['vs_unchecked']}, optimizers equal {out['optimizers_equal']}"
        f"; launches a replay by graph {out['graph_launches_by_segment']} "
        f"(a step {per_step}; without the checks one graph a kind: "
        f"{out['unchecked_segments']}), replays {out['replays_by_kind']}, "
        f"reruns {out['reruns']}, peak MiB {out['peak_mib']}")
    failed = []
    if not (out["vs_unchecked"]["bit_equal"] and out["optimizers_equal"]):
        failed.append(f"with nan_checks vs without {out['vs_unchecked']}, "
                      f"optimizers equal {out['optimizers_equal']}")
    if out["graph_launches_by_segment"] != {k: [per_step, none]
                                            for k in kinds} or \
            out["unchecked_segments"] != {k: 1 for k in kinds}:
        failed.append(f"graphs {out['graph_launches_by_segment']}, "
                      f"{out['unchecked_segments']}")
    if out["reruns"] != 0 or not all(math.isfinite(v) for m in checked[
            "metrics"] for v in m.values()):
        failed.append(f"{out['reruns']} reruns, or non-finite metrics")
    if failed:
        raise SystemExit(f"phase 20 failed: (a) {label}: "
                         f"{', '.join(failed)}")
    return label, out


def nan_times(torch):
    """(a) ms a step of phase 4's bf16 ViT FixMatch step (NAN_TIMED_STEPS
    of each mode after two untimed: a captured run's warm-up and capture)
    eager under
    anomaly mode (``debug.nan_checks`` at scan_steps 1), captured with
    the checks and captured without."""
    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        Trainer,
        full_fp32,
        init_model,
    )

    device = torch.device("cuda")
    batch = device_batch(torch, 50)
    del batch["ecg_u_s"]
    out = {}
    for mode, k, checks in (("eager_anomaly", 1, True),
                            ("captured_checked", SCAN_K, True),
                            ("captured", SCAN_K, False)):
        cfg = scan_config("vit_tiny", "fixmatch", "bf16")
        cfg["train"]["scan_steps"] = k
        if checks:
            cfg = nan_config(cfg)
        with full_fp32():
            trainer = Trainer(cfg, fixmatch.SPEC, device, 4,
                              model=init_model(cfg, device))
            for _ in range(2):
                trainer.train_step(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(NAN_TIMED_STEPS[mode]):
                trainer.train_step(batch)
            torch.cuda.synchronize()
        out[mode] = (time.perf_counter() - t0) * 1e3 / NAN_TIMED_STEPS[mode]
        del trainer
    log(f"  (a) bf16 ViT FixMatch ms a step: {out}")
    return out


def nan_step(torch):
    """(b) A captured bf16 ViT FixMatch run with ``debug.nan_checks`` at
    scan_steps SCAN_K, a NaN in one labeled row of step NAN_BAD_STEP's
    batch (after the warm-up and a replay): the step raises
    ``FloatingPointError`` from its eager rerun, at a backward op (anomaly
    mode's error the cause), and the parameters, optimizer and counters
    equal theirs from before it (the BatchNorm statistics move with the
    step's forward)."""
    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        Trainer,
        full_fp32,
        init_model,
    )
    from semi_seg_ecg_tpu_torch.utils.captured_step import CapturedStep

    device = torch.device("cuda")
    cfg = nan_config(scan_config("vit_tiny", "fixmatch", "bf16"))
    cfg["train"]["scan_steps"] = SCAN_K
    batches = []
    for s in range(NAN_BAD_STEP + 1):
        batch = device_batch(torch, 60 + s)
        del batch["ecg_u_s"]
        batches.append(batch)
    batches[-1]["ecg"][1, 0, NAN_BAD_SAMPLE] = float("nan")

    def state(trainer):
        # the parameters: the step's forward moves the BatchNorm statistics
        return host_copy(torch, {"model": dict(
            trainer.model.named_parameters()),
            "optimizer": trainer.optimizer.state_dict(),
            "step": trainer.step, "count": trainer.optimizer.count})

    with full_fp32():
        trainer = Trainer(cfg, fixmatch.SPEC, device, 4,
                          model=init_model(cfg, device))
        trainer.captured = captured = CapturedStep(trainer)
        for batch in batches[:-1]:
            trainer.train_step(batch)
        torch.cuda.synchronize()
        before = state(trainer)
        reset_counts()
        try:
            trainer.train_step(batches[-1])
            raised = None
        except FloatingPointError as e:
            raised = e
        torch.cuda.synchronize()
        after = state(trainer)
    out = {"raised": None if raised is None else str(raised),
           "cause": None if raised is None else repr(raised.__cause__),
           "warm_up_steps": captured.warm_up_steps,
           "replays_by_kind": dict(captured.replays_by_kind),
           "reruns": captured.reruns,
           "rerun_launches": launch_counts(),
           "unchanged": {k: payloads_equal(torch, after, before, (k,))
                         for k in before}}
    log(f"  (b) NaN in a labeled row of step {NAN_BAD_STEP}: {out}")
    at = NAN_AT_OP.match(out["raised"] or "")
    if not (at and int(at.group(1)) == NAN_BAD_STEP
            and isinstance(raised.__cause__, RuntimeError)
            and all(out["unchanged"].values()) and out["reruns"] == 1
            and out["warm_up_steps"] == 1
            and out["replays_by_kind"]["update"] == NAN_BAD_STEP - 1):
        raise SystemExit(f"phase 20 failed: (b) {out}")
    return out


def nan_entry(torch, split):
    """(b) ``train_main`` of phase 4's recipe with ``debug.nan_checks`` at
    scan_steps SCAN_K for one epoch (its graphs' nodes kept), a NaN in the
    first record of ``split`` (``valid`` or ``test``): it raises at epoch
    0's validation, before any ``best-*.ckpt``, or in the test pass, after
    them; the run's launches (the warm-up and the captures on the host
    counters, each replay read from its graphs, the evaluation's)."""
    from semi_seg_ecg_tpu_torch.cli import train_main

    data = synthetic_split(f"nan_{split}_data", seed=2, **NAN_SPLIT)
    record = os.path.join(data["ecg_dir"], f"{split}_0.pkl")
    with open(record, "rb") as f:
        x = np.array(pickle.load(f), np.float32)
    x[..., NAN_BAD_SAMPLE] = np.nan
    with open(record, "wb") as f:
        pickle.dump(x, f)
    _, config = write_train_config()
    config = nan_config(config)
    name = f"nan_{split}"
    config["dataset"].update(data)
    config["exp_name"] = name
    config["train"].update(epochs=1, scan_steps=SCAN_K)
    path = os.path.join(WORK, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    t = time.time()
    reset_counts()
    with built_trainers(keep_graph=True) as trainers:
        try:
            train_main(["-f", path])
            raised = None
        except FloatingPointError as e:
            raised = str(e)
    torch.cuda.synchronize()
    counts = launch_counts()
    captured = trainers[0].captured
    exp = os.path.join(WORK, "exps", name)
    out = {"seconds": time.time() - t, "raised": raised,
           "best": sorted(f for f in os.listdir(exp)
                          if f.startswith("best-")),
           "warm_up_steps": captured.warm_up_steps,
           "replays_by_kind": dict(captured.replays_by_kind),
           "reruns": captured.reruns,
           "launches": scan_run_launches(
               counts, captured, launches_per_step("vit_tiny", "fixmatch"))}
    trainers.clear()
    log(f"  (b) train_main, a NaN in a {split} record: {out}")
    want = ("batch 0 of epoch 0's validation" if split == "valid"
            else "batch 0 of the test pass")
    if raised is None or want not in raised or bool(out["best"]) != (
            split == "test") or out["reruns"] != 0:
        raise SystemExit(f"phase 20 failed: (b) {split}: {out}")
    return out


def nan_rank(torch, config, batches):
    """(c) on a rank: ``config``'s steps (``debug.nan_checks``) on this
    rank's rows of each batch, captured at scan_steps SCAN_K over NCCL
    (over gloo with CUDA tensors, which refuses K > 1, eager), the batch of
    step NAN_BAD_STEP holding a NaN in rank 1's rows only, until a step
    raises: its message and step, the parameters and optimizer against
    theirs from before it, the eager reruns."""
    from semi_seg_ecg_tpu_torch.algorithms.common import full_fp32
    from semi_seg_ecg_tpu_torch.parallel import dist as pdist

    per = batches[0]["ecg"].shape[0] // pdist.data_size()
    rows = slice(pdist.data_rank() * per, (pdist.data_rank() + 1) * per)
    device = torch.device("cuda", torch.cuda.current_device())
    mode = "captured" if pdist.backend() == "nccl" else "eager"
    out = {"mode": mode, "raised": None}
    with full_fp32():
        trainer = scan_rank_trainer(torch, config, mode)
        def state():
            # the parameters: a step's forward moves the BatchNorm
            # statistics
            return host_copy(torch, {
                "model": dict(trainer.model.named_parameters()),
                "optimizer": trainer.optimizer.state_dict()})

        for i, batch in enumerate(batches):
            before = state()
            try:
                trainer.train_step({k: torch.from_numpy(v[rows]).to(device)
                                    for k, v in batch.items()})
            except FloatingPointError as e:
                after = state()
                out.update(raised=str(e), at_step=i,
                           unchanged={k: payloads_equal(torch, after, before,
                                                        (k,))
                                      for k in before})
                break
        torch.cuda.synchronize()
    out["reruns"] = None if trainer.captured is None else \
        trainer.captured.reruns
    return out


def nan_rank_tasks(torch):
    """(c)'s task on phase 10's ranks: the bf16 ViT FixMatch step config
    (its backend), NAN_BAD_STEP + 1 global batches, the last with a NaN in
    one of rank 1's rows."""
    backend, _ = dp_layout(torch)
    cfg = nan_config(dp_step_config("vit_tiny", backend))
    cfg["precision"] = "bf16"
    batches = scan_rank_batches(92)[:NAN_BAD_STEP + 1]
    batches[-1]["ecg"][DP_ROWS + 1, 0, NAN_BAD_SAMPLE] = np.nan
    return [("nan_rank", {"config": cfg, "batches": batches})]


def nan_check_ranks(ranks):
    """(c): every rank raised at step NAN_BAD_STEP with its update not
    applied, rank 1 at a backward op; captured (NCCL) through one eager
    rerun."""
    log(f"  (c) {len(ranks)} ranks, a NaN in rank 1's rows of step "
        f"{NAN_BAD_STEP}: {ranks}")
    for r, got in enumerate(ranks):
        message = got["raised"] or ""
        at_op = NAN_AT_OP.match(message) is not None
        reruns = None if got["mode"] == "eager" else 1
        if got.get("at_step") != NAN_BAD_STEP or not all(
                got.get("unchanged", {False: False}).values()) or \
                got["reruns"] != reruns or not (
                    at_op or (r != 1 and "another rank's backward"
                              in message)):
            raise SystemExit(f"phase 20 failed: (c) rank {r}: {got}")
    return ranks


def phase_nan_checks(torch, shared=None):
    """Phase 20: ``debug.nan_checks``, under ``train.scan_steps`` too: (a)
    under deterministic algorithms each clean case with the checks against
    the same run without them, and the step's ms eager under anomaly mode,
    captured with the checks and without; (b) a NaN in a train step's
    batch (under deterministic algorithms), in a validation record and in
    a test record; (c) two ranks with the NaN on one (``shared``: the
    task's results from phase 10's ranks; alone, a group of its own);
    each part's seconds."""
    t_phase = time.perf_counter()
    backend, _ = dp_layout(torch)
    log(f"phase 20: debug.nan_checks; {torch.cuda.device_count()} card(s), "
        f"ranks over {backend}")
    own = None
    if shared is None:
        own = start_ranks(nan_rank_tasks(torch), backend,
                          {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"},
                          name="nan_ranks", timeout=SCAN_RANK_TIMEOUT)
    result = {"seconds": {}}
    t = time.perf_counter()
    with scan_determinism(torch):
        result["a"] = dict(nan_case(torch, *case) for case in NAN_CASES)
        result["seconds"]["a"] = time.perf_counter() - t
        t = time.perf_counter()
        result["b"] = {"step": nan_step(torch)}
    result["a_ms_per_step"] = nan_times(torch)
    result["b"].update({split: nan_entry(torch, split)
                        for split in ("valid", "test")})
    result["seconds"]["a (times), b"] = time.perf_counter() - t
    t = time.perf_counter()
    if shared is None:
        shared = finish_ranks(own, 20)[0][0]
    result["c"] = {"backend": backend, "ranks": nan_check_ranks(shared)}
    result["seconds"]["c"] = time.perf_counter() - t
    result["seconds"]["all"] = time.perf_counter() - t_phase
    log(f"  phase 20 seconds by part: {result['seconds']}")
    return result


# ---------------------------------------------------------------------------
# Phase 21: the measuring tools on the card
# ---------------------------------------------------------------------------

# the flash kernels at bench_longrec --mode card's shape: T = 65,536 in
# patches of 16 and the cls token, 3 heads of 64, batch 2
LONGREC_CARD_ROWS = [("longrec_card_bf16", (2, 3, 4097, 64), "bfloat16"),
                     ("longrec_card_fp32", (2, 3, 4097, 64), "float32")]
# a depth-4 ViT with remat: a forward a block, one more in its recompute,
# a backward a block
LONGREC_CARD_LAUNCHES = {"flash_attention_fwd": 8, "flash_attention_bwd": 4,
                         "gather1d": 0}
# tool: (its module under semi_seg_ecg_tpu_torch/tools, argv at short
# counts, the keys its line must hold, the device metrics (top level) and
# the rows' device metrics that must not be null on the card)
TOOL_ROW_METRICS = ("samples_per_sec", "ms_per_step", "mfu",
                    "device_busy_ms_per_step", "device_idle_share")
TOOL_RUNS = {
    "flops_audit": ("flops_audit", ["--batch", "16"],
                    ("flops_per_step", "by_op", "top_contributors"),
                    ("flops_per_step",), ()),
    "bench": ("bench", ["--steps", "20"],
              ("metric", "value", "unit", "vs_baseline", "mfu",
               "flops_per_step", "mode", "device_kind", "all_modes", "peak",
               "baseline"),
              ("value", "vs_baseline", "mfu", "device_idle_share",
               "device_kind"), TOOL_ROW_METRICS),
    "bench_scale": ("bench_scale", ["--batches", "16", "128", "--steps",
                                    "10"],
                    ("metric", "sweep"), (), TOOL_ROW_METRICS),
    "bench_matrix": ("bench_matrix", ["--steps", "3"], ("metric", "rows"),
                     (), ("ms_per_step", "samples_per_sec")),
    "profile_step": ("profile_step", ["--augment", "--steps", "10"],
                     ("launches_in_window", "kernel_events_in_window",
                      "categories_ms_per_step", "top_kernels"),
                     ("wall_ms_per_step", "device_busy_ms_per_step",
                      "device_idle_share", "device_events_per_step"), ()),
    "bench_e2e": ("bench_e2e", ["--records", "64", "--epochs", "3",
                                "--modes", "host,cache+scan"],
                  ("metric", "results", "rows"), (),
                  ("samples_per_sec", "sec_per_epoch")),
    "bench_inference": ("bench_inference", ["--batches", "16", "64",
                                            "--steps", "10", "--int8",
                                            "--static"],
                        ("metric", "rows"), (),
                        ("wall_ms", "windows_per_s", "device_busy_ms",
                         "device_idle_share")),
    "bench_holter": ("bench_holter", ["--hours", "1", "--reps", "2"],
                     ("metric", "value", "unit", "windows"),
                     ("value", "seconds_per_record", "hours_of_ecg_per_s",
                      "peak_memory_mb"), ()),
    "bench_streams": ("bench_streams", ["--streams", "64", "--reps", "2"],
                      ("metric", "value", "unit"),
                      ("value", "ms_per_step_dispatch"), ()),
    "bench_longrec_card": ("bench_longrec", ["--mode", "card", "--steps",
                                             "3"],
                           ("t", "tokens", "launches_per_step"),
                           ("ms_per_step", "first_step_s", "peak_memory_mb"),
                           ()),
    "bench_longrec_mem": ("bench_longrec", ["--mode", "mem", "--steps", "2"],
                          ("t", "rows"), (),
                          ("ms_per_step", "peak_memory_mb")),
}


def tool_line(name, module, argv):
    """``module.main(argv)`` in this process, its output kept aside: the
    last line's JSON object, the seconds and the port's launches."""
    import importlib
    import io

    tool = importlib.import_module(f"semi_seg_ecg_tpu_torch.tools.{module}")
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = tool.main(argv)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    if code != 0:
        raise SystemExit(f"phase 21 failed: {name} exited {code}")
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"  {name} ({seconds:.1f} s, launches {launches}): "
        f"{json.dumps(line)[:1500]}")
    return line, seconds, launches


def tool_faults(name, line, keys, metrics, row_metrics):
    """What of ``line`` breaks phase 21's rules: a key missing, a device
    metric null on the card, an MFU outside (0, 1], a loss not finite."""
    faults = [f"no {k}" for k in keys if k not in line]
    device = line.get("device") or {}
    if device.get("platform") != "gpu" or not device.get("kind") or \
            not device.get("power_limit"):
        faults.append(f"device {device}")
    faults += [f"{k} null" for k in metrics if line.get(k) is None]
    rows = [r for key in ("rows", "all_modes", "sweep")
            for r in line.get(key) or []]
    rows += [line["peak"]] if line.get("peak") else []
    if row_metrics and not rows:
        faults.append("no rows")
    for row in rows:
        faults += [f"{row.get('mode', row.get('model', ''))} {k} null"
                   for k in row_metrics if row.get(k) is None]
    for r in rows + [line]:
        if "mfu" in r and r["mfu"] is not None and not 0 < r["mfu"] <= 1:
            faults.append(f"mfu {r['mfu']}")
    losses = [v for r in rows + [line] for k, v in r.items()
              if k.endswith("loss")]
    faults += [f"loss {v}" for v in losses
               if v is None or not math.isfinite(v)]
    return faults


def phase_tools(torch):
    """Every measuring tool of ``semi_seg_ecg_tpu_torch/tools`` on the card
    at short counts, each line held to its keys, its device metrics not
    null, MFU in (0, 1] and finite losses; ``profile_step --augment``'s
    trace holds the gather launches its counter counted;
    ``bench_longrec --mode card`` launches 8 flash forwards and 4 backwards
    a step; the flash kernels at its (2, 3, 4097, 64) against their plain
    versions in both dtypes."""
    from semi_seg_ecg_tpu_torch.algorithms.common import full_fp32
    from semi_seg_ecg_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    result = {"lines": {}, "seconds": {}, "launches": {}}
    faults = {}
    for name, (module, argv, keys, metrics, row_metrics) in \
            TOOL_RUNS.items():
        line, seconds, launches = tool_line(name, module, argv)
        result["lines"][name] = line
        result["seconds"][name] = seconds
        result["launches"][name] = launches
        bad = tool_faults(name, line, keys, metrics, row_metrics)
        if bad:
            faults[name] = bad
    window = result["lines"]["profile_step"]
    gathers = window["launches_in_window"]["gather1d"]
    if not gathers or window["kernel_events_in_window"]["gather1d"] != \
            gathers:
        faults.setdefault("profile_step", []).append(
            f"gather launches {window['launches_in_window']} against the "
            f"trace's events {window['kernel_events_in_window']}")
    card = result["lines"]["bench_longrec_card"]["launches_per_step"]
    if card != LONGREC_CARD_LAUNCHES:
        faults.setdefault("bench_longrec_card", []).append(
            f"launches a step {card}, expected {LONGREC_CARD_LAUNCHES}")
    e2e = {r["mode"]: r["gather_launches"]
           for r in result["lines"]["bench_e2e"]["rows"]}
    if e2e.get("host") != 0 or not e2e.get("cache+scan"):
        faults.setdefault("bench_e2e", []).append(f"gathers {e2e}")
    if faults:
        raise SystemExit(f"phase 21 failed: {faults}")
    with full_fp32():
        gen = torch.Generator(device="cuda").manual_seed(21)
        result["rows"] = {
            "flash_attention_fwd": [check_kernel(torch, fa, gen, *case,
                                                 phase=21)
                                    for case in LONGREC_CARD_ROWS],
            "flash_attention_bwd": [check_backward(torch, fa, gen, *case,
                                                   phase=21)
                                    for case in LONGREC_CARD_ROWS]}
    result["seconds"]["all"] = time.perf_counter() - t_phase
    log(f"  phase 21 seconds by tool: {result['seconds']}")
    return result


def kernel_entry(name, rows, by_path):
    """A kernel's entry of the kernels line: ``launches`` on the main path
    (phase 4's vit_tiny FixMatch ``train_main``), ``launches_by_path`` on
    each path the script drives, the main row's times and bound."""
    main = next(r for r in rows if r["shape"] == MAIN_ROW[name])
    launches = by_path["vit_tiny_fixmatch"][name]
    entry = {"name": name, "route": "cuda", "source": CSRC.format(name),
             "replaces": REPLACES[name], "launches": launches,
             "row": main["shape"],
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "library_ms": main["library_ms"],
             "launches_by_path": {path: counts[name]
                                  for path, counts in by_path.items()},
             "shapes": rows}
    if name in FP32_ROW:
        row = next(r for r in rows if r["shape"] == FP32_ROW[name])
        entry["fp32"] = {"row": row["shape"], **{
            k: row[k] for k in ("ms", "bound_ms", "bound_by", "bound_peak",
                                "library_ms")}}
    return entry


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    t_start = time.time()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    phase_seconds = {}

    def timed(phase, fn, *args):
        t0 = time.time()
        out = fn(*args)
        phase_seconds[phase] = time.time() - t0
        log(f"phase {phase} took {phase_seconds[phase]:.1f} s "
            f"({time.time() - t_start:.1f} s in all)")
        return out

    build_s, hmma = timed(1, phase_build)
    rows, floor_ms = timed(2, phase_kernels, torch)
    slice_result = timed(3, phase_slice, torch)
    train_result = timed(4, phase_train, torch)
    resnet_result = timed(5, phase_resnet, torch)
    algorithm_results = timed(6, phase_algorithms, torch)
    reco_stpp = timed(7, phase_reco_stpp, torch)
    longrec = timed(8, phase_longrec, torch)
    deploy = timed(
        9, phase_deploy,
        torch, os.path.join(WORK, "exps", "vit_tiny_fixmatch",
                            "best-MeanIoU.ckpt"),
        os.path.join(WORK, "resnet18_seed0.pth"))
    # phase 12 (e)'s and phase 13 (d)'s rank tasks, and phase 17 (b)'s
    # ZeRO-1 one after them, ride on phase 10's rank processes (a group's
    # start costs tens of seconds); phase 17 (b)'s (1, 3) task on phase
    # 14's (1, 3) group
    ckpt_tasks = ckpt_rank_tasks(torch)
    accum_tasks = accum_rank_tasks(torch)
    z1_tasks = z1_rank_tasks(torch)
    # phase 20 (c)'s task last: its ranks raise, and every rank goes on
    nan_tasks = nan_rank_tasks(torch)
    parallel = timed(10, phase_parallel, torch,
                     accum_tasks + z1_tasks + ckpt_tasks["zero1"]
                     + nan_tasks)
    later, dp_logs = parallel.pop("extra")
    nan_shared = later[-1]
    later = later[:-len(nan_tasks)]
    remat = timed(11, phase_remat, torch)
    accum = timed(12, phase_accum, torch, later[:len(accum_tasks)])
    zero_cache = timed(13, phase_zero_cache, torch, ckpt_tasks["zero1"],
                       (later[len(accum_tasks):], dp_logs))
    ckpt_shared = {"zero1": zero_cache["zero1"].pop("extra")}
    # phase 16's (a) on an idle card and its inputs, then the rank groups
    # of phases 14-16 shared: a group's start costs tens of seconds. Phase
    # 15's (2, 2) tasks and phase 16's (1, 2, 2) one ride on phase 14's
    # (2, 2) group, phase 16's (1, 2) tasks on phase 15's (1, 2) group, and
    # phase 16's (1, 2, 3) group starts after phase 15's (a)
    so_plan = timed("16 (a) and inputs", seq_options_plan, torch)
    seq_22 = seq_parallel_tasks(torch, SEQ_LAYOUTS[1])
    tensor_parallel = timed(14, phase_tensor_parallel, torch, {
        TP_LONGREC_LAYOUT: seq_22 + so_plan["tasks"][SO_RESNET_LAYOUT],
        CKPT_TP_LAYOUT: ckpt_tasks["1x3"]})
    tp_extras = tensor_parallel.pop("extra")
    tp_extra = tp_extras[TP_LONGREC_LAYOUT]
    ckpt_shared["1x3"] = tp_extras[CKPT_TP_LAYOUT]
    seq_parallel = timed(
        15, phase_seq_parallel, torch,
        {SEQ_LAYOUTS[0]: so_plan["tasks"][SO_SEQ_LAYOUT],
         SEQ_LAYOUTS[1]: so_plan["tasks"][SO_RESNET_LAYOUT]},
        lambda: so_start(torch, so_plan, [SO_VIT_LAYOUT]),
        {SEQ_LAYOUTS[1]: tp_extra})
    extra = seq_parallel.pop("extra")
    seq_options = timed(16, phase_seq_options, torch, so_plan, {
        SO_SEQ_LAYOUT: extra[SEQ_LAYOUTS[0]],
        SO_RESNET_LAYOUT: extra[SEQ_LAYOUTS[1]]})
    checkpoint = timed(17, phase_checkpoint, torch, ckpt_shared)
    scan = timed(18, phase_scan, torch, train_result["log"])
    scan_accum = timed(19, phase_scan_accum, torch)
    nan = timed(20, phase_nan_checks, torch, nan_shared)
    tools = timed(21, phase_tools, torch)
    # the ring's hops beside phase 2's rows (phase 16's on one head a rank),
    # phase 21's long-record rows
    for phase in (seq_parallel, seq_options):
        for name, hop_rows in phase["hops"].items():
            rows[name] = rows[name] + hop_rows
    for name, long_rows in tools["rows"].items():
        rows[name] = rows[name] + long_rows
    # each path's launches, counted from 0 just before it and read after
    by_path = {
        "vit_tiny_serving": slice_result["runs"]["flash_fp32"][
            "launches_by_kernel"],
        "vit_tiny_fixmatch": train_result["launches"],
        "resnet18_serving": resnet_result["serving"]["runs"]["resnet_fp32"][
            "launches"],
        "resnet18_fixmatch": resnet_result["train"]["launches"],
        **{path: r["launches"] for path, r in algorithm_results.items()},
        **{path: r["launches"]
           for path, r in reco_stpp["recipes"].items()},
        **{f"longrec_{path}": r["launches"]
           for path, r in longrec["runs"].items()},
        "longrec_streaming": longrec["streaming"]["launches"],
        **{f"longrec_{family}_hour_int8": r["launches"]
           for family, r in deploy["longrec_int8"].items()},
        **{f"artifact_{family}_per_call": counts
           for family, counts in deploy["launches_per_call"].items()},
        # phase 10: one rank's launches (every rank's are checked equal)
        **{f"dp_{family}_fixmatch_per_rank_step": r["launches_per_rank_step"]
           for family, r in parallel["steps"].items()},
        **{f"dp_vit_tiny_{algorithm}_per_rank": r["launches_per_rank"]
           for algorithm, r in parallel["entries"].items()},
        # phase 11: one step's launches, remat off and on
        **{f"remat_{family}_fixmatch_{label}_per_step": r[label][
            "launches_per_step"]
           for family, r in remat["remat"].items() for label in ("off", "on")},
        # phase 12: the accumulated run, the resumed epoch (its own
        # process), a rank's micro-step of the 2-rank window
        "accum_vit_tiny_fixmatch": accum["straight"]["launches"],
        "accum_vit_tiny_fixmatch_resumed": accum["resume"]["launches"],
        "accum_dp_vit_tiny_per_rank_micro_step": accum["ranks"][
            "launches_per_rank_step"],
        # phase 13: the new ops' recipe streaming (its own process) and
        # with the device cache, a rank's ZeRO-1 step, the unsharded
        # step resumed from a ZeRO-1 checkpoint
        "new_ops_vit_tiny_fixmatch": zero_cache["cache"]["stream"][
            "launches"],
        "new_ops_vit_tiny_fixmatch_cached": zero_cache["cache"]["cache"][
            "launches"],
        **{f"zero1_vit_tiny_{algorithm}_per_rank_step": zero_cache["zero1"][
            algorithm]["launches_per_rank_step"]
           for algorithm in Z1_ALGORITHMS},
        **{f"zero1_vit_tiny_{algorithm}_resumed_step": zero_cache["zero1"][
            algorithm]["resume"]["launches"] for algorithm in Z1_ALGORITHMS},
        # phase 14: a rank's step at each (data, model) layout, a rank's
        # recipe run at (1, 3), each data rank's 1 h record and streams
        **{f"tp_{name}_fixmatch_per_rank_step": r["steps"][
            "launches_per_rank_step"]
           for name, r in tensor_parallel["layouts"].items()},
        "tp_1x3_vit_tiny_fixmatch_per_rank": tensor_parallel["layouts"][
            "1x3"]["recipe"]["launches_per_rank"],
        **{f"tp_longrec_hour_rank{r}": counts for r, counts in enumerate(
            tensor_parallel["longrec"]["launches_by_rank"])},
        "tp_longrec_streams_per_rank": tensor_parallel["longrec"][
            "stream_launches_per_rank"],
        # phase 15: a seq rank's step at each (data, seq) layout, a rank's
        # recipe run (the ring: a launch a hop)
        **{f"seq_{family}_fixmatch_per_rank_step_{key}": entry["steps"][
            family]["launches_per_rank_step"]
           for key, entry in seq_parallel["layouts"].items()
           for family in ("vit_tiny", "resnet18")},
        "seq_vit_tiny_fixmatch_recipe_per_rank": seq_parallel["layouts"][
            "1x2"]["recipe"]["launches_per_rank"],
        # phase 16: a seq rank's ReCo step at (1, 2), the FixMatch step at
        # (1, 2, 3) (the ViT, one head a model rank) and (1, 2, 2)
        # (ResNet18), a rank's ST++ ranking pass, a rank's int8 batch
        **{f"seq_{family}_reco_per_rank_step_1x2": r["launches_per_rank_step"]
           for family, r in seq_options["reco"].items()},
        **{f"seq_model_{family}_fixmatch_per_rank_step_"
           + "x".join(str(a) for a in r["layout"]): r[
               "launches_per_rank_step"]
           for family, r in seq_options["steps"].items()},
        "seq_vit_tiny_stpp_ranking_per_rank_1x2": seq_options["stpp"][
            "launches_per_rank"],
        **{f"int8_{case}_per_rank_batch": r["launches_per_rank"]
           for case, r in seq_options["int8"].items()},
        # phase 17: the recipe under each writer, the cross-platform
        # artifact's CUDA program a call
        **{f"ckpt_{mode}_vit_tiny_fixmatch": r["launches"]
           for mode, r in checkpoint["writer"]["runs"].items()},
        "artifact_xplat_vit_tiny_cuda_per_call": checkpoint["artifact"][
            "launches_per_call"],
        # phase 18: one replay of each captured step, read from its graph;
        # the captured recipe's run (its warm-up, replays and evals)
        **{f"scan_{family}_fixmatch_per_replay": scan[part]["bf16"][
            "graph_launches"]
           for part, family in (("a", "vit_tiny"), ("b", "resnet18"))},
        **{f"scan_vit_tiny_{algorithm}_per_replay": r["graph_launches"]
           for algorithm, r in scan["c"].items()},
        "scan_vit_tiny_fixmatch_recipe": scan["d"]["launches"],
        # phase 19: a replay of each graph of each accumulation case and
        # of each NCCL rank case (two cards or more), read from the graph;
        # the captured accumulation recipe's run
        **{f"scan_{label}_per_{kind}_replay": launches
           for label, r in scan_accum["a"].items()
           for kind, launches in r["graph_launches_by_kind"].items()},
        **{f"scan_rank_{name}_per_{kind}_replay": launches
           for name, r in scan_accum["d"].get("cases", {}).items()
           for kind, launches in r["graph_launches_by_kind"][0].items()},
        "scan_accum_vit_tiny_fixmatch_recipe": scan_accum["b"]["launches"],
        # phase 20: a replay of each clean case's graphs with
        # debug.nan_checks (a step's two graphs summed), read from them;
        # the recipe runs that raise at the validation and in the test pass
        **{f"nan_{label}_per_{kind}_replay": launches
           for label, r in nan["a"].items()
           for kind, launches in r["graph_launches_by_kind"].items()},
        **{f"nan_vit_tiny_fixmatch_{split}_nan_recipe": nan["b"][split][
            "launches"] for split in ("valid", "test")},
        # phase 21: each tool's run (counted from 0 just before it); the
        # long-record step's flash launches and the augmented trace
        # window's gathers
        **{f"tool_{name}": launches
           for name, launches in tools["launches"].items()},
        "tool_bench_longrec_card_per_step": tools["lines"][
            "bench_longrec_card"]["launches_per_step"],
        "tool_profile_step_augment_window": tools["lines"]["profile_step"][
            "launches_in_window"]}
    kernels = [kernel_entry(name, rows[name], by_path) for name in STEMS]
    smi = nvidia_smi()
    with open(OUT_JSON, "w") as f:
        json.dump({"nvidia_smi": smi, "torch": torch.__version__,
                   "build_s": build_s, "hmma": hmma,
                   "launch_floor_ms": floor_ms, "kernels": kernels,
                   "slice": slice_result, "train": train_result,
                   "resnet18": resnet_result,
                   "algorithms": algorithm_results,
                   "reco_stpp": reco_stpp, "longrec": longrec,
                   "deploy": deploy, "parallel": parallel,
                   "remat": remat, "accum": accum,
                   "zero_cache": zero_cache,
                   "tensor_parallel": tensor_parallel,
                   "seq_parallel": seq_parallel,
                   "seq_options": seq_options,
                   "checkpoint": checkpoint, "scan": scan,
                   "scan_accum": scan_accum, "nan_checks": nan,
                   "tools": tools,
                   "phase_seconds": phase_seconds,
                   "seconds": time.time() - t_start}, f,
                  indent=1)
    log(f"done in {time.time() - t_start:.1f} s; per phase: "
        + ", ".join(f"{k}: {v:.1f}" for k, v in phase_seconds.items()))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(*sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-drift"]:
        sys.exit(tp_drift_main(*sys.argv[2:]))
    if sys.argv[1:2] == ["--reco-noise"]:
        sys.exit(so_noise_main(*sys.argv[2:]))
    sys.exit(main())
