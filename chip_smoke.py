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
   against the offline stitcher; a 24-hour record per model with its
   throughput, the filter chain's host time and peak device memory; a
   profile of one hour;
9. the serving deployment: ``export_serving`` (``torch.export``, the flash
   forward as the PyTorch operator) of phase 4's trained ViT and phase 5's
   ResNet18 with a symbolic batch, no launch while tracing, ``load_serving``
   at batches 1, 16, 37 and 64 with ``DEPTH`` flash forwards a ViT call,
   within 1e-5 of ``ServingFn``; a pinned batch that refuses another; a
   bf16 autocast artifact that says so and agrees with fp32 on >= 90% of
   the argmaxes; int8 with dynamic and calibrated scales on both backbones
   (card against the CPU, int8 against fp32 by the JAX package's rule, no
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
   ms and its collectives' device time.

The line before the last prints the card's name and power limit as
nvidia-smi gives them; the line before that, a JSON object with one entry
per kernel. The last line is ``{"ok": true, "device": {...}}``. Details go
to ``build/chip_smoke/chip_smoke.json``.
"""

import contextlib
import copy
import functools
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

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
OUT_JSON = os.path.join(WORK, "chip_smoke.json")

# H100 SXM data-sheet peaks (dense): device memory and the rate of the units
# a kernel's products run on: fp32 on the CUDA cores (the gather), bf16 on
# the tensor cores, and fp32-accurate products on the tensor cores as three
# TF32 products each (3xTF32: 495 / 3 TFLOP/s, the fastest fp32-accurate
# product the card has, so the fp32 flash kernels' bound)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "3xtf32": 495e12 / 3}
# the PEAK_FLOPS entry each flash dtype is bounded by
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
# a time, and a 24-hour Holter record
FS = 250
LONGREC_BATCH, LONGREC_HOP = 64, SIGNAL_LENGTH // 2
HOUR_S, SHORT_S, STREAM_S, HOLTER_S = 3600, 120, 600, 24 * 3600
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


def log(*args):
    print("[chip_smoke]", *args, flush=True)


def device_ms(torch, fn, iters):
    """Device time per call: CUDA events around ``iters`` calls queued
    behind a sleep kernel, so the host's enqueue cost stays off the clock.
    The sleep lasts about a millisecond per call: SDPA's backward through
    autograd costs the host hundreds of microseconds a call in a fresh
    process, and a shorter sleep let that into its time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(max(100_000_000, 2_000_000 * iters))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    threads), queued and timed as ``device_ms`` times every kernel: what a
    launch costs the card before any work."""
    lib = gather1d.load_kernels()

    def empty():
        err = lib.gather1d_empty(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"phase 2 failed: the empty kernel's launch "
                             f"returned CUDA error {err}")

    return device_ms(torch, empty, 200)


def tf32_flags(torch):
    return ("torch.backends.cuda.matmul.allow_tf32 = "
            f"{torch.backends.cuda.matmul.allow_tf32}, "
            "torch.backends.cudnn.allow_tf32 = "
            f"{torch.backends.cudnn.allow_tf32}")


def check_kernel(torch, fa, gen, label, shape, dtype_name):
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
    kernel_ms = device_ms(torch, lambda: fa.flash_attention_forward(
        q, k, v, scale), 20 if long else 200)
    plain_ms = device_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, scale), 5 if long else 100)
    library_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale), 20 if long else 200)
    bound_ms, bound_by = attention_bound(shape, dtype_name)
    log(f"  fwd {label} {shape} {dtype_name}: err out {err_out:.3g} "
        f"({ratio:.3g} of the tolerance, {tol_name}) lse {err_lse:.3g} | "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, "
        f"{FLASH_PEAK[dtype_name]})")
    if not ok:
        raise SystemExit(f"phase 2 failed: forward {label} disagrees with "
                         f"the plain version (out {err_out}, {ratio} of the "
                         f"tolerance; lse {err_lse})")
    return {"shape": label, "bhnd": list(shape), "dtype": dtype_name,
            "max_abs_err": err_out, "max_abs_err_lse": err_lse,
            "tolerance": tol_name, "max_tolerance_ratio": ratio,
            "atol_lse": fa.LSE_ATOL, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_peak": FLASH_PEAK[dtype_name]}


def check_backward(torch, fa, gen, label, shape, dtype_name):
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
            raise SystemExit(f"phase 2 failed: backward {label} returned "
                             f"{got.dtype}, not {dtype}")
        err, r = excess_over(got, ref, tol)
        errs.append(err)
        ratio = max(ratio, r)
    del tols
    # a reading only: no kernel sums in the plain version's order
    bit_equal = all(torch.equal(g, w) for g, w in zip(grads, want))
    long = shape[2] >= 1000
    kernel_ms = device_ms(torch, lambda: fa.flash_attention_backward(
        q, k, v, out, lse, dout, scale), 20 if long else 200)
    plain_ms = device_ms(torch, lambda: fa.flash_attention_backward_plain(
        q, k, v, out, lse, dout, scale), 3 if long else 50)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    library_ms = device_ms(torch, lambda: torch.autograd.grad(
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
        raise SystemExit(f"phase 2 failed: backward {label} disagrees with "
                         f"the plain version (max error {err}, {ratio} of "
                         "the tolerance)")
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
    kernel_ms = device_ms(torch, run, 200)
    plain_ms = device_ms(torch, plain, 50)
    library_ms = device_ms(torch, library, 200) if library else None
    if kind == "pair":
        separate_ms = device_ms(torch, lambda: (
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


def write_random_weights(config, path):
    """The config's model at full width, weights from seed 0, as a .pth."""
    import torch

    from semi_seg_ecg_tpu_torch.config import normalize_config
    from semi_seg_ecg_tpu_torch.models import build_model_from_config
    from semi_seg_ecg_tpu_torch.utils.checkpoint import save_torch_checkpoint

    torch.manual_seed(0)
    model = build_model_from_config(normalize_config(config))
    save_torch_checkpoint(path, model, epoch=0)
    return sum(p.numel() for p in model.parameters())


def reset_counts():
    from semi_seg_ecg_tpu_torch.ops import flash_attention as fa
    from semi_seg_ecg_tpu_torch.ops import gather1d

    fa.LAUNCHES = fa.BWD_LAUNCHES = gather1d.LAUNCHES = 0


def read_counts():
    from semi_seg_ecg_tpu_torch.ops import flash_attention as fa
    from semi_seg_ecg_tpu_torch.ops import gather1d

    return {"flash_attention_fwd": fa.LAUNCHES,
            "flash_attention_bwd": fa.BWD_LAUNCHES,
            "gather1d": gather1d.LAUNCHES}


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
    launches = read_counts()
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


def trace_device(torch, fn, steps, region=None):
    """Device time of ``steps`` calls of ``fn`` from a torch.profiler
    trace: busy ms per call and per kernel, device events per call and,
    with a ``region`` (see :func:`region_device_us`), the region's device
    ms per call (else None). Empty when the trace holds no device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    region_ms = (region_device_us(prof.events(), *region) / 1e3 / steps
                 if region else None)
    per_kernel, count, kinds = {}, 0, {"copy": 0, "elementwise": 0}
    for event in prof.events():
        # user annotations (the optimizer's step range) span kernels that
        # the trace also lists, so they are not device work of their own
        if event.device_type == DeviceType.CUDA and not getattr(
                event, "is_user_annotation", False):
            count += 1
            per_kernel[event.name] = (per_kernel.get(event.name, 0.0)
                                      + event.time_range.elapsed_us() / 1e3)
            kind = kernel_kind(event.name)
            if kind:
                kinds[kind] += 1
    return (traced_ms, {k: v / steps for k, v in per_kernel.items()},
            count / steps, {k: v / steps for k, v in kinds.items()},
            region_ms)


def region_device_us(events, range_name, sequence_nrs):
    """Device µs of a region of a traced run: the kernels launched inside
    the host ranges named ``range_name`` (its forward) and inside the
    backward's ``evaluate_function`` ranges of the autograd nodes whose
    sequence numbers are ``sequence_nrs`` (its backward, each node's
    gradient accumulation included)."""
    from torch.autograd import DeviceType

    backward = "autograd::engine::evaluate_function:"
    total = 0.0
    for event in events:
        if event.device_type != DeviceType.CPU:
            continue
        if event.name == range_name or (
                event.name.startswith(backward)
                and event.sequence_nr in sequence_nrs):
            total += event.device_time_total
    return total


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


def kernel_kind(name):
    """'copy' for PyTorch's copy and cast kernels (and memcpys), else
    'elementwise' for its other elementwise kernels, else None."""
    low = name.lower()
    if "copy" in low or "memcpy" in low:
        return "copy"
    if "elementwise" in low:
        return "elementwise"
    return None


def kernel_ms(per_kernel, *needles):
    if not per_kernel:
        return None
    return sum(v for k, v in per_kernel.items()
               if any(n in k for n in needles))


def profile_model(torch, config, model_path, amp, steps=20):
    """Where one batch's time goes: host-clock wall time per forward of a
    (16, 1, 2500) batch (synchronized), and from a torch.profiler trace of
    the same loop the card's busy time, its idle share and the kernels
    that take the most device time. Device numbers are None when the
    trace holds no device events."""
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

    forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        forward()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    traced_ms, per_kernel, events, kinds, _ = trace_device(torch, forward,
                                                            steps)
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "wall_ms_per_batch": wall_ms,
        "windows_per_s": BATCH / (wall_ms / 1e3),
        "traced_wall_ms_per_batch": traced_ms,
        "device_events_per_batch": events,
        "copy_kernels_per_batch": kinds["copy"],
        "elementwise_kernels_per_batch": kinds["elementwise"],
        "device_busy_ms_per_batch": busy_ms if per_kernel else None,
        # busy time from the trace over the untraced wall time: tracing
        # slows the host, not the kernels
        "device_idle_share": (1 - busy_ms / wall_ms) if per_kernel
        else None,
        "flash_kernel_ms_per_batch": kernel_ms(per_kernel, "flash_fwd_"),
        "top_kernels_ms_per_batch": [(k[:80], v) for k, v in top],
    }


def profile_models(torch, config, model_path):
    """``profile_model`` at fp32 and under bf16 autocast, logged."""
    model = {"fp32": profile_model(torch, config, model_path, False),
             "bf16_autocast": profile_model(torch, config, model_path, True)}
    for name, m in model.items():
        log(f"  model forward, batch {BATCH}, {name}: "
            f"{m['wall_ms_per_batch']:.3f} ms wall "
            f"({m['windows_per_s']:.1f} windows/s); traced: "
            f"{m['device_events_per_batch']:.0f} device events "
            f"({m['copy_kernels_per_batch']:.0f} copy, "
            f"{m['elementwise_kernels_per_batch']:.0f} other elementwise), "
            "device busy "
            f"{m['device_busy_ms_per_batch']} ms, idle share "
            f"{m['device_idle_share']}, flash kernel "
            f"{m['flash_kernel_ms_per_batch']} ms")
        for kernel, ms in m["top_kernels_ms_per_batch"]:
            log(f"    {ms:.4f} ms  {kernel}")
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
            before = read_counts()
            out = fn(*args, **kwargs)
            part = names[name]
            if part == "stage":
                part += str(kwargs["stage_id"])
            parts[part] = {k: v - before[k] for k, v in read_counts().items()}
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
    launches = read_counts()
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
    served = read_counts()
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
                   phase=4, sgd=False, conf_thresh=LOCKSTEP_CONF_THRESH):
    """LOCKSTEP_STEPS fp32 FixMatch steps from one init, dropout 0, on
    fixed batches, in two runs: ``(attention_impl, device)`` each (phase 4:
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
                for s in range(LOCKSTEP_STEPS)]
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
    log(f"  lockstep, {LOCKSTEP_STEPS} fp32 FixMatch steps "
        f"({'SGD' if sgd else 'AdamW'}), {what}: params within "
        f"{worst_other:.3g} lr ({worst_name}), key bias "
        f"{worst_key_bias:.3g} lr; losses within {loss_rel:.3g} relative; "
        f"confident pixels {pixels}")
    if not (worst_other <= LOCKSTEP_TIGHT_ATOL_LR
            and worst_key_bias <= LOCKSTEP_ATOL_LR and loss_rel <= 1e-4
            and any(a > 0 for a, _ in pixels)
            and all(abs(a - b) <= 4 for a, b in pixels)):
        raise SystemExit(f"phase {phase} failed: the training steps of "
                         f"{what} disagree")
    return {"runs": [list(r) for r in runs], "sgd": sgd,
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
    width: synchronized host-clock ms per ``Trainer.train_step`` (device
    augmentation included), the peak of allocated device memory and, from
    a trace of the same loop, device busy time, idle share, the top kernels,
    the per-step ms of each ported kernel and, with ``region`` (a context
    manager yielding :func:`trace_device`'s region), the region's device ms
    per step."""
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
        step = lambda: trainer.train_step(batch)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        per_step = {k: v / steps for k, v in read_counts().items()}
        with region() if region else contextlib.nullcontext() as traced:
            traced_ms, per_kernel, events, kinds, region_ms = trace_device(
                torch, step, steps, traced)
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    out = {
        "algorithm": algorithm,
        "wall_ms_per_step": wall_ms,
        "windows_per_s": 2 * BATCH / (wall_ms / 1e3),
        "peak_memory_mb": peak_mb,
        "launches_per_step": per_step,
        "traced_wall_ms_per_step": traced_ms,
        "device_events_per_step": events,
        "copy_kernels_per_step": kinds["copy"],
        "elementwise_kernels_per_step": kinds["elementwise"],
        "device_busy_ms_per_step": busy_ms if per_kernel else None,
        "device_idle_share": (1 - busy_ms / wall_ms) if per_kernel
        else None,
        "flash_fwd_ms_per_step": kernel_ms(per_kernel, "flash_fwd_"),
        "flash_bwd_ms_per_step": kernel_ms(per_kernel, "flash_bwd_"),
        "gather_ms_per_step": kernel_ms(per_kernel, "gather1d_kernel"),
        # under a process group: the collectives' kernels (phase 10)
        "collectives_ms_per_step": kernel_ms(per_kernel, "nccl"),
        "allreduce_ms_per_step": kernel_ms(per_kernel, "AllReduce"),
        "region_ms_per_step": region_ms if per_kernel else None,
        "top_kernels_ms_per_step": [(k[:80], v) for k, v in top],
    }
    log(f"  {algorithm} train step, {precision}, {BATCH} + {BATCH} windows: "
        f"{wall_ms:.3f} ms wall ({out['windows_per_s']:.1f} windows/s), "
        f"peak memory {peak_mb:.1f} MiB, "
        f"launches/step {per_step}; traced: {events:.0f} device events "
        f"({kinds['copy']:.0f} copy, {kinds['elementwise']:.0f} other "
        "elementwise), "
        f"device busy {out['device_busy_ms_per_step']} ms, idle share "
        f"{out['device_idle_share']}; flash fwd "
        f"{out['flash_fwd_ms_per_step']} ms, flash bwd "
        f"{out['flash_bwd_ms_per_step']} ms, gather "
        f"{out['gather_ms_per_step']} ms per step")
    for kernel, ms in top:
        log(f"    {ms:.4f} ms  {kernel[:80]}")
    want = launches_per_step(family, algorithm)
    if per_step != want:
        raise SystemExit(f"phase {phase} failed: {precision} step launches "
                         f"{per_step}, expected {want}")
    # a trace with device events must find each launched kernel by its name
    unnamed = [k for k, kernel in (
        ("flash_fwd_ms_per_step", "flash_attention_fwd"),
        ("flash_bwd_ms_per_step", "flash_attention_bwd"),
        ("gather_ms_per_step", "gather1d"))
        if per_kernel and want[kernel] and not out[k]]
    if region and per_kernel and not region_ms:
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
        # few calls: their host enqueue stays inside device_ms's sleep
        ms = device_ms(torch, loss_and_backward, 5)
        traced_ms, per_kernel, events, _, _ = trace_device(
            torch, loss_and_backward, 10)
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
    launches = read_counts()
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
    launches = read_counts()
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
    _, per_kernel, events, kinds, _ = trace_device(
        torch, lambda: rest(ecg), reps)
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
    streams; a 24-hour Holter record per model, and a profile of 1 hour."""
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

    holter_path, holter = save_record("holter_24h", HOLTER_S, 2)
    t0 = time.perf_counter()
    filtered(load_config(resnet[0]), holter)
    filter_s = time.perf_counter() - t0
    log(f"  24 h record: {holter.shape[-1]} samples; the filter chain "
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
    if read_counts() != want:
        raise SystemExit(f"phase 9 failed: exporting {path} launched "
                         f"{read_counts()}, expected {want} (the "
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
    counts = read_counts()
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


def profile_serving(torch, fn, n, steps=10):
    """One serving call's time at batch ``n``: host-clock wall per call
    (synchronized), and from a torch.profiler trace of the same loop the
    card's busy time, idle share, device events and top kernel."""
    x = card_batch(torch, n, 90 + n)
    fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    _, per_kernel, events, kinds, _ = trace_device(torch, lambda: fn(x),
                                                    steps)
    busy_ms = sum(per_kernel.values())
    top = max(per_kernel.items(), key=lambda kv: kv[1]) if per_kernel \
        else (None, None)
    return {"batch": n, "wall_ms": wall_ms,
            "windows_per_s": n / (wall_ms / 1e3),
            "device_busy_ms": busy_ms if per_kernel else None,
            "device_idle_share": (1 - busy_ms / wall_ms) if per_kernel
            else None,
            "device_events": events, "copy_kernels": kinds["copy"],
            "flash_kernel_ms": kernel_ms(per_kernel, "flash_fwd_"),
            "top_kernel": (top[0] or "")[:80], "top_kernel_ms": top[1]}


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
            per_call = read_counts()
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

    # int8, both backbones, dynamic and calibrated: card against the CPU,
    # int8 against fp32, the calibrated graph without activation reductions
    int8 = {}
    for family, flash in (("vit_tiny", True), ("resnet18", False)):
        for kind, n_cal in (("dynamic", 0), ("static", 2)):
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
                m = profile_serving(torch, fn, n)
                timings[f"{family}/{form}/{n}"] = m
                log(f"  {family} {form} batch {n}: {m['wall_ms']:.3f} ms "
                    f"wall ({m['windows_per_s']:.1f} windows/s), busy "
                    f"{m['device_busy_ms']} ms, idle share "
                    f"{m['device_idle_share']}, {m['device_events']:.0f} "
                    f"device events ({m['copy_kernels']:.0f} copy), top "
                    f"{m['top_kernel_ms']} ms {m['top_kernel']}")
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


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def dp_layout(torch):
    """``(backend, description)``: NCCL over two cards where there are two,
    else gloo with CUDA tensors on one card (NCCL refuses two ranks on one
    device)."""
    if torch.cuda.device_count() >= DP_WORLD:
        return "nccl", (f"{DP_WORLD} ranks on cuda:0-{DP_WORLD - 1}, "
                        "launched by torch.distributed.run")
    return "gloo", (f"{DP_WORLD} ranks on cuda:0 (one card), each with "
                    "LOCAL_RANK=0, started by chip_smoke.py")


def dp_step_config(family, backend):
    """The family's FixMatch recipe for the step comparison: fp32, no
    dropout, no warmup, SGD with momentum, device augmentation (and flash
    attention for the ViT)."""
    from semi_seg_ecg_tpu_torch.config import normalize_config

    _, config = write_train_config(family, "fixmatch")
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
    """DP_STEPS FixMatch steps of the seed-0 model on ``rows`` of each
    global batch (default: this rank's DP_ROWS): the metrics of each step
    (their mean over the ranks under a process group), the launches of
    each step and the final state."""
    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        Trainer,
        full_fp32,
        init_model,
    )
    from semi_seg_ecg_tpu_torch.parallel.dist import all_reduce_mean, get_rank

    if rows is None:
        rows = slice(get_rank() * DP_ROWS, (get_rank() + 1) * DP_ROWS)
    device = torch.device("cuda", torch.cuda.current_device())
    metrics, launches = [], []
    with full_fp32():
        trainer = Trainer(copy.deepcopy(config), fixmatch.SPEC, device, 4,
                          model=init_model(config, device))
        for batch in batches:
            on_card = {k: torch.from_numpy(v[rows]).to(device)
                       for k, v in batch.items()}
            torch.cuda.synchronize()
            reset_counts()
            step = trainer.train_step(on_card)
            launches.append(read_counts())
            metrics.append({k: all_reduce_mean(v).item()
                            for k, v in step.items()})
    state = {k: v.detach().cpu().numpy()
             for k, v in trainer.model.state_dict().items()}
    return {"metrics": metrics, "launches": launches, "state": state}


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
    return {"seconds": time.time() - t0, "launches": read_counts(),
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


def dp_events_ms(torch, fn, reps):
    """CUDA-event ms per call of ``fn`` over ``reps`` calls, after a warm
    call and a barrier."""
    from semi_seg_ecg_tpu_torch.parallel.dist import barrier

    fn()
    barrier()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dp_profile(torch, reps=20):
    """On each rank: :func:`dp_profiles` (the collectives' device time
    includes a rank's wait for the other); the gradient all-reduce alone
    (``all_reduce_grads_`` on the model's gradients: flatten, NCCL, divide,
    copy back) and NCCL's all-reduce of the same bytes as one flat buffer,
    each by :func:`dp_events_ms`; :func:`dp_reco_sync_free`."""
    import torch.distributed as dist

    from semi_seg_ecg_tpu_torch.models import build_model_from_config
    from semi_seg_ecg_tpu_torch.parallel.dist import all_reduce_grads_

    out = dp_profiles(torch)
    model = build_model_from_config(dp_profile_config(), train=True).cuda()
    params = list(model.parameters())
    for p in params:
        p.grad = torch.ones_like(p)
    flat = torch.ones(sum(p.numel() for p in params), device="cuda")
    out["grad_allreduce_alone_ms"] = dp_events_ms(
        torch, lambda: all_reduce_grads_(params), reps)
    out["nccl_allreduce_ms"] = dp_events_ms(
        torch, lambda: dist.all_reduce(flat), reps)
    out["grad_allreduce_bytes"] = 4 * flat.numel()
    out["reco_loss_gathered"] = dp_reco_sync_free(torch)
    return out


RANK_TASKS = {"steps": dp_steps, "train": dp_train, "rank": dp_rank,
              "profile": dp_profile}


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
    results = [RANK_TASKS[name](torch, **kwargs)
               for name, kwargs in spec["tasks"]]
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    pdist.destroy_process_group()
    return 0


def dp_run_ranks(tasks, backend):
    """Phase 10's ranks on ``tasks``, each task's results by rank; fails
    the phase if a rank fails or the group outlives DP_TIMEOUT (then every
    process of it is killed)."""
    work = os.path.join(WORK, "dp")
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
                      f"--nproc_per_node={DP_WORLD}",
                      "--master_addr=127.0.0.1", f"--master_port={port}",
                      *args], {})]
    else:
        commands = [([sys.executable, *args],
                     {"RANK": str(r), "WORLD_SIZE": str(DP_WORLD),
                      "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                      "MASTER_PORT": str(port)}) for r in range(DP_WORLD)]
    procs = []
    with open(os.path.join(work, "launcher.log"), "w") as out:
        for cmd, env in commands:
            procs.append(subprocess.Popen(
                cmd, cwd=REPO, env={**os.environ, **env}, stdout=out,
                stderr=subprocess.STDOUT, start_new_session=True))
    deadline = time.monotonic() + DP_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    logs = {}
    for name in ["launcher"] + [f"rank{r}" for r in range(DP_WORLD)]:
        path = os.path.join(work, f"{name}.log")
        logs[name] = open(path).read() if os.path.exists(path) else ""
    codes = [p.returncode for p in procs]
    if codes != [0] * len(procs):
        for name, text in logs.items():
            log(f"  {name}'s output ends:\n{text[-3000:]}")
        raise SystemExit(f"phase 10 failed: the ranks exited {codes} "
                         f"(timeout {DP_TIMEOUT} s)")
    results = []
    for r in range(DP_WORLD):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return [list(by_task) for by_task in zip(*results)], logs


def dp_check_steps(family, ranks, single):
    """The ranks' steps against one process holding both shards: losses,
    confident pixels, launches per step, the state; the ranks' states
    equal."""
    want_launches = launches_per_step(family, "fixmatch")
    for r, got in enumerate(ranks):
        if got["launches"] != [want_launches] * DP_STEPS:
            raise SystemExit(f"phase 10 failed: {family} rank {r} launched "
                             f"{got['launches']}, expected {want_launches} "
                             "a step")
    first = ranks[0]
    for k, v in first["state"].items():
        if not np.array_equal(v, ranks[1]["state"][k]):
            raise SystemExit(f"phase 10 failed: {family}: the ranks' {k} "
                             "differ")
    loss_rel, pixels = 0.0, []
    n = DP_WORLD * DP_ROWS * SIGNAL_LENGTH
    for a, b in zip(first["metrics"], single["metrics"]):
        for k in ("loss", "loss_x", "loss_u_s", "loss_total"):
            loss_rel = max(loss_rel, abs(a[k] - b[k]) / max(abs(b[k]),
                                                             1e-12))
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
    log(f"  {family} FixMatch, {DP_STEPS} fp32 SGD steps, {DP_WORLD} ranks "
        f"x {DP_ROWS} rows against one process with num_shards="
        f"{DP_WORLD}: losses within {loss_rel:.3g} relative; parameters "
        f"and BN statistics: max(|diff| - {DP_RTOL} |one process|) = "
        f"{worst:.3g} ({worst_key}); confident pixels {pixels}; launches "
        f"per rank per step {want_launches}")
    if not (loss_rel <= DP_LOSS_RTOL and worst <= DP_ATOL
            and all(abs(a - b) <= DP_PIXELS for a, b in pixels)):
        raise SystemExit(f"phase 10 failed: {family}: {DP_WORLD} ranks "
                         "disagree with one process")
    return {"loss_rel": loss_rel, "state_excess": worst,
            "state_worst": worst_key, "confident_pixels": pixels,
            "launches_per_rank_step": want_launches,
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


def phase_parallel(torch):
    """Phase 10: data-parallel training through the port's own path
    (``parallel/``, ``train_main`` under a process group), two ranks."""
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
    by_task, logs = dp_run_ranks(tasks, backend)
    ranks_s = time.perf_counter() - t0
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
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 10 in {result['seconds']:.1f} s (ranks {ranks_s:.1f} s)")
    return result


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------


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
    build_s, hmma = phase_build()
    rows, floor_ms = phase_kernels(torch)
    slice_result = phase_slice(torch)
    train_result = phase_train(torch)
    resnet_result = phase_resnet(torch)
    algorithm_results = phase_algorithms(torch)
    reco_stpp = phase_reco_stpp(torch)
    longrec = phase_longrec(torch)
    deploy = phase_deploy(
        torch, os.path.join(WORK, "exps", "vit_tiny_fixmatch",
                            "best-MeanIoU.ckpt"),
        os.path.join(WORK, "resnet18_seed0.pth"))
    parallel = phase_parallel(torch)
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
           for algorithm, r in parallel["entries"].items()}}
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
                   "seconds": time.time() - t_start}, f, indent=1)
    log(f"done in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(*sys.argv[2:]))
    sys.exit(main())
