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
   checkpoint served.

The line before the last prints the card's name and power limit as
nvidia-smi gives them; the line before that, a JSON object with one entry
per kernel. The last line is ``{"ok": true, "device": {...}}``. Details go
to ``build/chip_smoke/chip_smoke.json``.
"""

import copy
import functools
import json
import math
import os
import re
import shutil
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
RECIPE_PASSES = {"fixmatch": (2, 1), "mean_teacher": (2, 1), "cps": (4, 2)}
RECIPE_GATHERS = {"fixmatch": 3, "mean_teacher": 3, "cps": 2}
# what the checkpoint of each algorithm holds beside the model
CKPT_EXTRAS = {"fixmatch": set(), "mean_teacher": {"model_ema"},
               "cps": {"model_peer", "peer_optimizer"}}
# the stem pool's tie-routing check: (B, C, T) of the ResNet18 stem output
POOL_SHAPE = (BATCH, 64, SIGNAL_LENGTH // 2)


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


def trace_device(torch, fn, steps):
    """Device time of ``steps`` calls of ``fn`` from a torch.profiler
    trace: busy ms per call and per kernel, and device events per call.
    Empty when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps
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
            count / steps, {k: v / steps for k, v in kinds.items()})


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
    traced_ms, per_kernel, events, kinds = trace_device(torch, forward,
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


def train_recipe(torch, phase, family, algorithm):
    """``train_main`` on a recipe (``write_train_config``) with the launch
    counters zeroed just before and read just after, held to the counts
    per step and per eval batch; then its files, its log, the parameters'
    move, what the checkpoint holds beside the model, and the trained
    checkpoint served through ``inference_main``. Returns the result and
    the normalized config."""
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
    want = {k: steps * v for k, v in per_step.items()}
    want["flash_attention_fwd"] += eval_batches * eval_depth
    log(f"phase {phase}: train_main, {name} (device_augment, "
        f"{config['precision']}, batch {BATCH} + {BATCH}), {TRAIN_EPOCHS} "
        f"epochs of {steps_per_epoch} steps, then the test pass; entering "
        f"with {tf32_flags(torch)}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    test_metrics = train_main(["-f", config_path])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = read_counts()
    log(f"  train_main: {seconds:.2f} s, launches {launches} (expected "
        f"{want}: per step {per_step}; {eval_depth} forward per eval batch "
        f"x {eval_batches}); test metrics {test_metrics}")
    if launches != want:
        raise SystemExit(f"phase {phase} failed: {name} launches "
                         f"{launches}, expected {want}")

    out_dir = os.path.join(WORK, "exps", name)
    for f in ("log.txt", "best-loss.ckpt", "best-MeanIoU.ckpt",
              "test_metrics.csv", "test_outputs.npy", "test_labels.npy"):
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
                       family="vit_tiny", steps=10):
    """Where one FixMatch step's time goes at full width: synchronized
    host-clock ms per ``Trainer.train_step`` (device augmentation
    included) and, from a trace of the same loop, device busy time, idle
    share, the top kernels and the per-step ms of each ported kernel."""
    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
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
        trainer = Trainer(cfg, fixmatch.SPEC, torch.device("cuda"), 4,
                          model=init_model(cfg, torch.device("cuda")))
        step = lambda: trainer.train_step(batch)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        per_step = {k: v / steps for k, v in read_counts().items()}
        traced_ms, per_kernel, events, kinds = trace_device(torch, step,
                                                            steps)
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    out = {
        "wall_ms_per_step": wall_ms,
        "windows_per_s": 2 * BATCH / (wall_ms / 1e3),
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
        "top_kernels_ms_per_step": [(k[:80], v) for k, v in top],
    }
    log(f"  train step, {precision}, {BATCH} + {BATCH} windows: "
        f"{wall_ms:.3f} ms wall ({out['windows_per_s']:.1f} windows/s), "
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
    want = launches_per_step(family, "fixmatch")
    if per_step != want:
        raise SystemExit(f"phase {phase} failed: {precision} step launches "
                         f"{per_step}, expected {want}")
    # a trace with device events must find each launched kernel by its name
    unnamed = [k for k, kernel in (
        ("flash_fwd_ms_per_step", "flash_attention_fwd"),
        ("flash_bwd_ms_per_step", "flash_attention_bwd"),
        ("gather_ms_per_step", "gather1d"))
        if per_kernel and want[kernel] and not out[k]]
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
    # each path's launches, counted from 0 just before it and read after
    by_path = {
        "vit_tiny_serving": slice_result["runs"]["flash_fp32"][
            "launches_by_kernel"],
        "vit_tiny_fixmatch": train_result["launches"],
        "resnet18_serving": resnet_result["serving"]["runs"]["resnet_fp32"][
            "launches"],
        "resnet18_fixmatch": resnet_result["train"]["launches"],
        **{path: r["launches"] for path, r in algorithm_results.items()}}
    kernels = [kernel_entry(name, rows[name], by_path) for name in STEMS]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    with open(OUT_JSON, "w") as f:
        json.dump({"nvidia_smi": smi, "torch": torch.__version__,
                   "build_s": build_s, "hmma": hmma,
                   "launch_floor_ms": floor_ms, "kernels": kernels,
                   "slice": slice_result, "train": train_result,
                   "resnet18": resnet_result,
                   "algorithms": algorithm_results,
                   "seconds": time.time() - t_start}, f, indent=1)
    log(f"done in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
