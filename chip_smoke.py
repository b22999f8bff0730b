#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
nvidia-smi. It imports the port (``semi_seg_ecg_tpu_torch``) and nothing of
JAX or of the JAX package. Phases, each of which stops the script with a
non-zero exit when it fails:

1. build every CUDA kernel of the ported path from ``csrc/`` (nvcc), and
   print the build time and the compiler's register report;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it and at a long and a ragged shape; time
   kernel, plain version and the one-call PyTorch equivalent, and compute
   the card's bound for the same work;
3. serve the full-width ``vit_tiny`` + FCNHead recipe
   (``configs/base/vit_tiny/scratch.yaml``, ``attention_impl: flash``) on a
   synthetic test split through ``inference_main``, at fp32 and under bf16
   autocast, with launch counters zeroed just before and read just after;
   check the probabilities, and hold the fp32 outputs against the dense
   attention path on the card and against the plain path on the CPU.

The line before the last prints the card's name and power limit as
nvidia-smi gives them; the line before that, a JSON object with one entry
per kernel. The last line is ``{"ok": true, "device": {...}}``. Details go
to ``build/chip_smoke/chip_smoke.json``.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import yaml

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
OUT_JSON = os.path.join(WORK, "chip_smoke.json")

# H100 SXM data-sheet peaks (dense): device memory and, per input type, the
# rate of the units that type runs on
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

FLASH_SOURCE = "semi_seg_ecg_tpu_torch/csrc/flash_attention_fwd.cu"
FLASH_REPLACES = "semi_seg_ecg_tpu/ops/pallas/flash_attention.py:124"
# (label, (B, H, N, D), dtype): the serving shape of vit_tiny at batch 16
# first, in both precisions the entry runs; then a long and ragged shapes
FLASH_SHAPES = [
    ("slice_fp32", (16, 3, 101, 64), "float32"),
    ("slice_bf16", (16, 3, 101, 64), "bfloat16"),
    ("long_bf16", (8, 12, 2048, 64), "bfloat16"),
    ("ragged_fp32", (4, 3, 1000, 64), "float32"),
    ("ragged_bf16_d100", (2, 4, 257, 100), "bfloat16"),
    # one head of the serving shape: 2 CTAs instead of 96, the same work
    # per CTA, so its time against slice_fp32 shows what one CTA costs
    ("one_head_fp32", (1, 1, 101, 64), "float32"),
]
# kernel vs plain, |kernel - plain| <= atol + rtol |plain|: fp32 sums in
# another order; bf16 output is the same fp32 value rounded once, so the two
# are at most one bf16 ulp (2^-7 of the value) apart
TOL_OUT = {"float32": (1e-5, 0.0), "bfloat16": (1e-5, 2.0 ** -7)}
ATOL_LSE = 1e-4

NUM_TEST, SIGNAL_LENGTH, BATCH, DEPTH = 64, 2500, 16, 12


def log(*args):
    print("[chip_smoke]", *args, flush=True)


def device_ms(torch, fn, iters):
    """Device time per call: CUDA events around ``iters`` calls queued
    behind a sleep kernel, so the host's enqueue cost stays off the clock."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(shape, dtype):
    """Least time for softmax(q kᵀ) v plus its logsumexp on an H100: each
    of q, k, v, out moved once (lse too), against 4·B·H·N²·D flops at the
    input type's peak."""
    b, h, n, d = shape
    elem = 4 if dtype == "float32" else 2
    nbytes = 4 * b * h * n * d * elem + b * h * n * 4
    flops = 4 * b * h * n * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_build(fa):
    from semi_seg_ecg_tpu_torch.ops.cuda_build import library_path

    t0 = time.time()
    fa.load_kernel()
    seconds = time.time() - t0
    log(f"phase 1: built flash_attention_fwd in {seconds:.2f} s")
    with open(library_path("flash_attention_fwd")[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())
    return seconds


def phase_kernels(torch, fa):
    from semi_seg_ecg_tpu_torch.algorithms.common import full_fp32

    # TF32 off for the plain version's fp32 matmuls here only: phase 3
    # starts from PyTorch's defaults, so that the entry sets its own
    with full_fp32():
        log(f"phase 2: {tf32_flags(torch)}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        return [check_kernel(torch, fa, gen, *case) for case in FLASH_SHAPES]


def tf32_flags(torch):
    return ("torch.backends.cuda.matmul.allow_tf32 = "
            f"{torch.backends.cuda.matmul.allow_tf32}, "
            "torch.backends.cudnn.allow_tf32 = "
            f"{torch.backends.cudnn.allow_tf32}")


def check_kernel(torch, fa, gen, label, shape, dtype_name):
    """One shape: the kernel against its plain version, then the times of
    kernel, plain version and SDPA, and the card's bound."""
    import torch.nn.functional as F

    dtype = getattr(torch, dtype_name)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
               for _ in range(3))
    scale = shape[-1] ** -0.5
    out, lse = fa.flash_attention_forward(q, k, v, scale)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, scale)
    atol, rtol = TOL_OUT[dtype_name]
    diff = (out.float() - ref_out.float()).abs()
    err_out = diff.max().item()
    # how far the worst element is past its tolerance (<= 0 passes)
    excess = (diff - rtol * ref_out.float().abs()).max().item() - atol
    err_lse = (lse - ref_lse).abs().max().item()
    ok = (math.isfinite(err_out) and excess <= 0
          and math.isfinite(err_lse) and err_lse <= ATOL_LSE)
    long = shape[2] >= 1000
    kernel_ms = device_ms(torch, lambda: fa.flash_attention_forward(
        q, k, v, scale), 20 if long else 200)
    plain_ms = device_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, scale), 5 if long else 100)
    library_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale), 20 if long else 200)
    bound_ms, bound_by = attention_bound(shape, dtype_name)
    log(f"  {label} {shape} {dtype_name}: err out {err_out:.3g} "
        f"(tolerance excess {excess:.3g}) lse {err_lse:.3g} | kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    if not ok:
        raise SystemExit(f"phase 2 failed: {label} disagrees with the "
                         f"plain version (out {err_out}, lse {err_lse})")
    return {"shape": label, "bhnd": list(shape), "dtype": dtype_name,
            "max_abs_err": err_out, "max_abs_err_lse": err_lse,
            "atol": atol, "rtol": rtol, "atol_lse": ATOL_LSE,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def write_slice_config():
    from semi_seg_ecg_tpu_torch.config import load_config
    from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset

    shutil.rmtree(WORK, ignore_errors=True)
    data = make_synthetic_dataset(
        os.path.join(WORK, "data"), num_train_labeled=1,
        num_train_unlabeled=1, num_valid=1, num_test=NUM_TEST,
        length=SIGNAL_LENGTH, seed=0)
    config = load_config(os.path.join(REPO, "configs", "base", "vit_tiny",
                                      "scratch.yaml"))
    config["backbone"]["vit_tiny"]["attention_impl"] = "flash"
    config["dataset"].update(data)
    config["dataloader"]["batch_size"] = BATCH
    config["output_dir"] = os.path.join(WORK, "exps")
    path = os.path.join(WORK, "vit_tiny_flash.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path, config


def write_random_weights(config, path):
    """vit_tiny + FCNHead at full width, weights from seed 0, as a .pth."""
    import torch

    from semi_seg_ecg_tpu_torch.config import normalize_config
    from semi_seg_ecg_tpu_torch.models import build_model_from_config
    from semi_seg_ecg_tpu_torch.utils.checkpoint import save_torch_checkpoint

    torch.manual_seed(0)
    model = build_model_from_config(normalize_config(config))
    save_torch_checkpoint(path, model, epoch=0)
    return sum(p.numel() for p in model.parameters())


def serve(config_path, model_path, name, **override):
    """One ``inference_main`` call with an override file; returns the
    outputs, the kernel launches it made and its wall seconds."""
    import torch

    from semi_seg_ecg_tpu_torch.cli import inference_main
    from semi_seg_ecg_tpu_torch.ops import flash_attention as fa

    override_path = os.path.join(WORK, f"{name}.yaml")
    with open(override_path, "w") as f:
        yaml.safe_dump(override, f)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    fa.LAUNCHES = 0
    t0 = time.time()
    outputs = inference_main(["-f", config_path, "-o", override_path,
                              "--model_path", model_path,
                              "--exp_name", name])
    seconds = time.time() - t0
    launches = fa.LAUNCHES
    saved = np.load(os.path.join(WORK, "exps", name, "test_outputs.npy"))
    if not np.array_equal(saved, outputs):
        raise SystemExit(f"{name}: test_outputs.npy differs from the "
                         "returned outputs")
    return outputs, launches, seconds


def check_probs(name, probs):
    expected = (NUM_TEST, 4, SIGNAL_LENGTH)
    if probs.shape != expected or not np.isfinite(probs).all():
        raise SystemExit(f"{name}: outputs {probs.shape} (expected "
                         f"{expected}) or not finite")
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    if row_err > 1e-5:
        raise SystemExit(f"{name}: probability rows sum to 1 +- {row_err}")
    return row_err


def profile_model(torch, config, model_path, amp, steps=20):
    """Where one batch's time goes: host-clock wall time per forward of a
    (16, 1, 2500) batch (synchronized), and from a torch.profiler trace of
    the same loop the card's busy time, its idle share and the kernels
    that take the most device time. Device numbers are None when the
    trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            forward()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    per_kernel = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            per_kernel[event.name] = (per_kernel.get(event.name, 0.0)
                                      + event.time_range.elapsed_us() / 1e3)
    busy_ms = sum(per_kernel.values()) / steps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    flash_ms = sum(v for k, v in per_kernel.items()
                   if "flash_fwd_kernel" in k) / steps
    return {
        "wall_ms_per_batch": wall_ms,
        "windows_per_s": BATCH / (wall_ms / 1e3),
        "traced_wall_ms_per_batch": traced_ms,
        "device_busy_ms_per_batch": busy_ms if per_kernel else None,
        # busy time from the trace over the untraced wall time: tracing
        # slows the host, not the kernels
        "device_idle_share": (1 - busy_ms / wall_ms) if per_kernel
        else None,
        "flash_kernel_ms_per_batch": flash_ms if per_kernel else None,
        "top_kernels_ms_per_batch": [(k[:80], v / steps) for k, v in top],
    }


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
        probs, launches, seconds = serve(config_path, model_path, name,
                                         **override)
        row_err = check_probs(name, probs)
        runs[name] = {"probs": probs, "launches": launches,
                      "seconds": seconds, "windows_per_s": NUM_TEST / seconds,
                      "row_sum_err": row_err}
        log(f"  {name}: {launches} kernel launches, {seconds:.3f} s entry "
            f"wall time, {NUM_TEST / seconds:.2f} windows/s end to end")
        on_card_flash = name.startswith("flash") and not name.endswith("cpu")
        if launches != (want if on_card_flash else 0):
            raise SystemExit(f"{name}: {launches} flash kernel launches, "
                             f"expected {want if on_card_flash else 0} "
                             f"({DEPTH} blocks x {n_batches} batches)")

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

    model = {"fp32": profile_model(torch, config, model_path, False),
             "bf16_autocast": profile_model(torch, config, model_path, True)}
    for name, m in model.items():
        log(f"  model forward, batch {BATCH}, {name}: "
            f"{m['wall_ms_per_batch']:.3f} ms wall "
            f"({m['windows_per_s']:.1f} windows/s); traced: device busy "
            f"{m['device_busy_ms_per_batch']} ms, idle share "
            f"{m['device_idle_share']}, flash kernel "
            f"{m['flash_kernel_ms_per_batch']} ms")
        for kernel, ms in m["top_kernels_ms_per_batch"]:
            log(f"    {ms:.4f} ms  {kernel}")
    summary = {name: {k: v for k, v in r.items() if k != "probs"}
               for name, r in runs.items()}
    return {"runs": summary, "diffs": diffs, "amp_argmax_agreement": agree,
            "batches": n_batches, "launches_expected": want,
            "model": model}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from semi_seg_ecg_tpu_torch.ops import flash_attention as fa

    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    t_start = time.time()
    build_s = phase_build(fa)
    rows = phase_kernels(torch, fa)
    slice_result = phase_slice(torch)
    main_row = rows[0]
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
        "launches": slice_result["runs"]["flash_fp32"]["launches"],
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": rows,
    }]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    os.makedirs(os.path.dirname(OUT_JSON), exist_ok=True)
    with open(OUT_JSON, "w") as f:
        json.dump({"nvidia_smi": smi, "torch": torch.__version__,
                   "build_s": build_s, "kernels": kernels,
                   "slice": slice_result,
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
