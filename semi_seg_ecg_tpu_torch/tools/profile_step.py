"""Kernel-level profile of the flagship FixMatch train step, or of serving
(the port of ``tools/profile_step.py``).

    python -m semi_seg_ecg_tpu_torch.tools.profile_step [--steps 20] \\
        [--scan K] [--augment] [--inference [--int8 [--static]]] \\
        [--holter [--hop H]] [--batch 16] [--top 25] [--out DIR] [--keep] \\
        [--device cpu]

A ``torch.profiler`` trace of ``--steps`` calls, written by the training
loop's own schedule (``utils/profiling.ProfileSchedule``) to a Chrome
trace under ``--out`` (a temporary directory, deleted unless ``--keep``),
after a warm-up and an untimed-by-the-profiler run of as many calls timed
with a synchronized host clock. What is profiled:

- the train step (default): the eager step, or with ``--scan K`` the
  captured step (``train.scan_steps: K``: replays of its CUDA graph);
  ``--augment`` adds ``dataset.device_augment`` with the flagship recipe
  (``tools/flagship.flagship_data_recipe``): the raw batch is resized and
  cropped, and its strong view built, on the card, which reaches the
  gather kernel;
- ``--inference``: the serving forward (eval mode and the softmax,
  ``serving.ServingFn``) at ``--batch``; ``--int8`` the int8 model,
  ``--static`` with calibrated scales;
- ``--holter``: the long-record stitcher (``ops/stitch.overlap_add_infer``)
  over a 1 h record at ``--hop``.

It prints the top kernels by device time (name, category, events a step,
µs a step, share), the rollup by category (``device_profile.category``),
device busy a step against wall a step and, last, one JSON line with the
same numbers and the port's kernel launches in the traced window (from
the wrappers' counters) beside the kernel events the trace holds. On the
CPU every time, busy and idle share is null.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from ..ops.stitch import overlap_add_infer
from ..utils.profiling import ProfileSchedule
from .bench_inference import calibration_batches
from .device_profile import (
    FLASH_BWD,
    FLASH_FWD,
    GATHER,
    category,
    device_identity,
    device_window,
    launch_counts,
    on_card,
    synchronize,
    tool_device,
    trace_file_kernels,
    wall_ms,
)
from .flagship import (
    build_trainer,
    flagship_config,
    flagship_data_recipe,
    serving_fn,
    synth_record,
    synthetic_batch,
)

WARMUP = 3
HOLTER_HOURS = 1.0


def train_call(args, dev):
    """The train step to profile and its label."""
    scan_k = max(args.scan, 1)
    if args.augment and scan_k > 1:
        raise SystemExit("--augment profiles the eager step")
    config = flagship_config(args.length, args.batch, dev.type)
    config["train"]["scan_steps"] = scan_k
    if args.augment:
        config["dataset"].update(flagship_data_recipe(args.length),
                                 device_augment=True)
    trainer = build_trainer(config, dev)
    # with the augmentation the strong view is built on the device
    batch = synthetic_batch(args.batch, args.length, dev,
                            strong=not args.augment)
    label = f"scan{scan_k}" if scan_k > 1 else (
        "augment+step" if args.augment else "per-step")
    return (lambda: trainer.train_step(batch)), label


def serving_call(args, dev):
    config = flagship_config(args.length, device=dev.type)
    form = "int8" if args.int8 else "fp32"
    infer = serving_fn(config, dev, form, calibration_batches(
        dev, args.length) if args.static else None)
    if args.holter:
        record = torch.from_numpy(synth_record(HOLTER_HOURS)).to(dev)
        return (lambda: overlap_add_infer(
            infer, record, window=args.length, hop=args.hop,
            batch=args.batch)), ("int8-" if args.int8 else "") + \
            "holter-record"
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.batch, 1, args.length)).astype(np.float32)).to(dev)
    return (lambda: infer(x)), ("int8-" if args.int8 else "") + "inference"


def profile(call, steps: int, dev, trace_dir: str) -> Dict[str, Any]:
    """``call`` warmed up, timed over ``steps`` calls, then traced over
    ``steps`` more by a ``ProfileSchedule``; the trace's kernels against
    the launch counters of the traced window."""
    for _ in range(WARMUP):
        call()
    wall = wall_ms(call, steps, dev)
    schedule = ProfileSchedule({"trace_dir": trace_dir, "start_step": 0,
                                "num_steps": steps}, dev)
    before = launch_counts()
    for i in range(steps):
        schedule.step(i)
        call()
    schedule.close()
    after = launch_counts()
    per_kernel, events = trace_file_kernels(schedule.path)
    launches = {k: after[k] - before[k] for k in after}
    kernel_events = {
        name: sum(n for k, n in events.items() if needle in k)
        for name, needle in (("flash_attention_fwd", FLASH_FWD),
                             ("flash_attention_bwd", FLASH_BWD),
                             ("gather1d", GATHER))}
    wall = on_card(dev, wall)
    window = device_window({k: v / steps for k, v in per_kernel.items()},
                           wall, top=len(per_kernel))
    busy = window["device_busy_ms"]
    return {
        "steps_traced": steps, "trace": schedule.path,
        "wall_ms_per_step": wall,
        "device_busy_ms_per_step": busy,
        "device_idle_share": window["device_idle_share"],
        "device_events_per_step": sum(events.values()) / steps
        if per_kernel else None,
        "launches_in_window": launches,
        "kernel_events_in_window": kernel_events if per_kernel else None,
        "categories_ms_per_step": window["categories_ms"],
        "top_kernels": [
            {"name": k, "category": category(k),
             "events_per_step": events[k] / steps,
             "us_per_step": ms * 1e3, "share": ms / busy}
            for k, ms in window["top_kernels"] or []],
    }


def report(out: Dict[str, Any], top: int) -> None:
    print(f"\n{'kernel':60s} {'category':16s} {'n/st':>6s} {'us/st':>9s} "
          f"{'%':>6s}")
    for row in out["top_kernels"][:top]:
        print(f"{row['name'][:60]:60s} {row['category']:16s} "
              f"{row['events_per_step']:6.1f} {row['us_per_step']:9.1f} "
              f"{100 * row['share']:6.2f}")
    if out["categories_ms_per_step"]:
        print("\ncategory rollup (us/step):")
        for cat, ms in sorted(out["categories_ms_per_step"].items(),
                              key=lambda kv: -kv[1]):
            print(f"  {cat:20s} {ms * 1e3:9.1f}")
    print(f"\ndevice busy: {out['device_busy_ms_per_step']} ms/step | wall: "
          f"{out['wall_ms_per_step']} ms/step | idle share "
          f"{out['device_idle_share']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--scan", type=int, default=0,
                    help="profile the captured step at train.scan_steps K")
    ap.add_argument("--augment", action="store_true",
                    help="the step with dataset.device_augment (the "
                         "flagship recipe on the card: the gather)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--inference", action="store_true",
                    help="the serving forward instead of the train step")
    ap.add_argument("--holter", action="store_true",
                    help="the long-record stitcher on a 1 h record")
    ap.add_argument("--hop", type=int, default=2500,
                    help="with --holter: the window stride")
    ap.add_argument("--int8", action="store_true",
                    help="with --inference or --holter: the int8 model")
    ap.add_argument("--static", action="store_true",
                    help="with --int8: calibrated static scales")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None,
                    help="trace directory (default: temporary, deleted "
                         "unless --keep)")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--length", type=int, default=2500,
                    help="signal or window length (2500: the recipe's)")
    args = ap.parse_args(argv)
    if args.static and not args.int8:
        ap.error("--static needs --int8")
    dev = tool_device(args.device)
    if args.holter:
        args.steps = max(1, min(args.steps, 5))
    call, label = serving_call(args, dev) if (
        args.inference or args.holter) else train_call(args, dev)
    trace_dir = args.out or tempfile.mkdtemp(prefix="torchprof_")
    try:
        out = profile(call, args.steps, dev, trace_dir)
        synchronize(dev)
        print(f"[{label}] traced {args.steps} calls, wall "
              f"{out['wall_ms_per_step']} ms/call")
        report(out, args.top)
        if args.keep or args.out:
            print(f"trace kept at {out['trace']}")
        else:
            out["trace"] = None  # deleted below
        out.update(metric="profile_step", label=label, batch=args.batch,
                   top_kernels=out["top_kernels"][:args.top],
                   device=device_identity(dev))
        print(json.dumps(out), flush=True)
    finally:
        if not args.keep and args.out is None:
            shutil.rmtree(trace_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
