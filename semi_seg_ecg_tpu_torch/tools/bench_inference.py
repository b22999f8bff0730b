"""Serving throughput: windows/s of a batch through ``serving.ServingFn``
(the port of ``tools/bench_inference.py``).

    python -m semi_seg_ecg_tpu_torch.tools.bench_inference [--int8] \\
        [--static] [--batches 16 64 256] [--steps 50] [--device cpu]

The flagship segmentor (ResNet18-1D + FCN head, windows of 2,500) with
seed-0 weights, eval mode, the softmax included, as ``ServingFn`` serves
it: at fp32 and under bf16 autocast, and with ``--int8`` in int8 too
(dynamic activation scales; ``--static`` calibrates static ones on four
batches first, ``utils/calibrate.py``). Each row: host-clock ms a batch
(synchronized, after a warm call), windows/s, and from a profiler window of
as many calls the device busy ms, idle share, events and top kernel
(``tools/device_profile.profile_forward``). Prints one JSON line; on the
CPU every time, rate and idle share is null.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .device_profile import device_identity, profile_forward, tool_device
from .flagship import flagship_config, serving_fn


def calibration_batches(device, length: int, n: int = 4, per: int = 16,
                        seed: int = 1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((per, 1, length)).astype(
        np.float32)).to(device) for _ in range(n)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--int8", action="store_true",
                   help="also serve the int8 model (dynamic scales)")
    p.add_argument("--static", action="store_true",
                   help="with --int8: calibrated static activation scales")
    p.add_argument("--batches", type=int, nargs="+", default=[16, 64, 256])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--length", type=int, default=2500)
    args = p.parse_args(argv)
    if args.static and not args.int8:
        p.error("--static needs --int8")
    dev = tool_device(args.device)
    config = flagship_config(args.length, device=dev.type)
    forms = ["fp32", "bf16"] + (["int8"] if args.int8 else [])
    rng = np.random.default_rng(0)
    rows = []
    for form in forms:
        calibration = calibration_batches(dev, args.length) \
            if form == "int8" and args.static else None
        infer = serving_fn(config, dev, form, calibration)
        for batch in args.batches:
            x = torch.from_numpy(rng.standard_normal(
                (batch, 1, args.length)).astype(np.float32)).to(dev)
            probs = infer(x)
            m = profile_forward(lambda: infer(x), batch, args.steps, dev,
                                top=1)
            m.update(form=form, quantize=("int8-static" if args.static
                                          else "int8-dynamic")
                     if form == "int8" else None,
                     finite=bool(torch.isfinite(probs).all()))
            rows.append(m)
            print(f"# {form} batch {batch:4d}: {m['wall_ms']} ms/batch, "
                  f"{m['windows_per_s']} windows/s, idle "
                  f"{m['device_idle_share']}", file=sys.stderr, flush=True)
    print(json.dumps({"metric": "serving_windows_per_sec",
                      "device": device_identity(dev), "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
