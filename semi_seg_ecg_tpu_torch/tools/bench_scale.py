"""The flagship train step against the batch a replica, in both modes
(the port of ``tools/bench_scale.py``).

    python -m semi_seg_ecg_tpu_torch.tools.bench_scale \\
        [--batches 16 32 64 128 256] [--modes 1 32] [--steps 96] \\
        [--device cpu]

``tools/bench.py`` pins the recipe's batch 16; this sweep asks how far one
card's samples/s and MFU rise with the batch and where they saturate. Each
row is :func:`bench.measure` (synchronized host clock, three trials, the
idle share from a profiler window, MFU against the card's dense bf16
peak) of the eager step (mode 1) or the captured one (``train.scan_steps``
K > 1). Prints a line to stderr a row and one JSON line; on the CPU every
time, rate, idle share and MFU is null.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import bench
from .device_profile import device_identity, tool_device
from .flagship import flagship_config
from .flops_audit import step_flops


def sweep(batches, modes, steps: int, device: str = "cuda",
          length: int = 2500):
    dev = tool_device(device)
    rows = []
    for b in batches:
        flops = step_flops(flagship_config(length, b, dev.type), dev)
        for k in modes:
            row = bench.measure(k, b, steps, dev, flops=flops, length=length)
            rows.append(row)
            print(f"# B={b:4d} {row['mode']:>9s}: {row['samples_per_sec']} "
                  f"samples/s, {row['ms_per_step']} ms/step, MFU "
                  f"{row['mfu']}, idle {row['device_idle_share']}",
                  file=sys.stderr, flush=True)
    return {"metric": "fixmatch_resnet18_batch_scaling",
            "device": device_identity(dev), "sweep": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, nargs="+",
                   default=[16, 32, 64, 128, 256])
    p.add_argument("--modes", type=int, nargs="+", default=[1, bench.SCAN_K],
                   help="train.scan_steps of each mode (1: eager)")
    p.add_argument("--steps", type=int, default=96,
                   help="eager steps a trial (captured: units of K)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--length", type=int, default=2500)
    args = p.parse_args(argv)
    print(json.dumps(sweep(args.batches, args.modes, args.steps,
                           args.device, args.length)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
