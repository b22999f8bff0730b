"""Holter-scale serving: hours of ECG a second through
``serving.long_record_inference`` (the port of ``tools/bench_holter.py``).

    python -m semi_seg_ecg_tpu_torch.tools.bench_holter [--hours 1.0] \\
        [--hop 2500] [--batch 64] [--int8] [--reps 3] [--device cpu]

The flagship segmentor (ResNet18-1D + FCN head, windows of 2,500 at
250 Hz, seed-0 weights) segments a synthetic record
(``tools/flagship.synth_record``) end to end: windowed at ``--hop``,
each window standardized, batched through the model and taper-stitched on
the card (``ops/stitch.overlap_add_infer``), the probabilities and labels
fetched once a record. ``--int8`` serves the int8 model with static
activation scales calibrated on standardized windows of the record. One
warm record, then ``--reps`` timed ones (each ends in its fetch; the
median). Prints one JSON line: record samples/s, hours of ECG a second,
seconds a record, the peak of the run's device memory (the model's and
the records', not what the process held before); on the CPU every time,
rate and memory is null.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..ops.stitch import plan_windows
from ..serving import long_record_inference
from .device_profile import (
    allocated_bytes,
    device_identity,
    on_card,
    peak_mb,
    synchronize,
    tool_device,
)
from .flagship import FS, flagship_config, serving_fn, synth_record

WINDOW = 2500


def calibration_windows(record: np.ndarray, device, n: int = 4,
                        per: int = 16):
    """Standardized windows of ``record`` (modulo its length), as the model
    will see them."""
    n_avail = max(1, record.shape[1] // WINDOW)
    out = []
    for b in range(n):
        idx = [(b * per + i) % n_avail for i in range(per)]
        wins = np.stack([record[:, j * WINDOW:(j + 1) * WINDOW]
                         for j in idx])
        mu = wins.mean(axis=(1, 2), keepdims=True)
        sd = wins.std(axis=(1, 2), keepdims=True)
        out.append(torch.from_numpy(
            (wins - mu) / np.where(sd == 0, 1, sd)).float().to(device))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hours", type=float, default=1.0)
    p.add_argument("--hop", type=int, default=WINDOW,
                   help=f"window stride ({WINDOW}: no overlap; "
                        f"{WINDOW // 2}: half, twice the windows)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--int8", action="store_true",
                   help="int8 with static scales calibrated on the record")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = tool_device(args.device)
    config = flagship_config(WINDOW, device=dev.type)
    config["dataset"]["transforms"] = [{"standardize": {"axis": [-1, -2]}}]
    record = synth_record(args.hours)
    held = allocated_bytes(dev)
    infer = serving_fn(config, dev, "int8" if args.int8 else "fp32",
                       calibration_windows(record, dev) if args.int8
                       else None)
    total = record.shape[1]
    n_win = plan_windows(total, WINDOW, args.hop, args.batch)[0]

    def segment():
        return long_record_inference(config, record, batch=args.batch,
                                     hop=args.hop, infer=infer)

    t0 = time.perf_counter()
    out = segment()
    first_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(args.reps):
        synchronize(dev)
        t0 = time.perf_counter()
        out = segment()  # numpy out: the fetch ends the record's work
        times.append(time.perf_counter() - t0)
    sec = on_card(dev, statistics.median(times))
    print(json.dumps({
        "metric": "holter_inference_throughput",
        "value": total / sec if sec else None,
        "unit": "record_samples/s/chip",
        "record_hours": args.hours, "record_samples": total,
        "windows": n_win, "hop": args.hop, "batch": args.batch,
        "quantize": "int8-static" if args.int8 else None,
        "seconds_per_record": sec,
        "seconds_per_record_reps": on_card(dev, times),
        "first_record_s": on_card(dev, first_s),
        "hours_of_ecg_per_s": args.hours / sec if sec else None,
        "windows_per_s": n_win / sec if sec else None,
        "peak_memory_mb": peak_mb(dev, held),
        "labels_in_range": bool(((out["labels"] >= 0)
                                 & (out["labels"] < 4)).all()),
        "probs_finite": bool(np.isfinite(out["probs"]).all()),
        "fs": FS, "device": device_identity(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
