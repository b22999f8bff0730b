"""Live-stream capacity: concurrent 250 Hz ECG streams one card keeps up
with through ``serving.StreamingSegmenter`` (the port of
``tools/bench_streams.py``, its per-step mode).

    python -m semi_seg_ecg_tpu_torch.tools.bench_streams [--streams 256] \\
        [--hop 2500] [--int8] [--reps 3] [--device cpu]

The flagship segmentor (seed-0 weights) in a segmenter of S streams: each
step runs the model on one window of every stream, blends the overlap
carry and fetches the ``hop`` samples it finalizes to the host, where
their argmax is taken (the segmenter's latency contract). A live stream
yields a window every ``hop / 250`` s, so the capacity is
S·(hop/250)/step time. Steps are timed with a synchronized host clock, 16
a trial, the median of ``--reps`` trials after a warm step.

The JAX tool's ``--scan`` mode, a ``lax.scan`` over windows with the
carry on the device, is not here: the segmenter's step fetches each
step's probabilities to the host and takes their argmax there, which a
CUDA graph cannot hold, so capturing it would change what a step returns.

Prints one JSON line; on the CPU every time and rate is null.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np

from ..serving import StreamingSegmenter
from .bench_inference import calibration_batches
from .device_profile import device_identity, on_card, tool_device, wall_ms
from .flagship import FS, flagship_config, serving_fn

WINDOW = 2500
STEPS = 16


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--streams", type=int, default=256)
    p.add_argument("--hop", type=int, default=WINDOW)
    p.add_argument("--int8", action="store_true",
                   help="int8 with calibrated static scales")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = tool_device(args.device)
    config = flagship_config(WINDOW, device=dev.type)
    infer = serving_fn(config, dev, "int8" if args.int8 else "fp32",
                       calibration_batches(dev, WINDOW) if args.int8
                       else None)
    seg = StreamingSegmenter(infer, window=WINDOW, hop=args.hop,
                             num_streams=args.streams)
    win = np.random.default_rng(0).standard_normal(
        (args.streams, 1, WINDOW)).astype(np.float32)
    probs, _ = seg._run_window(win)
    trials = [wall_ms(lambda: seg._run_window(win), STEPS, dev)
              for _ in range(args.reps)]
    ms = on_card(dev, statistics.median(trials))
    tick = args.hop / FS  # seconds of signal a step finalizes a stream
    streams = args.streams * tick / (ms / 1e3) if ms else None
    print(json.dumps({
        "metric": "live_stream_capacity",
        "value": streams,
        "unit": "concurrent 250Hz streams/chip (per-step)",
        "streams_batched": args.streams, "hop": args.hop,
        "quantize": "int8-static" if args.int8 else None,
        "ms_per_step_dispatch": ms,
        "ms_per_step_trials": on_card(dev, trials),
        "streams_at_dispatch_rate": streams,
        "probs_finite": bool(np.isfinite(probs).all()),
        "device": device_identity(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
