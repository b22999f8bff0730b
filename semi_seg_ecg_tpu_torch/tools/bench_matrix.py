"""One train step's time across backbones and algorithms (the port of
``tools/bench_matrix.py``).

    python -m semi_seg_ecg_tpu_torch.tools.bench_matrix [--steps 50] [--device cpu]

For ``resnet18``, ``resnet50``, ``vit_tiny`` and ``vit_base`` at full
width (``tools/flagship.MODELS``, length 2,500, patch 25 for the ViTs,
whose N = 101 keeps ``attention_impl: auto`` on the dense path), each under
``base`` (supervised) and ``fixmatch``: the eager bf16 step at batch 16,
after ten warm-up steps, timed with a synchronized host clock in three
trials of ``--steps`` steps (the best, as the JAX tool takes). Prints a
table and one JSON line; on the CPU every time and rate is null.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import bench
from .device_profile import device_identity, on_card, tool_device, trial_ms
from .flagship import MODELS

ALGORITHMS = ("base", "fixmatch")
WARMUP = 10


def bench_one(model: str, algorithm: str, device, batch: int = 16,
              steps: int = 50, length: int = 2500):
    _, trainer, data = bench.build(1, batch, device, model, algorithm, length)
    if algorithm == "base":
        data = {k: data[k] for k in ("ecg", "target")}
    step = lambda: trainer.train_step(data)  # noqa: E731
    timed = trial_ms(step, steps, device, trials=bench.TRIALS,
                     warmup=WARMUP)
    ms = on_card(device, min(timed["trials_ms"]))
    return {"model": model, "algorithm": algorithm, "batch": batch,
            "ms_per_step": ms,
            "samples_per_sec": batch / ms * 1e3 if ms else None,
            "final_loss": float(trainer.train_step(data)["loss"])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--length", type=int, default=2500)
    args = p.parse_args(argv)
    dev = tool_device(args.device)
    rows = []
    print(f"{'model':10s} {'algorithm':10s} {'ms/step':>9s} "
          f"{'samples/s':>11s}", file=sys.stderr)
    for model in MODELS:
        for algorithm in ALGORITHMS:
            row = bench_one(model, algorithm, dev, args.batch, args.steps,
                            args.length)
            rows.append(row)
            print(f"{model:10s} {algorithm:10s} {row['ms_per_step']} "
                  f"{row['samples_per_sec']}", file=sys.stderr, flush=True)
    print(json.dumps({"metric": "train_step_matrix",
                      "device": device_identity(dev), "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
