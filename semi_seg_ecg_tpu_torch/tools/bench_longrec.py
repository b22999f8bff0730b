"""Long-record (Holter-scale) training on one card: measure, don't assert
(the port of ``tools/bench_longrec.py``'s chip modes).

    python -m semi_seg_ecg_tpu_torch.tools.bench_longrec --mode card \\
        [--t 65536] [--steps 3] [--batch 2] [--depth 4] [--width 192] \\
        [--device cpu]
    python -m semi_seg_ecg_tpu_torch.tools.bench_longrec --mode mem [...]

- ``--mode card`` (the JAX tool's ``--mode tpu``): one process trains a
  supervised bf16 ViT + FCN head (``algorithm: base``) at T = 65,536
  samples in patches of 16 (N = 4,097 tokens with the cls token), depth 4,
  width 192, 3 heads of 64, batch 2, with remat and ``attention_impl:
  auto``, which takes the flash kernels from N >= 512 on the card
  (``models/backbones/vision_transformer.py``). It reports the first
  step's seconds (the kernels' build among them), the median ms a step of
  the rest, the peak of the run's device memory over them and the flash
  launches a step: a forward a block, again in the block's recompute, and
  a backward a block (8 / 4 at depth 4).
- ``--mode mem``: the peak device memory and ms of the same step at
  ``seq_parallel`` 1 with flash (``auto``) against dense attention
  (``xla``): what the kernels' O(N) memory buys on one card.

The JAX tool's CPU-mesh modes are not ported: ``--parity`` holds the ring
on an 8-device virtual CPU mesh against one device, and ``--crossover``
reads XLA's compiled ``memory_analysis`` of a step never run. The port
has neither a virtual device mesh nor a compiler's memory model; its
seq-axis tests (``tests/test_torch_seq_parallel.py``) already hold the
ring's ranks against one process, and ``--mode mem`` measures the
memory of real steps.

Prints one JSON line; on the CPU every time and memory is null.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from ..config import normalize_config
from .device_profile import (
    allocated_bytes,
    device_identity,
    launch_counts,
    on_card,
    peak_mb,
    synchronize,
    tool_device,
)
from .flagship import build_trainer

PATCH = 16


def make_config(t: int, impl: str, *, depth: int, width: int, heads: int,
                dim_head: int, mlp_dim: int, batch: int, remat: bool,
                precision: str, device: str) -> Dict[str, Any]:
    """The supervised ViT + FCN recipe at signal length ``t`` (the JAX
    tool's ``make_config`` at seq_parallel 1)."""
    return normalize_config({
        "device": device, "seed": 0, "algorithm": "base", "mode": "scratch",
        "use_amp": precision != "fp32", "precision": precision,
        "dataset": {"signal_length": t},
        "backbone": {"vit_tiny": {
            "seq_len": t, "patch_size": PATCH, "num_leads": 1,
            "fp16_enabled": precision != "fp32", "width": width,
            "depth": depth, "heads": heads, "dim_head": dim_head,
            "mlp_dim": mlp_dim, "attention_impl": impl, "remat": remat,
            "out_indices": [depth - 1]}},
        "decode_head": {"FCNHead": {
            "in_channels": width, "in_index": 0, "channels": 32,
            "num_convs": 1, "concat_input": False, "dropout_ratio": 0.0,
            "num_classes": 4, "align_corners": False}},
        "train": {"epochs": 2, "accum_iter": 1, "warmup_epochs": 0,
                  "min_lr": 1e-4, "blr": None, "lr": 1e-3,
                  "weight_decay": 0.05, "max_norm": None,
                  "layer_decay": None, "optimizer": "adamw",
                  "optimizer_kwargs": {"betas": [0.9, 0.999]}},
        "dataloader": {"batch_size": batch},
        "parallel": {"model_parallel": 1, "seq_parallel": 1},
    })


def long_batch(t: int, n: int, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"ecg": torch.from_numpy(rng.standard_normal(
                (n, 1, t)).astype(np.float32)).to(device),
            "target": torch.from_numpy(rng.integers(0, 4, (n, t))).to(
                device)}


def run_steps(args, impl: str, remat: bool, dev) -> Dict[str, Any]:
    """The first step, then ``args.steps`` timed ones: ms, the peak of the
    run's device memory (the trainer's and the steps', not what the
    process held before), launches a step, losses."""
    held = allocated_bytes(dev)
    cfg = make_config(args.t, impl, depth=args.depth, width=args.width,
                      heads=args.heads, dim_head=args.dim_head,
                      mlp_dim=args.mlp_dim, batch=args.batch, remat=remat,
                      precision="bf16", device=dev.type)
    trainer = build_trainer(cfg, dev, 10)
    batch = long_batch(args.t, args.batch, dev)
    t0 = time.perf_counter()
    first = float(trainer.train_step(batch)["loss"])
    first_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    times, loss = [], first
    for _ in range(args.steps):
        synchronize(dev)
        t0 = time.perf_counter()
        loss = float(trainer.train_step(batch)["loss"])  # syncs
        times.append(time.perf_counter() - t0)
    after = launch_counts()
    ms = on_card(dev, statistics.median(times) * 1e3)
    return {"impl": impl, "remat": remat, "ms_per_step": ms,
            "first_step_s": on_card(dev, first_s),
            "peak_memory_mb": peak_mb(dev, held),
            "launches_per_step": {k: (after[k] - before[k]) / args.steps
                                  for k in after},
            "first_loss": first, "final_loss": loss}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=["card", "mem"], default="card")
    p.add_argument("--t", type=int, default=65536)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--width", type=int, default=192)
    p.add_argument("--heads", type=int, default=3)
    p.add_argument("--dim-head", type=int, default=64)
    p.add_argument("--mlp-dim", type=int, default=768)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = tool_device(args.device)
    shape = {"t": args.t, "tokens": args.t // PATCH + 1,
             "batch": args.batch, "depth": args.depth, "width": args.width,
             "heads": args.heads, "dim_head": args.dim_head}
    if args.mode == "card":
        out = {"mode": "card", **shape, **run_steps(args, "auto", True, dev)}
    else:
        rows = [run_steps(args, impl, False, dev) for impl in ("auto",
                                                               "xla")]
        out = {"mode": "mem", **shape, "rows": rows}
    out["device"] = device_identity(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
