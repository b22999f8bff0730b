"""The ViT row of BASELINE.md:231-236 on the port: supervised against
FixMatch on ``tools/validate_ssl``'s low-label split.

    python -m semi_seg_ecg_tpu_torch.tools.vit_row [--seeds 0 1 2] \
        [--epochs 12] [--device cuda] [--root DIR]

Each run is ``cli.train_main`` on the shipped recipe
(``configs/base/vit_tiny/{scratch,fixmatch}.yaml`` of this checkout) with
BASELINE.md's overrides, ``train.layer_decay: 0.75`` and 12 epochs, the
split and the global batch of ``validate_ssl`` (4, FixMatch 8), and its
test pass on the best-MeanIoU checkpoint. The recipe keeps its own
backbone (2,500 samples in patches of 25): BASELINE.md's row ran 512
samples in patches of 16, on a recipe the repo does not hold, so this
row is a sanity check, not a parity gate. Its JAX values are carried for
comparison only; the check is that FixMatch beats supervised by at least
``MIN_GAIN``.

Every run prints one line of JSON; the last line holds, per algorithm,
the mean, std and per-seed MeanIoU, BASELINE.md's value and the gain. The
exit code is 1 when FixMatch's gain is below ``MIN_GAIN``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import yaml

from . import validate_ssl

RECIPES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "base", "vit_tiny")
ALGORITHMS = {"base": "scratch", "fixmatch": "fixmatch"}
# BASELINE.md:231-236, mean and std over seeds 0-2 (2-device CPU mesh)
BASELINE_MIOU = {"base": (0.329, 0.025), "fixmatch": (0.537, 0.007)}
LAYER_DECAY, EPOCHS = 0.75, 12
MIN_GAIN = 0.10


def write_config(algo, root, data, seed, epochs, device, recipes=RECIPES):
    """The shipped recipe with the row's overrides, as a YAML file."""
    from ..config import load_config

    cfg = load_config(os.path.join(recipes, f"{ALGORITHMS[algo]}.yaml"))
    cfg["dataset"].update(data)
    cfg["train"].update(layer_decay=LAYER_DECAY, epochs=epochs)
    cfg["dataloader"]["batch_size"] = validate_ssl.GLOBAL_BATCH.get(algo, 4)
    cfg.update(seed=seed, device=device, exp_name=f"vit_{algo}_s{seed}",
               output_dir=os.path.join(root, "exps"),
               test={"target_metric": "MeanIoU"})
    path = os.path.join(root, f"vit_{algo}_s{seed}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def main(argv: Optional[List[str]] = None) -> int:
    from ..cli import train_main

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--root", default=None)
    ap.add_argument("--split", type=int, nargs=4,
                    default=list(validate_ssl.SPLIT))
    args = ap.parse_args(argv)

    root = args.root or tempfile.mkdtemp(prefix="vit_row_")
    os.makedirs(root, exist_ok=True)
    data = validate_ssl.make_split(root, args.split)
    per_seed = {}
    for algo in ALGORITHMS:
        per_seed[algo] = []
        for seed in args.seeds:
            path = write_config(algo, root, data, seed, args.epochs,
                                args.device)
            miou = float(train_main(["-f", path])["MeanIoU"])
            per_seed[algo].append(miou)
            print(json.dumps({"algorithm": algo, "seed": seed,
                              "MeanIoU": miou}), flush=True)
    rows = {algo: {"mean": float(np.mean(v)), "std": float(np.std(v)),
                   "seeds": v, "baseline": BASELINE_MIOU[algo]}
            for algo, v in per_seed.items()}
    gain = rows["fixmatch"]["mean"] - rows["base"]["mean"]
    print(json.dumps({"device": validate_ssl.device_name(args.device),
                      "epochs": args.epochs, "rows": rows, "gain": gain,
                      "min_gain": MIN_GAIN}), flush=True)
    return 0 if gain >= MIN_GAIN else 1


if __name__ == "__main__":
    sys.exit(main())
