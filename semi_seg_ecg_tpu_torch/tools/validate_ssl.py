"""Semi-supervised convergence on synthetic data, held against the JAX
package's recorded results (the port of ``tools/validate_ssl.py``).

    python -m semi_seg_ecg_tpu_torch.tools.validate_ssl \
        [--algorithms base fixmatch ...] [--seeds 0 1 2] [--epochs 25] \
        [--device cuda] [--root DIR]

Each algorithm trains ResNet18 + FCN head in bf16 (AdamW at 1e-3, warmup
3, 25 epochs) on the JAX tool's low-label split: 8 labeled, 96 unlabeled,
16 valid and 32 test records of 2,500 samples from
``make_synthetic_dataset`` with dataset seed 11. The test pass scores the
best-MeanIoU checkpoint on the test split.

The JAX column is BASELINE.md:170-177 ("this framework"), measured at
global batch 4 (FixMatch at 8: BASELINE.md:184-192), which one process
runs here with the same BatchNorm statistics. The tolerance was set
before the first run on the card: |mean - JAX| <= max(0.02, 2 sigma_JAX)
for the rows with three JAX seeds (base, FixMatch, Mean Teacher), and
<= 0.02 for the single-seed rows (CPS, ReCo, ST++).

Every run prints one line of JSON; the last line holds, per algorithm,
the mean, std and per-seed MeanIoU, the JAX value and ``within``. The exit
code is 1 when a row lies outside its tolerance.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

ALGORITHMS = ("base", "fixmatch", "mean_teacher", "cps", "reco", "stpp")

# test MeanIoU of the JAX package, mean and std over seeds 0-2 (None: one
# seed), BASELINE.md:170-177
JAX_MIOU = {"base": (0.7119, 0.0178), "fixmatch": (0.7556, 0.0005),
            "mean_teacher": (0.7637, 0.0051), "cps": (0.7505, None),
            "reco": (0.7297, None), "stpp": (0.7524, None)}
MIN_TOL = 0.02

# the global batch of the JAX rows; 4 for the others
GLOBAL_BATCH = {"fixmatch": 8}

SPLIT = (8, 96, 16, 32)   # labeled, unlabeled, valid, test records
LENGTH = 2500
DATA_SEED = 11

# the flagship pipeline of ``tools/gen_configs.py``
STRONG_AUG = [
    {"RandAugment": {
        "ops": [
            {"AmplitudeScaling": {"sigma": 0.5}},
            {"AdaptivePowerlineNoise": {"fs": 250}},
            {"RandomPartialWhiteNoise": {"amplitude": 1, "ratio": 0.5}},
            {"RandomPartialSineNoise": {"amplitude": 1, "ratio": 0.5}},
        ],
        "level": 10,
        "num_layers": 3,
        "prob": 0.5,
    }},
]


def flagship_data_recipe(length: int = 2500) -> dict:
    """The FixMatch flagship pipeline blocks (filter / weak / strong /
    transforms), a copy of ``tools/gen_configs.flagship_data_recipe``."""
    return {
        "filter": [
            {"highpass_filter": {"fs": 250, "cutoff": 0.67}},
            {"lowpass_filter": {"fs": 250, "cutoff": 40}},
        ],
        "augmentations": [
            {"random_resize_crop": {"target_length": length,
                                    "scale_min": 0.5, "scale_max": 2.0}},
        ],
        "strong_augmentations": STRONG_AUG,
        "transforms": [
            {"standardize": {"axis": [-1, -2]}},
            {"to_tensor": {"dtype": "float"}},
        ],
    }


def cfg(algo, exp, root, data, epochs, seed=0, device="cuda"):
    """The JAX tool's config, key for key, on ``device``."""
    from ..config import normalize_config

    d = {
        "seed": seed, "output_dir": os.path.join(root, "exps"),
        "exp_name": exp, "resume": None, "start_epoch": 0, "device": device,
        "use_amp": True, "algorithm": algo, "mode": "scratch",
        "pretrained_backbone": None,
        "backbone": {"resnet18": {
            "num_leads": 1, "num_stages": 4, "out_indices": [0, 1, 2, 3],
            "dilations": [1, 1, 1, 1], "strides": [1, 2, 2, 2],
            "deep_stem": False, "avg_down": False,
            "contract_dilation": False}},
        "decode_head": {"FCNHead": {
            "in_channels": 512, "in_index": 3, "channels": 128,
            "num_convs": 1, "concat_input": False, "dropout_ratio": 0.1,
            "num_classes": 4, "align_corners": False}},
        "dataset": {**data, **flagship_data_recipe(2500)},
        "dataloader": {"batch_size": 4, "num_workers": 8,
                       "pin_memory": False},
        "train": {
            "epochs": epochs, "accum_iter": 1, "warmup_epochs": 3,
            "min_lr": 1e-4, "blr": None, "lr": 1e-3, "weight_decay": 0.05,
            "max_norm": None, "layer_decay": None, "optimizer": "adamw",
            "optimizer_kwargs": {"betas": [0.9, 0.999]},
            "conf_thresh": 0.80, "ema_decay": 0.99},
        "metric": {"task": "segmentation", "num_classes": 4,
                   "include_background": True, "per_class": False,
                   "input_format": "one-hot", "target_metrics": ["MeanIoU"]},
        "test": {"target_metric": "MeanIoU"},
    }
    if algo == "reco":
        d["use_latent_projection"] = True
        d["projection_in_dim"] = 512
        d["projection_out_dim"] = 128
        d["train"].update(eash_conf_thresh=0.65, hard_conf_thresh=0.80,
                          contr_temp=0.25, contr_num_queries=64,
                          contr_num_negatives=128)
    return normalize_config(d)


def make_split(root: str, split=SPLIT) -> Dict[str, str]:
    """The JAX tool's synthetic split under ``root``; its dataset config."""
    from ..data.synthetic import make_synthetic_dataset

    labeled, unlabeled, valid, test = split
    return make_synthetic_dataset(
        root, num_train_labeled=labeled, num_train_unlabeled=unlabeled,
        num_valid=valid, num_test=test, length=LENGTH, seed=DATA_SEED)


def tolerance(algo: str) -> float:
    std = JAX_MIOU[algo][1]
    return MIN_TOL if std is None else max(MIN_TOL, 2 * std)


def summarize(per_seed: Dict[str, List[float]]) -> Dict[str, dict]:
    """Per algorithm: the mean, std and seeds of the port, the JAX value
    and whether the mean lies within the tolerance of it."""
    rows = {}
    for algo, values in per_seed.items():
        mean = float(np.mean(values))
        jax_mean, jax_std = JAX_MIOU[algo]
        rows[algo] = {"mean": mean, "std": float(np.std(values)),
                      "seeds": values, "jax_mean": jax_mean,
                      "jax_std": jax_std, "tol": tolerance(algo),
                      "within": abs(mean - jax_mean) <= tolerance(algo)}
    return rows


def run(algo: str, seed: int, root: str, data: Dict[str, str],
        epochs: int, device: str) -> dict:
    """Train and test one algorithm at one seed; its line of JSON."""
    from ..algorithms import get_algorithm

    c = cfg(algo, f"ssl_{algo}_s{seed}", root, data, epochs, seed=seed,
            device=device)
    c["dataloader"]["batch_size"] = GLOBAL_BATCH.get(algo, 4)
    t0 = time.time()
    get_algorithm(algo).train(c)
    metrics = get_algorithm(algo).test(c)
    return {"algorithm": algo, "seed": seed,
            "MeanIoU": float(metrics["MeanIoU"]),
            "batch_size": c["dataloader"]["batch_size"],
            "wall_s": time.time() - t0,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def device_name(device: str) -> str:
    import torch

    if device == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(0)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--algorithms", nargs="+", default=list(ALGORITHMS),
                    choices=ALGORITHMS)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--root", default=None,
                    help="directory for the split and the runs (default: a "
                         "new temporary one)")
    ap.add_argument("--split", type=int, nargs=4, default=list(SPLIT),
                    metavar=("LABELED", "UNLABELED", "VALID", "TEST"),
                    help="record counts (default: the JAX tool's)")
    args = ap.parse_args(argv)

    root = args.root or tempfile.mkdtemp(prefix="ssl_validate_")
    os.makedirs(root, exist_ok=True)
    data = make_split(root, args.split)
    per_seed: Dict[str, List[float]] = {}
    for algo in args.algorithms:
        per_seed[algo] = []
        for seed in args.seeds:
            line = run(algo, seed, root, data, args.epochs, args.device)
            per_seed[algo].append(line["MeanIoU"])
            print(json.dumps(line), flush=True)
    rows = summarize(per_seed)
    print(json.dumps({"device": device_name(args.device),
                      "epochs": args.epochs, "split": args.split,
                      "rows": rows}), flush=True)
    return 0 if all(r["within"] for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
