"""The real-data on-ramp, rehearsed end to end in LUDB's actual format (the
port of ``tools/rehearse_wfdb.py``).

    python -m semi_seg_ecg_tpu_torch.tools.rehearse_wfdb [--root DIR] \\
        [--epochs 8] [--records 24] [--algorithm fixmatch] [--seed 0] \\
        [--device cuda]

One command drives the whole raw-data path:

  WFDB records (formats 16 and 212, 500 Hz, boundary annotations per lead:
  ``data/synthetic.make_synthetic_wfdb``)
    → ``tools/prepare_data.py`` (the pkl/CSV layout)
    → ``cli.train_main`` (the flagship ResNet18 recipe at signal_length
      2,500: the 10 s records at 500 Hz resample to 250 Hz, as real LUDB
      does; its test pass runs after training)
    → ``cli.test_main`` (the best-MeanIoU checkpoint → test_metrics.csv)
    → ``cli.infer_longrec_main`` (a RAW ``.hea`` record at its own 500 Hz,
      ``--model-fs 250``, ``--intervals``, ``--eval-labels``)
    → ``ops/delineation.delineation_metrics`` on the record's labels.

Prints one ``RESULT {json}`` line (test MeanIoU, the long record's overall
boundary sensitivity and PPV, records, epochs, fs, algorithm) and exits
nonzero on a broken stage. ``--device`` is the config's ``device:``:
``cuda`` (the default) raises where there is no card, ``cpu`` is a
rehearsal of the rehearsal.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import yaml


def build_config(root, data_dir, epochs, algorithm="fixmatch", seed=0,
                 length=2500, batch_size=4, device="cuda"):
    """The shipped flagship recipe over the prepared LUDB-format tree, on
    ``device``."""
    from .flagship import flagship_data_recipe

    return {
        "seed": seed, "output_dir": os.path.join(root, "exps"),
        "exp_name": f"rehearse_{algorithm}", "resume": None,
        "start_epoch": 0, "device": device, "use_amp": True,
        "algorithm": algorithm, "mode": "scratch",
        "pretrained_backbone": None,
        "backbone": {"resnet18": {"num_leads": 1, "num_stages": 4,
            "out_indices": [0, 1, 2, 3], "dilations": [1, 1, 1, 1],
            "strides": [1, 2, 2, 2], "deep_stem": False, "avg_down": False,
            "contract_dilation": False}},
        "decode_head": {"FCNHead": {"in_channels": 512, "in_index": 3,
            "channels": 128, "num_convs": 1, "concat_input": False,
            "dropout_ratio": 0.1, "num_classes": 4, "align_corners": False}},
        "dataset": {
            "ecg_dir": os.path.join(data_dir, "ecg"),
            "label_dir": os.path.join(data_dir, "label"),
            "index_dir": os.path.join(data_dir, "index"),
            "train_labeled_csv": "LUDB_train_labeled.csv",
            "train_unlabeled_csv": "LUDB_train_unlabeled.csv",
            "valid_csv": "LUDB_valid.csv", "test_csv": "LUDB_test.csv",
            "filename_col": "waveform", "label_filename_col": "label",
            "signal_length": length,
            **flagship_data_recipe(length),
        },
        "dataloader": {"batch_size": batch_size, "num_workers": 0,
                       "pin_memory": False},
        "train": {"epochs": epochs, "accum_iter": 1, "warmup_epochs": 1,
            "min_lr": 1e-4, "blr": None, "lr": 1e-3, "weight_decay": 0.05,
            "max_norm": None, "layer_decay": None, "optimizer": "adamw",
            "optimizer_kwargs": {"betas": [0.9, 0.999]},
            "conf_thresh": 0.80},
        "metric": {"task": "segmentation", "num_classes": 4,
            "include_background": True, "per_class": False,
            "input_format": "one-hot", "target_metrics": ["MeanIoU"]},
        "test": {"target_metric": "MeanIoU"},
    }


def rehearse(root, epochs=8, num_records=24, fs=500, seconds=10.0,
             algorithm="fixmatch", seed=0, batch_size=4, device="cuda",
             stage_seconds: Optional[Dict[str, float]] = None):
    """Run every stage under ``root``; returns the summary dict (raises on
    failure). ``stage_seconds``, where given, receives each stage's host
    seconds (``wfdb``, ``prepare``, ``train``, ``test``, ``longrec``,
    ``score``)."""
    from .. import cli
    from ..config import normalize_config, resolve_device
    from ..data.synthetic import make_synthetic_wfdb
    from ..ops.delineation import delineation_metrics
    from . import prepare_data

    resolve_device(normalize_config({"device": device}))
    times = {} if stage_seconds is None else stage_seconds
    clock = [time.perf_counter()]

    def lap(stage):
        now = time.perf_counter()
        times[stage] = now - clock[0]
        clock[0] = now

    raw_dir = os.path.join(root, "raw")
    data_dir = os.path.join(root, "prepared")
    wf = make_synthetic_wfdb(raw_dir, num_records=num_records, fs=fs,
                             seconds=seconds, seed=seed)
    lap("wfdb")

    # 1. raw WFDB → pkl/CSV tree
    prepare_data.main([
        "--records_dir", raw_dir, "--out_dir", data_dir,
        "--ann_ext", wf["ann_ext"], "--labeled_ratio", "0.5",
        "--splits", "0.67,0.17,0.16", "--seed", str(seed),
        "--prefix", "LUDB"])
    lap("prepare")

    # 2-3. train + test through the CLI entries
    model_fs = 250.0  # signal_length 2500 over 10 s records
    length = int(round(model_fs * seconds))
    config = build_config(root, data_dir, epochs, algorithm=algorithm,
                          seed=seed, length=length, batch_size=batch_size,
                          device=device)
    cfg_path = os.path.join(root, "rehearse.yaml")
    with open(cfg_path, "w") as f:
        yaml.dump(config, f)
    cli.train_main(["-f", cfg_path])
    exp = os.path.join(config["output_dir"], config["exp_name"])
    if not os.path.exists(os.path.join(exp, "best-MeanIoU.ckpt")):
        raise RuntimeError(f"train wrote no {exp}/best-MeanIoU.ckpt")
    lap("train")
    cli.test_main(["-f", cfg_path])
    csv = os.path.join(exp, "test_metrics.csv")
    if not os.path.exists(csv):
        raise RuntimeError(f"test wrote no {csv}")
    import pandas as pd

    test_miou = float(pd.read_csv(csv)["MeanIoU"].iloc[0])
    lap("test")

    # 4. segment one RAW record at its native rate; score the boundaries
    rec = wf["record_names"][-1]
    truth_path = os.path.join(root, f"{rec}_truth.npy")
    np.save(truth_path, wf["masks"][rec].astype(np.int64))
    infer_dir = os.path.join(root, "longrec_out")
    cli.infer_longrec_main([
        "-f", cfg_path, "--record", os.path.join(raw_dir, rec + ".hea"),
        "--model-fs", str(model_fs), "--out-dir", infer_dir,
        "--intervals", "--eval-labels", truth_path,
        "--batch", "8"])
    labels = np.load(os.path.join(infer_dir, "labels.npy"))
    if labels.shape[0] != int(round(fs * seconds)):
        raise RuntimeError(f"labels.npy has shape {labels.shape}, not the "
                           f"record's {int(round(fs * seconds))} samples")
    if not os.path.exists(os.path.join(infer_dir, "intervals.csv")):
        raise RuntimeError(f"infer-longrec wrote no {infer_dir}/"
                           "intervals.csv")
    lap("longrec")
    # the same scoring the CLI just printed, kept for the summary
    m = delineation_metrics(labels, wf["masks"][rec], fs=fs,
                            tolerance_ms=150.0,
                            min_duration=max(1, int(round(0.02 * fs))))
    lap("score")
    return {"test_MeanIoU": round(test_miou, 4),
            "longrec_overall_sensitivity":
                round(m["overall"]["sensitivity"], 4),
            "longrec_overall_ppv": round(m["overall"]["ppv"], 4),
            "records": num_records, "epochs": epochs, "fs": fs,
            "algorithm": algorithm}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="working dir (default: a fresh temp dir)")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--records", type=int, default=24)
    ap.add_argument("--algorithm", default="fixmatch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the runs' device (default: the card; raises "
                         "without one)")
    args = ap.parse_args(argv)

    root = args.root or tempfile.mkdtemp(prefix="wfdb_rehearsal_")
    os.makedirs(root, exist_ok=True)
    summary = rehearse(root, epochs=args.epochs, num_records=args.records,
                       algorithm=args.algorithm, seed=args.seed,
                       device=args.device)
    print("RESULT", json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
