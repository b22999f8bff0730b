"""Synthetic ECG fixture generator.

The reference framework ships no test data (datasets are downloaded
externally, README.md:46-65), so tests and benchmarks here synthesise
LUDB-shaped data: single-lead quasi-periodic waveforms of ``(T,)`` float64
with aligned 4-class delineation labels (0=background, 1=P, 2=QRS, 3=T),
written as the same ``.pkl``-per-record + index-CSV layout the real datasets
use (semi_dataset.py:50-57 contract).
"""

from __future__ import annotations

import os
import pickle as pkl
from typing import Dict

import numpy as np
import pandas as pd


def synth_ecg(rng: np.random.Generator, length: int = 2500, fs: int = 250):
    """One synthetic beat train: returns (waveform (T,), labels (T,))."""
    x = 0.05 * rng.standard_normal(length)
    y = np.zeros(length, dtype=np.int64)
    t = np.arange(length)
    # slow baseline wander
    x += 0.1 * np.sin(2 * np.pi * t / length * rng.uniform(1, 3))
    beat_period = int(fs * rng.uniform(0.7, 1.1))  # 55-85 bpm
    pos = int(rng.integers(0, beat_period))
    while pos + beat_period < length:
        # P wave: small gaussian bump
        p_center = pos + int(0.15 * beat_period)
        p_width = max(int(0.04 * fs), 3)
        # QRS: sharp spike
        q_center = pos + int(0.30 * beat_period)
        q_width = max(int(0.02 * fs), 2)
        # T wave: wide bump
        t_center = pos + int(0.55 * beat_period)
        t_width = max(int(0.08 * fs), 4)
        for center, width, amp, cls in (
            (p_center, p_width, 0.15, 1),
            (q_center, q_width, 1.0, 2),
            (t_center, t_width, 0.3, 3),
        ):
            lo = max(center - 2 * width, 0)
            hi = min(center + 2 * width, length)
            span = np.arange(lo, hi)
            x[lo:hi] += amp * np.exp(-0.5 * ((span - center) / width) ** 2)
            y[lo:hi] = cls
        pos += beat_period
    return x, y


def make_synthetic_dataset(
    root: str,
    num_train_labeled: int = 8,
    num_train_unlabeled: int = 16,
    num_valid: int = 4,
    num_test: int = 4,
    length: int = 2500,
    fs: int = 250,
    seed: int = 0,
    varied_fs: bool = False,
) -> Dict[str, str]:
    """Write a complete synthetic dataset tree under ``root``.

    Layout mirrors the bench configs (configs/bench/ludb/1over16.yaml:3-10):
    ``{root}/ecg/*.pkl``, ``{root}/label/*.pkl``, ``{root}/index/*.csv``.
    Returns the dataset-config fragment to splice into a training config.
    """
    rng = np.random.default_rng(seed)
    ecg_dir = os.path.join(root, "ecg")
    label_dir = os.path.join(root, "label")
    index_dir = os.path.join(root, "index")
    for d in (ecg_dir, label_dir, index_dir):
        os.makedirs(d, exist_ok=True)

    def write_split(name: str, count: int, labeled: bool) -> str:
        rows = []
        for i in range(count):
            this_fs = int(rng.choice([250, 500])) if varied_fs else fs
            this_len = length * this_fs // fs
            x, y = synth_ecg(rng, this_len, this_fs)
            fname = f"{name}_{i}.pkl"
            with open(os.path.join(ecg_dir, fname), "wb") as f:
                pkl.dump(x, f)
            row = {"waveform": fname}
            if labeled:
                lname = f"{name}_{i}_label.pkl"
                with open(os.path.join(label_dir, lname), "wb") as f:
                    pkl.dump(y, f)
                row["label"] = lname
            if varied_fs:
                row["fs"] = this_fs
            rows.append(row)
        csv_name = f"{name}.csv"
        pd.DataFrame(rows).to_csv(os.path.join(index_dir, csv_name), index=False)
        return csv_name

    cfg = {
        "ecg_dir": ecg_dir,
        "label_dir": label_dir,
        "index_dir": index_dir,
        "train_labeled_csv": write_split("train_labeled", num_train_labeled, True),
        "train_unlabeled_csv": write_split(
            "train_unlabeled", num_train_unlabeled, False
        ),
        "valid_csv": write_split("valid", num_valid, True),
        "test_csv": write_split("test", num_test, True),
        "filename_col": "waveform",
        "label_filename_col": "label",
        "signal_length": length,
    }
    if varied_fs:
        cfg["fs_col"] = "fs"
        cfg["fs"] = fs
        cfg.pop("signal_length")
    return cfg

