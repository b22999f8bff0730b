"""Whole-system training throughput: loader, host-to-device copies, train
steps (the port of ``tools/bench_e2e.py``).

    python -m semi_seg_ecg_tpu_torch.tools.bench_e2e \\
        [--modes host,device,device+scan,cache,cache+scan] [--records 512] \\
        [--epochs 8] [--warm 2] [--scan-steps 8] [--device cpu]

``tools/bench.py`` times the step on a resident batch; this tool times
what a user sees: FixMatch trained through ``run_training`` on a synthetic
LUDB-shaped split (``data/synthetic.make_synthetic_dataset``: 64
labeled records, ``--records`` unlabeled, 8 valid, 8 test, 2,500 samples)
with the flagship recipe (``tools/flagship``: ResNet18-1D, bf16, batch 16,
the flagship data pipeline), in each input-path mode:

- ``host``: host augmentation, the reference's path;
- ``device``: ``dataset.device_augment`` (the raw batch shipped, the views
  built on the card: the gather kernel);
- ``device+scan``: and ``train.scan_steps`` (the captured step);
- ``cache``: and ``dataset.device_cache`` (the split on the card, the
  steps ship indices);
- ``cache+scan``: both.

One training of ``--epochs`` epochs a mode, no checkpoints; each epoch's
train loop (``algorithms/common._train_one_epoch``: loader, copies, steps;
not the validation) is timed on the host clock, ending in a synchronize,
and the steady state is the median of the epochs after the first
``--warm`` (the kernels' build, the capture and the cache's fill land in
epoch 0). Prints one JSON line a mode and a last one with every mode's
samples/s; on the CPU every time and rate is null.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

from ..algorithms import common, get_algorithm
from ..data.synthetic import make_synthetic_dataset
from ..ops import gather1d
from .device_profile import device_identity, on_card, synchronize, tool_device
from .flagship import flagship_config, flagship_data_recipe

MODES = ("host", "device", "device+scan", "cache", "cache+scan")
BATCH = 16
WORKERS = 8  # the loaders' worker processes


def make_config(data_cfg, mode: str, epochs: int, length: int,
                scan_steps: int, device: str):
    config = flagship_config(length, BATCH, device)
    config.update({"output_dir": None, "exp_name": f"bench_{mode}",
                   "use_amp": True, "pretrained_backbone": None,
                   "test": {"target_metric": "MeanIoU"}})
    config["dataset"] = {**data_cfg, "signal_length": length,
                         "device_augment": mode != "host",
                         "device_cache": mode.startswith("cache"),
                         **flagship_data_recipe(length)}
    config["dataloader"] = {"batch_size": BATCH, "num_workers": WORKERS}
    config["train"].update(epochs=epochs, warmup_epochs=0,
                           scan_steps=scan_steps if mode.endswith("scan")
                           else 1)
    config["metric"].update(include_background=True, per_class=False,
                            input_format="one-hot")
    return config


@contextlib.contextmanager
def timed_epochs(device):
    """Inside, each epoch's train loop is timed: yields a list that gets
    ``(seconds, steps)`` an epoch."""
    epochs = []
    orig = common._train_one_epoch

    def timed(trainer, *args, **kwargs):
        step0 = trainer.step
        t0 = time.perf_counter()
        out = orig(trainer, *args, **kwargs)
        synchronize(device)
        epochs.append((time.perf_counter() - t0, trainer.step - step0))
        return out

    common._train_one_epoch = timed
    try:
        yield epochs
    finally:
        common._train_one_epoch = orig


def run_mode(data_cfg, mode: str, args, dev):
    config = make_config(data_cfg, mode, args.epochs, args.length,
                         args.scan_steps, dev.type)
    gathers = gather1d.LAUNCHES
    with timed_epochs(dev) as epochs:
        get_algorithm("fixmatch").train(copy.deepcopy(config))
    steady = epochs[args.warm:]
    sec = on_card(dev, statistics.median(s for s, _ in steady)) \
        if steady else None
    steps = steady[0][1] if steady else None
    return {"mode": mode,
            "samples_per_sec": steps * BATCH / sec if sec else None,
            "sec_per_epoch": sec, "steps_per_epoch": steps,
            "epoch_times_s": on_card(dev, [s for s, _ in epochs]),
            "gather_launches": gather1d.LAUNCHES - gathers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--length", type=int, default=2500)
    ap.add_argument("--records", type=int, default=512)
    ap.add_argument("--scan-steps", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=8,
                    help="epochs a mode; the first --warm are left out")
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    bad = [m for m in modes if m not in MODES]
    if bad:
        ap.error(f"unknown modes {bad}: expected some of {MODES}")
    dev = tool_device(args.device)
    root = tempfile.mkdtemp(prefix="bench_e2e_")
    try:
        data_cfg = make_synthetic_dataset(
            os.path.join(root, "data"), num_train_labeled=64,
            num_train_unlabeled=args.records, num_valid=8, num_test=8,
            length=args.length, seed=0)
        rows = []
        for mode in modes:
            rows.append(run_mode(data_cfg, mode, args, dev))
            print(json.dumps(rows[-1]), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"metric": "fixmatch_e2e_samples_per_sec",
                      "results": {r["mode"]: r["samples_per_sec"]
                                  for r in rows},
                      "rows": rows, "records": args.records,
                      "device": device_identity(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
