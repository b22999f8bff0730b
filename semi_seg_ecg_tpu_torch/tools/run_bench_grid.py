"""The benchmark grid's sweep (the port of ``tools/run_bench_grid.py``).

Runs the (backbone × dataset × 1/N label ratio × algorithm) grid of the
paper's experiments and aggregates every cell's test metrics into one
results table, ``{output_dir}/sweep_results.csv`` (columns ``backbone,
algorithm, dataset, ratio`` and the test metrics, ``%.4f``), rewritten
after each cell.

    python -m semi_seg_ecg_tpu_torch.tools.run_bench_grid \\
        --output_dir exps/sweep --backbones resnet18 \\
        --algorithms scratch fixmatch --datasets ludb qtdb --ratios 2 16 \\
        [--epochs 100] [--batch_size 16] [--device cuda]
    python -m semi_seg_ecg_tpu_torch.tools.run_bench_grid --synthetic \\
        --epochs 3                                  # self-contained demo

A cell is ``train -f configs/base/{backbone}/{algo}.yaml -o
configs/bench/{dataset}/1over{ratio}.yaml`` in-process (``cell_config``),
then the test pass on its best checkpoint. ``--synthetic`` puts one
synthetic dataset (16 labeled, 32 unlabeled, 8 valid, 8 test records of
2,500 samples) in place of every cell's. ``--device`` is written into each
cell's ``device:``: ``cuda`` (the default) raises where there is no card,
``cpu`` is a rehearsal. Under ``torchrun`` every cell trains and tests on
the process group, as ``cli.train_main`` does, and rank 0 prints and
writes the table.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import pandas as pd

from ..algorithms import get_algorithm
from ..config import deep_merge, load_config, normalize_config

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cell_config(backbone, algo, dataset, ratio, args, synthetic_data=None):
    """The normalized config of one cell: the base recipe, the bench
    override, then ``args``' output directory, epochs (the warmup cut to a
    tenth of them), batch size and device, and the synthetic dataset."""
    base = os.path.join(REPO, "configs", "base", backbone, f"{algo}.yaml")
    over = os.path.join(REPO, "configs", "bench", dataset,
                        f"1over{ratio}.yaml")
    config = load_config(base, over)
    override = {"output_dir": args.output_dir, "device": args.device}
    if synthetic_data is not None:
        override["dataset"] = dict(synthetic_data)
    if args.epochs:
        override["train"] = {"epochs": args.epochs,
                             "warmup_epochs": min(
                                 config["train"]["warmup_epochs"],
                                 max(args.epochs // 10, 1))}
    if args.batch_size:
        override["dataloader"] = {"batch_size": args.batch_size}
    config = normalize_config(deep_merge(config, override))
    config["exp_name"] = f"{backbone}/{algo}/{dataset}/1over{ratio}"
    return config


def run_cell(backbone, algo, dataset, ratio, args, synthetic_data=None):
    """Train and test one cell: its row of the table, and its train and
    test seconds (host clock; each pass ends with its results on the
    host)."""
    config = cell_config(backbone, algo, dataset, ratio, args,
                         synthetic_data)
    module = get_algorithm(config["algorithm"])
    t0 = time.perf_counter()
    module.train(config)
    t1 = time.perf_counter()
    metrics = module.test(config)
    t2 = time.perf_counter()
    row = {"backbone": backbone, "algorithm": algo, "dataset": dataset,
           "ratio": f"1/{ratio}", **metrics}
    return row, {"train_s": t1 - t0, "test_s": t2 - t1}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--backbones", nargs="+", default=["resnet18"])
    ap.add_argument("--algorithms", nargs="+",
                    default=["scratch", "mean_teacher", "fixmatch", "cps",
                             "reco", "stpp"])
    ap.add_argument("--datasets", nargs="+",
                    default=["ludb", "qtdb", "isp", "zhejiang"])
    ap.add_argument("--ratios", nargs="+", type=int, default=[2, 4, 8, 16])
    ap.add_argument("--epochs", type=int, default=None,
                    help="override recipe epochs (e.g. smoke runs)")
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="substitute a synthetic dataset for every cell "
                         "(self-contained demo / CI)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="every cell's device (default: the card; raises "
                         "without one)")
    return ap.parse_args(argv)


def synthetic_dataset():
    """The demo's dataset in a new temporary directory: its root and its
    dataset config. Under a process group rank 0 writes it and the others
    take both from rank 0."""
    import torch.distributed as dist

    from ..data.synthetic import make_synthetic_dataset
    from ..parallel.dist import is_main_process

    holder = [None]
    if is_main_process():
        root = tempfile.mkdtemp(prefix="bench_grid_")
        holder = [(root, make_synthetic_dataset(
            root, num_train_labeled=16, num_train_unlabeled=32,
            num_valid=8, num_test=8))]
    if dist.is_initialized():
        dist.broadcast_object_list(holder, src=0)
    return holder[0]


def sweep(args):
    """Every cell of ``args``' grid in order (backbone, dataset, ratio,
    algorithm), the table rewritten after each; the rows, each cell's
    seconds and the table's path. Runs on the process group that
    ``torchrun``'s variables describe, which it makes and destroys."""
    from ..cli import _process_group
    from ..config import resolve_device
    from ..parallel.dist import init_distributed_mode, is_main_process
    from ..utils.logging import log

    resolve_device(normalize_config({"device": args.device}))
    with _process_group():
        init_distributed_mode(device=args.device)
        synthetic_data = None
        if args.synthetic:
            root, synthetic_data = synthetic_dataset()
            if args.output_dir is None:
                args.output_dir = os.path.join(root, "exps")
        if not args.output_dir:
            raise SystemExit("--output_dir required for real-data sweeps")
        out_csv = os.path.join(args.output_dir, "sweep_results.csv")
        rows, seconds = [], []
        for backbone in args.backbones:
            for dataset in args.datasets:
                for ratio in args.ratios:
                    for algo in args.algorithms:
                        log(f"=== {backbone} / {algo} / {dataset} "
                            f"1/{ratio} ===")
                        row, secs = run_cell(backbone, algo, dataset, ratio,
                                             args, synthetic_data)
                        rows.append(row)
                        seconds.append(secs)
                        log(f"cell seconds: train {secs['train_s']:.1f}, "
                            f"test {secs['test_s']:.1f}")
                        if is_main_process():
                            os.makedirs(args.output_dir, exist_ok=True)
                            pd.DataFrame(rows).to_csv(
                                out_csv, index=False, float_format="%.4f")
        if is_main_process():
            print(pd.DataFrame(rows).to_string(index=False))
            print(f"results: {out_csv}")
    return rows, seconds, out_csv


def main(argv=None) -> int:
    sweep(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
