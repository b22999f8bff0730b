"""WFDB → pkl/CSV dataset preparation (the port of
``tools/prepare_data.py``, output for output the same files).

    python -m semi_seg_ecg_tpu_torch.tools.prepare_data --records_dir DIR \\
        --out_dir DIR [--lead 0] [--ann_ext atr] [--symbol_map p=1,N=2,t=3] \\
        [--splits 0.7,0.15,0.15] [--labeled_ratio 1.0] [--seed 0] \\
        [--prefix DATA]

Given a directory of WFDB records with delineation annotations, writes
``{out}/ecg/*.pkl`` (the lead's physical signal, float64),
``{out}/label/*_label.pkl`` (the dense per-sample mask, int64) and
``{out}/index/{prefix}_{train_labeled,train_unlabeled,valid,test}.csv``,
the layout ``data/dataset.build_seg_dataset`` reads. The split is a seeded
permutation of the sorted record names; the first ``labeled_ratio`` of
the training records stay labeled, the rest are unlabeled (the labeled
ones again when none are left).

The installed ``wfdb`` package reads the records where it is there;
otherwise the port's pure-Python reader ``data/wfdb_io.py`` does (formats
80, 16, 61, 212, 24 and 32 and MIT annotations: every container the
delineation datasets ship in). Host code only: no device is touched.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

DEFAULT_SYMBOL_MAP = {"p": 1, "N": 2, "t": 3}  # P-wave / QRS / T-wave


def annotations_to_mask(ann, length: int, symbol_map) -> np.ndarray:
    """Expand WFDB '(' symbol ')' triplets into a dense per-sample mask."""
    mask = np.zeros(length, dtype=np.int64)
    samples, symbols = list(ann.sample), list(ann.symbol)
    i = 0
    while i < len(symbols):
        if symbols[i] == "(" and i + 1 < len(symbols):
            sym = symbols[i + 1]
            onset = samples[i]
            # find the closing ')'
            j = i + 2
            while j < len(symbols) and symbols[j] != ")":
                j += 1
            offset = samples[j] if j < len(symbols) else samples[i + 1]
            cls = symbol_map.get(sym)
            if cls is not None:
                mask[max(onset, 0):min(offset + 1, length)] = cls
            i = j + 1
        else:
            i += 1
    return mask


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--records_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--lead", type=int, default=0)
    ap.add_argument("--ann_ext", default="atr",
                    help="annotation extension holding delineation symbols")
    ap.add_argument("--symbol_map", default="p=1,N=2,t=3")
    ap.add_argument("--splits", default="0.7,0.15,0.15",
                    help="train,valid,test fractions")
    ap.add_argument("--labeled_ratio", type=float, default=1.0,
                    help="fraction of train kept labeled (rest → unlabeled)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefix", default="DATA")
    args = ap.parse_args(argv)

    try:
        import wfdb  # the real package wins when installed
    except ImportError:
        from ..data import wfdb_io as wfdb
    import pandas as pd

    symbol_map = {}
    for pair in args.symbol_map.split(","):
        k, v = pair.split("=")
        symbol_map[k] = int(v)

    ecg_dir = os.path.join(args.out_dir, "ecg")
    label_dir = os.path.join(args.out_dir, "label")
    index_dir = os.path.join(args.out_dir, "index")
    for d in (ecg_dir, label_dir, index_dir):
        os.makedirs(d, exist_ok=True)

    record_names = sorted({
        os.path.splitext(f)[0]
        for f in os.listdir(args.records_dir) if f.endswith(".hea")
    })
    rows = []
    for name in record_names:
        path = os.path.join(args.records_dir, name)
        record = wfdb.rdrecord(path)
        sig = np.asarray(record.p_signal)[:, args.lead].astype(np.float64)
        ann = wfdb.rdann(path, args.ann_ext)
        mask = annotations_to_mask(ann, len(sig), symbol_map)
        with open(os.path.join(ecg_dir, f"{name}.pkl"), "wb") as f:
            pickle.dump(sig, f)
        with open(os.path.join(label_dir, f"{name}_label.pkl"), "wb") as f:
            pickle.dump(mask, f)
        rows.append({"waveform": f"{name}.pkl", "label": f"{name}_label.pkl",
                     "fs": int(record.fs)})

    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(rows))
    fr_train, fr_valid, _ = [float(x) for x in args.splits.split(",")]
    n_train = int(len(rows) * fr_train)
    n_valid = int(len(rows) * fr_valid)
    train = [rows[i] for i in order[:n_train]]
    valid = [rows[i] for i in order[n_train:n_train + n_valid]]
    test = [rows[i] for i in order[n_train + n_valid:]]
    n_labeled = max(int(len(train) * args.labeled_ratio), 1)
    labeled, unlabeled = train[:n_labeled], train[n_labeled:]

    p = args.prefix
    pd.DataFrame(labeled).to_csv(
        os.path.join(index_dir, f"{p}_train_labeled.csv"), index=False)
    pd.DataFrame(unlabeled or labeled).to_csv(
        os.path.join(index_dir, f"{p}_train_unlabeled.csv"), index=False)
    pd.DataFrame(valid).to_csv(
        os.path.join(index_dir, f"{p}_valid.csv"), index=False)
    pd.DataFrame(test).to_csv(
        os.path.join(index_dir, f"{p}_test.csv"), index=False)
    print(f"wrote {len(rows)} records → {args.out_dir} "
          f"({len(labeled)} labeled / {len(unlabeled)} unlabeled / "
          f"{len(valid)} valid / {len(test)} test)")


if __name__ == "__main__":
    main()
