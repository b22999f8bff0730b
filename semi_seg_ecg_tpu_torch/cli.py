"""Console entry points of the port (counterpart of
``semi_seg_ecg_tpu/cli.py`` ``train_main``, ``test_main``,
``inference_main`` and ``infer_longrec_main``, and of
``tools/export_model.py`` and ``tools/serve.py``).

    python -m semi_seg_ecg_tpu_torch.cli {train,test,inference} -f CONFIG
        [-o OVERRIDE] [--output_dir DIR] [--exp_name NAME] ...
    python -m semi_seg_ecg_tpu_torch.cli infer-longrec -f CONFIG
        --record RECORD [--out-dir DIR] [--intervals] ...
    python -m semi_seg_ecg_tpu_torch.cli export -f CONFIG [-o OVERRIDE]
        [--model_path CKPT] [--out ARTIFACT] [--batch N] [--platforms cuda]
    python -m semi_seg_ecg_tpu_torch.cli serve ARTIFACT [--host H]
        [--port P] [--buckets 16 64 256]

``train`` runs the config's algorithm and, when the config's ``test:`` is
truthy, the test pass on its best checkpoint; ``test`` evaluates a
checkpoint on the test split (``test_metrics.csv``, ``test_outputs.npy``,
``test_labels.npy``); ``inference`` writes ``test_outputs.npy``;
``infer-longrec`` segments raw records of any length (``probs.npy``,
``labels.npy``, optionally ``intervals.csv``); ``export`` writes the
serving artifact of a checkpoint (``serving.export_serving``) and prints a
line of JSON; ``serve`` serves an artifact over HTTP
(``serving.make_http_server``). Each runs on the CUDA device unless the
config says ``device: cpu`` (``serve``: the device the artifact was
exported for).

``train``, ``test`` and ``inference`` run data-parallel under ``torchrun``
(one process per GPU, ``torchrun --nproc_per_node N -m
semi_seg_ecg_tpu_torch.cli train -f CONFIG``, or ``scripts/torch_train.sh``)
or SLURM: rank 0 prints and writes the files, and an entry that made the
process group destroys it before it returns (a caller's group stays).
"""

import contextlib
import sys


@contextlib.contextmanager
def _process_group():
    """Inside, the entry's run; after it, the process group the run made
    (``parallel.dist.init_distributed_mode``) is destroyed, unless there
    was one before."""
    import torch.distributed as dist

    from .parallel.dist import destroy_process_group

    had_group = dist.is_initialized()
    try:
        yield
    finally:
        if not had_group:
            destroy_process_group()


def train_main(argv=None):
    from .algorithms import get_algorithm
    from .config import parse_train_args

    config = parse_train_args(argv if argv is not None else sys.argv[1:])
    algo = get_algorithm(config.get("algorithm"))
    with _process_group():
        algo.train(config)
        if config.get("test", False):
            return algo.test(config)
    return None


def test_main(argv=None):
    from .algorithms import get_algorithm
    from .config import parse_eval_args

    config = parse_eval_args(argv if argv is not None else sys.argv[1:],
                             prog="ECG segmentation test")
    with _process_group():
        return get_algorithm(config.get("algorithm")).test(config)


def inference_main(argv=None):
    from .algorithms.common import run_inference
    from .config import parse_eval_args

    config = parse_eval_args(argv if argv is not None else sys.argv[1:],
                             prog="ECG segmentation inference")
    with _process_group():
        return run_inference(config)


def load_record(path: str):
    """(leads, T) float32 from .npy / .pkl / WFDB (.hea or basename)."""
    import os
    import pickle

    import numpy as np

    if path.endswith(".npy"):
        x = np.load(path, allow_pickle=False)
    elif path.endswith(".pkl"):
        with open(path, "rb") as f:
            x = np.asarray(pickle.load(f))
    elif path.endswith(".hea") or os.path.exists(path + ".hea"):
        from .data.wfdb_io import rdrecord

        rec = rdrecord(path)
        x = np.nan_to_num(rec.p_signal).T  # (n_sig, sig_len)
    else:
        raise SystemExit(f"unrecognized record format: {path} "
                         "(expected .npy, .pkl, or a WFDB .hea)")
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[None]
    if x.ndim != 2:
        raise SystemExit(f"record must be 1-D or 2-D, got shape {x.shape}")
    # heuristically fix (T, leads) layouts: records are long, lead counts tiny
    if x.shape[0] > x.shape[1]:
        x = x.T
    return x


def _record_fs(path: str):
    """The record's own sampling rate, when the format carries one
    (WFDB header ``fs``); None otherwise."""
    import os

    if path.endswith(".hea") or os.path.exists(path + ".hea"):
        from .data.wfdb_io import rdrecord

        return float(rdrecord(path).fs)
    return None


def _write_longrec_outputs(out, out_dir, args):
    import os

    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    probs_path = os.path.join(out_dir, "probs.npy")
    labels_path = os.path.join(out_dir, "labels.npy")
    np.save(probs_path, out["probs"])
    np.save(labels_path, out["labels"])
    counts = np.bincount(out["labels"], minlength=out["probs"].shape[0])
    frac = counts / max(1, out["labels"].size)
    print("class occupancy:",
          " ".join(f"c{i}={f:.3f}" for i, f in enumerate(frac)))
    print(f"wrote {probs_path} {out['probs'].shape}, "
          f"{labels_path} {out['labels'].shape}")
    if args.intervals:
        from .ops.delineation import labels_to_intervals

        iv = labels_to_intervals(
            out["labels"],
            min_duration=max(1, int(round(args.min_duration_ms * args.fs
                                          / 1000.0))))
        iv_path = os.path.join(out_dir, "intervals.csv")
        with open(iv_path, "w") as f:
            f.write("class,onset,offset,onset_s,offset_s\n")
            for c in sorted(iv):
                for onset, offset in iv[c]:
                    f.write(f"{c},{onset},{offset},"
                            f"{onset / args.fs:.4f},{offset / args.fs:.4f}\n")
        n = sum(len(v) for v in iv.values())
        print(f"wrote {iv_path}: {n} wave intervals")


def infer_longrec_main(argv=None):
    """Segment one RAW record of any length (Holter/telemetry scale).

    The reference's inference entry only consumes pre-cut test-split
    windows (src/inference.py:112-125); this CLI takes .npy/.pkl/WFDB
    records and runs ``serving.long_record_inference`` — full-length
    filtering, then windowing, per-window standardization and the
    taper-stitched batched forward on the model's device, one fetch per
    record — writing ``probs.npy`` (C, T), ``labels.npy`` (T,), and
    optionally ``intervals.csv`` (``--intervals``, ops/delineation.py).
    Runs on the CUDA device unless the config says ``device: cpu``.
    Returns the last record's ``{"probs", "labels"}``.
    """
    import argparse
    import os

    import numpy as np

    p = argparse.ArgumentParser(
        "Long-record ECG segmentation",
        description=infer_longrec_main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-f", "--config_path", required=True)
    p.add_argument("-o", "--override_config_path", default=None)
    p.add_argument("--model_path", default="",
                   help="checkpoint to load (default: the config's best-*)")
    p.add_argument("--record", required=True,
                   help=".npy / .pkl / WFDB record, or a DIRECTORY of "
                        "records (one model load shared across records; "
                        "outputs in out-dir/<record-stem>/)")
    p.add_argument("--lead", type=int, default=None,
                   help="use only this lead index of a multi-lead record")
    p.add_argument("--hop", type=int, default=None,
                   help="window stride (default window//2; must divide it)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--taper", choices=("hann", "flat"), default="hann")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--intervals", action="store_true",
                   help="also write intervals.csv: per-wave [onset, offset) "
                        "runs extracted from the label field "
                        "(ops/delineation.py)")
    p.add_argument("--fs", type=float, default=None,
                   help="sampling rate for the intervals' second columns "
                        "and ms-based knobs (default: the record's own "
                        "rate for WFDB input, else 250)")
    p.add_argument("--min-duration-ms", type=float, default=20.0,
                   help="drop wave runs shorter than this (blip filter)")
    p.add_argument("--model-fs", type=float, default=None,
                   help="the model's sampling rate (e.g. 250 for the "
                        "shipped signal_length-2500 LUDB recipes). When "
                        "it differs from the record's rate the signal is "
                        "Fourier-resampled to the model rate for "
                        "inference — the training pipeline's exact "
                        "resample semantics — and predictions are mapped "
                        "back (zero-order-hold labels, linear probs) so "
                        "outputs and --eval-labels metrics stay on the "
                        "record's native timebase")
    p.add_argument("--eval-labels", default=None, metavar="NPY",
                   help="ground-truth label field (T,) to score against: "
                        "prints LUDB-convention delineation metrics "
                        "(per-boundary sensitivity/PPV, mean±std error ms)")
    p.add_argument("--tolerance-ms", type=float, default=150.0,
                   help="boundary match tolerance for --eval-labels")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    from .config import load_config, normalize_config, test_cfg
    from .serving import long_record_inference

    config = normalize_config(
        load_config(args.config_path, args.override_config_path))
    if args.model_path:
        config["test"] = test_cfg(config)
        config["test"]["model_path"] = args.model_path

    is_dir = os.path.isdir(args.record)
    if is_dir:
        paths = sorted(
            os.path.join(args.record, f)
            for f in os.listdir(args.record)
            if f.endswith((".npy", ".pkl", ".hea")))
        if not paths:
            raise SystemExit(f"no .npy/.pkl/.hea records in {args.record}")
        if args.eval_labels:
            raise SystemExit("--eval-labels applies to a single record")
        stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        dupes = {s for s in stems if stems.count(s) > 1}
        if dupes:
            raise SystemExit(
                f"records differing only by extension would overwrite each "
                f"other's outputs: {sorted(dupes)} — rename or separate them")
    else:
        paths = [args.record]

    # one model load shared across records
    from .serving import make_serving_fn

    infer, _ = make_serving_fn(config)
    n_leads = int(config["backbone"][next(iter(config["backbone"]))]
                  .get("num_leads", 1))
    for path in paths:
        ecg = load_record(path)
        if args.fs is None:
            fs = _record_fs(path)
            if fs is not None:
                print(f"using the record's own sampling rate: {fs:g} Hz")
            args.fs = fs if fs is not None else 250.0
        if args.lead is not None:
            if not 0 <= args.lead < ecg.shape[0]:
                raise SystemExit(f"{path}: --lead {args.lead} out of range "
                                 f"for a {ecg.shape[0]}-lead record")
            ecg = ecg[args.lead:args.lead + 1]
        if ecg.shape[0] != n_leads:
            raise SystemExit(f"{path}: record has {ecg.shape[0]} leads but "
                             f"the model takes {n_leads} — pass --lead")
        print(f"{path}: {ecg.shape[0]} lead(s) x {ecg.shape[1]} samples")
        out_dir = args.out_dir
        if is_dir:
            stem = os.path.splitext(os.path.basename(path))[0]
            out_dir = os.path.join(args.out_dir, stem)
        t_record = ecg.shape[1]
        if (args.model_fs and args.fs
                and abs(args.fs - args.model_fs) > 1e-9):
            from .data.transforms import _fourier_resample

            m = max(1, int(round(t_record * args.model_fs / args.fs)))
            print(f"resampling {args.fs:g} Hz -> model rate "
                  f"{args.model_fs:g} Hz ({t_record} -> {m} samples); "
                  "predictions mapped back to the record's timebase")
            ecg = np.ascontiguousarray(
                _fourier_resample(ecg, m, axis=1).astype(np.float32))
        out = long_record_inference(config, ecg, batch=args.batch,
                                    hop=args.hop, taper=args.taper,
                                    infer=infer)
        if out["labels"].shape[0] != t_record:
            from .data.transforms import _label_resample

            out["labels"] = _label_resample(
                out["labels"][None, :].astype(np.int64), t_record,
                "nearest")[0].astype(np.int32)
            src = np.linspace(0.0, 1.0, out["probs"].shape[1])
            dst = np.linspace(0.0, 1.0, t_record)
            out["probs"] = np.stack(
                [np.interp(dst, src, p) for p in out["probs"]]
            ).astype(np.float32)
        _write_longrec_outputs(out, out_dir, args)
    if args.eval_labels:  # single record (guarded above): `out` is its result
        from .ops.delineation import delineation_metrics

        true = np.load(args.eval_labels, allow_pickle=False)
        if true.shape != out["labels"].shape:
            raise SystemExit(f"--eval-labels shape {true.shape} != record "
                             f"labels {out['labels'].shape}")
        m = delineation_metrics(
            out["labels"], true, fs=args.fs,
            tolerance_ms=args.tolerance_ms,
            min_duration=max(1, int(round(args.min_duration_ms * args.fs
                                          / 1000.0))))
        print(f"delineation vs {args.eval_labels} "
              f"(tolerance {args.tolerance_ms:g} ms):")
        for key in sorted(k for k in m if k != "overall"):
            r = m[key]
            print(f"  {key:>12}: Se {r['sensitivity']:.3f}  "
                  f"PPV {r['ppv']:.3f}  err {r['mean_ms']:+.1f}"
                  f"±{r['std_ms']:.1f} ms  (n={r['n_true']})")
        o = m["overall"]
        print(f"  {'overall':>12}: Se {o['sensitivity']:.3f}  "
              f"PPV {o['ppv']:.3f}  matched {int(o['n_matched'])}")
        out["delineation"] = m
    return out

def export_main(argv=None):
    """Export a checkpoint to a self-contained serving artifact (the JAX
    package's ``tools/export_model.py``): the program with its weights
    baked in, loaded by ``serving.load_serving`` without the model code or
    the checkpoint. Prints one line of JSON: the artifact's path, its size
    and its header. Returns the header."""
    import argparse
    import json
    import os

    ap = argparse.ArgumentParser("ECG segmentation model export")
    ap.add_argument("-f", "--config_path", required=True, metavar="FILE")
    ap.add_argument("-o", "--override_config_path", default=None,
                    metavar="FILE")
    ap.add_argument("--model_path", default="", metavar="PATH",
                    help="checkpoint to export (default: the config's "
                         "best-{target_metric}.ckpt)")
    ap.add_argument("--out", default="", metavar="PATH",
                    help="artifact path (default: "
                         "{exp_dir}/serving-{exp_name}.pt2)")
    ap.add_argument("--batch", type=int, default=None,
                    help="pin the batch dimension (default: symbolic, one "
                         "artifact serves any batch size)")
    ap.add_argument("--platforms", nargs="+", default=None,
                    help="the artifact's platform (default: the config's "
                         "device; one platform only)")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])

    from .config import (
        experiment_dir,
        load_config,
        normalize_config,
        test_cfg,
    )
    from .serving import export_serving

    config = load_config(args.config_path, args.override_config_path)
    if args.model_path:
        config["test"] = test_cfg(config)
        config["test"]["model_path"] = args.model_path
    config = normalize_config(config)
    out = args.out
    if not out:
        exp_dir = experiment_dir(config)
        if not exp_dir:
            ap.error("config has no output_dir/exp_name to derive an "
                     "artifact path from - pass --out PATH")
        out = os.path.join(
            exp_dir, f"serving-{config.get('exp_name', 'model')}.pt2")
    header = export_serving(config, out, batch_size=args.batch,
                            platforms=args.platforms)
    print(json.dumps({"artifact": out,
                      "bytes": os.path.getsize(out), **header}), flush=True)
    return header


def serve_main(argv=None):
    """Serve an exported artifact over HTTP (the JAX package's
    ``tools/serve.py``): ``GET /v1/metadata`` (the header and buckets) and
    ``POST /v1/predict`` (``.npy`` float32 ``(B, leads, T)`` in, ``.npy``
    softmax ``(B, C, T)`` out). Prints one line of JSON when listening, then
    serves until interrupted.

    Client example::

        import io, urllib.request, numpy as np
        buf = io.BytesIO(); np.save(buf, x)          # x: (B, 1, T) float32
        req = urllib.request.Request("http://host:8000/v1/predict",
                                     data=buf.getvalue(), method="POST")
        probs = np.load(io.BytesIO(urllib.request.urlopen(req).read()))
    """
    import argparse
    import json

    ap = argparse.ArgumentParser("ECG segmentation model server")
    ap.add_argument("artifact", help="path to a serving artifact (export)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--buckets", type=int, nargs="+", default=[16, 64, 256],
                    help="batch buckets for symbolic-batch artifacts")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])

    from .serving import make_http_server

    server = make_http_server(args.artifact, host=args.host, port=args.port,
                              bucket_sizes=tuple(args.buckets))
    print(json.dumps({"listening": f"http://{args.host}:"
                                   f"{server.server_address[1]}",
                      "artifact": args.artifact,
                      "buckets": args.buckets}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


_ENTRIES = {"train": train_main, "test": test_main,
            "inference": inference_main, "infer-longrec": infer_longrec_main,
            "export": export_main, "serve": serve_main}

if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in _ENTRIES:
        sys.exit(f"usage: python -m semi_seg_ecg_tpu_torch.cli "
                 f"{{{','.join(_ENTRIES)}}} -f CONFIG ...")
    _ENTRIES[sys.argv[1]](sys.argv[2:])
