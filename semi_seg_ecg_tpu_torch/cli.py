"""Console entry points of the port (counterpart of
``semi_seg_ecg_tpu/cli.py`` ``train_main``, ``test_main`` and
``inference_main``).

    python -m semi_seg_ecg_tpu_torch.cli {train,test,inference} -f CONFIG
        [-o OVERRIDE] [--output_dir DIR] [--exp_name NAME] ...

``train`` runs the config's algorithm and, when the config's ``test:`` is
truthy, the test pass on its best checkpoint; ``test`` evaluates a
checkpoint on the test split (``test_metrics.csv``, ``test_outputs.npy``,
``test_labels.npy``); ``inference`` writes ``test_outputs.npy``. Each runs
on the CUDA device unless the config says ``device: cpu``.
"""

import sys


def train_main(argv=None):
    from .algorithms import get_algorithm
    from .config import parse_train_args

    config = parse_train_args(argv if argv is not None else sys.argv[1:])
    algo = get_algorithm(config.get("algorithm"))
    algo.train(config)
    if config.get("test", False):
        return algo.test(config)
    return None


def test_main(argv=None):
    from .algorithms import get_algorithm
    from .config import parse_eval_args

    config = parse_eval_args(argv if argv is not None else sys.argv[1:],
                             prog="ECG segmentation test")
    return get_algorithm(config.get("algorithm")).test(config)


def inference_main(argv=None):
    from .algorithms.common import run_inference
    from .config import parse_eval_args

    config = parse_eval_args(argv if argv is not None else sys.argv[1:],
                             prog="ECG segmentation inference")
    return run_inference(config)


_ENTRIES = {"train": train_main, "test": test_main,
            "inference": inference_main}

if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in _ENTRIES:
        sys.exit(f"usage: python -m semi_seg_ecg_tpu_torch.cli "
                 f"{{{','.join(_ENTRIES)}}} -f CONFIG ...")
    _ENTRIES[sys.argv[1]](sys.argv[2:])
