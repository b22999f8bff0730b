"""Console entry point of the port (counterpart of
``semi_seg_ecg_tpu/cli.py`` ``inference_main``).

    python -m semi_seg_ecg_tpu_torch.cli -f CONFIG [-o OVERRIDE]
        [--model_path CKPT] [--output_dir DIR] [--exp_name NAME]

serves the config's test split and writes ``test_outputs.npy``. It runs on
the CUDA device unless the config says ``device: cpu``.
"""

import sys


def inference_main(argv=None):
    from .algorithms.common import run_inference
    from .config import parse_eval_args

    config = parse_eval_args(argv if argv is not None else sys.argv[1:],
                             prog="ECG segmentation inference")
    return run_inference(config)


if __name__ == "__main__":
    inference_main()
