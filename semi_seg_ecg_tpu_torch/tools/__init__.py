"""Command-line tools of the port, each run with ``python -m
semi_seg_ecg_tpu_torch.tools.NAME``."""
