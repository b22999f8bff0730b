"""semi_seg_ecg_tpu_torch — the PyTorch/CUDA port of ``semi_seg_ecg_tpu``.

The JAX package beside this one is the reference: each module here sits at
the same path as its counterpart there and is held against it by the
``tests/test_torch_*.py`` files. This package imports torch, numpy, scipy,
pandas and yaml, and nothing of JAX or of the JAX package; the
framework-neutral host code (``config.py``, ``data/*``) is its own copy.

Ported so far: training, testing and serving of the ResNet-1D and ViT-1D
segmentors with the six algorithms (``cli.py``), long-record serving,
int8 serving, and the deployment unit (``serving.export_serving`` /
``load_serving`` / ``make_http_server``), with the three Pallas kernels
replaced by hand-written CUDA kernels (``csrc/``). Every entry runs on the
CUDA device unless its config says ``device: cpu``.
"""
