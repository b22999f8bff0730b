"""semi_seg_ecg_tpu_torch — the PyTorch/CUDA port of ``semi_seg_ecg_tpu``.

The JAX package beside this one is the reference: each module here sits at
the same path as its counterpart there and is held against it by the
``tests/test_torch_*.py`` files. This package imports torch, numpy, scipy,
pandas and yaml, and nothing of JAX or of the JAX package; the
framework-neutral host code (``config.py``, ``data/*``) is its own copy.

Ported so far: test-split serving of the ViT-1D + FCNHead segmentor
(``cli.inference_main`` → ``algorithms.common.run_inference``), with the
Pallas flash-attention forward replaced by a hand-written CUDA kernel
(``csrc/flash_attention_fwd.cu``). Every entry runs on the CUDA device
unless its config says ``device: cpu``.
"""
