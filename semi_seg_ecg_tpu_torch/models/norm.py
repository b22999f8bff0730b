"""Batch normalization (counterpart of ``semi_seg_ecg_tpu/models/norm.py``).

The JAX package writes its own ``TorchBatchNorm`` to reproduce torch's
convention: normalize with the biased batch variance, fold the unbiased one
into ``running_var``, momentum 0.1 in torch's sense, eps 1e-5. Here that
convention is ``nn.BatchNorm1d`` itself, so the module only pins the
defaults. Serving runs it in eval mode, on the running statistics.
"""

from __future__ import annotations

import torch.nn as nn


class TorchBatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over NCW with the JAX package's eps and momentum."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
