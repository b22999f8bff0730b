"""Batch normalization (counterpart of ``semi_seg_ecg_tpu/models/norm.py``).

The JAX package writes its own ``TorchBatchNorm`` to reproduce torch's
convention: normalize with the biased batch variance, fold the unbiased one
into ``running_var``, momentum 0.1 in torch's sense, eps 1e-5. Here that
convention is ``nn.BatchNorm1d`` itself, so the module only pins the
defaults. Eval mode normalizes with the running statistics; train mode with
the batch's, updating ``running_mean``/``running_var`` as the JAX module
updates ``mean``/``var`` (its flax momentum 0.9 is torch's 0.1).
"""

from __future__ import annotations

import torch.nn as nn


class TorchBatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over NCW with the JAX package's eps and momentum."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
