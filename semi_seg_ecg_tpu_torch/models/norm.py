"""Batch normalization (counterpart of ``semi_seg_ecg_tpu/models/norm.py``).

The JAX package writes its own ``TorchBatchNorm`` to reproduce torch's
convention: normalize with the biased batch variance, fold the unbiased one
into ``running_var``, momentum 0.1 in torch's sense, eps 1e-5. Here that
convention is ``nn.BatchNorm1d`` itself, so the module only pins the
defaults. Eval mode normalizes with the running statistics; train mode with
the batch's, updating ``running_mean``/``running_var`` as the JAX module
updates ``mean``/``var`` (its flax momentum 0.9 is torch's 0.1).
:func:`batch_statistics_only` runs a train-mode forward without that
update (the Mean Teacher's train-mode teacher).
"""

from __future__ import annotations

import contextlib

import torch.nn as nn


class TorchBatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over NCW with the JAX package's eps and momentum."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)


@contextlib.contextmanager
def batch_statistics_only(model: nn.Module):
    """Inside, train-mode BatchNorms normalize with the batch's statistics
    and leave ``running_mean``/``running_var``/``num_batches_tracked`` as
    they are (the JAX package's train-mode apply with its BN-stat mutation
    discarded); on exit the modules track their statistics again."""
    norms = [m for m in model.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)
             and m.track_running_stats]
    for m in norms:
        m.track_running_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.track_running_stats = True
