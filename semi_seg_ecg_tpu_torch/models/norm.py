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

Under a process group of more than one data rank, train mode takes the
statistics of the global batch (over the data group: the model ranks of a
data rank hold the same rows), as the JAX module does under a data mesh
(GSPMD reduces its means over every shard): each rank's count, mean and
sum of squared deviations are gathered (``parallel.dist.all_gather``,
differentiable, so the gradient flows through the statistics to every
rank's input) and merged pairwise by Chan's formula; the batch is
normalized with the biased variance and ``running_var`` takes the unbiased
one of the global count. ``nn.SyncBatchNorm`` would do the same on CUDA
tensors only; this one runs on both devices, so the CPU tests can hold it
against the JAX package.

:func:`running_stats_kept` runs a forward whose running-statistic updates
go to scratch copies: the recompute of a checkpointed block
(``models/remat.py``), which must not update the statistics a second
time. The forward itself is unchanged, collectives included, so every
rank of a process group issues the same ones.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from ..parallel.dist import all_gather, data_size


def _global_statistics(x: torch.Tensor):
    """``(mean, biased var, count)`` per channel of NCW ``x`` over the
    ranks' batches."""
    n = x.shape[0] * x.shape[2]
    xf = x.float()
    mean = xf.mean(dim=(0, 2))
    m2 = (xf - mean[None, :, None]).square().sum(dim=(0, 2))
    count = torch.full_like(mean, n)
    stats = all_gather(torch.stack([count, mean, m2]))   # (world, 3, C)
    count, mean, m2 = stats[0]
    for c_b, mean_b, m2_b in stats[1:]:
        total = count + c_b
        delta = mean_b - mean
        mean = mean + delta * (c_b / total)
        m2 = m2 + m2_b + delta.square() * (count * c_b / total)
        count = total
    return mean, m2 / count, count


class TorchBatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over NCW with the JAX package's eps and momentum,
    its train-mode statistics those of the global batch under a process
    group."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or data_size() == 1:
            return super().forward(x)
        mean, var, count = _global_statistics(x)
        if self.track_running_stats:
            with torch.no_grad():
                unbiased = var * (count / (count - 1))
                self.running_mean.mul_(1 - self.momentum).add_(
                    mean.detach() * self.momentum)
                self.running_var.mul_(1 - self.momentum).add_(
                    unbiased.detach() * self.momentum)
                self.num_batches_tracked.add_(1)
        y = (x.float() - mean[:, None]) * torch.rsqrt(var + self.eps)[:, None]
        if self.affine:
            y = y * self.weight[:, None] + self.bias[:, None]
        return y.to(x.dtype)


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


_RUNNING = ("running_mean", "running_var", "num_batches_tracked")


@contextlib.contextmanager
def running_stats_kept(module: nn.Module):
    """Inside, the BatchNorms of ``module`` update copies of their
    ``running_mean``/``running_var``/``num_batches_tracked`` and compute
    as they would on the originals; on exit the originals come back,
    untouched."""
    saved = [(m, [getattr(m, n) for n in _RUNNING])
             for m in module.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)
             and m.track_running_stats]
    for m, buffers in saved:
        for n, b in zip(_RUNNING, buffers):
            setattr(m, n, b.clone())
    try:
        yield
    finally:
        for m, buffers in saved:
            for n, b in zip(_RUNNING, buffers):
                setattr(m, n, b)
