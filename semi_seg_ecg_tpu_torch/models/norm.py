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
sum of squared deviations are gathered and merged pairwise by Chan's
formula (under a split time axis, ``parallel/seq_shard.py``, over the
data×seq group, each rank counting its rows × its block of time, as the
JAX module's means run over batch and time under GSPMD); the batch is
normalized with the biased variance and ``running_var`` takes the unbiased
one of the global count. The backward all-reduces the batch norm's two
per-channel sums, so the gradient flows through the statistics to every
rank's input, and only ``x`` and the statistics are saved for it. ``nn.SyncBatchNorm`` would do the same on CUDA
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

from ..parallel import seq_shard
from ..parallel.dist import (
    _gather_tensor,
    all_reduce_sum_,
    current_mesh,
    group_size,
)


def _statistics_group():
    """The ranks whose batches a train-mode BatchNorm normalizes over: the
    data group, or the data×seq group when the time axis is split."""
    if seq_shard.active() is not None:
        return current_mesh().data_seq_group
    return None


def _global_statistics(x: torch.Tensor, group=None):
    """``(mean, biased var, count)`` per channel of NCW ``x`` over the
    batches of the ranks of ``group`` (None: the data group), in fp32: each
    rank's count, mean and sum of squared deviations, gathered and merged
    pairwise by Chan's formula."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2))
    m2 = (xf - mean[None, :, None]).square().sum(dim=(0, 2))
    count = torch.full_like(mean, x.shape[0] * x.shape[2])
    stats = _gather_tensor(torch.stack([count, mean, m2]), group)
    count, mean, m2 = stats[0]
    for c_b, mean_b, m2_b in stats[1:]:
        total = count + c_b
        delta = mean_b - mean
        mean = mean + delta * (c_b / total)
        m2 = m2 + m2_b + delta.square() * (count * c_b / total)
        count = total
    return mean, m2 / count, count


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalization with the statistics of the ranks of
    ``group``. It saves ``x`` and the per-channel statistics only, as
    ``F.batch_norm`` does (autograd through the formula would keep three
    more activation-sized tensors a layer); the backward is the batch
    norm's, its two per-channel sums all-reduced over the group, since
    every rank's ``x`` moves the statistics. The weight's and bias's
    gradients are this rank's share, which the optimizer's all-reduce
    sums."""

    @staticmethod
    def forward(ctx, x, weight, bias, group, eps):
        mean, var, count = _global_statistics(x, group)
        invstd = torch.rsqrt(var + eps)
        y = (x.float() - mean[:, None]) * invstd[:, None]
        if weight is not None:
            y = y * weight[:, None] + bias[:, None]
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var, count)
        return y.to(x.dtype), mean, var, count

    @staticmethod
    def backward(ctx, grad, *_):
        x, weight, mean, invstd, count = ctx.saved_tensors
        g = grad.float()
        xhat = (x.float() - mean[:, None]) * invstd[:, None]
        sums = torch.stack([g.sum(dim=(0, 2)), (g * xhat).sum(dim=(0, 2))])
        local = sums.clone()
        all_reduce_sum_(sums, ctx.group)
        scale = invstd if weight is None else invstd * weight
        dx = (g - (sums[0] / count)[:, None]
              - xhat * (sums[1] / count)[:, None]) * scale[:, None]
        if weight is None:
            return dx.to(x.dtype), None, None, None, None
        return (dx.to(x.dtype), local[1].to(weight.dtype),
                local[0].to(weight.dtype), None, None)


class TorchBatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over NCW with the JAX package's eps and momentum,
    its train-mode statistics those of the global batch under a process
    group."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = _statistics_group() if self.training else None
        if not self.training or group_size(group) == 1:
            return super().forward(x)
        y, mean, var, count = _GlobalBatchNorm.apply(
            x, self.weight if self.affine else None,
            self.bias if self.affine else None, group, self.eps)
        if self.track_running_stats:
            with torch.no_grad():
                unbiased = var * (count / (count - 1))
                self.running_mean.mul_(1 - self.momentum).add_(
                    mean * self.momentum)
                self.running_var.mul_(1 - self.momentum).add_(
                    unbiased * self.momentum)
                self.num_batches_tracked.add_(1)
        return y


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
