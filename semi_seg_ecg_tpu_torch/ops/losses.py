"""Segmentation losses (counterpart of ``semi_seg_ecg_tpu/ops/losses.py``).

Three cross-entropy forms over ``(B, C, *)`` logits, all from one fp32
log-softmax over the class axis 1: hard labels (optionally masked, with
``'mean'``/``'sum'``/``'none'`` reduction), soft probability targets, and a
per-sample mean. The label pick is the JAX package's one-hot contraction,
not ``F.cross_entropy``: a label outside ``[0, C)`` contributes 0 where
torch would raise or clamp, and the mean still divides by every element.
Under a split time axis (``parallel/seq_shard.py``) the means and sums
run over the global array: each rank's sum, summed over the seq ranks,
over the global count, so every seq rank holds the loss of one process.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import seq_shard


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    with torch.autocast(logits.device.type, enabled=False):
        return torch.log_softmax(logits.float(), dim=1)


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return seq_shard.global_mean(loss)
    if reduction == "sum":
        return seq_shard.global_sum(loss)
    return loss


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  reduction: str = "mean",
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CE of ``(B, C, *)`` logits against integer ``(B, *)`` labels.
    ``mask`` (labels' shape) multiplies the per-element losses before the
    reduction: the FixMatch confidence filter."""
    logp = _log_softmax(logits)
    classes = torch.arange(logp.shape[1], device=labels.device,
                           dtype=labels.dtype)
    classes = classes.reshape((1, -1) + (1,) * (labels.dim() - 1))
    onehot = labels.unsqueeze(1) == classes
    loss = -torch.where(onehot, logp, 0.0).sum(dim=1)
    if mask is not None:
        loss = loss * mask.to(loss.dtype)
    return _reduce(loss, reduction)


def soft_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor,
                       reduction: str = "mean",
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CE against probability targets: ``-Σ_c q_c log p_c`` per element."""
    logp = _log_softmax(logits)
    loss = -(target_probs.to(logp.dtype) * logp).sum(dim=1)
    if mask is not None:
        loss = loss * mask.to(loss.dtype)
    return _reduce(loss, reduction)


def per_sample_cross_entropy(logits: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """Mean-over-time CE per sample, ``(B,)``: what the evaluator gathers
    (over the global time axis of ``(B, T)`` labels when it is split)."""
    loss = cross_entropy(logits, labels, reduction="none")
    if seq_shard.active() is not None:
        return seq_shard.time_mean(loss)
    return loss.mean(dim=tuple(range(1, loss.dim())))
