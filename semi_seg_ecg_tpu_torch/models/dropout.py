"""Dropout and stochastic depth that draw from a generator the caller owns.

The JAX package threads explicit ``dropout``/``droppath`` keys into every
train-mode forward. Here each module holds a ``generator`` slot that the
trainer fills with one ``torch.Generator`` on the training device
(:func:`use_generator`) and reseeds every step, so a run's masks follow
from its ``seed`` and not from PyTorch's global RNG. With the slot empty
the global RNG is used. Both modules are the identity in eval mode.

Under a process group a mask is drawn for the global batch and sliced to
the rank's rows (``parallel.dist.global_rows``), as the JAX package's
masks under a data mesh are drawn for the global array.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..parallel.dist import global_rows


def _keep_mask(x: torch.Tensor, shape, keep: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    return global_rows(lambda s: torch.rand(s, generator=generator,
                                            device=x.device), shape) < keep


class Dropout(nn.Module):
    """Element-wise dropout, flax's ``where(mask, x / keep, 0)``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate <= 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = _keep_mask(x, x.shape, keep, self.generator)
        return torch.where(mask, x / keep, 0.0)


class DropPath(nn.Module):
    """Per-sample stochastic depth."""

    def __init__(self, rate: float, scale_by_keep: bool = True):
        super().__init__()
        self.rate = rate
        self.scale_by_keep = scale_by_keep
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate <= 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = _keep_mask(x, shape, keep, self.generator).to(x.dtype)
        if self.scale_by_keep:
            mask = mask / keep
        return x * mask


def use_generator(model: nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """Point every :class:`Dropout` and :class:`DropPath` in ``model`` at
    ``generator``."""
    for module in model.modules():
        if isinstance(module, (Dropout, DropPath)):
            module.generator = generator
