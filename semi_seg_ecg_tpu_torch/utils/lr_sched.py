"""Learning-rate schedules as pure functions of fractional epoch (a copy
of ``semi_seg_ecg_tpu/utils/lr_sched.py`` without its traced-array branch).

- ``cosine_warmup_lr``: linear warmup from 0 over ``warmup_epochs``, then a
  half cosine from ``lr`` to ``min_lr`` over the remaining epochs, applied
  per iteration with ``epoch = update_step / updates_per_epoch``.
"""

from __future__ import annotations

import math
from typing import Any, Dict


def cosine_warmup_lr(epoch: float, config: Dict[str, Any]) -> float:
    """Half-cycle cosine decay with linear warmup; ``config`` needs ``lr``,
    ``min_lr``, ``warmup_epochs`` and ``epochs``."""
    lr = config["lr"]
    min_lr = config["min_lr"]
    warmup = config["warmup_epochs"]
    total = config["epochs"]
    if epoch < warmup:
        return lr * epoch / warmup
    return min_lr + (lr - min_lr) * 0.5 * (
        1.0 + math.cos(math.pi * (epoch - warmup) / (total - warmup))
    )

