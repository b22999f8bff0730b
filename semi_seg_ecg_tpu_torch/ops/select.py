"""Exact quantiles along the last axis (counterpart of
``semi_seg_ecg_tpu/ops/select.py``).

``jnp.percentile`` semantics (linear interpolation between the two order
statistics around ``q/100 · (t-1)``). The JAX package finds the order
statistics by a 32-step radix select because a sort was the TPU's most
expensive op in the fused step; here they come from one ``torch.sort``,
and the interpolation is the JAX package's own formula, so the two agree
to the last bit on the order statistics.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch


def exact_quantiles(x: torch.Tensor,
                    qs: Sequence[float]) -> List[torch.Tensor]:
    """One tensor per percentage in ``qs`` (each in [0, 100]), shaped
    ``(..., 1)``."""
    t = x.shape[-1]
    ordered = torch.sort(x.float(), dim=-1).values
    out = []
    for q in qs:
        rr = q / 100.0 * (t - 1)
        r0 = int(math.floor(rr))
        if r0 == t - 1:
            v = ordered[..., r0]
        else:
            w = rr - r0
            v = ordered[..., r0] * (1 - w) + ordered[..., r0 + 1] * w
        out.append(v.unsqueeze(-1))
    return out
