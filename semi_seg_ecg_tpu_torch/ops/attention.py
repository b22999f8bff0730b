"""Dense softmax attention: the one formulation the port's attention paths
share (counterpart of ``semi_seg_ecg_tpu/ops/attention.py``).

The ViT's short-sequence branch runs it, and the flash kernel's plain
version (``ops/flash_attention.py``) builds on it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    *,
    mm_dtype: Optional[torch.dtype] = None,
    attn_transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over (B, H, N, D), returned in fp32.

    Matmuls run in ``mm_dtype`` (default: q's dtype); the softmax is always
    fp32. ``attn_transform`` hooks between softmax and the value matmul (the
    ViT's attention dropout). Autocast is off inside, so ``mm_dtype`` is the
    matmul dtype whatever the caller's autocast state.
    """
    if mm_dtype is None:
        mm_dtype = q.dtype
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.einsum(
            "bhnd,bhmd->bhnm", q.to(mm_dtype), k.to(mm_dtype)
        ).float() * scale
        attn = torch.softmax(logits, dim=-1)
        if attn_transform is not None:
            attn = attn_transform(attn)
        return torch.einsum(
            "bhnm,bhmd->bhnd", attn.to(mm_dtype), v.to(mm_dtype)
        ).float()
