"""EncoderDecoder wrapper (counterpart of
``semi_seg_ecg_tpu/models/encoder_decoder.py``), eval path.

Contract as in the JAX package: inputs ``(B, leads, T)`` in, ``seg_logits``
``(B, num_classes, T)`` out — backbone feature tuple, decode head, logits
linearly interpolated back to the input length. Losses, latents and
auxiliary heads belong to training, which is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..ops.interpolate import linear_interpolate


class EncoderDecoder(nn.Module):
    def __init__(self, backbone: nn.Module, decode_head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.decode_head = decode_head

    def forward(self, inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.backbone(inputs)
        seg = self.decode_head(feats)  # (B, classes, t)
        seg = linear_interpolate(seg, inputs.shape[2],
                                 align_corners=self.decode_head.align_corners)
        return {"seg_logits": seg}
