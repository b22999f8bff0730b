"""1-D ResNet building blocks (counterpart of
``semi_seg_ecg_tpu/models/backbones/resnet.py``).

Only ``ConvBN`` is ported so far, because the FCN head is built from it.
The ResNet backbone itself is not ported yet: ``models.build_model_from_config``
refuses the ``resnet*`` names.
"""

from __future__ import annotations

import torch.nn as nn

from ..norm import TorchBatchNorm


class ConvBN(nn.Sequential):
    """Conv1d (no bias) + BatchNorm over NCW. As a ``Sequential`` its keys
    are ``0.weight`` (conv) and ``1.*`` (norm), the reference's layout."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1):
        pad = (kernel_size // 2) * dilation
        super().__init__(
            nn.Conv1d(in_channels, features, kernel_size, stride=stride,
                      padding=pad, dilation=dilation, bias=False),
            TorchBatchNorm(features),
        )
