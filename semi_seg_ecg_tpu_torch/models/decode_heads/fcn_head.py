"""FCN decode head over NCW features (counterpart of
``semi_seg_ecg_tpu/models/decode_heads/fcn_head.py``).

Pick feature ``inputs[in_index]``, run ``num_convs`` Conv-BN-ReLU blocks
(dilation-aware padding), optionally fuse the input back in through
``conv_cat``, drop out, and classify with a 1x1 conv. ``align_corners`` is
read by the EncoderDecoder's logit interpolation. Module names follow the
reference's keys (``convs.{i}.0``/``.1``, ``conv_cat.0``/``.1``,
``cls_seg``). ``quantize='int8'`` (serving) runs the Conv-BN convolutions in
int8; the classifier stays float. In training the BatchNorms use batch statistics and fold
them into the running ones (``models/norm.py``), and the dropout draws from
the trainer's generator (``models/dropout.py``). Under a split time axis
(``length`` given; ``parallel/seq_shard.py``) the convolutions run on the
rank's block of the features' global length with their halos fetched, and
the dropout's mask is the block of one drawn over the whole length.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel import seq_shard
from ..backbones.resnet import ConvBN
from ..dropout import Dropout


class FCNHead(nn.Module):
    def __init__(self, in_channels: int, channels: int, num_classes: int,
                 num_convs: int, kernel_size: int = 3,
                 concat_input: bool = True, dilation: int = 1,
                 in_index: int = -1, dropout_ratio: float = 0.1,
                 align_corners: bool = False,
                 quantize: Optional[str] = None):
        super().__init__()
        if num_convs < 0 or dilation <= 0:
            raise ValueError(f"FCNHead: num_convs={num_convs}, "
                             f"dilation={dilation}")
        if num_convs == 0 and in_channels != channels:
            raise ValueError("FCNHead: num_convs=0 needs in_channels == "
                             "channels")
        self.in_index = in_index
        self.align_corners = align_corners
        self.convs = nn.ModuleList(
            ConvBN(in_channels if i == 0 else channels, channels,
                   kernel_size, dilation=dilation, quantize=quantize)
            for i in range(num_convs))
        self.conv_cat = (ConvBN(in_channels + channels, channels,
                                kernel_size, quantize=quantize)
                         if concat_input else None)
        self.dropout = Dropout(dropout_ratio)
        # the classifier stays float, as in the JAX package: its logits feed
        # the argmax, where quantization error would show
        self.cls_seg = nn.Conv1d(channels, num_classes, 1)

    def forward(self, inputs: Sequence[torch.Tensor],
                length: Optional[int] = None) -> torch.Tensor:
        """``length``: the global length of the features' split time axis
        (None: the features are whole)."""
        x = inputs[self.in_index]
        if length is None:
            def conv_bn(block, t):
                return block(t)
            time = None
        else:
            def conv_bn(block, t):
                return block[1](seq_shard.conv_module(block[0], t, length)[0])
            time = (2, length, seq_shard.active().block(length)[0])
        out = x
        for conv in self.convs:
            out = F.relu(conv_bn(conv, out))
        if self.conv_cat is not None:
            out = F.relu(conv_bn(self.conv_cat, torch.cat([x, out], dim=1)))
        return self.cls_seg(self.dropout(out, time))
