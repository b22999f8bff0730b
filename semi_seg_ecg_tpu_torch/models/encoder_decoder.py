"""EncoderDecoder wrapper (counterpart of
``semi_seg_ecg_tpu/models/encoder_decoder.py``).

Contract as in the JAX package: inputs ``(B, leads, T)`` in, ``seg_logits``
``(B, num_classes, T)`` out — backbone feature tuple, decode head, logits
linearly interpolated back to the input length. With ``return_loss`` the
output also holds the cross-entropy ``loss`` against ``labels``. Auxiliary
heads (attached by ``build_model_from_config`` for training builds only)
run in train mode and add ``aux_seg_logits``, one entry per head, and with
labels ``loss_aux``, one loss per head: the JAX package's correction of the
reference's auxiliary-head block. With ``return_latent`` it holds the ReCo
projection's ``latent`` too. Under a split time axis
(``parallel/seq_shard.py``) every output is this seq rank's block of the
input's time axis: the heads and the projection run on the features'
blocks, and each resize is the split one (``seq_shard.linear_interpolate``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.interpolate import linear_interpolate
from ..ops.losses import cross_entropy
from ..parallel import seq_shard
from .norm import TorchBatchNorm


class LatentProjection(nn.Sequential):
    """The ReCo projection head: Conv(k3) → ReLU → BN → Conv(k1), both
    convolutions bias-free, the reference's ReLU-before-BN order kept
    (reference encoder_decoder.py:31-48). Its keys are the reference's,
    ``latent_projection.{0,2,3}.*``. ``in_channels`` is the config's
    ``projection_in_dim`` (flax infers it)."""

    def __init__(self, in_channels: int, out_dim: int):
        super().__init__(
            nn.Conv1d(in_channels, out_dim, 3, padding=1, bias=False),
            nn.ReLU(),
            # flax's momentum 0.9 is torch's 0.1
            TorchBatchNorm(out_dim, eps=1e-5, momentum=0.1),
            nn.Conv1d(out_dim, out_dim, 1, bias=False))

    def forward(self, x: torch.Tensor,
                length: Optional[int] = None) -> torch.Tensor:
        """``length``: the global length of a split time axis
        (``parallel/seq_shard.py``; the k3 convolution fetches its halos),
        None: ``x`` whole."""
        if length is None:
            return super().forward(x)
        x = seq_shard.conv_module(self[0], x, length)[0]
        return self[3](self[2](self[1](x)))


class EncoderDecoder(nn.Module):
    def __init__(self, backbone: nn.Module, decode_head: nn.Module,
                 auxiliary_heads: Optional[Sequence[nn.Module]] = None,
                 latent_projection: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.decode_head = decode_head
        self.auxiliary_heads = (nn.ModuleList(auxiliary_heads)
                                if auxiliary_heads else None)
        self.latent_projection = latent_projection

    @property
    def with_auxiliary_heads(self) -> bool:
        return self.auxiliary_heads is not None

    def no_weight_decay(self) -> set:
        """The names ``train.layer_decay`` exempts from weight decay: the
        backbone's and the decode head's."""
        names = set()
        for m in (self.backbone, self.decode_head):
            if hasattr(m, "no_weight_decay"):
                names |= m.no_weight_decay()
        return names

    def forward(self, inputs: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                return_loss: bool = False,
                return_latent: bool = False,
                train: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """``train`` selects the module mode for this call (the JAX
        package's ``train=`` flag); left as None, the mode is the module's
        own (``model.train()`` / ``model.eval()``)."""
        if train is not None and train != self.training:
            was = self.training
            self.train(train)
            try:
                return self.forward(inputs, labels, return_loss,
                                    return_latent)
            finally:
                self.train(was)
        shard = seq_shard.active()
        seq_len = inputs.shape[2] if shard is None else shard.length
        feats = self.backbone(inputs)
        if shard is None:
            lengths = [None] * len(feats)

            def resize(x, length, align_corners):
                return linear_interpolate(x, seq_len,
                                          align_corners=align_corners)
        else:
            lengths = list(self.backbone.feature_lengths(seq_len))

            def resize(x, length, align_corners):
                return seq_shard.linear_interpolate(x, length, seq_len,
                                                    align_corners)
        outputs = {}
        if return_latent:
            latent = feats[-1]
            if self.latent_projection is not None:
                latent = self.latent_projection(latent, lengths[-1])
            outputs["latent"] = resize(latent, lengths[-1],
                                       self.decode_head.align_corners)

        def head_logits(head):
            length = lengths[head.in_index]
            seg = head(feats) if length is None else head(feats, length)
            return resize(seg, length, head.align_corners)

        seg = head_logits(self.decode_head)  # (B, classes, T)
        outputs["seg_logits"] = seg
        if return_loss:
            outputs["loss"] = cross_entropy(seg, labels)
        if self.training and self.with_auxiliary_heads:
            aux_logits = [head_logits(head) for head in self.auxiliary_heads]
            outputs["aux_seg_logits"] = aux_logits
            if return_loss and labels is not None:
                outputs["loss_aux"] = [cross_entropy(a, labels)
                                       for a in aux_logits]
        return outputs
