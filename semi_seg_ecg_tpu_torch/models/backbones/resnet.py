"""1-D ResNet backbone (counterpart of
``semi_seg_ecg_tpu/models/backbones/resnet.py``).

Input ``(B, leads, T)``; output a tuple of NCW stage features at
``out_indices``. The stem is a k7/s2 Conv-BN-ReLU (or, with ``deep_stem``,
three k3 ones), then a k3/s2/p1 max pool; four stages of
:class:`BasicBlock` or :class:`Bottleneck` with configurable strides,
dilations, ``contract_dilation``, ``multi_grid`` and ``avg_down``. Convs
draw from Kaiming-normal fan-out (the reference's and the JAX package's
init, from PyTorch's global RNG, which ``algorithms/common.init_model``
seeds); ``zero_init_residual`` zeroes each block's last BN scale.

Module names follow the reference's torch keys, the key space
``semi_seg_ecg_tpu/utils/torch_interop.py`` maps the JAX trees to:
``stem.{3i}`` conv and ``stem.{3i+1}`` BN (ReLU at ``3i+2``),
``layer{s}.{j}.conv{k}`` / ``.bn{k}``, and ``layer{s}.{j}.downsample.{0,1}``,
``.{1,2}`` under ``avg_down`` (an ``AvgPool1d`` first).

The stem pool is ``nn.MaxPool1d``: its backward routes a tied window's
gradient to the earliest element, as the JAX package's closed-form VJP
(``ops/pooling.py``) does. The stem and the first ``frozen_stages`` stages
stay in eval mode in training (batch statistics neither used nor updated),
as in the JAX package; freezing their parameters is the optimizer's job.
With ``remat`` each residual block is checkpointed (``models/remat.py``),
as the JAX package wraps each in ``nn.remat``. ``quantize='int8'``
(serving) runs every convolution in int8 (``models/quant_layers.py``), as
the JAX package quantizes every ``ConvBN``.

Under a split time axis (``parallel.seq_parallel``,
``parallel/seq_shard.py``) the stem, the max pool, every block's
convolutions and the downsample path run on the rank's block of each
layer's global length and fetch the halos they reach (the JAX package's
GSPMD partition of the same convolutions); :meth:`ResNet1D.feature_lengths`
gives the stage outputs' global lengths.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel import seq_shard
from ..norm import TorchBatchNorm
from ..quant_layers import conv1d
from ..remat import remat_call


def _conv(in_channels: int, features: int, kernel_size: int,
          stride: int = 1, dilation: int = 1,
          quantize: Optional[str] = None) -> nn.Conv1d:
    """The conv of a Conv-BN pair (the JAX package's ``ConvBN``), in int8
    with ``quantize='int8'``."""
    pad = (kernel_size // 2) * dilation
    return conv1d(quantize, in_channels, features, kernel_size,
                  stride=stride, padding=pad, dilation=dilation, bias=False)


class ConvBN(nn.Sequential):
    """Conv1d (no bias) + BatchNorm over NCW. As a ``Sequential`` its keys
    are ``0.weight`` (conv) and ``1.*`` (norm), the reference's layout."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1,
                 quantize: Optional[str] = None):
        super().__init__(
            _conv(in_channels, features, kernel_size, stride, dilation,
                  quantize),
            TorchBatchNorm(features),
        )


def _downsample(in_channels: int, features: int, stride: int,
                avg_down: bool,
                quantize: Optional[str] = None) -> nn.Sequential:
    """The identity path's projection: a strided 1x1 Conv-BN, or with
    ``avg_down`` (and a stride) an average pool, then a 1x1 Conv-BN."""
    layers = []
    if avg_down and stride != 1:
        layers.append(nn.AvgPool1d(stride, stride=stride, ceil_mode=True,
                                   count_include_pad=False))
        stride = 1
    layers += [_conv(in_channels, features, 1, stride, quantize=quantize),
               TorchBatchNorm(features)]
    return nn.Sequential(*layers)


def _sharded_path(layers: nn.Sequential, x: torch.Tensor, length: int):
    """A Conv/BN/pool path (the stem's conv, the downsample) on this seq
    rank's block of a global ``length``: ``(y, out_length)``."""
    for layer in layers:
        if isinstance(layer, nn.Conv1d):
            x, length = seq_shard.conv_module(layer, x, length)
        elif isinstance(layer, nn.AvgPool1d):
            x, length = seq_shard.avg_pool1d(x, length, layer.kernel_size[0],
                                             layer.stride[0])
        else:
            x = layer(x)
    return x, length


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False,
                 avg_down: bool = False, quantize: Optional[str] = None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation, quantize)
        self.bn1 = TorchBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, quantize=quantize)
        self.bn2 = TorchBatchNorm(planes)
        self.downsample = (_downsample(inplanes, planes, stride, avg_down,
                                       quantize)
                           if has_downsample else None)

    @property
    def last_bn(self) -> nn.BatchNorm1d:
        return self.bn2

    def out_length(self, length: int) -> int:
        return _out_length(self.conv1, length)

    def forward(self, x: torch.Tensor,
                length: Optional[int] = None) -> torch.Tensor:
        """``length``: the global length of ``x``'s split time axis (None:
        ``x`` is whole)."""
        if length is None:
            out = F.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            identity = x if self.downsample is None else self.downsample(x)
            return F.relu(out + identity)
        out, mid = seq_shard.conv_module(self.conv1, x, length)
        out = F.relu(self.bn1(out))
        out = self.bn2(seq_shard.conv_module(self.conv2, out, mid)[0])
        identity = x if self.downsample is None else _sharded_path(
            self.downsample, x, length)[0]
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False,
                 avg_down: bool = False, quantize: Optional[str] = None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1, quantize=quantize)
        self.bn1 = TorchBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation, quantize)
        self.bn2 = TorchBatchNorm(planes)
        self.conv3 = _conv(planes, out, 1, quantize=quantize)
        self.bn3 = TorchBatchNorm(out)
        self.downsample = (_downsample(inplanes, out, stride, avg_down,
                                       quantize)
                           if has_downsample else None)

    @property
    def last_bn(self) -> nn.BatchNorm1d:
        return self.bn3

    def out_length(self, length: int) -> int:
        return _out_length(self.conv2, length)

    def forward(self, x: torch.Tensor,
                length: Optional[int] = None) -> torch.Tensor:
        """``length``: as :meth:`BasicBlock.forward`'s."""
        if length is None:
            out = F.relu(self.bn1(self.conv1(x)))
            out = F.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            identity = x if self.downsample is None else self.downsample(x)
            return F.relu(out + identity)
        out = F.relu(self.bn1(self.conv1(x)))    # 1x1: no halo
        out, mid = seq_shard.conv_module(self.conv2, out, length)
        out = self.bn3(self.conv3(F.relu(self.bn2(out))))
        identity = x if self.downsample is None else _sharded_path(
            self.downsample, x, length)[0]
        return F.relu(out + identity)


def _out_length(conv: nn.Conv1d, length: int) -> int:
    return seq_shard.conv_out_length(length, conv.kernel_size[0],
                                     conv.stride[0], conv.padding[0],
                                     conv.dilation[0])


class ResNet1D(nn.Module):
    def __init__(self, num_leads: int, stem_channels: int = 64,
                 base_channels: int = 64, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 deep_stem: bool = False, avg_down: bool = False,
                 frozen_stages: int = -1,
                 multi_grid: Optional[Sequence[int]] = None,
                 contract_dilation: bool = False, block: str = "basic",
                 stage_blocks: Sequence[int] = (2, 2, 2, 2),
                 zero_init_residual: bool = False,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 remat: bool = False, quantize: Optional[str] = None):
        super().__init__()
        if not 1 <= num_stages <= 4:
            raise ValueError("num_stages should be in [1, 4]")
        if not len(strides) == len(dilations) == num_stages:
            raise ValueError(
                "strides and dilations should be lists of the same length "
                f"as num_stages, but got {len(strides)}, {len(dilations)} "
                f"and {num_stages}")
        self.frozen_stages = frozen_stages
        self.out_indices = tuple(out_indices)
        self.remat = remat
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.feat_dim = (block_cls.expansion * base_channels
                         * 2 ** (num_stages - 1))

        if deep_stem:
            half = stem_channels // 2
            plan = [(num_leads, half, 3, 2), (half, half, 3, 1),
                    (half, stem_channels, 3, 1)]
        else:
            plan = [(num_leads, stem_channels, 7, 2)]
        stem = []
        for cin, cout, kernel_size, stride in plan:
            stem += [_conv(cin, cout, kernel_size, stride,
                           quantize=quantize),
                     TorchBatchNorm(cout), nn.ReLU()]
        self.stem = nn.Sequential(*stem)
        self.maxpool = nn.MaxPool1d(3, stride=2, padding=1)

        inplanes = stem_channels
        stage_blocks = tuple(stage_blocks)[:num_stages]
        for i, num_blocks in enumerate(stage_blocks):
            planes = base_channels * 2 ** i
            dilation = dilations[i]
            grid = multi_grid if i == len(stage_blocks) - 1 else None
            if grid is None:
                first = (dilation // 2 if dilation > 1 and contract_dilation
                         else dilation)
            else:
                first = grid[0]
            blocks = [block_cls(
                inplanes, planes, strides[i], first,
                has_downsample=(strides[i] != 1
                                or inplanes != planes * block_cls.expansion),
                avg_down=avg_down, quantize=quantize)]
            inplanes = planes * block_cls.expansion
            for j in range(1, num_blocks):
                blocks.append(block_cls(
                    inplanes, planes,
                    dilation=dilation if grid is None else grid[j],
                    quantize=quantize))
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_layers = len(stage_blocks)
        self._init_weights(zero_init_residual)

    def _init_weights(self, zero_init_residual: bool) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv1d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")
            elif isinstance(m, (BasicBlock, Bottleneck)) and \
                    zero_init_residual:
                nn.init.zeros_(m.last_bn.weight)

    def train(self, mode: bool = True):
        """The stem (``frozen_stages >= 0``) and stages ``1..frozen_stages``
        stay in eval mode, as the JAX package's ``stem_train`` /
        ``stage_train`` flags run them."""
        super().train(mode)
        if self.frozen_stages >= 0:
            self.stem.train(False)
        for i in range(1, min(self.frozen_stages, self.num_layers) + 1):
            getattr(self, f"layer{i}").train(False)
        return self

    def no_weight_decay(self) -> set:
        return set()

    def feature_lengths(self, length: int) -> Tuple[int, ...]:
        """The global time lengths of :meth:`forward`'s features for an
        input of ``length`` samples."""
        for layer in self.stem:
            if isinstance(layer, nn.Conv1d):
                length = _out_length(layer, length)
        length = (length + 2 - 3) // 2 + 1   # the k3/s2/p1 max pool
        out = []
        for i in range(self.num_layers):
            for block in getattr(self, f"layer{i + 1}"):
                length = block.out_length(length)
            if i in self.out_indices:
                out.append(length)
        return tuple(out)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        shard = seq_shard.active()
        if shard is None:
            x = self.maxpool(self.stem(x))
            length = None
        else:
            x, length = _sharded_path(self.stem, x, shard.length)
            x, length = seq_shard.max_pool1d(x, length, 3, 2, 1)
        outs = []
        for i in range(self.num_layers):
            for block in getattr(self, f"layer{i + 1}"):
                args = () if length is None else (length,)
                x = (remat_call(block, x, *args)
                     if self.remat and self.training else block(x, *args))
                if length is not None:
                    length = block.out_length(length)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


def _factory(block: str, stage_blocks):
    def make(num_leads: int, **kwargs) -> ResNet1D:
        kwargs.setdefault("block", block)
        kwargs.setdefault("stage_blocks", tuple(stage_blocks))
        return ResNet1D(num_leads=num_leads, **kwargs)

    return make


resnet18 = _factory("basic", (2, 2, 2, 2))
resnet34 = _factory("basic", (3, 4, 6, 3))
resnet50 = _factory("bottleneck", (3, 4, 6, 3))
resnet101 = _factory("bottleneck", (3, 4, 23, 3))
resnet152 = _factory("bottleneck", (3, 8, 36, 3))
