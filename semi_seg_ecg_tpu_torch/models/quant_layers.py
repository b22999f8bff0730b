"""Modules that run their contraction in int8 (serving; counterpart of
``semi_seg_ecg_tpu/models/quant_layers.py``).

:class:`Int8Conv1d` and :class:`Int8Linear` subclass ``nn.Conv1d`` and
``nn.Linear`` with the same parameters, so their ``state_dict`` keys are
the float modules' and every float checkpoint loads into the int8 model
unchanged: int8 serving is a config flip (``quantize: int8``). See
:mod:`semi_seg_ecg_tpu_torch.ops.quant` for the numerics.

The activation scale follows the JAX package's ``_act_scale``: while
``calibrating``, a module records the running absmax of its input
(``act_absmax``) and quantizes dynamically; once it holds an
``act_absmax`` and is not calibrating, it uses the static ``absmax / 127``;
otherwise the dynamic scale of the live batch. ``act_absmax`` is a
non-persistent buffer: a strict load of a float checkpoint still works,
it follows the module to its device, and ``torch.export`` carries it into
the serving artifact as a constant of the program.

Under ``torch.autocast`` the output has the autocast dtype, as the float
module's would (the JAX layers output ``self.dtype``); otherwise the
input's dtype.

Split inputs (the JAX package quantizes the global arrays): the
per-tensor absmax, dynamic or recorded while calibrating, is the maximum
over the ranks that hold pieces of the input (``parallel/seq_shard.absmax``):
the seq group under a split time axis, for every int8 layer there, and
the model group for a row-parallel layer (the ViT's ``to_out.0`` and
``ff.fn.net.3`` under tensor parallelism, whose inputs are a model rank's
heads or hidden columns; :meth:`Int8Linear.row_parallel`). The replicated
inputs of ``to_qkv`` and ``net.0`` take no collective. An int8 convolution
on a split time axis quantizes its block with the global scale and then
fetches its halos as int8 codes (:meth:`Int8Conv1d.split_forward`), so its
codes are the whole tensor's, the zero padding at the global edges added
after quantizing as in one process. Without a split every layer computes
as before, with no collective.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.quant import (
    QMAX,
    _div,
    dequantize,
    int8_conv1d,
    int8_linear,
    int_conv1d,
    int_matmul,
    quantize_absmax,
    quantize_input,
    quantize_symmetric,
)
from ..parallel import dist as pdist
from ..parallel import seq_shard


class _Int8Mixin:
    """The activation-scale state shared by the int8 modules."""

    def _init_quant(self) -> None:
        self.calibrating = False
        self.register_buffer("act_absmax", None, persistent=False)

    def _act_scale(self, x: torch.Tensor,
                   model_group=None) -> Optional[torch.Tensor]:
        """Calibrating: record the running absmax, and quantize dynamically
        this pass. Calibrated: the static scale. Neither: the dynamic scale.
        None stands for the dynamic scale of ``x`` itself; where ``x`` is a
        piece of a split input (a split time axis, or ``model_group``) the
        absmax is the global one's, and its scale is returned."""
        split = seq_shard.active() is not None or model_group is not None
        if self.calibrating:
            seen = seq_shard.absmax(x, model_group)
            self.act_absmax = (seen if self.act_absmax is None
                               else torch.maximum(self.act_absmax, seen))
            return _div(seen, QMAX) if split else None
        if self.act_absmax is not None:
            return _div(self.act_absmax, QMAX)
        if split:
            return _div(seq_shard.absmax(x, model_group), QMAX)
        return None

    @staticmethod
    def _out_dtype(x: torch.Tensor) -> torch.dtype:
        device_type = x.device.type
        if torch.is_autocast_enabled(device_type):
            return torch.get_autocast_dtype(device_type)
        return x.dtype


class Int8Conv1d(_Int8Mixin, nn.Conv1d):
    """``nn.Conv1d`` (zero padding, one group) with the contraction in
    int8 → int32."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.groups != 1 or self.padding_mode != "zeros" or \
                isinstance(self.padding, str):
            raise ValueError("Int8Conv1d takes one group and numeric zero "
                             "padding")
        self._init_quant()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_conv1d(x, self.weight, self.bias, stride=self.stride[0],
                           padding=self.padding[0],
                           dilation=self.dilation[0],
                           out_dtype=self._out_dtype(x),
                           act_scale=self._act_scale(x))

    def split_forward(self, x: torch.Tensor, length: int, shard
                      ) -> Tuple[torch.Tensor, int]:
        """``(y, out_length)``: this seq rank's block of the convolution
        over a split time axis of ``length`` samples
        (``seq_shard.conv_module``): the block quantized with the global
        scale, the halos fetched as codes (zero outside the signal), the
        int32 convolution without padding, dequantized."""
        (stride,), (dilation,), (padding,) = (self.stride, self.dilation,
                                              self.padding)
        out_len, ranges = seq_shard.conv_ranges(
            shard, length, self.kernel_size[0], stride, padding, dilation)
        xq, sx = quantize_input(x, self._act_scale(x))
        codes = torch.cat(seq_shard.halo_parts(xq, length, ranges, 0, shard),
                          dim=-1)
        kq, sk = quantize_symmetric(self.weight, dim=(1, 2))
        acc = int_conv1d(codes, kq, stride, 0, dilation)
        out = dequantize(acc.transpose(1, 2), sx, sk, self.bias,
                         self._out_dtype(x))
        return out.transpose(1, 2), out_len


class Int8Linear(_Int8Mixin, nn.Linear):
    """``nn.Linear`` with the matmul in int8 → int32."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_quant()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear(x, self.weight, self.bias,
                           out_dtype=self._out_dtype(x),
                           act_scale=self._act_scale(x))

    def row_parallel(self, x: torch.Tensor, group) -> torch.Tensor:
        """The row-parallel layer over the model ``group`` (this rank's
        input columns of the weight, ``x`` its block of the input
        features): the input and each output channel of the weight
        quantized with their global absmax, this rank's exact int32
        partial sums summed over the group, then dequantized and the bias
        added once; one process's :func:`int8_linear`, code for code."""
        xq, sx = quantize_input(x, self._act_scale(x, group))
        w = self.weight.float()
        w_max = w.abs().amax(dim=1, keepdim=True)
        kq, sk = quantize_absmax(w, pdist.all_reduce_max_(w_max, group))
        lead = x.shape[:-1]
        acc = pdist.all_reduce_sum_(
            int_matmul(xq.reshape(-1, x.shape[-1]), kq).contiguous(), group)
        out = dequantize(acc, sx, sk, self.bias, self._out_dtype(x))
        return out.reshape(*lead, self.weight.shape[0])


def int8_modules(model: nn.Module):
    """``(name, module)`` of every int8 module of ``model``."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, _Int8Mixin)]


def conv1d(quantize: Optional[str], *args, **kwargs) -> nn.Conv1d:
    """``nn.Conv1d``, or :class:`Int8Conv1d` when ``quantize == 'int8'``."""
    return (Int8Conv1d if _check(quantize) else nn.Conv1d)(*args, **kwargs)


def linear(quantize: Optional[str], *args, **kwargs) -> nn.Linear:
    """``nn.Linear``, or :class:`Int8Linear` when ``quantize == 'int8'``."""
    return (Int8Linear if _check(quantize) else nn.Linear)(*args, **kwargs)


def _check(quantize: Optional[str]) -> bool:
    if quantize not in (None, "int8"):
        raise ValueError(f"Unsupported quantize: {quantize!r}")
    return quantize == "int8"
