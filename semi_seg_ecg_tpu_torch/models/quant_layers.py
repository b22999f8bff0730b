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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.quant import QMAX, _div, int8_conv1d, int8_linear


class _Int8Mixin:
    """The activation-scale state shared by the int8 modules."""

    def _init_quant(self) -> None:
        self.calibrating = False
        self.register_buffer("act_absmax", None, persistent=False)

    def _act_scale(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """Calibrating: record the running absmax, return None (dynamic
        this pass). Calibrated: the static scale. Neither: None."""
        if self.calibrating:
            seen = x.detach().abs().amax().float()
            self.act_absmax = (seen if self.act_absmax is None
                               else torch.maximum(self.act_absmax, seen))
            return None
        if self.act_absmax is not None:
            return _div(self.act_absmax, QMAX)
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


class Int8Linear(_Int8Mixin, nn.Linear):
    """``nn.Linear`` with the matmul in int8 → int32."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_quant()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear(x, self.weight, self.bias,
                           out_dtype=self._out_dtype(x),
                           act_scale=self._act_scale(x))


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
