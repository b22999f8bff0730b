"""Post-training calibration of int8 activation scales (serving;
counterpart of ``semi_seg_ecg_tpu/utils/calibrate.py``).

The dynamically quantized model (``quantize: int8``) reduces each int8
layer's input to its absmax before the contraction. Calibration replaces
those reductions with constants: run the forward over a few representative
batches with every :class:`~semi_seg_ecg_tpu_torch.models.quant_layers.Int8Conv1d`
/ ``Int8Linear`` recording its running activation absmax, then serve with
the recorded values, which switches every layer to static scales.

Static scales are an approximation (an activation beyond the calibrated
absmax clips at ±127 instead of rescaling), standard for post-training
quantization; calibrate on data distributed like the serving traffic.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from ..models.quant_layers import int8_modules


def calibrate_quant(model: torch.nn.Module,
                    batches: Iterable[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Record each int8 layer's activation absmax over ``batches``
    (tensors shaped like the model input, on its device; the caller sets
    the precision, as for serving) and leave ``model`` with those static
    scales (a batch's own dynamic scales are used while it records; no
    gradients, and no inference tensors, so an exported program can carry
    the scales). Returns ``{module name:
    absmax}``, the JAX package's ``quant`` collection. Raises on zero
    batches or a model without int8 layers; an earlier calibration is
    discarded."""
    layers = int8_modules(model)
    if not layers:
        raise ValueError("calibrate_quant: the model has no int8 layers "
                         "(build it with quantize: int8)")
    for _, m in layers:
        m.act_absmax = None
        m.calibrating = True
    n = 0
    try:
        with torch.no_grad():
            for x in batches:
                model(x)
                n += 1
    finally:
        for _, m in layers:
            m.calibrating = False
    if n == 0:
        for _, m in layers:
            m.act_absmax = None
        raise ValueError("calibrate_quant needs at least one batch")
    return {name: m.act_absmax for name, m in layers}
