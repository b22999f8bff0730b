"""1-D linear interpolation with ``F.interpolate(mode='linear')`` semantics
(counterpart of ``semi_seg_ecg_tpu/ops/interpolate.py``).

The decode-head logits are resized back to the input length with it. Both
``align_corners`` conventions hold: ``False`` takes source coordinate
``(i + 0.5) * in/out - 0.5`` clamped at the edges, ``True`` takes
``i * (in-1)/(out-1)``. As in the JAX package, the coordinates are computed
in float64 on the host and each output sample is two weighted taps,
``x[lo]*w_lo + x[hi]*w_hi``, so the two packages round alike. The taps
go to each device once and are kept there, so an eager forward copies
nothing from the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_coords(in_len: int, out_len: int, align_corners: bool):
    """(lo, hi, w_lo, w_hi) source taps per output sample."""
    if out_len == 1:
        src = np.zeros(1) if align_corners else np.array(
            [0.5 * in_len - 0.5]).clip(0, in_len - 1)
    elif align_corners:
        src = np.arange(out_len) * (in_len - 1) / (out_len - 1)
    else:
        src = (np.arange(out_len) + 0.5) * in_len / out_len - 0.5
        src = np.clip(src, 0.0, in_len - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_len - 1)
    w_hi = (src - lo).astype(np.float32)
    w_lo = (1.0 - w_hi).astype(np.float32)
    return lo, hi, w_lo, w_hi


@functools.lru_cache(maxsize=64)
def _device_coords(in_len: int, out_len: int, align_corners: bool,
                   device: torch.device):
    """:func:`_interp_coords` as tensors on ``device``, uploaded once;
    normal tensors even when a serving call under inference mode asks
    first, so that a training forward may save them for its backward."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device) for a in
                     _interp_coords(in_len, out_len, align_corners))


def linear_interpolate(x: torch.Tensor, size: int,
                       align_corners: bool = False,
                       time_axis: int = -1) -> torch.Tensor:
    """Resize ``x`` along ``time_axis`` to ``size`` samples, keeping its
    dtype; any rank."""
    time_axis = time_axis % x.dim()
    in_len = x.shape[time_axis]
    if in_len == size:
        return x
    if torch.compiler.is_compiling():
        # a trace (torch.export) holds its own constants; what it makes
        # are not tensors an eager call may keep
        lo, hi, w_lo, w_hi = (torch.from_numpy(a).to(x.device) for a in
                              _interp_coords(in_len, size, align_corners))
    else:
        lo, hi, w_lo, w_hi = _device_coords(in_len, size, align_corners,
                                            x.device)
    moved = x.movedim(time_axis, -1)
    out = (moved.index_select(-1, lo) * w_lo.to(x.dtype)
           + moved.index_select(-1, hi) * w_hi.to(x.dtype))
    return out.movedim(-1, time_axis)
