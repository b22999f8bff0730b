"""Time-axis gather: a CUDA kernel for Hopper and its plain version.

Counterpart of ``semi_seg_ecg_tpu/ops/pallas/gather1d.py``: the device
augmentation (``ops/preprocess.py``) resamples and rolls signals along time
with per-sample monotone position maps,

    out[b, c, j] = (1 - w) · x[b, c, i0] + w · x[b, c, i0 + 1],
    i0 = floor(pos[b, j]),  w = pos - i0,  pos in [0, T - 1],

and reads label rows at integer positions. The kernel is
``csrc/gather1d.cu``; its header gives the design and the bound. One
launch does the signal, the labels, or both
(:func:`monotonic_gather_pair`, the resize-crop's two gathers).

Dispatch follows the tensors' device: CPU tensors take
:func:`monotonic_gather_plain` (``_xla_gather``'s formula, operation for
operation); CUDA tensors launch the kernel or raise. ``max_slope`` stays in
the signatures for call-site parity with the JAX package, whose TPU kernel
sizes a static input span from it; the direct-read kernel needs no span
bound and ignores it.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches since import (or since a caller reset it): one per call
# of monotonic_gather, monotonic_gather_int or monotonic_gather_pair on
# CUDA tensors
LAUNCHES = 0

_LIB = None


def monotonic_gather_plain(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``(B, C, T), (B, J) -> (B, C,
    J)`` fp32, as ``_xla_gather`` computes it."""
    b, c, t = x.shape
    pos = pos.float()
    i0 = torch.floor(pos).long()
    w = (pos - i0.float()).unsqueeze(1)
    i1 = torch.clamp(i0 + 1, max=t - 1)
    take = lambda idx: torch.gather(x, 2, idx.unsqueeze(1).expand(
        b, c, pos.shape[1]))
    return take(i0) * (1 - w) + take(i1) * w


def load_kernels():
    """Build (at first use) and bind the kernel's C entry, ``gather1d``,
    and the empty kernel's, ``gather1d_empty``; returns the library."""
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library

        lib = load_library("gather1d")
        lib.gather1d.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                 + [ctypes.c_void_p] * 3
                                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.gather1d_empty.argtypes = [ctypes.c_void_p]
        lib.gather1d.restype = lib.gather1d_empty.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name}: the tensors must all be CUDA tensors or "
                         "all CPU tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")


def _check_lerp(name: str, x: torch.Tensor, pos: torch.Tensor) -> None:
    if x.dim() != 3 or pos.dim() != 2 or pos.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be (B, C, T) and "
                         f"pos {tuple(pos.shape)} (B, J)")


def _check_index(name: str, y: torch.Tensor, idx: torch.Tensor) -> None:
    if y.dim() != 2 or idx.dim() != 2 or idx.shape[0] != y.shape[0]:
        raise ValueError(f"{name}: y {tuple(y.shape)} must be (B, T) and idx "
                         f"{tuple(idx.shape)} (B, J)")


def _launch(name, x=None, pos=None, y=None, idx=None):
    """One launch of the kernel over the signal ``(x, pos)``, the labels
    ``(y, idx)`` or both (CUDA tensors, shapes checked); returns the
    outputs of the parts given."""
    global LAUNCHES
    if x is not None and (x.dtype != torch.float32
                          or pos.dtype != torch.float32):
        raise TypeError(f"{name}: x and pos must be float32; got {x.dtype}, "
                        f"{pos.dtype}")
    if y is not None and y.dtype not in (torch.int32, torch.int64,
                                         torch.float32):
        raise TypeError(f"{name}: y must be int32, int64 or float32; got "
                        f"{y.dtype}")
    if idx is not None and idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32; got {idx.dtype}")
    tensors = [t for t in (x, pos, y, idx) if t is not None]
    _check_cuda(name, *tensors)
    b = tensors[0].shape[0]
    if b > 65535:
        raise ValueError(f"{name}: batch {b} exceeds the grid's 65535")
    device = tensors[0].device
    out = yout = None
    signal = (None, None, None, 0, 0, 0)   # c == 0: no signal
    labels = (None, None, None, 0, 0, 4)   # jy == 0: no labels
    if x is not None:
        out = torch.empty((b, x.shape[1], pos.shape[1]), dtype=x.dtype,
                          device=device)
        signal = (x.data_ptr(), pos.data_ptr(), out.data_ptr(), x.shape[1],
                  x.shape[2], pos.shape[1])
    if y is not None:
        yout = torch.empty(idx.shape, dtype=y.dtype, device=device)
        labels = (y.data_ptr(), idx.data_ptr(), yout.data_ptr(), y.shape[1],
                  idx.shape[1], y.element_size())
    lib = load_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.gather1d(*signal[:3], b, *signal[3:], *labels, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, yout


def monotonic_gather(x: torch.Tensor, pos: torch.Tensor, *,
                     max_slope: float = 1.0) -> torch.Tensor:
    """Linear-interpolation gather along time: ``(B, C, T)`` fp32 and ``(B,
    J)`` positions in ``[0, T-1]`` -> ``(B, C, J)`` fp32."""
    del max_slope  # a TPU span-sizing hint; the direct read has no span
    _check_lerp("monotonic_gather", x, pos)
    if not (x.is_cuda or pos.is_cuda):
        return monotonic_gather_plain(x, pos)
    return _launch("monotonic_gather", x=x, pos=pos)[0]


def monotonic_gather_int(y: torch.Tensor, idx: torch.Tensor, *,
                         max_slope: float = 1.0) -> torch.Tensor:
    """Nearest gather of label rows: ``(B, T)`` and integer ``(B, J)``
    indices in ``[0, T-1]`` -> ``(B, J)`` in y's dtype. The JAX package
    routes this through its float kernel at w = 0 (a TPU workaround); here
    the kernel reads the rows directly."""
    del max_slope
    _check_index("monotonic_gather_int", y, idx)
    if not (y.is_cuda or idx.is_cuda):
        return torch.gather(y, 1, idx.long())
    return _launch("monotonic_gather_int", y=y, idx=idx)[1]


def monotonic_gather_pair(x: torch.Tensor, pos: torch.Tensor,
                          y: torch.Tensor, idx: torch.Tensor):
    """:func:`monotonic_gather` of ``(x, pos)`` and
    :func:`monotonic_gather_int` of ``(y, idx)`` for one batch, in one
    launch: ``-> (x_out, y_out)``. The resize-crop's signal and labels."""
    _check_lerp("monotonic_gather_pair", x, pos)
    _check_index("monotonic_gather_pair", y, idx)
    if y.shape[0] != x.shape[0]:
        raise ValueError(f"monotonic_gather_pair: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} have different batch sizes")
    if not any(t.is_cuda for t in (x, pos, y, idx)):
        return (monotonic_gather_plain(x, pos),
                torch.gather(y, 1, idx.long()))
    return _launch("monotonic_gather_pair", x=x, pos=pos, y=y, idx=idx)
