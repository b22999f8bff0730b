"""Time-axis gather: a CUDA kernel for Hopper and its plain version.

Counterpart of ``semi_seg_ecg_tpu/ops/pallas/gather1d.py``: the device
augmentation (``ops/preprocess.py``) resamples and rolls signals along time
with per-sample monotone position maps,

    out[b, c, j] = (1 - w) · x[b, c, i0] + w · x[b, c, i0 + 1],
    i0 = floor(pos[b, j]),  w = pos - i0,  pos in [0, T - 1],

and reads label rows at integer positions. The kernel is
``csrc/gather1d.cu``; its header gives the design and the bound.

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

# kernel launches since import (or since a caller reset it), both variants
LAUNCHES = 0

_FNS = None


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
    """Build (at first use) and bind the two C functions."""
    global _FNS
    if _FNS is None:
        from .cuda_build import load_library

        lib = load_library("gather1d")
        lerp, index = lib.gather1d_lerp, lib.gather1d_index
        lerp.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        index.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lerp.restype = index.restype = ctypes.c_int
        _FNS = (lerp, index)
    return _FNS


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name}: the tensors must all be CUDA tensors or "
                         "all CPU tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")


def _launched(name: str, err: int) -> None:
    global LAUNCHES
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES += 1


def monotonic_gather(x: torch.Tensor, pos: torch.Tensor, *,
                     max_slope: float = 1.0) -> torch.Tensor:
    """Linear-interpolation gather along time: ``(B, C, T)`` fp32 and ``(B,
    J)`` positions in ``[0, T-1]`` -> ``(B, C, J)`` fp32."""
    del max_slope  # a TPU span-sizing hint; the direct read has no span
    if x.dim() != 3 or pos.dim() != 2 or pos.shape[0] != x.shape[0]:
        raise ValueError(f"monotonic_gather: x {tuple(x.shape)} must be (B, "
                         f"C, T) and pos {tuple(pos.shape)} (B, J)")
    if not (x.is_cuda or pos.is_cuda):
        return monotonic_gather_plain(x, pos)
    if x.dtype != torch.float32 or pos.dtype != torch.float32:
        raise TypeError(f"monotonic_gather: x and pos must be float32; got "
                        f"{x.dtype}, {pos.dtype}")
    _check_cuda("monotonic_gather", x, pos)
    b, c, t = x.shape
    out = torch.empty((b, c, pos.shape[1]), dtype=x.dtype, device=x.device)
    lerp, _ = load_kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lerp(x.data_ptr(), pos.data_ptr(), out.data_ptr(), b, c, t,
                   pos.shape[1], stream)
    _launched("gather1d_lerp", err)
    return out


def monotonic_gather_int(y: torch.Tensor, idx: torch.Tensor, *,
                         max_slope: float = 1.0) -> torch.Tensor:
    """Nearest gather of label rows: ``(B, T)`` and integer ``(B, J)``
    indices in ``[0, T-1]`` -> ``(B, J)`` in y's dtype. The JAX package
    routes this through its float kernel at w = 0 (a TPU workaround); here
    the kernel reads the rows directly."""
    del max_slope
    if y.dim() != 2 or idx.dim() != 2 or idx.shape[0] != y.shape[0]:
        raise ValueError(f"monotonic_gather_int: y {tuple(y.shape)} must be "
                         f"(B, T) and idx {tuple(idx.shape)} (B, J)")
    if not (y.is_cuda or idx.is_cuda):
        return torch.gather(y, 1, idx.long())
    if y.dtype not in (torch.int32, torch.int64, torch.float32):
        raise TypeError(f"monotonic_gather_int: y must be int32, int64 or "
                        f"float32; got {y.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"monotonic_gather_int: idx must be int32; got "
                        f"{idx.dtype}")
    _check_cuda("monotonic_gather_int", y, idx)
    b, t = y.shape
    out = torch.empty((b, idx.shape[1]), dtype=y.dtype, device=y.device)
    _, index = load_kernels()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = index(y.data_ptr(), idx.data_ptr(), out.data_ptr(), b, t,
                    idx.shape[1], y.element_size(), stream)
    _launched("gather1d_index", err)
    return out
