"""Flash-attention forward: a CUDA kernel for Hopper and its plain version.

Counterpart of ``semi_seg_ecg_tpu/ops/pallas/flash_attention.py``
``_fwd_kernel`` / ``_flash_forward``: ``softmax(q kᵀ · scale) v`` without the
(N, N) score matrix in device memory, plus the fp32 row logsumexp that a
backward pass consumes. The kernel is ``csrc/flash_attention_fwd.cu``; its
header gives the design and what bounds it on the card. The TPU's block
picking (``pick_blocks``, ``fits_vmem``, the VMEM budget and the padding of
D to 128) encodes VMEM and has no counterpart: the kernel tiles 64 q rows
by 64 keys and takes any N and any D up to 128.

Dispatch follows the device of the tensors: CPU tensors take
:func:`flash_attention_plain`; CUDA tensors launch the kernel or raise. The
backward kernel is not ported yet, so a CUDA input that needs a gradient
raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .attention import dense_attention

MAX_HEAD_DIM = 128

# kernel launches since import (or since a caller reset it): a run reads it
# to show that its attention went through the kernel
LAUNCHES = 0

_FN = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``(out, lse)`` with ``out``
    in q's dtype and ``lse`` fp32 ``(B, H, N)``, all arithmetic in fp32."""
    out = dense_attention(q, k, v, scale, mm_dtype=torch.float32)
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
        lse = torch.logsumexp(logits, dim=-1)
    return out.to(q.dtype), lse


def load_kernel():
    """Build (at first use) and bind the kernel's C function."""
    global _FN
    if _FN is None:
        from .cuda_build import load_library

        fn = load_library("flash_attention_fwd").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_forward: q, k, v must all be CUDA "
                         "tensors or all CPU tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_forward: q, k, v on different "
                         f"devices ({q.device}, {k.device}, {v.device})")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention_forward: q, k, v must share one "
                        "dtype, float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or not (q.shape == k.shape == v.shape):
        raise ValueError("flash_attention_forward: q, k, v must be (B, H, "
                         f"N, D) of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, n, d = q.shape
    if not 0 < d <= MAX_HEAD_DIM or n < 1 or not 0 < b * h <= 65535:
        raise ValueError(f"flash_attention_forward: shape {tuple(q.shape)} "
                         f"outside the kernel's range (1 <= D <= "
                         f"{MAX_HEAD_DIM}, N >= 1, 1 <= B*H <= 65535)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_forward: q, k, v must be "
                         "contiguous")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention_forward: backward not yet ported (the CUDA "
            "kernel is forward-only); run under torch.no_grad() or use "
            "attention_impl: xla")


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` for ``(B, H, N, D)`` q, k, v: ``out`` in q's dtype,
    ``lse`` fp32 ``(B, H, N)``. CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream."""
    global LAUNCHES
    if not (q.is_cuda or k.is_cuda or v.is_cuda):
        return flash_attention_plain(q, k, v, scale)
    _check(q, k, v)
    fn = load_kernel()
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b * h, n, d, float(scale),
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out, lse
