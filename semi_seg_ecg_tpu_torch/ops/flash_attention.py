"""Flash attention, forward and backward: CUDA kernels for Hopper and their
plain versions.

Counterpart of ``semi_seg_ecg_tpu/ops/pallas/flash_attention.py``:

- ``_fwd_kernel`` / ``_flash_forward``: ``softmax(q kᵀ · scale) v`` without
  the (N, N) score matrix in device memory, plus the fp32 row logsumexp
  that the backward consumes (``csrc/flash_attention_fwd.cu``);
- ``_bwd_kernel`` / ``_flash_backward``: dq, dk, dv recomputed blockwise
  from that logsumexp, with Δ = rowsum(dO ⊙ O) computed outside the kernel
  as the JAX package does (``csrc/flash_attention_bwd.cu``);
- the custom VJP ``flash_attention``: :class:`FlashAttention`, a
  ``torch.autograd.Function`` that saves ``(q, k, v, out, lse)``.

Each kernel file's header gives its design and what bounds it on the card.
The TPU's block picking (``pick_blocks``, ``fits_vmem``, the VMEM budget and
the padding of D to 128) encodes VMEM and has no counterpart: the kernels
tile 64 rows by 64 keys and take any N and any D up to 128.

Dispatch follows the device of the tensors: CPU tensors take
:func:`flash_attention_plain` and :func:`flash_attention_backward_plain`;
CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .attention import dense_attention

MAX_HEAD_DIM = 128

# kernel launches since import (or since a caller reset them): a run reads
# them to show that its attention went through the kernels
LAUNCHES = 0
BWD_LAUNCHES = 0

_FN = None
_BWD_FN = None
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


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, out: torch.Tensor,
                                   lse: torch.Tensor, dout: torch.Tensor,
                                   scale: float
                                   ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's function in plain PyTorch: ``(dq, dk, dv)`` in
    the inputs' dtypes, all arithmetic in fp32, P recomputed from ``lse``."""
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf = q.float(), k.float(), v.float()
        dof = dout.float()
        delta = (dof * out.float()).sum(dim=-1, keepdim=True)
        s = torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale
        p = torch.exp(s - lse.unsqueeze(-1))
        dv = torch.einsum("bhnm,bhnd->bhmd", p, dof)
        dp = torch.einsum("bhnd,bhmd->bhnm", dof, vf)
        ds = p * (dp - delta)
        dq = torch.einsum("bhnm,bhmd->bhnd", ds, kf) * scale
        dk = torch.einsum("bhnm,bhnd->bhmd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def load_kernel():
    """Build (at first use) and bind the forward kernel's C function."""
    global _FN
    if _FN is None:
        from .cuda_build import load_library

        fn = load_library("flash_attention_fwd").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def load_backward_kernel():
    """Build (at first use) and bind the backward kernels' C function."""
    global _BWD_FN
    if _BWD_FN is None:
        from .cuda_build import load_library

        fn = load_library("flash_attention_bwd").flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BWD_FN = fn
    return _BWD_FN


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


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             scale: float) -> Tuple[torch.Tensor, ...]:
    """``(dq, dk, dv)`` in the inputs' dtype for the forward's ``(out,
    lse)`` and the output gradient ``dout``. CPU tensors take the plain
    version; CUDA tensors compute Δ in PyTorch and launch the backward
    kernels on the current stream."""
    global BWD_LAUNCHES
    if not (q.is_cuda or k.is_cuda or v.is_cuda):
        return flash_attention_backward_plain(q, k, v, out, lse, dout, scale)
    _check(q, k, v)
    dout = dout.to(q.dtype).contiguous()
    out = out.contiguous()
    if dout.shape != q.shape or out.shape != q.shape or \
            lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError("flash_attention_backward: out and dout must be "
                         "(B, H, N, D) like q, lse (B, H, N) float32")
    if not (out.is_cuda and dout.is_cuda and lse.is_cuda):
        raise ValueError("flash_attention_backward: out, lse and dout must "
                         "lie on q's device")
    fn = load_backward_kernel()
    b, h, n, d = q.shape
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b * h, n, d, float(scale),
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    BWD_LAUNCHES += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``softmax(q kᵀ · scale) v`` with the flash kernels in both
    directions: the JAX package's ``jax.custom_vjp`` ``flash_attention``.
    Under ``torch.no_grad()`` nothing is saved."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                              ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Differentiable flash attention over ``(B, H, N, D)``; the output is
    in q's dtype."""
    return FlashAttention.apply(q, k, v, scale)
