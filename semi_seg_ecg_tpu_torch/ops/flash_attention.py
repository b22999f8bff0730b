"""Flash attention, forward and backward: CUDA kernels for Hopper and their
plain versions.

Counterpart of ``semi_seg_ecg_tpu/ops/pallas/flash_attention.py``:

- ``_fwd_kernel`` / ``_flash_forward``: ``softmax(q kᵀ · scale) v`` without
  the (N, N) score matrix in device memory, plus the fp32 row logsumexp
  that the backward consumes (``csrc/flash_attention_fwd.cu``);
- ``_bwd_kernel`` / ``_flash_backward``: dq, dk, dv recomputed blockwise
  from that logsumexp (``csrc/flash_attention_bwd.cu``; Δ = rowsum(dO ⊙ O),
  which the JAX package computes outside its kernel, is the dQ kernel's
  own work);
- the custom VJP ``flash_attention``: the forward is the PyTorch operator
  ``semi_seg_ecg_tpu_torch::flash_attention_forward`` (``torch.library``,
  with a fake that gives ``torch.export`` its output's shapes and strides),
  whose autograd formula saves ``(q, k, v, out, lse)`` and launches the
  backward kernels.

Each kernel file's header gives its design and what bounds it on the card.
The TPU's block picking (``pick_blocks``, ``fits_vmem``, the VMEM budget and
the padding of D to 128) encodes VMEM and has no counterpart: the kernels
tile 64 rows by 64 keys and take any N and any D up to 128, in the layout
the operands come in (:func:`check_layout`). Both dtypes run on the tensor
cores. bf16 rounds P and dS to bf16 as operands; :func:`forward_error_bound`
and :func:`backward_error_bound` give the tolerance that follows from that.
fp32 forms every product from three TF32 products of operands split into a
high and a low TF32 part (3xTF32), which keeps fp32's accuracy: the kernels
are held to fp32 tolerances (``FWD_TOL_FP32``, ``BWD_TOL_FP32``), and the
TF32 flags of cuBLAS and cuDNN do not apply to them.

Dispatch follows the device of the tensors: CPU tensors take
:func:`flash_attention_plain` and :func:`flash_attention_backward_plain`;
CUDA tensors launch the kernels or raise. A traced or exported program
(``serving.export_serving``) calls the operator, so it launches the kernel
as an eager forward does, and tracing it launches nothing.
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


class _Tensor4(ctypes.Structure):
    """The kernels' ``Tensor4``: a (B, H, N, D) operand's base pointer and
    its element strides along B, H and N (D has stride 1)."""

    _fields_ = [("ptr", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("sh", ctypes.c_longlong), ("sn", ctypes.c_longlong)]


def _desc(t: torch.Tensor):
    return ctypes.byref(_Tensor4(t.data_ptr(), *t.stride()[:3]))


# unit roundoff of bf16 (8 significant bits), and one bf16 ulp relative to
# the value, the rounding of the result itself
BF16_UNIT_ROUNDOFF = 2.0 ** -8
BF16_ULP = 2.0 ** -7
# the fp32 kernels against the plain versions, (atol, rtol): the forward's
# 3xTF32 products are within a few fp32 roundings of fp32 ones and are
# summed in another order; each backward gradient sums N products.
# lse within LSE_ATOL in both dtypes
FWD_TOL_FP32 = (1e-5, 0.0)
BWD_TOL_FP32 = (1e-4, 1e-4)
LSE_ATOL = 1e-4


def forward_error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Per-element tolerance of the bf16 kernel's ``out`` against
    :func:`flash_attention_plain`, in plain fp32: the kernel rounds each
    probability (a relative error of at most u = 2^-8) before P V, so
    ``|out − plain| <= u · (P |V|)``, doubled for the fp32 sums; plus one
    bf16 ulp of the result (both round it) and 1e-5."""
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf = q.float(), k.float(), v.float()
        p = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale,
                          dim=-1)
        plain = p @ vf
        return (2 * BF16_UNIT_ROUNDOFF * (p @ vf.abs())
                + BF16_ULP * plain.abs() + 1e-5)


def backward_error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor, scale: float
                         ) -> Tuple[torch.Tensor, ...]:
    """Per-element tolerances ``(dq, dk, dv)`` of the bf16 backward kernels
    against :func:`flash_attention_backward_plain`, in plain fp32: the
    kernels round P and dS to bf16 as operands (relative error u = 2^-8),
    so dV is within u · (Pᵀ |dO|), dQ within u · scale · (|dS| |K|) and dK
    within u · scale · (|dS|ᵀ |Q|), each doubled for the fp32 sums; plus
    one bf16 ulp of the result and 1e-4, the fp32 tolerance."""
    u2 = 2 * BF16_UNIT_ROUNDOFF
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
        delta = (dof * out.float()).sum(dim=-1, keepdim=True)
        p = torch.exp(torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale
                      - lse.unsqueeze(-1))
        ds = p * (dof @ vf.transpose(-1, -2) - delta)
        pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
        return tuple(
            u2 * term + BF16_ULP * grad.abs() + 1e-4 for term, grad in (
                (scale * (ds.abs() @ kf.abs()), scale * (ds @ kf)),
                (scale * (dst.abs() @ qf.abs()), scale * (dst @ qf)),
                (pt @ dof.abs(), pt @ dof)))


def forward_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, plain_out: torch.Tensor) -> torch.Tensor:
    """Per-element tolerance of the forward kernel's ``out`` against
    ``plain_out`` (:func:`flash_attention_plain`'s): atol + rtol·|plain| of
    ``FWD_TOL_FP32`` in fp32, :func:`forward_error_bound` in bf16."""
    if q.dtype == torch.float32:
        atol, rtol = FWD_TOL_FP32
        return atol + rtol * plain_out.float().abs()
    return forward_error_bound(q, k, v, scale)


def backward_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor,
                       dout: torch.Tensor, scale: float,
                       plain_grads: Tuple[torch.Tensor, ...]
                       ) -> Tuple[torch.Tensor, ...]:
    """Per-element tolerances ``(dq, dk, dv)`` of the backward kernels
    against ``plain_grads`` (:func:`flash_attention_backward_plain`'s):
    atol + rtol·|plain| of ``BWD_TOL_FP32`` in fp32,
    :func:`backward_error_bound` in bf16."""
    if q.dtype == torch.float32:
        atol, rtol = BWD_TOL_FP32
        return tuple(atol + rtol * g.float().abs() for g in plain_grads)
    return backward_error_bound(q, k, v, out, lse, dout, scale)


def load_kernel():
    """Build (at first use) and bind the forward kernel's C function."""
    global _FN
    if _FN is None:
        from .cuda_build import load_library

        fn = load_library("flash_attention_fwd").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
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
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BWD_FN = fn
    return _BWD_FN


def layout_fault(t: torch.Tensor):
    """Why the kernels cannot read or write ``t`` where it lies, or None.
    They need unit stride along D, and a base and B, H, N strides that are
    multiples of 4 bytes (a bf16 row is copied in 4-byte pieces at least;
    16-byte pieces where every operand allows it)."""
    if t.stride(3) != 1:
        return f"needs unit stride along D; got strides {tuple(t.stride())}"
    size = t.element_size()
    if t.data_ptr() % 4 or any(s * size % 4 for s in t.stride()[:3]):
        return (f"is misaligned for the kernel: base and (B, H, N) strides "
                f"{tuple(t.stride()[:3])} x {size} bytes must be multiples "
                "of 4 bytes")
    return None


def check_layout(name: str, t: torch.Tensor) -> None:
    """Raise unless the kernels take ``t`` in its layout
    (:func:`layout_fault`)."""
    fault = layout_fault(t)
    if fault:
        raise ValueError(f"flash_attention: {name} {fault}")


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
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_layout(name, t)


def _empty_bnhd(like: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, H, N, D) tensor over (B, N, H, D) memory: the
    layout the ViT merges heads from and takes its qkv gradient in, so
    that the transposes and reshapes around the kernels are views."""
    b, h, n, d = like.shape
    return torch.empty((b, n, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _launch(fn, name, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# the forward as a PyTorch operator, so that ``torch.export`` traces it
# (a ctypes call is opaque to the tracer): the fake gives the output's
# strides, the CPU implementation is the plain version, the CUDA one
# launches the kernel, and the autograd formula calls the backward kernels
OP_NAME = "semi_seg_ecg_tpu_torch::flash_attention_forward"


@torch.library.custom_op(OP_NAME, mutates_args=(), device_types="cpu",
                         schema="(Tensor q, Tensor k, Tensor v, float scale)"
                                " -> (Tensor, Tensor)")
def _forward_op(q, k, v, scale):
    """CPU tensors: :func:`flash_attention_plain`, with ``out`` in the
    kernel's (B, N, H, D) memory, so that a traced graph's views of it hold
    on either device."""
    out, lse = flash_attention_plain(q, k, v, scale)
    return _empty_bnhd(q).copy_(out), lse


@_forward_op.register_kernel("cuda")
def _forward_cuda(q, k, v, scale):
    global LAUNCHES
    _check(q, k, v)
    fn = load_kernel()
    b, h, n, d = q.shape
    out = _empty_bnhd(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _launch(fn, "flash_attention_fwd", q.device, _desc(q), _desc(k),
            _desc(v), _desc(out), lse.data_ptr(), b, h, n, d, float(scale),
            _DTYPE_CODES[q.dtype])
    LAUNCHES += 1
    return out, lse


@_forward_op.register_fake
def _forward_fake(q, k, v, scale):
    b, h, n, _ = q.shape
    return _empty_bnhd(q), q.new_empty((b, h, n), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    q, k, v, scale = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.scale = scale
    # lse is not differentiable (the JAX custom VJP returns out alone), so
    # no zeros are materialized for its gradient
    ctx.mark_non_differentiable(output[1])
    ctx.set_materialize_grads(False)


def _backward(ctx, dout, _dlse):
    """Autograd picks ``dout``'s layout (a sum's backward hands over an
    expand of stride 0), so a ``dout`` the kernels do not take is copied
    here."""
    q, k, v, out, lse = ctx.saved_tensors
    if layout_fault(dout):
        dout = dout.clone(memory_format=torch.contiguous_format)
    dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout, ctx.scale)
    return dq, dk, dv, None


_forward_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` for ``(B, H, N, D)`` q, k, v: ``out`` in q's dtype,
    ``lse`` fp32 ``(B, H, N)``, through the operator ``OP_NAME``. CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    current stream, which reads q, k, v in their own layouts (see
    :func:`check_layout`); ``out`` is a (B, H, N, D) view of (B, N, H, D)
    memory on both devices. Differentiable: the backward launches the
    backward kernels (:func:`flash_attention_backward`)."""
    return _forward_op(q, k, v, float(scale))


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             scale: float) -> Tuple[torch.Tensor, ...]:
    """``(dq, dk, dv)`` in the inputs' dtype for the forward's ``(out,
    lse)`` and the output gradient ``dout``. CPU tensors take the plain
    version; CUDA tensors launch the backward kernels on the current
    stream, which read every operand in its own layout and write dq, dk,
    dv as (B, H, N, D) views of (B, N, H, D) memory. Δ = rowsum(dO ⊙ O) is
    the dQ kernel's work in both dtypes (summed in fp32 from the O and dO
    tiles it streams, and kept in ``delta`` for the dK/dV kernel), so no
    PyTorch arithmetic runs here."""
    global BWD_LAUNCHES
    if not (q.is_cuda or k.is_cuda or v.is_cuda):
        return flash_attention_backward_plain(q, k, v, out, lse, dout, scale)
    _check(q, k, v)
    if dout.shape != q.shape or out.shape != q.shape or \
            lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError("flash_attention_backward: out and dout must be "
                         "(B, H, N, D) like q, lse (B, H, N) float32")
    if not (out.device == dout.device == lse.device == q.device):
        raise ValueError("flash_attention_backward: out, lse and dout must "
                         "lie on q's device")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError("flash_attention_backward: out and dout must have "
                        f"q's dtype {q.dtype}; got {out.dtype}, "
                        f"{dout.dtype}")
    if not lse.is_contiguous():
        raise ValueError("flash_attention_backward: lse must be contiguous")
    check_layout("out", out)
    check_layout("dout", dout)
    fn = load_backward_kernel()
    b, h, n, d = q.shape
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    dq, dk, dv = (_empty_bnhd(t) for t in (q, k, v))
    _launch(fn, "flash_attention_bwd", q.device, _desc(q), _desc(k),
            _desc(v), _desc(out), _desc(dout), lse.data_ptr(),
            delta.data_ptr(), _desc(dq), _desc(dk), _desc(dv), b, h, n, d,
            float(scale), _DTYPE_CODES[q.dtype])
    BWD_LAUNCHES += 1
    return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Differentiable flash attention over ``(B, H, N, D)``, the JAX
    package's ``jax.custom_vjp`` ``flash_attention``; the output is in q's
    dtype. Under ``torch.no_grad()`` nothing is saved. The caller picks the
    layouts of q, k and v, and the kernels refuse one they do not take."""
    return flash_attention_forward(q, k, v, scale)[0]
