"""Symmetric int8 quantization for serving (counterpart of
``semi_seg_ecg_tpu/ops/quant.py``).

- **weights**: per-output-channel symmetric int8 (``absmax / 127``),
  computed from the fp32 parameters inside the forward, so checkpoints stay
  fp32 and the ``state_dict`` is the float model's;
- **activations**: per-tensor symmetric int8, with the scale from the live
  batch (dynamic) or a calibrated one (static, ``utils/calibrate.py``).

The contraction runs on int8 operands into an exact int32 accumulator
(``torch._int_mm``: cuBLASLt's integer GEMM on the card, the JAX package's
``preferred_element_type=jnp.int32`` contraction, which XLA computes outside
any Pallas kernel); the result is dequantized by ``sx · sk``, the bias added
in fp32. A convolution is an im2col (the padded int8 signal unfolded into
``(B·L, C_in·K)`` rows) times the ``(C_in·K, C_out)`` weight. The card's
integer GEMM takes m > 16 rows and k, n that are multiples of 8; the
operands are padded with zeros to that (exact: zero rows and columns add
nothing to an integer sum) on every device, so the CPU runs the padded
shapes too.

The divisions divide by a tensor: CUDA PyTorch turns a tensor over a Python
number into a multiply by its reciprocal, which moves some codes at the .5
boundaries away from the JAX package's. ``torch.round`` rounds half to
even, as ``jnp.round`` does. Serving only: nothing here has a gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# smallest representable scale: guards all-zero tensors (fresh params,
# zero-padded activations) from a 0/0 in the quantize divide
_EPS = 1e-8
QMAX = 127.0
# torch._int_mm on CUDA: m > 16, k and n multiples of 8
_MIN_ROWS, _ALIGN = 17, 8


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once, as the JAX op divides (see the module
    docstring)."""
    return a / torch.full_like(a, b)


def _quantize(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(t / scale), -QMAX, QMAX).to(torch.int8)


def quantize_symmetric(t: torch.Tensor, dim: Optional[Tuple[int, ...]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` with ``q = clip(round(t / scale), ±127)`` int8 and
    ``scale = max(absmax / 127, _EPS)`` reduced over ``dim`` (``None``: the
    whole tensor), kept as size-1 dims; ``t ≈ q · scale``."""
    t = t.float()
    if dim is None:
        dim = tuple(range(t.dim()))
    scale = torch.clamp_min(_div(t.abs().amax(dim=dim, keepdim=True), QMAX),
                            _EPS)
    return _quantize(t, scale), scale


def quantize_static(t: torch.Tensor, scale: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize with a precomputed (calibrated) per-tensor scale: no absmax
    reduction over the live tensor. Returns the scale shaped ``(1,) *
    t.dim()``."""
    t = t.float()
    scale = torch.clamp_min(scale.float(), _EPS).reshape((1,) * t.dim())
    return _quantize(t, scale), scale


def _pad_dim(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``t`` zero-padded at the end of ``dim`` to ``size`` (or as it is)."""
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, extra]
    return F.pad(t, pad)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` exactly in int32 for int8 ``a`` (M, K) and ``w`` (N, K):
    both padded with zeros to the card's integer-GEMM shapes (M > 16, K and
    N multiples of 8), the padding sliced off the result."""
    m, k = a.shape
    n = w.shape[0]
    kp, np_ = _round_up(k, _ALIGN), _round_up(n, _ALIGN)
    a = _pad_dim(_pad_dim(a, 1, kp), 0, _MIN_ROWS).contiguous()
    w = _pad_dim(_pad_dim(w, 1, kp), 0, np_).contiguous()
    return torch._int_mm(a, w.t())[:m, :n]


def _dequantize(acc: torch.Tensor, sx: torch.Tensor, sk: torch.Tensor,
                bias: Optional[torch.Tensor], out_dtype: torch.dtype
                ) -> torch.Tensor:
    """``acc · (sx · sk) (+ bias)`` in fp32, then ``out_dtype``; ``sk``
    broadcasts over the last axis of ``acc``."""
    out = acc.float() * (sx.reshape(()) * sk.reshape(-1))
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def _quantize_input(x: torch.Tensor, act_scale: Optional[torch.Tensor]):
    if act_scale is None:
        return quantize_symmetric(x)  # per tensor
    return quantize_static(x, act_scale)


def int8_conv1d(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding: int = 0, dilation: int = 1,
                out_dtype: torch.dtype = torch.float32,
                act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.conv1d`` over NCW ``x`` (B, C_in, W) with the fp32 ``weight``
    (C_out, C_in, K), its contraction on int8 operands into int32: the
    JAX package's ``int8_conv`` (NWC there). Per-tensor activation scale,
    dynamic unless ``act_scale`` (a calibrated ``absmax / 127``);
    per-output-channel weight scale. Symmetric zero ``padding`` (a
    quantized zero is 0, so the signal is padded after quantizing)."""
    xq, sx = _quantize_input(x, act_scale)
    kq, sk = quantize_symmetric(weight, dim=(1, 2))   # per out-channel
    acc = int_conv1d(xq, kq, stride, padding, dilation)
    out = _dequantize(acc.transpose(1, 2), sx, sk, bias, out_dtype)
    return out.transpose(1, 2)


def int_conv1d(xq: torch.Tensor, kq: torch.Tensor, stride: int = 1,
               padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """The exact int32 convolution ``(B, C_out, L)`` of int8 ``xq`` (B,
    C_in, W) with int8 ``kq`` (C_out, C_in, K): the signal zero-padded and
    unfolded into ``(B·L, C_in·K)`` rows (im2col), times the weight."""
    c_out, c_in, k = kq.shape
    b = xq.shape[0]
    span = dilation * (k - 1) + 1
    cols = F.pad(xq, (padding, padding)).unfold(2, span, stride)
    if dilation > 1:
        cols = cols[..., ::dilation]
    length = cols.shape[2]
    # (B, C_in, L, K) -> (B·L, C_in·K), the weight's (C_in, K) order
    cols = cols.permute(0, 2, 1, 3).reshape(b * length, c_in * k)
    acc = int_matmul(cols, kq.reshape(c_out, c_in * k))
    return acc.reshape(b, length, c_out).transpose(1, 2)


def int8_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32,
                act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear`` over ``x`` (..., C_in) with the fp32 ``weight``
    (C_out, C_in), its matmul on int8 operands into int32: the JAX
    package's ``int8_dense``."""
    xq, sx = _quantize_input(x, act_scale)
    kq, sk = quantize_symmetric(weight, dim=(1,))      # per out-channel
    lead = x.shape[:-1]
    acc = int_matmul(xq.reshape(-1, x.shape[-1]), kq)
    out = _dequantize(acc, sx, sk, bias, out_dtype)
    return out.reshape(*lead, weight.shape[0])
