"""1-D Vision Transformer backbone (counterpart of
``semi_seg_ecg_tpu/models/backbones/vision_transformer.py``).

Input ``(B, leads, T)``; output a tuple of ``(B, width, num_patches)``
features at ``out_indices`` (cls token dropped), the NCW layout the FCN head
convolves. Patchify keeps the reference's ``'(p c)'`` element order, then
LN/Linear/LN embedding, learned cls + pos embeddings, pre-norm blocks with
optional qk-norm and LayerScale, stochastic depth, an optional final norm.
In training, dropout and DropPath draw from the generator the trainer sets
(``models/dropout.py``), the flash path is differentiable through both
kernels (``ops/flash_attention.flash_attention``), and the first
``frozen_stages`` blocks run deterministically, as in the JAX package.

Module names follow the reference's torch keys (``to_patch_embedding.{1,2,3}``,
``block{i}.attn.norm``, ``block{i}.attn.fn.to_qkv``, ``...to_out.0``,
``block{i}.ff.fn.net.{0,3}``, ``block{i}.ls_1``, ``norm``), so
``utils/weights.py`` carries JAX weights in and a reference ``.pth`` loads
with ``load_state_dict``. LayerNorm eps is 1e-6, flax's default, which the
JAX package uses everywhere.

Precision: parameters stay fp32; under ``torch.autocast`` the linears run in
the autocast dtype, and attention's matmuls follow it when ``fp16_enabled``
(else fp32). The softmax is always fp32. ``quantize='int8'`` (serving)
runs the patch embedding, qkv, output projection and both MLP layers in
int8 (``models/quant_layers.py``), the layers the JAX package quantizes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops.attention import dense_attention
from ...ops.flash_attention import flash_attention
from ..dropout import DropPath, Dropout
from ..quant_layers import linear

LN_EPS = 1e-6


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class PreNorm(nn.Module):
    """LayerNorm, then ``fn``: the reference's ``norm``/``fn`` key pair."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = _layer_norm(dim)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class FeedForward(nn.Module):
    """Linear → GELU (exact) → dropout → Linear → dropout."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 quantize: Optional[str] = None):
        super().__init__()
        self.net = nn.Sequential(
            linear(quantize, dim, hidden_dim), nn.GELU(), Dropout(dropout),
            linear(quantize, hidden_dim, dim), Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Attention(nn.Module):
    """Multi-head self-attention after the block's pre-norm."""

    def __init__(self, input_dim: int, output_dim: int, heads: int = 8,
                 dim_head: int = 64, qkv_bias: bool = True,
                 qk_norm: bool = False, fp16_enabled: bool = True,
                 dropout: float = 0.0, attn_dropout: float = 0.0,
                 attention_impl: str = "auto",
                 quantize: Optional[str] = None):
        super().__init__()
        if attention_impl not in ("auto", "xla", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        inner_dim = dim_head * heads
        self.heads = heads
        self.dim_head = dim_head
        self.fp16_enabled = fp16_enabled
        self.attn_dropout = attn_dropout
        self.attention_impl = attention_impl
        self.to_qkv = linear(quantize, input_dim, inner_dim * 3,
                             bias=qkv_bias)
        if qk_norm:
            self.q_norm = _layer_norm(dim_head)
            self.k_norm = _layer_norm(dim_head)
        else:
            self.q_norm = self.k_norm = None
        self.attn_drop = Dropout(attn_dropout)
        project_out = not (heads == 1 and dim_head == input_dim)
        self.to_out = (nn.Sequential(linear(quantize, inner_dim,
                                            output_dim),
                                     Dropout(dropout))
                       if project_out else None)

    def _use_flash(self, n: int, on_cuda: bool) -> bool:
        """The JAX package's rules with the device test on CUDA.

        'xla' and 'ring' take the dense path ('ring' without a sequence
        mesh falls back to dense in the JAX package too, and the port has
        no mesh); attention dropout in training needs the (N, N) matrix.
        'flash' then always takes the kernel path, which raises on a head
        dim it does not take; 'auto' takes it on CUDA from N >= 512, the
        crossover swept on a TPU (not yet measured on the H100)."""
        if self.attention_impl in ("xla", "ring"):
            return False
        if self.attn_dropout > 0 and self.training:
            return False
        if self.attention_impl == "flash":
            return True
        return on_cuda and n >= 512

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in (q, k, v))
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)

        device_type = x.device.type
        if self.fp16_enabled and torch.is_autocast_enabled(device_type):
            mm_dtype = torch.get_autocast_dtype(device_type)
        else:
            mm_dtype = torch.float32
        scale = self.dim_head ** -0.5
        if self._use_flash(n, x.is_cuda):
            # the kernels take the transposed chunks of the qkv projection
            # (and the q/k norms' outputs) as they lie and write out as
            # (B, N, H, D) memory, so no copy is made on either side. A
            # .contiguous() would not help where the wrapper refuses a
            # layout: that is an odd bf16 dim_head, whose rows are
            # misaligned for the kernel's 4-byte copies in any layout
            out = flash_attention(q.to(mm_dtype), k.to(mm_dtype),
                                  v.to(mm_dtype), scale)
        else:
            out = dense_attention(q, k, v, scale, mm_dtype=mm_dtype,
                                  attn_transform=self.attn_drop)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        if self.to_out is not None:
            out = self.to_out(out)
        return out


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, heads: int = 8,
                 dim_head: int = 32, qkv_bias: bool = True,
                 qk_norm: bool = False, fp16_enabled: bool = True,
                 dropout: float = 0.0, attn_dropout: float = 0.0,
                 attention_impl: str = "auto", drop_path: float = 0.0,
                 layer_scale: Optional[float] = None,
                 quantize: Optional[str] = None):
        super().__init__()
        self.attn = PreNorm(dim, Attention(
            dim, dim, heads=heads, dim_head=dim_head, qkv_bias=qkv_bias,
            qk_norm=qk_norm, fp16_enabled=fp16_enabled, dropout=dropout,
            attn_dropout=attn_dropout, attention_impl=attention_impl,
            quantize=quantize))
        self.ff = PreNorm(dim, FeedForward(dim, hidden_dim, dropout,
                                           quantize))
        if layer_scale is not None:
            self.ls_1 = nn.Parameter(torch.full((dim,), float(layer_scale)))
            self.ls_2 = nn.Parameter(torch.full((dim,), float(layer_scale)))
        else:
            self.ls_1 = self.ls_2 = None
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.attn(x)
        if self.ls_1 is not None:
            a = a * self.ls_1.to(a.dtype)
        x = self.drop_path(a) + x
        f = self.ff(x)
        if self.ls_2 is not None:
            f = f * self.ls_2.to(f.dtype)
        return self.drop_path(f) + x


class Patchify(nn.Module):
    """``(B, C, T)`` → ``(B, T // p, p * C)`` in ``'(p c)'`` order; the
    reference's parameter-free ``to_patch_embedding.0``."""

    def __init__(self, patch_size: int):
        super().__init__()
        self.patch_size = patch_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        return x.transpose(1, 2).reshape(b, t // self.patch_size,
                                         self.patch_size * c)


class VisionTransformer1D(nn.Module):
    def __init__(self, seq_len: int, patch_size: int, num_leads: int,
                 width: int = 768, depth: int = 12, mlp_dim: int = 3072,
                 heads: int = 12, dim_head: int = 64, qkv_bias: bool = True,
                 qk_norm: bool = False, fp16_enabled: bool = True,
                 drop_out_rate: float = 0.0, attn_drop_out_rate: float = 0.0,
                 drop_path_rate: float = 0.0, uniform_dpr: bool = False,
                 layer_scale: Optional[float] = None,
                 attention_impl: str = "auto", frozen_stages: int = -1,
                 out_indices: Sequence[int] = (3, 5, 7, 11),
                 final_norm: bool = False, output_cls_token: bool = False,
                 remat: bool = False, quantize: Optional[str] = None):
        super().__init__()
        if seq_len % patch_size != 0:
            raise ValueError("The sequence length must be divisible by the "
                             "patch size.")
        self.width = width
        self.depth = depth
        self.frozen_stages = frozen_stages
        self.remat = remat
        self.out_indices = tuple(out_indices)
        self.output_cls_token = output_cls_token
        num_patches = seq_len // patch_size
        patch_dim = patch_size * num_leads
        self.to_patch_embedding = nn.Sequential(
            Patchify(patch_size), _layer_norm(patch_dim),
            linear(quantize, patch_dim, width), _layer_norm(width))
        self.pos_embedding = nn.Parameter(
            torch.randn(1, num_patches + 1, width))
        self.cls_embedding = nn.Parameter(torch.randn(width))
        self.dropout = Dropout(drop_out_rate)
        dpr = ([drop_path_rate] * depth if uniform_dpr
               else np.linspace(0, drop_path_rate, depth).tolist())
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(
                width, mlp_dim, heads=heads, dim_head=dim_head,
                qkv_bias=qkv_bias, qk_norm=qk_norm,
                fp16_enabled=fp16_enabled, dropout=drop_out_rate,
                attn_dropout=attn_drop_out_rate,
                attention_impl=attention_impl, drop_path=dpr[i],
                layer_scale=layer_scale, quantize=quantize))
        self.norm = _layer_norm(width) if final_norm else None

    def train(self, mode: bool = True):
        """Frozen blocks (index < ``frozen_stages``) stay in eval mode, so
        they run without dropout or DropPath (the JAX package's
        ``block_train = train and i >= frozen_stages``); freezing their
        parameters is the optimizer's job."""
        super().train(mode)
        for i in range(min(max(self.frozen_stages, 0), self.depth)):
            getattr(self, f"block{i}").train(False)
        return self

    def forward(self, x: torch.Tensor) -> Tuple:
        if self.remat and self.training and torch.is_grad_enabled():
            # an eval forward is the same with or without checkpointing
            raise NotImplementedError(
                "remat (activation checkpointing) is not yet ported to the "
                "torch package's training")
        b = x.shape[0]
        x = self.to_patch_embedding(x)
        n = x.shape[1]
        cls = self.cls_embedding.to(x.dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding[:, :n + 1].to(
            x.dtype)
        x = self.dropout(x)
        features = []
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
            if i == self.depth - 1 and self.norm is not None:
                x = self.norm(x)
            if i in self.out_indices:
                patches = x[:, 1:, :].transpose(1, 2)  # NCW, cls dropped
                features.append((patches, x[:, 0]) if self.output_cls_token
                                else patches)
        return tuple(features)


def _factory(width, depth, heads, mlp_dim):
    def make(num_leads, seq_len=2250, patch_size=75, **kwargs):
        args = dict(width=width, depth=depth, heads=heads, mlp_dim=mlp_dim)
        args.update(kwargs)  # explicit kwargs win over family defaults
        return VisionTransformer1D(seq_len=seq_len, patch_size=patch_size,
                                   num_leads=num_leads, **args)

    return make


vit_tiny = _factory(192, 12, 3, 768)
vit_small = _factory(384, 12, 6, 1536)
vit_base = _factory(768, 12, 12, 3072)
