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
With ``remat`` each block is checkpointed (``models/remat.py``), as the
JAX package wraps each in ``nn.remat``.

Module names follow the reference's torch keys (``to_patch_embedding.{1,2,3}``,
``block{i}.attn.norm``, ``block{i}.attn.fn.to_qkv``, ``...to_out.0``,
``block{i}.ff.fn.net.{0,3}``, ``block{i}.ls_1``, ``norm``), so
``utils/weights.py`` carries JAX weights in and a reference ``.pth`` loads
with ``load_state_dict``. LayerNorm eps is 1e-6, flax's default, which the
JAX package uses everywhere.

Tensor parallelism (``parallel.model_parallel > 1``): once
``parallel/sharding_rules.shard_module_`` has sliced a block's parameters,
its :class:`Attention` and :class:`FeedForward` run Megatron's layout over
the mesh's model group: column-parallel in (``copy_to_model``, then the
local ``to_qkv`` or ``net.0``), row-parallel out (the local ``to_out.0`` or
``net.3`` without its bias, ``reduce_from_model``, then the bias). The
attention runs this rank's ``heads / tp`` heads, the flash path on
``(B, H/tp, N, D)`` through the same kernels, the counterpart of the JAX
package's ``sharded_flash_attention``. The dropouts over sliced dimensions
(attention's over the heads, the MLP's after the GELU over the hidden
width) draw whole and keep this rank's block (``parallel.dist.global_rows``
with ``split``), so the masks are one process's.

Sequence parallelism (``parallel.seq_parallel > 1``, a split time axis;
``parallel/seq_shard.py``): seq rank 0 holds the cls token and the first
block of patches, each other rank its block of the global patches (the
split rule of ``seq_shard.block`` over the patch count); a patch that a
block boundary of the samples cuts is fetched whole. The position
embedding's rows and the cls token are taken at the rank's global token
offsets, the dropouts over tokens draw over all of them and keep the
rank's, and the features leave time-split; with ``output_cls_token``
every seq rank returns its patch block and the whole cls row, broadcast
from seq rank 0 (``seq_shard.broadcast_first``: the backward sums onto
rank 0). Attention follows the JAX
package's ``_use_ring``: ``auto`` and ``ring`` run the ring
(``ops/ring_attention.py``: the flash kernels once per hop on CUDA);
attention dropout in training, ``flash`` (with a warning) and ``xla``
gather the tokens, attend whole and keep the rank's rows.

Precision: parameters stay fp32; under ``torch.autocast`` the linears run in
the autocast dtype, and attention's matmuls follow it when ``fp16_enabled``
(else fp32). The softmax is always fp32. ``quantize='int8'`` (serving)
runs the patch embedding, qkv, output projection and both MLP layers in
int8 (``models/quant_layers.py``), the layers the JAX package quantizes;
under the seq or model axis each takes the absmax of its global input.

Both axes (``seq_parallel`` and ``model_parallel`` > 1): a model rank's
attention runs the ring on its ``heads / tp`` heads over its own seq group
(one ring per (data, model) index), the JAX package's head-sharded ring;
where ``tp`` does not divide the heads the attention stays whole and
replicated and the MLP is still sliced (``sharding_rules.model_plan``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import dense_attention
from ...ops.flash_attention import flash_attention
from ...ops.ring_attention import ring_attention
from ...parallel import seq_shard
from ...parallel.dist import copy_to_model, reduce_from_model
from ...utils.logging import log
from ..dropout import DropPath, Dropout
from ..quant_layers import linear
from ..remat import remat_call

LN_EPS = 1e-6

# warnings already given, once per process (the JAX package gives them once
# per trace)
_WARNED: set = set()


def _warn_once(msg: str) -> None:
    if msg not in _WARNED:
        _WARNED.add(msg)
        log(msg, force=True)


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


def row_parallel(layer: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel linear: this rank's partial product, summed over the
    model ``group``, then the (replicated) bias once; an int8 layer's own
    (``Int8Linear.row_parallel``: exact int32 partial sums)."""
    if hasattr(layer, "row_parallel"):
        return layer.row_parallel(x, group)
    y = reduce_from_model(F.linear(x, layer.weight), group)
    if layer.bias is not None:
        y = y + layer.bias.to(y.dtype)
    return y


class FeedForward(nn.Module):
    """Linear → GELU (exact) → dropout → Linear → dropout; tensor-parallel
    over a model group after :meth:`use_model_mesh`."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 quantize: Optional[str] = None):
        super().__init__()
        self.net = nn.Sequential(
            linear(quantize, dim, hidden_dim), nn.GELU(), Dropout(dropout),
            linear(quantize, hidden_dim, dim), Dropout(dropout))
        self.model_group = None

    def use_model_mesh(self, mesh) -> None:
        """Run with ``net.0``'s rows and ``net.3``'s columns sliced to this
        model rank's block of the hidden width."""
        self.model_group = mesh.model_group
        self.net[2].split = (-1, mesh.model, mesh.model_rank)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.model_group is None:
            return self.net(x)
        h = self.net[0](copy_to_model(x, self.model_group))
        h = self.net[2](self.net[1](h))
        return self.net[4](row_parallel(self.net[3], h, self.model_group))


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
        self.local_heads = heads
        self.model_group = None
        # under a split token axis, every seq rank's token count (the ViT
        # sets it before each forward); None: the tokens are whole
        self.tokens = None

    def use_model_mesh(self, mesh) -> None:
        """Run this model rank's ``heads / tp`` heads: ``to_qkv`` holds
        their rows of each third and ``to_out.0`` their columns."""
        self.local_heads = self.heads // mesh.model
        self.model_group = mesh.model_group
        self.attn_drop.split = (1, mesh.model, mesh.model_rank)

    def _use_ring(self) -> bool:
        """The JAX package's rules: 'auto' and 'ring' take the ring when the
        token axis is split, except under attention dropout in training
        (the ring never forms the (N, N) matrix the mask needs), which
        warns and attends whole on the gathered tokens."""
        if self.tokens is None or self.attention_impl not in ("auto",
                                                              "ring"):
            return False
        if self.attn_dropout > 0 and self.training:
            _warn_once(
                "ring attention skipped: attn_dropout > 0 needs the full "
                "(N, N) attention matrix — falling back to dense attention, "
                "which all-gathers the seq-sharded token axis (set "
                "attn_drop_out_rate: 0 to keep tokens sharded)")
            return False
        return True

    def _use_flash(self, n: int, on_cuda: bool) -> bool:
        """The JAX package's rules with the device test on CUDA.

        'xla' and 'ring' take the dense path ('ring' without a split token
        axis falls back to dense in the JAX package too); attention dropout
        in training needs the (N, N) matrix.
        'flash' then always takes the kernel path, which raises on a head
        dim it does not take; 'auto' takes it on CUDA from N >= 512, the
        crossover swept on a TPU (not yet measured on the H100)."""
        if self.attention_impl in ("xla", "ring"):
            return False
        if self.attn_dropout > 0 and self.training:
            return False
        if self.attention_impl == "flash":
            if self.tokens is not None:
                _warn_once(
                    "attention_impl='flash' under a seq>1 mesh all-gathers "
                    "the seq-sharded token axis and computes the kernel "
                    "redundantly on every seq rank — use attention_impl: "
                    "auto (or ring) to keep tokens sharded")
            return True
        return on_cuda and n >= 512

    def _attend(self, q, k, v, scale, mm_dtype):
        """Attention over this rank's ``(B, H, N, D)`` q, k, v: the ring
        under a split token axis, else the flash kernels or the dense path
        on the (gathered) tokens."""
        counts = self.tokens
        if self._use_ring():
            shard = seq_shard.active()
            return ring_attention(q.to(mm_dtype), k.to(mm_dtype),
                                  v.to(mm_dtype), scale, counts, shard.comm)
        if counts is not None:
            q, k, v = (seq_shard.gather_time(t, counts, 2) for t in (q, k, v))
        if self._use_flash(q.shape[2], q.is_cuda):
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
        if counts is not None:
            rank = seq_shard.active().rank
            out = out.narrow(2, sum(counts[:rank]), counts[rank])
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        heads, group = self.local_heads, self.model_group
        if group is not None:
            x = copy_to_model(x, group)
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, heads, self.dim_head).transpose(1, 2)
                   for t in (q, k, v))
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)

        device_type = x.device.type
        if self.fp16_enabled and torch.is_autocast_enabled(device_type):
            mm_dtype = torch.get_autocast_dtype(device_type)
        else:
            mm_dtype = torch.float32
        scale = self.dim_head ** -0.5
        out = self._attend(q, k, v, scale, mm_dtype)
        out = out.transpose(1, 2).reshape(b, n, heads * self.dim_head)
        if group is not None:
            return self.to_out[1](row_parallel(self.to_out[0], out, group))
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
        self.patch_size = patch_size
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
        blocks = [getattr(self, f"block{i}") for i in range(depth)]
        self._attentions = [blk.attn.fn for blk in blocks]
        # the dropouts over the token axis (not attention's over (N, N))
        self._token_dropouts = [self.dropout] + [
            m for blk in blocks for name, m in blk.named_modules()
            if isinstance(m, Dropout) and not name.endswith("attn_drop")]

    def feature_lengths(self, length: int) -> Tuple[int, ...]:
        """The global token lengths of :meth:`forward`'s features (the
        patches) for an input of ``length`` samples."""
        return (length // self.patch_size,) * len(self.out_indices)

    def _split_tokens(self, shard):
        """Set every attention's token counts and every token dropout's
        block for this forward (None: whole tokens); return the split's
        ``(n patches, patch block, start)`` or None."""
        split = None
        counts = time = None
        if shard is not None:
            n = shard.length // self.patch_size
            blocks = shard.blocks(n)
            counts = tuple(b - a + (j == 0) for j, (a, b) in
                           enumerate(blocks))
            a, b = blocks[shard.rank]
            start = 0 if shard.rank == 0 else 1 + a
            time = (1, n + 1, start)
            split = (n, blocks, start)
        for attn in self._attentions:
            attn.tokens = counts
        for drop in self._token_dropouts:
            drop.time = time
        return split

    def train(self, mode: bool = True):
        """Frozen blocks (index < ``frozen_stages``) stay in eval mode, so
        they run without dropout or DropPath (the JAX package's
        ``block_train = train and i >= frozen_stages``); freezing their
        parameters is the optimizer's job."""
        super().train(mode)
        for i in range(min(max(self.frozen_stages, 0), self.depth)):
            getattr(self, f"block{i}").train(False)
        return self

    def no_weight_decay(self) -> set:
        return {"cls_embedding", "pos_embedding"}

    def forward(self, x: torch.Tensor) -> Tuple:
        b = x.shape[0]
        shard = seq_shard.active()
        split = self._split_tokens(shard)
        if split is None:
            x = self.to_patch_embedding(x)
            n = x.shape[1]
            cls = self.cls_embedding.to(x.dtype).expand(b, 1, self.width)
            x = torch.cat([cls, x], dim=1) + self.pos_embedding[
                :, :n + 1].to(x.dtype)
            first = True
        else:
            n, blocks, start = split
            p = self.patch_size
            x = self.to_patch_embedding(seq_shard.fetch_time_range(
                x, shard.length, [(a * p, c * p) for a, c in blocks]))
            first = shard.rank == 0
            if first:
                cls = self.cls_embedding.to(x.dtype).expand(b, 1, self.width)
                x = torch.cat([cls, x], dim=1)
            x = x + self.pos_embedding[:, start:start + x.shape[1]].to(
                x.dtype)
        x = self.dropout(x)
        features = []
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            x = (remat_call(block, x) if self.remat and self.training
                 else block(x))
            if i == self.depth - 1 and self.norm is not None:
                x = self.norm(x)
            if i in self.out_indices:
                # NCW, cls dropped
                patches = (x[:, 1:, :] if first else x).transpose(1, 2)
                if not self.output_cls_token:
                    features.append(patches)
                    continue
                if split is None:
                    cls = x[:, 0]
                else:
                    # seq rank 0 holds the cls token: every rank gets its
                    # row, and its gradient goes back to rank 0. The other
                    # ranks' placeholder takes part in the backward as rank
                    # 0's row does, so every rank runs the collective
                    cls = seq_shard.broadcast_first(
                        x[:, 0] if first else x.new_zeros(
                            b, self.width).requires_grad_(x.requires_grad),
                        shard)
                features.append((patches, cls))
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
