"""Carry the JAX package's weights into the port.

The JAX package stores a model as two nested dicts of NumPy arrays,
``params`` and ``batch_stats`` (flax's trees). The port's module names follow
the reference's torch key space, the same one
``semi_seg_ecg_tpu/utils/torch_interop.py`` maps those trees to; this module
is the port's own copy of that spec walker, for the families the port
builds: the ResNet-1D and ViT-1D backbones, the FCN head, as the decode
head and as auxiliary heads, and the ReCo latent projection.

The JAX tree does not record ``avg_down``: a block's ``Downsample_0/ConvBN_0``
is the same either way, while the torch keys shift by one when an
``AvgPool1d`` leads the downsample (``downsample.{1,2}`` for ``.{0,1}``).
Given the target model's keys, the walker takes the shifted names where the
unshifted conv key is absent; without them it names the unshifted ones, as
``torch_interop.trees_to_torch_sd`` does.

Layouts: Linear torch ``(out, in)`` from flax ``(in, out)``; Conv1d torch
``(out, in, k)`` from flax ``(k, in, out)``; norms take ``scale`` →
``weight`` and the running ``mean``/``var`` → ``running_mean``/``running_var``.
The int8 serving model's calibrated activation absmax (the JAX ``quant``
collection) maps to the port's int8 module names by the same walk
(:func:`jax_quant_to_absmax`).
"""

from __future__ import annotations

import re
from typing import Any, Collection, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_CONV = "conv"      # (k, in, out) -> (out, in, k)
_DENSE = "dense"    # (in, out) -> (out, in)
_DIRECT = "direct"  # same layout

_STAT_LEAVES = ("mean", "var")

Spec = Tuple[Tuple[str, ...], str, str]


def _norm_key(prefix: str, leaf: str) -> str:
    return f"{prefix}." + {"scale": "weight", "bias": "bias",
                           "mean": "running_mean",
                           "var": "running_var"}[leaf]


def _dense_leaf(prefix: str, leaf: str) -> Tuple[str, str]:
    if leaf == "kernel":
        return f"{prefix}.weight", _DENSE
    return f"{prefix}.{leaf}", _DIRECT


def _convbn_specs(path, conv: str, bn: str) -> Iterator[Spec]:
    yield path + ("Conv_0", "kernel"), f"{conv}.weight", _CONV
    for leaf in ("scale", "bias", "mean", "var"):
        yield path + ("BatchNorm_0", leaf), _norm_key(bn, leaf), _DIRECT


def _resnet_specs(path, tree, prefix: str,
                  target_keys: Optional[Collection[str]]) -> Iterator[Spec]:
    for name in tree:
        if name.startswith("stem_"):
            i = int(name.split("_")[1])
            yield from _convbn_specs(path + (name,), f"{prefix}stem.{3 * i}",
                                     f"{prefix}stem.{3 * i + 1}")
            continue
        m = re.fullmatch(r"layer(\d+)_block(\d+)", name)
        if m is None:
            raise KeyError(
                f"unexpected ResNet leaf {'/'.join(path + (name,))}")
        base = f"{prefix}layer{m.group(1)}.{m.group(2)}"
        for sub in tree[name]:
            if sub.startswith("ConvBN_"):
                k = int(sub.split("_")[1]) + 1
                yield from _convbn_specs(path + (name, sub), f"{base}.conv{k}",
                                         f"{base}.bn{k}")
            elif sub == "Downsample_0":
                i = 0
                if target_keys is not None and \
                        f"{base}.downsample.0.weight" not in target_keys:
                    i = 1  # avg_down: the AvgPool1d is downsample.0
                yield from _convbn_specs(
                    path + (name, sub, "ConvBN_0"),
                    f"{base}.downsample.{i}", f"{base}.downsample.{i + 1}")
            else:
                raise KeyError(
                    f"unexpected ResNet leaf {'/'.join(path + (name, sub))}")


def _backbone_specs(path, tree, prefix: str,
                    target_keys: Optional[Collection[str]]
                    ) -> Iterator[Spec]:
    if any(n.startswith("stem_") for n in tree):
        yield from _resnet_specs(path, tree, prefix, target_keys)
    else:
        yield from _vit_specs(path, tree, prefix)


def _vit_specs(path, tree, prefix: str) -> Iterator[Spec]:
    patch_embed = {"LayerNorm_0": "to_patch_embedding.1",
                   "Dense_0": "to_patch_embedding.2",
                   "LayerNorm_1": "to_patch_embedding.3"}
    for name in tree:
        if name in ("pos_embedding", "cls_embedding"):
            yield path + (name,), f"{prefix}{name}", _DIRECT
        elif name in patch_embed:
            mod = f"{prefix}{patch_embed[name]}"
            for leaf in tree[name]:
                if name.startswith("Dense"):
                    key, kind = _dense_leaf(mod, leaf)
                else:
                    key, kind = _norm_key(mod, leaf), _DIRECT
                yield path + (name, leaf), key, kind
        elif name == "norm":
            for leaf in tree[name]:
                yield path + (name, leaf), _norm_key(f"{prefix}norm", leaf), \
                    _DIRECT
        elif name.startswith("block"):
            yield from _block_specs(path + (name,), tree[name],
                                    f"{prefix}{name}")
        else:
            raise KeyError(f"unexpected ViT leaf {'/'.join(path + (name,))}")


def _block_specs(path, block, base: str) -> Iterator[Spec]:
    attn_mods = {"Dense_0": "attn.fn.to_qkv", "Dense_1": "attn.fn.to_out.0"}
    ff_mods = {"Dense_0": "ff.fn.net.0", "Dense_1": "ff.fn.net.3"}
    for sub in block:
        if sub in ("ls_1", "ls_2"):
            yield path + (sub,), f"{base}.{sub}", _DIRECT
            continue
        if sub == "Attention_0":
            norm, dense = "attn.norm", attn_mods
        elif sub == "FeedForward_0":
            norm, dense = "ff.norm", ff_mods
        else:
            raise KeyError(f"unexpected ViT leaf {'/'.join(path + (sub,))}")
        for mod, leaves in block[sub].items():
            for leaf in leaves:
                leaf_path = path + (sub, mod, leaf)
                if mod == "LayerNorm_0":
                    yield leaf_path, _norm_key(f"{base}.{norm}", leaf), \
                        _DIRECT
                elif mod in ("q_norm", "k_norm") and sub == "Attention_0":
                    yield leaf_path, _norm_key(f"{base}.attn.fn.{mod}",
                                               leaf), _DIRECT
                elif mod in dense:
                    key, kind = _dense_leaf(f"{base}.{dense[mod]}", leaf)
                    yield leaf_path, key, kind
                else:
                    raise KeyError(
                        f"unexpected ViT leaf {'/'.join(leaf_path)}")


def _fcn_head_specs(path, tree, prefix: str) -> Iterator[Spec]:
    for name in tree:
        if re.fullmatch(r"conv\d+", name):
            i = int(name[4:])
            yield from _convbn_specs(path + (name,), f"{prefix}convs.{i}.0",
                                     f"{prefix}convs.{i}.1")
        elif name == "conv_cat":
            yield from _convbn_specs(path + (name,), f"{prefix}conv_cat.0",
                                     f"{prefix}conv_cat.1")
        elif name == "cls_seg":
            for leaf in tree[name]:
                kind = _CONV if leaf == "kernel" else _DIRECT
                key = "weight" if leaf == "kernel" else leaf
                yield path + (name, leaf), f"{prefix}cls_seg.{key}", kind
        else:
            raise KeyError(f"unexpected FCNHead leaf "
                           f"{'/'.join(path + (name,))}")


def _latent_projection_specs(path, tree, prefix: str) -> Iterator[Spec]:
    """The ReCo projection, ``Sequential(conv, ReLU, BN, conv)``."""
    for name in tree:
        if name == "Conv_0":
            yield path + (name, "kernel"), f"{prefix}0.weight", _CONV
        elif name == "Conv_1":
            yield path + (name, "kernel"), f"{prefix}3.weight", _CONV
        elif name == "BatchNorm_0":
            for leaf in tree[name]:
                yield path + (name, leaf), _norm_key(f"{prefix}2", leaf), \
                    _DIRECT
        else:
            raise KeyError(f"unexpected latent projection leaf "
                           f"{'/'.join(path + (name,))}")


def _merge_trees(params, batch_stats):
    """Union of params and batch_stats (their leaf names are disjoint)."""
    if not isinstance(params, dict):
        return params
    out = dict(params)
    for k, v in (batch_stats or {}).items():
        out[k] = _merge_trees(out[k], v) if k in out else v
    return out


def model_specs(params: Dict[str, Any], batch_stats: Dict[str, Any],
                target_keys: Optional[Collection[str]] = None,
                backbone_only: bool = False) -> Iterator[Spec]:
    """Yield ``(tree_path, torch_key, kind)`` for every leaf of a JAX
    EncoderDecoder's trees, or with ``backbone_only`` of a bare backbone's
    (keys without the ``backbone.`` prefix). ``target_keys``: the keys of
    the model the weights go into (resolves ``avg_down``)."""
    tree = _merge_trees(params, batch_stats)
    if backbone_only:
        yield from _backbone_specs((), tree, "", target_keys)
        return
    for top in tree:
        if top == "backbone":
            yield from _backbone_specs((top,), tree[top], "backbone.",
                                       target_keys)
        elif top == "decode_head":
            yield from _fcn_head_specs((top,), tree[top], "decode_head.")
        elif top.startswith("auxiliary_head"):
            # flax's auxiliary_heads_{i}: the reference's ModuleList
            i = top.split("_")[-1] if top[-1].isdigit() else "0"
            yield from _fcn_head_specs((top,), tree[top],
                                       f"auxiliary_heads.{i}.")
        elif top == "latent_projection":
            yield from _latent_projection_specs((top,), tree[top],
                                                "latent_projection.")
        else:
            raise KeyError(f"unexpected model leaf {top}")


def _tree_get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _to_torch_layout(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == _CONV:
        return arr.transpose(2, 1, 0)
    if kind == _DENSE:
        return arr.transpose(1, 0)
    return arr


def jax_trees_to_state_dict(params: Dict[str, Any],
                            batch_stats: Dict[str, Any],
                            target_keys: Optional[Collection[str]] = None,
                            backbone_only: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``(params, batch_stats)`` NumPy trees as the port's
    ``state_dict`` (fp32 CPU tensors; ``num_batches_tracked`` zeros beside
    each norm's running stats, so a strict ``load_state_dict`` takes it).
    ``target_keys`` and ``backbone_only`` as in :func:`model_specs`."""
    sd: Dict[str, torch.Tensor] = {}
    for path, key, kind in model_specs(params, batch_stats, target_keys,
                                       backbone_only):
        tree = batch_stats if path[-1] in _STAT_LEAVES else params
        arr = _to_torch_layout(np.asarray(_tree_get(tree, path)), kind)
        sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
        if key.endswith("running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.long)
    return sd


def _rename_leaves(tree, old: str, new: str):
    if not isinstance(tree, dict):
        return tree
    return {(new if k == old else k): _rename_leaves(v, old, new)
            for k, v in tree.items()}


def jax_quant_to_absmax(quant: Dict[str, Any],
                        target_keys: Optional[Collection[str]] = None
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``quant`` collection (each int8 layer's
    ``act_absmax``, beside where its ``kernel`` lies in ``params``) as
    ``{port module name: absmax}`` (fp32 0-d tensors), the names
    ``models.quant_layers.int8_modules`` gives and
    ``utils.calibrate.calibrate_quant`` returns. ``target_keys`` as in
    :func:`model_specs`."""
    as_params = _rename_leaves(quant, "act_absmax", "kernel")
    out: Dict[str, torch.Tensor] = {}
    for path, key, _ in model_specs(as_params, {}, target_keys):
        if path[-1] != "kernel":
            continue
        try:
            value = _tree_get(quant, path[:-1] + ("act_absmax",))
        except KeyError:
            continue
        out[key[:-len(".weight")]] = torch.tensor(
            float(np.asarray(value)), dtype=torch.float32)
    return out
