"""BEiT-style layer-wise learning-rate decay over the port's parameter names
(counterpart of ``semi_seg_ecg_tpu/utils/lr_decay.py``).

The JAX package gives each leaf of its parameter tree an lr scale and a
weight-decay flag; here the same two come per ``named_parameters()`` name,
for :mod:`.optimizer` to group into ``torch.optim`` param groups.

Layer ids: the embeddings (``cls_embedding``, ``pos_embedding``) and the
patch embedding (``to_patch_embedding.*``) are 0, transformer block ``i``
(``block{i}.*``) is ``i + 1``, everything else (the final norm, the decode
and auxiliary heads, ReCo's ``latent_projection``) is ``num_layers``, with
``num_layers = depth + 1`` and ``scale = layer_decay ** (num_layers -
id)``. Weight decay skips parameters with at most one dimension and those
named in the model's ``no_weight_decay()``.
"""

from __future__ import annotations

from typing import Collection, Dict, Tuple

import torch

EMBEDDINGS = ("cls_embedding", "pos_embedding", "to_patch_embedding")


def get_layer_id(name: str, num_layers: int) -> int:
    """The layer id of parameter ``name`` (a ``named_parameters()`` name of
    the model, or of its bare backbone)."""
    parts = name.split(".")
    if parts[0] == "backbone":
        parts = parts[1:]
    head = parts[0] if parts else ""
    if head in EMBEDDINGS:
        return 0
    if head.startswith("block") and head[5:].isdigit():
        return int(head[5:]) + 1
    return num_layers


def decays_weight(name: str, param: torch.Tensor,
                  no_weight_decay: Collection[str]) -> bool:
    """Whether ``param`` takes weight decay under layer decay."""
    if param.ndim <= 1:
        return False
    return not any(part in no_weight_decay for part in name.split("."))


def param_lr_scales_and_wd(model: torch.nn.Module, layer_decay: float
                           ) -> Dict[str, Tuple[float, bool]]:
    """``{name: (lr scale, takes weight decay)}`` for every parameter of
    ``model``, whose backbone must have a ``depth``."""
    depth = getattr(getattr(model, "backbone", model), "depth", None)
    if depth is None:
        raise ValueError("train.layer_decay needs a backbone with a depth "
                         "(the ViT's blocks); this backbone has none")
    num_layers = depth + 1
    no_wd = model.no_weight_decay() if hasattr(model, "no_weight_decay") \
        else set()
    return {name: (layer_decay ** (num_layers - get_layer_id(name,
                                                             num_layers)),
                   decays_weight(name, p, no_wd))
            for name, p in model.named_parameters()}
