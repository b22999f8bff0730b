"""Model registry + config-driven assembly (counterpart of
``semi_seg_ecg_tpu/models/__init__.py``).

``backbone: {name: kwargs}`` and ``decode_head: {name: kwargs}`` pick entries
from :data:`BACKBONES` / :data:`DECODE_HEADS` and are wrapped in an
:class:`EncoderDecoder`. Only what serving the ViT needs is ported; every
other part of the JAX registry raises "not yet ported" instead of building
something else.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .backbones.vision_transformer import (
    VisionTransformer1D,
    vit_base,
    vit_small,
    vit_tiny,
)
from .decode_heads.fcn_head import FCNHead
from .encoder_decoder import EncoderDecoder

BACKBONES = {
    "vit_tiny": vit_tiny,
    "vit_small": vit_small,
    "vit_base": vit_base,
}

DECODE_HEADS = {
    "FCNHead": FCNHead,
}

# names the JAX package builds that this package does not build yet
NOT_YET_PORTED = ("resnet18", "resnet34", "resnet50", "resnet101",
                  "resnet152")

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32,
           "fp16": torch.float16}


def compute_dtype(config: Dict[str, Any]) -> torch.dtype:
    """The autocast dtype the config's ``precision`` names."""
    return _DTYPES[config.get("precision", "bf16")]


def build_model_from_config(config: Dict[str, Any]) -> EncoderDecoder:
    """The eval-mode model of a config (``init_model_from_cfg`` parity).
    What the port cannot build yet raises ``NotImplementedError``."""
    if config.get("quantize", None):
        raise NotImplementedError(
            f"quantize: {config['quantize']!r} is not yet ported to the "
            "torch package")
    if config.get("auxiliary_heads", None):
        raise NotImplementedError(
            "auxiliary_heads are not yet ported to the torch package")
    if config.get("use_latent_projection", False):
        raise NotImplementedError(
            "use_latent_projection (ReCo) is not yet ported to the torch "
            "package")

    backbone_name, backbone_kwargs = list(config["backbone"].items())[0]
    if backbone_name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"backbone {backbone_name!r} is not yet ported to the torch "
            "package")
    if backbone_name not in BACKBONES:
        raise ValueError(f"Unsupported model name: {backbone_name}")
    backbone = BACKBONES[backbone_name](**(backbone_kwargs or {}))

    decoder_name, decoder_kwargs = list(config["decode_head"].items())[0]
    if decoder_name not in DECODE_HEADS:
        raise ValueError(f"Unsupported decode head name: {decoder_name}")
    decode_head = DECODE_HEADS[decoder_name](**(decoder_kwargs or {}))
    return EncoderDecoder(backbone=backbone, decode_head=decode_head)


__all__ = ["BACKBONES", "DECODE_HEADS", "EncoderDecoder", "FCNHead",
           "VisionTransformer1D", "build_model_from_config",
           "compute_dtype"]
