"""Model registry + config-driven assembly (counterpart of
``semi_seg_ecg_tpu/models/__init__.py``).

``backbone: {name: kwargs}`` and ``decode_head: {name: kwargs}`` pick entries
from :data:`BACKBONES` / :data:`DECODE_HEADS` and are wrapped in an
:class:`EncoderDecoder`, with ``auxiliary_heads`` attached for training
builds. The whole JAX registry is ported (ResNet-1D and ViT-1D families,
the FCN head); the ReCo latent projection and int8 serving raise "not yet
ported" instead of building something else.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .backbones.resnet import (
    ResNet1D,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from .backbones.vision_transformer import (
    VisionTransformer1D,
    vit_base,
    vit_small,
    vit_tiny,
)
from .decode_heads.fcn_head import FCNHead
from .encoder_decoder import EncoderDecoder

BACKBONES = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "vit_tiny": vit_tiny,
    "vit_small": vit_small,
    "vit_base": vit_base,
}

DECODE_HEADS = {
    "FCNHead": FCNHead,
}

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32,
           "fp16": torch.float16}


def compute_dtype(config: Dict[str, Any]) -> torch.dtype:
    """The autocast dtype the config's ``precision`` names."""
    return _DTYPES[config.get("precision", "bf16")]


def build_model_from_config(config: Dict[str, Any],
                            train: bool = False) -> EncoderDecoder:
    """A config's model (``init_model_from_cfg`` parity), in eval mode.
    ``train=True`` builds the training graph: auxiliary heads are attached
    only then, and ``quantize`` (a serving option) is ignored, as in the JAX
    package. What the port cannot build yet raises ``NotImplementedError``."""
    if config.get("quantize", None) and not train:
        raise NotImplementedError(
            f"quantize: {config['quantize']!r} is not yet ported to the "
            "torch package")
    if config.get("use_latent_projection", False):
        raise NotImplementedError(
            "use_latent_projection (ReCo) is not yet ported to the torch "
            "package")

    backbone_name, backbone_kwargs = list(config["backbone"].items())[0]
    if backbone_name not in BACKBONES:
        raise ValueError(f"Unsupported model name: {backbone_name}")
    backbone = BACKBONES[backbone_name](**(backbone_kwargs or {}))

    decoder_name, decoder_kwargs = list(config["decode_head"].items())[0]
    if decoder_name not in DECODE_HEADS:
        raise ValueError(f"Unsupported decode head name: {decoder_name}")
    decode_head = DECODE_HEADS[decoder_name](**(decoder_kwargs or {}))

    auxiliary_heads = None
    if config.get("auxiliary_heads", None) and train:
        auxiliary_heads = []
        for aux_cfg in config["auxiliary_heads"]:
            aux_name, aux_kwargs = list(aux_cfg.items())[0]
            if aux_name not in DECODE_HEADS:
                raise ValueError(
                    f"Unsupported auxiliary head name: {aux_name}")
            auxiliary_heads.append(DECODE_HEADS[aux_name](
                **(aux_kwargs or {})))
    return EncoderDecoder(backbone=backbone, decode_head=decode_head,
                          auxiliary_heads=auxiliary_heads).eval()


__all__ = ["BACKBONES", "DECODE_HEADS", "EncoderDecoder", "FCNHead",
           "ResNet1D", "VisionTransformer1D", "build_model_from_config",
           "compute_dtype"]
