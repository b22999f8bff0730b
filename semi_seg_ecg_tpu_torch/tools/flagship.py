"""The flagship recipe the measuring tools time, and the pieces they share.

- :func:`flagship_config`: FixMatch ResNet18-1D with the FCN head, bf16,
  batch 16 a replica, length 2,500, AdamW at 1e-3 (the port's copy of the
  repo's ``__graft_entry__._flagship_config``, the reference's north-star
  recipe shape, ``configs/base/resnet18/fixmatch.yaml``);
- :func:`flagship_data_recipe`: its filter, weak, strong and transform
  chains (the copy of ``tools/gen_configs.flagship_data_recipe``, the one
  recipe every benchmark merges over its dataset config);
- :data:`MODELS`: the backbones of the training matrix at full width
  (``tools/bench_matrix.py``);
- :func:`synthetic_batch` and :func:`build_trainer`: a seeded step batch
  on the device and a ``Trainer`` on it;
- :func:`serving_fn`: the flagship's eval model with seed-0 weights as a
  ``serving.ServingFn`` at fp32, under bf16 autocast, or in int8 (dynamic
  scales, or static ones calibrated on given batches);
- :func:`synth_record`: an ECG-shaped long record at 250 Hz.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch

from ..algorithms import get_algorithm
from ..algorithms.common import Trainer, init_model
from ..config import normalize_config
from ..models import build_model_from_config
from ..serving import ServingFn

FS = 250

SIGNAL_LENGTH = 2500

_RESNET = {"num_leads": 1, "num_stages": 4, "out_indices": [0, 1, 2, 3],
           "dilations": [1, 1, 1, 1], "strides": [1, 2, 2, 2],
           "deep_stem": False, "avg_down": False,
           "contract_dilation": False}
_VIT = {"seq_len": SIGNAL_LENGTH, "patch_size": 25, "num_leads": 1,
        "fp16_enabled": True}

# backbone config and the FCN head's input channels
MODELS = {
    "resnet18": ({"resnet18": dict(_RESNET)}, 512),
    "resnet50": ({"resnet50": dict(_RESNET)}, 2048),
    "vit_tiny": ({"vit_tiny": dict(_VIT)}, 192),
    "vit_base": ({"vit_base": dict(_VIT)}, 768),
}

STRONG_AUG = [
    {"RandAugment": {
        "ops": [
            {"AmplitudeScaling": {"sigma": 0.5}},
            {"AdaptivePowerlineNoise": {"fs": 250}},
            {"RandomPartialWhiteNoise": {"amplitude": 1, "ratio": 0.5}},
            {"RandomPartialSineNoise": {"amplitude": 1, "ratio": 0.5}},
        ],
        "level": 10,
        "num_layers": 3,
        "prob": 0.5,
    }},
]


def flagship_data_recipe(length: int = SIGNAL_LENGTH) -> Dict[str, Any]:
    """The FixMatch flagship pipeline blocks (filter, weak, strong,
    transforms) to merge over a dataset config."""
    return {
        "filter": [
            {"highpass_filter": {"fs": 250, "cutoff": 0.67}},
            {"lowpass_filter": {"fs": 250, "cutoff": 40}},
        ],
        "augmentations": [
            {"random_resize_crop": {"target_length": length,
                                    "scale_min": 0.5, "scale_max": 2.0}},
        ],
        "strong_augmentations": copy.deepcopy(STRONG_AUG),
        "transforms": [
            {"standardize": {"axis": [-1, -2]}},
            {"to_tensor": {"dtype": "float"}},
        ],
    }


def flagship_config(signal_length: int = SIGNAL_LENGTH,
                    batch_per_replica: int = 16, device: str = "cuda",
                    model: str = "resnet18", algorithm: str = "fixmatch"
                    ) -> Dict[str, Any]:
    """The flagship recipe, normalized, on ``device``; ``model`` another
    backbone of :data:`MODELS`, ``algorithm`` another algorithm."""
    backbone, head_in = copy.deepcopy(MODELS[model])
    for kwargs in backbone.values():
        if "seq_len" in kwargs:
            kwargs["seq_len"] = signal_length
    return normalize_config({
        "device": device,
        "seed": 0,
        "precision": "bf16",
        "algorithm": algorithm,
        "mode": "scratch",
        "backbone": backbone,
        "decode_head": {
            "FCNHead": {
                "in_channels": head_in, "in_index": 3, "channels": 128,
                "num_convs": 1, "concat_input": False, "dropout_ratio": 0.1,
                "num_classes": 4, "align_corners": False,
            }
        },
        "dataset": {"signal_length": signal_length},
        "dataloader": {"batch_size": batch_per_replica},
        "train": {
            "epochs": 100, "accum_iter": 1, "warmup_epochs": 10,
            "min_lr": 1e-4, "blr": None, "lr": 1e-3, "weight_decay": 0.05,
            "max_norm": None, "layer_decay": None, "optimizer": "adamw",
            "optimizer_kwargs": {"betas": [0.9, 0.999]},
            "conf_thresh": 0.80,
        },
        "metric": {"task": "segmentation", "num_classes": 4,
                   "target_metrics": ["MeanIoU"]},
        "parallel": {"model_parallel": 1},
    })


def synthetic_batch(batch: int, length: int, device: torch.device,
                    seed: int = 0, strong: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """A step's batch from a numpy seed, on ``device``: labeled signals and
    labels, the unlabeled weak view and (``strong``) the strong view."""
    rng = np.random.default_rng(seed)
    signal = lambda: torch.from_numpy(  # noqa: E731
        rng.standard_normal((batch, 1, length)).astype(np.float32))
    out = {"ecg": signal(),
           "target": torch.from_numpy(rng.integers(0, 4, (batch, length))),
           "ecg_u_w": signal()}
    if strong:
        out["ecg_u_s"] = signal()
    return {k: v.to(device) for k, v in out.items()}


def build_trainer(config: Dict[str, Any], device: torch.device,
                  updates_per_epoch: int = 1000) -> Trainer:
    """A ``Trainer`` of ``config``'s algorithm on ``device``, its model
    initialised from the config's seed."""
    return Trainer(config, get_algorithm(config["algorithm"]).SPEC, device,
                   updates_per_epoch,
                   model=init_model(config, device))


def serving_fn(config: Dict[str, Any], device: torch.device,
               precision: str = "fp32", calibration=None) -> ServingFn:
    """``config``'s eval model with seed-0 weights on ``device``, as
    ``ServingFn``: ``precision`` ``fp32``, ``bf16`` (autocast) or ``int8``
    (the int8 build, fp32 around it: dynamic scales, or with
    ``calibration``, batches on ``device``, static ones)."""
    cfg = copy.deepcopy(config)
    if precision == "int8":
        cfg["quantize"] = "int8"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg["seed"])
        model = build_model_from_config(cfg, serving=True).to(device).eval()
    infer = ServingFn(model, device, precision == "bf16", torch.bfloat16)
    if calibration is not None:
        from ..utils.calibrate import calibrate_quant

        with infer.precision():
            calibrate_quant(model, calibration)
    return infer


def synth_record(hours: float, seed: int = 0) -> np.ndarray:
    """``(1, T)`` at 250 Hz: sharp periodic pulses (75 bpm), baseline
    wander and noise. The content does not move throughput; the shape keeps
    each window's standardization honest (a std away from 0)."""
    n = int(round(hours * 3600 * FS))
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) / FS
    beat_phase = (t % 0.8) / 0.8
    qrs = np.exp(-((beat_phase - 0.5) ** 2) / 2e-4).astype(np.float32)
    wander = 0.2 * np.sin(2 * np.pi * 0.05 * t).astype(np.float32)
    noise = rng.normal(0.0, 0.05, n).astype(np.float32)
    return (qrs + wander + noise)[None, :]
