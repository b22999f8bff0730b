"""Config system: YAML base + YAML override deep-merge + CLI precedence.

Mirrors the reference behaviour (src/train.py:14-76): the base YAML is loaded,
an optional override YAML is deep-merged on top (reference used
``mergedeep.merge``; we implement the same additive strategy natively), and
truthy CLI arguments overwrite top-level keys. ``model_path`` is special-cased
into ``config['test']['model_path']`` (src/test.py:63-68).

The resulting raw dict keeps the exact reference schema so that the 26 shipped
reference config files run unmodified. A copy of the JAX package's
``config.py`` except for the device key: ``device:`` names a torch device
here (``cuda``, or ``cpu`` when asked for explicitly), see
:func:`resolve_device`.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Any, Dict, Optional

import yaml


def deep_merge(dest: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    """Additive deep merge: nested dicts merge recursively, everything else
    (including lists) is replaced by ``src``. Same semantics as
    ``mergedeep.merge`` with the default additive strategy."""
    for key, src_val in src.items():
        dest_val = dest.get(key)
        if isinstance(dest_val, dict) and isinstance(src_val, dict):
            deep_merge(dest_val, src_val)
        else:
            dest[key] = src_val
    return dest


def load_config(
    config_path: str,
    override_config_path: Optional[str] = None,
) -> Dict[str, Any]:
    with open(os.path.realpath(config_path), "r") as f:
        config = yaml.safe_load(f)
    if override_config_path:
        with open(os.path.realpath(override_config_path), "r") as f:
            override = yaml.safe_load(f)
        config = deep_merge(config, override)
    return config


def _add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "-f", "--config_path", dest="config_path", required=True, type=str,
        metavar="FILE", help="YAML config file path",
    )
    parser.add_argument(
        "-o", "--override_config_path", dest="override_config_path",
        default=None, type=str, metavar="FILE",
        help="YAML config file path to override",
    )
    parser.add_argument(
        "--output_dir", default="", type=str, metavar="DIR",
        help="path where to save",
    )
    parser.add_argument(
        "--exp_name", default="", type=str, help="experiment name",
    )


def parse_train_args(argv=None) -> Dict[str, Any]:
    """CLI surface of the reference train entry (src/train.py:14-76)."""
    parser = argparse.ArgumentParser("ECG segmentation training")
    _add_common_args(parser)
    parser.add_argument(
        "--resume", default="", type=str, metavar="PATH",
        help="resume from checkpoint",
    )
    parser.add_argument(
        "--start_epoch", default=0, type=int, metavar="N", help="start epoch",
    )
    args = parser.parse_args(argv)
    config = load_config(args.config_path, args.override_config_path)
    for k, v in vars(args).items():
        if v:
            config[k] = v
    return normalize_config(config)


def parse_eval_args(argv=None, prog: str = "ECG segmentation test") -> Dict[str, Any]:
    """CLI surface of the reference test/inference entries
    (src/test.py:12-71, src/inference.py:16-74)."""
    parser = argparse.ArgumentParser(prog)
    _add_common_args(parser)
    parser.add_argument(
        "--model_path", default="", type=str, metavar="PATH",
        help="saved checkpoint to evaluate",
    )
    args = parser.parse_args(argv)
    config = load_config(args.config_path, args.override_config_path)
    for k, v in vars(args).items():
        if v:
            if k == "model_path":
                # the test: section may be a boolean flag (see test_cfg)
                config["test"] = test_cfg(config)
                config["test"]["model_path"] = v
            else:
                config[k] = v
    return normalize_config(config)


# every accelerator spelling of the shipped configs (``tpu``, the
# reference's ``cuda``, ``gpu``, or no key at all) means the CUDA card; the
# CPU only when a config asks for it by name
_DEVICE_MAP = {None: "cuda", "cuda": "cuda", "gpu": "cuda", "tpu": "cuda",
               "cpu": "cpu"}


def normalize_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Map legacy reference-schema knobs onto this framework.

    - ``device:`` → ``cuda`` or ``cpu`` (``_DEVICE_MAP``).
    - ``use_amp: true`` → bf16 compute policy (``precision: bf16``) unless an
      explicit ``precision`` key is present.
    - ``eash_conf_thresh`` (reference typo key, configs/base/resnet18/
      reco.yaml:113) is aliased to ``easy_conf_thresh``; both spellings are
      accepted, the typo wins if both present for drop-in parity.
    """
    config = copy.deepcopy(config)
    device = config.get("device", None)
    if device not in _DEVICE_MAP:
        raise ValueError(f"unknown device {device!r}; expected one of "
                         f"{sorted(k for k in _DEVICE_MAP if k)}")
    config["device"] = _DEVICE_MAP[device]
    if "precision" not in config:
        config["precision"] = "bf16" if config.get("use_amp", True) else "fp32"
    train_cfg = config.get("train")
    if isinstance(train_cfg, dict):
        if "eash_conf_thresh" in train_cfg:
            train_cfg["easy_conf_thresh"] = train_cfg["eash_conf_thresh"]
        elif "easy_conf_thresh" in train_cfg:
            train_cfg["eash_conf_thresh"] = train_cfg["easy_conf_thresh"]
    config.setdefault("seed", 0)
    config.setdefault("start_epoch", 0)
    config.setdefault("resume", None)
    return config


def resolve_device(config: Dict[str, Any]):
    """The torch device a normalized config asks for: under a process
    group, the rank's card ``cuda:{LOCAL_RANK}``. Raises when it asks for
    CUDA and there is none, or when the host has no card of that index:
    an entry never drops to the CPU unasked."""
    import torch
    import torch.distributed as dist

    device = config.get("device") or "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "config asks for the CUDA device (device: cuda/gpu/tpu or no "
            "device key) but torch.cuda.is_available() is False; set "
            "device: cpu to run on the CPU")
    if device == "cuda" and dist.is_initialized():
        from .parallel.dist import cuda_device

        return cuda_device()
    return torch.device(device)


def test_cfg(config: Dict[str, Any]) -> Dict[str, Any]:
    """The ``test:`` section as a dict. The reference treats ``config.test``
    as a truthy flag (src/train.py:87-90), so booleans are legal YAML here;
    accessors must not assume a mapping."""
    t = config.get("test")
    return t if isinstance(t, dict) else {}


def experiment_dir(config: Dict[str, Any]) -> Optional[str]:
    if not config.get("output_dir"):
        return None
    return os.path.join(config["output_dir"], config.get("exp_name", ""))
