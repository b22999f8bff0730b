"""Convert checkpoints between the reference's torch ``.pth`` format and the
``.ckpt`` format, both directions (the port of
``tools/convert_checkpoint.py``).

    # any checkpoint the port reads -> reference-loadable .pth
    python -m semi_seg_ecg_tpu_torch.tools.convert_checkpoint to-torch \\
        best-MeanIoU.ckpt out.pth [--backbone-only]
    # reference .pth -> .ckpt (config read from the checkpoint when it
    # embeds one; pass -f for config-less pretrained-backbone files)
    python -m semi_seg_ecg_tpu_torch.tools.convert_checkpoint to-framework \\
        best-loss.pth out.ckpt [-f CONFIG] [--backbone-only]

``to-torch`` reads what ``utils/checkpoint.load_checkpoint`` reads: a JAX
``.ckpt`` (its ``{params, batch_stats}`` trees translated by
``utils/weights.py``, against the keys of the config's model where the
file embeds a config), the port's ``.ckpt`` and the port's
``torch.distributed.checkpoint`` directory (flat state_dicts). It writes
the reference layout ``{epoch, model, optimizer: None, scaler: None,
config, metrics?, model_ema?}``. A JAX orbax directory is refused: only
the JAX package reads orbax (its ``tools/convert_checkpoint.py to-torch``
converts one).

``to-framework`` writes the port's ``.ckpt``: a pickle with NumPy leaves
whose ``model`` (and ``model_ema``) is the flat state_dict of the config's
model (``backbone.``-prefixed with ``--backbone-only``, auto-detected when
no key names the backbone or the decode head), which the port and the JAX
package both read. Every key of the model must be in the file (BatchNorm's
``num_batches_tracked`` counters start at 0 where absent); keys the model
lacks are dropped, as the reference drops an SSL pretraining's leftovers.

Optimizer statistics are not translated: a converted checkpoint warm-starts
the model and restarts the optimizer, as the reference does on a
cross-format resume (misc.py:315-320). Host code only: no device is
touched.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _load_config(args, embedded):
    import yaml

    if args.config:
        with open(args.config) as f:
            return yaml.safe_load(f)
    if embedded is not None:
        return embedded
    raise SystemExit(
        "checkpoint embeds no config; pass -f/--config to describe the model"
    )


def _model(config) -> torch.nn.Module:
    """The config's training model on the CPU: the key space of the
    trees' translation and of the state_dict a ``.ckpt`` must hold."""
    from ..models import build_model_from_config

    return build_model_from_config(config, train=True)


def _strip_backbone(sd):
    if any(k.startswith("backbone.") for k in sd):
        return {k[len("backbone."):]: v for k, v in sd.items()
                if k.startswith("backbone.")}
    return sd


def _take(sd, target, name):
    """``sd``'s tensors for every key of ``target`` (a state_dict), as NumPy
    arrays of the target's dtype and shape."""
    out = {}
    for key, want in target.items():
        if key in sd:
            got = torch.as_tensor(np.asarray(sd[key]))
        elif key.endswith("num_batches_tracked"):
            got = torch.zeros_like(want)
        else:
            raise KeyError(f"{name}: the checkpoint holds no {key}")
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"{name}: {key} has shape {tuple(got.shape)}, "
                             f"the model's is {tuple(want.shape)}")
        out[key] = got.to(want.dtype).numpy()
    return out


def to_framework(args) -> None:
    from ..utils import checkpoint as ckpt

    payload = ckpt.load_checkpoint(args.src)
    sd = payload.get("model", payload)
    backbone_only = args.backbone_only or not any(
        k.startswith(("backbone.", "decode_head.")) for k in sd)
    config = _load_config(args, payload.get("config"))
    model = _model(config)
    target = (model.backbone if backbone_only else model).state_dict()

    def convert(state, name):
        if backbone_only:
            return {f"backbone.{k}": v for k, v in _take(
                _strip_backbone(state), target, name).items()}
        return _take(state, target, name)

    ema = payload.get("model_ema")
    ckpt.save_checkpoint(
        args.dst, epoch=payload.get("epoch", 0), model=convert(sd, "model"),
        config=config, metrics=payload.get("metrics"),
        ema_model=convert(ema, "model_ema") if ema else None)
    print(f"wrote {args.dst} "
          f"({'backbone-only' if backbone_only else 'full model'})")


def to_torch(args) -> None:
    from ..utils import checkpoint as ckpt

    payload = ckpt.load_checkpoint(args.src)
    model = payload["model"]
    target_keys = None
    if "params" in model and payload.get("config"):
        target_keys = _model(payload["config"]).state_dict().keys()
    sd = ckpt.model_state_dict(model, target_keys)
    if args.backbone_only:
        sd = _strip_backbone(sd)
    entries = {"optimizer": None, "scaler": None}
    if payload.get("metrics") is not None:
        entries["metrics"] = payload["metrics"]
    if payload.get("model_ema") is not None:
        entries["model_ema"] = ckpt.model_state_dict(payload["model_ema"],
                                                     target_keys)
    ckpt.save_torch_checkpoint(args.dst, sd, epoch=payload.get("epoch", 0),
                               config=payload.get("config"), **entries)
    print(f"wrote {args.dst}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, fn in (("to-framework", to_framework), ("to-torch", to_torch)):
        p = sub.add_parser(name)
        p.add_argument("src")
        p.add_argument("dst")
        p.add_argument("-f", "--config", default=None,
                       help="YAML config describing the model (defaults to "
                            "the config embedded in the checkpoint)")
        p.add_argument("--backbone-only", action="store_true",
                       help="treat the checkpoint as a bare backbone "
                            "state_dict (auto-detected for .pth inputs)")
        p.set_defaults(fn=fn)
    args = parser.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
