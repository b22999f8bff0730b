"""Checkpoints (counterpart of ``semi_seg_ecg_tpu/utils/checkpoint.py``).

Two formats come in:

- a ``.ckpt``: a pickle with NumPy leaves. The JAX package writes ``{epoch,
  model: {params, batch_stats}, config, ...}``; the port's trainer writes
  :func:`save_checkpoint`'s ``{epoch, step, model: <flat state_dict>,
  optimizer, config, metrics, best}``, with Mean Teacher's ``model_ema``
  and CPS's ``model_peer`` / ``peer_optimizer`` under the JAX package's
  payload keys. Either is read with an unpickler
  that admits only NumPy's array and dtype constructors, so a file that
  names a JAX class (or anything else) is refused rather than imported;
  JAX ``model`` trees go through ``utils/weights.py``. A flat state_dict
  is the JAX package's torch format, so its ``load_checkpoint`` and
  ``restore_model_state`` read the port's files as they are;
- a torch ``.pth`` in the reference layout, ``{model: state_dict, ...}``,
  which is what :func:`save_torch_checkpoint` writes and what the JAX
  package's own ``.pth`` loader reads.

:func:`maybe_resume` restarts a run (``resume:`` / ``--resume``) from any
of the three: the port's own ``.ckpt`` restores everything it holds, a JAX
``.ckpt`` its trees and, through ``utils/optim_state.py``, its optax
state, a ``.pth`` the model only.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Collection, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .logging import log
from .optim_state import load_optax_leaves
from .weights import jax_trees_to_state_dict

# what a NumPy-leaved pickle may name: array and scalar reconstruction,
# dtypes (numpy >= 2 moved numpy.core to numpy._core)
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")
_NUMPY_NAMES = ("_reconstruct", "_frombuffer", "ndarray", "dtype", "scalar")


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module in _NUMPY_MODULES and name in _NUMPY_NAMES) or (
                module == "numpy.dtypes" and name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint names {module}.{name}: only NumPy arrays and plain "
            "Python values can be read without the framework that wrote "
            "them")


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint's payload: torch tensors for ``.pth``/``.pt``, NumPy
    trees for the JAX package's pickle ``.ckpt``."""
    if path.endswith((".pth", ".pt")):
        return torch.load(path, map_location="cpu", weights_only=True)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: orbax directory checkpoints are not yet ported to the "
            "torch package; convert one with "
            "`python tools/convert_checkpoint.py to-torch`")
    with open(path, "rb") as f:
        return _NumpyOnlyUnpickler(f).load()


def model_state_dict(payload_model: Dict[str, Any],
                     target_keys: Optional[Collection[str]] = None
                     ) -> Dict[str, torch.Tensor]:
    """A checkpoint's ``model`` entry as the port's ``state_dict``: JAX
    ``{params, batch_stats}`` trees are translated (``target_keys``, the
    receiving model's keys, resolve the ResNet ``avg_down`` names), a flat
    state_dict (of tensors or NumPy arrays) is taken key for key."""
    if isinstance(payload_model, dict) and "params" in payload_model:
        return jax_trees_to_state_dict(payload_model["params"],
                                       payload_model.get("batch_stats", {}),
                                       target_keys)
    return {k: torch.as_tensor(v) for k, v in payload_model.items()}


def _to_numpy(obj):
    """Tensors → NumPy arrays, through dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _state(optimizer) -> Dict[str, Any]:
    return optimizer if isinstance(optimizer, dict) else \
        optimizer.state_dict()


def _model_state(model) -> Dict[str, Any]:
    return model if isinstance(model, dict) else model.state_dict()


def save_checkpoint(path: Union[str, Sequence[str]], epoch: int,
                    model: Union[torch.nn.Module, Dict[str, Any]],
                    optimizer=None,
                    config: Optional[Dict[str, Any]] = None,
                    metrics: Optional[Dict[str, Any]] = None,
                    best: Optional[Dict[str, Any]] = None,
                    step: Optional[int] = None,
                    ema_model=None, peer_model=None,
                    peer_optimizer=None
                    ) -> None:
    """Write one training checkpoint, a pickle with NumPy leaves, to each
    of ``path`` (one payload, fetched from the device once), atomically
    (temporary file, then rename). The Mean Teacher's teacher goes under
    ``model_ema``, the CPS peer and its optimizer under ``model_peer`` and
    ``peer_optimizer``, each model a flat state_dict. A model is given as
    itself or as its state_dict, an optimizer as itself or as its
    ``state_dict()`` (a model sliced over the model axis and a ZeRO-1
    optimizer give theirs through collectives, which every rank takes
    before rank 0 writes: ``algorithms/common.Trainer.checkpoint_state``). The write is
    synchronous: ``async_checkpoint`` (the JAX package's background writer)
    changes when the file appears, not what it holds, so the port accepts
    it and writes here."""
    paths = [path] if isinstance(path, str) else list(path)
    payload: Dict[str, Any] = {
        "epoch": epoch,
        "step": step,
        "model": _to_numpy(_model_state(model)),
        "config": config,
    }
    if optimizer is not None:
        payload["optimizer"] = _to_numpy(_state(optimizer))
    if ema_model is not None:
        payload["model_ema"] = _to_numpy(_model_state(ema_model))
    if peer_model is not None:
        payload["model_peer"] = _to_numpy(_model_state(peer_model))
    if peer_optimizer is not None:
        payload["peer_optimizer"] = _to_numpy(_state(peer_optimizer))
    if metrics is not None:
        payload["metrics"] = {k: float(v) for k, v in metrics.items()}
    if best is not None:
        payload["best"] = {k: float(v) for k, v in best.items()}
    for p in paths:
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, p)


def save_torch_checkpoint(path: str, model: torch.nn.Module,
                          epoch: Optional[int] = None,
                          config: Optional[Dict[str, Any]] = None) -> None:
    """Write ``{model, epoch, config}`` as a torch ``.pth`` (reference
    layout, CPU tensors), atomically."""
    payload = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "epoch": epoch,
        "config": config,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def resolve_checkpoint_url(path: str) -> str:
    """URL-resume capability (reference misc.py:307-309 uses torch.hub).

    This build runs with zero network egress, so URLs resolve against the
    torch-hub download cache instead of the network: ``file://`` maps to the
    local path, and ``http(s)://`` URLs are looked up by filename in
    ``$TORCH_HOME/hub/checkpoints`` (the directory ``torch.hub`` populates).
    A cache miss raises with instructions rather than attempting a fetch."""
    if path.startswith("file://"):
        return path[len("file://"):]
    if not path.startswith(("http://", "https://")):
        return path
    fname = os.path.basename(path.split("?", 1)[0])
    torch_home = os.environ.get(
        "TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache", "torch")
    )
    cached = os.path.join(torch_home, "hub", "checkpoints", fname)
    if os.path.exists(cached):
        log(f"URL resume served from torch-hub cache: {cached}")
        return cached
    raise FileNotFoundError(
        f"URL resume requires a pre-downloaded checkpoint (no network "
        f"egress). Place the file at {cached} or pass a local path."
    )


def _restore_module(module: torch.nn.Module, payload_model) -> None:
    module.load_state_dict(model_state_dict(payload_model,
                                            module.state_dict().keys()))


def maybe_resume(config: Dict[str, Any], trainer) -> Optional[Dict[str, Any]]:
    """``--resume`` (the JAX package's ``maybe_resume``, reference
    misc.py:305-321) into a built ``trainer`` (``algorithms/common.Trainer``),
    in place: the model, and the teacher (``model_ema``) and peer
    (``model_peer``) where both run and file have one. A torch ``.pth``
    then restarts the optimizer; the port's ``.ckpt`` and a JAX ``.ckpt``
    restore the optimizers (the update count and an open accumulation
    window too) and the step. Sets ``config["start_epoch"]`` to the file's
    epoch + 1. Returns the file's best-so-far thresholds (``best``), if
    any."""
    resume = config.get("resume")
    if not resume:
        return None
    resume = resolve_checkpoint_url(str(resume))
    payload = load_checkpoint(resume)
    _restore_module(trainer.model, payload["model"])
    for module, key in ((trainer.teacher, "model_ema"),
                        (trainer.peer, "model_peer")):
        if module is not None and key in payload:
            _restore_module(module, payload[key])
    log(f"Resume checkpoint {resume}")
    if resume.endswith((".pth", ".pt")):
        # a torch optimizer's state is keyed by the writer's param groups:
        # the weights warm-start, the statistics restart; the epoch counter
        # carries over (reference misc.py:315-320)
        if payload.get("epoch") is not None:
            config["start_epoch"] = payload["epoch"] + 1
            log(f"Torch-format checkpoint: model restored, optimizer "
                f"restarted, resuming at epoch {config['start_epoch']}")
        else:
            log("Torch-format checkpoint: model restored, optimizer "
                "restarted")
        return payload.get("best")
    if "optimizer" in payload and payload.get("epoch") is not None:
        jax_trees = "params" in payload["model"]
        for optimizer, key, model_key, module in (
                (trainer.optimizer, "optimizer", "model", trainer.model),
                (trainer.peer_optimizer, "peer_optimizer", "model_peer",
                 trainer.peer)):
            if optimizer is None or key not in payload:
                continue
            if jax_trees:
                load_optax_leaves(optimizer, payload[key],
                                  payload[model_key]["params"],
                                  module.state_dict().keys())
            else:
                # files written before accumulation was ported hold no
                # count; every step was an update then
                optimizer.load_state_dict(
                    {"count": payload.get("step") or 0, **payload[key]})
        if payload.get("step") is not None:
            trainer.step = int(payload["step"])
        config["start_epoch"] = payload["epoch"] + 1
        log("With optim & sched!")
    return payload.get("best")
