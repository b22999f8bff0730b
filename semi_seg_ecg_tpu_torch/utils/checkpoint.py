"""Checkpoints (counterpart of ``semi_seg_ecg_tpu/utils/checkpoint.py``).

Two formats come in:

- a ``.ckpt``: a pickle with NumPy leaves. The JAX package writes ``{epoch,
  model: {params, batch_stats}, config, ...}``; the port's trainer writes
  :func:`save_checkpoint`'s ``{epoch, step, model: <flat state_dict>,
  optimizer, config, metrics, best}``. Either is read with an unpickler
  that admits only NumPy's array and dtype constructors, so a file that
  names a JAX class (or anything else) is refused rather than imported;
  JAX ``model`` trees go through ``utils/weights.py``. A flat state_dict
  is the JAX package's torch format, so its ``load_checkpoint`` and
  ``restore_model_state`` read the port's files as they are;
- a torch ``.pth`` in the reference layout, ``{model: state_dict, ...}``,
  which is what :func:`save_torch_checkpoint` writes and what the JAX
  package's own ``.pth`` loader reads.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

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
            "torch package")
    with open(path, "rb") as f:
        return _NumpyOnlyUnpickler(f).load()


def model_state_dict(payload_model: Dict[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """A checkpoint's ``model`` entry as the port's ``state_dict``: JAX
    ``{params, batch_stats}`` trees are translated, a flat state_dict (of
    tensors or NumPy arrays) is taken key for key."""
    if isinstance(payload_model, dict) and "params" in payload_model:
        return jax_trees_to_state_dict(payload_model["params"],
                                       payload_model.get("batch_stats", {}))
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


def save_checkpoint(path: Union[str, Sequence[str]], epoch: int,
                    model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    config: Optional[Dict[str, Any]] = None,
                    metrics: Optional[Dict[str, Any]] = None,
                    best: Optional[Dict[str, Any]] = None,
                    step: Optional[int] = None) -> None:
    """Write one training checkpoint, a pickle with NumPy leaves, to each
    of ``path`` (one payload, fetched from the device once), atomically
    (temporary file, then rename)."""
    paths = [path] if isinstance(path, str) else list(path)
    payload: Dict[str, Any] = {
        "epoch": epoch,
        "step": step,
        "model": _to_numpy(model.state_dict()),
        "config": config,
    }
    if optimizer is not None:
        payload["optimizer"] = _to_numpy(optimizer.state_dict())
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
