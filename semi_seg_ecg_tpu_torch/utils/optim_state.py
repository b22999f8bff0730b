"""The JAX package's optimizer state in a port optimizer.

The JAX package checkpoints an optax state as ``jax.tree.leaves(opt_state)``
(``utils/checkpoint.py``): a flat list without its structure. For the
chains ``utils/optimizer.get_optimizer_from_config`` builds, the transforms
other than those below keep no state (clipping, weight decay, its mask,
the layer-decay scales, the frozen-gradient zeroing), so the list is,
with P the model's parameter leaves in the params tree's flatten order
(dict keys sorted at every level):

- ``adamw``: ``[adam count, mu x P, nu x P, schedule count]``;
- ``sgd`` with momentum: ``[trace x P, schedule count]``; without:
  ``[schedule count]``;
- under ``optax.MultiSteps`` (``train.accum_iter`` > 1):
  ``[mini_step, gradient_step, <the chain's leaves>, acc_grads x P]``,
  ``acc_grads`` the running mean of the open window's ``mini_step``
  gradients.

:func:`load_optax_leaves` puts them into a :class:`TrainOptimizer`: ``mu`` /
``nu`` become AdamW's ``exp_avg`` / ``exp_avg_sq`` and the adam count its
``step``, ``trace`` SGD's ``momentum_buffer``, the schedule count the
update ``count``, and the open window its summed gradients
(``acc_grads x mini_step``). Each leaf is matched to a parameter by the
spec walker (``utils/weights.py``) and laid out as torch lays it; a
frozen parameter (in no param group) keeps nothing, and under ZeRO-1 a
rank keeps the parameters it owns (``TrainOptimizer.holds``). A list of
any other
length or shape raises: the optimizer never restarts silently.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .optimizer import TrainOptimizer
from .weights import _to_torch_layout, model_specs


def _leaf_paths(tree, path=()) -> List[Tuple[str, ...]]:
    """The paths of a nested dict's leaves in ``jax.tree.leaves`` order."""
    if not isinstance(tree, dict):
        return [path]
    return [p for k in sorted(tree) for p in _leaf_paths(tree[k], path + (k,))]


def optax_layout(optimizer: TrainOptimizer, num_params: int
                 ) -> Dict[str, Any]:
    """Where each part of the optax state lies in the leaf list for the
    port optimizer's kind and accumulation: scalar indices (``count``,
    ``mini_step``) and P-long runs (``mu``, ``nu``, ``trace``,
    ``acc_grads``, as their first index), and ``length``."""
    P = num_params
    opt = optimizer.optimizer
    layout: Dict[str, Any] = {}
    at = 0
    if optimizer.accum > 1:
        layout["mini_step"] = 0
        at = 2  # mini_step, gradient_step
    if isinstance(opt, torch.optim.AdamW):
        layout.update(mu=at + 1, nu=at + 1 + P, count=at + 1 + 2 * P)
        at += 2 + 2 * P
    elif isinstance(opt, torch.optim.SGD):
        if opt.defaults["momentum"]:
            layout["trace"] = at
            at += P
        layout["count"] = at
        at += 1
    else:
        raise TypeError(f"no optax layout for {type(opt).__name__}")
    if optimizer.accum > 1:
        layout["acc_grads"] = at
        at += P
    layout["length"] = at
    return layout


def load_optax_leaves(optimizer: TrainOptimizer, leaves: Sequence[Any],
                      params: Dict[str, Any], target_keys) -> None:
    """Restore ``optimizer`` (its torch state, ``count`` and open window)
    from a JAX checkpoint's optimizer ``leaves``; ``params`` is the same
    checkpoint's params tree, ``target_keys`` the receiving model's
    state_dict keys."""
    paths = _leaf_paths(params)
    spec = {path: (key, kind) for path, key, kind in
            model_specs(params, {}, target_keys)}
    layout = optax_layout(optimizer, len(paths))
    kind_name = type(optimizer.optimizer).__name__
    if len(leaves) != layout["length"]:
        raise ValueError(
            f"the checkpoint's optimizer state has {len(leaves)} leaves; "
            f"{kind_name} with accum_iter {optimizer.accum} over the "
            f"checkpoint's {len(paths)} parameters expects "
            f"{layout['length']}: it was written by another optimizer "
            "configuration")
    leaves = [np.asarray(leaf) for leaf in leaves]
    for name in ("count", "mini_step"):
        if name in layout and leaves[layout[name]].shape != ():
            raise ValueError(f"optax {name} leaf {layout[name]} has shape "
                             f"{leaves[layout[name]].shape}, not ()")
    index = {spec[path][0]: i for i, path in enumerate(paths)}

    def leaf(part, name, shape):
        i = index[name]
        arr = _to_torch_layout(leaves[layout[part] + i], spec[paths[i]][1])
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"optax {part} of {name} has shape "
                             f"{arr.shape}, the parameter {tuple(shape)}")
        return torch.from_numpy(np.array(arr, dtype=np.float32))

    count = int(leaves[layout["count"]])
    opt = optimizer.optimizer
    for name, p in zip(optimizer.names, optimizer.params):
        if name not in index:
            raise KeyError(f"the checkpoint holds no parameter {name}")
        if not optimizer.holds(p):
            continue  # ZeRO-1: another rank keeps this parameter's state
        if "mu" in layout:
            opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": leaf("mu", name, p.shape).to(p.device),
                "exp_avg_sq": leaf("nu", name, p.shape).to(p.device)}
        elif "trace" in layout:
            opt.state[p] = {"momentum_buffer":
                            leaf("trace", name, p.shape).to(p.device)}
    optimizer.count = count
    if "acc_grads" in layout:
        mini = int(leaves[layout["mini_step"]])
        optimizer.set_window(mini, {
            name: leaf("acc_grads", name, p.shape) * mini
            for name, p in zip(optimizer.names, optimizer.params)}
            if mini else {})
