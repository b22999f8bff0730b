"""Optimizer factory (counterpart of ``semi_seg_ecg_tpu/utils/optimizer.py``).

The JAX package chains optax transformations; here the same update is a
``torch.optim`` optimizer plus the two pieces optax keeps inside its chain:

- the per-iteration warmup + cosine schedule, evaluated at the update
  count *before* the update (optax's ``scale_by_learning_rate`` reads the
  pre-increment count), so the first update of a warmup run has lr 0;
- ``max_norm``, optax's ``clip_by_global_norm`` (scale by ``max_norm /
  norm`` when the global norm is not below ``max_norm``; torch's
  ``clip_grad_norm_`` adds 1e-6 to the norm and is not used).

``adamw`` is ``torch.optim.AdamW``: decoupled weight decay scaled by the
scheduled lr, ``p -= lr · (adam + wd · p)`` in optax's terms. ``sgd`` is
``torch.optim.SGD``, which couples weight decay into the gradient before
the momentum buffer, as the optax chain does. Weight decay applies to every
parameter (one group), as in the JAX package without ``layer_decay``.
``layer_decay``, ``frozen_stages >= 0`` and ``mode: freeze_backbone`` are
not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from ..parallel.dist import all_reduce_grads_
from . import lr_sched


def make_lr_schedule(train_cfg: Dict[str, Any],
                     steps_per_epoch: int) -> Callable[[int], float]:
    """Update step → lr with the fractional-epoch convention
    (``epoch = step / steps_per_epoch``)."""

    def schedule(step: int) -> float:
        return lr_sched.cosine_warmup_lr(step / steps_per_epoch, train_cfg)

    return schedule


def resolve_lr(config: Dict[str, Any], mesh_data_size: int = 1) -> None:
    """Linear-scaling rule: ``lr = blr · eff_batch / 256`` when ``lr`` is
    unset, the effective batch counting every data-parallel replica's
    ``batch_size``. Mutates the config in place like the reference."""
    train_cfg = config["train"]
    eff = config["dataloader"]["batch_size"]
    eff *= train_cfg.get("accum_iter", 1)
    eff *= mesh_data_size
    if train_cfg.get("lr") is None:
        train_cfg["lr"] = train_cfg["blr"] * eff / 256
    config["train"]["eff_batch_size"] = eff


def clip_by_global_norm_(params: List[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place, without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)


class TrainOptimizer:
    """A ``torch.optim`` optimizer driven by the schedule: :meth:`step`
    sets the lr of update ``count``, averages the gradients over the
    process group's ranks, clips, steps and counts."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], max_norm=None):
        self.optimizer = optimizer
        self.schedule = schedule
        self.max_norm = max_norm
        self.count = 0
        self.params = [p for g in optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        # the mean over the ranks first, so every rank clips and applies
        # the global batch's gradient (one rank: nothing to do)
        all_reduce_grads_(self.params)
        if self.max_norm is not None:
            clip_by_global_norm_(self.params, self.max_norm)
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        return self.optimizer.state_dict()


def build_optimizer(config: Dict[str, Any], model: torch.nn.Module,
                    steps_per_epoch: int) -> TrainOptimizer:
    """The config's optimizer over every parameter of ``model``."""
    train_cfg = config["train"]
    if train_cfg.get("layer_decay", None):
        raise NotImplementedError(
            "train.layer_decay is not yet ported to the torch package")
    backbone = getattr(model, "backbone", None)
    if config.get("mode") == "freeze_backbone" or \
            getattr(backbone, "frozen_stages", -1) >= 0:
        raise NotImplementedError(
            "backbone freezing (mode: freeze_backbone, frozen_stages >= 0) "
            "is not yet ported to the torch package")
    opt_name = train_cfg["optimizer"]
    weight_decay = train_cfg["weight_decay"] or 0.0
    kwargs = train_cfg.get("optimizer_kwargs", {}) or {}
    params = list(model.parameters())
    schedule = make_lr_schedule(train_cfg, steps_per_epoch)
    lr0 = schedule(0)
    if opt_name == "sgd":
        opt = torch.optim.SGD(params, lr=lr0,
                              momentum=kwargs.get("momentum", 0),
                              weight_decay=weight_decay)
    elif opt_name == "adamw":
        b1, b2 = tuple(kwargs.get("betas", (0.9, 0.999)))
        opt = torch.optim.AdamW(params, lr=lr0, betas=(b1, b2),
                                eps=kwargs.get("eps", 1e-8),
                                weight_decay=weight_decay)
    else:
        raise ValueError(f"Unknown optimizer: {opt_name}")
    return TrainOptimizer(opt, schedule, train_cfg.get("max_norm", None))
