"""Parameter slices over the ``model`` axis (tensor parallelism; counterpart
of ``semi_seg_ecg_tpu/parallel/sharding_rules.py``).

Megatron's layout of the ViT blocks, matched on the trailing names of the
port's parameters (so the same rules slice the student, the Mean Teacher
and ST++ teachers, the CPS peer, the optimizer's moments and an open
accumulation window's gradients, all keyed by parameter name):

- ``attn.fn.to_qkv.{weight,bias}``: whole heads. Rank ``m`` of ``tp``
  keeps heads ``[m·H/tp, (m+1)·H/tp)`` of each of the q, k and v thirds,
  so its projection yields its heads' q, k and v as the unsliced one lays
  them out, and the flash kernels run on ``(B, H/tp, N, D)``;
- ``attn.fn.to_out.0.weight``: its input columns, the same heads;
- ``ff.fn.net.0.{weight,bias}``: the MLP's hidden rows;
  ``ff.fn.net.3.weight``: the same hidden columns;
- everything else (``to_out.0.bias`` and ``net.3.bias``, added once after
  the reduce, the norms, the embeddings, the decode head, every ResNet
  parameter) replicated.

The JAX package shards the fused qkv kernel's output columns in
contiguous blocks and lets GSPMD move what a head needs; the port keeps
whole heads on a rank instead, so no collective runs inside attention.
Two guards, as in the JAX package: a dimension ``tp`` does not divide
stays replicated, and an attention block whose heads ``tp`` does not
divide keeps its attention replicated (its MLP is still sliced), the
JAX package's ``sharded_flash_attention`` fallback.

:func:`model_plan` gives each sliced parameter its :class:`Slice`;
:func:`shard_state` takes a rank's slices of an unsliced state dict and
:func:`unshard_state` gathers them back over the model group (a
collective). :func:`shard_module_` slices a live model in place and points
its attention and MLP blocks at the mesh; :func:`full_state_dict` and
:func:`load_full_state_dict` read and write such a model in the unsliced
layout, which is the one every checkpoint holds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

from ..utils.logging import log
from . import dist as pdist


@dataclass(frozen=True)
class Slice:
    """``dim`` is split over the model ranks; viewed as ``(groups, tp,
    chunk)``, a rank keeps block ``model_rank`` of each of the ``groups``
    (3 for the fused q/k/v rows, else 1)."""

    dim: int
    groups: int = 1

    def take(self, t: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
        """Rank ``rank``'s slice of the unsliced ``t``, contiguous."""
        parts = t.unflatten(self.dim, (self.groups, tp, -1))
        return parts.select(self.dim + 1, rank).flatten(
            self.dim, self.dim + 1).contiguous()

    def join(self, pieces) -> torch.Tensor:
        """The unsliced tensor from every rank's slice, in rank order."""
        parts = [p.unflatten(self.dim, (self.groups, -1)) for p in pieces]
        return torch.stack(parts, dim=self.dim + 1).flatten(
            self.dim, self.dim + 2)


QKV = Slice(0, groups=3)
ROWS, COLUMNS = Slice(0), Slice(1)


def spec_for_name(name: str, heads_split: bool = True) -> Optional[Slice]:
    """The trailing-name rule of parameter ``name``: its :class:`Slice`, or
    None (replicated). ``heads_split`` False keeps an attention block's
    projections whole."""
    if heads_split and name.endswith(("attn.fn.to_qkv.weight",
                                      "attn.fn.to_qkv.bias")):
        return QKV
    if heads_split and name.endswith("attn.fn.to_out.0.weight"):
        return COLUMNS
    if name.endswith(("ff.fn.net.0.weight", "ff.fn.net.0.bias")):
        return ROWS
    if name.endswith("ff.fn.net.3.weight"):
        return COLUMNS
    return None


def _attention_of(model: nn.Module, name: str):
    """The ``Attention`` module whose parameter ``name`` is (or None)."""
    prefix = name.rsplit(".to_", 1)[0]
    try:
        return model.get_submodule(prefix)
    except AttributeError:
        return None


def model_plan(model: nn.Module, tp: int) -> Dict[str, Slice]:
    """The :class:`Slice` of every parameter of ``model`` the rules slice
    over ``tp`` model ranks, after the guards: the dimension divides, and a
    head-parallel attention block has heads ``tp`` divides (and an output
    projection)."""
    if tp <= 1:
        return {}
    plan = {}
    for name, p in model.named_parameters():
        attention = _attention_of(model, name) if ".attn.fn." in name \
            else None
        heads_split = attention is not None and \
            attention.heads % tp == 0 and attention.to_out is not None
        spec = spec_for_name(name, heads_split)
        if spec is None or p.dim() <= spec.dim:
            continue
        if p.shape[spec.dim] % (spec.groups * tp) != 0:
            continue
        plan[name] = spec
    return plan


def shard_state(state: Mapping[str, torch.Tensor], plan: Mapping[str, Slice],
                mesh) -> Dict[str, torch.Tensor]:
    """This model rank's slices of the unsliced ``state`` (keys the plan
    does not name pass through)."""
    out = {}
    for key, value in state.items():
        spec = plan.get(key)
        out[key] = value if spec is None else spec.take(
            torch.as_tensor(value), mesh.model, mesh.model_rank)
    return out


def unshard(t: torch.Tensor, spec: Slice, mesh) -> torch.Tensor:
    """The unsliced tensor of which ``t`` is this rank's slice, gathered
    over the model group (a collective)."""
    pieces = pdist.all_gather(t.detach(), mesh.model_group)
    return spec.join(list(pieces))


def unshard_state(state: Mapping[str, torch.Tensor],
                  plan: Mapping[str, Slice], mesh) -> Dict[str, torch.Tensor]:
    """The unsliced state dict of a model rank's ``state``, gathered over
    the model group (a collective: every model rank calls it, with the
    same keys)."""
    out = {}
    for key, value in state.items():
        spec = plan.get(key)
        out[key] = value if spec is None else unshard(value, spec, mesh)
    return out


def shard_module_(model: nn.Module, mesh) -> Dict[str, Slice]:
    """Slice ``model``'s parameters (and their ``.grad``) to this model
    rank's, in place, and run its sliced attention and MLP blocks
    tensor-parallel over ``mesh``'s model group. Returns the plan (also
    kept as ``model.model_plan``). With no rule matching, logs the JAX
    package's warning and leaves the model replicated."""
    plan = model_plan(model, mesh.model)
    if mesh.model > 1 and not plan:
        log(f"WARNING: model_parallel={mesh.model} but no tensor-parallel "
            "sharding rule matched any parameter — training proceeds fully "
            "replicated on the model axis (check parallel/sharding_rules.py "
            "patterns against the model's module names)", force=True)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, spec in plan.items():
            p = params[name]
            p.data = spec.take(p.data, mesh.model, mesh.model_rank)
            if p.grad is not None:
                p.grad = spec.take(p.grad, mesh.model, mesh.model_rank)
    for name, module in model.named_modules():
        if hasattr(module, "use_model_mesh"):
            first = next(iter(module.state_dict()), None)
            if first is not None and f"{name}.{first}" in plan:
                module.use_model_mesh(mesh)
    model.model_plan = plan
    model.model_mesh = mesh
    return plan


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` in the unsliced layout (a collective over the
    model group where the model is sliced)."""
    plan = getattr(model, "model_plan", None)
    state = model.state_dict()
    if not plan:
        return state
    return unshard_state(state, plan, model.model_mesh)


def load_full_state_dict(model: nn.Module,
                         state: Mapping[str, torch.Tensor]) -> None:
    """Load an unsliced state dict into ``model``, sliced where it is."""
    plan = getattr(model, "model_plan", None)
    if plan:
        state = shard_state(state, plan, model.model_mesh)
    model.load_state_dict(state)
