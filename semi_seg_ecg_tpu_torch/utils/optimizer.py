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
the momentum buffer, as the optax chain does.

Param groups (:func:`param_groups`). Without ``train.layer_decay`` every
trainable parameter is in one group with the config's weight decay, as in
the JAX package. With it, each parameter's lr is scaled by its layer's
factor and weight decay skips 1-D parameters and the model's
``no_weight_decay()`` names (``utils/lr_decay.py``): one group per (scale,
decay) pair, each carrying its ``lr_scale``; :meth:`TrainOptimizer.step`
sets ``lr · lr_scale`` on each. The JAX package multiplies the update by
the scale after the decoupled decay, so the decay is scaled too, which is
what a group's ``lr = lr0 · scale`` gives.

Gradient accumulation (``train.accum_iter`` k > 1), the JAX package's
``optax.MultiSteps``: a window of k micro-steps, counted on the global
micro-step (so a window may span an epoch's end), makes one update.
:meth:`TrainOptimizer.zero_grad` clears the gradients only at a window's
start, so autograd sums the k micro-steps' gradients into ``.grad``;
:meth:`TrainOptimizer.step` on the window's last micro-step divides the sum
by k (optax keeps a running mean, ``acc + (g - acc) / (n + 1)``; the two
round apart in the last bits), then all-reduces, clips, applies the update
and counts it; on the other micro-steps it does nothing. The schedule
counts updates: ``updates_per_epoch = max(steps_per_epoch // k, 1)``.
Under a process group each rank's ``.grad`` holds its own partial sum
until the window's last micro-step; :meth:`TrainOptimizer.average_window_`
replaces it by the ranks' mean (the training loop calls it on every rank
at an epoch's end), so a checkpoint, written by rank 0, holds the global
batch's partial sum, which every rank of a resumed run continues from.
The window's mean is linear in the gradients, so the update is the same.

ZeRO-1 (``parallel.shard_optimizer: true`` over more than one rank; the
JAX package shards the optax state of ``opt_state`` and ``peer_opt_state``
over its data axis): each rank owns a balanced set of whole trainable
parameters (:func:`balanced_owners`; frozen parameters are in no group and
owned by none) and its torch optimizer holds only those, in their groups,
so it keeps their moments (or momentum) alone. :meth:`TrainOptimizer.step`
all-reduces and clips every gradient as before, steps the parameters the
rank owns, and broadcasts each parameter from its owner
(``parallel.dist.broadcast_from_owners_``): the same elementwise update of
the same averaged, clipped gradients, so the replicated run's numbers.
:meth:`TrainOptimizer.state_dict` is then a collective that returns the
whole state in the unsharded layout on every rank (a checkpoint equals an
unsharded run's, and the JAX package reads it), and
:meth:`TrainOptimizer.load_state_dict` keeps the rank's share of a whole
state. One rank has nothing to shard and runs unsharded.

Tensor parallelism (``parallel.model_parallel > 1``): the trainer slices
the model over the model axis after building its optimizer
(:meth:`TrainOptimizer.shard_`, which slices any state a resume loaded),
so the optimizer steps this rank's slices. Gradients are averaged over the
data group only (the model ranks of a data rank hold the same rows), and
the replicated parameters' (every parameter of a model no rule slices,
as ResNet18's) are then taken from model rank 0, so that the model ranks'
copies stay equal bit for bit;
``max_norm`` clips by the global norm, the squares of the sliced
parameters summed over the model group and the replicated ones counted
once (optax's norm over the global arrays); ZeRO-1 balances the rank's
slices over its data group (the JAX package's data axis on top of the
model axis). :meth:`TrainOptimizer.state_dict` gathers the slices over the
model group, so a checkpoint holds the unsliced layout, and
:meth:`TrainOptimizer.load_state_dict` takes the rank's slices of it.

Sequence parallelism (a step on a split time axis,
``parallel/seq_shard.py``): each seq rank's gradient is its block's part of
the global loss's, so the all-reduce runs over the data×seq group and
divides by the data ranks alone (summed over seq, averaged over data); a
step whose batch stayed whole averages over the data group as before.
Every rank ends with the same sum, so the seq ranks' parameters stay
equal bit for bit.

A captured step (``train.scan_steps``, ``utils/captured_step.py``):
:meth:`TrainOptimizer.make_capturable_` turns each group's lr into a
device tensor, which :meth:`TrainOptimizer.write_lr` fills before every
updating replay (a float would be baked into the graph), keeps AdamW's
step count and bias correction on the device (``capturable=True``) and
gives SGD its fused update, which reads the lr tensor (the foreach update
takes its lr as a host scalar); a ZeRO-1 optimizer (its own parameters)
and a model-sliced one (its slices) become capturable the same way.
Inside the capture :meth:`TrainOptimizer.step` leaves the lr alone, and
:meth:`TrainOptimizer.replayed` advances the host counters after a
replay. Under accumulation the window's gradients are fixed tensors the
graphs share: :meth:`TrainOptimizer.zero_grad` leaves them, and
:meth:`TrainOptimizer.step` zeroes them in place after each update (a
parameter without one keeps none: a zero would make AdamW decay it);
:meth:`TrainOptimizer.average_window_` writes into them, and a resume's
:meth:`TrainOptimizer.set_window` runs before the capture, so the tensors
it makes are the window's. The seq ranks' all-reduce decides once, at
the first update, which gradients take part (its host sync cannot be
captured).
:meth:`TrainOptimizer.state_dict` writes the eager layout (a float lr, the
step count on the host, the eager flags), so a captured run's checkpoint
resumes eagerly and the other way round.

Freezing (``mode: freeze_backbone``, ``frozen_stages >= 0``): the frozen
set is the JAX package's ``frozen_param_mask``
(:func:`frozen_parameter_names`).
The JAX package zeroes their gradients before and after its optimizer, so
they see neither an Adam step nor decay; here they are left out of every
group and stop requiring gradients. (A zeroed ``.grad`` would not do:
AdamW would still decay the parameter.)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from ..parallel import dist as pdist
from ..parallel import seq_shard
from ..parallel.dist import all_reduce_grads_
from . import lr_sched
from .lr_decay import param_lr_scales_and_wd


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


def clip_by_global_norm_(params: List[torch.Tensor], max_norm: float,
                         sliced: Optional[Sequence[bool]] = None,
                         model_group=None) -> None:
    """optax ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place, without a host sync. ``sliced`` flags the parameters a model
    axis slices (``model_group``): their squares are summed over it, the
    replicated parameters' counted once."""
    flags = sliced or [False] * len(params)
    grads, total = [], None
    for flag in (True, False):
        part = [p.grad for p, s in zip(params, flags)
                if bool(s) == flag and p.grad is not None]
        if not part:
            continue
        sq = torch.stack(torch._foreach_norm(part)).float().square().sum()
        if flag:
            pdist.all_reduce_sum_(sq, model_group)
        grads += part
        total = sq if total is None else total + sq
    if total is None:
        return
    norm = total.sqrt()
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)


def balanced_owners(sizes: Sequence[int], world: int) -> List[int]:
    """The owning rank of each of ``len(sizes)`` whole parameters of
    ``sizes`` elements: the largest first, each to the rank that owns the
    fewest elements so far (ties to the lower rank, then the earlier
    parameter), the same on every rank."""
    load = [0] * world
    owners = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        rank = min(range(world), key=lambda r: (load[r], r))
        owners[i] = rank
        load[rank] += sizes[i]
    return owners


class TrainOptimizer:
    """A ``torch.optim`` optimizer driven by the schedule: :meth:`step`
    sets the lr of update ``count``, averages the gradients over the
    process group's ranks, clips, steps and counts, once every ``accum``
    micro-steps (``micro_step`` of them taken in the open window).
    ``params`` are the trainable parameters in the groups' order, ``names``
    their names; a checkpoint keys an open window's gradients by them.
    With ``owners`` (ZeRO-1: each parameter's owning rank), ``optimizer``
    holds this rank's parameters only, in groups of ``group_sizes`` of
    ``params``."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float],
                 params: Sequence[torch.Tensor], names: Sequence[str],
                 max_norm=None, accum: int = 1,
                 owners: Optional[Sequence[int]] = None,
                 group_sizes: Sequence[int] = ()):
        self.optimizer = optimizer
        self.schedule = schedule
        self.max_norm = max_norm
        self.accum = accum
        self.count = 0
        self.micro_step = 0
        self.params = list(params)
        self.names = list(names)
        self.owners = None if owners is None else list(owners)
        self.group_sizes = list(group_sizes)
        self._held = {id(p) for g in optimizer.param_groups
                      for p in g["params"]}
        self._index = {id(p): i for i, p in enumerate(self.params)}
        self.slices: List = [None] * len(self.params)
        self.mesh = None
        self._time_split = False
        # each group's eager flags, once make_capturable_ changed them, and
        # the lr last written into each group's tensor, as a float
        self._eager_flags: Optional[List[Dict[str, Any]]] = None
        self._host_lrs: List[float] = []
        # captured: which parameters' gradients the seq ranks' all-reduce
        # takes, decided at the first update
        self._seq_have: Optional[List[bool]] = None
        # fixed window gradients at every accum (make_capturable_)
        self._fixed = False
        # called at the entry of every step (debug.nan_checks: the step's
        # gradient check, the split point of a captured step)
        self.before_update: Optional[Callable[[], None]] = None

    def shard_(self, plan: Dict[str, Any], mesh) -> None:
        """The model's parameters are now this model rank's slices
        (``parallel/sharding_rules.shard_module_`` with ``plan``): step
        them, and slice the optimizer state already held (a resume's)."""
        self.slices = [plan.get(n) for n in self.names]
        self.mesh = mesh
        by_id = {id(p): spec for p, spec in zip(self.params, self.slices)}
        for p, entry in self.optimizer.state.items():
            spec = by_id.get(id(p))
            if spec is None:
                continue
            for k, v in entry.items():
                if torch.is_tensor(v) and v.dim() > spec.dim:
                    entry[k] = spec.take(v, mesh.model, mesh.model_rank)

    @property
    def _sliced(self) -> bool:
        return any(s is not None for s in self.slices)

    @property
    def sharded(self) -> bool:
        return self.owners is not None

    def holds(self, p: torch.Tensor) -> bool:
        """Whether this rank's optimizer keeps the state of ``p``."""
        return id(p) in self._held

    @property
    def _fixed_grads(self) -> bool:
        """Whether the window's gradients are fixed tensors (captured, with
        accumulation or ``fixed_grads``), zeroed in place after each
        update."""
        return self.captured and (self.accum > 1 or self._fixed)

    def zero_grad(self) -> None:
        """Clear the gradients at the start of a window (every call when
        ``accum`` is 1), of every trainable parameter, held or not; with
        :attr:`_fixed_grads` the last update zeroed them in place."""
        if self.micro_step == 0 and not self._fixed_grads:
            for p in self.params:
                p.grad = None

    def step(self) -> bool:
        """End a micro-step; on a window's last, apply the update to the
        window's mean gradient. Returns whether it applied one. First
        :attr:`before_update`, where set."""
        if self.before_update is not None:
            self.before_update()
        self._time_split = seq_shard.active() is not None
        self.micro_step += 1
        if self.micro_step < self.accum:
            return False
        self.micro_step = 0
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.accum > 1 and grads:
            torch._foreach_div_(grads, self.accum)
        if not (self.captured and self.params[0].is_cuda
                and torch.cuda.is_current_stream_capturing()):
            # a replay's lr is written before it (write_lr)
            self.write_lr()
        # the mean over the ranks first, so every rank clips and applies
        # the global batch's gradient (one rank: nothing to do)
        self._reduce_grads()
        if self.mesh is not None and self.mesh.model > 1:
            # the replicated parameters take model rank 0's gradient: every
            # model rank computed it from the same numbers, but on a card
            # the atomic adds of index_select's backward and of cuDNN's
            # convolution backward round apart, and the copies would drift
            held = [p.grad for p, spec in zip(self.params, self.slices)
                    if spec is None and p.grad is not None]
            pdist.broadcast_from_owners_(held, [0] * len(held),
                                         self.mesh.model_group)
        if self.max_norm is not None:
            clip_by_global_norm_(
                self.params, self.max_norm,
                [s is not None for s in self.slices],
                self.mesh.model_group if self.mesh is not None else None)
        self.optimizer.step()
        if self.sharded:
            # each rank updated its own parameters: every rank takes them
            pdist.broadcast_from_owners_(self.params, self.owners)
        if self._fixed_grads:
            # the next window accumulates into the same tensors
            window = [p.grad for p in self.params if p.grad is not None]
            if window:
                torch._foreach_zero_(window)
        self.count += 1
        return True

    def replayed(self) -> None:
        """The host's part of a :meth:`step` a CUDA graph replayed: the
        window's micro-step, and the update count at its end."""
        self.micro_step += 1
        if self.micro_step == self.accum:
            self.micro_step = 0
            self.count += 1

    @property
    def captured(self) -> bool:
        """Whether :meth:`make_capturable_` ran."""
        return self._eager_flags is not None

    def write_lr(self) -> None:
        """Each group's lr for update ``count``: ``lr · lr_scale``, into its
        device tensor once :meth:`make_capturable_` ran."""
        lr = self.schedule(self.count)
        for i, group in enumerate(self.optimizer.param_groups):
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(lr * group["lr_scale"])
                self._host_lrs[i] = lr * group["lr_scale"]
            else:
                group["lr"] = lr * group["lr_scale"]

    def make_capturable_(self, fixed_grads: bool = False) -> None:
        """Make :meth:`step` capturable in a CUDA graph: each group's lr a
        0-d fp32 tensor on the parameters' device, AdamW ``capturable``
        with its step counts moved there, SGD's fused update; the same for
        a ZeRO-1 optimizer, whose groups hold this rank's parameters (a
        group may hold none), and a model-sliced one, whose state is
        already sliced. With accumulation, or ``fixed_grads`` (a step
        captured in two graphs, the gradients living across them), the
        window's gradients become fixed tensors from here on
        (:attr:`_fixed_grads`)."""
        if self.captured:
            return
        self._fixed = fixed_grads
        opt = self.optimizer
        device = self.params[0].device
        flags = []
        self._host_lrs = [float(g["lr"]) for g in opt.param_groups]
        for group in opt.param_groups:
            if isinstance(opt, torch.optim.AdamW):
                flags.append({"capturable": group["capturable"]})
                group["capturable"] = True
            elif isinstance(opt, torch.optim.SGD):
                flags.append({"fused": group["fused"],
                              "foreach": group["foreach"]})
                group.update(fused=True, foreach=False)
            else:
                raise TypeError(f"{type(opt).__name__} cannot be captured")
            group["lr"] = torch.tensor(float(group["lr"]),
                                       dtype=torch.float32, device=device)
        for p, entry in opt.state.items():
            if torch.is_tensor(entry.get("step")):
                entry["step"] = entry["step"].to(p.device, torch.float32)
        self._eager_flags = flags

    def _eager_layout(self, local: Dict[str, Any]) -> Dict[str, Any]:
        """A torch state_dict of a captured optimizer in the eager one's
        layout: the float lr last written and the eager flags in each
        group, each step count a host tensor."""
        if not self.captured:
            return local
        groups = [dict(g, lr=lr, **flags)
                  for g, lr, flags in zip(local["param_groups"],
                                          self._host_lrs, self._eager_flags)]
        state = {i: {k: v.cpu() if k == "step" else v
                     for k, v in entry.items()}
                 for i, entry in local["state"].items()}
        return dict(local, param_groups=groups, state=state)

    def average_window_(self) -> None:
        """Replace an open window's summed gradients by their mean over the
        process group's ranks, in place; every rank calls it (one rank:
        nothing to do)."""
        if self.micro_step:
            self._reduce_grads()

    def _reduce_grads(self) -> None:
        """The ranks' gradients summed and averaged over the data ranks:
        over the data×seq group when the last step split the time axis
        (the seq ranks' parts of one gradient), else over the data group."""
        mesh = pdist.current_mesh()
        if self._time_split and mesh is not None:
            have = all_reduce_grads_(self.params, mesh.data_seq_group,
                                     mesh.data, have=self._seq_have)
            if self.captured:
                self._seq_have = have
        else:
            all_reduce_grads_(self.params)

    def _unslice(self, state: Dict[int, Dict[str, Any]]) -> None:
        """Gather the sliced parameters' state tensors of ``state`` (by
        parameter index, every one of them present) over the model group,
        in place."""
        from ..parallel.sharding_rules import unshard

        for i, spec in enumerate(self.slices):
            if spec is None or i not in state:
                continue
            state[i] = {k: unshard(v.to(self.params[i].device), spec,
                                   self.mesh)
                        if torch.is_tensor(v) and v.dim() > spec.dim else v
                        for k, v in state[i].items()}

    def _torch_state_dict(self) -> Dict[str, Any]:
        """The torch optimizer's state_dict; under ZeRO-1 gathered from
        every rank of the data group, and under the model axis from every
        rank of the model group, into the unsharded layout (a
        collective)."""
        local = self._eager_layout(self.optimizer.state_dict())
        if not self.sharded:
            if self._sliced:
                local = dict(local, state=dict(local["state"]))
                self._unslice(local["state"])
            return local
        held = self._held_indices()
        mine = {held[i]: {k: v.detach().cpu() if torch.is_tensor(v) else v
                          for k, v in entry.items()}
                for i, entry in local["state"].items()}
        state: Dict[int, Any] = {}
        for part in pdist.all_gather_object(mine):
            state.update(part)
        if self._sliced:
            self._unslice(state)
        return {"state": {i: state[i] for i in sorted(state)},
                "param_groups": self._global_groups(local["param_groups"])}

    def _held_indices(self) -> List[int]:
        """The index in :attr:`params` of each parameter this rank's torch
        optimizer holds, in its order."""
        return [self._index[id(p)] for g in self.optimizer.param_groups
                for p in g["params"]]

    def _global_groups(self, local_groups) -> List[Dict[str, Any]]:
        """The param groups of the unsharded layout: ``local_groups``'
        settings over consecutive indices of :attr:`params`."""
        if not self.sharded:
            return local_groups
        groups, at = [], 0
        for group, size in zip(local_groups, self.group_sizes):
            groups.append(dict(group, params=list(range(at, at + size))))
            at += size
        return groups

    def local_state_dict(self) -> Dict[str, Any]:
        """What this rank holds, with no collective (the directory
        checkpoint's part of it): the state of the parameters its torch
        optimizer holds (under ZeRO-1 its share), keyed by parameter name
        and sliced as the parameters are under the model axis; the
        unsharded layout's param groups; ``count``, ``micro_step``, the
        open window's gradients by name (this rank's slices) and the
        parameters' ``names`` in index order."""
        local = self._eager_layout(self.optimizer.state_dict())
        held = self._held_indices()
        state = {self.names[held[i]]: dict(entry)
                 for i, entry in local["state"].items()}
        out = {"state": state,
               "param_groups": self._global_groups(local["param_groups"]),
               "count": self.count, "micro_step": self.micro_step,
               "names": list(self.names)}
        if self.micro_step:
            out["acc_grads"] = {n: p.grad for n, p in zip(self.names,
                                                          self.params)
                                if p.grad is not None}
        return out

    def _load_torch_state_dict(self, state: Dict[str, Any]) -> None:
        """The torch optimizer's state from an unsharded state_dict; under
        ZeRO-1 this rank's share of it, under the model axis its slices."""
        if self._sliced:
            mesh = self.mesh
            state = dict(state, state={
                i: {k: spec.take(v, mesh.model, mesh.model_rank)
                    if spec is not None and torch.is_tensor(v)
                    and v.dim() > spec.dim else v for k, v in entry.items()}
                for i, entry in state["state"].items()
                for spec in [self.slices[int(i)]]})
        if not self.sharded:
            self.optimizer.load_state_dict(state)
            return
        sizes = [len(g["params"]) for g in state["param_groups"]]
        if sizes != self.group_sizes:
            raise ValueError(f"the optimizer state has groups of {sizes} "
                             f"parameters, this optimizer {self.group_sizes}")
        local_state, groups, at = {}, [], 0
        for group, mine in zip(state["param_groups"],
                               self.optimizer.param_groups):
            ids = []
            for p in mine["params"]:
                entry = state["state"].get(self._index[id(p)])
                if entry is not None:
                    local_state[at] = entry
                ids.append(at)
                at += 1
            groups.append(dict(group, params=ids))
        self.optimizer.load_state_dict({"state": local_state,
                                        "param_groups": groups})

    def state_dict(self) -> Dict[str, Any]:
        """The torch optimizer's state_dict (under ZeRO-1 the whole state,
        gathered: a collective, so every rank calls it), with the update
        ``count``, the open window's ``micro_step`` and, when one is open,
        its summed gradients by parameter name (``acc_grads``; under a
        process group as :meth:`average_window_` left them)."""
        from ..parallel.sharding_rules import unshard

        state = dict(self._torch_state_dict(), count=self.count,
                     micro_step=self.micro_step)
        if self.micro_step:
            state["acc_grads"] = {
                n: p.grad if spec is None else unshard(p.grad, spec,
                                                       self.mesh)
                for n, p, spec in zip(self.names, self.params, self.slices)
                if p.grad is not None}
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore :meth:`state_dict`'s output (tensors or NumPy arrays),
        written sharded or not."""
        if self.captured:
            raise RuntimeError("a captured optimizer's state cannot be "
                               "replaced: its graph holds the tensors")
        state = dict(state)
        self.count = int(state.pop("count"))
        self.micro_step = int(state.pop("micro_step", 0))
        self.set_window(self.micro_step, state.pop("acc_grads", {}))
        self._load_torch_state_dict(_as_tensors(state))

    def set_window(self, micro_step: int,
                   grads: Dict[str, Any]) -> None:
        """Open a window at ``micro_step`` holding the summed ``grads`` (by
        parameter name; a parameter left out has none)."""
        if micro_step >= self.accum:
            raise ValueError(f"a window of {self.accum} micro-steps cannot "
                             f"be at micro-step {micro_step}")
        self.micro_step = micro_step
        by_name = dict(zip(self.names, self.params))
        unknown = set(grads) - set(by_name)
        if unknown:
            raise KeyError(f"gradients of unknown parameters: "
                           f"{sorted(unknown)[:5]}")
        slices = dict(zip(self.names, self.slices))
        for name, p in by_name.items():
            g = grads.get(name)
            spec = slices[name]
            if g is not None and spec is not None:
                g = spec.take(torch.as_tensor(g), self.mesh.model,
                              self.mesh.model_rank)
            if g is not None and tuple(g.shape) != tuple(p.shape):
                raise ValueError(f"the gradient of {name} has shape "
                                 f"{tuple(g.shape)}, not {tuple(p.shape)}")
            # in the parameter's own layout, as autograd lays a gradient
            p.grad = None if g is None else torch.empty_like(p).copy_(
                torch.as_tensor(g))


def _as_tensors(obj):
    """NumPy arrays → tensors through dicts and lists (a checkpoint's
    optimizer state; torch's ``load_state_dict`` moves them to each
    parameter's device)."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy())
    if isinstance(obj, dict):
        return {k: _as_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_as_tensors(v) for v in obj)
    return obj


def frozen_parameter_names(config: Dict[str, Any],
                           model: torch.nn.Module) -> Set[str]:
    """The ``named_parameters()`` names the JAX package's
    ``frozen_param_mask`` freezes: with ``mode: freeze_backbone`` all of
    ``backbone.*``; with the backbone's ``frozen_stages`` s >= 0, for the
    ResNet the stem and ``layer1..s``, for the ViT ``pos_embedding``, the
    patch embedding and blocks ``< s`` (not ``cls_embedding``)."""
    backbone = getattr(model, "backbone", None)
    stages = getattr(backbone, "frozen_stages", -1)
    freeze_all = config.get("mode") == "freeze_backbone"
    if backbone is None or (not freeze_all and stages < 0):
        return set()
    vit = hasattr(backbone, "to_patch_embedding")
    frozen = set()
    for name, _ in backbone.named_parameters():
        head = name.split(".")[0]
        if freeze_all:
            hit = True
        elif vit:
            hit = head in ("pos_embedding", "to_patch_embedding") or (
                head.startswith("block") and int(head[5:]) < stages)
        else:
            hit = head == "stem" or (head.startswith("layer")
                                     and int(head[5:]) <= stages)
        if hit:
            frozen.add(f"backbone.{name}")
    return frozen


def param_groups(config: Dict[str, Any],
                 model: torch.nn.Module) -> List[Dict[str, Any]]:
    """The trainable parameters of ``model`` as param groups, each with its
    ``lr_scale`` and ``weight_decay``; frozen parameters stop requiring
    gradients and are in no group."""
    train_cfg = config["train"]
    weight_decay = train_cfg["weight_decay"] or 0.0
    layer_decay = train_cfg.get("layer_decay", None)
    scales = param_lr_scales_and_wd(model, layer_decay) if layer_decay \
        else {}
    frozen = frozen_parameter_names(config, model)
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for name, p in model.named_parameters():
        if name in frozen:
            p.requires_grad_(False)
            continue
        scale, decays = scales.get(name, (1.0, True))
        groups.setdefault((scale, weight_decay if decays else 0.0),
                          []).append(p)
    return [{"params": params, "lr_scale": scale, "weight_decay": wd}
            for (scale, wd), params in groups.items()]


def accum_iter(config: Dict[str, Any]) -> int:
    return int(config["train"].get("accum_iter", 1) or 1)


def updates_per_epoch(config: Dict[str, Any], steps_per_epoch: int) -> int:
    """The optimizer updates an epoch of ``steps_per_epoch`` micro-steps
    makes under ``train.accum_iter`` (at least one)."""
    return max(steps_per_epoch // accum_iter(config), 1)


def build_optimizer(config: Dict[str, Any], model: torch.nn.Module,
                    updates_per_epoch: int) -> TrainOptimizer:
    """The config's optimizer over the trainable parameters of ``model``,
    in the groups of :func:`param_groups`, its schedule counting
    ``updates_per_epoch`` updates an epoch."""
    train_cfg = config["train"]
    opt_name = train_cfg["optimizer"]
    kwargs = train_cfg.get("optimizer_kwargs", {}) or {}
    groups = param_groups(config, model)
    schedule = make_lr_schedule(train_cfg, updates_per_epoch)
    lr0 = schedule(0)
    params = [p for g in groups for p in g["params"]]
    owners = None
    world = pdist.data_size()
    if (config.get("parallel") or {}).get("shard_optimizer") and world > 1:
        # ZeRO-1: this rank's optimizer over the parameters it owns among
        # those of its data group
        owners = balanced_owners([p.numel() for p in params], world)
        mine = {id(p) for p, r in zip(params, owners)
                if r == pdist.data_rank()}
        local = [dict(g, params=[p for p in g["params"] if id(p) in mine])
                 for g in groups]
    else:
        local = groups
    if opt_name == "sgd":
        opt = torch.optim.SGD(local, lr=lr0,
                              momentum=kwargs.get("momentum", 0))
    elif opt_name == "adamw":
        b1, b2 = tuple(kwargs.get("betas", (0.9, 0.999)))
        opt = torch.optim.AdamW(local, lr=lr0, betas=(b1, b2),
                                eps=kwargs.get("eps", 1e-8))
    else:
        raise ValueError(f"Unknown optimizer: {opt_name}")
    name_of = {id(p): n for n, p in model.named_parameters()}
    return TrainOptimizer(opt, schedule, params,
                          [name_of[id(p)] for p in params],
                          train_cfg.get("max_norm", None), accum_iter(config),
                          owners=owners,
                          group_sizes=[len(g["params"]) for g in groups])
