"""``debug.nan_checks``: the JAX package's ``jax_debug_nans`` in the port.

The JAX package sets ``jax_debug_nans`` at the start of ``run_training``
(``semi_seg_ecg_tpu/algorithms/common.py``) and never resets it, so from
then to the end of ``cli.train_main`` every jitted call that returns a NaN
raises ``FloatingPointError``: the train step (its new state, under
``train.accum_iter`` > 1 the window's accumulated gradients among it, and
its metrics), the epoch's ``eval_step`` (``probs`` and ``loss``) and the
``test: true`` pass; the de-optimised rerun names the op. NaN only: an inf
is no fault (``jax_debug_infs`` stays off). ``test_main`` alone does not
check, nor does ST++'s ranking, whose outputs are integer counts.

The port checks the same outputs, and raises the same exception:

- the gradients, at the entry of a step's first ``TrainOptimizer.step``
  (after the backward, before the ranks' all-reduce and the update: the
  update of a flagged step is never applied): :func:`grad_flags`, one flag
  a trainable parameter, from its gradient's norm (``torch._foreach_norm``:
  a NaN element gives a NaN norm, an inf or an overflow an inf);
- an eager step's backward: in one process under autograd's anomaly
  mode, whose error at the op that returned a NaN is raised as
  ``FloatingPointError`` from it (:func:`is_anomaly`), so the op and the
  forward's trace stay in the traceback; under a process group by
  :class:`BackwardNans`, which finds the same op without raising in the
  middle of the backward, since another rank's backward may be waiting at
  a collective of it (BatchNorm's statistics, the ring, the model axis)
  that this rank would never reach;
- the step's metrics (:func:`metric_flags`), and each evaluation batch's
  probabilities and per-sample loss (``algorithms/common.evaluate``).

Each flag vector is MAX-reduced over every rank of the process group
before the host reads it (:func:`world_any`), so that every rank raises at
the same point and none waits at a collective another rank has left.
Under ``train.scan_steps`` on a card the checks of a step run inside its
CUDA graphs, split at the gradients' flag (``utils/captured_step.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves

from ..parallel import dist as pdist

# names listed in a message before "and N more"
SHOWN = 5


def enabled(config) -> bool:
    """Whether the config sets ``debug.nan_checks``."""
    return bool((config.get("debug") or {}).get("nan_checks", False))


def world_any(flags: torch.Tensor) -> torch.Tensor:
    """``flags`` (0 or 1 each) replaced by their maximum over every rank of
    the process group, in place (no group: as they are); no host sync."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        pdist.all_reduce_max_(flags, dist.group.WORLD)
    return flags


def _params(optimizers) -> List[torch.Tensor]:
    return [p for opt in optimizers for p in opt.params]


def grad_flags(optimizers,
               at_op: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step's gradient flags over every rank (:func:`world_any`): a
    float vector whose element 0 is ``at_op`` (:meth:`BackwardNans.any`: a
    rank's backward op returned a NaN; unset: 0), then one element a
    trainable parameter of ``optimizers`` in their order, 1 where its
    gradient holds a NaN (a parameter without a gradient: 0). Device work
    only, so that a CUDA graph can hold it."""
    params = _params(optimizers)
    grads = [p.grad for p in params if p.grad is not None]
    zero = params[0].new_zeros((), dtype=torch.float32)
    norms = iter(torch._foreach_norm(grads) if grads else ())
    entries = [zero if at_op is None else at_op.float()] + [
        next(norms).float().isnan().float() if p.grad is not None else zero
        for p in params]
    return world_any(torch.stack(entries))


class BackwardNans(TorchFunctionMode):
    """Inside (a step's forward and backward, under a process group): the
    autograd node of every op's output records, once the backward has run
    it, whether a gradient it returned holds a NaN, on the device (anomaly
    mode's check, without its raise). :meth:`any` and :meth:`first` read
    the records. The nodes are held while inside (so that an id stays its
    node's) and let go on exit: a graph's nodes kept alive would keep the
    parameters' gradient accumulators, with the stream they were made on,
    into the next step, and a capture on another stream would then wait on
    that one."""

    def __init__(self):
        super().__init__()
        self.records: List = []  # (node name, 0-d bool), in backward order
        self._nodes: Dict[int, object] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            node = getattr(t, "grad_fn", None) if isinstance(
                t, torch.Tensor) else None
            if node is not None and id(node) not in self._nodes:
                self._nodes[id(node)] = node
                node.register_hook(_recorder(self.records, node.name()))
        return out

    def __exit__(self, *exc):
        self._nodes.clear()
        return super().__exit__(*exc)

    def any(self) -> Optional[torch.Tensor]:
        """Whether a node's gradient held a NaN (0-d, on the device; None
        when no node recorded)."""
        if not self.records:
            return None
        return torch.stack([f for _, f in self.records]).any()

    def first(self) -> Optional[str]:
        """The first node (in the backward's order) whose gradient held a
        NaN, or None (one host sync)."""
        if not self.records:
            return None
        hit = torch.stack([f for _, f in self.records]).cpu().tolist()
        return next((name for (name, _), h in zip(self.records, hit) if h),
                    None)


def _recorder(records: List, name: str):
    """A node's post hook: whether a gradient it returned holds a NaN,
    appended to ``records`` with the node's ``name``."""
    def hook(grad_inputs, grad_outputs):
        flags = [g.isnan().any() for g in grad_inputs
                 if g is not None and g.is_floating_point()]
        if flags:
            records.append((name, torch.stack(flags).any()))

    return hook


def flagged_names(flags, optimizers) -> List[str]:
    """The names of the parameters whose gradient ``flags`` (host values of
    :func:`grad_flags`) mark."""
    names = [n for opt in optimizers for n in opt.names]
    return [n for n, f in zip(names, list(flags)[1:]) if f]


def _listed(names: Sequence[str]) -> str:
    more = len(names) - SHOWN
    return ", ".join(names[:SHOWN]) + (f" and {more} more" if more > 0
                                       else "")


def raise_for_grads(flags: torch.Tensor, optimizers, step: int,
                    rerun_of: Optional[List[str]] = None,
                    at_op: Optional[str] = None) -> None:
    """Raise ``FloatingPointError`` when :func:`grad_flags` ``flags`` (read
    here, one host sync) are set: at ``at_op``, the node of this rank's
    backward that returned a NaN (:meth:`BackwardNans.first`), when there
    is one; with ``rerun_of`` (the eager rerun of a captured step whose
    graph flagged those gradients) raise in any case: the rerun applies no
    update."""
    host = flags.cpu().tolist()
    names = flagged_names(host, optimizers)
    where = f"debug.nan_checks: train step {step}"
    if at_op is not None:
        raise FloatingPointError(
            f"{where}: Function '{at_op}' returned nan values (rank "
            f"{pdist.get_rank()}, found after the backward)")
    if host[0]:
        raise FloatingPointError(
            f"{where}: another rank's backward returned a NaN (that rank "
            "names the op)")
    if names:
        raise FloatingPointError(
            f"{where}: NaN in the gradients of {_listed(names)} (under "
            "train.accum_iter, the window's sum so far)")
    if rerun_of is not None:
        raise FloatingPointError(
            f"{where}: the captured step's gradients of {_listed(rerun_of)} "
            "held a NaN, and the step's eager rerun did not reproduce it")


def is_anomaly(error: RuntimeError) -> bool:
    """Whether ``error`` is autograd's anomaly mode finding a NaN that a
    backward op returned."""
    return "returned nan values" in str(error)


def metric_flags(values: torch.Tensor) -> torch.Tensor:
    """One flag an element of the stacked metrics ``values``, over every
    rank (:func:`world_any`); device work only."""
    return world_any(values.isnan().float())


def raise_for_metrics(flags: torch.Tensor, keys: Sequence[str],
                      step: int) -> None:
    """Raise ``FloatingPointError`` naming the metrics :func:`metric_flags`
    ``flags`` mark (read here, one host sync) after train step ``step``."""
    names = [k for k, f in zip(keys, flags.cpu().tolist()) if f]
    if names:
        raise FloatingPointError(f"debug.nan_checks: train step {step}: NaN "
                                 f"in the step's {', '.join(names)}")


def check_metrics(metrics: Dict[str, torch.Tensor], step: int) -> None:
    """:func:`raise_for_metrics` of an eager step's ``metrics``."""
    keys = list(metrics)
    values = torch.stack([metrics[k].detach().float() for k in keys])
    raise_for_metrics(metric_flags(values), keys, step)


EVAL_OUTPUTS = ("probs", "loss")


def eval_flags(probs: torch.Tensor, loss: torch.Tensor) -> torch.Tensor:
    """One flag each for ``eval_step``'s probabilities and per-sample loss
    (:data:`EVAL_OUTPUTS`), NaN anywhere in them, over every rank."""
    return world_any(torch.stack([probs.isnan().any(),
                                  loss.isnan().any()]).float())


def raise_for_eval(flags: torch.Tensor, where: str, batch: int) -> None:
    """Raise ``FloatingPointError`` when :func:`eval_flags` ``flags`` (read
    here) are set: ``where`` names the pass, ``batch`` its batch."""
    names = [k for k, f in zip(EVAL_OUTPUTS, flags.cpu().tolist()) if f]
    if names:
        raise FloatingPointError(
            f"debug.nan_checks: NaN in eval_step's {' and '.join(names)} "
            f"at batch {batch} of {where}")
