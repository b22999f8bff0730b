"""Activation checkpointing of one block (``remat: true``), the counterpart
of the JAX package's ``nn.remat`` around each transformer or residual
block.

:func:`remat_call` runs the block under ``torch.utils.checkpoint`` (the
non-reentrant kind): its activations are dropped after the forward and
recomputed in the backward, so the loss, the gradients and the running
statistics are those of the plain call. Three things keep the recompute
the forward's twin, which ``torch.utils.checkpoint`` alone would not:

- the block's dropout generators (``models/dropout.py``) are put back to
  where the forward found them, so it draws the same masks (the global
  RNGs, which a generator-less dropout uses, checkpointing restores
  itself);
- each module's train/eval mode is the forward's, whatever the step set
  in between, and so is the batch's layout for the per-row draws under a
  process group (``parallel.dist.concatenated_rows``);
- its BatchNorms update scratch copies of their running statistics
  (``models/norm.running_stats_kept``), so the statistics move once per
  forward, as under ``nn.remat``.

The kernels inside the block run again in the recompute: the flash
forward launches once more per checkpointed block, its backward as
often as without checkpointing.

Under CUDA graph capture (``train.scan_steps``, ``utils/captured_step.py``)
torch refuses to read or set a generator's state, so the generators are
put back another way. The step's eager warm-up records, in
:func:`recording`, where each block's forward found them (their offsets
from the step's reseed, one :class:`RematCall` a call); each call gets a
stand-in generator per generator, registered with the graph, which
:meth:`RematCall.point_stand_ins` sets to that position before every
replay. Inside the capture (:func:`capturing`) the recompute swaps the
stand-ins in with ``graphsafe_set_state`` and back after, so it draws the
forward's masks as the eager recompute does. ``torch.utils.checkpoint``
keeps its own save of the global RNGs out of the capture (the blocks draw
from their generators only).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..parallel import seq_shard
from ..parallel.dist import concatenated_rows, row_parts
from .dropout import generators_of
from .norm import running_stats_kept


class RematCall:
    """One checkpointed call of a captured step: its block's generators,
    their offsets from the step's reseed where the forward found them, and
    a stand-in generator for each."""

    def __init__(self, gens: List[torch.Generator]):
        self.gens = gens
        self.offsets = [g.get_offset() for g in gens]
        self.stand_ins = [torch.Generator(device=g.device) for g in gens]

    def point_stand_ins(self) -> None:
        """After the step's reseed, before a replay: each stand-in at the
        position its generator will hold at the block's forward."""
        for g, s, offset in zip(self.gens, self.stand_ins, self.offsets):
            s.set_state(g.get_state())
            s.set_offset(g.get_offset() + offset)


# the RematCalls being recorded (a list), or replayed in a capture (an
# iterator over them); None outside both
_RECORD: Optional[List[RematCall]] = None
_CAPTURE = None


@contextlib.contextmanager
def recording():
    """Record a :class:`RematCall` for each checkpointed call inside, in
    order; yields the list."""
    global _RECORD
    calls: List[RematCall] = []
    _RECORD = calls
    try:
        yield calls
    finally:
        _RECORD = None


@contextlib.contextmanager
def capturing(calls: List[RematCall]):
    """Inside a CUDA graph capture of the step :func:`recording` recorded:
    the checkpointed calls take ``calls``' stand-ins in order."""
    global _CAPTURE
    _CAPTURE = iter(calls)
    try:
        yield
    finally:
        _CAPTURE = None


def remat_call(block: nn.Module, x: torch.Tensor, *args) -> torch.Tensor:
    """``block(x, *args)`` with its activations recomputed in the backward
    (a plain call where no graph is recorded); the recompute runs under the
    forward's split of the time axis (``parallel/seq_shard.py``)."""
    if not torch.is_grad_enabled():
        return block(x, *args)
    shard = seq_shard.active()
    gens = generators_of(block)
    graph_safe = _CAPTURE is not None
    if graph_safe:
        call = next(_CAPTURE, None)
        if call is None or len(call.gens) != len(gens) or any(
                a is not b for a, b in zip(call.gens, gens)):
            raise RuntimeError("the captured step's checkpointed calls "
                               "differ from its warm-up's")
        states = call.stand_ins
    else:
        states = [g.get_state() for g in gens]
        if _RECORD is not None:
            _RECORD.append(RematCall(gens))
    modes = [(m, m.training) for m in block.modules()]
    parts = row_parts()
    forward_done = False

    def put(targets):
        """Put each generator at ``targets`` (states, or under capture the
        stand-ins' generators); returns how to put them back."""
        if graph_safe:
            now = [g.graphsafe_get_state() for g in gens]
            for g, s in zip(gens, targets):
                g.graphsafe_set_state(s)
            return lambda: [g.graphsafe_set_state(s)
                            for g, s in zip(gens, now)]
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, targets):
            g.set_state(s)
        return lambda: [g.set_state(s) for g, s in zip(gens, now)]

    def run(inp: torch.Tensor) -> torch.Tensor:
        nonlocal forward_done
        if not forward_done:
            forward_done = True
            return block(inp, *args)
        now_modes = [(m, m.training) for m, _ in modes]
        restore = put(states)
        for m, training in modes:
            m.training = training
        try:
            with running_stats_kept(block), concatenated_rows(parts), \
                    seq_shard.using(shard):
                return block(inp, *args)
        finally:
            restore()
            for m, training in now_modes:
                m.training = training

    return checkpoint(run, x, use_reentrant=False,
                      preserve_rng_state=not graph_safe)
