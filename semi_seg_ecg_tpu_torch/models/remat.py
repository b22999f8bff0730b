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
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..parallel import seq_shard
from ..parallel.dist import concatenated_rows, row_parts
from .dropout import generators_of
from .norm import running_stats_kept


def remat_call(block: nn.Module, x: torch.Tensor, *args) -> torch.Tensor:
    """``block(x, *args)`` with its activations recomputed in the backward
    (a plain call where no graph is recorded); the recompute runs under the
    forward's split of the time axis (``parallel/seq_shard.py``)."""
    if not torch.is_grad_enabled():
        return block(x, *args)
    shard = seq_shard.active()
    gens = generators_of(block)
    states = [g.get_state() for g in gens]
    modes = [(m, m.training) for m in block.modules()]
    parts = row_parts()
    forward_done = False

    def run(inp: torch.Tensor) -> torch.Tensor:
        nonlocal forward_done
        if not forward_done:
            forward_done = True
            return block(inp, *args)
        now = [g.get_state() for g in gens]
        now_modes = [(m, m.training) for m, _ in modes]
        for g, s in zip(gens, states):
            g.set_state(s)
        for m, training in modes:
            m.training = training
        try:
            with running_stats_kept(block), concatenated_rows(parts), \
                    seq_shard.using(shard):
                return block(inp, *args)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)
            for m, training in now_modes:
                m.training = training

    return checkpoint(run, x, use_reentrant=False)
