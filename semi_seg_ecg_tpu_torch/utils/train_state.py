"""The Mean Teacher's EMA (counterpart of ``ema_update`` in
``semi_seg_ecg_tpu/utils/train_state.py``).

The JAX package threads the teacher through its state tree; here it is a
second module beside the student, updated in place after each optimizer
step. As in the JAX package (and the reference, mean_teacher.py:138-149)
the average covers the parameters and the floating-point buffers (the BN
running statistics); ``num_batches_tracked`` is an integer and is left
alone.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def ema_update(student: torch.nn.Module, teacher: torch.nn.Module,
               decay: float) -> None:
    """``t = t * decay + s * (1 - decay)`` for every floating-point entry
    of the teacher's state_dict, in that order (two products, then their
    sum, each rounded, as the JAX package's ``mix``)."""
    s_state = student.state_dict()
    pairs = [(t, s_state[k]) for k, t in teacher.state_dict().items()
             if t.is_floating_point()]
    if not pairs:
        return
    ts = [t for t, _ in pairs]
    torch._foreach_mul_(ts, decay)
    torch._foreach_add_(ts, torch._foreach_mul([s for _, s in pairs],
                                               1.0 - decay))
