"""The matmul and convolution FLOPs of one flagship FixMatch step: the MFU
denominator of ``tools/bench.py`` (the port of ``tools/flops_audit.py``).

    python -m semi_seg_ecg_tpu_torch.tools.flops_audit [--batch 16] \\
        [--device cpu]

One whole ``Trainer.train_step`` runs under
``torch.utils.flop_counter.FlopCounterMode``: the eval-mode pseudo-label
forward on the weak view, the train forward on ``cat(labeled, strong)``,
the backward and the AdamW update. The count is the one MFU uses: 2·M·N·K
a product and 2·B·T_out·C_out·(C_in/groups)·K a convolution, each
backward's input and weight gradients at their forward's count;
elementwise work, norms, softmax and the loss are left out. It prints one
JSON line: the total, the count by operator and the top contributors by
operator and input shapes.

The port's flash operators (``ops/flash_attention.py``) get formulas
(:func:`register_flash_formulas`): forward 4·B·H·Nq·Nkv·D (q kᵀ and P v),
backward 8·B·H·Nq·Nkv·D (dP, dV, dQ, dK), which is what the dense path's
products count, so a flash step and a dense step count the same. The
backward kernels also recompute S = q kᵀ (2·B·H·Nq·Nkv·D more, part of the
10·B·H·N²·D that ``chip_smoke.py`` bounds the kernel's own work by): that
is the kernel's way to the gradients, not the model's work.

What the JAX tool's analytic count (``count_jaxpr`` over the step's jaxpr)
counts otherwise, held by ``tests/test_torch_flops.py``:

- the decode head's resize: the JAX package's ``linear_interpolate`` is an
  einsum with a dense (out, in) interpolation matrix below 2^24 entries,
  2·B·C·in·out a resize (forward, and the backward's input gradient); the
  port takes two taps a sample, no product;
- a strided convolution's input gradient: ``count_jaxpr`` counts its
  transposed convolution over the stride-dilated cotangent, T_in output
  positions, where the products that meet no inserted zero are T_out's:
  2·B·C_in·C_out·K·(T_in - T_out) more in JAX;
- a Pallas kernel: ``count_jaxpr`` enters a ``pallas_call``'s kernel jaxpr
  with a multiplier of 1, so it counts one grid block of the flash
  kernels, not the call (``tools/flops_audit.py:82-100``): the JAX
  package's flash step is held against the port with ``attention_impl:
  dense``.

The JAX tool's second count, XLA's cost model of the compiled step, has no
counterpart: the port's eager step is no compiled program that a compiler
could cost.
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import sys
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import (
    FlopCounterMode,
    flop_registry,
    register_flop_formula,
)

from ..ops import flash_attention  # noqa: F401 (registers the operators)
from .device_profile import device_identity, tool_device
from .flagship import build_trainer, flagship_config, synthetic_batch


def flash_forward_flops(q_shape, k_shape, *args, **kwargs) -> int:
    """q kᵀ and P v: 2 + 2 FLOPs a (query, key, feature) triple."""
    b, h, nq, d = q_shape
    return 4 * b * h * nq * k_shape[2] * d


def flash_backward_flops(q_shape, k_shape, *args, **kwargs) -> int:
    """dP = dO vᵀ, dV = Pᵀ dO, dQ = dS k, dK = dSᵀ q."""
    b, h, nq, d = q_shape
    return 8 * b * h * nq * k_shape[2] * d


def register_flash_formulas() -> None:
    """The flash operators' formulas in ``FlopCounterMode``'s registry
    (once a process)."""
    ops = torch.ops.semi_seg_ecg_tpu_torch
    for packet, formula in ((ops.flash_attention_forward,
                             flash_forward_flops),
                            (ops.flash_attention_backward,
                             flash_backward_flops)):
        if packet not in flop_registry:
            register_flop_formula(packet)(formula)


class ShapeTable(TorchDispatchMode):
    """Inside ``FlopCounterMode``: each counted operator call's FLOPs by
    (operator, its first two inputs' shapes), from the same formulas, so
    that the top contributors name their shapes as the JAX tool's do."""

    def __init__(self):
        super().__init__()
        self.table: Dict[tuple, int] = collections.defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            shapes = tuple(tuple(a.shape) for a in args[:2]
                           if isinstance(a, torch.Tensor))
            self.table[(str(func._overloadpacket), shapes)] += formula(
                *args, **kwargs, out_val=out)
        return out


def count_step(trainer, batch: Dict[str, torch.Tensor]):
    """One ``trainer.train_step(batch)`` under ``FlopCounterMode``:
    ``(total FLOPs, by operator, ShapeTable's table)``."""
    register_flash_formulas()
    with FlopCounterMode(display=False) as counter, ShapeTable() as shapes:
        trainer.train_step(batch)
    by_op = {str(op): n for op, n in counter.get_flop_counts()[
        "Global"].items()}
    return counter.get_total_flops(), by_op, dict(shapes.table)


def step_flops(config: Dict[str, Any], device: torch.device,
               batch: Optional[Dict[str, torch.Tensor]] = None) -> int:
    """FLOPs of one step of ``config`` (its ``train.scan_steps`` set to 1:
    a replay runs the eager step's kernels) on a trainer of its own, on
    ``batch`` or a synthetic one of the config's shape."""
    cfg = copy.deepcopy(config)
    cfg["train"]["scan_steps"] = 1
    if batch is None:
        n = cfg["dataloader"]["batch_size"]
        length = cfg["dataset"]["signal_length"]
        batch = synthetic_batch(n, length, device, seed=7,
                                strong=not cfg["dataset"].get(
                                    "device_augment", False))
    return count_step(build_trainer(cfg, device), batch)[0]


def top_rows(table: Dict[tuple, int], total: int, top: int):
    """The ``top`` (operator, shapes) entries by FLOPs, with their share."""
    rows = sorted(table.items(), key=lambda kv: -kv[1])[:top]
    return [{"op": op, "shapes": [list(s) for s in shapes],
             "gflops": f / 1e9, "share": f / total}
            for (op, shapes), f in rows]


def audit(batch_per_replica: int = 16, device: str = "cuda",
          top: int = 12) -> Dict[str, Any]:
    """The flagship step's count on ``device`` (the count is the same on
    either; the card's is what bench.py divides by)."""
    dev = tool_device(device)
    config = flagship_config(batch_per_replica=batch_per_replica,
                             device=dev.type)
    trainer = build_trainer(config, dev)
    batch = synthetic_batch(batch_per_replica, config["dataset"][
        "signal_length"], dev, seed=7)
    total, by_op, table = count_step(trainer, batch)
    return {
        "metric": "fixmatch_resnet18_flops_per_step",
        "batch_per_replica": batch_per_replica,
        "global_batch": batch_per_replica,
        "flops_per_step": total,
        "by_op": by_op,
        "top_contributors": top_rows(table, total, top),
        "device": device_identity(dev),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    print(json.dumps(audit(args.batch, args.device, args.top)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
