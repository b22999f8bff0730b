"""Process groups and collectives (counterpart of
``semi_seg_ecg_tpu/parallel/dist.py``).

One process per GPU, as the reference runs (src/utils/misc.py:209-233):
``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``; under SLURM ``SLURM_PROCID``,
``SLURM_NTASKS`` and ``SLURM_LOCALID`` stand for the first three (the
rendezvous address still comes from ``MASTER_ADDR``/``MASTER_PORT``).
Without either the run is one process and nothing is initialised. The
backend is the ``ddp`` section's ``dist_backend`` (the reference's key,
which the JAX package ignores), else NCCL for a CUDA run and gloo for a
CPU run; NCCL takes CUDA tensors only, gloo either.

The JAX package gets its collectives from GSPMD; here they are explicit,
and the group's all-reduce is the only reduction used for data (gloo has
no ``ReduceOp.AVG`` and no ``reduce_scatter``):

- :func:`all_reduce_grads_`: the gradient mean over the ranks, one flat
  buffer per dtype, summed and divided by a tensor (CUDA turns a division
  by a Python number into a reciprocal multiply);
- :func:`all_reduce_mean`: the mean of a tensor over the ranks;
- :func:`all_gather`: the ranks' tensors stacked on a new leading axis,
  differentiable: its backward sums the full gradient over the ranks and
  returns this rank's slice;
- :func:`all_gather_rows`: the sharded evaluators' row exchange;
- :func:`broadcast_module_`: rank 0's parameters and buffers to every rank;
- :func:`global_rows`: a per-row random draw made for the global batch
  and sliced to this rank's rows, so that rank ``r`` of ``N`` with ``b``
  rows draws rows ``[r·b, (r+1)·b)`` of what one process with all ``N·b``
  rows draws.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logging import log, set_logging_enabled

BACKENDS = ("nccl", "gloo")


def _env_ranks() -> Optional[tuple]:
    """``(rank, world_size, local_rank)`` from torchrun's variables, else
    SLURM's, else None (one process)."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return (int(env["RANK"]), int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", 0)))
    if "SLURM_PROCID" in env:
        return (int(env["SLURM_PROCID"]), int(env.get("SLURM_NTASKS", 1)),
                int(env.get("SLURM_LOCALID", 0)))
    return None


def local_rank() -> int:
    """This process's index among the processes of its host."""
    ranks = _env_ranks()
    return ranks[2] if ranks else 0


def cuda_device() -> torch.device:
    """``cuda:{local_rank}``; raises where the host has no such card."""
    index = local_rank()
    count = torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(
            f"local rank {index} needs cuda:{index}, but the host has "
            f"{count} CUDA device(s)")
    return torch.device("cuda", index)


def init_distributed_mode(ddp_cfg: Optional[Dict[str, Any]] = None,
                          device: Optional[str] = None) -> None:
    """Idempotent process-group bring-up for a run on ``device`` (the
    config's ``device``; unset, ``cuda``), then rank-0-only logging.
    ``ddp_cfg`` (the config's ``ddp`` section) gets ``rank``,
    ``world_size`` and ``distributed`` as the JAX package fills them. A
    launch without torchrun's or SLURM's variables is one process."""
    device = device or "cuda"
    ranks = _env_ranks()
    if ranks is not None and not dist.is_initialized():
        rank, world, _ = ranks
        backend = (ddp_cfg or {}).get("dist_backend") or (
            "nccl" if device == "cuda" else "gloo")
        if backend not in BACKENDS:
            raise ValueError(f"ddp.dist_backend {backend!r}: expected one "
                             f"of {BACKENDS}")
        if backend == "nccl" and device != "cuda":
            raise RuntimeError(
                "ddp.dist_backend nccl takes CUDA tensors only, and the "
                f"config asks for device {device!r}; use gloo on the CPU")
        available = (dist.is_nccl_available() and torch.cuda.is_available()
                     if backend == "nccl" else dist.is_gloo_available())
        if not available:
            raise RuntimeError(f"world size {world} needs the {backend} "
                               "backend, which this torch build or host "
                               "lacks")
        if device == "cuda":
            torch.cuda.set_device(cuda_device())
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
        log(f"| distributed init (rank {rank}/{world}, {backend})",
            force=True)
    if ddp_cfg is not None:
        ddp_cfg["rank"] = get_rank()
        ddp_cfg["world_size"] = get_world_size()
        ddp_cfg["distributed"] = dist.is_initialized()
    set_logging_enabled(is_main_process())


def destroy_process_group() -> None:
    """Tear down the process group, if there is one; every process prints
    again."""
    if dist.is_initialized():
        dist.destroy_process_group()
    set_logging_enabled(True)


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def barrier() -> None:
    if get_world_size() > 1:
        dist.barrier()


def _is_nccl() -> bool:
    return dist.get_backend() == "nccl"


def _group_device() -> torch.device:
    """Where the group's tensors live: this rank's card under NCCL, else
    the CPU."""
    return (torch.device("cuda", torch.cuda.current_device())
            if _is_nccl() else torch.device("cpu"))


def _check(t: torch.Tensor) -> None:
    if _is_nccl() and t.device.type != "cuda":
        raise RuntimeError("the nccl process group takes CUDA tensors, got "
                           f"one on {t.device}")


def _gather_tensor(t: torch.Tensor) -> torch.Tensor:
    """``(world, *t.shape)``: every rank's ``t``. Under gloo through an
    all-reduce of this rank's slot in a zero buffer, which is exact (each
    element is one rank's value plus zeros) and which gloo runs on CUDA
    tensors too, as its all-gather does not."""
    _check(t)
    world = get_world_size()
    t = t.contiguous()
    if _is_nccl():
        out = t.new_empty((world,) + tuple(t.shape))
        dist.all_gather_into_tensor(out, t)
        return out
    out = t.new_zeros((world,) + tuple(t.shape))
    out[get_rank()] = t
    dist.all_reduce(out)
    return out


class _AllGather(torch.autograd.Function):
    """Forward: every rank's tensor, stacked. Backward: every rank holds
    the gradient of its own loss with respect to all ranks' inputs; their
    sum over the ranks, sliced to this rank, is the gradient of the sum of
    the ranks' losses with respect to this rank's input."""

    @staticmethod
    def forward(ctx, t):
        return _gather_tensor(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[get_rank()]


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """``(world, *t.shape)``, differentiable (:class:`_AllGather`); one
    rank: ``t[None]``."""
    if get_world_size() == 1:
        return t.unsqueeze(0)
    return _AllGather.apply(t)


def gather_batch(t: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-rank batch ``t``: the ranks' rows
    concatenated in rank order, differentiable (:func:`all_gather`)."""
    if get_world_size() == 1:
        return t
    return all_gather(t).flatten(0, 1)


def _divide_by_world(t: torch.Tensor) -> torch.Tensor:
    return t.div_(torch.full((), get_world_size(), dtype=t.dtype,
                             device=t.device))


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks (a new tensor; ``t`` itself with
    one rank)."""
    if get_world_size() == 1:
        return t
    _check(t)
    out = t.detach().clone()
    dist.all_reduce(out)
    return _divide_by_world(out)


@torch.no_grad()
def all_reduce_grads_(params: Sequence[torch.Tensor]) -> None:
    """Replace each ``.grad`` of ``params`` by its mean over the ranks, one
    all-reduce per dtype. Parameters without a gradient are skipped: every
    rank runs the same graph, so they are the same on every rank."""
    if get_world_size() == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        _check(flat)
        dist.all_reduce(flat)
        _divide_by_world(flat)
        # one multi-tensor copy back, not a launch per gradient
        pieces = flat.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [p.view_as(g)
                                     for p, g in zip(pieces, grads)])


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers into every rank's ``module``."""
    if get_world_size() == 1:
        return
    for t in module.state_dict().values():
        _check(t)
        dist.broadcast(t, src=0)


def all_gather_rows(rows: np.ndarray, arrays: Sequence[np.ndarray]):
    """Cross-rank reassembly of per-sample arrays (the JAX package's
    ``_allgather_rows``). ``rows`` are the dataset indices this rank
    computed; each of ``arrays`` is a full-size ``(N, ...)`` buffer with
    those rows filled. The ranks exchange their rows (equal counts, the
    loader pads its shards) and every rank writes all of them in rank
    order, so every rank ends with the same arrays. Returns ``arrays``."""
    if get_world_size() == 1:
        return arrays
    device = _group_device()
    rows = np.asarray(rows, np.int64)
    all_rows = _gather_tensor(torch.from_numpy(rows).to(device)).cpu()
    for a in arrays:
        vals = _gather_tensor(torch.from_numpy(
            np.ascontiguousarray(a[rows])).to(device)).cpu().numpy()
        for r in range(vals.shape[0]):
            a[all_rows[r].numpy()] = vals[r]
    return arrays


def global_rows(draw: Callable[[tuple], torch.Tensor],
                shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows of the global batch: the draw
    of ``(world·b, *shape[1:])`` sliced to rows ``[rank·b, (rank+1)·b)``,
    ``b = shape[0]``."""
    shape = tuple(shape)
    world = get_world_size()
    if world == 1:
        return draw(shape)
    b, rank = shape[0], get_rank()
    return draw((b * world,) + shape[1:])[rank * b:(rank + 1) * b]
