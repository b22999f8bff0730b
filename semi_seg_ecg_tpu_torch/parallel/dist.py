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
no ``ReduceOp.AVG`` and no ``reduce_scatter``). The ranks form the
``(data, model)`` mesh of ``parallel/mesh.py`` (:func:`set_mesh`); every
collective below takes a ``group=`` and, left unset, runs over this
rank's data group, which is the whole group when ``model_parallel`` is 1:

- :func:`all_reduce_grads_`: the gradient mean over the ranks, one flat
  buffer per dtype, summed and divided by a tensor (CUDA turns a division
  by a Python number into a reciprocal multiply);
- :func:`all_reduce_mean`: the mean of a tensor over the ranks;
- :func:`all_reduce_max_`: the elementwise maximum over a group (int8
  serving's activation absmax, where the seq or model axis splits a
  layer's input);
- :func:`all_gather`: the ranks' tensors stacked on a new leading axis,
  differentiable: its backward sums the full gradient over the ranks and
  returns this rank's slice;
- :func:`all_gather_rows`: the sharded evaluators' row exchange;
- :func:`broadcast_module_`: rank 0's parameters and buffers to every rank
  of the world (before the model axis slices them);
- :func:`broadcast_from_owners_`: each tensor from the rank that owns it
  (ZeRO-1's parameters after the update); :func:`all_gather_object`:
  every rank's picklable object (ZeRO-1's optimizer state for a
  checkpoint);
- :func:`global_rows`: a per-row random draw made for the global batch
  and sliced to this rank's rows, so that rank ``r`` of ``N`` with ``b``
  rows draws rows ``[r·b, (r+1)·b)`` of what one process with all ``N·b``
  rows draws. A batch that concatenates ``k`` parts (the semi-supervised
  student's labeled and unlabeled rows) says so with
  :func:`concatenated_rows`: one process holds each part's ``N·b/k`` rows
  one after the other, so rank ``r`` takes its block of each part. A
  draw over a dimension the model axis splits (the MLP's hidden columns,
  the attention heads) is made whole and sliced to this model rank's
  block (``split``).

Point to point (:func:`exchange`): the seq axis's halos and its ring
(``parallel/seq_shard.py``, ``ops/ring_attention.py``) send each peer one
tensor and receive one from each peer, all posted at once
(``batch_isend_irecv``): on CUDA tensors under NCCL, and through the host
under gloo, whose ``send`` and ``recv`` take CPU tensors.

The model axis's two operators (Megatron's ``f`` and ``g``) are autograd
functions over the model group: :func:`copy_to_model`
(identity forward, all-reduce backward) in front of a column-parallel
layer, :func:`reduce_from_model` (all-reduce forward, identity backward)
behind a row-parallel one. The reduce sums in fp32 whatever the
activation's dtype, and rounds once to it.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logging import log, set_logging_enabled

BACKENDS = ("nccl", "gloo")

# the parts the batch of the forward in progress concatenates
_ROW_PARTS: contextvars.ContextVar = contextvars.ContextVar("row_parts",
                                                           default=1)
# the (data, model) layout of the ranks (parallel/mesh.py); None: every
# rank is a data rank
_MESH = None


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
        set_mesh(None)
        log(f"| distributed init (rank {rank}/{world}, {backend})",
            force=True)
    if ddp_cfg is not None:
        ddp_cfg["rank"] = get_rank()
        ddp_cfg["world_size"] = get_world_size()
        ddp_cfg["distributed"] = dist.is_initialized()
    set_logging_enabled(is_main_process())


def destroy_process_group() -> None:
    """Tear down the process group, if there is one; every process prints
    again. Unreachable objects go first: a CUDA graph that captured NCCL
    calls (``utils/captured_step.py``; a trainer and its captured step
    form reference cycles) holds its communicator, and NCCL destroys a
    communicator only once every such graph is gone."""
    if dist.is_initialized():
        gc.collect()
        dist.destroy_process_group()
    set_mesh(None)
    set_logging_enabled(True)


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def set_mesh(mesh) -> None:
    """Register the ranks' ``(data, model)`` layout (``parallel/mesh.py``),
    or forget it (None)."""
    global _MESH
    _MESH = mesh


def current_mesh():
    """The registered mesh, while the process group it was made on lives;
    else None."""
    if _MESH is None:
        return None
    world = dist.group.WORLD if dist.is_initialized() else None
    return _MESH if _MESH.world_group is world else None


def data_group():
    """This rank's data group (None: the whole group)."""
    mesh = current_mesh()
    return None if mesh is None else mesh.data_group


def data_size() -> int:
    mesh = current_mesh()
    return get_world_size() if mesh is None else mesh.data


def data_rank() -> int:
    mesh = current_mesh()
    return get_rank() if mesh is None else mesh.data_rank


def _group(group):
    """``group``, or this rank's data group when it is None."""
    return data_group() if group is None else group


def _size(group) -> int:
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _rank(group) -> int:
    if not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def backend() -> Optional[str]:
    """The process group's backend (``nccl``, ``gloo``), None without one."""
    return dist.get_backend() if dist.is_initialized() else None


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


def _gather_tensor(t: torch.Tensor, group=None) -> torch.Tensor:
    """``(n, *t.shape)``: the ``t`` of each of the ``n`` ranks of ``group``
    (None: the data group). Under gloo through an all-reduce of this rank's
    slot in a zero buffer, which is exact (each element is one rank's value
    plus zeros) and which gloo runs on CUDA tensors too, as its all-gather
    does not."""
    _check(t)
    group = _group(group)
    n = _size(group)
    t = t.contiguous()
    if _is_nccl():
        out = t.new_empty((n,) + tuple(t.shape))
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    out = t.new_zeros((n,) + tuple(t.shape))
    out[_rank(group)] = t
    dist.all_reduce(out, group=group)
    return out


class _AllGather(torch.autograd.Function):
    """Forward: every rank's tensor, stacked. Backward: every rank holds
    the gradient of its own loss with respect to all ranks' inputs; their
    sum over the ranks, sliced to this rank, is the gradient of the sum of
    the ranks' losses with respect to this rank's input."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _gather_tensor(t, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[_rank(ctx.group)], None


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``(n, *t.shape)`` over the ``n`` ranks of ``group`` (None: the data
    group), differentiable (:class:`_AllGather`); one rank: ``t[None]``."""
    group = _group(group)
    if _size(group) == 1:
        return t.unsqueeze(0)
    return _AllGather.apply(t, group)


def gather_batch(t: torch.Tensor, group=None) -> torch.Tensor:
    """The global batch of a per-rank batch ``t``: the rows of the ranks of
    ``group`` (None: the data group) concatenated in rank order,
    differentiable (:func:`all_gather`)."""
    if _size(_group(group)) == 1:
        return t
    return all_gather(t, group).flatten(0, 1)


def _divide_by(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.div_(torch.full((), n, dtype=t.dtype, device=t.device))


def all_reduce_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``group`` (None: the data group;
    a new tensor, ``t`` itself with one rank)."""
    group = _group(group)
    n = _size(group)
    if n == 1:
        return t
    _check(t)
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return _divide_by(out, n)


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (None: the data group), in
    place; returns ``t``."""
    group = _group(group)
    if _size(group) > 1:
        _check(t)
        dist.all_reduce(t, group=group)
    return t


def all_reduce_max_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` replaced by its elementwise maximum over the ranks of
    ``group`` (None: the data group), in place; returns ``t``. Exact in any
    dtype (int8 serving's activation absmax over the ranks that split a
    tensor)."""
    group = _group(group)
    if _size(group) > 1:
        _check(t)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


@torch.no_grad()
def all_reduce_grads_(params: Sequence[torch.Tensor], group=None,
                      divisor: Optional[int] = None,
                      have: Optional[List[bool]] = None
                      ) -> Optional[List[bool]]:
    """Replace each ``.grad`` of ``params`` by its sum over the ranks of
    ``group`` (None: the data group) divided by ``divisor`` (None: their
    number, the mean), one all-reduce per dtype, in place. Parameters
    without a gradient are skipped: every rank runs the same graph, so they
    are the same on every rank; with a ``divisor`` (the seq axis) a
    gradient that another rank has is taken as zero here. Which ones some
    rank has (one flag a trainable parameter) costs an all-reduce and a
    host sync: ``have`` gives the flags an earlier call returned (a CUDA
    graph capture can make no host sync). Returns the flags with a
    ``divisor``, else None."""
    group = _group(group)
    n = _size(group)
    if n == 1:
        return None
    if divisor is not None:
        # the seq ranks run different parts of one graph (only seq rank 0
        # holds the cls token): a gradient that some rank lacks is zero there
        params = [p for p in params if p.requires_grad]
        if have is None:
            flags = torch.tensor([float(p.grad is not None) for p in params],
                                 device=params[0].device)
            dist.all_reduce(flags, group=group)
            have = [bool(h) for h in flags.tolist()]
        for p, h in zip(params, have):
            if h and p.grad is None:
                p.grad = torch.zeros_like(p)
        n = divisor
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        _check(flat)
        dist.all_reduce(flat, group=group)
        _divide_by(flat, n)
        # one multi-tensor copy back, not a launch per gradient
        pieces = flat.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [p.view_as(g)
                                     for p, g in zip(pieces, grads)])
    return have


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers into every rank's ``module``, over
    the whole group (model ranks included: the model axis slices the
    parameters afterwards)."""
    if get_world_size() == 1:
        return
    for t in module.state_dict().values():
        _check(t)
        dist.broadcast(t, src=0)


@torch.no_grad()
def broadcast_from_owners_(tensors: Sequence[torch.Tensor],
                           owners: Sequence[int], group=None) -> None:
    """Each of ``tensors`` (the same list on every rank) from the rank of
    ``group`` (None: the data group) that ``owners`` names into every other
    rank's, in place: one broadcast per owning rank and dtype, of the
    owner's tensors flattened into one buffer. ZeRO-1's parameter exchange
    after each rank's update."""
    group = _group(group)
    n = _size(group)
    if n == 1:
        return
    rank = _rank(group)
    for src in range(n):
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t, owner in zip(tensors, owners):
            if owner == src:
                by_dtype.setdefault(t.dtype, []).append(t)
        for owned in by_dtype.values():
            if rank == src:
                flat = torch.cat([t.reshape(-1) for t in owned])
            else:
                flat = torch.empty(sum(t.numel() for t in owned),
                                   dtype=owned[0].dtype,
                                   device=owned[0].device)
            _check(flat)
            dist.broadcast(flat, src=src if group is None else
                           dist.get_global_rank(group, src), group=group)
            if rank != src:
                pieces = flat.split([t.numel() for t in owned])
                torch._foreach_copy_(owned, [p.view_as(t) for p, t
                                             in zip(pieces, owned)])


def exchange(sends: Dict[int, torch.Tensor],
             recvs: Dict[int, Tuple[Tuple[int, ...], torch.dtype]],
             ranks: Sequence[int], group, device: torch.device
             ) -> Dict[int, torch.Tensor]:
    """Point to point among the ranks of ``group``: ``sends[j]`` goes to
    global rank ``ranks[j]``, and from ``ranks[j]`` comes a tensor of
    ``recvs[j] = (shape, dtype)``, returned on ``device`` under ``j``. Every
    send and receive is posted at once (``batch_isend_irecv``), so no order
    of the peers deadlocks; at most one tensor each way per peer. Under
    gloo the tensors go through the host. Under NCCL the host waits on
    nothing: the group's stream takes the ops after the current stream's
    work and each ``wait`` makes the current stream wait for them, so a
    CUDA graph captures the exchange (``utils/captured_step.py``)."""
    nccl = _is_nccl()
    wire = device if nccl else torch.device("cpu")
    ops, out = [], {}
    for j, t in sends.items():
        t = t.contiguous() if nccl else t.detach().to(wire).contiguous()
        _check(t)
        ops.append(dist.P2POp(dist.isend, t, ranks[j], group))
    for j, (shape, dtype) in recvs.items():
        out[j] = torch.empty(shape, dtype=dtype, device=wire)
        ops.append(dist.P2POp(dist.irecv, out[j], ranks[j], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return {j: t.to(device, non_blocking=False) for j, t in out.items()}


def all_gather_object(obj: Any, group=None) -> List[Any]:
    """The picklable ``obj`` of every rank of ``group`` (None: the data
    group), in rank order (one rank: ``[obj]``)."""
    group = _group(group)
    n = _size(group)
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def all_gather_rows(rows: np.ndarray, arrays: Sequence[np.ndarray],
                    group=None):
    """Cross-rank reassembly of per-sample arrays (the JAX package's
    ``_allgather_rows``). ``rows`` are the dataset indices this rank
    computed; each of ``arrays`` is a full-size ``(N, ...)`` buffer with
    those rows filled. The ranks exchange their rows (equal counts, the
    loader pads its shards) and every rank writes all of them in rank
    order, so every rank ends with the same arrays. The ranks are those of
    ``group`` (None: the data group; the model ranks of a data rank hold the
    same rows). Returns ``arrays``."""
    group = _group(group)
    if _size(group) == 1:
        return arrays
    device = _group_device()
    rows = np.asarray(rows, np.int64)
    all_rows = _gather_tensor(torch.from_numpy(rows).to(device), group).cpu()
    for a in arrays:
        vals = _gather_tensor(torch.from_numpy(
            np.ascontiguousarray(a[rows])).to(device), group).cpu().numpy()
        for r in range(vals.shape[0]):
            a[all_rows[r].numpy()] = vals[r]
    return arrays


@contextlib.contextmanager
def concatenated_rows(parts: int):
    """Inside, a batch is the concatenation of ``parts`` equal parts, each
    sharded over the ranks (for :func:`global_rows`)."""
    token = _ROW_PARTS.set(parts)
    try:
        yield
    finally:
        _ROW_PARTS.reset(token)


def row_parts() -> int:
    """The ``parts`` of the innermost :func:`concatenated_rows`, else 1."""
    return _ROW_PARTS.get()


def global_rows(draw: Callable[[tuple], torch.Tensor],
                shape: Sequence[int],
                split: Optional[Tuple[int, int, int]] = None,
                time: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows of the global batch: the draw
    of ``(n·b, *shape[1:])`` over the ``n`` data ranks, sliced to rows
    ``[r·b, (r+1)·b)`` of data rank ``r``, ``b = shape[0]``; under
    :func:`concatenated_rows`, this rank's block of each part. With
    ``split = (dim, parts, index)``, ``shape[dim]`` is block ``index`` of
    ``parts`` equal blocks of the draw's ``dim``: the draw is made whole
    there and sliced to the block (a model rank's columns or heads). With
    ``time = (dim, length, start)``, ``shape[dim]`` is the entries
    ``[start, start + shape[dim])`` of a global axis of ``length`` (a seq
    rank's block of the time or token axis): drawn whole, then sliced."""
    shape = tuple(shape)
    whole = list(shape)
    if split is not None:
        dim, parts_m, index = split
        dim %= len(shape)
        whole[dim] *= parts_m
    if time is not None:
        tdim, length, start = time
        tdim %= len(shape)
        whole[tdim] = length
    n = data_size()
    if n == 1:
        full = draw(tuple(whole))
    else:
        parts, rank = row_parts(), data_rank()
        b = shape[0] // parts
        full = draw((whole[0] * n,) + tuple(whole[1:]))
        full = full.reshape((parts, n, b) + tuple(whole[1:]))[:, rank]
        full = full.reshape(whole)
    if split is not None:
        full = full.narrow(dim, index * shape[dim], shape[dim])
    if time is not None:
        full = full.narrow(tdim, start, shape[tdim])
    return full


def group_size(group=None) -> int:
    """The ranks of ``group`` (None: the data group)."""
    return _size(_group(group))


def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``group``, in fp32, in ``t``'s
    dtype."""
    out = t.float().contiguous()
    if out is t:
        out = out.clone()
    _check(out)
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the model ranks' gradients
    (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model ranks forward; identity backward (Megatron's
    ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` into a column-parallel layer on the model ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The partial sums of a row-parallel layer on the model ``group``,
    summed."""
    return _ReduceFromModel.apply(x, group)
