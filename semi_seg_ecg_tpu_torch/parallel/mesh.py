"""The ``(data, seq, model)`` layout of the ranks (counterpart of
``semi_seg_ecg_tpu/parallel/mesh.py``).

The JAX package builds a device mesh and makes the data axis of every
device the other two do not take. Here a rank is a device: :func:`make_mesh`
lays the process group out as ``data × seq × model`` with the model axis
innermost, as the JAX package reshapes its device list, so rank ``r`` is
data rank ``r // (seq·model)``, seq rank ``(r // model) % seq`` and model
rank ``r % model``. It makes the ``torch.distributed`` subgroups once and
registers the mesh with ``parallel/dist.py``, whose collectives then run
over the data group unless told otherwise:

- ``data_group``: the ranks of one (seq, model) index;
- ``model_group``: the ranks of one (data, seq) index;
- ``seq_group``: the ranks of one (data, model) index, the ring of
  ``parallel/seq_shard.py`` (their global ranks in ``seq_ranks``);
- ``data_seq_group``: the ranks of one model index, over which the
  replicated parameters' gradients and the BatchNorm statistics reduce
  when the time axis is sharded.

With ``model_parallel`` and ``seq_parallel`` 1 (every shipped recipe)
there are no subgroups: the data group is the whole group.

Each data rank loads its own shards of every global batch
(:func:`host_shard_args`); the seq and model ranks of one data rank load
the same rows, and their draws are the same. The seq ranks then take their
block of the time axis (``parallel/seq_shard.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist

from . import dist as pdist
from .dist import get_rank, get_world_size


@dataclass(frozen=True)
class Mesh:
    """The ranks' layout: axis sizes, this rank's coordinates and its
    subgroups (None: the whole group, or none at all for the seq ones).
    ``world_group`` is the process group the mesh was made on (None: one
    process)."""

    data: int
    seq: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Any = None
    model_group: Any = None
    world_group: Any = None
    seq_rank: int = 0
    seq_group: Any = None
    seq_ranks: Tuple[int, ...] = (0,)
    data_seq_group: Any = None


def _axes(config: Optional[Dict[str, Any]]):
    par = (config or {}).get("parallel") or {}
    return (int(par.get("model_parallel", 1) or 1),
            int(par.get("seq_parallel", 1) or 1))


def make_mesh(config: Optional[Dict[str, Any]] = None) -> Mesh:
    """The mesh of the ranks for ``config['parallel']`` (``model_parallel``
    and ``seq_parallel``, default 1), registered as the current mesh under
    a process group (one process has nothing to register); the same one
    again while the process group and the sizes are the same."""
    model, seq = _axes(config)
    n = get_world_size()
    assert n % (model * seq) == 0, (
        f"{n} devices not divisible by model_parallel={model} "
        f"x seq_parallel={seq}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 0) or 0)
    if (model * seq) > 1 and n > 1 and local:
        assert local % (model * seq) == 0, (
            f"model_parallel={model} x seq_parallel={seq} must divide each "
            f"process's device count (got {local} ranks on this host): "
            "non-data mesh axes are host-local (per-host loaders shard "
            "batch rows, not the time axis)")
    mesh = pdist.current_mesh()
    world = dist.group.WORLD if dist.is_initialized() else None
    if mesh is not None and (mesh.data * mesh.model * mesh.seq, mesh.model,
                             mesh.seq) == (n, model, seq):
        return mesh
    rank, tile = get_rank(), model * seq
    data_group = model_group = seq_group = data_seq_group = None
    d_me, s_me, m_me = rank // tile, (rank // model) % seq, rank % model
    seq_ranks = tuple(d_me * tile + i * model + m_me for i in range(seq))
    if tile > 1:
        # every rank makes every group, in the same order
        for j in range(tile):
            g = dist.new_group(list(range(j, n, tile)))
            if rank % tile == j:
                data_group = g
        for d in range(n // tile):
            for i in range(seq):
                g = dist.new_group([d * tile + i * model + m
                                    for m in range(model)])
                if (d, i) == (d_me, s_me):
                    model_group = g
    if seq > 1:
        for d in range(n // tile):
            for m in range(model):
                g = dist.new_group([d * tile + i * model + m
                                    for i in range(seq)])
                if (d, m) == (d_me, m_me):
                    seq_group = g
        if model > 1:
            for m in range(model):
                g = dist.new_group(list(range(m, n, model)))
                if m == m_me:
                    data_seq_group = g
        else:
            data_seq_group = world
    mesh = Mesh(data=n // tile, seq=seq, model=model, data_rank=d_me,
                model_rank=m_me, data_group=data_group,
                model_group=model_group, world_group=world, seq_rank=s_me,
                seq_group=seq_group, seq_ranks=seq_ranks,
                data_seq_group=data_seq_group)
    if world is not None:
        pdist.set_mesh(mesh)
    return mesh


def data_parallel_size() -> int:
    """The number of data-parallel replicas: the ranks of the group over the
    model and seq axes."""
    return pdist.data_size()


def seq_parallel_size() -> int:
    """The size of the current mesh's seq axis (1 without a mesh)."""
    mesh = pdist.current_mesh()
    return 1 if mesh is None else mesh.seq


def host_shard_args(num_shards: int) -> Dict[str, int]:
    """The loader arguments by which this process materialises only its
    own data rank's slice of the ``num_shards`` data-parallel shards (one
    process: all of them); the JAX package's ``_host_shard_args``."""
    procs = pdist.data_size()
    assert num_shards % procs == 0, (
        f"data-parallel shards ({num_shards}) must divide evenly across "
        f"processes ({procs}); uneven splits would silently drop shards"
    )
    local = num_shards // procs
    return {"shard_offset": pdist.data_rank() * local, "local_shards": local}
