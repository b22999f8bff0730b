"""The data-parallel layout (counterpart of
``semi_seg_ecg_tpu/parallel/mesh.py``).

The JAX package builds a ``(data, seq, model)`` device mesh and makes the
data axis of every device the other two do not take; every shipped recipe
says ``parallel: {model_parallel: 1}``, so the mesh is pure data
parallelism. Here the data axis is the process group: one rank per GPU,
``data_parallel_size()`` ranks, each loading and computing its own shards
of every global batch. ``model_parallel`` and ``seq_parallel`` above 1 are
refused by the trainer (``algorithms/common.py``).
"""

from __future__ import annotations

from typing import Dict

from .dist import get_rank, get_world_size


def data_parallel_size() -> int:
    """The number of data-parallel replicas: the ranks of the group."""
    return get_world_size()


def host_shard_args(num_shards: int) -> Dict[str, int]:
    """The loader arguments by which this process materialises only its
    own slice of the ``num_shards`` data-parallel shards (one process:
    all of them); the JAX package's ``_host_shard_args``."""
    procs = get_world_size()
    assert num_shards % procs == 0, (
        f"data-parallel shards ({num_shards}) must divide evenly across "
        f"processes ({procs}); uneven splits would silently drop shards"
    )
    local = num_shards // procs
    return {"shard_offset": get_rank() * local, "local_shards": local}
