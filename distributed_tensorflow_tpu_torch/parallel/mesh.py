"""The data-parallel mesh of the port.

Counterpart of the data-parallel part of
``distributed_tensorflow_tpu/parallel/mesh.py``: ``data_parallel_mesh``,
``data_shards``, ``round_batch_to_mesh`` and ``local_batch_size``.  The
JAX mesh is a grid of devices with named axes; here the one axis is
``data``, over the ranks of a ``torch.distributed`` process group, one
card (or CPU process) a rank.  The other axes (fsdp, tensor, seq, pipe,
expert) and ``make_mesh`` wait for the parallelism slice.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch.distributed as dist

__all__ = ["Mesh", "data_parallel_mesh", "data_shards",
           "round_batch_to_mesh", "local_batch_size"]


class Mesh:
    """One ``data`` axis of ``size`` ranks; ``rank`` is this process's
    place on it and ``group`` the process group the all-reduce runs over
    (None for a single process without one)."""

    def __init__(self, size: int = 1, rank: int = 0, group=None):
        if size < 1 or not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a mesh of {size}")
        self.size, self.rank, self.group = int(size), int(rank), group

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size}

    def __repr__(self):
        return f"Mesh(data={self.size}, rank={self.rank})"


def data_parallel_mesh() -> Mesh:
    """Every rank of the process group on the ``data`` axis; a mesh of one,
    with no group, when no process group was started."""
    if not dist.is_initialized():
        return Mesh()
    return Mesh(dist.get_world_size(), dist.get_rank(), dist.group.WORLD)


def data_shards(mesh: Mesh, axes: Sequence[str] = ("data", "fsdp")) -> int:
    """Number of ways the batch dim is split on this mesh."""
    shard = 1
    for a in axes:
        shard *= mesh.shape.get(a, 1)
    return shard


def round_batch_to_mesh(global_batch: int, mesh: Mesh,
                        axes: Sequence[str] = ("data", "fsdp")) -> int:
    """Smallest batch >= global_batch divisible by the mesh's data shards
    (the reference's batch of 50 does not shard over 4 ranks: 52)."""
    shard = data_shards(mesh, axes)
    return -(-global_batch // shard) * shard


def local_batch_size(global_batch: int, mesh: Mesh,
                     axes: Sequence[str] = ("data", "fsdp")) -> int:
    """Per-rank batch share of a global batch."""
    shard = data_shards(mesh, axes)
    if global_batch % shard:
        raise ValueError(
            f"global batch {global_batch} not divisible by data shards "
            f"{shard}")
    return global_batch // shard
