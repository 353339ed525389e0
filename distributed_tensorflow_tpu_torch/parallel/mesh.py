"""The named mesh of the port.

Counterpart of ``distributed_tensorflow_tpu/parallel/mesh.py``:
``AXIS_ORDER``, ``MeshConfig``, ``make_mesh``, ``data_parallel_mesh``,
``data_shards``, ``round_batch_to_mesh`` and ``local_batch_size``.  The
JAX mesh is a grid of devices with named axes; here it is a grid of the
ranks of a ``torch.distributed`` process group, one card (or CPU
process) a rank, laid out as ``np.asarray(devices).reshape(shape)`` lays
out the JAX package's devices: row-major over the axes in
``AXIS_ORDER``, so rank r sits at ``np.unravel_index(r, shape)``.

Each axis of more than one rank has one process group a line (the ranks
that differ only in that axis' coordinate), created by every rank in the
same order, as ``torch.distributed.new_group`` requires.  A collective
"over an axis" runs on this rank's line (``axis_group``).  A mesh of one
process without a process group has every axis of size 1 and no group.

``shard_pytree`` and the partition rules are ``parallel/sharding.py``'s.
``named_sharding``, ``replicated`` and ``logical_to_mesh`` return a
``Placement``: a spec holder (the mesh and the spec pruned to it) that
cuts a tensor into this rank's block, not a JAX sharding object (there
is no partitioner here to hand one to).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import sharding as sharding_lib

__all__ = ["AXIS_ORDER", "Mesh", "MeshConfig", "Placement", "make_mesh",
           "plan_mesh", "data_parallel_mesh", "data_shards",
           "logical_to_mesh", "named_sharding", "replicated",
           "round_batch_to_mesh", "local_batch_size"]

# Fixed major-to-minor order, the JAX package's: pipe outermost, then the
# data-like axes, tensor innermost.
AXIS_ORDER: Sequence[str] = ("pipe", "data", "fsdp", "expert", "seq",
                             "tensor")


class MeshConfig(dict):
    """{axis_name: size} with validation against the rank count."""

    def total(self) -> int:
        return math.prod(self.values()) if self else 1


class Mesh:
    """Named axes over the ranks of a process group.

    ``Mesh(size, rank, group)`` is the data-parallel mesh: one ``data``
    axis of ``size`` ranks, ``rank`` this process's place on it and
    ``group`` the process group (None for a single process without
    one).  ``make_mesh`` builds the named form.  On either, ``size``,
    ``rank`` and ``group`` are the whole mesh's: its rank count, this
    rank's place in it and the group spanning it (the one the train
    step's flat all-reduce runs over)."""

    def __init__(self, size: int = 1, rank: int = 0, group=None, *,
                 axes: Optional[Mapping[str, int]] = None,
                 lines: Optional[Mapping[str, object]] = None):
        if size < 1 or not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a mesh of {size}")
        self.size, self.rank, self.group = int(size), int(rank), group
        self._axes = dict(axes) if axes is not None else {"data": self.size}
        if math.prod(self._axes.values()) != self.size:
            raise ValueError(f"axes {self._axes} do not hold {size} ranks")
        idx = np.unravel_index(self.rank, tuple(self._axes.values()))
        self._coords = {a: int(i) for a, i in zip(self._axes, idx)}
        if lines is None:
            lines = {"data": group} if self.size > 1 else {}
        # {axis: the process group of this rank's line along it}
        self._lines = dict(lines)

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size} of the axes asked for, in ``AXIS_ORDER``."""
        return dict(self._axes)

    def axis_size(self, axis: str) -> int:
        """Ranks along ``axis`` (1 for an axis the mesh does not name)."""
        return self._axes.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 for an absent axis), the
        ``lax.axis_index`` of the JAX spelling."""
        return self._coords.get(axis, 0)

    def axis_group(self, axis: str):
        """The process group of this rank's line along ``axis`` (its group
        ranks are the axis indices); None when the axis has one rank."""
        return self._lines.get(axis)

    @property
    def data_index(self) -> int:
        """This rank's batch shard: its index over ``data`` x ``fsdp``
        (row-major), which picks its rows of a global batch; every rank
        of a ``seq`` line takes the same rows."""
        return (self.axis_index("data") * self.axis_size("fsdp")
                + self.axis_index("fsdp"))

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in self._axes.items())
        return f"Mesh({axes}, rank={self.rank})"


def plan_mesh(axes: Optional[Mapping[str, int]], n: int) -> Dict[str, int]:
    """The ``{axis: size}`` that ``make_mesh(axes)`` builds over ``n``
    ranks, in ``AXIS_ORDER``, with the JAX package's checks: at most one
    ``-1`` (it takes the ranks left over), the product equal to ``n``,
    names from ``AXIS_ORDER``.  None or empty puts every rank on
    ``data``."""
    axes = dict(axes) if axes else {"data": n}
    wildcard = [k for k, v in axes.items() if v == -1]
    if len(wildcard) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if wildcard:
        known = math.prod(v for v in axes.values() if v != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        axes[wildcard[0]] = n // known
    size = math.prod(axes.values())
    if size != n:
        raise ValueError(
            f"mesh axes {axes} require {size} devices, have {n}")
    unknown = set(axes) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; use {AXIS_ORDER}")
    return {a: int(axes[a]) for a in AXIS_ORDER if a in axes}


def make_mesh(axes: Optional[Mapping[str, int]] = None) -> Mesh:
    """A named mesh over every rank of the initialised process group (one
    rank, no group, when none was started).  ``axes`` as ``plan_mesh``
    takes them, so a ``seq`` axis larger than the world raises.  Every
    rank must call it, with the same axes, in the same order relative to
    its other group creations: it creates one group a line of each axis
    of more than one rank (a line spanning every rank reuses the world
    group)."""
    started = dist.is_initialized()
    n = dist.get_world_size() if started else 1
    rank = dist.get_rank() if started else 0
    shape = plan_mesh(axes, n)
    grid = np.arange(n).reshape(tuple(shape.values()))
    lines = {}
    for i, axis in enumerate(shape):
        if shape[axis] == 1:
            continue
        # each line along `axis`: move it last and walk the rest
        for line in np.moveaxis(grid, i, -1).reshape(-1, shape[axis]):
            ranks = [int(r) for r in line]
            group = (dist.group.WORLD if len(ranks) == n
                     else dist.new_group(ranks))
            if rank in ranks:
                lines[axis] = group
    return Mesh(n, rank, dist.group.WORLD if started else None, axes=shape,
                lines=lines)


def data_parallel_mesh() -> Mesh:
    """Every rank of the process group on the ``data`` axis; a mesh of one,
    with no group, when no process group was started."""
    if not dist.is_initialized():
        return Mesh()
    return Mesh(dist.get_world_size(), dist.get_rank(), dist.group.WORLD)


class Placement:
    """A spec holder: ``mesh`` and ``spec`` pruned to its axes, the port's
    stand-in for a ``NamedSharding`` (no partitioner places anything).
    ``block(t)`` is this rank's block of a whole tensor ``t`` (``t``
    itself when the spec keeps it whole), cut as ``parallel.sharding.
    block_of`` says."""

    def __init__(self, mesh: Mesh, spec=()):
        self.mesh = mesh
        self.spec = sharding_lib.prune_spec(tuple(spec), mesh)

    def block_of(self, shape):
        """(start, length) of this rank's block along each dim."""
        return sharding_lib.block_of(tuple(shape), self.spec, self.mesh)

    def block(self, t: torch.Tensor) -> torch.Tensor:
        return sharding_lib._cut(t, self.block_of(t.shape))

    def __eq__(self, other):
        return (isinstance(other, Placement) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self):
        return f"Placement({self.mesh}, spec={self.spec})"


def named_sharding(mesh: Mesh, *spec) -> Placement:
    """Shorthand: ``named_sharding(mesh, "tensor", None)``."""
    return Placement(mesh, spec)


def replicated(mesh: Mesh) -> Placement:
    """Every rank holds the whole tensor."""
    return Placement(mesh, ())


def logical_to_mesh(specs, mesh: Mesh):
    """A tree of specs (dicts of tuples) -> the same tree of
    ``Placement`` on ``mesh``."""
    if isinstance(specs, Mapping):
        return {k: logical_to_mesh(v, mesh) for k, v in specs.items()}
    return Placement(mesh, specs)


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
