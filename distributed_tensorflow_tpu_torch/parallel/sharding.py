"""Partition rules and the ZeRO layout of the port.

Counterpart of ``distributed_tensorflow_tpu/parallel/sharding.py``: a rule
table maps parameter paths (regexes, first match wins) to specs over the
mesh's named axes, and one table serves every mesh, since an axis the
mesh does not name degrades to replicated (``prune_spec``).  A spec is a
tuple with one entry per dim: an axis name, a tuple of names (the first
one major) or None.  ``PartitionRules``, ``prune_spec``, ``tree_paths``
and ``shard_pytree`` take the port's flat ``{name: tensor}`` dicts (or
nested dicts, whose ``/``-joined keys are the paths).

The JAX package hands a spec to its partitioner, which places the blocks
on the devices.  Here every rank holds its own block of each leaf:
``shard_pytree`` cuts it (``block_of`` says which), dim by dim, as
``NamedSharding(mesh, spec).devices_indices_map(shape)`` cuts it for
the device at this rank's place in the mesh.  A dim that its axes do not
divide raises ``ValueError``, as the JAX package's ``device_put`` does.

Only ``data`` and ``fsdp`` may be larger than 1 here.  A ``tensor`` or
``expert`` axis of more than one rank raises ``NotImplementedError``
(ROADMAP Queue 1 item 7.2: tensor parallelism needs the column- and
row-parallel collectives inside each model), as does a ``pipe`` axis
(item 7.3, the pipeline) and a ``seq`` axis beside a cut (item 7.5).
``named_sharding``, ``replicated`` and ``logical_to_mesh`` return JAX
sharding objects, which have no torch counterpart: they come with item
7.2.

The ZeRO layout (``train.shard_train_state``): a leaf cut along one dim
over the ``fsdp`` line (``Shard``: the dim, this rank's start and length,
the dim's full size, the line) or kept whole (None).  A ``ShardedDict``
is a params-shaped dict of this rank's blocks with that layout beside it
(``layout``, ``mesh``, and for the parameters themselves ``full``: the
model's own tensors, which the train step gathers the blocks into).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, \
    Sequence, Tuple

import torch

__all__ = ["PartitionRules", "Shard", "ShardedDict", "block_of",
           "check_zero_mesh", "prune_spec", "shard_pytree",
           "tree_paths", "zero_shard"]

Spec = Tuple[Any, ...]
Rules = Sequence[Tuple[str, Spec]]

# the ROADMAP item that ports each axis the port cannot cut over yet
_UNPORTED = {"tensor": "7.2 (tensor parallelism)",
             "expert": "7.2 (tensor parallelism)",
             "pipe": "7.3 (the pipeline)",
             "seq": "7.5 (ZeRO beside a seq axis)"}


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def prune_spec(spec: Spec, mesh) -> Spec:
    """Drop axis names the mesh does not have (that dim replicates): one
    table serves every mesh, ``(None, "fsdp", "tensor")`` on a data-only
    mesh degrades to ``(None, None, None)``."""
    names = set(mesh.shape)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, str):
            return entry if entry in names else None
        kept = tuple(a for a in entry if a in names)
        return kept if kept else None

    return tuple(keep(e) for e in spec)


def _leaves(tree, prefix: str = ""):
    """(path, leaf) in the JAX flatten order: dict keys sorted, nested
    dicts joined with ``/``."""
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _leaves(val, path + "/")
        else:
            yield path, val


def tree_paths(tree) -> List[str]:
    """``/``-joined dict-key paths of every leaf, in flatten order."""
    return [p for p, _ in _leaves(tree)]


class PartitionRules:
    """Ordered (regex, spec) table; the first match wins, no match
    replicates (``()``)."""

    def __init__(self, rules: Rules):
        self.rules = [(re.compile(pat), tuple(spec)) for pat, spec in rules]

    def spec_for(self, path: str) -> Spec:
        for pat, spec in self.rules:
            if pat.search(path):
                return spec
        return ()

    def tree_specs(self, params) -> Dict[str, Any]:
        """A dict of the same structure holding each leaf's spec."""
        def walk(tree, prefix):
            return {k: (walk(v, f"{prefix}{k}/") if isinstance(v, Mapping)
                        else self.spec_for(f"{prefix}{k}"))
                    for k, v in tree.items()}
        return walk(params, "")


def _refuse(mesh, axes, what: str) -> None:
    """Raise for an axis of ``axes`` larger than 1 on ``mesh`` that the
    port cannot cut over yet."""
    for a in axes:
        if a in _UNPORTED and mesh.axis_size(a) > 1:
            raise NotImplementedError(
                f"{what} with a {a!r} axis of {mesh.axis_size(a)} ranks: "
                f"only 'data' and 'fsdp' are ported (ROADMAP Queue 1 item "
                f"{_UNPORTED[a]})")


def check_zero_mesh(mesh) -> None:
    """Raise unless every axis of ``mesh`` larger than 1 is ``data`` or
    ``fsdp``, the axes a ZeRO layout runs over."""
    _refuse(mesh, mesh.shape, "a ZeRO layout")


def block_of(shape: Sequence[int], spec: Spec, mesh
             ) -> List[Tuple[int, int]]:
    """(start, length) along each dim of this rank's block of a leaf of
    ``shape`` under ``spec`` (pruned to ``mesh``): a dim named by axes of
    n ranks in all splits into n equal parts, and this rank takes the one
    at its row-major index over those axes (the first axis major; a
    ``parallel.Mesh(n, r, None, axes=...)`` is rank r without a group).
    Raises ``ValueError`` when n does not divide the dim,
    as the JAX package's ``device_put`` does."""
    spec = prune_spec(spec, mesh)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the leaf's "
                         f"{len(shape)} dims")
    _refuse(mesh, [a for e in spec for a in _names(e)], f"spec {spec}")
    out = []
    for d, size in enumerate(shape):
        axes = _names(spec[d]) if d < len(spec) else ()
        n, idx = 1, 0
        for a in axes:
            idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
            n *= mesh.axis_size(a)
        if size % n:
            raise ValueError(
                f"the spec {spec} implies that the global size of dim {d} "
                f"should be divisible by {n}, but it is {size} (full "
                f"shape: {tuple(shape)})")
        out.append((idx * (size // n), size // n))
    return out


def _cut(t: torch.Tensor, block) -> torch.Tensor:
    """``t``'s block as a contiguous tensor of its own (``t`` itself when
    the block is the whole leaf)."""
    if all(length == size for (_, length), size in zip(block, t.shape)):
        return t
    view = t
    for d, (start, length) in enumerate(block):
        view = view.narrow(d, start, length)
    return view.detach().clone(memory_format=torch.contiguous_format)


def shard_pytree(params, mesh, rules: PartitionRules):
    """This rank's block of every leaf of ``params`` (a dict of tensors,
    flat or nested) under the rule table: each a contiguous tensor of its
    own, or the leaf itself where the spec keeps it whole."""
    def place(tree, prefix):
        return {k: (place(v, f"{prefix}{k}/") if isinstance(v, Mapping)
                    else _cut(v, block_of(v.shape,
                                          rules.spec_for(f"{prefix}{k}"),
                                          mesh)))
                for k, v in tree.items()}
    return place(params, "")


class Shard(NamedTuple):
    """A leaf cut along ``dim`` over the ``line`` axis: this rank holds
    ``[start, start + length)`` of the dim's ``size``."""
    dim: int
    start: int
    length: int
    size: int
    line: str = "fsdp"

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf ``t``, as a contiguous
        tensor of its own."""
        return t.detach().narrow(self.dim, self.start, self.length).clone(
            memory_format=torch.contiguous_format)

    def full_shape(self, shard_shape: Sequence[int]) -> Tuple[int, ...]:
        shape = list(shard_shape)
        shape[self.dim] = self.size
        return tuple(shape)


def zero_shard(shape: Sequence[int], spec: Spec, mesh) -> Optional[Shard]:
    """The ZeRO layout of a leaf: None when ``spec`` keeps it whole on
    ``mesh``, else its ``Shard``.  Raises ``NotImplementedError`` for a
    cut the ZeRO step cannot gather (over ``data``, or along two dims)."""
    block = block_of(shape, spec, mesh)
    cut = [d for d, ((_, n), size) in enumerate(zip(block, shape))
           if n != size]
    if not cut:
        return None
    spec = prune_spec(spec, mesh)
    if len(cut) > 1 or _names(spec[cut[0]]) != ("fsdp",):
        raise NotImplementedError(
            f"spec {spec} cuts a leaf of shape {tuple(shape)} "
            f"{'along two dims' if len(cut) > 1 else 'over data'}: the "
            f"ZeRO step gathers along one dim over the 'fsdp' line only")
    d = cut[0]
    start, length = block[d]
    return Shard(d, start, length, int(shape[d]))


class ShardedDict(dict):
    """A params-shaped dict of this rank's blocks (see the module
    docstring): ``layout`` {name: ``Shard`` or None}, ``mesh``, and
    ``full`` (the parameters' own tensors) for the parameters, None for
    a shard of optimizer state."""

    def __init__(self, items, layout: Mapping[str, Optional[Shard]],
                 mesh, full: Optional[Mapping[str, torch.Tensor]] = None):
        super().__init__(items)
        self.layout = dict(layout)
        self.mesh = mesh
        self.full = full

    @property
    def cut(self) -> bool:
        """Whether any leaf is cut (never on a line of one rank)."""
        return any(s is not None for s in self.layout.values())

