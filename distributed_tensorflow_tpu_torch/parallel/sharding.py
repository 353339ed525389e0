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

The axes a leaf may be cut over are ``data``, ``fsdp``, ``tensor``,
``expert`` (a MoE bank's leading expert dim, ``ops/moe.py``) and ``pipe``
(a stacked leaf's leading stage dim, ``parallel/pipeline.py``); a ``seq``
axis cuts activations, never a leaf.  These raise
``NotImplementedError``, each naming its ROADMAP Queue 1 item: a ``seq``
axis beside ``fsdp`` (item 7.5, with or without a ``tensor`` axis),
``expert`` beside ``fsdp`` (7.2c) or ``seq`` (7.2d), and ``pipe`` beside
``fsdp``, ``tensor``, ``seq`` or ``expert`` (items 7.3a-d): a pipeline
runs beside ``data`` alone, as the JAX package's ``examples/train_gpt.py``
runs it.  ``tensor`` runs beside ``data``, ``fsdp`` and ``seq`` (the JAX
package's multi-chip mesh ``{"data": 2, "seq": 2, "tensor": 2}``: a
rank's tensor blocks, its heads inside the ring of its seq line);
``expert`` beside ``data`` and ``tensor``.  ``parallel/mesh.py`` holds
``named_sharding``, ``replicated`` and ``logical_to_mesh``.

The layouts of ``train.shard_train_state``: a leaf cut along one dim over
one line (``Shard``: the dim, this rank's start and length, the dim's
full size, the line: ``fsdp`` for ZeRO, ``tensor`` for tensor
parallelism, ``expert`` for a MoE bank's experts), along two dims over
the ``expert`` and the ``tensor`` line or over the ``fsdp`` and the
``tensor`` line (``Blocks``, one ``Shard`` a dim, each with its start in
the whole leaf: a bank's ``w_in`` on ``{"expert": X, "tensor": T}``; a
query kernel [d, h, hd] on ``{"fsdp": F, "tensor": T}``, dim 0 over
``fsdp`` and dim 1 over ``tensor``) or kept whole (None).  A
``ShardedDict`` is a params-shaped dict of this rank's blocks with that
layout beside it (``layout``, ``mesh``, and for the parameters
themselves ``full``: under ZeRO the model's own whole tensors, which the
train step gathers the blocks into; under tensor parallelism the blocks
themselves, which the model computes on; under ``fsdp`` x ``tensor`` the
model's tensor blocks and whole leaves, which the step gathers the
``fsdp`` parts into).  A tensor-parallel model keeps its blocks as its
parameters, each marked with its ``Shard`` (``mark_block``), so the
placement knows a block from a whole leaf.

A pipeline stage's layers (``GPT(config, mesh=)`` with
``pipeline_stages``) are whole leaves that only the ranks of one stage
hold: the model keeps its stage's layers under their global names, each
marked with its ``Stage`` (the layer, the layer count, the stage, the
line), and a rule table with ``stages`` says which stage holds each
layer (``PartitionRules.stage_for``; ``shard_pytree`` keeps this rank's
stage's layers only).  Their layout is the ``Stage``: a ``ShardedDict``
over ``pipe`` gathers them over the line into the whole model
(``parallel.data_parallel.gather_stages``), sums their squares over it
for the global norm, and writes each stage's layers once into a sharded
checkpoint.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, \
    Sequence, Tuple

import torch

__all__ = ["Blocks", "PartitionRules", "Shard", "ShardedDict", "Stage",
           "block_of", "check_mesh", "cut_blocks", "lines_of", "mark_block",
           "marked_shard", "part_on", "prune_spec", "shard_pytree",
           "tree_paths", "without", "zero_shard"]

Spec = Tuple[Any, ...]
Rules = Sequence[Tuple[str, Spec]]

# the axes that may not be larger than 1 beside an axis of more than 1,
# each with the ROADMAP Queue 1 item that ports the pair: beside a pipe or
# a seq axis whatever a spec cuts, beside an expert axis where a spec
# cuts over it
_BESIDE = {"pipe": {"fsdp": "7.3a (pipe beside fsdp)",
                    "tensor": "7.3b (pipe beside tensor)",
                    "seq": "7.3c (pipe beside seq)",
                    "expert": "7.3d (pipe beside expert)"},
           "seq": {"fsdp": "7.5 (ZeRO beside a seq axis)"},
           "expert": {"fsdp": "7.2c (expert beside fsdp)",
                      "seq": "7.2d (expert beside seq)"}}


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


class Stage(NamedTuple):
    """A whole leaf of layer ``layer`` (of ``layers``) that only the ranks
    of pipeline stage ``stage`` on the ``line`` axis hold."""
    layer: int
    layers: int
    stage: int
    line: str = "pipe"


class PartitionRules:
    """Ordered (regex, spec) table; the first match wins, no match
    replicates (``()``).  ``stages``: ``(pattern, layers, stages, axis)``
    for a pipelined stack, the pattern's first group a path's layer
    index: layer ``i`` of ``layers`` lives on stage ``i // (layers /
    stages)`` of ``axis``, as the JAX package's rules put ``axis`` on the
    stacked leaves' leading layer dim."""

    def __init__(self, rules: Rules, stages=None):
        self.rules = [(re.compile(pat), tuple(spec)) for pat, spec in rules]
        self.stages = None
        if stages is not None:
            pat, layers, n, axis = stages
            self.stages = (re.compile(pat), int(layers), int(n), axis)

    def stage_for(self, path: str) -> Optional[Stage]:
        """The ``Stage`` of a pipelined layer's leaf, None for any other
        path (or without ``stages``)."""
        if self.stages is None:
            return None
        pat, layers, n, axis = self.stages
        m = pat.search(path)
        if m is None:
            return None
        layer = int(m.group(1))
        return Stage(layer, layers, layer // (layers // n), axis)

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
    """Raise for a ``pipe`` or a ``seq`` axis beside an axis it cannot run
    beside, and for an ``expert`` axis (named in ``axes``) likewise."""
    for axis, table in _BESIDE.items():
        if mesh.axis_size(axis) == 1 or (axis == "expert"
                                         and axis not in axes):
            continue
        for a, item in table.items():
            if mesh.axis_size(a) > 1:
                raise NotImplementedError(
                    f"{what}: a {axis!r} axis of {mesh.axis_size(axis)} "
                    f"ranks beside a {a!r} axis of {mesh.axis_size(a)}: "
                    f"not ported (ROADMAP Queue 1 item {item})")


def check_mesh(mesh) -> None:
    """Raise unless every axis of ``mesh`` larger than 1 is ``data``,
    ``fsdp``, ``tensor``, ``expert``, ``pipe`` or ``seq``, ``seq`` is not
    beside ``fsdp``, ``expert`` is beside neither ``fsdp`` nor ``seq``,
    and ``pipe`` is beside ``data`` alone: the layouts
    ``train.shard_train_state`` places."""
    _refuse(mesh, mesh.shape, "a sharded layout")


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


def _on_this_stage(path: str, rules: PartitionRules, mesh) -> bool:
    """Whether this rank holds ``path``: every leaf but a pipelined
    layer's, which only its stage's ranks hold (on a ``pipe`` line of
    more than one rank, whose size must be the rules' stage count)."""
    stage = rules.stage_for(path)
    if stage is None or mesh.axis_size(stage.line) == 1:
        return True
    n = rules.stages[2]
    if mesh.axis_size(stage.line) != n:
        raise ValueError(f"rules for {n} pipeline stages over a "
                         f"{stage.line!r} axis of "
                         f"{mesh.axis_size(stage.line)} ranks")
    return stage.stage == mesh.axis_index(stage.line)


def shard_pytree(params, mesh, rules: PartitionRules):
    """This rank's block of every leaf of ``params`` (a dict of tensors,
    flat or nested) under the rule table: each a contiguous tensor of its
    own, or the leaf itself where the spec keeps it whole; a pipelined
    layer's leaves only on the ranks of its stage (``_on_this_stage``)."""
    def place(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}{k}"
            if isinstance(v, Mapping):
                out[k] = place(v, path + "/")
            elif _on_this_stage(path, rules, mesh):
                out[k] = _cut(v, block_of(v.shape, rules.spec_for(path),
                                          mesh))
        return out
    return place(params, "")


class Shard(NamedTuple):
    """A leaf cut along ``dim`` over the ``line`` axis: this rank holds
    ``[start, start + length)`` of the dim's ``size``.  (A pipeline
    stage's layer is a ``Stage``, not a cut.)"""
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

    @property
    def parts(self) -> Tuple["Shard", ...]:
        return (self,)


class Blocks(NamedTuple):
    """A leaf cut along several dims, each over its own line: ``parts``
    holds one ``Shard`` a dim, in dim order (a MoE bank's ``w_in`` [E, D,
    F] on ``{"expert": X, "tensor": T}``: dim 0 over ``expert``, dim 2
    over ``tensor``; a FFN's ``w_in`` [d, f] on ``{"fsdp": F, "tensor":
    T}``: dim 0 over ``fsdp``, dim 1 over ``tensor``)."""
    parts: Tuple[Shard, ...]

    @property
    def line(self) -> str:
        return "+".join(p.line for p in self.parts)

    def take(self, t: torch.Tensor) -> torch.Tensor:
        view = t.detach()
        for p in self.parts:
            view = view.narrow(p.dim, p.start, p.length)
        return view.clone(memory_format=torch.contiguous_format)

    def full_shape(self, shard_shape: Sequence[int]) -> Tuple[int, ...]:
        for p in self.parts:
            shard_shape = p.full_shape(shard_shape)
        return tuple(shard_shape)


def lines_of(s) -> Tuple[str, ...]:
    """The lines a layout entry is cut over (``()`` for a whole leaf)."""
    if s is None:
        return ()
    if isinstance(s, Stage):
        return (s.line,)
    return tuple(p.line for p in s.parts)


def part_on(s, line: str) -> Optional[Shard]:
    """The ``Shard`` of a layout entry over ``line``, None when ``line``
    does not cut it."""
    if s is None or isinstance(s, Stage):
        return None
    return next((p for p in s.parts if p.line == line), None)


def without(s, line: str):
    """A layout entry less its part over ``line``: the block it is a part
    of (a ``Blocks`` over ``fsdp`` and ``tensor`` less ``fsdp`` is its
    tensor ``Shard``; a ZeRO ``Shard`` less ``fsdp`` is None, the whole
    leaf)."""
    if part_on(s, line) is None:
        return s
    rest = tuple(p for p in s.parts if p.line != line)
    return None if not rest else rest[0] if len(rest) == 1 else Blocks(rest)


def zero_shard(shape: Sequence[int], spec: Spec, mesh):
    """The layout of a leaf: None when ``spec`` keeps it whole on ``mesh``,
    else its ``Shard`` over the one axis that cuts it (``fsdp``: a ZeRO
    block; ``tensor``: a tensor-parallel block; ``expert``: a MoE bank's
    experts), or its ``Blocks`` when the ``tensor`` line cuts one dim
    and the ``expert`` or the ``fsdp`` line another.  Raises
    ``NotImplementedError`` for a cut the step cannot run (over
    ``data``, over two axes on one dim, or along two dims other than
    those pairs)."""
    block = block_of(shape, spec, mesh)
    cut = [d for d, ((_, n), size) in enumerate(zip(block, shape))
           if n != size]
    if not cut:
        return None
    spec = prune_spec(spec, mesh)
    names = [[a for a in _names(spec[d]) if mesh.axis_size(a) > 1]
             for d in cut]
    lines = [n[0] if len(n) == 1 else None for n in names]
    ok = (lines[0] in ("fsdp", "tensor", "expert") if len(cut) == 1
          else sorted(lines, key=str) in (["expert", "tensor"],
                                          ["fsdp", "tensor"]))
    if not ok:
        how = ("along dims " + ", ".join(map(str, cut)) if len(cut) > 1
               else "over " + ", ".join(names[0]))
        raise NotImplementedError(
            f"spec {spec} cuts a leaf of shape {tuple(shape)} {how}: a "
            f"step cuts along one dim over the 'fsdp', 'tensor' or "
            f"'expert' line, or along two over 'tensor' and 'expert' or "
            f"'fsdp' (ROADMAP Queue 1 item 7.2b)")
    parts = tuple(Shard(d, block[d][0], block[d][1], int(shape[d]), line)
                  for d, line in zip(cut, lines))
    return parts[0] if len(parts) == 1 else Blocks(parts)


def mark_block(t: torch.Tensor, shard) -> torch.Tensor:
    """Mark ``t`` as this rank's block ``shard`` of a whole leaf (a
    tensor-parallel model's parameter), or as a pipeline stage's layer
    (a ``Stage``); returns ``t``."""
    t.block_shard = shard
    return t


def marked_shard(t: torch.Tensor):
    """The ``Shard`` or ``Stage`` ``mark_block`` gave ``t``, or None for a
    whole leaf that every rank holds."""
    return getattr(t, "block_shard", None)


def cut_blocks(params: Mapping[str, torch.Tensor], rules: "PartitionRules",
               mesh) -> Dict[str, torch.Tensor]:
    """{name: this rank's block} of whole ``params`` over ``mesh``'s
    ``tensor`` and ``expert`` axes: each cut leaf a contiguous copy marked
    with its ``Shard`` or ``Blocks`` (``requires_grad`` as its leaf), each
    uncut one the leaf itself.  A dim its line does not divide raises
    ``ValueError``."""
    check_mesh(mesh)
    out = {}
    for name, p in params.items():
        s = zero_shard(tuple(p.shape), rules.spec_for(name), mesh)
        if s is None:
            out[name] = p
            continue
        block = s.take(p).requires_grad_(p.requires_grad)
        out[name] = mark_block(block, s)
    return out


class ShardedDict(dict):
    """A params-shaped dict of this rank's blocks (see the module
    docstring): ``layout`` {name: ``Shard`` or None}, ``mesh``, and
    ``full`` for the parameters (under ZeRO the whole tensors, under
    tensor parallelism the blocks themselves), None for a shard of
    optimizer state."""

    def __init__(self, items, layout: Mapping[str, Optional[Shard]],
                 mesh, full: Optional[Mapping[str, torch.Tensor]] = None):
        super().__init__(items)
        self.layout = dict(layout)
        self.mesh = mesh
        self.full = full

    @property
    def cut(self) -> bool:
        """Whether any leaf is cut, or a stage's layer (never on lines of
        one rank)."""
        return any(s is not None for s in self.layout.values())

    @property
    def line(self) -> Optional[str]:
        """The axis the cut leaves are cut over (``fsdp``, ``tensor``,
        ``expert`` or ``pipe`` for a pipeline stage's layers), the lines
        joined by ``+`` in name order when several cut leaves
        (``"expert+tensor"``, ``"fsdp+tensor"``), None when nothing is
        cut."""
        lines = sorted({a for s in self.layout.values()
                        for a in lines_of(s)})
        return "+".join(lines) if lines else None
