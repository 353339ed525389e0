"""Synchronous data parallelism: the gradient all-reduce.

Counterpart of ``distributed_tensorflow_tpu/parallel/data_parallel.py``
(``make_psum_train_step``): each rank computes the mean gradients of its
shard of the global batch; ONE all-reduce (``torch.distributed``, NCCL on
the cards, gloo on the CPU) of a flat f32 bucket holding every gradient,
the loss and the metrics sums them, and a division by the rank count
makes the mean, the ``lax.pmean`` of the JAX spelling.  Every rank then
applies the same update, so the parameters stay equal without a
parameter server.  With equal shards the mean of the ranks' means is the
global batch's mean.

In the port the JAX package's two spellings, ``make_train_step(mesh=
...)`` and ``make_psum_train_step``, are one path, the first:
``train/step.py`` calls ``all_reduce_mean`` when its mesh has a process
group, and ``make_psum_train_step`` is a name for it.

The ranks that average are the replicas: on a mesh with a ``tensor``,
an ``expert`` or a ``pipe`` axis of more than one rank, the ranks of
this rank's ``data`` x ``fsdp`` x ``seq`` grid (those that share its
``tensor``, ``expert`` and ``pipe`` coordinates and so hold the same
blocks, experts or stage), never the whole mesh, whose sum would add
blocks or layers of different ranks (and divide an expert's gradient by
the expert line's size).  The ranks of a ``seq`` line hold the same
blocks and compute on different positions of the same rows, and the
sequence ops scale their gradients for a mean over the line (below), so
the line is a replica line as the ``data`` line is.  No one group spans
that grid, so a sum over it is an all-reduce over this rank's ``fsdp``
line, then its ``seq`` line, then its ``data`` line; a line of one
issues none (``replicas``).

Weighted losses: a loss function that reports ``metrics["loss_weight"]``
(a masked mean's normaliser, such as the token or mask count) is a
weighted mean, and the global batch's is ``sum_d w_d L_d / sum_d w_d``,
not the mean of the ranks' means, which differs as soon as the ranks'
mask counts do.  So each rank's gradients, loss and metrics go into the
bucket times its weight, the weight itself rides along, and the sums are
divided by the summed weight: the exact global-batch mean, as the JAX
step computes it on the whole batch.

Sequence parallelism (a mesh with a ``seq`` axis of R ranks) needs
nothing of its own here: the ops that cross between a rank's sequence
shard and what the line holds alike scale their gradients by R
(``parallel/ring.py``), so every rank's gradient is R times the line's
on the shard's part and the line's whole after a gather, and a model
reports its share of the line's weight (``ring.weight_share``).  The
plain (or weighted) mean over all the mesh's ranks is then the global
batch's, for a loss on the shards' sums and a loss on a gathered output
alike.

ZeRO over the ``fsdp`` axis (a state placed by ``train.
shard_train_state``; the layout is ``parallel/sharding.py``'s): each rank
holds its block of the cut leaves, and the step issues, over this rank's
``fsdp`` line, ONE ``all_gather_into_tensor`` of a flat bucket of its
parameter blocks (``gather_shards``, which writes the whole leaves back
along each leaf's own dim) and ONE ``reduce_scatter_tensor`` of a flat
gradient bucket laid out rank-major (``reduce_scatter_mean``: segment r
holds every cut gradient's block r, ``narrow(dim, start, length)``, and
the whole of the uncut gradients, the loss, the metrics and the weight,
so the scatter leaves each rank the line's sums of its own blocks and of
all the rest); then, with a ``data`` axis of more than one rank, ONE
all-reduce of that segment over this rank's ``data`` line, and the
division by the summed weight or the replica count (``data`` x
``fsdp``), as above.  The global gradient norm and the count of
non-finite elements sum the blocks' squares and counts over the
``fsdp`` line (``line_sum``, one all-reduce of two numbers) and count
each uncut leaf once.  Beside a ``tensor`` axis the same two collectives
act on the ``fsdp`` part of each tensor block (a ``Blocks`` over
``fsdp`` and ``tensor``): the gather joins the parts into the model's
tensor blocks, the scatter cuts each block's gradient along its ``fsdp``
dim, and a leaf that only ``tensor`` cuts rides whole in every segment,
as an uncut leaf does, so it is summed over the ``fsdp`` line and then
the ``data`` line; nothing is summed over ``tensor``.

A pipeline stage's layers (``parallel.sharding.Stage``) gather into the
whole model over the ``pipe`` line with ONE ``all_gather_into_tensor``
(``gather_stages``), for eval and ``generate`` on a whole model; a MoE
bank's expert blocks gather whole over the ``expert`` line as ZeRO's
blocks do over ``fsdp`` (``gather_shards(axis="expert")``).

The statistics of the global batch that a forward needs (a training
``BatchNorm``'s moments, a MoE layer's router load) are sums over the
batch line (``batch_group``: the replicas of the mesh the train step
enters with ``cross_rank_moments``), through ``batch_sum``, an
all-reduce whose backward sums the ranks' gradients.

``LAUNCHES`` counts the collectives issued by kind: ``all_reduce``,
``all_gather``, ``reduce_scatter``, ``stats_all_reduce`` and
``batch_all_reduce`` (``batch_sum``, forward and backward), and those of
``parallel/tensor_parallel.py`` as ``tp_all_reduce`` and
``tp_all_gather`` on the tensor line, ``ep_all_reduce`` and
``ep_all_gather`` on the expert line.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import math
import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["LAUNCHES", "all_reduce_mean", "batch_group", "batch_sum",
           "cross_rank_moments", "gather_shards", "gather_stages",
           "line_sum", "make_psum_train_step", "reduce_scatter_mean",
           "replicas"]

LAUNCHES: collections.Counter = collections.Counter()


def _flat(parts: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in parts])


def _unflat(flat: torch.Tensor, like: List[torch.Tensor]
            ) -> List[torch.Tensor]:
    out, lo = [], 0
    for t in like:
        out.append(flat[lo:lo + t.numel()].view(t.shape).to(t.dtype))
        lo += t.numel()
    return out


def replicas(mesh) -> Tuple[Tuple[object, ...], int]:
    """(the process groups the gradients sum over, one after the other;
    the replica count): the whole mesh's group, or under a ``tensor``,
    ``expert`` or ``pipe`` axis of more than one rank this rank's
    ``fsdp`` line, its ``seq`` line and then its ``data`` line (the lines
    of more than one rank; none on a grid of one)."""
    if any(mesh.axis_size(a) > 1 for a in ("tensor", "expert", "pipe")):
        lines = ("fsdp", "seq", "data")
        groups = tuple(g for g in map(mesh.axis_group, lines)
                       if g is not None)
        return groups, math.prod(mesh.axis_size(a) for a in lines)
    return (() if mesh.group is None else (mesh.group,)), mesh.size


# the mesh of the train step whose loss function runs (None outside one)
_STEP_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "step_mesh", default=None)


@contextlib.contextmanager
def cross_rank_moments(mesh):
    """Within the block, ``batch_group()`` is ``mesh``'s batch line: the
    train step enters it around its loss function on a mesh of more than
    one rank, so that a training ``BatchNorm`` takes the moments of the
    global batch and a MoE GPT its router statistics."""
    token = _STEP_MESH.set(mesh)
    try:
        yield
    finally:
        _STEP_MESH.reset(token)


def batch_group(mesh=None):
    """The process groups of the ranks that hold the rest of this rank's
    batch (its other rows, and on a ``seq`` line its other positions), a
    tuple summed over one after the other: ``mesh``'s
    replicas (``replicas``), by default those of the mesh the running
    train step entered (``cross_rank_moments``); None outside a step and
    for a plane of one.  A model reads it once, as its forward starts,
    and passes it down: a recomputation in the backward (``remat``) runs
    outside the step's block."""
    mesh = _STEP_MESH.get() if mesh is None else mesh
    return None if mesh is None else (replicas(mesh)[0] or None)


class _BatchSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks of ``groups`` (one all-reduce a
    group), and in the backward the sum of the ranks' gradients; each
    all-reduce counts one ``batch_all_reduce``.
    ``torch.distributed.nn.functional.all_reduce`` computes the same, but
    importing that module keeps every gloo group's threads alive past
    ``destroy_process_group``, and a rank then aborts at exit now and
    then."""

    @staticmethod
    def forward(ctx, groups, x):
        ctx.groups = groups
        x = x.clone(memory_format=torch.contiguous_format)
        for group in groups:
            dist.all_reduce(x, group=group)
            LAUNCHES["batch_all_reduce"] += 1
        return x

    @staticmethod
    def backward(ctx, grad):
        return None, _BatchSum.apply(ctx.groups, grad)


def batch_sum(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed over the batch line's ``groups`` (``batch_group``),
    ``x`` itself for None; differentiable: the backward sums the ranks'
    gradients, so a statistic of the global batch trains as one."""
    return x if groups is None else _BatchSum.apply(tuple(groups), x)


def all_reduce_mean(grads: Mapping[str, torch.Tensor], loss: torch.Tensor,
                    metrics: Mapping[str, torch.Tensor], mesh,
                    weight: Optional[torch.Tensor] = None
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                               Dict[str, torch.Tensor]]:
    """(grads, loss, metrics), each the global batch's mean over the
    replicas of ``mesh`` (``replicas``), with one all-reduce of a flat f32
    bucket a group (the ``fsdp``, the ``seq`` and the ``data`` line, beside
    a ``tensor`` axis); every tensor comes back in its own shape and dtype.
    ``weight``: this rank's loss weight (module docstring), None for a
    plain mean; with it, ``metrics["loss_weight"]`` comes back as the
    global weight.  A tensor-parallel mesh's plane of one issues nothing
    and changes nothing."""
    groups, n = replicas(mesh)
    if not groups:
        metrics = dict(metrics)
        if weight is not None:
            metrics["loss_weight"] = weight
        return dict(grads), loss, metrics
    names = list(grads)
    keys = list(metrics)
    parts = ([grads[n] for n in names] + [loss]
             + [metrics[k] for k in keys])
    flat = _flat(parts)
    if weight is not None:
        w = weight.reshape(1).float()
        flat = torch.cat([flat * w, w])
    for group in groups:
        dist.all_reduce(flat, group=group)
        LAUNCHES["all_reduce"] += 1
    if weight is None:
        total = flat.new_full((1,), float(n))
    else:
        total, flat = torch.clamp(flat[-1:], min=1e-9), flat[:-1]
    out = _unflat(flat / total, parts)
    metrics = dict(zip(keys, out[len(names) + 1:]))
    if weight is not None:
        metrics["loss_weight"] = total.reshape(())
    return dict(zip(names, out[:len(names)])), out[len(names)], metrics


def make_psum_train_step(model, loss, optimizer, mesh, axis: str = "data",
                         metric_fns=None, seed: int = 0,
                         per_replica_rng: bool = True):
    """The JAX package's explicit data-parallel step: in the port a name
    for ``train.make_train_step(model, loss, optimizer, metric_fns=,
    seed=, mesh=)``, whose one all-reduce is the ``lax.pmean`` of that
    spelling.  ``axis`` must be ``"data"`` and ``per_replica_rng`` True
    (every rank folds its replica into the dropout generator)."""
    if axis != "data" or not per_replica_rng:
        raise ValueError("make_psum_train_step averages over the 'data' "
                         "axis with a dropout generator per replica; got "
                         f"axis={axis!r}, per_replica_rng={per_replica_rng}")
    from ..train.step import make_train_step
    return make_train_step(model, loss, optimizer, metric_fns=metric_fns,
                           seed=seed, mesh=mesh)


@torch.no_grad()
def gather_shards(shards: Mapping[str, torch.Tensor], layout, mesh,
                  out: Optional[Mapping[str, torch.Tensor]] = None,
                  axis: str = "fsdp") -> Dict[str, torch.Tensor]:
    """{name: the leaf whole along its ``axis`` dim} of ``shards`` ({name:
    this rank's block, cut as ``layout`` says}): every leaf cut over
    ``axis`` (a ``Shard``, or a part of a ``parallel.sharding.Blocks``)
    joined from ONE ``all_gather_into_tensor`` over the ``axis`` line,
    written in place into ``out[name]`` when given (the model's
    parameters) or into new tensors; every other entry is itself (a leaf
    also cut over another line stays that line's block).  Every rank of
    the line must call."""
    from .sharding import part_on
    cut = {n: p for n in shards
           if (p := part_on(layout.get(n), axis)) is not None}
    res = dict(shards)
    parts = mesh.axis_size(axis)
    if not cut or parts == 1:
        return res
    dtypes = {shards[n].dtype for n in cut}
    if len(dtypes) != 1:
        raise TypeError(f"gather_shards over blocks of types {dtypes}")
    flat = torch.cat([shards[n].detach().reshape(-1) for n in cut])
    buf = flat.new_empty(parts * flat.numel())
    dist.all_gather_into_tensor(buf, flat, group=mesh.axis_group(axis))
    LAUNCHES["all_gather"] += 1
    buf = buf.view(parts, -1)
    lo = 0
    for n, p in cut.items():
        t = shards[n]
        shape = list(t.shape)
        shape[p.dim] = p.length * parts
        dst = out[n] if out is not None else t.new_empty(shape)
        for r in range(parts):
            dst.narrow(p.dim, r * p.length, p.length).copy_(
                buf[r, lo:lo + t.numel()].view(t.shape))
        lo += t.numel()
        res[n] = dst
    return res


@torch.no_grad()
def gather_stages(values: Mapping[str, torch.Tensor], layout, mesh
                  ) -> Dict[str, torch.Tensor]:
    """{name: tensor} of the whole model from this rank's: the layers of
    every stage of the ``pipe`` line (``layout[name]`` a
    ``parallel.sharding.Stage``; names ``<prefix>.<layer>.<path>``) from
    ONE ``all_gather_into_tensor`` over the line, this rank's own layers
    and every other entry as they are.  Every rank of the line must
    call."""
    from .sharding import Stage
    stage = [n for n in values if isinstance(layout.get(n), Stage)]
    if not stage:
        return dict(values)
    first = min(layout[n].layer for n in stage)

    def rel(n):
        m = re.match(rf"^(.*?\.){layout[n].layer}(\..*)$", n)
        return layout[n].layer - first, m.group(1), m.group(2)
    order = sorted(stage, key=rel)
    dtypes = {values[n].dtype for n in order}
    if len(dtypes) != 1:
        raise TypeError(f"gather_stages over layers of types {dtypes}")
    s0 = layout[order[0]]
    parts = mesh.axis_size(s0.line)
    per = s0.layers // parts
    flat = torch.cat([values[n].detach().reshape(-1) for n in order])
    buf = flat.new_empty(parts * flat.numel())
    dist.all_gather_into_tensor(buf, flat, group=mesh.axis_group(s0.line))
    LAUNCHES["all_gather"] += 1
    buf = buf.view(parts, -1)
    own = set(stage)
    out = {n: t for n, t in values.items() if n not in own}
    for r in range(parts):
        lo = 0
        for n in order:
            j, head, tail = rel(n)
            t = values[n]
            name = f"{head}{r * per + j}{tail}"
            out[name] = (t if r == s0.stage else
                         buf[r, lo:lo + t.numel()].view(t.shape).clone())
            lo += t.numel()
    return out


def reduce_scatter_mean(grads: Mapping[str, torch.Tensor],
                        loss: torch.Tensor,
                        metrics: Mapping[str, torch.Tensor], layout, mesh,
                        weight: Optional[torch.Tensor] = None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                   Dict[str, torch.Tensor]]:
    """(grads, loss, metrics), each the global batch's mean over the
    replicas of ``mesh`` (its ``data`` x ``fsdp`` ranks), a gradient cut
    over ``fsdp`` as this rank's block of it (the ``fsdp`` part of a
    tensor block beside a ``tensor`` axis; the module docstring says how:
    one reduce-scatter over the ``fsdp`` line, one all-reduce over the
    ``data`` line when it has more than one rank); every other gradient
    in its own shape.  ``weight`` as in ``all_reduce_mean``."""
    from .sharding import part_on
    names = list(grads)
    part = {n: part_on(layout[n], "fsdp") for n in names}
    cut = [n for n in names if part[n] is not None]
    whole = [n for n in names if part[n] is None]
    keys = list(metrics)
    rest = [grads[n] for n in whole] + [loss] + [metrics[k] for k in keys]
    tail = _flat(rest)
    w = None if weight is None else weight.reshape(1).float()
    def blocks(r):
        return [grads[n].narrow(part[n].dim, r * part[n].length,
                                part[n].length) for n in cut]
    segments = []
    for r in range(mesh.axis_size("fsdp")):
        seg = torch.cat([_flat(blocks(r)), tail])
        segments.append(seg if w is None else torch.cat([seg * w, w]))
    bucket = torch.cat(segments)
    flat = bucket.new_empty(segments[0].numel())
    dist.reduce_scatter_tensor(flat, bucket, group=mesh.axis_group("fsdp"))
    LAUNCHES["reduce_scatter"] += 1
    data = mesh.axis_group("data")
    if data is not None:
        dist.all_reduce(flat, group=data)
        LAUNCHES["all_reduce"] += 1
    if w is None:
        total = flat.new_full((1,), float(mesh.axis_size("data")
                                          * mesh.axis_size("fsdp")))
    else:
        total, flat = torch.clamp(flat[-1:], min=1e-9), flat[:-1]
    out = _unflat(flat / total, blocks(0) + rest)
    grads_out = dict(zip(cut, out[:len(cut)]))
    grads_out.update(zip(whole, out[len(cut):len(names)]))
    metrics_out = dict(zip(keys, out[len(names) + 1:]))
    if w is not None:
        metrics_out["loss_weight"] = total.reshape(())
    return ({n: grads_out[n] for n in names}, out[len(names)],
            metrics_out)


def line_sum(t: torch.Tensor, mesh, axis: str = "fsdp") -> torch.Tensor:
    """``t`` summed over this rank's ``axis`` line: one all-reduce of a
    copy (``t`` itself on a line of one rank)."""
    group = mesh.axis_group(axis)
    if group is None:
        return t
    t = t.clone()
    dist.all_reduce(t, group=group)
    LAUNCHES["stats_all_reduce"] += 1
    return t
