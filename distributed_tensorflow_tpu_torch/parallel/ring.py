"""Ring attention: sequence (context) parallelism over a mesh axis.

Counterpart of ``distributed_tensorflow_tpu/parallel/ring.py``.  Each rank
of the ``seq`` axis owns one sequence shard of Q, K and V.  The K/V blocks
(and the key-padding plane) rotate around the ring, rank i sending to
``(i + 1) mod R`` with ``torch.distributed.batch_isend_irecv`` (NCCL on
the cards, gloo on the CPU), while every rank folds ``softmax(QK^T)V``
against the passing blocks into a running (max, sum) online softmax.  The
JAX package computes it with einsums outside any Pallas kernel, and so
does this module, in plain torch; ``parallel/ring_flash.py`` runs the
same schedule through the flash kernels.

Two entry points, as in the JAX package:

* ``ring_attention(q, k, v, group, ...)`` on this rank's shards, where
  the JAX spelling runs inside a ``shard_map`` with ``axis_name`` bound:
  ``group`` is the seq line's process group (``Mesh.axis_group``), None
  for a ring of one;
* ``ring_attention_sharded(q, k, v, mesh, seq_axis, ...)`` on the global
  ``[b, s, h, d]`` that every rank of the seq line holds: it slices this
  rank's shard, rings, and returns the global result through an
  all-gather, the contract of the JAX partial-manual ``shard_map``.  Its
  gradients are the global ones on every rank (``shard_seq``,
  ``gather_seq``).

Gradients across the line.  Every rank of a seq line computes the line's
loss alike, and the train step averages the gradients over all the
mesh's ranks (``parallel.data_parallel.all_reduce_mean``).  So that a
plain mean is exact, a tensor that lives on one rank's shard carries R
times its gradient (R the line's size) and a tensor that every rank
holds alike carries its gradient once: the ops that cross between the
two scale by R.  ``gather_seq``'s backward takes this rank's slice times
R, ``sum_seq``'s passes the gradient on times R, and ``shard_seq``'s
all-gathers the shards' gradients over R.  A parameter used on the
shards then holds R times the part through its rank's tokens, whose
mean over the line is the whole; one used after a gather (a loss on
``apply``'s output, a pooler on the global ``[CLS]``) holds the whole on
every rank; and a replicated input of ``ring_attention_sharded`` gets
its global gradient.

Beside a ``tensor`` axis (``{"seq": S, "tensor": T}``, the JAX
package's multi-chip mesh with ``data``) the ring's group is this rank's
``seq`` line at its ``tensor`` index (``Mesh.axis_group("seq")``; the
mesh puts ``tensor`` innermost), so each ring carries one tensor rank's
heads.  The tensor line's collectives (``parallel/tensor_parallel.py``)
act within a sequence shard and scale nothing: every rank of a tensor
line holds the same R-scaled gradient of its shard's replicated
activations, ``copy_to_line`` sums the ranks' parts of it once, and
``reduce_from_line`` passes it through, so a block's gradient on a rank
is R times the part through its shard's tokens, and the train step's
mean over the ``seq`` line (``data_parallel.replicas``) makes it whole.

The rotation is differentiable (``_Rotate``: its backward sends the
gradients the other way round), so autograd carries the plain ring's
gradients, as ``lax.ppermute``'s transpose does.  A ring of one does no
communication.  ``sum_seq`` reduces a loss's sums over the line, and
``weight_share`` is a rank's share of a loss weight the line holds
alike.  ``LAUNCHES`` counts the collectives issued: ``"p2p"`` (one
``batch_isend_irecv`` a rotation), ``"p2p_host"`` (each staged host
copy of a rotated CUDA tensor under gloo, where ranks share a card),
``"all_gather"`` and ``"all_reduce"``.
"""
from __future__ import annotations

import collections
import math
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["LAUNCHES", "Ring", "gather_seq", "ring_attention",
           "ring_attention_sharded", "ring_of", "rotate", "seq_part",
           "shard_seq", "sum_seq", "weight_share"]

LAUNCHES: collections.Counter = collections.Counter()


class Ring(NamedTuple):
    """A ring over a process group: its size, this rank's index on it, the
    group, the global ranks of the next and previous members, and
    whether the group's backend is gloo."""
    size: int
    index: int
    group: object
    next: Optional[int]
    prev: Optional[int]
    gloo: bool = False


def ring_of(group) -> Ring:
    """The ring over ``group``'s ranks in group order (None: a ring of
    one).  ``P2POp`` takes global ranks, so the neighbours are mapped
    through ``get_global_rank``."""
    if group is None:
        return Ring(1, 0, None, None, None)
    size, index = dist.get_world_size(group), dist.get_rank(group)
    return Ring(size, index, group,
                dist.get_global_rank(group, (index + 1) % size),
                dist.get_global_rank(group, (index - 1) % size),
                dist.get_backend(group) == "gloo")


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backends carry it (bool as uint8, same bytes)."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer shaped as ``t``."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def rotate(tensors: Sequence[Optional[torch.Tensor]], ring: Ring,
           backward: bool = False) -> List[Optional[torch.Tensor]]:
    """Every tensor sent to the next rank of the ring and the previous
    rank's received in its place (``backward``: the other way round), in
    one ``batch_isend_irecv``; None stays None.  On a ring of one the
    tensors come back as they are.  Under gloo, whose ``send``/``recv``
    take CPU tensors only, a CUDA tensor is staged through a pinned host
    buffer each way (``parallel/pipeline.py`` stages its exchange so
    too); under NCCL nothing is staged."""
    if ring.size == 1:
        return list(tensors)
    dst, src = (ring.prev, ring.next) if backward else (ring.next, ring.prev)
    ops, recvs = [], []
    for tag, t in enumerate(tensors):
        if t is None:
            recvs.append(None)
            continue
        send = _wire(t)
        staged = ring.gloo and send.is_cuda
        if staged:
            send = _host(send).copy_(send)
            LAUNCHES["p2p_host"] += 1
        recv = _host(send) if staged else torch.empty_like(send)
        ops.append(dist.P2POp(dist.isend, send, dst, group=ring.group,
                              tag=tag))
        ops.append(dist.P2POp(dist.irecv, recv, src, group=ring.group,
                              tag=tag))
        recvs.append((recv, t))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    LAUNCHES["p2p"] += 1
    out = []
    for got in recvs:
        if got is None:
            out.append(None)
            continue
        recv, t = got
        if recv.device != t.device:
            recv = recv.to(t.device)
            LAUNCHES["p2p_host"] += 1
        out.append(recv.view(torch.bool) if t.dtype == torch.bool else recv)
    return out


class _Rotate(torch.autograd.Function):
    """``rotate`` of float tensors as an op, and of ``carried`` (a list
    of one tensor or None, outside autograd: the padding plane) in the
    same exchange.  The backward rotates the gradients the other way, so
    each returns to the rank whose tensor it belongs to."""

    @staticmethod
    def forward(ctx, ring, carried, *tensors):
        ctx.ring = ring
        out = rotate([*tensors, carried[0]], ring)
        carried[0] = out.pop()
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *rotate(grads, ctx.ring, backward=True))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = False,
                   kv_valid: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: this rank's shards ``[b, s_local, h, d]`` (equal shards on
    every rank of ``group``); returns its output shard in q's type.

    ``causal`` masks by global position, from the ring rotation: after
    ``i`` steps the resident K/V block came from rank ``(my - i) mod R``.
    ``kv_valid``: optional ``[b, s_local]`` padding plane of the local
    keys (1 = real token); it rotates with K/V.  A row with no unmasked
    key gives 0."""
    ring = ring_of(group)
    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q32 = q.float()
    acc = q.new_zeros((b, h, sq, d), dtype=torch.float32)
    row_max = q.new_full((b, h, sq), -math.inf, dtype=torch.float32)
    row_sum = q.new_zeros((b, h, sq), dtype=torch.float32)
    q_pos = ring.index * sq + torch.arange(sq, device=q.device)
    valid = (torch.ones(b, k.shape[1], dtype=torch.bool, device=q.device)
             if kv_valid is None else kv_valid.to(q.device).bool())
    k_blk, v_blk = k, v
    for i in range(ring.size):
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float()) * scale
        logits = logits.masked_fill(~valid[:, None, None, :], -math.inf)
        if causal:
            src = (ring.index - i) % ring.size
            k_pos = src * sq + torch.arange(k_blk.shape[1], device=q.device)
            keep = q_pos[:, None] >= k_pos[None, :]
            logits = logits.masked_fill(~keep[None, None], -math.inf)
        new_max = torch.maximum(row_max, logits.amax(-1))
        # fully masked rows keep -inf; guard the exp shifts
        shift = torch.where(torch.isfinite(new_max), new_max, 0.0)
        correction = torch.exp(torch.where(torch.isfinite(row_max),
                                           row_max - shift, -math.inf))
        probs = torch.exp(logits - shift[..., None])
        row_sum = row_sum * correction + probs.sum(-1)
        acc = acc * correction[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", probs, v_blk.float())
        row_max = new_max
        if i + 1 < ring.size:
            carried = [valid]
            k_blk, v_blk = _Rotate.apply(ring, carried, k_blk, v_blk)
            valid = carried[0]
    out = acc / torch.clamp(row_sum, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


class _ShardSeq(torch.autograd.Function):
    """This rank's part of dim 1; the backward all-gathers the parts'
    gradients over R, so a replicated input gets its whole gradient
    (module docstring)."""

    @staticmethod
    def forward(ctx, x, group, part, size):
        ctx.group, ctx.size = group, size
        return x[:, part].contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g, ctx.group, ctx.size) / ctx.size, None, None,
                None)


class _GatherSeq(torch.autograd.Function):
    """The shards of dim 1 gathered in ring order; the backward takes this
    rank's slice of the (replicated) gradient times R (module
    docstring)."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.index, ctx.n, ctx.size = index, x.shape[1], size
        return _all_gather(x, group, size)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.n
        return g[:, lo:lo + ctx.n] * ctx.size, None, None, None


class _SumSeq(torch.autograd.Function):
    """The sum over the line's ranks; the backward passes the gradient on
    times R (module docstring)."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.size = size
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        LAUNCHES["all_reduce"] += 1
        return x

    @staticmethod
    def backward(ctx, g):
        return g * ctx.size, None, None


def sum_seq(x: torch.Tensor, mesh, seq_axis: str = "seq") -> torch.Tensor:
    """``x`` summed over the ``seq_axis`` line of ``mesh``: the models'
    loss sums (nll, hits) of their shards made the line's.  Every rank of
    the line holds the same value and differentiates it; the backward
    hands the rank's own term R times the gradient, so a parameter's
    gradient on a rank is R times the part through its tokens, and their
    mean over the line (the train step's all-reduce) is the whole."""
    size = mesh.axis_size(seq_axis)
    if size == 1:
        return x
    return _SumSeq.apply(x, mesh.axis_group(seq_axis), size)


def weight_share(w: torch.Tensor, mesh, seq_axis: Optional[str]
                 ) -> torch.Tensor:
    """This rank's share of a loss weight ``w`` that every rank of the
    ``seq_axis`` line holds alike (a mask's sum): ``w`` over R, so the
    train step's all-reduce sums the global weight; ``w`` itself without
    ``seq_axis``."""
    return w if seq_axis is None else w / mesh.axis_size(seq_axis)


def _all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    if size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    LAUNCHES["all_gather"] += 1
    return torch.cat(parts, dim=1)


def seq_part(s: int, mesh=None, seq_axis: Optional[str] = None) -> slice:
    """This rank's positions of a sequence of ``s`` over the ``seq_axis``
    line of ``mesh`` (all of them when ``seq_axis`` is None); raises
    unless ``s`` splits evenly over the line."""
    if seq_axis is None:
        return slice(0, s)
    size = mesh.axis_size(seq_axis)
    if s % size:
        raise ValueError(f"sequence of {s} positions not divisible by the "
                         f"{size} ranks of mesh axis {seq_axis!r}")
    lo = mesh.axis_index(seq_axis) * (s // size)
    return slice(lo, lo + s // size)


def shard_seq(x: torch.Tensor, mesh, seq_axis: str = "seq") -> torch.Tensor:
    """This rank's shard of ``x``'s dim 1 over the ``seq_axis`` line
    (the backward all-gathers)."""
    part = seq_part(x.shape[1], mesh, seq_axis)
    size = mesh.axis_size(seq_axis)
    return x if size == 1 else _ShardSeq.apply(x, mesh.axis_group(seq_axis),
                                               part, size)


def gather_seq(x: torch.Tensor, mesh, seq_axis: str = "seq") -> torch.Tensor:
    """The global tensor from every rank's dim-1 shard over the
    ``seq_axis`` line (the backward slices)."""
    size = mesh.axis_size(seq_axis)
    if size == 1:
        return x
    return _GatherSeq.apply(x, mesh.axis_group(seq_axis),
                            mesh.axis_index(seq_axis), size)


def ring_attention_sharded(q, k, v, mesh, seq_axis: str = "seq",
                           causal: bool = False, kv_valid=None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """``ring_attention`` over the ``seq_axis`` line of ``mesh`` on the
    global ``[b, s, h, d]`` tensors every rank of the line holds; returns
    the global output.  ``kv_valid``: optional ``[b, s]`` padding mask
    (1 = real token)."""
    local = [shard_seq(t, mesh, seq_axis) for t in (q, k, v)]
    valid = None if kv_valid is None else shard_seq(kv_valid, mesh,
                                                    seq_axis)
    out = ring_attention(*local, group=mesh.axis_group(seq_axis),
                         causal=causal, kv_valid=valid, scale=scale)
    return gather_seq(out, mesh, seq_axis)
