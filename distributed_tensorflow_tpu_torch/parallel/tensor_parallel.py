"""Tensor parallelism: the collectives the JAX package's partitioner
inserts, issued by the models themselves.

In the JAX package a model under ``partition_rules`` runs as if it held
whole tensors, and GSPMD adds the collectives its shardings imply.  Torch
has no such partitioner, so here each model over a ``tensor`` axis of T
ranks computes on its blocks (``parallel/sharding.py`` cuts them as the
rule tables say) and calls the functions below where Megatron-LM's
column- and row-parallel layers would, every one a collective over this
rank's ``tensor`` line (``Mesh.axis_group("tensor")``):

* ``copy_to_line``: identity forward, the gradient all-reduced backward.
  It enters a column-parallel region (the q/k/v projections, ``w_in`` and
  ``w_gate``, a head over vocabulary blocks): every rank reads the same
  replicated activation, and the activation's gradient is the sum of the
  ranks' parts.  Replicated weights read inside the region (the kv
  kernels of the MQA recipe, a column-parallel layer's replicated bias)
  ride in the same backward all-reduce, which sums their partial
  gradients;
* ``reduce_from_line``: all-reduce forward, identity backward.  It ends a
  row-parallel product (the attention output, ``w_out``): each rank holds
  a partial sum of the whole output, whose bias is added once, after;
* ``gather_from_line``: all-gather along the last dim forward, this
  rank's slice of the gradient backward (BERT's column-parallel MLM
  transform and pooler, whose LayerNorm and classifier read the whole
  vector; whole logits for a caller that asks for them);
* ``vocab_parallel_embed``: the ids outside this rank's rows of the
  embedding are masked, the rest looked up, and the partial embeddings
  summed with ``reduce_from_line``;
* ``vocab_parallel_cross_entropy``: the integer-label cross entropy of
  logits cut over the vocabulary, with an all-reduce of the row max and
  one of the sum of exps beside the target's logit; its backward is the
  softmax minus the one-hot on this rank's columns, with no collective;
* ``vocab_parallel_argmax``: the whole row's argmax (the first index
  among ties, as ``torch.argmax``) from one all-gather of each rank's
  (max, index) pair.

Every collective runs in float32 (a bf16 tensor is cast there and back),
so a backend needs no reduction over bf16.  On a line of one rank every
function is the identity and issues nothing.  ``parallel.data_parallel.
LAUNCHES`` counts the collectives under ``tp_all_reduce`` and
``tp_all_gather``.

The line is the ``tensor`` axis unless a function is given ``axis=``:
the MoE's expert line (``ops/moe.py``) enters and ends its region with
the same ``copy_to_line`` and ``reduce_from_line`` over ``"expert"``,
counted apart as ``ep_all_reduce`` and ``ep_all_gather``.

``kv_heads`` says which kv heads a rank's query heads read when the
kv projections replicate (the MQA recipe, ``kv_heads < num_heads``
without ``shard_kv``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .data_parallel import LAUNCHES

__all__ = ["active", "copy_to_line", "gather_from_line", "gather_state",
           "kv_heads",
           "reduce_from_line", "size", "index", "vocab_parallel_argmax",
           "vocab_parallel_cross_entropy", "vocab_parallel_embed"]

AXIS = "tensor"
# the LAUNCHES prefix of each line's collectives
_KIND = {"tensor": "tp", "expert": "ep"}


def size(mesh, axis: str = AXIS) -> int:
    """Ranks on ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.axis_size(axis)


def index(mesh, axis: str = AXIS) -> int:
    """This rank's coordinate on ``axis``."""
    return 0 if mesh is None else mesh.axis_index(axis)


def active(mesh, axis: str = AXIS):
    """``mesh`` when its ``axis`` has more than one rank, else None (the
    models' switch between the plain and the parallel path)."""
    return mesh if size(mesh, axis) > 1 else None


def _all_reduce(t: torch.Tensor, mesh, op=dist.ReduceOp.SUM,
                axis: str = AXIS) -> torch.Tensor:
    """A new f32 tensor holding ``t`` reduced over the line."""
    buf = t.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    dist.all_reduce(buf, op=op, group=mesh.axis_group(axis))
    LAUNCHES[f"{_KIND[axis]}_all_reduce"] += 1
    return buf


def _all_gather(t: torch.Tensor, mesh, axis: str = AXIS) -> torch.Tensor:
    """[T, *t.shape] f32: every rank's ``t``, in line order."""
    src = t.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    parts = [torch.empty_like(src) for _ in range(size(mesh, axis))]
    dist.all_gather(parts, src, group=mesh.axis_group(axis))
    LAUNCHES[f"{_KIND[axis]}_all_gather"] += 1
    return torch.stack(parts)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        like = [g for g in grads if g is not None]
        if not like:
            return (None, None) + grads
        flat = _all_reduce(torch.cat([g.reshape(-1).float() for g in like]),
                           ctx.mesh, axis=ctx.axis)
        out, lo = [], 0
        for g in grads:
            if g is None:
                out.append(None)
                continue
            out.append(flat[lo:lo + g.numel()].view(g.shape).to(g.dtype))
            lo += g.numel()
        return (None, None, *out)


def copy_to_line(x: torch.Tensor, mesh, *also: torch.Tensor,
                 axis: str = AXIS):
    """``x`` unchanged; its gradient (and those of ``also``, replicated
    weights read in the same region) summed over the line by ONE
    all-reduce in the backward.  Returns ``x``, or ``(x, *also)`` when
    ``also`` is given."""
    if size(mesh, axis) == 1:
        return x if not also else (x, *also)
    out = _Copy.apply(mesh, axis, x, *also)
    return out[0] if not also else out


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis=axis).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_from_line(x: torch.Tensor, mesh, axis: str = AXIS
                     ) -> torch.Tensor:
    """The sum of every rank's ``x`` (one all-reduce); the gradient passes
    through unchanged."""
    if size(mesh, axis) == 1:
        return x
    return _Reduce.apply(x, mesh, axis)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.n, ctx.r = x.shape[-1], index(mesh, axis)
        parts = _all_gather(x, mesh, axis).to(x.dtype)
        return torch.cat(list(parts), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return (g[..., ctx.r * ctx.n:(ctx.r + 1) * ctx.n].contiguous(),
                None, None)


def gather_from_line(x: torch.Tensor, mesh, axis: str = AXIS
                     ) -> torch.Tensor:
    """Every rank's ``x`` joined along the last dim in line order (one
    all-gather); the gradient of this rank's columns comes back."""
    if size(mesh, axis) == 1:
        return x
    return _Gather.apply(x, mesh, axis)


@torch.no_grad()
def gather_state(t: torch.Tensor, mesh, axis: str = AXIS) -> torch.Tensor:
    """Every rank's ``t`` joined along the last dim in line order, outside
    autograd (state, not activations: a BatchNorm's moving moments of
    this rank's channels), in ``t``'s type."""
    if size(mesh, axis) == 1:
        return t
    return torch.cat(list(_all_gather(t, mesh, axis)), dim=-1).to(t.dtype)


def vocab_parallel_embed(ids: torch.Tensor, word: torch.Tensor,
                         mesh) -> torch.Tensor:
    """Rows of the whole embedding for ``ids`` from this rank's block
    ``word`` [V/T, d] (rows ``index * V/T`` on): each rank looks up the
    ids it holds, zeros the rest, and the line sums them."""
    if size(mesh) == 1:
        return F.embedding(ids, word)
    n = word.shape[0]
    start = index(mesh) * n
    local = ids - start
    own = (local >= 0) & (local < n)
    x = F.embedding(torch.clamp(local, 0, n - 1), word)
    x = torch.where(own[..., None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    return reduce_from_line(x, mesh)


class _VocabCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, mesh):
        n = logits.shape[-1]
        local = targets - index(mesh) * n
        own = (local >= 0) & (local < n)
        local = torch.clamp(local, 0, n - 1)
        row_max = _all_reduce(logits.max(-1).values, mesh,
                              dist.ReduceOp.MAX)
        shifted = logits - row_max[:, None]
        exp = torch.exp(shifted)
        target = torch.where(own, shifted.gather(-1, local[:, None])[:, 0],
                             torch.zeros((), device=logits.device))
        sums = _all_reduce(torch.stack([exp.sum(-1), target]), mesh)
        ctx.save_for_backward(exp / sums[0][:, None], local, own)
        return torch.log(sums[0]) - sums[1]

    @staticmethod
    def backward(ctx, g):
        softmax, local, own = ctx.saved_tensors
        grad = softmax.clone()
        rows = torch.arange(grad.shape[0], device=grad.device)
        grad[rows, local] -= own.to(grad.dtype)
        return grad * g[:, None], None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor,
                                 targets: torch.Tensor,
                                 mesh) -> torch.Tensor:
    """Per-row ``-log softmax(whole logits)[target]`` (f32) of ``logits``
    [N, V/T] f32, this rank's columns of the vocabulary (``index * V/T``
    on), and the whole vocabulary's ``targets`` [N]."""
    if size(mesh) == 1:
        return -torch.log_softmax(logits, dim=-1).gather(
            -1, targets[:, None])[:, 0]
    return _VocabCE.apply(logits, targets.long(), mesh)


@torch.no_grad()
def vocab_parallel_argmax(logits: torch.Tensor, mesh) -> torch.Tensor:
    """The whole vocabulary's argmax over the last dim of ``logits``
    [..., V/T] (this rank's columns), the first index among equal
    maxima, as ``torch.argmax`` of the whole row."""
    if size(mesh) == 1:
        return logits.argmax(-1)
    best, at = logits.max(-1)
    at = at + index(mesh) * logits.shape[-1]
    # f32 holds every index below 2**24 exactly
    pairs = _all_gather(torch.stack([best.float(), at.float()]), mesh)
    rank = pairs[:, 0].argmax(0)           # the first rank among ties
    return pairs[:, 1].gather(0, rank[None])[0].long()


def kv_heads(num_heads: int, num_kv_heads: int, mesh) -> slice:
    """The kv heads that this rank's query heads (``[index * h/T, (index
    + 1) * h/T)``) read when the kv projections replicate: a block of
    ``kv/T`` when T divides them, else the one kv head of the rank's
    group (``kv < T``, T a multiple of kv).  The flash kernel maps local
    query head i to local kv head ``i // (h_local / kv_local)``, which
    this slice makes the right one."""
    t, r, kv = size(mesh), index(mesh), num_kv_heads
    if kv % t == 0:
        return slice(r * kv // t, (r + 1) * kv // t)
    if t % kv == 0:
        g = r * kv // t
        return slice(g, g + 1)
    raise ValueError(f"{kv} kv heads on a tensor line of {t}: one must "
                     f"divide the other")


def dropout_block(x: torch.Tensor, rate: float,
                  generator: Optional[torch.Generator], dim: int,
                  start: int, whole: int) -> torch.Tensor:
    """Inverted dropout of ``x``, this rank's block ``[start, start +
    x.shape[dim])`` of a tensor ``whole`` long along ``dim``: the mask is
    drawn at the whole shape and cut, so every rank of the line draws the
    same bits (the generator stays in step across the line) and the block
    gets the mask the whole tensor would."""
    shape = list(x.shape)
    shape[dim] = whole
    keep = 1.0 - rate
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    mask = mask.narrow(dim, start, x.shape[dim])
    return torch.where(mask, x / keep, torch.zeros_like(x))
