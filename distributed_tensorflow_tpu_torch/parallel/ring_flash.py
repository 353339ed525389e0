"""Ring attention through the flash kernels: ring-flash attention.

Counterpart of ``distributed_tensorflow_tpu/parallel/ring_flash.py``: the
schedule of ``parallel/ring.py`` (each rank owns one sequence shard; the
K/V blocks rotate to ``(i + 1) mod R``), with each block pair computed by
the port's flash kernels (``ops/kernels/flash_attention.py``:
``csrc/flash_attention.cu``) instead of dense f32 logits, and the block
outputs merged by their row logsumexp.

* Forward: step i holds the K/V block of rank ``src = (my - i) mod R``
  and picks a route by ``rel_index``: ``full`` (a block wholly before
  this rank's, or any block when not causal) launches the non-causal
  forward, ``diag`` (the rank's own block of a causal ring) the causal
  one, and ``skip`` (a block after it) launches nothing.  Each returns
  ``(out_i, lse_i)`` normalised within the block; the f32 running merge
  ``out = sum_i exp(lse_i - lse) out_i`` with ``lse = logaddexp_i lse_i``
  is the global softmax, and a row no block reaches keeps lse ``-inf``
  and output 0 (``forward_step``).
* Backward: with the GLOBAL lse and ``D = rowsum(dO * O)`` (computed
  once, ``flash_lib.row_dot``), the kernels' backward of one block pair
  (``flash_backward_dq`` and ``flash_backward_dkv`` with a given lse and
  D) is exactly that block's share of dQ and the block's own dK/dV
  (``backward_step``).  The ring runs again; the f32 dK/dV accumulators
  rotate WITH their K/V blocks and, after one more rotation, are home.

GQA: K and V rotate with their ``hk`` heads; the kernels map each query
head to its kv head, so no broadcast is built.  Under tensor parallelism
a rank's ring carries its ``h/T`` query heads and the kv heads they read
(its block of them, or with replicated kv projections the group's slice
that ``tensor_parallel.kv_heads`` takes before the projection), so only
those rotate, and local query head i reads local kv head ``i // (h_local
/ hk_local)`` at every step of the ring.  ``block_q`` / ``block_k``
are the JAX signature's Pallas tile sizes, accepted and unused (the
kernels pick their own tiles), as is ``interpret``.

``forward_step`` and ``backward_step`` are module functions so that a
caller can drive the ring's steps itself: ``chip_smoke.py`` runs them in
lockstep for several virtual ranks on one card.  CUDA tensors launch the
kernels or raise; CPU tensors take the wrappers' plain versions.
``LAUNCHES`` counts the block calls per route (kernel launches on the
card): ``forward_full``, ``forward_diag``, ``dq_full``, ``dq_diag``,
``dkv_full``, ``dkv_diag``.  A causal ring of R ranks calls the forward
R(R+1)/2 times over its ranks (rank r: r full blocks and one diag), and
dQ and dK/dV as often; a non-causal ring R^2 times.
"""
from __future__ import annotations

import collections
import math
from typing import Optional, Tuple

import torch

from ..ops.kernels import flash_attention as flash_lib
from .ring import Ring, gather_seq, ring_of, rotate, shard_seq

__all__ = ["FULL", "DIAG", "SKIP", "LAUNCHES", "backward_step",
           "forward_step", "rel_index", "ring_flash_attention",
           "ring_flash_attention_sharded"]

LAUNCHES: collections.Counter = collections.Counter()

FULL, DIAG, SKIP = 0, 1, 2
_ROUTE = {FULL: "full", DIAG: "diag"}


def rel_index(src: int, my: int, causal: bool) -> int:
    """The route of the block from rank ``src`` on rank ``my``: FULL (the
    block is wholly visible), DIAG (aligned causal) or SKIP."""
    if not causal or src < my:
        return FULL
    return DIAG if src == my else SKIP


def forward_step(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
                 valid_blk: Optional[torch.Tensor], out: torch.Tensor,
                 lse: torch.Tensor, src: int, my: int, causal: bool,
                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward step on rank ``my`` with the block of rank ``src``:
    ``(out, lse)`` with the block merged in.  q ``[b, s, h, d]``; k/v
    ``[b, s, hk, d]``; ``valid_blk`` the block's ``[b, s]`` key plane or
    None; ``out`` the f32 running output ``[b, s, h, d]``; ``lse`` f32
    ``[b, h, s]`` (-inf where no key was seen yet)."""
    rel = rel_index(src, my, causal)
    if rel == SKIP:
        return out, lse
    o_i, lse_i = flash_lib.flash_forward(q, k_blk, v_blk, valid_blk,
                                         causal=rel == DIAG, scale=scale)
    LAUNCHES["forward_" + _ROUTE[rel]] += 1
    new_lse = torch.logaddexp(lse, lse_i)
    live = torch.isfinite(new_lse)
    # rows still without a key keep -inf and 0: guard the exp shifts
    w_old = torch.where(live, torch.exp(lse - new_lse), 0.0)
    w_new = torch.where(live, torch.exp(lse_i - new_lse), 0.0)
    out = (out * w_old.transpose(1, 2)[..., None]
           + o_i.float() * w_new.transpose(1, 2)[..., None])
    return out, new_lse


def backward_step(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
                  valid_blk: Optional[torch.Tensor], do: torch.Tensor,
                  lse: torch.Tensor, dvec: torch.Tensor, src: int, my: int,
                  causal: bool, scale: float):
    """One backward step on rank ``my`` with the block of rank ``src``:
    ``(dq_i, dk_i, dv_i)`` in the inputs' types, this block's share of dQ
    and its own dK/dV, from the global ``lse`` and ``dvec`` (D); None
    where the forward skipped."""
    rel = rel_index(src, my, causal)
    if rel == SKIP:
        return None
    route = _ROUTE[rel]
    dq = flash_lib.flash_backward_dq(q, k_blk, v_blk, valid_blk, do, lse,
                                     dvec, causal=rel == DIAG, scale=scale)
    LAUNCHES["dq_" + route] += 1
    dk, dv = flash_lib.flash_backward_dkv(q, k_blk, v_blk, valid_blk, do,
                                          lse, dvec, causal=rel == DIAG,
                                          scale=scale)
    LAUNCHES["dkv_" + route] += 1
    return dq, dk, dv


def _forward(q, k, v, valid, ring: Ring, causal, scale):
    """The forward ring: (out f32, lse)."""
    b, s, h, d = q.shape
    out = torch.zeros(b, s, h, d, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s), -math.inf, dtype=torch.float32,
                     device=q.device)
    k_blk, v_blk, valid_blk = k, v, valid
    for i in range(ring.size):
        out, lse = forward_step(q, k_blk, v_blk, valid_blk, out, lse,
                                (ring.index - i) % ring.size, ring.index,
                                causal, scale)
        if i + 1 < ring.size:
            k_blk, v_blk, valid_blk = rotate((k_blk, v_blk, valid_blk), ring)
    return out, lse


class _RingFlash(torch.autograd.Function):
    """The ring as one differentiable op; residuals (q, k, v, valid, out
    in q's type, lse), as the JAX ``custom_vjp`` keeps them."""

    @staticmethod
    def forward(ctx, q, k, v, valid, ring, causal, scale):
        out, lse = _forward(q, k, v, valid, ring, causal, scale)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, valid, out, lse)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, valid, out, lse = ctx.saved_tensors
        ring, causal, scale = ctx.ring, ctx.causal, ctx.scale
        do = do.contiguous()
        # D is the same for every K/V block: once, not once a step
        dvec = flash_lib.row_dot(do, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk, valid_blk = k, v, valid
        for i in range(ring.size):
            got = backward_step(q, k_blk, v_blk, valid_blk, do, lse, dvec,
                                (ring.index - i) % ring.size, ring.index,
                                causal, scale)
            if got is not None:
                dq.add_(got[0].float())
                dk.add_(got[1].float())
                dv.add_(got[2].float())
            # the accumulators travel WITH their blocks; the last turn
            # takes them home
            if i + 1 < ring.size:
                k_blk, v_blk, valid_blk, dk, dv = rotate(
                    (k_blk, v_blk, valid_blk, dk, dv), ring)
            else:
                dk, dv = rotate((dk, dv), ring)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group=None, causal: bool = False,
                         kv_valid: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None,
                         block_q: int = 512, block_k: int = 1024,
                         interpret: Optional[bool] = None) -> torch.Tensor:
    """Flash-kernel ring attention on this rank's shards, over the ring
    of ``group`` (the seq line's process group; None: a ring of one).

    q ``[b, s_local, h, d]``, k/v ``[b, s_local, hk, d]`` with ``h % hk ==
    0``; ``kv_valid``: optional ``[b, s_local]`` padding plane of the
    local keys (1 = real), rotating with K/V.  Same contract as
    ``ring.ring_attention``; differentiable.  ``block_q``, ``block_k``
    and ``interpret`` are unused (module docstring)."""
    del block_q, block_k, interpret
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    valid = None if kv_valid is None else flash_lib._valid_bool(
        kv_valid.to(q.device)).contiguous()
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            valid, ring_of(group), bool(causal),
                            float(scale))


def ring_flash_attention_sharded(q, k, v, mesh, seq_axis: str = "seq",
                                 causal: bool = False, kv_valid=None,
                                 scale: Optional[float] = None,
                                 block_q: int = 512,
                                 block_k: int = 1024) -> torch.Tensor:
    """``ring_flash_attention`` over the ``seq_axis`` line of ``mesh`` on
    the global ``[b, s, h, d]`` tensors every rank of the line holds;
    returns the global output, and the global gradients on every rank
    (``ring.shard_seq`` / ``gather_seq``).  ``kv_valid``: optional
    ``[b, s]`` padding mask (1 = real token)."""
    local = [shard_seq(t, mesh, seq_axis) for t in (q, k, v)]
    valid = None if kv_valid is None else shard_seq(kv_valid, mesh,
                                                    seq_axis)
    out = ring_flash_attention(*local, group=mesh.axis_group(seq_axis),
                               causal=causal, kv_valid=valid, scale=scale,
                               block_q=block_q, block_k=block_k)
    return gather_seq(out, mesh, seq_axis)
