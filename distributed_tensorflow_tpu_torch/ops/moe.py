"""Mixture-of-Experts FFN: grouped top-k routing into capacity slots.

Counterpart of ``distributed_tensorflow_tpu/ops/moe.py`` (GShard/Switch
style).  Routing, dispatch and combine are dense products over one-hot
capacity-slot masks, as in the JAX package: static shapes, no gather or
scatter, no data-dependent control flow.  No Pallas kernel is involved
there, and none here: the products are ``torch.einsum`` (batched matrix
products on the card).

Tokens over an expert's capacity are dropped (their output is zeros):
the caller adds the residual, so a dropped token passes through
unchanged.  ``aux_loss`` (Switch load balancing, ``E * sum_e f_e P_e``,
1.0 at perfect balance) and ``router_z_loss`` are for the caller to add
to the training loss.  Given the batch line (``apply_moe(...,
batch_group=)``, the groups of ``parallel.data_parallel.batch_group()``
that a model reads as its training forward starts), ``f_e`` and ``P_e``
are the global batch's, as the JAX package's jit over a sharded batch
takes them: each rank sums its sums of them and its token count over
the line (``data_parallel.batch_sum``, whose backward sums the
gradients), so the product of means is the global batch's and not the
mean of the ranks' products.

The train-time router jitter draws from an explicit ``torch.Generator``;
its bits differ from ``jax.random``'s, as ``ops.attention.dropout``'s do.

Expert parallelism (``apply_moe(..., mesh=)`` with an ``expert`` axis of
X ranks, the bank cut by ``moe_partition_rules``: experts over
``expert``, the FFN's hidden dim over ``tensor``).  The JAX layout cuts
the batch over ``data`` (and ``fsdp``) only, never over ``expert``, so
every rank of an expert line holds the same tokens, and the port
computes what the JAX partitioner computes there; no all-to-all
dispatch is needed, and none is issued:

* the router's logits and softmax, the top-k dispatch and the capacity
  are computed whole on every rank, from the global expert count, so
  the dispatch plan is the same across the line (every rank draws the
  same jitter: the train step folds no expert coordinate into its
  generator);
* a rank takes its ``E/X`` experts' slice of ``dispatch`` and
  ``combine`` and runs its experts (their hidden dim column-parallel
  over a ``tensor`` line of more than one rank, ended by
  ``reduce_from_line`` before ``b_out``), so its output is a partial
  sum, which ``reduce_from_line`` over ``expert`` ends;
* ``copy_to_line`` over ``expert`` enters the region on the tokens and
  on the router probabilities that build ``combine``, so the tokens' and
  the router's gradients add the ranks' parts.  ``aux_loss`` and
  ``router_z_loss`` read the probabilities and logits from before it:
  every rank computes them whole, and their gradient is not summed X
  times.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import data_parallel as dp_lib
from ..parallel import tensor_parallel as tp_lib
from . import activations as act_lib
from . import initializers as init_lib

__all__ = ["init_moe", "apply_moe", "moe_partition_rules"]


def init_moe(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             num_experts: int, dtype=torch.float32) -> Dict[str, Any]:
    """Router + a bank of ``num_experts`` two-matrix FFNs (leading E dim):
    ``router.kernel`` [D, E], ``experts.w_in`` [E, D, F], ``b_in`` [E, F],
    ``w_out`` [E, F, D], ``b_out`` [E, D].  Kernels are glorot-uniform
    (each expert's matrix with its own fans), biases zero, on the
    generator's device."""
    glorot = init_lib.glorot_uniform()
    router = glorot(generator, (d_model, num_experts), dtype)
    w_in = torch.stack([glorot(generator, (d_model, d_ff), dtype)
                        for _ in range(num_experts)])
    w_out = torch.stack([glorot(generator, (d_ff, d_model), dtype)
                         for _ in range(num_experts)])
    return {
        "router": {"kernel": router},
        "experts": {
            "w_in": w_in,
            "b_in": init_lib.zeros(generator, (num_experts, d_ff), dtype),
            "w_out": w_out,
            "b_out": init_lib.zeros(generator, (num_experts, d_model),
                                    dtype),
        },
    }


def moe_partition_rules():
    """(regex, spec) rows for ``parallel.PartitionRules``, the JAX table:
    experts over ``expert``, the FFN hidden dim over ``tensor``, the
    router replicated.  The patterns match a nested tree's ``/`` paths
    (``experts/w_in``) and a model's ``.`` names (``blocks.0.moe.experts.
    w_in``) alike."""
    return [
        (r"experts[./]w_in$", ("expert", None, "tensor")),
        (r"experts[./]b_in$", ("expert", "tensor")),
        (r"experts[./]w_out$", ("expert", "tensor", None)),
        (r"experts[./]b_out$", ("expert", None)),
        (r"router[./]", ()),
    ]


def _jitter_noise(x: torch.Tensor, generator: torch.Generator,
                 jitter: float) -> torch.Tensor:
    """The router input's multiplicative noise: uniform draws in ``[1 -
    jitter, 1 + jitter)`` of x's shape, drawn in f32 from ``generator``
    (on x's device) and cast to x's dtype."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return (u * (2.0 * jitter) + (1.0 - jitter)).to(x.dtype)


def _top_k_dispatch(probs: torch.Tensor, k: int, capacity: int):
    """One-hot capacity-slot dispatch/combine tensors from router probs.

    probs: [G, T, E] f32 (each group routes alone: the JAX package maps
    this over groups with ``vmap``).  Returns (dispatch [G, T, E, C],
    combine [G, T, E, C], top1_mask [G, T, E]), all f32.  Iterative
    argmax: choice i masks out the experts already taken (ties go to the
    lowest expert id), then tokens claim slots in token order through a
    cumsum, after the slots earlier choices filled.  A token past its
    expert's capacity is dropped.  Gradients reach the router through the
    gates; the one-hots and positions carry none."""
    g, t, e = probs.shape
    remaining = probs
    fill = torch.zeros((g, e), dtype=probs.dtype, device=probs.device)
    dispatch = combine = top1 = None
    gate_sum = torch.zeros((g, t), dtype=probs.dtype, device=probs.device)
    for i in range(k):
        idx = remaining.argmax(-1)                               # [G, T]
        mask = F.one_hot(idx, e).to(probs.dtype)                 # [G, T, E]
        if i == 0:
            top1 = mask
        gate = (probs * mask).sum(-1)                            # [G, T]
        pos = (torch.cumsum(mask, dim=1) - 1) * mask + fill[:, None] * mask
        pos_tok = pos.sum(-1).long()                             # [G, T]
        keep = ((pos_tok < capacity) & (mask.amax(-1) > 0)).to(probs.dtype)
        # an index past capacity is dropped by ``keep`` (jax's one_hot
        # gives it zeros; torch's refuses it, so it is clamped first)
        slot = F.one_hot(torch.clamp(pos_tok, max=capacity - 1),
                         capacity).to(probs.dtype)               # [G, T, C]
        assign = mask[..., None] * slot[:, :, None, :] * keep[..., None, None]
        dispatch = assign if dispatch is None else dispatch + assign
        weighted = assign * gate[..., None, None]
        combine = weighted if combine is None else combine + weighted
        gate_sum = gate_sum + gate * keep
        fill = fill + assign.sum(dim=(1, 3))
        remaining = remaining * (1.0 - mask)
    combine = combine / torch.clamp(gate_sum, min=1e-9)[..., None, None]
    return dispatch, combine, top1


def apply_moe(params: Dict[str, Any], x: torch.Tensor, *, k: int = 2,
              capacity_factor: float = 1.25,
              capacity: Optional[int] = None,
              group_size: Optional[int] = None, activation="gelu",
              train: bool = False,
              generator: Optional[torch.Generator] = None,
              jitter: float = 1e-2, mesh=None, batch_group=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [..., d_model] -> (y [..., d_model], metrics).

    Routing is grouped: tokens are split into groups of ``group_size``
    and each group routes into its own per-expert capacity slots, so the
    dispatch/combine tensors are [G, S, E, C] with C proportional to S.
    Default grouping: the leading (batch) dim when ``x`` has 3 or more
    dims, one group otherwise; ``group_size`` overrides it and must
    divide the token count.  ``capacity`` (per group per expert) defaults
    to ``max(1, int(capacity_factor * k * group_size / E))``.

    Router logits are computed in x's dtype, the softmax in f32; the
    dispatch and combine tensors are built in f32 and cast to x's dtype.
    ``metrics``: ``aux_loss`` and ``router_z_loss`` (f32 scalars the
    caller adds to the loss, weighted ~1e-2 / ~1e-3) and
    ``dropped_fraction``.  ``jitter``: with ``train`` and a
    ``generator``, the router input is multiplied by uniform noise in
    ``[1 - jitter, 1 + jitter)``.

    ``mesh``: a ``parallel.Mesh`` whose ``expert`` axis (and ``tensor``
    axis) cut the bank as ``moe_partition_rules`` says: ``params``
    holds this rank's experts (and their hidden dim's block), ``x`` the
    same tokens on every rank of both lines (module docstring); ``y`` and
    the metrics come out whole and equal on every rank.  ``batch_group``:
    the process groups of the ranks that hold the batch's other rows
    (``parallel.data_parallel.batch_group``); ``aux_loss`` then reads the
    global batch's ``f_e`` and ``P_e`` (module docstring)."""
    act = act_lib.get(activation)
    *lead, d = x.shape
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    ex = params["experts"]
    # the global expert count (the router's), and this rank's experts
    e = params["router"]["kernel"].shape[1]
    local = ex["w_in"].shape[0]
    if e % local or e // local != tp_lib.size(mesh, "expert"):
        raise ValueError(f"{local} experts of {e} on this rank of an "
                         f"expert line of {tp_lib.size(mesh, 'expert')}")
    first = tp_lib.index(mesh, "expert") * local
    if group_size is None:
        group_size = t // x.shape[0] if x.dim() >= 3 else t
    if t % group_size:
        raise ValueError(f"group_size {group_size} does not divide token "
                         f"count {t}")
    tok = tokens.reshape(-1, group_size, d)                      # [G, S, D]
    if capacity is None:
        capacity = max(1, int(capacity_factor * k * group_size / e))

    router_in = tok
    if train and generator is not None and jitter > 0:
        router_in = tok * _jitter_noise(tok, generator, jitter)
    logits = router_in @ params["router"]["kernel"].to(x.dtype)  # [G, S, E]
    logits32 = logits.float()
    probs = torch.softmax(logits32, dim=-1)

    # the expert line's region: the tokens' and the gates' gradients add
    # the ranks' parts (one all-reduce of both)
    tok_in, probs_in = tp_lib.copy_to_line(tok, mesh, probs, axis="expert")
    dispatch, combine, top1 = _top_k_dispatch(probs_in, k, capacity)
    kept = dispatch.sum()
    dispatch = dispatch[:, :, first:first + local].to(x.dtype)
    combine = combine[:, :, first:first + local].to(x.dtype)

    staged = torch.einsum("gsec,gsd->gecd", dispatch, tok_in)
    staged = tp_lib.copy_to_line(staged, mesh)
    h = act(torch.einsum("gecd,edf->gecf", staged, ex["w_in"].to(x.dtype))
            + ex["b_in"].to(x.dtype)[None, :, None, :])
    out_e = (tp_lib.reduce_from_line(
        torch.einsum("gecf,efd->gecd", h, ex["w_out"].to(x.dtype)), mesh)
        + ex["b_out"].to(x.dtype)[None, :, None, :])
    y = tp_lib.reduce_from_line(
        torch.einsum("gsec,gecd->gsd", combine, out_e), mesh, axis="expert")

    if batch_group is None:
        frac_tokens = top1.mean(dim=(0, 1))                      # f_e
        mean_probs = probs.mean(dim=(0, 1))                      # P_e
    else:
        # the global batch's f_e and P_e, as the JAX package's jit over a
        # batch sharded on the mesh computes them
        sums = dp_lib.batch_sum(torch.cat([
            top1.sum(dim=(0, 1)), probs.sum(dim=(0, 1)),
            probs.new_full((1,), probs.shape[0] * probs.shape[1])]),
            batch_group)
        frac_tokens = sums[:e] / sums[-1]
        mean_probs = sums[e:2 * e] / sums[-1]
    z = torch.logsumexp(logits32, dim=-1)
    metrics = {
        "aux_loss": e * torch.sum(frac_tokens * mean_probs),
        "router_z_loss": torch.mean(z ** 2),
        "dropped_fraction": 1.0 - kept / (k * t),
    }
    return y.reshape(*lead, d), metrics
