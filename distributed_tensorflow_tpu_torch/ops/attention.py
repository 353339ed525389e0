"""Attention and FFN bodies of the serving path, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/ops/attention.py``, only the
parts the paged serving path runs: ``NEG_INF``, ``dot_product_attention``
(with the grouped-query contraction) and ``ffn_core``.  Layouts are the
JAX package's: q/k/v ``[batch, seq, heads, head_dim]``; masks are
additive (0 / ``NEG_INF``).

Logits and softmax are computed in float32 whatever the input type, and
the weights are cast back to q's type before the PV product, as in the
JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["NEG_INF", "dot_product_attention", "ffn_core"]

NEG_INF = -1e9  # finite -inf stand-in: keeps softmax well-defined in f32


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: [b, s, h, hd]; k, v: [b, s_k, kv_heads, hd] with ``h`` a multiple
    of ``kv_heads`` (grouped-query attention: each kv head is contracted
    against its query group, never broadcast in memory); ``mask``
    additive, broadcastable to [b, 1, s, s_k].  Returns [b, s, h, hd]."""
    head_dim = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    hq, hk = q.shape[2], k.shape[2]
    if hq == hk:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        if mask is not None:
            logits = logits + mask
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", weights, v)
    if hq % hk:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hk}")
    group = hq // hk
    b, s = q.shape[0], q.shape[1]
    qg = q.reshape(b, s, hk, group, head_dim)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    if mask is not None:
        # masks are [b|1, 1, q, s_k]; insert the group axis
        logits = logits + mask[:, :, None, :, :]
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", weights, v)
    return ctx.reshape(b, s, hq, head_dim)


def affine(kernel: torch.Tensor, bias: Optional[torch.Tensor],
           x: torch.Tensor) -> torch.Tensor:
    """``x @ kernel (+ bias)`` in x's type; the f32 weights are cast at
    the product, as the JAX package's ``.astype(dtype)`` does."""
    y = x @ kernel.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def ffn_core(w_in, b_in, w_out, b_out, x: torch.Tensor) -> torch.Tensor:
    """w_in -> gelu -> w_out.  ``jax.nn.gelu`` defaults to the tanh
    approximation, so this is ``F.gelu(approximate="tanh")``."""
    h = F.gelu(affine(w_in, b_in, x), approximate="tanh")
    return affine(w_out, b_out, h)
