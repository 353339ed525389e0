"""Attention and FFN bodies of the serving and training paths, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/ops/attention.py``, the parts
the port's paths run: ``NEG_INF``, ``causal_mask``, ``padding_mask``,
``dot_product_attention`` (with the grouped-query contraction),
``attention_core`` (projections, an optional q/k transform such as RoPE,
the swappable inner kernel, dropout on the context, out projection),
the RoPE tables (``rope_tables``, ``apply_rope``, ``rotary_embedding``),
``ffn_core`` (gelu, or the activation given) and ``ffn_swiglu_core``
(Llama), ``resolve_activation`` (a config's ``hidden_act`` name) and the
``MultiHeadAttention`` layer.  ``attention_core`` also takes a memory
sequence (``kv``) for cross-attention (seq2seq).  Layouts are the JAX
package's: q/k/v ``[batch, seq, heads, head_dim]``, projection kernels
``[d, heads, head_dim]`` and ``[heads, head_dim, d]``; masks are additive
(0 / ``NEG_INF``).

Logits and softmax are computed in float32 whatever the input type, and
the weights are cast back to q's type before the PV product, as in the
JAX package.

Tensor parallelism (``mesh=`` with a ``tensor`` axis of T > 1 ranks; the
parameters are this rank's blocks, ``parallel/tensor_parallel.py``):
``attention_core`` is Megatron's attention, column-parallel q/k/v (a
rank's ``h/T`` heads, ``[d, h/T, hd]`` kernels) into the inner kernel on
the local heads, then the row-parallel output (``[h/T, hd, d]``) summed
over the line, its bias added once after the sum; ``ffn_core`` and
``ffn_swiglu_core`` are the column-parallel ``w_in`` (and ``w_gate``)
into the row-parallel ``w_out``.  Cross-attention under tensor
parallelism projects the queries of this rank's heads from ``x`` and its
keys and values from the memory, which the caller has brought onto the
line itself (``tensor_parallel.copy_to_line``): seq2seq brings it once a
decoder pass, so the memory's gradient is summed over the line by one
all-reduce for every layer together, not one a layer.  On a line of one
they are the plain bodies.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F

from ..parallel import tensor_parallel as tp_lib
from . import initializers as init_lib
from .layers import Layer

__all__ = ["NEG_INF", "MultiHeadAttention", "affine", "apply_rope",
           "attention_core", "causal_mask", "dropout",
           "dot_product_attention", "ffn_core", "ffn_swiglu_core",
           "padding_mask", "project", "resolve_activation", "rope_tables",
           "rotary_embedding"]

NEG_INF = -1e9  # finite -inf stand-in: keeps softmax well-defined in f32


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def resolve_activation(name: str) -> Callable:
    """A config's ``hidden_act`` name -> the activation: ``"gelu_approx"``
    (and HF's aliases ``"gelu_new"``, ``"gelu_pytorch_tanh"``) is the
    tanh approximation, ``jax.nn.gelu``'s default; ``"gelu"`` the exact
    erf form; ``"relu"``."""
    table = {"gelu_approx": _gelu_tanh, "gelu_new": _gelu_tanh,
             "gelu_pytorch_tanh": _gelu_tanh, "gelu": F.gelu,
             "relu": F.relu}
    if name not in table:
        raise ValueError(f"unsupported hidden_act {name!r}; "
                         f"one of {sorted(table)}")
    return table[name]


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """[1, 1, seq, seq] additive f32 mask; position i attends to j <= i."""
    keep = torch.ones(seq_len, seq_len, dtype=torch.bool,
                      device=device).tril()
    return torch.where(keep, 0.0, NEG_INF)[None, None]


def padding_mask(valid: torch.Tensor) -> torch.Tensor:
    """valid [b, s_k] bool/int (1 = real token) -> [b, 1, 1, s_k] additive
    f32 mask."""
    return torch.where(valid.bool(), 0.0, NEG_INF)[:, None, None, :]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], train: bool
            ) -> torch.Tensor:
    """Inverted dropout from an explicit generator (the JAX package's
    ``_dropout``; the bits differ from ``jax.random``'s)."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


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


def project(kernel: torch.Tensor, bias: Optional[torch.Tensor],
            x: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, kernel) (+ bias)`` as one matrix
    product in x's type: kernel [d, h, hd], bias [h, hd] -> [..., h, hd]."""
    d, nh, hd = kernel.shape
    y = x @ kernel.reshape(d, nh * hd).to(x.dtype)
    if bias is not None:
        y = y + bias.reshape(nh * hd).to(x.dtype)
    return y.reshape(*x.shape[:-1], nh, hd)


def attention_core(params: Mapping[str, Mapping[str, torch.Tensor]],
                   x: torch.Tensor, *, mask: Optional[torch.Tensor] = None,
                   dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   train: bool = False,
                   attention_fn=dot_product_attention,
                   kv: Optional[torch.Tensor] = None,
                   qk_transform: Optional[Callable] = None,
                   mesh=None, kv_heads: Optional[slice] = None
                   ) -> torch.Tensor:
    """The shared multi-head attention body.

    ``params``: {query, key, value: {kernel [d, h, hd], bias [h, hd]},
    out: {kernel [h, hd, d], bias [d]}} (a missing bias is skipped).
    ``attention_fn(q, k, v, mask=...)`` is the inner kernel: the dense
    ``dot_product_attention`` or the flash kernel
    (``ops.kernels.flash_attention.make_flash_attention_fn``).
    ``kv``: a memory sequence [b, s_k, d] for cross-attention (keys and
    values project from it, queries from ``x``); under a tensor line the
    caller passes it through ``tensor_parallel.copy_to_line`` first, once
    for every layer that reads it (its backward, one all-reduce counted
    as ``tp_all_reduce``, sums the layers' gradients of it over the
    line), and this rank's key and value blocks project its heads.
    ``qk_transform(q, k) -> (q, k)`` runs after the projections (RoPE).
    Grouped
    kv heads are broadcast only for a kernel that does not take them
    (``supports_gqa``).  Dropout, in train mode, drops the context.

    ``mesh`` with a ``tensor`` axis of T > 1 (module docstring): ``params``
    hold this rank's blocks.  ``kv_heads``: None when the key and value
    kernels are this rank's blocks too; else they replicate and this
    rank's queries read those kv heads (``tensor_parallel.kv_heads``),
    whose gradients the line sums; the slice is taken of the kernels,
    before the projection, so only those kv heads reach
    ``attention_fn`` (under ``seq_axis`` the ring-flash ring, which
    rotates them).  The context's dropout mask is drawn at the whole
    heads' shape of ``x``'s positions (``tensor_parallel.dropout_block``;
    under ``seq_axis`` a sequence shard's, from the step's generator,
    which folds in the seq coordinate and not the tensor one)."""
    line = tp_lib.active(mesh)
    kvp = {n: dict(params[n]) for n in ("key", "value")}
    if line is not None:
        reps = [] if kv_heads is None else [
            (n, w) for n in ("key", "value") for w in ("kernel", "bias")
            if kvp[n].get(w) is not None]
        if reps:
            x, *ws = tp_lib.copy_to_line(x, line,
                                         *[kvp[n][w] for n, w in reps])
            for (n, w), t in zip(reps, ws):
                kvp[n][w] = t[:, kv_heads] if w == "kernel" else t[kv_heads]
        else:
            x = tp_lib.copy_to_line(x, line)

    def proj(p, src):
        return project(p["kernel"], p.get("bias"), src)

    memory = x if kv is None else kv.to(x.dtype)
    q = proj(params["query"], x)
    k, v = proj(kvp["key"], memory), proj(kvp["value"], memory)
    if qk_transform is not None:
        q, k = qk_transform(q, k)
    if (k.shape[2] != q.shape[2]
            and attention_fn is not dot_product_attention
            and not getattr(attention_fn, "supports_gqa", False)):
        if q.shape[2] % k.shape[2]:
            raise ValueError(f"query heads {q.shape[2]} not a multiple of "
                             f"kv heads {k.shape[2]}")
        group = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    ctx = attention_fn(q, k, v, mask=mask)
    if line is not None and train and dropout_rate > 0.0:
        nh = ctx.shape[2]
        ctx = tp_lib.dropout_block(ctx, dropout_rate, generator, 2,
                                   tp_lib.index(line) * nh,
                                   nh * tp_lib.size(line))
    else:
        ctx = dropout(ctx, dropout_rate, generator, train)
    out = params["out"]
    nh, hd, d = out["kernel"].shape
    return _row_parallel(out["kernel"].reshape(nh * hd, d), out.get("bias"),
                         ctx.reshape(*ctx.shape[:-2], nh * hd), line)


def _row_parallel(kernel: torch.Tensor, bias: Optional[torch.Tensor],
                  x: torch.Tensor, line) -> torch.Tensor:
    """``affine``, or over a tensor line the partial products summed and
    the (replicated) bias added once after the sum."""
    if line is None:
        return affine(kernel, bias, x)
    y = tp_lib.reduce_from_line(x @ kernel.to(x.dtype), line)
    return y if bias is None else y + bias.to(y.dtype)


def affine(kernel: torch.Tensor, bias: Optional[torch.Tensor],
           x: torch.Tensor) -> torch.Tensor:
    """``x @ kernel (+ bias)`` in x's type; the f32 weights are cast at
    the product, as the JAX package's ``.astype(dtype)`` does."""
    y = x @ kernel.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def ffn_core(w_in, b_in, w_out, b_out, x: torch.Tensor,
             activation: Callable = _gelu_tanh, mesh=None) -> torch.Tensor:
    """w_in -> activation -> w_out.  ``jax.nn.gelu`` defaults to the tanh
    approximation, so the default is ``F.gelu(approximate="tanh")``.
    ``mesh`` with a ``tensor`` axis: the column-parallel ``w_in`` block
    into the row-parallel ``w_out`` block (module docstring)."""
    line = tp_lib.active(mesh)
    if line is not None:
        x = tp_lib.copy_to_line(x, line)
    h = activation(affine(w_in, b_in, x))
    return _row_parallel(w_out, b_out, h, line)


def ffn_swiglu_core(w_gate, b_gate, w_in, b_in, w_out, b_out,
                    x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Gated FFN (Llama): ``w_out(silu(w_gate(x)) * w_in(x))``; ``w_in``
    is HF's up_proj, ``w_gate`` gate_proj, ``w_out`` down_proj.  Biases
    may be None.  ``mesh`` as in ``ffn_core``."""
    line = tp_lib.active(mesh)
    if line is not None:
        x = tp_lib.copy_to_line(x, line)
    h = F.silu(affine(w_gate, b_gate, x)) * affine(w_in, b_in, x)
    return _row_parallel(w_out, b_out, h, line)


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, base: float, device: torch.device) -> torch.Tensor:
    """RoPE's f32 frequencies, computed on the CPU and copied to ``device``
    once: a host-to-card copy from pageable memory waits for the stream,
    so a copy on every decode step would be a host sync a token."""
    return torch.pow(base, -torch.arange(half, dtype=torch.float32)
                     / half).to(device)


def rope_tables(positions: torch.Tensor, head_dim: int,
                base: float = 10000.0):
    """(cos, sin) f32 tables for RoPE, shaped to broadcast against [b, s,
    h, hd/2]: positions [s] give [1, s, 1, hd/2], positions [b, s] give
    [b, s, 1, hd/2].  Build once per forward and share across layers.
    The frequencies are computed on the CPU, so every device rotates by
    the same f32 angles."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {head_dim}")
    angles = positions.float()[..., None] * _rope_freqs(
        head_dim // 2, float(base), positions.device)
    if angles.ndim == 2:
        angles = angles[None, :, None, :]
    else:
        angles = angles[:, :, None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [b, s, h, hd] by the tables (rotate-half convention, as
    HF Llama): f32 arithmetic, cast back to x's type."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor,
                     base: float = 10000.0) -> torch.Tensor:
    """RoPE of x [b, s, h, hd] at ``positions`` [s] or [b, s] in one call."""
    cos, sin = rope_tables(positions, x.shape[-1], base)
    return apply_rope(x, cos, sin)


class MultiHeadAttention(Layer):
    """Self-attention over ``attention_core`` with the dense
    ``dot_product_attention`` (the JAX layer has no kernel either):
    projections ``[d, heads, head_dim]``, the out projection ``[heads,
    head_dim, d_model]``, each kernel drawn from ``kernel_init`` on its
    flattened ``[fan_in, fan_out]`` shape, biases zero."""

    def __init__(self, num_heads: int, d_model: int,
                 head_dim: Optional[int] = None, dropout_rate: float = 0.0,
                 kernel_init="glorot_uniform", name: Optional[str] = None):
        super().__init__(name or "attention")
        self.num_heads = num_heads
        self.d_model = d_model
        self.head_dim = head_dim or d_model // num_heads
        self.dropout_rate = dropout_rate
        self.kernel_init = init_lib.get(kernel_init)

    def init(self, generator, in_shape):
        d, h, hd = in_shape[-1], self.num_heads, self.head_dim
        dev = init_lib._device(generator)

        def dense(fan_in, fan_out, shape, bias_shape):
            kernel = self.kernel_init(generator, (fan_in, fan_out))
            return {"kernel": kernel.reshape(shape),
                    "bias": torch.zeros(bias_shape, device=dev)}
        params = {name: dense(d, h * hd, (d, h, hd), (h, hd))
                  for name in ("query", "key", "value")}
        params["out"] = dense(h * hd, self.d_model, (h, hd, self.d_model),
                              (self.d_model,))
        return params, {}

    def out_shape(self, in_shape):
        return tuple(in_shape[:-1]) + (self.d_model,)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return attention_core(params, x, mask=mask,
                              dropout_rate=self.dropout_rate, generator=rng,
                              train=train), state
