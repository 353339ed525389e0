"""Flash attention, forward and backward: CUDA kernels and plain versions.

Replaces the three Pallas kernels of
``distributed_tensorflow_tpu/ops/pallas/flash_attention.py``:
``_flash_forward`` (body ``_flash_kernel``, out + row logsumexp) and the
two calls of ``_flash_backward`` (bodies ``_flash_dkv_kernel`` and
``_flash_dq_kernel``), reached there through ``flash_attention`` and its
``jax.custom_vjp``.  The kernels are ``csrc/flash_attention.cu``; its
header says how the TPU design was rethought for Hopper.  In short: the
bf16 forward takes a block per (head, batch, 128-row q tile), 8 warps of
16 rows with Q in registers, and streams 64-row K/V tiles through a
two-stage ring of shared memory filled by ``cp.async`` a tile ahead;
swizzled tiles feed ``ldmatrix`` and ``mma.sync`` (bf16 operands, f32
online softmax in log2 units); the mask is evaluated only on the tiles
that need it and causal grids run their heaviest tiles first.  dQ takes
a block per (batch, head, 64-row q tile) and dK/dV a block per (batch,
kv head, 64-row k tile) that sums its query group inside, so GQA needs
no second pass; both hold one operand (in registers at head dim 64) and
stream the other through the same kind of ``cp.async`` ring, with the
forward's swizzled tiles, ``ldmatrix`` and log2-unit softmax.  f32 runs
every product on the CUDA cores in full f32.  The kernels take head dims
64 and 128; the wrapper takes 16 and 32 too (the zoo's small encoders:
``finetune_bert``'s 32, ``train_vit``'s 16) by zero-padding q, k and v
along the head dim to 64 (``_pad_head_dim``) with the scale of the real
head dim: a zero column adds nothing to a logit and gives a zero column
of the output and of dq, dk and dv, which are sliced off.  The launches
and their counts are those of head dim 64.  Any other head dim raises.

What bounds it on the H100: at the training shape (b 48, s 256, 12 heads
of 64, causal) bytes, about five times the flops' time, so every kernel
overlaps its tile copies with its products.

Contract (that of the JAX ``flash_attention``): q ``[b, s, h, hd]``, k/v
``[b, s_k, hk, hd]`` with ``h % hk == 0``; an optional ``kv_valid``
``[b, s_k]`` (1 = real key); ``causal`` masks ``q_pos < k_pos`` aligned
top-left; any sequence length; a row with no unmasked key gives 0 and
its backward contributes 0; no dropout inside (``attention_core`` drops
the output).  ``D = rowsum(dO * O)``, plain XLA before the JAX
package's two backward kernels, is computed by the dQ kernel from O
(``_launch_dq_d``), so the backward launches dQ first and dK/dV reads
its D; ``flash_backward_dq`` still takes a given D.

Dispatch is by the tensors' device and nothing else: every public
function here runs its plain version for CPU tensors and launches the
kernel or raises for CUDA tensors.  ``LAUNCHES`` counts kernel launches
("flash_forward", "flash_backward_dkv", "flash_backward_dq").
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_plain",
           "flash_backward_dkv", "flash_backward_dkv_plain",
           "flash_backward_dq", "flash_backward_dq_d_plain",
           "flash_backward_dq_plain", "flash_backward_plain", "flash_forward",
           "flash_forward_plain", "make_flash_attention_fn", "row_dot"]

LAUNCHES: collections.Counter = collections.Counter()

_INF = float("inf")


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _valid_bool(kv_valid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """kv_valid of any type -> bool (``> 0.5``, as the JAX kernel reads
    its f32 mask)."""
    if kv_valid is None:
        return None
    if kv_valid.dtype == torch.bool:
        return kv_valid
    return kv_valid.float() > 0.5


# --------------------------------------------------------------- plain

def _expand_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """[b, s_k, hk, hd] -> [b, s_k, h, hd] f32: query head i reads kv head
    i // group."""
    x = x.float()
    return x.repeat_interleave(group, dim=2) if group > 1 else x


def _logits(q, k, kv_valid, causal, scale):
    """Masked f32 logits [b, h, s, s_k]; masked entries are -inf."""
    group = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _expand_kv(k, group)) * scale
    valid = _valid_bool(kv_valid)
    if valid is not None:
        s = s.masked_fill(~valid[:, None, None, :], -_INF)
    if causal:
        sq, sk = s.shape[-2:]
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~keep, -_INF)
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid: Optional[torch.Tensor] = None,
                          causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The JAX package's ``_reference`` formula (dense f32 softmax, rows
    with no unmasked key zeroed), differentiable through torch."""
    _check_heads(q, k)
    s = _logits(q, k, kv_valid, causal, _scale(q, scale))
    row_any = (s > -_INF).any(dim=-1, keepdim=True)
    w = torch.softmax(torch.where(row_any, s, 0.0), dim=-1)
    w = torch.where(row_any, w, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", w,
                       _expand_kv(v, q.shape[2] // k.shape[2]))
    return out.to(q.dtype)


def flash_forward_plain(q, k, v, kv_valid=None, causal=False, scale=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (out [b, s, h, hd] in q's
    type, lse [b, h, s] f32, -inf on rows with no unmasked key)."""
    s = _logits(q, k, kv_valid, causal, _scale(q, scale))
    lse = torch.logsumexp(s, dim=-1)
    return flash_attention_plain(q, k, v, kv_valid, causal, scale), lse


def _probs_and_ds(q, k, v, kv_valid, do, lse, dvec, causal, scale):
    """The backward's per-entry terms, [b, h, s, s_k] f32:
    ``p = exp(s - lse)`` (0 where lse is -inf) and
    ``ds = p * (dO.V - D) * scale``."""
    scale = _scale(q, scale)
    group = q.shape[2] // k.shape[2]
    s = _logits(q, k, kv_valid, causal, scale)
    live = torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(s - torch.where(live, lse[..., None],
                                                    0.0)), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _expand_kv(v, group))
    return p, p * (dp - dvec[..., None]) * scale


def flash_backward_dkv_plain(q, k, v, kv_valid, do, lse, dvec, causal=False,
                             scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel: ``dv = p^T dO``, ``dk = ds^T Q``,
    summed over each kv head's query group; (dk, dv) in k's type."""
    p, ds = _probs_and_ds(q, k, v, kv_valid, do, lse, dvec, causal, scale)
    b, sk, hk, hd = k.shape
    group = q.shape[2] // hk

    def per_kv_head(w, x):
        y = torch.einsum("bhqk,bqhd->bkhd", w, x.float())
        return y.reshape(b, sk, hk, group, hd).sum(3)
    return per_kv_head(ds, q).to(k.dtype), per_kv_head(p, do).to(v.dtype)


def flash_backward_dq_plain(q, k, v, kv_valid, do, lse, dvec, causal=False,
                            scale=None) -> torch.Tensor:
    """Plain version of the dQ kernel: ``dq = ds K`` in q's type."""
    _, ds = _probs_and_ds(q, k, v, kv_valid, do, lse, dvec, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds,
                      _expand_kv(k, q.shape[2] // k.shape[2]))
    return dq.to(q.dtype)


def flash_backward_dq_d_plain(q, k, v, kv_valid, do, out, lse, causal=False,
                              scale=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dQ kernel given O: (dq, D) with ``D =
    row_dot(do, out)``, as ``_flash_backward`` computes it."""
    dvec = row_dot(do, out)
    return flash_backward_dq_plain(q, k, v, kv_valid, do, lse, dvec, causal,
                                   scale), dvec


def flash_backward_plain(q, k, v, kv_valid, do, out, lse, causal=False,
                         scale=None) -> Tuple[torch.Tensor, ...]:
    """Plain version of the whole backward as ``_Flash`` runs it: (dq, dk,
    dv), D from the dQ step."""
    dq, dvec = flash_backward_dq_d_plain(q, k, v, kv_valid, do, out, lse,
                                         causal, scale)
    return (dq, *flash_backward_dkv_plain(q, k, v, kv_valid, do, lse, dvec,
                                          causal, scale))


# --------------------------------------------------------------- kernels

def _check_heads(q, k):
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"flash_attention requires the q head count to be a multiple "
            f"of the kv head count; got {q.shape[2]} vs {k.shape[2]}")


# head dims the wrapper zero-pads to the kernels' 64 (module docstring)
_PADDED_HEAD_DIMS = {16: 64, 32: 64}


def _pad_head_dim(*tensors: Optional[torch.Tensor]):
    """Each tensor zero-padded along its last dim to the kernels' head
    dim (None stays None); unchanged at 64 and 128."""
    return tuple(t if t is None or t.shape[-1] not in _PADDED_HEAD_DIMS
                 else torch.nn.functional.pad(
                     t, (0, _PADDED_HEAD_DIMS[t.shape[-1]] - t.shape[-1]))
                 for t in tensors)


def _checked(q, k, v, kv_valid, **extra):
    """Validate a launch's operands; returns the valid plane as a
    contiguous bool tensor (1 byte per key) or None."""
    _check_heads(q, k)
    b, sq, h, hd = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or f32; got {q.dtype}")
    if hd not in (16, 32, 64, 128):
        raise ValueError(f"head_dim {hd} unsupported (16, 32, 64 or 128)")
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != hd \
            or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    tensors = {"q": q, "k": k, "v": v, **extra}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    for name in ("k", "v", "do", "out"):
        t = tensors.get(name)
        if t is not None and t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
        if name in ("do", "out") and t is not None and t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
    valid = _valid_bool(kv_valid)
    if valid is not None:
        if valid.shape != (b, k.shape[1]) or valid.device != q.device:
            raise ValueError(f"kv_valid must be [{b}, {k.shape[1]}] on "
                             f"{q.device}")
        valid = valid.contiguous()
    return valid


def _fn(name: str, n_ptrs: int):
    """The bound C entry ``name``: n_ptrs pointers, the type flag and six
    dims, the scale, the causal flag and the stream."""
    return _build.bind("flash_attention", name, [ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])


def _dims(q, k):
    b, sq, h, hd = q.shape
    return (int(q.dtype == torch.bfloat16), b, sq, k.shape[1], h,
            k.shape[2], hd)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_forward(q, k, v, valid, causal, scale):
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                      dtype=torch.float32, device=q.device)
    if q.numel():
        rc = _fn("flash_forward", 6)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid),
            out.data_ptr(), lse.data_ptr(), *_dims(q, k), scale,
            int(causal), _build.stream_ptr(q))
        _build.check(rc, "flash_forward")
        LAUNCHES["flash_forward"] += 1
    return out, lse


def _launch_dkv(q, k, v, valid, do, lse, dvec, causal, scale):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.numel():
        rc = _fn("flash_backward_dkv", 9)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid),
            do.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_dims(q, k), scale, int(causal),
            _build.stream_ptr(q))
        _build.check(rc, "flash_backward_dkv")
        LAUNCHES["flash_backward_dkv"] += 1
    return dk, dv


def _launch_dq(q, k, v, valid, do, lse, dvec, causal, scale, out=None):
    """dQ; given ``out`` (O) the kernel also computes D into ``dvec``,
    else it reads D there."""
    dq = torch.empty_like(q)
    if q.numel():
        rc = _fn("flash_backward_dq", 9)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid),
            do.data_ptr(), _ptr(out), lse.data_ptr(), dvec.data_ptr(),
            dq.data_ptr(), *_dims(q, k), scale, int(causal),
            _build.stream_ptr(q))
        _build.check(rc, "flash_backward_dq")
        LAUNCHES["flash_backward_dq"] += 1
    return dq


def _launch_dq_d(q, k, v, valid, do, out, lse, causal, scale):
    """dQ with D computed in the kernel from O: (dq, D [b, h, s] f32)."""
    dvec = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                       dtype=torch.float32, device=q.device)
    return _launch_dq(q, k, v, valid, do, lse, dvec, causal, scale,
                      out=out), dvec


def _backward(q, k, v, valid, do, out, lse, causal, scale):
    """The backward's launches: dQ, which computes D from O, then dK/dV,
    which reads it; (dq, dk, dv)."""
    dq, dvec = _launch_dq_d(q, k, v, valid, do, out, lse, causal, scale)
    return (dq, *_launch_dkv(q, k, v, valid, do, lse, dvec, causal, scale))


def _check_row_terms(q, lse, dvec):
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("dvec", dvec)):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name} must be f32 {list(want)}")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_valid: Optional[torch.Tensor] = None,
                  causal: bool = False, scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (out [b, s, h, hd] in q's type, lse [b, h, s] f32)."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, kv_valid, causal, scale)
    valid = _checked(q, k, v, kv_valid)
    hd, scale = q.shape[-1], _scale(q, scale)
    out, lse = _launch_forward(*_pad_head_dim(q, k, v), valid, causal, scale)
    return out[..., :hd].contiguous(), lse


def flash_backward_dkv(q, k, v, kv_valid, do, lse, dvec, causal=False,
                       scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK/dV kernel: (dk, dv) [b, s_k, hk, hd] in k's type, each kv head's
    query group summed.  ``dvec`` = ``rowsum(dO * O)`` [b, h, s] f32."""
    if q.device.type == "cpu":
        return flash_backward_dkv_plain(q, k, v, kv_valid, do, lse, dvec,
                                        causal, scale)
    valid = _checked(q, k, v, kv_valid, do=do, lse=lse, dvec=dvec)
    _check_row_terms(q, lse, dvec)
    hd, scale = k.shape[-1], _scale(q, scale)
    dk, dv = _launch_dkv(*_pad_head_dim(q, k, v), valid,
                         *_pad_head_dim(do), lse, dvec, causal, scale)
    return dk[..., :hd].contiguous(), dv[..., :hd].contiguous()


def flash_backward_dq(q, k, v, kv_valid, do, lse, dvec, causal=False,
                      scale=None) -> torch.Tensor:
    """dQ kernel with a given ``dvec`` (D): dq [b, s, h, hd] in q's
    type."""
    if q.device.type == "cpu":
        return flash_backward_dq_plain(q, k, v, kv_valid, do, lse, dvec,
                                       causal, scale)
    valid = _checked(q, k, v, kv_valid, do=do, lse=lse, dvec=dvec)
    _check_row_terms(q, lse, dvec)
    hd, scale = q.shape[-1], _scale(q, scale)
    dq = _launch_dq(*_pad_head_dim(q, k, v), valid, *_pad_head_dim(do), lse,
                    dvec, causal, scale)
    return dq[..., :hd].contiguous()


def row_dot(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dO * O)`` in f32, [b, h, s] (a torch reduction, as it
    is plain XLA in the JAX package)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class _Flash(torch.autograd.Function):
    """The kernels as one differentiable op; residuals (q, k, v, valid,
    out, lse), as the JAX ``custom_vjp`` keeps them.  The backward
    launches dQ, which also computes D from O, then dK/dV, which reads
    that D."""

    @staticmethod
    def forward(ctx, q, k, v, valid, causal, scale):
        out, lse = _launch_forward(q, k, v, valid, causal, scale)
        ctx.save_for_backward(q, k, v, valid, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, valid, out, lse = ctx.saved_tensors
        return (*_backward(q, k, v, valid, do.contiguous(), out, lse,
                           ctx.causal, ctx.scale), None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention, differentiable.  q ``[b, s, h, hd]``; k, v ``[b,
    s_k, hk, hd]`` with ``h % hk == 0``; ``kv_valid`` optional ``[b,
    s_k]`` (1 = real key).  Returns ``[b, s, h, hd]`` in q's type.  CPU
    tensors take ``flash_attention_plain`` (torch autograd); CUDA tensors
    the three kernels, at head dim 16 or 32 on operands zero-padded to 64
    (the padding and the slice are torch ops outside ``_Flash``, so
    autograd carries the gradients through them)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_valid, causal, scale)
    valid = _checked(q, k, v, kv_valid)
    hd, scale = q.shape[-1], _scale(q, scale)
    out = _Flash.apply(*_pad_head_dim(q, k, v), valid, bool(causal), scale)
    return out if out.shape[-1] == hd else out[..., :hd]


def make_flash_attention_fn(causal: bool = False):
    """Adapter for the ``attention_fn(q, k, v, mask=...)`` slot of
    ``ops.attention.attention_core``.  Accepts ``mask=None`` or a padding
    mask ``[b, 1, 1, s_k]`` (additive: 0 keeps, ``NEG_INF`` drops);
    any other mask raises."""
    def fn(q, k, v, mask=None, scale=None):
        kv_valid = None
        if mask is not None:
            if mask.dim() != 4 or mask.shape[1] != 1 or mask.shape[2] != 1:
                raise ValueError("flash attention accepts only padding "
                                 f"masks [b,1,1,s]; got {tuple(mask.shape)}")
            kv_valid = mask[:, 0, 0, :] >= 0.0
        return flash_attention(q, k, v, kv_valid=kv_valid, causal=causal,
                               scale=scale)
    fn.supports_gqa = True      # attention_core: no kv-head broadcast
    return fn
