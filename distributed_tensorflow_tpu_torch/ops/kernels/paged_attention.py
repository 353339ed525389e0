"""Paged attention straight off the page pool: CUDA kernel and plain version.

Replaces the Pallas kernel ``_paged_attention`` of
``distributed_tensorflow_tpu/ops/pallas/paged_attention.py`` (body
``_make_paged_kernel``) and its two entries, ``paged_decode_attention``
and ``paged_window_attention``, in both of its branches: a pool in the
compute dtype, and the int8 pool (``quantized``: int8 K/V with the
``k_scale``/``v_scale`` f32 planes, one scale per token and kv head,
dequantized at the operand).  The kernel is ``csrc/paged_attention.cu``;
its header says how the TPU design was rethought for Hopper.  In short:
a block per (row, kv head, up to 8 query vectors); its 4 warps take the
row's 32-column sub-tiles in turn, walking the page table inside the
kernel, copying the next sub-tile's K/V (and, int8, their scales) with
cp.async while computing on the current one, each with f32
online-softmax state in registers, merged at the end; the TPU kernel's
exact finite-mask guards are kept.  The int8 branch is the same kernel
over a third element type: it folds the k scale into the logit and the
v scale into the softmax weight (equal to dequantizing each element,
up to f32 rounding order).  Head dims 64 and 128.

What bounds it on the H100: bytes (the K/V columns it must read: hd*2
bytes per column per leaf in bf16, hd + 4 in int8, about 0.52x at hd
128); the flops per byte are far below the tensor-core line.  The
design reads only sub-tiles that hold an unmasked column and keeps every
intermediate on chip; it does not yet split the page walk across
blocks, so at decode batch 8 (64 to 96 blocks) some SMs idle and a long
row is walked serially: at Llama-3-8B's decode shape (8192-column rows)
the kernel is latency-bound, int8 and bf16 alike (``PERF.md``).

Page-size rule: any ``page_size >= 1`` dividing ``max_len``.  The
kernel gathers per column, so Mosaic's multiple-of-8 rule does not
apply; the scheduler picks ``auto_page_size(max_len, 16)``.

Dispatch is by the tensors' device and nothing else.  For CPU tensors the
wrappers run the plain version: the gather of the row's pages into a
contiguous ``[b, view_len, kv_heads, head_dim]`` operand, then
``dot_product_attention`` (int8: the gathered pages dequantized in f32,
``q.float() * scale`` as the Pallas body does, attention in f32, output
in q's type).  For CUDA tensors they launch the kernel or raise; there
is no fallback.  ``LAUNCHES`` counts kernel launches per entry point and
branch: ``paged_decode``, ``paged_window``, ``paged_decode_int8``,
``paged_window_int8``.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Dict, Optional

import torch

from ..attention import NEG_INF, dot_product_attention
from . import _build

__all__ = ["LAUNCHES", "paged_decode_attention",
           "paged_decode_attention_plain", "paged_layer_kv",
           "paged_window_attention", "paged_window_attention_plain"]

# kernel launches per entry point and branch ("paged_decode",
# "paged_window", "paged_decode_int8", "paged_window_int8")
LAUNCHES: collections.Counter = collections.Counter()

_SMEM_LIMIT = 232448      # bytes of shared memory one block may use


def paged_layer_kv(kv: Dict[str, torch.Tensor], layer: int,
                   page_tab: torch.Tensor):
    """Layer ``layer``'s (k, v) gathered through ``page_tab`` [b, P] into
    ``[b, P * page_size, kv_heads, head_dim]`` (the plain read path).
    An int8 pool comes back dequantized in f32 (``k * k_scale``)."""
    def view(name):
        g = kv[name][layer][page_tab.long()]       # [b, P, pg, kvh, x]
        return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])
    k, v = view("k"), view("v")
    if "k_scale" in kv:
        k = k.float() * view("k_scale")
        v = v.float() * view("v_scale")
    return k, v


def _plain(q, kv, layer, page_tab, mask, scale):
    k, v = paged_layer_kv(kv, layer, page_tab)
    if "k_scale" not in kv:
        return dot_product_attention(q, k, v, mask=mask, scale=scale)
    return dot_product_attention(q.float(), k, v, mask=mask,
                                 scale=scale).to(q.dtype)


def paged_decode_attention_plain(q, kv, layer, page_tab, valid, *,
                                 scale=None):
    """Plain version of the decode kernel: gather + masked softmax."""
    mask = torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    return _plain(q, kv, layer, page_tab, mask, scale)


def paged_window_attention_plain(q, kv, layer, page_row, pos, *, scale=None):
    """Plain version of the window kernel: gather the row, then row j of
    the window attends columns ``<= pos + j``."""
    s, view_len = q.shape[1], page_row.shape[0] * kv["k"].shape[2]
    col = torch.arange(view_len, device=q.device)[None, :]
    row = pos + torch.arange(s, device=q.device)[:, None]
    mask = torch.where(col <= row, 0.0, NEG_INF)[None, None]
    return _plain(q, kv, layer, page_row[None, :], mask, scale)


def _launch(q, kv, layer, page_tab, valid, pos, *, window, scale):
    k_pool, v_pool = kv["k"], kv["v"]
    int8 = "k_scale" in kv or "v_scale" in kv
    tensors = {"q": q, "k": k_pool, "v": v_pool, "page_tab": page_tab}
    if int8:
        tensors["k_scale"] = kv.get("k_scale")
        tensors["v_scale"] = kv.get("v_scale")
        if tensors["k_scale"] is None or tensors["v_scale"] is None:
            raise ValueError("an int8 pool needs both k_scale and v_scale")
    if valid is not None:
        tensors["valid"] = valid
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or f32; got {q.dtype}")
    pool_dtype = torch.int8 if int8 else q.dtype
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        want = ("int8 beside scale planes" if int8
                else f"q's type {q.dtype} without scale planes")
        raise TypeError(f"pool {k_pool.dtype}/{v_pool.dtype}: expected "
                        f"{want}")
    if int8:
        sshape = (*k_pool.shape[:-1], 1)
        for name in ("k_scale", "v_scale"):
            t = tensors[name]
            if t.dtype != torch.float32 or tuple(t.shape) != sshape:
                raise ValueError(f"{name} must be f32 {sshape}; got "
                                 f"{t.dtype} {tuple(t.shape)}")
    if page_tab.dtype != torch.int32:
        raise TypeError(f"page_tab must be int32; got {page_tab.dtype}")
    B, sq, h, hd = q.shape
    L, num_pages, page_size, kvh, hd_k = k_pool.shape
    P = page_tab.shape[-1]
    if v_pool.shape != k_pool.shape or hd_k != hd or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not match pool "
                         f"{tuple(k_pool.shape)}")
    if page_tab.shape != (B, P):
        raise ValueError(f"page_tab {tuple(page_tab.shape)} != ({B}, {P})")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (B, P * page_size)):
        raise ValueError(f"valid must be bool [{B}, {P * page_size}]")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [
        ctypes.c_float, ctypes.c_void_p]
    size = lib.paged_attention_smem_bytes
    size.restype = ctypes.c_size_t
    size.argtypes = [ctypes.c_int] * 4
    is_bf16 = int(q.dtype == torch.bfloat16)
    smem = size(is_bf16, int(int8), hd, P * page_size)
    if smem == 0:
        raise ValueError(f"head_dim {hd} unsupported (64 or 128)")
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a view of {P * page_size} columns at head_dim "
                         f"{hd} ({k_pool.dtype} pool) needs {smem} bytes of "
                         f"shared memory per block; the card gives "
                         f"{_SMEM_LIMIT}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)

    def ptr(name):
        t = tensors.get(name)
        return t.data_ptr() if t is not None else None
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            ptr("k_scale"), ptr("v_scale"), page_tab.data_ptr(),
            ptr("valid"), out.data_ptr(), is_bf16, int(int8), int(window),
            B, sq, h, kvh, hd, num_pages, page_size, P, int(layer), int(pos),
            float(scale), _build.stream_ptr(q))
    _build.check(rc, "paged_attention_forward")
    LAUNCHES[("paged_window" if window else "paged_decode")
             + ("_int8" if int8 else "")] += 1
    return out


def paged_decode_attention(q: torch.Tensor, kv: Dict[str, torch.Tensor],
                           layer: int, page_tab: torch.Tensor,
                           valid: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """s=1 decode attention off the page pool.

    q [S, 1, h, hd] bf16 or f32; ``kv`` the pool leaves ``k``/``v`` [L,
    NP, pg, kvh, hd] in q's type, or int8 with ``k_scale``/``v_scale``
    f32 [L, NP, pg, kvh, 1]; page_tab [S, P] int32; valid [S, P * pg] bool (the kv-valid
    window OR the row's own column).  Returns [S, 1, h, hd].  The page
    ids are trusted: the scheduler only hands out pages of the pool."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, kv, layer, page_tab, valid,
                                            scale=scale)
    return _launch(q, kv, layer, page_tab, valid, 0, window=False,
                   scale=scale)


def paged_window_attention(q: torch.Tensor, kv: Dict[str, torch.Tensor],
                           layer: int, page_row: torch.Tensor, pos: int, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Prefill-window attention for ONE row: q [1, s, h, hd], page_row
    [P] int32, ``pos`` the logical column of the window's first token.
    Row j attends columns ``<= pos + j``.  Returns [1, s, h, hd]."""
    if q.device.type == "cpu":
        return paged_window_attention_plain(q, kv, layer, page_row, pos,
                                            scale=scale)
    return _launch(q, kv, layer, page_row[None, :], None, pos, window=True,
                   scale=scale)
