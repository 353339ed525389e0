"""Paged attention straight off the page pool: CUDA kernel and plain version.

Replaces the Pallas kernel ``_paged_attention`` of
``distributed_tensorflow_tpu/ops/pallas/paged_attention.py`` (body
``_make_paged_kernel``) and its two entries, ``paged_decode_attention``
and ``paged_window_attention``, in both of its branches: a pool in the
compute dtype, and the int8 pool (``quantized``: int8 K/V with the
``k_scale``/``v_scale`` f32 planes, one scale per token and kv head,
dequantized at the operand).  The kernel is ``csrc/paged_attention.cu``;
its header says how the TPU design was rethought for Hopper.  In short:
the grid is (row x kv head, q-block, split); each split walks a share of
the row's 32-column sub-tiles (split-K, planned here from shapes alone by
:func:`split_plan`) and the last block of a (row, kv head, q-block) to
finish merges the splits' f32 partials in the same launch, through a
per-device workspace and ticket counters.  A decode block scans only its
share of the valid plane, 16 bytes a thread, and compacts its active
sub-tiles with warp ballots; a row with no valid column anywhere is
attended uniformly, decided once by the merge.  Copies are cp.async
gathers through the page table with each page id loaded a sub-tile
ahead.  Every bf16 window runs on the tensor cores (``mma.sync``, one
block holding all of a kv head's query vectors; int8 K/V widened to bf16
once a sub-tile), as does bf16 decode over a bf16 pool; f32 calls and
decode over an int8 pool run on the CUDA cores.  The TPU kernel's exact
finite-mask guards are kept.  The int8 branch folds the k scale into the logit and the v scale into
the softmax weight (equal to dequantizing each element, up to rounding
order).  Head dims 32, 64 and 128, each a native tile (head dim 32: one
dim a lane in the CUDA cores' P V, two k-steps of 16 and four n-tiles of
8 on the tensor cores; nothing is padded, so the pool keeps its bytes).

What bounds it on the H100: bytes (the K/V columns it must read: hd*2
bytes per column per leaf in bf16, hd + 4 in int8, about 0.52x at hd
128); the flops per byte are far below the tensor-core line.  The host
side is one bound C function (``_build.bind``), one guard expression,
shared-memory sizes cached per device and a workspace per (device,
stream): the engines are host-bound.

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
from typing import Dict, Optional, Tuple

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


# Split-K plan: aim for about 4 blocks an SM on the CUDA cores (4-warp
# blocks: two waves at two blocks an SM) and 8 on the tensor cores (a
# decode block there is one warp), a share of at least 4 sub-tiles (one a
# warp) on the CUDA cores and 2 on the tensor cores, and at most 16
# splits to merge (the kernel's kMaxSplits).
_BLOCKS_PER_SM = {False: 4, True: 8}
_MAX_SPLITS = 16
_SUB = 32                 # columns of a sub-tile
_QB = {False: 8, True: 128}   # query vectors a block: CUDA / tensor cores

_FORWARD_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 17
                 + [ctypes.c_float, ctypes.c_void_p])
_sm_counts: Dict[int, int] = {}
_smem: Dict[tuple, int] = {}
# (device, stream) -> (workspace f32, tickets int32, retired buffers)
_scratch: Dict[tuple, tuple] = {}


def tensor_cores(is_bf16: bool, int8: bool, window: bool) -> bool:
    """The route, from the dtypes alone (the card's times, PERF.md): every
    bf16 window and bf16 decode over a bf16 pool on the tensor cores;
    every f32 call and decode over an int8 pool on the CUDA cores."""
    return is_bf16 and (window or not int8)


def split_plan(blocks: int, n_cols: int, sm_count: int,
               tc: bool) -> Tuple[int, int]:
    """(splits, per): how many blocks share each (row, kv head, q-block)
    of a launch with ``blocks`` of them over ``n_cols`` columns, and the
    sub-tiles of 32 columns each split walks (the last may walk fewer).
    From shapes alone, never from the valid plane, so a launch needs no
    device->host read and can be captured in a CUDA graph."""
    n_sub = max(1, -(-n_cols // _SUB))
    want = -(-_BLOCKS_PER_SM[bool(tc)] * sm_count // max(1, blocks))
    splits = max(1, min(want, _MAX_SPLITS, n_sub // (2 if tc else 4)))
    per = -(-n_sub // splits)
    return -(-n_sub // per), per


def launch_plan(B: int, sq: int, h: int, kvh: int, n_cols: int, tc: bool,
                dev: int, splits: Optional[int] = None):
    """(blocks, splits, per) of a launch: ``blocks`` (row, kv head,
    q-block) triples, each split ``splits`` ways in shares of ``per``
    sub-tiles; ``splits`` forces the count (measurement only)."""
    blocks = B * kvh * -(-sq * (h // kvh) // _QB[tc])
    if splits is None:
        return (blocks, *split_plan(blocks, n_cols, _sm_count(dev), tc))
    n_sub = max(1, -(-n_cols // _SUB))
    per = -(-n_sub // min(splits, _MAX_SPLITS))
    return blocks, -(-n_sub // per), per


def _sm_count(dev: int) -> int:
    n = _sm_counts.get(dev)
    if n is None:
        n = _sm_counts[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _smem_bytes(key) -> int:
    n = _smem.get(key)
    if n is None:
        n = _smem[key] = _build.bind(
            "paged_attention", "paged_attention_smem_bytes",
            [ctypes.c_int] * 7, ctypes.c_size_t)(*key)
    return n


def _workspace(dev, stream: int, n_ws: int, n_tickets: int):
    """The split-K workspace (f32) and ticket counters (int32, all 0
    between launches: the merging block of each launch resets its own) of
    one stream on one device.  A stream's launches run in order, so they
    may share them; launches on two streams never do.  Grown at least
    twofold when a launch needs more, and a buffer once handed out is
    never freed: a CUDA graph captured earlier goes on using it."""
    key = (dev, stream)
    ws, tickets, retired = _scratch.get(key, (None, None, []))
    if ws is None or ws.numel() < n_ws or tickets.numel() < n_tickets:
        if ws is not None:
            retired.append((ws, tickets))
            n_ws = max(n_ws, 2 * ws.numel())
            n_tickets = max(n_tickets, 2 * tickets.numel())
        ws = torch.empty(max(n_ws, 1), dtype=torch.float32, device=dev)
        tickets = torch.zeros(max(n_tickets, 1), dtype=torch.int32,
                              device=dev)
        _scratch[key] = (ws, tickets, retired)
    return ws, tickets


def _launch(q, kv, layer, page_tab, valid, pos, *, window, scale,
            splits=None):
    """Launch the kernel; ``splits`` overrides the split plan
    (measurement only)."""
    k_pool, v_pool = kv["k"], kv["v"]
    k_scale, v_scale = kv.get("k_scale"), kv.get("v_scale")
    int8 = k_scale is not None or v_scale is not None
    pool_dtype = torch.int8 if int8 else q.dtype
    B, sq, h, hd = q.shape
    shape = k_pool.shape
    L, num_pages, page_size, kvh = shape[:4]
    P = page_tab.shape[-1]
    dev = q.get_device()
    # one cheap test on the launch path; the message is worked out only
    # when it fails
    if (q.dtype is not torch.bfloat16 and q.dtype is not torch.float32) \
            or k_pool.dtype is not pool_dtype \
            or v_pool.dtype is not pool_dtype or v_pool.shape != shape \
            or shape[4] != hd or h % kvh or page_tab.dtype is not torch.int32 \
            or page_tab.shape != (B, P) or not 0 <= layer < L \
            or k_pool.get_device() != dev or v_pool.get_device() != dev \
            or page_tab.get_device() != dev \
            or not (q.is_contiguous() and k_pool.is_contiguous()
                    and v_pool.is_contiguous() and page_tab.is_contiguous()) \
            or (valid is not None
                and (valid.dtype is not torch.bool
                     or valid.shape != (B, P * page_size)
                     or valid.get_device() != dev
                     or not valid.is_contiguous())) \
            or (int8 and (k_scale is None or v_scale is None
                          or k_scale.dtype is not torch.float32
                          or v_scale.dtype is not torch.float32
                          or k_scale.shape != (*shape[:4], 1)
                          or v_scale.shape != (*shape[:4], 1)
                          or k_scale.get_device() != dev
                          or v_scale.get_device() != dev
                          or not (k_scale.is_contiguous()
                                  and v_scale.is_contiguous()))):
        _refuse(q, kv, layer, page_tab, valid)
    is_bf16 = q.dtype is torch.bfloat16
    tc = tensor_cores(is_bf16, int8, window)
    view_len = P * page_size
    n_cols = min(view_len, pos + sq) if window else view_len
    blocks, splits, per = launch_plan(B, sq, h, kvh, n_cols, tc, dev, splits)
    smem = _smem_bytes((int(is_bf16), int(int8), hd, int(tc), int(window),
                        h // kvh, per))
    if smem == 0 or smem > _SMEM_LIMIT:
        _refuse_shape(k_pool, hd, view_len, smem, tc)
    stream = _build.stream_ptr(q)
    ws, tickets = _workspace(dev, stream, blocks * splits * _QB[tc] * (hd + 4)
                             if splits > 1 else 0, blocks)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    rc = _build.bind("paged_attention", "paged_attention_forward",
                     _FORWARD_ARGS)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None, page_tab.data_ptr(),
        valid.data_ptr() if valid is not None else None, out.data_ptr(),
        ws.data_ptr(), tickets.data_ptr(), is_bf16, int8, window, tc, B, sq,
        h, kvh, hd, num_pages, page_size, P, layer, pos, n_cols, splits, per,
        scale, stream)
    _build.check(rc, "paged_attention_forward")
    LAUNCHES[("paged_window" if window else "paged_decode")
             + ("_int8" if int8 else "")] += 1
    return out


def _refuse(q, kv, layer, page_tab, valid):
    """Raise with what the paged kernel cannot take."""
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
    raise ValueError(f"layer {layer} outside [0, {L})")


def _refuse_shape(k_pool, hd, view_len, smem, tc):
    if smem == 0:
        raise ValueError(f"head_dim {hd} unsupported (32, 64 or 128)")
    raise ValueError(f"a view of {view_len} columns at head_dim {hd} "
                     f"({k_pool.dtype} pool, {'tensor' if tc else 'CUDA'} "
                     f"cores) needs {smem} bytes of shared memory per block; "
                     f"the card gives {_SMEM_LIMIT}")


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
