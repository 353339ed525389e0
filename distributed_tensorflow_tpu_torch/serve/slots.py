"""Contiguous slot cache: the state layer of the ``paged=False`` engine.

Counterpart of ``distributed_tensorflow_tpu/serve/slots.py``.  The batch
dimension of ``GPT.init_cache`` becomes a bank of ``num_slots`` slots,
each holding one in-flight request, with per-slot state in place of the
cache's ``pos``:

* ``kv``: the cache leaves without ``pos`` (``[L, num_slots, max_len,
  kv_heads, head_dim]``, int8 beside f32 scale planes under
  ``kv_cache_dtype="int8"``);
* ``start_col``/``write_col`` [S] int32: the slot's valid columns
  ``[start_col, write_col)`` (left pads before ``start_col`` after a
  ragged splice; stale or unwritten columns from ``write_col`` on), so
  validity is two ints a slot and the [S, max_len] mask is derived per
  step (``slot_kv_valid``);
* ``positions`` [S] int32: the slot's next position index.

Retiring a slot is host bookkeeping only: its columns fall outside the
next occupant's window, and a masked column's weight is exp(NEG_INF) =
0, so ``insert_slot`` never scrubs a row.  The device tensors are
written in place (the JAX package donates them instead).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from ..models.gpt import GPT

__all__ = ["decode_slots_step", "init_slot_cache", "insert_slot",
           "slot_kv_valid", "strip_pos"]


# The K/V leaves of an ``init_cache`` dict, without ``pos``.
strip_pos = GPT._cache_kv


def init_slot_cache(model, num_slots: int, max_len: int) -> Dict[str, Any]:
    """An empty slot cache on the model's device: ``init_cache(num_slots,
    max_len)``'s leaves and per-slot int32 column state; every slot
    starts retired (an empty window at column 0)."""
    kv = strip_pos(model.init_cache(num_slots, max_len))

    def col():
        return torch.zeros((num_slots,), dtype=torch.int32,
                           device=model.device)
    return {"kv": kv, "start_col": col(), "write_col": col(),
            "positions": col()}


def slot_kv_valid(cache: Mapping[str, Any]) -> torch.Tensor:
    """[S, max_len] bool: each slot's valid columns."""
    cols = torch.arange(cache["kv"]["k"].shape[2],
                        device=cache["write_col"].device)[None, :]
    return ((cols >= cache["start_col"][:, None])
            & (cols < cache["write_col"][:, None]))


def insert_slot(cache: Dict[str, Any], slot_idx: int,
                prefilled: Mapping[str, torch.Tensor], length: int,
                pad_len: int = 0) -> Dict[str, Any]:
    """Splice a prefilled request into slot ``slot_idx``, in place.

    ``prefilled``: the leaves (``strip_pos``) of a batch-1 cache of the
    same max_len and dtypes (a ``decode_window`` chunked prefill or a
    ``decode_block``); the whole row is copied, int8 scale planes too, so
    a quantized cache round-trips bit for bit.  ``length``: the
    request's real token count; ``pad_len``: left-pad columns before them
    (a row of a left-padded ragged block).  The slot's window becomes
    ``[pad_len, pad_len + length)``, its write head ``pad_len + length``,
    its position index ``length``; every other column stays masked.
    Returns ``cache``."""
    for name, buf in cache["kv"].items():
        buf[:, slot_idx].copy_(prefilled[name][:, 0])
    cache["start_col"][slot_idx] = pad_len
    cache["write_col"][slot_idx] = pad_len + length
    cache["positions"][slot_idx] = length
    return cache


def decode_slots_step(model, cache: Mapping[str, Any], tokens: torch.Tensor,
                      live: torch.Tensor, adapters=None,
                      adapter_rows: Optional[torch.Tensor] = None):
    """One decode step for every slot -> (logits [S, vocab], new cache).

    ``tokens`` [S]: each slot's input token.  Dead rows compute too, but
    only ``live`` rows advance ``write_col``/``positions``, so a dead
    row's write lands outside every validity window (or, at max_len, is
    dropped) and the next ``insert_slot`` overwrites it.
    ``adapters``/``adapter_rows`` [S]: per-slot LoRA adapters (None: no
    adapter work).  The K/V leaves are written in place; the column
    state is rebound."""
    logits, kv = model.decode_step_slots(
        cache["kv"], tokens, cache["write_col"], slot_kv_valid(cache),
        cache["positions"], adapters=adapters, adapter_rows=adapter_rows)
    live = live.to(torch.int32)
    return logits, {
        "kv": kv,
        "start_col": cache["start_col"],
        "write_col": cache["write_col"] + live,
        "positions": cache["positions"] + live,
    }
