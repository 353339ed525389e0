"""Next-token selection and finished-row bookkeeping, in PyTorch.

Counterpart of ``resolve_pad``, ``finish_step``, ``filtered_logits`` and
``sample_logits`` of ``distributed_tensorflow_tpu/ops/decoding.py``.
Greedy is ``argmax`` (the first maximum, as ``jnp.argmax``); the sampled
path draws from an explicit ``torch.Generator``, so its numbers differ
from ``jax.random``'s for the same seed.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["filtered_logits", "finish_step", "resolve_pad", "sample_logits"]


def resolve_pad(eos_id: Optional[int], pad_id: Optional[int]) -> Optional[int]:
    """``pad_id`` defaults to ``eos_id`` and is meaningless without one."""
    if pad_id is not None and eos_id is None:
        raise ValueError("pad_id requires eos_id (nothing finishes "
                         "without an EOS to detect)")
    return eos_id if pad_id is None else pad_id


def finish_step(nxt: torch.Tensor, finished: torch.Tensor, eos_id: int,
                pad: int, eligible: Optional[torch.Tensor] = None):
    """Rows already finished emit ``pad``; rows emitting ``eos_id`` (while
    ``eligible``) join the finished set.  Returns (next_tokens, finished)."""
    nxt = torch.where(finished, torch.full_like(nxt, pad), nxt)
    newly = nxt == eos_id
    if eligible is not None:
        newly = newly & eligible
    return nxt, finished | newly


def filtered_logits(logits: torch.Tensor, temperature: float = 1.0,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None) -> torch.Tensor:
    """[b, V] logits after temperature, top-k, then nucleus filtering;
    dropped tokens are -inf.  Requires ``temperature > 0``."""
    logits = logits / temperature
    vocab = logits.shape[-1]
    need_k = top_k is not None and top_k < vocab
    need_p = top_p is not None and top_p < 1.0
    neg = torch.tensor(float("-inf"), dtype=logits.dtype,
                       device=logits.device)
    if need_p:
        # stable: among equal logits the lower id first, as lax.top_k
        sorted_logits, sorted_idx = torch.sort(logits, dim=-1,
                                               descending=True, stable=True)
        if need_k:
            pos = torch.arange(vocab, device=logits.device)[None, :]
            sorted_logits = torch.where(pos < top_k, sorted_logits, neg)
        probs = torch.softmax(sorted_logits, dim=-1)
        # keep while the EXCLUSIVE prefix mass is < p; the top token stays
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep[..., 0] = True
        filtered = torch.where(keep, sorted_logits, neg)
        return torch.full_like(logits, float("-inf")).scatter(
            -1, sorted_idx, filtered)
    if need_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    return logits


def sample_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Next token [b] int32 from [b, V] logits: greedy argmax when
    ``temperature <= 0``, else a draw from the filtered distribution."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(filtered_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
