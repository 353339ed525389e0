"""Next-token selection, finished-row and beam bookkeeping, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/ops/decoding.py``: the
sampling filters, the finished-row bookkeeping, the early-exit decode
loop, the ragged-prompt masks and the beam-search helpers shared by
``GPT.generate`` and ``GPT.beam_search``.  Greedy is ``argmax`` (the
first maximum, as ``jnp.argmax``); the sampled path draws from an
explicit ``torch.Generator``, so its numbers differ from
``jax.random``'s for the same seed.  Ranking among equal values keeps
the lower index first, as ``lax.top_k`` does (``torch.topk`` promises
no order for ties, so the port sorts stably instead).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

__all__ = ["decode_loop", "expand_beams", "filtered_logits", "finish_step",
           "freeze_finished", "init_beam_scores", "ragged_prompt_masks",
           "rank_beams", "resolve_pad", "sample_logits"]


def ragged_prompt_masks(prompt_valid: torch.Tensor,
                        prompt_shape: Tuple[int, int], max_len: int):
    """Validate a LEFT-padded ``prompt_valid`` [b, plen] (1 = real token)
    and derive ``pad_len`` [b] int32 (each row's pad count, for position
    shifting) and ``kv_valid`` [b, max_len] bool (pads False, the
    generated columns True).  Reads the mask's last column on the host
    once: a right-padded mask raises."""
    b, plen = prompt_shape
    if tuple(prompt_valid.shape) != (b, plen):
        raise ValueError(f"prompt_valid shape {tuple(prompt_valid.shape)} "
                         f"!= prompt shape {(b, plen)}")
    pv = prompt_valid.bool()
    if not bool(pv[:, -1].all()):
        raise ValueError("prompt_valid must be LEFT-padded: the last "
                         "prompt column must be all valid")
    pad_len = (plen - pv.sum(dim=1)).to(torch.int32)
    kv_valid = torch.cat(
        [pv, torch.ones((b, max_len - plen), dtype=torch.bool,
                        device=pv.device)], dim=1)
    return pad_len, kv_valid


def decode_loop(advance: Callable, carry, n_steps: int, start: int = 0):
    """Early-exit autoregressive loop: ``carry = advance(carry, i)`` for
    ``i`` in [start, n_steps), stopping as soon as every row has finished
    (``carry[-1]``, the finished mask [b]).  Returns (final carry, the
    index it stopped at).  The exit test reads ``finished.all()`` on the
    host once a step: one sync per generated token."""
    i = start
    while i < n_steps and not bool(carry[-1].all()):
        carry = advance(carry, i)
        i += 1
    return carry, i


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
    neg = logits.new_full((), float("-inf"))   # no host-to-card copy
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


def init_beam_scores(batch: int, beam: int,
                     device=None) -> torch.Tensor:
    """[b, k] f32 scores with only beam 0 alive (the others -inf), so
    identical start beams cannot collapse the search to k copies."""
    alive = torch.arange(beam, device=device) == 0
    row = torch.where(alive, 0.0, float("-inf"))
    return row[None, :].expand(batch, beam).clone()


def freeze_finished(logp: torch.Tensor, finished: torch.Tensor,
                    eos_id: Optional[int]) -> torch.Tensor:
    """Finished beams may only extend with EOS, at zero added cost: their
    score is frozen while still competing in the top-k."""
    if eos_id is None:
        return logp
    # built by a comparison, not an item write: writing a Python number
    # into a card tensor is a host-to-card copy that waits for the stream
    is_eos = torch.arange(logp.shape[-1], device=logp.device) == eos_id
    frozen = torch.where(is_eos, 0.0, float("-inf")).to(logp.dtype)
    return torch.where(finished[:, :, None], frozen[None, None], logp)


def expand_beams(scores: torch.Tensor, logp: torch.Tensor):
    """One beam expansion: ``scores`` [b, k] + ``logp`` [b, k, V] ->
    (new scores [b, k], source beam [b, k] int64, token [b, k] int32).
    The top k of the [b, k*V] candidates in descending order, the lower
    flat index first among equal values (``lax.top_k``'s order; a stable
    sort, since ``torch.topk`` promises none for ties)."""
    b, k, vocab = logp.shape
    flat = (scores[:, :, None] + logp).reshape(b, k * vocab)
    top, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    return top, idx // vocab, (idx % vocab).to(torch.int32)


def rank_beams(scores: torch.Tensor, generated: torch.Tensor,
               eos_id: Optional[int], max_new_tokens: int,
               length_penalty: float) -> torch.Tensor:
    """Best beam index [b] per batch row (GNMT ``score / len^alpha``;
    length = the position of the first EOS in ``generated`` [b, k, T],
    else T); the first best on ties, as ``jnp.argmax``."""
    b, k = scores.shape
    if eos_id is not None:
        is_eos = generated == eos_id
        first = torch.argmax(is_eos.to(torch.int32), dim=-1) + 1
        lengths = torch.where(is_eos.any(-1), first,
                              torch.full_like(first, max_new_tokens))
    else:
        lengths = torch.full((b, k), max_new_tokens, device=scores.device)
    ranked = scores / torch.pow(lengths.float(), length_penalty)
    return torch.argmax(ranked, dim=1)
