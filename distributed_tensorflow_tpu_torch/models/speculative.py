"""Speculative decoding: a small draft model proposes, the target verifies.

Counterpart of ``distributed_tensorflow_tpu/models/speculative.py``.
Each round the DRAFT decodes ``gamma`` tokens with its own contiguous
KV cache (``GPT.decode_step``), then the TARGET scores the window
``[current, d_1..d_gamma]`` in one ``GPT.decode_window``.  Greedy
(``temperature <= 0``): the longest prefix of drafts equal to the
target's argmax is kept, followed by the target's own token (the
correction, or the bonus after a clean sweep), so the output is the
target's greedy decode and each round emits 1..gamma+1 tokens for one
target forward.  Sampled: ``speculative_accept``'s rejection rule
(Leviathan et al. 2023), whose emitted tokens follow the target's
filtered distribution exactly; both sides draw from the same
``ops.decoding.filtered_logits``.

Rollback costs nothing: rejected columns stay in both caches, hidden by
moving ``pos`` back, and the next round's window overwrites them.  The
round loop runs on the host and reads the round's accepted count (and,
with ``eos_id``, whether it stopped) once a round: one sync per 1 to
gamma+1 emitted tokens.  Batch 1 only: speculation is the latency play.

One numerical caveat, as in the JAX package: corrections argmax
``decode_window`` logits where ``generate`` argmaxes ``decode_step``
logits, two reductions that agree to round-off, so a near-tie can flip
a token between the two paths (more often in bf16).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import decoding as dec

__all__ = ["generate_speculative", "speculative_accept"]


def speculative_accept(p: torch.Tensor, q: torch.Tensor,
                       drafts: torch.Tensor,
                       generator: Optional[torch.Generator] = None):
    """The rejection-sampling acceptance rule: accept draft ``d_k ~ q_k``
    with probability ``min(1, p_k(d_k) / q_k(d_k))``; at the first
    rejection emit a token from ``norm(max(0, p_n - q_n))``; after a clean
    sweep emit the bonus from ``p_gamma``.  The emitted prefix is then
    distributed as sampling from ``p`` token by token.

    ``p`` [..., gamma+1, V] target probabilities (row k for the token
    after k accepted drafts), ``q`` [..., gamma, V] the draft's,
    ``drafts`` [..., gamma] int; leading dims are independent rounds.
    Returns (n accepted [...] int64, emit [..., gamma+1] int32: rows
    ``< n`` the accepted drafts, row ``n`` the residual or bonus draw).
    Draws from ``generator`` (on p's device)."""
    lead = drafts.shape[:-1]
    gamma, vocab = drafts.shape[-1], p.shape[-1]
    p = p.reshape(-1, gamma + 1, vocab)
    q = q.reshape(-1, gamma, vocab)
    drafts = drafts.reshape(-1, gamma).long()
    rounds = drafts.shape[0]
    u = torch.rand((rounds, gamma), generator=generator, device=p.device)
    p_d = p[:, :gamma].gather(2, drafts[:, :, None])[:, :, 0]
    q_d = q.gather(2, drafts[:, :, None])[:, :, 0]
    # strict, so a draft the filtered target excludes (p_d == 0) is never
    # accepted, even at u == 0; p_d >= q_d always accepts (u*q_d < q_d)
    accept = u * q_d < p_d
    n = torch.cumprod(accept.long(), dim=1).sum(dim=1)           # [R]
    q_pad = torch.cat([q, torch.zeros_like(p[:, :1])], dim=1)
    rows = torch.arange(rounds, device=p.device)
    p_n = p[rows, n]
    res = torch.clamp(p_n - q_pad[rows, n], min=0.0)
    tot = res.sum(dim=-1, keepdim=True)
    # tot == 0 only where p == q (acceptance certain, the draw unused)
    res = torch.where(tot > 0, res / torch.clamp(tot, min=1e-20), p_n)
    corr = torch.multinomial(res, 1, generator=generator)        # [R, 1]
    prefix = torch.cat([drafts, drafts[:, -1:]], dim=1)
    idx = torch.arange(gamma + 1, device=p.device)[None, :]
    emit = torch.where(idx < n[:, None], prefix, corr).to(torch.int32)
    return n.reshape(lead), emit.reshape(*lead, gamma + 1)


@torch.no_grad()
def generate_speculative(target_model, draft_model, prompt_ids,
                         max_new_tokens: int, gamma: int = 4,
                         temperature: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         max_len: Optional[int] = None,
                         prefill_chunk: Optional[int] = None,
                         eos_id: Optional[int] = None,
                         pad_id: Optional[int] = None,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None):
    """Speculative decode of one prompt; returns (tokens [1, plen + new]
    int32 on the target's device, accepted fraction: the share of draft
    proposals kept, a float).

    ``target_model``/``draft_model``: port ``GPT``s on one device sharing
    the vocabulary.  ``temperature <= 0``: greedy longest-prefix
    acceptance (the target's greedy decode).  ``temperature > 0``:
    rejection sampling from ``generator``, with ``top_k``/``top_p``
    applied to both sides.  ``prefill_chunk``: both prompts prefill
    through ``decode_window`` windows.  ``eos_id``: generation stops at
    the first emitted EOS; later columns hold ``pad_id`` (default
    ``eos_id``)."""
    prompt_ids = torch.as_tensor(prompt_ids)
    b, plen = prompt_ids.shape
    if b != 1:
        raise ValueError(
            f"speculative decoding is the batch-1 latency path; got "
            f"batch {b} (run generate() for throughput batching)")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1; got {gamma}")
    total = plen + max_new_tokens
    if max_len is not None and total > max_len:
        raise ValueError(f"prompt ({plen}) + max_new_tokens "
                         f"({max_new_tokens}) = {total} exceeds "
                         f"max_len {max_len}")
    # the last round starts at i <= total-2, so windows write columns up
    # to total+gamma-1 and embed positions up to total+gamma-2; the
    # scratch tail is cut off before returning
    scratch = total + gamma
    for model, which in ((target_model, "target"), (draft_model, "draft")):
        c = model.config
        if (c.position_embedding == "learned"
                and c.max_position < scratch - 1):
            raise ValueError(
                f"{which} model's learned position table ({c.max_position}"
                f") is smaller than plen + max_new_tokens + gamma - 1 = "
                f"{scratch - 1}: speculative windows need that headroom")
    sampled = temperature > 0
    resolved = dec.resolve_pad(eos_id, pad_id)
    pad = 0 if resolved is None else resolved
    dev = target_model.device
    ids = prompt_ids.to(dev, torch.int32)

    t_cache = target_model.init_cache(1, scratch)
    d_cache = draft_model.init_cache(1, scratch)
    tokens = torch.full((1, scratch), pad, dtype=torch.int32, device=dev)
    tokens[:, :plen] = ids
    logits, t_cache = target_model.prefill_cache(t_cache, ids,
                                                 chunk=prefill_chunk)
    first = dec.sample_logits(logits, temperature, top_k, top_p,
                              generator=generator)             # [1]
    tokens[:, plen] = first
    _, d_cache = draft_model.prefill_cache(d_cache, ids, chunk=prefill_chunk)
    finished = eos_id is not None and int(first[0]) == eos_id

    i, n_acc, n_prop = plen, 0, 0
    idx = torch.arange(gamma + 1, device=dev)
    while i < total - 1 and not finished:
        # the draft takes gamma+1 steps from tokens[i]: the last consumes
        # its own final proposal, so its cache holds every window column
        # even after a clean sweep (that prediction is discarded)
        tok = tokens[:, i]
        proposals, q_rows = [], []
        for _ in range(gamma + 1):
            lg, d_cache = draft_model.decode_step(d_cache, tok)
            if sampled:
                fl = dec.filtered_logits(lg, temperature, top_k, top_p)
                probs = torch.softmax(fl, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[
                    :, 0].to(torch.int32)
                q_rows.append(probs[0])
            else:
                tok = torch.argmax(lg, dim=-1).to(torch.int32)
            proposals.append(tok)
        drafts = torch.cat(proposals[:gamma])                   # [gamma]

        window = torch.cat([tokens[0, i:i + 1], drafts])[None, :]
        logits, t_cache = target_model.decode_window(t_cache, window)
        if sampled:
            p = torch.softmax(dec.filtered_logits(
                logits[0], temperature, top_k, top_p), dim=-1)
            n, emit = speculative_accept(p, torch.stack(q_rows[:gamma]),
                                         drafts, generator=generator)
        else:
            greedy = torch.argmax(logits[0], dim=-1).to(torch.int32)
            n = torch.cumprod((drafts == greedy[:gamma]).long(), 0).sum()
            emit = torch.where(idx < n, torch.cat([drafts, drafts[-1:]]),
                               greedy)
        n_emit = torch.clamp(n + 1, max=total - 1 - i)
        stop = torch.zeros((), dtype=torch.bool, device=dev)
        if eos_id is not None:
            # stop at the FIRST emitted EOS: truncate the round there
            is_eos = (emit == eos_id) & (idx < n_emit)
            first_eos = torch.where(is_eos, idx, gamma + 1).min()
            stop = is_eos.any()
            n_emit = torch.minimum(n_emit, first_eos + 1)
            emit = torch.where(idx < n_emit, emit, pad)
        tokens[0, i + 1:i + gamma + 2] = emit
        n_host, n_emit_host, stop_host = torch.stack(
            [n, n_emit, stop.long()]).tolist()          # the round's sync
        # rollback = move pos; stale columns are hidden, then overwritten
        i += n_emit_host
        t_cache = dict(t_cache, pos=i)
        d_cache = dict(d_cache, pos=i)
        n_acc += min(n_host, n_emit_host)
        n_prop += gamma
        finished = bool(stop_host)
    return tokens[:, :total], n_acc / max(n_prop, 1)
