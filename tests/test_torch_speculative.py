"""The port's speculative decoding held against the JAX package.

Greedy ``generate_speculative`` must emit the JAX package's tokens for
the same weights and prompt, and equal the port's own greedy
``generate`` (the draft only amortizes target forwards): with the target
as its own draft, with a draft made of the target's first layer (as the
JAX bench row's layer-truncated draft), at gamma 1, with a chunked
prefill into an int8 cache, and stopping at EOS.

The rejection rule ``speculative_accept`` is held by its edge cases (p >=
q always accepts; a draft the target gives probability 0 never does; the
residual's ``tot == 0`` branch falls back to p) and by a Monte-Carlo
check of the emitted law with a fixed ``torch.Generator``: first tokens
follow p[0], bonus tokens p[1] (as tests/test_speculative.py checks the
JAX one; the bits differ from ``jax.random``'s, the law must not).  The
sampled path keeps every token inside the filtered support.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.models.speculative import \
    generate_speculative as jspec
from distributed_tensorflow_tpu.models.speculative import \
    speculative_accept as jaccept
from distributed_tensorflow_tpu_torch import (GPT, GPTConfig,
                                              generate_speculative,
                                              load_jax_params,
                                              speculative_accept)

torch.set_num_threads(1)

_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
           "intermediate_size", "max_position", "layer_norm_eps",
           "num_kv_heads", "position_embedding", "rope_base", "norm",
           "ffn_activation", "use_bias", "tied_head", "kv_cache_dtype")


def _port(jmodel, jparams):
    config = GPTConfig(dropout_rate=0.0, **{
        f: getattr(jmodel.config, f) for f in _FIELDS})
    return load_jax_params(GPT(config, device="cpu"),
                           jax.tree.map(np.asarray, jparams))


@functools.lru_cache(maxsize=None)
def _pair(kv_cache_dtype=None, draft_layers=None):
    """(JAX target, params, port target, JAX draft, params, port draft):
    the draft is the target itself, or its first ``draft_layers`` layers
    under the same embeddings, final norm and head."""
    kw = dict(dropout_rate=0.0, hidden_size=64, max_position=64,
              kv_cache_dtype=kv_cache_dtype)
    jt = jgpt_tiny(**kw)
    jtp = jt.init(jax.random.PRNGKey(0))
    if draft_layers is None:
        jd, jdp = jt, jtp
    else:
        jd = jgpt_tiny(num_layers=draft_layers, **kw)
        jdp = dict(jtp, decoder=jax.tree.map(lambda a: a[:draft_layers],
                                             jtp["decoder"]))
    return jt, jtp, _port(jt, jtp), jd, jdp, _port(jd, jdp)


def _prompt(s, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (1, s),
                                                dtype=np.int32)


_CASES = {
    "self_draft": (dict(), dict(gamma=4)),
    "truncated_draft": (dict(draft_layers=1), dict(gamma=3)),
    "gamma1": (dict(), dict(gamma=1)),
    "chunked_int8": (dict(kv_cache_dtype="int8"),
                     dict(gamma=3, prefill_chunk=2)),
    "eos": (dict(draft_layers=1), dict(gamma=3, eos_id="picked")),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_greedy_speculative_matches_jax_and_generate(case):
    pair_kw, kw = _CASES[case]
    jt, jtp, tt, jd, jdp, td = _pair(**pair_kw)
    prompt = _prompt(6)
    new = 12
    gen_kw = {k: v for k, v in kw.items() if k == "prefill_chunk"}
    if kw.get("eos_id") == "picked":
        free = tt.generate(torch.from_numpy(prompt), new)
        kw = dict(kw, eos_id=int(free[0, 6 + 7]))   # emitted mid-way
        gen_kw["eos_id"] = kw["eos_id"]
    want, jacc = jspec(jt, jtp, jd, jdp, jnp.asarray(prompt), new, **kw)
    got, acc = generate_speculative(tt, td, torch.from_numpy(prompt), new,
                                    **kw)
    assert got.shape == (1, 6 + new) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), tt.generate(torch.from_numpy(prompt), new,
                                 **gen_kw).numpy())
    assert acc == pytest.approx(float(jacc), abs=1e-6)
    if "eos_id" in kw:
        row = got[0, 6:].tolist()
        stop = row.index(kw["eos_id"])
        assert stop < new - 1 and set(row[stop:]) == {kw["eos_id"]}


# -------------------------------------------------------- the accept rule

def _accept_both(p, q, drafts, seed=0):
    n, emit = speculative_accept(torch.from_numpy(p), torch.from_numpy(q),
                                 torch.from_numpy(drafts),
                                 generator=torch.Generator().manual_seed(
                                     seed))
    jn, jemit = jaccept(jax.random.PRNGKey(seed), jnp.asarray(p),
                        jnp.asarray(q), jnp.asarray(drafts))
    return int(n), emit.tolist(), int(jn), np.asarray(jemit).tolist()


def test_speculative_accept_edge_cases():
    vocab, gamma = 6, 3
    rng = np.random.default_rng(0)
    q = rng.dirichlet(np.ones(vocab), gamma).astype(np.float32)
    drafts = np.array([1, 4, 2], np.int32)
    # p >= q at every draft: always accepted, the bonus drawn from p[gamma]
    p = rng.dirichlet(np.ones(vocab), gamma + 1).astype(np.float32)
    for k, d in enumerate(drafts):
        p[k] = 0.0
        p[k, d] = 1.0
    for seed in range(20):
        n, emit, jn, jemit = _accept_both(p, q, drafts, seed)
        assert n == jn == gamma
        assert emit[:gamma] == jemit[:gamma] == drafts.tolist()
        assert p[gamma, emit[gamma]] > 0
    # p(d_0) = 0: never accepted, and the correction is never d_0
    p0 = p.copy()
    p0[0] = rng.dirichlet(np.ones(vocab)).astype(np.float32)
    p0[0, drafts[0]] = 0.0
    p0[0] /= p0[0].sum()
    for seed in range(20):
        n, emit, jn, jemit = _accept_both(p0, q, drafts, seed)
        assert n == jn == 0
        assert emit[0] != drafts[0] and jemit[0] != drafts[0]
        assert p0[0, emit[0]] > 0
    # the rejection row equals q there: max(p - q, 0) sums to 0, so the
    # draw falls back to p itself (only a zero-probability draft gets
    # here: it is rejected although p == q)
    pz = p.copy()
    qz = q.copy()
    qz[0, drafts[0]] = 0.0
    qz[0] /= qz[0].sum()
    pz[0] = qz[0]
    for seed in range(20):
        n, emit, jn, _ = _accept_both(pz, qz, drafts, seed)
        assert n == jn == 0
        assert pz[0, emit[0]] > 0


def test_speculative_accept_preserves_target_distribution():
    """Monte Carlo at gamma 1, vocab 8, 200,000 rounds in one batched
    call: first-emitted frequencies match p[0], bonus frequencies (on
    accepted rounds) match p[1], the tolerances of the JAX test."""
    vocab, trials = 8, 200_000
    p0 = np.asarray([.30, .20, .15, .10, .10, .08, .05, .02], np.float32)
    q0 = np.asarray([.10, .30, .05, .20, .05, .10, .05, .15], np.float32)
    p1 = np.asarray([.05, .05, .40, .10, .10, .10, .10, .10], np.float32)
    gen = torch.Generator().manual_seed(0)
    drafts = torch.multinomial(torch.from_numpy(q0).expand(trials, vocab), 1,
                               replacement=True, generator=gen)
    p = torch.from_numpy(np.stack([p0, p1]))[None].expand(trials, 2, vocab)
    q = torch.from_numpy(q0)[None, None].expand(trials, 1, vocab)
    n, emit = speculative_accept(p, q, drafts, generator=gen)
    assert n.shape == (trials,) and emit.shape == (trials, 2)
    freq = np.bincount(emit[:, 0].numpy(), minlength=vocab) / trials
    np.testing.assert_allclose(freq, p0, atol=5e-3)
    acc = (n == 1).numpy()
    freq_b = (np.bincount(emit[:, 1].numpy()[acc], minlength=vocab)
              / max(acc.sum(), 1))
    np.testing.assert_allclose(freq_b, p1, atol=8e-3)


def test_sampled_speculative_stays_in_filtered_support():
    """top_k on the sampled path: re-scored against the target's
    teacher-forced logits, every emitted token ranks below k; another
    generator seed gives another continuation."""
    _, _, tt, _, _, td = _pair(draft_layers=1)
    prompt = torch.from_numpy(_prompt(4))
    k = 5
    out, acc = generate_speculative(
        tt, td, prompt, 12, gamma=3, temperature=1.0, top_k=k,
        generator=torch.Generator().manual_seed(3))
    assert out.shape == (1, 16) and 0.0 <= acc <= 1.0
    assert torch.equal(out[:, :4], prompt)
    with torch.no_grad():
        lg = tt.logits(tt.apply(out[:, :-1]))[0, 3:]
    for t, tok in enumerate(out[0, 4:].tolist()):
        # the margin absorbs the window-vs-teacher-forced round-off
        assert int((lg[t] > lg[t, tok] + 1e-3).sum()) < k, (t, tok)
    other, _ = generate_speculative(
        tt, td, prompt, 12, gamma=3, temperature=1.0, top_k=k,
        generator=torch.Generator().manual_seed(4))
    assert not torch.equal(out, other)


def test_rejects_bad_args():
    _, _, tt, _, _, _ = _pair()
    prompt = torch.from_numpy(_prompt(4))
    with pytest.raises(ValueError, match="batch-1"):
        generate_speculative(tt, tt, torch.zeros((2, 4), dtype=torch.int32),
                             8)
    with pytest.raises(ValueError, match="gamma"):
        generate_speculative(tt, tt, prompt, 8, gamma=0)
    with pytest.raises(ValueError, match="position table"):
        # learned table 64 < plen + new + gamma - 1 = 4 + 60 + 4 - 1 = 67
        generate_speculative(tt, tt, prompt, 60, gamma=4)
    with pytest.raises(ValueError, match="max_len"):
        generate_speculative(tt, tt, prompt, 8, max_len=10)
    with pytest.raises(ValueError, match="pad_id requires eos_id"):
        generate_speculative(tt, tt, prompt, 8, pad_id=0)
