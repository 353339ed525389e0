"""The port's GPT and paged serving engine held against the JAX package.

Same weights (the JAX tree carried across by ``gpt_params_from_jax``),
same inputs (numpy, one seed): the port's ``decode_window_paged`` and
``decode_step_slots_paged`` logits agree with the JAX package's within
1e-4 at f32 (matrix products sum in another order), and the port
engine's greedy token streams equal the JAX ``serve.Engine(paged=True)``
and ``GPT.generate`` token for token, including a radix prefix hit, the
whole-chain COW split and requests sharing a prefix in flight together
(the contracts of tests/test_pages.py).  The port runs on the CPU here,
so its kernel wrappers take their plain versions.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import serve as jserve
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.obs import metrics as metrics_lib
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              gpt_params_from_jax)
from distributed_tensorflow_tpu_torch.models.convert import load_jax_params
from distributed_tensorflow_tpu_torch.serve import pages as tpages

torch.set_num_threads(1)

LOGIT_TOL = 1e-4


def _models(**kw):
    jmodel = jgpt_tiny(dropout_rate=0.0, **kw)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    c = jmodel.config
    config = GPTConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                       num_layers=c.num_layers, num_heads=c.num_heads,
                       intermediate_size=c.intermediate_size,
                       max_position=c.max_position,
                       layer_norm_eps=c.layer_norm_eps,
                       num_kv_heads=c.num_kv_heads)
    model = load_jax_params(GPT(config, device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model


def _prompt(plen, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, plen,
                                                dtype=np.int32)


def _generate(jmodel, jparams, prompt, new, max_len=64):
    out = jmodel.generate(jparams, jnp.asarray(prompt[None]),
                          max_new_tokens=new, max_len=max_len)
    return np.asarray(out)[0, prompt.size:].tolist()


def test_convert_covers_every_parameter():
    jmodel, jparams, model = _models()
    sd = gpt_params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config)
    assert set(sd) == set(model.state_dict())
    q = np.asarray(jparams["decoder"]["attention"]["query"]["kernel"][1])
    np.testing.assert_array_equal(
        model.blocks[1].attention.query.kernel.detach().numpy(), q)


@pytest.mark.parametrize("kw", [{}, {"num_heads": 4, "num_kv_heads": 2}],
                         ids=["mha", "gqa"])
def test_paged_window_and_decode_step_logits_match_jax(kw):
    jmodel, jparams, model = _models(**kw)
    c = model.config
    L, pg, P, S, NP = c.num_layers, 8, 4, 3, 16
    shape = (L, NP, pg, c.kv_heads, c.head_dim)
    jkv = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tkv = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    rng = np.random.default_rng(3)
    row = np.array([5, 2, 9, 0], np.int32)           # the window's row
    toks = rng.integers(0, c.vocab_size, (2, 1, 6), dtype=np.int32)
    for w, pos in enumerate((0, 6)):                  # two windows
        jl, jkv = jmodel.decode_window_paged(
            jparams, jkv, jnp.asarray(toks[w]), jnp.asarray(row),
            jnp.int32(pos), head="all", use_kernel=True)
        tl, tkv = model.decode_window_paged(
            tkv, torch.from_numpy(toks[w]), torch.from_numpy(row), pos,
            head="all")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        last, _ = model.decode_window_paged(
            {k: v.clone() for k, v in tkv.items()},
            torch.from_numpy(toks[w]), torch.from_numpy(row), pos, head=3)
        np.testing.assert_allclose(last.numpy(), tl.numpy()[:, 3], atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(tkv[name].numpy(), np.asarray(jkv[name]),
                                   atol=1e-5)
    # one decode step: row 0 continues the window's request, row 1 has a
    # ragged private history, row 2 is retired onto the trash page
    tab = np.array([row, [7, 8, 0, 0], [0, 0, 0, 0]], np.int32)
    write_col = np.array([12, 9, 4], np.int32)
    start_col = np.array([0, 2, 0], np.int32)
    cols = np.arange(P * pg)[None, :]
    valid = (cols >= start_col[:, None]) & (cols < write_col[:, None])
    positions = write_col.copy()
    tokens = rng.integers(0, c.vocab_size, (S,), dtype=np.int32)
    jl, jkv = jmodel.decode_step_slots_paged(
        jparams, jkv, jnp.asarray(tokens), jnp.asarray(tab),
        jnp.asarray(write_col), jnp.asarray(valid), jnp.asarray(positions),
        use_kernel=True)
    tl, tkv = model.decode_step_slots_paged(
        tkv, torch.from_numpy(tokens), torch.from_numpy(tab),
        torch.from_numpy(write_col), torch.from_numpy(valid),
        torch.from_numpy(positions))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tkv[name].numpy(), np.asarray(jkv[name]),
                                   atol=1e-5)


def _engine(model, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 64)
    return Engine(model, device="cpu", **kw)


def _jengine(jmodel, jparams, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 64)
    return jserve.Engine(jmodel, jparams, paged=True,
                         registry=metrics_lib.Registry(), **kw)


@pytest.mark.parametrize("kw", [{}, {"num_heads": 4, "num_kv_heads": 2}],
                         ids=["mha", "gqa"])
def test_engine_matches_jax_engine_and_generate(kw):
    jmodel, jparams, model = _models(**kw)
    prompts = [_prompt(7, 1), _prompt(5, 2), _prompt(9, 3), _prompt(3, 4)]
    budgets = [9, 6, 4, 8]
    wants = [_generate(jmodel, jparams, p, n) for p, n in zip(prompts,
                                                              budgets)]
    eng = _engine(model, prefill_chunk=4, tick_steps=3)
    hs = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    eng.drain()
    jeng = _jengine(jmodel, jparams, prefill_chunk=4, tick_steps=3)
    jhs = [jeng.submit(p, n) for p, n in zip(prompts, budgets)]
    jeng.drain()
    assert all(h.status == "ok" for h in hs)
    assert [h.tokens for h in hs] == [h.tokens for h in jhs] == wants


def test_prefix_hit_matches_cold_cache_and_jax():
    jmodel, jparams, model = _models()
    sys_prompt = _prompt(16, 7)                   # 2 pages at page_size 8
    reqs = [np.concatenate([sys_prompt, _prompt(5, 8)]),
            np.concatenate([sys_prompt, _prompt(3, 9)])]

    def run(eng, req):
        h = eng.submit(req, 7)
        eng.drain()
        assert h.status == "ok"
        return h.tokens

    kw = dict(prefill_chunk=4, tick_steps=2, page_size=8)
    warm = _engine(model, **kw)
    got = [run(warm, r) for r in reqs]            # seed, then hit
    st = warm.stats()
    assert st.prefix_hits_total == 1
    assert st.prefix_tokens_reused_total == 16
    assert st.prefill_windows_skipped_total == 4
    assert st.prefix_hit_rate == 0.5
    jwarm = _jengine(jmodel, jparams, **kw)
    assert [run(jwarm, r) for r in reqs] == got
    for req, g in zip(reqs, got):
        assert run(_engine(model, **kw), req) == g
        assert g == _generate(jmodel, jparams, req, 7)


def test_cow_whole_chain_prompt_matches_jax():
    jmodel, jparams, model = _models()
    prompt = _prompt(16, 13)                      # exactly 2 pages
    want = _generate(jmodel, jparams, prompt, 6)
    eng = _engine(model, prefill_chunk=4, tick_steps=2, page_size=8)
    h1 = eng.submit(prompt, 6)
    eng.drain()
    h2 = eng.submit(prompt, 6)                    # whole-chain re-submit
    eng.drain()
    jeng = _jengine(jmodel, jparams, prefill_chunk=4, tick_steps=2,
                    page_size=8)
    j1 = jeng.submit(prompt, 6)
    jeng.drain()
    j2 = jeng.submit(prompt, 6)
    jeng.drain()
    assert h1.tokens == h2.tokens == j1.tokens == j2.tokens == want
    st = eng.stats()
    assert st.cow_splits_total == 1
    assert st.prefix_hits_total == 1
    assert st.prefix_tokens_reused_total == 8


def test_concurrent_shared_prefix_and_exhaustion_drain_exact():
    jmodel, jparams, model = _models()
    sys_prompt = _prompt(8, 11)
    reqs = [np.concatenate([sys_prompt, _prompt(4, 20 + i)])
            for i in range(4)]
    eng = _engine(model, prefill_chunk=4, tick_steps=2, page_size=8)
    hs = [eng.submit(r, 8) for r in reqs]
    eng.drain()
    assert [h.tokens for h in hs] == [_generate(jmodel, jparams, r, 8)
                                      for r in reqs]
    assert eng.stats().prefix_hits_total >= 1
    # more demand than pages: admission requeues, every request drains
    eng = _engine(model, max_len=32, prefill_chunk=4, tick_steps=2,
                  page_size=8, num_pages=10)
    prompts = [_prompt(9 + (i % 3), 30 + i) for i in range(6)]
    hs = [eng.submit(p, 10) for p in prompts]
    eng.drain()
    for h, p in zip(hs, prompts):
        assert h.status == "ok"
        assert h.tokens == _generate(jmodel, jparams, p, 10, max_len=32)
    st = eng.stats()
    assert st.pages_free + _radix_pages(eng.scheduler.pages) \
        == st.pages_total


def _radix_pages(pool):
    n, stack = 0, list(pool._root.children.values())
    while stack:
        node = stack.pop()
        n += 1
        stack.extend(node.children.values())
    return n


def test_eos_budget_cancel_and_generate_batch():
    jmodel, jparams, model = _models()
    prompts = [_prompt(6, 40), _prompt(4, 41)]
    wants = [_generate(jmodel, jparams, p, 6) for p in prompts]
    eos = wants[0][2]                              # fires mid-stream
    eng = _engine(model, prefill_chunk=4, tick_steps=2, eos_id=eos)
    h = eng.submit(prompts[0], 6)
    eng.drain()
    assert h.tokens == wants[0][:wants[0].index(eos) + 1]
    assert _engine(model, prefill_chunk=4).generate_batch(prompts, 6) \
        == wants
    eng = _engine(model, prefill_chunk=4, tick_steps=2)
    a, b = eng.submit(prompts[0], 6), eng.submit(prompts[1], 6)
    eng.step()
    assert eng.cancel(a) and a.status == "cancelled"
    eng.drain()
    assert not eng.cancel(a)
    assert b.tokens == wants[1]
    assert eng.stats().pages_free == eng.stats().pages_total


def test_validation():
    _, _, model = _models()
    with pytest.raises(ValueError, match="page_size"):
        _engine(model, max_len=32, page_size=7)
    eng = _engine(model, max_len=32, prefill_chunk=4)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(_prompt(30, 1), 8)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros((0,), np.int32), 2)
    assert tpages.auto_page_size(1024) == 16
    assert tpages.auto_page_size(40) == 10
    assert tpages.auto_page_size(31) == 1


def test_raising_callback_fails_only_its_request():
    _, _, model = _models()
    prompts = [_prompt(6, 50), _prompt(5, 51)]
    want = _engine(model, prefill_chunk=4).generate_batch(prompts, 6)

    def boom(toks):
        raise RuntimeError("consumer gone")

    eng = _engine(model, prefill_chunk=4, tick_steps=2)
    bad = eng.submit(prompts[0], 6, on_token=boom)
    good = eng.submit(prompts[1], 6)
    eng.drain()
    assert bad.status == "failed" and isinstance(bad.error, RuntimeError)
    assert good.status == "ok" and good.tokens == want[1]
    assert eng.stats().pages_free == eng.stats().pages_total


def test_concurrent_submitters_against_a_pumping_engine():
    """Submitter threads (more than cores) race a pumping thread under a
    short switch interval: every request finishes with its solo tokens
    and the pool balances (no lost lease, no double free)."""
    _, _, model = _models()
    sys_prompt = _prompt(8, 60)
    reqs = [np.concatenate([sys_prompt, _prompt(2 + i % 3, 61 + i)])
            for i in range(12)]
    wants = _engine(model, prefill_chunk=4).generate_batch(reqs, 4)
    eng = _engine(model, num_slots=3, max_len=32, prefill_chunk=4,
                  tick_steps=2, page_size=8)
    handles, lock = {}, threading.Lock()

    def submit(ids):
        for i in ids:
            h = eng.submit(reqs[i], 4)
            with lock:
                handles[i] = h

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=submit, args=(range(k, 12, 12),),
                               daemon=True) for k in range(12)]
        for t in ts:
            t.start()
        deadline = time.time() + 120
        while True:
            with lock:
                done = len(handles) == 12 and all(h.done for h in
                                                  handles.values())
            if done:
                break
            eng.step()
            assert time.time() < deadline, "did not drain"
        for t in ts:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert [handles[i].tokens for i in range(12)] == wants
    st = eng.stats()
    assert st.pages_free + _radix_pages(eng.scheduler.pages) \
        == st.pages_total
