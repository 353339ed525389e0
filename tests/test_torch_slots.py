"""The port's contiguous slot cache and ``Engine(paged=False)`` held
against the JAX package.

* A mixed workload through the port's contiguous engine equals the port's
  paged engine, the JAX package's contiguous engine and JAX ``generate``
  request for request, for the base, RoPE + GQA and int8 families (the
  contract of tests/test_pages.py).
* ``decode_step_slots`` logits agree with the JAX ones within 1e-4 at f32
  and write the same cache, including a dead row whose ``write_col`` is
  ``max_len``: its write is dropped (no raise, no live entry changed).
* ``insert_slot`` splices a row of a left-padded ragged prefill; the
  spliced slot then decodes as the JAX package's does.
* EOS, budgets and cancellation on the contiguous layout, with page
  counters at 0 (there is no page pool).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import serve as jserve
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.obs import metrics as metrics_lib
from distributed_tensorflow_tpu.serve import slots as jslots
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              load_jax_params)
from distributed_tensorflow_tpu_torch.serve import slots as tslots

torch.set_num_threads(1)

LOGIT_TOL = 1e-4
_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
           "intermediate_size", "max_position", "layer_norm_eps",
           "num_kv_heads", "position_embedding", "rope_base", "norm",
           "ffn_activation", "use_bias", "tied_head", "kv_cache_dtype")
FAMILIES = {
    "base": {},
    "rope_gqa": dict(position_embedding="rope", num_heads=4, num_kv_heads=2),
    "int8": dict(kv_cache_dtype="int8"),
}


@functools.lru_cache(maxsize=None)
def _models(family):
    jmodel = jgpt_tiny(dropout_rate=0.0, hidden_size=64, max_position=64,
                       **FAMILIES[family])
    jparams = jmodel.init(jax.random.PRNGKey(0))
    config = GPTConfig(dropout_rate=0.0, **{
        f: getattr(jmodel.config, f) for f in _FIELDS})
    model = load_jax_params(GPT(config, device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(0, 512, plen,
                                                dtype=np.int32)


def _generate(jmodel, jparams, prompt, new, **kw):
    out = jmodel.generate(jparams, jnp.asarray(prompt[None]),
                          max_new_tokens=new, max_len=64, **kw)
    return np.asarray(out)[0, prompt.size:].tolist()


def _engine(model, **kw):
    kw = {"num_slots": 2, "max_len": 64, "prefill_chunk": 4,
          "tick_steps": 3, "paged": False, **kw}
    return Engine(model, device="cpu", **kw)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_contiguous_engine_matches_paged_jax_and_generate(family):
    jmodel, jparams, model = _models(family)
    prompts = [_prompt(7, 1), _prompt(5, 2), _prompt(9, 3), _prompt(3, 4)]
    budgets = [9, 6, 4, 8]
    wants = [_generate(jmodel, jparams, p, n)
             for p, n in zip(prompts, budgets)]
    outs = {}
    for paged in (True, False):
        eng = _engine(model, paged=paged)
        hs = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
        eng.drain()
        assert all(h.status == "ok" for h in hs)
        outs[paged] = [h.tokens for h in hs]
    jeng = jserve.Engine(jmodel, jparams, paged=False, num_slots=2,
                         max_len=64, prefill_chunk=4, tick_steps=3,
                         registry=metrics_lib.Registry())
    jhs = [jeng.submit(p, n) for p, n in zip(prompts, budgets)]
    jeng.drain()
    assert outs[False] == outs[True] == [h.tokens for h in jhs] == wants


def _slot_state(c, S, max_len, rng):
    """A slot cache with random K/V and three rows: live, live after a
    ragged splice (start_col 2), and dead with write_col == max_len."""
    shape = (c.num_layers, S, max_len, c.kv_heads, c.head_dim)
    kv = {"k": rng.standard_normal(shape).astype(np.float32),
          "v": rng.standard_normal(shape).astype(np.float32)}
    write_col = np.array([5, 9, max_len], np.int32)
    start_col = np.array([0, 2, 0], np.int32)
    positions = write_col - start_col
    return kv, write_col, start_col, positions


def test_decode_step_slots_matches_jax_and_drops_a_dead_rows_write():
    jmodel, jparams, model = _models("base")
    c = model.config
    S, max_len = 3, 16
    rng = np.random.default_rng(7)
    kv, write_col, start_col, positions = _slot_state(c, S, max_len, rng)
    cols = np.arange(max_len)[None, :]
    valid = (cols >= start_col[:, None]) & (cols < write_col[:, None])
    valid[2] = False                              # the dead row
    tokens = rng.integers(0, 512, (S,), dtype=np.int32)
    jl, jkv = jmodel.decode_step_slots(
        jparams, {k: jnp.asarray(v) for k, v in kv.items()},
        jnp.asarray(tokens), jnp.asarray(write_col), jnp.asarray(valid),
        jnp.asarray(positions))
    tkv = {k: torch.from_numpy(v.copy()) for k, v in kv.items()}
    tl, tkv = model.decode_step_slots(
        tkv, torch.from_numpy(tokens), torch.from_numpy(write_col),
        torch.from_numpy(valid), torch.from_numpy(positions))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                               atol=LOGIT_TOL, rtol=0)
    for name in kv:
        got, want = tkv[name].numpy(), np.asarray(jkv[name])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(got[:, 2], kv[name][:, 2])
        # live rows changed exactly at their write columns
        changed = (got != kv[name]).any(axis=(0, 3, 4))
        assert changed.nonzero()[1].tolist() == [5, 9]


def test_insert_slot_ragged_splice_then_decode_matches_jax():
    jmodel, jparams, model = _models("int8")
    max_len, S = 16, 3
    ids = np.stack([_prompt(6, 8), _prompt(6, 9)])
    valid = np.ones((2, 6), bool)
    valid[1, :2] = False                          # row 1: 4 real tokens
    pad = np.array([0, 2], np.int32)
    positions = np.maximum(np.arange(6)[None, :] - pad[:, None], 0)
    _, jpf = jmodel.decode_block(jparams, jmodel.init_cache(2, max_len),
                                 jnp.asarray(ids), kv_valid=jnp.asarray(valid),
                                 positions=jnp.asarray(positions))
    _, tpf = model.decode_block(model.init_cache(2, max_len),
                                torch.from_numpy(ids),
                                kv_valid=torch.from_numpy(valid),
                                positions=torch.from_numpy(positions))
    jcache = jslots.init_slot_cache(jmodel, S, max_len)
    tcache = tslots.init_slot_cache(model, S, max_len)
    for slot, row in ((2, 1), (0, 0)):
        jcache = jslots.insert_slot(
            jcache, slot, {k: v[:, row:row + 1]
                           for k, v in jslots.strip_pos(jpf).items()},
            int(valid[row].sum()), pad_len=int(pad[row]))
        tcache = tslots.insert_slot(
            tcache, slot, {k: v[:, row:row + 1]
                           for k, v in tslots.strip_pos(tpf).items()},
            int(valid[row].sum()), pad_len=int(pad[row]))
    for key in ("start_col", "write_col", "positions"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))
    live = np.array([True, False, True])
    for t in range(3):
        tokens = _prompt(S, 20 + t)
        jl, jcache = jslots.decode_slots_step(jmodel, jparams, jcache,
                                              jnp.asarray(tokens),
                                              jnp.asarray(live))
        tl, tcache = tslots.decode_slots_step(model, tcache,
                                              torch.from_numpy(tokens),
                                              torch.from_numpy(live))
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=LOGIT_TOL, rtol=0)
    for key in ("start_col", "write_col", "positions"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))
    assert tcache["write_col"].tolist() == [9, 0, 9]


def test_contiguous_engine_eos_budget_cancel_and_stats():
    jmodel, jparams, model = _models("base")
    prompts = [_prompt(6, 40), _prompt(4, 41)]
    wants = [_generate(jmodel, jparams, p, 6) for p in prompts]
    eos = wants[0][2]                              # fires mid-stream
    eng = _engine(model, tick_steps=2, eos_id=eos)
    h = eng.submit(prompts[0], 6)
    eng.drain()
    assert h.tokens == wants[0][:wants[0].index(eos) + 1]
    assert h.tokens == _generate(jmodel, jparams, prompts[0], 6,
                                 eos_id=eos)[:len(h.tokens)]
    assert _engine(model).generate_batch(prompts, 6) == wants
    eng = _engine(model, tick_steps=2)
    a, b = eng.submit(prompts[0], 6), eng.submit(prompts[1], 6)
    eng.step()
    assert eng.cancel(a) and a.status == "cancelled"
    eng.drain()
    assert not eng.cancel(a)
    assert b.tokens == wants[1]
    # a prefill cancelled mid-way hands its cache back to the spare pool
    c = eng.submit(_prompt(13, 42), 3)
    eng.step()
    assert eng.cancel(c)
    eng.drain()
    assert len(eng.scheduler._pf_pool) <= eng.scheduler.num_slots
    st = eng.stats()
    assert (st.pages_total, st.pages_free, st.page_size,
            st.prefix_lookups_total) == (0, 0, 0, 0)
    assert eng.scheduler.pages is None
