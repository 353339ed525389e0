"""The port's LoRA adapters held against the JAX package.

* ``lora_shapes``, ``init_lora_table`` and ``lora_insert_row`` build the
  reference's table; ``merge_lora`` of converted weights equals the
  reference's within 1e-6.
* Every serving entry (``decode_window_paged``, ``decode_step_slots_paged``,
  ``decode_window``, ``decode_step_slots``) with one adapter table and
  mixed ``adapter_rows`` gives the reference's logits within 1e-4 at f32,
  for GPT and for Llama (GQA, RoPE).
* The engine, both layouts: ``adapter_id=None`` tokens equal an
  adapter-free engine's; adapter tokens equal ``generate`` on merged
  weights, the port's and the reference's, and differ from the base
  model's (asserted, so that the comparison cannot pass vacuously);
  capacity pressure requeues and drains with no pin left; LRU eviction;
  a hot update of a resident id; validation.

The adapters here are strong (entries of ``a`` and ``b`` ~ N(0, 0.5^2)),
so that their tokens differ from the base model's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models import llama as jllama
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              gpt_params_to_jax,
                                              load_jax_params, lora_from_jax,
                                              lora_to_jax)
from distributed_tensorflow_tpu_torch.serve import adapters as tadapters
from distributed_tensorflow_tpu_torch.serve import pages as tpages

torch.set_num_threads(1)

LOGIT_TOL = 1e-4
MERGE_TOL = 1e-6
# the pool's K/V, relative to their largest entry (strong adapters make
# them reach ~40): f32 summation order only
KV_TOL = 1e-5
RANK = 4
_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
           "intermediate_size", "max_position", "layer_norm_eps",
           "num_kv_heads", "position_embedding", "rope_base", "norm",
           "ffn_activation", "use_bias", "tied_head", "kv_cache_dtype")
FAMILIES = {"gpt": lambda: jgpt_tiny(dropout_rate=0.0),
            "llama": lambda: jllama.llama_tiny()}


def _models(family="gpt"):
    jmodel = FAMILIES[family]()
    jparams = jmodel.init(jax.random.PRNGKey(0))
    config = GPTConfig(dropout_rate=0.0, **{
        f: getattr(jmodel.config, f) for f in _FIELDS})
    model = load_jax_params(GPT(config, device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model


def _adapter(model, seed, rank=RANK, scale=0.5):
    """A JAX-layout adapter (numpy leaves) with nonzero ``a`` and ``b``."""
    rng = np.random.default_rng(seed)
    L = model.config.num_layers
    return {name: {"a": (scale * rng.standard_normal((L,) + a)).astype(
                       np.float32),
                   "b": (scale * rng.standard_normal((L,) + b)).astype(
                       np.float32)}
            for name, (a, b) in model.lora_shapes(rank).items()}


def _tables(jmodel, model, ads, rank=RANK):
    """The same table in both packages: row 0 zero, ``ads`` in rows 1.."""
    jtab = jmodel.init_lora_table(len(ads) + 1, rank)
    ttab = model.init_lora_table(len(ads) + 1, rank)
    for row, ad in enumerate(ads, start=1):
        jtab = jmodel.lora_insert_row(jtab, row, jax.tree.map(jnp.asarray,
                                                              ad))
        model.lora_insert_row(ttab, row, lora_from_jax(ad))
    return jtab, ttab


def _prompt(plen, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, plen,
                                                dtype=np.int32)


def _jgenerate(jmodel, jparams, prompt, new, max_len=64):
    out = jmodel.generate(jparams, jnp.asarray(prompt[None]),
                          max_new_tokens=new, max_len=max_len)
    return np.asarray(out)[0, prompt.size:].tolist()


def _generate(model, prompt, new, max_len=64):
    out = model.generate(torch.from_numpy(prompt[None]), new,
                         max_len=max_len)
    return out[0, prompt.size:].tolist()


def _merged(model, adapter):
    merged = GPT(model.config, device="cpu")
    merged.load_state_dict(model.merge_lora(lora_from_jax(adapter)))
    return merged


def _engine(model, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("tick_steps", 3)
    return Engine(model, device="cpu", **kw)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_table_layout_and_insert_row_match_jax(family):
    jmodel, _, model = _models(family)
    assert model.lora_shapes(RANK) == jmodel.lora_shapes(RANK)
    ads = [_adapter(model, 1), _adapter(model, 2)]
    jtab, ttab = _tables(jmodel, model, ads)
    for name in jmodel._LORA_TARGETS:
        for ab in ("a", "b"):
            got = ttab[name][ab].numpy()
            np.testing.assert_array_equal(got, np.asarray(jtab[name][ab]))
            assert not got[0].any()
    ad = lora_to_jax(lora_from_jax(ads[0]))
    for name in ad:
        np.testing.assert_array_equal(ad[name]["a"], ads[0][name]["a"])
    fresh = model.init_lora(torch.Generator().manual_seed(0), rank=RANK)
    assert all(not fresh[n]["b"].any() and fresh[n]["a"].any()
               for n in fresh)
    with pytest.raises(ValueError, match="capacity"):
        model.init_lora_table(1, RANK)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_merge_lora_matches_jax(family):
    jmodel, jparams, model = _models(family)
    ad = _adapter(model, 3)
    want = jmodel.merge_lora(jparams, jax.tree.map(jnp.asarray, ad))
    got = gpt_params_to_jax(model.merge_lora(lora_from_jax(ad)),
                            model.config)
    for name in jmodel._LORA_TARGETS:
        np.testing.assert_allclose(
            got["decoder"]["attention"][name]["kernel"],
            np.asarray(want["decoder"]["attention"][name]["kernel"]),
            atol=MERGE_TOL, rtol=0)
    base = gpt_params_to_jax(model.state_dict(), model.config)
    np.testing.assert_array_equal(got["decoder"]["ffn"]["w_in"]["kernel"],
                                  base["decoder"]["ffn"]["w_in"]["kernel"])


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_paged_entries_logits_match_jax(family):
    jmodel, jparams, model = _models(family)
    c = model.config
    jtab, ttab = _tables(jmodel, model, [_adapter(model, 4),
                                         _adapter(model, 5)])
    L, pg, P, NP = c.num_layers, 8, 4, 16
    shape = (L, NP, pg, c.kv_heads, c.head_dim)
    jkv = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tkv = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    rng = np.random.default_rng(3)
    row = np.array([5, 2, 9, 0], np.int32)
    toks = rng.integers(0, c.vocab_size, (2, 1, 6), dtype=np.int32)
    for w, pos in enumerate((0, 6)):                 # two windows, row 2
        jl, jkv = jmodel.decode_window_paged(
            jparams, jkv, jnp.asarray(toks[w]), jnp.asarray(row),
            jnp.int32(pos), head="all", adapters=jtab,
            adapter_rows=jnp.asarray([2], jnp.int32), use_kernel=True)
        tl, tkv = model.decode_window_paged(
            tkv, torch.from_numpy(toks[w]), torch.from_numpy(row), pos,
            head="all", adapters=ttab, adapter_rows=torch.tensor([2]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
    # a decode step, rows under adapters 2, 0 (none) and 1
    tab = np.array([row, [7, 8, 0, 0], [10, 11, 0, 0]], np.int32)
    write_col = np.array([12, 9, 4], np.int32)
    cols = np.arange(P * pg)[None, :]
    valid = cols < write_col[:, None]
    tokens = rng.integers(0, c.vocab_size, (3,), dtype=np.int32)
    rows = np.array([2, 0, 1], np.int32)
    jl, jkv = jmodel.decode_step_slots_paged(
        jparams, jkv, jnp.asarray(tokens), jnp.asarray(tab),
        jnp.asarray(write_col), jnp.asarray(valid), jnp.asarray(write_col),
        adapters=jtab, adapter_rows=jnp.asarray(rows), use_kernel=True)
    tl, tkv = model.decode_step_slots_paged(
        tkv, torch.from_numpy(tokens), torch.from_numpy(tab),
        torch.from_numpy(write_col), torch.from_numpy(valid),
        torch.from_numpy(write_col), adapters=ttab,
        adapter_rows=torch.from_numpy(rows))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    for name in ("k", "v"):
        want = np.asarray(jkv[name])
        np.testing.assert_allclose(tkv[name].numpy(), want, rtol=0,
                                   atol=KV_TOL * max(1.0, np.abs(want).max()))
    # the zero row adds nothing: row 1's logits equal an adapter-free step
    base, _ = model.decode_step_slots_paged(
        {k: v.clone() for k, v in tkv.items()}, torch.from_numpy(tokens),
        torch.from_numpy(tab), torch.from_numpy(write_col),
        torch.from_numpy(valid), torch.from_numpy(write_col))
    again, _ = model.decode_step_slots_paged(
        {k: v.clone() for k, v in tkv.items()}, torch.from_numpy(tokens),
        torch.from_numpy(tab), torch.from_numpy(write_col),
        torch.from_numpy(valid), torch.from_numpy(write_col),
        adapters=ttab, adapter_rows=torch.from_numpy(rows))
    assert torch.equal(again[1], base[1])
    assert not torch.equal(again[0], base[0])


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_contiguous_entries_logits_match_jax(family):
    jmodel, jparams, model = _models(family)
    c = model.config
    jtab, ttab = _tables(jmodel, model, [_adapter(model, 6),
                                         _adapter(model, 7)])
    rng = np.random.default_rng(4)
    rows = np.array([1, 2], np.int32)
    toks = rng.integers(0, c.vocab_size, (2, 2, 5), dtype=np.int32)
    jcache, tcache = jmodel.init_cache(2, 32), model.init_cache(2, 32)
    for w in range(2):                                 # two windows
        jl, jcache = jmodel.decode_window(
            jparams, jcache, jnp.asarray(toks[w]), head="all",
            adapters=jtab, adapter_rows=jnp.asarray(rows))
        tl, tcache = model.decode_window(
            tcache, torch.from_numpy(toks[w]), head="all", adapters=ttab,
            adapter_rows=torch.from_numpy(rows))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
    # slots: rows under adapters 0, 2 and 1 at ragged columns
    S, max_len = 3, 32
    shape = (c.num_layers, S, max_len, c.kv_heads, c.head_dim)
    kv0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    write_col = np.array([7, 12, 3], np.int32)
    valid = np.arange(max_len)[None, :] < write_col[:, None]
    tokens = rng.integers(0, c.vocab_size, (S,), dtype=np.int32)
    srows = np.array([0, 2, 1], np.int32)
    jl, _ = jmodel.decode_step_slots(
        jparams, {"k": jnp.asarray(kv0), "v": jnp.asarray(v0)},
        jnp.asarray(tokens), jnp.asarray(write_col), jnp.asarray(valid),
        jnp.asarray(write_col), adapters=jtab,
        adapter_rows=jnp.asarray(srows))
    tl, _ = model.decode_step_slots(
        {"k": torch.from_numpy(kv0.copy()), "v": torch.from_numpy(v0.copy())},
        torch.from_numpy(tokens), torch.from_numpy(write_col),
        torch.from_numpy(valid), torch.from_numpy(write_col), adapters=ttab,
        adapter_rows=torch.from_numpy(srows))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_adapter_and_none_requests(paged):
    """One engine, mixed requests: ``None`` requests equal an adapter-free
    engine token for token; adapter requests equal ``generate`` on the
    merged weights (port and reference) and differ from the base."""
    jmodel, jparams, model = _models()
    ads = {"x": _adapter(model, 8), "y": _adapter(model, 9)}
    prompts = [_prompt(n, 20 + i) for i, n in enumerate((5, 13, 9, 18))]
    ids = ["x", None, "y", None]
    eng = _engine(model, paged=paged, adapter_capacity=2, adapter_rank=RANK)
    for name, ad in ads.items():
        eng.load_adapter(name, lora_from_jax(ad))
    hs = [eng.submit(p, 8, adapter_id=a) for p, a in zip(prompts, ids)]
    eng.drain()
    plain = _engine(model, paged=paged).generate_batch(prompts, 8)
    assert eng.adapters.pinned() == 0
    for h, p, a, base in zip(hs, prompts, ids, plain):
        assert h.status == "ok" and h.adapter_id == a
        if a is None:
            assert h.tokens == base
            continue
        want = _jgenerate(jmodel, jmodel.merge_lora(
            jparams, jax.tree.map(jnp.asarray, ads[a])), p, 8)
        assert want != _jgenerate(jmodel, jparams, p, 8), \
            "adapter too weak to change the tokens: the test is vacuous"
        assert h.tokens == want
        assert h.tokens == _generate(_merged(model, ads[a]), p, 8)


def test_capacity_pressure_requeues_and_drains_without_a_pin_left():
    """One adapter row, two adapters, two slots: the second adapter's
    request waits in the queue (requeued at the front) until the first
    retires; everything drains exactly, every pin released."""
    _, _, model = _models()
    ads = {"x": _adapter(model, 10), "y": _adapter(model, 11)}
    eng = _engine(model, adapter_capacity=1, adapter_rank=RANK)
    for name, ad in ads.items():
        eng.load_adapter(name, lora_from_jax(ad))
    prompts = [_prompt(6, 30 + i) for i in range(4)]
    ids = ["x", "y", "x", None]
    hs = [eng.submit(p, 5, adapter_id=a) for p, a in zip(prompts, ids)]
    eng.step()
    st = eng.stats()
    assert st.prefilling + st.active == 1 and st.queued == 3
    eng.drain()
    assert all(h.status == "ok" and len(h.tokens) == 5 for h in hs)
    assert eng.adapters.pinned() == 0 and eng.adapters.evictions >= 1
    for h, p, a in zip(hs, prompts, ids):
        want = (_generate(model, p, 5) if a is None
                else _generate(_merged(model, ads[a]), p, 5))
        assert h.tokens == want
    assert eng.stats().pages_free == eng.stats().pages_total


def test_table_lru_eviction_and_full():
    _, _, model = _models()
    table = tadapters.AdapterTable(model, capacity=2, rank=RANK)
    for i, name in enumerate("abc"):
        table.register(name, lora_from_jax(_adapter(model, 40 + i)))
    assert table.acquire(None) == 0
    ra = table.acquire("a")
    table.release("a")
    rb = table.acquire("b")
    table.release("b")
    assert table.acquire("a") == ra                  # a is now the newest
    table.release("a")
    assert table.acquire("c") == rb                  # evicts b, the LRU
    assert set(table.resident_ids) == {"a", "c"} and table.evictions == 1
    np.testing.assert_array_equal(
        table.arrays["query"]["a"][rb].numpy(),
        _adapter(model, 42)["query"]["a"])
    table.acquire("a")                               # both rows pinned
    with pytest.raises(tadapters.AdapterTableFull):
        table.acquire("b")
    with pytest.raises(KeyError):
        table.acquire("zzz")


def test_hot_update_of_a_resident_adapter():
    """Re-loading a resident id rebinds a new table (the old one, which
    a running tick may hold, is left as it was); later requests decode
    under the new adapter."""
    _, _, model = _models()
    a1, a2 = _adapter(model, 12), _adapter(model, 13)
    eng = _engine(model, adapter_capacity=2, adapter_rank=RANK)
    eng.load_adapter("x", lora_from_jax(a1))
    p = _prompt(7, 50)
    h1 = eng.submit(p, 6, adapter_id="x")
    eng.drain()
    old = eng.adapters.arrays
    old_q = old["query"]["b"].clone()
    eng.load_adapter("x", lora_from_jax(a2))
    assert eng.adapters.arrays is not old
    assert torch.equal(old["query"]["b"], old_q)
    h2 = eng.submit(p, 6, adapter_id="x")
    eng.drain()
    assert h1.tokens == _generate(_merged(model, a1), p, 6)
    assert h2.tokens == _generate(_merged(model, a2), p, 6)
    assert h1.tokens != h2.tokens


def test_adapter_validation():
    _, _, model = _models()
    eng = _engine(model, adapter_capacity=1, adapter_rank=RANK)
    with pytest.raises(KeyError, match="unknown adapter_id"):
        eng.submit(_prompt(4, 1), 4, adapter_id="nope")
    with pytest.raises(ValueError, match="shapes"):
        eng.load_adapter("bad", lora_from_jax(_adapter(model, 1, rank=2)))
    with pytest.raises(ValueError, match="adapter_id"):
        eng.load_adapter("", lora_from_jax(_adapter(model, 1)))
    plain = _engine(model)
    with pytest.raises(ValueError, match="adapter table"):
        plain.submit(_prompt(4, 1), 4, adapter_id="x")
    with pytest.raises(ValueError, match="without adapters"):
        plain.load_adapter("x", lora_from_jax(_adapter(model, 1)))
    assert not eng.busy and not plain.busy
    with pytest.raises(ValueError, match="adapter_rows"):
        model.decode_step_slots_paged(
            tpages.init_paged_cache(model, 1, 9, 8)["kv"],
            torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 4), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 32), dtype=torch.bool),
            torch.zeros(1, dtype=torch.int32),
            adapters=eng.adapters.arrays)


def test_prefix_cache_never_crosses_adapters():
    """Requests sharing a prompt under different adapters: each decodes
    its own model's tokens.  The K/V of a prompt depend on the adapter
    (its k and v deltas), so pages prefilled under one adapter must not
    serve another, nor the base model, nor a hot-updated version of the
    same adapter; the same adapter hits.  (The JAX package's radix tree
    is shared by every adapter, so there a base request after an adapter
    request with the same prompt decodes from the adapter's K/V.)"""
    _, _, model = _models()
    ads = {"x": _adapter(model, 14), "y": _adapter(model, 15)}
    eng = _engine(model, num_slots=1, num_pages=20, adapter_capacity=2,
                  adapter_rank=RANK)
    for name, ad in ads.items():
        eng.load_adapter(name, lora_from_jax(ad))
    p = _prompt(40, 60)                     # 2 full pages of 16
    want = {None: _generate(model, p, 6)}
    for name, ad in ads.items():
        want[name] = _generate(_merged(model, ad), p, 6)
    assert len({tuple(w) for w in want.values()}) == 3
    for a in ("x", None, "y", "x"):
        hits = eng.stats().prefix_hits_total
        h = eng.submit(p, 6, adapter_id=a)
        eng.drain()
        assert h.tokens == want[a], a
    assert eng.stats().prefix_hits_total == hits + 1    # the second x
    new = _adapter(model, 16)
    eng.load_adapter("x", lora_from_jax(new))
    h = eng.submit(p, 6, adapter_id="x")
    eng.drain()
    assert eng.stats().prefix_hits_total == hits + 1    # no stale hit
    assert h.tokens == _generate(_merged(model, new), p, 6)
