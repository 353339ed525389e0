"""The port's Llama path held against the JAX package.

Same weights (a JAX ``llama_tiny`` tree carried across by
``gpt_params_from_jax``), same numpy inputs: RoPE and the SwiGLU FFN
agree to 1e-5; the full-sequence ``apply`` and the paged window and
decode-step logits agree to 1e-4 at f32 (matrix products sum in another
order), with a bf16-sized or an int8 KV pool; the port engine's greedy
token streams equal the JAX ``serve.Engine(paged=True)`` and
``GPT.generate`` token for token, with and without the int8 cache and
through a radix prefix hit (the contract of tests/test_pages.py for the
``rope_gqa`` and ``int8`` families).  The port runs on the CPU here, so
its kernel wrappers take their plain versions.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import serve as jserve
from distributed_tensorflow_tpu.models import llama as jllama
from distributed_tensorflow_tpu.obs import metrics as metrics_lib
from distributed_tensorflow_tpu.ops import attention as jattn
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              gpt_params_from_jax,
                                              gpt_params_to_jax, llama3_8b,
                                              llama_tiny)
from distributed_tensorflow_tpu_torch.models.convert import load_jax_params
from distributed_tensorflow_tpu_torch.ops import attention as tattn
from distributed_tensorflow_tpu_torch.serve import pages as tpages

torch.set_num_threads(1)

TOL = 1e-5
LOGIT_TOL = 1e-4
_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
           "intermediate_size", "max_position", "layer_norm_eps",
           "num_kv_heads", "position_embedding", "rope_base", "norm",
           "ffn_activation", "use_bias", "tied_head", "kv_cache_dtype")


def _models(**kw):
    jmodel = jllama.llama_tiny(**kw)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    config = GPTConfig(dropout_rate=0.0, **{
        f: getattr(jmodel.config, f) for f in _FIELDS})
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


# -------------------------------------------------------------- the ops

@pytest.mark.parametrize("pos_shape", [(7,), (3, 1), (2, 5)],
                         ids=["shared", "decode", "per_row"])
def test_rope_matches_jax(pos_shape):
    rng = np.random.default_rng(0)
    positions = rng.integers(0, 300, pos_shape).astype(np.int32)
    b = pos_shape[0] if len(pos_shape) == 2 else 2
    s = pos_shape[-1]
    x = rng.standard_normal((b, s, 4, 32), dtype=np.float32)
    jcos, jsin = jattn.rope_tables(jnp.asarray(positions), 32, base=5e5)
    tcos, tsin = tattn.rope_tables(torch.from_numpy(positions), 32,
                                   base=5e5)
    assert tcos.shape == jcos.shape
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=TOL)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=TOL)
    want = jattn.rotary_embedding(jnp.asarray(x), jnp.asarray(positions),
                                  base=5e5)
    got = tattn.rotary_embedding(torch.from_numpy(x),
                                 torch.from_numpy(positions), base=5e5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    half = tattn.apply_rope(torch.from_numpy(x).to(torch.bfloat16),
                            tcos, tsin)
    assert half.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="even"):
        tattn.rope_tables(torch.arange(3), 7)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(1)
    d, i = 16, 40
    p = {name: {"kernel": 0.2 * rng.standard_normal(shape,
                                                    dtype=np.float32)}
         for name, shape in (("w_gate", (d, i)), ("w_in", (d, i)),
                             ("w_out", (i, d)))}
    x = rng.standard_normal((2, 3, d), dtype=np.float32)
    want = jattn.ffn_swiglu_core(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    t = {n: torch.from_numpy(v["kernel"]) for n, v in p.items()}
    got = tattn.ffn_swiglu_core(t["w_gate"], None, t["w_in"], None,
                                t["w_out"], None, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


# ------------------------------------------------------------ the model

def test_config_validation_and_llama3_8b_widths():
    c = llama3_8b()
    assert (c.hidden_size, c.num_layers, c.num_heads, c.kv_heads,
            c.head_dim, c.intermediate_size, c.vocab_size, c.rope_base) \
        == (4096, 32, 32, 8, 128, 14336, 128256, 500000.0)
    assert (c.norm, c.ffn_activation, c.position_embedding, c.use_bias,
            c.tied_head) == ("rmsnorm", "swiglu", "rope", False, False)
    for bad in (dict(kv_cache_dtype="int4"), dict(norm="batchnorm"),
                dict(ffn_activation="relu"),
                dict(position_embedding="alibi")):
        with pytest.raises(ValueError):
            llama_tiny(**bad)


def test_convert_round_trips_a_llama_tree():
    jmodel, jparams, model = _models()
    tree = jax.tree.map(np.asarray, jparams)
    sd = gpt_params_from_jax(tree, model.config)
    assert set(sd) == set(model.state_dict())
    assert "position" not in sd and "lm_head" in sd
    assert not any(k.endswith((".beta", ".bias")) for k in sd)
    assert "blocks.1.ffn.w_gate.kernel" in sd
    back = gpt_params_to_jax(model.state_dict(), model.config)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # a top-level key the port does not run is refused (a MoE decoder
    # converts since the MoE FFN was ported)
    with pytest.raises(ValueError, match="not run yet"):
        gpt_params_from_jax(dict(tree, pipeline={}), model.config)


def test_apply_matches_jax():
    jmodel, jparams, model = _models()
    ids = _prompt(24, 5).reshape(2, 12)
    want = jmodel.logits(jparams, jmodel.apply(jparams, jnp.asarray(ids)))
    got = model.logits(model.apply(torch.from_numpy(ids)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)


def _pools(c, NP, pg):
    shape = (c.num_layers, NP, pg, c.kv_heads, c.head_dim)
    if c.kv_cache_dtype == "int8":
        names = {"k": np.int8, "v": np.int8}
        sshape = shape[:-1] + (1,)
        jkv = {n: jnp.zeros(shape, d) for n, d in names.items()}
        jkv.update({n + "_scale": jnp.zeros(sshape) for n in names})
        tkv = {n: torch.zeros(shape, dtype=torch.int8) for n in names}
        tkv.update({n + "_scale": torch.zeros(sshape) for n in names})
        return jkv, tkv
    return ({n: jnp.zeros(shape) for n in ("k", "v")},
            {n: torch.zeros(shape) for n in ("k", "v")})


def _assert_pools_match(tkv, jkv, int8):
    for name in tkv:
        got, want = tkv[name].numpy(), np.asarray(jkv[name])
        if int8 and name in ("k", "v"):
            # a value within f32 round-off of a rounding boundary may
            # quantize one step apart
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            assert (got != want).mean() < 1e-3
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"],
                         ids=["f32_cache", "int8_cache"])
def test_paged_window_and_decode_step_logits_match_jax(kv_cache_dtype):
    jmodel, jparams, model = _models(kv_cache_dtype=kv_cache_dtype)
    c = model.config
    pg, P, S, NP = 8, 4, 3, 16
    jkv, tkv = _pools(c, NP, pg)
    rng = np.random.default_rng(3)
    row = np.array([5, 2, 9, 0], np.int32)
    toks = rng.integers(0, c.vocab_size, (2, 1, 6), dtype=np.int32)
    for w, pos in enumerate((0, 6)):
        jl, jkv = jmodel.decode_window_paged(
            jparams, jkv, jnp.asarray(toks[w]), jnp.asarray(row),
            jnp.int32(pos), head="all", use_kernel=True)
        tl, tkv = model.decode_window_paged(
            tkv, torch.from_numpy(toks[w]), torch.from_numpy(row), pos,
            head="all")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
    _assert_pools_match(tkv, jkv, kv_cache_dtype == "int8")
    tab = np.array([row, [7, 8, 0, 0], [0, 0, 0, 0]], np.int32)
    write_col = np.array([12, 9, 4], np.int32)
    start_col = np.array([0, 2, 0], np.int32)
    cols = np.arange(P * pg)[None, :]
    valid = (cols >= start_col[:, None]) & (cols < write_col[:, None])
    positions = write_col + np.array([0, 3, 0], np.int32)
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
    _assert_pools_match(tkv, jkv, kv_cache_dtype == "int8")


def test_int8_pool_layout():
    _, _, model = _models(kv_cache_dtype="int8")
    cache = tpages.init_paged_cache(model, num_slots=2, num_pages=5,
                                    page_size=8)
    kv = cache["kv"]
    assert sorted(kv) == ["k", "k_scale", "v", "v_scale"]
    assert kv["k"].dtype == torch.int8 and kv["k"].shape == (2, 5, 8, 2, 32)
    assert kv["v_scale"].dtype == torch.float32
    assert kv["v_scale"].shape == (2, 5, 8, 2, 1)


# ----------------------------------------------------------- the engine

@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"],
                         ids=["f32_cache", "int8_cache"])
def test_engine_matches_jax_engine_and_generate(kv_cache_dtype):
    jmodel, jparams, model = _models(kv_cache_dtype=kv_cache_dtype)
    prompts = [_prompt(7, 1), _prompt(5, 2), _prompt(9, 3), _prompt(3, 4)]
    budgets = [9, 6, 4, 8]
    wants = [_generate(jmodel, jparams, p, n) for p, n in zip(prompts,
                                                              budgets)]
    eng = Engine(model, device="cpu", num_slots=2, max_len=64,
                 prefill_chunk=4, tick_steps=3)
    hs = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    eng.drain()
    jeng = jserve.Engine(jmodel, jparams, paged=True, num_slots=2,
                         max_len=64, prefill_chunk=4, tick_steps=3,
                         registry=metrics_lib.Registry())
    jhs = [jeng.submit(p, n) for p, n in zip(prompts, budgets)]
    jeng.drain()
    assert all(h.status == "ok" for h in hs)
    assert [h.tokens for h in hs] == [h.tokens for h in jhs] == wants


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"],
                         ids=["f32_cache", "int8_cache"])
def test_prefix_hit_matches_cold_cache_and_jax(kv_cache_dtype):
    jmodel, jparams, model = _models(kv_cache_dtype=kv_cache_dtype)
    sys_prompt = _prompt(16, 7)                   # 2 pages at page_size 8
    reqs = [np.concatenate([sys_prompt, _prompt(5, 8)]),
            np.concatenate([sys_prompt, _prompt(3, 9)])]

    def run(eng, req):
        h = eng.submit(req, 7)
        eng.drain()
        assert h.status == "ok"
        return h.tokens

    kw = dict(num_slots=2, max_len=64, prefill_chunk=4, tick_steps=2,
              page_size=8)
    warm = Engine(model, device="cpu", **kw)
    got = [run(warm, r) for r in reqs]            # seed, then hit
    assert warm.stats().prefix_hits_total == 1
    assert warm.stats().prefill_windows_skipped_total == 4
    jwarm = jserve.Engine(jmodel, jparams, paged=True,
                          registry=metrics_lib.Registry(), **kw)
    assert [run(jwarm, r) for r in reqs] == got
    for req, g in zip(reqs, got):
        assert run(Engine(model, device="cpu", **kw), req) == g
        assert g == _generate(jmodel, jparams, req, 7)
