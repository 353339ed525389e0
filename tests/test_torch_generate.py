"""The port's single-stream decoding on the contiguous KV cache held
against the JAX package.

Same weights (a JAX tree carried across by ``load_jax_params``), same
numpy inputs, four tiny families: the GPT-2 base (2 layers, d 64), RoPE
with grouped-query attention, an int8 KV cache, and ``llama_tiny``.

* ``decode_block``, ``decode_step``, ``decode_window`` (every ``head``)
  and ``prefill_cache`` logits agree within 1e-4 at f32 (matrix products
  sum in another order), and so do the caches they write.  Logits read
  back through an int8 cache are held at the JAX tests' int8 tolerance
  (5e-2), and int8 cache values may sit one quantization step apart
  where an f32 round-off crosses a rounding boundary.  The JAX
  ``decode_block`` runs dense, as it does on the CPU, and once with
  ``use_flash=True``, its Pallas kernel in interpret mode.
* ``generate`` greedy tokens equal the JAX ones, plain, with
  ``eos_id``/``pad_id``, with left-padded ``prompt_valid`` and with
  ``prefill_chunk``, and it refuses what the JAX one refuses.  Sampling
  draws other bits than ``jax.random``, so the sampled path is held by
  law: ``top_k=1`` is greedy, and every token lies in the filtered
  support of its step.
* ``beam_search`` tokens equal the JAX ones, with and without EOS.

The port runs on the CPU here, so its kernel wrappers take their plain
versions.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models import llama as jllama
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu_torch import GPT, GPTConfig, load_jax_params
from distributed_tensorflow_tpu_torch.ops import decoding as tdec

torch.set_num_threads(1)

LOGIT_TOL = 1e-4
INT8_LOGIT_TOL = 5e-2       # tests/test_gpt.py::test_int8_kv_cache_decode
_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
           "intermediate_size", "max_position", "layer_norm_eps",
           "num_kv_heads", "position_embedding", "rope_base", "norm",
           "ffn_activation", "use_bias", "tied_head", "kv_cache_dtype")
FAMILIES = {
    "base": {},
    "rope_gqa": dict(position_embedding="rope", num_heads=4, num_kv_heads=2),
    "int8": dict(kv_cache_dtype="int8"),
    "llama": None,
}


@functools.lru_cache(maxsize=None)
def _models(family, **kw):
    """(JAX model, its params, the port model with the same weights); built
    once per family (no test changes a model or its weights)."""
    if FAMILIES[family] is None:
        jmodel = jllama.llama_tiny(**kw)
    else:
        jmodel = jgpt_tiny(dropout_rate=0.0, hidden_size=64, max_position=64,
                           **FAMILIES[family], **kw)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    config = GPTConfig(dropout_rate=0.0, **{
        f: getattr(jmodel.config, f) for f in _FIELDS})
    model = load_jax_params(GPT(config, device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model


def _ids(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0, err_msg=what)


def _assert_caches_match(tcache, jcache, int8):
    assert int(tcache["pos"]) == int(jcache["pos"])
    for name in ("k", "v", "k_scale", "v_scale"):
        if name not in jcache:
            assert name not in tcache
            continue
        got, want = tcache[name].numpy(), np.asarray(jcache[name])
        if int8 and name in ("k", "v"):
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            assert (got != want).mean() < 1e-3
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------ the decode surface

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_surface_logits_and_cache_match_jax(family):
    jmodel, jparams, model = _models(family)
    int8 = model.config.kv_cache_dtype == "int8"
    read_tol = INT8_LOGIT_TOL if int8 else LOGIT_TOL
    ids = _ids((2, 6), 1)
    more = _ids((2, 5), 2)
    jc, tc = jmodel.init_cache(2, 16), model.init_cache(2, 16)
    jl, jc = jmodel.decode_block(jparams, jc, jnp.asarray(ids))
    tl, tc = model.decode_block(tc, _t(ids))
    # the block attends its own unquantized K/V on both sides
    _close(tl, jl, LOGIT_TOL, "decode_block")
    _assert_caches_match(tc, jc, int8)
    for t in range(2):
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(more[:, t]))
        tl, tc = model.decode_step(tc, _t(more[:, t]))
        _close(tl, jl, read_tol, f"decode_step {t}")
    for head, (lo, hi) in (("all", (2, 4)), ("last", (4, 5))):
        jl, jc = jmodel.decode_window(jparams, jc,
                                      jnp.asarray(more[:, lo:hi]), head=head)
        tl, tc = model.decode_window(tc, _t(more[:, lo:hi]), head=head)
        assert tl.shape == jl.shape
        _close(tl, jl, read_tol, f"decode_window {head}")
    _assert_caches_match(tc, jc, int8)
    jl, jc = jmodel.decode_window(jparams, jc, jnp.asarray(ids[:, :3]),
                                  head="none")
    tl, tc = model.decode_window(tc, _t(ids[:, :3]), head="none")
    assert tl is None and jl is None
    _assert_caches_match(tc, jc, int8)


@pytest.mark.parametrize("family", ["base", "llama"])
def test_ragged_decode_block_matches_jax(family):
    """Left-padded rows through the dense path with per-row positions;
    a fully masked pad row stays finite."""
    jmodel, jparams, model = _models(family)
    ids = _ids((3, 7), 3)
    valid = np.ones((3, 7), bool)
    valid[0, :3] = False
    valid[2, :6] = False                       # one real token
    pad = (7 - valid.sum(1)).astype(np.int32)
    positions = np.maximum(np.arange(7)[None, :] - pad[:, None], 0)
    jl, jc = jmodel.decode_block(jparams, jmodel.init_cache(3, 12),
                                 jnp.asarray(ids), kv_valid=jnp.asarray(valid),
                                 positions=jnp.asarray(positions))
    tl, tc = model.decode_block(model.init_cache(3, 12), _t(ids),
                                kv_valid=_t(valid), positions=_t(positions))
    assert torch.isfinite(tl).all()
    _close(tl, jl, LOGIT_TOL)
    _assert_caches_match(tc, jc, False)


def test_decode_block_matches_jax_flash_kernel_in_interpret_mode():
    """The JAX block through its Pallas flash kernel (``use_flash=True``,
    interpret mode on the CPU) against the port's flash route."""
    jmodel, jparams, model = _models("base", use_flash=True)
    ids = _ids((2, 9), 4)
    jl, jc = jmodel.decode_block(jparams, jmodel.init_cache(2, 12),
                                 jnp.asarray(ids))
    tl, tc = model.decode_block(model.init_cache(2, 12), _t(ids))
    _close(tl, jl, LOGIT_TOL)
    _assert_caches_match(tc, jc, False)


@pytest.mark.parametrize("family", ["base", "int8", "llama"])
def test_prefill_cache_one_block_and_chunked_match_jax(family):
    jmodel, jparams, model = _models(family)
    int8 = model.config.kv_cache_dtype == "int8"
    ids = _ids((2, 10), 5)
    for chunk in (None, 4):
        jl, jc = jmodel.prefill_cache(jparams, jmodel.init_cache(2, 16),
                                      jnp.asarray(ids), chunk=chunk)
        tl, tc = model.prefill_cache(model.init_cache(2, 16), _t(ids),
                                     chunk=chunk)
        _close(tl, jl, INT8_LOGIT_TOL if int8 and chunk else LOGIT_TOL,
               f"chunk {chunk}")
        _assert_caches_match(tc, jc, int8)


def test_int8_block_and_chunked_prefill_differ_by_quantization_only():
    """The block attends unquantized K/V, the chunked windows read them
    back quantized: close, and not equal, on both sides alike."""
    _, _, model = _models("int8")
    ids = _t(_ids((2, 10), 5))
    one, _ = model.prefill_cache(model.init_cache(2, 16), ids)
    chunked, _ = model.prefill_cache(model.init_cache(2, 16), ids, chunk=4)
    err = (one - chunked).abs().max().item()
    assert 0 < err <= INT8_LOGIT_TOL


def test_prefill_cache_and_decode_block_refusals():
    _, _, model = _models("base")
    cache = model.init_cache(1, 16)
    with pytest.raises(ValueError, match="non-empty"):
        model.prefill_cache(cache, torch.zeros((1, 0), dtype=torch.int32))
    with pytest.raises(ValueError, match="chunk"):
        model.prefill_cache(cache, _t(_ids((1, 4), 0)), chunk=0)
    _, cache = model.decode_step(cache, _t(_ids((1,), 0)))
    with pytest.raises(ValueError, match="empty cache"):
        model.prefill_cache(cache, _t(_ids((1, 4), 0)))
    with pytest.raises(ValueError, match="empty cache"):
        model.decode_block(cache, _t(_ids((1, 4), 0)))
    with pytest.raises(ValueError, match="head"):
        model.decode_window(cache, _t(_ids((1, 2), 0)), head="first")


# ----------------------------------------------------------------- generate

_GEN_MODES = {
    "plain": dict(),
    "eos_pad": dict(eos_id=None, pad_id=0),     # eos picked from the run
    "ragged": dict(prompt_valid=True),
    "chunked": dict(prefill_chunk=3),
}


# every family plain; each option on two families
_GEN_CASES = ([(f, "plain") for f in sorted(FAMILIES)]
              + [("base", "eos_pad"), ("llama", "eos_pad"),
                 ("base", "ragged"), ("rope_gqa", "ragged"),
                 ("base", "chunked"), ("int8", "chunked")])


@pytest.mark.parametrize("family,mode", _GEN_CASES)
def test_generate_greedy_matches_jax(family, mode):
    jmodel, jparams, model = _models(family)
    ids = _ids((3, 7), 6)
    kw = dict(_GEN_MODES[mode])
    if "eos_id" in kw:
        # a token the free-running decode emits mid-way in some row
        free = np.asarray(jmodel.generate(jparams, jnp.asarray(ids), 9))
        kw["eos_id"] = int(free[1, 10])
    jkw = dict(kw)
    if kw.get("prompt_valid"):
        valid = np.ones((3, 7), bool)
        valid[0, :2] = False
        valid[2, :5] = False
        kw["prompt_valid"], jkw["prompt_valid"] = _t(valid), jnp.asarray(
            valid)
    want = np.asarray(jmodel.generate(jparams, jnp.asarray(ids), 9,
                                      max_len=20, **jkw))
    got = model.generate(_t(ids), 9, max_len=20, **kw)
    assert got.dtype == torch.int32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    if mode == "eos_pad":
        assert (got[1, 11:] == 0).all()        # pads after the stop


@pytest.mark.parametrize("plen,new", [(1, 5), (4, 0), (5, 1)])
def test_generate_edge_lengths_match_jax(plen, new):
    jmodel, jparams, model = _models("base")
    ids = _ids((2, plen), 7)
    want = np.asarray(jmodel.generate(jparams, jnp.asarray(ids), new,
                                      eos_id=3))
    np.testing.assert_array_equal(
        model.generate(_t(ids), new, eos_id=3).numpy(), want)


def test_generate_refuses_what_jax_refuses():
    jmodel, jparams, model = _models("base")
    ids = _ids((2, 6), 8)
    right = np.ones((2, 6), bool)
    right[0, -1] = False
    # (kwargs, message, beam_search takes them too)
    cases = [
        (dict(max_new_tokens=70), "max_position", True),
        (dict(max_new_tokens=8, max_len=10), "exceeds max_len", True),
        (dict(max_new_tokens=4, pad_id=1), "pad_id requires eos_id", False),
        (dict(max_new_tokens=4, prefill_chunk=2, prompt_valid=right),
         "does not compose", True),
        (dict(max_new_tokens=4, prompt_valid=right), "LEFT-padded", True),
    ]
    for kw, match, beam in cases:
        jkw = dict(kw)
        if "prompt_valid" in kw:
            jkw["prompt_valid"] = jnp.asarray(kw["prompt_valid"])
            kw = dict(kw, prompt_valid=_t(kw["prompt_valid"]))
        with pytest.raises(ValueError, match=match):
            jmodel.generate(jparams, jnp.asarray(ids), **jkw)
        with pytest.raises(ValueError, match=match):
            model.generate(_t(ids), **kw)
        if beam:
            with pytest.raises(ValueError, match=match):
                jmodel.beam_search(jparams, jnp.asarray(ids), **jkw)
            with pytest.raises(ValueError, match=match):
                model.beam_search(_t(ids), **kw)


def test_sampled_generate_top_k1_is_greedy_and_stays_in_support():
    _, _, model = _models("base")
    ids = _t(_ids((2, 5), 9))
    greedy = model.generate(ids, 8)
    gen = torch.Generator().manual_seed(0)
    one = model.generate(ids, 8, temperature=0.7, top_k=1, generator=gen)
    assert torch.equal(one, greedy)
    k, p = 5, 0.9
    out = model.generate(ids, 8, temperature=1.3, top_k=k, top_p=p,
                         generator=torch.Generator().manual_seed(1))
    # re-score the emitted continuation step by step: every sampled token
    # is inside that step's filtered support
    cache = model.init_cache(2, 13)
    for t in range(12):
        logits, cache = model.decode_step(cache, out[:, t])
        if t >= 4:
            kept = torch.isfinite(tdec.filtered_logits(logits, 1.3, k, p))
            assert kept.gather(1, out[:, t + 1, None].long()).all(), t
    other = model.generate(ids, 8, temperature=1.3, top_k=k, top_p=p,
                           generator=torch.Generator().manual_seed(2))
    assert not torch.equal(out, other)


# ------------------------------------------------------------- beam search

@pytest.mark.parametrize("family,eos", [
    ("base", None), ("base", "picked"), ("int8", "picked"), ("llama", None)])
def test_beam_search_matches_jax(family, eos):
    jmodel, jparams, model = _models(family)
    ids = _ids((2, 6), 10)
    eos_id = None
    if eos:
        free = np.asarray(jmodel.beam_search(jparams, jnp.asarray(ids), 8,
                                             beam_size=3))
        eos_id = int(free[0, 9])
    want = np.asarray(jmodel.beam_search(jparams, jnp.asarray(ids), 8,
                                         beam_size=3, eos_id=eos_id))
    got = model.beam_search(_t(ids), 8, beam_size=3, eos_id=eos_id)
    assert got.shape == (2, 14) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_beam_search_ragged_and_chunked_match_jax():
    jmodel, jparams, model = _models("rope_gqa")
    ids = _ids((2, 7), 11)
    valid = np.ones((2, 7), bool)
    valid[1, :3] = False
    want = np.asarray(jmodel.beam_search(jparams, jnp.asarray(ids), 6,
                                         beam_size=4,
                                         prompt_valid=jnp.asarray(valid)))
    got = model.beam_search(_t(ids), 6, beam_size=4, prompt_valid=_t(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jmodel.beam_search(jparams, jnp.asarray(ids), 6,
                                         beam_size=4, prefill_chunk=2))
    got = model.beam_search(_t(ids), 6, beam_size=4, prefill_chunk=2)
    np.testing.assert_array_equal(got.numpy(), want)
