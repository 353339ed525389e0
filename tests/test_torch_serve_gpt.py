"""The port's ``examples.serve_gpt`` against the JAX package's
``examples/serve_gpt.py``.

- ``python -m distributed_tensorflow_tpu_torch.examples.serve_gpt`` runs
  in-process on ``--device=cpu`` at 4 new tokens with ``--engine
  --replicas=2 --shared_prefix`` and prints the JAX script's lines, in
  its order and f-string forms; the prefix-cache line's counts are the
  JAX script's at these flags (they depend on the prompts and the page
  size only), and every exactness line reads 1.000.
- ``serve_demo`` run on the JAX demo's weights (``GPT.init(PRNGKey(0))``
  carried across by ``gpt_params_from_jax``) gives the JAX demo's tokens
  on the greedy, ragged, beam, chunked, weight-only int8 and full-int8
  paths, the engine's greedy, and speculative decoding (tokens and
  acceptance), each computed here with the JAX script's own calls.
- The entry point runs on the card by default and raises without one.

Tokens are held exactly.
"""
import contextlib
import io
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_tpu.models.gpt import GPTConfig as JConfig
from distributed_tensorflow_tpu.models.speculative import \
    generate_speculative as jgenerate_speculative
from distributed_tensorflow_tpu.ops import quant as jquant
from distributed_tensorflow_tpu_torch import gpt_params_from_jax
from distributed_tensorflow_tpu_torch.examples import serve_gpt

torch.set_num_threads(1)

NEW, B, PLEN = 4, 4, 8


def _lines(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue().splitlines()


def _rate(name):
    return re.escape(f"{name:<28} ") + r"[ \d,]{10} tok/s"


def _note(text):
    return re.escape(f"{'':<28} {text}")


def test_demo_prints_the_jax_scripts_lines():
    rc, lines = _lines(serve_gpt.main, [
        "--device=cpu", f"--new_tokens={NEW}", "--engine", "--replicas=2",
        "--shared_prefix"])
    assert rc == 0
    one = r"1\.000"
    want = [
        r"telemetry: http://127\.0\.0\.1:\d+/metrics \(\+ /healthz\)",
        _rate("greedy generate"), _rate("sampled (T=0.8, top_p=0.9)"),
        _rate("ragged batch (prompt_valid)"), _rate("beam search (beam=4)"),
        _rate("chunked prefill (W=4)"), _rate("int8 weights"),
        _note("int8 greedy agreement ") + r"\d\.\d{3}",
        _rate("int8 weights + int8 KV cache"),
        _note("full-int8 greedy agreement ") + r"\d\.\d{3}",
        _rate("engine greedy"), _note("engine==lock-step greedy ") + one,
        _rate("engine sampled (T=0.8)"), _rate("engine ragged"),
        re.escape(f"{'shared-prefix (paged KV)':<28} ttft cold ")
        + r" *[\d.]+ ms -> hit  *[\d.]+ ms \([\d.]+x faster\)",
        _note("prefix hits 3/5, 6 prefill windows skipped, 24 tokens "
              "reused, 15/20 pages free"),
        _rate("fleet (2 replicas)"),
        _note("fleet==lock-step greedy ") + one
        + re.escape(" (base-model rows), placements {0: 4, 1: 4}"),
        _rate("speculative (gamma=4)"),
        _note("spec acceptance ") + r"\d\.\d{3}, greedy match " + one,
        _note("/metrics scrape: ") + r"[1-9]\d* samples",
    ]
    assert len(lines) == len(want), lines
    for line, pattern in zip(lines, want):
        assert re.fullmatch(pattern, line), (line, pattern)


def test_demo_tokens_equal_the_jax_demos_on_its_weights():
    max_len = PLEN + NEW + 8
    config = JConfig(vocab_size=512, hidden_size=128, num_layers=4,
                     num_heads=4, intermediate_size=512,
                     max_position=max_len + 8, dropout_rate=0.0)
    jmodel = JGPT(config)
    params = jmodel.init(jax.random.PRNGKey(0))
    prompt = np.random.default_rng(0).integers(
        0, 512, (B, PLEN)).astype(np.int32)
    port_config, port_max_len = serve_gpt.demo_config(NEW)
    assert port_max_len == max_len
    sd = gpt_params_from_jax(jax.tree.map(np.asarray, params), port_config)
    got, _ = _lines(serve_gpt.serve_demo, sd, device="cpu", new=NEW,
                    batch=B, seed=0, engine=True)

    def gen(p, prompt_ids, model=jmodel, **kw):
        return np.asarray(jax.jit(lambda: model.generate(
            p, prompt_ids, max_new_tokens=NEW, max_len=max_len, **kw))())

    valid = np.ones((B, PLEN), np.int32)
    valid[0, : PLEN // 2] = 0
    ragged = prompt.copy()
    ragged[0, : PLEN // 2] = 0
    deq = jquant.dequantize_tree(jquant.quantize_tree(params))
    kv8 = JGPT(JConfig(**{**config.__dict__, "kv_cache_dtype": "int8"}))
    greedy = gen(params, prompt, temperature=0.0)
    want = {
        "greedy": greedy,
        "ragged": gen(params, jnp.asarray(ragged),
                      prompt_valid=jnp.asarray(valid)),
        "beam": np.asarray(jax.jit(lambda: jmodel.beam_search(
            params, prompt, max_new_tokens=NEW, beam_size=4,
            max_len=max_len))()),
        "chunked": gen(params, prompt, temperature=0.0, prefill_chunk=4),
        "int8": gen(deq, prompt, temperature=0.0),
        "kv8": gen(deq, prompt, model=kv8, temperature=0.0),
    }
    for name, tokens in want.items():
        np.testing.assert_array_equal(got[name], tokens, err_msg=name)
    assert got["engine_greedy"] == greedy[:, PLEN:].tolist()
    draft = JGPT(JConfig(**{**config.__dict__, "num_layers": 2}))
    d_params = dict(params)
    d_params["decoder"] = jax.tree.map(lambda a: a[:2], params["decoder"])
    spec, acc = jgenerate_speculative(jmodel, params, draft, d_params,
                                      prompt[:1], max_new_tokens=NEW,
                                      gamma=4)
    np.testing.assert_array_equal(got["spec"][0], np.asarray(spec))
    assert got["spec"][1] == pytest.approx(float(acc), abs=1e-6)


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default would run on it")
    with pytest.raises(RuntimeError, match="CUDA card"):
        serve_gpt.main(["--new_tokens=2", "--metrics_port=-1"])
