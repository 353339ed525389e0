"""``tensor`` beside ``seq`` for the Llama recipe in the port, held
against the JAX package: one launch of 4 gloo ranks ``{"seq": 2,
"tensor": 2}`` (a rank's Megatron blocks on its shard of the sequence,
ring-flash over its seq line on its query heads and the kv heads they
read; RoPE at the shard's global offset; the kernels' plain versions on
the CPU).  ``tests/test_torch_tp_sp.py`` holds GPT-2 and BERT.

- **Cases**: the Llama recipe tiny (RoPE, RMSNorm, SwiGLU, 4 q / 2 kv
  heads) with its kv heads cut over ``tensor`` (``shard_kv=True``:
  a rank's 2 query heads and its kv head), with them replicated (each
  rank's queries read their group's kv head, sliced before the ring),
  and the recipe with one kv head replicated (fewer kv heads than
  tensor ranks: both ranks read it); f32, dropout 0.
- **Forward**: ``apply``'s gathered hidden within 1e-5 of the JAX
  package's one-device forward, the loss within rtol 1e-5 of the JAX
  step's first.
- **Two adamw steps** (1e-3, clip 1.0), and under remat "dots": the
  loss and the norm within rtol 1e-5 and every rank's blocks within atol
  5e-5 of the JAX step on ``shard_pytree(params, jmesh, rules)`` over the
  same mesh; the replicated recipe at kv 2 against the port's plain step
  only (one JAX compile less); every metric also against the port's
  plain step on the whole batch.
- **Collectives a step**, exact, and the blocks in agreement along the
  seq line, the replicated leaves on every rank."""
import pytest
import torch

import tsp_cases

torch.set_num_threads(1)

NAMES = ("llama_skv", "llama", "llama_kv1")
JAX_NAMES = ("llama_skv", "llama_kv1")


@pytest.fixture(scope="module")
def cases():
    return {n: c for n, c in tsp_cases.cases().items() if n in NAMES}


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory, cases):
    return tsp_cases.start(tmp_path_factory, {"cases": cases, "ckpt": {}})


@pytest.fixture(scope="module")
def jax_side(started, cases):
    return tsp_cases.jax_side(cases, JAX_NAMES)


@pytest.fixture(scope="module")
def run(started, jax_side):
    return started()


@pytest.mark.parametrize("name", JAX_NAMES)
def test_forward_matches_the_jax_package(run, jax_side, name):
    tsp_cases.check_forward(run, jax_side[name], name)


@pytest.mark.parametrize("arm", ["tsp", "remat"])
@pytest.mark.parametrize("name", JAX_NAMES)
def test_two_adamw_steps_match_the_jax_step(run, jax_side, name, arm):
    tsp_cases.check_jax_steps(run, jax_side[name], name, arm)


@pytest.mark.parametrize("name", NAMES)
def test_two_adamw_steps_match_the_plain_step(run, name):
    tsp_cases.check_plain_steps(run, name)


@pytest.mark.parametrize("name", NAMES)
def test_collectives_a_step(run, cases, name):
    tsp_cases.check_collectives(run, name, cases[name])
