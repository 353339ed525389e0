"""The JAX package's multi-chip check in the port: the BERT MLM step that
``__graft_entry__.py`` ``dryrun_multichip(8)`` trains on ``{"data": 2,
"seq": 2, "tensor": 2}`` (vocab 512, d 64, 2 layers of 2 heads, FFN 128,
32 positions, 2 rows a data rank, a 15% MLM mask; the configuration is
built here), on 8 gloo ranks: each rank one tensor rank's Megatron blocks
on its shard of its data rank's rows, ring-flash over its seq line.
Dropout 0 (its bits are the generators', not ``jax.random``'s).

- The forward's sequence output and pooled ``[CLS]`` within 1e-5 of the
  JAX package's one-device forward, the loss within rtol 1e-5;
- two adamw steps (1e-3, clip 1.0): the loss and the norm within rtol
  1e-5 and every rank's blocks within atol 5e-5 of the JAX step on 8
  virtual devices of the same mesh (the model built with ``seq_axis``,
  ``shard_pytree`` by its rules), and of the port's plain step on the
  whole batch;
- the collectives a step, exact: the gradient mean is one all-reduce
  over the seq line and one over the data line; the replicas of a tensor
  index (its seq and data lines) hold the same blocks."""
import pytest
import torch

import tsp_cases

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    return tsp_cases.graft_case()


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory, case):
    return tsp_cases.start(tmp_path_factory,
                           {"cases": {"graft": case}, "ckpt": {}},
                           axes=tsp_cases.GRAFT_AXES)


@pytest.fixture(scope="module")
def jax_side(started, case):
    return (tsp_cases.jax_steps(case, tsp_cases.GRAFT_AXES),
            tsp_cases.jax_forward(case))


@pytest.fixture(scope="module")
def run(started, jax_side):
    return started()


def test_forward_matches_the_jax_package(run, jax_side):
    tsp_cases.check_forward(run, jax_side, "graft")


def test_two_adamw_steps_match_the_jax_step(run, jax_side):
    tsp_cases.check_jax_steps(run, jax_side, "graft", "tsp")


def test_two_adamw_steps_match_the_plain_step(run):
    tsp_cases.check_plain_steps(run, "graft")


def test_collectives_a_step(run, case):
    tsp_cases.check_collectives(run, "graft", case, data=2)
