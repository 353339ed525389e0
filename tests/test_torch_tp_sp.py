"""``tensor`` beside ``seq`` in the port, held against the JAX package:
one launch of 4 gloo ranks ``{"seq": 2, "tensor": 2}`` (each rank a
tensor rank's Megatron blocks on its shard of the sequence, ring-flash
over its seq line on its heads; the kernels' plain versions on the CPU).

- **Models**: GPT-2 tiny (one head a rank, a ``loss_mask`` whose counts
  differ between the shards) and BERT tiny (MLM with the gathered head,
  ``mlm_predictions_per_seq=3``; key padding that leaves some rows no
  real key on rank 1's block); f32, dropout 0.  The Llama recipe's
  cases are ``tests/test_torch_tp_sp_llama.py``'s.
- **Forward**: ``apply``'s gathered output (BERT's pooled ``[CLS]``
  too) within 1e-5 of the JAX package's one-device forward, the loss
  within rtol 1e-5 of the JAX step's first.
- **Two adamw steps** (1e-3, clip 1.0), with and without remat: the loss
  and the norm within rtol 1e-5 and every rank's blocks within atol
  5e-5 (``tests/test_torch_tp.py``'s tolerances) of the JAX step on
  ``shard_pytree(params, jmesh, rules)`` over the same mesh, the model
  built with ``seq_axis``.  Every metric also against the port's plain
  step on the whole batch.
- **Collectives a step**, exact: the tensor line's, the ring's
  rotations (a layer: one forward, two backward, one more forward under
  remat), the seq line's loss sum, the norm's one over ``tensor`` and
  the gradient mean over the ``seq`` line.
- **Dropout 0.1**: the four ranks' training forwards agree, and after a
  step the blocks agree along the seq line and the replicated leaves on
  every rank.
- **``gather_params``** gives a rank's blocks, which the tensor line's
  boxes join into the whole model (the seq ranks hold the same); a
  **sharded checkpoint** round-trips and ``verify_sharded`` passes (each
  box written once: by the seq line's first rank)."""
import numpy as np
import pytest
import torch

import expert_cases
import tsp_cases
from distributed_tensorflow_tpu_torch.train import sharded_checkpoint

torch.set_num_threads(1)

NAMES = ("gpt2", "bert")


@pytest.fixture(scope="module")
def cases():
    return {n: c for n, c in tsp_cases.cases().items() if n in NAMES}


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    return {n: str(tmp_path_factory.mktemp(f"tsp_ckpt_{n}"))
            for n in NAMES}


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory, cases, ckpt_dirs):
    return tsp_cases.start(tmp_path_factory, {
        "cases": cases, "ckpt": ckpt_dirs, "dropout": "gpt2"})


@pytest.fixture(scope="module")
def jax_side(started, cases):
    return tsp_cases.jax_side(cases, NAMES)


@pytest.fixture(scope="module")
def run(started, jax_side):
    return started()


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_the_jax_package(run, jax_side, name):
    tsp_cases.check_forward(run, jax_side[name], name)


@pytest.mark.parametrize("arm", ["tsp", "remat"])
@pytest.mark.parametrize("name", NAMES)
def test_two_adamw_steps_match_the_jax_step(run, jax_side, name, arm):
    tsp_cases.check_jax_steps(run, jax_side[name], name, arm)


@pytest.mark.parametrize("name", NAMES)
def test_two_adamw_steps_match_the_plain_step(run, name):
    tsp_cases.check_plain_steps(run, name)


@pytest.mark.parametrize("name", NAMES)
def test_collectives_a_step(run, cases, name):
    tsp_cases.check_collectives(run, name, cases[name])


def test_dropout_keeps_the_lines_equal(run):
    first = run[0]
    assert not np.array_equal(first["dropout/hidden"],
                              first["dropout/hidden_eval"])
    for out in run[1:]:
        for k in ("dropout/hidden", "dropout/loss"):
            np.testing.assert_array_equal(out[k], first[k], err_msg=k)
    tsp_cases.lines_agree(run, "dropout")


@pytest.mark.parametrize("name", NAMES)
def test_gather_params_gives_the_models_blocks(run, jax_side, name):
    """``gather_params`` returns the blocks the model computes on; over
    the tensor line their boxes join into the whole model, which is the
    JAX step's."""
    _, jwhole = jax_side[name][0]
    for out in run:
        assert bool(out[f"tsp/{name}/gathered_same"])
        expert_cases.blocks_close(out, f"tsp/{name}/gathered", jwhole,
                                  tsp_cases.PARAM_ATOL)
    # the two boxes of a tensor line tile every leaf, once if it is cut
    # and twice if it is whole
    by = {tuple(o["coords"][1:]): o for o in run}
    for pname, leaf in jwhole.items():
        covered = np.zeros(leaf.shape, np.int64)
        boxes = [by[(0, t)][f"tsp/{name}/gathered/box/{pname}"]
                 for t in range(2)]
        for box in boxes:
            covered[tuple(slice(lo, lo + n) for lo, n in box)] += 1
        want = 2 if np.array_equal(*boxes) else 1
        assert (covered == want).all(), pname


@pytest.mark.parametrize("name", NAMES)
def test_sharded_checkpoint_round_trips(run, ckpt_dirs, name):
    for out in run:
        assert bool(out[f"tsp/{name}/restored/equal"])
        assert int(out[f"tsp/{name}/restored/step"]) == 2
        assert bool(out[f"tsp/{name}/restored/same_tensors"])
    path = sharded_checkpoint.all_sharded_checkpoints(ckpt_dirs[name])[-1]
    assert sharded_checkpoint.verify_sharded(path) == (True, "")
