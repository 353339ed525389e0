"""The pipelined Llama tiny recipe (GQA 4:2, RMSNorm, SwiGLU, RoPE, an
untied head) in the port, held against the JAX package: the checks of
``tests/test_torch_pipeline_gpt.py`` (its helpers; a spawn of 4 gloo
ranks of its own, ``{"pipe": 2, "data": 2}``) at the same tolerances:
the pipelined forward, the GPipe and 1F1B loss and gradients under a
``loss_mask``, GPipe against 1F1B under dropout, and two masked
``adamw(1e-3)`` steps of each schedule against the JAX steps."""
import pytest
import torch

from test_torch_pipeline_gpt import (check_forward_loss_and_grads,
                                     check_same_dropout,
                                     check_two_masked_steps,
                                     spawn_and_compare)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_and_compare(tmp_path_factory, ["llama"], ckpt=False)


def test_forward_loss_and_grads_equal_jax(ranks):
    check_forward_loss_and_grads(ranks, "llama")


def test_gpipe_and_1f1b_draw_the_same_dropout(ranks):
    check_same_dropout(ranks, "llama")


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_two_masked_steps_equal_the_jax_steps(ranks, schedule):
    check_two_masked_steps(ranks, "llama", schedule)
