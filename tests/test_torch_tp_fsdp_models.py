"""``tensor`` beside ``fsdp`` for the other models of the port, held
against the JAX package: one launch of 4 gloo ranks ``{"fsdp": 2,
"tensor": 2}``, where GPT-2 tiny, the Llama recipe tiny (GQA 4:2, whose
kv kernels replicate over the tensor line: a leaf cut over ``fsdp``
alone beside the tensor blocks), BERT tiny (MLM) and ViT tiny each take
two ``adamw`` steps (f32, dropout 0, clip 1.0) under their
``partition_rules(fsdp=True)``.  The loss and the norm within rtol 1e-5
and every rank's blocks within atol 5e-5 of the JAX step on
``shard_pytree(params, jmesh, rules(fsdp=True))``; one all-gather and
one reduce-scatter over ``fsdp`` a step, the norm over both lines, and
no data line to average over."""
import pytest
import torch

import tpf_cases
import torch_ep_worker
import torch_sp_worker
import torch_tpf_worker

torch.set_num_threads(1)

AXES = {"fsdp": 2, "tensor": 2}
NAMES = ("gpt2", "llama", "bert", "vit")


@pytest.fixture(scope="module")
def cases():
    return tpf_cases.model_cases()


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory, cases):
    """The gloo run, started before the JAX package's side is computed."""
    tmp = tmp_path_factory.mktemp("tpf_models")
    spec = {"axes": AXES, "cases": {n: cases[n][0] for n in NAMES}}
    return torch_sp_worker.start_ranks(
        tmp_path_factory.mktemp("tpf_models_run"),
        torch_tpf_worker.run_tpf_models_rank,
        (torch_ep_worker.park(tmp / "spec.pkl", spec),), world=4)


@pytest.fixture(scope="module")
def jax_side(started, cases):
    return {n: tpf_cases.model_jax_steps(AXES, cases[n][1]) for n in NAMES}


@pytest.fixture(scope="module")
def run(started, jax_side):
    return started()


@pytest.mark.parametrize("name", NAMES)
def test_two_adamw_steps_match_the_jax_step(run, jax_side, name):
    tpf_cases.check_steps(run, jax_side[name], f"tpf/{name}",
                          ("loss", "grad_norm"))


@pytest.mark.parametrize("name", NAMES)
def test_collectives_a_step(run, name):
    for out in run:
        for i in range(2):
            got = tpf_cases.launches(out, f"tpf/{name}", i)
            assert got.pop("all_gather") == 1
            assert got.pop("reduce_scatter") == 1
            assert got.pop("stats_all_reduce") == 2
            assert "all_reduce" not in got
            assert got.pop("tp_all_reduce") > 0
            assert set(got) <= {"tp_all_gather"}
