"""Expert parallelism beside tensor parallelism in the port, held against
the JAX package: two adamw steps of the MoE GPT (``gpt_tiny(moe_experts=
4)``, f32, dropout and the router jitter off) on 4 gloo ranks
``{"expert": 2, "tensor": 2}``, where a bank's ``w_in``, ``b_in`` and
``w_out`` are cut along two dims (``parallel.sharding.Blocks``): losses,
``moe_aux`` and the clip's norm within rtol 1e-5, every rank's blocks
within atol 5e-5 of the JAX step on ``shard_pytree(params, jmesh,
rules)`` over the same mesh and of the port's plain step.  Each step's
expert collectives are exact, the norm sums over both lines (one
all-reduce each) and no data line averages; the tensor line's
collectives are the same on every rank.  (``tests/test_torch_expert.py``
holds the ``data`` x ``expert`` mesh.)"""
import pytest
import torch

import expert_cases
import torch_ep_worker
import torch_sp_worker

torch.set_num_threads(1)

AXES = {"expert": 2, "tensor": 2}


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The gloo run, started before the JAX package's side is computed."""
    tmp = tmp_path_factory.mktemp("ep_tp")
    spec = {"cases": {"ep_tp": expert_cases.step_case(AXES)}}
    return torch_sp_worker.start_ranks(
        tmp_path_factory.mktemp("ep_tp_step"),
        torch_ep_worker.run_moe_step_rank,
        (torch_ep_worker.park(tmp / "step.pkl", spec),), world=4)


@pytest.fixture(scope="module")
def jax_steps(started):
    return expert_cases.jax_steps(AXES)


@pytest.fixture(scope="module")
def step_run(started, jax_steps):
    return started()


def test_two_adamw_steps_equal_the_jax_step(step_run, jax_steps):
    expert_cases.check_steps(step_run, jax_steps, "ep_tp", AXES)


def test_collectives_of_a_step(step_run):
    tp = []
    for out in step_run:
        for i in range(2):
            launches = {k.rsplit("/", 1)[1]: int(v) for k, v in out.items()
                        if k.startswith(f"ep/ep_tp/step{i}/launches/")}
            # per MoE layer one expert all-reduce forward, one backward;
            # the norm over the expert and the tensor line
            assert launches.pop("ep_all_reduce") == 4
            assert launches.pop("stats_all_reduce") == 2
            assert "all_reduce" not in launches
            tp.append(launches)
    assert all(t == tp[0] for t in tp)
    assert tp[0]["tp_all_reduce"] > 0 and tp[0]["tp_all_gather"] > 0
