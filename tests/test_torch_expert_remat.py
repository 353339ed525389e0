"""The MoE GPT under remat on a data line, held against the JAX package:
two adamw steps of ``gpt_tiny(moe_experts=4)`` (f32, dropout and the
router jitter off) with ``remat`` "full" and "dots" on 4 gloo ranks
``{"data": 2, "expert": 2}`` and on 2 ranks ``{"data": 2}`` equal the
JAX step (which runs without remat: a recomputation gives the same
values) at ``tests/test_torch_expert.py``'s tolerances.  A block
recomputed in the backward sums its router statistics over the data
line as its forward did: one expert all-reduce and one batch sum a
layer in the forward, again in the recomputation, and once each in the
backward."""
import pytest
import torch

import expert_cases
import torch_ep_worker
import torch_sp_worker

torch.set_num_threads(1)

AXES = {"data": 2, "expert": 2}
DATA = {"data": 2}
REMAT = ("full", "dots")


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """Both gloo runs, started before the JAX package's side is computed:
    {world size: join function}."""
    tmp = tmp_path_factory.mktemp("ep_remat")
    joins = {}
    for world, axes in ((4, AXES), (2, DATA)):
        cases = {f"{world}_{policy}": expert_cases.step_case(
            axes, remat=True, remat_policy=policy) for policy in REMAT}
        joins[world] = torch_sp_worker.start_ranks(
            tmp_path_factory.mktemp(f"ep_remat{world}"),
            torch_ep_worker.run_moe_step_rank,
            (torch_ep_worker.park(tmp / f"{world}.pkl", {"cases": cases}),),
            world=world)
    return joins


@pytest.fixture(scope="module")
def jax_side(started):
    return {4: expert_cases.jax_steps(AXES), 2: expert_cases.jax_steps(DATA)}


@pytest.fixture(scope="module")
def runs(started, jax_side):
    return {world: join() for world, join in started.items()}


@pytest.mark.parametrize("policy", REMAT)
@pytest.mark.parametrize("world, axes", [(4, AXES), (2, DATA)], ids=str)
def test_remat_steps_equal_the_jax_step(policy, world, axes, runs,
                                        jax_side):
    name = f"{world}_{policy}"
    expert_cases.check_steps(runs[world], jax_side[world], name, axes)
    want = {"batch_all_reduce": 6, "all_reduce": 1}
    if "expert" in axes:
        want.update(ep_all_reduce=6, stats_all_reduce=1)
    for out in runs[world]:
        for i in range(2):
            assert expert_cases.step_launches(out, name, i) == want
