"""Expert parallelism in the port, held against the JAX package.

- **Rules.**  ``moe_partition_rules`` and a MoE GPT's
  ``gpt_partition_rules`` give every leaf the JAX table's spec (less the
  stacked layer dim), and every rank's block on ``{"data": 2, "expert":
  2}`` and ``{"expert": 2, "tensor": 2}`` is the slice
  ``NamedSharding(jmesh, spec).devices_indices_map`` gives the device at
  its place; a model built on that rank holds it.
- **Refusals.**  ``expert`` beside ``fsdp``, ``seq`` or ``pipe`` raises
  ``NotImplementedError`` naming ROADMAP items 7.2c, 7.2d and 7.3d; an
  expert count the line does not divide raises the ``ValueError`` of the
  JAX package's ``device_put``.
- **``apply_moe``** on a 2-rank ``{"expert": 2}`` gloo line equals the
  JAX ``apply_moe`` on ``{"data": 2, "expert": 4}`` (``tests/test_moe.py:
  74-93``: k 2, capacity factor 2.0): output, ``aux_loss``,
  ``dropped_fraction``, and the gradients of ``sum(y * dy) + aux_loss +
  router_z_loss`` for x and every leaf (the router's and the tokens'
  summed over the line, the aux losses counted once) equal ``jax.grad``'s;
  one expert all-reduce forward and one backward.
- **Two adamw steps** of the MoE GPT (``gpt_tiny(moe_experts=4)``, f32,
  dropout and the router jitter off) on 4 gloo ranks ``{"data": 2,
  "expert": 2}``: losses, ``moe_aux`` and the clip's norm within rtol
  1e-5, every rank's blocks within atol 5e-5 of the JAX step on
  ``shard_pytree(params, jmesh, rules)`` and of the port's plain step;
  the collectives a step are exact (the router statistics summed over
  the data line, forward and backward); ``train.gather_params`` gathers
  the whole model, and ``optim.ema_params`` the EMA shadow's; a sharded
  checkpoint restores the state bit-exact into a fresh placed state.
  ``tests/test_torch_expert_tp.py`` holds the same on ``{"expert": 2,
  "tensor": 2}``, ``tests/test_torch_expert_remat.py`` under remat.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.ops import moe as jmoe
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel.sharding import \
    PartitionRules as JRules
from distributed_tensorflow_tpu.parallel.sharding import \
    prune_spec as jprune
from distributed_tensorflow_tpu.parallel.sharding import \
    shard_pytree as jshard
from distributed_tensorflow_tpu_torch import (GPT, TrainState, gpt_tiny,
                                              optim, parallel, train)
from distributed_tensorflow_tpu_torch.models import convert
from distributed_tensorflow_tpu_torch.models.gpt import gpt_partition_rules
from distributed_tensorflow_tpu_torch.ops import moe as tmoe
from distributed_tensorflow_tpu_torch.parallel import sharding

import expert_cases
import torch_ep_worker
import torch_sp_worker

torch.set_num_threads(1)

LOSS_RTOL, PARAM_ATOL, EXACT = 1e-5, 5e-5, 1e-6
AXES = {"data": 2, "expert": 2}


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """Both gloo runs, started together before the JAX package's side is
    computed (in this process, meanwhile): {name: join function}."""
    tmp = tmp_path_factory.mktemp("ep")
    cases = {"dp_ep": dict(expert_cases.step_case(AXES),
                           ckpt=str(tmp / "ckpt"))}
    line = {"line": expert_cases.moe_case()}
    park = torch_ep_worker.park
    return {"line": torch_sp_worker.start_ranks(
                tmp_path_factory.mktemp("ep_line"),
                torch_ep_worker.run_moe_step_rank,
                (park(tmp / "line.pkl", line),), world=2),
            "step": torch_sp_worker.start_ranks(
                tmp_path_factory.mktemp("ep_step"),
                torch_ep_worker.run_moe_step_rank,
                (park(tmp / "step.pkl", {"cases": cases}),), world=4)}


# -- in one process ------------------------------------------------------------

def test_moe_rules_match_the_jax_table():
    rows, jrows = tmoe.moe_partition_rules(), jmoe.moe_partition_rules()
    assert len(rows) == len(jrows)
    for (pat, spec), (jpat, jspec) in zip(rows, jrows):
        assert pat.replace("[./]", "/") == jpat
        assert spec == tuple(jspec)
    config = gpt_tiny(moe_experts=4)
    rules = gpt_partition_rules(config)
    jrules = jgpt_tiny(moe_experts=4).partition_rules()
    names = GPT(config, device="cpu").state_dict()
    assert any(".moe.experts." in n for n in names)
    for name in names:
        path, stacked = expert_cases.jax_path(name)
        want = tuple(jrules.spec_for(path))
        assert rules.spec_for(name) == (want[1:] if stacked else want), name


@pytest.mark.parametrize("axes", [AXES, {"expert": 2, "tensor": 2}],
                         ids=str)
def test_blocks_match_named_sharding(axes):
    config = gpt_tiny(moe_experts=4, dropout_rate=0.0)
    jmodel = jgpt_tiny(moe_experts=4, dropout_rate=0.0)
    whole = expert_cases.whole_state()
    rules, jrules = gpt_partition_rules(config), jmodel.partition_rules()
    jm = jmesh.make_mesh(axes, jax.devices()[:4])
    ref = dict(GPT(config, device="cpu").named_parameters())
    L = config.num_layers
    for r in range(4):
        mesh = expert_cases.virtual(axes, r)
        held = dict(GPT(config, device="cpu", mesh=mesh).named_parameters())
        assert sorted(held) == sorted(whole)
        for name, full in whole.items():
            path, stacked = expert_cases.jax_path(name)
            shape = ((L,) if stacked else ()) + full.shape
            index = NamedSharding(jm, jprune(jrules.spec_for(path), jm)) \
                .devices_indices_map(shape)[jm.devices.flat[r]]
            want = [(s.start or 0, (s.stop or n) - (s.start or 0))
                    for s, n in zip(index[1 if stacked else 0:], full.shape)]
            assert sharding.block_of(full.shape, rules.spec_for(name),
                                     mesh) == want, (name, r)
            view = ref[name].detach()
            for d, (start, length) in enumerate(want):
                view = view.narrow(d, start, length)
            assert torch.equal(held[name].detach(), view), (name, r)


@pytest.mark.parametrize("axes, item", [
    ({"fsdp": 2, "expert": 2}, "7.2c"), ({"expert": 2, "seq": 2}, "7.2d"),
    ({"pipe": 2, "expert": 2}, "7.3d")])
def test_expert_beside_another_axis_raises(axes, item):
    mesh = expert_cases.virtual(axes)
    config = gpt_tiny(moe_experts=4, dropout_rate=0.0)
    with pytest.raises(NotImplementedError, match=item):
        sharding.check_mesh(mesh)
    with pytest.raises(NotImplementedError, match=item):
        GPT(config, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match=item):
        train.make_custom_train_step(lambda *a: None, optim.adamw(1e-3),
                                     mesh=mesh)
    with pytest.raises(NotImplementedError, match=item):
        sharding.block_of((4, 8), ("expert", None), mesh)


def test_undivided_experts_raise_in_both_packages():
    spec = ("expert", None, None)
    with pytest.raises(ValueError, match="divisible by 2"):
        sharding.block_of((3, 8, 8), spec, expert_cases.virtual(
            {"expert": 2}))
    jm = jmesh.make_mesh({"expert": 2}, jax.devices()[:2])
    with pytest.raises(ValueError, match="divisible by 2"):
        jax.device_put(jnp.zeros((3, 8, 8)), NamedSharding(jm, P(*spec)))
    with pytest.raises(ValueError, match="divisible by 2"):
        GPT(gpt_tiny(moe_experts=3), device="cpu",
            mesh=expert_cases.virtual({"expert": 2}))


def test_line_of_one_is_the_plain_model():
    """``{"expert": 1}``: nothing is cut, no collective runs, and two steps
    equal the plain model's to the bit."""
    from distributed_tensorflow_tpu_torch.parallel import data_parallel
    mesh = parallel.make_mesh({"expert": 1})
    rng = np.random.default_rng(2)
    batches = [torch.from_numpy(rng.integers(0, 512, (4, 9)))
               for _ in range(2)]
    runs = []
    for m in (None, mesh):
        model = GPT(gpt_tiny(moe_experts=4, dropout_rate=0.0), device="cpu",
                    mesh=m)
        params = dict(model.named_parameters())
        opt = optim.adamw(1e-3)
        state = TrainState.create(params, opt.init(params))
        if m is not None:
            state = train.shard_train_state(state, m,
                                            model.partition_rules())
            assert not state.params.cut
        step = train.make_custom_train_step(model.lm_loss_fn(), opt, mesh=m,
                                            grad_clip_norm=1.0)
        data_parallel.LAUNCHES.clear()
        losses = [float(step(state, {"input_ids": b})[1]["loss"])
                  for b in batches]
        assert not data_parallel.LAUNCHES
        runs.append((losses, {k: p.detach().clone()
                              for k, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


def test_convert_returns_this_ranks_experts():
    config = gpt_tiny(moe_experts=4, dropout_rate=0.0)
    jparams = convert.gpt_params_to_jax(
        {k: torch.from_numpy(v) for k, v in
         expert_cases.whole_state().items()}, config)
    mesh = expert_cases.virtual({"expert": 2, "tensor": 2}, 2)
    model = GPT(config, device="cpu", mesh=mesh)
    convert.load_jax_params(model, jparams)
    whole = convert.gpt_params_from_jax(jparams, config)
    held = dict(model.named_parameters())
    # rank 2 sits at expert 1, tensor 0
    assert torch.equal(held["blocks.0.moe.experts.w_in"].detach(),
                       whole["blocks.0.moe.experts.w_in"][2:, :, :256])
    assert sharding.marked_shard(held["blocks.0.moe.experts.w_in"]) == \
        sharding.Blocks((sharding.Shard(0, 2, 2, 4, "expert"),
                         sharding.Shard(2, 0, 256, 512, "tensor")))
    assert torch.equal(held["blocks.1.moe.router.kernel"].detach(),
                       whole["blocks.1.moe.router.kernel"])


# -- apply_moe on an expert line of 2 ----------------------------------------

@pytest.fixture(scope="module")
def jax_moe(started):
    """The JAX ``apply_moe`` on ``{"data": 2, "expert": 4}``: (output,
    metrics, gradients of x and of the tree)."""
    c = expert_cases.moe_case()
    jm = jmesh.make_mesh({"data": 2, "expert": 4}, jax.devices()[:8])
    sp = jshard(c["params"], jm, JRules(jmoe.moe_partition_rules()))
    xs = jax.device_put(c["x"], NamedSharding(jm, P("data")))

    def f(p, x):
        y, m = jmoe.apply_moe(p, x, k=2, capacity_factor=2.0)
        loss = jnp.sum(y * c["dy"]) + m["aux_loss"] + m["router_z_loss"]
        return loss, (y, m)
    (_, (y, m)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(sp, xs)
    return (np.asarray(y), {k: float(v) for k, v in m.items()},
            np.asarray(gx), jax.tree.map(np.asarray, gp))


@pytest.fixture(scope="module")
def line_run(started, jax_moe):
    return started["line"]()


def test_apply_moe_on_an_expert_line_equals_the_jax_mesh(line_run, jax_moe):
    y, metrics, gx, gp = jax_moe
    outs = line_run
    for r, out in enumerate(outs):
        for key in ("ep", "plain"):
            np.testing.assert_allclose(out[f"{key}/y"], y, rtol=0,
                                       atol=1e-5)
            for k in ("aux_loss", "router_z_loss", "dropped_fraction"):
                np.testing.assert_allclose(out[f"{key}/{k}"], metrics[k],
                                           rtol=LOSS_RTOL, err_msg=k)
            np.testing.assert_allclose(out[f"{key}/grad/x"], gx, rtol=0,
                                       atol=1e-5)
        for g, sub in gp.items():
            for k, want in sub.items():
                if g == "experts":
                    want = want[2 * r:2 * (r + 1)]
                np.testing.assert_allclose(out[f"ep/grad/{g}/{k}"], want,
                                           rtol=0, atol=1e-5,
                                           err_msg=f"{g}/{k}")
        launches = {k.rsplit("/", 1)[1]: int(v) for k, v in out.items()
                    if k.startswith("ep/launches/")}
        assert launches == {"ep_all_reduce": 2}
        assert not any(k.startswith("plain/launches/") for k in out)


# -- two adamw steps on data 2 x expert 2 --------------------------------------

@pytest.fixture(scope="module")
def jax_steps(started):
    return expert_cases.jax_steps(AXES)


@pytest.fixture(scope="module")
def step_run(started, jax_steps):
    return started["step"]()


def test_two_adamw_steps_equal_the_jax_step(step_run, jax_steps):
    outs = step_run
    expert_cases.check_steps(outs, jax_steps, "dp_ep", AXES)
    # each step: per MoE layer one expert all-reduce and one sum of the
    # router statistics over the data line forward, one of each
    # backward; the data line's gradient mean, the norm's sums over the
    # expert line
    for out in outs:
        for i in range(2):
            assert expert_cases.step_launches(out, "dp_ep", i) == {
                "ep_all_reduce": 4, "batch_all_reduce": 4,
                "all_reduce": 1, "stats_all_reduce": 1}


def test_gather_params_and_the_sharded_checkpoint(step_run, jax_steps):
    outs = step_run
    _, want = jax_steps
    for out in outs:
        assert int(out["ep/dp_ep/gathered/launches"]) == 1
        names = [k[len("ep/dp_ep/gathered/"):] for k in out
                 if k.startswith("ep/dp_ep/gathered/")
                 and k != "ep/dp_ep/gathered/launches"]
        assert sorted(names) == sorted(want)
        for name in names:
            np.testing.assert_allclose(out[f"ep/dp_ep/gathered/{name}"],
                                       want[name], rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)
        assert int(out["ep/dp_ep/restored/step"]) == 2
        assert bool(out["ep/dp_ep/restored/equal"])
        assert bool(out["ep/dp_ep/restored/same_tensors"])
        # optim.ema_params gathers the shadow's experts whole as well
        assert bool(out["ep/dp_ep/ema/shapes"])
        assert float(out["ep/dp_ep/ema/gap"]) < EXACT
