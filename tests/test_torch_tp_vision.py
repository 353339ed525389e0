"""ViT over a mesh in the port, held against the JAX package.

- **Rules.**  ``ViT.partition_rules(fsdp=)`` gives every leaf the JAX
  table's spec (less an encoder leaf's stacked layer dim), and a
  ``ViT(config, mesh=)`` rank's ``init`` holds the slice of the whole
  model that ``NamedSharding(jmesh, spec)`` gives the device at its
  place on ``{"data": 2, "tensor": 2}``.
- **Two tensor-parallel steps** of ``vit_tiny(num_heads=2)`` (f32,
  ``adamw(1e-3)`` with the JAX default decay mask, clip 1.0) on 4 gloo
  ranks ``{"data": 2, "tensor": 2}``: loss, accuracy and the clip's norm
  within rtol 1e-5 and every rank's blocks within atol 5e-5 of the JAX
  step on ``{"data": 4, "tensor": 2}`` (``tests/test_vit.py:62-82``) and
  of the port's plain step; the gathered logits after them equal the
  plain model's.
- **ZeRO** (``partition_rules(fsdp=True)`` through
  ``train.shard_train_state`` on 2 gloo ranks ``{"fsdp": 2}``): the
  same against the JAX package's ZeRO step on ``{"fsdp": 2}``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_tensorflow_tpu import optim as joptim
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu.models import vit as jvit
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel.sharding import \
    prune_spec as jprune
from distributed_tensorflow_tpu_torch.models import convert
from distributed_tensorflow_tpu_torch.models import vit as tvit
from distributed_tensorflow_tpu_torch.parallel import sharding

import expert_cases
import torch_ep_worker
import torch_sp_worker

torch.set_num_threads(1)

LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-5
AXES = {"data": 2, "tensor": 2}


def _jax_path(name):
    """(JAX tree path, stacked over layers) of a port ViT parameter."""
    head, _, rest = name.partition(".")
    if head == "encoder":
        return "encoder/" + rest.split(".", 1)[1].replace(".", "/"), True
    return name.replace(".", "/"), False


def _case():
    """vit_tiny(num_heads=2): its config, its JAX tree (drawn by the port's
    ``init`` from seed 0) and two batches of 8 images."""
    model = tvit.vit_tiny(num_heads=2)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    batches = [(rng.random((8, 32, 32, 3), np.float32),
                rng.integers(0, 10, 8).astype(np.int64)) for _ in range(2)]
    return {"config": dataclasses.asdict(model.config),
            "params": convert.vit_params_to_jax(params, model.config),
            "batches": batches}


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """Both gloo runs, started together before the JAX package's side is
    computed (in this process, meanwhile): {name: join function}."""
    tmp = tmp_path_factory.mktemp("vit")
    case = _case()
    park = torch_ep_worker.park
    return {"tp": torch_sp_worker.start_ranks(
                tmp_path_factory.mktemp("vit_tp"),
                torch_ep_worker.run_vision_rank,
                (park(tmp / "tp.pkl", {"axes": AXES, "vit": case}),),
                world=4),
            "zero": torch_sp_worker.start_ranks(
                tmp_path_factory.mktemp("vit_zero"),
                torch_ep_worker.run_vit_zero_rank,
                (park(tmp / "zero.pkl", case),), world=2)}


# -- in one process ------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True])
def test_vit_rules_match_the_jax_table(fsdp):
    model = tvit.vit_tiny(num_heads=2)
    jrules = jvit.vit_tiny(num_heads=2).partition_rules(fsdp=fsdp)
    rules = model.partition_rules(fsdp=fsdp)
    for name in model.init(torch.Generator()):
        path, stacked = _jax_path(name)
        want = tuple(jrules.spec_for(path))
        assert rules.spec_for(name) == (want[1:] if stacked else want), name


def test_blocks_match_named_sharding():
    config = tvit.vit_tiny(num_heads=2).config
    whole = tvit.ViT(config).init(torch.Generator().manual_seed(0))
    jrules = jvit.vit_tiny(num_heads=2).partition_rules()
    jm = jmesh.make_mesh(AXES, jax.devices()[:4])
    L = config.num_layers
    for r in range(4):
        mesh = expert_cases.virtual(AXES, r)
        model = tvit.ViT(config, mesh)
        held = model.init(torch.Generator().manual_seed(0))
        assert sorted(held) == sorted(whole)
        for name, full in whole.items():
            path, stacked = _jax_path(name)
            shape = ((L,) if stacked else ()) + tuple(full.shape)
            index = NamedSharding(jm, jprune(jrules.spec_for(path), jm)) \
                .devices_indices_map(shape)[jm.devices.flat[r]]
            view = full.detach()
            for d, s in enumerate(index[1 if stacked else 0:]):
                start = s.start or 0
                view = view.narrow(d, start, (s.stop or full.shape[d])
                                   - start)
            assert torch.equal(held[name].detach(), view), (name, r)
            assert (sharding.marked_shard(held[name]) is not None) == (
                view.shape != full.shape), name


# -- the JAX side --------------------------------------------------------------

def _jax_steps(axes, rules_fsdp):
    """The JAX step (adamw 1e-3, clip 1.0) on the state placed by
    ``shard_train_state`` over ``axes`` (the batch over its first axis):
    (each step's metrics, the port's whole parameters after two
    steps)."""
    case = _case()
    jmodel = jvit.vit_tiny(num_heads=2)
    n = int(np.prod(list(axes.values())))
    jm = jmesh.make_mesh(axes, jax.devices()[:n])
    opt = joptim.adamw(1e-3)
    params = case["params"]
    state = jtrain.shard_train_state(
        jtrain.TrainState.create(params, opt.init(params)), jm,
        jmodel.partition_rules(fsdp=rules_fsdp))
    step = jtrain.make_custom_train_step(jmodel.loss_fn(), opt,
                                         grad_clip_norm=1.0)
    batch_axis = next(iter(axes))
    metrics = []
    for x, y in case["batches"]:
        batch = tuple(jax.device_put(jnp.asarray(a.astype(np.int32)
                                                 if a.dtype == np.int64
                                                 else a),
                                     NamedSharding(jm, P(batch_axis)))
                      for a in (x, y))
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    config = tvit.ViTConfig(**case["config"])
    whole = convert.vit_params_from_jax(jax.device_get(state.params), config)
    return metrics, {k: v.detach().numpy() for k, v in whole.items()}


@pytest.fixture(scope="module")
def jax_tp(started):
    return _jax_steps({"data": 4, "tensor": 2}, False)


@pytest.fixture(scope="module")
def jax_zero(started):
    return _jax_steps({"fsdp": 2}, True)


@pytest.fixture(scope="module")
def tp_run(started, jax_tp, jax_zero):
    return started["tp"]()


@pytest.fixture(scope="module")
def zero_run(started, jax_tp, jax_zero):
    return started["zero"]()


def _check(out, key, jax_side, plain=None):
    jmetrics, jwhole = jax_side
    for i in range(2):
        for k in ("loss", "accuracy", "grad_norm"):
            got = float(out[f"{key}/step{i}/{k}"])
            np.testing.assert_allclose(got, jmetrics[i][k], rtol=LOSS_RTOL,
                                       err_msg=(key, k, i))
            if plain is not None:
                np.testing.assert_allclose(
                    got, float(plain[f"plain/vit/step{i}/{k}"]),
                    rtol=LOSS_RTOL, err_msg=(key, k, i))
    expert_cases.blocks_close(out, key, jwhole, PARAM_ATOL)


def test_two_tp_steps_equal_the_jax_step(tp_run, jax_tp):
    plain = tp_run[0]
    pwhole = {k[len("plain/vit/p/"):]: v for k, v in plain.items()
              if k.startswith("plain/vit/p/")}
    for out in tp_run:
        _check(out, "tp/vit", jax_tp, plain)
        expert_cases.blocks_close(out, "tp/vit", pwhole, PARAM_ATOL)
        np.testing.assert_allclose(out["tp/vit/logits"],
                                   plain["plain/vit/logits"], rtol=0,
                                   atol=1e-5)
        for i in range(2):
            launches = {k.rsplit("/", 1)[1]: int(v) for k, v in out.items()
                        if k.startswith(f"tp/vit/step{i}/launches/")}
            # the data line's mean and the norm over the tensor line, once
            assert launches.pop("all_reduce") == 1
            assert launches.pop("stats_all_reduce") == 1
            assert launches["tp_all_reduce"] > 0
            assert launches["tp_all_gather"] > 0


def test_zero_steps_equal_the_jax_zero_step(zero_run, jax_zero):
    for out in zero_run:
        _check(out, "zero/vit", jax_zero)
        for i in range(2):
            launches = {k.rsplit("/", 1)[1]: int(v) for k, v in out.items()
                        if k.startswith(f"zero/vit/step{i}/launches/")}
            assert launches == {"all_gather": 1, "reduce_scatter": 1,
                                "stats_all_reduce": 1}
    np.testing.assert_array_equal(zero_run[0]["zero/vit/logits"],
                                  zero_run[1]["zero/vit/logits"])
