"""ResNet over a tensor line in the port, held against the JAX package.

- **Rules.**  ``ResNet.partition_rules(fsdp=)`` gives every leaf the JAX
  table's spec; with ``fsdp=True`` on ``{"fsdp": 2}`` the stem's 3 input
  channels do not cut, and both packages raise ``ValueError``
  ("divisible by 2").
- **Two tensor-parallel steps** of ``resnet_cifar()`` (f32, 8x8 images,
  ``momentum(0.01, 0.9)`` through ``train.make_train_step`` with the
  sparse cross entropy and accuracy) on 4 gloo ranks ``{"data": 2,
  "tensor": 2}``: loss and accuracy within rtol 1e-5, every rank's
  blocks within atol 5e-5 and the BatchNorm state (whole and equal on
  every rank) within atol 5e-5 of the JAX step on ``{"data": 4,
  "tensor": 2}`` (``tests/test_resnet.py:48-54``'s placement) and of the
  port's plain step.
- **``cross_rank_moments`` on ``{"data": 2, "tensor": 2}``**: a training
  ``BatchNorm`` on each rank's rows and tensor block of the channels
  normalises with that block's moments over the whole batch, and moves
  its state by them.  The moments sum over the ``data`` line only: summed
  over the whole mesh they would add the two channel blocks, and this
  test (and the step above) fails.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_tensorflow_tpu import optim as joptim
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu.models import resnet as jresnet
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel.sharding import \
    shard_pytree as jshard
from distributed_tensorflow_tpu_torch.models import convert
from distributed_tensorflow_tpu_torch.models import resnet as tresnet
from distributed_tensorflow_tpu_torch.ops.layers import _flat, _nest
from distributed_tensorflow_tpu_torch.parallel import sharding

import expert_cases
import torch_ep_worker
import torch_sp_worker

torch.set_num_threads(1)

LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-5
AXES = {"data": 2, "tensor": 2}
SHAPE = (8, 8, 3)


def _case():
    """resnet_cifar's parameters (its JAX tree) and BatchNorm state, drawn
    by the port's ``init`` from seed 0, and two batches of 8 images."""
    params, state = tresnet.resnet_cifar().init(
        torch.Generator().manual_seed(0), SHAPE)
    rng = np.random.default_rng(6)
    batches = [(rng.random((8,) + SHAPE, np.float32),
                rng.integers(0, 10, 8).astype(np.int64)) for _ in range(2)]
    return {"params": convert.stack_params_to_jax(params),
            "state": {k: v.numpy() for k, v in _flat(state, "").items()},
            "batches": batches}


def _moments_case():
    rng = np.random.default_rng(8)
    return {"x": (rng.standard_normal((8, 3, 3, 8)) * 2 + 1).astype(
        np.float32)}


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The gloo run, started before the JAX package's side is computed."""
    tmp = tmp_path_factory.mktemp("resnet")
    spec = {"axes": AXES, "resnet": _case(), "moments": _moments_case()}
    return torch_sp_worker.start_ranks(
        tmp_path_factory.mktemp("resnet_tp"),
        torch_ep_worker.run_vision_rank,
        (torch_ep_worker.park(tmp / "tp.pkl", spec),), world=4)


# -- in one process ------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True])
def test_resnet_rules_match_the_jax_table(fsdp):
    rules = tresnet.ResNet.partition_rules(fsdp=fsdp)
    jrules = jresnet.ResNet.partition_rules(fsdp=fsdp)
    params, _ = tresnet.resnet_cifar().init(torch.Generator(), SHAPE)
    cut = 0
    for name in params:
        want = tuple(jrules.spec_for(name.replace(".", "/")))
        assert rules.spec_for(name) == want, name
        cut += "tensor" in want
    assert cut == len([n for n in params if n.endswith("kernel")])


def test_fsdp_stem_raises_in_both_packages():
    params, _ = tresnet.resnet_cifar().init(torch.Generator(), SHAPE)
    mesh = expert_cases.virtual({"fsdp": 2})
    rules = tresnet.ResNet.partition_rules(fsdp=True)
    with pytest.raises(ValueError, match="divisible by 2"):
        sharding.shard_pytree(params, mesh, rules)
    jm = jmesh.make_mesh({"fsdp": 2}, jax.devices()[:2])
    jparams = convert.stack_params_to_jax(params)
    with pytest.raises(ValueError, match="divisible by 2"):
        jshard(jparams, jm, jresnet.ResNet.partition_rules(fsdp=True))


def test_model_on_a_tensor_line_holds_its_blocks():
    whole, _ = tresnet.resnet_cifar().init(torch.Generator().manual_seed(0),
                                           SHAPE)
    held, state = tresnet.resnet_cifar(
        mesh=expert_cases.virtual(AXES, 3)).init(
            torch.Generator().manual_seed(0), SHAPE)
    assert sorted(held) == sorted(whole)
    k = "stage1_block0.conv3.kernel"
    assert held[k].shape[-1] * 2 == whole[k].shape[-1]
    assert torch.equal(held[k].detach(),
                       whole[k].detach()[..., whole[k].shape[-1] // 2:])
    assert sharding.marked_shard(held["head.kernel"]) == sharding.Shard(
        1, 5, 5, 10, "tensor")
    assert held["head.bias"] is not None and held["head.bias"].shape == (10,)
    assert state["stem_bn"]["mean"].shape == (32,)


# -- two steps on data 2 x tensor 2 --------------------------------------------

@pytest.fixture(scope="module")
def jax_steps(started):
    """The JAX step on the state placed over {"data": 4, "tensor": 2}:
    (each step's metrics, the port's whole parameters and the flat
    BatchNorm state after two steps)."""
    case = _case()
    model = jresnet.resnet_cifar()
    jm = jmesh.make_mesh({"data": 4, "tensor": 2}, jax.devices()[:8])
    opt = joptim.momentum(0.01, 0.9)
    state = jtrain.shard_train_state(
        jtrain.TrainState.create(case["params"], opt.init(case["params"]),
                                 _nest(dict(case["state"]))), jm,
        jresnet.ResNet.partition_rules())
    step = jtrain.make_train_step(model, "sparse_categorical_crossentropy",
                                  opt, metric_fns={"acc": "accuracy"})
    metrics = []
    for x, y in case["batches"]:
        batch = (jax.device_put(x, NamedSharding(jm, P("data"))),
                 jax.device_put(jnp.asarray(y.astype(np.int32)),
                                NamedSharding(jm, P("data"))))
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    params = convert.stack_params_from_jax(jax.device_get(state.params))
    return (metrics, {k: v.detach().numpy() for k, v in params.items()},
            {k: np.asarray(v) for k, v in
             _flat(jax.device_get(state.model_state), "").items()})


@pytest.fixture(scope="module")
def run(started, jax_steps):
    return started()


def test_two_tp_steps_equal_the_jax_step(run, jax_steps):
    jmetrics, jwhole, jstate = jax_steps
    plain = run[0]
    pwhole = {k[len("plain/resnet/p/"):]: v for k, v in plain.items()
              if k.startswith("plain/resnet/p/")}
    for out in run:
        for i in range(2):
            for k in ("loss", "acc"):
                got = float(out[f"tp/resnet/step{i}/{k}"])
                np.testing.assert_allclose(got, jmetrics[i][k],
                                           rtol=LOSS_RTOL, err_msg=(k, i))
                np.testing.assert_allclose(
                    got, float(plain[f"plain/resnet/step{i}/{k}"]),
                    rtol=LOSS_RTOL, err_msg=(k, i))
        expert_cases.blocks_close(out, "tp/resnet", jwhole, PARAM_ATOL)
        expert_cases.blocks_close(out, "tp/resnet", pwhole, PARAM_ATOL)
        names = [k for k in out if k.startswith("tp/resnet/state/")]
        assert sorted(n[len("tp/resnet/state/"):] for n in names) == \
            sorted(jstate)
        for n in names:
            key = n[len("tp/resnet/state/"):]
            np.testing.assert_allclose(out[n], jstate[key], rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)
            np.testing.assert_allclose(
                out[n], plain[f"plain/resnet/state/{key}"], rtol=0,
                atol=PARAM_ATOL, err_msg=key)
        for i in range(2):
            launches = {k.rsplit("/", 1)[1]: int(v) for k, v in out.items()
                        if k.startswith(f"tp/resnet/step{i}/launches/")}
            # one gather of the output and one of the moving moments a
            # norm (the stem's, 3 in each of 6 blocks, 3 projections'),
            # one of the logits
            assert launches["tp_all_gather"] == 2 * (1 + 18 + 3) + 1
            # one backward all-reduce a convolution's input (with its
            # norm's gamma and beta) and the head's; the data line's mean
            assert launches["tp_all_reduce"] == 1 + 18 + 3 + 1
            assert launches["all_reduce"] == 1
            # each norm's moments summed over the data line, forward and
            # backward
            assert launches["batch_all_reduce"] == 2 * (1 + 18 + 3)
            assert len(launches) == 4


def test_batchnorm_moments_reduce_over_the_data_line(run):
    x = _moments_case()["x"]
    eps, m = 1e-5, 0.9
    # rank r holds data row block r // 2 and channel block r % 2
    for r, out in enumerate(run):
        d, t = divmod(r, 2)
        block = x[..., t * 4:(t + 1) * 4].astype(np.float64)
        mean = block.mean(axis=(0, 1, 2))
        var = np.maximum((block ** 2).mean(axis=(0, 1, 2)) - mean ** 2, 0)
        want = (block[d * 4:(d + 1) * 4] - mean) / np.sqrt(var + eps)
        np.testing.assert_allclose(out["bn/y"], want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(out["bn/mean"], (1 - m) * mean, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(out["bn/var"], m + (1 - m) * var,
                                   rtol=0, atol=1e-6)
