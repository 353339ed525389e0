"""The port's cluster bootstrap, data-parallel mesh and gradient all-reduce,
held against the JAX package.

- ``cluster_from_env`` on the same env dicts as the JAX package's: new
  style, legacy (``WORKER_HOSTS[0]`` the coordinator, ``TASK_INDEX``),
  new over legacy, bad ints (their defaults), ``JOB_NAME=ps``, and none
  (single-machine): equal configs.
- ``JOB_NAME=ps``: ``initialize`` exits 64 under ``DTTPU_LAUNCHER`` and
  warns otherwise, as the JAX package's does; the entry point returns 64
  or 0 and prints its refusal.  With no topology ``initialize`` starts
  nothing: rank 0 of 1, chief, a mesh of one with no group.
- ``data_shards``, ``round_batch_to_mesh`` and ``local_batch_size`` on
  meshes of 1 to 8 ranks equal the JAX package's on meshes of 1 to 8
  devices.
- Two gloo ranks (``torch.multiprocessing``, spawned; a free port picked
  by binding port 0) run 8 steps of ``make_train_step(mesh=...)`` on the
  XOR MLP at dropout 0 over a global batch of 64 (``round_batch_to_mesh``
  of 63), each rank its 32 rows.  Their parameters are equal to each
  other, to the JAX package's ``make_train_step(mesh=...)`` on a 2-device
  CPU mesh, and to the port's single-process step on the whole batch,
  within 1e-5 absolute (f32; the ranks' means averaged against one mean),
  and each rank issued one all-reduce a step.  ``init_process_group`` and
  each join are limited to 60 s, so a hang fails the test.
- Two gloo ranks train a Dense (no bias) -> BatchNorm -> Dense model: the batch
  moments are all-reduced, so parameters, running moments and losses
  equal the JAX package's 2-device mesh within 1e-5, and a lone
  ``BatchNorm`` on shards of 3 and 9 rows equals one process on 12.
"""
import dataclasses
import logging
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import ops as jops
from distributed_tensorflow_tpu import optim as jopt
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu.parallel import cluster as jcluster
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu_torch import example as texample
from distributed_tensorflow_tpu_torch import ops as tops
from distributed_tensorflow_tpu_torch import optim as topt
from distributed_tensorflow_tpu_torch import parallel as tpar
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.models.convert import (
    stack_params_from_jax, stack_params_to_jax)
from distributed_tensorflow_tpu_torch.parallel import cluster as tcluster

torch.set_num_threads(1)

TOL = 1e-5
JOIN_S = 60

ENVS = {
    "none": {},
    "new": {"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "4",
            "PROCESS_ID": "2"},
    "legacy": {"JOB_NAME": "worker", "TASK_INDEX": "1",
               "WORKER_HOSTS": "w0:2222, w1:2222,w2:2222"},
    "new_over_legacy": {"COORDINATOR_ADDRESS": "c:1", "NUM_PROCESSES": "2",
                        "PROCESS_ID": "1", "TASK_INDEX": "0",
                        "WORKER_HOSTS": "w0:2222,w1:2222,w2:2222"},
    "bad_ints": {"COORDINATOR_ADDRESS": "c:1", "NUM_PROCESSES": "four",
                 "PROCESS_ID": "x", "TASK_INDEX": "3"},
    "bad_task_index": {"WORKER_HOSTS": "w0:1,w1:1", "TASK_INDEX": "one"},
    "ps": {"JOB_NAME": "ps", "TASK_INDEX": "0", "WORKER_HOSTS": "w0:2222"},
    "empty_hosts": {"WORKER_HOSTS": " , ", "JOB_NAME": ""},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_cluster_from_env_equals_jax(name, caplog):
    env = ENVS[name]
    with caplog.at_level(logging.WARNING):
        got = tcluster.cluster_from_env(environ=dict(env))
        want = jcluster.cluster_from_env(environ=dict(env))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.distributed, got.is_legacy_ps) == (want.distributed,
                                                   want.is_legacy_ps)
    if name == "bad_ints":
        assert (got.num_processes, got.process_id) == (1, 3)
        assert sum("not an int" in r.message for r in caplog.records) == 4
    assert tcluster.LEGACY_PS_EXIT_CODE == jcluster.LEGACY_PS_EXIT_CODE == 64


def test_ps_is_refused_with_exit_code_64_under_the_launcher(monkeypatch,
                                                            caplog, capsys):
    config = tcluster.cluster_from_env(environ=dict(ENVS["ps"]))
    monkeypatch.setenv("DTTPU_LAUNCHER", "1")
    for lib, cfg in ((tcluster, config),
                     (jcluster, jcluster.cluster_from_env(
                         environ=dict(ENVS["ps"])))):
        with pytest.raises(SystemExit) as exc:
            lib.initialize(cfg)
        assert exc.value.code == 64
    assert texample.main(["--device=cpu", "--job_name=ps"]) == 64
    monkeypatch.delenv("DTTPU_LAUNCHER")
    with caplog.at_level(logging.WARNING):
        assert tcluster.initialize(config) is config
    assert any("JOB_NAME=ps ignored" in r.message for r in caplog.records)
    assert not torch.distributed.is_initialized()
    assert texample.main(["--device=cpu", "--job_name=ps"]) == 0
    assert capsys.readouterr().out.count("no parameter-server role") == 2


def test_single_machine_fallback_starts_nothing():
    config = tcluster.initialize(tcluster.cluster_from_env(environ={}))
    assert config == tcluster.ClusterConfig()
    assert not torch.distributed.is_initialized()
    assert (tcluster.process_index(), tcluster.process_count()) == (0, 1)
    assert tcluster.is_chief()
    mesh = tpar.data_parallel_mesh()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.shape == {"data": 1}


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_batch_helpers_equal_jax(n):
    mesh = tpar.Mesh(n, n - 1)
    jm = jmesh.data_parallel_mesh(jax.devices()[:n])
    assert tpar.data_shards(mesh) == jmesh.data_shards(jm) == n
    for batch in (1, 50, 63, 64, 1000):
        assert tpar.round_batch_to_mesh(batch, mesh) == \
            jmesh.round_batch_to_mesh(batch, jm)
        rounded = tpar.round_batch_to_mesh(batch, mesh)
        assert tpar.local_batch_size(rounded, mesh) == \
            jmesh.local_batch_size(rounded, jm) == rounded // n
    if n > 1:
        with pytest.raises(ValueError, match="not divisible"):
            tpar.local_batch_size(n * 10 + 1, mesh)
    with pytest.raises(ValueError, match="rank"):
        tpar.Mesh(n, n)


def _models():
    def build(lib):
        return lib.serial(lib.Dense(128, activation="relu"),
                          lib.Dropout(0.0),
                          lib.Dense(128, activation="relu"),
                          lib.Dropout(0.0),
                          lib.Dense(32, activation="sigmoid"))
    return build(jops), build(tops)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_equal_the_jax_mesh_and_one_process(tmp_path):
    import torch_dp_worker

    world, steps = 2, 8
    batch = tpar.round_batch_to_mesh(63, tpar.Mesh(world))
    assert batch == 64
    jm, tm = _models()
    jo = jopt.adam()
    jstate = jtrain.init_train_state(jm, jo, jax.random.PRNGKey(0), (64,))
    init = {k: v.detach().numpy().copy() for k, v in stack_params_from_jax(
        jax.tree.map(np.asarray, jstate.params)).items()}
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 2, (steps, batch, 64)).astype(np.float32)
    ys = np.bitwise_xor(xs[..., :32].astype(np.int8),
                        xs[..., 32:].astype(np.int8)).astype(np.float32)

    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    procs = [ctx.Process(target=torch_dp_worker.run_rank,
                         args=(r, world, port, init, xs, ys, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        assert not any(p.is_alive() for p in procs), "a rank hung"
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    ranks = [dict(np.load(o)) for o in outs]
    for r in ranks:
        assert int(r.pop("all_reduces")) == steps
    np.testing.assert_array_equal(ranks[0].pop("losses"),
                                  ranks[1].pop("losses"))
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    got = stack_params_to_jax({k: torch.from_numpy(v)
                               for k, v in ranks[0].items()})

    # the JAX package on a 2-device CPU mesh
    mesh = jmesh.data_parallel_mesh(jax.devices()[:world])
    jstep = jtrain.make_train_step(jm, "mse", jo, mesh=mesh)
    for x, y in zip(xs, ys):
        jstate, _ = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))

    # the port in one process, on the whole batch
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in init.items()}
    to = topt.adam()
    state = ttrain.TrainState.create(params, to.init(params), {})
    step = ttrain.make_train_step(tm, "mse", to)
    for x, y in zip(xs, ys):
        state, _ = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    single = stack_params_to_jax(state.params)

    for want in (jstate.params, single):
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=0,
                                       err_msg=str(path))


def _spawn_ranks(tmp_path, target, args_of, world=2):
    """Run ``target(rank, world, port, *args_of(rank), out)`` on ``world``
    spawned gloo ranks; each join limited to JOIN_S.  Returns the ranks'
    npz outputs as dicts."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    procs = [ctx.Process(target=target,
                         args=(r, world, port, *args_of(r), outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        assert not any(p.is_alive() for p in procs), "a rank hung"
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [dict(np.load(o)) for o in outs]


def test_batchnorm_two_gloo_ranks_equal_the_jax_mesh(tmp_path):
    """A model holding a ``BatchNorm`` trains on 2 gloo ranks as the JAX
    package's ``make_train_step(mesh=...)`` does on a 2-device mesh: the
    ranks' moments are the global batch's (the JAX jit over a sharded
    batch), so parameters, running moments and losses agree within 1e-5.
    The Dense before the norm has no bias: the norm removes the mean, so
    such a bias's gradient is 0 up to round-off, and Adam turns round-off
    of either sign into steps of up to lr.
    A lone ``BatchNorm`` on shards of 3 and 9 rows equals one process on
    the 12."""
    import torch_dp_worker

    world, steps, batch = 2, 4, 16

    def build(lib):
        return lib.serial(lib.Dense(16, use_bias=False), lib.BatchNorm(),
                          lib.Dense(4, activation="sigmoid"))

    jm = build(jops)
    jo = jopt.adam(1e-2)
    jstate = jtrain.init_train_state(jm, jo, jax.random.PRNGKey(0), (8,))
    init = {k: v.detach().numpy().copy() for k, v in stack_params_from_jax(
        jax.tree.map(np.asarray, jstate.params)).items()}
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(steps, batch, 8)).astype(np.float32) * 2 + 1
    ys = rng.uniform(size=(steps, batch, 4)).astype(np.float32)
    ragged = rng.normal(size=(12, 5)).astype(np.float32) * 3 - 1

    ranks = _spawn_ranks(tmp_path, torch_dp_worker.run_bn_rank,
                         lambda r: (init, xs, ys, ragged))
    for k in ("losses", "bn_mean", "bn_var", "ragged_mean", "ragged_var"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)

    mesh = jmesh.data_parallel_mesh(jax.devices()[:world])
    jstep = jtrain.make_train_step(jm, "mse", jo, mesh=mesh)
    jlosses = []
    for x, y in zip(xs, ys):
        jstate, jmetrics = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        jlosses.append(float(jmetrics["loss"]))
    np.testing.assert_allclose(ranks[0]["losses"], jlosses, atol=TOL,
                               rtol=0)
    jbn = jstate.model_state["batchnorm"]
    for k in ("mean", "var"):
        for r in ranks:
            np.testing.assert_allclose(r[f"bn_{k}"], np.asarray(jbn[k]),
                                       atol=TOL, rtol=0, err_msg=k)
    got = stack_params_to_jax({k[2:]: torch.from_numpy(v)
                               for k, v in ranks[0].items()
                               if k.startswith("p_")})
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=0,
                                   err_msg=str(path))

    # unequal shards: the sums and counts make them exact
    bn = tops.BatchNorm()
    _, bn_state = bn.init(torch.Generator().manual_seed(0), (5,))
    want_y, want = bn.apply({"gamma": torch.ones(5), "beta": torch.zeros(5)},
                            bn_state, torch.from_numpy(ragged), train=True)
    got_y = np.concatenate([ranks[0]["ragged_y"], ranks[1]["ragged_y"]])
    np.testing.assert_allclose(got_y, want_y.numpy(), atol=TOL, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(ranks[0][f"ragged_{k}"], want[k].numpy(),
                                   atol=TOL, rtol=0, err_msg=k)
