"""ZeRO over the ``fsdp`` axis in the port, held against the JAX package.

- **Rules and layout.** ``GPT.partition_rules`` gives every leaf of GPT
  tiny and of a GQA Llama tiny the JAX table's spec (a decoder leaf's
  without the stacked layer dim), with and without ``fsdp``; each rank's
  block (``block_of``, on a mesh of ``{"fsdp": 2}``, ``{"fsdp": 4}``,
  ``{"data": 2, "fsdp": 2}`` and ``{"data": 4, "fsdp": 2}``) is the slice
  that ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives the
  device at that rank's place.  A dim that its axes do not divide raises
  ``ValueError`` in both packages; a ``tensor``, ``expert`` or ``pipe``
  axis of more than one rank, a MoE config's rules and
  ``pipeline_stages`` raise ``NotImplementedError``.
- **Placement.** ``shard_train_state`` places Adam, momentum, the EMA
  shadow, Adafactor and SGD states as the JAX package's does: for every
  leaf of the state (the JAX tree's paths and global shapes), the block a
  rank holds is the one the JAX state's sharding gives that device.
- **Two ZeRO steps** of ``with_ema(adamw(1e-3), 0.99)`` with clip 1.0 on
  GPT tiny (f32, dropout 0) on 2 gloo ranks (``fsdp`` 2) and 4 (``data``
  2 x ``fsdp`` 2): losses within rtol 1e-5 and parameters and the EMA
  shadow within atol 5e-5 (the JAX test's own tolerance,
  ``tests/test_sharding.py``: sharded reductions reorder float sums) of
  the JAX step on ``shard_train_state``'s placement on the 8-device XLA
  CPU mesh, and of the port's replicated data-parallel step; one
  all-gather, one reduce-scatter and one stats all-reduce a step (and one
  data-line all-reduce on the 4-rank mesh).
- **Global checks.** An inf planted in rank 0's block of one gradient
  skips the step on every rank (``skip_nonfinite``), with the same
  non-finite count everywhere.
- A line of one rank: the blocks are the model's tensors, no collective
  runs, and two steps equal the plain state's to the bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_tensorflow_tpu import optim as joptim
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.models.llama import llama_tiny as jllama
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel.sharding import \
    PartitionRules as JRules
from distributed_tensorflow_tpu.parallel.sharding import \
    prune_spec as jprune
from distributed_tensorflow_tpu_torch import (GPT, GPTConfig, TrainState,
                                              gpt_params_from_jax, gpt_tiny,
                                              optim, parallel, train)
from distributed_tensorflow_tpu_torch.models.llama import llama_tiny
from distributed_tensorflow_tpu_torch.parallel import data_parallel
from distributed_tensorflow_tpu_torch.parallel import sharding
from distributed_tensorflow_tpu_torch.train import sharded_checkpoint

import torch_sp_worker
import torch_zero_worker

torch.set_num_threads(1)

LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-5
MESHES = ({"fsdp": 2}, {"fsdp": 4}, {"data": 2, "fsdp": 2},
          {"data": 4, "fsdp": 2})
RANKS = {2: {"fsdp": 2}, 4: {"data": 2, "fsdp": 2}}


def _jax_path(name):
    """The JAX tree path of a port GPT parameter name and whether the
    leaf is stacked over layers."""
    if name in ("word", "position"):
        return f"embeddings/{name}", False
    if name.startswith("blocks."):
        return "decoder/" + name.split(".", 2)[2].replace(".", "/"), True
    return name.replace(".", "/"), False


def _virtual(axes, r):
    """Rank r of a mesh of ``axes`` without a process group."""
    n = int(np.prod(list(axes.values())))
    return parallel.Mesh(n, r, None, axes=parallel.plan_mesh(axes, n),
                         lines={})


def _models(kind):
    if kind == "gpt":
        return GPT(gpt_tiny_cfg(), device="cpu"), JGPT(jgpt_tiny().config)
    return (GPT(llama_tiny(), device="cpu"), JGPT(jllama().config))


def gpt_tiny_cfg(**kw):
    return gpt_tiny(dropout_rate=0.0, **kw)


@pytest.mark.parametrize("kind", ["gpt", "llama"])
@pytest.mark.parametrize("fsdp", [False, True])
def test_rules_match_the_jax_table(kind, fsdp):
    model, jmodel = _models(kind)
    rules = model.partition_rules(fsdp=fsdp)
    jrules = jmodel.partition_rules(fsdp=fsdp)
    for name, _ in model.named_parameters():
        path, stacked = _jax_path(name)
        want = tuple(jrules.spec_for(path))
        assert rules.spec_for(name) == (want[1:] if stacked else want), name


@pytest.mark.parametrize("axes", MESHES, ids=str)
def test_blocks_match_named_sharding(axes):
    model, jmodel = _models("gpt")
    rules = model.partition_rules(fsdp=True)
    jrules = jmodel.partition_rules(fsdp=True)
    n = int(np.prod(list(axes.values())))
    jm = jmesh.make_mesh(axes, jax.devices()[:n])
    L = model.config.num_layers
    for name, p in model.named_parameters():
        path, stacked = _jax_path(name)
        shape = ((L,) if stacked else ()) + tuple(p.shape)
        index = NamedSharding(jm, jprune(jrules.spec_for(path), jm)) \
            .devices_indices_map(shape)
        for r in range(n):
            got = sharding.block_of(tuple(p.shape), rules.spec_for(name),
                                    _virtual(axes, r))
            want = index[jm.devices.flat[r]][1 if stacked else 0:]
            want = [(s.start or 0, (s.stop or size) - (s.start or 0))
                    for s, size in zip(want, p.shape)]
            assert got == want, (name, r)


def test_undivided_dim_raises_in_both_packages():
    spec = ("fsdp", None)
    with pytest.raises(ValueError, match="divisible by 4"):
        sharding.block_of((6, 8), spec, _virtual({"data": 2, "fsdp": 4}, 0))
    jm = jmesh.make_mesh({"data": 2, "fsdp": 4})
    with pytest.raises(ValueError, match="divisible by 4"):
        jax.device_put(jnp.zeros((6, 8)), NamedSharding(jm, P(*spec)))


def test_unported_axes_and_configs_raise():
    model = GPT(gpt_tiny_cfg(), device="cpu")
    params = dict(model.named_parameters())
    opt = optim.adamw(1e-3)
    state = TrainState.create(params, opt.init(params))
    for axes, item in (({"fsdp": 2, "seq": 2, "tensor": 2}, "7.5"),
                       ({"fsdp": 2, "expert": 2}, "7.2c"),
                       ({"pipe": 2, "fsdp": 2}, "7.3a"),
                       ({"fsdp": 2, "seq": 2}, "7.5")):
        with pytest.raises(NotImplementedError, match=item):
            train.shard_train_state(state, _virtual(axes, 0),
                                    model.partition_rules(fsdp=True))
    # tensor beside seq places: a model built on the mesh keeps its
    # tensor blocks, and the state is cut over the tensor line alone
    ts = _virtual({"seq": 2, "tensor": 2}, 3)
    ts_model = GPT(gpt_tiny_cfg(seq_axis="seq"), device="cpu", mesh=ts)
    ts_params = dict(ts_model.named_parameters())
    assert train.shard_train_state(
        TrainState.create(ts_params, opt.init(ts_params)), ts,
        ts_model.partition_rules(fsdp=True)).params.line == "tensor"
    # tensor beside fsdp places: a model built on rank 3 of the mesh keeps
    # its tensor blocks, the state their fsdp parts, the moments alike;
    # a whole model's leaves under those rules raise
    tf = _virtual({"fsdp": 2, "tensor": 2}, 3)
    with pytest.raises(ValueError, match="mesh"):
        train.shard_train_state(state, tf, model.partition_rules(fsdp=True))
    tp_model = GPT(gpt_tiny_cfg(), device="cpu", mesh=tf)
    tp_params = dict(tp_model.named_parameters())
    placed = train.shard_train_state(
        TrainState.create(tp_params, opt.init(tp_params)), tf,
        tp_model.partition_rules(fsdp=True))
    assert placed.params.line == "fsdp+tensor"
    assert placed.params.full["word"] is tp_params["word"]
    d = gpt_tiny_cfg().hidden_size
    word = placed.params.layout["word"]
    assert [(p.dim, p.start, p.length, p.line) for p in word.parts] == [
        (0, 256, 256, "tensor"), (1, d // 2, d // 2, "fsdp")]
    assert torch.equal(placed.params["word"],
                       tp_params["word"].detach()[:, d // 2:])
    assert placed.opt_state.inner["m"]["word"].shape == (256, d // 2)
    # a tensor axis cuts (rank 1 sits at tensor 1), and beside fsdp a
    # leaf is cut over both along two dims; over both axes on one dim it
    # still raises
    assert sharding.block_of((8, 8), ("tensor", None),
                             _virtual({"data": 2, "tensor": 2}, 1)) == [
        (4, 4), (0, 8)]
    assert sharding.block_of((8, 8), ("tensor", "fsdp"),
                             _virtual({"fsdp": 2, "tensor": 2}, 1)) == [
        (4, 4), (0, 4)]
    with pytest.raises(NotImplementedError, match="7.2b"):
        sharding.zero_shard((8, 8), (("fsdp", "tensor"), None),
                            _virtual({"fsdp": 2, "tensor": 2}, 0))
    # a MoE config's table takes the expert rows, which a ZeRO mesh
    # prunes to whole banks
    moe = GPT(gpt_tiny_cfg(moe_experts=2), device="cpu")
    assert moe.partition_rules(fsdp=True).spec_for(
        "blocks.0.moe.experts.w_in") == ("expert", None, "tensor")
    # the pipeline is ported; a MoE config beside it stays refused, as in
    # the JAX package
    assert GPTConfig(pipeline_stages=2).pipeline_stages == 2
    with pytest.raises(ValueError, match="MoE"):
        GPTConfig(pipeline_stages=2, moe_experts=2)
    # a cut over data cannot be gathered over the fsdp line
    with pytest.raises(NotImplementedError, match="over data"):
        sharding.zero_shard((8, 8), ("data", None),
                            _virtual({"data": 2, "fsdp": 2}, 0))


_OPTIMIZERS = {
    "adam": (lambda: optim.adam(1e-3), lambda: joptim.adam(1e-3)),
    "momentum": (lambda: optim.momentum(0.1), lambda: joptim.momentum(0.1)),
    "ema": (lambda: optim.with_ema(optim.adamw(1e-3), 0.99),
            lambda: joptim.with_ema(joptim.adamw(1e-3), 0.99)),
    "adafactor": (lambda: optim.adafactor(),
                  lambda: joptim.adafactor()),
    "sgd": (lambda: optim.sgd(0.1), lambda: joptim.sgd(0.1)),
}


def _dense_params():
    """A layer stack's parameters (``<layer>.<param>``; the JAX tree
    nests them): a factored [256, 128] kernel under adafactor's defaults,
    a [16, 8] one that is not, and a bias."""
    rng = np.random.default_rng(0)
    shapes = {"big.kernel": (256, 128), "big.bias": (128,),
              "small.kernel": (16, 8)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _placed(kind, opt, axes, r):
    """(port state placed on rank r of ``axes``, JAX state placed on the
    8-device mesh of ``axes``) from the same weights."""
    jm = jmesh.make_mesh(axes)
    jopt, topt = _OPTIMIZERS[opt][1](), _OPTIMIZERS[opt][0]()
    if kind == "gpt":
        jmodel = JGPT(jgpt_tiny(dropout_rate=0.0).config)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        jrules = jmodel.partition_rules(fsdp=True)
        model = GPT(gpt_tiny_cfg(), device="cpu")
        params, rules = dict(model.named_parameters()), \
            model.partition_rules(fsdp=True)
    else:
        flat = _dense_params()
        jparams = {}
        for k, v in flat.items():
            layer, name = k.split(".")
            jparams.setdefault(layer, {})[name] = jnp.asarray(v)
        jrules = JRules([(r"kernel", P("fsdp", None))])
        params = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
        rules = sharding.PartitionRules([(r"kernel", ("fsdp", None))])
    jstate = jtrain.shard_train_state(
        jtrain.TrainState.create(jparams, jopt.init(jparams)), jm, jrules)
    state = train.shard_train_state(
        TrainState.create(params, topt.init(params)), _virtual(axes, r),
        rules)
    return state, jstate, jm


@pytest.mark.parametrize("kind,opt", [("gpt", o) for o in sorted(_OPTIMIZERS)
                                      if o != "adafactor"]
                         + [("dense", o) for o in sorted(_OPTIMIZERS)])
def test_placement_matches_the_jax_state(kind, opt):
    """Every leaf of the placed state (params and optimizer state, the
    JAX tree's paths) holds on rank r the block the JAX state's sharding
    gives device r, on a data 4 x fsdp 2 mesh."""
    axes = {"data": 4, "fsdp": 2}
    for r in (0, 3, 6):
        state, jstate, jm = _placed(kind, opt, axes, r)
        jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
        pieces = train.checkpoint._flatten(
            sharded_checkpoint._pieces(state, r, with_data=True))
        assert [p for p, _ in pieces] == [jax.tree_util.keystr(p)
                                          for p, _ in jflat]
        for (path, pc), (_, leaf) in zip(pieces, jflat):
            assert pc.shape == tuple(np.shape(leaf)), path
            idx = (leaf.sharding.devices_indices_map(pc.shape)
                   [jm.devices.flat[r]] if hasattr(leaf, "sharding")
                   else ())
            want = tuple(((s.start or 0), (s.stop or n) - (s.start or 0))
                         for s, n in zip(idx, pc.shape)) or tuple(
                (0, n) for n in pc.shape)
            assert tuple(zip(pc.start, pc.chunk)) == want, (path, r)
            assert tuple(pc.data.shape) == pc.chunk, path
    inner = state.opt_state.inner
    if opt == "sgd":
        assert inner == ()
    if opt == "momentum":
        k = "small.kernel" if kind == "dense" else "blocks.0.ffn.w_in.kernel"
        assert inner.cut and inner.layout[k] == state.params.layout[k]
    if opt == "adafactor":
        # the factored moments of the big kernel replicate; the small
        # kernel's full second moment shards with it
        assert not inner["vr"].cut and not inner["vc"].cut
        assert inner["v"].layout["small.kernel"] is not None
        assert inner["v"].layout["big.kernel"] is None


def _spec():
    jmodel = jgpt_tiny(dropout_rate=0.0)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    state = {k: v.numpy() for k, v in gpt_params_from_jax(
        jax.tree.map(np.asarray, jparams), gpt_tiny_cfg()).items()}
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 512, (8, 17)).astype(np.int64)
               for _ in range(2)]
    return jmodel, jparams, state, batches


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step on ``shard_train_state``'s placement on the 8-device
    mesh: (each step's metrics, the state's leaves by keystr path)."""
    jmodel, jparams, _, batches = _spec()
    jm = jmesh.make_mesh({"data": 4, "fsdp": 2})
    opt = joptim.with_ema(joptim.adamw(1e-3), 0.99)
    jstate = jtrain.shard_train_state(
        jtrain.TrainState.create(jparams, opt.init(jparams)), jm,
        jmodel.partition_rules(fsdp=True))
    step = jtrain.make_custom_train_step(jmodel.lm_loss_fn(), opt,
                                         grad_clip_norm=1.0,
                                         device_health=True)
    metrics = []
    for ids in batches:
        jstate, m = step(jstate, {"input_ids": jnp.asarray(ids)})
        metrics.append(jax.device_get(m))
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(jstate))[0]}
    return metrics, flat


@pytest.fixture(scope="module", params=sorted(RANKS), ids=lambda w: f"R{w}")
def ranks(request, tmp_path_factory):
    """(world, every rank's results) of ``run_zero_rank`` on the mesh of
    ``RANKS[world]``."""
    world = request.param
    _, _, state, batches = _spec()
    return world, torch_sp_worker.spawn_ranks(
        tmp_path_factory.mktemp(f"zero{world}"),
        torch_zero_worker.run_zero_rank,
        ({"axes": RANKS[world], "state": state, "batches": batches},),
        world=world)


def _leaves(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items()
            if k.startswith(prefix + "/")}


def test_zero_steps_equal_the_jax_step(ranks, jax_run):
    jmetrics, jflat = jax_run
    for out in ranks[1]:
        for i, jm in enumerate(jmetrics):
            for k in ("loss", "token_accuracy", "grad_norm"):
                np.testing.assert_allclose(out[f"zero_step{i}_{k}"], jm[k],
                                           rtol=LOSS_RTOL, err_msg=k)
            assert out[f"zero_step{i}_nonfinite_grads"] == 0
        got = _leaves(out, "zero")
        assert sorted(got) == sorted(jflat)
        for path, want in jflat.items():
            if "['params']" in path or "shadow" in path or path in (
                    ".step",):
                np.testing.assert_allclose(got[path], want, rtol=0,
                                           atol=PARAM_ATOL, err_msg=path)
        assert int(got[".opt_state.count"]) == 2


def test_zero_steps_equal_the_replicated_step(ranks):
    for out in ranks[1]:
        for i in range(2):
            np.testing.assert_allclose(out[f"zero_step{i}_loss"],
                                       out[f"dp_step{i}_loss"],
                                       rtol=LOSS_RTOL)
        dp = _leaves(out, "dp")
        for path, got in _leaves(out, "zero").items():
            np.testing.assert_allclose(got, dp[path], rtol=0,
                                       atol=PARAM_ATOL, err_msg=path)
    # every rank holds the same whole state
    first = _leaves(ranks[1][0], "zero")
    for out in ranks[1][1:]:
        for path, v in _leaves(out, "zero").items():
            np.testing.assert_array_equal(v, first[path], err_msg=path)


def test_zero_collectives_a_step(ranks):
    data = RANKS[ranks[0]].get("data", 1)
    for out in ranks[1]:
        assert int(out["zero_collectives_all_gather"]) == 2
        assert int(out["zero_collectives_reduce_scatter"]) == 2
        assert int(out["zero_collectives_stats_all_reduce"]) == 2
        assert int(out.get("zero_collectives_all_reduce", 0)) == (
            2 if data > 1 else 0)


def test_planted_inf_skips_every_rank(ranks):
    counts = set()
    for out in ranks[1]:
        assert not bool(out["skip_step0_grads_finite"])
        assert bool(out["skip_kept"])
        assert int(out["skip_count"]) == 0 and int(out["skip_step"]) == 1
        counts.add(float(out["skip_step0_nonfinite_grads"]))
    assert len(counts) == 1 and counts.pop() >= 1


def test_line_of_one_is_the_plain_step():
    _, _, state, batches = _spec()
    runs = []
    for zero in (False, True):
        model = torch_zero_worker._model(state)
        mesh = parallel.make_mesh({"data": 1, "fsdp": 1})
        if zero:
            st = torch_zero_worker._zero_state(model, mesh)
            assert not st.params.cut
            assert all(st.params[k] is p for k, p in model.named_parameters())
        else:
            params = dict(model.named_parameters())
            opt = torch_zero_worker._optimizer()
            st = TrainState.create(params, opt.init(params))
        step = train.make_custom_train_step(
            model.lm_loss_fn(), torch_zero_worker._optimizer(), mesh=mesh,
            grad_clip_norm=1.0)
        data_parallel.LAUNCHES.clear()
        losses = []
        for ids in batches:
            st, m = step(st, {"input_ids": torch.from_numpy(ids)})
            losses.append(float(m["loss"]))
        assert not data_parallel.LAUNCHES
        runs.append((losses, {k: p.detach().clone()
                              for k, p in model.named_parameters()},
                     optim.ema_params(st.opt_state)))
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k
        assert torch.equal(runs[0][2][k], runs[1][2][k]), k


def test_cut_state_refuses_what_it_cannot_do():
    model = GPT(gpt_tiny_cfg(), device="cpu")
    params = dict(model.named_parameters())
    opt = optim.lamb(1e-3)
    state = train.shard_train_state(
        TrainState.create(params, opt.init(params)),
        _virtual({"fsdp": 2}, 0), model.partition_rules(fsdp=True))
    assert state.params.cut
    batch = {"input_ids": torch.zeros((2, 9), dtype=torch.long)}
    # no mesh: a cut state never runs as a replicated one
    with pytest.raises(ValueError, match="mesh"):
        train.make_custom_train_step(model.lm_loss_fn(), opt)(state, batch)
    with pytest.raises(NotImplementedError, match="lamb"):
        train.make_custom_train_step(model.lm_loss_fn(), opt,
                                     mesh=state.params.mesh)(state, batch)
    # so does a state cut over fsdp beside tensor
    tf = _virtual({"fsdp": 2, "tensor": 2}, 0)
    tp_model = GPT(gpt_tiny_cfg(), device="cpu", mesh=tf)
    tp_params = dict(tp_model.named_parameters())
    tf_state = train.shard_train_state(
        TrainState.create(tp_params, opt.init(tp_params)), tf,
        tp_model.partition_rules(fsdp=True))
    with pytest.raises(NotImplementedError, match="lamb"):
        train.make_custom_train_step(tp_model.lm_loss_fn(), opt,
                                     mesh=tf)(tf_state, batch)
    # the plain checkpoint refuses it
    with pytest.raises(ValueError, match="sharded_checkpoint"):
        train.checkpoint.save("/nonexistent", 0, state)
