"""Tensor parallelism in the port, held against the JAX package.

- **Rules and blocks.**  For GPT tiny (4 heads), a GQA GPT tiny at kv 1,
  the Llama tiny recipe (GQA 4:2) and BERT tiny (4 heads), every rank's
  block (``block_of`` on ``{"tensor": 2}``, ``{"data": 2, "tensor": 2}``
  and ``{"tensor": 4}``) is the slice that ``NamedSharding(jmesh,
  spec).devices_indices_map(shape)`` gives the device at that rank's
  place, and a model built on that rank holds exactly that slice of the
  whole model.  ``Bert.partition_rules`` is the JAX table; the placed
  state (parameters, Adam's moments, the EMA shadow) is laid out as the
  JAX package's ``shard_train_state`` lays it out.  A dim T does not
  divide (GPT-2's vocabulary of 50257 at T = 2) raises in both packages.
- **The collectives alone** (2 gloo ranks): each function of
  ``parallel/tensor_parallel.py`` forward and backward against the plain
  op on whole tensors; the vocabulary-parallel cross entropy and argmax
  equal ``ops/losses.py`` and ``torch.argmax`` on whole logits to 1e-6
  (ties across the ranks' boundary pick the first index).
- **Two TP steps** of ``adamw(1e-3)`` with clip 1.0 on 4 gloo ranks
  ``{"data": 2, "tensor": 2}`` (f32, dropout 0): GPT tiny
  (``tests/test_gpt.py:173``), GQA tiny at kv 1 (``:605``) and at kv 2
  with ``shard_kv=True`` (``:636``), BERT tiny MLM
  (``tests/test_bert.py:107``), and the Llama tiny recipe.  Losses within
  rtol 1e-5 and every rank's parameter blocks within atol 5e-5 of the
  JAX step on ``shard_pytree(params, jmesh, rules)`` (sharded reductions
  reorder float sums: ``tests/test_sharding.py``'s tolerance; the Llama
  recipe against the plain step only) and of the port's plain step on
  the whole batch; the collectives a step are exact.
- **TP decoding** on ``{"tensor": 2}``: ``decode_block`` and
  ``decode_step`` logits within 2e-3 (``tests/test_gpt.py:291-294``) of
  the JAX package's TP-sharded jitted decode and of the plain model;
  greedy ``generate`` tokens identical to the JAX package's, sampled
  ones to the plain model's with the same generator.
- **Dropout**: the training forward under TP draws the plain model's
  masks, and after a step at dropout 0.1 the residual stream and the
  replicated leaves are bit-equal across the line.
- **``loss_seq_chunk``** under TP (the Llama recipe's untied head)
  equals the whole logits' loss, accuracy and gradients.
- **``finetune_bert``** on 2 gloo ranks takes the tp=2 path and prints
  the lines ``tests/test_torch_zoo_examples.py`` asks of its one-rank
  run.
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
from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.models.llama import llama_tiny as jllama
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel.sharding import \
    prune_spec as jprune
from distributed_tensorflow_tpu.parallel.sharding import \
    shard_pytree as jshard
from distributed_tensorflow_tpu_torch import (GPT, TrainState, gpt_tiny,
                                              make_custom_train_step,
                                              optim, parallel, train)
from distributed_tensorflow_tpu_torch.models import bert as tbert
from distributed_tensorflow_tpu_torch.models import convert
from distributed_tensorflow_tpu_torch.models.llama import llama_tiny
from distributed_tensorflow_tpu_torch.ops import losses
from distributed_tensorflow_tpu_torch.parallel import data_parallel
from distributed_tensorflow_tpu_torch.parallel import sharding
from distributed_tensorflow_tpu_torch.parallel import tensor_parallel
from distributed_tensorflow_tpu_torch.train import sharded_checkpoint

import torch_sp_worker
import torch_tp_worker

torch.set_num_threads(1)

LOSS_RTOL, PARAM_ATOL, DECODE_ATOL, EXACT = 1e-5, 5e-5, 2e-3, 1e-6
AXES = {"data": 2, "tensor": 2}
MESHES = ({"tensor": 2}, {"data": 2, "tensor": 2}, {"tensor": 4})


def _virtual(axes, r):
    """Rank r of a mesh of ``axes`` without a process group."""
    n = int(np.prod(list(axes.values())))
    return parallel.Mesh(n, r, None, axes=parallel.plan_mesh(axes, n),
                         lines={})


# -- the models: (port config kwargs, shard_kv, JAX model) -------------------

def _cases(heads4=False):
    """{name: (kind, port config, shard_kv, JAX model)}; ``heads4``: every
    model with 4 heads (the blocks test cuts over 4 ranks)."""
    g = dict(num_heads=4) if heads4 else {}
    return {
        "gpt": ("gpt", gpt_tiny(dropout_rate=0.0, **g), None,
                jgpt_tiny(dropout_rate=0.0, **g)),
        "gqa_kv1": ("gpt", gpt_tiny(dropout_rate=0.0, num_heads=4,
                                    num_kv_heads=1), None,
                    jgpt_tiny(dropout_rate=0.0, num_heads=4,
                              num_kv_heads=1)),
        "gqa_kv2_shard_kv": ("gpt", gpt_tiny(dropout_rate=0.0, num_heads=4,
                                             num_kv_heads=2), True,
                             jgpt_tiny(dropout_rate=0.0, num_heads=4,
                                       num_kv_heads=2)),
        "llama": ("gpt", llama_tiny(), None, jllama(dropout_rate=0.0)),
        "bert": ("bert", tbert.BertConfig(**dataclasses.asdict(
            tbert.bert_tiny(dropout_rate=0.0, **g).config)), None,
            jbert.bert_tiny(dropout_rate=0.0, **g)),
    }


def _jax_rules(kind, jmodel, shard_kv):
    if kind == "bert":
        return jmodel.partition_rules()
    return jmodel.partition_rules(shard_kv=shard_kv)


def _port_rules(kind, config, shard_kv):
    if kind == "bert":
        return tbert.Bert(config).partition_rules()
    from distributed_tensorflow_tpu_torch.models.gpt import \
        gpt_partition_rules
    return gpt_partition_rules(config, shard_kv=shard_kv)


def _jax_path(kind, name):
    """(JAX tree path, stacked over layers) of a port parameter name."""
    if kind == "bert":
        head, _, rest = name.partition(".")
        if head == "encoder":
            return "encoder/" + rest.split(".", 1)[1].replace(".", "/"), True
        return name.replace(".", "/"), False
    if name in ("word", "position"):
        return f"embeddings/{name}", False
    if name.startswith("blocks."):
        return "decoder/" + name.split(".", 2)[2].replace(".", "/"), True
    return name.replace(".", "/"), False


def _jax_params(jmodel):
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))


def _port_state(kind, config, jparams):
    """The port's whole parameters (numpy, port names) of a JAX tree."""
    if kind == "bert":
        params = convert.bert_params_from_jax(jparams, config)
    else:
        params = convert.gpt_params_from_jax(jparams, config)
    return {k: v.detach().numpy() for k, v in params.items()}


def _slice_of(index, shape, stacked):
    idx = index[1 if stacked else 0:]
    return [(s.start or 0, (s.stop or n) - (s.start or 0))
            for s, n in zip(idx, shape)]


# -- rules and blocks -------------------------------------------------------

@pytest.mark.parametrize("axes", MESHES, ids=str)
@pytest.mark.parametrize("name", ["gpt", "gqa_kv1", "llama", "bert"])
def test_blocks_match_named_sharding(name, axes):
    kind, config, shard_kv, jmodel = _cases(heads4=True)[name]
    jparams = _jax_params(jmodel)
    whole = _port_state(kind, config, jparams)
    rules = _port_rules(kind, config, shard_kv)
    jrules = _jax_rules(kind, jmodel, shard_kv)
    n = int(np.prod(list(axes.values())))
    jm = jmesh.make_mesh(axes, jax.devices()[:n])
    L = config.num_layers
    for r in range(n):
        mesh = _virtual(axes, r)
        if kind == "bert":
            held = tbert.Bert(config, mesh).init(torch.Generator())
            ref = tbert.Bert(config).init(torch.Generator())
        else:
            held = dict(GPT(config, device="cpu", mesh=mesh,
                            shard_kv=shard_kv).named_parameters())
            ref = dict(GPT(config, device="cpu").named_parameters())
        assert sorted(held) == sorted(whole)
        for pname, full in whole.items():
            path, stacked = _jax_path(kind, pname)
            shape = ((L,) if stacked else ()) + full.shape
            index = NamedSharding(jm, jprune(jrules.spec_for(path), jm)) \
                .devices_indices_map(shape)[jm.devices.flat[r]]
            want = _slice_of(index, full.shape, stacked)
            got = sharding.block_of(full.shape, rules.spec_for(pname), mesh)
            assert got == want, (pname, r)
            # the model built on rank r holds that slice of the whole
            # model it draws (the same at every T)
            view = ref[pname].detach()
            for d, (start, length) in enumerate(want):
                view = view.narrow(d, start, length)
            assert torch.equal(held[pname].detach(), view), (pname, r)
            cut = want != [(0, s) for s in full.shape]
            assert (sharding.marked_shard(held[pname]) is not None) == cut


@pytest.mark.parametrize("fsdp", [False, True])
def test_bert_rules_match_the_jax_table(fsdp):
    model = tbert.bert_tiny()
    jrules = jbert.bert_tiny().partition_rules(fsdp=fsdp)
    rules = model.partition_rules(fsdp=fsdp)
    for name in model.init(torch.Generator()):
        path, stacked = _jax_path("bert", name)
        want = tuple(jrules.spec_for(path))
        assert rules.spec_for(name) == (want[1:] if stacked else want), name


def test_undivided_dim_raises_in_both_packages():
    """GPT-2's vocabulary of 50257 does not cut over 2 ranks."""
    spec = ("tensor", None)
    with pytest.raises(ValueError, match="divisible by 2"):
        sharding.block_of((50257, 8), spec, _virtual({"tensor": 2}, 0))
    jm = jmesh.make_mesh({"tensor": 2}, jax.devices()[:2])
    with pytest.raises(ValueError, match="divisible by 2"):
        jax.device_put(jnp.zeros((50257, 8)), NamedSharding(jm, P(*spec)))
    with pytest.raises(ValueError, match="divisible by 2"):
        GPT(gpt_tiny(vocab_size=513), device="cpu",
            mesh=_virtual({"tensor": 2}, 1))
    # two kv heads and a line of 4: the query group mapping still works
    # (a group of one kv head a rank); 3 kv heads on 2 ranks do not
    assert tensor_parallel.kv_heads(8, 2, _virtual({"tensor": 4}, 3)) \
        == slice(1, 2)
    with pytest.raises(ValueError, match="divide"):
        tensor_parallel.kv_heads(6, 3, _virtual({"tensor": 2}, 0))


def test_placements_are_spec_holders():
    mesh = _virtual({"data": 2, "tensor": 2}, 3)
    t = torch.arange(32.0).reshape(8, 4)
    p = parallel.named_sharding(mesh, "tensor", "fsdp")
    assert p.spec == ("tensor", None)           # fsdp pruned
    assert torch.equal(p.block(t), t[4:])
    assert parallel.replicated(mesh).block(t) is t
    tree = parallel.logical_to_mesh({"a": ("tensor",), "b": {"c": ()}},
                                    mesh)
    assert tree["a"] == parallel.Placement(mesh, ("tensor",))
    assert tree["b"]["c"].spec == ()


def _want_block(leaf, jm, r, shape):
    """(start, length) per dim of device r's block of a JAX leaf."""
    if not hasattr(leaf, "sharding"):
        return tuple((0, n) for n in shape)
    idx = leaf.sharding.devices_indices_map(shape)[jm.devices.flat[r]]
    return tuple(((s.start or 0), (s.stop or n) - (s.start or 0))
                 for s, n in zip(idx, shape))


def _at(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


@pytest.mark.parametrize("name", ["gpt", "llama", "bert"])
def test_placement_matches_the_jax_state(name):
    """Every leaf of the placed state (params, Adam's moments, the EMA
    shadow) holds on rank r the block the JAX state's sharding gives
    device r, on a data 2 x tensor 2 mesh: for the GPT family every leaf
    of the JAX tree's paths (as the sharded checkpoint writes them), for
    BERT each params-shaped leaf against its stacked JAX leaf."""
    kind, config, shard_kv, jmodel = _cases()[name]
    jparams = _jax_params(jmodel)
    whole = _port_state(kind, config, jparams)
    jm = jmesh.make_mesh(AXES, jax.devices()[:4])
    jopt = joptim.with_ema(joptim.adamw(1e-3), 0.99)
    jstate = jtrain.shard_train_state(
        jtrain.TrainState.create(jparams, jopt.init(jparams)), jm,
        _jax_rules(kind, jmodel, shard_kv))
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    L = config.num_layers
    for r in range(4):
        mesh = _virtual(AXES, r)
        if kind == "bert":
            model = tbert.Bert(config, mesh)
            params = sharding.cut_blocks(
                {k: torch.from_numpy(v.copy()).requires_grad_(True)
                 for k, v in whole.items()}, model.partition_rules(), mesh)
        else:
            model = GPT(config, device="cpu", mesh=mesh)
            params = dict(model.named_parameters())
        opt = optim.with_ema(optim.adamw(1e-3), 0.99)
        state = train.shard_train_state(
            TrainState.create(params, opt.init(params)), mesh,
            model.partition_rules())
        assert state.params.line == "tensor"
        assert all(state.params[k] is params[k] for k in params)
        inner = state.opt_state.inner
        placed = {"params": state.params, "m": inner["opt"].inner["m"],
                  "v": inner["opt"].inner["v"],
                  "shadow": inner["ema"].shadow}
        for sub in placed.values():
            assert sub.layout == state.params.layout
        if kind == "bert":
            jsubs = {"params": jstate.params,
                     "m": jstate.opt_state.inner["opt"].inner["m"],
                     "v": jstate.opt_state.inner["opt"].inner["v"],
                     "shadow": jstate.opt_state.inner["ema"].shadow}
            for what, sub in placed.items():
                for pname, t in sub.items():
                    path, stacked = _jax_path(kind, pname)
                    shape = ((L,) if stacked else ()) + whole[pname].shape
                    want = _want_block(_at(jsubs[what], path), jm, r, shape)
                    s = sub.layout[pname]
                    got = [(0, n) for n in whole[pname].shape]
                    if s is not None:
                        got[s.dim] = (s.start, s.length)
                    assert tuple(got) == want[1 if stacked else 0:], (
                        what, pname, r)
                    assert tuple(t.shape) == tuple(n for _, n in got)
            continue
        pieces = train.checkpoint._flatten(
            sharded_checkpoint._pieces(state, r, with_data=True))
        assert [p for p, _ in pieces] == [jax.tree_util.keystr(p)
                                          for p, _ in jflat]
        for (path, pc), (_, leaf) in zip(pieces, jflat):
            assert pc.shape == tuple(np.shape(leaf)), path
            assert tuple(zip(pc.start, pc.chunk)) == _want_block(
                leaf, jm, r, pc.shape), (path, r)
            assert tuple(pc.data.shape) == pc.chunk, path


# -- in one process ---------------------------------------------------------

def test_line_of_one_is_the_plain_model():
    """``{"tensor": 1}``: nothing is cut, no collective runs, and two steps
    equal the plain model's to the bit."""
    mesh = parallel.make_mesh({"tensor": 1})
    rng = np.random.default_rng(2)
    batches = [torch.from_numpy(rng.integers(0, 512, (4, 9)))
               for _ in range(2)]
    runs = []
    for m in (None, mesh):
        model = GPT(llama_tiny(), device="cpu", mesh=m)
        params = dict(model.named_parameters())
        opt = optim.adamw(1e-3)
        state = TrainState.create(params, opt.init(params))
        if m is not None:
            state = train.shard_train_state(state, m,
                                            model.partition_rules())
            assert not state.params.cut
        step = make_custom_train_step(model.lm_loss_fn(), opt, mesh=m,
                                      grad_clip_norm=1.0)
        data_parallel.LAUNCHES.clear()
        losses_ = [float(step(state, {"input_ids": b})[1]["loss"])
                   for b in batches]
        assert not data_parallel.LAUNCHES
        runs.append((losses_, {k: p.detach().clone()
                               for k, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


def test_refusals_under_tensor():
    """What tensor parallelism does not run raises, naming ROADMAP Queue 1
    item 7.2b (or 7.5 beside seq and fsdp); a plain state refuses a
    tensor-parallel step."""
    mesh = _virtual({"tensor": 2}, 0)
    # (a MoE config runs under tensor now: tests/test_torch_expert.py)
    with pytest.raises(NotImplementedError, match="7.2b"):
        GPT(gpt_tiny(kv_cache_dtype="int8"), device="cpu", mesh=mesh)
    # beside seq the model keeps its tensor blocks, cut as on a tensor
    # line alone (tests/test_torch_tp_sp.py trains it); beside seq and
    # fsdp at once it raises, naming ROADMAP Queue 1 item 7.5
    beside_seq = GPT(gpt_tiny(seq_axis="seq"), device="cpu",
                     mesh=_virtual({"seq": 2, "tensor": 2}, 3))
    assert sharding.marked_shard(beside_seq.word) == sharding.Shard(
        0, 256, 256, 512, "tensor")
    with pytest.raises(NotImplementedError, match="7.5"):
        GPT(gpt_tiny(seq_axis="seq"), device="cpu",
            mesh=_virtual({"fsdp": 2, "seq": 2, "tensor": 2}, 0))
    # beside fsdp the model keeps its tensor blocks, cut as on a tensor
    # line alone
    beside_fsdp = GPT(gpt_tiny(), device="cpu",
                      mesh=_virtual({"fsdp": 2, "tensor": 2}, 1))
    assert sharding.marked_shard(beside_fsdp.word) == sharding.Shard(
        0, 256, 256, 512, "tensor")
    model = GPT(gpt_tiny(dropout_rate=0.0), device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="7.2b"):
        model.decode_window_paged({}, torch.zeros(1, 2, dtype=torch.long),
                                  torch.zeros(2, dtype=torch.int32), 0)
    with pytest.raises(NotImplementedError, match="7.2b"):
        model.decode_window(model.init_cache(1, 8),
                            torch.zeros(1, 2, dtype=torch.long),
                            adapters={}, adapter_rows=torch.zeros(1))
    params = dict(model.named_parameters())
    opt = optim.adamw(1e-3)
    step = make_custom_train_step(model.lm_loss_fn(), opt, mesh=mesh)
    with pytest.raises(ValueError, match="shard_train_state"):
        step(TrainState.create(params, opt.init(params)),
             {"input_ids": torch.zeros(2, 5, dtype=torch.long)})
    # the rules must cut the model's blocks as the model did
    skv = GPT(gpt_tiny(num_heads=4, num_kv_heads=2), device="cpu",
              mesh=mesh, shard_kv=True)
    p = dict(skv.named_parameters())
    with pytest.raises(ValueError, match="shard_kv"):
        train.shard_train_state(TrainState.create(p, opt.init(p)), mesh,
                                skv.partition_rules(shard_kv=False))


def test_convert_returns_this_ranks_blocks():
    kind, config, _, jmodel = _cases()["llama"]
    jparams = _jax_params(jmodel)
    whole = convert.gpt_params_from_jax(jparams, config)
    mesh = _virtual({"tensor": 2}, 1)
    model = GPT(config, device="cpu", mesh=mesh)
    got = convert.gpt_params_from_jax(jparams, config, mesh=mesh)
    want = sharding.shard_pytree(whole, mesh, model.partition_rules())
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    convert.load_jax_params(model, jparams)
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
    bkind, bconfig, _, bjmodel = _cases()["bert"]
    bj = _jax_params(bjmodel)
    blocks = convert.bert_params_from_jax(bj, bconfig, mesh=mesh)
    full = convert.bert_params_from_jax(bj, bconfig)
    s = sharding.marked_shard(blocks["mlm.output_bias"])
    assert s == sharding.Shard(0, 500, 500, 1000, "tensor")
    assert torch.equal(blocks["mlm.output_bias"].detach(),
                       full["mlm.output_bias"].detach()[500:])


def test_make_psum_train_step_is_the_mesh_step():
    from distributed_tensorflow_tpu_torch import ops as lib
    model = lib.serial(lib.Dense(4, activation="relu"), lib.Dense(2))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((8, 2)).astype(np.float32))
    mesh = parallel.data_parallel_mesh()
    out = []
    for build in (parallel.make_psum_train_step, None):
        state = train.init_train_state(model, optim.sgd(0.1),
                                       torch.Generator().manual_seed(0),
                                       (8, 3))
        if build is None:
            step = train.make_train_step(model, "mse", optim.sgd(0.1),
                                         mesh=mesh)
        else:
            step = build(model, "mse", optim.sgd(0.1), mesh)
        state, m = step(state, (x, y))
        out.append((float(m["loss"]), {k: v.clone()
                                       for k, v in state.params.items()}))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k])
    with pytest.raises(ValueError, match="data"):
        parallel.make_psum_train_step(model, "mse", optim.sgd(0.1), mesh,
                                      axis="tensor")


# -- the collectives on a line of 2 -----------------------------------------

def _collective_case():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 16)).astype(np.float32) * 3
    ties = rng.standard_normal((3, 16)).astype(np.float32)
    ties[0, [2, 9]] = 9.0        # a max in both ranks' columns
    ties[1, [10, 12]] = 9.0      # twice in rank 1's
    ties[2, 7] = ties[2, 8] = 9.0    # across the boundary
    return {"x": rng.standard_normal((3, 4, 8)).astype(np.float32),
            "w": rng.standard_normal((2, 3, 4, 8)).astype(np.float32),
            "word": rng.standard_normal((10, 6)).astype(np.float32),
            "ids": rng.integers(0, 10, (3, 5)).astype(np.int64),
            "dy": rng.standard_normal((3, 5, 6)).astype(np.float32),
            "logits": logits,
            "targets": rng.integers(0, 16, 6).astype(np.int64),
            "ties": ties}


def _decode_case(kind):
    config = (gpt_tiny(dropout_rate=0.0) if kind == "gpt"
              else llama_tiny())
    jmodel = (jgpt_tiny(dropout_rate=0.0) if kind == "gpt"
              else jllama(dropout_rate=0.0))
    jparams = _jax_params(jmodel)
    ids = np.random.default_rng(7).integers(0, 512, (2, 8)).astype(np.int64)
    return ({"kind": "gpt", "config": dataclasses.asdict(config),
             "state": _port_state("gpt", config, jparams), "ids": ids},
            jmodel, jparams)


FINETUNE_ARGV = ["--device=cpu", "--steps=25", "--batch_size=8",
                 "--seq_len=16", "--mlm_steps=4", "--mlm_predictions_per_seq=4",
                 "--remat", "--remat_policy=dots"]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Both gloo runs, started together before the JAX package's side is
    computed (in this process, meanwhile): {name: join function}."""
    cases, _ = _step_spec()
    line = {"collectives": _collective_case(),
            "decode": {k: _decode_case(k)[0] for k in ("gpt", "llama")},
            "finetune_argv": FINETUNE_ARGV}
    return {"line": torch_sp_worker.start_ranks(
                tmp_path_factory.mktemp("tp_line"),
                torch_tp_worker.run_line_rank, (line,), world=2),
            "step": torch_sp_worker.start_ranks(
                tmp_path_factory.mktemp("tp_step"),
                torch_tp_worker.run_step_rank,
                ({"axes": AXES, "cases": cases},), world=4)}


@pytest.fixture(scope="module")
def line_run(started, jax_decode, jax_steps):
    return started["line"]()


def _part(a, r, dim=-1, t=2):
    n = a.shape[dim] // t
    return np.take(a, np.arange(r * n, (r + 1) * n), axis=dim)


def test_collectives_match_the_plain_ops(line_run):
    c = _collective_case()
    word = torch.from_numpy(c["word"]).requires_grad_(True)
    emb = torch.nn.functional.embedding(torch.from_numpy(c["ids"]), word)
    (emb * torch.from_numpy(c["dy"])).sum().backward()
    for r, out in enumerate(line_run):
        np.testing.assert_allclose(out["coll/copy/grad"], c["w"].sum(0),
                                   rtol=0, atol=EXACT)
        np.testing.assert_allclose(out["coll/reduce/out"], c["w"].sum(0),
                                   rtol=0, atol=EXACT)
        np.testing.assert_array_equal(out["coll/reduce/grad"], c["x"])
        np.testing.assert_array_equal(out["coll/gather/out"], c["x"])
        np.testing.assert_array_equal(out["coll/gather/grad"],
                                      _part(c["x"], r))
        np.testing.assert_allclose(out["coll/embed/out"],
                                   emb.detach().numpy(), rtol=0, atol=EXACT)
        np.testing.assert_allclose(out["coll/embed/grad"],
                                   _part(word.grad.numpy(), r, 0),
                                   rtol=0, atol=EXACT)
        for name, kind, n in (("copy", "tp_all_reduce", 1),
                              ("reduce", "tp_all_reduce", 1),
                              ("gather", "tp_all_gather", 1),
                              ("embed", "tp_all_reduce", 1),
                              ("cross_entropy", "tp_all_reduce", 2),
                              ("argmax", "tp_all_gather", 1)):
            launches = {k.rsplit("/", 1)[1]: int(v) for k, v in out.items()
                        if k.startswith(f"coll/{name}/launches/")}
            assert launches == {kind: n}, name


def test_vocab_parallel_ce_and_argmax_equal_the_plain_ones(line_run):
    c = _collective_case()
    logits = torch.from_numpy(c["logits"]).requires_grad_(True)
    targets = torch.from_numpy(c["targets"])
    mean = losses.softmax_cross_entropy_with_integer_labels(logits, targets)
    mean.backward()
    per_row = -torch.log_softmax(logits, -1).gather(
        -1, targets[:, None])[:, 0]
    want_argmax = torch.from_numpy(c["ties"]).argmax(-1).numpy()
    assert list(want_argmax) == [2, 10, 7]
    for r, out in enumerate(line_run):
        np.testing.assert_allclose(out["coll/cross_entropy/nll"],
                                   per_row.detach().numpy(), rtol=0,
                                   atol=EXACT)
        np.testing.assert_allclose(out["coll/cross_entropy/nll"].mean(),
                                   float(mean.detach()), rtol=0, atol=EXACT)
        np.testing.assert_allclose(out["coll/cross_entropy/grad"],
                                   _part(logits.grad.numpy(), r), rtol=0,
                                   atol=EXACT)
        np.testing.assert_array_equal(out["coll/argmax/out"], want_argmax)


@pytest.fixture(scope="module")
def jax_decode(started):
    """The JAX package's TP-sharded jitted decode on {"tensor": 2}: (block
    logits, step logits, greedy tokens) for each decode case."""
    jm = jmesh.make_mesh({"tensor": 2}, jax.devices()[:2])
    out = {}
    for kind in ("gpt", "llama"):
        case, jmodel, jparams = _decode_case(kind)
        sp = jshard(jparams, jm, jmodel.partition_rules())
        ids = jnp.asarray(case["ids"].astype(np.int32))
        cache = jmodel.init_cache(2, max_len=12)
        block, cache = jax.jit(jmodel.decode_block)(sp, cache, ids[:, :6])
        step, cache = jax.jit(jmodel.decode_step)(sp, cache, ids[:, 6])
        greedy = jax.jit(lambda p, i: jmodel.generate(
            p, i, max_new_tokens=4, max_len=12))(sp, ids)
        out[kind] = (np.asarray(block), np.asarray(step), np.asarray(greedy))
    return out


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_tp_decode_matches_jax_and_plain(line_run, jax_decode, kind):
    block, step, greedy = jax_decode[kind]
    L = 2
    for out in line_run:
        key = f"dec/{kind}"
        for want in (block, out[f"{key}/plain/block"]):
            np.testing.assert_allclose(out[f"{key}/tp/block"], want,
                                       rtol=0, atol=DECODE_ATOL)
        for want in (step, out[f"{key}/plain/step"]):
            np.testing.assert_allclose(out[f"{key}/tp/step"], want,
                                       rtol=0, atol=DECODE_ATOL)
        np.testing.assert_array_equal(out[f"{key}/tp/greedy"], greedy)
        np.testing.assert_array_equal(out[f"{key}/plain/greedy"], greedy)
        np.testing.assert_array_equal(out[f"{key}/tp/sampled"],
                                      out[f"{key}/plain/sampled"])
        # the cache holds this rank's kv heads: half of GPT tiny's 2,
        # the Llama recipe's group of 1 of its 2 (replicated kv)
        assert int(out[f"{key}/tp/cache_heads"]) == 1
        # 10 forwards (block, step, 2 x (prefill + 3 steps)): each an
        # embedding sum and 2 a layer, one gather of the logits
        launches = {k.rsplit("/", 1)[1]: int(v) for k, v in out.items()
                    if k.startswith(f"{key}/tp/launches/")}
        assert launches == {"tp_all_reduce": 10 * (1 + 2 * L),
                            "tp_all_gather": 10}
        assert not any(k.startswith(f"{key}/plain/launches/") for k in out)


def test_tp_dropout_keeps_the_line_equal(line_run):
    a, b = line_run
    # the training forward draws the plain model's masks
    for out in line_run:
        np.testing.assert_allclose(out["dropout/tp/hidden0"],
                                   out["dropout/plain/hidden0"], rtol=0,
                                   atol=1e-5)
        assert not np.array_equal(out["dropout/tp/hidden"],
                                  out["dropout/tp/hidden0"])
    for k in ("dropout/tp/loss", "dropout/tp/hidden", "dropout/tp/ln_f",
              "dropout/tp/hidden0"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tp_chunked_loss_equals_the_unchunked(line_run):
    """``loss_seq_chunk`` under tensor parallelism (the Llama recipe's
    untied ``lm_head``, vocabulary-parallel a chunk at a time): the same
    loss, accuracy and gradients as the whole logits' loss."""
    for out in line_run:
        np.testing.assert_allclose(out["chunk/5/loss"], out["chunk/0/loss"],
                                   rtol=EXACT)
        np.testing.assert_array_equal(out["chunk/5/acc"],
                                      out["chunk/0/acc"])
        grads = [k for k in out if k.startswith("chunk/0/grad/")]
        assert len(grads) == 3 + 9 * 2
        for k in grads:
            np.testing.assert_allclose(out[k.replace("/0/", "/5/", 1)],
                                       out[k], rtol=0, atol=EXACT,
                                       err_msg=k)


def test_finetune_bert_takes_the_tp2_path(line_run):
    import re
    num = r"-?\d+\.\d{3,4}"
    for out in line_run:
        assert int(out["finetune/rc"]) == 0
        assert "mesh={'data': 1, 'tensor': 2}" in str(out["finetune/err"])
        lines = list(out["finetune/lines"])
        assert re.fullmatch(rf"mlm step 4: loss={num} acc={num}", lines[0])
        assert re.fullmatch(rf"step 25: loss={num} acc={num}", lines[1])
        assert re.fullmatch(rf"eval accuracy: {num}", lines[2])
        assert len(lines) == 3
    assert list(line_run[0]["finetune/lines"]) == list(
        line_run[1]["finetune/lines"])


# -- two TP steps on data 2 x tensor 2 --------------------------------------

STEP_CASES = ["gpt", "gqa_kv1", "gqa_kv2_shard_kv", "llama", "bert"]
# the cases held against the JAX package's step (the Llama recipe, whose
# TP parts GPT tiny and the GQA cases cover, against the plain step only:
# one JAX compile less)
JAX_CASES = ["gpt", "gqa_kv1", "gqa_kv2_shard_kv", "bert"]


def _batches(kind, vocab):
    rng = np.random.default_rng(3)
    if kind == "gpt":
        return [{"input_ids": rng.integers(0, vocab, (8, 17)).astype(
            np.int64)} for _ in range(2)]
    out = []
    for _ in range(2):
        valid = (np.arange(16)[None, :]
                 < rng.integers(9, 17, (8,))[:, None]).astype(np.int64)
        out.append({"input_ids": rng.integers(0, vocab, (8, 16)),
                    "labels": rng.integers(0, vocab, (8, 16)),
                    "mlm_mask": (rng.random((8, 16)) < 0.2).astype(
                        np.float32),
                    "attention_mask": valid})
    return out


def _step_spec():
    cases, jax_side = {}, {}
    for name in STEP_CASES:
        kind, config, shard_kv, jmodel = _cases()[name]
        jparams = _jax_params(jmodel)
        cases[name] = {"kind": kind, "config": dataclasses.asdict(config),
                       "shard_kv": shard_kv,
                       "state": _port_state(kind, config, jparams),
                       "batches": _batches(kind, config.vocab_size)}
        jax_side[name] = (kind, config, shard_kv, jmodel, jparams)
    return cases, jax_side


@pytest.fixture(scope="module")
def step_run(started, jax_decode, jax_steps):
    return started["step"]()


@pytest.fixture(scope="module")
def jax_steps(started):
    """The JAX step on ``shard_pytree(params, jmesh, rules)`` over data 2 x
    tensor 2: (each step's metrics, the port's whole parameters after
    two steps) by case."""
    cases, jax_side = _step_spec()
    jm = jmesh.make_mesh(AXES, jax.devices()[:4])
    out = {}
    for name in JAX_CASES:
        kind, config, shard_kv, jmodel, jparams = jax_side[name]
        sp = jshard(jparams, jm, _jax_rules(kind, jmodel, shard_kv))
        opt = joptim.adamw(1e-3)
        state = jtrain.TrainState.create(sp, opt.init(sp))
        loss_fn = (jmodel.mlm_loss_fn() if kind == "bert"
                   else jmodel.lm_loss_fn())
        step = jtrain.make_custom_train_step(loss_fn, opt,
                                             grad_clip_norm=1.0)
        metrics = []
        for batch in cases[name]["batches"]:
            jb = {k: jax.device_put(
                jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                            else v), NamedSharding(jm, P("data")))
                for k, v in batch.items()}
            state, m = step(state, jb)
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = (metrics, _port_state(kind, config,
                                          jax.device_get(state.params)))
    return out


def _blocks_close(out, prefix, whole, atol):
    names = [k[len(prefix) + 3:] for k in out if k.startswith(prefix + "/p/")]
    assert sorted(names) == sorted(whole)
    for name in names:
        got = out[f"{prefix}/p/{name}"]
        dim, start, length = (int(x) for x in out[f"{prefix}/layout/{name}"])
        want = whole[name]
        if dim >= 0:
            want = np.take(want, np.arange(start, start + length), axis=dim)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("name", JAX_CASES)
def test_tp_steps_match_the_jax_step(step_run, jax_steps, name):
    metrics, whole = jax_steps[name]
    for out in step_run:
        for i, jm in enumerate(metrics):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(out[f"tp/{name}/step{i}/{k}"],
                                           jm[k], rtol=LOSS_RTOL,
                                           err_msg=f"step {i} {k}")
        _blocks_close(out, f"tp/{name}", whole, PARAM_ATOL)


@pytest.mark.parametrize("name", STEP_CASES)
def test_tp_steps_match_the_plain_step(step_run, name):
    plain = step_run[0]
    whole = {k[len(f"plain/{name}/p/"):]: v for k, v in plain.items()
             if k.startswith(f"plain/{name}/p/")}
    metric_keys = [k.rsplit("/", 1)[1] for k in plain
                   if k.startswith(f"plain/{name}/step0/")
                   and "/launches/" not in k]
    assert "loss" in metric_keys
    for out in step_run:
        for i in range(2):
            for k in metric_keys:
                np.testing.assert_allclose(out[f"tp/{name}/step{i}/{k}"],
                                           plain[f"plain/{name}/step{i}/{k}"],
                                           rtol=LOSS_RTOL, atol=1e-7,
                                           err_msg=f"step {i} {k}")
        _blocks_close(out, f"tp/{name}", whole, PARAM_ATOL)


@pytest.mark.parametrize("name", STEP_CASES)
def test_tp_collectives_a_step(step_run, name):
    """Per step over L = 2 layers: GPT's embedding sum, 2 row-parallel
    sums a layer and the cross entropy's 2 all-reduces forward, 2
    column-parallel gradient sums a layer and the head's backward (4L + 4
    all-reduces) and the argmax's all-gather; BERT adds the MLM
    transform's gather and its gradient sum (4L + 5, 2 gathers); one
    stats all-reduce over the tensor line and one gradient all-reduce
    over the data line."""
    L = 2
    bert = name == "bert"
    want = {"tp_all_reduce": 4 * L + (5 if bert else 4),
            "tp_all_gather": 2 if bert else 1,
            "stats_all_reduce": 1, "all_reduce": 1}
    for out in step_run:
        for i in range(2):
            pre = f"tp/{name}/step{i}/launches/"
            got = {k[len(pre):]: int(v) for k, v in out.items()
                   if k.startswith(pre)}
            assert got == want, (i, got)
    # the ranks of a tensor line hold the same replicated leaves; those
    # of a data line the same blocks
    by = {tuple(o["coords"]): o for o in step_run}
    for k in by[(0, 0)]:
        if k.startswith(f"tp/{name}/p/"):
            layout = by[(0, 0)][k.replace("/p/", "/layout/")]
            np.testing.assert_array_equal(by[(0, 0)][k], by[(1, 0)][k])
            if layout[0] < 0:
                np.testing.assert_array_equal(by[(0, 0)][k], by[(0, 1)][k])
