"""The layouts of ``tensor`` beside ``seq`` in the port, on virtual ranks
(``parallel.Mesh`` without a process group; no gloo):

- ``check_mesh`` accepts ``{"seq": 2, "tensor": 2}`` and ``{"data": 2,
  "seq": 2, "tensor": 2}``; ``seq`` beside ``fsdp`` (with or without
  ``tensor``), ``pipe`` beside ``seq`` and ``expert`` beside ``seq`` still
  raise, naming their ROADMAP items (7.5, 7.3c, 7.2d), as do a MoE config
  with ``seq_axis`` (7.4) and the int8 cache, the paged entries and LoRA
  under a tensor axis beside ``seq`` (7.2b);
- ``data_parallel.replicas`` of a tensor mesh lists the ``seq`` line (the
  ranks that hold the same blocks over other positions) and counts it;
  before this slice it listed the ``data`` line alone, so each seq rank
  updated its blocks from its own shard;
- the step's dropout stream folds the ``seq`` coordinate and not the
  ``tensor`` one;
- a GPT and a BERT built on rank 3 keep the blocks the JAX table cuts
  for tensor index 1 (the same on both ranks of a seq line), the
  converters place the JAX package's whole weights as those blocks, and
  ``shard_train_state`` lays the state out over the tensor line alone;
- a sharded checkpoint's boxes are written once: each tensor block by
  the first rank of its seq line, a whole leaf by the chief."""
import dataclasses

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import (GPT, TrainState, gpt_tiny,
                                              optim, parallel, train)
from distributed_tensorflow_tpu_torch.models import bert as tbert
from distributed_tensorflow_tpu_torch.models import convert
from distributed_tensorflow_tpu_torch.models.llama import llama_tiny
from distributed_tensorflow_tpu_torch.parallel import data_parallel
from distributed_tensorflow_tpu_torch.parallel import sharding
from distributed_tensorflow_tpu_torch.train import sharded_checkpoint
from distributed_tensorflow_tpu_torch.train import step as step_lib

torch.set_num_threads(1)

TSP = {"seq": 2, "tensor": 2}
DTSP = {"data": 2, "seq": 2, "tensor": 2}


def _virtual(axes, r, lines=None, group=None):
    """Rank r of a mesh of ``axes`` without a process group; ``lines``
    and ``group`` stand-ins for its lines' groups and the world's."""
    n = int(np.prod(list(axes.values())))
    return parallel.Mesh(n, r, group, axes=parallel.plan_mesh(axes, n),
                         lines=lines or {})


@pytest.mark.parametrize("axes", [TSP, DTSP], ids=str)
def test_check_mesh_accepts_tensor_beside_seq(axes):
    n = int(np.prod(list(axes.values())))
    for r in range(n):
        sharding.check_mesh(_virtual(axes, r))


@pytest.mark.parametrize("axes, item", [
    ({"fsdp": 2, "seq": 2, "tensor": 2}, "7.5"),
    ({"fsdp": 2, "seq": 2}, "7.5"),
    ({"pipe": 2, "seq": 2}, "7.3c"),
    ({"expert": 2, "seq": 2}, "7.2d"),
    ({"expert": 2, "seq": 2, "tensor": 2}, "7.2d")], ids=str)
def test_what_stays_refused(axes, item):
    mesh = _virtual(axes, 0)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        sharding.check_mesh(mesh)
    model = GPT(gpt_tiny(), device="cpu")
    params = dict(model.named_parameters())
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        train.shard_train_state(TrainState.create(params, {}), mesh,
                                model.partition_rules(fsdp=True))


def test_serving_paths_and_moe_stay_refused():
    mesh = _virtual(TSP, 0)
    with pytest.raises(NotImplementedError, match="item 7.4"):
        gpt_tiny(seq_axis="seq", moe_experts=2)
    with pytest.raises(NotImplementedError, match="item 7.2b"):
        GPT(gpt_tiny(seq_axis="seq", kv_cache_dtype="int8"), device="cpu",
            mesh=mesh)
    model = GPT(gpt_tiny(seq_axis="seq", dropout_rate=0.0), device="cpu",
                mesh=mesh)
    with pytest.raises(NotImplementedError, match="item 7.2b"):
        model.decode_window_paged({}, torch.zeros(1, 2, dtype=torch.long),
                                  torch.zeros(2, dtype=torch.int32), 0)
    with pytest.raises(NotImplementedError, match="item 7.2b"):
        model.decode_window(model.init_cache(1, 8),
                            torch.zeros(1, 2, dtype=torch.long),
                            adapters={}, adapter_rows=torch.zeros(1))


@pytest.mark.parametrize("axes, want", [
    (TSP, (("seq-line",), 2)),
    (DTSP, (("seq-line", "data-line"), 4)),
    ({"data": 2, "tensor": 2}, (("data-line",), 2))], ids=str)
def test_replicas_list_the_seq_line(axes, want):
    """The gradient mean beside ``tensor`` runs over the seq line too:
    its ranks hold the same blocks, and the sequence ops scale their
    gradients for a mean over it."""
    lines = {a: f"{a}-line" for a in axes if axes[a] > 1}
    mesh = _virtual(axes, 0, lines, group="world")
    assert data_parallel.replicas(mesh) == want
    assert data_parallel.batch_group(mesh) == want[0]


def test_dropout_stream_folds_seq_not_tensor():
    n = 8
    streams = {}
    for r in range(n):
        mesh = _virtual(DTSP, r, group="world")
        coords = tuple(mesh.axis_index(a) for a in ("data", "seq",
                                                    "tensor"))
        streams[coords] = step_lib._replica(mesh)
    for d in range(2):
        for s in range(2):
            assert streams[(d, s, 0)] == streams[(d, s, 1)]
    assert len({streams[(d, s, 0)] for d in range(2) for s in range(2)}) == 4
    # a tensor line alone draws the plain step's stream
    assert step_lib._replica(_virtual({"tensor": 2}, 1,
                                      group="world")) is None


def _bert_config():
    return tbert.BertConfig(hidden_size=64, num_layers=2, num_heads=2,
                            intermediate_size=128, vocab_size=512,
                            max_position=32, seq_axis="seq")


def test_models_on_rank_3_keep_the_tables_blocks():
    """Rank 3 of ``{"seq": 2, "tensor": 2}`` sits at seq 1, tensor 1: its
    blocks are tensor index 1's of the whole model, those of rank 1 (seq
    0) too; the converters place the same blocks from a JAX tree, and the
    placed state is cut over the tensor line alone."""
    rank3, rank1 = _virtual(TSP, 3), _virtual(TSP, 1)
    assert (rank3.axis_index("seq"), rank3.axis_index("tensor")) == (1, 1)
    for config, shard_kv in ((gpt_tiny(seq_axis="seq"), None),
                             (llama_tiny(seq_axis="seq"), True),
                             (llama_tiny(seq_axis="seq",
                                         num_kv_heads=1), None)):
        def build(mesh):
            return GPT(config, device="cpu", mesh=mesh, shard_kv=shard_kv,
                       generator=torch.Generator().manual_seed(0))
        model, other = build(rank3), build(rank1)
        whole = dict(GPT(dataclasses.replace(config, seq_axis=None),
                         device="cpu", generator=torch.Generator()
                         .manual_seed(0)).named_parameters())
        rules = model.partition_rules()
        params = dict(model.named_parameters())
        tree = convert.gpt_params_to_jax(whole, model.config)
        placed = convert.gpt_params_from_jax(tree, model.config, mesh=rank3,
                                             shard_kv=shard_kv)
        for name, p in params.items():
            want = whole[name].detach()
            for d, (lo, n) in enumerate(sharding.block_of(
                    want.shape, rules.spec_for(name), rank3)):
                want = want.narrow(d, lo, n)
            assert torch.equal(p.detach(), want), name
            assert torch.equal(p.detach(), other.get_parameter(name)
                               .detach()), name
            assert torch.equal(placed[name], want), name
        opt = optim.adamw(1e-3)
        state = train.shard_train_state(
            TrainState.create(params, opt.init(params)), rank3, rules)
        assert state.params.line == "tensor"
        assert all(state.params[k] is params[k] for k in params)
        assert state.params.layout["word"] == sharding.Shard(
            0, 256, 256, 512, "tensor")
        assert state.opt_state.inner["m"].layout == state.params.layout
    bert = tbert.Bert(_bert_config(), rank3)
    full = tbert.Bert(dataclasses.replace(_bert_config(), seq_axis=None))
    init = full.init(torch.Generator().manual_seed(0))
    blocks = bert.init(torch.Generator().manual_seed(0))
    jtree = convert.bert_params_to_jax(init, bert.config)
    placed = convert.bert_params_from_jax(jtree, bert.config, mesh=rank3)
    for name, p in blocks.items():
        s = sharding.marked_shard(p)
        want = init[name].detach() if s is None else s.take(init[name])
        assert torch.equal(p.detach(), want), name
        assert torch.equal(placed[name].detach(), want), name
    assert sharding.marked_shard(blocks["mlm.output_bias"]) == \
        sharding.Shard(0, 256, 256, 512, "tensor")


def test_checkpoint_boxes_are_written_once():
    """Over the four ranks every leaf of the placed state (parameters and
    Adam's moments, in the JAX tree's stacked paths) is owned exactly
    once, element for element."""
    config = gpt_tiny(seq_axis="seq")
    owned = {}
    for r in range(4):
        mesh = _virtual(TSP, r)
        model = GPT(config, device="cpu", mesh=mesh)
        params = dict(model.named_parameters())
        opt = optim.adamw(1e-3)
        state = train.shard_train_state(
            TrainState.create(params, opt.init(params)), mesh,
            model.partition_rules())
        pieces = train.checkpoint._flatten(
            sharded_checkpoint._pieces(state, r, with_data=False))
        for path, pc in pieces:
            if not isinstance(pc, sharded_checkpoint._Piece):
                continue
            total, seen = owned.setdefault(path, [int(np.prod(pc.shape)),
                                                  0])
            if pc.owner:
                # a tensor block's owner sits at seq 0
                assert mesh.axis_index("seq") == 0, path
                owned[path][1] += int(np.prod(pc.chunk))
    assert owned and all(total == seen for total, seen in owned.values())
