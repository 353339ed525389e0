"""The cases and the JAX side of the port's tests of seq2seq under tensor
parallelism and of ``tensor`` beside ``fsdp`` (``tests/
test_torch_seq2seq_tp.py``, ``tests/test_torch_tp_fsdp.py``, ``tests/
test_torch_tp_fsdp_models.py``): the models' inputs, the JAX package's
step on ``shard_pytree(params, jmesh, rules)`` over an XLA CPU mesh, and
the checks of the ranks' steps against it."""
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_tensorflow_tpu import optim as joptim
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.models import seq2seq as jseq2seq
from distributed_tensorflow_tpu.models import vit as jvit
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.models.llama import llama_tiny as jllama
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel.sharding import \
    shard_pytree as jshard
from distributed_tensorflow_tpu_torch import gpt_tiny
from distributed_tensorflow_tpu_torch.models import bert as tbert
from distributed_tensorflow_tpu_torch.models import convert
from distributed_tensorflow_tpu_torch.models import seq2seq as tseq2seq
from distributed_tensorflow_tpu_torch.models import vit as tvit
from distributed_tensorflow_tpu_torch.models.llama import llama_tiny

import expert_cases

LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-5
VOCAB, SRC, TGT = 128, 8, 6


def seq2seq_config():
    """The port's ``seq2seq_tiny`` config, dropout off."""
    return tseq2seq.seq2seq_tiny(dropout_rate=0.0).config


def seq2seq_jax_model():
    return jseq2seq.seq2seq_tiny(dropout_rate=0.0)


def seq2seq_jax_path(name):
    """(JAX tree path, stacked over layers) of a port seq2seq name."""
    head, _, rest = name.partition(".")
    if head in ("encoder", "decoder"):
        return f"{head}/" + rest.split(".", 1)[1].replace(".", "/"), True
    return name.replace(".", "/"), False


@functools.lru_cache(maxsize=None)
def _seq2seq_tree():
    config = seq2seq_config()
    return convert.seq2seq_params_to_jax(
        tseq2seq.Seq2Seq(config).init(torch.Generator().manual_seed(0)),
        config)


def seq2seq_params():
    """A ``seq2seq_tiny`` JAX tree (numpy leaves), drawn by the port's
    ``init`` from seed 0 (the JAX package's draws op by op, slowly, on
    the CPU); a fresh copy each call."""
    return jax.tree.map(np.copy, _seq2seq_tree())


def seq2seq_batches(masked, seed=3):
    """Two batches of 8 rows: source [8, 8], target [8, 6]; ``masked``:
    with a ``src_valid`` padding plane and a ``loss_mask``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        b = {"src_ids": rng.integers(1, VOCAB, (8, SRC)).astype(np.int64),
             "tgt_ids": rng.integers(1, VOCAB, (8, TGT)).astype(np.int64)}
        if masked:
            b["src_valid"] = (np.arange(SRC)[None, :] < rng.integers(
                3, SRC + 1, (8,))[:, None]).astype(np.int64)
            b["loss_mask"] = (rng.random((8, TGT - 1)) < 0.7).astype(
                np.float32)
        out.append(b)
    return out


def seq2seq_case(masked=False):
    """A case of ``torch_tpf_worker``: the port config, the JAX tree and
    two batches."""
    return {"config": dataclasses.asdict(seq2seq_config()),
            "params": seq2seq_params(), "batches": seq2seq_batches(masked)}


def _device_batch(batch, jm):
    return {k: jax.device_put(jnp.asarray(v.astype(np.int32)
                                          if v.dtype == np.int64 else v),
                              NamedSharding(jm, P()))
            for k, v in batch.items()}


def jax_steps(axes, jmodel, params, rules, loss_fn, opt, batches,
              to_port):
    """The JAX step (clip 1.0) on ``shard_pytree(params, jmesh, rules)``
    over ``axes``: (each step's metrics, the port's whole parameters
    after the steps, via ``to_port(tree)``)."""
    n = int(np.prod(list(axes.values())))
    jm = jmesh.make_mesh(axes, jax.devices()[:n])
    sp = jshard(params, jm, rules)
    state = jtrain.TrainState.create(sp, opt.init(sp))
    step = jtrain.make_custom_train_step(loss_fn, opt, grad_clip_norm=1.0)
    metrics = []
    for batch in batches:
        if isinstance(batch, tuple):
            jb = tuple(_device_batch({"a": a}, jm)["a"] for a in batch)
        else:
            jb = _device_batch(batch, jm)
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, to_port(jax.device_get(state.params))


def seq2seq_whole(tree):
    """The port's whole seq2seq parameters (numpy) of a JAX tree."""
    return {k: v.detach().numpy() for k, v in
            convert.seq2seq_params_from_jax(tree, seq2seq_config()).items()}


def seq2seq_jax_steps(axes, masked, opt, fsdp):
    jmodel = seq2seq_jax_model()
    return jax_steps(axes, jmodel, seq2seq_params(),
                     jmodel.partition_rules(fsdp=fsdp),
                     jmodel.seq2seq_loss_fn(), opt, seq2seq_batches(masked),
                     seq2seq_whole)


def check_steps(outs, jax_side, prefix, keys):
    """Every rank's two steps under ``prefix`` against the JAX step: the
    metrics ``keys`` within LOSS_RTOL, the blocks within PARAM_ATOL; every
    rank reports the same loss."""
    jmetrics, jwhole = jax_side
    for r, out in enumerate(outs):
        for i, jm in enumerate(jmetrics):
            for k in keys:
                np.testing.assert_allclose(
                    float(out[f"{prefix}/step{i}/{k}"]), jm[k],
                    rtol=LOSS_RTOL, err_msg=(k, i, r))
        expert_cases.blocks_close(out, prefix, jwhole, PARAM_ATOL)
    for i in range(len(jmetrics)):
        assert len({float(o[f"{prefix}/step{i}/loss"]) for o in outs}) == 1


def launches(out, prefix, i):
    """{kind: count} of the collectives of step ``i`` under ``prefix``."""
    pre = f"{prefix}/step{i}/launches/"
    return {k[len(pre):]: int(v) for k, v in out.items()
            if k.startswith(pre)}


def tp_all_reduces(enc, dec):
    """A seq2seq step's tensor-line all-reduces: forward the two
    embeddings, 2 row-parallel sums an encoder layer and 3 a decoder
    layer, the cross entropy's 2; backward 2 column-parallel gradient
    sums an encoder layer and 3 a decoder layer, the memory's one and the
    head's one."""
    return 2 * (2 * enc + 3 * dec) + 6


# -- GPT-2, the Llama recipe, BERT and ViT ---------------------------------

def _gpt_batches(vocab):
    rng = np.random.default_rng(3)
    return [{"input_ids": rng.integers(0, vocab, (8, 17)).astype(np.int64)}
            for _ in range(2)]


def _bert_batches(vocab):
    rng = np.random.default_rng(3)
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


def model_cases():
    """{name: (the worker's case, the JAX side's arguments)}: GPT-2 tiny,
    the Llama recipe tiny (GQA 4:2, kv replicated over the tensor line),
    BERT tiny and ViT tiny, dropout off; the JAX package draws the
    weights from PRNGKey(0), as ``tests/test_torch_tp.py`` draws them
    (ViT's the port, as ``tests/test_torch_tp_vision.py``)."""
    out = {}
    for name, config, jmodel in (
            ("gpt2", gpt_tiny(dropout_rate=0.0), jgpt_tiny(dropout_rate=0.0)),
            ("llama", llama_tiny(), jllama(dropout_rate=0.0))):
        jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))

        def to_port(tree, config=config):
            return {k: v.detach().numpy() for k, v in
                    convert.gpt_params_from_jax(tree, config).items()}
        batches = _gpt_batches(config.vocab_size)
        out[name] = ({"kind": "gpt", "config": dataclasses.asdict(config),
                      "state": to_port(jparams), "batches": batches},
                     (jmodel, jparams, jmodel.lm_loss_fn(), batches,
                      to_port))
    config = tbert.bert_tiny(dropout_rate=0.0).config
    jmodel = jbert.bert_tiny(dropout_rate=0.0)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))

    def bert_port(tree):
        return {k: v.detach().numpy() for k, v in
                convert.bert_params_from_jax(tree, config).items()}
    batches = _bert_batches(config.vocab_size)
    out["bert"] = ({"kind": "bert", "config": dataclasses.asdict(config),
                    "state": bert_port(jparams), "batches": batches},
                   (jmodel, jparams, jmodel.mlm_loss_fn(), batches,
                    bert_port))
    vmodel = tvit.vit_tiny(num_heads=2)
    vparams = convert.vit_params_to_jax(
        vmodel.init(torch.Generator().manual_seed(0)),
        vmodel.config)
    jmodel = jvit.vit_tiny(num_heads=2)
    rng = np.random.default_rng(5)
    batches = [(rng.random((8, 32, 32, 3), np.float32),
                rng.integers(0, 10, 8).astype(np.int64)) for _ in range(2)]

    def vit_port(tree):
        return {k: v.detach().numpy() for k, v in
                convert.vit_params_from_jax(tree, vmodel.config).items()}
    out["vit"] = ({"kind": "vit", "config": dataclasses.asdict(vmodel.config),
                   "params": vparams, "batches": batches},
                  (jmodel, vparams, jmodel.loss_fn(), batches, vit_port))
    return out


def model_jax_steps(axes, jax_args):
    jmodel, jparams, loss_fn, batches, to_port = jax_args
    return jax_steps(axes, jmodel, jparams, jmodel.partition_rules(fsdp=True),
                     loss_fn, joptim.adamw(1e-3), batches, to_port)
