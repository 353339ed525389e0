"""GPT-2, Llama and BERT with ``seq_axis`` in the port, held against the JAX
models on an XLA CPU mesh of the same shape.

Four spawned gloo ranks (once for the module, ``torch_sp_worker``) run:

- forwards on a ``{"seq": 4}`` mesh: GPT-2 tiny (learned positions) and
  Llama tiny (RoPE, GQA 4q/2kv) hidden and logits, BERT tiny's sequence
  output and pooled ``[CLS]`` with an ``attention_mask`` that leaves one
  row's last shard all padding, against the JAX ``GPT(config, mesh)`` /
  ``Bert(config, mesh)`` on a 4-device mesh (its plain ring off a TPU;
  the port's ring-flash runs the kernels' plain versions): within 1e-4;
- two ``adamw`` steps (clip 1.0) on a ``{"data": 2, "seq": 2}`` mesh,
  each data rank its 2 rows of a batch of 4: GPT-2 tiny under remat
  "full" with a ``loss_mask`` whose counts differ by rank, Llama tiny
  under remat "dots" (the ring runs again in the recomputation), BERT tiny MLM
  with and without the gathered head, and BERT tiny under ``sgd`` on a
  loss of the pooled ``[CLS]`` of ``apply``'s gathered output (the
  pooler after the gather, the encoder before it); metrics and
  parameters within 1e-4 of the JAX step on the same mesh, one
  all-reduce a step;
- the repair of this slice: on a ``{"data": 4}`` mesh a masked mean
  (GPT-2 ``loss_mask``, counts 31, 5, 17 and 1 a rank) is the global
  batch's, as the JAX step computes it on the whole batch; the mean of
  the ranks' means was not.

Also, in this process: the config checks (``moe_experts`` with
``seq_axis``, a missing mesh, a sequence that does not split, a step over
a ``tensor`` axis) and a ring
of one equal to the model without ``seq_axis``.  Dropout is 0 throughout
(its bits come from each rank's generator, not ``jax.random``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.models import llama as jllama
from distributed_tensorflow_tpu.optim import optimizers as jopt
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.train.session import TrainState as JState
from distributed_tensorflow_tpu.train.step import \
    make_custom_train_step as jmake_step
from distributed_tensorflow_tpu_torch import (GPT, GPTConfig, gpt_tiny,
                                              load_jax_params, parallel)
from distributed_tensorflow_tpu_torch.models import bert as tbert
from distributed_tensorflow_tpu_torch.models.convert import (
    bert_params_from_jax, bert_params_to_jax, gpt_params_to_jax)

import torch_sp_worker

torch.set_num_threads(1)

TOL = 1e-4
_GPT_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
               "intermediate_size", "max_position", "layer_norm_eps",
               "num_kv_heads", "position_embedding", "rope_base", "norm",
               "ffn_activation", "use_bias", "tied_head")
_BERT = dict(hidden_size=64, num_layers=2, num_heads=2,
             intermediate_size=128, vocab_size=200, max_position=64,
             dropout_rate=0.0)


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmesh.make_mesh(axes, jax.devices()[:n])


_GPT2_TINY = dict(hidden_size=128, num_layers=2, num_heads=2,
                  intermediate_size=512, vocab_size=512, max_position=128)


def _jgpt(kind, mesh, **kw):
    if kind == "llama":
        return jllama.llama_tiny(mesh=mesh, dropout_rate=0.0, **kw)
    return jgpt.GPT(jgpt.GPTConfig(dropout_rate=0.0, **_GPT2_TINY, **kw),
                    mesh=mesh)


def _gpt_entry(kind, jparams):
    """The port's config kwargs and state dict (numpy) of a JAX GPT."""
    jc = _jgpt(kind, None).config
    kw = {f: getattr(jc, f) for f in _GPT_FIELDS}
    model = load_jax_params(GPT(GPTConfig(dropout_rate=0.0, **kw),
                                device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    return ({"dropout_rate": 0.0, **kw},
            {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()})


def _ids(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _bert_batch(seed, b, s, valid_lengths):
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, s)) < 0.3).astype(np.float32)
    mask[0, :] = 0.0
    mask[0, [1, 5]] = 1.0                 # counts differ by data rank
    return {"input_ids": _ids(seed, b, s, 200),
            "labels": _ids(seed + 1, b, s, 200), "mlm_mask": mask,
            "attention_mask": (np.arange(s)[None]
                               < np.asarray(valid_lengths)[:, None]
                               ).astype(np.int32)}


def _gpt_batches(seed, masked, counts=(31, 5, 17, 1)):
    out = []
    for i in range(2):
        batch = {"input_ids": _ids(seed + i, 4, 33, 512)}
        if masked:
            mask = np.zeros((4, 32), np.float32)
            for row, n in enumerate(counts):
                mask[row, np.random.default_rng(seed + row).permutation(
                    32)[:n]] = 1.0
            batch["loss_mask"] = mask
        out.append(batch)
    return out


def _spec():
    key = jax.random.PRNGKey(0)
    forward, train, jax_train = {}, {}, {}
    for kind in ("gpt2", "llama"):
        jparams = _jgpt(kind, None).init(key)
        config, state = _gpt_entry(kind, jparams)
        forward[kind] = {"kind": "gpt", "config": config, "state": state,
                         "ids": _ids(7, 2, 32, 512), "jparams": jparams}
    jb = jbert.Bert(jbert.BertConfig(**_BERT))
    bparams = jb.init(key)
    bstate = {k: v.detach().numpy() for k, v in bert_params_from_jax(
        jax.tree.map(np.asarray, bparams),
        tbert.BertConfig(**_BERT)).items()}
    # row 1's last 8 keys are padding: the whole last shard of the ring
    valid = (np.arange(32)[None] < np.array([[32], [24]])).astype(np.int32)
    forward["bert"] = {"kind": "bert", "config": _BERT, "state": bstate,
                       "ids": _ids(8, 2, 32, 200), "valid": valid,
                       "jparams": bparams}
    sp = {"data": 2, "seq": 2}
    for name, kind, kw, masked in (("gpt2_remat", "gpt2", {"remat": True},
                                    True),
                                   ("llama_dots", "llama",
                                    {"remat": True, "remat_policy": "dots"},
                                    False)):
        jparams = _jgpt(kind, None).init(jax.random.PRNGKey(1))
        config, state = _gpt_entry(kind, jparams)
        train[name] = {"kind": "gpt", "config": {**config, **kw},
                       "state": state, "rows": 2, "axes": sp,
                       "batches": _gpt_batches(20, masked)}
        jax_train[name] = (kind, kw, jparams)
    for name, gather in (("bert", 0), ("bert_gather", 3)):
        config = {**_BERT, "mlm_predictions_per_seq": gather}
        train[name] = {"kind": "bert", "config": config, "state": bstate,
                       "rows": 2, "axes": sp, "batches": [
                           _bert_batch(30 + i, 4, 16, [16, 12, 16, 7])
                           for i in range(2)]}
        jax_train[name] = ("bert", config, bparams)
    rng = np.random.default_rng(50)
    train["bert_pooled"] = {
        "kind": "bert_pooled", "config": _BERT, "state": bstate, "rows": 2,
        "axes": sp, "batches": [
            {**{k: v for k, v in _bert_batch(50 + i, 4, 16,
                                             [16, 12, 16, 7]).items()
                if k in ("input_ids", "attention_mask")},
             "target": rng.uniform(-1, 1, (4, 64)).astype(np.float32)}
            for i in range(2)]}
    jax_train["bert_pooled"] = ("bert_pooled", _BERT, bparams)
    jparams = _jgpt("gpt2", None).init(jax.random.PRNGKey(2))
    config, state = _gpt_entry("gpt2", jparams)
    train["gpt2_dp_masked"] = {"kind": "gpt", "config": config,
                               "state": state, "rows": 1,
                               "axes": {"data": 4},
                               "batches": _gpt_batches(40, True)}
    jax_train["gpt2_dp_masked"] = ("gpt2", {}, jparams)
    return forward, train, jax_train


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    forward, train, jax_train = _spec()
    ship = {"forward": {k: {n: v for n, v in f.items() if n != "jparams"}
                        for k, f in forward.items()},
            "train": train}
    ranks = torch_sp_worker.spawn_ranks(
        tmp_path_factory.mktemp("sp_models"),
        torch_sp_worker.run_models_rank, (ship,))
    return forward, train, jax_train, ranks


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", ["gpt2", "llama", "bert"])
def test_forward_equals_the_jax_mesh(runs, name):
    forward, _, _, ranks = runs
    f = forward[name]
    mesh = _jmesh({"seq": 4})
    if f["kind"] == "gpt":
        jm = _jgpt(name, mesh, seq_axis="seq")
        hidden = jm.apply(f["jparams"], jnp.asarray(f["ids"]))
        extra = ("logits", jm.logits(f["jparams"], hidden))
    else:
        jm = jbert.Bert(jbert.BertConfig(seq_axis="seq", **_BERT),
                        mesh=mesh)
        hidden = jm.apply(f["jparams"], jnp.asarray(f["ids"]),
                          attention_mask=jnp.asarray(f["valid"]))
        extra = ("pooled", jm.pooled(f["jparams"], hidden))
    for r in ranks:
        _close(r[f"{name}_hidden"], hidden, f"{name} hidden")
        _close(r[f"{name}_{extra[0]}"], extra[1], f"{name} {extra[0]}")
        assert np.all(np.isfinite(r[f"{name}_hidden"]))


def _jax_steps(name, t, spec):
    kind, kw, jparams = spec
    jparams = jax.tree.map(jnp.copy, jparams)   # the step donates its state
    mesh = _jmesh(t["axes"])
    seq = {"seq_axis": "seq"} if "seq" in t["axes"] else {}
    if kind == "bert":
        jm = jbert.Bert(jbert.BertConfig(**kw, **seq), mesh=mesh)
        opt = jopt.adamw(1e-3)
        loss_fn = jm.mlm_loss_fn()
    elif kind == "bert_pooled":
        jm = jbert.Bert(jbert.BertConfig(**kw, **seq), mesh=mesh)
        opt = jopt.sgd(0.1)

        def loss_fn(params, model_state, batch, rng, train):
            pooled = jm.pooled(params, jm.apply(
                params, batch["input_ids"],
                attention_mask=batch["attention_mask"]))
            return jnp.mean((pooled - batch["target"]) ** 2), (
                {}, model_state)
    else:
        jm = _jgpt(kind, mesh, **kw, **seq)
        opt = jopt.adamw(1e-3)
        loss_fn = jm.lm_loss_fn()
    step = jmake_step(loss_fn, opt, grad_clip_norm=1.0)
    state = JState.create(jparams, opt.init(jparams))
    metrics = []
    for batch in t["batches"]:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append(m)
    return state.params, metrics


@pytest.mark.parametrize("name", ["gpt2_remat", "llama_dots", "bert",
                                  "bert_gather", "bert_pooled",
                                  "gpt2_dp_masked"])
def test_two_adamw_steps_equal_the_jax_step(runs, name):
    _, train, jax_train, ranks = runs
    t = train[name]
    want_params, want_metrics = _jax_steps(name, t, jax_train[name])
    for r in ranks:
        assert int(r[f"{name}_all_reduces"]) == 2
        for i, jm in enumerate(want_metrics):
            got = {k[len(f"{name}_step{i}_"):] for k in r
                   if k.startswith(f"{name}_step{i}_")}
            assert got == set(jm), (got, set(jm))
            for k in jm:
                want = jm[k]
                if k == "mlm_overflow":
                    want = _weighted_overflow(t, i)
                _close(r[f"{name}_step{i}_{k}"], want, f"{name} {i} {k}")
        params = {k[len(f"{name}_param_"):]: torch.from_numpy(v)
                  for k, v in r.items() if k.startswith(f"{name}_param_")}
        if t["kind"].startswith("bert"):
            tree = bert_params_to_jax(params, tbert.BertConfig(
                **t["config"]))
        else:
            tree = gpt_params_to_jax(params, GPTConfig(**t["config"]))
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves(want_params)):
            _close(a, b, f"{name} {jax.tree_util.keystr(path)}")


def _weighted_overflow(t, i):
    """``mlm_overflow`` as the port's step reports it over data ranks:
    like every metric, the ranks' values averaged with their loss weights
    (a deliberate difference: the JAX step on the whole batch reports the
    batch's count)."""
    mask = t["batches"][i]["mlm_mask"]
    n = t["config"]["mlm_predictions_per_seq"]
    rows = t["rows"]
    num = den = 0.0
    for lo in range(0, mask.shape[0], rows):
        part = mask[lo:lo + rows]
        kept = np.minimum(part.sum(1), n).sum()
        num += kept * (part.sum() - kept)
        den += kept
    return num / den


def test_config_checks():
    mesh = parallel.make_mesh({"seq": 1})
    with pytest.raises(NotImplementedError, match="moe_experts"):
        gpt_tiny(seq_axis="seq", moe_experts=4)
    with pytest.raises(ValueError, match="mesh"):
        GPT(gpt_tiny(seq_axis="seq"), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        GPT(gpt_tiny(seq_axis="seq"), device="cpu",
            mesh=parallel.make_mesh({"data": 1}))
    with pytest.raises(ValueError, match="mesh"):
        tbert.Bert(tbert.BertConfig(seq_axis="seq", **_BERT))
    model = GPT(gpt_tiny(seq_axis="seq", dropout_rate=0.0), device="cpu",
                mesh=mesh)
    assert model.apply(torch.zeros(1, 5, dtype=torch.long)).shape == (
        1, 5, 128)
    four = parallel.Mesh(4, 1, None, axes={"seq": 4}, lines={})
    model.mesh = four
    with pytest.raises(ValueError, match="not divisible"):
        model.apply(torch.zeros(1, 6, dtype=torch.long))
    # the step takes data, fsdp, seq, tensor and expert; tensor beside seq
    # runs (tests/test_torch_tp_sp.py trains it), beside seq and fsdp at
    # once it is not ported (7.5), nor expert beside seq (7.2d)
    from distributed_tensorflow_tpu_torch import adamw, make_custom_train_step
    assert callable(make_custom_train_step(
        model.lm_loss_fn(), adamw(1e-3), mesh=parallel.Mesh(
            4, 0, None, axes={"seq": 2, "tensor": 2}, lines={})))
    with pytest.raises(NotImplementedError, match="7.5"):
        make_custom_train_step(model.lm_loss_fn(), adamw(1e-3),
                               mesh=parallel.Mesh(8, 0, None,
                                                  axes={"fsdp": 2, "seq": 2,
                                                        "tensor": 2},
                                                  lines={}))
    with pytest.raises(NotImplementedError, match="expert"):
        make_custom_train_step(model.lm_loss_fn(), adamw(1e-3),
                               mesh=parallel.Mesh(4, 0, None,
                                                  axes={"expert": 2,
                                                        "seq": 2},
                                                  lines={}))


def test_ring_of_one_equals_the_model_without_seq_axis():
    """On a mesh of one the ring is the plain flash on the whole sequence:
    hidden, loss and gradients equal the model without ``seq_axis``."""
    mesh = parallel.make_mesh({"seq": 1})
    gen = torch.Generator().manual_seed(3)
    dense = GPT(gpt_tiny(dropout_rate=0.0, num_kv_heads=1), device="cpu",
                generator=gen)
    sp = GPT(gpt_tiny(dropout_rate=0.0, num_kv_heads=1, seq_axis="seq"),
             device="cpu", mesh=mesh)
    sp.load_state_dict(dense.state_dict())
    ids = torch.from_numpy(_ids(5, 2, 17, 512))
    mask = torch.from_numpy((np.random.default_rng(6).random((2, 16))
                             < 0.5).astype(np.float32))
    out = []
    for model in (dense, sp):
        params = dict(model.named_parameters())
        loss, (m, _) = model.lm_loss_fn()(
            params, (), {"input_ids": ids, "loss_mask": mask}, None, True)
        grads = torch.autograd.grad(loss, list(params.values()))
        out.append((model.apply(ids).detach(), loss.detach(),
                    {k: v.detach() for k, v in m.items()}, grads))
    _close(out[1][0], out[0][0], "hidden")
    _close(out[1][1], out[0][1], "loss")
    for k in out[0][2]:
        _close(out[1][2][k], out[0][2][k], k)
    for a, b in zip(out[1][3], out[0][3]):
        _close(a, b, "grad")
