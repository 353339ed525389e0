"""The pipelined GPT and its train steps in the port, held against the JAX
package (the Llama recipe's half: ``tests/test_torch_pipeline_llama.py``,
through this file's helpers; ``train_gpt --pipeline_stages=2`` on two
ranks: ``tests/test_torch_train_gpt.py``).

GPT-2 tiny and the Llama tiny recipe at 4 layers, 2 stages of 2 layers,
4 microbatches, dropout 0 (the port's masks come from its generator, not
from ``jax.random``), f32.  The JAX side runs on the conftest's 8-device
CPU mesh; the port on 4 gloo ranks ``{"pipe": 2, "data": 2}`` (one spawn
for the module, started before the JAX side is computed; worker
``tests/torch_pp_worker.py``), every rank loading its stage's layers from
the JAX tree (``convert.gpt_params_from_jax(mesh=)``).  Tolerances: the
hidden states and gradients atol 1e-5, losses rtol 1e-5, parameters
after two AdamW steps atol 5e-5.

- The pipelined forward (``apply``), the GPipe loss and gradients
  (autograd through ``lm_loss_fn``) and the 1F1B loss and gradients
  (``lm_1f1b_value_and_grad``) of the whole batch with a ``loss_mask``
  whose counts differ between microbatches, against the JAX package's
  pipelined model: each rank's stage layers and the replicated
  embeddings, ``ln_f`` and head.  Under dropout 0.1 the port's GPipe and
  1F1B draw the same masks and agree (port against port); 1F1B warns that
  it does not apply ``loss_seq_chunk``.
- Two ``adamw(1e-3)`` steps with clip 1.0, masked, through
  ``make_custom_train_step`` (GPipe) and ``make_1f1b_train_step``
  (1F1B) over ``{"pipe": 2, "data": 2}``, against the JAX steps on the
  same mesh: each step's loss and gradient norm, and every parameter a
  rank holds after them.
- A pipe-2 sharded checkpoint of the GPipe state restores bit-equal
  onto pipe 2 (in the ranks) and onto a mesh of one, whose whole model
  equals the ranks' ``gather_params``.
- In this process: the config refusals of both packages, a stage
  model's layers (its stage's, under their global names, marked),
  ``generate`` refusing a stage model, and ``pipe`` beside ``fsdp``,
  ``tensor``, ``seq`` or ``expert`` raising with its ROADMAP item.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_tensorflow_tpu import optim as joptim
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_tpu.models.gpt import GPTConfig as JGPTConfig
from distributed_tensorflow_tpu.models.llama import llama as jllama
from distributed_tensorflow_tpu.parallel import make_mesh as jmake_mesh
from distributed_tensorflow_tpu.parallel.sharding import \
    shard_pytree as jshard
from distributed_tensorflow_tpu_torch import (GPT, GPTConfig, TrainState,
                                              gpt_tiny, optim, parallel,
                                              train)
from distributed_tensorflow_tpu_torch.models import convert
from distributed_tensorflow_tpu_torch.models.llama import llama_tiny
from distributed_tensorflow_tpu_torch.parallel import sharding
from distributed_tensorflow_tpu_torch.train import sharded_checkpoint

import torch_pp_worker
import torch_sp_worker

torch.set_num_threads(1)

ATOL, LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5, 5e-5
LAYERS, STAGES, MICRO, LR = 4, 2, 4, 1e-3


def _configs():
    """{name: (port config with the pipeline, JAX model constructor)}."""
    pp = dict(num_layers=LAYERS, dropout_rate=0.0, pipeline_stages=STAGES,
              pipeline_microbatches=MICRO)
    g = gpt_tiny(**pp)
    la = llama_tiny(**pp)

    def jgpt(mesh, **kw):
        return JGPT(JGPTConfig(**{**dict(
            vocab_size=g.vocab_size, hidden_size=g.hidden_size,
            num_heads=g.num_heads, intermediate_size=g.intermediate_size,
            max_position=g.max_position), **pp, **kw}), mesh=mesh)

    def jla(mesh, **kw):
        return jllama(mesh=mesh, **{**dict(
            vocab_size=la.vocab_size, hidden_size=la.hidden_size,
            num_heads=la.num_heads, num_kv_heads=la.num_kv_heads,
            intermediate_size=la.intermediate_size,
            max_position=la.max_position), **pp, **kw})
    return {"gpt2": (g, jgpt), "llama": (la, jla)}


def _batch(seed, vocab, b=8, s=16):
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, s)) < 0.6).astype(np.float32)
    mask[:2] = 1.0                      # microbatch 0's count differs
    return {"input_ids": rng.integers(0, vocab, (b, s + 1)).astype(np.int32),
            "loss_mask": mask}


def _jax_side(tree, jbuild, batch, batches):
    jm = jmake_mesh({"pipe": STAGES}, jax.devices()[:STAGES])
    model = jbuild(jm)
    params = jax.tree.map(jnp.asarray, tree)
    jb = jax.tree.map(jnp.asarray, batch)
    rng = jax.random.PRNGKey(1)
    hidden = jax.jit(lambda p, ids: model.apply(p, ids))(
        params, jb["input_ids"][:, :-1])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.lm_loss_fn()(p, None, jb, rng, True)[0]))(params)
    loss1, grads1 = jax.jit(lambda p: model.lm_1f1b_value_and_grad(
        p, jb, rng, True))(params)
    out = {"hidden": np.asarray(hidden), "gpipe_loss": float(loss),
           "gpipe_g": jax.tree.map(np.asarray, grads),
           "1f1b_loss": float(loss1),
           "1f1b_g": jax.tree.map(np.asarray, grads1)}
    jm4 = jmake_mesh({"pipe": STAGES, "data": 2}, jax.devices()[:4])
    pm = jbuild(jm4)
    for schedule in ("gpipe", "1f1b"):
        opt = joptim.adamw(LR)
        p = jshard(jax.tree.map(jnp.asarray, tree), jm4,
                   pm.partition_rules())
        state = jtrain.TrainState.create(p, opt.init(p))
        step = (jtrain.make_1f1b_train_step(pm, opt, grad_clip_norm=1.0,
                                            jit=False)
                if schedule == "1f1b" else jtrain.make_custom_train_step(
                    pm.lm_loss_fn(), opt, grad_clip_norm=1.0, jit=False))

        def two(state, b0, b1):
            # both steps in one program: one compile
            state, m0 = step(state, b0)
            state, m1 = step(state, b1)
            return state.params, [m0, m1]
        params_after, ms = jax.jit(two)(state, *[
            {k: jax.device_put(jnp.asarray(v), NamedSharding(jm4, P("data")))
             for k, v in b.items()} for b in batches])
        out[f"steps_{schedule}"] = (
            [(float(m["loss"]), float(m["grad_norm"])) for m in ms],
            jax.tree.map(np.asarray, params_after))
    return out


def spawn_and_compare(tmp_path_factory, names, ckpt=True):
    """The ranks' outputs and the JAX side of the models ``names``: (rank
    outputs, {name: JAX results}, {name: spec}, the checkpoint dir or
    None)."""
    ckpt = str(tmp_path_factory.mktemp("pp_ckpt")) if ckpt else None
    configs = _configs()
    specs, jax_inputs = {}, {}
    for n, name in enumerate(names):
        config, jbuild = configs[name]
        # the weights of the port's plain model, in the JAX tree's layout
        plain = dataclasses.replace(config, pipeline_stages=0,
                                    pipeline_microbatches=0)
        tree = convert.gpt_params_to_jax(dict(GPT(
            plain, device="cpu").named_parameters()), plain)
        batch = _batch(10 + n, config.vocab_size)
        batches = [_batch(20 + n + i, config.vocab_size) for i in range(2)]
        specs[name] = {"config": dataclasses.asdict(config), "tree": tree,
                       "batch": batch, "batches": batches}
        jax_inputs[name] = (tree, jbuild, batch, batches)
    join = torch_sp_worker.start_ranks(
        tmp_path_factory.mktemp("pp_gpt"), torch_pp_worker.run_gpt_rank,
        ({"models": specs, "ckpt": ckpt},), world=4)
    ref = {name: _jax_side(*args) for name, args in jax_inputs.items()}
    return join(), ref, specs, ckpt


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_and_compare(tmp_path_factory, ["gpt2"])


def _port(tree, config):
    """{port name: numpy} of a JAX tree (parameters or gradients)."""
    return {k: v.numpy() for k, v in
            convert.gpt_params_from_jax(tree, config).items()}


def _held(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items()
            if k.startswith(prefix + "/")}


def check_forward_loss_and_grads(ranks, name):
    outs, ref, specs, _ = ranks
    want = ref[name]
    config = GPTConfig(**specs[name]["config"])
    for schedule in ("gpipe", "1f1b"):
        wg = _port(want[f"{schedule}_g"], config)
        for r, res in enumerate(outs):
            np.testing.assert_allclose(res[f"{name}/hidden"], want["hidden"],
                                       atol=ATOL, rtol=0)
            np.testing.assert_allclose(float(res[f"{name}/{schedule}_loss"]),
                                       want[f"{schedule}_loss"],
                                       rtol=LOSS_RTOL)
            got = _held(res, f"{name}/{schedule}_g")
            stage = int(res["pipe_index"])
            assert {k for k in got if k.startswith("blocks.")} == {
                f"blocks.{i}.{p}" for i in range(2 * stage, 2 * stage + 2)
                for p in {k.split(".", 2)[2] for k in wg
                          if k.startswith("blocks.")}}
            for k, g in got.items():
                np.testing.assert_allclose(g, wg[k], atol=ATOL, rtol=0,
                                           err_msg=f"{schedule} {k} {r}")


def check_same_dropout(ranks, name):
    outs, _, _, _ = ranks
    for res in outs:
        ld, ld1 = res[f"{name}/dropout_loss"]
        np.testing.assert_allclose(ld1, ld, rtol=LOSS_RTOL)
        assert float(res[f"{name}/dropout_grad_gap"]) <= ATOL
        assert bool(res[f"{name}/chunk_warned"])


def check_two_masked_steps(ranks, name, schedule):
    outs, ref, specs, _ = ranks
    metrics, jparams = ref[name][f"steps_{schedule}"]
    want = _port(jparams, GPTConfig(**specs[name]["config"]))
    key = f"{name}/steps_{schedule}"
    for r, res in enumerate(outs):
        for i, (loss, gnorm) in enumerate(metrics):
            np.testing.assert_allclose(float(res[f"{key}/loss{i}"]), loss,
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(float(res[f"{key}/grad_norm{i}"]),
                                       gnorm, rtol=LOSS_RTOL)
        for k, v in _held(res, f"{key}/p").items():
            np.testing.assert_allclose(v, want[k], atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{k} rank {r}")


def test_forward_loss_and_grads_equal_jax(ranks):
    check_forward_loss_and_grads(ranks, "gpt2")


def test_gpipe_and_1f1b_draw_the_same_dropout(ranks):
    check_same_dropout(ranks, "gpt2")


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_two_masked_steps_equal_the_jax_steps(ranks, schedule):
    check_two_masked_steps(ranks, "gpt2", schedule)


def test_pipe2_checkpoint_restores_on_pipe2_and_on_one(ranks):
    outs, _, specs, ckpt = ranks
    key = "gpt2/steps_gpipe"
    for res in outs:
        assert int(res[f"{key}/restored_step"]) == 2
        assert bool(res[f"{key}/restored_equal"])
    path, = sharded_checkpoint.all_sharded_checkpoints(ckpt)
    assert sharded_checkpoint.verify_sharded(path) == (True, "")
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["process_count"] == 4
    config = dataclasses.replace(GPTConfig(**specs["gpt2"]["config"]),
                                 pipeline_stages=0, pipeline_microbatches=0)
    model = GPT(config, device="cpu")
    params = dict(model.named_parameters())
    opt = optim.adamw(LR)
    target = TrainState.create(params, opt.init(params))
    state = sharded_checkpoint.restore_sharded(target, path)
    assert state.step == 2 and state.opt_state.count == 2
    whole = _held(outs[0], f"{key}/gathered")
    assert sorted(whole) == sorted(params)
    for k, p in params.items():
        np.testing.assert_array_equal(p.detach().numpy(), whole[k], k)


def _virtual(axes, r=0):
    n = int(np.prod(list(axes.values())))
    return parallel.Mesh(n, r, None, axes=parallel.plan_mesh(axes, n),
                         lines={})


def test_config_refusals_in_both_packages():
    for kw, match in ((dict(num_layers=5, pipeline_stages=4),
                       "not divisible"),
                      (dict(num_layers=4, pipeline_stages=4,
                            moe_experts=2), "MoE"),
                      (dict(num_layers=4, pipeline_stages=4,
                            seq_axis="seq"), "seq_axis")):
        with pytest.raises(ValueError, match=match):
            JGPTConfig(**kw)
        with pytest.raises(ValueError, match=match):
            GPTConfig(**kw)
    with pytest.raises(ValueError, match="mesh"):
        GPT(gpt_tiny(num_layers=4, pipeline_stages=2), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        GPT(gpt_tiny(num_layers=4, pipeline_stages=2), device="cpu",
            mesh=_virtual({"pipe": 4}))
    plain = GPT(gpt_tiny(num_layers=4), device="cpu")
    with pytest.raises(ValueError, match="pipeline_stages > 1"):
        plain.lm_1f1b_value_and_grad(dict(plain.named_parameters()),
                                     {"input_ids": torch.zeros(2, 5)})


@pytest.mark.parametrize("axes, item", [
    ({"pipe": 2, "fsdp": 2}, "7.3a"), ({"pipe": 2, "tensor": 2}, "7.3b"),
    ({"pipe": 2, "seq": 2}, "7.3c"), ({"pipe": 2, "expert": 2}, "7.3d")])
def test_pipe_beside_another_axis_raises(axes, item):
    config = gpt_tiny(num_layers=4, pipeline_stages=2)
    mesh = _virtual(axes)
    with pytest.raises(NotImplementedError, match=item):
        sharding.check_mesh(mesh)
    with pytest.raises(NotImplementedError, match=item):
        GPT(config, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match=item):
        train.make_custom_train_step(lambda *a: None, optim.adamw(1e-3),
                                     mesh=mesh)


@pytest.mark.parametrize("r", [0, 1])
def test_stage_model_holds_its_layers(r):
    config = gpt_tiny(num_layers=4, pipeline_stages=2)
    whole = dict(GPT(gpt_tiny(num_layers=4), device="cpu").named_parameters())
    model = GPT(config, device="cpu", mesh=_virtual({"pipe": 2}, r))
    held = dict(model.named_parameters())
    layers = {int(k.split(".")[1]) for k in held if k.startswith("blocks.")}
    assert layers == {2 * r, 2 * r + 1}
    assert set(held) == {k for k in whole if not k.startswith("blocks.")
                         or int(k.split(".")[1]) in layers}
    rules = model.partition_rules()
    for k, p in held.items():
        assert torch.equal(p, whole[k]), k
        assert sharding.marked_shard(p) == rules.stage_for(k)
    assert rules.stage_for("blocks.3.ln_1.gamma") == sharding.Stage(
        3, 4, 1, "pipe")
    # the converter gives a rank its stage's layers
    tree = convert.gpt_params_to_jax(whole, gpt_tiny(num_layers=4))
    assert set(convert.gpt_params_from_jax(
        tree, config, mesh=_virtual({"pipe": 2}, r))) == set(held)
    with pytest.raises(ValueError, match="gather_params"):
        model.generate(torch.zeros(1, 4, dtype=torch.long), 2)
