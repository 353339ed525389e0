"""The cases and the JAX side of the port's expert-parallel tests
(``tests/test_torch_expert.py``, ``tests/test_torch_expert_tp.py``): the
MoE GPT's inputs, the JAX package's step on a mesh with the router
jitter off, and the checks of the ranks' two steps against it."""
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_tensorflow_tpu import optim as joptim
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu.models import gpt as jgpt_mod
from distributed_tensorflow_tpu.ops import moe as jmoe
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel.sharding import \
    shard_pytree as jshard
from distributed_tensorflow_tpu_torch import GPT, gpt_tiny, parallel
from distributed_tensorflow_tpu_torch.models import convert
from distributed_tensorflow_tpu_torch.ops import moe as tmoe

LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-5
D, F, E = 16, 32, 4


def virtual(axes, r=0):
    """Rank r of a mesh of ``axes`` without a process group."""
    n = int(np.prod(list(axes.values())))
    return parallel.Mesh(n, r, None, axes=parallel.plan_mesh(axes, n),
                         lines={})


def jax_path(name):
    """(JAX tree path, stacked over layers) of a port GPT parameter."""
    if name in ("word", "position"):
        return f"embeddings/{name}", False
    if name.startswith("blocks."):
        return "decoder/" + name.split(".", 2)[2].replace(".", "/"), True
    return name.replace(".", "/"), False


def port_state(config, jparams):
    """The port's whole parameters (numpy, port names) of a JAX tree."""
    return {k: v.detach().numpy()
            for k, v in convert.gpt_params_from_jax(jparams, config).items()}


def moe_case():
    """A bank of 4 experts (d 16, f 32) and 4 groups of 8 tokens (drawn
    by the port's ``init_moe``: the JAX package's draws op by op, slowly,
    on the CPU)."""
    params = {g: {k: v.numpy() for k, v in sub.items()} for g, sub in
              tmoe.init_moe(torch.Generator().manual_seed(0), D, F,
                            E).items()}
    rng = np.random.default_rng(0)
    return {"params": params,
            "x": rng.standard_normal((4, 8, D)).astype(np.float32),
            "dy": rng.standard_normal((4, 8, D)).astype(np.float32)}


def _models(**port):
    """(the port's config, the JAX model): ``gpt_tiny`` with 4 experts,
    dropout off; ``port`` sets more of the port's config (``remat``,
    which recomputes the same values and leaves the JAX side as it
    is)."""
    return (gpt_tiny(moe_experts=4, dropout_rate=0.0, **port),
            jgpt_mod.gpt_tiny(moe_experts=4, dropout_rate=0.0))


def _batches():
    rng = np.random.default_rng(3)
    return [{"input_ids": rng.integers(0, 512, (8, 17)).astype(np.int64)}
            for _ in range(2)]


def whole_state():
    """The MoE GPT's whole parameters (numpy, port names), drawn by the
    port's ``GPT`` from seed 0."""
    config, _ = _models()
    return {k: v.detach().numpy().copy() for k, v in
            GPT(config, device="cpu").state_dict().items()}


def step_case(axes, **port):
    """A case of ``torch_ep_worker.run_moe_step_rank``: the MoE GPT
    (``_models(**port)``) trained two steps over ``axes``."""
    config, _ = _models(**port)
    return {"axes": axes, "config": dataclasses.asdict(config),
            "state": whole_state(), "batches": _batches()}


def jax_steps(axes):
    """The JAX step (adamw 1e-3, clip 1.0, the router jitter off) on
    ``shard_pytree(params, jmesh, rules)`` over ``axes``, the batch cut
    over ``data`` when the mesh has it: (each step's metrics, the port's
    whole parameters after two steps)."""
    config, jmodel = _models()
    jparams = convert.gpt_params_to_jax(
        {k: torch.from_numpy(v) for k, v in whole_state().items()}, config)
    jm = jmesh.make_mesh(axes, jax.devices()[:int(np.prod(list(
        axes.values())))])
    sp = jshard(jparams, jm, jmodel.partition_rules())
    opt = joptim.adamw(1e-3)
    state = jtrain.TrainState.create(sp, opt.init(sp))
    saved = jgpt_mod.apply_moe
    jgpt_mod.apply_moe = functools.partial(jmoe.apply_moe, jitter=0.0)
    try:
        step = jtrain.make_custom_train_step(jmodel.lm_loss_fn(), opt,
                                             grad_clip_norm=1.0)
        batch_spec = P("data") if "data" in axes else P()
        metrics = []
        for batch in _batches():
            jb = {k: jax.device_put(jnp.asarray(v.astype(np.int32)),
                                    NamedSharding(jm, batch_spec))
                  for k, v in batch.items()}
            state, m = step(state, jb)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jgpt_mod.apply_moe = saved
    return metrics, port_state(config, jax.device_get(state.params))


def step_launches(out, name, i):
    """{kind: count} of the collectives of step ``i`` of case ``name`` on
    a rank."""
    return {k.rsplit("/", 1)[1]: int(v) for k, v in out.items()
            if k.startswith(f"ep/{name}/step{i}/launches/")}


def blocks_close(out, prefix, whole, atol):
    """Every block ``<prefix>/p/<name>`` of a rank equals its box of the
    whole parameters."""
    names = [k[len(prefix) + 3:] for k in out if k.startswith(prefix + "/p/")]
    assert sorted(names) == sorted(whole)
    for name in names:
        want = whole[name]
        for d, (start, length) in enumerate(out[f"{prefix}/box/{name}"]):
            want = np.take(want, np.arange(start, start + length), axis=d)
        np.testing.assert_allclose(out[f"{prefix}/p/{name}"], want, rtol=0,
                                   atol=atol, err_msg=name)


def check_steps(outs, jax_side, name, axes):
    """Every rank's two steps of case ``name`` against the JAX step (the
    loss, ``moe_aux`` and the norm within LOSS_RTOL, the blocks within
    PARAM_ATOL) and against rank 0's plain step; every rank of a line
    reports the same loss."""
    jmetrics, jwhole = jax_side
    plain = outs[0]
    pwhole = {k[len(f"plain/{name}/p/"):]: v for k, v in plain.items()
              if k.startswith(f"plain/{name}/p/")}
    for r, out in enumerate(outs):
        for i in range(2):
            for k in ("loss", "moe_aux", "grad_norm"):
                got = float(out[f"ep/{name}/step{i}/{k}"])
                np.testing.assert_allclose(got, jmetrics[i][k],
                                           rtol=LOSS_RTOL, err_msg=(k, i, r))
                np.testing.assert_allclose(
                    got, float(plain[f"plain/{name}/step{i}/{k}"]),
                    rtol=LOSS_RTOL, err_msg=(k, i, r))
        blocks_close(out, f"ep/{name}", jwhole, PARAM_ATOL)
        blocks_close(out, f"ep/{name}", pwhole, PARAM_ATOL)
    for i in range(2):
        losses = {float(o[f"ep/{name}/step{i}/loss"]) for o in outs}
        assert len(losses) == 1, losses
