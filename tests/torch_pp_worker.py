"""Ranks of the port's pipeline tests (``tests/test_torch_pipeline.py``:
``run_generic_rank``; ``tests/test_torch_pipeline_gpt.py``:
``run_gpt_rank``; ``tests/test_torch_pipeline_gpu.py``:
``run_card_rank``).  Imports neither JAX nor the JAX package, so a
spawned child starts quickly; spawned through
``torch_sp_worker.spawn_ranks`` / ``start_ranks``.

Every rank writes its results to an npz; the tests hold them against the
JAX package on an XLA CPU mesh.  A rank's gradients of stacked stage
params are its own stage's row (the JAX gradient's row at its ``pipe``
index); a GPT rank dumps the parameters it holds under their names."""
import collections
import warnings

import numpy as np
import torch
import torch.distributed as dist

from torch_sp_worker import _start

LR = 1e-3


def stage_fn(params, x):
    """The JAX test's stage: ``tanh(x @ w + b)``, promoting ``x`` to the
    weights' dtype as ``jnp.matmul`` does (a bf16 batch through f32
    stages computes in f32)."""
    x = x.to(torch.promote_types(x.dtype, params["w"].dtype))
    return torch.tanh(x @ params["w"] + params["b"])


def bf16_stage(params, x):
    """A stage computing in bf16 on any carry."""
    return torch.tanh(x.to(torch.bfloat16) @ params["w"].to(torch.bfloat16)
                      + params["b"].to(torch.bfloat16))


def mse(out, y):
    return ((out.float() - y) ** 2).mean()


def head_mse(aux, out, y):
    """A loss through a head the pipeline does not hold (``aux_params``)."""
    return ((out @ aux["head"] - y) ** 2).mean()


def _meshes(world):
    """{stage count: mesh}: on 4 ranks, S = 2 as two pipe lines of a
    ``{"pipe": 2, "data": 2}`` mesh and S = 4 as one line; on 2 ranks,
    S = 2."""
    from distributed_tensorflow_tpu_torch import parallel
    if world == 2:
        return {2: parallel.make_mesh({"pipe": 2})}
    return {2: parallel.make_mesh({"pipe": 2, "data": 2}),
            4: parallel.make_mesh({"pipe": 4})}


def _tensor(a, requires_grad=False, device="cpu"):
    t = torch.from_numpy(np.array(a))
    if t.dtype == torch.float32 and a.dtype != np.float32:
        t = t.float()
    return t.to(device).requires_grad_(requires_grad)


def _stacked(case, S, device="cpu"):
    return {k: _tensor(v, True, device)
            for k, v in case[f"stacked{S}"].items()}


def _generic(res, key, case, mesh, device="cpu"):
    """One generic case on ``mesh``: GPipe's output and the gradients of
    ``mean(out ** 2)`` (``kind`` "apply"), or the 1F1B pass (``kind``
    "1f1b"), under ``key``."""
    from distributed_tensorflow_tpu_torch.parallel import pipeline as pl
    S = mesh.axis_size("pipe")
    stacked = _stacked(case, S, device)
    x = _tensor(case["x"], True, device)
    if case.get("x_bf16"):
        x = x.detach().to(torch.bfloat16).requires_grad_(True)
    fn = bf16_stage if case.get("bf16_stage") else stage_fn
    M = case["M"]
    if case["kind"] == "apply":
        out = pl.pipeline_apply(fn, stacked, x, mesh, M)
        (out.float() ** 2).mean().backward()
        res[f"{key}/out"] = out.detach().float().cpu().numpy()
        res[f"{key}/out_dtype"] = np.array(str(out.dtype))
        for k, p in stacked.items():
            res[f"{key}/g/{k}"] = p.grad.cpu().numpy()
        res[f"{key}/dx"] = x.grad.float().cpu().numpy()
        with torch.no_grad():
            again = pl.pipeline_apply(fn, stacked, x, mesh, M)
        res[f"{key}/out_no_grad"] = again.float().cpu().numpy()
        return
    y = _tensor(case["y"], False, device)
    aux = ({"head": _tensor(case["head"], False, device)}
           if "head" in case else None)
    out = pl.pipeline_value_and_grad(
        fn, head_mse if aux is not None else mse,
        {k: v.detach() for k, v in stacked.items()}, x.detach(), y, mesh,
        M, aux_params=aux, with_dx=True,
        microbatch_weights=case.get("weights"))
    loss, grads = out[0], out[1]
    res[f"{key}/loss"] = loss.cpu().numpy()
    for k, g in grads.items():
        res[f"{key}/g/{k}"] = g.cpu().numpy()
    if aux is not None:
        res[f"{key}/aux/head"] = out[2]["head"].cpu().numpy()
    res[f"{key}/dx"] = out[-1].float().cpu().numpy()


def run_generic_rank(rank, world, port, cases, out_path):
    """Every case of ``cases`` on each of its stage counts, under
    ``<case>_S<S>/...``, with the pipeline's traffic counts under
    ``<case>_S<S>/counts/<kind>``; the ranks' ``pipe`` index under
    ``index_S<S>``; the "apply" case's forward also on this rank's
    ``[1, ...]`` blocks (``shard_pytree`` under ``pipeline_rules_spec``)
    under ``blocks/``."""
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch.parallel import pipeline as pl
        from distributed_tensorflow_tpu_torch.parallel import sharding
        res = {}
        meshes = _meshes(world)
        for S, mesh in meshes.items():
            res[f"index_S{S}"] = np.array(mesh.axis_index("pipe"))
        for name, case in cases.items():
            for S in case["stages"]:
                mesh = meshes[S]
                before = collections.Counter(pl.LAUNCHES)
                _generic(res, f"{name}_S{S}", case, mesh)
                got = collections.Counter(pl.LAUNCHES)
                got.subtract(before)
                for k, v in got.items():
                    res[f"{name}_S{S}/counts/{k}"] = np.array(v)
        blocks = cases["apply"]
        mesh = meshes[2]
        stacked = _stacked(blocks, 2)
        cut = sharding.shard_pytree(
            {k: v.detach() for k, v in stacked.items()}, mesh,
            sharding.PartitionRules([(k, s) for k, s in pl.pipeline_rules_spec(
                {k: None for k in stacked}).items()]))
        res["blocks/shape"] = np.array(cut["w"].shape)
        with torch.no_grad():
            res["blocks/out"] = pl.pipeline_apply(
                stage_fn, cut, _tensor(blocks["x"]), mesh,
                blocks["M"]).numpy()
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


# -- GPT ----------------------------------------------------------------------

def _model(config, tree, mesh, device="cpu"):
    from distributed_tensorflow_tpu_torch import GPT, GPTConfig
    from distributed_tensorflow_tpu_torch.models import convert
    model = GPT(GPTConfig(**config), device=device, mesh=mesh)
    with torch.no_grad():
        for k, v in convert.gpt_params_from_jax(
                tree, model.config, mesh=mesh).items():
            model.get_parameter(k).copy_(v)
    return model


def _rows(batch, mesh, device="cpu"):
    """This rank's rows of a global batch (by its ``data`` index)."""
    n = batch["input_ids"].shape[0] // mesh.axis_size("data")
    i = mesh.axis_index("data")
    return {k: torch.from_numpy(np.array(v[i * n:(i + 1) * n])).to(device)
            for k, v in batch.items()}


def _whole(batch, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in batch.items()}


def _dump(res, prefix, tensors):
    for k, t in tensors.items():
        res[f"{prefix}/{k}"] = t.detach().float().cpu().numpy().copy()


def _steps(res, key, config, tree, batches, mesh, schedule, device="cpu",
           ckpt=None):
    """Two ``adamw(1e-3)`` steps with clip 1.0 under ``schedule`` on this
    rank's rows: each step's loss and gradient norm, the parameters it
    holds after them, and with ``ckpt`` the state saved there (sharded)
    beside a fresh state restored from it."""
    from distributed_tensorflow_tpu_torch import (TrainState,
                                                  make_custom_train_step,
                                                  optim, train)
    model = _model(config, tree, mesh, device)
    opt = optim.adamw(LR)
    params = dict(model.named_parameters())
    state = train.shard_train_state(TrainState.create(params,
                                                      opt.init(params)),
                                    mesh, model.partition_rules())
    step = (train.make_1f1b_train_step(model, opt, grad_clip_norm=1.0)
            if schedule == "1f1b" else
            make_custom_train_step(model.lm_loss_fn(), opt, mesh=mesh,
                                   grad_clip_norm=1.0))
    for i, batch in enumerate(batches):
        state, m = step(state, _rows(batch, mesh, device))
        res[f"{key}/loss{i}"] = m["loss"].detach().cpu().numpy()
        res[f"{key}/grad_norm{i}"] = m["grad_norm"].detach().cpu().numpy()
    _dump(res, f"{key}/p", params)
    if ckpt is None:
        return
    from distributed_tensorflow_tpu_torch.train import sharded_checkpoint
    sharded_checkpoint.save_sharded(ckpt, state.step, state)
    dist.barrier()
    fresh = _model(config, tree, mesh, device)
    fp = dict(fresh.named_parameters())
    target = train.shard_train_state(TrainState.create(fp, opt.init(fp)),
                                     mesh, fresh.partition_rules())
    got = sharded_checkpoint.restore_sharded(target, ckpt + "/ckpt-"
                                             f"{state.step:010d}")
    res[f"{key}/restored_step"] = np.array(got.step)
    res[f"{key}/restored_equal"] = np.array(all(
        torch.equal(fp[k], params[k]) for k in params) and all(
        torch.equal(got.opt_state.inner[w][k], state.opt_state.inner[w][k])
        for w in ("m", "v") for k in params))
    _dump(res, f"{key}/gathered", train.gather_params(state))


def run_gpt_rank(rank, world, port, spec, out_path):
    """On ``{"pipe": 2, "data": 2}``: for each model of ``spec["models"]``
    (its config, the JAX tree, the batch) the pipelined forward, the GPipe
    loss and gradients (autograd through ``lm_loss_fn``), the 1F1B loss
    and gradients (``lm_1f1b_value_and_grad``), GPipe against 1F1B under
    dropout, the 1F1B pass's ``loss_seq_chunk`` warning, and two steps of
    each schedule (with ``spec["ckpt"]``, the first model's GPipe state
    saved there and restored)."""
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import parallel
        res = {}
        mesh = parallel.make_mesh({"pipe": 2, "data": 2})
        res["pipe_index"] = np.array(mesh.axis_index("pipe"))
        res["data_index"] = np.array(mesh.axis_index("data"))
        for n, (name, m) in enumerate(spec["models"].items()):
            config, tree, batch = m["config"], m["tree"], m["batch"]
            model = _model(config, tree, mesh)
            params = dict(model.named_parameters())
            whole = _whole(batch)
            h = model.apply(whole["input_ids"][:, :-1])
            res[f"{name}/hidden"] = h.detach().numpy()
            loss, _ = model.lm_loss_fn()(params, (), whole, None, True)
            grads = torch.autograd.grad(loss, list(params.values()))
            res[f"{name}/gpipe_loss"] = loss.detach().numpy()
            _dump(res, f"{name}/gpipe_g", dict(zip(params, grads)))
            loss1, g1 = model.lm_1f1b_value_and_grad(params, whole, None,
                                                     True)
            res[f"{name}/1f1b_loss"] = loss1.numpy()
            _dump(res, f"{name}/1f1b_g", g1)
            drop = _model(dict(config, dropout_rate=0.1), tree, mesh)
            dp = dict(drop.named_parameters())
            gen = torch.Generator().manual_seed(7)
            ld, _ = drop.lm_loss_fn()(dp, (), whole, gen, True)
            gd = torch.autograd.grad(ld, list(dp.values()))
            gen = torch.Generator().manual_seed(7)
            ld1, gd1 = drop.lm_1f1b_value_and_grad(dp, whole, gen, True)
            res[f"{name}/dropout_loss"] = np.array([float(ld.detach()),
                                                    float(ld1)])
            res[f"{name}/dropout_grad_gap"] = np.array(max(
                float((a - gd1[k]).abs().max()) for k, a in zip(dp, gd)))
            chunk = _model(dict(config, loss_seq_chunk=8), tree, mesh)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                chunk.lm_1f1b_value_and_grad(dict(chunk.named_parameters()),
                                             whole, None, True)
            res[f"{name}/chunk_warned"] = np.array(any(
                "loss_seq_chunk" in str(w.message) for w in caught))
            for schedule in ("gpipe", "1f1b"):
                ckpt = (spec["ckpt"] if n == 0 and schedule == "gpipe"
                        else None)
                _steps(res, f"{name}/steps_{schedule}", config, tree,
                       m["batches"], mesh, schedule, ckpt=ckpt)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


# -- the card -------------------------------------------------------------

def run_card_rank(rank, world, port, spec, out_path):
    """On ``{"pipe": 2}`` of two ranks sharing one card (gloo with CUDA
    tensors): GPipe and 1F1B of ``spec`` (a GPT tiny config and the
    port's whole state, numpy) on the card, each under ``<schedule>/``:
    the loss, the gradients the rank holds, the pipeline's traffic and
    the kernels' launches."""
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import GPT, GPTConfig, parallel
        from distributed_tensorflow_tpu_torch.ops.kernels import (
            flash_attention, fused)
        from distributed_tensorflow_tpu_torch.parallel import pipeline as pl
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = parallel.make_mesh({"pipe": world})
        model = GPT(GPTConfig(**spec["config"]), device="cuda", mesh=mesh)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(torch.from_numpy(spec["state"][k]))
        params = dict(model.named_parameters())
        batch = _whole(spec["batch"], "cuda")
        res = {"pipe_index": np.array(mesh.axis_index("pipe"))}
        for schedule in ("gpipe", "1f1b"):
            counters = (pl.LAUNCHES, flash_attention.LAUNCHES,
                        fused.LAUNCHES)
            for c in counters:
                c.clear()
            if schedule == "gpipe":
                loss, _ = model.lm_loss_fn()(params, (), batch, None, True)
                grads = dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))
            else:
                loss, grads = model.lm_1f1b_value_and_grad(params, batch,
                                                           None, True)
            torch.cuda.synchronize()
            res[f"{schedule}/loss"] = loss.detach().cpu().numpy()
            _dump(res, f"{schedule}/g", grads)
            for c in counters:
                for k, v in c.items():
                    res[f"{schedule}/counts/{k}"] = np.array(v)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()
