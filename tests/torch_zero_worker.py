"""Ranks of the port's ZeRO tests (``tests/test_torch_zero.py``:
``run_zero_rank``; ``tests/test_torch_sharded_checkpoint.py``:
``run_ckpt_rank``).  Imports neither JAX nor the JAX package, so a
spawned child starts quickly; spawned through ``torch_sp_worker.
spawn_ranks``.

Every rank writes its results to an npz; the tests hold them against the
JAX package on an XLA CPU mesh.  A state is dumped whole (every block
gathered over the ``fsdp`` line) as ``<prefix>/<keystr path>`` entries of
the JAX tree, so it compares leaf by leaf with a JAX state."""
import numpy as np
import torch
import torch.distributed as dist

from torch_sp_worker import _start

LR, DECAY = 1e-3, 0.99


def _model(state):
    from distributed_tensorflow_tpu_torch import GPT, gpt_tiny
    model = GPT(gpt_tiny(dropout_rate=0.0), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in state.items()})
    return model


def _optimizer():
    from distributed_tensorflow_tpu_torch import optim
    return optim.with_ema(optim.adamw(LR), DECAY)


def _zero_state(model, mesh):
    from distributed_tensorflow_tpu_torch import TrainState, train
    params = dict(model.named_parameters())
    opt = _optimizer()
    state = TrainState.create(params, opt.init(params))
    return train.shard_train_state(state, mesh,
                                   model.partition_rules(fsdp=True))


def _whole(tree):
    """``tree`` with every cut ``ShardedDict`` gathered into whole
    tensors (a collective over its line)."""
    from distributed_tensorflow_tpu_torch.parallel import (data_parallel,
                                                           sharding)
    if isinstance(tree, sharding.ShardedDict) and tree.cut:
        return data_parallel.gather_shards(tree, tree.layout, tree.mesh)
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_whole(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_whole(v) for v in tree)
    return tree


def dump_state(res, prefix, state):
    """The whole state as ``<prefix>/<keystr path>`` arrays of the JAX
    tree (bf16 through its bits, as the checkpoints store it)."""
    from distributed_tensorflow_tpu_torch.models import convert
    from distributed_tensorflow_tpu_torch.train import checkpoint
    tree = convert.train_state_to_jax(_whole(state),
                                      leaf=lambda t: t.detach().cpu(),
                                      stack=torch.stack)
    for path, t in checkpoint._flatten(tree):
        res[f"{prefix}/{path}"] = checkpoint._stored(t)[0]


def _rows(batch, mesh):
    n = batch.shape[0] // (mesh.axis_size("data") * mesh.axis_size("fsdp"))
    return torch.from_numpy(batch[mesh.data_index * n:
                                  (mesh.data_index + 1) * n])


def _steps(res, key, state, step, batches, mesh, plant=None):
    """Run ``step`` over the global ``batches`` (this rank's rows):
    each step's metrics as ``<key>_step<i>_<metric>``."""
    for i, ids in enumerate(batches):
        batch = {"input_ids": _rows(ids, mesh)}
        if plant is not None:
            batch["plant"] = torch.tensor(plant[i])
        state, m = step(state, batch)
        for k, v in m.items():
            res[f"{key}_step{i}_{k}"] = v.detach().float().numpy()
    return state


def _planted(loss_fn, name):
    """``loss_fn`` plus ``params[name][0, 0] * batch["plant"]``: an inf
    plant puts a non-finite gradient into element [0, 0] of ``name`` on
    this rank alone (the block of rank 0 of the fsdp line)."""
    def fn(params, model_state, batch, generator, train):
        batch = dict(batch)
        plant = batch.pop("plant")
        loss, aux = loss_fn(params, model_state, batch, generator, train)
        return loss + params[name][0, 0] * plant, aux
    return fn


def run_zero_rank(rank, world, port, spec, out_path):
    """On the mesh of ``spec["axes"]``: (zero) two ZeRO steps of
    ``with_ema(adamw)`` with clip 1.0 and device health from
    ``spec["state"]`` over ``spec["batches"]``, the collectives issued,
    the whole state after them; (dp) the same steps on the plain state
    (the replicated data-parallel step); (skip) a ZeRO step with
    ``skip_nonfinite`` whose gradient holds an inf in rank 0's block of
    ``blocks.0.ffn.w_in.kernel`` only: its metrics and whether each
    parameter block kept its values."""
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import (TrainState,
                                                      make_custom_train_step,
                                                      parallel)
        from distributed_tensorflow_tpu_torch.parallel import data_parallel
        res = {}
        mesh = parallel.make_mesh(spec["axes"])
        model = _model(spec["state"])
        state = _zero_state(model, mesh)
        step = make_custom_train_step(model.lm_loss_fn(), _optimizer(),
                                      mesh=mesh, grad_clip_norm=1.0,
                                      device_health=True)
        data_parallel.LAUNCHES.clear()
        state = _steps(res, "zero", state, step, spec["batches"], mesh)
        for k, v in data_parallel.LAUNCHES.items():
            res[f"zero_collectives_{k}"] = np.array(v)
        dump_state(res, "zero", state)

        model = _model(spec["state"])
        params = dict(model.named_parameters())
        opt = _optimizer()
        plain = TrainState.create(params, opt.init(params))
        step = make_custom_train_step(model.lm_loss_fn(), opt, mesh=mesh,
                                      grad_clip_norm=1.0, device_health=True)
        plain = _steps(res, "dp", plain, step, spec["batches"], mesh)
        dump_state(res, "dp", plain)

        model = _model(spec["state"])
        state = _zero_state(model, mesh)
        before = {k: t.clone() for k, t in state.params.items()}
        name = "blocks.0.ffn.w_in.kernel"
        step = make_custom_train_step(
            _planted(model.lm_loss_fn(), name), _optimizer(), mesh=mesh,
            grad_clip_norm=1.0, device_health=True, skip_nonfinite=True)
        plant = [float("inf") if rank == 0 else 0.0, 0.0]
        state = _steps(res, "skip", state, step, spec["batches"][:1], mesh,
                       plant)
        res["skip_kept"] = np.array(all(
            torch.equal(before[k], t) for k, t in state.params.items()))
        res["skip_count"] = np.array(state.opt_state.count)
        res["skip_step"] = np.array(state.step)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def run_ckpt_rank(rank, world, port, spec, out_path):
    """On the mesh of ``spec["axes"]``, for each job of ``spec["jobs"]``
    in order, from a fresh ZeRO state of ``spec["state"]``: ``("train",
    dir)``: one ZeRO step, then a sharded save to ``dir`` (the whole
    state dumped as ``train``); ``("restore", dir, key, save_dir)``: a
    restore from ``dir``'s newest checkpoint, dumped as ``key`` and
    saved again to ``save_dir`` when one is given."""
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import (make_custom_train_step,
                                                      parallel)
        from distributed_tensorflow_tpu_torch.train import \
            sharded_checkpoint as sc
        res = {}
        mesh = parallel.make_mesh(spec["axes"])
        for job in spec["jobs"]:
            model = _model(spec["state"])
            state = _zero_state(model, mesh)
            if job[0] == "train":
                step = make_custom_train_step(model.lm_loss_fn(),
                                              _optimizer(), mesh=mesh,
                                              grad_clip_norm=1.0)
                state = _steps(res, "train", state, step,
                               spec["batches"][:1], mesh)
                sc.save_sharded(job[1], state.step, state,
                                sync_fn=dist.barrier)
                dump_state(res, "train", state)
                continue
            _, src, key, save_dir = job
            state = sc.restore_sharded(state,
                                       sc.all_sharded_checkpoints(src)[-1])
            dump_state(res, key, state)
            if save_dir is not None:
                sc.save_sharded(save_dir, state.step, state,
                                sync_fn=dist.barrier)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()
