"""Ranks of the port's expert-parallel and vision tensor-parallel tests
(``tests/test_torch_expert.py``, ``tests/test_torch_expert_tp.py``,
``tests/test_torch_tp_vision.py``, ``tests/test_torch_tp_resnet.py``).
Imports neither JAX nor the JAX package, so a spawned child starts
quickly; spawned through ``torch_sp_worker.start_ranks``.

Every rank writes its results to an npz; the tests hold them against the
JAX package on an XLA CPU mesh and against the port's plain model.  A
rank's parameters are dumped as its blocks beside their box
(``<prefix>/box/<name>``: one (start, length) row a dim)."""
import functools
import pickle

import numpy as np
import torch
import torch.distributed as dist

from torch_sp_worker import _start
from torch_tp_worker import _counts, _kernel_counts, _since

LR = 1e-3


def park(path, spec):
    """Write ``spec`` to ``path`` (a pickle) and return the path: a rank
    takes the path, not the spec, because a spawned child reads its
    arguments from a pipe only once it has started, so a parent writing
    megabytes of weights there waits for each child in turn."""
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    return str(path)


def _spec(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _no_jitter():
    """The router jitter off (its bits differ from ``jax.random``'s)."""
    from distributed_tensorflow_tpu_torch.models import gpt as tgpt
    from distributed_tensorflow_tpu_torch.ops import moe as tmoe
    tgpt.apply_moe = functools.partial(tmoe.apply_moe, jitter=0.0)


def _box(shape, s):
    """[(start, length)] a dim of a leaf of ``shape`` (this rank's block
    shape) under the layout entry ``s``."""
    from distributed_tensorflow_tpu_torch.parallel import sharding
    box = [[0, n] for n in shape]
    if s is not None and not isinstance(s, sharding.Stage):
        for p in s.parts:
            box[p.dim] = [p.start, p.length]
    return np.array(box, np.int64).reshape(len(shape), 2)


def _dump(res, prefix, params, layout):
    for name, t in params.items():
        res[f"{prefix}/p/{name}"] = t.detach().float().cpu().numpy().copy()
        res[f"{prefix}/box/{name}"] = _box(tuple(t.shape), layout.get(name))


def _record(res, key, i, metrics, before):
    for k, v in metrics.items():
        res[f"{key}/step{i}/{k}"] = v.detach().float().cpu().numpy()
    for k, v in _since(before).items():
        res[f"{key}/step{i}/launches/{k}"] = np.array(v)


def _rows(arrays, mesh, device="cpu"):
    """This rank's rows of a global batch (a dict or a tuple of arrays;
    all of them without a mesh): its index over ``data`` x ``fsdp``."""
    from distributed_tensorflow_tpu_torch.parallel import data_shards
    items = arrays.items() if isinstance(arrays, dict) else enumerate(arrays)
    n = len(next(iter(arrays.values())) if isinstance(arrays, dict)
            else arrays[0])
    i = 0
    if mesh is not None:
        n //= data_shards(mesh)
        i = mesh.data_index
    out = {k: torch.from_numpy(np.ascontiguousarray(v[i * n:(i + 1) * n]))
           .to(device) for k, v in items}
    return out if isinstance(arrays, dict) else tuple(out.values())


# -- apply_moe on an expert line ---------------------------------------------

def _moe_run(res, key, c, mesh):
    """``apply_moe`` of the case's bank on ``mesh`` (None: the whole bank):
    output, metrics, and the gradients of ``sum(y * dy) + aux_loss +
    router_z_loss`` for x and this rank's leaves."""
    from distributed_tensorflow_tpu_torch.ops import moe as tmoe
    from distributed_tensorflow_tpu_torch.parallel import (PartitionRules,
                                                           shard_pytree)
    tree = {g: {k: torch.from_numpy(v.copy()) for k, v in sub.items()}
            for g, sub in c["params"].items()}
    if mesh is not None:
        tree = shard_pytree(tree, mesh,
                            PartitionRules(tmoe.moe_partition_rules()))
    for sub in tree.values():
        for t in sub.values():
            t.requires_grad_(True)
    x = torch.from_numpy(c["x"]).requires_grad_(True)
    before = _counts()
    y, m = tmoe.apply_moe(tree, x, k=2, capacity_factor=2.0, mesh=mesh)
    loss = ((y * torch.from_numpy(c["dy"])).sum() + m["aux_loss"]
            + m["router_z_loss"])
    loss.backward()
    res[f"{key}/y"] = y.detach().numpy()
    for k, v in m.items():
        res[f"{key}/{k}"] = v.detach().numpy()
    res[f"{key}/grad/x"] = x.grad.numpy()
    for g, sub in tree.items():
        for k, t in sub.items():
            res[f"{key}/grad/{g}/{k}"] = t.grad.numpy()
    for k, v in _since(before).items():
        res[f"{key}/launches/{k}"] = np.array(v)


# -- MoE GPT steps -----------------------------------------------------------

def _moe_gpt(case, mesh, device="cpu"):
    from distributed_tensorflow_tpu_torch import GPT, GPTConfig, optim
    from distributed_tensorflow_tpu_torch.parallel import sharding
    model = GPT(GPTConfig(**case["config"]), device=device, mesh=mesh)
    whole = {k: torch.from_numpy(v.copy()).to(device)
             for k, v in case["state"].items()}
    if mesh is not None:
        whole = sharding.shard_pytree(whole, mesh, model.partition_rules())
    model.load_state_dict(whole)
    params = dict(model.named_parameters())
    return model, params, optim.adamw(LR)


def _moe_train(res, key, case, mesh, device="cpu", ckpt=None):
    """Two steps of ``adamw(1e-3)`` with clip 1.0 of the case's MoE GPT
    over ``mesh`` (None: the plain model on the whole batch); with
    ``ckpt``, a sharded checkpoint of the state after them, restored
    into a fresh placed state (``<key>/restored``), and the gathered
    parameters (``<key>/gathered``)."""
    from distributed_tensorflow_tpu_torch import (TrainState,
                                                  make_custom_train_step,
                                                  train)
    from distributed_tensorflow_tpu_torch.train import sharded_checkpoint
    model, params, opt = _moe_gpt(case, mesh, device)
    state = TrainState.create(params, opt.init(params))
    if mesh is not None:
        state = train.shard_train_state(state, mesh, model.partition_rules())
    step = make_custom_train_step(model.lm_loss_fn(), opt, mesh=mesh,
                                  grad_clip_norm=1.0)
    for i, batch in enumerate(case["batches"]):
        before = _counts()
        state, m = step(state, _rows(batch, mesh, device))
        _record(res, key, i, m, before)
    layout = getattr(state.params, "layout", {})
    _dump(res, key, dict(state.params), layout)
    if ckpt is None:
        return
    before = _counts()
    gathered = train.gather_params(state)
    res[f"{key}/gathered/launches"] = np.array(
        _since(before).get("all_gather", 0))
    for k, v in gathered.items():
        res[f"{key}/gathered/{k}"] = v.detach().float().cpu().numpy()
    sharded_checkpoint.save_sharded(ckpt, 2, state)
    dist.barrier()
    model2, params2, opt2 = _moe_gpt(case, mesh, device)
    fresh = train.shard_train_state(
        TrainState.create(params2, opt2.init(params2)), mesh,
        model2.partition_rules())
    restored = sharded_checkpoint.restore_sharded(
        fresh, sharded_checkpoint.all_sharded_checkpoints(ckpt)[-1])
    res[f"{key}/restored/step"] = np.array(int(restored.step))
    same = [torch.equal(restored.params[n], state.params[n])
            for n in state.params]
    moments = restored.opt_state.inner["m"]
    same += [torch.equal(moments[n], state.opt_state.inner["m"][n])
             for n in moments]
    res[f"{key}/restored/equal"] = np.array(all(same))
    res[f"{key}/restored/same_tensors"] = np.array(all(
        restored.params[n] is params2[n] for n in params2))
    # with_ema's shadow gathers whole too: after one step its debiased
    # value is the parameters themselves
    from distributed_tensorflow_tpu_torch import optim
    model3, params3, _ = _moe_gpt(case, mesh, device)
    opt3 = optim.with_ema(optim.adamw(LR), 0.9)
    ema_state = train.shard_train_state(
        TrainState.create(params3, opt3.init(params3)), mesh,
        model3.partition_rules())
    step3 = make_custom_train_step(model3.lm_loss_fn(), opt3, mesh=mesh)
    ema_state, _ = step3(ema_state, _rows(case["batches"][0], mesh, device))
    ema = optim.ema_params(ema_state.opt_state)
    whole = train.gather_params(ema_state)
    res[f"{key}/ema/shapes"] = np.array(all(
        ema[n].shape == whole[n].shape == gathered[n].shape for n in whole))
    res[f"{key}/ema/gap"] = np.array(max(
        float((ema[n] - whole[n]).abs().max()) for n in whole))


def run_moe_step_rank(rank, world, port, spec, out_path):
    """With ``spec["line"]``, ``apply_moe`` of that case on an ``expert``
    line of ``world`` ranks (``ep/``) and, on every rank, on the whole
    bank (``plain/``); then every case of ``spec["cases"]`` (its own
    ``axes``) trained two steps over its mesh (``ep/<case>``), with the
    checkpoint round trip where the case names ``ckpt``; on rank 0 also
    plainly on the whole batch (``plain/<case>``)."""
    spec = _spec(spec)
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import parallel
        _no_jitter()
        res = {}
        if "line" in spec:
            mesh = parallel.make_mesh({"expert": world})
            _moe_run(res, "ep", spec["line"], mesh)
            _moe_run(res, "plain", spec["line"], None)
        for name, case in spec.get("cases", {}).items():
            mesh = parallel.make_mesh(case["axes"])
            _moe_train(res, f"ep/{name}", case, mesh, ckpt=case.get("ckpt"))
            if rank == 0:
                _moe_train(res, f"plain/{name}", case, None)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


# -- ViT and ResNet ------------------------------------------------------------

def _vit_train(res, key, case, mesh, rules_fsdp=False, device="cpu"):
    """Two steps of ``adamw(1e-3)`` with clip 1.0 of the case's ViT over
    ``mesh`` (None: the plain model on the whole batch): tensor-parallel
    on a tensor axis, ZeRO (``partition_rules(fsdp=True)``) on fsdp."""
    from distributed_tensorflow_tpu_torch import (TrainState,
                                                  make_custom_train_step,
                                                  optim, train)
    from distributed_tensorflow_tpu_torch.models import convert
    from distributed_tensorflow_tpu_torch.models.vit import ViT, ViTConfig
    model = ViT(ViTConfig(**case["config"]), mesh=mesh)
    params = convert.vit_params_from_jax(case["params"], model.config,
                                         device=device, mesh=mesh)
    opt = optim.adamw(LR, mask=model.decay_mask)
    state = TrainState.create(params, opt.init(params))
    if mesh is not None:
        state = train.shard_train_state(
            state, mesh, model.partition_rules(fsdp=rules_fsdp))
    step = make_custom_train_step(model.loss_fn(), opt, mesh=mesh,
                                  grad_clip_norm=1.0)
    for i, batch in enumerate(case["batches"]):
        before = _counts()
        state, m = step(state, _rows(batch, mesh, device))
        _record(res, key, i, m, before)
    if rules_fsdp:
        _dump(res, key, train.gather_params(state), {})
    else:
        _dump(res, key, dict(state.params),
              getattr(state.params, "layout", {}))
    with torch.no_grad():
        images = torch.from_numpy(case["batches"][0][0]).to(device)
        res[f"{key}/logits"] = model.apply(
            dict(train.gather_params(state)) if rules_fsdp
            else dict(state.params), images).cpu().numpy()


def _resnet_train(res, key, case, mesh, device="cpu"):
    """Two steps of ``momentum(0.01, 0.9)`` of ``resnet_cifar`` over
    ``mesh`` through ``train.make_train_step`` (sparse cross entropy,
    accuracy): each step's metrics and collectives, the parameters and
    the BatchNorm state after them."""
    from distributed_tensorflow_tpu_torch import TrainState, optim, train
    from distributed_tensorflow_tpu_torch.models import convert
    from distributed_tensorflow_tpu_torch.models.resnet import (ResNet,
                                                                resnet_cifar)
    from distributed_tensorflow_tpu_torch.ops.layers import _flat, _nest
    model = resnet_cifar(mesh=mesh)
    params = convert.stack_params_from_jax(
        case["params"], device, rules=ResNet.partition_rules(), mesh=mesh)
    model_state = _nest({k: torch.from_numpy(v.copy()).to(device)
                         for k, v in case["state"].items()})
    opt = optim.momentum(0.01, 0.9)
    state = TrainState.create(params, opt.init(params), model_state)
    if mesh is not None:
        state = train.shard_train_state(state, mesh,
                                        ResNet.partition_rules())
    step = train.make_train_step(model, "sparse_categorical_crossentropy",
                                 opt, metric_fns={"acc": "accuracy"},
                                 mesh=mesh)
    for i, batch in enumerate(case["batches"]):
        before = _counts()
        state, m = step(state, _rows(batch, mesh, device))
        _record(res, key, i, m, before)
    _dump(res, key, dict(state.params), getattr(state.params, "layout", {}))
    for k, v in _flat(state.model_state, "").items():
        res[f"{key}/state/{k}"] = v.detach().cpu().numpy()


def _moments(res, c, mesh):
    """A training ``BatchNorm`` under ``cross_rank_moments`` on a data x
    tensor mesh, each rank on its rows and its tensor block of the
    channels: the output and the moving moments (``bn/``)."""
    from distributed_tensorflow_tpu_torch.ops import layers
    from distributed_tensorflow_tpu_torch.parallel import (data_parallel,
                                                           tensor_parallel)
    x = c["x"]
    n = x.shape[-1] // tensor_parallel.size(mesh)
    t = tensor_parallel.index(mesh)
    rows = x.shape[0] // mesh.axis_size("data")
    d = mesh.axis_index("data")
    part = torch.from_numpy(np.ascontiguousarray(
        x[d * rows:(d + 1) * rows, ..., t * n:(t + 1) * n]))
    bn = layers.BatchNorm()
    params, state = bn.init(None, (n,))
    with data_parallel.cross_rank_moments(mesh):
        y, new = bn.apply(params, state, part, train=True)
    res["bn/y"] = y.numpy()
    res["bn/mean"] = new["mean"].numpy()
    res["bn/var"] = new["var"].numpy()


def run_vision_rank(rank, world, port, spec, out_path):
    """On ``spec["axes"]`` (data x tensor): the ``BatchNorm`` moments
    (``bn/``), and each model of ``spec`` trained two steps
    tensor-parallel (``tp/vit``, ``tp/resnet``) and, on rank 0, plainly
    on the whole batch (``plain/...``)."""
    spec = _spec(spec)
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import parallel
        res = {}
        mesh = parallel.make_mesh(spec["axes"])
        if "moments" in spec:
            _moments(res, spec["moments"], mesh)
        if "vit" in spec:
            _vit_train(res, "tp/vit", spec["vit"], mesh)
            if rank == 0:
                _vit_train(res, "plain/vit", spec["vit"], None)
        if "resnet" in spec:
            _resnet_train(res, "tp/resnet", spec["resnet"], mesh)
            if rank == 0:
                _resnet_train(res, "plain/resnet", spec["resnet"], None)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def run_vit_zero_rank(rank, world, port, spec, out_path):
    """ViT trained two steps under ZeRO on ``{"fsdp": world}``
    (``zero/vit``, the gathered parameters)."""
    spec = _spec(spec)
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import parallel
        res = {}
        mesh = parallel.make_mesh({"fsdp": world})
        _vit_train(res, "zero/vit", spec, mesh, rules_fsdp=True)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def run_card_rank(rank, world, port, spec, out_path):
    """On the card (gloo with CUDA tensors, ranks sharing it): the MoE
    GPT of ``spec["moe"]`` on ``{"expert": world}`` (``ep/moe``), ViT and
    ResNet of ``spec["vit"]`` / ``spec["resnet"]`` on ``{"tensor":
    world}`` (``tp/vit``, ``tp/resnet``), each two steps, with the
    kernels' launches under ``<key>/kernels/``; on rank 0 also the plain
    models (``plain/...``)."""
    spec = _spec(spec)
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import parallel
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _no_jitter()
        res = {}
        arms = (("ep/moe", "expert", lambda k, m: _moe_train(
                    res, k, spec["moe"], m, device="cuda")),
                ("tp/vit", "tensor", lambda k, m: _vit_train(
                    res, k, spec["vit"], m, device="cuda")),
                ("tp/resnet", "tensor", lambda k, m: _resnet_train(
                    res, k, spec["resnet"], m, device="cuda")))
        for key, axis, run in arms:
            mesh = parallel.make_mesh({axis: world})
            before = _kernel_counts()
            run(key, mesh)
            got = _kernel_counts()
            got.subtract(before)
            for k, v in got.items():
                res[f"{key}/kernels/{k}"] = np.array(v)
            if rank == 0:
                run("plain/" + key.split("/")[1], None)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()
