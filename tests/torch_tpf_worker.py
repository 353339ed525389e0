"""Ranks of the port's tests of seq2seq under tensor parallelism and of
``tensor`` beside ``fsdp`` (``tests/test_torch_seq2seq_tp.py``,
``tests/test_torch_tp_fsdp.py``, ``tests/test_torch_tp_fsdp_models.py``).
Imports neither JAX nor the JAX package, so a spawned child starts
quickly; spawned through ``torch_sp_worker.start_ranks`` with its spec
parked in a pickle (``torch_ep_worker.park``).

Every rank writes its results to an npz; the tests hold them against the
JAX package on an XLA CPU mesh and against the port's plain model.  A
rank's parameters are dumped as its blocks beside their box
(``<prefix>/box/<name>``: one (start, length) row a dim of the whole
leaf)."""
import numpy as np
import torch
import torch.distributed as dist

from torch_ep_worker import _dump, _record, _rows, _spec
from torch_sp_worker import _start
from torch_tp_worker import _counts, _since

LR = 1e-3


def _seq2seq(case, mesh, device="cpu", scale=1.0):
    """(model, params) of the case's seq2seq over ``mesh`` (None: the
    plain model), its weights the case's JAX tree times ``scale``."""
    from distributed_tensorflow_tpu_torch.models import convert
    from distributed_tensorflow_tpu_torch.models.seq2seq import (
        Seq2Seq, Seq2SeqConfig)
    model = Seq2Seq(Seq2SeqConfig(**case["config"]), mesh=mesh)
    tree = case["params"]
    if scale != 1.0:
        tree = _scaled(tree, scale)
    params = convert.seq2seq_params_from_jax(tree, model.config,
                                             device=device, mesh=mesh)
    return model, params


def _scaled(tree, scale):
    return {k: _scaled(v, scale) if isinstance(v, dict)
            else (np.asarray(v) * scale).astype(np.float32)
            for k, v in tree.items()}


def _train(res, key, case, mesh, opt_name, rules_fsdp, device="cpu",
           ckpt=None):
    """Two steps of ``opt_name`` (1e-3) with clip 1.0 of the case's
    seq2seq over ``mesh`` (None: the plain model on the whole batch),
    placed by ``partition_rules(fsdp=rules_fsdp)``: each step's metrics
    and collectives, the blocks after them; with ``ckpt``, a sharded
    checkpoint of the state written there and restored into a fresh
    placed state (``<key>/restored``)."""
    from distributed_tensorflow_tpu_torch import (TrainState,
                                                  make_custom_train_step,
                                                  optim, train)
    from distributed_tensorflow_tpu_torch.train import sharded_checkpoint

    def build():
        model, params = _seq2seq(case, mesh, device)
        opt = getattr(optim, opt_name)(LR)
        state = TrainState.create(params, opt.init(params))
        if mesh is not None:
            state = train.shard_train_state(
                state, mesh, model.partition_rules(fsdp=rules_fsdp))
        return model, params, opt, state
    model, _, opt, state = build()
    step = make_custom_train_step(model.seq2seq_loss_fn(), opt, mesh=mesh,
                                  grad_clip_norm=1.0)
    for i, batch in enumerate(case["batches"]):
        before = _counts()
        state, m = step(state, _rows(batch, mesh, device))
        _record(res, key, i, m, before)
    _dump(res, key, dict(state.params), getattr(state.params, "layout", {}))
    if ckpt is None:
        return state
    sharded_checkpoint.save_sharded(ckpt, 2, state)
    dist.barrier()
    fresh = build()[3]
    restored = sharded_checkpoint.restore_sharded(
        fresh, sharded_checkpoint.all_sharded_checkpoints(ckpt)[-1])
    same = [torch.equal(restored.params[n], state.params[n])
            for n in state.params]
    for k in ("m", "v"):
        moments = restored.opt_state.inner[k]
        same += [torch.equal(moments[n], state.opt_state.inner[k][n])
                 for n in moments]
    res[f"{key}/restored/equal"] = np.array(all(same))
    res[f"{key}/restored/step"] = np.array(int(restored.step))
    res[f"{key}/restored/same_tensors"] = np.array(all(
        restored.params[n] is fresh.params[n] for n in fresh.params))
    return state


def run_seq2seq_line_rank(rank, world, port, spec, out_path):
    """On ``{"tensor": world}``: ``encode``, ``decode`` and the gathered
    ``logits`` of the case's inputs (``tp/fwd``), greedy ``generate`` and
    ``beam_search`` tokens on the scaled weights (``tp/gen``; the plain
    model's on rank 0, ``plain/gen``), two adamw steps (``tp/steps``),
    and with ``remat`` (``tp/remat``), and the training loss at dropout
    0.1 (``dropout/``)."""
    spec = _spec(spec)
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import parallel
        res = {}
        mesh = parallel.make_mesh({"tensor": world})
        case = spec["case"]
        fwd = spec["fwd"]
        model, params = _seq2seq(case, mesh)
        with torch.no_grad():
            src = torch.from_numpy(fwd["src"])
            valid = torch.from_numpy(fwd["src_valid"])
            before = _counts()
            memory = model.encode(params, src, valid)
            hidden = model.decode(params, memory,
                                  torch.from_numpy(fwd["tgt"]), valid)
            logits = model.logits(params, hidden)
            for k, v in _since(before).items():
                res[f"tp/fwd/launches/{k}"] = np.array(v)
        res["tp/fwd/memory"] = memory.numpy()
        res["tp/fwd/hidden"] = hidden.numpy()
        res["tp/fwd/logits"] = logits.numpy()
        arms = [("tp", mesh)] + ([("plain", None)] if rank == 0 else [])
        for key, m in arms:
            gmodel, gparams = _seq2seq(case, m, scale=spec["gen_scale"])
            res[f"{key}/gen/greedy"] = gmodel.generate(
                gparams, src, spec["new_tokens"], src_valid=valid).numpy()
            res[f"{key}/gen/beam"] = gmodel.beam_search(
                gparams, src, spec["new_tokens"], beam_size=2,
                src_valid=valid).numpy()
        _train(res, "tp/steps", case, mesh, "adamw", False)
        remat = dict(case, config=dict(case["config"], remat=True))
        _train(res, "tp/remat", remat, mesh, "adamw", False)
        _dropout_losses(res, case, mesh, rank)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _dropout_losses(res, case, mesh, rank):
    """The training loss at dropout 0.1 of the case's first batch from
    one generator seed, over ``mesh`` (``dropout/tp``) and, on rank 0,
    plainly (``dropout/plain``): a head-sharded context draws its mask
    at the whole heads' shape, so every mask is the plain model's."""
    drop = dict(case, config=dict(case["config"], dropout_rate=0.1))
    batch = {k: torch.from_numpy(v) for k, v in
             case["batches"][0].items()}
    for key, m in [("tp", mesh)] + ([("plain", None)] if rank == 0 else []):
        model, params = _seq2seq(drop, m)
        with torch.no_grad():
            loss, _ = model.seq2seq_loss_fn()(
                params, (), batch, torch.Generator().manual_seed(5), True)
        res[f"dropout/{key}/loss"] = loss.numpy()


def _session(res, case, mesh):
    """``TrainSession(sharded_checkpoint=True)`` on the placed state: one
    step and the save on exit, then a session on a fresh placement
    restores that step and those blocks (``session/``)."""
    from distributed_tensorflow_tpu_torch import (TrainState,
                                                  make_custom_train_step,
                                                  optim, train)

    def placed():
        model, params = _seq2seq(case, mesh)
        opt = optim.adam(LR)
        state = train.shard_train_state(
            TrainState.create(params, opt.init(params)), mesh,
            model.partition_rules(fsdp=True))
        return state, make_custom_train_step(model.seq2seq_loss_fn(), opt,
                                             mesh=mesh)
    state, step = placed()
    with train.TrainSession(state, step, checkpoint_dir=case["dir"],
                            sharded_checkpoint=True) as sess:
        sess.run_step(_rows(case["batches"][0], mesh))
        blocks = {n: t.detach().clone() for n, t in sess.state.params.items()}
    state, step = placed()
    with train.TrainSession(state, step, checkpoint_dir=case["dir"],
                            sharded_checkpoint=True) as sess:
        res["session/step"] = np.array(sess.step)
        res["session/equal"] = np.array(all(
            torch.equal(sess.state.params[n], blocks[n]) for n in blocks))


def _replica_sums(res, mesh):
    """The batch line's sums and the data-parallel mean on ``mesh``
    (``repair/``): every rank's ``batch_sum`` of its rank + 1 over
    ``batch_group``, and ``all_reduce_mean`` of a rank-valued gradient,
    loss and metric weighted by rank + 1, each with its collectives."""
    from distributed_tensorflow_tpu_torch.parallel import data_parallel
    r = float(dist.get_rank())
    before = _counts()
    with data_parallel.cross_rank_moments(mesh):
        res["repair/batch_sum"] = data_parallel.batch_sum(
            torch.tensor([r + 1.0]), data_parallel.batch_group()).numpy()
    res["repair/batch_launches"] = np.array(
        _since(before).get("batch_all_reduce", 0))
    before = _counts()
    grads, loss, metrics = data_parallel.all_reduce_mean(
        {"g": torch.full((3,), r)}, torch.tensor(r),
        {"acc": torch.tensor(2 * r)}, mesh, torch.tensor(r + 1.0))
    res["repair/mean_launches"] = np.array(
        _since(before).get("all_reduce", 0))
    res["repair/grad"] = grads["g"].numpy()
    res["repair/loss"] = loss.numpy()
    res["repair/acc"] = metrics["acc"].numpy()
    res["repair/weight"] = metrics["loss_weight"].numpy()


def run_tpf_rank(rank, world, port, spec, out_path):
    """On ``spec["axes"]`` (data x fsdp x tensor): the replicas' sums
    (``repair/``), then each case of ``spec["cases"]`` trained two adam
    steps under ``partition_rules(fsdp=True)`` (``tpf/<case>``), the one
    that names ``ckpt`` saved and restored (``tpf/<case>/restored``);
    with ``spec["ema"]``, one ``with_ema`` step whose shadow
    ``ema_params`` gathers (``ema/``); with ``spec["session"]``, the
    sharded session's save and resume (``session/``)."""
    spec = _spec(spec)
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import (
            TrainState, make_custom_train_step, optim, parallel, train)
        res = {}
        mesh = parallel.make_mesh(spec["axes"])
        res["coords"] = np.array([mesh.axis_index(a)
                                  for a in ("data", "fsdp", "tensor")])
        _replica_sums(res, mesh)
        for name, case in spec["cases"].items():
            _train(res, f"tpf/{name}", case, mesh, "adam", True,
                   ckpt=case.get("ckpt"))
        if "ema" in spec:
            case = spec["ema"]
            model, params = _seq2seq(case, mesh)
            opt = optim.with_ema(optim.adam(LR), 0.9)
            state = train.shard_train_state(
                TrainState.create(params, opt.init(params)), mesh,
                model.partition_rules(fsdp=True))
            step = make_custom_train_step(model.seq2seq_loss_fn(), opt,
                                          mesh=mesh)
            state, _ = step(state, _rows(case["batches"][0], mesh))
            ema = optim.ema_params(state.opt_state)
            blocks = train.gather_params(state)
            res["ema/same_tensors"] = np.array(all(
                blocks[n] is params[n] for n in params))
            res["ema/shapes"] = np.array(all(
                ema[n].shape == blocks[n].shape for n in blocks))
            # after one step the debiased shadow is the parameters
            res["ema/gap"] = np.array(max(
                float((ema[n] - blocks[n].detach()).abs().max())
                for n in blocks))
        if "session" in spec:
            _session(res, spec["session"], mesh)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


# -- GPT-2, the Llama recipe, BERT and ViT on fsdp x tensor ---------------

def _model_params(case, mesh, device="cpu"):
    """(loss_fn, params, optimizer, rules(fsdp=True)) of a models case
    over ``mesh`` (None: the plain model), its tensor blocks cut from the
    case's whole weights."""
    from distributed_tensorflow_tpu_torch import GPT, GPTConfig, optim
    from distributed_tensorflow_tpu_torch.models import convert
    from distributed_tensorflow_tpu_torch.models.bert import Bert, BertConfig
    from distributed_tensorflow_tpu_torch.models.vit import ViT, ViTConfig
    from distributed_tensorflow_tpu_torch.parallel import sharding
    kind = case["kind"]
    if kind == "gpt":
        model = GPT(GPTConfig(**case["config"]), device=device, mesh=mesh)
        whole = {k: torch.from_numpy(v.copy()).to(device)
                 for k, v in case["state"].items()}
        if mesh is not None:
            whole = sharding.shard_pytree(whole, mesh,
                                          model.partition_rules())
        model.load_state_dict(whole)
        return (model.lm_loss_fn(), dict(model.named_parameters()),
                optim.adamw(LR), model.partition_rules(fsdp=True))
    if kind == "bert":
        model = Bert(BertConfig(**case["config"]), mesh=mesh)
        params = {k: torch.from_numpy(v.copy()).to(device)
                  .requires_grad_(True) for k, v in case["state"].items()}
        if mesh is not None:
            params = sharding.cut_blocks(params, model.partition_rules(),
                                         mesh)
        return (model.mlm_loss_fn(), params,
                optim.adamw(LR, mask=model.decay_mask),
                model.partition_rules(fsdp=True))
    model = ViT(ViTConfig(**case["config"]), mesh=mesh)
    params = convert.vit_params_from_jax(case["params"], model.config,
                                         device=device, mesh=mesh)
    return (model.loss_fn(), params, optim.adamw(LR, mask=model.decay_mask),
            model.partition_rules(fsdp=True))


def _models_train(res, key, case, mesh, device="cpu"):
    from distributed_tensorflow_tpu_torch import (TrainState,
                                                  make_custom_train_step,
                                                  train)
    loss_fn, params, opt, rules = _model_params(case, mesh, device)
    state = TrainState.create(params, opt.init(params))
    if mesh is not None:
        state = train.shard_train_state(state, mesh, rules)
    step = make_custom_train_step(loss_fn, opt, mesh=mesh,
                                  grad_clip_norm=1.0)
    for i, batch in enumerate(case["batches"]):
        before = _counts()
        state, m = step(state, _rows(batch, mesh, device))
        _record(res, key, i, m, before)
    _dump(res, key, dict(state.params), getattr(state.params, "layout", {}))


def run_tpf_models_rank(rank, world, port, spec, out_path):
    """Each case of ``spec["cases"]`` trained two adamw steps on
    ``spec["axes"]`` (fsdp x tensor) under its ``partition_rules(fsdp=
    True)`` (``tpf/<case>``)."""
    spec = _spec(spec)
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import parallel
        res = {}
        mesh = parallel.make_mesh(spec["axes"])
        for name, case in spec["cases"].items():
            _models_train(res, f"tpf/{name}", case, mesh)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()
