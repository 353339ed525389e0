"""Ranks of the port's tests of ``tensor`` beside ``seq``
(``tests/test_torch_tp_sp.py`` on ``{"seq": 2, "tensor": 2}``,
``tests/test_torch_tp_sp_graft.py`` on ``{"data": 2, "seq": 2,
"tensor": 2}``).  Imports neither JAX nor the JAX package, so a spawned
child starts quickly; spawned through ``torch_sp_worker.start_ranks``
with its spec parked in a pickle (``torch_ep_worker.park``).

Every rank writes its results to an npz; the tests hold them against the
JAX package on an XLA CPU mesh and against the port's plain model.  A
rank's parameters are dumped as its blocks beside their box
(``<prefix>/box/<name>``: one (start, length) row a dim of the whole
leaf).  Collective counts join ``parallel.data_parallel.LAUNCHES`` and
``parallel.ring.LAUNCHES`` (the ring's under ``ring_<kind>``)."""
import collections

import numpy as np
import torch
import torch.distributed as dist

from torch_ep_worker import _dump, _rows, _spec
from torch_sp_worker import _start

LR = 1e-3


def _counts():
    from distributed_tensorflow_tpu_torch.parallel import data_parallel, ring
    out = collections.Counter(data_parallel.LAUNCHES)
    out.update({f"ring_{k}": v for k, v in ring.LAUNCHES.items()})
    return out


def _since(before):
    got = _counts()
    got.subtract(before)
    return {k: v for k, v in got.items() if v}


def _record(res, key, i, metrics, before):
    for k, v in metrics.items():
        res[f"{key}/step{i}/{k}"] = v.detach().float().cpu().numpy()
    for k, v in _since(before).items():
        res[f"{key}/step{i}/launches/{k}"] = np.array(v)


def build(case, mesh, **overrides):
    """(model, loss_fn, params, optimizer, rules) of a case over ``mesh``
    (None: the plain model, without ``seq_axis``), its weights cut from
    the case's whole state; ``overrides`` change the config."""
    from distributed_tensorflow_tpu_torch import GPT, GPTConfig, optim
    from distributed_tensorflow_tpu_torch.models.bert import Bert, BertConfig
    from distributed_tensorflow_tpu_torch.parallel import sharding
    config = dict(case["config"], **overrides)
    if mesh is None:
        config["seq_axis"] = None
    whole = {k: torch.from_numpy(v.copy()) for k, v in case["state"].items()}
    if case["kind"] == "gpt":
        model = GPT(GPTConfig(**config), device="cpu", mesh=mesh,
                    shard_kv=case.get("shard_kv"))
        if mesh is not None:
            whole = sharding.shard_pytree(whole, mesh,
                                          model.partition_rules())
        model.load_state_dict(whole)
        return (model, model.lm_loss_fn(), dict(model.named_parameters()),
                optim.adamw(LR), model.partition_rules())
    model = Bert(BertConfig(**config), mesh=mesh)
    params = {k: v.requires_grad_(True) for k, v in whole.items()}
    if model.line is not None:
        params = sharding.cut_blocks(params, model.partition_rules(), mesh)
    return (model, model.mlm_loss_fn(), params,
            optim.adamw(LR, mask=model.decay_mask), model.partition_rules())


def _forward(res, key, case, mesh):
    """The training loss at the first batch (``<key>/loss``) and the
    gathered output of ``apply``: the hidden after ``ln_f`` of a GPT (of
    the inputs, ``input_ids[:, :-1]``), BERT's sequence output and pooled
    ``[CLS]``."""
    model, loss_fn, params, _, _ = build(case, mesh)
    batch = _rows(case["batches"][0], mesh)
    before = _counts()
    with torch.no_grad():
        loss, (metrics, _) = loss_fn(params, (), batch, None, False)
        if case["kind"] == "gpt":
            res[f"{key}/hidden"] = model.apply(
                batch["input_ids"][:, :-1]).numpy()
        else:
            seq = model.apply(params, batch["input_ids"],
                              attention_mask=batch["attention_mask"])
            res[f"{key}/hidden"] = seq.numpy()
            res[f"{key}/pooled"] = model.pooled(params, seq).numpy()
    res[f"{key}/loss"] = loss.numpy()
    for k, v in _since(before).items():
        res[f"{key}/launches/{k}"] = np.array(v)


def train(res, key, case, mesh, ckpt=None, seed=0, **overrides):
    """Two steps of ``adamw(1e-3)`` with clip 1.0 over ``mesh`` (None: the
    plain model on the whole batch): each step's metrics and collectives,
    the blocks after them (``<key>/p``), what ``train.gather_params``
    returns (``<key>/gathered``); with ``ckpt``, a sharded checkpoint
    written there and restored into a fresh placed state
    (``<key>/restored``)."""
    from distributed_tensorflow_tpu_torch import (TrainState,
                                                  make_custom_train_step)
    from distributed_tensorflow_tpu_torch import train as train_lib
    from distributed_tensorflow_tpu_torch.train import sharded_checkpoint

    def placed():
        model, loss_fn, params, opt, rules = build(case, mesh, **overrides)
        state = TrainState.create(params, opt.init(params))
        if mesh is not None:
            state = train_lib.shard_train_state(state, mesh, rules)
        return loss_fn, opt, state
    loss_fn, opt, state = placed()
    step = make_custom_train_step(loss_fn, opt, seed=seed, mesh=mesh,
                                  grad_clip_norm=1.0)
    for i, batch in enumerate(case["batches"]):
        before = _counts()
        state, m = step(state, _rows(batch, mesh))
        _record(res, key, i, m, before)
    layout = getattr(state.params, "layout", {})
    _dump(res, key, dict(state.params), layout)
    if mesh is None:
        return state
    gathered = train_lib.gather_params(state)
    res[f"{key}/gathered_same"] = np.array(all(
        gathered[n] is state.params[n] for n in state.params))
    _dump(res, f"{key}/gathered", gathered, layout)
    if ckpt is None:
        return state
    sharded_checkpoint.save_sharded(ckpt, 2, state)
    dist.barrier()
    fresh = placed()[2]
    restored = sharded_checkpoint.restore_sharded(
        fresh, sharded_checkpoint.all_sharded_checkpoints(ckpt)[-1])
    same = [torch.equal(restored.params[n], state.params[n])
            for n in state.params]
    for k in ("m", "v"):
        same += [torch.equal(restored.opt_state.inner[k][n],
                             state.opt_state.inner[k][n])
                 for n in state.params]
    res[f"{key}/restored/equal"] = np.array(all(same))
    res[f"{key}/restored/step"] = np.array(int(restored.step))
    res[f"{key}/restored/same_tensors"] = np.array(all(
        restored.params[n] is fresh.params[n] for n in fresh.params))
    return state


def _dropout(res, case, mesh):
    """At dropout 0.1: the training forward's gathered hidden from a
    generator seeded by the seq coordinate (the step's fold), then the
    loss and the blocks after one step (``seed=3``)."""
    from distributed_tensorflow_tpu_torch import (TrainState,
                                                  make_custom_train_step)
    from distributed_tensorflow_tpu_torch import train as train_lib
    model, loss_fn, params, opt, rules = build(case, mesh, dropout_rate=0.1)
    batch = _rows(case["batches"][0], mesh)
    ids = batch["input_ids"][:, :-1]
    gen = torch.Generator().manual_seed(11 + mesh.axis_index("seq"))
    with torch.no_grad():
        res["dropout/hidden"] = model.apply(ids, train=True,
                                            generator=gen).numpy()
        res["dropout/hidden_eval"] = model.apply(ids).numpy()
    state = train_lib.shard_train_state(
        TrainState.create(params, opt.init(params)), mesh, rules)
    step = make_custom_train_step(loss_fn, opt, seed=3, mesh=mesh)
    state, m = step(state, batch)
    res["dropout/loss"] = m["loss"].detach().numpy()
    _dump(res, "dropout", dict(state.params), state.params.layout)


def run_tsp_rank(rank, world, port, spec, out_path):
    """Each case of ``spec["cases"]`` on ``spec["axes"]``: its forward
    (``fwd/<case>``), two steps (``tsp/<case>``), with remat when the case
    names a policy (``remat/<case>``), the plain model's two steps on
    rank 0 (``plain/<case>``); the dropout check on ``spec["dropout"]``'s
    case (``dropout/``); a sharded checkpoint of each case named in
    ``spec["ckpt"]`` under its directory."""
    spec = _spec(spec)
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import parallel
        res = {}
        mesh = parallel.make_mesh(spec["axes"])
        res["coords"] = np.array([mesh.axis_index(a)
                                  for a in ("data", "seq", "tensor")])
        for name, case in spec["cases"].items():
            _forward(res, f"fwd/{name}", case, mesh)
            train(res, f"tsp/{name}", case, mesh,
                  ckpt=spec["ckpt"].get(name))
            if case.get("remat_policy"):
                train(res, f"remat/{name}", case, mesh, remat=True,
                      remat_policy=case["remat_policy"])
            if rank == 0:
                train(res, f"plain/{name}", case, None)
        if "dropout" in spec:
            _dropout(res, spec["cases"][spec["dropout"]], mesh)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()
