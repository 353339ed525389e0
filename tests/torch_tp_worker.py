"""Ranks of the port's tensor-parallel tests (``tests/test_torch_tp.py``:
``run_line_rank`` on a ``tensor`` line of 2, ``run_step_rank`` on a
``data`` 2 x ``tensor`` 2 mesh).  Imports neither JAX nor the JAX
package, so a spawned child starts quickly; spawned through
``torch_sp_worker.spawn_ranks``.

Every rank writes its results to an npz; the tests hold them against the
JAX package on an XLA CPU mesh and against the port's plain model.  A
rank's parameters are dumped as its blocks beside their layout
(``<prefix>/layout/<name>``: dim, start, length; dim -1 for a whole
leaf)."""
import collections
import contextlib
import io

import numpy as np
import torch
import torch.distributed as dist

from torch_sp_worker import _start

LR = 1e-3


def _counts():
    from distributed_tensorflow_tpu_torch.parallel import data_parallel
    return collections.Counter(data_parallel.LAUNCHES)


def _since(before):
    got = _counts()
    got.subtract(before)
    return {k: v for k, v in got.items() if v}


def _device(case):
    return torch.device(case.get("device", "cpu"))


def _gpt(case, mesh):
    """(model, loss_fn, params, optimizer) of a GPT case over ``mesh``
    (None: the plain model), its weights from the case's whole state, on
    the case's device (the CPU unless it names one)."""
    from distributed_tensorflow_tpu_torch import GPT, GPTConfig, optim
    from distributed_tensorflow_tpu_torch.parallel import sharding
    model = GPT(GPTConfig(**case["config"]), device=_device(case),
                mesh=mesh, shard_kv=case.get("shard_kv"))
    whole = {k: torch.from_numpy(v.copy()).to(_device(case))
             for k, v in case["state"].items()}
    if mesh is not None:
        whole = sharding.shard_pytree(whole, mesh, model.partition_rules())
    model.load_state_dict(whole)
    params = dict(model.named_parameters())
    return model, model.lm_loss_fn(), params, optim.adamw(LR)


def _bert(case, mesh):
    from distributed_tensorflow_tpu_torch import optim
    from distributed_tensorflow_tpu_torch.models.bert import Bert, BertConfig
    from distributed_tensorflow_tpu_torch.parallel import sharding
    model = Bert(BertConfig(**case["config"]), mesh=mesh)
    params = {k: torch.from_numpy(v.copy()).to(_device(case))
              .requires_grad_(True) for k, v in case["state"].items()}
    if mesh is not None:
        params = sharding.cut_blocks(params, model.partition_rules(), mesh)
    return (model, model.mlm_loss_fn(), params,
            optim.adamw(LR, mask=model.decay_mask))


def _rows(batch, mesh, device="cpu"):
    """This rank's rows of a global batch (all of them without a mesh)."""
    n, i = batch["input_ids"].shape[0], 0
    if mesh is not None:
        n //= mesh.axis_size("data")
        i = mesh.data_index
    return {k: torch.from_numpy(v[i * n:(i + 1) * n]).to(device)
            for k, v in batch.items()}


def dump_params(res, prefix, params, layout):
    for name, t in params.items():
        res[f"{prefix}/p/{name}"] = t.detach().cpu().numpy().copy()
        s = layout.get(name)
        res[f"{prefix}/layout/{name}"] = np.array(
            [-1, 0, 0] if s is None else [s.dim, s.start, s.length])


def _train(res, key, case, mesh):
    """Two steps of ``adamw(1e-3)`` with clip 1.0 of ``case`` over
    ``mesh`` (None: the plain model on the whole batch): each step's
    metrics and collectives, the parameters after them."""
    from distributed_tensorflow_tpu_torch import (TrainState,
                                                  make_custom_train_step,
                                                  train)
    build = _gpt if case["kind"] == "gpt" else _bert
    model, loss_fn, params, opt = build(case, mesh)
    state = TrainState.create(params, opt.init(params))
    if mesh is not None:
        state = train.shard_train_state(state, mesh, model.partition_rules())
    step = make_custom_train_step(loss_fn, opt, mesh=mesh,
                                  grad_clip_norm=1.0)
    for i, batch in enumerate(case["batches"]):
        before = _counts()
        state, m = step(state, _rows(batch, mesh, _device(case)))
        for k, v in m.items():
            res[f"{key}/step{i}/{k}"] = v.detach().float().cpu().numpy()
        for k, v in _since(before).items():
            res[f"{key}/step{i}/launches/{k}"] = np.array(v)
    layout = (state.params.layout if hasattr(state.params, "layout")
              else {})
    dump_params(res, key, dict(state.params), layout)


def run_step_rank(rank, world, port, spec, out_path):
    """Every case of ``spec["cases"]`` trained two steps tensor-parallel
    on ``spec["axes"]`` (``tp/<case>``) and, on rank 0, plainly on the
    whole batch in this process (``plain/<case>``)."""
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import parallel
        res = {}
        mesh = parallel.make_mesh(spec["axes"])
        res["coords"] = np.array([mesh.axis_index("data"),
                                  mesh.axis_index("tensor")])
        for name, case in spec["cases"].items():
            _train(res, f"tp/{name}", case, mesh)
            if rank == 0:
                _train(res, f"plain/{name}", case, None)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _collectives(res, c, mesh):
    """Each function of ``parallel/tensor_parallel.py`` forward and
    backward on this rank's part of the case's global tensors."""
    from distributed_tensorflow_tpu_torch.parallel import \
        tensor_parallel as tp
    r, t = tp.index(mesh), tp.size(mesh)

    def part(a, dim):
        n = a.shape[dim] // t
        return torch.from_numpy(np.ascontiguousarray(
            np.take(a, np.arange(r * n, (r + 1) * n), axis=dim)))

    def record(name, fn):
        before = _counts()
        out = fn()
        for k, v in out.items():
            res[f"{name}/{k}"] = v.detach().numpy().copy()
        for k, v in _since(before).items():
            res[f"{name}/launches/{k}"] = np.array(v)

    def copy():
        x = torch.from_numpy(c["x"]).requires_grad_(True)
        w = torch.from_numpy(c["w"][r])
        (tp.copy_to_line(x, mesh) * w).sum().backward()
        return {"grad": x.grad}

    def reduce():
        x = torch.from_numpy(c["w"][r]).requires_grad_(True)
        y = tp.reduce_from_line(x, mesh)
        (y * torch.from_numpy(c["x"])).sum().backward()
        return {"out": y, "grad": x.grad}

    def gather():
        x = part(c["x"], -1).requires_grad_(True)
        y = tp.gather_from_line(x, mesh)
        (y * torch.from_numpy(c["x"])).sum().backward()
        return {"out": y, "grad": x.grad}

    def embed():
        word = part(c["word"], 0).requires_grad_(True)
        y = tp.vocab_parallel_embed(torch.from_numpy(c["ids"]), word, mesh)
        (y * torch.from_numpy(c["dy"])).sum().backward()
        return {"out": y, "grad": word.grad}

    def cross_entropy():
        logits = part(c["logits"], -1).requires_grad_(True)
        nll = tp.vocab_parallel_cross_entropy(
            logits, torch.from_numpy(c["targets"]), mesh)
        nll.mean().backward()
        return {"nll": nll, "grad": logits.grad}

    def argmax():
        return {"out": tp.vocab_parallel_argmax(part(c["ties"], -1), mesh)}

    for name, fn in (("copy", copy), ("reduce", reduce), ("gather", gather),
                     ("embed", embed), ("cross_entropy", cross_entropy),
                     ("argmax", argmax)):
        record(f"coll/{name}", fn)


def _decode(res, key, case, mesh):
    """``decode_block`` of the prompt's first 6 tokens, one
    ``decode_step``, greedy and sampled ``generate``."""
    model = _gpt(case, mesh)[0]
    ids = torch.from_numpy(case["ids"]).to(_device(case))
    before = _counts()
    with torch.no_grad():
        cache = model.init_cache(ids.shape[0], 12)
        res[f"{key}/cache_heads"] = np.array(cache["k"].shape[3])
        logits, cache = model.decode_block(cache, ids[:, :6])
        step, cache = model.decode_step(cache, ids[:, 6])
        res[f"{key}/block"] = logits.cpu().numpy()
        res[f"{key}/step"] = step.cpu().numpy()
        res[f"{key}/greedy"] = model.generate(ids, 4,
                                              max_len=12).cpu().numpy()
        gen = torch.Generator(ids.device).manual_seed(5)
        res[f"{key}/sampled"] = model.generate(
            ids, 4, temperature=1.0, top_k=20, generator=gen,
            max_len=12).cpu().numpy()
    for k, v in _since(before).items():
        res[f"{key}/launches/{k}"] = np.array(v)


def _dropout(res, case, mesh):
    """At dropout 0.1: the training forward's hidden (the residual stream
    after ``ln_f``) from one generator, tensor-parallel and plain
    (``dropout/<tp|plain>/hidden0``); then one step on the line and the
    same forward again (``dropout/tp/hidden``) with ``ln_f``'s gamma, a
    replicated leaf."""
    from distributed_tensorflow_tpu_torch import (TrainState,
                                                  make_custom_train_step,
                                                  train)
    case = dict(case, config=dict(case["config"], dropout_rate=0.1))
    ids = torch.from_numpy(case["ids"])

    def hidden(model):
        gen = torch.Generator().manual_seed(11)
        with torch.no_grad():
            return model.apply(ids, train=True, generator=gen).numpy()
    res["dropout/plain/hidden0"] = hidden(_gpt(case, None)[0])
    model, loss_fn, params, opt = _gpt(case, mesh)
    res["dropout/tp/hidden0"] = hidden(model)
    state = train.shard_train_state(TrainState.create(params,
                                                      opt.init(params)),
                                    mesh, model.partition_rules())
    step = make_custom_train_step(loss_fn, opt, mesh=mesh, seed=3)
    state, metrics = step(state, {"input_ids": ids})
    res["dropout/tp/loss"] = metrics["loss"].detach().numpy()
    res["dropout/tp/hidden"] = hidden(model)
    res["dropout/tp/ln_f"] = model.ln_f.gamma.detach().numpy().copy()


def _chunked(res, case, mesh):
    """The loss, token accuracy and gradients of the case's GPT on the
    line with ``loss_seq_chunk`` 5 (``chunk/5/``) and off
    (``chunk/0/``)."""
    ids = torch.from_numpy(case["ids"])
    for chunk in (0, 5):
        c = dict(case, config=dict(case["config"], loss_seq_chunk=chunk))
        model, loss_fn, params, _ = _gpt(c, mesh)
        loss, (metrics, _) = loss_fn(params, (), {"input_ids": ids}, None,
                                     True)
        grads = torch.autograd.grad(loss, list(params.values()))
        res[f"chunk/{chunk}/loss"] = loss.detach().numpy()
        res[f"chunk/{chunk}/acc"] = metrics["token_accuracy"].numpy()
        for name, g in zip(params, grads):
            res[f"chunk/{chunk}/grad/{name}"] = g.numpy()


def run_line_rank(rank, world, port, spec, out_path):
    """On a ``tensor`` line of ``world`` ranks: the collectives alone
    (``coll/``), contiguous decoding of each case of ``spec["decode"]``
    tensor-parallel (``dec/<case>/tp``) and plain (``dec/<case>/plain``),
    the dropout check (``dropout/``), the chunked loss on the Llama
    recipe's untied head (``chunk/``), and ``finetune_bert``'s entry
    point on the line (its printed lines, ``finetune/lines``)."""
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import parallel
        from distributed_tensorflow_tpu_torch.examples import finetune_bert
        res = {}
        mesh = parallel.make_mesh({"tensor": world})
        _collectives(res, spec["collectives"], mesh)
        for name, case in spec["decode"].items():
            _decode(res, f"dec/{name}/tp", case, mesh)
            _decode(res, f"dec/{name}/plain", case, None)
        _dropout(res, spec["decode"]["gpt"], mesh)
        _chunked(res, spec["decode"]["llama"], mesh)
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(
                err):
            rc = finetune_bert.main(spec["finetune_argv"])
        res["finetune/rc"] = np.array(rc)
        res["finetune/lines"] = np.array(out.getvalue().splitlines())
        res["finetune/err"] = np.array(err.getvalue())
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _kernel_counts():
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention, fused
    return collections.Counter({**flash_attention.LAUNCHES,
                                **fused.LAUNCHES})


def run_card_rank(rank, world, port, spec, out_path):
    """On a ``tensor`` line of ``world`` ranks sharing one card (gloo
    with CUDA tensors): every case of ``spec["cases"]`` trained two
    steps (``tp/<case>``, with the kernels' launches under
    ``tp/<case>/kernels/``) and every case of ``spec["decode"]`` decoded
    (``dec/<case>/tp``), on the card."""
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import parallel
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        res = {}
        mesh = parallel.make_mesh({"tensor": world})
        for name, case in spec["cases"].items():
            before = _kernel_counts()
            _train(res, f"tp/{name}", dict(case, device="cuda"), mesh)
            got = _kernel_counts()
            got.subtract(before)
            for k, v in got.items():
                res[f"tp/{name}/kernels/{k}"] = np.array(v)
        for name, case in spec["decode"].items():
            _decode(res, f"dec/{name}/tp", dict(case, device="cuda"), mesh)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()
