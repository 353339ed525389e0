"""Ranks of the port's sequence-parallel tests (``tests/test_torch_ring.py``:
``run_ring_rank``; ``tests/test_torch_sp_models.py``:
``run_models_rank``) and the helper that spawns them.  Imports neither
JAX nor the JAX package, so a spawned child starts quickly.

Every rank writes its results to an npz; the tests hold them against the
JAX package on an XLA CPU mesh of the same shape."""
import collections
import socket

import numpy as np
import torch
import torch.distributed as dist

JOIN_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(out_dir, target, args, world=4):
    """Run ``target(rank, world, port, *args, out)`` on ``world`` spawned
    gloo ranks, each join limited to JOIN_S seconds (a hang fails).
    Returns the ranks' npz outputs as dicts."""
    return start_ranks(out_dir, target, args, world)()


def start_ranks(out_dir, target, args, world=4):
    """``spawn_ranks`` without waiting: the ranks start now, and the
    returned function joins them and returns their outputs, so the caller
    can work meanwhile."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    outs = [str(out_dir / f"rank{r}.npz") for r in range(world)]
    procs = [ctx.Process(target=target, args=(r, world, port, *args,
                                              outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()

    def join():
        try:
            for p in procs:
                p.join(JOIN_S)
            assert not any(p.is_alive() for p in procs), "a rank hung"
            assert [p.exitcode for p in procs] == [0] * world
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        return [dict(np.load(o)) for o in outs]
    return join


def _start(rank, world, port):
    torch.set_num_threads(1)
    from distributed_tensorflow_tpu_torch.parallel import cluster
    cluster.initialize(cluster.ClusterConfig(
        coordinator_address=f"localhost:{port}", num_processes=world,
        process_id=rank), backend="gloo", timeout_s=60)


def _meshes():
    """The rings every test runs: R = 2 as two data lines of a 2 x 2 mesh,
    R = 4 as one seq line of 4."""
    from distributed_tensorflow_tpu_torch import parallel
    return {2: parallel.make_mesh({"data": 2, "seq": 2}),
            4: parallel.make_mesh({"seq": 4})}


def run_ring_rank(rank, world, port, cases, out_path):
    """``ring_attention_sharded`` and ``ring_flash_attention_sharded`` on
    every case (global numpy q, k, v, do, an optional ``valid`` plane and
    a ``causal`` flag) over rings of 2 and 4: the output, the gradients of
    ``sum(out * do)`` for q, k and v, and the flash ring's launches by
    route, under ``<case>_R<R>_<ring|flash>_<what>``; the meshes' layout
    under ``mesh_R<R>_*``; the ring module's collective counts."""
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch.parallel import (
            make_mesh, ring, ring_flash)
        res = {}
        meshes = _meshes()
        for n, mesh in meshes.items():
            res[f"mesh_R{n}_coords"] = np.array(
                [mesh.axis_index(a) for a in ("data", "seq")])
            res[f"mesh_R{n}_line"] = np.array(
                dist.get_process_group_ranks(mesh.axis_group("seq")))
        try:
            make_mesh({"seq": 2 * world})
        except ValueError as e:
            res["too_big"] = np.array(str(e))
        for name, c in cases.items():
            for n, mesh in meshes.items():
                for kind, fn in (("ring", ring.ring_attention_sharded),
                                 ("flash",
                                  ring_flash.ring_flash_attention_sharded)):
                    if kind == "ring" and c["k"].shape[2] != c["q"].shape[2]:
                        continue          # the plain ring takes no GQA
                    q, k, v = (torch.from_numpy(c[t]).requires_grad_(True)
                               for t in ("q", "k", "v"))
                    valid = (None if c.get("valid") is None
                             else torch.from_numpy(c["valid"]))
                    before = collections.Counter(ring_flash.LAUNCHES)
                    out = fn(q, k, v, mesh, "seq", causal=bool(c["causal"]),
                             kv_valid=valid)
                    (out * torch.from_numpy(c["do"])).sum().backward()
                    key = f"{name}_R{n}_{kind}"
                    res[key + "_out"] = out.detach().numpy()
                    for t, x in (("dq", q), ("dk", k), ("dv", v)):
                        res[f"{key}_{t}"] = x.grad.numpy()
                    got = collections.Counter(ring_flash.LAUNCHES)
                    got.subtract(before)
                    for route, count in got.items():
                        res[f"{key}_launch_{route}"] = np.array(count)
        res["p2p"] = np.array(ring.LAUNCHES["p2p"])
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _gpt(config_kw, state, mesh, seq_axis="seq"):
    from distributed_tensorflow_tpu_torch import GPT, GPTConfig
    model = GPT(GPTConfig(seq_axis=seq_axis, **config_kw), device="cpu",
                mesh=mesh)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _pooled_loss(model):
    """A loss on ``Bert.apply``'s gathered output: the squared distance of
    the pooled ``[CLS]`` from ``batch["target"]``."""
    def loss_fn(params, model_state, batch, generator, train):
        hidden = model.apply(params, batch["input_ids"],
                             attention_mask=batch["attention_mask"])
        pooled = model.pooled(params, hidden)
        return ((pooled - batch["target"]) ** 2).mean(), ({}, model_state)
    return loss_fn


def run_models_rank(rank, world, port, spec, out_path):
    """The models with ``seq_axis="seq"``: for each GPT and BERT entry of
    ``spec["forward"]`` the global hidden (GPT's logits, BERT's pooled
    output) of its ids on the ring of 4; for each entry of
    ``spec["train"]`` two ``adamw`` steps (clip 1.0) on the mesh of its
    ``axes`` (``seq_axis`` set when it has a ``seq`` axis), each rank
    feeding its data shard's rows of the global batches (a
    ``bert_pooled`` entry: ``sgd`` on ``_pooled_loss``): the steps'
    metrics, the all-reduces issued and the parameters after them."""
    _start(rank, world, port)
    try:
        from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                      make_custom_train_step)
        from distributed_tensorflow_tpu_torch.optim import sgd
        from distributed_tensorflow_tpu_torch.models import bert as tbert
        from distributed_tensorflow_tpu_torch.parallel import (
            data_parallel, make_mesh, ring)
        res = {}
        for name, f in spec["forward"].items():
            mesh = make_mesh({"seq": 4})
            ids = torch.from_numpy(f["ids"])
            with torch.no_grad():
                if f["kind"] == "gpt":
                    model = _gpt(f["config"], f["state"], mesh)
                    hidden = model.apply(ids)
                    res[f"{name}_logits"] = model.logits(hidden).numpy()
                else:
                    model = tbert.Bert(tbert.BertConfig(
                        seq_axis="seq", **f["config"]), mesh=mesh)
                    params = {k: torch.from_numpy(v)
                              for k, v in f["state"].items()}
                    hidden = model.apply(params, ids, attention_mask=(
                        torch.from_numpy(f["valid"])))
                    res[f"{name}_pooled"] = model.pooled(params,
                                                         hidden).numpy()
            res[f"{name}_hidden"] = hidden.numpy()
        for name, t in spec["train"].items():
            mesh = make_mesh(t["axes"])
            seq_axis = "seq" if "seq" in t["axes"] else None
            rows = t["rows"]
            part = slice(mesh.data_index * rows, (mesh.data_index + 1) * rows)
            if t["kind"] == "gpt":
                model = _gpt(t["config"], t["state"], mesh, seq_axis)
                params = dict(model.named_parameters())
                opt = adamw(1e-3)
                loss_fn = model.lm_loss_fn()
            else:
                model = tbert.Bert(tbert.BertConfig(seq_axis=seq_axis,
                                                    **t["config"]),
                                   mesh=mesh)
                params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
                          for k, v in t["state"].items()}
                opt = adamw(1e-3, mask=model.decay_mask)
                loss_fn = model.mlm_loss_fn()
            if t["kind"] == "bert_pooled":
                opt, loss_fn = sgd(0.1), _pooled_loss(model)
            state = TrainState.create(params, opt.init(params))
            step = make_custom_train_step(loss_fn, opt, mesh=mesh,
                                          grad_clip_norm=1.0)
            reduces = data_parallel.LAUNCHES["all_reduce"]
            for i, batch in enumerate(t["batches"]):
                state, m = step(state, {k: torch.from_numpy(v[part])
                                        for k, v in batch.items()})
                for k, v in m.items():
                    res[f"{name}_step{i}_{k}"] = v.detach().numpy()
            res[f"{name}_all_reduces"] = np.array(
                data_parallel.LAUNCHES["all_reduce"] - reduces)
            for k, v in state.params.items():
                res[f"{name}_param_{k}"] = v.detach().numpy()
        res["p2p"] = np.array(ring.LAUNCHES["p2p"])
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()
