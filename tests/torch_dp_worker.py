"""One rank of the port's two-process data-parallel tests
(``tests/test_torch_parallel.py``: ``run_rank``, ``run_bn_rank``;
``tests/test_torch_sequential.py``: ``run_fit_rank``,
``run_weighted_bn_fit_rank``): imports neither
JAX nor the JAX package, so a spawned child starts quickly."""
import numpy as np
import torch
import torch.distributed as dist


def run_rank(rank, world, port, params, xs, ys, out_path):
    """Train the XOR MLP (dropout 0) over the global batches ``xs``/``ys``
    as rank ``rank`` of ``world`` (gloo, rendezvous on localhost:port),
    feeding this rank's contiguous shard of each; write the parameters to
    ``out_path`` (npz)."""
    from distributed_tensorflow_tpu_torch import ops, optim, parallel, train
    from distributed_tensorflow_tpu_torch.parallel import cluster

    torch.set_num_threads(1)
    cluster.initialize(cluster.ClusterConfig(
        coordinator_address=f"localhost:{port}", num_processes=world,
        process_id=rank), backend="gloo", timeout_s=60)
    try:
        mesh = parallel.data_parallel_mesh()
        assert (mesh.size, mesh.rank) == (world, rank)
        model = ops.serial(ops.Dense(128, activation="relu"),
                           ops.Dropout(0.0),
                           ops.Dense(128, activation="relu"),
                           ops.Dropout(0.0),
                           ops.Dense(32, activation="sigmoid"))
        state_params = {k: torch.from_numpy(v).requires_grad_(True)
                        for k, v in params.items()}
        opt = optim.adam()
        state = train.TrainState.create(state_params,
                                        opt.init(state_params), {})
        step = train.make_train_step(model, "mse", opt, mesh=mesh)
        local = parallel.local_batch_size(xs.shape[1], mesh)
        losses = []
        for x, y in zip(xs, ys):
            shard = slice(rank * local, (rank + 1) * local)
            state, m = step(state, (torch.from_numpy(x[shard]),
                                    torch.from_numpy(y[shard])))
            losses.append(float(m["loss"]))
        from distributed_tensorflow_tpu_torch.parallel import data_parallel
        np.savez(out_path, losses=np.array(losses),
                 all_reduces=data_parallel.LAUNCHES["all_reduce"],
                 **{k: v.detach().numpy() for k, v in state.params.items()})
    finally:
        dist.destroy_process_group()


def run_fit_rank(rank, world, port, weights, x, y, xv, yv, out_path):
    """``Sequential.fit(mesh=...)`` of the XOR MLP (dropout 0) as rank
    ``rank`` of ``world`` (gloo, rendezvous on localhost:port) from the
    given weights: 2 epochs of global batch 63 (rounded to the mesh),
    validation each epoch; write the History, the evaluate means and the
    weights to ``out_path`` (npz)."""
    from distributed_tensorflow_tpu_torch import models, ops, parallel
    from distributed_tensorflow_tpu_torch.parallel import (cluster,
                                                           data_parallel)

    torch.set_num_threads(1)
    cluster.initialize(cluster.ClusterConfig(
        coordinator_address=f"localhost:{port}", num_processes=world,
        process_id=rank), backend="gloo", timeout_s=60)
    try:
        mesh = parallel.data_parallel_mesh()
        model = models.Sequential(
            [ops.Dense(128, activation="relu"), ops.Dropout(0.0),
             ops.Dense(128, activation="relu"), ops.Dropout(0.0),
             ops.Dense(32, activation="sigmoid")], name="xor",
            device="cpu")
        model.compile("mean_squared_error", "adam", ["bitwise_accuracy"],
                      mesh=mesh)
        model.build((64,))
        model.set_weights(weights)
        hist = model.fit(x, y, epochs=2, batch_size=63,
                         validation_data=(xv, yv), verbose=0)
        final = model.evaluate(xv, yv, verbose=0)
        np.savez(out_path,
                 all_reduces=data_parallel.LAUNCHES["all_reduce"],
                 **{f"h_{k}": np.array(v) for k, v in hist.history.items()},
                 **{f"e_{k}": np.array(v) for k, v in final.items()},
                 **{f"w{i}": w for i, w in enumerate(model.get_weights())})
    finally:
        dist.destroy_process_group()


def run_weighted_bn_fit_rank(rank, world, port, weights, x, y, w, out_path):
    """``Sequential.fit(sample_weight=...)`` of a Dense (no bias) ->
    BatchNorm -> Dense model compiled with ``mesh=...``, as rank ``rank``
    of ``world`` (gloo, rendezvous on localhost:port) from the given
    weights: 2 epochs of global batch 16.  Writes the History, the
    weights and the BatchNorm's running moments to ``out_path`` (npz)."""
    from distributed_tensorflow_tpu_torch import models, ops, parallel
    from distributed_tensorflow_tpu_torch.parallel import cluster

    torch.set_num_threads(1)
    cluster.initialize(cluster.ClusterConfig(
        coordinator_address=f"localhost:{port}", num_processes=world,
        process_id=rank), backend="gloo", timeout_s=60)
    try:
        mesh = parallel.data_parallel_mesh()
        model = models.Sequential(
            [ops.Dense(16, use_bias=False), ops.BatchNorm(),
             ops.Dense(4, activation="sigmoid")], name="bn", device="cpu")
        model.compile("mean_squared_error", "adam", mesh=mesh)
        model.build((x.shape[-1],))
        model.set_weights(weights)
        hist = model.fit(x, y, epochs=2, batch_size=16, sample_weight=w,
                         verbose=0)
        bn = model.state.model_state["batchnorm"]
        np.savez(out_path,
                 bn_mean=bn["mean"].numpy(), bn_var=bn["var"].numpy(),
                 **{f"h_{k}": np.array(v) for k, v in hist.history.items()},
                 **{f"w{i}": a for i, a in enumerate(model.get_weights())})
    finally:
        dist.destroy_process_group()


def run_bn_rank(rank, world, port, params, xs, ys, ragged, out_path):
    """``make_train_step(mesh=...)`` of a Dense (no bias) -> BatchNorm ->
    Dense model
    as rank ``rank`` of ``world`` (gloo, rendezvous on localhost:port),
    feeding this rank's contiguous shard of each global batch; then one
    training forward of a lone ``BatchNorm`` under ``cross_rank_moments``
    on this rank's share of ``ragged`` (shards of unequal sizes: rank r
    takes rows ``[r * 3, ...)`` of 3 and the rest).  Writes the
    parameters, the running moments, the losses and the ragged run's
    output and moments to ``out_path`` (npz)."""
    from distributed_tensorflow_tpu_torch import ops, optim, parallel, train
    from distributed_tensorflow_tpu_torch.parallel import cluster

    torch.set_num_threads(1)
    cluster.initialize(cluster.ClusterConfig(
        coordinator_address=f"localhost:{port}", num_processes=world,
        process_id=rank), backend="gloo", timeout_s=60)
    try:
        mesh = parallel.data_parallel_mesh()
        model = ops.serial(ops.Dense(16, use_bias=False), ops.BatchNorm(),
                           ops.Dense(4, activation="sigmoid"))
        state_params = {k: torch.from_numpy(v).requires_grad_(True)
                        for k, v in params.items()}
        _, model_state = model.init(torch.Generator().manual_seed(0),
                                    (xs.shape[-1],))
        opt = optim.adam(1e-2)
        state = train.TrainState.create(state_params,
                                        opt.init(state_params), model_state)
        step = train.make_train_step(model, "mse", opt, mesh=mesh)
        local = parallel.local_batch_size(xs.shape[1], mesh)
        losses = []
        for x, y in zip(xs, ys):
            shard = slice(rank * local, (rank + 1) * local)
            state, m = step(state, (torch.from_numpy(x[shard]),
                                    torch.from_numpy(y[shard])))
            losses.append(float(m["loss"]))
        bn = ops.BatchNorm()
        _, bn_state = bn.init(torch.Generator().manual_seed(0),
                              (ragged.shape[-1],))
        rows = slice(0, 3) if rank == 0 else slice(3, None)
        with parallel.data_parallel.cross_rank_moments(mesh):
            y_ragged, bn_new = bn.apply({"gamma": torch.ones(ragged.shape[-1]),
                                         "beta": torch.zeros(ragged.shape[-1])},
                                        bn_state,
                                        torch.from_numpy(ragged[rows]),
                                        train=True)
        ms = state.model_state["batchnorm"]
        np.savez(out_path, losses=np.array(losses),
                 bn_mean=ms["mean"].numpy(), bn_var=ms["var"].numpy(),
                 ragged_y=y_ragged.numpy(),
                 ragged_mean=bn_new["mean"].numpy(),
                 ragged_var=bn_new["var"].numpy(),
                 **{f"p_{k}": v.detach().numpy()
                    for k, v in state.params.items()})
    finally:
        dist.destroy_process_group()
