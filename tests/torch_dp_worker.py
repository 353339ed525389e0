"""One rank of the port's two-process data-parallel test
(``tests/test_torch_parallel.py``): imports neither JAX nor the JAX
package, so a spawned child starts quickly."""
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
