"""The low-level training entry point, in PyTorch: the port of ``example.py``.

    python -m distributed_tensorflow_tpu_torch.example [--device=cuda]
        [--log_dir=...] [--epochs=N] [--batch_size=N] [--seed=N]

The reference's system: the 64-bit XOR task, the 128-128-32 MLP with
dropout 0.3, MSE and bitwise accuracy, Adam with TF-1.4 defaults (one
launch of the Adam kernel per parameter tensor on the card), trained
data-parallel under a monitored session (``TrainSession`` with
``StopAtStepHook``, chief-only ``CheckpointHook(every_secs=60)``,
``PreemptionHook`` and a ``SummaryHook`` on the fractional-epoch axis),
the model graph in the event file, and a validation print every 5
epochs.  The same flags and environment variables as ``example.py``.

Cluster topology comes from COORDINATOR_ADDRESS / NUM_PROCESSES /
PROCESS_ID, or the reference's legacy JOB_NAME / TASK_INDEX /
WORKER_HOSTS; with none set it runs single-machine.  A coordinator starts
a ``torch.distributed`` group (NCCL on cards, gloo on the CPU), one card
a rank, and every step averages the gradients with one all-reduce.

``--device`` is ``cuda`` by default and raises when there is no card;
``--device=cpu`` runs on the CPU.  Matmuls run in full f32 precision
(TF32 off, set below): the XOR model is held to the CPU at f32 round-off.
"""
import os
import sys

from distributed_tensorflow_tpu_torch import utils
from distributed_tensorflow_tpu_torch.utils import flags as flags_lib
from distributed_tensorflow_tpu_torch.utils.flags import FLAGS

# Hyperparameters (example.py's)
bits = 32                  # half the input width; label width
train_batch_size = 50      # global batch size
train_set_size = 30000
val_set_size = 1000
epochs = 50
print_rate = 5             # epochs between validation prints


def _define_flags() -> None:
    """The flags and their defaults, set again at each ``main`` (the
    package's entry points share one ``FLAGS`` registry)."""
    flags_lib.DEFINE_string(
        "job_name", flags_lib.env_default("JOB_NAME", None),
        "Legacy role name ('worker'; 'ps' is refused: there is no parameter "
        "server)")
    flags_lib.DEFINE_integer(
        "task_index",
        flags_lib.env_default(
            "PROCESS_ID", flags_lib.env_default("TASK_INDEX", 0, int), int),
        "Process index within the job; index 0 is chief (does checkpoint and "
        "summary writes)")
    flags_lib.DEFINE_string(
        "coordinator", flags_lib.env_default("COORDINATOR_ADDRESS", None),
        "host:port of process 0 for multi-process runs")
    flags_lib.DEFINE_integer(
        "num_processes", flags_lib.env_default("NUM_PROCESSES", 0, int),
        "Number of participating processes (0 = infer from env)")
    flags_lib.DEFINE_string(
        "worker_hosts", flags_lib.env_default("WORKER_HOSTS", None),
        "Legacy comma-separated worker list; first host becomes coordinator")
    flags_lib.DEFINE_string(
        "data_dir", os.environ.get("DATA_DIR") or utils.get_data_path(
            "xor", local_root=os.path.join("logs", "data"), local_repo="xor"),
        "Directory containing/receiving training data")
    flags_lib.DEFINE_string(
        "log_dir", os.environ.get("LOG_DIR") or utils.get_logs_path(
            os.path.join("logs", "xor")),
        "Directory for checkpoints and TensorBoard event files")
    flags_lib.DEFINE_string(
        "device", "cuda",
        "'cuda' (the default; raises without a card) or 'cpu'")
    flags_lib.DEFINE_integer("epochs", epochs, "Training epochs")
    flags_lib.DEFINE_integer(
        "accum_steps", 1,
        "Gradient-accumulation microbatches per update (1 = off)")
    flags_lib.DEFINE_bool(
        "async_checkpoint", False,
        "Write checkpoints on a background thread (never stalls the step)")
    flags_lib.DEFINE_integer("batch_size", train_batch_size,
                             "Global batch size")
    flags_lib.DEFINE_integer("seed", 0,
                             "Seed of the data, weights and dropout")


def main(argv=None) -> int:
    _define_flags()
    FLAGS.reset()
    FLAGS.parse(argv)

    import torch

    from distributed_tensorflow_tpu_torch import (data, ops, optim, parallel,
                                                  train)
    from distributed_tensorflow_tpu_torch._launch import start
    from distributed_tensorflow_tpu_torch.parallel import cluster
    from distributed_tensorflow_tpu_torch.summary import SummaryWriter

    # Cluster bootstrap; CLI flags overlay the environment.
    env = dict(os.environ)
    if FLAGS.coordinator:
        env["COORDINATOR_ADDRESS"] = FLAGS.coordinator
    if FLAGS.num_processes:
        env["NUM_PROCESSES"] = str(FLAGS.num_processes)
    if FLAGS.worker_hosts:
        env["WORKER_HOSTS"] = FLAGS.worker_hosts
    if FLAGS.job_name:
        env["JOB_NAME"] = FLAGS.job_name
    env["PROCESS_ID"] = str(FLAGS.task_index)
    config = cluster.cluster_from_env(environ=env)
    if FLAGS.job_name == "ps" or config.is_legacy_ps:
        print("JOB_NAME=ps: there is no parameter-server role; gradients "
              "are averaged with an all-reduce. Exiting.")
        if os.environ.get("DTTPU_LAUNCHER"):
            # under a supervisor, exit 0 would read as "completed"
            return cluster.LEGACY_PS_EXIT_CODE
        return 0
    if not config.distributed:
        print("Running single-machine training")
    device = start(FLAGS.device, config)

    # All ranks on one 'data' axis; each feeds its share of the global
    # batch and the step averages the gradients over the ranks.
    mesh = parallel.data_parallel_mesh()
    is_chief = cluster.is_chief()
    print(f"devices: {mesh.size} ({device.type}), mesh={mesh.shape}, "
          f"chief={is_chief}")

    model = ops.serial(
        ops.Dense(128, activation="relu"),
        ops.Dropout(0.3),
        ops.Dense(128, activation="relu"),
        ops.Dropout(0.3),
        ops.Dense(bits, activation="sigmoid"),
    )
    optimizer = optim.adam()   # TF 1.4 defaults

    (x_train, y_train), (x_val, y_val) = data.xor_data(
        train_set_size, val_set_size, seed=FLAGS.seed)
    batch_size = parallel.round_batch_to_mesh(FLAGS.batch_size, mesh)
    if batch_size != FLAGS.batch_size:
        print(f"batch_size {FLAGS.batch_size} -> {batch_size} "
              f"(divisible by {parallel.data_shards(mesh)} data shards)")
    dataset = data.Dataset(
        [x_train, y_train], parallel.local_batch_size(batch_size, mesh),
        seed=FLAGS.seed, process_index=mesh.rank, process_count=mesh.size)
    total_batch = len(dataset)   # == global steps per epoch

    metric_fns = {"accuracy": "bitwise_accuracy"}
    train_step = train.make_train_step(model, "mse", optimizer,
                                       metric_fns=metric_fns, mesh=mesh,
                                       seed=FLAGS.seed,
                                       accum_steps=FLAGS.accum_steps)
    eval_step = train.make_eval_step(model, "mse", metric_fns=metric_fns,
                                     mesh=mesh)
    state = train.init_train_state(
        model, optimizer, torch.Generator(device).manual_seed(FLAGS.seed),
        (2 * bits,))

    last_step = FLAGS.epochs * total_batch
    writer = SummaryWriter(FLAGS.log_dir) if is_chief else None
    if writer is not None:
        writer.add_graph(model)
    hooks = [train.StopAtStepHook(last_step=last_step),
             train.CheckpointHook(every_secs=60.0),
             train.PreemptionHook()]
    if writer is not None:
        hooks.append(train.SummaryHook(
            writer, every_steps=max(1, total_batch // 60),
            step_fn=lambda s: s / total_batch))

    val_batch = (torch.from_numpy(x_val).to(device),
                 torch.from_numpy(y_val).to(device))

    with train.TrainSession(state, train_step, checkpoint_dir=FLAGS.log_dir,
                            hooks=hooks, is_chief=is_chief,
                            async_checkpoint=FLAGS.async_checkpoint) as sess:
        start_epoch = sess.step // total_batch
        for epoch in range(start_epoch, FLAGS.epochs):
            if sess.should_stop():
                break
            # the epoch's sums stay on the device: one fetch an epoch
            loss_sum = acc_sum = None
            n_batches = 0
            for batch in data.prefetch_to_device(iter(dataset),
                                                 device=device):
                if sess.should_stop():
                    break
                m = sess.run_step(batch)
                loss_sum = (m["loss"] if loss_sum is None
                            else loss_sum + m["loss"])
                acc_sum = (m["accuracy"] if acc_sum is None
                           else acc_sum + m["accuracy"])
                n_batches += 1
            if epoch % print_rate == 0 or epoch == FLAGS.epochs - 1:
                val = eval_step(sess.state, val_batch)
                avg_loss = (float(loss_sum) / n_batches) if n_batches else 0.0
                avg_acc = (float(acc_sum) / n_batches) if n_batches else 0.0
                print(f"Epoch: {epoch:4d}  loss: {avg_loss:.6f}  "
                      f"train acc: {avg_acc:.4f}  "
                      f"val acc: {float(val['accuracy']):.4f}", flush=True)
                if writer is not None:
                    writer.add_scalars(
                        {"val/accuracy": float(val["accuracy"]),
                         "val/loss": float(val["loss"])}, epoch)
    if writer is not None:
        writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
