"""The MNIST MLP entry point (low-level tier), in PyTorch: the port of
``outline_tensorflow.py``.

    python -m distributed_tensorflow_tpu_torch.outline_tensorflow
        [--device=cuda] [--epochs=N] [--batch_size=N] [--learning_rate=F]
        [--data_dir=...] [--log_dir=...] [--seed=N]

``models.mnist_mlp`` (784→128 relu → dropout 0.2 → 10; 4 parameter
tensors) trained by ``make_train_step`` with
``sparse_categorical_crossentropy``, ``adam(--learning_rate)`` and
``accuracy`` under ``TrainSession`` with ``StopAtStepHook``,
``CheckpointHook(every_secs=120)``, ``LoggingHook``, ``PreemptionHook``
and, on the chief, a ``SummaryHook`` every 10 steps; then the loss and
accuracy on the first 4096 test images.  5 epochs of batch 1024.  Real
MNIST files (IDX or ``mnist.npz``) in ``--data_dir`` are used when
present; otherwise the synthetic stand-in (``data.mnist``).  With a
coordinator in the environment the ranks train data-parallel, each on
its contiguous shard of the training set.

``--device`` is ``cuda`` by default and raises when there is no card;
``--device=cpu`` runs on the CPU.
"""
import os
import sys

from distributed_tensorflow_tpu_torch.utils import flags as flags_lib
from distributed_tensorflow_tpu_torch.utils.flags import FLAGS


def _define_flags() -> None:
    """The flags and their defaults, set again at each ``main`` (the
    package's entry points share one ``FLAGS`` registry)."""
    flags_lib.DEFINE_string(
        "device", "cuda",
        "'cuda' (the default; raises without a card) or 'cpu'")
    flags_lib.DEFINE_string("data_dir", os.environ.get("DATA_DIR", ""),
                            "Directory with MNIST files (IDX or mnist.npz)")
    flags_lib.DEFINE_string("log_dir",
                            os.environ.get("LOG_DIR",
                                           os.path.join("logs", "mnist")),
                            "Checkpoint/summary directory")
    flags_lib.DEFINE_integer("epochs", 5, "Training epochs")
    flags_lib.DEFINE_integer("batch_size", 1024, "Global batch size")
    flags_lib.DEFINE_float("learning_rate", 1e-3, "Adam learning rate")
    flags_lib.DEFINE_integer("seed", 0, "Seed of the data, weights and "
                             "dropout")


def main(argv=None) -> int:
    _define_flags()
    FLAGS.reset()
    FLAGS.parse(argv)

    import torch

    from distributed_tensorflow_tpu_torch import (data, models, optim,
                                                  parallel, train)
    from distributed_tensorflow_tpu_torch._launch import start
    from distributed_tensorflow_tpu_torch.parallel import cluster
    from distributed_tensorflow_tpu_torch.summary import SummaryWriter

    device = start(FLAGS.device, cluster.cluster_from_env())
    mesh = parallel.data_parallel_mesh()
    is_chief = cluster.is_chief()
    print(f"devices: {mesh.size} ({device.type}), mesh={mesh.shape}",
          file=sys.stderr)

    (x_train, y_train), (x_val, y_val) = data.mnist(
        FLAGS.data_dir or None, flatten=True, seed=FLAGS.seed)

    model = models.mnist_mlp()
    optimizer = optim.adam(FLAGS.learning_rate)
    metric_fns = {"accuracy": "accuracy"}
    train_step = train.make_train_step(
        model, "sparse_categorical_crossentropy", optimizer,
        metric_fns=metric_fns, mesh=mesh, seed=FLAGS.seed)
    eval_step = train.make_eval_step(
        model, "sparse_categorical_crossentropy", metric_fns=metric_fns)

    batch_size = parallel.round_batch_to_mesh(FLAGS.batch_size, mesh)
    dataset = data.Dataset([x_train, y_train],
                           parallel.local_batch_size(batch_size, mesh),
                           seed=FLAGS.seed, process_index=mesh.rank,
                           process_count=mesh.size)
    state = train.init_train_state(
        model, optimizer, torch.Generator(device).manual_seed(FLAGS.seed),
        (784,))

    writer = SummaryWriter(FLAGS.log_dir) if is_chief else None
    hooks = [train.StopAtStepHook(last_step=FLAGS.epochs * len(dataset)),
             train.CheckpointHook(every_secs=120.0),
             train.LoggingHook(every_steps=max(10, len(dataset) // 2)),
             train.PreemptionHook()]
    if writer is not None:
        hooks.append(train.SummaryHook(writer, every_steps=10))

    val = (torch.from_numpy(x_val[:4096]).to(device),
           torch.from_numpy(y_val[:4096]).to(device))
    with train.TrainSession(state, train_step, checkpoint_dir=FLAGS.log_dir,
                            hooks=hooks, is_chief=is_chief) as sess:
        while not sess.should_stop():
            for batch in data.prefetch_to_device(iter(dataset),
                                                 device=device):
                if sess.should_stop():
                    break
                sess.run_step(batch)
        metrics = eval_step(sess.state, val)
        print(f"Final step {sess.step}: val loss {float(metrics['loss']):.4f}"
              f"  val accuracy {float(metrics['accuracy']):.4f}", flush=True)
    if writer is not None:
        writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
