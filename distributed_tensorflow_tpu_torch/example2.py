"""The high-level training entry point, in PyTorch: the port of
``example2.py``.

    python -m distributed_tensorflow_tpu_torch.example2 [--device=cuda]
        [--log_dir=...] [--epochs=N] [--batch_size=N] [--seed=N]

``example.py``'s XOR task and MLP as a ``Sequential`` (64→128→128→32,
relu, dropout 0.3, sigmoid), ``compile("mean_squared_error", "adam",
["bitwise_accuracy"], mesh=...)`` (Adam with TF-1.4 defaults, one launch
of the Adam kernel per parameter tensor on the card), ``fit`` with the
validation set and a ``TensorBoard`` callback, then ``evaluate``: 50
epochs of batch 50.  The same flags and environment variables as
``example2.py``, and the same cluster bootstrap as ``example.py``: with a
coordinator the ranks train data-parallel, each on its slice of every
global batch.  ``--log_dir``'s ``{}`` gets a timestamp.  The TensorBoard
callback writes on the chief only.

``--device`` is ``cuda`` by default and raises when there is no card;
``--device=cpu`` runs on the CPU.
"""
import os
import sys
from time import time

from distributed_tensorflow_tpu_torch.utils import flags as flags_lib
from distributed_tensorflow_tpu_torch.utils.flags import FLAGS

# Hyperparameters (example2.py's)
bits = 32
train_batch_size = 50
train_set_size = 30000
val_set_size = 1000
epochs = 50


def _define_flags() -> None:
    """The flags and their defaults, set again at each ``main`` (the
    package's entry points share one ``FLAGS`` registry)."""
    flags_lib.DEFINE_string("job_name", flags_lib.env_default("JOB_NAME",
                                                              None),
                            "Legacy role name ('ps' is refused)")
    flags_lib.DEFINE_integer("task_index",
                             flags_lib.env_default("TASK_INDEX", 0, int),
                             "Process index; 0 is chief")
    flags_lib.DEFINE_string("log_dir",
                            os.environ.get("LOG_DIR",
                                           os.path.join("logs", "xor2_{}")),
                            "TensorBoard/checkpoint dir; '{}' gets a "
                            "timestamp")
    flags_lib.DEFINE_string(
        "device", "cuda",
        "'cuda' (the default; raises without a card) or 'cpu'")
    flags_lib.DEFINE_integer("epochs", epochs, "Training epochs")
    flags_lib.DEFINE_integer("batch_size", train_batch_size,
                             "Global batch size")
    flags_lib.DEFINE_integer("seed", 0, "Seed of the data, weights and "
                             "dropout")


def main(argv=None) -> int:
    _define_flags()
    FLAGS.reset()
    FLAGS.parse(argv)

    from distributed_tensorflow_tpu_torch import data, models, ops, parallel
    from distributed_tensorflow_tpu_torch._launch import start
    from distributed_tensorflow_tpu_torch.parallel import cluster

    config = cluster.cluster_from_env()
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

    mesh = parallel.data_parallel_mesh()
    print(f"devices: {mesh.size} ({device.type}), mesh={mesh.shape}")

    model = models.Sequential(name="xor_mlp", device=device)
    model.add(ops.Dense(128, activation="relu"))
    model.add(ops.Dropout(0.3))
    model.add(ops.Dense(128, activation="relu"))
    model.add(ops.Dropout(0.3))
    model.add(ops.Dense(bits, activation="sigmoid"))
    model.compile(loss="mean_squared_error", optimizer="adam",
                  metrics=["bitwise_accuracy"], mesh=mesh, seed=FLAGS.seed)

    (x_train, y_train), (x_val, y_val) = data.xor_data(
        train_set_size, val_set_size, seed=FLAGS.seed)

    callbacks = []
    if cluster.is_chief():
        callbacks.append(models.TensorBoard(
            log_dir=FLAGS.log_dir.format(time())))

    model.fit(x_train, y_train, epochs=FLAGS.epochs,
              batch_size=FLAGS.batch_size,
              validation_data=(x_val, y_val),
              callbacks=callbacks, seed=FLAGS.seed)

    final = model.evaluate(x_val, y_val, batch_size=FLAGS.batch_size,
                           verbose=0)
    print(f"Final validation accuracy: {final['bitwise_accuracy']:.4f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
