"""The CIFAR-10 CNN entry point (high-level tier), in PyTorch: the port of
``outline_keras.py``.

    python -m distributed_tensorflow_tpu_torch.outline_keras [--device=cuda]
        [--epochs=N] [--batch_size=N] [--steps_per_execution=K]
        [--data_dir=...] [--log_dir=...] [--seed=N]

``models.cifar_cnn`` (four 3x3 convs, two max pools, Dense(256), dropout
0.5, Dense(10); 12 parameter tensors) through ``Sequential`` with
``sparse_categorical_crossentropy``, ``adam`` and ``accuracy``; the
standard CIFAR augment (``random_crop(4)`` then ``random_flip_lr()``, on
the host, on the prefetch thread); a validation slice of 4096 each
epoch, then ``evaluate`` on the whole test set.  10 epochs of batch 256.
Real CIFAR-10 files in ``--data_dir`` are used when present; otherwise
the synthetic stand-in (``data.cifar10``).  With a coordinator in the
environment the ranks train data-parallel.  The TensorBoard callback
writes on the chief only.

``--device`` is ``cuda`` by default and raises when there is no card;
``--device=cpu`` runs on the CPU.
"""
import os
import sys
from time import time

from distributed_tensorflow_tpu_torch.utils import flags as flags_lib
from distributed_tensorflow_tpu_torch.utils.flags import FLAGS


def _define_flags() -> None:
    """The flags and their defaults, set again at each ``main`` (the
    package's entry points share one ``FLAGS`` registry)."""
    flags_lib.DEFINE_string(
        "device", "cuda",
        "'cuda' (the default; raises without a card) or 'cpu'")
    flags_lib.DEFINE_string("data_dir", os.environ.get("DATA_DIR", ""),
                            "Directory with CIFAR-10 files")
    flags_lib.DEFINE_string("log_dir",
                            os.environ.get("LOG_DIR",
                                           os.path.join("logs", "cifar_{}")),
                            "TensorBoard directory; '{}' gets a timestamp")
    flags_lib.DEFINE_integer("epochs", 10, "Training epochs")
    flags_lib.DEFINE_integer("batch_size", 256, "Global batch size")
    flags_lib.DEFINE_integer("steps_per_execution", 1,
                             "Optimizer updates per dispatch in the JAX "
                             "package; fit runs single steps at every K")
    flags_lib.DEFINE_integer("seed", 0, "Seed of the data, weights, "
                             "dropout and augment")


def main(argv=None) -> int:
    _define_flags()
    FLAGS.reset()
    FLAGS.parse(argv)

    from distributed_tensorflow_tpu_torch import data, models, parallel
    from distributed_tensorflow_tpu_torch._launch import start
    from distributed_tensorflow_tpu_torch.parallel import cluster

    device = start(FLAGS.device, cluster.cluster_from_env())
    mesh = parallel.data_parallel_mesh()
    print(f"devices: {mesh.size} ({device.type}), mesh={mesh.shape}",
          file=sys.stderr)

    (x_train, y_train), (x_val, y_val) = data.cifar10(FLAGS.data_dir or None,
                                                      seed=FLAGS.seed)

    model = models.Sequential(models.cifar_cnn().layers, name="cifar_cnn",
                              device=device)
    model.compile(loss="sparse_categorical_crossentropy", optimizer="adam",
                  metrics=["accuracy"], mesh=mesh, seed=FLAGS.seed,
                  steps_per_execution=FLAGS.steps_per_execution)

    callbacks = []
    if cluster.is_chief():
        callbacks.append(models.TensorBoard(
            log_dir=FLAGS.log_dir.format(time())))
    # pad-reflect crop + horizontal flip, on the host, beside the card
    train_augment = data.augment.compose(data.augment.random_crop(4),
                                         data.augment.random_flip_lr())
    model.fit(x_train, y_train, epochs=FLAGS.epochs,
              batch_size=FLAGS.batch_size,
              validation_data=(x_val[:4096], y_val[:4096]),
              callbacks=callbacks, seed=FLAGS.seed,
              augment=train_augment)

    final = model.evaluate(x_val, y_val, batch_size=FLAGS.batch_size,
                           verbose=0)
    print(f"Final validation accuracy: {final['accuracy']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
