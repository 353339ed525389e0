"""ViT image classification, in PyTorch: the port of
``examples/train_vit.py``.

    python -m distributed_tensorflow_tpu_torch.examples.train_vit
        [--device=cuda] [--steps=300] [--batch_size=64] [--seed=0]

A small ViT (32x32 images in 8x8 patches, d 64, 4 layers of 4 heads of
16, FFN 128, dropout 0.1, f32) trained data-parallel with ``adamw`` under
``warmup_cosine_decay(3e-3, 20, steps)`` and a global-norm clip of 1.0
on a synthetic task (which quadrant holds the bright 8x8 patch), then
evaluated on 256 held-out images.  The data come from numpy's generator
seeded with ``--seed``, as in the JAX script.

Every attention (17 tokens: one ragged tile) runs the flash kernel at
head dim 16 (zero-padded to 64 in its wrapper) and every LayerNorm the
LayerNorm kernel; Adam runs its kernel on every leaf.

``--device`` is ``cuda`` by default and raises when there is no card;
``--device=cpu`` runs on the CPU.
"""
import sys

from distributed_tensorflow_tpu_torch.utils import flags as flags_lib
from distributed_tensorflow_tpu_torch.utils.flags import FLAGS

SIZE = 32
CLASSES = 4


def _define_flags() -> None:
    flags_lib.DEFINE_string(
        "device", "cuda",
        "'cuda' (the default; raises without a card) or 'cpu'")
    flags_lib.DEFINE_integer("steps", 300, "training steps")
    flags_lib.DEFINE_integer("batch_size", 64, "global batch size")
    flags_lib.DEFINE_integer("seed", 0, "data/init seed")


def make_batch(rng, batch):
    """Class = quadrant of a bright 8x8 patch on a noisy background."""
    x = rng.normal(0.0, 0.2, (batch, SIZE, SIZE, 3)).astype("float32")
    y = rng.integers(0, CLASSES, batch).astype("int32")
    half = SIZE // 2
    for i in range(batch):
        r = (y[i] // 2) * half + rng.integers(0, half - 8)
        c = (y[i] % 2) * half + rng.integers(0, half - 8)
        x[i, r:r + 8, c:c + 8] += 1.0
    return x, y


def main(argv=None) -> int:
    _define_flags()
    FLAGS.reset()
    FLAGS.parse(argv)

    import numpy as np
    import torch

    from distributed_tensorflow_tpu_torch import optim, parallel, train
    from distributed_tensorflow_tpu_torch._launch import start
    from distributed_tensorflow_tpu_torch.examples import local_rows
    from distributed_tensorflow_tpu_torch.models.vit import ViT, ViTConfig
    from distributed_tensorflow_tpu_torch.parallel import cluster

    device = start(FLAGS.device, cluster.cluster_from_env())
    mesh = parallel.data_parallel_mesh()
    print(f"devices: {mesh.size} ({device.type}), mesh={mesh.shape}",
          file=sys.stderr)

    model = ViT(ViTConfig(image_size=SIZE, patch_size=8, channels=3,
                          num_classes=CLASSES, hidden_size=64, num_layers=4,
                          num_heads=4, intermediate_size=128,
                          dropout_rate=0.1))
    params = model.init(torch.Generator(device).manual_seed(FLAGS.seed))
    optimizer = optim.adamw(optim.schedules.warmup_cosine_decay(
        3e-3, 20, FLAGS.steps), mask=model.decay_mask)
    state = train.TrainState.create(params, optimizer.init(params))
    step = train.make_custom_train_step(model.loss_fn(), optimizer,
                                        seed=FLAGS.seed, mesh=mesh,
                                        grad_clip_norm=1.0)

    rng = np.random.default_rng(FLAGS.seed)
    batch = parallel.round_batch_to_mesh(FLAGS.batch_size, mesh)
    for i in range(FLAGS.steps):
        x, y = local_rows(make_batch(rng, batch), mesh)
        state, metrics = step(state, (torch.from_numpy(x).to(device),
                                      torch.from_numpy(y).to(device)))
        if (i + 1) % 20 == 0:
            print(f"step {i + 1}: loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f}", flush=True)

    x, y = make_batch(np.random.default_rng(FLAGS.seed + 1), 256)
    with torch.no_grad():
        logits = model.apply(state.params, torch.from_numpy(x).to(device))
    acc = float(np.mean(logits.argmax(-1).cpu().numpy() == y))
    print(f"eval accuracy: {acc:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
