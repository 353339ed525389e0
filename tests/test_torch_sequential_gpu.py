"""The high-level tier on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs
as ``python -m pytest --noconftest -m gpu tests/test_torch_sequential_gpu.py``.

- The conv, pool, norm and recurrent layers on the card against the CPU
  on the same weights and input, with TF32 off in cuBLAS and cuDNN:
  outputs and the gradients of ``sum(y * r)`` (parameters and input)
  within ``1e-5 * max(1, max |want|)`` (f32; summation order only).
- ``fit`` launches the Adam kernel once a leaf a step (6 leaves of
  ``[Dense(128), LayerNorm(fused="auto"), Dense(10)]``) and the LayerNorm
  kernel once a forward (the training steps' forwards, then one per
  ``evaluate`` batch), and nothing else of the port's kernels.
- ``steps_per_execution=8`` on the CIFAR CNN (dropout 0.5) leaves the
  parameters bit-equal to ``steps_per_execution=1`` after one epoch
  (cuDNN deterministic, so that equal calls give equal bits).
"""
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import data, models, ops
from distributed_tensorflow_tpu_torch.ops.kernels import fused

pytestmark = pytest.mark.gpu

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = saved


def _close(got, want, what):
    want = want.detach().cpu().double()
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = float((got.detach().cpu().double() - want).abs().max()) \
        if want.numel() else 0.0
    assert err <= TOL * scale, (what, err, scale)


LAYERS = {
    "conv2d_same_s2": (lambda: ops.Conv2D(8, 3, strides=2), (9, 9, 3)),
    "conv2d_valid": (lambda: ops.Conv2D(8, 4, padding="VALID"), (9, 8, 3)),
    "conv1d": (lambda: ops.Conv1D(6, 4, strides=2), (11, 5)),
    "depthwise": (lambda: ops.DepthwiseConv2D(3, depth_multiplier=2),
                  (7, 7, 4)),
    "separable": (lambda: ops.SeparableConv2D(5, 3, strides=2), (8, 8, 3)),
    "maxpool_same": (lambda: ops.MaxPool2D(3, 2, padding="SAME"),
                     (7, 7, 3)),
    "avgpool_same": (lambda: ops.AvgPool2D(3, 2, padding="SAME"),
                     (7, 7, 3)),
    "global_avg": (lambda: ops.GlobalAvgPool(), (5, 6, 3)),
    "batchnorm": (lambda: ops.BatchNorm(), (4, 4, 3)),
    "layernorm": (lambda: ops.LayerNorm(fused="auto"), (129,)),
    "lstm": (lambda: ops.LSTM(8, return_sequences=True), (6, 4)),
    "gru": (lambda: ops.GRU(8), (6, 4)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_on_the_card_equals_the_cpu(cuda, name):
    make, in_shape = LAYERS[name]
    layer = make()
    params, state = layer.init(torch.Generator().manual_seed(0), in_shape)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3,) + in_shape).astype(np.float32))
    runs = []
    for dev in ("cpu", cuda):
        p = {k: v.detach().to(dev).requires_grad_(True)
             if torch.is_tensor(v)
             else {kk: vv.detach().to(dev).requires_grad_(True)
                   for kk, vv in v.items()} for k, v in params.items()}
        s = {k: v.to(dev) for k, v in state.items()}
        xt = x.detach().to(dev).requires_grad_(True)
        y, _ = layer.apply(p, s, xt, train=True)
        r = torch.linspace(-1, 1, y.numel()).reshape(y.shape).to(dev)
        leaves = [v for v in p.values() if torch.is_tensor(v)] + [
            vv for v in p.values() if isinstance(v, dict)
            for vv in v.values()]
        grads = torch.autograd.grad((y * r).sum(), leaves + [xt])
        runs.append((y, grads))
    (y_cpu, g_cpu), (y_card, g_card) = runs
    _close(y_card, y_cpu, "output")
    for i, (a, b) in enumerate(zip(g_card, g_cpu)):
        _close(a, b, f"grad {i}")


def test_fit_launches_adam_per_leaf_and_layernorm_per_forward(cuda):
    (x, y), (xv, yv) = data.synthetic_image_classes((784,), 10, 512, 96,
                                                    seed=0)
    model = models.Sequential([ops.Dense(128, activation="relu"),
                               ops.LayerNorm(fused="auto"),
                               ops.Dense(10)], device=cuda)
    model.compile("sparse_categorical_crossentropy", "adam", ["accuracy"])
    model.build((784,))
    fused.LAUNCHES.clear()
    model.fit(x, y, epochs=1, batch_size=64, verbose=0)
    torch.cuda.synchronize()
    assert dict(fused.LAUNCHES) == {"adam": 6 * 8, "layernorm": 8}
    fused.LAUNCHES.clear()
    model.evaluate(xv, yv, batch_size=32, verbose=0)
    assert dict(fused.LAUNCHES) == {"layernorm": 3}


def test_steps_per_execution_8_is_bit_equal_on_the_card(cuda):
    (x, y), _ = data.synthetic_image_classes((32, 32, 3), 10, 24 * 32, 1,
                                             seed=0)
    runs = []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for spe in (1, 8):
        model = models.Sequential(models.cifar_cnn().layers, device=cuda)
        model.compile("sparse_categorical_crossentropy", "adam",
                      ["accuracy"], steps_per_execution=spe)
        model.build((32, 32, 3))
        h = model.fit(x, y, epochs=1, batch_size=32, verbose=0)
        runs.append((h.history, model.get_weights()))
    torch.backends.cudnn.deterministic = saved
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)
