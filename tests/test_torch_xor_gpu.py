"""``example.py``'s path on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs
as ``python -m pytest --noconftest -m gpu tests/test_torch_xor_gpu.py``.

- ``prefetch_to_device`` hands each batch to the compute stream only
  after its copy: a batch of 16 MB read on the compute stream as soon as
  the consumer has it (its copy on the side stream may still run)
  equals its source exactly.
- The XOR MLP's ``make_train_step`` makes no host sync in a step (dropout
  0.3, batches from ``prefetch_to_device``) and launches the Adam kernel
  6 times a step.
- The same step on the card equals the CPU's after 5 steps at dropout 0:
  losses within 1e-6 relative, parameters within 1e-5 absolute (f32, TF32
  off; summation order only).
"""
import warnings

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import data, ops, optim, train
from distributed_tensorflow_tpu_torch.models.convert import \
    stack_params_from_jax
from distributed_tensorflow_tpu_torch.ops.kernels import fused

pytestmark = pytest.mark.gpu

LOSS_RTOL, PARAM_TOL = 1e-6, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _model(rate):
    return ops.serial(ops.Dense(128, activation="relu"), ops.Dropout(rate),
                      ops.Dense(128, activation="relu"), ops.Dropout(rate),
                      ops.Dense(32, activation="sigmoid"))


def test_prefetched_batches_are_whole_when_read(cuda):
    """Each batch of 16 MB is read on the compute stream the moment the
    consumer has it, while its copy on the side stream may still run: the
    read waits for the copy's event."""
    rng = np.random.default_rng(0)
    src = [rng.standard_normal((2048, 2048)).astype(np.float32)
           for _ in range(4)]
    for want in src:
        gen = data.prefetch_to_device(iter([want, want]), size=1,
                                      device=cuda)
        got = next(gen)
        total = got.sum()
        assert got.device.type == "cuda"
        assert total.item() == pytest.approx(
            float(want.sum(dtype=np.float64)), rel=1e-4, abs=1e-2)
        assert torch.equal(got.cpu(), torch.from_numpy(want))
        assert torch.equal(next(gen).cpu(), torch.from_numpy(want))
        with pytest.raises(StopIteration):
            next(gen)


def test_xor_step_makes_no_host_sync(cuda):
    model, opt = _model(0.3), optim.adam()
    state = train.init_train_state(model, opt,
                                   torch.Generator(cuda).manual_seed(0),
                                   (64,))
    step = train.make_train_step(model, "mse", opt,
                                 metric_fns={"accuracy": "bitwise_accuracy"})
    (x, y), _ = data.xor_data(500, 1)
    batches = list(data.prefetch_to_device(
        iter(data.Dataset([x, y], 50)), device=cuda))
    state, _ = step(state, batches[0])          # warm-up
    torch.cuda.synchronize()
    fused.LAUNCHES.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for b in batches[1:]:
                state, m = step(state, b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message)
             and "prototype feature" not in str(w.message)]
    assert syncs == []
    assert fused.LAUNCHES["adam"] == 6 * (len(batches) - 1)
    assert torch.isfinite(m["loss"]).item()


def test_xor_step_on_the_card_equals_the_cpu(cuda):
    rng = np.random.default_rng(1)
    tree = {name: {"kernel": rng.uniform(-0.2, 0.2, (i, o)).astype(
                       np.float32),
                   "bias": rng.uniform(-0.05, 0.05, (o,)).astype(np.float32)}
            for name, (i, o) in (("dense", (64, 128)),
                                 ("dense_1", (128, 128)),
                                 ("dense_2", (128, 32)))}
    (x, y), _ = data.xor_data(250, 1, seed=1)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        opt = optim.adam()
        params = stack_params_from_jax(tree, device=dev)
        state = train.TrainState.create(params, opt.init(params), {})
        step = train.make_train_step(_model(0.0), "mse", opt)
        losses = []
        for i in range(0, 250, 50):
            state, m = step(state, (torch.from_numpy(x[i:i + 50]).to(dev),
                                    torch.from_numpy(y[i:i + 50]).to(dev)))
            losses.append(float(m["loss"]))
        out[dev.type] = (losses, {k: v.detach().cpu()
                                  for k, v in state.params.items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0],
                               rtol=LOSS_RTOL, atol=0)
    for k, v in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], v, atol=PARAM_TOL,
                                   rtol=0)
