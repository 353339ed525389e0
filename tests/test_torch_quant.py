"""The port's int8 quantization held against the JAX package's ops/quant.py.

The same numpy tensors (one seed) go through both.  The int8 values are
exactly equal and the scales agree to 1e-7 relative: both compute
``max(amax / 127, 1e-12)`` in f32 and round half to even.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_tensorflow_tpu.ops import quant as jquant
from distributed_tensorflow_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)


def _check(got: tquant.QTensor, want: jquant.QTensor):
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-7, atol=0)


@pytest.mark.parametrize("shape,axes", [
    ((2, 5, 3, 16), (-1,)),            # the KV write: per (token, head)
    ((4, 6, 8), "auto"),               # a stacked kernel: keeps L and out
    ((32, 24), "auto"),                # a matrix: per output channel
    ((40,), "auto"),                   # a vector: one scale
    ((6, 10), None),                   # explicit whole-tensor scale
    ((3, 4, 5), (0, 2)),
])
def test_quantize_and_dequantize_match_jax(shape, axes):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape, dtype=np.float32) * 3
    w.reshape(-1)[::7] = 0.0
    want = jquant.quantize_tensor(jnp.asarray(w), reduce_axes=axes)
    got = tquant.quantize_tensor(torch.from_numpy(w), reduce_axes=axes)
    _check(got, want)
    np.testing.assert_allclose(
        tquant.dequantize_tensor(got).numpy(),
        np.asarray(jquant.dequantize_tensor(want)), rtol=0, atol=0)


def test_round_half_to_even_and_zero_slices():
    """Values at exactly k + 0.5 steps round to even, as jnp.round does;
    an all-zero slice gets the 1e-12 floor and quantizes to 0."""
    w = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5],
                  [0.0] * 6], np.float32)
    want = jquant.quantize_tensor(jnp.asarray(w), reduce_axes=(-1,))
    got = tquant.quantize_tensor(torch.from_numpy(w), reduce_axes=(-1,))
    _check(got, want)
    assert got.q[0].tolist() == [127, 0, 2, 2, 0, -2]
    assert got.q[1].abs().sum() == 0 and got.scale[1, 0] == 1e-12


def test_quantize_tree_matches_jax():
    rng = np.random.default_rng(1)
    tree = {"dense": {"kernel": rng.standard_normal((64, 32), np.float32),
                      "bias": rng.standard_normal((32,), np.float32)},
            "stack": [rng.standard_normal((2, 32, 48), np.float32),
                      rng.standard_normal((4, 4), np.float32)]}
    jtree = {"dense": {k: jnp.asarray(v) for k, v in tree["dense"].items()},
             "stack": [jnp.asarray(v) for v in tree["stack"]]}
    ttree = {"dense": {k: torch.from_numpy(v)
                       for k, v in tree["dense"].items()},
             "stack": [torch.from_numpy(v) for v in tree["stack"]]}
    want = jquant.quantize_tree(jtree)
    got = tquant.quantize_tree(ttree)
    _check(got["dense"]["kernel"], want["dense"]["kernel"])
    _check(got["stack"][0], want["stack"][0])
    # biases and small tensors stay as they are
    assert got["dense"]["bias"] is ttree["dense"]["bias"]
    assert got["stack"][1] is ttree["stack"][1]
    assert tquant.quantize_tree(got)["dense"]["kernel"] \
        is got["dense"]["kernel"]
    assert tquant.quantized_bytes(got) == jquant.quantized_bytes(want)
    back = tquant.dequantize_tree(got)
    jback = jquant.dequantize_tree(want)
    np.testing.assert_array_equal(back["stack"][0].numpy(),
                                  np.asarray(jback["stack"][0]))
    assert back["dense"]["kernel"].dtype == torch.float32
