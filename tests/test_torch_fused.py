"""The port's LayerNorm (plain version) held against the JAX kernel.

Inputs from one numpy seed go through ``fused_layernorm`` of the JAX
package (Pallas, interpret mode off a TPU) and the port's
``fused_layernorm``, which takes its plain version (the f32 formula) for
CPU tensors.  Tolerance 1e-5 absolute at f32 (another summation order);
at bf16 the outputs may differ by one bf16 ulp at unit scale (2**-7),
from rounding the f32 result at another place.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_tensorflow_tpu.ops.pallas import fused as jfused
from distributed_tensorflow_tpu_torch.ops.kernels import fused as tfused

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(256, 768), (8, 768), (2, 3, 128)],
                         ids=["window", "decode", "3d"])
def test_layernorm_matches_pallas_kernel(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape, dtype=np.float32) * 3 + 0.5)
    d = shape[-1]
    gamma = rng.standard_normal(d, dtype=np.float32)
    beta = rng.standard_normal(d, dtype=np.float32)
    want = jfused.fused_layernorm(jnp.asarray(x), jnp.asarray(gamma),
                                  jnp.asarray(beta), eps=1e-5)
    got = tfused.fused_layernorm(torch.from_numpy(x), torch.from_numpy(gamma),
                                 torch.from_numpy(beta), eps=1e-5)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_layernorm_bf16_output_type_and_agreement():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 768), dtype=np.float32)
    gamma = np.ones(768, np.float32)
    beta = np.zeros(768, np.float32)
    want = jfused.fused_layernorm(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(gamma), jnp.asarray(beta))
    got = tfused.fused_layernorm(torch.from_numpy(x).to(torch.bfloat16),
                                 torch.from_numpy(gamma),
                                 torch.from_numpy(beta))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2 ** -6,
                               rtol=0)


def test_cpu_wrapper_launches_nothing():
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    before = dict(tfused.LAUNCHES)
    out = tfused.fused_layernorm(x, torch.ones(32), torch.zeros(32))
    assert torch.equal(out, tfused.layernorm_plain(x, torch.ones(32),
                                                   torch.zeros(32)))
    assert dict(tfused.LAUNCHES) == before


@pytest.mark.parametrize("shape", [(32, 4096), (8, 4096), (2, 3, 128)],
                         ids=["window", "decode", "3d"])
def test_rmsnorm_matches_pallas_kernel(shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape, dtype=np.float32) * 3 + 0.5
    gamma = rng.standard_normal(shape[-1], dtype=np.float32)
    want = jfused.fused_rmsnorm(jnp.asarray(x), jnp.asarray(gamma), eps=1e-5)
    got = tfused.fused_rmsnorm(torch.from_numpy(x), torch.from_numpy(gamma),
                               eps=1e-5)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_rmsnorm_bf16_output_type_and_agreement():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 4096), dtype=np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(4096)).astype(np.float32)
    want = jfused.fused_rmsnorm(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(gamma))
    got = tfused.fused_rmsnorm(torch.from_numpy(x).to(torch.bfloat16),
                               torch.from_numpy(gamma))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2 ** -6,
                               rtol=0)


def test_rmsnorm_gradient_matches_jax():
    """The backward recomputes through the plain version, as the JAX
    ``_rmsnorm_bwd`` takes the vjp of its reference."""
    import jax
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 64), dtype=np.float32)
    gamma = rng.standard_normal(64, dtype=np.float32)
    g = rng.standard_normal((6, 64), dtype=np.float32)
    _, vjp = jax.vjp(lambda a, b: jfused.fused_rmsnorm(a, b, eps=1e-5),
                     jnp.asarray(x), jnp.asarray(gamma))
    want_dx, want_dg = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(gamma).requires_grad_()
    tfused.fused_rmsnorm(tx, tg, eps=1e-5).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(want_dg),
                               atol=1e-5, rtol=0)


def test_rmsnorm_cpu_wrapper_launches_nothing():
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(1))
    before = dict(tfused.LAUNCHES)
    out = tfused.fused_rmsnorm(x, torch.ones(32))
    assert torch.equal(out, tfused.rmsnorm_plain(x, torch.ones(32)))
    assert dict(tfused.LAUNCHES) == before


@pytest.mark.parametrize("grad_enabled,requires_grad,want", [
    (True, (False, False, False), False),
    (True, (True, False, False), True),
    (True, (False, False, True), True),
    (False, (True, True, True), False)],
    ids=["no-input-needs-grad", "x-needs-grad", "beta-needs-grad",
         "under-no-grad"])
def test_layernorm_direct_launch_only_when_autograd_would_not_record(
        grad_enabled, requires_grad, want):
    """``fused_layernorm`` launches a CUDA call directly when this is
    False and through ``_LayerNorm.apply`` (kernel forward, plain
    backward) when it is True."""
    tensors = [torch.ones(4, 8).requires_grad_(r) for r in requires_grad]
    with torch.set_grad_enabled(grad_enabled):
        assert tfused._needs_grad(*tensors) is want


def test_layernorm_cpu_under_no_grad_is_the_plain_version():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 32, generator=gen).requires_grad_()
    gamma, beta = torch.randn(32, generator=gen), torch.randn(32,
                                                              generator=gen)
    before = dict(tfused.LAUNCHES)
    with torch.no_grad():
        out = tfused.fused_layernorm(x, gamma, beta, 1e-5)
    assert not out.requires_grad
    assert torch.equal(out, tfused.layernorm_plain(x, gamma, beta,
                                                   1e-5).detach())
    assert dict(tfused.LAUNCHES) == before


def test_bind_types_a_c_function_once_and_caches_it(monkeypatch):
    """``_build.bind`` loads the library and sets restype/argtypes on the
    first call only; later calls return the same typed function object
    without touching the loader.  The C library of this process stands in
    for a kernel library."""
    import ctypes
    from distributed_tensorflow_tpu_torch.ops.kernels import _build
    loads = []

    def fake_load(name):
        loads.append(name)
        return ctypes.CDLL(None)
    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(_build, "_bound", {})
    fn = _build.bind("libc", "abs", [ctypes.c_int])
    assert fn.restype is ctypes.c_int and fn.argtypes == [ctypes.c_int]
    assert fn(-7) == 7
    assert _build.bind("libc", "abs", [ctypes.c_int]) is fn
    assert loads == ["libc"]
