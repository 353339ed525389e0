"""The port's named mesh, ring attention and ring-flash attention, held
against the JAX package.

- ``plan_mesh`` (the shape ``make_mesh`` builds) and each rank's
  coordinates equal the JAX ``make_mesh``'s axes and device positions on
  1 to 8 devices, ``-1`` wildcard included; the same errors raise.  A
  mesh of one process has every axis of size 1 and no group.
- Four spawned gloo ranks (once for the module) run
  ``ring_attention_sharded`` and ``ring_flash_attention_sharded`` on rings
  of 2 (the seq lines of a ``{"data": 2, "seq": 2}`` mesh) and of 4 (a
  ``{"seq": 4}`` mesh), causal, with a ``kv_valid`` that leaves whole
  shards all padding, and GQA (ring-flash only: the plain ring takes
  none, as in the JAX package).  Outputs equal the JAX package's
  ``ring_attention_sharded`` / ``ring_flash_attention_sharded`` on an XLA
  CPU mesh of the same size (its Pallas kernels in interpret mode) within
  1e-5, and the gradients of ``sum(out * do)`` for q, k and v within 1e-4
  (f32).  Every rank of a line holds the same global result.
- The flash ring's launches by route are exact: rank r of a causal ring
  runs r full blocks and one diag block, forward, dQ and dK/dV alike
  (R(R+1)/2 forwards over the ring); a bidirectional ring R blocks a
  rank.  A ring of one does no communication; a ``seq`` axis larger than
  the world raises.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel.ring import \
    ring_attention_sharded as jring
from distributed_tensorflow_tpu.parallel.ring_flash import \
    ring_flash_attention_sharded as jring_flash
from distributed_tensorflow_tpu_torch import parallel as tpar
from distributed_tensorflow_tpu_torch.ops.kernels import \
    flash_attention as flash_lib
from distributed_tensorflow_tpu_torch.parallel import ring as tring
from distributed_tensorflow_tpu_torch.parallel import ring_flash as tflash

import torch_sp_worker

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
RINGS = (2, 4)


def _case(seed, b, s, h, hk, d, causal, pad=None):
    rng = np.random.default_rng(seed)
    c = {"q": rng.standard_normal((b, s, h, d)).astype(np.float32),
         "k": rng.standard_normal((b, s, hk, d)).astype(np.float32),
         "v": rng.standard_normal((b, s, hk, d)).astype(np.float32),
         "do": rng.standard_normal((b, s, h, d)).astype(np.float32),
         "causal": causal, "valid": None}
    if pad is not None:
        valid = np.ones((b, s), np.bool_)
        for row, n in enumerate(pad):
            valid[row, s - n:] = False
        c["valid"] = valid
    return c


# s 16: shards of 8 (R = 2) and 4 (R = 4).  "padded" leaves the last 8 keys
# of row 0 padding: one whole shard of the ring of 2, two of the ring of 4.
CASES = {
    "causal": _case(0, 2, 16, 2, 2, 8, True),
    "padded": _case(1, 2, 16, 2, 2, 8, False, pad=(8, 3)),
    "padded_causal": _case(2, 1, 16, 2, 2, 8, True, pad=(8,)),
    "gqa": _case(3, 1, 16, 4, 2, 8, True),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_sp_worker.spawn_ranks(
        tmp_path_factory.mktemp("ring"), torch_sp_worker.run_ring_rank,
        (CASES,))


def _jax_run(kind, c, n):
    """(out, (dq, dk, dv)) of the JAX sharded ring on an n-device mesh."""
    mesh = jmesh.make_mesh({"seq": n}, jax.devices()[:n])
    fn = jring if kind == "ring" else jring_flash
    valid = None if c["valid"] is None else jnp.asarray(c["valid"])

    def f(q, k, v):
        return fn(q, k, v, mesh, "seq", causal=c["causal"], kv_valid=valid)
    out, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(c[t])
                                     for t in ("q", "k", "v")))
    return np.asarray(out), [np.asarray(g)
                             for g in vjp(jnp.asarray(c["do"]))]


# the plain ring takes no GQA, in either package
RUNS = [(name, kind, n) for name in CASES for kind in ("ring", "flash")
        for n in RINGS if kind == "flash" or name != "gqa"]


@pytest.mark.parametrize("name,kind,n", RUNS)
def test_ring_equals_jax_mesh(ranks, name, kind, n):
    c = CASES[name]
    key = f"{name}_R{n}_{kind}"
    want_out, want_grads = _jax_run(kind, c, n)
    for r in ranks:
        np.testing.assert_allclose(r[key + "_out"], want_out, atol=FWD_TOL,
                                   rtol=0, err_msg=key)
        for t, want in zip(("dq", "dk", "dv"), want_grads):
            np.testing.assert_allclose(r[f"{key}_{t}"], want, atol=GRAD_TOL,
                                       rtol=0, err_msg=f"{key} {t}")
        assert np.all(np.isfinite(r[key + "_out"]))


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("name", list(CASES))
def test_flash_ring_launches_by_route(ranks, name, n):
    causal = CASES[name]["causal"]
    key = f"{name}_R{n}_flash_launch_"
    for rank, r in enumerate(ranks):
        my = rank % n                       # the seq coordinate
        want = {"full": my, "diag": 1} if causal else {"full": n, "diag": 0}
        for part in ("forward", "dq", "dkv"):
            for route, count in want.items():
                got = int(r.get(f"{key}{part}_{route}", 0))
                assert got == count, (rank, part, route, got)
    total = sum(int(r.get(key + "forward_full", 0))
                + int(r.get(key + "forward_diag", 0)) for r in ranks)
    rings = len(ranks) // n
    assert total == rings * (n * (n + 1) // 2 if causal else n * n)


def test_mesh_layout_on_the_ranks(ranks):
    for rank, r in enumerate(ranks):
        # row-major: rank = data * 2 + seq on the 2 x 2 mesh
        np.testing.assert_array_equal(r["mesh_R2_coords"],
                                      [rank // 2, rank % 2])
        np.testing.assert_array_equal(r["mesh_R2_line"],
                                      [rank - rank % 2, rank - rank % 2 + 1])
        np.testing.assert_array_equal(r["mesh_R4_coords"], [0, rank])
        np.testing.assert_array_equal(r["mesh_R4_line"], [0, 1, 2, 3])
        assert "require 8 devices, have 4" in str(r["too_big"])
        assert int(r["p2p"]) > 0


AXES = [None, {"data": -1}, {"seq": -1}, {"data": 2, "seq": -1},
        {"seq": 2, "data": -1}, {"pipe": 2, "data": -1, "tensor": 2},
        {"fsdp": -1, "expert": 1, "seq": 2},
        {"tensor": 2, "seq": 2, "data": -1, "pipe": 1}]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("axes", AXES, ids=str)
def test_plan_mesh_and_coordinates_equal_jax(axes, n):
    devices = jax.devices()[:n]
    try:
        want = jmesh.make_mesh(axes, devices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpar.plan_mesh(axes, n)
        assert str(got.value) == str(e)
        return
    shape = tpar.plan_mesh(axes, n)
    assert shape == dict(want.shape)
    assert tuple(shape) == tuple(want.axis_names)
    for rank in range(n):
        m = tpar.Mesh(n, rank, None, axes=shape, lines={})
        pos = np.argwhere(np.vectorize(lambda d: d.id)(want.devices)
                          == devices[rank].id)[0]
        assert [m.axis_index(a) for a in shape] == list(pos)
        assert m.data_index == (m.axis_index("data") * m.axis_size("fsdp")
                                + m.axis_index("fsdp"))


@pytest.mark.parametrize("axes", [{"seq": 3, "data": -1}, {"a": 1},
                                  {"data": -1, "seq": -1}, {"seq": 16}],
                         ids=str)
def test_plan_mesh_errors_equal_jax(axes):
    devices = jax.devices()[:8]
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(axes, devices)
    with pytest.raises(ValueError) as got:
        tpar.plan_mesh(axes, 8)
    assert str(got.value) == str(want.value)
    assert tpar.MeshConfig(dict(axes)).total() == jmesh.MeshConfig(
        dict(axes)).total()


def test_mesh_of_one_process_and_ring_of_one():
    """No process group: every axis has size 1 and no group; a ring of one
    is the flash kernel's plain version on the whole sequence and sends
    nothing; a ``seq`` axis of 2 raises."""
    assert not torch.distributed.is_initialized()
    mesh = tpar.make_mesh({"seq": 1})
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.shape == {"seq": 1} and mesh.axis_size("data") == 1
    assert mesh.axis_group("seq") is None
    with pytest.raises(ValueError, match="require 2 devices, have 1"):
        tpar.make_mesh({"seq": 2})
    c = CASES["padded_causal"]
    q, k, v = (torch.from_numpy(c[t]).requires_grad_(True)
               for t in ("q", "k", "v"))
    p2p = tring.LAUNCHES["p2p"]
    out = tflash.ring_flash_attention_sharded(
        q, k, v, mesh, causal=True, kv_valid=torch.from_numpy(c["valid"]))
    ref = flash_lib.flash_attention_plain(q, k, v,
                                          torch.from_numpy(c["valid"]), True)
    np.testing.assert_allclose(out.detach(), ref.detach(), atol=FWD_TOL,
                               rtol=0)
    plain = tring.ring_attention_sharded(q, k, v, mesh, causal=True)
    np.testing.assert_allclose(
        plain.detach(), flash_lib.flash_attention_plain(q, k, v, None,
                                                        True).detach(),
        atol=FWD_TOL, rtol=0)
    assert tring.LAUNCHES["p2p"] == p2p
