"""The port's ``parallel/pipeline.py`` held against the JAX package's.

The same numpy stages (``tanh(x @ w + b)``, the JAX test's stage) and
inputs go through the JAX functions on the conftest's 8-device CPU mesh
(a ``pipe`` axis of S devices, f32) and through the port on gloo ranks:
S = 2 as the two pipe lines of a ``{"pipe": 2, "data": 2}`` mesh of 4
ranks, S = 4 as one line of 4 (one spawn of 4 ranks for the module,
started before the JAX side is computed; worker
``tests/torch_pp_worker.py``).  A rank's gradient of the stacked params
is its stage's row of the JAX gradient.  Tolerances: outputs, ``dx`` and
gradients atol 1e-5, losses rtol 1e-5 (f32); a bf16 stage 2e-2 (the JAX
test's).

- GPipe (``pipeline_apply``): the output, the gradients of ``mean(out **
  2)`` and ``dx`` at M = 4, one microbatch, more microbatches than stages
  (M = 8), a bf16 batch through f32 stages (the carry promotes to f32),
  and the forward under ``torch.no_grad``; this rank's ``[1, ...]``
  blocks cut by ``shard_pytree`` under ``pipeline_rules_spec``.
- 1F1B (``pipeline_value_and_grad``): loss, gradients and ``dx`` against
  the JAX 1F1B and ``jax.value_and_grad`` through the JAX GPipe, at M = 6,
  with fewer microbatches than stages, with ``aux_params`` and
  ``microbatch_weights``, and with a bf16 stage on f32 carries.
- The exchanges a pass are exact (one ``batch_isend_irecv`` a tick with
  any traffic, ``chip_smoke.pp_collectives``; three broadcasts), and a
  stage keeps at most ``min(M, 2S - 1)`` inputs (the pass raises
  otherwise).
- In this process: a line of one runs the stages in order; a stage count
  that does not match the line, a batch M does not divide and
  ``microbatch_weights`` of the wrong shape raise in both packages;
  ``stack_pipeline_params`` and ``pipeline_rules_spec`` match the JAX
  package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.parallel import make_mesh as jmake_mesh
from distributed_tensorflow_tpu.parallel import pipeline as jpl
from distributed_tensorflow_tpu_torch import parallel
from distributed_tensorflow_tpu_torch.parallel import pipeline as tpl

import chip_smoke
import torch_pp_worker
import torch_sp_worker

torch.set_num_threads(1)

HID = 16
ATOL, LOSS_RTOL, BF16_TOL = 1e-5, 1e-5, 2e-2


def _stages(n, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(HID, HID)) * 0.5).astype(np.float32),
             "b": (rng.normal(size=(HID,)) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _stacked(stages):
    return {k: np.stack([s[k] for s in stages]) for k in stages[0]}


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _case(kind, M, batch, seed, stages=(2, 4), out=HID, **extra):
    case = {"kind": kind, "M": M, "stages": stages,
            "x": _normal(seed, batch, HID)}
    for S in stages:
        case[f"stacked{S}"] = _stacked(_stages(S, seed + S))
    if kind == "1f1b":
        case["y"] = np.tanh(_normal(seed + 1, batch, out))
    case.update(extra)
    return case


CASES = {
    "apply": _case("apply", 4, 24, 1),
    "one_microbatch": _case("apply", 1, 6, 2),
    "many_microbatches": _case("apply", 8, 32, 3),
    "mixed_carry": _case("apply", 2, 8, 4, x_bf16=True),
    "1f1b": _case("1f1b", 6, 24, 5),
    "1f1b_few_microbatches": _case("1f1b", 2, 8, 6),
    "1f1b_aux_weights": _case("1f1b", 4, 16, 7, out=8,
                              head=_normal(8, HID, 8) * 0.3,
                              weights=np.array([0.1, 0.2, 0.3, 0.4],
                                               np.float32)),
    "1f1b_bf16_stage": _case("1f1b", 2, 8, 9, bf16_stage=True),
}
APPLY = [n for n, c in CASES.items() if c["kind"] == "apply"]
ONE_F = [n for n, c in CASES.items() if c["kind"] == "1f1b"]


def _jstage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _jbf16_stage(params, x):
    return jnp.tanh(x.astype(jnp.bfloat16) @ params["w"].astype(jnp.bfloat16)
                    + params["b"].astype(jnp.bfloat16))


def _jmesh(S):
    return jmake_mesh({"pipe": S}, jax.devices()[:S])


def _jax_apply(case, S):
    stacked = jax.tree.map(jnp.asarray, case[f"stacked{S}"])
    x = jnp.asarray(case["x"])
    if case.get("x_bf16"):
        x = x.astype(jnp.bfloat16)
    mesh = _jmesh(S)

    def loss(stacked, x):
        out = jpl.pipeline_apply(_jstage, stacked, x, mesh, case["M"])
        return (out.astype(jnp.float32) ** 2).mean(), out
    (_, out), (g, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stacked, x)
    return {"out": np.asarray(out, np.float32), "dtype": str(out.dtype),
            "g": jax.tree.map(np.asarray, g),
            "dx": np.asarray(dx.astype(jnp.float32))}


def _jax_1f1b(case, S):
    stacked = jax.tree.map(jnp.asarray, case[f"stacked{S}"])
    x, y = jnp.asarray(case["x"]), jnp.asarray(case["y"])
    mesh = _jmesh(S)
    stage = _jbf16_stage if case.get("bf16_stage") else _jstage
    if "head" in case:
        aux = {"head": jnp.asarray(case["head"])}

        def loss_fn(a, out, yy):
            return ((out @ a["head"] - yy) ** 2).mean()
        loss, g, ga, dx = jax.jit(lambda p, x, y, a: jpl.pipeline_value_and_grad(
            stage, loss_fn, p, x, y, mesh, case["M"], aux_params=a,
            with_dx=True, microbatch_weights=case["weights"]))(
            stacked, x, y, aux)
        extra = {"aux": np.asarray(ga["head"])}
    else:
        def loss_fn(out, yy):
            return ((out.astype(jnp.float32) - yy) ** 2).mean()
        loss, g, dx = jax.jit(lambda p, x, y: jpl.pipeline_value_and_grad(
            stage, loss_fn, p, x, y, mesh, case["M"], with_dx=True))(
            stacked, x, y)
        extra = {}

        def gpipe(stacked, x):
            out = jpl.pipeline_apply(stage, stacked, x, mesh, case["M"])
            return ((out.astype(jnp.float32) - y) ** 2).mean()
        l_ref, (g_ref, dx_ref) = jax.jit(jax.value_and_grad(
            gpipe, argnums=(0, 1)))(stacked, x)
        extra["gpipe"] = (float(l_ref), jax.tree.map(np.asarray, g_ref),
                          np.asarray(dx_ref))
    return dict(extra, loss=float(loss), g=jax.tree.map(np.asarray, g),
                dx=np.asarray(dx))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    join = torch_sp_worker.start_ranks(
        tmp_path_factory.mktemp("pp"), torch_pp_worker.run_generic_rank,
        (CASES,), world=4)
    ref = {}
    for name, case in CASES.items():
        for S in case["stages"]:
            ref[(name, S)] = (_jax_apply if case["kind"] == "apply"
                              else _jax_1f1b)(case, S)
    return join(), ref


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", APPLY)
def test_gpipe_output_and_grads_equal_jax(ranks, name, S):
    outs, ref = ranks
    want = ref[(name, S)]
    tol = BF16_TOL if CASES[name].get("x_bf16") else ATOL
    for r, res in enumerate(outs):
        i = int(res[f"index_S{S}"])
        key = f"{name}_S{S}"
        assert str(res[f"{key}/out_dtype"]) == "torch.float32"
        assert want["dtype"] == "float32"
        _close(res[f"{key}/out"], want["out"], ATOL, f"out rank {r}")
        _close(res[f"{key}/out_no_grad"], want["out"], ATOL, "no_grad")
        for k in ("w", "b"):
            got = res[f"{key}/g/{k}"]
            _close(got[i], want["g"][k][i], ATOL, f"grad {k} rank {r}")
            assert not np.delete(got, i, axis=0).any()
        _close(res[f"{key}/dx"], want["dx"], tol, f"dx rank {r}")


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", ONE_F)
def test_1f1b_equals_jax_1f1b_and_gpipe(ranks, name, S):
    outs, ref = ranks
    want = ref[(name, S)]
    bf16 = CASES[name].get("bf16_stage")
    tol, rtol = (BF16_TOL, BF16_TOL) if bf16 else (ATOL, LOSS_RTOL)
    for r, res in enumerate(outs):
        i = int(res[f"index_S{S}"])
        key = f"{name}_S{S}"
        loss = float(res[f"{key}/loss"])
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, want["loss"], rtol=rtol)
        for k in ("w", "b"):
            got = res[f"{key}/g/{k}"]
            assert np.isfinite(got).all()
            _close(got[i], want["g"][k][i], tol, f"grad {k} rank {r}")
        _close(res[f"{key}/dx"], want["dx"], tol, f"dx rank {r}")
        if "aux" in want:
            _close(res[f"{key}/aux/head"], want["aux"], ATOL, "aux")
        if "gpipe" in want and not bf16:
            l_ref, g_ref, dx_ref = want["gpipe"]
            np.testing.assert_allclose(loss, l_ref, rtol=LOSS_RTOL)
            for k in ("w", "b"):
                _close(res[f"{key}/g/{k}"][i], g_ref[k][i], ATOL, k)
            _close(res[f"{key}/dx"], dx_ref, ATOL, "dx vs gpipe")


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", ["apply", "many_microbatches", "1f1b",
                                  "1f1b_few_microbatches"])
def test_exchanges_a_pass_are_exact(ranks, name, S):
    outs, _ = ranks
    case = CASES[name]
    for res in outs:
        s = int(res[f"index_S{S}"])
        key = f"{name}_S{S}/counts"
        # apply: the forward with gradients, then the no-grad forward
        fwd_only = ((set(range(s, s + case["M"])) if s else set())
                    | (set(range(s + 1, s + 1 + case["M"]))
                       if s < S - 1 else set()))
        schedule = "gpipe" if case["kind"] == "apply" else "1f1b"
        want = chip_smoke.pp_collectives(schedule, case["M"], S, s)["p2p"]
        if case["kind"] == "apply":
            want += len(fwd_only)
        assert int(res[f"{key}/p2p"]) == want
        # the dtype, the output and dx (apply: twice the first two)
        assert int(res[f"{key}/broadcast"]) == (5 if case["kind"] == "apply"
                                                else 3)
        assert f"{key}/p2p_host" not in res          # CPU tensors


def test_blocks_cut_by_pipeline_rules_spec(ranks):
    outs, ref = ranks
    for res in outs:
        assert tuple(res["blocks/shape"]) == (1, HID, HID)
        _close(res["blocks/out"], ref[("apply", 2)]["out"], ATOL, "blocks")


def _line_of_one():
    return parallel.Mesh(1, 0, None, axes={"pipe": 1}, lines={})


@pytest.mark.parametrize("M", [1, 3])
def test_line_of_one_runs_the_stages_in_order(M):
    stages = _stages(1, 11)
    x = _normal(12, 6, HID)

    def jloss(p):
        return (jpl.pipeline_apply(_jstage, p, jnp.asarray(x), _jmesh(1),
                                   M) ** 2).mean()
    jout, jgrads = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, _stacked(stages)))
    stacked = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in _stacked(stages).items()}
    out = tpl.pipeline_apply(torch_pp_worker.stage_fn, stacked,
                             torch.from_numpy(x), _line_of_one(), M)
    loss = (out ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jout),
                               rtol=LOSS_RTOL)
    for k in ("w", "b"):
        _close(stacked[k].grad.numpy(), np.asarray(jgrads[k]), ATOL, k)


def test_stage_count_mismatch_raises_in_both_packages():
    mesh = parallel.Mesh(4, 0, None, axes={"pipe": 4}, lines={})
    stacked = _stacked(_stages(8, 13))
    x = np.zeros((8, HID), np.float32)
    with pytest.raises(ValueError, match="drop stages"):
        jpl.pipeline_apply(_jstage, jax.tree.map(jnp.asarray, stacked),
                           jnp.asarray(x), _jmesh(4), 2)
    with pytest.raises(ValueError, match="drop stages"):
        tpl.pipeline_apply(torch_pp_worker.stage_fn,
                           {k: torch.from_numpy(v) for k, v in
                            stacked.items()}, torch.from_numpy(x), mesh, 2)
    with pytest.raises(ValueError, match="4 stages"):
        tpl.pipeline_value_and_grad(
            torch_pp_worker.stage_fn, torch_pp_worker.mse,
            {k: torch.from_numpy(v) for k, v in stacked.items()},
            torch.from_numpy(x), torch.from_numpy(x), mesh, 2)


def test_batch_and_weights_refusals_in_both_packages():
    mesh = parallel.Mesh(2, 0, None, axes={"pipe": 2}, lines={})
    stacked = _stacked(_stages(2, 14))
    x = np.zeros((6, HID), np.float32)
    tstack = {k: torch.from_numpy(v) for k, v in stacked.items()}
    jstack = jax.tree.map(jnp.asarray, stacked)
    with pytest.raises(ValueError, match="not divisible by 4"):
        jpl.pipeline_apply(_jstage, jstack, jnp.asarray(x), _jmesh(2), 4)
    with pytest.raises(ValueError, match="not divisible by 4"):
        tpl.pipeline_apply(torch_pp_worker.stage_fn, tstack,
                           torch.from_numpy(x), mesh, 4)
    with pytest.raises(ValueError, match="microbatch_weights shape"):
        jpl.pipeline_value_and_grad(
            _jstage, lambda o, y: ((o - y) ** 2).mean(), jstack,
            jnp.asarray(x), jnp.asarray(x), _jmesh(2), 3,
            microbatch_weights=jnp.ones((2,)) / 2)
    with pytest.raises(ValueError, match="microbatch_weights shape"):
        tpl.pipeline_value_and_grad(
            torch_pp_worker.stage_fn, torch_pp_worker.mse, tstack,
            torch.from_numpy(x), torch.from_numpy(x), mesh, 3,
            microbatch_weights=torch.ones(2) / 2)


def test_stack_and_rules_spec_match_jax():
    stages = _stages(3, 15)
    got = tpl.stack_pipeline_params(
        [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages])
    want = jpl.stack_pipeline_params(
        [jax.tree.map(jnp.asarray, s) for s in stages])
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    specs = tpl.pipeline_rules_spec(got)
    jspecs = jpl.pipeline_rules_spec(want)
    assert specs == {k: tuple(v) for k, v in jspecs.items()} \
        == {"w": ("pipe",), "b": ("pipe",)}
