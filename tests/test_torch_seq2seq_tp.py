"""Seq2seq under tensor parallelism in the port, held against the JAX
package (``seq2seq_tiny``, f32, dropout 0).

- **Rules and blocks.**  ``Seq2Seq.partition_rules(fsdp=)`` is the JAX
  table (``models/seq2seq.py:397``) on every leaf, the stacked leaves'
  layer dim dropped.  On every rank of ``{"data": 2, "fsdp": 2,
  "tensor": 2}`` each leaf's block (``block_of``) is the slice that
  ``NamedSharding(jmesh, spec).devices_indices_map(shape)`` gives the
  device at that rank's place, and the state ``shard_train_state``
  places from a model built on that rank holds exactly that slice.
- **On 2 gloo ranks of ``{"tensor": 2}``**: ``encode``, ``decode`` and
  the gathered ``logits`` within 1e-5 of the JAX ones, with a source
  padding plane; greedy ``generate`` and ``beam_search`` tokens equal
  to the plain model's (weights scaled 4x, so the tokens vary); two
  ``adamw`` steps (clip 1.0), with and without ``remat``, within rtol
  1e-5 on the loss, the accuracy and the norm, and atol 5e-5 on every
  rank's blocks, of the JAX step on ``shard_pytree(params, jmesh,
  rules)``; the collectives of a forward and of a step are exact; at
  dropout 0.1 the training loss from one generator seed is the plain
  model's (the context's masks drawn at the whole heads' shape).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from distributed_tensorflow_tpu import optim as joptim
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel.sharding import \
    prune_spec as jprune
from distributed_tensorflow_tpu_torch import TrainState, optim, train
from distributed_tensorflow_tpu_torch.models import seq2seq as tseq2seq
from distributed_tensorflow_tpu_torch.parallel import sharding

import expert_cases
import tpf_cases
import torch_ep_worker
import torch_sp_worker
import torch_tpf_worker

torch.set_num_threads(1)

FWD_ATOL = 1e-5
NEW_TOKENS, GEN_SCALE = 4, 4.0


def _fwd_inputs():
    rng = np.random.default_rng(7)
    return {"src": rng.integers(1, tpf_cases.VOCAB, (4, 8)).astype(np.int64),
            "src_valid": (np.arange(8)[None, :]
                          < np.array([8, 5, 3, 7])[:, None]).astype(np.int64),
            "tgt": rng.integers(1, tpf_cases.VOCAB, (4, 5)).astype(np.int64)}


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The gloo run, started before the JAX package's side is computed."""
    tmp = tmp_path_factory.mktemp("s2s_tp")
    spec = {"case": tpf_cases.seq2seq_case(), "fwd": _fwd_inputs(),
            "gen_scale": GEN_SCALE, "new_tokens": NEW_TOKENS}
    return torch_sp_worker.start_ranks(
        tmp_path_factory.mktemp("s2s_tp_run"),
        torch_tpf_worker.run_seq2seq_line_rank,
        (torch_ep_worker.park(tmp / "spec.pkl", spec),), world=2)


# -- in one process ------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True])
def test_rules_match_the_jax_table(fsdp):
    jrules = tpf_cases.seq2seq_jax_model().partition_rules(fsdp=fsdp)
    rules = tseq2seq.Seq2Seq(tpf_cases.seq2seq_config()).partition_rules(
        fsdp=fsdp)
    for name in tpf_cases.seq2seq_whole(tpf_cases.seq2seq_params()):
        path, stacked = tpf_cases.seq2seq_jax_path(name)
        want = tuple(jrules.spec_for(path))
        assert rules.spec_for(name) == (want[1:] if stacked else want), name


def test_blocks_match_named_sharding():
    axes = {"data": 2, "fsdp": 2, "tensor": 2}
    config = tpf_cases.seq2seq_config()
    whole = tseq2seq.Seq2Seq(config).init(torch.Generator().manual_seed(0))
    jrules = tpf_cases.seq2seq_jax_model().partition_rules(fsdp=True)
    jm = jmesh.make_mesh(axes, jax.devices()[:8])
    for r in range(8):
        mesh = expert_cases.virtual(axes, r)
        model = tseq2seq.Seq2Seq(config, mesh)
        rules = model.partition_rules(fsdp=True)
        params = model.init(torch.Generator().manual_seed(0))
        opt = optim.adam(1e-3)
        state = train.shard_train_state(
            TrainState.create(params, opt.init(params)), mesh, rules)
        assert state.params.line == "fsdp+tensor"
        for name, full in whole.items():
            path, stacked = tpf_cases.seq2seq_jax_path(name)
            shape = ((2,) if stacked else ()) + tuple(full.shape)
            index = NamedSharding(jm, jprune(jrules.spec_for(path), jm)) \
                .devices_indices_map(shape)[jm.devices.flat[r]]
            want = [(s.start or 0, (s.stop or n) - (s.start or 0))
                    for s, n in zip(index[1 if stacked else 0:], full.shape)]
            assert sharding.block_of(tuple(full.shape), rules.spec_for(name),
                                     mesh) == want, (name, r)
            view = full.detach()
            for d, (start, length) in enumerate(want):
                view = view.narrow(d, start, length)
            # the placed state holds that box, its moments alike
            assert torch.equal(state.params[name].detach(), view), (name, r)
            assert state.opt_state.inner["m"][name].shape == view.shape
            box = torch_ep_worker._box(tuple(view.shape),
                                       state.params.layout[name])
            assert box.tolist() == [list(w) for w in want], (name, r)


# -- the JAX side --------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side(started):
    """(encode, decode and logits of the JAX model on the forward inputs;
    its two adamw steps over ``{"tensor": 2}``)."""
    jmodel = tpf_cases.seq2seq_jax_model()
    params = tpf_cases.seq2seq_params()
    fwd = {k: jnp.asarray(v.astype(np.int32))
           for k, v in _fwd_inputs().items()}

    @jax.jit
    def forward(p, src, valid, tgt):
        memory = jmodel.encode(p, src, valid)
        hidden = jmodel.decode(p, memory, tgt, valid)
        return memory, hidden, jmodel.logits(p, hidden)
    out = [np.asarray(a) for a in forward(params, fwd["src"],
                                          fwd["src_valid"], fwd["tgt"])]
    steps = tpf_cases.seq2seq_jax_steps({"tensor": 2}, False,
                                        joptim.adamw(1e-3), False)
    return out, steps


@pytest.fixture(scope="module")
def run(started, jax_side):
    return started()


def test_forward_matches_jax(run, jax_side):
    (memory, hidden, logits), _ = jax_side
    for out in run:
        for k, want in (("memory", memory), ("hidden", hidden),
                        ("logits", logits)):
            np.testing.assert_allclose(out[f"tp/fwd/{k}"], want, rtol=0,
                                       atol=FWD_ATOL, err_msg=k)


def test_forward_collectives(run):
    """Two embeddings, 2 row-parallel sums an encoder layer and 3 a decoder
    layer; the logits' one gather."""
    c = tpf_cases.seq2seq_config()
    want = {"tp_all_reduce": 2 + 2 * c.num_encoder_layers
            + 3 * c.num_decoder_layers, "tp_all_gather": 1}
    for out in run:
        got = {k.rsplit("/", 1)[1]: int(v) for k, v in out.items()
               if k.startswith("tp/fwd/launches/")}
        assert got == want


@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_tokens_equal_the_plain_model(run, kind):
    plain = run[0][f"plain/gen/{kind}"]
    assert plain.shape == (4, NEW_TOKENS)
    assert len(np.unique(plain)) > 1
    for out in run:
        np.testing.assert_array_equal(out[f"tp/gen/{kind}"], plain)


@pytest.mark.parametrize("arm", ["steps", "remat"])
def test_two_adamw_steps_match_the_jax_step(run, jax_side, arm):
    tpf_cases.check_steps(run, jax_side[1], f"tp/{arm}",
                          ("loss", "token_accuracy", "grad_norm"))


def test_dropout_masks_are_the_plain_models(run):
    plain = float(run[0]["dropout/plain/loss"])
    for out in run:
        np.testing.assert_allclose(float(out["dropout/tp/loss"]), plain,
                                   rtol=tpf_cases.LOSS_RTOL)


def test_step_collectives(run):
    c = tpf_cases.seq2seq_config()
    want = {"tp_all_reduce": tpf_cases.tp_all_reduces(
                c.num_encoder_layers, c.num_decoder_layers),
            "tp_all_gather": 1, "stats_all_reduce": 1}
    for out in run:
        for i in range(2):
            assert tpf_cases.launches(out, "tp/steps", i) == want, i
