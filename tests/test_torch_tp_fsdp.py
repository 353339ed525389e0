"""``tensor`` beside ``fsdp`` in the port, held against the JAX package on
its own test's mesh (``tests/test_seq2seq.py:108``): ``{"data": 2,
"fsdp": 2, "tensor": 2}``, one launch of 8 gloo ranks.

- **Two adam steps** of ``seq2seq_tiny`` (f32, dropout 0, clip 1.0)
  under ``partition_rules(fsdp=True)``, unmasked and with ``src_valid`` +
  ``loss_mask``: the loss, ``token_accuracy`` and the norm within rtol
  1e-5 and every rank's blocks (the ``fsdp`` part of its tensor blocks)
  within atol 5e-5 of the JAX step on ``shard_pytree(params, jmesh,
  rules(fsdp=True))``.  The collectives a step are exact: one all-gather
  over ``fsdp``, one reduce-scatter over ``fsdp``, one all-reduce over
  ``data``, the norm over the ``fsdp`` and the ``tensor`` line, and the
  model's own tensor-line collectives.
- **The replicas** of this mesh are its ``data`` x ``fsdp`` plane: the
  batch line's sum and the data-parallel weighted mean cover four ranks,
  one all-reduce over ``fsdp`` and one over ``data``.
- **The sharded checkpoint** of the masked run restores bit-equal onto
  the same layout (``verify_sharded`` passes: each box written once),
  onto a whole model in this process and onto ``{"tensor": 2}``.
- **EMA**: ``ema_params`` gathers the shadow's ``fsdp`` parts into
  tensor blocks.
- **The session**: ``TrainSession(sharded_checkpoint=True)`` saves on
  exit and a session on a fresh placement resumes that step's blocks.
"""
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu import optim as joptim
from distributed_tensorflow_tpu_torch import TrainState, optim, train
from distributed_tensorflow_tpu_torch.models import seq2seq as tseq2seq
from distributed_tensorflow_tpu_torch.train import sharded_checkpoint

import expert_cases
import tpf_cases
import torch_ep_worker
import torch_sp_worker
import torch_tpf_worker

torch.set_num_threads(1)

AXES = {"data": 2, "fsdp": 2, "tensor": 2}
CASES = ("unmasked", "masked")
KEYS = ("loss", "token_accuracy", "grad_norm")


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tpf_ckpt")


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory, ckpt_dir):
    """The gloo run, started before the JAX package's side is computed."""
    tmp = tmp_path_factory.mktemp("tpf")
    masked = tpf_cases.seq2seq_case(masked=True)
    spec = {"axes": AXES,
            "cases": {"unmasked": tpf_cases.seq2seq_case(),
                      "masked": dict(masked, ckpt=str(ckpt_dir))},
            "ema": masked,
            "session": dict(masked, dir=str(tmp_path_factory.mktemp(
                "tpf_session")))}
    return torch_sp_worker.start_ranks(
        tmp_path_factory.mktemp("tpf_run"), torch_tpf_worker.run_tpf_rank,
        (torch_ep_worker.park(tmp / "spec.pkl", spec),), world=8)


@pytest.fixture(scope="module")
def jax_side(started):
    return {name: tpf_cases.seq2seq_jax_steps(AXES, name == "masked",
                                              joptim.adam(1e-3), True)
            for name in CASES}


@pytest.fixture(scope="module")
def run(started, jax_side):
    return started()


def test_replicas_span_data_and_fsdp(run):
    """Rank r holds r + 1; the ranks sharing a tensor index are the four
    of even or of odd rank (tensor is the last axis)."""
    for r, out in enumerate(run):
        peers = [q for q in range(8) if q % 2 == r % 2]
        assert float(out["repair/batch_sum"][0]) == sum(q + 1 for q in peers)
        assert int(out["repair/batch_launches"]) == 2
        w = np.array([q + 1.0 for q in peers])
        mean = float((w * np.array(peers)).sum() / w.sum())
        np.testing.assert_allclose(out["repair/grad"], [mean] * 3,
                                   rtol=1e-6)
        np.testing.assert_allclose(out["repair/loss"], mean, rtol=1e-6)
        np.testing.assert_allclose(out["repair/acc"], 2 * mean, rtol=1e-6)
        assert float(out["repair/weight"]) == w.sum()
        assert int(out["repair/mean_launches"]) == 2


@pytest.mark.parametrize("name", CASES)
def test_two_adam_steps_match_the_jax_step(run, jax_side, name):
    tpf_cases.check_steps(run, jax_side[name], f"tpf/{name}", KEYS)


@pytest.mark.parametrize("name", CASES)
def test_collectives_a_step(run, name):
    c = tpf_cases.seq2seq_config()
    want = {"tp_all_reduce": tpf_cases.tp_all_reduces(
                c.num_encoder_layers, c.num_decoder_layers),
            "tp_all_gather": 1, "all_gather": 1, "reduce_scatter": 1,
            "all_reduce": 1, "stats_all_reduce": 2}
    for out in run:
        for i in range(2):
            assert tpf_cases.launches(out, f"tpf/{name}", i) == want, i


def test_blocks_are_the_fsdp_parts_of_tensor_blocks(run):
    """A query kernel [d, h, hd] is cut along d over fsdp and along h over
    tensor; a bias only tensor cuts is the tensor block; a norm whole."""
    c = tpf_cases.seq2seq_config()
    d, h = c.hidden_size, c.num_heads
    for out in run:
        data, fsdp, tensor = (int(x) for x in out["coords"])
        box = out["tpf/unmasked/box/decoder.1.cross_attention.query.kernel"]
        assert box.tolist() == [[fsdp * d // 2, d // 2],
                                [tensor * h // 2, h // 2], [0, d // h]]
        box = out["tpf/unmasked/box/encoder.0.attention.key.bias"]
        assert box.tolist() == [[tensor * h // 2, h // 2], [0, d // h]]
        assert out["tpf/unmasked/box/ln_dec_f.gamma"].tolist() == [[0, d]]


def test_sharded_checkpoint_round_trip(run, ckpt_dir):
    for out in run:
        assert bool(out["tpf/masked/restored/equal"])
        assert bool(out["tpf/masked/restored/same_tensors"])
        assert int(out["tpf/masked/restored/step"]) == 2
    path = sharded_checkpoint.all_sharded_checkpoints(str(ckpt_dir))[-1]
    assert sharded_checkpoint.verify_sharded(path) == (True, "")
    config = tpf_cases.seq2seq_config()

    def placed(mesh):
        model = tseq2seq.Seq2Seq(config, mesh)
        params = model.init(torch.Generator().manual_seed(1))
        opt = optim.adam(1e-3)
        state = TrainState.create(params, opt.init(params))
        if mesh is not None:
            state = train.shard_train_state(state, mesh,
                                            model.partition_rules())
        return sharded_checkpoint.restore_sharded(state, path)
    # onto a whole model: every rank's block of it
    whole = {k: v.detach().numpy() for k, v in placed(None).params.items()}
    for out in run:
        expert_cases.blocks_close(out, "tpf/masked", whole, 0.0)
    # onto {"tensor": 2} (each rank placed without a group)
    for r in range(2):
        state = placed(expert_cases.virtual({"tensor": 2}, r))
        for name, t in state.params.items():
            want = torch.from_numpy(whole[name])
            s = state.params.layout[name]
            if s is not None:
                want = s.take(want)
            assert torch.equal(t.detach(), want), (name, r)


def test_sharded_session_resumes(run):
    for out in run:
        assert int(out["session/step"]) == 1
        assert bool(out["session/equal"])


def test_ema_params_gather_tensor_blocks(run):
    for out in run:
        assert bool(out["ema/same_tensors"])
        assert bool(out["ema/shapes"])
        assert float(out["ema/gap"]) < 1e-6
