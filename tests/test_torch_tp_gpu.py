"""Tensor parallelism on the card: the checks of ``chip_smoke.py`` phase 27
at small width.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs as
``python -m pytest --noconftest -m gpu tests/test_torch_tp_gpu.py``.

- A line of one (``{"tensor": 1}``): two steps of the Llama tiny recipe
  (f32, TF32 off) equal the plain model's to the bit, with the same
  kernel launches and no collective.
- Two ranks sharing the card over gloo with CUDA tensors, ``{"tensor":
  2}``: two ``adamw(1e-3)`` steps with clip 1.0 of GPT tiny, the Llama
  tiny recipe (replicated kv and ``shard_kv``) and BERT tiny MLM (f32)
  against the plain model on the card (losses rtol 1e-5, every block
  atol 5e-5), the tensor line's collectives exact a step and the flash
  kernels launched on each rank's heads; contiguous decoding of GPT tiny
  and the Llama recipe: ``decode_block`` / ``decode_step`` logits within
  2e-3 of the plain model's, the same greedy and sampled tokens.
- ``python -m distributed_tensorflow_tpu_torch.examples.finetune_bert``
  on two ranks of the card (``DTTPU_DIST_BACKEND=gloo``) takes the tp=2
  path to its end.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import (GPT, TrainState, gpt_tiny,
                                              make_custom_train_step,
                                              optim, parallel, train)
from distributed_tensorflow_tpu_torch.models import bert as tbert
from distributed_tensorflow_tpu_torch.models.llama import llama_tiny
from distributed_tensorflow_tpu_torch.parallel import data_parallel

import torch_sp_worker
import torch_tp_worker

pytestmark = pytest.mark.gpu

LOSS_RTOL, PARAM_ATOL, DECODE_ATOL = 1e-5, 5e-5, 2e-3
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _gpt_case(config, shard_kv=None):
    model = GPT(config, device="cpu",
                generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(3)
    return {"kind": "gpt", "config": dataclasses.asdict(config),
            "shard_kv": shard_kv,
            "state": {k: v.detach().numpy() for k, v in
                      model.state_dict().items()},
            "batches": [{"input_ids": rng.integers(
                0, config.vocab_size, (4, 17))} for _ in range(2)],
            "ids": rng.integers(0, config.vocab_size, (2, 8))}


def _bert_case():
    config = tbert.bert_tiny(dropout_rate=0.0).config
    params = tbert.Bert(config).init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(2):
        valid = (np.arange(16)[None] < rng.integers(9, 17, (4,))[:, None])
        batches.append({"input_ids": rng.integers(0, 1000, (4, 16)),
                        "labels": rng.integers(0, 1000, (4, 16)),
                        "mlm_mask": (rng.random((4, 16)) < 0.2).astype(
                            np.float32),
                        "attention_mask": valid.astype(np.int64)})
    return {"kind": "bert", "config": dataclasses.asdict(config),
            "state": {k: v.detach().numpy() for k, v in params.items()},
            "batches": batches}


def _cases():
    return {"gpt": _gpt_case(gpt_tiny(dropout_rate=0.0)),
            "llama": _gpt_case(llama_tiny()),
            "llama_shard_kv": _gpt_case(llama_tiny(), shard_kv=True),
            "bert": _bert_case()}


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = _cases()
    decode = {k: dict(cases[k]) for k in ("gpt", "llama")}
    return cases, torch_sp_worker.spawn_ranks(
        tmp_path_factory.mktemp("tp_card"), torch_tp_worker.run_card_rank,
        ({"cases": cases, "decode": decode},), world=2)


def _plain(case):
    res = {}
    torch_tp_worker._train(res, "plain", dict(case, device="cuda"), None)
    return res


def test_line_of_one_is_the_plain_step(cuda):
    from distributed_tensorflow_tpu_torch.ops.kernels import flash_attention
    mesh = parallel.make_mesh({"tensor": 1})
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (4, 33))).to(cuda)
    runs = []
    for m in (None, mesh):
        model = GPT(llama_tiny(), device=cuda, mesh=m,
                    generator=torch.Generator(cuda).manual_seed(0))
        params = dict(model.named_parameters())
        opt = optim.adamw(1e-3)
        state = TrainState.create(params, opt.init(params))
        if m is not None:
            state = train.shard_train_state(state, m,
                                            model.partition_rules())
        step = make_custom_train_step(model.lm_loss_fn(), opt, mesh=m,
                                      grad_clip_norm=1.0)
        data_parallel.LAUNCHES.clear()
        flash_attention.LAUNCHES.clear()
        losses = [float(step(state, {"input_ids": ids})[1]["loss"])
                  for _ in range(2)]
        assert not data_parallel.LAUNCHES
        runs.append((losses, dict(flash_attention.LAUNCHES),
                     {k: p.detach().clone()
                      for k, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    assert runs[0][1] == runs[1][1] == {
        "flash_forward": 4, "flash_backward_dkv": 4, "flash_backward_dq": 4}
    for k in runs[0][2]:
        assert torch.equal(runs[0][2][k], runs[1][2][k]), k


@pytest.mark.parametrize("name", ["gpt", "llama", "llama_shard_kv", "bert"])
def test_two_ranks_match_the_plain_model(cuda, card_ranks, name):
    cases, ranks = card_ranks
    plain = _plain(cases[name])
    L = 2
    bert = name == "bert"
    want = {"tp_all_reduce": 4 * L + (5 if bert else 4),
            "tp_all_gather": 2 if bert else 1, "stats_all_reduce": 1}
    for out in ranks:
        for i in range(2):
            np.testing.assert_allclose(out[f"tp/{name}/step{i}/loss"],
                                       plain[f"plain/step{i}/loss"],
                                       rtol=LOSS_RTOL)
            pre = f"tp/{name}/step{i}/launches/"
            assert {k[len(pre):]: int(v) for k, v in out.items()
                    if k.startswith(pre)} == want
        for k in out:
            if not k.startswith(f"tp/{name}/p/"):
                continue
            pname = k[len(f"tp/{name}/p/"):]
            dim, start, length = (int(x) for x in
                                  out[f"tp/{name}/layout/{pname}"])
            whole = plain[f"plain/p/{pname}"]
            if dim >= 0:
                whole = np.take(whole, np.arange(start, start + length),
                                axis=dim)
            np.testing.assert_allclose(out[k], whole, rtol=0,
                                       atol=PARAM_ATOL, err_msg=pname)
        # the flash kernels ran on this rank's heads: one forward, dK/dV
        # and dQ a layer a step
        for kernel in ("flash_forward", "flash_backward_dkv",
                       "flash_backward_dq"):
            assert int(out[f"tp/{name}/kernels/{kernel}"]) == 2 * L


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_two_ranks_decode_as_the_plain_model(cuda, card_ranks, name):
    cases, ranks = card_ranks
    res = {}
    torch_tp_worker._decode(res, "plain", dict(cases[name], device="cuda"),
                            None)
    for out in ranks:
        for k in ("block", "step"):
            np.testing.assert_allclose(out[f"dec/{name}/tp/{k}"],
                                       res[f"plain/{k}"], rtol=0,
                                       atol=DECODE_ATOL)
        for k in ("greedy", "sampled"):
            np.testing.assert_array_equal(out[f"dec/{name}/tp/{k}"],
                                          res[f"plain/{k}"])


def test_finetune_bert_on_two_ranks_of_the_card(cuda):
    port = torch_sp_worker._free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
                   NUM_PROCESSES="2", PROCESS_ID=str(r),
                   DTTPU_DIST_BACKEND="gloo", PYTHONPATH=_REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "distributed_tensorflow_tpu_torch.examples.finetune_bert",
             "--steps=25", "--mlm_steps=4"], cwd=_REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert "mesh={'data': 1, 'tensor': 2}" in err
        assert out.splitlines()[-1].startswith("eval accuracy:")
    assert outs[0][0] == outs[1][0]
