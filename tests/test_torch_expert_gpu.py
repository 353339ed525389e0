"""The expert axis and the vision zoo on a mesh, on the card: the checks of
``chip_smoke.py`` phase 29 at small width.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, so on a machine with a card and no JAX it runs as
``python -m pytest --noconftest -m gpu tests/test_torch_expert_gpu.py``.

- ``apply_moe`` on the card, on a line of one (``{"expert": 1}``): the
  plain layer to the bit, no collective.
- Two ranks sharing the card over gloo with CUDA tensors (f32, TF32 off,
  the router jitter off): two ``adamw(1e-3)`` steps of the MoE GPT tiny
  (4 experts) on ``{"expert": 2}``, two of ViT tiny (2 heads) and two of
  ``momentum(0.01, 0.9)`` of ``resnet_cifar`` on ``{"tensor": 2}``,
  against the plain models on the card: losses rtol 1e-5, every block
  atol 5e-5 (ResNet's BatchNorm state too), the flash kernels, the
  LayerNorm kernel and Adam launched on every rank (ResNet: none).
"""
import dataclasses

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import GPT, gpt_tiny, parallel
from distributed_tensorflow_tpu_torch.models import convert
from distributed_tensorflow_tpu_torch.models import resnet as tresnet
from distributed_tensorflow_tpu_torch.models import vit as tvit
from distributed_tensorflow_tpu_torch.ops import moe as tmoe
from distributed_tensorflow_tpu_torch.ops.layers import _flat
from distributed_tensorflow_tpu_torch.parallel import data_parallel

import torch_ep_worker
import torch_sp_worker

pytestmark = pytest.mark.gpu

LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-5


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


def test_apply_moe_on_a_line_of_one_is_the_plain_layer(cuda):
    tree = tmoe.init_moe(torch.Generator(cuda).manual_seed(0), 64, 128, 4)
    x = torch.randn(4, 16, 64, generator=torch.Generator(cuda)
                    .manual_seed(1), device=cuda)
    mesh = parallel.make_mesh({"expert": 1})
    data_parallel.LAUNCHES.clear()
    y1, m1 = tmoe.apply_moe(tree, x, mesh=mesh)
    y0, m0 = tmoe.apply_moe(tree, x)
    assert not data_parallel.LAUNCHES
    assert torch.equal(y1, y0)
    for k in m0:
        assert torch.equal(m1[k], m0[k]), k


def _cases():
    config = gpt_tiny(moe_experts=4, dropout_rate=0.0)
    state = {k: v.detach().numpy().copy() for k, v in
             GPT(config, device="cpu").state_dict().items()}
    rng = np.random.default_rng(3)
    moe = {"config": dataclasses.asdict(config), "state": state,
           "batches": [{"input_ids": rng.integers(0, 512, (4, 17))}
                       for _ in range(2)]}
    vit = tvit.vit_tiny(num_heads=2)
    vparams = vit.init(torch.Generator().manual_seed(0))
    vit_case = {"config": dataclasses.asdict(vit.config),
                "params": convert.vit_params_to_jax(vparams, vit.config),
                "batches": [(rng.random((4, 32, 32, 3), np.float32),
                             rng.integers(0, 10, 4)) for _ in range(2)]}
    rparams, rstate = tresnet.resnet_cifar().init(
        torch.Generator().manual_seed(0), (8, 8, 3))
    resnet_case = {"params": convert.stack_params_to_jax(rparams),
                   "state": {k: v.numpy() for k, v in
                             _flat(rstate, "").items()},
                   "batches": [(rng.random((4, 8, 8, 3), np.float32),
                                rng.integers(0, 10, 4)) for _ in range(2)]}
    return {"moe": moe, "vit": vit_case, "resnet": resnet_case}


def _close(out, key, plain):
    prefix = f"plain/{key.split('/')[1]}/p/"
    whole = {k[len(prefix):]: v for k, v in plain.items()
             if k.startswith(prefix)}
    names = [k[len(key) + 3:] for k in out if k.startswith(key + "/p/")]
    assert sorted(names) == sorted(whole)
    for name in names:
        want = whole[name]
        for d, (start, length) in enumerate(out[f"{key}/box/{name}"]):
            want = np.take(want, np.arange(start, start + length), axis=d)
        np.testing.assert_allclose(out[f"{key}/p/{name}"], want, rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_two_ranks_on_the_card_equal_the_plain_models(cuda, tmp_path):
    spec = torch_ep_worker.park(tmp_path / "card.pkl", _cases())
    outs = torch_sp_worker.spawn_ranks(tmp_path, torch_ep_worker
                                       .run_card_rank, (spec,), world=2)
    plain = outs[0]
    for out in outs:
        for key, metric in (("ep/moe", "moe_aux"), ("tp/vit", "accuracy"),
                            ("tp/resnet", "acc")):
            name = key.split("/")[1]
            for i in range(2):
                for k in ("loss", metric):
                    np.testing.assert_allclose(
                        float(out[f"{key}/step{i}/{k}"]),
                        float(plain[f"plain/{name}/step{i}/{k}"]),
                        rtol=LOSS_RTOL, err_msg=(key, k, i))
            _close(out, key, plain)
        for n in [k for k in out if k.startswith("tp/resnet/state/")]:
            np.testing.assert_allclose(
                out[n], plain[n.replace("tp/", "plain/", 1)], rtol=0,
                atol=PARAM_ATOL, err_msg=n)
        for key in ("ep/moe", "tp/vit"):
            for kernel in ("flash_forward", "flash_backward_dkv",
                           "flash_backward_dq", "layernorm", "adam"):
                assert int(out.get(f"{key}/kernels/{kernel}", 0)) > 0, (
                    key, kernel)
        assert not any(int(v) for k, v in out.items()
                       if k.startswith("tp/resnet/kernels/"))
