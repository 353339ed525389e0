"""Text and Hugging Face interop on the card: the converted models and
the fine-tune entry point against the CPU, and the host C++ routines
against their Python counterparts on the card's machine.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports neither JAX nor ``transformers``: the checkpoints are
HF-layout state dicts made from a seed (``chip_smoke.hf_state``), so on
a machine with a card and no JAX it runs as ``python -m pytest
--noconftest -m gpu tests/test_torch_hf_gpu.py``.

Tolerances: f32 with TF32 off; logits within 1e-4 of their scale,
losses within 1e-4 relative, greedy tokens exactly; the host routines
exactly.
"""
import json
import types

import numpy as np
import pytest
import torch

import chip_smoke
from distributed_tensorflow_tpu_torch.data import (BPETokenizer, Dataset,
                                                   GPT2BPETokenizer)
from distributed_tensorflow_tpu_torch.examples import finetune_gpt2_hf
from distributed_tensorflow_tpu_torch.models import convert
from distributed_tensorflow_tpu_torch.ops.kernels import flash_attention as fa
from distributed_tensorflow_tpu_torch.ops.kernels import fused

pytestmark = pytest.mark.gpu

TOL = 1e-4


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


def _close(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= TOL * scale


def _tiny(kind, vocab=96):
    """A tiny HF config (namespace) and state dict of ``kind``."""
    if kind == "gpt2":
        cfg = dict(chip_smoke.gpt2_hf_config(2), vocab_size=vocab,
                   n_positions=64, n_embd=64, n_head=2, n_inner=None)
        shapes = chip_smoke.gpt2_hf_shapes(2, V=vocab, P=64, d=64)
    else:
        cfg = dict(chip_smoke.hf_configs(2)[kind], hidden_size=64,
                   num_attention_heads=2, intermediate_size=96)
        if kind == "bert":
            cfg.update(vocab_size=120, max_position_embeddings=64)
            shapes = chip_smoke.bert_hf_shapes(2, V=120, P=64, d=64, ff=96)
        elif kind == "vit":
            cfg.update(image_size=32, patch_size=8, num_labels=5)
            shapes = chip_smoke.vit_hf_shapes(2, d=64, ff=96, image=32,
                                              patch=8, labels=5)
        else:
            cfg.update(vocab_size=96, num_attention_heads=4,
                       num_key_value_heads=2)
            shapes = chip_smoke.llama_hf_shapes(2, V=96, d=64, h=4, kv=2,
                                                ff=96)
    sd = chip_smoke.hf_state(torch, shapes, 3, device="cpu")
    return types.SimpleNamespace(**cfg), sd


@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_decoders_card_equals_cpu(cuda, kind):
    pair = _tiny(kind)
    fn = convert.gpt2_from_hf if kind == "gpt2" else convert.llama_from_hf
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 96, (2, 20)))
    out = {}
    for device in ("cuda", "cpu"):
        model, _ = fn(pair, device=device)
        with torch.no_grad():
            logits = model.logits(model.apply(ids.to(device)))
        gen = model.generate(ids[:, :6].to(device), max_new_tokens=8)
        out[device] = (logits, gen.cpu())
    _close(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])


@pytest.mark.parametrize("kind", ["bert", "vit"])
def test_encoders_card_equal_cpu(cuda, kind):
    pair = _tiny(kind)
    out = []
    for device in ("cuda", "cpu"):
        rng = np.random.default_rng(1)
        if kind == "bert":
            model, params = convert.bert_from_hf(pair, device=device)
            ids = torch.from_numpy(rng.integers(0, 120, (3, 40)))
            mask = torch.ones(3, 40, dtype=torch.int32)
            mask[1, 25:] = 0
            with torch.no_grad():
                seq = model.apply(params, ids.to(device),
                                  attention_mask=mask.to(device))
                out.append(model.mlm_logits(params, seq))
        else:
            model, params = convert.vit_from_hf(pair, device=device)
            imgs = torch.from_numpy(rng.random((3, 32, 32, 3), np.float32))
            with torch.no_grad():
                out.append(model.apply(params, imgs.to(device)))
    _close(out[0], out[1])


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_finetune_entry_point_card_equals_cpu(cuda, tmp_path, fmt):
    config, sd = _tiny("gpt2", vocab=300)
    tok = BPETokenizer.train([finetune_gpt2_hf.CORPUS], 259 + 20)
    chip_smoke.gpt2_tokenizer_files(tmp_path, tok, eos_id=299)
    (tmp_path / "config.json").write_text(json.dumps(vars(config)))
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    if fmt == "bin":
        torch.save(sd, tmp_path / "pytorch_model.bin")
    else:
        sd.pop("lm_head.weight")
        chip_smoke.write_safetensors(tmp_path / "model.safetensors", sd)
    argv = [f"--hf_dir={tmp_path}", "--steps=4", "--batch_size=4",
            "--seq_len=8"]
    fa.LAUNCHES.clear()
    fused.LAUNCHES.clear()
    card = finetune_gpt2_hf.run(argv + ["--device=cuda"])
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_forward"] == 2 * 4 + 2
    assert fa.LAUNCHES["flash_backward_dq"] == 2 * 4
    assert fused.LAUNCHES["adam"] == (2 * 16 + 4) * 4
    cpu = finetune_gpt2_hf.run(argv + ["--device=cpu"])
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=TOL,
                               atol=0)
    assert card["ids"] == cpu["ids"]


def test_host_routines_on_the_card_machine(cuda, tmp_path):
    text = chip_smoke.hf_text(np, 0, 1 << 15)
    tok = BPETokenizer.train([text[:4000]], 259 + 120)
    native = tok.encode(text, backend="native")
    np.testing.assert_array_equal(native, tok.encode(text, backend="python"))
    np.testing.assert_array_equal(native, tok.encode(text))
    assert tok.decode(native) == text
    chip_smoke.gpt2_tokenizer_files(tmp_path, tok)
    g2 = GPT2BPETokenizer.load(str(tmp_path / "vocab.json"),
                               str(tmp_path / "merges.txt"))
    assert g2.decode(g2.encode(text)) == text
    x = np.random.default_rng(2).standard_normal((1000, 7)).astype(
        np.float32)
    rows = np.arange(1000, dtype=np.int32)
    for backend in ("native", "numpy"):
        got = [b[1] for b in Dataset([x, rows], 100, backend=backend)]
        assert np.array_equal(np.sort(np.concatenate(got)), rows)
