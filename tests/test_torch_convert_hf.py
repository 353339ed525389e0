"""The port's Hugging Face converters (``models/convert.py``) held against
the JAX package's and against ``transformers``.

Hermetic: random tiny ``transformers`` models built from configs in code
(as ``tests/test_convert.py`` and ``tests/test_llama.py`` build them).
For GPT-2, BERT (encoder and MLM), ViT (features and classifier) and
Llama (GQA and a tied MHA head):

- the port's parameters equal the JAX package's ``*_params_from_hf``
  tree exactly, carried back through the port's ``*_params_to_jax``;
- logits (sequence outputs, pooler, features) within 2e-4 of the torch
  forward (the JAX package's tolerance) and of the JAX model's;
- GPT-2 and Llama greedy ``generate`` equal ``hf.generate``;
- every configuration the JAX package refuses raises ``ValueError``;
- ``load_hf_dir`` reads ``save_pretrained`` directories (safetensors and
  ``safe_serialization=False``) and one written by hand with bf16 and f16
  weights and a config.json of a few keys (HF's defaults fill the rest).
"""
import json

import jax
import numpy as np
import pytest

import chip_smoke
from distributed_tensorflow_tpu.models import convert as jconvert
from distributed_tensorflow_tpu_torch.models import convert

transformers = pytest.importorskip("transformers")
torch = pytest.importorskip("torch")

torch.set_num_threads(1)

TOL = 2e-4


def _tree_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _tree_equal(got[k], want[k], f"{path}{k}.")
        else:
            w = np.asarray(want[k])
            assert got[k].shape == w.shape, f"{path}{k}"
            np.testing.assert_array_equal(got[k], w, err_msg=f"{path}{k}")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _gpt2(seed=0, **kw):
    torch.manual_seed(seed)
    cfg = dict(vocab_size=96, n_positions=32, n_embd=32, n_layer=2, n_head=2,
               resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    cfg.update(kw)
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(**cfg)).eval()


def _llama(seed=0, kv_heads=2, tie=False):
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=96, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=kv_heads, max_position_embeddings=64,
        rms_norm_eps=1e-5, rope_theta=10000.0, attention_dropout=0.0,
        tie_word_embeddings=tie)).eval()


def _bert(seed=0, mlm=False):
    torch.manual_seed(seed)
    cfg = transformers.BertConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    cls = transformers.BertForMaskedLM if mlm else transformers.BertModel
    return cls(cfg).eval()


def _vit(seed=0, classify=False):
    torch.manual_seed(seed)
    cfg = transformers.ViTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, image_size=16, patch_size=8,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        num_labels=5)
    cls = (transformers.ViTForImageClassification if classify
           else transformers.ViTModel)
    return cls(cfg).eval()


@pytest.mark.parametrize("family", ["gpt2", "llama_gqa", "llama_tied"])
def test_decoders_equal_jax_trees_logits_and_generate(family):
    if family == "gpt2":
        hf, port_fn, jax_fn = _gpt2(), convert.gpt2_from_hf, \
            jconvert.gpt2_from_hf
    else:
        tie = family == "llama_tied"
        hf = _llama(seed=int(tie), kv_heads=4 if tie else 2, tie=tie)
        port_fn, jax_fn = convert.llama_from_hf, jconvert.llama_from_hf
    model, params = port_fn(hf, device="cpu")
    assert params.keys() == dict(model.named_parameters()).keys()
    jmodel, jparams = jax_fn(hf)
    _tree_equal(convert.gpt_params_to_jax(params, model.config),
                jax.tree.map(np.asarray, jparams))
    assert ("lm_head" in jparams) == (family == "llama_gqa")
    ids = np.random.default_rng(0).integers(0, 96, (2, 13))
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.numpy()
        got = model.logits(model.apply(torch.from_numpy(ids))).numpy()
    _close(got, want)
    _close(got, jmodel.logits(jparams, jmodel.apply(
        jparams, ids.astype(np.int32))))
    prompt = np.asarray([[5, 9, 2, 41]])
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(prompt), max_new_tokens=8,
                           do_sample=False, pad_token_id=0).numpy()
    got = model.generate(torch.from_numpy(prompt), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gpt2_bf16_compute_and_training_step():
    model, params = convert.gpt2_from_hf(_gpt2(seed=3), device="cpu",
                                         dtype=torch.bfloat16)
    assert model.config.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in params.values())
    from distributed_tensorflow_tpu_torch import (TrainState, adam,
                                                  make_custom_train_step)
    opt = adam(1e-3)
    step = make_custom_train_step(model.lm_loss_fn(), opt)
    state = TrainState.create(params, opt.init(params))
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 96, (4, 17)))
    losses = []
    for _ in range(4):
        state, m = step(state, {"input_ids": ids})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("mlm", [False, True])
def test_bert_equals_jax_tree_and_torch_forward(mlm):
    hf = _bert(seed=3 if mlm else 0, mlm=mlm)
    model, params = convert.bert_from_hf(hf, device="cpu")
    assert model.config.hidden_act == "gelu"
    jmodel, jparams = jconvert.bert_from_hf(hf)
    _tree_equal(convert.bert_params_to_jax(params, model.config),
                jax.tree.map(np.asarray, jparams))
    assert ("mlm" in jparams) == mlm and ("pooler" in jparams) != mlm
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 120, (2, 19))
    mask = np.ones((2, 19), np.int64)
    mask[1, 12:] = 0
    with torch.no_grad():
        out = hf(torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask))
        seq = model.apply(params, torch.from_numpy(ids),
                          attention_mask=torch.from_numpy(mask))
        jseq = jmodel.apply(jparams, ids.astype(np.int32),
                            attention_mask=mask.astype(np.int32))
        if mlm:
            _close(model.mlm_logits(params, seq), out.logits)
            _close(model.mlm_logits(params, seq),
                   jmodel.mlm_logits(jparams, jseq))
        else:
            _close(seq, out.last_hidden_state)
            _close(seq, jseq)
            _close(model.pooled(params, seq), out.pooler_output)


@pytest.mark.parametrize("classify", [False, True])
def test_vit_equals_jax_tree_and_torch_forward(classify):
    hf = _vit(seed=5 if classify else 0, classify=classify)
    model, params = convert.vit_from_hf(hf, device="cpu")
    jmodel, jparams = jconvert.vit_from_hf(hf)
    assert model.config.num_classes == jmodel.config.num_classes == 5
    _tree_equal(convert.vit_params_to_jax(params, model.config),
                jax.tree.map(np.asarray, jparams))
    imgs = np.random.default_rng(1).random((2, 16, 16, 3)).astype(np.float32)
    pixels = torch.from_numpy(imgs.transpose(0, 3, 1, 2))
    with torch.no_grad():
        feats = model.apply(params, torch.from_numpy(imgs),
                            return_features=True)
        _close(feats, (hf.vit if classify else hf)(pixels).last_hidden_state)
        _close(feats, jmodel.apply(jparams, imgs, return_features=True))
        if classify:
            _close(model.apply(params, torch.from_numpy(imgs)),
                   hf(pixels).logits)


def _refusals():
    gpt2 = transformers.GPT2Config
    bert = transformers.BertConfig
    vit = transformers.ViTConfig
    llama = dict(vocab_size=96, hidden_size=32, intermediate_size=48,
                 num_hidden_layers=2, num_attention_heads=4)
    return [
        (convert.gpt2_config_from_hf, gpt2(activation_function="relu"),
         "activation"),
        (convert.gpt2_config_from_hf, gpt2(scale_attn_weights=False),
         "scale_attn_weights"),
        (convert.gpt2_config_from_hf,
         gpt2(scale_attn_by_inverse_layer_idx=True), "layer_idx"),
        (convert.gpt2_config_from_hf, gpt2(reorder_and_upcast_attn=True),
         "reorder"),
        (convert.bert_config_from_hf, bert(hidden_act="silu"), "hidden_act"),
        (convert.bert_config_from_hf,
         bert(position_embedding_type="relative_key"), "relative"),
        (convert.vit_config_from_hf, vit(hidden_act="relu"), "hidden_act"),
        (convert.vit_config_from_hf, vit(qkv_bias=False), "qkv_bias"),
        (convert.llama_config_from_hf,
         transformers.LlamaConfig(hidden_act="gelu", **llama), "silu"),
        (convert.llama_config_from_hf,
         transformers.LlamaConfig(attention_bias=True, **llama), "bias"),
        (convert.llama_config_from_hf,
         transformers.LlamaConfig(mlp_bias=True, **llama), "bias"),
        (convert.llama_config_from_hf, transformers.LlamaConfig(
            rope_scaling={"rope_type": "linear", "factor": 2.0}, **llama),
         "rope_scaling"),
        (convert.llama_config_from_hf,
         transformers.LlamaConfig(head_dim=16, **llama), "head_dim"),
    ]


@pytest.mark.parametrize("case", range(13))
def test_refusals_raise_value_error(case):
    fn, cfg, match = _refusals()[case]
    args = (cfg, 5) if fn is convert.vit_config_from_hf else (cfg,)
    with pytest.raises(ValueError, match=match):
        fn(*args)
    jfn = getattr(jconvert, fn.__name__)
    with pytest.raises(ValueError, match=match):
        jfn(*args)


def test_llama_without_its_head_raises():
    hf = _llama()
    sd = {k: v for k, v in hf.state_dict().items() if k != "lm_head.weight"}
    with pytest.raises(ValueError, match="lm_head"):
        convert.llama_from_hf((hf.config, sd), device="cpu")


@pytest.mark.parametrize("safe", [True, False])
def test_load_hf_dir_reads_save_pretrained(tmp_path, safe):
    hf = _gpt2(seed=4)
    hf.save_pretrained(str(tmp_path), safe_serialization=safe)
    assert (tmp_path / ("model.safetensors" if safe
                        else "pytorch_model.bin")).exists()
    config, sd = convert.load_hf_dir(str(tmp_path))
    assert config.n_layer == 2 and config.activation_function == "gelu_new"
    want_sd = hf.state_dict()
    for k, v in sd.items():
        assert torch.equal(v, want_sd[k]), k
    model, _ = convert.gpt2_from_hf((config, sd), device="cpu")
    ids = np.random.default_rng(2).integers(0, 96, (2, 9))
    with torch.no_grad():
        _close(model.logits(model.apply(torch.from_numpy(ids))),
               hf(torch.from_numpy(ids)).logits)
    lhf = _llama(seed=6)
    lhf.save_pretrained(str(tmp_path / "llama"))
    model, _ = convert.llama_from_hf(
        convert.load_hf_dir(str(tmp_path / "llama")), device="cpu")
    with torch.no_grad():
        _close(model.logits(model.apply(torch.from_numpy(ids))),
               lhf(torch.from_numpy(ids)).logits)


def test_load_hf_dir_by_hand_bf16_and_defaults(tmp_path):
    hf = _vit(seed=7, classify=True)
    sd = hf.state_dict()
    half = {k: v.to(torch.bfloat16 if i % 2 else torch.float16)
            for i, (k, v) in enumerate(sd.items())}
    chip_smoke.write_safetensors(tmp_path / "model.safetensors", half)
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "vit", "hidden_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 64, "image_size": 16,
        "patch_size": 8, "id2label": {str(i): f"c{i}" for i in range(5)}}))
    config, got = convert.load_hf_dir(str(tmp_path))
    assert config.num_labels == 5 and config.hidden_act == "gelu"
    assert config.qkv_bias and config.num_channels == 3
    assert config.layer_norm_eps == 1e-12
    for k, v in half.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    model, params = convert.vit_from_hf((config, got), device="cpu")
    _, want = convert.vit_from_hf(
        (hf.config, {k: v.float() for k, v in half.items()}), device="cpu")
    for k in want:
        assert torch.equal(params[k], want[k]), k
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "llama", "hidden_size": 32, "num_attention_heads": 4}))
    config, _ = convert.load_hf_dir(str(tmp_path))
    assert config.num_key_value_heads is None and config.rope_scaling is None
    assert convert.llama_config_from_hf(
        config.__class__(**dict(vars(config), vocab_size=8,
                                num_hidden_layers=1, intermediate_size=8))
    ).kv_heads == 4
    assert config.rms_norm_eps == 1e-6 and not config.tie_word_embeddings
