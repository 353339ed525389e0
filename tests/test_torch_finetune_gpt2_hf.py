"""``python -m distributed_tensorflow_tpu_torch.examples.finetune_gpt2_hf``
held against the JAX package's ``examples/finetune_gpt2_hf.py``.

The JAX script's body (``gpt2_from_hf``, ``adamw(3e-4)``, a global-norm
clip of 1.0, rows of ``seq_len + 1`` ids of its corpus, a batch picked
by ``np.random.default_rng(0)`` each step, greedy ``generate`` of 12
tokens from "the quick brown") runs here through the JAX package's API
on one device, beside the port's entry point on ``--device=cpu``:

- at the default demo (a random tiny ``transformers`` GPT-2, torch seed
  0, with ``ByteTokenizer``), ``--steps=5``: the per-step losses agree
  within 1e-4 relative (f32, another summation order) and the generated
  text is equal; the printed lines are the JAX script's;
- with ``--hf_dir`` on a checkpoint directory the test writes
  (``save_pretrained`` weights and a GPT-2 tokenizer of learned merges),
  the JAX side loading it with ``transformers.from_pretrained`` and the
  JAX ``GPT2BPETokenizer``: the same.

The entry point defaults to the card and raises without one.
"""
import contextlib
import io
import re

import numpy as np
import pytest

import chip_smoke
from distributed_tensorflow_tpu.data import text as jtext
from distributed_tensorflow_tpu.models import convert as jconvert
from distributed_tensorflow_tpu_torch.data import BPETokenizer
from distributed_tensorflow_tpu_torch.examples import finetune_gpt2_hf as ex

transformers = pytest.importorskip("transformers")
torch = pytest.importorskip("torch")

torch.set_num_threads(1)

LOSS_RTOL = 1e-4


def _jax_finetune(hf, encode, decode, steps, batch=16, seq=32):
    """The JAX script's body through the JAX package's API: (per-step
    losses, generated text)."""
    from distributed_tensorflow_tpu import optim, train
    model, params = jconvert.gpt2_from_hf(hf.eval())
    ids = np.asarray(encode(ex.CORPUS))
    n = (len(ids) - 1) // seq
    rows = np.stack([ids[i * seq:i * seq + seq + 1] for i in range(n)])
    np.testing.assert_array_equal(rows, ex.rows_of(ids, seq))
    optimizer = optim.adamw(3e-4)
    step = train.make_custom_train_step(model.lm_loss_fn(), optimizer,
                                        grad_clip_norm=1.0)
    state = train.TrainState.create(params, optimizer.init(params))
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        pick = rng.integers(0, len(rows), batch)
        state, m = step(state, {"input_ids": rows[pick].astype(np.int32)})
        losses.append(float(m["loss"]))
    prompt = encode("the quick brown")[None].astype(np.int32)
    out = model.generate(state.params, prompt, max_new_tokens=12,
                         temperature=0.0)
    return losses, decode(np.asarray(out)[0].tolist())


def _port(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = ex.run(["--device=cpu"] + argv)
    return res, out.getvalue().splitlines(), err.getvalue().splitlines()


def _agree(res, losses, text):
    np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_RTOL,
                               atol=0)
    assert res["text"] == text


def test_default_demo_equals_the_jax_script():
    res, out, err = _port(["--steps=5"])
    losses, text = _jax_finetune(ex.demo_model(), jtext.ByteTokenizer().encode,
                                 jtext.ByteTokenizer().decode, 5)
    _agree(res, losses, text)
    assert losses[-1] < losses[0]
    assert err == ["converted GPT-2: 2 layers, hidden 64, vocab 256",
                   f"step 0: loss={losses[0]:.4f}",
                   f"step 4: loss={losses[4]:.4f}"]
    assert out == [f"generated: {text!r}"]
    assert text.startswith("the quick brown")
    assert ex.main(["--device=cpu", "--steps=1"]) == 0


def test_hf_dir_equals_the_jax_script(tmp_path):
    tok = BPETokenizer.train([ex.CORPUS], 259 + 40)
    chip_smoke.gpt2_tokenizer_files(tmp_path, tok)
    vocab = len(jtext.GPT2BPETokenizer.load(
        str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")).vocab)
    torch.manual_seed(1)
    transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=vocab, n_positions=64, n_embd=64, n_layer=2, n_head=2,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    ).save_pretrained(str(tmp_path))
    res, out, err = _port([f"--hf_dir={tmp_path}", "--steps=3",
                           "--batch_size=6", "--seq_len=8"])
    jtok = jtext.GPT2BPETokenizer.load(str(tmp_path / "vocab.json"),
                                       str(tmp_path / "merges.txt"))
    losses, text = _jax_finetune(
        transformers.GPT2LMHeadModel.from_pretrained(str(tmp_path)),
        jtok.encode, jtok.decode, 3, batch=6, seq=8)
    _agree(res, losses, text)
    prompt = jtok.encode("the quick brown").tolist()
    assert res["ids"][:len(prompt)] == prompt
    assert err[0] == f"converted GPT-2: 2 layers, hidden 64, vocab {vocab}"
    assert re.fullmatch(r"generated: '.*'", out[0])


def test_entry_point_defaults_to_the_card_and_checks_its_flags():
    with pytest.raises(ValueError, match="dtype"):
        ex.main(["--device=cpu", "--dtype=float16"])
    with pytest.raises(SystemExit, match="seq_len"):
        ex.rows_of(np.arange(10), 32)
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the defaults would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        ex.main(["--steps=1"])
