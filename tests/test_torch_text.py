"""The port's tokenizers (``data/text.py``) held against the JAX
package's and against ``transformers``.

- ``ByteTokenizer``: ids, specials and decode equal the JAX package's.
- ``BPETokenizer``: ``train`` learns the JAX package's merges; ``encode``
  gives its ids on every backend (the port's "native" and "auto" run
  ``csrc/bpe.cpp``, the JAX package's "python" its loop); ``save`` and
  ``load`` cross between the packages; an unknown backend raises, and
  "native" and "auto" raise where the host encoder cannot be built.
- ``GPT2BPETokenizer`` (no ``regex``): the JAX package's ids and
  ``transformers.GPT2Tokenizer``'s on the seven texts of
  ``tests/test_convert.py`` (on the same synthetic vocabulary, with its
  '#'-led merge) and on hypothesis-drawn text (letters and digits of many
  scripts, combining marks, runs of whitespace, contractions and
  ``<|endoftext|>``) over a vocabulary of merges learned on English-like
  text; ``_pretokens`` gives ``regex.findall``'s pieces of the JAX
  pattern; decode round-trips.

Everything is exact.
"""
import json

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from distributed_tensorflow_tpu.data import text as jtext
from distributed_tensorflow_tpu_torch.data import text
from distributed_tensorflow_tpu_torch.utils import native

transformers = pytest.importorskip("transformers")
regex = pytest.importorskip("regex")

torch.set_num_threads(1)

CORPUS = ("the quick brown fox jumps over the lazy dog. " * 16
          + chip_smoke.hf_text(np, 0, 3000))
TEXTS = [
    "the thesis in the theses",
    "  leading spaces, punctuation! and 123 numbers",
    "unicode: café — 中文 \U0001f600",
    "line\nbreaks\n\n and trailing ",
    "it's the'd they'll we've I'm",
    "## markdown header and #include <stdio.h>",
    "doc one<|endoftext|>doc two<|endoftext|>",
]


def test_byte_tokenizer_equals_the_jax_one():
    for specials in (("<pad>", "<bos>", "<eos>"), ("<bos>",)):
        got, want = text.ByteTokenizer(specials), jtext.ByteTokenizer(
            specials)
        assert got.vocab_size == want.vocab_size
        for t in TEXTS:
            kw = dict(bos=True, eos=False)
            g = got.encode(t, **kw) if "<bos>" in specials else \
                got.encode(t)
            w = want.encode(t, **kw) if "<bos>" in specials else \
                want.encode(t)
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
            assert got.decode(g) == want.decode(w) == t
    with pytest.raises(KeyError, match="<pad>"):
        text.ByteTokenizer(("<bos>",)).pad_id


@pytest.fixture(scope="module")
def trained():
    return (text.BPETokenizer.train([CORPUS], 420),
            jtext.BPETokenizer.train([CORPUS], 420))


def test_bpe_train_learns_the_jax_merges(trained):
    got, want = trained
    assert got.merges == want.merges and len(got.merges) == 420 - 259
    assert got.vocab_size == want.vocab_size == 420
    small = text.BPETokenizer.train(["abab", "ab"], 300, specials=())
    assert small.merges == jtext.BPETokenizer.train(
        ["abab", "ab"], 300, specials=()).merges
    with pytest.raises(ValueError, match="vocab_size"):
        text.BPETokenizer.train(["x"], 100)


@pytest.mark.parametrize("backend", ["native", "auto", "python"])
def test_bpe_encode_gives_the_jax_ids(trained, backend):
    got, want = trained
    for t in TEXTS + [CORPUS[::-1], "", "z"]:
        ids = got.encode(t, bos=True, eos=True, backend=backend)
        np.testing.assert_array_equal(
            ids, want.encode(t, bos=True, eos=True, backend="python"))
        assert ids.dtype == np.int32
        assert got.decode(ids) == want.decode(ids) == t


def test_bpe_save_load_cross_the_packages(trained, tmp_path):
    got, want = trained
    got.save(str(tmp_path / "port.json"))
    want.save(str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())
    back = text.BPETokenizer.load(str(tmp_path / "jax.json"))
    assert back.merges == want.merges
    assert jtext.BPETokenizer.load(str(tmp_path / "port.json")).merges == \
        got.merges
    np.testing.assert_array_equal(back.encode(CORPUS),
                                  got.encode(CORPUS, backend="python"))


def test_bpe_backend_validation(trained, monkeypatch):
    got, _ = trained
    with pytest.raises(ValueError, match="unknown backend"):
        got.encode("x", backend="rust")
    monkeypatch.setattr(native, "native_available", lambda: False)
    for backend in ("native", "auto"):
        with pytest.raises(RuntimeError, match="cannot be built"):
            got.encode("x", backend=backend)
    assert got.encode("x", backend="python").tolist() == [ord("x")]


def _reference_vocab(tmp_path):
    """The synthetic checkpoint files of ``tests/test_convert.py``."""
    b2u = text._gpt2_bytes_to_unicode()
    vocab = {b2u[b]: i for i, b in enumerate(sorted(b2u))}
    merges = [("t", "h"), ("th", "e"), ("Ġ", "the"), ("e", "s"),
              ("i", "n"), ("Ġthe", "s"), ("1", "2"), ("#", "#")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    vf, mf = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vf.write_text(json.dumps(vocab), encoding="utf-8")
    mf.write_text("#version: 0.2\n" +
                  "\n".join(f"{a} {b}" for a, b in merges) + "\n",
                  encoding="utf-8")
    return str(vf), str(mf)


def _three(vf, mf):
    return (text.GPT2BPETokenizer.load(vf, mf),
            jtext.GPT2BPETokenizer.load(vf, mf),
            transformers.GPT2Tokenizer(vf, mf))


def test_gpt2_bpe_equals_jax_and_transformers(tmp_path):
    ours, jax_tok, hf = _three(*_reference_vocab(tmp_path))
    for t in TEXTS:
        ids = ours.encode(t)
        assert ids.dtype == np.int32
        assert ids.tolist() == jax_tok.encode(t).tolist() == hf.encode(t)
        assert ours.decode(ids) == t
    # CRLF merges: no '\r' on the second symbol
    vf, mf = _reference_vocab(tmp_path)
    crlf = tmp_path / "crlf.txt"
    crlf.write_bytes(open(mf, "rb").read().replace(b"\n", b"\r\n"))
    assert text.GPT2BPETokenizer.load(vf, str(crlf)).encode(
        TEXTS[0]).tolist() == hf.encode(TEXTS[0])


@pytest.fixture(scope="module")
def learned(tmp_path_factory):
    """A vocabulary of 300 merges learned on English-like text, written
    as GPT-2 files (``chip_smoke.gpt2_tokenizer_files``)."""
    d = tmp_path_factory.mktemp("gpt2_vocab")
    chip_smoke.gpt2_tokenizer_files(
        d, text.BPETokenizer.train([CORPUS], 259 + 300))
    return _three(str(d / "vocab.json"), str(d / "merges.txt"))


_CHARS = st.characters(codec="utf-8", exclude_categories=("Cs", "Cn", "Co"))
_PIECES = st.sampled_from([
    "'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S", " 's", "!'s",
    "<|endoftext|>", "<|endoftext|", " <|endoftext|> ", "  ", "\n\n",
    " \t ", "　", "\xa0", "\x1c", "\x1f ", "é", " the", " quick",
    "٣٤", "Ⅻ", "¼", "中文", "Ωμέγα", "ß", "ﬁ", "12 345", " 7", "#",
    "\U0001f600", "\r\n", "\x0b", "\x85", " "])
_TEXT = st.lists(st.one_of(st.text(_CHARS, max_size=6), _PIECES),
                 max_size=10).map("".join)


@settings(max_examples=250, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture,
                                 HealthCheck.too_slow])
@given(t=_TEXT)
def test_gpt2_bpe_ids_on_drawn_text(learned, t):
    ours, jax_tok, hf = learned
    pieces = list(text._pretokens(t))
    assert pieces == regex.findall(jtext.GPT2BPETokenizer._PRETOKEN, t)
    ids = ours.encode(t)
    assert ids.tolist() == jax_tok.encode(t).tolist() == hf.encode(t)
    assert ours.decode(ids) == t


def test_gpt2_bpe_special_tokens_split_longest_first(tmp_path):
    vf, mf = _reference_vocab(tmp_path)
    vocab = json.load(open(vf))
    vocab["<|end|>"] = len(vocab)
    vocab["<|endoftext|>x"] = len(vocab)
    json.dump(vocab, open(vf, "w"))
    specials = ("<|end|>", "<|endoftext|>", "<|endoftext|>x", "<|absent|>")
    ours = text.GPT2BPETokenizer.load(vf, mf, special_tokens=specials)
    want = jtext.GPT2BPETokenizer.load(vf, mf, special_tokens=specials)
    assert ours.special_tokens == want.special_tokens
    for t in ("a<|endoftext|>xb<|end|><|endoftext|><|absent|>",
              "<|end|><|end|>", "<|endoftext|>", "x<|end"):
        assert ours.encode(t).tolist() == want.encode(t).tolist()
