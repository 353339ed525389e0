"""Text tokenization: the byte-level base, trainable BPE and GPT-2's BPE.

Counterpart of ``distributed_tensorflow_tpu/data/text.py``, the same ids:

  * ``ByteTokenizer``: one id per byte, special ids after the byte range.
  * ``BPETokenizer``: byte-pair encoding trained on raw text (Sennrich et
    al., 2016): repeatedly merge the most frequent adjacent pair, ties to
    the smaller pair; ``encode`` applies the merges by rank.
    ``backend="python"`` runs the merge loop here; ``"native"`` and
    ``"auto"`` (the default) run the same loop in host C++
    (``csrc/bpe.cpp`` through ``utils/native.py``), with the same
    segmentation.  Unlike the JAX package's ``"auto"``, which falls back
    to the Python loop where the library is missing, the port's raises
    there, as every host routine of the port does without a compiler.
  * ``GPT2BPETokenizer``: replays a GPT-2 checkpoint's ``vocab.json`` and
    ``merges.txt`` with ``transformers``' ids.  The JAX package splits
    the text with the ``regex`` package's pattern ``'s|'t|'re|'ve|'m|'ll
    |'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``; the
    port needs no ``regex``: ``_pretokens`` scans for the same pieces,
    with ``unicodedata.category`` for ``\\p{L}`` (``L*``) and ``\\p{N}``
    (``N*``) and ``str.isspace`` less U+001C..U+001F for ``\\s`` (what
    ``regex`` counts as whitespace).  Code points that Python's Unicode
    database leaves unassigned may be letters or digits in ``regex``'s
    newer one; text of assigned characters splits the same.

All return int32 numpy arrays.
"""
from __future__ import annotations

import json
import unicodedata
from collections import Counter
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ByteTokenizer", "BPETokenizer", "GPT2BPETokenizer"]


def _special_id(specials: Dict[str, int], name: str) -> int:
    """A special token's id; a missing one raises rather than alias a
    byte."""
    try:
        return specials[name]
    except KeyError:
        raise KeyError(f"tokenizer has no {name!r} special token; "
                       f"configured: {sorted(specials)}") from None


def _apply_merge(seq, pair, new_id):
    """Replace every non-overlapping occurrence of ``pair`` in ``seq``
    with ``new_id``, left to right: the one merge step of BPE training,
    BPE encoding and the GPT-2 replay (symbols are ints or strings)."""
    out: List = []
    i = 0
    n = len(seq)
    while i < n:
        if i + 1 < n and seq[i] == pair[0] and seq[i + 1] == pair[1]:
            out.append(new_id)
            i += 2
        else:
            out.append(seq[i])
            i += 1
    return out


class ByteTokenizer:
    """Reversible byte-level tokenizer: ids 0-255 are bytes; special
    tokens (``<pad>``, ``<bos>``, ``<eos>`` by default) get ids 256+."""

    def __init__(self, specials: Sequence[str] = ("<pad>", "<bos>", "<eos>")):
        self.specials = {name: 256 + i for i, name in enumerate(specials)}

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.specials)

    @property
    def pad_id(self) -> int:
        return _special_id(self.specials, "<pad>")

    @property
    def bos_id(self) -> int:
        return _special_id(self.specials, "<bos>")

    @property
    def eos_id(self) -> int:
        return _special_id(self.specials, "<eos>")

    def encode(self, text: str, bos: bool = False,
               eos: bool = False) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        by = bytes(int(i) for i in np.asarray(ids).ravel() if int(i) < 256)
        return by.decode("utf-8", errors="replace")


class BPETokenizer:
    """Byte-pair encoding over the byte alphabet.

    ``train`` learns ``vocab_size - 256 - len(specials)`` merges; merge
    ``r`` gets id ``256 + len(specials) + r``.  ``save``/``load`` keep
    one JSON file, the JAX package's format."""

    def __init__(self, merges: Optional[List[Tuple[int, int]]] = None,
                 specials: Sequence[str] = ("<pad>", "<bos>", "<eos>")):
        self.merges: List[Tuple[int, int]] = list(merges or [])
        self.specials_names = list(specials)
        self._rebuild()

    def _rebuild(self) -> None:
        self._base = 256 + len(self.specials_names)
        self.specials = {n: 256 + i for i, n in
                         enumerate(self.specials_names)}
        self._ranks: Dict[Tuple[int, int], int] = {
            tuple(pair): r for r, pair in enumerate(self.merges)}
        # [n_merges, 2] int32 for the host encoder, built once
        self._merge_array = (np.asarray(self.merges, np.int32)
                             if self.merges
                             else np.zeros((0, 2), np.int32))
        self._expand: Dict[int, bytes] = {i: bytes([i]) for i in range(256)}
        for r, (a, b) in enumerate(self.merges):
            self._expand[self._base + r] = (
                self._expand_id(a) + self._expand_id(b))

    def _expand_id(self, i: int) -> bytes:
        return self._expand.get(int(i), b"")

    @property
    def vocab_size(self) -> int:
        return self._base + len(self.merges)

    @property
    def pad_id(self) -> int:
        return _special_id(self.specials, "<pad>")

    @property
    def bos_id(self) -> int:
        return _special_id(self.specials, "<bos>")

    @property
    def eos_id(self) -> int:
        return _special_id(self.specials, "<eos>")

    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int,
              specials: Sequence[str] = ("<pad>", "<bos>", "<eos>")
              ) -> "BPETokenizer":
        """Learn merges until ``vocab_size`` is reached or no pair occurs
        twice; ties break on the smaller pair."""
        base = 256 + len(specials)
        if vocab_size < base:
            raise ValueError(f"vocab_size {vocab_size} < byte+special "
                             f"base {base}")
        seqs = [list(t.encode("utf-8")) for t in texts]
        merges: List[Tuple[int, int]] = []
        next_id = base
        while next_id < vocab_size:
            counts: Counter = Counter()
            for s in seqs:
                counts.update(zip(s, s[1:]))
            if not counts:
                break
            best, n = max(counts.items(),
                          key=lambda kv: (kv[1], tuple(-x for x in kv[0])))
            if n < 2:
                break
            merges.append((int(best[0]), int(best[1])))
            seqs = [_apply_merge(s, best, next_id) for s in seqs]
            next_id += 1
        return cls(merges, specials)

    def encode(self, text: str, bos: bool = False,
               eos: bool = False, backend: str = "auto") -> np.ndarray:
        """``backend``: "python" runs the merge loop here; "native" and
        "auto" run it in ``csrc/bpe.cpp`` (the same ids) and raise where
        that cannot be built."""
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown backend {backend!r}")
        raw = text.encode("utf-8")
        if backend == "python":
            s = list(raw)
            while len(s) > 1:
                # the lowest-rank pair present, merged everywhere
                ranked = [(self._ranks[p], p) for p in set(zip(s, s[1:]))
                          if p in self._ranks]
                if not ranked:
                    break
                rank, pair = min(ranked)
                s = _apply_merge(s, pair, self._base + rank)
            ids = np.asarray(s, np.int32)
        else:
            from ..utils import native
            if not native.native_available():
                raise RuntimeError(
                    f"backend={backend!r}: the host BPE encoder "
                    "(csrc/bpe.cpp) cannot be built here; "
                    "backend='python' runs the merge loop")
            ids = native.bpe_encode(raw, self._merge_array, self._base)
        parts = []
        if bos:
            parts.append(np.asarray([self.bos_id], np.int32))
        parts.append(ids)
        if eos:
            parts.append(np.asarray([self.eos_id], np.int32))
        return np.concatenate(parts) if len(parts) > 1 else ids

    def decode(self, ids) -> str:
        out = b"".join(self._expand_id(i) for i in np.asarray(ids).ravel()
                       if int(i) not in self.specials.values())
        return out.decode("utf-8", errors="replace")

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"merges": self.merges,
                       "specials": self.specials_names}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls([tuple(m) for m in d["merges"]], d["specials"])


# -- GPT-2 byte-level BPE (checkpoint interop) ----------------------------

def _gpt2_bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> character table: printable bytes map to
    themselves, the rest to 256 + n, so that any byte string becomes a
    string the merges apply to."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# ``regex`` does not count these as ``\s``; ``str.isspace`` does
_NOT_REGEX_SPACE = frozenset("\x1c\x1d\x1e\x1f")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_CLASS: Dict[str, str] = {}


def _char_class(c: str) -> str:
    """'s' (``\\s``), 'L' (``\\p{L}``), 'N' (``\\p{N}``) or 'o' (other)."""
    k = _CLASS.get(c)
    if k is None:
        if c.isspace() and c not in _NOT_REGEX_SPACE:
            k = "s"
        else:
            k = unicodedata.category(c)[0]
            k = k if k in "LN" else "o"
        _CLASS[c] = k
    return k


def _pretokens(text: str) -> Iterator[str]:
    """The pieces ``regex.findall`` of GPT-2's pattern gives, in order:
    at each position the first alternative that matches, as ``regex``
    tries them."""
    n = len(text)
    cls = [_char_class(c) for c in text]
    i = 0
    while i < n:
        c = text[i]
        con = c == "'" and next((t for t in _CONTRACTIONS
                                 if text.startswith(t, i)), None)
        if con:
            yield con
            i += len(con)
            continue
        # " ?\p{L}+", " ?\p{N}+", " ?[^\s\p{L}\p{N}]+": an optional
        # leading space (U+0020 only) joins a run of one class
        j = i + 1 if c == " " and i + 1 < n and cls[i + 1] != "s" else i
        k = cls[j]
        if k != "s":
            e = j + 1
            while e < n and cls[e] == k:
                e += 1
            yield text[i:e]
            i = e
            continue
        # "\s+(?!\S)" then "\s+": a run of whitespace gives back its last
        # character to a following non-space, unless it is that one alone
        e = i + 1
        while e < n and cls[e] == "s":
            e += 1
        if e < n and e - i > 1:
            e -= 1
        yield text[i:e]
        i = e


class GPT2BPETokenizer:
    """GPT-2's byte-level BPE from a checkpoint's ``vocab.json`` and
    ``merges.txt``: the checkpoint's ids, as ``transformers``'
    ``GPT2Tokenizer`` gives them.  Pairs with
    ``models.convert.gpt2_from_hf``.  Added tokens in the vocabulary
    (``special_tokens``) are split out first, longest first, and stay
    one id each."""

    def __init__(self, vocab: Dict[str, int],
                 merges: List[Tuple[str, str]],
                 special_tokens: Sequence[str] = ("<|endoftext|>",)):
        self.vocab = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self._ranks = {tuple(m): r for r, m in enumerate(merges)}
        self._b2u = _gpt2_bytes_to_unicode()
        self._u2b = {u: b for b, u in self._b2u.items()}
        self._cache: Dict[str, List[str]] = {}
        self.special_tokens = sorted(
            (t for t in special_tokens if t in self.vocab),
            key=len, reverse=True)

    @classmethod
    def load(cls, vocab_file: str, merges_file: str,
             special_tokens: Sequence[str] = ("<|endoftext|>",)
             ) -> "GPT2BPETokenizer":
        """``special_tokens``: added tokens that bypass BPE (a fine-tuned
        checkpoint's pad or chat markers)."""
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_file, encoding="utf-8") as f:
            for n, line in enumerate(f):
                line = line.rstrip()   # CRLF files: no \r on the symbol
                # only the first line may be the '#version' header: real
                # merge rules may start with '#' ('# #', '## #')
                if not line:
                    continue
                if n == 0 and line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges, special_tokens=special_tokens)

    def _bpe(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        symbols: List[str] = list(word)
        while len(symbols) > 1:
            pairs = [(self._ranks.get((a, b), float("inf")), i)
                     for i, (a, b) in enumerate(zip(symbols, symbols[1:]))]
            rank, i = min(pairs)
            if rank == float("inf"):
                break
            pair = (symbols[i], symbols[i + 1])
            symbols = _apply_merge(symbols, pair, pair[0] + pair[1])
        self._cache[word] = symbols
        return symbols

    def _encode_plain(self, text: str, ids: List[int]) -> None:
        for tok in _pretokens(text):
            word = "".join(self._b2u[b] for b in tok.encode("utf-8"))
            ids.extend(self.vocab[p] for p in self._bpe(word))

    def _split_specials(self, text: str) -> Iterator[Tuple[str, bool]]:
        """(piece, is_special) left to right: the leftmost special token
        next, the longest of those that start there."""
        pos = 0
        while self.special_tokens:
            hits = [(at, -len(t), t) for t in self.special_tokens
                    for at in (text.find(t, pos),) if at >= 0]
            if not hits:
                break
            at, _, tok = min(hits)
            yield text[pos:at], False
            yield tok, True
            pos = at + len(tok)
        yield text[pos:], False

    def encode(self, text: str) -> np.ndarray:
        ids: List[int] = []
        for piece, special in self._split_specials(text):
            if special:
                ids.append(self.vocab[piece])
            elif piece:
                self._encode_plain(piece, ids)
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        text = "".join(self.inv_vocab[int(i)]
                       for i in np.asarray(ids).ravel()
                       if int(i) in self.inv_vocab)
        data = bytes(self._u2b[c] for c in text if c in self._u2b)
        return data.decode("utf-8", errors="replace")
