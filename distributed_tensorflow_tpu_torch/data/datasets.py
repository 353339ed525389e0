"""Synthetic token streams for causal-LM training.

Counterpart of ``distributed_tensorflow_tpu/data/datasets.py``, the part
the GPT training path uses: ``synthetic_lm_corpus`` (a fixed random
Markov chain, 80% deterministic continuation) and ``lm_sequences`` (rows
of ``seq_len + 1`` ids).  Same seed, same arrays as the JAX package's.
The MNIST and CIFAR-10 loaders wait for the image models.
"""
from __future__ import annotations

import numpy as np

__all__ = ["synthetic_lm_corpus", "lm_sequences"]


def synthetic_lm_corpus(vocab_size: int = 256, length: int = 1_000_000,
                        seed: int = 0, order: int = 2) -> np.ndarray:
    """Deterministic synthetic token stream with learnable structure.

    A fixed random Markov chain over the last ``order`` tokens (1 or 2 —
    higher values are clamped to 2): 80% of positions follow the chain's
    deterministic continuation, 20% are noise.  Same seed → same corpus, no
    downloads; a causal LM that learns it drops well below the uniform
    log(vocab) loss, so training scripts have a real convergence signal.
    The context table is hashed into at most 2^16 buckets, so memory stays
    bounded for any vocab size.  Returns int32 [length].
    """
    rng = np.random.default_rng(seed)
    order = 1 if order <= 1 else 2
    h_mod = vocab_size if order == 1 else min(vocab_size * vocab_size,
                                              1 << 16)
    table = rng.integers(0, vocab_size, size=h_mod).tolist()
    noise = rng.random(length).tolist()
    # plain-int list arithmetic: ~10x faster than per-element numpy scalars
    out = [int(t) for t in rng.integers(0, vocab_size, order)]
    for i in range(order, length):
        ctx = (out[-1] % h_mod if order == 1
               else (out[-1] * 31 + out[-2]) % h_mod)
        if noise[i] < 0.8:           # 80% deterministic continuation
            out.append(table[ctx])
        else:
            out.append(int(noise[i] * 1e9) % vocab_size)
    return np.asarray(out, np.int32)


def lm_sequences(corpus: np.ndarray, seq_len: int) -> np.ndarray:
    """Chop a token stream into [n, seq_len+1] rows (inputs ++ next-token
    target at each position via shift-by-one).  A corpus shorter than
    ``seq_len + 1`` yields an empty [0, seq_len+1] array."""
    n = (len(corpus) - 1) // seq_len
    if n <= 0:
        return np.zeros((0, seq_len + 1), np.int32)
    x = corpus[:n * seq_len + 1]
    rows = np.stack([x[i * seq_len:(i + 1) * seq_len + 1] for i in range(n)])
    return rows.astype(np.int32)
