"""The port's synthetic LM corpus and ``Dataset`` held against the JAX
package's ``data/datasets.py`` and ``data/pipeline.py``: the same arrays
and the same batches, in the same order, over two epochs (exact)."""
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.data import pipeline as jpipe
from distributed_tensorflow_tpu.data.datasets import \
    lm_sequences as jlm_sequences
from distributed_tensorflow_tpu.data.datasets import \
    synthetic_lm_corpus as jcorpus
from distributed_tensorflow_tpu_torch.data import (Dataset, lm_sequences,
                                                   synthetic_lm_corpus)

torch.set_num_threads(1)


@pytest.mark.parametrize("vocab,seed,order", [(256, 0, 2), (50257, 3, 1),
                                              (512, 7, 5)])
def test_corpus_and_sequences_equal_the_jax_arrays(vocab, seed, order):
    got = synthetic_lm_corpus(vocab, 20_000, seed=seed, order=order)
    want = jcorpus(vocab, 20_000, seed=seed, order=order)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for seq in (16, 257, 30_000):
        np.testing.assert_array_equal(lm_sequences(got, seq),
                                      jlm_sequences(want, seq))
    assert lm_sequences(got, 30_000).shape == (0, 30_001)


@pytest.mark.parametrize("shuffle,drop", [(True, True), (True, False),
                                          (False, False)])
def test_dataset_batches_equal_over_two_epochs(shuffle, drop):
    rows = lm_sequences(synthetic_lm_corpus(512, 5_000, seed=1), 32)
    labels = np.arange(len(rows), dtype=np.int32)
    kw = dict(batch_size=12, shuffle=shuffle, drop_remainder=drop, seed=4)
    got = list(Dataset([rows, labels], **kw).epochs(2))
    want = list(jpipe.Dataset([rows, labels], backend="numpy",
                              **kw).epochs(2))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    ds = Dataset([rows], **kw)
    assert len(ds) == len(jpipe.Dataset([rows], **kw))


def test_dataset_shards_transform_and_refusals():
    x = np.arange(40).reshape(20, 2)
    kw = dict(batch_size=3, seed=2, process_index=1, process_count=3)
    got = list(Dataset([x], **kw))
    want = list(jpipe.Dataset([x], **kw))
    for (a,), (b,) in zip(got, want):
        np.testing.assert_array_equal(a, b)

    def jitter(rng, batch):
        return (batch[0] + rng.integers(0, 5, batch[0].shape),)
    got = list(Dataset([x], 4, seed=9, transform=jitter))
    want = list(jpipe.Dataset([x], 4, seed=9, transform=jitter))
    for (a,), (b,) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown backend"):
        Dataset([x], 4, backend="torch")
    with pytest.raises(ValueError, match="backend='native'"):
        Dataset([x], 4, backend="native", drop_remainder=False)
    with pytest.raises(ValueError, match="leading dim"):
        Dataset([x, x[:3]], 4)
