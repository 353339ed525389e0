"""The port's ``filtered_logits`` held against the JAX package's.

The same numpy logits go through both.  Kept tokens (entries that are not
-inf) must be the same set and their values equal: both sides divide by
the same temperature in f32 and copy the survivors, so equal means bit
equal.  Three kinds of logits: integers in [0, 4) (ties at every cut;
the reference's ``lax.top_k`` keeps the lower id first among equal
values, so the port's sort must be stable), bf16-rounded normals at
GPT-2's vocabulary (the card's logits are a bf16 product, where ties are
common) and continuous normals.  Three filters: nucleus alone, top-k
then nucleus, top-k alone.

The one exception is a nucleus cut that falls within ``CUT_TOL`` of
``top_p``: there the two f32 cumulative sums, taken in another order
over thousands of terms of a vocabulary-50257 row, may keep one token
more or less, so tokens at such a position of the sorted row (judged by
a float64 sum) are not compared.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.ops import decoding as jdec
from distributed_tensorflow_tpu_torch.ops import decoding as tdec

torch.set_num_threads(1)

CUT_TOL = 2e-5


def _at_the_cut(logits, temperature, top_k, top_p):
    """[b, V] bool: tokens whose exclusive prefix mass in the reference's
    order (descending, lower id first among ties), summed in float64,
    lies within CUT_TOL of ``top_p``."""
    out = np.zeros(logits.shape, bool)
    if top_p is None or top_p >= 1.0:
        return out
    x = (logits / np.float32(temperature)).astype(np.float64)
    for r, row in enumerate(x):
        order = np.argsort(-row, kind="stable")
        s = row[order]
        if top_k is not None:
            s[top_k:] = -np.inf
        p = np.exp(s - s[0])
        p /= p.sum()
        out[r, order] = np.abs(np.cumsum(p) - p - top_p) <= CUT_TOL
    return out


def _tied(rng):
    """Rows of small integer logits at assorted vocabulary sizes."""
    return [rng.integers(0, 4, (4, v)).astype(np.float32)
            for v in (4, 5, 17, 64, 100, 257, 300)]


def _bf16_rounded(rng):
    x = torch.from_numpy(rng.normal(0.0, 3.0, (6, 50257)).astype(np.float32))
    return [x.to(torch.bfloat16).float().numpy()]


def _continuous(rng):
    return [rng.standard_normal((4, v)).astype(np.float32)
            for v in (7, 100, 1000)]


_LOGITS = {"tied": _tied, "bf16_rounded": _bf16_rounded,
           "continuous": _continuous}
# (temperature, top_k, top_p)
_FILTERS = {
    "top_p": [(1.0, None, 0.5), (0.8, None, 0.9), (1.0, None, 0.95)],
    "top_k_top_p": [(1.0, 3, 0.5), (0.8, 50, 0.9), (1.0, 10, 0.95)],
    "top_k": [(1.0, 3, None), (0.8, 50, None), (1.0, 2, 1.0)],
}


@pytest.mark.parametrize("mode", sorted(_FILTERS))
@pytest.mark.parametrize("kind", sorted(_LOGITS))
def test_filtered_logits_matches_jax(kind, mode):
    rng = np.random.default_rng(sorted(_LOGITS).index(kind))
    for logits in _LOGITS[kind](rng):
        for temperature, top_k, top_p in _FILTERS[mode]:
            want = np.asarray(jdec.filtered_logits(
                jnp.asarray(logits), temperature, top_k, top_p))
            got = tdec.filtered_logits(torch.from_numpy(logits), temperature,
                                       top_k, top_p).numpy()
            where = str((kind, logits.shape, temperature, top_k, top_p))
            judged = ~_at_the_cut(logits, temperature, top_k, top_p)
            np.testing.assert_array_equal(np.isneginf(got)[judged],
                                          np.isneginf(want)[judged],
                                          err_msg=where)
            kept = ~np.isneginf(want) & ~np.isneginf(got)
            np.testing.assert_array_equal(got[kept], want[kept],
                                          err_msg=where)
