"""The port's ``ops/decoding.py`` held against the JAX package's.

First ``filtered_logits``.

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

Then the decode-loop and beam helpers, on the same numpy inputs:
``ragged_prompt_masks`` (and its right-padded refusal), ``decode_loop``'s
early exit, ``init_beam_scores``, ``freeze_finished``, ``expand_beams``
and ``rank_beams``, equal element for element.  ``expand_beams`` is held
on tied scores too (integers, and -inf ties from dead and frozen beams),
where the reference's ``lax.top_k`` keeps the lower flat index first and
``torch.topk`` would not: the port's stable sort must pick the same
beams in the same order.
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


# ------------------------------------------------------ loop and beam helpers

def test_ragged_prompt_masks_match_jax():
    pv = np.ones((3, 6), bool)
    pv[0, :2] = False
    pv[2, :5] = False
    want = jdec.ragged_prompt_masks(jnp.asarray(pv), (3, 6), 10)
    got = tdec.ragged_prompt_masks(torch.from_numpy(pv), (3, 6), 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool


def test_ragged_prompt_masks_refusals():
    right = np.ones((2, 5), bool)
    right[1, -2:] = False                      # right-padded row
    for mod, arr in ((jdec, jnp.asarray), (tdec, torch.from_numpy)):
        with pytest.raises(ValueError, match="LEFT-padded"):
            mod.ragged_prompt_masks(arr(right), (2, 5), 8)
        with pytest.raises(ValueError, match="shape"):
            mod.ragged_prompt_masks(arr(right), (2, 6), 8)


@pytest.mark.parametrize("finish_at,start,n_steps", [
    ([3, 5, 2], 0, 10), ([30, 30, 30], 2, 9), ([0, 0, 0], 0, 4)],
    ids=["early", "budget", "already"])
def test_decode_loop_matches_jax(finish_at, start, n_steps):
    """Row r finishes at step finish_at[r]; the counter counts steps."""
    fin_at = np.asarray(finish_at, np.int32)

    def jadvance(carry, i):
        count, finished = carry
        return count + 1, finished | (i + 1 >= jnp.asarray(fin_at))

    def tadvance(carry, i):
        count, finished = carry
        return count + 1, finished | (i + 1 >= torch.from_numpy(fin_at))

    fin0 = fin_at <= start
    (jcount, jfin), jstop = jdec.decode_loop(
        jadvance, (jnp.int32(0), jnp.asarray(fin0)), n_steps, start=start)
    (tcount, tfin), tstop = tdec.decode_loop(
        tadvance, (0, torch.from_numpy(fin0)), n_steps, start=start)
    assert (tcount, tstop) == (int(jcount), int(jstop))
    np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))


def test_init_beam_scores_and_freeze_finished_match_jax():
    np.testing.assert_array_equal(tdec.init_beam_scores(3, 4).numpy(),
                                  np.asarray(jdec.init_beam_scores(3, 4)))
    rng = np.random.default_rng(5)
    logp = rng.standard_normal((2, 3, 11)).astype(np.float32)
    finished = np.array([[True, False, False], [False, True, True]])
    for eos in (None, 4):
        want = jdec.freeze_finished(jnp.asarray(logp), jnp.asarray(finished),
                                    eos)
        got = tdec.freeze_finished(torch.from_numpy(logp),
                                   torch.from_numpy(finished), eos)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _beam_inputs(kind, rng):
    """(scores [b, k], logp [b, k, V]) of one kind of tie."""
    if kind == "continuous":
        return (rng.standard_normal((2, 4)).astype(np.float32),
                rng.standard_normal((2, 4, 37)).astype(np.float32))
    if kind == "integer_ties":
        return (rng.integers(-2, 1, (3, 4)).astype(np.float32),
                rng.integers(-3, 1, (3, 4, 50)).astype(np.float32))
    if kind == "dead_beams":
        # only beam 0 alive and V < k: -inf candidates fill the top k
        return (np.array(jdec.init_beam_scores(2, 4)),
                rng.integers(-2, 1, (2, 4, 2)).astype(np.float32))
    # every beam frozen: EOS at zero cost, all else -inf
    logp = rng.standard_normal((2, 3, 9)).astype(np.float32)
    frozen = np.array(jdec.freeze_finished(
        jnp.asarray(logp), jnp.ones((2, 3), bool), 4))
    return np.asarray([[-1.0, -1.0, -2.0], [-3.0, -3.0, -3.0]],
                      np.float32), frozen


@pytest.mark.parametrize("kind", ["continuous", "integer_ties", "dead_beams",
                                  "frozen_beams"])
def test_expand_beams_matches_jax_including_ties(kind):
    scores, logp = _beam_inputs(kind, np.random.default_rng(11))
    want = jdec.expand_beams(jnp.asarray(scores), jnp.asarray(logp))
    got = tdec.expand_beams(torch.from_numpy(scores), torch.from_numpy(logp))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=kind)


def test_expand_beams_ties_are_where_topk_would_differ():
    """The tied cases above are real: ``torch.topk`` on them picks other
    flat indices (or another order) than the reference."""
    differs = 0
    for kind in ("integer_ties", "dead_beams"):
        scores, logp = _beam_inputs(kind, np.random.default_rng(11))
        b, k, vocab = logp.shape
        flat = torch.from_numpy(scores)[:, :, None] + torch.from_numpy(logp)
        by_topk = torch.topk(flat.reshape(b, k * vocab), k).indices
        want = jax.lax.top_k((jnp.asarray(scores)[:, :, None]
                              + jnp.asarray(logp)).reshape(b, k * vocab), k)[1]
        differs += int(not np.array_equal(by_topk.numpy(), np.asarray(want)))
    assert differs >= 1


@pytest.mark.parametrize("eos", [None, 3])
def test_rank_beams_matches_jax(eos):
    rng = np.random.default_rng(2)
    scores = rng.standard_normal((3, 4)).astype(np.float32)
    scores[1] = scores[1, 0]                    # a tied row: first wins
    gen = rng.integers(0, 6, (3, 4, 7)).astype(np.int32)
    want = jdec.rank_beams(jnp.asarray(scores), jnp.asarray(gen), eos, 7, 0.6)
    got = tdec.rank_beams(torch.from_numpy(scores), torch.from_numpy(gen),
                          eos, 7, 0.6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
