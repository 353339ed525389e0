"""The port's page wire (``fleet/pagewire.py``, ``summary/crc32c.py``) and
the engine's page shipping, held against the JAX package.

* ``crc32c`` (the C++ host routine) equals the reference's byte loop.
* Frames round-trip; a flipped byte, a bad magic or a truncation is a
  ``WireFrameError`` (the receiver's NAK).
* Frames written by the reference parse in the port and the reverse, for
  f32, int8 with its scale planes, and bf16 pages, byte for byte.
* ``export_wire_pages`` -> frames -> ``import_wire_pages`` lands the
  pages bit-equal in another engine, whose resumed request skips their
  windows and ends with the unmigrated tokens (f32 and int8 pools); an
  alien page size or chain, a contiguous engine or a pool without a
  prefix cache adopts nothing.
* Pages exported by the reference engine splice into the port engine and
  resume to the reference's tokens, and the reverse.

The tiny model's weight matrices are scaled 5x so that its greedy tokens
vary (at init scale it repeats one token).
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import serve as jserve
from distributed_tensorflow_tpu.fleet import pagewire as jwire
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.obs import metrics as metrics_lib
from distributed_tensorflow_tpu.summary.crc32c import py_crc32c as jcrc
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              RequestSnapshot,
                                              load_jax_params)
from distributed_tensorflow_tpu_torch.fleet import pagewire as wire
from distributed_tensorflow_tpu_torch.summary import crc32c as tcrc

torch.set_num_threads(1)

_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
           "intermediate_size", "max_position", "layer_norm_eps",
           "num_kv_heads", "kv_cache_dtype")


def _models(**kw):
    jmodel = jgpt_tiny(dropout_rate=0.0, **kw)
    jparams = jax.tree.map(lambda x: x * 5.0 if x.ndim >= 2 else x,
                           jmodel.init(jax.random.PRNGKey(0)))
    config = GPTConfig(dropout_rate=0.0, **{
        f: getattr(jmodel.config, f) for f in _FIELDS})
    return jmodel, jparams, load_jax_params(GPT(config, device="cpu"),
                                            jax.tree.map(np.asarray, jparams))


_MODELS = {None: _models(), "int8": _models(kv_cache_dtype="int8")}


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(0, 512, plen, dtype=np.int32)


def _want(prompt, new, kv=None):
    jmodel, jparams, _ = _MODELS[kv]
    out = jmodel.generate(jparams, jnp.asarray(prompt[None]),
                          max_new_tokens=new, max_len=64)
    return np.asarray(out)[0, prompt.size:].tolist()


def _engine(kv=None, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("tick_steps", 2)
    return Engine(_MODELS[kv][2], device="cpu", **kw)


def _ship(records, snap):
    """The records as the receiver sees them: framed two to a frame,
    parsed back."""
    recs = [wire.PageRecord(index=i, chain=c,
                            tokens=dict(snap.shipped_pages)[c], payload=p)
            for i, c, p in records]
    out = []
    for seq in range(0, len(recs), 2):
        got_seq, got = wire.parse_frame(wire.frame_chunk(seq,
                                                         recs[seq:seq + 2]))
        assert got_seq == seq
        out += got
    return out


def _exported(eng, plen=30, seed=4, new=10, after=5):
    p = _prompt(plen, seed)
    h = eng.submit(p, new)
    while len(h.tokens) < after:
        eng.step()
    return p, eng.export_request(h)


@pytest.mark.parametrize("n", [0, 1, 7, 255, 256, 257, 4096, 100_003])
def test_crc32c_matches_the_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    for crc in (0, 0xDEADBEEF):
        assert tcrc.crc32c(data, crc) == jcrc(data, crc)
        if n < 5000:
            assert tcrc.py_crc32c(data, crc) == jcrc(data, crc)
    assert tcrc.crc32c(b"123456789") == 0xE3069283


def test_frame_roundtrip_and_naks():
    recs = [wire.PageRecord(index=0, chain=b"\x01" * 8, tokens=16,
                            payload={"k": torch.randn(2, 16, 2, 8)}),
            wire.PageRecord(index=1, chain=7, tokens=32,
                            payload={"v": torch.arange(12, dtype=torch.int8)
                                     .reshape(3, 4)})]
    frame = wire.frame_chunk(5, recs)
    seq, got = wire.parse_frame(frame)
    assert seq == 5 and [r.chain for r in got] == [b"\x01" * 8, 7]
    assert torch.equal(got[0].payload["k"], recs[0].payload["k"])
    assert torch.equal(got[1].payload["v"], recs[1].payload["v"])
    bad = bytearray(frame)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(wire.WireFrameError, match="CRC"):
        wire.parse_frame(bytes(bad))
    with pytest.raises(wire.WireFrameError, match="short"):
        wire.parse_frame(frame[:8])
    with pytest.raises(wire.WireFrameError):
        wire.parse_frame(frame[:-9] + frame[-4:])
    body = b"XXXX" + frame[4:-4]
    with pytest.raises(wire.WireFrameError, match="magic"):
        wire.parse_frame(body + tcrc.crc32c(body).to_bytes(4, "big"))
    with pytest.raises(ValueError, match="CPU"):
        wire.frame_chunk(0, [dataclasses.replace(
            recs[0], payload={"k": torch.zeros(1, device="meta")})])


def _payload_pair(kind, rng):
    """The same page in numpy (reference) and torch (port) form."""
    x = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    if kind == "f32":
        return {"k": x, "v": -x}, {"k": torch.from_numpy(x),
                                   "v": torch.from_numpy(-x)}
    if kind == "bf16":
        b = x.astype(ml_dtypes.bfloat16)
        t = torch.from_numpy(x).to(torch.bfloat16)
        return {"k": b, "v": b}, {"k": t, "v": t}
    q = (x * 40).astype(np.int8)
    s = np.abs(x[..., :1]) + 0.5
    return ({"k": q, "v": q, "k_scale": s, "v_scale": s},
            {"k": torch.from_numpy(q), "v": torch.from_numpy(q),
             "k_scale": torch.from_numpy(s), "v_scale": torch.from_numpy(s)})


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
def test_frames_interoperate_with_the_reference(kind):
    rng = np.random.default_rng(1)
    jp, tp = _payload_pair(kind, rng)
    jframe = jwire.frame_chunk(3, [jwire.PageRecord(0, b"c" * 8, 8, jp),
                                   jwire.PageRecord(1, 9, 16, jp)])
    tframe = wire.frame_chunk(3, [wire.PageRecord(0, b"c" * 8, 8, tp),
                                  wire.PageRecord(1, 9, 16, tp)])
    assert tframe == jframe
    _, got = wire.parse_frame(jframe)
    _, jgot = jwire.parse_frame(tframe)
    for r, jr in zip(got, jgot):
        for name, leaf in tp.items():
            assert r.payload[name].dtype == leaf.dtype
            assert torch.equal(r.payload[name], leaf)
            assert jr.payload[name].dtype == jp[name].dtype
            np.testing.assert_array_equal(jr.payload[name], jp[name])


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_ship_pages_bit_equal_skip_windows_and_resume(kv):
    src, dst = _engine(kv), _engine(kv)
    page = src.scheduler.page_size
    p, snap = _exported(src)
    assert snap.page_size == page
    assert [t for _, t in snap.shipped_pages] == [page, 2 * page]
    records = src.export_wire_pages(snap)
    assert [i for i, _, _ in records] == [0, 1]
    shipped = _ship(records, snap)
    before = dst.stats()
    assert dst.import_wire_pages(snap, shipped) == 2
    assert dst.import_wire_pages(snap, shipped) == 2     # idempotent
    ctx = snap.context
    kv_dst = dst.scheduler._cache["kv"]
    for (_, page_id, _), (_, _, payload) in zip(
            dst.scheduler.pages.chain_pages(ctx), records):
        for name, leaf in payload.items():
            assert torch.equal(kv_dst[name][:, page_id], leaf)
    h2 = dst.import_request(snap)
    dst.drain()
    after = dst.stats()
    assert h2.status == "ok" and len(h2.tokens) == 10
    assert after.prefill_windows_skipped_total \
        - before.prefill_windows_skipped_total >= 2 * page // 4
    if kv is None:
        assert h2.tokens == _want(p, 10)
        assert len(set(h2.tokens)) >= 5


def test_wire_adopts_nothing_it_cannot_use():
    src, dst = _engine(), _engine()
    page = src.scheduler.page_size
    _, snap = _exported(src, seed=6)
    recs = _ship(src.export_wire_pages(snap), snap)
    half = dataclasses.replace(snap, page_size=page // 2)
    assert dst.import_wire_pages(half, recs) == 0
    forged = [dataclasses.replace(r, chain=b"\x00" * 8) for r in recs]
    assert dst.import_wire_pages(snap, forged) == 0
    wrong = [dataclasses.replace(r, payload={k: v.double() for k, v
                                             in r.payload.items()})
             for r in recs]
    assert dst.import_wire_pages(snap, wrong) == 0
    assert dst.stats().pages_free == dst.stats().pages_total
    assert dst.import_wire_pages(snap, recs) == 2
    flat = _engine(paged=False)
    assert flat.import_wire_pages(snap, recs) == 0
    _, flat_snap = _exported(flat, seed=6)
    assert flat_snap.shipped_pages is None
    assert flat.export_wire_pages(flat_snap) == []
    off = _engine(prefix_cache=False)
    assert off.import_wire_pages(snap, recs) == 0
    _, off_snap = _exported(off, seed=6)
    assert off.export_wire_pages(off_snap) == []


def _jengine(**kw):
    jmodel, jparams, _ = _MODELS[None]
    return jserve.Engine(jmodel, jparams, num_slots=2, max_len=64,
                         prefill_chunk=4, tick_steps=2,
                         registry=metrics_lib.Registry(), **kw)


def test_reference_pages_resume_in_the_port():
    jeng = _jengine()
    p = _prompt(30, 8)
    h = jeng.submit(p, 10)
    while len(h.tokens) < 5:
        jeng.step()
    jsnap = jeng.export_request(h)
    frame = jwire.frame_chunk(0, [
        jwire.PageRecord(i, c, dict(jsnap.shipped_pages)[c], pl)
        for i, c, pl in jeng.export_wire_pages(jsnap)])
    _, recs = wire.parse_frame(frame)
    snap = RequestSnapshot(**{f.name: getattr(jsnap, f.name)
                              for f in dataclasses.fields(RequestSnapshot)})
    eng = _engine()
    assert eng.import_wire_pages(snap, recs) == len(recs) == 2
    h2 = eng.import_request(snap)
    eng.drain()
    assert h2.tokens == _want(p, 10)
    assert eng.stats().prefill_windows_skipped_total > 0


def test_port_pages_resume_in_the_reference():
    eng = _engine()
    p, snap = _exported(eng, seed=9)
    recs = _ship(eng.export_wire_pages(snap), snap)
    _, jrecs = jwire.parse_frame(wire.frame_chunk(0, recs))
    jsnap = jserve.RequestSnapshot(**{
        f.name: getattr(snap, f.name)
        for f in dataclasses.fields(jserve.RequestSnapshot)})
    jeng = _jengine()
    assert jeng.import_wire_pages(jsnap, jrecs) == 2
    h2 = jeng.import_request(jsnap)
    jeng.drain()
    assert h2.tokens == _want(p, 10)
    assert jeng.stats().prefill_windows_skipped_total > 0
