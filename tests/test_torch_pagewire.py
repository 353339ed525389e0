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
* The sender, ``PageWire`` over ``InProcessLink``, equals the reference's
  on the same records and fault plans: what the destination adopts, the
  plan's audit trail and the ``dttpu_wire_*`` series (chunking, overlap,
  drop, corrupt and stall retried, kill_host and exhausted retries a
  ``WireError``, the degradations), and its seeded backoff delays.
* The chaos matrix on a port fleet: ``drain_replica`` with the page wire
  under each wire fault, pre- and mid-transfer, ends with the reference's
  unmigrated tokens and an exact stream; kill_host degrades to
  re-prefill.

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
from distributed_tensorflow_tpu.resilience import faults as jfaults
from distributed_tensorflow_tpu.summary.crc32c import py_crc32c as jcrc
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              RequestSnapshot,
                                              load_jax_params)
from distributed_tensorflow_tpu_torch import fleet as tfleet
from distributed_tensorflow_tpu_torch.fleet import pagewire as wire
from distributed_tensorflow_tpu_torch.obs import metrics as tmetrics
from distributed_tensorflow_tpu_torch.resilience import faults as tfaults
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


# ---------------------------------------------------------------------------
# the sender: PageWire over InProcessLink, against the reference's


class _Snap:
    """A shipped-pages manifest carrier for the wire's unit cases."""

    def __init__(self, shipped, page_size):
        self.shipped_pages = tuple(shipped)
        self.page_size = page_size


class _FakeDest:
    """A destination that adopts everything (or refuses)."""

    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail

    def import_wire_pages(self, snap, records, timeout_s=None):
        if self.fail:
            raise RuntimeError("destination pool exhausted")
        self.calls.append([(r.index, r.chain, r.tokens) for r in records])
        return len(records)


_WIRES = {"jax": (jwire, jfaults, metrics_lib),
          "torch": (wire, tfaults, tmetrics)}


def _sender(pkg, **kw):
    mod, _, mlib = _WIRES[pkg]
    reg = mlib.Registry()
    kw.setdefault("chunk_pages", 1)
    kw.setdefault("backoff_base_s", 1e-4)
    kw.setdefault("backoff_max_s", 1e-3)
    kw.setdefault("sleep", lambda s: None)
    return mod.PageWire(registry=reg, **kw), reg


def _wire_series(pkg, reg):
    fams = _WIRES[pkg][2].parse_exposition(reg.expose())
    return {k: v for name, fam in fams.items()
            if name.startswith("dttpu_wire_") and "seconds" not in name
            for k, v in fam["samples"].items()}


def _records(chains):
    return [(i, c, {}) for i, c in enumerate(chains)]


def _ship_case(pkg, faults=(), records=("a", "b", "c"), dest=None,
               shipped=None, **kw):
    """One ``ship`` under ``faults``: (adopted or the error's class name,
    the destination's calls, the plan's log, the wire series)."""
    _, flib, mlib = _WIRES[pkg]
    sender, reg = _sender(pkg, **kw)
    dest = dest if dest is not None else _FakeDest()
    chains = [c.encode() for c in records]
    snap = _Snap(shipped if shipped is not None else
                 [(c, 4 * (i + 1)) for i, c in enumerate(chains)], 4)
    plan = flib.FaultPlan(list(faults), registry=mlib.Registry())
    with flib.activated(plan):
        try:
            got = sender.ship(_records(chains), dest, snap)
        except Exception as e:
            got = type(e).__name__
    calls = getattr(dest, "calls", None)
    return got, calls, plan.log, _wire_series(pkg, reg), \
        reg.get("dttpu_wire_transfer_seconds").count


_SHIP_CASES = {
    # id: (ship arguments, adopted, retried)
    "chunks_of_2": (dict(chunk_pages=2), 3, False),
    "overlap_2": (dict(overlap=2), 3, False),
    "drop": (dict(faults=[{"kind": "drop_chunk", "at": 0}]), 3, True),
    "corrupt": (dict(faults=[{"kind": "corrupt_chunk", "at": 1}]), 3, True),
    "stall": (dict(faults=[{"kind": "stall_wire", "at": 0,
                            "seconds": 0.05}], timeout_s=0.01), 3, True),
    "kill_host": (dict(faults=[{"kind": "kill_host", "at": 1}]),
                  "WireError", False),
    "retries_exhausted": (dict(faults=[{"kind": "drop_chunk", "at": i}
                                       for i in range(3)],
                               records=("a",), max_retries=2),
                          "WireError", True),
    "nothing": (dict(records=()), 0, False),
    "no_wire_surface": (dict(dest=object()), 0, False),
    "refused": (dict(dest=_FakeDest(fail=True)), 0, False),
}


@pytest.mark.parametrize("name", sorted(_SHIP_CASES))
def test_ship_equals_the_reference(name):
    import copy
    case, adopted, retried = _SHIP_CASES[name]
    ref = _ship_case("jax", **copy.deepcopy(case))
    got = _ship_case("torch", **copy.deepcopy(case))
    assert got == ref
    out, calls, log, series, timed = got
    assert out == adopted
    assert [e["kind"] for e in log] == [f["kind"] for f in
                                        case.get("faults", ())][:len(log)]
    assert (series[("dttpu_wire_chunk_retries_total", ())] > 0) == retried
    if adopted == 3:
        assert calls == [[(0, b"a", 4), (1, b"b", 8), (2, b"c", 12)]]
        assert timed == 1
    failed = series[("dttpu_wire_failures_total", ())]
    assert failed == (1 if adopted == "WireError" or name == "refused"
                      else 0)
    if name == "kill_host":
        assert calls == []


def test_ship_splices_the_contiguous_prefix_only():
    for pkg in ("jax", "torch"):
        sender, reg = _sender(pkg)
        dest = _FakeDest()
        snap = _Snap([(b"a", 4), (b"b", 8)], 4)
        assert sender.ship([(1, b"b", {})], dest, snap) == 0
        assert dest.calls == []
        assert _wire_series(pkg, reg)[("dttpu_wire_failures_total", ())] \
            == 0


def test_backoff_delays_equal_the_reference():
    a, _ = _sender("jax", seed=5, backoff_base_s=0.002, backoff_max_s=0.05)
    b, _ = _sender("torch", seed=5, backoff_base_s=0.002,
                   backoff_max_s=0.05)
    got = [b._delay(i) for i in range(1, 9)]
    assert got == [a._delay(i) for i in range(1, 9)]
    assert all(x <= 0.05 * 1.5 for x in got) and got[1] > got[0] * 1.5
    with pytest.raises(ValueError, match="chunk_pages"):
        wire.PageWire(chunk_pages=0, registry=tmetrics.Registry())
    with pytest.raises(ValueError, match="overlap"):
        wire.PageWire(overlap=0, registry=tmetrics.Registry())


def test_link_applies_the_plan_per_frame():
    link = wire.InProcessLink(wire_id=3)
    frames = [b"x" * 16, b"y" * 16, b"z" * 16]
    plan = tfaults.FaultPlan(
        [{"kind": "drop_chunk", "at": 0, "replica": 3},
         {"kind": "corrupt_chunk", "at": 1, "replica": 3},
         {"kind": "kill_host", "at": 5, "replica": 3}],
        registry=tmetrics.Registry())
    with tfaults.activated(plan):
        out = link.deliver(frames)
        assert out[0] is None and out[2] == frames[2]
        assert out[1] != frames[1] and len(out[1]) == 16
        assert link.deliver(frames[:2]) == frames[:2]
        with pytest.raises(ConnectionError):
            link.deliver(frames[:1])
    assert link.deliver(frames) == frames          # no plan: clean


def test_pagewire_ships_engine_pages_and_resume_skips_windows():
    src, dst = _engine(), _engine()
    page = src.scheduler.page_size
    p, snap = _exported(src, seed=13)
    records = src.export_wire_pages(snap)
    sender, reg = _sender("torch", chunk_pages=2)
    before = dst.stats()
    assert sender.ship(records, dst, snap) == 2
    assert sender.ship(records, dst, snap) == 2        # idempotent
    h = dst.import_request(snap)
    dst.drain()
    after = dst.stats()
    assert h.status == "ok" and h.tokens == _want(p, 10)
    assert after.prefix_tokens_reused_total \
        - before.prefix_tokens_reused_total >= 2 * page
    series = _wire_series("torch", reg)
    assert series[("dttpu_wire_transfers_total", ())] == 2
    assert series[("dttpu_wire_pages_shipped_total", ())] == 4


@pytest.fixture(scope="module")
def wire_fleet():
    """One two-engine port fleet with a page wire, shared by the chaos
    matrix (each case migrates a fresh prompt)."""
    reg = tmetrics.Registry()
    engines = [_engine(registry=reg) for _ in range(2)]
    sender = wire.PageWire(chunk_pages=1, timeout_s=0.05,
                           backoff_base_s=1e-4, backoff_max_s=1e-3,
                           registry=reg)
    return engines, tfleet.Router(engines, registry=reg,
                                  page_wire=sender), reg


_WIRE_KINDS = ["none", "drop_chunk", "corrupt_chunk", "stall_wire",
               "kill_host"]


@pytest.mark.parametrize("at", [0, 1], ids=["pre_transfer",
                                            "mid_transfer"])
@pytest.mark.parametrize("kind", _WIRE_KINDS)
def test_router_wire_migration_chaos_matrix(wire_fleet, kind, at):
    """drain_replica with the page wire under each wire fault, armed at
    the first frame and the second: the request ends with the
    reference's unmigrated tokens and a stream without a gap or a
    repeat; recoverable faults still ship (retry), kill_host degrades
    to re-prefill."""
    engines, router, reg = wire_fleet
    page = engines[0].scheduler.page_size
    p = _prompt(2 * page - 2, 200 + 10 * at + _WIRE_KINDS.index(kind))
    c0 = {k: reg.get(k).value for k in (
        "dttpu_router_wire_migrations_total",
        "dttpu_router_wire_degraded_total",
        "dttpu_wire_chunk_retries_total", "dttpu_migrations_total")}
    faults = ([] if kind == "none" else
              [{"kind": kind, "at": at, "replica": 0, "seconds": 0.2}])
    plan = tfaults.FaultPlan(faults, registry=tmetrics.Registry())
    stream = []
    with tfaults.activated(plan):
        h = router.submit(p, 8, on_token=stream.extend)
        while len(h.tokens) < 5:
            router.step()
        victim = h.replica_id
        survivor = engines[1 - victim].stats()
        assert router.drain_replica(victim, timeout_s=60) is True
        while not h.done:
            router.step()
    router.resume_replica(victim)
    d = {k: reg.get(k).value - v for k, v in c0.items()}
    assert [e["kind"] for e in plan.log] == [k["kind"] for k in faults]
    assert h.status == "ok" and h.tokens == _want(p, 8)
    assert stream == h.tokens
    assert d["dttpu_migrations_total"] == 1
    skipped = engines[1 - victim].stats().prefill_windows_skipped_total \
        - survivor.prefill_windows_skipped_total
    if kind == "kill_host":
        assert d["dttpu_router_wire_degraded_total"] == 1
        assert d["dttpu_router_wire_migrations_total"] == 0
    else:
        assert d["dttpu_router_wire_migrations_total"] == 1
        assert d["dttpu_router_wire_degraded_total"] == 0
        assert skipped >= 2 * page // 4
        assert (d["dttpu_wire_chunk_retries_total"] > 0) \
            == (kind != "none")
