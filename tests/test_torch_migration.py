"""Live migration and deadlines of the port's engine, held against the
JAX package (the contracts of tests/test_migration.py, without the
router and the watchdog).

* Export mid-decode, import on a second engine: the terminal tokens equal
  an unmigrated greedy run (the port's engine and the reference's
  ``generate``) and the stream across both engines has no duplicated and
  no lost token; so too for queued and mid-prefill exports, on both
  layouts, and under a LoRA adapter.
* Export of a terminal or unknown request raises; an import that could
  not resume faithfully is refused; imports pass the same admission door
  as submits (queue depth, quota at the remaining budget).
* The export's lease handoff seeds the radix tree, so a re-import skips
  windows; ``drain(timeout_s)`` exports the stragglers.
* Deadlines retire queued, prefilling and active requests
  ``deadline_exceeded`` without touching the others' tokens.
* Across implementations: a reference snapshot resumes in the port
  engine over converted weights and ends with the reference's
  unmigrated tokens, and the reverse.

The tiny model's weight matrices are scaled 5x: at init scale it repeats
one token, and a resumed request that lost its state could still match.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import serve as jserve
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.obs import metrics as metrics_lib
from distributed_tensorflow_tpu_torch import (GPT, Engine, GPTConfig,
                                              QueueFullError, RequestSnapshot,
                                              TenantPolicy, TenantQuota,
                                              load_jax_params, lora_from_jax)

torch.set_num_threads(1)

LAYOUTS = pytest.mark.parametrize("paged", [True, False],
                                  ids=["paged", "contiguous"])


def _models():
    jmodel = jgpt_tiny(dropout_rate=0.0)
    jparams = jax.tree.map(lambda x: x * 5.0 if x.ndim >= 2 else x,
                           jmodel.init(jax.random.PRNGKey(0)))
    c = jmodel.config
    config = GPTConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                       num_layers=c.num_layers, num_heads=c.num_heads,
                       intermediate_size=c.intermediate_size,
                       max_position=c.max_position, dropout_rate=0.0)
    return jmodel, jparams, load_jax_params(GPT(config, device="cpu"),
                                            jax.tree.map(np.asarray, jparams))


_MODELS = _models()


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(0, 512, plen, dtype=np.int32)


def _want(prompt, new, params=None):
    """The reference's unmigrated greedy tokens."""
    jmodel, jparams, _ = _MODELS
    out = jmodel.generate(params if params is not None else jparams,
                          jnp.asarray(prompt[None]), max_new_tokens=new,
                          max_len=64)
    return np.asarray(out)[0, prompt.size:].tolist()


def _engine(paged=True, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("tick_steps", 2)
    return Engine(_MODELS[2], device="cpu", paged=paged, **kw)


def _jengine(**kw):
    jmodel, jparams, _ = _MODELS
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("tick_steps", 2)
    return jserve.Engine(jmodel, jparams, registry=metrics_lib.Registry(),
                         **kw)


@LAYOUTS
def test_export_mid_decode_import_exact_and_exactly_once(paged):
    src, dst = _engine(paged), _engine(paged)
    p = _prompt(5, 1)
    want = _want(p, 10)
    stream = []
    h = src.submit(p, 10, on_token=stream.extend)
    while len(h.tokens) < 4:
        src.step()
    snap = src.export_request(h)
    assert h.status == "migrated" and h.done and not src.busy
    assert snap.clean and snap.stream_offset == len(snap.generated)
    assert snap.generated == want[:len(snap.generated)]
    assert len(set(want)) >= 5, "the tokens barely vary: a vacuous test"
    h2 = dst.import_request(snap, on_token=stream.extend)
    assert h2.tokens == snap.generated            # pre-seeded
    dst.drain()
    assert h2.status == "ok" and h2.tokens == want
    assert stream == want
    assert dst.stats().inflight_per_tenant == {}


@LAYOUTS
def test_export_before_first_token_restarts_cleanly(paged):
    src, dst = _engine(paged, num_slots=1), _engine(paged)
    p_queued, p_prefill = _prompt(4, 2), _prompt(10, 3)
    h_pf = src.submit(p_prefill, 6)          # 3 windows: stays prefilling
    h_q = src.submit(p_queued, 6)            # one slot: stays queued
    src.step()
    assert src.stats().prefilling == 1 and src.stats().queued == 1
    snaps = src.export_inflight()
    assert not src.busy and len(snaps) == 2
    assert all(s.generated == [] for s in snaps)
    assert h_pf.status == "migrated" and h_q.status == "migrated"
    hs = [dst.import_request(s) for s in snaps]       # rid order
    dst.drain()
    assert hs[0].tokens == _want(p_prefill, 6)
    assert hs[1].tokens == _want(p_queued, 6)


def test_export_terminal_and_unknown_rid_raise():
    eng = _engine()
    h = eng.submit(_prompt(4, 1), 4)
    eng.drain()
    with pytest.raises(RuntimeError, match="already terminal"):
        eng.export_request(h)
    with pytest.raises(KeyError, match="no in-flight request"):
        eng.export_request(12345)


def test_import_refuses_what_it_cannot_resume():
    src = _engine()
    h = src.submit(_prompt(4, 1), 6)
    while not h.tokens:
        src.step()
    snap = src.export_request(h)
    with pytest.raises(ValueError, match="sampling config mismatch"):
        _engine(temperature=0.7).import_request(snap)
    spent = RequestSnapshot(rid=0, prompt=_prompt(4, 1), generated=[1, 2, 3],
                            max_new_tokens=3, stream_offset=3)
    with pytest.raises(ValueError, match="no remaining budget"):
        _engine().import_request(spent)
    long_snap = RequestSnapshot(rid=0, prompt=_prompt(10, 2),
                                generated=[1] * 4, max_new_tokens=8,
                                stream_offset=4)
    with pytest.raises(ValueError, match="exceeds max_len"):
        _engine(max_len=16).import_request(long_snap)
    tuned = dataclasses.replace(snap, adapter_id="tuned")
    with pytest.raises(ValueError, match="adapter table"):
        _engine().import_request(tuned)
    with pytest.raises(KeyError, match="unknown adapter_id"):
        _engine(adapter_capacity=1, adapter_rank=2).import_request(tuned)


def test_import_admission_respects_queue_depth_and_quota():
    src = _engine()
    h = src.submit(_prompt(4, 1), 8, tenant="a")
    while len(h.tokens) < 3:
        src.step()
    snap = src.export_request(h)
    assert snap.tenant == "a"
    dst = _engine(max_queue_depth=1)
    dst.submit(_prompt(4, 9), 4)                 # queue now full
    with pytest.raises(QueueFullError):
        dst.import_request(snap)
    quota = _engine(tenancy=TenantPolicy(
        {"a": TenantQuota(max_tokens_inflight=6)}))
    # charged the remaining 8 - 3 = 5 <= 6, though the original 8 is not
    h2 = quota.import_request(snap)
    assert quota.stats().tokens_inflight_per_tenant == {"a": 5}
    quota.drain()
    assert h2.status == "ok" and h2.tokens == _want(_prompt(4, 1), 8)


def test_export_handoff_seeds_radix_for_reimport():
    """The handoff publishes a chunk completed by GENERATED tokens, which
    admission alone never registers: a re-import reuses both chunks."""
    eng = _engine(prefill_chunk=4)
    page = eng.scheduler.page_size
    p = _prompt(2 * page - 2, 4)
    h = eng.submit(p, 10)
    while len(h.tokens) < 5:
        eng.step()
    before = eng.stats()
    snap = eng.export_request(h)
    assert [t for _, t in snap.shipped_pages] == [page, 2 * page]
    h2 = eng.import_request(snap)
    eng.drain()
    after = eng.stats()
    assert h2.tokens == _want(p, 10)
    assert (after.prefix_tokens_reused_total
            - before.prefix_tokens_reused_total) >= 2 * page
    assert after.prefill_windows_skipped_total \
        > before.prefill_windows_skipped_total


@LAYOUTS
def test_drain_timeout_exports_then_migrates_elsewhere(paged):
    a, b = _engine(paged, num_slots=1), _engine(paged)
    prompts = [_prompt(4, i) for i in range(3)]
    hs = [a.submit(p, 12) for p in prompts]
    for _ in range(3):
        a.step()
    res = a.drain(timeout_s=0.0)
    assert not res and not a.busy and len(res.exported) == 3
    assert all(h.status == "migrated" for h in hs)
    out = [b.import_request(s) for s in res.exported]
    assert b.drain()
    for h2, p in zip(out, prompts):
        assert h2.status == "ok" and h2.tokens == _want(p, 12)


@LAYOUTS
def test_migration_under_an_adapter(paged):
    jmodel, jparams, model = _MODELS
    rng = np.random.default_rng(7)
    ad = {n: {"a": (0.5 * rng.standard_normal((2,) + a)).astype(np.float32),
              "b": (0.5 * rng.standard_normal((2,) + b)).astype(np.float32)}
          for n, (a, b) in model.lora_shapes(4).items()}
    p = _prompt(6, 5)
    want = _want(p, 9, jmodel.merge_lora(jparams,
                                         jax.tree.map(jnp.asarray, ad)))
    assert want != _want(p, 9)
    src, dst = (_engine(paged, adapter_capacity=1, adapter_rank=4)
                for _ in range(2))
    for eng in (src, dst):
        eng.load_adapter("tuned", lora_from_jax(ad))
    h = src.submit(p, 9, adapter_id="tuned")
    while len(h.tokens) < 3:
        src.step()
    snap = src.export_request(h)
    assert snap.adapter_id == "tuned" and src.adapters.pinned() == 0
    h2 = dst.import_request(snap)
    dst.drain()
    assert h2.tokens == want and dst.adapters.pinned() == 0


@LAYOUTS
def test_deadlines_retire_queued_prefilling_and_active(paged):
    """One request of each kind expires at the same tick; the survivor's
    tokens are those of a run without them, and every page and tenant
    count comes back."""
    eng = _engine(paged, num_slots=3)
    p_act, p_pf, p_q, p_ok = (_prompt(n, 30 + n) for n in (4, 12, 5, 6))
    active = eng.submit(p_act, 20, deadline_s=3600.0)
    survivor = eng.submit(p_ok, 12)
    while len(active.tokens) < 3:
        eng.step()
    prefilling = eng.submit(p_pf, 6, deadline_s=3600.0)
    eng.step()                       # 3 windows: still prefilling
    queued = eng.submit(p_q, 6, deadline_s=0.0)
    st = eng.stats()
    assert (st.active, st.prefilling, st.queued) == (2, 1, 1)
    for h in (active, prefilling):   # their deadlines pass now
        h._req.deadline = time.perf_counter() - 1.0
    eng.step()
    for h in (active, prefilling, queued):
        assert h.status == "deadline_exceeded"
    assert 3 <= len(active.tokens) < 20
    assert prefilling.tokens == [] and queued.tokens == []
    eng.drain()
    assert survivor.status == "ok" and survivor.tokens == _want(p_ok, 12)
    st = eng.stats()
    assert st.inflight == 0 and st.inflight_per_tenant == {}
    assert st.pages_free == st.pages_total
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit(p_ok, 4, deadline_s=-1.0)


@LAYOUTS
def test_reference_snapshot_resumes_in_the_port(paged):
    p = _prompt(7, 11)
    want = _want(p, 10)
    jeng = _jengine(paged=paged)
    h = jeng.submit(p, 10)
    while len(h.tokens) < 4:
        jeng.step()
    jsnap = jeng.export_request(h)
    snap = RequestSnapshot(**{f.name: getattr(jsnap, f.name)
                              for f in dataclasses.fields(RequestSnapshot)})
    stream = []
    h2 = _engine(paged).import_request(snap, on_token=stream.extend)
    h2.result()
    assert h2.tokens == want and stream == want[snap.stream_offset:]


@LAYOUTS
def test_port_snapshot_resumes_in_the_reference(paged):
    p = _prompt(9, 12)
    want = _want(p, 10)
    eng = _engine(paged)
    h = eng.submit(p, 10)
    while len(h.tokens) < 5:
        eng.step()
    snap = eng.export_request(h)
    jsnap = jserve.RequestSnapshot(**{
        f.name: getattr(snap, f.name)
        for f in dataclasses.fields(jserve.RequestSnapshot)})
    jeng = _jengine(paged=paged)
    h2 = jeng.import_request(jsnap)
    jeng.drain()
    assert h2.tokens == want
