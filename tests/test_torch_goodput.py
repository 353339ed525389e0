"""The port's goodput accountant (``obs.goodput``) and its sites, held
against the JAX package's (the contracts of tests/test_goodput.py).

- Buckets are exclusive: a nested frame pauses its parent, so each
  second lands in one bucket; ``other`` is the unattributed remainder;
  the split sums to wall.  The same schedule on a virtual clock gives
  the same snapshot and report in both packages.
- Unknown buckets are refused; frames on two threads are independent;
  accruals reach ``dttpu_goodput_seconds_total{bucket=}`` and a Chrome
  counter lane; the module-level ``account`` is a cached no-op with
  nothing active, and ``activated`` restores the previous accountant.
- The port's sites: ``TrainSession.run_step`` books ``step``, ``save``
  ``checkpoint_save``, ``restore_latest_good`` ``checkpoint_restore``,
  the prefetch consumer's wait ``data_stall``, and ``Supervisor``'s
  rebuild and sleep ``fault_recovery`` and ``restart_backoff``; the
  buckets and ``other`` sum to the run's wall clock.
"""
import threading
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.obs import goodput as jgoodput
from distributed_tensorflow_tpu.obs import metrics as jmetrics
from distributed_tensorflow_tpu.obs import trace as jtrace
from distributed_tensorflow_tpu_torch import (GPT, adamw, gpt_tiny,
                                              make_custom_train_step)
from distributed_tensorflow_tpu_torch import data as tdata
from distributed_tensorflow_tpu_torch import resilience as tres
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.obs import goodput as tgoodput
from distributed_tensorflow_tpu_torch.obs import metrics as tmetrics
from distributed_tensorflow_tpu_torch.obs import trace as ttrace
from distributed_tensorflow_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

PACKAGES = pytest.mark.parametrize("lib", [
    (jgoodput, jmetrics, jtrace), (tgoodput, tmetrics, ttrace)],
    ids=["jax", "port"])


def _schedule(goodput):
    """Nested frames on a virtual clock: (snapshot, report)."""
    t = [0.0]
    acct = goodput.GoodputAccountant(clock=lambda: t[0]).start()
    with acct.account("step"):
        t[0] += 1.0
        with acct.account("compile"):
            t[0] += 3.0
        t[0] += 0.5
    with acct.account("fault_recovery"):
        t[0] += 0.25
        with acct.account("checkpoint_restore"):
            t[0] += 2.0
    acct.accrue("restart_backoff", 0.5)
    t[0] += 3.0                                  # untracked host time
    acct.stop()
    return acct.snapshot(), acct.report()


def test_virtual_clock_schedule_equals_jax():
    got, want = _schedule(tgoodput), _schedule(jgoodput)
    assert got == want
    snap, rep = got
    assert snap == {"step": 1.5, "compile": 3.0, "checkpoint_save": 0.0,
                    "checkpoint_restore": 2.0, "restart_backoff": 0.5,
                    "data_stall": 0.0, "fault_recovery": 0.25,
                    "other": 3.0 - 0.5}
    assert sum(snap.values()) == pytest.approx(rep["wall_s"])
    assert rep["wall_s"] == 9.75     # accrue() adds no wall time
    assert rep["goodput_pct"] == pytest.approx(100 * 1.5 / 9.75, abs=1e-3)


@PACKAGES
def test_unknown_bucket_rejected(lib):
    goodput = lib[0]
    acct = goodput.GoodputAccountant()
    with pytest.raises(ValueError, match="unknown goodput bucket"):
        acct.account("lunch")
    with pytest.raises(ValueError, match="unknown goodput bucket"):
        acct.accrue("other", 1.0)


@PACKAGES
def test_thread_frames_are_independent(lib):
    goodput = lib[0]
    acct = goodput.GoodputAccountant().start()
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            with acct.account("data_stall"):
                time.sleep(0.002)

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    with acct.account("step"):
        time.sleep(0.05)
    stop.set()
    th.join(timeout=10)
    assert not th.is_alive()
    acct.stop()
    snap = acct.snapshot()
    assert snap["step"] >= 0.04 and snap["data_stall"] > 0.0


@PACKAGES
def test_registry_export_and_counter_lane(lib):
    goodput, metrics, trace = lib
    reg = metrics.Registry()
    tracer = trace.Tracer(enabled=True)
    acct = goodput.GoodputAccountant(registry=reg)
    with trace.activated(tracer), goodput.activated(acct):
        with goodput.account("checkpoint_save"):
            time.sleep(0.01)
    c = reg.get("dttpu_goodput_seconds_total",
                labels={"bucket": "checkpoint_save"})
    assert c is not None and c.value > 0.0
    lanes = [e for e in tracer.events() if e.get("ph") == "C"]
    assert lanes and lanes[-1]["name"] == "goodput_seconds"
    assert lanes[-1]["args"]["checkpoint_save"] > 0.0


@PACKAGES
def test_inactive_is_a_noop_and_activated_restores(lib):
    goodput = lib[0]
    goodput.deactivate()
    assert goodput.account("step") is goodput._NULL_FRAME
    a, b = goodput.GoodputAccountant(), goodput.GoodputAccountant()
    goodput.activate(a)
    try:
        with goodput.activated(b):
            assert goodput.active() is b
        assert goodput.active() is a and b._stopped_at is not None
    finally:
        goodput.deactivate()


def test_the_port_sites_fill_their_buckets(tmp_path):
    model = GPT(gpt_tiny(dropout_rate=0.0), device="cpu")
    params = dict(model.named_parameters())
    opt = adamw(1e-3)
    step = make_custom_train_step(model.lm_loss_fn(), opt)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 512, (2, 17)).astype(np.int32)
               for _ in range(4)]
    ckpt_dir = str(tmp_path / "ckpt")

    def slow():
        for ids in batches:
            time.sleep(0.02)               # the producer starves the loop
            yield (ids,)

    acct = tgoodput.GoodputAccountant()
    with tgoodput.activated(acct):
        sup = tres.Supervisor(max_restarts=1, backoff_base=0.01,
                              registry=tmetrics.Registry())
        failed = []

        def build():
            return ttrain.TrainSession(
                ttrain.TrainState.create(params, opt.init(params)), step,
                checkpoint_dir=ckpt_dir,
                hooks=[ttrain.CheckpointHook(every_steps=2,
                                             every_secs=None)])

        def run(sess):
            for (ids,) in tdata.prefetch_to_device(slow(), device="cpu"):
                if sess.step == 3 and not failed:
                    failed.append(True)
                    raise ConnectionError("transient")
                sess.run_step({"input_ids": ids})
            return sess.step

        assert sup.run(build, run) == 6       # restored at 2, 4 more steps
    snap = acct.snapshot()
    for bucket in ("step", "checkpoint_save", "checkpoint_restore",
                   "data_stall", "fault_recovery", "restart_backoff"):
        assert snap[bucket] > 0.0, bucket
    assert snap["compile"] == 0.0                 # the port has no jit
    assert sum(snap.values()) == pytest.approx(acct.wall_seconds(),
                                               rel=1e-6)
    assert tckpt.latest_step(ckpt_dir) == 6
