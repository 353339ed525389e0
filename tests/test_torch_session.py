"""``TrainSession`` and the hooks of the port, held against the JAX
package's ``train/session.py`` and ``train/hooks.py``.

- Six steps of ``gpt_tiny`` under ``StopAtStepHook``,
  ``CheckpointHook(every_steps=2)``, ``LoggingHook``, ``NaNHook``,
  ``EvalHook`` and ``StepCounterHook``: every hook fires at the steps
  where the JAX session's fires, and the same checkpoints are written.
- Resuming from the checkpoint directory equals an uninterrupted run, bit
  for bit (on the CPU both runs take the same operations in the same
  order, dropout 0.1 seeded by ``(seed, step)``).
- ``NaNHook(fail_fast=True)`` raises; ``PreemptionHook`` saves and stops
  on a signal sent to the process; ``WatchdogHook`` reports a stall;
  ``ProfilerHook`` writes a trace; ``is_chief=False`` writes nothing;
  ``sharded_checkpoint`` saves and resumes (its cases:
  ``tests/test_torch_sharded_checkpoint.py``); ``telemetry`` is
  accepted (its spans and series: ``tests/test_torch_obs.py``).
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import optim as jopt
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu_torch import (GPT, TrainSession, TrainState,
                                              adamw, gpt_tiny,
                                              make_custom_train_step,
                                              with_ema)
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)


def _batches(n=8):
    rng = np.random.default_rng(1)
    return [rng.integers(0, 512, (2, 17)).astype(np.int32) for _ in range(n)]


def _port(dropout=0.0):
    model = GPT(gpt_tiny(dropout_rate=dropout), device="cpu")
    params = dict(model.named_parameters())
    opt = with_ema(adamw(1e-3), decay=0.9)
    step = make_custom_train_step(model.lm_loss_fn(), opt, seed=3,
                                  grad_clip_norm=1.0)
    return model, TrainState.create(params, opt.init(params)), step


def _jax():
    model = jgpt_tiny(dropout_rate=0.0)
    params = model.init(jax.random.PRNGKey(0))
    opt = jopt.with_ema(jopt.adamw(1e-3), decay=0.9)
    step = jtrain.make_custom_train_step(model.lm_loss_fn(), opt,
                                         grad_clip_norm=1.0)
    return jtrain.TrainState.create(params, opt.init(params)), step


class _Recorder:
    """A summary writer that keeps the steps it was written at."""

    def __init__(self):
        self.steps = []

    def add_scalars(self, scalars, step):
        self.steps.append(int(step))

    def flush(self):
        pass


def _drive(lib, state, step, to_batch, ckpt_dir, capsys):
    """Run a session of ``lib``'s hooks to step 6: (eval steps, step
    counter steps, logged steps, checkpoint names)."""
    evals, counter = [], _Recorder()
    hooks = [lib.StopAtStepHook(last_step=6),
             lib.CheckpointHook(every_steps=2, every_secs=None),
             lib.LoggingHook(every_steps=2),
             lib.NaNHook(every_steps=1),
             lib.EvalHook(lambda s: evals.append(int(s.step)) or
                          {"seen": float(len(evals))}, every_steps=3),
             lib.StepCounterHook(every_steps=2, writer=counter)]
    capsys.readouterr()
    with lib.TrainSession(state, step, checkpoint_dir=ckpt_dir, hooks=hooks,
                          max_to_keep=10) as sess:
        for ids in _batches():
            if sess.should_stop():
                break
            sess.run_step({"input_ids": to_batch(ids)})
    logged = [int(line.split(":")[0].split()[1])
              for line in capsys.readouterr().out.splitlines()
              if line.startswith("step ") and "loss=" in line]
    names = sorted(n for n in os.listdir(ckpt_dir) if n.startswith("ckpt-"))
    return evals, counter.steps, logged, names


def test_hooks_fire_where_the_jax_session_fires_them(tmp_path, capsys):
    _, state, step = _port()
    got = _drive(ttrain, state, step, torch.from_numpy,
                 str(tmp_path / "port"), capsys)
    jstate, jstep = _jax()
    want = _drive(jtrain, jstate, jstep, jnp.asarray, str(tmp_path / "jax"),
                  capsys)
    assert got == want
    assert got == ([3, 6], [2, 4, 6], [2, 4, 6],
                   ["ckpt-0000000002", "ckpt-0000000004", "ckpt-0000000006"])


def _session_run(ckpt_dir, last_step):
    model, state, step = _port(dropout=0.1)
    batches = _batches()
    with TrainSession(state, step, checkpoint_dir=ckpt_dir,
                      hooks=[ttrain.StopAtStepHook(last_step=last_step),
                             ttrain.CheckpointHook(every_steps=2,
                                                   every_secs=None)]) as sess:
        while not sess.should_stop():
            sess.run_step({"input_ids": torch.from_numpy(
                batches[sess.step])})
        final = sess.state
    return model, final


def test_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    model, whole = _session_run(str(tmp_path / "whole"), 6)
    _session_run(str(tmp_path / "split"), 4)
    capsys.readouterr()
    model2, resumed = _session_run(str(tmp_path / "split"), 6)
    assert "Restored checkpoint ckpt-0000000004 at step 4" in \
        capsys.readouterr().out
    assert resumed.step == whole.step == 6
    for k, p in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], p), k
    for k, s in whole.opt_state.inner["ema"].shadow.items():
        assert torch.equal(resumed.opt_state.inner["ema"].shadow[k], s), k
    assert resumed.opt_state.count == whole.opt_state.count == 6
    assert tckpt.latest_step(str(tmp_path / "split")) == 6


def _fake_step(loss):
    def step(state, batch):
        return state._replace(step=state.step + 1), {
            "loss": torch.tensor(loss)}
    return step


def test_nan_hook_fails_fast():
    state = TrainState.create({}, None)
    with pytest.raises(FloatingPointError, match="non-finite"):
        with TrainSession(state, _fake_step(float("nan")),
                          hooks=[ttrain.NaNHook(every_steps=1)]) as sess:
            sess.run_step(None)


def test_preemption_hook_saves_on_a_signal(tmp_path):
    _, state, step = _port()
    d = str(tmp_path)
    batches = _batches()
    hook = ttrain.PreemptionHook(signals=[signal.SIGUSR1])
    with TrainSession(state, step, checkpoint_dir=d, hooks=[hook]) as sess:
        while not sess.should_stop():
            sess.run_step({"input_ids": torch.from_numpy(
                batches[sess.step])})
            if sess.step == 3:      # caught now; acted on after step 4
                os.kill(os.getpid(), signal.SIGUSR1)
        assert sess.step == 4
    assert hook.triggered
    assert [os.path.basename(p) for p in tckpt.all_checkpoints(d)] == \
        ["ckpt-0000000004"]
    assert signal.getsignal(signal.SIGUSR1) is not hook._on_signal


def test_watchdog_reports_a_stall():
    stalls = []
    hook = ttrain.WatchdogHook(timeout_secs=0.05, poll_secs=0.01,
                               on_stall=lambda s, e: stalls.append(e))

    def slow(state, batch):
        time.sleep(0.3)
        return state._replace(step=state.step + 1), {}
    with TrainSession(TrainState.create({}, None), slow,
                      hooks=[hook]) as sess:
        sess.run_step(None)
        sess.run_step(None)
    assert hook.stall_count >= 1 and stalls and min(stalls) > 0.05
    assert not hook._thread.is_alive()


def test_profiler_hook_traces_its_steps(tmp_path):
    hook = ttrain.ProfilerHook(str(tmp_path), start_step=2, num_steps=2)
    with TrainSession(TrainState.create({}, None), _fake_step(1.0),
                      hooks=[hook]) as sess:
        for _ in range(5):
            sess.run_step(None)
    assert os.listdir(tmp_path) == ["trace-3.json"]
    assert hook.profile is not None and not hook._active


def test_non_chief_writes_nothing(tmp_path):
    _, state, step = _port()
    d = str(tmp_path / "ckpt")
    with TrainSession(state, step, checkpoint_dir=d, is_chief=False,
                      hooks=[ttrain.CheckpointHook(every_steps=1)]) as sess:
        sess.run_step({"input_ids": torch.from_numpy(_batches()[0])})
        assert sess.save() is None
    assert not os.path.exists(d)


def test_unported_options_raise(tmp_path):
    # sharded_checkpoint is ported now (it raised until the ZeRO slice):
    # every rank's chunks and the manifest, a final save at the last step
    # and a restore into a fresh state that resumes there (the JAX
    # package's cases: tests/test_torch_sharded_checkpoint.py)
    from distributed_tensorflow_tpu_torch.train import sharded_checkpoint
    d = str(tmp_path / "sharded")
    model, state, step = _port()
    ids = torch.from_numpy(_batches()[0])
    with TrainSession(state, step, checkpoint_dir=d,
                      sharded_checkpoint=True) as sess:
        sess.run_step({"input_ids": ids})
        sess.run_step({"input_ids": ids})
    want = {k: p.detach().clone() for k, p in model.named_parameters()}
    path, = sharded_checkpoint.all_sharded_checkpoints(d)
    assert sorted(os.listdir(path)) == ["chunks-00000.json",
                                        "manifest.json", "shards-00000.npz"]
    model2, state2, step2 = _port()
    with TrainSession(state2, step2, checkpoint_dir=d,
                      sharded_checkpoint=True) as sess:
        assert sess.step == 2
        for k, p in model2.named_parameters():
            assert torch.equal(p.detach(), want[k]), k
    state = TrainState.create({}, None)
    # telemetry is ported now: accepted and kept, never closed by the
    # session (tests/test_torch_obs.py holds it against the JAX package)
    from distributed_tensorflow_tpu_torch import obs as tobs
    tele = tobs.Telemetry()
    assert TrainSession(state, _fake_step(1.0),
                        telemetry=tele).telemetry is tele
