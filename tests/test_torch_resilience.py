"""The port's resilience layer (``resilience.faults``,
``resilience.supervisor``) and its sites, held against the JAX package's.

- The same plan and seed, driven through the same sequence of site
  calls (every one of the 14 kinds), give the same outcomes (which call
  raises, with which message), the same audit trail, the same
  ``dttpu_faults_injected_total`` and, for ``corrupt_checkpoint`` in
  flip mode, the same flipped byte (the plan's seeded generator).
- The same ``Supervisor`` settings and seed give the same backoff delays
  (``sleep`` stubbed), ``restart_log``, restart counter and recovery
  observations; a spent budget re-raises the last error; exceptions are
  classified alike (transient: OSError, ConnectionError, TimeoutError,
  FloatingPointError, InjectedFault; the rest fatal, re-raised at once).
- ``NonfiniteGuardHook(K)`` trips on the K-th consecutive non-finite
  step (``nonfinite_grads``, or ``grads_finite`` without it), as the JAX
  hook does on the same metrics.
- A chaos run of ``gpt_tiny`` (f32) under ``Supervisor`` with the same
  ``FaultPlan`` in both packages (a failed save, a corrupted checkpoint,
  three NaN steps that trip the guard, a killed prefetch producer) gives
  the same ``restart_log``, the same restores (the corrupt checkpoint is
  quarantined and the one before it taken), the same audit trail, the
  same final step, and parameters equal within 1e-5.
- ``plan_from_env`` parses the same ``DTTPU_FAULTS`` JSON (a list, or a
  seed and a list) to the same faults, and ``active()`` reads it.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import data as jdata
from distributed_tensorflow_tpu import obs as jobs
from distributed_tensorflow_tpu import optim as jopt
from distributed_tensorflow_tpu import resilience as jres
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu_torch import (GPT, GPTConfig, adamw,
                                              gpt_params_to_jax,
                                              load_jax_params,
                                              make_custom_train_step)
from distributed_tensorflow_tpu_torch import data as tdata
from distributed_tensorflow_tpu_torch import obs as tobs
from distributed_tensorflow_tpu_torch import resilience as tres
from distributed_tensorflow_tpu_torch import train as ttrain

torch.set_num_threads(1)

TOL = 1e-5

_FAULTS = [
    {"kind": "save_oserror", "at": 1},
    {"kind": "corrupt_checkpoint", "at": 2, "mode": "flip"},
    {"kind": "corrupt_checkpoint", "at": 3},
    {"kind": "poison_batch", "at": 2},
    {"kind": "kill_prefetch", "at": 4},
    {"kind": "nan_grads", "at": 3},
    {"kind": "fail_decode", "at": 5},
    {"kind": "stall_tick", "at": 1, "replica": 0, "seconds": 0.0},
    {"kind": "wedge_replica", "at": 2, "replica": 1, "seconds": 0.0},
    {"kind": "kill_replica", "at": 1, "replica": 2},
    {"kind": "correlated_kill", "at": 6, "k": 2, "window": 8},
    {"kind": "drop_chunk", "at": 0},
    {"kind": "corrupt_chunk", "at": 1},
    {"kind": "stall_wire", "at": 2, "seconds": 0.0},
    {"kind": "kill_host", "at": 3},
    {"kind": "kill_host", "at": 0, "replica": 1},
]


def _call(outcomes, fn, *args):
    try:
        out = fn(*args)
    except Exception as e:               # the plan's injections
        outcomes.append((type(e).__name__, str(e)))
        return None
    outcomes.append(_plain(out))
    return out


def _plain(x):
    """Site results as comparable plain values."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "kind") and hasattr(x, "at"):
        return ("fault", x.kind, x.at)
    if hasattr(x, "shape"):             # str: NaN == NaN
        return ("array", str(np.asarray(x).tolist()))
    return x


def _drive_sites(res, tmp):
    """Every site of ``res``'s plan, in one fixed order."""
    reg = (jobs if res is jres else tobs).Registry()
    plan = res.FaultPlan(_FAULTS, seed=7, registry=reg)
    out = []
    for _ in range(3):
        _call(out, plan.on_save)
    for i in range(4):
        d = tmp / f"ckpt{i}"
        d.mkdir()
        (d / "arrays.npz").write_bytes(bytes(range(256)) * 4)
        _call(out, plan.on_saved, str(d), i)
        out.append(((d / "arrays.npz").read_bytes().hex(),))
    item = {"x": np.arange(6, dtype=np.float32), "ids": np.arange(3)}
    for _ in range(6):
        _call(out, plan.on_batch, item)
    for step in range(5):
        _call(out, plan.on_step, step, ({"mask": np.ones(2, np.float32)},))
    for rid in range(7):
        _call(out, plan.on_decode, rid)
    for _ in range(3):
        for tag in (0, 1):
            _call(out, plan.on_engine_tick, tag)
    for _ in range(4):
        for replica in range(4):
            _call(out, plan.on_replica_step, replica)
    for _ in range(5):
        _call(out, plan.on_wire_chunk, 0)
    for host in (0, 1):
        _call(out, plan.on_host_poll, host)
    log = [{k: (os.path.basename(v) if k == "path" else v)
            for k, v in e.items()} for e in plan.log]
    fired = {f.kind + str(f.at): f.fired for f in plan.faults}
    victims = [f.victims for f in plan.faults
               if f.kind == "correlated_kill"]
    return out, log, fired, victims, \
        reg.get("dttpu_faults_injected_total").value


def test_same_plan_and_seed_give_the_same_audit_trail(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _drive_sites(jres, tmp_path / "jax")
    got = _drive_sites(tres, tmp_path / "port")
    for g, w in zip(got, want):
        assert g == w
    out, log, fired, victims, injected = got
    assert {e["kind"] for e in log} == set(tres.faults.KINDS)
    assert all(n >= 1 for n in fired.values()) and injected == len(log)
    assert victims[0] and len(victims[0]) == 2
    assert ("OSError", "injected fault: checkpoint save #1 failed") in out
    assert ("InjectedFault",
            "injected fault: decode failed for request 5") in out


def test_poison_keeps_integers_and_the_device():
    tree = ({"ids": torch.arange(3), "mask": torch.ones(2, 3)},
            [np.ones(2, np.float32), np.arange(2)], 3.0)
    got = tres.faults._poison(tree)
    assert torch.equal(got[0]["ids"], tree[0]["ids"])
    assert torch.isnan(got[0]["mask"]).all()
    assert got[0]["mask"].device == tree[0]["mask"].device
    assert np.isnan(got[1][0]).all() and got[1][1].tolist() == [0, 1]
    assert got[2] == 3.0


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _supervise(res, obs, errors, max_restarts=4):
    delays, attempts = [], []
    reg = obs.Registry()
    sup = res.Supervisor(max_restarts=max_restarts, seed=5,
                         sleep=delays.append, registry=reg)

    def train(sess):
        attempts.append(len(attempts))
        if len(attempts) <= len(errors):
            raise errors[len(attempts) - 1]
        return 42

    try:
        result = sup.run(_Null, train)
    except Exception as e:
        result = ("raised", type(e).__name__, str(e))
    return (result, delays, sup.restart_log, sup.restarts_total.value,
            sup.recovery_seconds.count, len(attempts))


@pytest.mark.parametrize("n_errors,max_restarts", [(3, 4), (3, 2)],
                         ids=["recovers", "budget_spent"])
def test_supervisor_backoff_and_log_equal_jax(n_errors, max_restarts):
    def errors(res):
        return [OSError("disk"), ConnectionError("peer"),
                res.InjectedFault("chaos")][:n_errors]

    got = _supervise(tres, tobs, errors(tres), max_restarts)
    want = _supervise(jres, jobs, errors(jres), max_restarts)
    assert got == want
    result, delays, log, restarts, recoveries, attempts = got
    assert restarts == len(delays) == len(log) == min(n_errors,
                                                     max_restarts)
    if max_restarts >= n_errors:
        assert result == 42 and recoveries == n_errors
    else:
        assert result == ("raised", "InjectedFault", "chaos")
    # exponential with jitter in [1, 1.5) of base * 2**(attempt - 1)
    for i, d in enumerate(delays):
        assert 0.5 * 2 ** i <= d < 0.75 * 2 ** i


def test_exceptions_are_classified_alike():
    def excs(res):
        return [OSError(), ConnectionError(), TimeoutError(),
                FloatingPointError(), res.InjectedFault(), RuntimeError(),
                ValueError(), AssertionError(), KeyError(),
                KeyboardInterrupt()]

    got = [tres.Supervisor()._is_transient(e) for e in excs(tres)]
    want = [jres.Supervisor()._is_transient(e) for e in excs(jres)]
    assert got == want == [True] * 5 + [False] * 5
    custom = tres.Supervisor(classify=lambda e: "transient")
    assert custom._is_transient(ValueError())
    # a fatal error escapes at once, with no restart
    got = _supervise(tres, tobs, [ValueError("bug")])
    assert got == _supervise(jres, jobs, [ValueError("bug")])
    assert got[0] == ("raised", "ValueError", "bug") and got[2] == []


class _Sess:
    step = 0


def _guard_trips(res, as_array, key, values, k=3):
    hook = res.NonfiniteGuardHook(k)
    hook.begin(_Sess())
    for i, v in enumerate(values):
        try:
            hook.after_step(_Sess(), {key: as_array(v)})
        except FloatingPointError:
            return i, hook.total_nonfinite
    return None, hook.total_nonfinite


@pytest.mark.parametrize("key,values", [
    ("nonfinite_grads", [0.0, 2.0, 1.0, 0.0, 5.0, 1.0, 1.0, 0.0]),
    ("grads_finite", [True, False, False, True, False, False, False]),
])
def test_nonfinite_guard_trips_after_k(key, values):
    got = _guard_trips(tres, torch.tensor, key, values)
    want = _guard_trips(jres, jnp.asarray, key, values)
    assert got == want == (6, 5)
    assert _guard_trips(tres, torch.tensor, key, values, k=4) == \
        (None, 5)
    with pytest.raises(ValueError):
        tres.NonfiniteGuardHook(0)


def test_plan_from_env_parses_the_same_json(monkeypatch):
    specs = ['[{"kind": "nan_grads", "at": 3}, '
             '{"kind": "stall_tick", "at": 2, "seconds": 0.5}]',
             '{"seed": 9, "faults": [{"kind": "corrupt_checkpoint", '
             '"at": 1, "mode": "flip", "file": "manifest.json"}]}']
    for spec in specs:
        got = tres.faults.plan_from_env(spec)
        want = jres.faults.plan_from_env(spec)
        assert [vars(f) for f in got.faults] == \
            [vars(f) for f in want.faults]
        assert got.seed == want.seed
    with pytest.raises(ValueError, match="unknown fault kind"):
        tres.faults.plan_from_env('[{"kind": "meteor", "at": 0}]')
    monkeypatch.setenv("DTTPU_FAULTS", specs[1])
    plan = tres.faults.active()
    assert plan is tres.faults.active() and plan.seed == 9
    monkeypatch.delenv("DTTPU_FAULTS")
    assert tres.faults.active() is None


# -- the chaos run ------------------------------------------------------

LAST_STEP, EVERY = 20, 5
# a failed first save; the second save's checkpoint corrupted; three NaN
# steps from step 10 (the guard trips after the third, before the next
# save); the producer killed at batch 25, which the third attempt reaches
# however far the earlier attempts' producers ran ahead (5 + 13 batches
# consumed, at most 3 more each)
_CHAOS = [{"kind": "save_oserror", "at": 0},
          {"kind": "corrupt_checkpoint", "at": 2},
          {"kind": "nan_grads", "at": 10},
          {"kind": "nan_grads", "at": 11},
          {"kind": "nan_grads", "at": 12},
          {"kind": "kill_prefetch", "at": 25}]


def _chaos_batches():
    rng = np.random.default_rng(8)
    return [(rng.integers(0, 512, (2, 17)).astype(np.int32),
             np.ones((2, 16), np.float32)) for _ in range(LAST_STEP)]


def _chaos(res, obs, train, prefetch, new_state, step_fn, ckpt_dir):
    reg = obs.Registry()
    plan = res.FaultPlan(_CHAOS, seed=1, registry=reg)
    sup = res.Supervisor(max_restarts=5, seed=2, sleep=lambda s: None,
                         registry=reg)
    batches = _chaos_batches()
    restored = []

    def build():
        sess = train.TrainSession(
            new_state(), step_fn, checkpoint_dir=ckpt_dir,
            hooks=[train.StopAtStepHook(last_step=LAST_STEP),
                   train.CheckpointHook(every_steps=EVERY, every_secs=None),
                   res.NonfiniteGuardHook(3)])
        restored.append(sess.step)
        return sess

    def run(sess):
        for ids, mask in prefetch(iter(batches[sess.step:])):
            if sess.should_stop():
                break
            sess.run_step({"input_ids": ids, "loss_mask": mask})
        return sess

    with res.faults.activated(plan):
        sess = sup.run(build, run)
    quarantined = sorted(n for n in os.listdir(ckpt_dir)
                         if n.startswith("corrupt-"))
    return (sess, sup.restart_log, restored[:3], plan.log, quarantined,
            reg.get("dttpu_restarts_total").value)


def test_chaos_run_equals_jax(tmp_path):
    jmodel = jgpt_tiny(dropout_rate=0.0)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    c = jmodel.config
    model = load_jax_params(
        GPT(GPTConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                      num_layers=c.num_layers, num_heads=c.num_heads,
                      intermediate_size=c.intermediate_size,
                      max_position=c.max_position, dropout_rate=0.0),
            device="cpu"),
        jax.tree.map(np.asarray, jparams))
    params = dict(model.named_parameters())
    init = {k: p.detach().clone() for k, p in params.items()}
    opt = adamw(1e-3)

    def port_state():
        with torch.no_grad():              # a fresh start every attempt
            for k, p in params.items():
                p.copy_(init[k])
        return ttrain.TrainState.create(params, opt.init(params))

    got = _chaos(tres, tobs, ttrain,
                 lambda it: tdata.prefetch_to_device(it, device="cpu"),
                 port_state,
                 make_custom_train_step(model.lm_loss_fn(), opt,
                                        grad_clip_norm=1.0,
                                        device_health=True,
                                        skip_nonfinite=True),
                 str(tmp_path / "port"))
    jo = jopt.adamw(1e-3)
    jinit = jax.tree.map(np.asarray, jparams)

    def jax_state():                       # the step donates its state
        fresh = jax.tree.map(jnp.array, jinit)
        return jtrain.TrainState.create(fresh, jo.init(fresh))

    want = _chaos(jres, jobs, jtrain, jdata.prefetch_to_device,
                  jax_state,
                  jtrain.make_custom_train_step(jmodel.lm_loss_fn(), jo,
                                                grad_clip_norm=1.0,
                                                device_health=True,
                                                skip_nonfinite=True),
                  str(tmp_path / "jax"))
    sess, log, restored, audit, quarantined, restarts = got
    assert log == want[1] and restored == want[2]
    assert quarantined == want[4] == ["corrupt-ckpt-0000000010"]
    assert restored == [0, 0, 5]
    assert [e["kind"] for e in audit] == \
        [e["kind"] for e in want[3]] == \
        ["save_oserror", "corrupt_checkpoint", "nan_grads", "nan_grads",
         "nan_grads", "kill_prefetch"]
    assert [type_name.split("(")[0] for _, type_name in log] == \
        ["OSError", "FloatingPointError", "OSError"]
    assert restarts == want[5] == 3
    assert sess.step == int(want[0].step) == LAST_STEP
    assert sess.state.opt_state.count == int(want[0].state.opt_state.count)
    got_params = gpt_params_to_jax(model.state_dict(), model.config)
    for a, b in zip(jax.tree.leaves(got_params),
                    jax.tree.leaves(want[0].state.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=0)
