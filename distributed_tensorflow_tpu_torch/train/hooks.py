"""Training hooks, in PyTorch: the ``tf.train.SessionRunHook`` analogue.

Counterpart of ``distributed_tensorflow_tpu/train/hooks.py``.
``TrainSession`` dispatches every hook:

  begin(session)            once, after restore, before the first step
  before_step(session)      each step, before the step function
  after_step(session, metrics)   each step, with the step's metric dict
  end(session)              once, at a clean session exit
  close(session)            always, at session exit

Hooks must not wait for the card unless they fire: metric values arrive
as device tensors and are only read with ``float()`` inside a firing
hook, so the training loop queues steps without host syncs.
``ProfilerHook`` runs ``torch.profiler`` (CPU and, with a card, CUDA
activity) and writes a Chrome trace.  ``TraceHook`` (host-timeline
spans) and ``MetricsExportHook`` (the ``dttpu_*`` training series) feed
an ``obs.Telemetry``.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

log = logging.getLogger(__name__)

__all__ = ["Hook", "StopAtStepHook", "CheckpointHook", "SummaryHook",
           "LoggingHook", "NaNHook", "ProfilerHook", "PreemptionHook",
           "WatchdogHook", "EvalHook", "StepCounterHook", "TraceHook",
           "MetricsExportHook"]


class Hook:
    def begin(self, session) -> None:
        pass

    def before_step(self, session) -> None:
        pass

    def after_step(self, session, metrics: Dict) -> None:
        pass

    def end(self, session) -> None:
        """Clean-exit work (flushes, final saves) — NOT run if an exception
        escapes the session; put unconditional cleanup in ``close``."""

    def close(self, session) -> None:
        """Unconditional cleanup (restore signal handlers, stop threads) —
        runs in a ``finally`` on every session exit, clean or not."""


class StopAtStepHook(Hook):
    """Stop when the global step reaches ``last_step`` (or after
    ``num_steps`` more steps from restore) — reference example.py:187.

    In sync-DP one "step" is one globally synchronized update, not one
    per-worker async push (SURVEY.md §7 `global_step` note).
    """

    def __init__(self, last_step: Optional[int] = None,
                 num_steps: Optional[int] = None):
        if (last_step is None) == (num_steps is None):
            raise ValueError("exactly one of last_step/num_steps required")
        self.last_step = last_step
        self.num_steps = num_steps

    def begin(self, session) -> None:
        if self.num_steps is not None:
            self.last_step = session.step + self.num_steps

    def after_step(self, session, metrics) -> None:
        if session.step >= self.last_step:
            session.request_stop()


class CheckpointHook(Hook):
    """Periodic chief-only checkpoint save (+ final save at end)."""

    def __init__(self, every_steps: Optional[int] = None,
                 every_secs: Optional[float] = 600.0,
                 save_at_end: bool = True):
        self.every_steps = every_steps
        self.every_secs = every_secs
        self.save_at_end = save_at_end
        self._last_time = time.time()
        self._last_step = None

    def begin(self, session) -> None:
        self._last_time = time.time()
        self._last_step = session.step

    def _due(self, step: int) -> bool:
        if self.every_steps and step - (self._last_step or 0) >= self.every_steps:
            return True
        if self.every_secs and time.time() - self._last_time >= self.every_secs:
            return True
        return False

    def after_step(self, session, metrics) -> None:
        if self._due(session.step):
            session.save()
            self._last_time = time.time()
            self._last_step = session.step

    def end(self, session) -> None:
        # Skip if the session already holds a save at this exact step (e.g.
        # PreemptionHook saved inside the grace window — don't double the
        # checkpoint I/O right when time is shortest).
        if (self.save_at_end and session.step != (self._last_step or -1)
                and getattr(session, "last_saved_step", None) != session.step):
            session.save()


class SummaryHook(Hook):
    """Writes scalar metrics to TB events (reference example.py:172-174,219).

    ``step_fn``: optional step->x-axis mapping, e.g. fractional epochs like
    the reference's ``epoch + i/total_batch``.
    """

    def __init__(self, writer, every_steps: int = 1,
                 step_fn: Optional[Callable[[int], float]] = None):
        self.writer = writer
        self.every_steps = max(1, every_steps)
        self.step_fn = step_fn

    def after_step(self, session, metrics) -> None:
        if session.step % self.every_steps:
            return
        scalars = {k: float(v) for k, v in metrics.items()
                   if _is_scalar(v)}
        if scalars:
            x = self.step_fn(session.step) if self.step_fn else session.step
            self.writer.add_scalars(scalars, x)

    def end(self, session) -> None:
        self.writer.flush()


class _RateWindow:
    """Steps/sec over the window since the last reading — the one tracker
    both LoggingHook and StepCounterHook report from."""

    def __init__(self):
        self._t0 = time.time()
        self._step0 = 0

    def reset(self, step: int) -> None:
        self._t0, self._step0 = time.time(), step

    def rate(self, step: int) -> float:
        now = time.time()
        out = (step - self._step0) / max(now - self._t0, 1e-9)
        self._t0, self._step0 = now, step
        return out


class LoggingHook(Hook):
    """Console progress lines (reference example.py:222-226 prints every
    ``print_rate`` epochs); includes steps/sec like TF's LoggingTensorHook."""

    def __init__(self, every_steps: int = 100,
                 formatter: Optional[Callable[[int, Dict], str]] = None):
        self.every_steps = max(1, every_steps)
        self.formatter = formatter
        self._window = _RateWindow()

    def begin(self, session) -> None:
        self._window.reset(session.step)

    def after_step(self, session, metrics) -> None:
        if session.step % self.every_steps:
            return
        rate = self._window.rate(session.step)
        if self.formatter:
            line = self.formatter(session.step, metrics)
        else:
            parts = [f"{k}={float(v):.4f}" for k, v in metrics.items()
                     if _is_scalar(v)]
            line = f"step {session.step}: " + ", ".join(parts)
        log.info("%s (%.1f steps/s)", line, rate)
        print(f"{line} ({rate:.1f} steps/s)", flush=True)


class StepCounterHook(Hook):
    """Periodic steps/sec (and examples/sec when ``batch_size`` is given)
    to a summary writer and/or the log — tf.train.StepCounterHook parity.

    Distinct from LoggingHook: this is the THROUGHPUT channel (its scalars
    land in TensorBoard under ``steps_per_sec``/``examples_per_sec``),
    not the metrics console line.
    """

    def __init__(self, every_steps: int = 100, writer=None,
                 batch_size: Optional[int] = None):
        self.every_steps = max(1, every_steps)
        self.writer = writer
        self.batch_size = batch_size
        self._window = _RateWindow()

    def begin(self, session) -> None:
        self._window.reset(session.step)

    def after_step(self, session, metrics) -> None:
        if session.step % self.every_steps:
            return
        rate = self._window.rate(session.step)
        scalars = {"steps_per_sec": rate}
        if self.batch_size:
            scalars["examples_per_sec"] = rate * self.batch_size
        if self.writer is not None:
            self.writer.add_scalars(scalars, session.step)
        log.info("step %d: %.1f steps/s%s", session.step, rate,
                 f" ({scalars.get('examples_per_sec', 0):,.0f} ex/s)"
                 if self.batch_size else "")


class NaNHook(Hook):
    """Stop (or raise) when the monitored metric goes non-finite.

    The sync-DP replacement for the reference's silent tolerance of async
    staleness (SURVEY.md §5 race-detection row): divergence is detected, not
    raced through.
    """

    def __init__(self, metric: str = "loss", fail_fast: bool = True,
                 every_steps: int = 25):
        self.metric = metric
        self.fail_fast = fail_fast
        self.every_steps = max(1, every_steps)

    def after_step(self, session, metrics) -> None:
        if session.step % self.every_steps:
            return
        value = metrics.get(self.metric)
        if value is None:
            return
        import math
        v = float(value)
        if math.isnan(v) or math.isinf(v):
            msg = f"{self.metric} is non-finite ({v}) at step {session.step}"
            if self.fail_fast:
                raise FloatingPointError(msg)
            log.error("%s — requesting stop", msg)
            session.request_stop()


class ProfilerHook(Hook):
    """Captures a ``torch.profiler`` trace of exactly ``num_steps`` steps:
    the ones whose post-step global step (``session.step`` after the step
    ran, the numbering ``StopAtStepHook`` and checkpoint names use) lands
    in ``{start_step, ..., start_step + num_steps - 1}``; a session
    restored past ``start_step`` traces its next ``num_steps``.  The trace
    goes to ``log_dir/trace-<last step>.json`` (Chrome format), and the
    profiler object stays on ``self.profile`` for ``key_averages()``."""

    def __init__(self, log_dir: str, start_step: int = 10,
                 num_steps: int = 5):
        self.log_dir = log_dir
        self.start_step = start_step
        self.num_steps = num_steps
        self.profile = None
        self._active = False
        self._done = False
        self._traced = 0

    def before_step(self, session) -> None:
        import torch
        if (not self._done and not self._active
                and session.step >= self.start_step - 1):
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.profile = torch.profiler.profile(activities=acts)
            self.profile.__enter__()
            self._active = True

    def _stop(self, session) -> None:
        import os
        self.profile.__exit__(None, None, None)
        self._active = False
        os.makedirs(self.log_dir, exist_ok=True)
        self.profile.export_chrome_trace(
            os.path.join(self.log_dir, f"trace-{session.step}.json"))

    def after_step(self, session, metrics) -> None:
        if not self._active:
            return
        self._traced += 1
        if self._traced >= self.num_steps:
            self._stop(session)
            self._done = True

    def close(self, session) -> None:
        # close, not end: a trace left running after an exception leaks
        if self._active:
            self._stop(session)


class EvalHook(Hook):
    """Periodic validation — the reference's every-5-epochs val accuracy
    print (example.py:222-226) as a composable hook.

    ``eval_fn(state) -> {name: scalar}`` (typically a closure over
    ``train.make_eval_step`` and the val set).  Results are logged with a
    ``val_`` prefix, optionally written to a summary writer, and stored on
    ``self.last_metrics`` for callers (e.g. early stopping on top).
    """

    def __init__(self, eval_fn: Callable, every_steps: int,
                 writer=None, prefix: str = "val_", also_at_end: bool = True):
        self.eval_fn = eval_fn
        self.every_steps = max(1, every_steps)
        self.writer = writer
        self.prefix = prefix
        self.also_at_end = also_at_end
        self.last_metrics: Optional[Dict] = None
        self._last_eval_step = -1

    def _run(self, session) -> None:
        metrics = {f"{self.prefix}{k}": float(v)
                   for k, v in self.eval_fn(session.state).items()}
        self.last_metrics = metrics
        self._last_eval_step = session.step
        line = ", ".join(f"{k}={v:.4f}" for k, v in metrics.items())
        log.info("step %d: %s", session.step, line)
        print(f"step {session.step}: {line}", flush=True)
        if self.writer is not None:
            self.writer.add_scalars(metrics, session.step)

    def after_step(self, session, metrics) -> None:
        if session.step % self.every_steps == 0:
            self._run(session)

    def end(self, session) -> None:
        if self.also_at_end and session.step != self._last_eval_step:
            self._run(session)


class PreemptionHook(Hook):
    """Preemption-aware save+stop (SURVEY.md §5 failure-detection row).

    The reference's only recovery story is MTS restore-on-restart
    (reference example.py:189-192); preemptible machines additionally give
    a SIGTERM grace window.  This hook catches the signal, lets the
    in-flight step finish, writes a final checkpoint (chief-only via
    ``session.save``), and requests a clean stop so the next run
    auto-restores from the exact preemption step instead of the last
    periodic save.

    Multi-host: assumes WHOLE-SLICE preemption (every process receives
    SIGTERM, the usual maintenance/preemption behaviour), so all
    processes stop at the same step.  If only a subset of hosts can be
    signalled, pass ``sync_fn`` — e.g. a psum of the flag — so the stop
    decision is agreed cross-host; otherwise the surviving hosts would
    block in the next step's collective.
    """

    def __init__(self, signals=None, save: bool = True,
                 sync_fn: Optional[Callable[[bool], bool]] = None):
        import signal as signal_mod
        self.signals = (tuple(signals) if signals is not None
                        else (signal_mod.SIGTERM,))
        self.save = save
        self.sync_fn = sync_fn
        self.triggered = False
        self._prev = {}

    def _on_signal(self, signum, frame):
        del frame
        log.warning("received signal %s — will checkpoint and stop after "
                    "the current step", signum)
        self.triggered = True

    def begin(self, session) -> None:
        import signal as signal_mod
        self.triggered = False
        for sig in self.signals:
            self._prev[sig] = signal_mod.signal(sig, self._on_signal)

    def after_step(self, session, metrics) -> None:
        triggered = (self.sync_fn(self.triggered) if self.sync_fn
                     else self.triggered)
        if triggered and not session.should_stop():
            if self.save:
                session.save()
                # async mode queues the write — a preemption save must be
                # DURABLE before the grace window closes
                session.drain_checkpoints()
            session.request_stop()

    def close(self, session) -> None:
        import signal as signal_mod
        for sig, prev in self._prev.items():
            try:
                signal_mod.signal(sig, prev)
            except Exception:  # pragma: no cover
                pass
        self._prev.clear()


class WatchdogHook(Hook):
    """Failure detection for hung steps (stuck collectives, host stalls).

    A multi-host collective waits forever if one participant dies; nothing
    in-band ever returns.  A daemon thread watches the time since the last
    completed step and fires ``on_stall(session, elapsed)`` once the
    ``timeout_secs`` budget is exceeded — default action logs an error and
    dumps all thread stacks (faulthandler) so the operator sees WHERE the
    program is wedged.  Detection only; recovery is restart-from-checkpoint
    (SURVEY.md §5: collectives are all-or-nothing).
    """

    def __init__(self, timeout_secs: float = 600.0,
                 on_stall: Optional[Callable] = None,
                 poll_secs: Optional[float] = None):
        self.timeout_secs = timeout_secs
        self.on_stall = on_stall or self._default_on_stall
        self.poll_secs = poll_secs or min(10.0, timeout_secs / 4)
        self._last = None
        self._thread = None
        self._stop_evt = None
        self.stall_count = 0

    @staticmethod
    def _default_on_stall(session, elapsed):
        # Dump stacks FIRST and never touch session.step here: reading it
        # pulls a (possibly in-flight) device array, and on a genuinely hung
        # collective that read would wedge the watchdog thread too.
        import faulthandler
        import sys
        faulthandler.dump_traceback(file=sys.stderr)
        log.error("no step completed in %.1fs — possible hung collective; "
                  "stacks dumped above", elapsed)

    def begin(self, session) -> None:
        import threading
        self._last = time.time()
        self._stop_evt = threading.Event()

        def watch():
            fired_at = None
            while not self._stop_evt.wait(self.poll_secs):
                elapsed = time.time() - self._last
                if elapsed > self.timeout_secs and fired_at != self._last:
                    fired_at = self._last  # once per stall
                    self.stall_count += 1
                    try:
                        self.on_stall(session, elapsed)
                    except Exception:  # pragma: no cover
                        log.exception("watchdog on_stall raised")

        self._thread = threading.Thread(target=watch, daemon=True,
                                        name="train-watchdog")
        self._thread.start()

    def after_step(self, session, metrics) -> None:
        self._last = time.time()

    def close(self, session) -> None:
        if self._stop_evt is not None:
            self._stop_evt.set()
            self._thread.join(timeout=5)


class TraceHook(Hook):
    """Host-timeline spans for the training loop (``obs.trace``).

    Per step this hook records a ``data_load`` span — the host gap from
    the previous step's end to this step's start, where the batch fetch
    and hook work live — and a ``step`` span over the whole
    ``run_step``.  The ``dispatch`` span nested inside comes from
    ``TrainSession(telemetry=...)`` itself, and ``checkpoint`` spans
    from ``session.save()``.  The trace file is written at ``end`` AND
    ``close``, so a crashed run still leaves its timeline on disk.

    Step numbers in span args come from a host counter seeded once at
    ``begin``, as in the JAX package (the port's ``session.step`` is a
    host int too, so either would do).
    """

    def __init__(self, telemetry, save_every_steps: int = 0):
        self.telemetry = telemetry
        self.save_every_steps = save_every_steps
        self._step = 0
        self._gap_t0: Optional[float] = None
        self._step_t0: Optional[float] = None

    def begin(self, session) -> None:
        from ..obs import trace as obs_trace
        self.telemetry.start()
        self._step = session.step
        self.telemetry.tracer.instant("session_begin", step=self._step)
        self._gap_t0 = obs_trace.now_us()

    def before_step(self, session) -> None:
        from ..obs import trace as obs_trace
        now = obs_trace.now_us()
        if self._gap_t0 is not None:
            self.telemetry.tracer.add_span("data_load", self._gap_t0, now,
                                           step=self._step + 1)
        self._step_t0 = now

    def after_step(self, session, metrics) -> None:
        from ..obs import trace as obs_trace
        now = obs_trace.now_us()
        self._step += 1
        if self._step_t0 is not None:
            self.telemetry.tracer.add_span("step", self._step_t0, now,
                                           step=self._step)
        self._gap_t0 = now
        if self.save_every_steps and \
                self._step % self.save_every_steps == 0:
            self.telemetry.save_trace()

    def end(self, session) -> None:
        self.telemetry.tracer.instant("session_end", step=self._step)
        self.telemetry.save_trace()

    def close(self, session) -> None:
        self.telemetry.save_trace()


class MetricsExportHook(Hook):
    """Prometheus export for the training loop (``obs.metrics``; the
    series and their names are the JAX package's, docs/OBSERVABILITY.md):

    * ``dttpu_steps_total`` — counter, +1 per completed step;
    * ``dttpu_step_time_seconds`` — histogram of host wall time per
      ``run_step`` (the launches' issue time: the step returns before the
      card finishes, so the window rates below carry the honest rate);
    * ``dttpu_steps_per_second`` (+ ``dttpu_tokens_per_second`` /
      ``dttpu_examples_per_second`` when sized) — window rates at hook
      cadence;
    * ``dttpu_retraces_total`` — counter of the tracer's ``retrace``
      instants.  Registered for the same exposition as the JAX package;
      the port has no jit, so nothing retraces and it stays 0;
    * ``dttpu_live_arrays_bytes`` — gauge, ``obs.device
      .live_arrays_bytes`` (the caching allocator's live bytes);
    * ``dttpu_loss``, ``dttpu_grad_norm``, ``dttpu_nonfinite_grads`` —
      gauges read from the step's metrics when present (the latter two
      ride steps built with ``device_health=True``).

    Per-step cost is two clock reads and two in-memory bumps; anything
    that reads a device value (the pulled gauges' 0-d tensors) fires only
    every ``every_steps``: hooks don't sync.
    """

    _PULLED = ("loss", "grad_norm", "nonfinite_grads")

    def __init__(self, telemetry, every_steps: int = 10,
                 tokens_per_step: Optional[int] = None,
                 examples_per_step: Optional[int] = None):
        self.telemetry = telemetry
        self.every_steps = max(1, every_steps)
        self.tokens_per_step = tokens_per_step
        self.examples_per_step = examples_per_step
        self._window = _RateWindow()
        self._step = 0
        self._t0: Optional[float] = None
        self._retraces_seen = 0

    def begin(self, session) -> None:
        self.telemetry.start()
        reg = self.telemetry.registry
        self._steps = reg.counter(
            "dttpu_steps_total", "Training steps completed.")
        self._step_time = reg.histogram(
            "dttpu_step_time_seconds",
            "Host wall time per run_step (dispatch-only under async).")
        self._rate = reg.gauge(
            "dttpu_steps_per_second", "Steps/s over the last export window.")
        self._retraces = reg.counter(
            "dttpu_retraces_total",
            "jit retraces observed by the telemetry tracer (0 in the "
            "PyTorch port: it has no jit).")
        self._live_bytes = reg.gauge(
            "dttpu_live_arrays_bytes",
            "Total bytes of live tensors on the card "
            "(torch.cuda.memory_allocated).")
        self._step = session.step
        self._window.reset(self._step)

    def before_step(self, session) -> None:
        self._t0 = time.perf_counter()

    def after_step(self, session, metrics) -> None:
        if self._t0 is not None:
            self._step_time.observe(time.perf_counter() - self._t0)
        self._steps.inc()
        self._step += 1
        if self._step % self.every_steps:
            return
        self._export(metrics)

    def _export(self, metrics: Optional[Dict]) -> None:
        from ..obs import device as obs_device
        reg = self.telemetry.registry
        # an empty window (the end-of-session flush right after a periodic
        # export) keeps the last rate instead of publishing a zero
        if self._step > self._window._step0:
            rate = self._window.rate(self._step)
            self._rate.set(rate)
            if self.tokens_per_step:
                reg.gauge("dttpu_tokens_per_second",
                          "Training throughput.").set(
                              rate * self.tokens_per_step)
            if self.examples_per_step:
                reg.gauge("dttpu_examples_per_second",
                          "Training throughput.").set(
                              rate * self.examples_per_step)
        seen = self.telemetry.tracer.instant_counts.get("retrace", 0)
        if seen > self._retraces_seen:
            self._retraces.inc(seen - self._retraces_seen)
            self._retraces_seen = seen
        self._live_bytes.set(obs_device.live_arrays_bytes())
        if metrics:
            for key in self._PULLED:
                value = metrics.get(key)
                if value is not None and _is_scalar(value):
                    reg.gauge(f"dttpu_{key}",
                              f"Last exported value of metrics[{key!r}]."
                              ).set(float(value))

    def end(self, session) -> None:
        self._export(None)   # final window flush


def _is_scalar(v) -> bool:
    """A number, or an array or tensor with no axes."""
    if hasattr(v, "shape"):
        return tuple(v.shape) == ()
    return isinstance(v, (int, float))
