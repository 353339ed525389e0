"""Keras-style callbacks for the high-level ``fit`` API, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/models/callbacks.py``, host code
with the same rules: ``Callback``, ``TensorBoard`` (epoch scalars and the
model's graph record, through the port's ``SummaryWriter``), ``History``,
``ModelCheckpoint`` (the ``{params, model_state}`` weights checkpoint
``Sequential.save_weights`` writes, readable by either package),
``LearningRateScheduler`` and ``ReduceLROnPlateau`` (they move the
``with_lr_scale`` multiplier, a host value), ``CSVLogger``,
``TerminateOnNaN``, ``LambdaCallback`` and ``EarlyStopping``.  Callbacks
see epoch boundaries; per-step observability belongs to ``train.hooks``.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..summary import SummaryWriter

__all__ = ["Callback", "TensorBoard", "History", "EarlyStopping",
           "ModelCheckpoint", "LearningRateScheduler", "ReduceLROnPlateau",
           "CSVLogger", "TerminateOnNaN", "LambdaCallback"]


class Callback:
    def on_train_begin(self, model) -> None:
        pass

    def on_epoch_begin(self, model, epoch: int) -> None:
        pass

    def on_epoch_end(self, model, epoch: int, logs: Dict[str, float]) -> None:
        pass

    def on_train_end(self, model) -> None:
        pass


class TensorBoard(Callback):
    """Writes epoch metrics as TB scalars, and the model's graph once."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._writer: Optional[SummaryWriter] = None

    def on_train_begin(self, model) -> None:
        self._writer = SummaryWriter(self.log_dir)
        # the graph record; only a model without an ordered layer list
        # skips it (real serialization errors must propagate)
        if getattr(model, "layers", None) is not None:
            self._writer.add_graph(model)

    def on_epoch_end(self, model, epoch, logs) -> None:
        if self._writer and logs:
            self._writer.add_scalars(logs, epoch)
            self._writer.flush()

    def on_train_end(self, model) -> None:
        if self._writer:
            self._writer.close()


class History(Callback):
    """Accumulates per-epoch logs; ``fit`` returns it (Keras convention)."""

    def __init__(self):
        self.history: Dict[str, list] = {}
        self.epochs: list = []

    def on_epoch_end(self, model, epoch, logs) -> None:
        self.epochs.append(epoch)
        for k, v in logs.items():
            self.history.setdefault(k, []).append(v)


def _monitor_sign(mode: str, monitor: str) -> float:
    """+1 = lower is better.  Keras modes: min / max / auto (auto infers
    max for accuracy-ish monitors); anything else is an error, not a
    silent max."""
    if mode == "auto":
        mode = "max" if ("acc" in monitor or monitor.startswith("fmeasure")) \
            else "min"
    if mode == "min":
        return 1.0
    if mode == "max":
        return -1.0
    raise ValueError(f"mode must be 'min', 'max', or 'auto'; got {mode!r}")


class ModelCheckpoint(Callback):
    """Per-epoch weights save, optionally only on metric improvement
    (Keras ``ModelCheckpoint``).  Writes the same ``{params,
    model_state}`` payload as ``Sequential.save_weights``, so
    ``load_weights`` reads these checkpoints back."""

    def __init__(self, ckpt_dir: str, monitor: str = "val_loss",
                 save_best_only: bool = False, mode: str = "auto",
                 max_to_keep: int = 5):
        self.ckpt_dir = ckpt_dir
        self.monitor = monitor
        self.save_best_only = save_best_only
        self.sign = _monitor_sign(mode, monitor)
        self.max_to_keep = max_to_keep
        self.best = float("inf")

    def on_epoch_end(self, model, epoch, logs) -> None:
        import math
        if self.save_best_only:
            value = logs.get(self.monitor)
            if value is None or not math.isfinite(float(value)):
                return     # a NaN epoch must never become "best"
            score = self.sign * float(value)
            if score >= self.best:
                return
            self.best = score
        from ..train import checkpoint as ck
        ck.save(self.ckpt_dir, int(model.state.step), model.weights_tree(),
                max_to_keep=self.max_to_keep)


class LearningRateScheduler(Callback):
    """Epoch-indexed LR control (Keras ``LearningRateScheduler`` analogue).

    ``schedule(epoch) -> multiplier`` of the compiled base learning rate:
    the callback moves the ``with_lr_scale`` multiplier (a host value the
    next step reads).
    """

    def __init__(self, schedule, verbose: int = 0):
        self.schedule = schedule
        self.verbose = verbose

    def on_epoch_begin(self, model, epoch) -> None:
        scale = float(self.schedule(epoch))
        model.lr_scale = scale
        if self.verbose:
            print(f"LearningRateScheduler: epoch {epoch} lr_scale={scale:g}",
                  flush=True)


class ReduceLROnPlateau(Callback):
    """Shrink the LR multiplier when the monitored metric stalls (Keras
    ``ReduceLROnPlateau`` parity: factor/patience/cooldown/min)."""

    def __init__(self, monitor: str = "val_loss", factor: float = 0.1,
                 patience: int = 10, min_delta: float = 1e-4,
                 cooldown: int = 0, min_scale: float = 0.0,
                 mode: str = "auto", verbose: int = 0):
        if factor >= 1.0:
            raise ValueError("ReduceLROnPlateau needs factor < 1.0")
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_scale = min_scale
        self.sign = _monitor_sign(mode, monitor)
        self.verbose = verbose
        self.best = float("inf")
        self.wait = 0
        self.cooldown_left = 0

    def on_epoch_end(self, model, epoch, logs) -> None:
        value = logs.get(self.monitor)
        if value is None:
            return
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            self.wait = 0
        score = self.sign * float(value)
        if score < self.best - self.min_delta:
            self.best = score
            self.wait = 0
        elif self.cooldown_left == 0:
            self.wait += 1
            if self.wait >= self.patience:
                new = max(model.lr_scale * self.factor, self.min_scale)
                if new < model.lr_scale:
                    model.lr_scale = new
                    if self.verbose:
                        print(f"ReduceLROnPlateau: epoch {epoch} "
                              f"lr_scale -> {new:g}", flush=True)
                self.cooldown_left = self.cooldown
                self.wait = 0


class CSVLogger(Callback):
    """Append per-epoch logs to a CSV file (Keras ``CSVLogger`` parity).
    The column set is fixed by the first logged epoch.

    With ``append=True``, a pre-existing file whose header does not start
    with ``epoch,`` raises ``ValueError`` at ``on_train_begin`` — appending
    rows under a foreign header would silently corrupt the log, so reusing
    a log path across tools is an explicit error, not a degradation."""

    def __init__(self, filename: str, append: bool = False):
        self.filename = filename
        self.append = append
        self._file = None
        self._keys = None

    def on_train_begin(self, model) -> None:
        import os
        os.makedirs(os.path.dirname(self.filename) or ".", exist_ok=True)
        if self.append:
            # appending to a file with content: its header already exists —
            # never write a second one mid-file (Keras CSVLogger behavior)
            if self._keys is None and os.path.exists(self.filename) \
                    and os.path.getsize(self.filename) > 0:
                with open(self.filename) as f:
                    header = f.readline().strip()
                if header.startswith("epoch,"):
                    self._keys = header.split(",")[1:]
                else:
                    # Appending rows under a foreign header would interleave
                    # two incompatible tables in one file; refuse instead.
                    raise ValueError(
                        f"CSVLogger(append=True): {self.filename} has an "
                        f"incompatible header {header!r} (expected it to "
                        "start with 'epoch,'); pass append=False to "
                        "overwrite or point at a fresh file")
        else:
            self._keys = None   # truncated file needs its header rewritten
        self._file = open(self.filename, "a" if self.append else "w")

    def on_epoch_end(self, model, epoch, logs) -> None:
        if self._file is None:
            return
        if self._keys is None:
            self._keys = sorted(logs)
            self._file.write(",".join(["epoch"] + self._keys) + "\n")
        row = [str(epoch)] + [f"{logs.get(k, float('nan'))}"
                              for k in self._keys]
        self._file.write(",".join(row) + "\n")
        self._file.flush()

    def on_train_end(self, model) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class TerminateOnNaN(Callback):
    """Stop training when the epoch loss goes non-finite (Keras parity;
    the per-step fail-fast variant is ``train.NaNHook``)."""

    def on_epoch_end(self, model, epoch, logs) -> None:
        import math
        loss = logs.get("loss")
        if loss is not None and not math.isfinite(float(loss)):
            print(f"TerminateOnNaN: non-finite loss at epoch {epoch}, "
                  "stopping", flush=True)
            model.stop_training = True


class LambdaCallback(Callback):
    """Ad-hoc callbacks from plain functions (Keras ``LambdaCallback``)."""

    def __init__(self, on_train_begin=None, on_epoch_begin=None,
                 on_epoch_end=None, on_train_end=None):
        if on_train_begin:
            self.on_train_begin = on_train_begin
        if on_epoch_begin:
            self.on_epoch_begin = on_epoch_begin
        if on_epoch_end:
            self.on_epoch_end = on_epoch_end
        if on_train_end:
            self.on_train_end = on_train_end


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "val_loss", patience: int = 3,
                 min_delta: float = 0.0, mode: str = "auto"):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.sign = _monitor_sign(mode, monitor)
        self.best = float("inf")
        self.wait = 0

    def on_epoch_end(self, model, epoch, logs) -> None:
        value = logs.get(self.monitor)
        if value is None:
            return
        score = self.sign * float(value)
        if score < self.best - self.min_delta:
            self.best = score
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                model.stop_training = True
