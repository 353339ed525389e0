"""Sequential — the high-level ``compile``/``fit`` tier, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/models/sequential.py``:
``Sequential`` with ``add``, ``compile(loss, optimizer, metrics, ...)``,
``build``, ``fit`` / ``fit_stream``, the ``*_on_batch`` methods,
``evaluate`` / ``evaluate_stream``, ``predict``, weights and full-model
IO, ``lr_scale`` and ``summary``, driving the same steps as the low-level
tier (``train.make_train_step``, ``make_multi_train_step``,
``make_eval_step``).

The port's differences, each forced by eager PyTorch:

* A ``Sequential`` lives on one device, ``device=`` (``"cuda"`` by
  default; it raises without a card, and ``"cpu"`` is the explicit
  opt-in).  Parameters are the ``Stack``'s flat dict (``"dense.kernel"``),
  updated in place by the step.
* ``steps_per_execution=K`` is accepted, checked and saved with the
  compile config, but ``fit`` runs the single step for every batch: the
  JAX package compiles K steps into one program to save dispatches, and
  eager PyTorch has no such program, so K single steps are the same
  updates at no extra cost (``train.make_multi_train_step`` is ported
  for callers that want the [K, batch, ...] form).
* Data parallelism (``compile(mesh=...)`` with a ``parallel.Mesh`` over a
  process group): every rank draws the same shuffled (and augmented)
  global batch from the same seed and feeds its contiguous
  ``local_batch_size`` slice; the step averages the gradients, loss and
  metrics over the ranks with one all-reduce, and a ``BatchNorm`` takes
  the global batch's moments.  Under ``fit(sample_weight=...)`` the loss
  divides by the global batch's count of non-zero weights (one more
  all-reduce, of that count), as the JAX fit over a sharded batch does.
  ``evaluate`` and
  ``predict`` run the whole of their data on every rank (no collective;
  the means are the one-process means exactly, so the JAX package's
  padded, masked tail for multi-process evaluation is not needed here;
  ``train.make_masked_eval_step`` is ported beside it).
* Epoch means are summed on the device and read once an epoch
  (``_MeanAccumulator``); ``evaluate`` reads its sums once.  There is no
  sync cadence: eager PyTorch bounds its own queue, and the prefetch
  holds at most two staged batches.
"""
from __future__ import annotations

import itertools
import json
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.pipeline import Dataset, prefetch_to_device
from ..ops import layers as layer_lib
from ..ops import losses as loss_lib
from ..ops import metrics as metric_lib
from ..optim import optimizers as opt_lib
from ..parallel import mesh as mesh_lib
from ..train import checkpoint as ck
from ..train import step as step_lib
from ..train.session import TrainState
from .callbacks import Callback, History
from .gpt import resolve_device

log = logging.getLogger(__name__)

__all__ = ["Sequential"]


class _MeanAccumulator:
    """Exact epoch mean of step metrics with no per-batch host reads:
    each step's scalar is added to an f32 running sum on the device, in
    step order, and ``means``
    reads every sum at once, one host read an epoch.  Keys come out
    sorted, the order of the JAX package's metric dicts (a pytree's)."""

    def __init__(self):
        self.sums: Dict[str, torch.Tensor] = {}
        self.counts: Dict[str, int] = {}

    def add(self, metrics: Dict[str, torch.Tensor]) -> None:
        for k, v in metrics.items():
            v = v.detach().float()
            prev = self.sums.get(k)
            self.sums[k] = v if prev is None else prev + v
            self.counts[k] = self.counts.get(k, 0) + 1

    def means(self) -> Dict[str, float]:
        if not self.sums:
            return {}
        keys = sorted(self.sums)
        vals = torch.stack([self.sums[k] for k in keys]).tolist()
        return {k: v / self.counts[k] for k, v in zip(keys, vals)}


def _sorted_leaves(tree: Dict[str, Any]) -> List[Any]:
    """Leaves of a nested dict in the JAX flatten order (sorted keys at
    every level)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_sorted_leaves(v) if isinstance(v, dict) else [v])
    return out


class Sequential:
    def __init__(self, layers: Sequence[layer_lib.Layer] = (),
                 name: str = "sequential", device="cuda"):
        self.name = name
        self.device = resolve_device(device)
        self._layers: List[layer_lib.Layer] = list(layers)
        self._stack: Optional[layer_lib.Stack] = None
        self.state: Optional[TrainState] = None
        self.stop_training = False
        self._compiled = None
        self._compile_config = None   # JSON-able compile args (for save)
        self._in_shape = None         # recorded at build (for load)

    # -- construction ----------------------------------------------------
    def add(self, layer: layer_lib.Layer) -> None:
        self._layers.append(layer)
        self._stack = None
        self._compiled = None

    @property
    def stack(self) -> layer_lib.Stack:
        if self._stack is None:
            self._stack = layer_lib.Stack(self._layers, name=self.name)
        return self._stack

    @property
    def layers(self) -> List[layer_lib.Layer]:
        """Ordered layer list (Keras ``model.layers``); read by
        ``summary.model_graph_nodes`` for the graph record."""
        return self._layers

    # -- compile ---------------------------------------------------------
    def compile(self, loss, optimizer="adam",
                metrics: Sequence = (),
                mesh=None, params_spec=None, seed: int = 0,
                grad_clip_norm: Optional[float] = None,
                policy=None, steps_per_execution: int = 1,
                grad_accum_steps: int = 1) -> None:
        """Loss, optimizer and metrics by name or as callables/objects.

        ``mesh``: a ``parallel.Mesh`` (module docstring).  ``policy``: a
        precision policy for the train and eval steps.
        ``steps_per_execution``: checked and saved; ``fit`` runs single
        steps (module docstring).  ``grad_accum_steps``: that
        many microbatches a batch, one update.  ``params_spec``
        (tensor-parallel parameter specs) is not ported and must be
        None."""
        if params_spec is not None:
            raise NotImplementedError(
                "params_spec: tensor-parallel parameter specs are not "
                "ported; the port's mesh has one data axis")
        loss_fn = loss_lib.get(loss)
        # with_lr_scale: LearningRateScheduler / ReduceLROnPlateau move a
        # host multiplier in opt_state between steps
        opt = opt_lib.with_lr_scale(opt_lib.get(optimizer))
        metric_fns = {}
        for m in metrics:
            fn = metric_lib.get(m)
            metric_fns[getattr(fn, "__name__", str(m))] = fn
        if grad_accum_steps < 1:
            raise ValueError(
                f"grad_accum_steps must be >= 1; got {grad_accum_steps}")
        if steps_per_execution < 1:
            raise ValueError(
                f"steps_per_execution must be >= 1; got {steps_per_execution}")
        # ONE kwargs dict builds the default step and any weighted sibling
        step_kwargs = dict(metric_fns=metric_fns, seed=seed, mesh=mesh,
                           grad_clip_norm=grad_clip_norm, policy=policy,
                           accum_steps=int(grad_accum_steps))
        self._compiled = dict(
            loss=loss_fn, optimizer=opt, metric_fns=metric_fns, mesh=mesh,
            loss_name=loss if isinstance(loss, str) else None,
            step_kwargs=step_kwargs,
            weighted_steps={},
            train_step=step_lib.make_train_step(
                self.stack, loss_fn, opt, **step_kwargs),
            eval_step=step_lib.make_eval_step(
                self.stack, loss_fn, metric_fns=metric_fns, policy=policy),
        )
        # the compile call, for model.save, when every piece is a JSON-able
        # registry name (a mesh or a callable cannot round-trip)
        serializable = (isinstance(loss, str) and isinstance(optimizer, str)
                        and all(isinstance(m, str) for m in metrics)
                        and (policy is None or isinstance(policy, str))
                        and mesh is None)
        self._compile_config = dict(
            loss=loss, optimizer=optimizer, metrics=list(metrics),
            seed=seed, grad_clip_norm=grad_clip_norm, policy=policy,
            steps_per_execution=int(steps_per_execution),
            grad_accum_steps=int(grad_accum_steps)
        ) if serializable else None
        # a recompile keeps the weights and resets the optimizer state
        # (Keras recompile semantics; what lets load_model restore weights
        # before the user's own compile())
        if self.state is not None:
            self.state = self.state._replace(
                opt_state=opt.init(self.state.params))

    def _require_compiled(self) -> dict:
        if self._compiled is None:
            raise RuntimeError("call model.compile(...) before fit/evaluate")
        return self._compiled

    def _require_state(self) -> TrainState:
        if self.state is None:
            raise RuntimeError("model has no state; call fit or build first")
        return self.state

    def build(self, in_shape: Tuple[int, ...], seed: int = 0) -> TrainState:
        """Initialize parameters for per-example feature shape ``in_shape``
        from a generator seeded with ``seed``, on the model's device."""
        c = self._require_compiled()
        self._in_shape = tuple(int(d) for d in in_shape)
        self.state = step_lib.init_train_state(
            self.stack, c["optimizer"],
            torch.Generator(self.device).manual_seed(seed), in_shape)
        return self.state

    # -- the data-parallel batch slice -----------------------------------
    def _rank_rows(self, mesh, batch_rows: int) -> Optional[slice]:
        """This rank's rows of a global batch (None without a group)."""
        if mesh is None or mesh.group is None:
            return None
        local = mesh_lib.local_batch_size(batch_rows, mesh)
        return slice(mesh.rank * local, (mesh.rank + 1) * local)

    def _local(self, it, mesh):
        """Each global batch of ``it`` cut to this rank's rows."""
        for b in it:
            rows = self._rank_rows(mesh, b[0].shape[0])
            yield b if rows is None else tuple(a[rows] for a in b)

    # -- training --------------------------------------------------------
    def fit(self, x, y, epochs: int = 1, batch_size: int = 32,
            validation_data: Optional[Tuple] = None,
            validation_split: float = 0.0,
            callbacks: Sequence[Callback] = (),
            shuffle: bool = True, seed: int = 0,
            verbose: int = 1, augment=None,
            class_weight=None, sample_weight=None) -> History:
        """Train for ``epochs`` over ``(x, y)`` in shuffled batches.

        ``augment``: a per-batch transform of ``data.augment``, run on the
        prefetch thread, on training batches only.  ``validation_split``:
        a fraction held out from the END of ``(x, y)`` before shuffling
        when no ``validation_data`` is given.  Epoch ``logs``/History
        values are the mean of every step's metrics.  ``class_weight``:
        ``{class_id: weight}`` on the training loss (a string
        classification loss).  ``sample_weight``: per-sample weights [n]
        on the training loss with Keras 2.0.8's normalization
        (``sum(loss_i * w_i) / count_nonzero(w)``); metrics stay
        unweighted, and it cannot be combined with ``class_weight``."""
        c = self._require_compiled()
        train_step = c["train_step"]
        accum = c["step_kwargs"]["accum_steps"]
        if accum > 1 and (sample_weight is not None
                          or class_weight is not None):
            raise ValueError(
                "grad_accum_steps > 1 composes only with the unweighted "
                "loss path; drop sample_weight/class_weight or recompile "
                "with grad_accum_steps=1")
        if sample_weight is not None:
            if class_weight is not None:
                raise ValueError(
                    "pass either sample_weight or class_weight, not both "
                    "(Keras 2.0.8 silently ignored class_weight here; "
                    "refusing is safer)")
            sample_weight = np.asarray(sample_weight, np.float32)
            if sample_weight.shape != (int(np.shape(x)[0]),):
                raise ValueError(
                    f"sample_weight shape {sample_weight.shape} != "
                    f"({int(np.shape(x)[0])},) — one float per sample")
            train_step = self._sample_weighted_step(c)
        if class_weight is not None:
            if c["loss_name"] is None:
                raise ValueError("class_weight needs the model compiled "
                                 "with a loss NAME (string), not a callable")
            key_cw = tuple(sorted((int(k), float(v))
                                  for k, v in class_weight.items()))
            if key_cw not in c["weighted_steps"]:
                wfn = loss_lib.class_weighted(c["loss_name"], class_weight)
                c["weighted_steps"][key_cw] = step_lib.make_train_step(
                    self.stack, wfn, c["optimizer"], **c["step_kwargs"])
            train_step = c["weighted_steps"][key_cw]
        if validation_split and validation_data is None:
            if not 0.0 < validation_split < 1.0:
                raise ValueError(
                    f"validation_split must be in (0, 1); got "
                    f"{validation_split}")
            n = int(np.shape(x)[0])
            split = n - max(1, int(n * validation_split))
            x, y = np.asarray(x), np.asarray(y)
            validation_data = (x[split:], y[split:])
            x, y = x[:split], y[:split]
            if sample_weight is not None:   # held-out rows eval unweighted
                sample_weight = sample_weight[:split]
        if self.state is None:
            self.build(tuple(np.shape(x)[1:]), seed=seed)

        history = History()
        callbacks = list(callbacks) + [history]
        self.stop_training = False

        mesh = c["mesh"]
        if mesh is not None:
            rounded = mesh_lib.round_batch_to_mesh(batch_size, mesh)
            if rounded != batch_size:
                log.info("batch_size %d -> %d (divisible by mesh data shards)",
                         batch_size, rounded)
                batch_size = rounded
        if accum > 1 and batch_size % accum:
            raise ValueError(
                f"batch_size {batch_size} is not divisible by "
                f"grad_accum_steps {accum}")
        arrays = [np.asarray(x), np.asarray(y)]
        if sample_weight is not None:
            arrays.append(sample_weight)   # shuffles/shards with (x, y)
        dataset = Dataset(arrays, batch_size,
                          shuffle=shuffle, seed=seed, transform=augment)

        for cb in callbacks:
            cb.on_train_begin(self)
        for epoch in range(epochs):
            if self.stop_training:
                break
            for cb in callbacks:
                cb.on_epoch_begin(self, epoch)
            acc = _MeanAccumulator()
            for batch in prefetch_to_device(self._local(iter(dataset), mesh),
                                            device=self.device):
                self.state, metrics = train_step(self.state, batch)
                acc.add(metrics)
            logs = acc.means()
            if validation_data is not None:
                val = self.evaluate(validation_data[0], validation_data[1],
                                    batch_size=batch_size, verbose=0)
                logs.update({f"val_{k}": v for k, v in val.items()})
            if verbose:
                parts = ", ".join(f"{k}={v:.4f}" for k, v in logs.items())
                print(f"Epoch {epoch + 1}/{epochs}: {parts}", flush=True)
            for cb in callbacks:
                cb.on_epoch_end(self, epoch, logs)
        for cb in callbacks:
            cb.on_train_end(self)
        return history

    def fit_stream(self, batches, steps_per_epoch: int, epochs: int = 1,
                   callbacks: Sequence[Callback] = (),
                   validation_data: Optional[Tuple] = None,
                   verbose: int = 1) -> History:
        """Train from streamed ``(x, y)`` numpy batches: an iterator, or a
        callable ``epoch -> iterator``.  All batches share one shape,
        divisible by the mesh's data shards and by ``grad_accum_steps``
        (checked on the first batch).  Each epoch draws
        ``steps_per_epoch`` batches; a source that ends sooner ends the
        epoch, and training, early."""
        c = self._require_compiled()
        train_step = c["train_step"]
        mesh = c["mesh"]

        def epoch_iter(epoch):
            it = batches(epoch) if callable(batches) else batches
            for _ in range(steps_per_epoch):
                try:
                    yield next(it)
                except StopIteration:
                    return

        first_it = epoch_iter(0)
        try:
            first = next(first_it)
        except StopIteration:
            raise ValueError("batch stream is empty") from None
        bs = int(np.shape(first[0])[0])
        accum = c["step_kwargs"]["accum_steps"]
        if accum > 1 and bs % accum:
            raise ValueError(f"streamed batch size {bs} is not divisible "
                             f"by grad_accum_steps {accum}")
        if mesh is not None:
            shards = mesh.shape.get("data", 1)
            if bs % shards:
                raise ValueError(f"streamed batch size {bs} is not "
                                 f"divisible by the mesh's {shards} data "
                                 f"shards")
        if self.state is None:
            self.build(tuple(np.shape(first[0])[1:]))

        history = History()
        callbacks = list(callbacks) + [history]
        self.stop_training = False
        exhausted = False
        for cb in callbacks:
            cb.on_train_begin(self)
        for epoch in range(epochs):
            if self.stop_training or exhausted:
                break
            it = (itertools.chain([first], first_it) if epoch == 0
                  else epoch_iter(epoch))
            acc = _MeanAccumulator()
            drawn = 0
            epoch_began = False
            for batch in prefetch_to_device(self._local(it, mesh),
                                            device=self.device):
                if not epoch_began:
                    # after the first batch exists: an exactly-exhausted
                    # stream must not produce a ghost zero-step epoch
                    epoch_began = True
                    for cb in callbacks:
                        cb.on_epoch_begin(self, epoch)
                self.state, metrics = train_step(self.state, batch)
                drawn += 1
                acc.add(metrics)
            if not epoch_began:
                break                              # stream already dry
            exhausted = drawn < steps_per_epoch
            logs = acc.means()
            if validation_data is not None:
                val = self.evaluate(validation_data[0], validation_data[1],
                                    verbose=0)
                logs.update({f"val_{k}": v for k, v in val.items()})
            if verbose:
                parts = ", ".join(f"{k}={v:.4f}" for k, v in logs.items())
                print(f"Epoch {epoch + 1}/{epochs}: {parts}", flush=True)
            for cb in callbacks:
                cb.on_epoch_end(self, epoch, logs)
        for cb in callbacks:
            cb.on_train_end(self)
        return history

    def _sample_weighted_step(self, c) -> Any:
        """``step(state, (x, y, w))`` with Keras 2.0.8's sample-weight
        rule; built once per compile and cached."""
        if "sample_step" in c:
            return c["sample_step"]
        loss_value_fn = c["loss"]
        metric_fns = c["metric_fns"]
        stack = self.stack
        kw = c["step_kwargs"]
        mesh = kw["mesh"]
        dp = mesh if mesh is not None and mesh.group is not None else None

        def loss_fn(params, model_state, batch, generator, train):
            xb, yb, wb = batch
            preds, new_ms = stack.apply(params, model_state, xb,
                                        train=train, rng=generator)
            # per-sample losses: the loss of each sample's own [1, ...]
            # slice (exact for any mean-of-per-sample-terms loss)
            per = step_lib.per_example(loss_value_fn, preds, yb)
            w = wb.to(per.dtype)
            nonzero = torch.sum((w != 0).to(per.dtype))
            total = torch.sum(per * w)
            if dp is not None:
                # the global batch's count: the step averages the ranks'
                # losses, so each carries size / count of its own sum
                dist.all_reduce(nonzero, group=dp.group)
                total = total * dp.size
            loss = total / torch.clamp(nonzero, min=1.0)
            metrics = {name: metric_lib.get(fn)(preds.detach(), yb)
                       for name, fn in metric_fns.items()}
            return loss, (metrics, new_ms)

        c["sample_step"] = step_lib.make_custom_train_step(
            loss_fn, c["optimizer"], seed=kw["seed"], mesh=mesh,
            grad_clip_norm=kw["grad_clip_norm"], policy=kw["policy"])
        return c["sample_step"]

    # -- single batches (Keras train/test/predict_on_batch) --------------
    def _tensors(self, *arrays):
        return tuple(torch.as_tensor(np.asarray(a)).to(self.device)
                     for a in arrays)

    def train_on_batch(self, x, y) -> Dict[str, float]:
        """One optimizer step on one batch -> metric dict; on a mesh the
        batch must divide the data shards (each rank steps on its
        rows)."""
        c = self._require_compiled()
        if self.state is None:
            self.build(tuple(np.shape(x)[1:]))
        x, y = np.asarray(x), np.asarray(y)
        mesh = c["mesh"]
        if mesh is not None and x.shape[0] % mesh.size:
            raise ValueError(
                f"train_on_batch with a mesh-compiled model needs the batch "
                f"({x.shape[0]}) divisible by the mesh's data shards "
                f"({mesh.size})")
        rows = self._rank_rows(mesh, x.shape[0])
        if rows is not None:
            x, y = x[rows], y[rows]
        self.state, metrics = c["train_step"](self.state,
                                              self._tensors(x, y))
        return {k: float(v) for k, v in metrics.items()}

    def test_on_batch(self, x, y) -> Dict[str, float]:
        """Loss/metrics on one batch, no state change."""
        c = self._require_compiled()
        metrics = c["eval_step"](self._require_state(), self._tensors(x, y))
        return {k: float(v) for k, v in metrics.items()}

    def predict_on_batch(self, x) -> np.ndarray:
        return self.predict(np.asarray(x), batch_size=int(np.shape(x)[0]))

    def evaluate(self, x, y, batch_size: int = 32,
                 verbose: int = 1) -> Dict[str, float]:
        """Batch-size-weighted means of the loss and metrics over ``(x,
        y)`` in order, the tail batch included."""
        self._require_compiled()
        self._require_state()
        dataset = Dataset([np.asarray(x), np.asarray(y)], batch_size,
                          shuffle=False, drop_remainder=False)
        return self._evaluate_batches(iter(dataset), verbose)

    def evaluate_stream(self, batches, steps: Optional[int] = None,
                        verbose: int = 1) -> Dict[str, float]:
        """``evaluate`` over streamed ``(x, y)`` batches: up to ``steps``
        of them (all when None; an ``islice``, so no extra batch is drawn
        from a shared iterator)."""
        it = batches if steps is None else itertools.islice(batches, steps)
        return self._evaluate_batches(it, verbose)

    def _evaluate_batches(self, it, verbose: int) -> Dict[str, float]:
        """The one eval core: batch-size-weighted metric means, summed on
        the device in f64 and read once; keys sorted."""
        c = self._require_compiled()
        state = self._require_state()
        totals: Dict[str, torch.Tensor] = {}
        n = 0
        for batch in prefetch_to_device(it, device=self.device):
            bs = batch[0].shape[0]
            for k, v in c["eval_step"](state, batch).items():
                t = v.double() * bs
                totals[k] = t if k not in totals else totals[k] + t
            n += bs
        keys = sorted(totals)
        vals = torch.stack([totals[k] for k in keys]).tolist() if keys \
            else []
        out = {k: v / max(n, 1) for k, v in zip(keys, vals)}
        if verbose:
            parts = ", ".join(f"{k}={v:.4f}" for k, v in out.items())
            print(f"evaluate: {parts}", flush=True)
        return out

    @torch.no_grad()
    def predict(self, x, batch_size: int = 256) -> np.ndarray:
        state = self._require_state()
        x = np.asarray(x)
        outs = [self.stack.apply(state.params, state.model_state, xb,
                                 train=False)[0]
                for (xb,) in prefetch_to_device(
                    ((x[lo:lo + batch_size],)
                     for lo in range(0, x.shape[0], batch_size)),
                    device=self.device)]
        return torch.cat(outs).cpu().numpy()   # one read at the end

    # -- weights IO (Keras save_weights/load_weights) --------------------
    def weights_tree(self) -> Dict[str, Any]:
        """``{params, model_state}`` in the JAX package's tree (parameters
        nested by layer, the model's own tensors): what ``save_weights``
        and ``ModelCheckpoint`` write and ``load_weights`` restores into."""
        state = self._require_state()
        return {"params": layer_lib._nest(dict(state.params)),
                "model_state": state.model_state}

    def save_weights(self, ckpt_dir: str) -> str:
        """Write {params, model_state} (not optimizer state) as a
        step-stamped checkpoint under ``ckpt_dir``."""
        return ck.save(ckpt_dir, int(self._require_state().step),
                       self.weights_tree())

    def load_weights(self, ckpt_dir: str) -> None:
        """Restore the latest weights checkpoint from ``ckpt_dir`` into the
        (built) model, in place; optimizer state is untouched."""
        if self.state is None:
            raise RuntimeError("build the model (compile + build/fit) "
                               "before load_weights")
        latest = ck.latest_checkpoint(ckpt_dir)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        restored = ck.restore(self.weights_tree(), latest)
        self.state = self.state._replace(model_state=restored["model_state"])

    # -- flat weights access (Keras get_weights/set_weights) -------------
    def _layer_leaves(self) -> List[torch.Tensor]:
        """Parameter tensors: layers in model order, leaves in the JAX
        package's (sorted-key) order within each layer."""
        nested = layer_lib._nest(dict(self._require_state().params))
        return [t for key in self.stack.keys if key in nested
                for t in _sorted_leaves(nested[key])]

    def get_weights(self) -> List[np.ndarray]:
        """Parameters as a flat list of host arrays, in the JAX package's
        order; ``set_weights`` is the exact inverse."""
        return [t.detach().cpu().numpy().copy() for t in self._layer_leaves()]

    @torch.no_grad()
    def set_weights(self, weights: Sequence[np.ndarray]) -> None:
        """Inverse of ``get_weights`` (also the JAX model's list): same
        order, shapes must match; copied into the parameters in place."""
        leaves = self._layer_leaves()
        if len(weights) != len(leaves):
            raise ValueError(f"expected {len(leaves)} arrays, got "
                             f"{len(weights)}")
        for cur, w in zip(leaves, weights):
            w = np.asarray(w)
            if tuple(w.shape) != tuple(cur.shape):
                raise ValueError(f"shape mismatch: expected "
                                 f"{tuple(cur.shape)}, got {w.shape}")
        for cur, w in zip(leaves, weights):
            cur.copy_(torch.from_numpy(np.array(w, np.float32)))

    # -- full-model IO (Keras model.save / load_model / to_json) ---------
    def save(self, path: str) -> str:
        """Architecture + weights under ``path`` (see models.saving)."""
        from . import saving
        return saving.save_model(self, path)

    def to_json(self, **dump_kwargs) -> str:
        from . import saving
        return json.dumps(saving.model_to_config(self), **dump_kwargs)

    @classmethod
    def from_json(cls, text: str, device="cuda") -> "Sequential":
        from . import saving
        return saving.model_from_config(json.loads(text), device=device)

    # -- learning-rate control -------------------------------------------
    @property
    def lr_scale(self) -> float:
        """Multiplier on the compiled optimizer's learning rate."""
        return opt_lib.get_lr_scale(self._require_state().opt_state)

    @lr_scale.setter
    def lr_scale(self, value: float) -> None:
        state = self._require_state()
        self.state = state._replace(
            opt_state=opt_lib.set_lr_scale(state.opt_state, value))

    # -- introspection ---------------------------------------------------
    def summary(self) -> str:
        lines = [f"Model: {self.name}"]
        total = 0
        if self.state is not None:
            nested = layer_lib._nest(dict(self.state.params))
            for name, p in nested.items():
                n = sum(t.numel() for t in _sorted_leaves(p))
                total += n
                lines.append(f"  {name}: {n:,} params")
            lines.append(f"Total params: {total:,}")
        else:
            lines += [f"  {layer!r}" for layer in self._layers]
        text = "\n".join(lines)
        print(text, flush=True)
        return text
