"""The training and eval steps, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/train/step.py``:
``make_custom_train_step``, loss and gradients (over ``accum_steps``
microbatches), the precision policy, loss scaling, the non-finite skip,
device-health metrics, the global-norm clip, the optimizer update, the
parameters updated in place, the step advanced; ``make_train_step`` and
``make_eval_step``, its adapters for a layer ``Stack`` with a named loss
and metrics over ``(x, y)`` batches (``example.py``'s builders);
``make_multi_train_step`` (K single steps over a ``[K, batch, ...]``
group, metrics stacked to ``[K]``: the JAX package scans the single step
inside one program, here the same step runs K times) and
``make_masked_eval_step`` (per-example loss and metrics weighted by a
validity mask); ``make_1f1b_train_step`` (a pipelined GPT's gradients
from the hand-scheduled 1F1B pass); and ``init_train_state``.  The JAX step is one
jit-compiled program over a donated state; here PyTorch runs eagerly and
the parameters are the model's own tensors, updated in place under
``torch.no_grad()``, which is what donation buys there.  Metrics stay on the device as tensors.

Data parallelism (``mesh=`` from ``parallel.data_parallel_mesh`` over a
``torch.distributed`` group): each rank computes the mean gradients of
its shard of the global batch, and ONE all-reduce of a flat bucket
averages the gradients, the loss and the metrics over the ranks
(``parallel.data_parallel.all_reduce_mean``) before the loss-scale and
skip logic, the clip and the update, so every rank applies the same
update.  A loss function that reports ``metrics["loss_weight"]`` (the
models' masked means) is averaged with those weights, which makes the
result the global batch's masked mean however the ranks' mask counts
differ; a plain mean needs equal shards, which
``parallel.round_batch_to_mesh`` guarantees.  The JAX step gets the same
average from its partitioner (a global-mean loss over a batch sharded on
the mesh's ``data`` axis).  A ``BatchNorm`` takes the global batch's
moments there: ``make_custom_train_step`` runs every loss function under
``parallel.data_parallel.cross_rank_moments``, so the norm's forward
sums its shard's sums over the batch line and its backward the
gradients of them (a MoE GPT's router statistics likewise).

Sequence parallelism (a mesh from ``parallel.make_mesh`` with ``data`` x
``seq`` axes, ``fsdp`` counted as ``data``): every rank of a seq line
passes the same batch (its ``Mesh.data_index`` picks the rows) and the
model's loss function computes on its sequence shard, reducing its sums
over the line (``GPT.lm_loss_fn``, ``Bert.mlm_loss_fn`` with
``seq_axis``), or on the gathered output of ``apply``, so each rank
holds the line's loss.  The ops that cross the line scale the gradients
so that the same single all-reduce's mean is the global batch's
(``parallel/ring.py`` says how).

ZeRO over ``fsdp`` (``shard_train_state``, the JAX package's
placement): each rank keeps its block of every leaf the partition rules
cut over the ``fsdp`` axis (``parallel/sharding.py``), the parameters
and every params-shaped piece of optimizer state alike (Adam's moments,
momentum's ``mu``, the ``with_ema`` shadow); the rest replicates.  The
step over such a state (``make_custom_train_step(mesh=)``) gathers the
blocks into the model's full tensors (one all-gather over the ``fsdp``
line), runs loss and gradients on them as above, reduce-scatters the
gradients to the blocks and averages them over the ``data`` line
(``parallel.data_parallel.reduce_scatter_mean``), then clips and updates
the blocks alone: the Adam kernel runs on each block, and the EMA folds
each block of the shadow.  The global norm, the non-finite count and so
the skip are global over the line (a block's squares summed over it, an
uncut leaf counted once), so a non-finite element in one rank's block
skips the step on every rank.  ``fsdp`` stays a batch axis.  The full
tensors are kept between steps (the blocks are the truth; eval and
``generate`` read the model after ``gather_params``): what the layout
saves is the moments, the EMA shadow and the master blocks, at 1/R each
on a line of R ranks.  ZeRO-3's per-layer gather, which frees the full
parameters between layers, is later work.  On a line of one rank the
blocks ARE the model's tensors and no collective runs: the step is the
plain one.  An optimizer that reduces over each tensor (``lamb``,
``adafactor``: ``Optimizer.elementwise`` False) raises over a cut
layout.

Tensor parallelism (a mesh with ``data`` x ``tensor`` axes and a state
placed by ``shard_train_state`` from a model built on that mesh, whose
parameters are its blocks): the model issues the line's collectives
itself (``parallel/tensor_parallel.py``), every rank of a ``tensor``
line passes the same rows of the batch (``Mesh.data_index``) and holds
the whole loss.  The step averages the gradients over the ``data`` line
only (``parallel.data_parallel.replicas``: the ranks that hold the same
blocks; none on a line of one), weighted by a ``loss_weight`` summed over
that line; the global norm and the non-finite count sum each block's
squares and counts over the ``tensor`` line (one all-reduce of two
numbers) and count each replicated leaf once; Adam runs on the blocks.
On a line of one the model and the step are the plain ones.

Tensor beside sequence parallelism (a ``seq`` x ``tensor`` or ``data`` x
``seq`` x ``tensor`` mesh, a model with ``seq_axis`` built on it): the
ranks of a ``seq`` line hold the same blocks, each computing them on its
shard of the sequence, and the sequence ops scale their gradients for a
mean over the line (``parallel/ring.py``), so the step averages over
the ``seq`` line and then the ``data`` line (``replicas``: two
all-reduces, a line of one issuing none), weighted by the loss weight
shares the model reports; the global norm and the non-finite count sum
the blocks' squares over the ``tensor`` line once the gradients are the
replicas' mean, and count each replicated leaf once.

Tensor beside ZeRO (a ``data`` x ``fsdp`` x ``tensor`` mesh, a model built
on it and its rules with ``fsdp=True``): each rank keeps the ``fsdp``
part of each of its tensor blocks (``parallel.sharding.Blocks`` over
``fsdp`` and ``tensor``), its tensor blocks of the leaves only
``tensor`` cuts, the ``fsdp`` block of the leaves only ``fsdp`` cuts (a
replicated kv kernel) and the rest whole.  The step gathers the ``fsdp``
parts into the model's tensor blocks and whole leaves (one all-gather
over the ``fsdp`` line), the model computes on its blocks as under
tensor parallelism, and the gradients go through the ZeRO
reduce-scatter over ``fsdp`` and the mean over ``data``: a leaf with an
``fsdp`` part comes back as that part, every other leaf summed over
``fsdp`` and then ``data``; nothing is summed over ``tensor`` beyond
what the model's own ``copy_to_line`` backwards sum.  The global norm
sums each group of leaves over every line that cuts it.

Expert parallelism (a mesh with ``data`` x ``expert`` or ``expert`` x
``tensor`` axes and a state placed by ``shard_train_state`` from a MoE
``GPT`` built on that mesh): each rank keeps its experts of every MoE
bank (``parallel/sharding.py``'s ``Shard`` over ``expert``, or
``Blocks`` over ``expert`` and ``tensor``), every rank of an ``expert``
line passes the same rows of the batch and holds the whole loss
(``ops/moe.py`` says how).  As under tensor parallelism, the step
averages the gradients over the ``data`` line only (never over the
expert line, which would divide the experts' gradients by its size),
and the global norm sums each block's squares over every line that cuts
it (one all-reduce a line) and counts each replicated leaf once.
``expert`` beside ``fsdp`` or ``seq`` raises (items 7.2c, 7.2d).

Pipeline parallelism (a mesh with ``pipe`` x ``data`` axes and a state
placed by ``shard_train_state`` from a model built on that mesh, whose
parameters are its stage's layers and the replicated embeddings and
head): every rank of a ``pipe`` line passes the same rows of the batch
(``Mesh.data_index``); the model's GPipe forward returns the last
stage's output on every rank, so each computes the same loss and the
same gradients of the replicated leaves.  As under tensor parallelism,
the step averages over the ``data`` line only, and the global norm sums
the stage layers' squares over the ``pipe`` line (one all-reduce of two
numbers) and counts each replicated leaf once; Adam runs on the rank's
own leaves.  ``pipe`` beside ``fsdp``, ``tensor`` or ``seq`` raises
(ROADMAP Queue 1 items 7.3a-c).

Dropout randomness: a ``torch.Generator`` on the parameters' device,
seeded from ``(seed, step)`` for every step, from ``(seed, step, i)``
for microbatch ``i`` when ``accum_steps > 1``, and with the replica
folded in over a mesh of more than one replica (the rank's index over
every axis but ``pipe``, ``expert`` and ``tensor``: its ``data``,
``fsdp`` and ``seq`` coordinates): deterministic, resume-stable and
unique, as the JAX step folds the step (and the microbatch, and in its
``make_psum_train_step`` the replica) into its key.  Every rank of a
``tensor``, an ``expert`` or a ``pipe`` line draws the same bits (so
every rank of an expert line routes with the same router jitter into
the same dispatch plan), so the replicated residual stream stays equal
across the line, and a mesh of one replica draws what the same step
without a mesh draws; a head-sharded activation (the attention context)
draws its mask at the whole heads' shape and keeps its own heads' part,
so under tensor parallelism every mask is the one the same replica
draws at T = 1.  The bits differ from ``jax.random``'s, so parity
with the JAX package is tested at dropout rate 0.

The reported loss under ``loss_scale`` is the loss itself, not the
scaled loss unscaled as the JAX step reports it: where the scaled value
overflows to inf while every gradient stays finite (the gradients never
need that value), the JAX step applies a sound update and reports an
infinite loss, which stops a run under ``NaNHook``; here it reports the
loss.  Below overflow the two are equal (the scale is a power of two).

Skipping a step (``loss_scale`` or ``skip_nonfinite``): the JAX step
rolls a non-finite update back inside its program with ``jnp.where``.
Here Adam writes the parameters and moments in place, so the step reads
the finite flag on the host once, before the update, and on a skip
launches no optimizer at all: parameters, moments, the EMA shadow, the
optimizer's count and ``model_state`` keep their values and only
``TrainState.step`` advances.  That read is the step's only host sync;
the default path makes none.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from ..obs import device as obs_device
from ..ops import losses as loss_lib
from ..ops import metrics as metric_lib
from ..optim import optimizers as opt_lib
from ..optim.ema import EMAState
from ..parallel import data_parallel as dp_lib
from ..parallel import sharding as sharding_lib
from . import precision as prec_lib
from .session import TrainState

__all__ = ["TrainState", "gather_params", "init_train_state",
           "make_custom_train_step", "make_eval_step",
           "make_1f1b_train_step", "make_masked_eval_step",
           "make_multi_train_step", "make_train_step", "shard_train_state"]


def _step_generator(seed: int, step: int, device: torch.device,
                    microbatch: Optional[int] = None,
                    replica: Optional[int] = None) -> torch.Generator:
    """The dropout generator of step ``step`` (of its microbatch
    ``microbatch`` under accumulation, on rank ``replica`` under data
    parallelism)."""
    s = int(seed) * 1_000_003 + int(step)
    if microbatch is not None:
        s = s * 1_000_003 + int(microbatch) + 1
    if replica is not None:
        s = s * 1_000_003 + int(replica) + 1
    return torch.Generator(device).manual_seed(s % (2 ** 63))


def _microbatches(batch, n: int):
    """``batch`` (a dict, tuple or list of tensors) split along its leading
    dim into ``n`` equal batches of the same structure."""
    items = batch.items() if isinstance(batch, Mapping) \
        else enumerate(batch)
    bad = sorted({v.shape[0] for _, v in items if v.shape[0] % n})
    if bad:
        raise ValueError(f"batch leading dim(s) {bad} not divisible by "
                         f"accum_steps={n}")

    def part(v, i):
        return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
    if isinstance(batch, Mapping):
        return [{k: part(v, i) for k, v in batch.items()} for i in range(n)]
    return [type(batch)(part(v, i) for v in batch) for i in range(n)]


def init_train_state(model, optimizer: opt_lib.Optimizer,
                     generator: torch.Generator, in_shape) -> TrainState:
    """The ``TrainState`` of a layer ``Stack`` and an optimizer:
    parameters drawn from ``generator`` on its device."""
    params, model_state = model.init(generator, in_shape)
    return TrainState.create(params, optimizer.init(params), model_state)


def shard_train_state(state: TrainState, mesh, rules) -> TrainState:
    """Place a ``TrainState`` over ``mesh`` by ``rules``, as the JAX
    package's ``shard_train_state`` does.  The parameters become a
    ``ShardedDict`` of this rank's blocks: a whole leaf is cut (a copy),
    a leaf that is a block already (a tensor-parallel model's parameter,
    ``parallel.sharding.mark_block``) stays itself.  Every params-shaped
    subtree of the optimizer state is laid out with them leaf by leaf
    where the shapes agree (Adam's ``m``/``v``, momentum's ``mu``, the
    ``with_ema`` shadow); adafactor's factored moments, the counts, the
    EMA's scalars, ``sgd``'s empty state and ``model_state`` replicate.
    A ZeRO cut (over ``fsdp``) keeps the model's whole tensors as
    ``full``, which the step gathers the blocks into; a tensor-parallel
    cut's ``full`` is the blocks (a cut whole leaf's block requires
    gradients, as its leaf did), and so is an expert-parallel one's and
    a pipeline stage's (its layers marked with their ``Stage``, the rest
    whole).  Under ``fsdp`` x ``tensor`` a model's block is cut along
    its ``fsdp`` dim too and ``full`` is the model's own parameters (its
    marked tensor blocks and whole leaves), which the step gathers the
    ``fsdp`` parts into.  On lines of one rank nothing is cut, and a
    ``seq`` axis cuts no leaf.  ``seq`` may not be beside ``fsdp``,
    ``expert`` beside ``fsdp`` or ``seq``, and ``pipe`` runs beside
    ``data`` alone (``parallel/sharding.py``)."""
    sharding_lib.check_mesh(mesh)
    params = state.params
    if isinstance(params, sharding_lib.ShardedDict):
        raise ValueError("the state is sharded already")
    marked = {n: sharding_lib.marked_shard(p) for n, p in params.items()}
    for n in params:
        stage = rules.stage_for(n)
        if stage is not None and mesh.axis_size(stage.line) > 1 \
                and marked[n] != stage:
            raise ValueError(f"{n} is layer {stage.layer} of a pipelined "
                             f"stack, marked {marked[n]}: build the model "
                             f"with GPT(config, mesh=) of this mesh")
    layout = {n: marked[n] or sharding_lib.zero_shard(
        tuple(p.shape), rules.spec_for(n), mesh) for n, p in params.items()}
    for n, s in marked.items():
        if s is None and {"tensor", "expert"} & set(
                sharding_lib.lines_of(layout[n])):
            raise ValueError(f"{n} is a whole leaf, but the rules cut it as "
                             f"{layout[n]}: a model computes on its blocks "
                             f"only when built with the mesh (GPT(config, "
                             f"mesh=), Bert(config, mesh), ...)")
        if s is None or isinstance(s, sharding_lib.Stage):
            continue
        want = sharding_lib.zero_shard(s.full_shape(params[n].shape),
                                       rules.spec_for(n), mesh)
        # beside a tensor axis the rules also cut the block over fsdp
        if sharding_lib.without(want, "fsdp") != s:
            raise ValueError(f"{n} is a block {s}, but the rules cut it as "
                             f"{want}: build the model and the rules with "
                             f"the same mesh and shard_kv")
        layout[n] = want
    # what this placement cuts of each leaf: a whole leaf's layout, or the
    # fsdp part of a marked block (whose start along its own dim is the
    # whole leaf's, the block being whole along it)
    cuts = {n: layout[n] if marked[n] is None
            else sharding_lib.part_on(layout[n], "fsdp") for n in params}
    names = set(params)

    def take(n, t):
        if cuts[n] is None:
            return t
        block = cuts[n].take(t)
        if "fsdp" not in sharding_lib.lines_of(cuts[n]):
            block.requires_grad_(t.requires_grad)
        return block

    def place(sub):
        if isinstance(sub, dict) and names and set(sub) == names:
            same = {n: tuple(sub[n].shape) == tuple(params[n].shape)
                    for n in sub}
            return sharding_lib.ShardedDict(
                {n: take(n, t) if same[n] else t for n, t in sub.items()},
                {n: layout[n] if same[n] else None for n in sub}, mesh)
        if isinstance(sub, dict):
            return {k: place(v) for k, v in sub.items()}
        if isinstance(sub, opt_lib.OptState):
            return opt_lib.OptState(sub.count, place(sub.inner))
        if isinstance(sub, EMAState):
            return sub._replace(shadow=place(sub.shadow))
        return sub

    blocks = {n: take(n, p) for n, p in params.items()}
    # the model computes on its blocks (tensor, expert) or its stage
    # (pipe), into which a ZeRO cut beside them gathers
    lines = {a for s in layout.values() for a in sharding_lib.lines_of(s)}
    own = bool(lines & {"tensor", "expert", "pipe"}) and "fsdp" not in lines
    shards = sharding_lib.ShardedDict(blocks, layout, mesh,
                                      full=dict(blocks) if own else params)
    return state._replace(params=shards, opt_state=place(state.opt_state))


def gather_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """The parameters eval and ``generate`` read, of a training state:
    under a ZeRO layout every rank gathers its blocks into the model's own
    whole tensors (one all-gather over the ``fsdp`` line; every rank must
    call), beside a ``tensor`` axis into the model's tensor blocks; under
    a tensor-parallel layout the blocks themselves; under an
    expert-parallel one every MoE bank whole along its expert dim (one
    all-gather over the ``expert`` line: new tensors), so on ``data`` x
    ``expert`` the whole model, which a model built without the mesh
    loads, and on ``expert`` x ``tensor`` a tensor-parallel model's
    blocks; under a pipeline stage's the whole model's parameters on
    every rank (one all-gather over the ``pipe`` line: this rank's
    tensors and copies of the other stages' layers), which a model built
    without the pipeline loads (``load_state_dict``); otherwise
    ``state.params``."""
    params = state.params
    if not isinstance(params, sharding_lib.ShardedDict):
        return params
    if params.line == "pipe":
        return dp_lib.gather_stages(params, params.layout, params.mesh)
    if "expert" in (params.line or ""):
        return dp_lib.gather_shards(params, params.layout, params.mesh,
                                    axis="expert")
    return _compute_params(params)


def _compute_params(params) -> Dict[str, torch.Tensor]:
    """The tensors a step computes on, of a ``ShardedDict`` of parameters:
    the whole leaves gathered in place under ZeRO (beside a ``tensor``
    axis the model's tensor blocks, from their ``fsdp`` parts: one
    all-gather over the ``fsdp`` line either way), the blocks or the
    stage themselves under tensor or pipeline parallelism."""
    if "fsdp" in (params.line or ""):
        dp_lib.gather_shards(params, params.layout, params.mesh,
                             out=params.full)
    return dict(params.full)


def _replica(mesh) -> Optional[int]:
    """The replica folded into the dropout generator: this rank's index
    over ``data``, ``fsdp`` and ``seq`` (row-major), every axis but
    ``pipe``, ``expert`` and ``tensor``, so a pipe line, an expert line
    and a tensor line each draw one stream; None (the stream of a step
    without a mesh) when those axes hold one replica."""
    if mesh is None or mesh.group is None or all(
            mesh.axis_size(a) == 1 for a in ("data", "fsdp", "seq")):
        return None
    out = 0
    for a in ("data", "fsdp", "seq"):
        out = out * mesh.axis_size(a) + mesh.axis_index(a)
    return out


def _metric_dict(metric_fns, preds, y) -> Dict[str, torch.Tensor]:
    return {name: metric_lib.get(fn)(preds, y)
            for name, fn in (metric_fns or {}).items()}


def make_train_step(model, loss, optimizer: opt_lib.Optimizer,
                    metric_fns: Optional[Dict[str, Any]] = None,
                    seed: int = 0, mesh=None,
                    grad_clip_norm: Optional[float] = None,
                    accum_steps: int = 1, policy: Any = None,
                    loss_scale: bool = False, device_health: bool = False,
                    skip_nonfinite: bool = False) -> Callable:
    """Build ``step(state, (x, y)) -> (new_state, metrics)`` for a layer
    ``Stack`` (``model.apply``), a loss by name or function
    (``ops.losses.get``) and metrics ``{name: metric}``
    (``ops.metrics.get``), computed on the predictions of the step.

    A thin adapter over ``make_custom_train_step`` (same options);
    ``mesh``: a ``parallel.Mesh``, under which each rank passes its shard
    of the global batch and the gradients, loss and metrics are averaged
    over the ranks (see the module docstring)."""
    loss_value_fn = loss_lib.get(loss)

    def loss_fn(params, model_state, batch, generator, train):
        x, y = batch
        preds, new_model_state = model.apply(params, model_state, x,
                                             train=train, rng=generator)
        metrics = _metric_dict(metric_fns, preds.detach(), y)
        return loss_value_fn(preds, y), (metrics, new_model_state)

    return make_custom_train_step(loss_fn, optimizer, seed=seed, mesh=mesh,
                                  grad_clip_norm=grad_clip_norm,
                                  accum_steps=accum_steps, policy=policy,
                                  loss_scale=loss_scale,
                                  device_health=device_health,
                                  skip_nonfinite=skip_nonfinite)


def make_multi_train_step(model, loss, optimizer: opt_lib.Optimizer,
                          steps_per_call: int,
                          metric_fns: Optional[Dict[str, Any]] = None,
                          seed: int = 0, mesh=None,
                          grad_clip_norm: Optional[float] = None,
                          accum_steps: int = 1, policy: Any = None,
                          loss_scale: bool = False) -> Callable:
    """``step(state, (xs, ys)) -> (state, metrics)`` running
    ``steps_per_call`` updates over a group whose leaves carry a leading
    ``[K]`` dim; every metric comes back stacked to ``[K]`` (device
    tensors).  The updates are the single step's, K times in order, so
    the result equals K calls of ``make_train_step``'s step."""
    inner = make_train_step(model, loss, optimizer, metric_fns=metric_fns,
                            seed=seed, mesh=mesh,
                            grad_clip_norm=grad_clip_norm,
                            accum_steps=accum_steps, policy=policy,
                            loss_scale=loss_scale)

    def multi(state: TrainState, batch):
        xs, ys = batch
        if xs.shape[0] != steps_per_call or ys.shape[0] != steps_per_call:
            raise ValueError(f"a group of {xs.shape[0]} batches for "
                             f"steps_per_call={steps_per_call}")
        rows = []
        for k in range(steps_per_call):
            state, m = inner(state, (xs[k], ys[k]))
            rows.append(m)
        return state, {name: torch.stack([m[name] for m in rows])
                       for name in rows[0]}

    return multi


def _eval_forward(model, pol, state: TrainState, x):
    """The eval-mode predictions, shared by the plain and masked eval
    steps: the model state seen through a loss scale, the policy's casts
    in and out."""
    model_state = state.model_state
    if isinstance(model_state, prec_lib.LossScaled):
        model_state = model_state.model_state
    params = state.params
    if pol is not None:
        params, x = pol.cast_to_compute(params), pol.cast_to_compute(x)
    preds, _ = model.apply(params, model_state, x, train=False)
    if pol is not None:
        preds = pol.cast_to_output(preds)
    return preds


def make_eval_step(model, loss, metric_fns: Optional[Dict[str, Any]] = None,
                   mesh=None, policy: Any = None) -> Callable:
    """Build ``eval_step(state, (x, y)) -> metrics``: the forward in eval
    mode (dropout off), no gradients, ``loss`` and the metrics as device
    tensors.  ``policy`` casts parameters and inputs to the compute dtype
    and the predictions to the output dtype, as the train builders do.
    ``mesh`` is accepted for the JAX signature and unused: every rank
    evaluates the batch it is given."""
    del mesh
    loss_fn = loss_lib.get(loss)
    pol = prec_lib.policy(policy) if policy is not None else None

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        x, y = batch
        preds = _eval_forward(model, pol, state, x)
        return {"loss": loss_fn(preds, y), **_metric_dict(metric_fns, preds,
                                                            y)}

    return eval_step


def per_example(fn, preds, y) -> torch.Tensor:
    """``fn`` (a loss or metric of a batch) on each example's own
    ``[1, ...]`` slice: a ``[batch]`` tensor (``torch.func.vmap``, as the
    JAX package ``jax.vmap``s it)."""
    return torch.func.vmap(lambda p, t: fn(p[None], t[None]))(preds, y)


def make_masked_eval_step(model, loss,
                          metric_fns: Optional[Dict[str, Any]] = None,
                          policy: Any = None) -> Callable:
    """``eval_step(state, (x, y, w)) -> metrics`` with a per-example
    validity weight ``w`` ([batch] float, 1 real, 0 padding): each loss
    and metric computed per example, then averaged with the weights
    (``sum(per * w) / max(sum(w), 1)``), so padded rows drop out of the
    means."""
    pol = prec_lib.policy(policy) if policy is not None else None
    fns = {"loss": loss_lib.get(loss),
           **{name: metric_lib.get(fn)
              for name, fn in (metric_fns or {}).items()}}

    @torch.no_grad()
    def masked_eval_step(state: TrainState, batch):
        x, y, w = batch
        preds = _eval_forward(model, pol, state, x)
        out = {}
        for name, fn in fns.items():
            per = per_example(fn, preds, y)
            wf = w.to(per.dtype)
            out[name] = torch.sum(per * wf) / torch.clamp(torch.sum(wf),
                                                          min=1.0)
        return out

    return masked_eval_step


def _global_stats(grads: Mapping[str, torch.Tensor], layout, mesh
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(norm, non-finite count) of a sharded step's gradients over the
    whole model: the cut blocks' squares and counts summed over every
    line that cuts them (one all-reduce a line, which carries the sums of
    each group of leaves cut over it: a leaf cut over ``expert`` and
    ``tensor`` is summed over both, one after the other), each uncut leaf
    counted once."""
    def sums(names):
        zero = torch.zeros((), device=grads[names[0]].device)
        return torch.stack([
            sum((torch.sum(torch.square(grads[n].float())) for n in names),
                zero),
            sum((torch.sum(~torch.isfinite(grads[n])).float()
                 for n in names), zero)])
    groups: Dict[Tuple[str, ...], list] = {}
    for n in grads:
        groups.setdefault(tuple(sorted(sharding_lib.lines_of(layout[n]))),
                          []).append(n)
    vals = {key: sums(names) for key, names in groups.items()}
    for line in sorted({a for key in vals for a in key}):
        keys = [key for key in vals if line in key]
        summed = dp_lib.line_sum(torch.stack([vals[k] for k in keys]), mesh,
                                 line)
        vals.update(zip(keys, summed))
    total = sum(vals.values())
    return torch.sqrt(total[0]), total[1]


def make_custom_train_step(loss_fn: Callable, optimizer: opt_lib.Optimizer,
                           seed: int = 0, mesh=None,
                           grad_clip_norm: Optional[float] = None,
                           accum_steps: int = 1,
                           policy: Any = None,
                           loss_scale: bool = False,
                           device_health: bool = False,
                           skip_nonfinite: bool = False) -> Callable:
    """Build ``step(state, batch) -> (new_state, metrics)``.

    ``loss_fn(params, model_state, batch, generator, train) -> (loss,
    (metrics, new_model_state))`` (``GPT.lm_loss_fn()``).  Metrics are
    device tensors: ``loss``, the loss function's own, ``grad_norm``
    (before clipping) when ``grad_clip_norm`` is set.  The state's
    parameters are updated in place; the returned state holds the same
    tensors.

    ``accum_steps > 1``: the batch's leading dim splits into that many
    microbatches, run one after another with f32 gradient accumulators
    and ONE optimizer update.  Every microbatch's gradients, loss and
    metrics are weighted by its ``metrics["loss_weight"]`` (1 without
    that key) and divided by the weights' sum (at least 1e-9), which
    recovers the full batch's masked mean; ``model_state`` threads
    through the microbatches in order.

    ``policy``: a ``precision.Policy`` or its string (``"mixed_bfloat16"``):
    floating parameters and batch tensors are cast to the compute dtype
    inside the differentiated function, so gradients land on the f32
    parameters; loss and metrics leave in the output dtype.

    ``loss_scale=True``: ``state.model_state`` must be wrapped by
    ``precision.attach_loss_scale``; the loss is scaled, the gradients
    unscaled, a non-finite step skipped (see the module docstring) with
    its gradients zeroed first and its loss reported as 0, and the
    adjusted scale threaded on (``metrics["loss_scale"]``,
    ``metrics["grads_finite"]``).  ``skip_nonfinite=True`` skips a step
    whose gradients hold a non-finite element; it cannot be combined
    with ``loss_scale``, which skips already.

    ``device_health=True``: ``grad_norm`` and ``nonfinite_grads`` of the
    (unscaled) gradients (``obs.device.grad_health``), as device tensors;
    the clip's ``grad_norm`` takes precedence.

    ``mesh``: a ``parallel.Mesh``; over a process group, the gradients,
    loss and metrics are averaged over its replicas with one all-reduce
    (weighted by ``metrics["loss_weight"]`` where the loss reports it), a
    ``BatchNorm`` in ``loss_fn`` takes the global batch's moments, and
    the dropout generator is folded with the replica (module docstring).
    A ``tensor`` axis of more than one rank needs a state placed by
    ``shard_train_state``."""
    if skip_nonfinite and loss_scale:
        raise ValueError("loss_scale=True already skips non-finite "
                         "updates; drop skip_nonfinite")
    pol = prec_lib.policy(policy) if policy is not None else None
    if mesh is not None:
        if any(mesh.axis_size(a) > 1 for a in ("tensor", "expert",
                                                "pipe")):
            sharding_lib.check_mesh(mesh)
    dp = mesh if mesh is not None and mesh.group is not None else None
    replica = _replica(dp)
    moments = (functools.partial(dp_lib.cross_rank_moments, dp)
               if dp is not None and dp.size > 1 else contextlib.nullcontext)

    def grad_of(params, model_state, batch, gen, ls):
        names = list(params)
        p, mb = params, batch
        if pol is not None:
            p = pol.cast_to_compute(params)
            mb = pol.cast_to_compute(batch)
        with moments():
            loss, (metrics, new_model_state) = loss_fn(p, model_state, mb,
                                                       gen, True)
        value = loss if ls is None else ls.scale(loss)
        leaves = [params[n] for n in names]
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
        # a parameter the loss does not read (BERT's pooler under the MLM
        # loss) gets a zero gradient, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                new_model_state, dict(zip(names, grads)))

    def accumulate(state, params, model_state, batch, device, ls):
        grads = loss_sum = metrics_sum = w_sum = None
        has_weight = False
        for i, mb in enumerate(_microbatches(batch, accum_steps)):
            gen = _step_generator(seed, state.step, device, i, replica)
            loss, metrics, model_state, g = grad_of(params, model_state, mb,
                                                    gen, ls)
            has_weight = "loss_weight" in metrics
            w = metrics.pop("loss_weight", None)
            w = (torch.ones((), device=device) if w is None
                 else w.to(torch.float32))
            if grads is None:
                grads = {k: v * w for k, v in g.items()}
                loss_sum, w_sum = loss * w, w
                metrics_sum = {k: v * w for k, v in metrics.items()}
                continue
            for k, v in g.items():
                grads[k].add_(v * w)
            loss_sum = loss_sum + loss * w
            metrics_sum = {k: metrics_sum[k] + v * w
                           for k, v in metrics.items()}
            w_sum = w_sum + w
        inv = 1.0 / torch.clamp(w_sum, min=1e-9)
        for g in grads.values():
            g.mul_(inv)
        metrics = {k: v * inv for k, v in metrics_sum.items()}
        if has_weight:
            metrics["loss_weight"] = w_sum
        return loss_sum * inv, metrics, model_state, grads

    def zero_of(state: TrainState):
        """The state's ``ShardedDict`` of parameters, checked against the
        step's mesh, or None for a plain state."""
        zero = state.params
        if not isinstance(zero, sharding_lib.ShardedDict):
            for axis in ("tensor", "expert", "pipe"):
                if mesh is not None and mesh.axis_size(axis) > 1:
                    raise ValueError(
                        f"a step over a {axis} axis of "
                        f"{mesh.axis_size(axis)} ranks needs the state "
                        "placed by train.shard_train_state(state, mesh, "
                        "model.partition_rules())")
            return None
        if zero.cut:
            if mesh is None or mesh.shape != zero.mesh.shape \
                    or mesh.rank != zero.mesh.rank:
                raise ValueError(
                    f"a ZeRO state cut over {zero.mesh} needs "
                    f"make_custom_train_step(mesh=) of that mesh; got "
                    f"{mesh}")
            if not optimizer.elementwise:
                raise NotImplementedError(
                    "an optimizer that reduces over each tensor (lamb, "
                    "adafactor) over a cut ZeRO layout: its blocks would "
                    "see their own norms, not the tensor's")
        return zero

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        zero = zero_of(state)
        params = state.params if zero is None else _compute_params(zero)
        cut = zero is not None and zero.cut
        zero_cut = cut and "fsdp" in zero.line
        seen = {}

        def stats(g):
            """``_global_stats`` of ``g``, once per gradient dict."""
            if id(g) not in seen:
                seen[id(g)] = _global_stats(g, zero.layout, dp)
            return seen[id(g)]

        def all_finite(g):
            return stats(g)[1] == 0 if cut else prec_lib.all_finite(g)

        def grad_health(g):
            if not cut:
                return obs_device.grad_health(g)
            norm, bad = stats(g)
            return {obs_device.GRAD_NORM_KEY: norm,
                    obs_device.NONFINITE_KEY: bad}

        device = next(iter(params.values())).device
        if loss_scale:
            if not isinstance(state.model_state, prec_lib.LossScaled):
                raise TypeError(
                    "loss_scale=True needs state.model_state wrapped by "
                    "precision.attach_loss_scale(state, loss_scale)")
            model_state_in = state.model_state.model_state
            ls = state.model_state.loss_scale
        else:
            model_state_in, ls = state.model_state, None

        if accum_steps == 1:
            loss, metrics, new_model_state, grads = grad_of(
                params, model_state_in, batch,
                _step_generator(seed, state.step, device, None, replica), ls)
        else:
            loss, metrics, new_model_state, grads = accumulate(
                state, params, model_state_in, batch, device, ls)
        if zero_cut:
            weight = metrics.pop("loss_weight", None)
            grads, loss, metrics = dp_lib.reduce_scatter_mean(
                grads, loss, metrics, zero.layout, dp, weight)
        elif dp is not None:
            weight = metrics.pop("loss_weight", None)
            grads, loss, metrics = dp_lib.all_reduce_mean(grads, loss,
                                                          metrics, dp,
                                                          weight)
        apply = True
        if ls is not None:
            grads = ls.unscale(grads)
            finite = all_finite(grads)
            new_ls = ls.adjust(finite)
            apply = bool(finite)            # the one host sync
            if not apply:
                grads = {k: torch.zeros_like(g) for k, g in grads.items()}
        if pol is not None:
            loss = pol.cast_to_output(loss)
            metrics = pol.cast_to_output(metrics)
        metrics = {"loss": loss, **metrics}
        if device_health:
            for k, v in grad_health(grads).items():
                metrics.setdefault(k, v)
        if skip_nonfinite:
            sn_finite = all_finite(grads)
            apply = bool(sn_finite)         # the one host sync
            metrics["grads_finite"] = sn_finite
        if grad_clip_norm is not None:
            grads, gnorm = opt_lib.clip_by_global_norm(
                grads, grad_clip_norm, norm=stats(grads)[0] if cut else None)
            metrics["grad_norm"] = gnorm
        # the update runs on the blocks (the parameters themselves when
        # the state is plain, tensor-parallel, a pipeline stage's or on a
        # line of one rank)
        own = params if zero is None else zero
        if apply:
            updates, new_opt_state = optimizer.update(grads, state.opt_state,
                                                      own)
            opt_lib.apply_updates(own, updates)
        else:
            new_opt_state, new_model_state = state.opt_state, model_state_in
        if ls is not None:
            if not apply:
                metrics["loss"] = torch.zeros_like(metrics["loss"])
            metrics["grads_finite"] = finite
            metrics["loss_scale"] = new_ls.scale_value
            new_model_state = prec_lib.LossScaled(new_model_state, new_ls)
        return TrainState(step=state.step + 1, params=own,
                          opt_state=new_opt_state,
                          model_state=new_model_state), metrics

    return step


def make_1f1b_train_step(model, optimizer: opt_lib.Optimizer, seed: int = 0,
                         grad_clip_norm: Optional[float] = None) -> Callable:
    """``step(state, batch) -> (new_state, metrics)`` whose gradients come
    from the model's hand-scheduled 1F1B pipeline pass
    (``model.lm_1f1b_value_and_grad(params, batch, generator, train)``:
    ``models.gpt.GPT`` with ``pipeline_stages > 1``), at most ``min(M,
    2S - 1)`` stashed stage inputs a rank instead of the GPipe path's M
    microbatches' activations.  Metrics: ``loss`` and, with
    ``grad_clip_norm``, ``grad_norm`` (before clipping), as the JAX
    package's.  The state is placed by ``shard_train_state`` on the
    model's mesh (a plain state on a mesh of one); the dropout generator
    is the custom step's, the gradients and loss are averaged over the
    ``data`` line (weighted by the ``loss_mask`` count when the batch has
    one), the norm is global over the ``pipe`` line, and Adam runs on the
    rank's own leaves."""
    mesh = model.mesh
    dp = mesh if mesh is not None and mesh.group is not None else None
    replica = _replica(dp)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        zero = state.params
        cut = isinstance(zero, sharding_lib.ShardedDict) and zero.cut
        params = (_compute_params(zero)
                  if isinstance(zero, sharding_lib.ShardedDict) else zero)
        device = next(iter(params.values())).device
        loss, grads = model.lm_1f1b_value_and_grad(
            params, batch, _step_generator(seed, state.step, device, None,
                                           replica), True)
        metrics: Dict[str, Any] = {}
        if dp is not None:
            mask = batch.get("loss_mask")
            weight = (None if mask is None
                      else mask.to(device).float().sum())
            grads, loss, metrics = dp_lib.all_reduce_mean(grads, loss, {},
                                                          dp, weight)
            metrics.pop("loss_weight", None)
        metrics = {"loss": loss, **metrics}
        if grad_clip_norm is not None:
            norm = (_global_stats(grads, zero.layout, dp)[0] if cut
                    else None)
            grads, gnorm = opt_lib.clip_by_global_norm(
                grads, grad_clip_norm, norm=norm)
            metrics["grad_norm"] = gnorm
        own = zero if isinstance(zero, sharding_lib.ShardedDict) else params
        updates, new_opt_state = optimizer.update(grads, state.opt_state,
                                                  own)
        opt_lib.apply_updates(own, updates)
        return TrainState(step=state.step + 1, params=own,
                          opt_state=new_opt_state,
                          model_state=state.model_state), metrics

    return step
