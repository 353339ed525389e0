"""Pipeline parallelism: microbatched stages over a ``pipe`` mesh axis.

Counterpart of ``distributed_tensorflow_tpu/parallel/pipeline.py``, with
its four names: ``stack_pipeline_params``, ``pipeline_rules_spec``,
``pipeline_apply`` (GPipe) and ``pipeline_value_and_grad`` (the
hand-scheduled 1F1B).  Each rank of the ``pipe`` line holds one stage;
a stage maps activations of one shape to activations of the same shape
(``stage_fn(stage_params, acts) -> acts``), so embeddings run before the
pipeline and a head inside the loss, as in the JAX package.

Stacked parameters.  A leaf either leads with the stage count (the whole
stack: this rank takes its row, as ``shard_map`` hands a device its
slice, and autograd gives that row its gradient) or, on a line of more
than one rank, leads with 1: this rank's block of it (what
``parallel.shard_pytree`` cuts under ``pipeline_rules_spec``).

The schedules run on the ranks of the line, not in lockstep: the JAX
package runs every stage on every tick and masks the result, and here a
rank runs only the sub-ticks that are active for it.

* GPipe (``pipeline_apply``): stage ``s`` forwards microbatch ``m`` at
  tick ``m + s``; the last stage's outputs are broadcast to every rank of
  the line.  The backward (``_GPipe``, an ``autograd.Function``) runs the
  reverse schedule by hand: stage ``s`` takes microbatch ``M - 1 - m``'s
  cotangent at tick ``m + S - 1 - s``, so every rank walks its
  exchanges in an order its partners share (autograd's own order over
  differentiable exchanges is not promised to match across ranks).  The
  forward keeps each microbatch's graph: activation memory grows with M.
  Stage 0's input cotangent is broadcast, so every rank returns the
  gradient of ``x``, as the JAX package's transpose of a replicated
  input sums it over the line.
* 1F1B (``pipeline_value_and_grad``): stage ``s`` forwards microbatch
  ``m`` at tick ``m + s`` and backwards it at tick ``m + 2(S-1) - s``,
  ``M + 2S - 2`` ticks.  A stage keeps at most ``min(M, 2S - 1)`` stage
  inputs; its backward recomputes the stage from the stashed input,
  replaying the dropout generator's state of the forward it recomputes
  (as ``torch.utils.checkpoint`` does with ``preserve_rng_state``).  The
  last stage forwards a microbatch only in its backward sub-tick (its
  forward output goes nowhere), computes the loss there, and seeds the
  cotangent with the microbatch's weight.  The loss and the gradients of
  ``aux_params`` are broadcast from the last stage, ``dx`` from the
  first.

Exchanges.  Each tick's sends and receives go in ONE
``batch_isend_irecv`` (activations forward, cotangents backward), worked
out from the schedule on both sides, so every send meets its receive and
stages 0 and 1 cannot deadlock in 1F1B.  The activation dtype (the JAX
package's ``result_type(x.dtype, stage output)``) is learned by stage 0
from its first microbatch and broadcast over the line once a call.
Under gloo a CUDA tensor is staged through a pinned host buffer for
each send and receive (gloo's ``send``/``recv`` take CPU tensors only);
under NCCL nothing is staged.  The broadcasts run on the tensors where
they lie (f32 buckets).  A line of one rank runs the stages in order
with no exchange.

``LAUNCHES`` counts the line's traffic: ``"p2p"`` (one
``batch_isend_irecv``), ``"p2p_host"`` (each staged host copy of a sent
or received tensor) and ``"broadcast"``.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


__all__ = ["LAUNCHES", "pipeline_apply", "pipeline_rules_spec",
           "pipeline_value_and_grad", "stack_pipeline_params"]

LAUNCHES: collections.Counter = collections.Counter()

# the dtypes an activation may take, by code (the first-stage broadcast)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


# -- trees ------------------------------------------------------------------

def _flatten(tree) -> Tuple[List[Any], Callable]:
    """(leaves, rebuild) of a tree of dicts (keys sorted), lists, tuples
    and leaves; ``rebuild(leaves)`` makes the same structure again."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new):
        out, lo = [], 0
        for (_, sub), n in zip(parts, sizes):
            out.append(sub(new[lo:lo + n]))
            lo += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)
    return leaves, rebuild


def stack_pipeline_params(stage_params: Sequence[Any]):
    """Stack per-stage parameter trees (one structure and shapes) on a new
    leading stage dim."""
    flat = [_flatten(p) for p in stage_params]
    rebuild = flat[0][1]
    return rebuild([torch.stack(leaves) for leaves in
                    zip(*(f[0] for f in flat))])


def pipeline_rules_spec(stacked_params, axis: str = "pipe"):
    """The same tree with the spec ``(axis,)`` at every leaf: the leading
    stage dim over the ``pipe`` axis (``parallel.shard_pytree`` cuts each
    rank's ``[1, ...]`` block by it)."""
    leaves, rebuild = _flatten(stacked_params)
    return rebuild([(axis,)] * len(leaves))


# -- the line ---------------------------------------------------------------

class _Line:
    """The ``axis`` line of ``mesh``: its size, this rank's index, its
    group (None for a line of one), the global ranks of its members and
    whether its backend is gloo."""

    def __init__(self, mesh, axis: str):
        self.size = mesh.axis_size(axis)
        self.index = mesh.axis_index(axis)
        self.group = mesh.axis_group(axis)
        self.ranks = ([dist.get_global_rank(self.group, i)
                       for i in range(self.size)]
                      if self.group is not None else [0])
        self.gloo = (self.group is not None
                     and dist.get_backend(self.group) == "gloo")
        self.first = self.index == 0
        self.last = self.index == self.size - 1


def _exchange(line: _Line, sends, recvs) -> List[torch.Tensor]:
    """One tick's exchange in one ``batch_isend_irecv``: ``sends`` [(tensor,
    line index, tag)], ``recvs`` [(shape, dtype, device, line index,
    tag)]; returns the received tensors.  Nothing is issued when both
    are empty."""
    if not sends and not recvs:
        return []
    ops, bufs, staged = [], [], []
    for t, dst, tag in sends:
        t = t.contiguous()
        if line.gloo and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            LAUNCHES["p2p_host"] += 1
            t = host
        ops.append(dist.P2POp(dist.isend, t, line.ranks[dst],
                              group=line.group, tag=tag))
    for shape, dtype, device, src, tag in recvs:
        stage = line.gloo and device.type == "cuda"
        buf = (torch.empty(shape, dtype=dtype, pin_memory=True) if stage
               else torch.empty(shape, dtype=dtype, device=device))
        ops.append(dist.P2POp(dist.irecv, buf, line.ranks[src],
                              group=line.group, tag=tag))
        bufs.append(buf)
        staged.append(device if stage else None)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    LAUNCHES["p2p"] += 1
    out = []
    for buf, device in zip(bufs, staged):
        if device is not None:
            buf = buf.to(device)
            LAUNCHES["p2p_host"] += 1
        out.append(buf)
    return out


def _broadcast(parts: List[torch.Tensor], line: _Line, root: int
               ) -> List[torch.Tensor]:
    """``parts`` of line index ``root`` on every rank of the line: one
    broadcast of a flat f32 bucket (the other ranks pass tensors of the
    same shapes, whose values are ignored); each part comes back in its
    own shape and dtype."""
    if line.group is None or not parts:
        return parts
    flat = torch.cat([p.reshape(-1).float() for p in parts])
    dist.broadcast(flat, src=line.ranks[root], group=line.group)
    LAUNCHES["broadcast"] += 1
    out, lo = [], 0
    for p in parts:
        out.append(flat[lo:lo + p.numel()].view(p.shape).to(p.dtype))
        lo += p.numel()
    return out


def _share_dtype(line: _Line, dtype: Optional[torch.dtype],
                 device: torch.device) -> torch.dtype:
    """The activation dtype that stage 0 found, on every rank of the line
    (one broadcast of its code)."""
    if line.group is None:
        return dtype
    code = torch.tensor([_DTYPES.index(dtype) if line.first else 0],
                        dtype=torch.int32, device=device)
    code, = _broadcast([code], line, 0)
    return _DTYPES[int(code.item())]


# -- the stage a rank holds ---------------------------------------------------

def _local_stage(stacked_params, line: _Line, axis: str, what: str):
    """This rank's stage of ``stacked_params`` (the tree with each leaf's
    stage dim dropped): a whole stack's row ``line.index``, or a block's
    only row.  Raises ``ValueError`` when a leaf leads with neither the
    stage count nor (as a block) 1."""
    leaves, rebuild = _flatten(stacked_params)
    leading = {leaf.shape[0] for leaf in leaves}
    if not leading <= {line.size, 1}:
        raise ValueError(
            f"stacked params have leading dim(s) {sorted(leading)} but the "
            f"'{axis}' mesh axis has {line.size} stages{what}")
    return rebuild([leaf[line.index] if leaf.shape[0] == line.size
                    else leaf[0] for leaf in leaves])


def _microbatches(x: torch.Tensor, num_microbatches: int
                  ) -> List[torch.Tensor]:
    if x.shape[0] % num_microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"{num_microbatches} microbatches")
    return list(x.reshape(num_microbatches, x.shape[0] // num_microbatches,
                          *x.shape[1:]).unbind(0))


def _diff_leaves(params) -> Tuple[List[int], List[torch.Tensor], Callable]:
    """(indices of the floating leaves, the leaves, rebuild of the tree
    from all leaves)."""
    leaves, rebuild = _flatten(params)
    idx = [i for i, leaf in enumerate(leaves)
           if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    return idx, leaves, rebuild


def _with(leaves, idx, new):
    out = list(leaves)
    for i, t in zip(idx, new):
        out[i] = t
    return out


@contextlib.contextmanager
def _replay(generator: Optional[torch.Generator], state):
    """Run the body from the generator state ``state`` (None: as it is),
    then put the generator's state back."""
    if generator is None or state is None:
        yield
        return
    now = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(now)


def _first_forward(stage_fn, params, x_mb, generator, x_grad: bool):
    """(activation dtype, stage input, output in that dtype) of stage 0's
    first microbatch: the dtype is ``promote(x.dtype, output dtype)`` of
    the stage run on ``x``'s own dtype, as the JAX package's
    ``eval_shape`` resolves it; where it differs from ``x``'s, the
    microbatch runs again on its input cast to it, from the same
    generator state.  Runs under the caller's grad mode; the input is a
    leaf that requires grad when ``x_grad``."""
    state = None if generator is None else generator.get_state()
    xin = x_mb.detach().requires_grad_(x_grad)
    out = stage_fn(params(), xin)
    act = torch.promote_types(x_mb.dtype, out.dtype)
    if act != x_mb.dtype:
        if generator is not None:
            generator.set_state(state)
        xin = x_mb.detach().to(act).requires_grad_(x_grad)
        out = stage_fn(params(), xin)
    return act, xin, out.to(act)


def _grad_of(out, inputs, g_out=None):
    """``torch.autograd.grad`` of ``out`` for those of ``inputs`` that
    require grad (None in the others' places)."""
    need = [t for t in inputs if t is not None and t.requires_grad]
    got = iter(torch.autograd.grad(out, need, g_out, allow_unused=True)
               if need else ())
    return [next(got) if t is not None and t.requires_grad else None
            for t in inputs]


# -- GPipe --------------------------------------------------------------------

class _GPipe(torch.autograd.Function):
    """The GPipe schedule as one op: ``x`` and this rank's floating stage
    leaves in, the last stage's outputs (on every rank of the line) out;
    the backward runs the reverse schedule (module docstring)."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        line, M, stage_fn = run["line"], run["M"], run["stage_fn"]
        s, S = line.index, line.size
        mbs = _microbatches(x, M)
        det = [t.detach().requires_grad_(t.requires_grad) for t in leaves]

        def params():
            return run["params_of"](det)
        mode = torch.enable_grad if run["grad"] else torch.no_grad
        x_grad = run["grad"] and run["x_grad"]
        # stage 0 finds the activation dtype on its first microbatch; the
        # others wait for its broadcast before their first receive
        act = None if s == 0 else _share_dtype(line, None, x.device)
        graphs: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = \
            [None] * M
        outs: List[torch.Tensor] = []
        pending = None                # the output to send this tick
        for t in range(M + S - 1):
            m = t - s
            active = 0 <= m < M
            sends = [(pending, s + 1, 0)] if pending is not None else []
            pending = None
            recvs = ([(mbs[0].shape, act, x.device, s - 1, 0)]
                     if active and s > 0 else [])
            got = _exchange(line, sends, recvs)
            if not active:
                continue
            with mode():
                if s == 0 and m == 0:
                    act, xin, out = _first_forward(
                        stage_fn, params, mbs[0], run["generator"], x_grad)
                    act = _share_dtype(line, act, x.device)
                else:
                    src = got[0] if s > 0 else mbs[m].detach().to(act)
                    xin = src.detach().requires_grad_(s > 0 or x_grad)
                    out = stage_fn(params(), xin).to(act)
            if run["grad"]:
                graphs[m] = (xin, out)
            if line.last:
                outs.append(out.detach())
            else:
                pending = out.detach()
        shape = (x.shape[0],) + tuple(mbs[0].shape[1:])
        y = (torch.cat(outs) if line.last
             else torch.empty(shape, dtype=act, device=x.device))
        y, = _broadcast([y], line, S - 1)
        ctx.run, ctx.graphs, ctx.det, ctx.act = run, graphs, det, act
        ctx.x_dtype = x.dtype
        return y

    @staticmethod
    def backward(ctx, g_y):
        run, graphs, det, act = ctx.run, ctx.graphs, ctx.det, ctx.act
        line, M = run["line"], run["M"]
        s, S = line.index, line.size
        want_dx = ctx.needs_input_grad[1]
        g_mbs = _microbatches(g_y.to(act), M) if line.last else None
        acc: List[Optional[torch.Tensor]] = [None] * len(det)
        dx: List[Optional[torch.Tensor]] = [None] * M
        pending = None
        for t in range(M + S - 1):
            m = M - 1 - (t - (S - 1 - s))
            active = 0 <= m < M
            sends = [(pending, s - 1, 1)] if pending is not None else []
            pending = None
            xin, out = graphs[m] if active else (None, None)
            recvs = ([(out.shape, act, out.device, s + 1, 1)]
                     if active and not line.last else [])
            got = _exchange(line, sends, recvs)
            if not active:
                continue
            g_out = g_mbs[m] if line.last else got[0]
            grads = _grad_of(out, [xin] + det, g_out)
            graphs[m] = None
            for i, g in enumerate(grads[1:]):
                if g is not None:
                    acc[i] = g if acc[i] is None else acc[i] + g
            if s > 0:
                pending = grads[0].to(act)
            elif want_dx:
                dx[m] = grads[0]
        g_x = None
        if want_dx:
            g_x = (torch.cat(dx) if line.first
                   else torch.empty(g_y.shape, dtype=act,
                                    device=g_y.device))
            g_x, = _broadcast([g_x], line, 0)
            g_x = g_x.to(ctx.x_dtype)
        return (None, g_x, *[None if a is None else a.to(d.dtype)
                             for a, d in zip(acc, det)])


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params, x: torch.Tensor, mesh,
                   num_microbatches: int, axis: str = "pipe",
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Run ``x`` through the line's stages of ``stage_fn`` as a GPipe
    pipeline.

    ``stage_fn(params_of_one_stage, acts) -> acts`` (same shape in and
    out); ``stacked_params`` as the module docstring says; ``x``
    [batch, ...] on every rank of the line, its batch divisible by
    ``num_microbatches``.  Returns the last stage's outputs [batch, ...]
    in the activation dtype on every rank of the line.  Differentiable:
    every rank computes the same loss of the output, and each rank's
    gradients (its own stage's row, and ``x``) are what ``jax.grad``
    through the JAX package's ``pipeline_apply`` gives.  ``generator``:
    the generator ``stage_fn`` draws dropout from, replayed where stage 0
    runs its first microbatch again at the activation dtype."""
    line = _Line(mesh, axis)
    local = _local_stage(stacked_params, line, axis,
                         " — shard_map would silently drop stages")
    mbs = _microbatches(x, num_microbatches)
    idx, leaves, rebuild = _diff_leaves(local)
    diff = [leaves[i] for i in idx]
    grad = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in diff))
    if line.size == 1:
        # no exchange: the microbatches in order, under plain autograd
        state = None if generator is None else generator.get_state()
        out = stage_fn(local, mbs[0])
        act = torch.promote_types(x.dtype, out.dtype)
        if act != x.dtype:
            if generator is not None:
                generator.set_state(state)
            out = stage_fn(local, mbs[0].to(act))
        return torch.cat([out.to(act)] + [stage_fn(local, mb.to(act)).to(act)
                                          for mb in mbs[1:]])
    run = {"line": line, "M": num_microbatches, "stage_fn": stage_fn,
           "generator": generator, "grad": grad,
           "x_grad": x.requires_grad,
           "params_of": lambda new: rebuild(_with(leaves, idx, new))}
    return _GPipe.apply(run, x, *diff)


# -- 1F1B ---------------------------------------------------------------------

def pipeline_value_and_grad(stage_fn: Callable[[Any, torch.Tensor],
                                               torch.Tensor],
                            loss_fn: Callable, stacked_params,
                            x: torch.Tensor, y, mesh,
                            num_microbatches: int, axis: str = "pipe",
                            aux_params: Any = None, with_dx: bool = False,
                            microbatch_weights: Any = None,
                            generator: Optional[torch.Generator] = None):
    """The hand-scheduled 1F1B training pass -> ``(loss, grads[,
    aux_grads][, dx])``, the JAX package's contract.

    ``loss_fn(out_mb, y_mb)`` (``loss_fn(aux_params, out_mb, y_mb)`` with
    ``aux_params``) is a microbatch's mean; the loss is the weighted sum
    over microbatches (``microbatch_weights`` [M] summing to 1; uniform
    1/M when None) and ``grads`` its gradient for this rank's stage, in
    ``stacked_params``' structure and shapes (a whole stack's other rows
    zero, as autograd through the row would give them).  ``y`` is a
    tensor or a tree of tensors sharing the batch dim.  ``aux_grads``
    (the gradients of ``aux_params``, which only the loss reads) and
    ``dx`` (the gradient of ``x``) are the same on every rank of the
    line.  ``generator``: the generator ``stage_fn`` draws dropout from;
    each recompute replays the state its forward started from.  Schedule
    and exchanges: the module docstring."""
    line = _Line(mesh, axis)
    local = _local_stage(stacked_params, line, axis, "")
    M = num_microbatches
    mbs = _microbatches(x, M)
    if microbatch_weights is None:
        weights = torch.full((M,), 1.0 / M, dtype=torch.float32,
                             device=x.device)
    else:
        weights = torch.as_tensor(microbatch_weights, dtype=torch.float32,
                                  device=x.device)
    if tuple(weights.shape) != (M,):
        raise ValueError(
            f"microbatch_weights shape {tuple(weights.shape)} != ({M},) — "
            "clamp-indexing would silently mis-scale the loss")
    y_leaves, y_rebuild = _flatten(y)
    y_mbs = [y_rebuild(parts) for parts in zip(
        *(_microbatches(leaf, M) for leaf in y_leaves))]
    has_aux = aux_params is not None
    s, S = line.index, line.size
    n_slots = min(M, 2 * S - 1)
    idx, leaves, rebuild = _diff_leaves(local)
    det = [leaves[i].detach().requires_grad_(True) for i in idx]
    aux_leaves, aux_rebuild = _flatten(aux_params if has_aux else {})
    aux_det = [a.detach().requires_grad_(True) for a in aux_leaves]
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
           for t in det]
    aux_acc = [torch.zeros(a.shape, dtype=torch.float32, device=a.device)
               for a in aux_det]
    dx: List[Optional[torch.Tensor]] = [None] * M
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    stash: Dict[int, Tuple[torch.Tensor, Any]] = {}
    send_f = send_b = None

    def params():
        return rebuild(_with(leaves, idx, det))

    # stage 0 finds the activation dtype on its first microbatch; the
    # others wait for its broadcast before their first receive
    act = None if s == 0 else _share_dtype(line, None, x.device)
    for t in range(M + 2 * S - 2):
        mf = t - s
        mb = t - 2 * (S - 1) + s
        active_f = 0 <= mf < M
        active_b = 0 <= mb < M
        sends = []
        if send_f is not None:
            sends.append((send_f, s + 1, 0))
        if send_b is not None:
            sends.append((send_b, s - 1, 1))
        send_f = send_b = None
        recvs = []
        if active_f and s > 0:
            recvs.append((mbs[0].shape, act, x.device, s - 1, 0))
        if active_b and not line.last:
            recvs.append((mbs[0].shape, act, x.device, s + 1, 1))
        got = list(_exchange(line, sends, recvs))
        # ---- F: stage s forwards microbatch t - s -----------------------
        if active_f:
            state = None if generator is None else generator.get_state()
            if s == 0 and mf == 0:
                with torch.no_grad():
                    act, xin, out = _first_forward(stage_fn, params, mbs[0],
                                                   generator, False)
                act = _share_dtype(line, act, x.device)
                if line.last and generator is not None:
                    # its backward sub-tick runs the microbatch again
                    generator.set_state(state)
            else:
                xin = got.pop(0) if s > 0 else mbs[mf].to(act)
                if not line.last:
                    with torch.no_grad():
                        out = stage_fn(params(), xin).to(act)
            # the last stage's forward output goes nowhere: its backward
            # sub-tick computes the microbatch, with the live generator
            stash[mf] = (xin.detach(), None if line.last else state)
            if len(stash) > n_slots:
                raise AssertionError(f"{len(stash)} stashed inputs, more "
                                     f"than {n_slots}")
            if not line.last:
                send_f = out
        # ---- B: stage s backwards microbatch t - 2(S-1) + s -------------
        if active_b:
            xin, state = stash.pop(mb)
            x_leaf = xin.requires_grad_(s > 0 or with_dx)
            with _replay(generator, state), torch.enable_grad():
                out = stage_fn(params(), x_leaf).to(act)
                if line.last:
                    y_mb = y_mbs[mb]
                    loss = (loss_fn(aux_rebuild(aux_det), out, y_mb)
                            if has_aux else loss_fn(out, y_mb)).float()
                    grads = _grad_of(loss * weights[mb],
                                     [x_leaf] + det + aux_det)
                    loss_sum = loss_sum + loss.detach() * weights[mb]
                else:
                    grads = _grad_of(out, [x_leaf] + det, got.pop(0))
            for a, g in zip(acc + aux_acc, grads[1:]):
                if g is not None:
                    a.add_(g.float())
            if s > 0:
                send_b = grads[0].to(act)
            elif with_dx:
                dx[mb] = grads[0]
    # the loss and the aux gradients from the last stage, dx from the first
    loss_sum, *aux_acc = _broadcast([loss_sum] + aux_acc, line, S - 1)
    dx_full = None
    if with_dx:
        dx_full = (torch.cat(dx) if line.first
                   else torch.empty(x.shape, dtype=act, device=x.device))
        dx_full, = _broadcast([dx_full], line, 0)
        dx_full = dx_full.to(x.dtype)
    grads = _stage_grads(stacked_params, line, leaves, idx, acc)
    result = (loss_sum, grads)
    if has_aux:
        result += (aux_rebuild([g.to(a.dtype)
                                for g, a in zip(aux_acc, aux_leaves)]),)
    if with_dx:
        result += (dx_full,)
    return result


def _stage_grads(stacked_params, line: _Line, local_leaves, idx, acc):
    """The stage's gradients in ``stacked_params``' structure: a block's
    ``[1, ...]``, a whole stack's ``[S, ...]`` with this rank's row
    filled; a non-floating leaf's zeros."""
    leaves, rebuild = _flatten(stacked_params)
    by_leaf = dict(zip(idx, acc))
    out = []
    for i, leaf in enumerate(leaves):
        g = by_leaf.get(i)
        g = (torch.zeros_like(local_leaves[i]) if g is None
             else g.to(local_leaves[i].dtype))
        if leaf.shape[0] != line.size:
            out.append(g[None])
            continue
        full = torch.zeros_like(leaf)
        full[line.index] = g
        out.append(full)
    return rebuild(out)
