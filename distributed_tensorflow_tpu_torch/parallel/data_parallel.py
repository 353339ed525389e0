"""Synchronous data parallelism: the gradient all-reduce.

Counterpart of ``distributed_tensorflow_tpu/parallel/data_parallel.py``
(``make_psum_train_step``): each rank computes the mean gradients of its
shard of the global batch; ONE all-reduce (``torch.distributed``, NCCL on
the cards, gloo on the CPU) of a flat f32 bucket holding every gradient,
the loss and the metrics sums them, and a division by the rank count
makes the mean, the ``lax.pmean`` of the JAX spelling.  Every rank then
applies the same update, so the parameters stay equal without a
parameter server.  With equal shards the mean of the ranks' means is the
global batch's mean.

In the port the JAX package's two spellings, ``make_train_step(mesh=
...)`` and ``make_psum_train_step``, are one path, the first:
``train/step.py`` calls ``all_reduce_mean`` when its mesh has a process
group.

Weighted losses: a loss function that reports ``metrics["loss_weight"]``
(a masked mean's normaliser, such as the token or mask count) is a
weighted mean, and the global batch's is ``sum_d w_d L_d / sum_d w_d``,
not the mean of the ranks' means, which differs as soon as the ranks'
mask counts do.  So each rank's gradients, loss and metrics go into the
bucket times its weight, the weight itself rides along, and the sums are
divided by the summed weight: the exact global-batch mean, as the JAX
step computes it on the whole batch.

Sequence parallelism (a mesh with a ``seq`` axis of R ranks) needs
nothing of its own here: the ops that cross between a rank's sequence
shard and what the line holds alike scale their gradients by R
(``parallel/ring.py``), so every rank's gradient is R times the line's
on the shard's part and the line's whole after a gather, and a model
reports its share of the line's weight (``ring.weight_share``).  The
plain (or weighted) mean over all the mesh's ranks is then the global
batch's, for a loss on the shards' sums and a loss on a gathered output
alike.

``LAUNCHES["all_reduce"]`` counts the all-reduces issued.
"""
from __future__ import annotations

import collections
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["LAUNCHES", "all_reduce_mean"]

LAUNCHES: collections.Counter = collections.Counter()


def all_reduce_mean(grads: Mapping[str, torch.Tensor], loss: torch.Tensor,
                    metrics: Mapping[str, torch.Tensor], mesh,
                    weight: Optional[torch.Tensor] = None
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                               Dict[str, torch.Tensor]]:
    """(grads, loss, metrics), each the global batch's mean over the ranks
    of ``mesh.group``, with one all-reduce of a flat f32 bucket; every
    tensor comes back in its own shape and dtype.  ``weight``: this
    rank's loss weight (module docstring), None for a plain mean; with
    it, ``metrics["loss_weight"]`` comes back as the global weight."""
    names = list(grads)
    keys = list(metrics)
    parts = ([grads[n] for n in names] + [loss]
             + [metrics[k] for k in keys])
    flat = torch.cat([t.reshape(-1).float() for t in parts])
    if weight is not None:
        w = weight.reshape(1).float()
        flat = torch.cat([flat * w, w])
    dist.all_reduce(flat, group=mesh.group)
    LAUNCHES["all_reduce"] += 1
    if weight is None:
        total = flat.new_full((1,), float(mesh.size))
    else:
        total, flat = torch.clamp(flat[-1:], min=1e-9), flat[:-1]
    flat = flat / total
    out, lo = [], 0
    for t in parts:
        out.append(flat[lo:lo + t.numel()].view(t.shape).to(t.dtype))
        lo += t.numel()
    metrics = dict(zip(keys, out[len(names) + 1:]))
    if weight is not None:
        metrics["loss_weight"] = total.reshape(())
    return dict(zip(names, out[:len(names)])), out[len(names)], metrics
