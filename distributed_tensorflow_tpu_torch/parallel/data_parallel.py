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

``LAUNCHES["all_reduce"]`` counts the all-reduces issued.
"""
from __future__ import annotations

import collections
from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist

__all__ = ["LAUNCHES", "all_reduce_mean"]

LAUNCHES: collections.Counter = collections.Counter()


def all_reduce_mean(grads: Mapping[str, torch.Tensor], loss: torch.Tensor,
                    metrics: Mapping[str, torch.Tensor], mesh
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                               Dict[str, torch.Tensor]]:
    """(grads, loss, metrics), each averaged over the ranks of
    ``mesh.group`` with one all-reduce of a flat f32 bucket; every tensor
    comes back in its own shape and dtype."""
    names = list(grads)
    keys = list(metrics)
    parts = ([grads[n] for n in names] + [loss]
             + [metrics[k] for k in keys])
    flat = torch.cat([t.reshape(-1).float() for t in parts])
    dist.all_reduce(flat, group=mesh.group)
    LAUNCHES["all_reduce"] += 1
    flat.div_(mesh.size)
    out, lo = [], 0
    for t in parts:
        out.append(flat[lo:lo + t.numel()].view(t.shape).to(t.dtype))
        lo += t.numel()
    return (dict(zip(names, out[:len(names)])), out[len(names)],
            dict(zip(keys, out[len(names) + 1:])))

