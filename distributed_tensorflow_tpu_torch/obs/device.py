"""Device-health reductions of a training step, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/obs/device.py`` (``grad_health``
and ``tree_bytes``).  ``grad_health`` computes the global gradient L2 norm
and the count of non-finite gradient elements as 0-d device tensors; the
step builder puts them in its metrics, and nothing reads them back to the
host until a hook does.  ``live_arrays_bytes`` is the device-memory-leak
gauge ``MetricsExportHook`` exports: where the JAX package totals the
buffers of ``jax.live_arrays()``, the port reads the same total from the
caching allocator, ``torch.cuda.memory_allocated`` (the bytes of live
tensors; the allocator's cached free blocks are not counted).

``device_busy`` runs a function under ``torch.profiler`` and sums the
device time of the kernels and copies it ran: divided by the wall time
of the same work run without the profiler, that is the card's busy share
(the profiler's own host cost stretches the profiled run's wall time,
not its device time).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import torch

__all__ = ["device_busy", "grad_health", "tree_bytes", "live_arrays_bytes",
           "GRAD_NORM_KEY", "NONFINITE_KEY"]

# the metric keys the step builder emits, as in the JAX package
GRAD_NORM_KEY = "grad_norm"
NONFINITE_KEY = "nonfinite_grads"


def grad_health(grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``{grad_norm, nonfinite_grads}`` of a dict of gradients: the norm
    in f32 whatever their type (bf16 squares overflow at ~2e19), the count
    as f32."""
    leaves = list(grads.values())
    if not leaves:
        zero = torch.zeros(())
        return {GRAD_NORM_KEY: zero, NONFINITE_KEY: zero}
    sq = sum(torch.sum(torch.square(g.float())) for g in leaves)
    bad = sum(torch.sum(~torch.isfinite(g)) for g in leaves)
    return {GRAD_NORM_KEY: torch.sqrt(sq),
            NONFINITE_KEY: bad.to(torch.float32)}


def tree_bytes(tree: Any) -> int:
    """Bytes of the tensors and arrays in a tree of dicts, lists, tuples
    and NamedTuples (from shapes and types only; no device access)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    nbytes = getattr(tree, "nbytes", None)
    return int(nbytes) if nbytes is not None and hasattr(tree, "shape") \
        else 0


def live_arrays_bytes(device=None) -> int:
    """Bytes of the live tensors on ``device`` (default: the current
    card): ``torch.cuda.memory_allocated``, the port's counterpart of
    totalling ``jax.live_arrays()``.  A host-side read of the allocator's
    counter (no device sync).  0 in a process that has not initialised
    CUDA: a run on the CPU holds no device memory."""
    if not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.memory_allocated(device))


def device_busy(fn: Callable[[], Any]) -> Tuple[Any, float, int]:
    """(fn's result, the seconds the card spent in kernels and copies
    while it ran, how many it ran): one run of ``fn`` under
    ``torch.profiler`` with CUDA activity, ended by a synchronize."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy_us, count = 0.0, 0
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us > 0:
            busy_us += us
            count += e.count
    return out, busy_us / 1e6, count
