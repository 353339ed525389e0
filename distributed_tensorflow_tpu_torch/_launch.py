"""What every entry point does first: pick this process's device from
its ``--device`` flag and start the process group of its cluster
configuration over it.

``--device=cuda`` (every entry point's default) raises when there is no
card; ``--device=cpu`` is the explicit opt-in.  On a card, rank ``r``
takes card ``r % device_count`` and f32 runs in full f32 precision in
every library (TF32 off for cuBLAS's matmuls and cuDNN's convolutions
alike), the precision the configurations state.  The group runs over
NCCL on cards and gloo on the CPU (``parallel.cluster.initialize``);
``DTTPU_DIST_BACKEND=gloo`` picks gloo on cards too, for ranks that share
one card (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import os

import torch

from .parallel import cluster

__all__ = ["start"]


def start(device_flag: str, config: cluster.ClusterConfig) -> torch.device:
    """This process's device for ``device_flag``; starts ``config``'s
    process group (a no-op without a coordinator)."""
    cuda = device_flag.startswith("cuda")
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda needs a CUDA card; pass "
                           "--device=cpu to run on the CPU")
    if not cuda and device_flag != "cpu":
        raise ValueError(f"--device={device_flag!r}: 'cuda' or 'cpu'")
    if cuda:
        device = torch.device("cuda", config.process_id
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
        torch.set_float32_matmul_precision("highest")   # TF32 off
        torch.backends.cudnn.allow_tf32 = False
    else:
        device = torch.device("cpu")
    backend = os.environ.get("DTTPU_DIST_BACKEND") or (
        "nccl" if cuda else "gloo")
    cluster.initialize(config, backend=backend)
    return device
