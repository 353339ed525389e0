"""Cluster bootstrap over ``torch.distributed``: env-var topology with a
single-machine fallback.

Counterpart of ``distributed_tensorflow_tpu/parallel/cluster.py`` (the
reference's ``ClusterSpec``/``Server`` scaffolding, example.py:59-68,
108-143).  There is no parameter server: every process runs the same
program, and gradients are averaged with an all-reduce.  The topology
comes from the same environment variables, new style first, the
reference's legacy names honoured:

    new                    legacy
    COORDINATOR_ADDRESS    first host in WORKER_HOSTS
    NUM_PROCESSES          len(WORKER_HOSTS.split(','))
    PROCESS_ID             TASK_INDEX
    (no role)              JOB_NAME -- "ps" is refused

``cluster_from_env`` parses them exactly as the JAX package does (a bad
int falls back to its default with a warning).  ``initialize`` starts a
``torch.distributed`` process group on the coordinator
(``tcp://<COORDINATOR_ADDRESS>``, the rendezvous), with world size
``NUM_PROCESSES`` and rank ``PROCESS_ID``, over NCCL when a card is there
and gloo otherwise, and with a timeout: a rank that never arrives fails
the others instead of hanging them.  It starts a group whenever a
coordinator is known, also for one process (the JAX package starts its
runtime only for two or more): a group of one runs the data-parallel
step, all-reduce included.  With no topology in the environment it does
nothing, the reference's single-machine fallback.

The chief is rank 0 of the group, and the single process without one.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import List, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

__all__ = ["ClusterConfig", "LEGACY_PS_EXIT_CODE", "cluster_from_env",
           "initialize", "is_chief", "process_index", "process_count"]

# A legacy JOB_NAME=ps process under the fleet launcher (DTTPU_LAUNCHER
# set) exits with this code, EX_USAGE of sysexits.h: the configuration
# asked for a role that does not exist here.
LEGACY_PS_EXIT_CODE = 64


@dataclasses.dataclass
class ClusterConfig:
    """Resolved multi-process topology. ``num_processes == 1`` => local."""
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0
    job_name: Optional[str] = None          # legacy role, informational only
    worker_hosts: Optional[List[str]] = None

    @property
    def distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_legacy_ps(self) -> bool:
        return self.job_name == "ps"


def _split_hosts(raw: Optional[str]) -> Optional[List[str]]:
    if not raw:
        return None
    return [h.strip() for h in raw.split(",") if h.strip()]


def cluster_from_env(environ=None) -> ClusterConfig:
    """Resolve the topology from env vars; absent vars => single-machine."""
    env = os.environ if environ is None else environ

    coordinator = env.get("COORDINATOR_ADDRESS")
    workers = _split_hosts(env.get("WORKER_HOSTS"))
    job_name = env.get("JOB_NAME") or None

    def _int(var: str, default: int) -> int:
        raw = env.get(var)
        if raw is None:
            return default
        try:
            return int(raw)
        except ValueError:
            log.warning("env var %s=%r is not an int; using %d", var, raw,
                        default)
            return default

    num_processes = _int("NUM_PROCESSES", len(workers) if workers else 1)
    process_id = _int("PROCESS_ID", _int("TASK_INDEX", 0))

    if coordinator is None and workers:
        # legacy convention: the first worker is the coordinator, so the
        # chief (task 0) is the reference's is_chief=(task_index == 0)
        coordinator = workers[0]

    if coordinator is None:
        return ClusterConfig(job_name=job_name)

    return ClusterConfig(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        job_name=job_name,
        worker_hosts=workers,
    )


def initialize(config: Optional[ClusterConfig] = None,
               backend: Optional[str] = None,
               timeout_s: float = 300.0) -> ClusterConfig:
    """Start the process group of ``config`` (from the environment when
    None); a no-op without a coordinator or when a group exists.

    ``backend``: "nccl" or "gloo"; by default NCCL when a card is there,
    gloo otherwise (the caller picks the card of its rank first, with
    ``torch.cuda.set_device``).  A legacy ``JOB_NAME=ps`` process starts
    nothing: under the fleet launcher (``DTTPU_LAUNCHER`` set) it exits
    ``LEGACY_PS_EXIT_CODE``, so the launcher reports the host instead of
    counting a silent no-op as success; otherwise it warns."""
    if config is None:
        config = cluster_from_env()

    if config.is_legacy_ps:
        if os.environ.get("DTTPU_LAUNCHER"):
            log.error("JOB_NAME=ps refused: there is no parameter-server "
                      "role; exiting %d", LEGACY_PS_EXIT_CODE)
            raise SystemExit(LEGACY_PS_EXIT_CODE)
        log.warning("JOB_NAME=ps ignored: there is no parameter-server role "
                    "(gradients are averaged with an all-reduce). This "
                    "process will not start.")
        return config

    if config.coordinator_address is None or dist.is_initialized():
        return config
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{config.coordinator_address}",
        world_size=config.num_processes, rank=config.process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return config


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_chief() -> bool:
    """The chief writes checkpoints and summaries."""
    return process_index() == 0
