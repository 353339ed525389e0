"""Parallelism of the port: the cluster bootstrap over ``torch.distributed``
(``parallel/cluster.py``), the data-parallel mesh (``parallel/mesh.py``)
and the gradient all-reduce (``parallel/data_parallel.py``)."""
from . import cluster, data_parallel, mesh
from .cluster import ClusterConfig, cluster_from_env, initialize, is_chief
from .data_parallel import all_reduce_mean
from .mesh import (Mesh, data_parallel_mesh, data_shards, local_batch_size,
                   round_batch_to_mesh)

__all__ = ["cluster", "data_parallel", "mesh", "ClusterConfig",
           "cluster_from_env", "initialize", "is_chief", "all_reduce_mean",
           "Mesh", "data_parallel_mesh",
           "data_shards", "local_batch_size", "round_batch_to_mesh"]
