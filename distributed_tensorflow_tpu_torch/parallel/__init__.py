"""Parallelism of the port: the cluster bootstrap over ``torch.distributed``
(``parallel/cluster.py``), the named mesh (``parallel/mesh.py``), the
gradient all-reduce and the ZeRO collectives
(``parallel/data_parallel.py``), the partition rules and the ZeRO layout
(``parallel/sharding.py``), tensor parallelism's collectives
(``parallel/tensor_parallel.py``), pipeline parallelism
(``parallel/pipeline.py``) and sequence parallelism: ring
attention (``parallel/ring.py``) and ring-flash attention over the flash
kernels (``parallel/ring_flash.py``)."""
from . import (cluster, data_parallel, mesh, pipeline, ring, ring_flash,
               sharding, tensor_parallel)
from .cluster import ClusterConfig, cluster_from_env, initialize, is_chief
from .data_parallel import all_reduce_mean, make_psum_train_step
from .mesh import (AXIS_ORDER, Mesh, MeshConfig, Placement,
                   data_parallel_mesh, data_shards, local_batch_size,
                   logical_to_mesh, make_mesh, named_sharding, plan_mesh,
                   replicated, round_batch_to_mesh)
from .pipeline import (pipeline_apply, pipeline_rules_spec,
                       pipeline_value_and_grad, stack_pipeline_params)
from .ring import ring_attention, ring_attention_sharded
from .ring_flash import ring_flash_attention, ring_flash_attention_sharded
from .sharding import PartitionRules, prune_spec, shard_pytree, tree_paths

__all__ = ["cluster", "data_parallel", "mesh", "pipeline", "ring",
           "ring_flash",
           "sharding", "tensor_parallel", "PartitionRules", "prune_spec",
           "shard_pytree", "tree_paths",
           "ClusterConfig", "cluster_from_env", "initialize", "is_chief",
           "all_reduce_mean", "make_psum_train_step", "AXIS_ORDER", "Mesh",
           "MeshConfig", "Placement", "data_parallel_mesh", "data_shards",
           "local_batch_size", "logical_to_mesh", "make_mesh",
           "named_sharding", "plan_mesh", "replicated",
           "round_batch_to_mesh",
           "pipeline_apply", "pipeline_rules_spec",
           "pipeline_value_and_grad", "stack_pipeline_params",
           "ring_attention", "ring_attention_sharded",
           "ring_flash_attention", "ring_flash_attention_sharded"]
