"""Example entry points of the port, the root ``examples/`` scripts'
counterparts: ``python -m distributed_tensorflow_tpu_torch.examples.
finetune_bert``, ``.train_vit``, ``.serve_gpt`` and ``.finetune_gpt2_hf``,
with those scripts' flags, data and printed lines, on the card unless
``--device=cpu``."""
import numpy as np


def local_rows(tree, mesh):
    """This rank's share of a global batch (numpy arrays with the batch
    leading): the ``mesh.data_index``-th of the mesh's data shards, equal
    slices, as the JAX scripts' ``device_put`` onto ``P("data")`` hands
    each device its own (every rank of a ``tensor`` line takes the same
    rows)."""
    from ..parallel import data_shards
    shards = data_shards(mesh)

    def part(a):
        n = a.shape[0] // shards
        return np.ascontiguousarray(a[mesh.data_index * n:
                                      (mesh.data_index + 1) * n])
    if isinstance(tree, dict):
        return {k: part(v) for k, v in tree.items()}
    return type(tree)(part(v) for v in tree)
