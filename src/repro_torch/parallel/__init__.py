"""Distribution: a single-controller device mesh (mesh.py), placements of
tensors on it (placement.py: ``PartitionSpec``, ``NamedSharding``,
``Placed``), the collectives over it and the sequence-parallel Viterbi
decoder (collectives.py), GPipe pipeline parallelism over a stage axis
(pipeline.py), and the LM's sharding helpers (sharding.py)."""
from repro_torch.parallel.mesh import Mesh
from repro_torch.parallel.placement import NamedSharding, PartitionSpec, Placed
from repro_torch.parallel.sharding import (
    batch_axes,
    batch_spec,
    make_rules,
    named_sharding,
    shard_batch_tree,
    step_shardings,
)

__all__ = ["Mesh", "NamedSharding", "PartitionSpec", "Placed", "batch_axes", "batch_spec",
           "make_rules", "named_sharding", "shard_batch_tree", "step_shardings"]
