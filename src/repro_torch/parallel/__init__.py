"""Distribution: a single-controller device mesh (mesh.py), the collectives
over it and the sequence-parallel Viterbi decoder (collectives.py), GPipe
pipeline parallelism over a stage axis (pipeline.py), and the LM's sharding
helpers (sharding.py, not ported yet: they raise naming ROADMAP item 9b)."""
from repro_torch.parallel.mesh import Mesh
from repro_torch.parallel.sharding import (
    batch_spec,
    make_rules,
    named_sharding,
    step_shardings,
)

__all__ = ["Mesh", "batch_spec", "make_rules", "named_sharding", "step_shardings"]
