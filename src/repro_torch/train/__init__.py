"""Training-side runtime.  Only the straggler detector is ported so far: the
stream scheduler flags slow ticks with it.  The optimizers, training steps and
checkpointing need the LM models (ROADMAP queue 1, item 11); ``elastic_mesh``
needs a device mesh (item 9b)."""
from repro_torch.train.fault_tolerance import StragglerDetector

__all__ = ["StragglerDetector"]
