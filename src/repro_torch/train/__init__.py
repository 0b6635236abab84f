"""Training runtime: optimizers, the train-step builder, the fault-tolerant
loop, async checkpointing, straggler detection.  On one device; a device
mesh (``elastic_mesh``, sharded steps) waits for ROADMAP item 9b."""
from repro_torch.train.fault_tolerance import StragglerDetector
from repro_torch.train.optimizer import adafactor, adamw, cosine_warmup
from repro_torch.train.train_loop import make_train_step, train

__all__ = ["StragglerDetector", "adamw", "adafactor", "cosine_warmup", "make_train_step",
           "train"]
