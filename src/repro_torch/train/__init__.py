"""Training runtime: optimizers, the train-step builder, the fault-tolerant
loop, async checkpointing, straggler detection and the elastic mesh
rebuild (``fault_tolerance.elastic_mesh``).  The step runs on one device
or data-parallel over a mesh (``make_train_step(mesh=...)``); sharded
parameters (tensor parallelism, FSDP/ZeRO) wait for ROADMAP items 9b.3b
and 9b.3c."""
from repro_torch.train.fault_tolerance import StragglerDetector
from repro_torch.train.optimizer import adafactor, adamw, cosine_warmup
from repro_torch.train.train_loop import make_train_step, train

__all__ = ["StragglerDetector", "adamw", "adafactor", "cosine_warmup", "make_train_step",
           "train"]
