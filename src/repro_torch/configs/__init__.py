"""Configurations: the config dataclasses and the architecture registry
(``base``), one module per LM architecture (``ARCH`` and ``SMOKE`` each),
and the paper's own Viterbi workload (``paper_viterbi``: the codes, the
decode specs, the batch shapes and the streaming subsystem's deployment
defaults)."""
from repro_torch.configs.base import (
    SHAPES,
    ArchBundle,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    PartitionConfig,
    ShapeConfig,
    SSMConfig,
    XLSTMConfig,
    arch_ids,
    get_arch,
    get_smoke_arch,
)
from repro_torch.configs.paper_viterbi import (
    ARCH,
    CODES,
    DECODE_SPEC,
    DECODE_SPEC_SOFT,
    SERVE_BITS_PER_TOKEN,
    SMOKE,
    STREAM,
    StreamDefaults,
    ViterbiBundle,
    ViterbiShape,
)

__all__ = [
    "ARCH",
    "ArchBundle",
    "CODES",
    "DECODE_SPEC",
    "DECODE_SPEC_SOFT",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "PartitionConfig",
    "SERVE_BITS_PER_TOKEN",
    "SHAPES",
    "SMOKE",
    "SSMConfig",
    "STREAM",
    "ShapeConfig",
    "StreamDefaults",
    "ViterbiBundle",
    "ViterbiShape",
    "XLSTMConfig",
    "arch_ids",
    "get_arch",
    "get_smoke_arch",
]
