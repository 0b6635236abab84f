"""Configurations.  Only the paper's own Viterbi workload is ported so far
(``paper_viterbi``: the codes, the decode specs, the batch shapes and the
streaming subsystem's deployment defaults); the LM architecture configs wait
for the models (ROADMAP.md queue 1, item 11)."""
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
    "CODES",
    "DECODE_SPEC",
    "DECODE_SPEC_SOFT",
    "SERVE_BITS_PER_TOKEN",
    "SMOKE",
    "STREAM",
    "StreamDefaults",
    "ViterbiBundle",
    "ViterbiShape",
]
