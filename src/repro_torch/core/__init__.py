"""Numeric core: trellis tables, encoder, channels, metrics, ACS, the plain
decoders (sequential oracle, block-parallel, HMM) and the linear-chain CRF."""
from repro_torch.core.acs import acs_step, acs_step_unfused
from repro_torch.core.channel import (
    awgn,
    bpsk_modulate,
    bsc,
    hard_branch_metrics,
    soft_branch_metrics,
)
from repro_torch.core.crf import (
    crf_decode,
    crf_log_norm,
    crf_loss,
    crf_marginals,
    crf_score,
)
from repro_torch.core.encoder import encode, pack_symbols, unpack_symbols
from repro_torch.core.puncture import (
    PUNCTURE_2_3,
    PUNCTURE_3_4,
    PUNCTURE_5_6,
    PUNCTURE_TURBO_1_2,
    effective_rate,
    pattern_mask,
    punctured_hard_metrics,
)
from repro_torch.core.trellis import (
    CODE_K3_PAPER,
    CODE_K3_STD,
    CODE_K5_GSM,
    CODE_K7_NASA,
    NEG_UNREACHABLE,
    ConvCode,
    paper_expansion_calls,
)
from repro_torch.core.viterbi import (
    hmm_viterbi,
    minplus_matmul,
    viterbi_decode,
    viterbi_decode_parallel,
)

__all__ = [
    "CODE_K3_PAPER",
    "CODE_K3_STD",
    "CODE_K5_GSM",
    "CODE_K7_NASA",
    "NEG_UNREACHABLE",
    "PUNCTURE_2_3",
    "PUNCTURE_3_4",
    "PUNCTURE_5_6",
    "PUNCTURE_TURBO_1_2",
    "ConvCode",
    "acs_step",
    "acs_step_unfused",
    "awgn",
    "bpsk_modulate",
    "bsc",
    "crf_decode",
    "crf_log_norm",
    "crf_loss",
    "crf_marginals",
    "crf_score",
    "effective_rate",
    "encode",
    "hard_branch_metrics",
    "hmm_viterbi",
    "minplus_matmul",
    "pack_symbols",
    "paper_expansion_calls",
    "pattern_mask",
    "punctured_hard_metrics",
    "soft_branch_metrics",
    "unpack_symbols",
    "viterbi_decode",
    "viterbi_decode_parallel",
]
