"""Hand-written Hopper kernels of the decode hot path, each beside its plain
PyTorch version.

viterbi_scan.py — forward ACS scans with in-kernel branch metrics: from
                  state 0, carried, windowed (packed), unpacked and carried
                  unpacked (one template in csrc/viterbi_scan.cu)
texpand.py      — the paper's one-step instruction (csrc/texpand.cu)
bcjr.py         — max-log-MAP alpha scan and fused beta/LLR scan
                  (csrc/bcjr.cu)
survivors.py    — 32-per-word pack/unpack helpers + the packed and windowed
                  tracebacks (csrc/survivors.cu)
metrics.py      — affine in-kernel branch-metric plans (hard/soft/punctured)
minplus.py      — the batched (min,+) product (csrc/minplus.cu) and the
                  (min,+) state-map algebra of the tiled seams (plain torch)
tiling.py       — time-tile plans and the default tile count
ops.py          — public wrappers: texpand, the unpacked, packed, tiled and
                  block-parallel decode pipelines, the streaming chunk ops,
                  the SISO op, the reference's (min,+) product op
common.py       — survivor word width, kernel-or-plain rule, launch counters
_build.py       — nvcc build at first use + ctypes loading
"""
from repro_torch.kernels.bcjr import MAX_FEATURES as BCJR_MAX_FEATURES
from repro_torch.kernels.bcjr import MAX_STATES as BCJR_MAX_STATES
from repro_torch.kernels.bcjr import (
    bcjr_alpha_scan,
    bcjr_alpha_scan_plain,
    bcjr_beta_llr_scan,
    bcjr_beta_llr_scan_plain,
)
from repro_torch.kernels.common import launch_counts, plain_counts, reset_counts
from repro_torch.kernels.metrics import FusedMetricPlan, fused_metric_plan
from repro_torch.kernels.minplus import (
    compose_maps,
    identity_map,
    minplus_matmul,
    minplus_matmul_plain,
    prefix_maps,
    seam_argmin,
    tile_entry_metrics,
)
from repro_torch.kernels.ops import (
    bcjr_llr_op,
    minplus_matmul_op,
    texpand_op,
    viterbi_decode_fused,
    viterbi_decode_fused_packed,
    viterbi_decode_packed,
    viterbi_decode_parallel_op,
    viterbi_decode_tiled_fused,
    viterbi_decode_tiled_op,
    viterbi_forward_chunk_op,
    viterbi_forward_fused_op,
    viterbi_forward_op,
    viterbi_forward_packed_op,
    viterbi_forward_weighted_op,
    viterbi_traceback_op,
)
from repro_torch.kernels.survivors import (
    pack_survivors,
    traceback_packed,
    traceback_packed_plain,
    traceback_packed_window,
    traceback_packed_window_plain,
    unpack_survivors,
)
from repro_torch.kernels.texpand import texpand_plain
from repro_torch.kernels.tiling import (
    TilePlan,
    default_tiles,
    plan_tiles,
    truncation_depth,
)
from repro_torch.kernels.viterbi_scan import MAX_STATES as SCAN_MAX_STATES
from repro_torch.kernels.viterbi_scan import (
    table_weights,
    viterbi_scan_carry,
    viterbi_scan_carry_plain,
    viterbi_scan_packed,
    viterbi_scan_packed_carry,
    viterbi_scan_packed_carry_plain,
    viterbi_scan_packed_plain,
    viterbi_scan_packed_window,
    viterbi_scan_packed_window_plain,
    viterbi_scan_plain,
)

__all__ = [
    "BCJR_MAX_FEATURES",
    "BCJR_MAX_STATES",
    "FusedMetricPlan",
    "SCAN_MAX_STATES",
    "TilePlan",
    "bcjr_alpha_scan",
    "bcjr_alpha_scan_plain",
    "bcjr_beta_llr_scan",
    "bcjr_beta_llr_scan_plain",
    "bcjr_llr_op",
    "compose_maps",
    "default_tiles",
    "fused_metric_plan",
    "identity_map",
    "launch_counts",
    "minplus_matmul",
    "minplus_matmul_op",
    "minplus_matmul_plain",
    "pack_survivors",
    "plain_counts",
    "plan_tiles",
    "prefix_maps",
    "reset_counts",
    "seam_argmin",
    "table_weights",
    "texpand_op",
    "texpand_plain",
    "tile_entry_metrics",
    "traceback_packed",
    "traceback_packed_plain",
    "traceback_packed_window",
    "traceback_packed_window_plain",
    "truncation_depth",
    "unpack_survivors",
    "viterbi_decode_fused",
    "viterbi_decode_fused_packed",
    "viterbi_decode_packed",
    "viterbi_decode_parallel_op",
    "viterbi_decode_tiled_fused",
    "viterbi_decode_tiled_op",
    "viterbi_forward_chunk_op",
    "viterbi_forward_fused_op",
    "viterbi_forward_op",
    "viterbi_forward_packed_op",
    "viterbi_forward_weighted_op",
    "viterbi_scan_carry",
    "viterbi_scan_carry_plain",
    "viterbi_scan_packed",
    "viterbi_scan_packed_carry",
    "viterbi_scan_packed_carry_plain",
    "viterbi_scan_packed_plain",
    "viterbi_scan_packed_window",
    "viterbi_scan_packed_window_plain",
    "viterbi_scan_plain",
    "viterbi_traceback_op",
]
