"""Hand-written Hopper kernels of the decode hot path, each beside its plain
PyTorch version.

viterbi_scan.py — packed forward ACS scan with in-kernel branch metrics
                  (csrc/viterbi_scan.cu)
survivors.py    — 32-per-word pack/unpack helpers + the packed traceback
                  (csrc/survivors.cu)
metrics.py      — affine in-kernel branch-metric plans (hard/soft/punctured)
ops.py          — public wrappers and the packed decode pipelines
common.py       — survivor word width, kernel-or-plain rule, launch counters
tiling.py       — default tile count for the planner's long-block rule
_build.py       — nvcc build at first use + ctypes loading
"""
from repro_torch.kernels.common import launch_counts, plain_counts, reset_counts
from repro_torch.kernels.metrics import FusedMetricPlan, fused_metric_plan
from repro_torch.kernels.ops import (
    viterbi_decode_fused_packed,
    viterbi_decode_packed,
    viterbi_forward_fused_op,
    viterbi_forward_packed_op,
    viterbi_forward_weighted_op,
    viterbi_traceback_op,
)
from repro_torch.kernels.survivors import (
    pack_survivors,
    traceback_packed,
    traceback_packed_plain,
    unpack_survivors,
)
from repro_torch.kernels.viterbi_scan import (
    table_weights,
    viterbi_scan_packed,
    viterbi_scan_packed_plain,
)

__all__ = [
    "FusedMetricPlan",
    "fused_metric_plan",
    "launch_counts",
    "pack_survivors",
    "plain_counts",
    "reset_counts",
    "table_weights",
    "traceback_packed",
    "traceback_packed_plain",
    "unpack_survivors",
    "viterbi_decode_fused_packed",
    "viterbi_decode_packed",
    "viterbi_forward_fused_op",
    "viterbi_forward_packed_op",
    "viterbi_forward_weighted_op",
    "viterbi_scan_packed",
    "viterbi_scan_packed_plain",
    "viterbi_traceback_op",
]
