"""Roofline accounting: the op-and-kernel counter (``op_cost``) and the
roofline terms of its counts on the H100 (``analysis``)."""
from repro_torch.roofline.analysis import (
    HW,
    Hardware,
    collective_bytes,
    model_flops,
    roofline_report,
    roofline_terms,
)
from repro_torch.roofline.op_cost import CostCounter, count_fn_costs

__all__ = ["HW", "Hardware", "collective_bytes", "model_flops", "roofline_terms",
           "roofline_report", "CostCounter", "count_fn_costs"]
