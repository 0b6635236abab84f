"""Roofline terms of counted costs, on one NVIDIA H100 SXM.

Three terms, each a lower-bound execution time in seconds:

  compute    = flops            / peak_flops   [bf16 dense tensor cores]
  memory     = bytes            / hbm_bw       [HBM3]
  collective = collective bytes / ici_bw       [NVLink, per direction]

The inputs are per device.  The flops and bytes come from the op-and-kernel
counter (``roofline/op_cost.py``); the collective bytes from the counters
that ``parallel/collectives.py`` keeps beside its call counts, by the
reference's kind names (the reference parses them out of compiled HLO
text; the port has no HLO).  Bytes counted are each collective's result
bytes, the reference's convention.

The reference's constants are a TPU v5e's; these are the H100's.  The
Viterbi kernels compute in float32, so ``fp32_flops`` (the non-tensor-core
float32 peak) is the rate behind their bounds (``PERF.md`` §6).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

#: the reference's collective kinds, in its order
COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
)
#: parallel/collectives.py function -> the kind it counts under
COLLECTIVE_KIND_OF = {
    "gather": "all-gather",
    "all_gather": "all-gather",
    "broadcast": "all-gather",
    "ring_shift": "collective-permute",
    "reduce_across_shards": "all-reduce",
    "all_reduce": "all-reduce",
    "psum_scalar": "all-reduce",
}


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device's peak rates and memory.

    Attributes:
      peak_flops: bf16 dense tensor-core FLOP/s (H100 SXM datasheet).
      hbm_bw: HBM3 bytes/s (H100 SXM datasheet).
      ici_bw: NVLink bytes/s per direction: 900 GB/s both ways over its 18
        fourth-generation links (H100 SXM datasheet), half of it each way.
      hbm_bytes: device memory as ``torch.cuda.get_device_properties(0)
        .total_memory`` reads it on the card.
      fp32_flops: float32 FLOP/s without tensor cores (H100 SXM datasheet).
    """

    name: str = "h100_sxm"
    peak_flops: float = 989.4e12
    hbm_bw: float = 3.35e12
    ici_bw: float = 450e9
    hbm_bytes: float = 85_017_493_504
    fp32_flops: float = 67e12


HW = Hardware()


def collective_bytes() -> Dict[str, object]:
    """``{"total", "per_kind", "counts"}`` of every collective called since
    the counters were last cleared (``collectives.calls.clear()`` and
    ``collectives.nbytes.clear()``), by the reference's kind names."""
    from repro_torch.parallel import collectives

    out = {k: 0.0 for k in COLLECTIVE_KINDS}
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    for fn, kind in COLLECTIVE_KIND_OF.items():
        out[kind] += float(collectives.nbytes[fn])
        counts[kind] += collectives.calls[fn]
    return {"total": sum(out.values()), "per_kind": out, "counts": counts}


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
    hw: Hardware = HW,
) -> Dict[str, float]:
    """The three terms, the dominant one, the bound (their largest) and the
    compute term's share of it.  All inputs are per device."""
    compute = flops_per_device / hw.peak_flops
    memory = bytes_per_device / hw.hbm_bw
    collective = collective_bytes_per_device / hw.ici_bw
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    terms["dominant"] = dom
    terms["bound_s"] = bound
    terms["compute_fraction_of_bound"] = compute / bound if bound > 0 else 0.0
    return terms


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for train (forward + backward), 2·N·D per decoded
    or prefilled token, N the active parameters (MoE-aware)."""
    n_active = cfg.param_count()["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "encdec":
            tokens = shape.global_batch * (shape.seq_len // cfg.dec_ratio)
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "encdec":
            tokens = shape.global_batch * (shape.seq_len + shape.seq_len // cfg.dec_ratio)
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token a sequence


def roofline_report(cell: dict, hw: Hardware = HW) -> dict:
    """The roofline row of one cell record (the reference's keys: ``chips``,
    ``jaxpr_cost`` with per-device flops and bytes, else ``cost_analysis``,
    ``collectives``' ``total``, ``model_flops``): the terms, the model flops,
    their share of the counted flops (``useful_ratio``) and the model-FLOP
    utilization the bound allows (``mfu_bound``)."""
    chips = cell.get("chips", 1)
    jx = cell.get("jaxpr_cost")
    if jx:
        flops = jx["flops_per_device"]
        byts = jx["bytes_per_device"]
    else:
        flops = cell["cost_analysis"].get("flops", 0.0)
        byts = cell["cost_analysis"].get("bytes accessed", 0.0)
    coll = cell["collectives"]["total"]
    terms = roofline_terms(flops, byts, coll, hw)
    mf = cell.get("model_flops", 0.0)
    terms["model_flops"] = mf
    terms["useful_ratio"] = (mf / chips) / flops if flops else 0.0
    terms["mfu_bound"] = (mf / chips / hw.peak_flops) / terms["bound_s"] \
        if terms["bound_s"] else 0.0
    return terms
