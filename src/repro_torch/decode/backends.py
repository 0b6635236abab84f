"""The decode backends on the DecoderRegistry.

Ported: ``fused_packed`` (the packed scan + traceback kernels, with a
raw-symbol entry that computes branch metrics in the scan kernel and a
bm-table entry that feeds the same kernel through ``table_weights``) and
``sequential`` (the plain oracle).  Every other backend name of the reference
is registered with the reference's capability record, so the planner and
validation behave the same, but its entry raises ``NotImplementedError``
naming the ROADMAP.md item that ports it — it never falls back to another
backend.  Importing this module (which ``repro_torch.decode`` does)
populates the registry.
"""
from __future__ import annotations

from repro_torch.core.viterbi import viterbi_decode
from repro_torch.decode.registry import BackendCapabilities, register_decoder
from repro_torch.decode.request import DecodeContext, DecodeResult
from repro_torch.decode.spec import CodecSpec
from repro_torch.kernels.metrics import fused_metric_plan
from repro_torch.kernels.ops import viterbi_decode_fused_packed, viterbi_decode_packed

#: Largest trellis the fused scan takes: the planner's cap for the fused
#: routes, kept equal to the reference's so both pick the same backend (the
#: CUDA scan kernel's own limit, viterbi_scan.MAX_STATES, is the same 4096).
FUSED_MAX_STATES = 4096


def _result(spec: CodecSpec, bits, metric, **diag) -> DecodeResult:
    return DecodeResult(bits=bits, path_metric=metric, spec=spec, diagnostics=diag)


def _not_ported(name: str, item: int):
    """Entry of a backend that is registered but not ported yet."""

    def entry(spec, data, *, ctx: DecodeContext) -> DecodeResult:
        raise NotImplementedError(
            f"backend {name!r} is not ported to repro_torch yet "
            f"(ROADMAP.md queue 1, item {item})"
        )

    return entry


def _fused_packed_from_received(
    spec: CodecSpec, received, *, ctx: DecodeContext
) -> DecodeResult:
    """Raw-symbol entry: branch metrics computed in the scan kernel — the
    (B, T, M) bm table never exists."""
    plan = fused_metric_plan(spec.code, spec.metric, spec.puncture_array)
    bits, metric = viterbi_decode_fused_packed(
        plan, ctx.place(received), terminated=spec.terminated
    )
    return _result(spec, bits, metric, backend="fused_packed", metrics="in-kernel")


@register_decoder(
    "fused_packed",
    capabilities=BackendCapabilities(
        family="conv", max_states=FUSED_MAX_STATES, accepts_received=True
    ),
    from_received=_fused_packed_from_received,
)
def decode_fused_packed(spec: CodecSpec, bm_tables, *, ctx: DecodeContext) -> DecodeResult:
    """Packed forward scan kernel with on-chip path metrics and bit-packed
    survivors + packed traceback kernel; given raw symbols it also computes
    branch metrics in the scan kernel."""
    bits, metric = viterbi_decode_packed(
        spec.code, ctx.place(bm_tables), terminated=spec.terminated
    )
    return _result(spec, bits, metric, backend="fused_packed", metrics="table")


@register_decoder("sequential", capabilities=BackendCapabilities(family="conv"))
def decode_sequential(spec: CodecSpec, bm_tables, *, ctx: DecodeContext) -> DecodeResult:
    """Plain sequential decoder — the oracle every other backend is tested
    against."""
    bits, metric = viterbi_decode(spec.code, ctx.place(bm_tables), terminated=spec.terminated)
    return _result(spec, bits, metric, backend="sequential")


register_decoder(
    "fused",
    capabilities=BackendCapabilities(family="conv", max_states=FUSED_MAX_STATES),
    summary="scan with unpacked survivors (not ported yet)",
)(_not_ported("fused", 7))

register_decoder(
    "tiled",
    capabilities=BackendCapabilities(
        family="conv", max_states=FUSED_MAX_STATES, accepts_received=True
    ),
    summary="time-parallel tiled decode (not ported yet)",
    from_received=_not_ported("tiled", 6),
)(_not_ported("tiled", 6))

register_decoder(
    "parallel",
    capabilities=BackendCapabilities(family="conv"),
    summary="(min,+) associative scan over chunks (not ported yet)",
)(_not_ported("parallel", 9))

register_decoder(
    "seqparallel",
    capabilities=BackendCapabilities(family="conv", supports_mesh=True, requires_mesh=True),
    summary="sequence-parallel decode across a mesh (not ported yet)",
)(_not_ported("seqparallel", 9))

register_decoder(
    "sharded_stream",
    capabilities=BackendCapabilities(
        family="conv",
        supports_mesh=True,
        requires_mesh=True,
        supports_streaming=True,
        sharded_stream=True,
        online=True,
        max_states=FUSED_MAX_STATES,
    ),
    summary="mesh-sharded streaming scheduler (not ported yet)",
)(_not_ported("sharded_stream", 9))

register_decoder(
    "streaming",
    capabilities=BackendCapabilities(family="conv", supports_streaming=True, online=True),
    summary="truncated-traceback sliding window (not ported yet)",
)(_not_ported("streaming", 5))

register_decoder(
    "bcjr",
    capabilities=BackendCapabilities(
        family="rsc", max_states=FUSED_MAX_STATES, accepts_received=True
    ),
    summary="max-log-MAP BCJR SISO decoder (not ported yet)",
    from_received=_not_ported("bcjr", 8),
)(_not_ported("bcjr", 8))

register_decoder(
    "turbo",
    capabilities=BackendCapabilities(family="turbo", accepts_received=True),
    summary="iterative turbo decoder (not ported yet)",
    from_received=_not_ported("turbo", 8),
)(_not_ported("turbo", 8))
