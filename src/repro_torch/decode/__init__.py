"""Decode API — the public decode surface of the port.

  CodecSpec        what is decoded: code + metric kind + puncturing +
                   termination (spec.py)
  DecoderRegistry  who decodes it: every backend behind one normalized
                   ``decode(spec, bm_tables, *, ctx)`` signature with a
                   capability record (registry.py, backends.py)
  plan_decode      which backend runs: shape-aware selection with explicit
                   override and ``explain()`` (planner.py)
  decode           one-shot convenience: plan + execute

Quickstart::

    from repro_torch.decode import CodecSpec, DecodeRequest, decode

    spec = CodecSpec(code=CODE_K7_NASA, metric="hard")
    gen = torch.Generator(device="cuda").manual_seed(0)
    coded = spec.encode(bits)                       # (B, T, n_out)
    rx = spec.channel(gen, coded, flip_prob=0.02)
    res = decode(DecodeRequest(spec, received=rx))  # runs on the card
    res.info_bits, res.path_metric, res.plan.explain()

A long block over a device mesh plans ``seqparallel`` (the time axis split
across the mesh's ``model`` shards)::

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 2), ("data", "model"))     # two visible cards
    res = decode(DecodeRequest(spec, received=rx), ctx=DecodeContext(mesh=mesh))
"""
from repro_torch.decode import backends as _backends  # noqa: F401  (registers the backends)
from repro_torch.decode.planner import LONG_BLOCK_T, DecodePlan, decode, plan_decode
from repro_torch.decode.registry import (
    REGISTRY,
    BackendCapabilities,
    DecoderBackend,
    DecoderRegistry,
    RegisteredDecoder,
    get_decoder,
    list_decoders,
    register_decoder,
)
from repro_torch.decode.request import DecodeContext, DecodeRequest, DecodeResult
from repro_torch.decode.spec import CodecSpec, spec_family

__all__ = [
    "BackendCapabilities",
    "CodecSpec",
    "DecodeContext",
    "DecodePlan",
    "DecodeRequest",
    "DecodeResult",
    "DecoderBackend",
    "DecoderRegistry",
    "LONG_BLOCK_T",
    "REGISTRY",
    "RegisteredDecoder",
    "decode",
    "get_decoder",
    "list_decoders",
    "plan_decode",
    "register_decoder",
    "spec_family",
]
