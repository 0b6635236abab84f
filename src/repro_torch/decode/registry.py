"""DecoderBackend protocol + DecoderRegistry.

Every decoder implements ONE normalized signature

    decode(spec: CodecSpec, bm_tables: (B, T, M), *, ctx: DecodeContext)
        -> DecodeResult

and registers itself with a capability record:

    @register_decoder("fused_packed", capabilities=BackendCapabilities(...))
    def _fused_packed(spec, bm_tables, *, ctx): ...

The planner (planner.py) reads the capability records to auto-select.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, ItemsView, Iterator, Optional, Protocol, Tuple

from repro_torch.decode.request import DecodeContext, DecodeResult
from repro_torch.decode.spec import CodecSpec


class DecoderBackend(Protocol):
    """The one normalized decode signature every backend implements."""

    def __call__(self, spec: CodecSpec, bm_tables, *, ctx: DecodeContext) -> DecodeResult:
        ...


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """What a backend can run — the planner's selection input.

    Attributes:
      family: code family the backend decodes — ``"conv"`` (feed-forward
        convolutional, Viterbi), ``"rsc"`` (recursive systematic, SISO) or
        ``"turbo"``.  A mismatch with the spec is a validation error.
      supports_mesh: can shard the decode across a device mesh.
      requires_mesh: refuses to run without a mesh.
      supports_streaming: windowed/online decode — bounded memory for
        unbounded streams, bits emitted a fixed lag behind the channel.
      max_states: largest trellis (n_states) the backend handles, or None
        for unlimited.
      needs_terminated: only decodes terminated trellises.
      accepts_received: the backend has a raw-symbol entry (``from_received``)
        that computes branch metrics in-kernel — ``decode`` routes channel
        output straight to it, skipping the (B, T, M) bm table.
      sharded_stream: partitions a streaming slot table along a mesh axis.
      online: the backing machinery ingests incrementally (chunk-fed).
    """

    family: str = "conv"
    supports_mesh: bool = False
    requires_mesh: bool = False
    supports_streaming: bool = False
    max_states: Optional[int] = None
    needs_terminated: bool = False
    accepts_received: bool = False
    sharded_stream: bool = False
    online: bool = False


@dataclasses.dataclass(frozen=True)
class RegisteredDecoder:
    name: str
    fn: DecoderBackend
    capabilities: BackendCapabilities
    summary: str = ""
    #: optional raw-symbol entry: (spec, received (B, T, n_out), *, ctx) ->
    #: DecodeResult with branch metrics computed in-kernel.
    from_received: Optional[Callable] = None

    def __call__(self, spec: CodecSpec, bm_tables, *, ctx: DecodeContext) -> DecodeResult:
        return self.fn(spec, bm_tables, ctx=ctx)

    def decode_received(self, spec: CodecSpec, received, *, ctx: DecodeContext) -> DecodeResult:
        if self.from_received is None:
            raise ValueError(f"backend {self.name!r} has no raw-symbol entry")
        return self.from_received(spec, received, ctx=ctx)


class DecoderRegistry:
    """Name -> RegisteredDecoder mapping with decorator-style registration."""

    def __init__(self):
        self._decoders: Dict[str, RegisteredDecoder] = {}

    def register(
        self,
        name: str,
        *,
        capabilities: Optional[BackendCapabilities] = None,
        summary: str = "",
        from_received: Optional[Callable] = None,
    ) -> Callable[[DecoderBackend], DecoderBackend]:
        def deco(fn: DecoderBackend) -> DecoderBackend:
            if name in self._decoders:
                raise KeyError(f"decoder {name!r} already registered")
            doc = summary
            if not doc and fn.__doc__:
                doc = fn.__doc__.strip().splitlines()[0]
            self._decoders[name] = RegisteredDecoder(
                name=name,
                fn=fn,
                capabilities=capabilities or BackendCapabilities(),
                summary=doc,
                from_received=from_received,
            )
            return fn

        return deco

    def get(self, name: str) -> RegisteredDecoder:
        try:
            return self._decoders[name]
        except KeyError:
            raise KeyError(
                f"unknown decoder {name!r}; registered: {', '.join(self.names())}"
            ) from None

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._decoders))

    def __contains__(self, name: str) -> bool:
        return name in self._decoders

    def __iter__(self) -> Iterator[RegisteredDecoder]:
        return iter(self._decoders.values())

    def items(self) -> ItemsView[str, RegisteredDecoder]:
        return self._decoders.items()


#: The process-wide registry every built-in backend registers onto.
REGISTRY = DecoderRegistry()
register_decoder = REGISTRY.register
get_decoder = REGISTRY.get


def list_decoders() -> Tuple[str, ...]:
    return REGISTRY.names()
