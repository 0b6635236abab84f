"""Request/result/context dataclasses of the decode API.

DecodeContext  where/how to run that is not part of the codec itself: the
               device or device mesh, chunking, streaming window depth, the
               streaming flag, a pinned tile count and overlap.  The
               planner consumes it to pick a backend; the backend to
               execute.
DecodeRequest  one decode job: a CodecSpec plus either raw channel output
               (``received``) or precomputed branch-metric tables.
DecodeResult   bits + path metric + per-stream diagnostics + the plan that
               produced them.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, Optional

import torch

from repro_torch.decode.spec import CodecSpec
from repro_torch.kernels.common import resolve_device
from repro_torch.parallel.mesh import Mesh

if TYPE_CHECKING:  # planner imports this module; annotation only
    from repro_torch.decode.planner import DecodePlan


@dataclasses.dataclass(frozen=True)
class DecodeContext:
    """Execution context shared by the planner and every backend.

    Attributes:
      mesh: a device mesh (parallel/mesh.py) for the mesh backends (None =
        one device).  Its devices must be of ``device``'s type; inputs are
        placed on, and results come back on, its first device.
      mesh_axis: mesh axis name the sequence is sharded over.
      batch_axis: mesh axis name batch/slot-parallel backends shard over.
      chunk: chunk length for chunked backends (the parallel scan's chunk
        transfer matrices, streaming).
      stream_depth: truncated-traceback depth for the streaming backend
        (None = the textbook 5*K).
      streaming: a live session context — the caller consumes bits a fixed
        lag behind the channel, so the planner picks a windowed backend.
      tiles: time-tile count for the ``tiled`` backend (None = the planner
        picks kernels/tiling.default_tiles).
      tile_overlap: per-tile warm-up steps for the ``tiled`` backend.  None
        (the default) and any value >= the truncation depth 5·K select the
        exact min-plus seam resolution (bit-exact); smaller values select
        the cheaper truncated warm-up approximation.
      device: where the decode runs.  ``"cuda"`` (the default) launches the
        hand-written kernels and raises when no card is present; ``"cpu"``
        runs their plain PyTorch versions.
    """

    mesh: Optional[Mesh] = None
    mesh_axis: str = "model"
    batch_axis: str = "data"
    chunk: int = 64
    stream_depth: Optional[int] = None
    streaming: bool = False
    tiles: Optional[int] = None
    tile_overlap: Optional[int] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.mesh is None:
            return
        if not isinstance(self.mesh, Mesh):
            raise TypeError(f"DecodeContext.mesh must be a repro_torch.parallel.Mesh, got "
                            f"{type(self.mesh).__name__}")
        if self.mesh.device_type != torch.device(self.device).type:
            raise ValueError(f"mesh devices are {self.mesh.device_type!r} but the context's "
                             f"device is {self.device!r}; pass a mesh of that type or "
                             "DecodeContext(device=...) of the mesh's")

    def home(self) -> torch.device:
        """Where inputs go and results come back: the mesh's first device,
        else ``device`` (``"cuda"`` without a card raises)."""
        return resolve_device(self.device if self.mesh is None else self.mesh.devices.flat[0])

    def place(self, x) -> torch.Tensor:
        """``x`` (tensor or array) as a tensor on :meth:`home`."""
        return torch.as_tensor(x, device=self.home())


@dataclasses.dataclass(frozen=True)
class DecodeRequest:
    """One decode job.  Provide ``received`` (channel output, shaped
    (B, T, n_out)) or ``bm_tables`` ((B, T, n_symbols), already built)."""

    spec: CodecSpec
    received: Optional[Any] = None
    bm_tables: Optional[Any] = None

    def shape(self):
        """(B, T) problem shape for the planner."""
        src = self.bm_tables if self.bm_tables is not None else self.received
        if src is None:
            raise ValueError("DecodeRequest needs received or bm_tables")
        return tuple(src.shape[:2])

    def metrics(self, ctx: Optional[DecodeContext] = None):
        """Branch-metric tables for this request: the precomputed
        ``bm_tables`` as handed in, else built from ``received`` through the
        spec on ``ctx``'s device (the card unless ``ctx`` says otherwise)."""
        if self.bm_tables is not None:
            return self.bm_tables
        if self.received is None:
            raise ValueError("DecodeRequest needs received or bm_tables")
        ctx = DecodeContext() if ctx is None else ctx
        return self.spec.branch_metrics(ctx.place(self.received))


@dataclasses.dataclass
class DecodeResult:
    """What every backend returns, in one normalized shape.

    Attributes:
      bits: (B, T) decoded input bits, *including* flush bits when the spec
        is terminated — ``info_bits`` strips them.
      path_metric: (B,) winning path metric (minimized).
      spec: the CodecSpec that was decoded.
      plan: the DecodePlan that chose the backend (filled by plan.execute).
      diagnostics: per-backend extras (backend name, metric route, ...).
    """

    bits: torch.Tensor
    path_metric: torch.Tensor
    spec: CodecSpec
    plan: Optional["DecodePlan"] = None
    diagnostics: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def info_bits(self) -> torch.Tensor:
        """Decoded information bits (flush bits stripped per the spec)."""
        return self.spec.strip_flush(self.bits)
