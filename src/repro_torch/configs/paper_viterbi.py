"""The paper's own workload: Viterbi decoding of rate-1/2 convolutional
codes.  Not an LM — this config names the trellis codes and batch shapes the
decode paths are sized by, mirroring the paper's 12..60-bit sweeps (Fig. 3)
plus throughput-scale batches.  The shape names keep the reference's (its
``tpu_*`` shapes are the batch sizes, not a device: the port runs them on
one NVIDIA card)."""
import dataclasses
from typing import Optional, Tuple

from repro_torch.core.trellis import CODE_K3_PAPER, CODE_K3_STD, CODE_K5_GSM, CODE_K7_NASA, ConvCode
from repro_torch.decode.spec import CodecSpec


@dataclasses.dataclass(frozen=True)
class ViterbiShape:
    name: str
    n_info_bits: int  # information bits per stream (before flush)
    batch: int


@dataclasses.dataclass(frozen=True)
class ViterbiBundle:
    code: ConvCode = CODE_K3_STD
    paper_code: ConvCode = CODE_K3_PAPER
    shapes: Tuple[ViterbiShape, ...] = (
        # the paper's Fig. 3 sweep: 12..60 coded bits (= 6..30 info bits at
        # rate 1/2, including the 2 flush bits for K=3)
        ViterbiShape("paper_12b", 4, 1),
        ViterbiShape("paper_24b", 10, 1),
        ViterbiShape("paper_36b", 16, 1),
        ViterbiShape("paper_48b", 22, 1),
        ViterbiShape("paper_60b", 28, 1),
        # throughput-scale shapes
        ViterbiShape("tpu_gsm_burst", 185, 4096),   # GSM full-rate burst, K=5
        ViterbiShape("tpu_nasa_frame", 1024, 1024),  # NASA K=7 frames
        ViterbiShape("tpu_stream_64k", 65536, 128),  # long-stream decode
    )


ARCH = ViterbiBundle()
SMOKE = ViterbiBundle(shapes=(ViterbiShape("smoke", 16, 8),))

CODES = {
    "k3_std": CODE_K3_STD,
    "k3_paper": CODE_K3_PAPER,
    "k5_gsm": CODE_K5_GSM,
    "k7_nasa": CODE_K7_NASA,
}

# ---------------------------------------------------------------------------- #
# The ONE decode configuration scripts share: codec specs for the paper        #
# workload and the streaming-subsystem shape defaults.  Scripts source these   #
# instead of re-stating literals.                                              #
# ---------------------------------------------------------------------------- #

#: Hard-decision rate-1/2 K=3 spec — the paper's baseline workload.
DECODE_SPEC = CodecSpec(code=CODE_K3_STD, metric="hard")
#: Soft-decision variant of the same code (BPSK + AWGN channels).
DECODE_SPEC_SOFT = CodecSpec(code=CODE_K3_STD, metric="soft")

#: LM-source demos pack tokens from a 512-word vocab into 9-bit symbols.
SERVE_BITS_PER_TOKEN = 9


@dataclasses.dataclass(frozen=True)
class StreamDefaults:
    """Shared shape defaults for the streaming subsystem (sessions,
    scheduler, stream runs): chunk per tick, the continuous-batching
    decode-block size, and the mesh axis a sharded scheduler spans (the
    mesh is ``repro_torch.parallel.Mesh``).

    ``n_slots`` is the PER-SHARD slot load: a sharded scheduler weak-scales,
    so the slot table grows with the mesh (``n_slots_for``) and each device
    carries the same number of slots a single-device scheduler would.

    ``max_buffered`` is the per-stream input-queue bound for online
    ingestion (unconsumed rows a chunk-fed stream may hold before
    ``submit_chunk`` raises StreamBusy): 8 chunks — deep enough to ride out
    tick jitter, shallow enough that backpressure reaches the source within
    one window's worth of symbols."""

    chunk: int = 64
    n_slots: int = 64
    max_buffered: int = 512  # 8 * chunk
    mesh_axis: str = "data"

    def depth(self, code: ConvCode) -> int:
        """The subsystem's single depth rule (stream.window.default_depth)."""
        from repro_torch.stream.window import default_depth

        return default_depth(code)

    def n_slots_for(self, n_shards: int, slots_per_shard: Optional[int] = None) -> int:
        """Weak-scaling slot-table size: per-shard load (default
        ``self.n_slots``) times shard count — the one sizing rule sharded
        deployments share."""
        per_shard = self.n_slots if slots_per_shard is None else slots_per_shard
        return per_shard * max(1, int(n_shards))


STREAM = StreamDefaults()
