"""Stateful streaming decode sessions.

A StreamSession owns the carried StreamState for one (optionally batched)
bitstream and the host-side bookkeeping around it: how many steps have been
pushed, how many bits are already committed, and therefore which slice of
each chunk's committed window is actually valid.  Memory is O(depth + chunk)
regardless of stream length; path metrics are renormalized every chunk so
float32 never saturates, with the accumulated offset tracked so ``finish``
still reports the absolute path metric.

Backends: ``fused``/``scan`` consume (B, chunk, M) branch-metric tables.
``fused_packed`` runs the memory-lean pipeline — bit-packed survivor ring,
traceback kernel on the card — and with ``inputs="received"`` consumes raw
(B, chunk, n_out) channel symbols, computing branch metrics in the scan
kernel (kernels/metrics.py).  The packed ring shifts whole 32-bit words, so
the chunk must be a multiple of 32 and the depth is rounded up to one.

The session lives on one device, chosen at construction (``device="cuda"``
by default, which raises without a card); every pushed chunk is moved there.

Typical use:

    sess = StreamSession(spec, batch=128, chunk=64, backend="fused_packed",
                         inputs="received")
    for rx_chunk in channel:                  # (B, 64, n_out) each
        emit(sess.push(rx_chunk))             # (B, <=64) newly-final bits
    emit(*sess.finish())                      # the last bits + metric
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core.trellis import ConvCode
from repro_torch.decode.spec import CodecSpec
from repro_torch.kernels.common import resolve_device
from repro_torch.obs import Telemetry
from repro_torch.obs.trace import span
from repro_torch.stream import window as _w


def _require_finite(x: torch.Tensor, what: str) -> None:
    """Raise on NaN/Inf input — one device-to-host sync, the reference's
    ``np.isfinite`` scan.  A single bad value poisons the carried path
    metrics of every stream in the batch, silently."""
    bad = int((~torch.isfinite(x)).sum())
    if bad:
        raise ValueError(
            f"non-finite input: {bad} NaN/Inf value(s) in {what} "
            f"{tuple(x.shape)} — they would silently corrupt the carried path "
            "metrics for the whole batch (validate=False to skip this check)"
        )


class StreamSession:
    """Online Viterbi decoder for one stream (or a batch sharing timing).

    Args:
      spec: a CodecSpec (or a bare ConvCode, promoted with defaults) — its
        ``terminated`` flag is the default for ``finish``/``decode_all``.
      batch: number of independent streams advanced in lock-step.
      chunk: trellis steps consumed per push (fixed).
      depth: truncated-traceback depth D; bits commit D steps behind the
        frontier.  Default 5*K; rounded up to a multiple of 32 for the
        packed backend.
      backend: 'fused' (carried unpacked scan kernel), 'fused_packed'
        (carried packed scan kernel + packed traceback kernel), or 'scan'
        (plain torch).
      inputs: 'bm' — push takes (B, chunk, M) branch-metric tables;
        'received' (fused_packed only) — push takes raw (B, chunk, n_out)
        channel symbols and the kernel computes the metrics.
      normalize: renormalize path metrics every chunk.
      mesh: not ported yet — anything but None raises.
      telemetry: obs.Telemetry bundle — an attached tracer records ``push``
        / ``finish`` spans; ``device_counters=True`` carries DeviceCounters
        through every push, read back only by :meth:`device_counter_report`.
      validate: reject non-finite chunks at push/finish time (one
        device-to-host sync per push).
      device: where the state lives and the kernels run.
    """

    def __init__(
        self,
        spec: Union[CodecSpec, ConvCode],
        batch: int = 1,
        chunk: int = 64,
        depth: Optional[int] = None,
        backend: str = "fused",
        normalize: bool = True,
        inputs: str = "bm",
        mesh: Optional[object] = None,
        telemetry: Optional[Telemetry] = None,
        validate: bool = True,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "StreamSession(mesh=...) is not ported to repro_torch yet "
                "(ROADMAP.md queue 1, item 9)"
            )
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.validate = bool(validate)
        self.spec = CodecSpec.of(spec)
        code = self.spec.code
        self.code = code
        self.batch = batch
        self.chunk = chunk
        self.device = resolve_device(device)
        self.depth = _w.default_depth(code) if depth is None else depth
        if self.depth < 1:
            raise ValueError("depth must be >= 1")
        self.backend = backend
        self.inputs = inputs
        self.packed, self.depth, self._plan, self._weights = _w.resolve_stream_backend(
            self.spec, chunk, self.depth, backend, inputs, self.device
        )
        self.state = _w.init_stream_state(
            code, batch, self.depth, chunk, packed=self.packed, device=self.device
        )
        #: the ring holds packed words (True until an odd tail unpacks it)
        self._ring_packed = self.packed
        self.offset = torch.zeros((batch,), dtype=torch.float32, device=self.device)
        self.t = 0  # trellis steps pushed so far
        self.committed = 0  # bits already handed to the caller
        self.closed = False
        self._step = _w.jitted_stream_step(code, backend=backend, normalize=normalize)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._tracer = self.telemetry.tracer
        self._counters = (
            _w.init_device_counters(batch, self.device)
            if self.telemetry.device_counters
            else None
        )

    @property
    def ring_size(self) -> int:
        return self.depth + self.chunk

    @property
    def lag(self) -> int:
        """Bits pushed but not yet committed (== depth at steady state)."""
        return self.t - self.committed

    def push(self, chunk_data) -> torch.Tensor:
        """Advance the stream by exactly ``chunk`` steps.

        Args:
          chunk_data: (B, chunk, M) branch-metric tables, or raw
            (B, chunk, n_out) symbols for ``inputs='received'``.
        Returns:
          (B, n_new) newly-committed bits on the session's device, n_new in
          [0, chunk] — 0 while the window warms up, exactly ``chunk`` at
          steady state.
        """
        if self.closed:
            raise RuntimeError("session is finished")
        chunk_data = torch.as_tensor(chunk_data, device=self.device)
        if tuple(chunk_data.shape[:2]) != (self.batch, self.chunk):
            raise ValueError(
                f"expected ({self.batch}, {self.chunk}, ·) chunk, got {tuple(chunk_data.shape)}"
            )
        if self.validate:
            _require_finite(chunk_data, "a chunk")
        if self.inputs == "received":
            chunk_data = self._plan.features(chunk_data, t0=self.t)
        weights = self._weights if self.packed else None
        with span(self._tracer, "push"):
            if self._counters is not None:
                self.state, bits, delta, self._counters = self._step(
                    self.state, chunk_data, weights, counters=self._counters
                )
            else:
                self.state, bits, delta = self._step(self.state, chunk_data, weights)
        self.offset = self.offset + delta
        self.t += self.chunk
        committable = max(0, self.t - self.depth)
        n_new = committable - self.committed
        self.committed = committable
        # the committed window covers positions [t-R, t-D); its valid tail
        # (positions >= previous commit point) is the last n_new entries.
        return bits[:, self.chunk - n_new:] if n_new else bits[:, :0]

    def _tail_bm(self, tail: torch.Tensor) -> torch.Tensor:
        """Branch-metric tables for an odd-length tail (raw symbols are
        converted through the metric plan, phased at the current step)."""
        if self.inputs == "received":
            return self._plan.bm_tables(tail, t0=self.t)
        return tail

    def finish(self, bm_tail=None, terminated: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Consume an optional odd-length tail and flush the window.

        Args:
          bm_tail: (B, r, ·) with 0 < r < chunk, or None (same input kind as
            ``push``).
          terminated: the stream ends in state 0 (encoder flushed); defaults
            to the spec's ``terminated`` flag.
        Returns:
          bits: (B, lag) the remaining uncommitted bits.
          metric: (B,) absolute winning path metric (normalization undone).
        """
        if self.closed:
            raise RuntimeError("session is finished")
        if terminated is None:
            terminated = self.spec.terminated
        if bm_tail is not None and bm_tail.shape[1]:
            bm_tail = torch.as_tensor(bm_tail, device=self.device)
            r = bm_tail.shape[1]
            if r >= self.chunk or bm_tail.shape[0] != self.batch:
                raise ValueError(f"tail must be (B, <chunk, ·), got {tuple(bm_tail.shape)}")
            if self.validate:
                _require_finite(bm_tail, "the finish() tail")
            tail_bm = self._tail_bm(bm_tail)
            ring = self.state.ring
            if self._ring_packed:
                # word shifts can't absorb an odd tail: unpack once, off the
                # hot path — the flush runs on the unpacked ring.
                ring = _w.unpack_ring(self.code, ring)
                self._ring_packed = False
            new_pm, bps = _w.jitted_chunk_forward(self.code)(self.state.pm, tail_bm)
            ring = torch.cat([ring[r:], bps], dim=0)
            self.state = _w.StreamState(pm=new_pm, ring=ring)
            self.t += r
        with span(self._tracer, "finish"):
            bits, metric = _w.jitted_stream_flush(
                self.code, terminated=terminated, packed=self._ring_packed
            )(self.state)
        n_rest = self.t - self.committed
        self.committed = self.t
        self.closed = True
        R = bits.shape[1]
        return (bits[:, R - n_rest:] if n_rest else bits[:, :0]), metric + self.offset

    def device_counter_report(self) -> dict:
        """Read the per-row device counters back (one transfer per field,
        never on the push path): {field: (B,) list} plus the derived
        ``merge_depth_mean``."""
        if self._counters is None:
            raise RuntimeError(
                "device counters are off — construct the session with "
                "telemetry=Telemetry(device_counters=True)"
            )
        leaves = {
            name: x.cpu().numpy() for name, x in zip(_w.DeviceCounters._fields, self._counters)
        }
        ticks = leaves["ticks"].clip(min=1)
        out = {name: x.tolist() for name, x in leaves.items()}
        out["merge_depth_mean"] = (leaves["merge_depth_sum"] / ticks).tolist()
        return out

    def decode_all(self, bm_tables, terminated: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Push a full (B, T, ·) block through this session and return the
        complete (B, T) decode + metric (tables or raw symbols per the
        session's ``inputs`` kind)."""
        bm_tables = torch.as_tensor(bm_tables, device=self.device)
        T = bm_tables.shape[1]
        out = []
        n_full = T // self.chunk
        for i in range(n_full):
            out.append(self.push(bm_tables[:, i * self.chunk:(i + 1) * self.chunk]))
        tail = bm_tables[:, n_full * self.chunk:]
        rest, metric = self.finish(tail if tail.shape[1] else None, terminated=terminated)
        out.append(rest)
        return torch.cat(out, dim=1), metric
