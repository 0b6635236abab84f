"""CodecSpec — the immutable description of *what* is being decoded.

One spec bundles the convolutional code (trellis), the branch-metric kind
(``hard`` Hamming vs ``soft`` correlation), an optional puncturing pattern
(punctured positions are erasures) and whether the trellis is terminated.
A CodecSpec is hashable (puncture patterns are normalized to nested tuples).

Two code families: a feed-forward ``ConvCode`` ("conv", Viterbi-decoded)
and a recursive systematic ``RSCCode`` ("rsc", SISO/BCJR-decoded).  The
turbo family has its own spec, ``siso.turbo.TurboSpec``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.channel import (
    awgn,
    bpsk_modulate,
    bsc,
    hard_branch_metrics,
    soft_branch_metrics,
)
from repro_torch.core.encoder import encode
from repro_torch.core.puncture import pattern_mask, punctured_hard_metrics
from repro_torch.core.trellis import CODE_K3_STD, ConvCode
from repro_torch.siso.rsc import RSCCode

METRIC_KINDS = ("hard", "soft")


def spec_family(spec) -> str:
    """Code family of any decode spec: "conv" (feed-forward convolutional),
    "rsc" (recursive systematic, SISO-decoded), or "turbo" (TurboSpec).
    The planner and capability validation dispatch on it."""
    return getattr(spec, "family", "conv")


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """Immutable codec description shared by every decode backend.

    Attributes:
      code: a feed-forward ConvCode (Viterbi-decoded) or a recursive
        systematic RSCCode (SISO/BCJR-decoded; the planner routes by
        ``family``).
      metric: ``"hard"`` (Hamming distance over received bits) or ``"soft"``
        (correlation metric over real channel outputs).
      puncture: optional (n_out, period) 0/1 pattern; accepted as any
        array-like, stored as nested tuples so the spec stays hashable.
      terminated: the encoder appends K-1 flush bits so the trellis ends in
        state 0.  ``False`` decodes open-ended blocks: the traceback starts
        from the best frontier state instead.
    """

    code: Union[ConvCode, RSCCode] = CODE_K3_STD
    metric: str = "hard"
    puncture: Optional[Tuple[Tuple[int, ...], ...]] = None
    terminated: bool = True

    def __post_init__(self):
        if not isinstance(self.code, (ConvCode, RSCCode)):
            raise TypeError(
                f"code must be a repro_torch ConvCode or RSCCode, got "
                f"{type(self.code).__module__}.{type(self.code).__name__}"
            )
        if self.metric not in METRIC_KINDS:
            raise ValueError(f"metric must be one of {METRIC_KINDS}, got {self.metric!r}")
        if self.puncture is not None:
            pat = np.asarray(self.puncture)
            if pat.ndim != 2 or pat.shape[0] != self.code.n_out:
                raise ValueError(
                    f"puncture pattern must be (n_out={self.code.n_out}, period), "
                    f"got shape {pat.shape}"
                )
            object.__setattr__(
                self, "puncture", tuple(tuple(int(x) for x in row) for row in pat)
            )

    @classmethod
    def of(cls, obj: Union["CodecSpec", ConvCode]) -> "CodecSpec":
        """Normalize a bare ConvCode into a CodecSpec."""
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, ConvCode):
            return cls(code=obj)
        raise TypeError(f"expected CodecSpec or ConvCode, got {type(obj).__name__}")

    # ------------------------------ derived ------------------------------ #

    @property
    def family(self) -> str:
        return "rsc" if isinstance(self.code, RSCCode) else "conv"

    @property
    def table_width(self) -> int:
        """Last-axis width of the per-step decoder input: the (B, T, M)
        bm table for the Viterbi family, per-bit LLR columns for SISO."""
        return self.code.n_out if self.family == "rsc" else self.code.n_symbols

    @property
    def soft(self) -> bool:
        return self.metric == "soft"

    @property
    def puncture_array(self) -> Optional[np.ndarray]:
        return None if self.puncture is None else np.asarray(self.puncture)

    @property
    def n_flush(self) -> int:
        """Flush bits appended by the encoder (0 for open-ended streams)."""
        return self.code.constraint - 1 if self.terminated else 0

    def n_steps(self, n_info_bits: int) -> int:
        """Trellis steps for a block of ``n_info_bits`` information bits."""
        return n_info_bits + self.n_flush

    # ---------------------------- encode side ---------------------------- #

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        """(..., T) info bits -> (..., T + n_flush, n_out) int32 coded bits,
        with punctured positions zeroed (not transmitted)."""
        if self.family == "rsc":
            coded = self.code.encode(bits, terminate=self.terminated)
        else:
            coded = encode(self.code, bits, terminate=self.terminated)
        if self.puncture is not None:
            mask = pattern_mask(self.code, coded.shape[-2], self.puncture_array, coded.device)
            coded = (coded * mask).to(coded.dtype)
        return coded

    def channel(self, gen: torch.Generator, coded_bits: torch.Tensor, *,
                flip_prob: float = 0.0, snr_db: Optional[float] = None) -> torch.Tensor:
        """Simulate the channel this spec's metric kind expects: BSC for hard
        decisions, BPSK + AWGN for soft.  ``gen`` lives on the device of
        ``coded_bits``.  A knob for the other metric kind is rejected."""
        if self.soft:
            if snr_db is None:
                raise ValueError("soft metric channel needs snr_db")
            if flip_prob:
                raise ValueError("flip_prob is a hard-decision knob; soft channels use snr_db")
            return awgn(gen, bpsk_modulate(coded_bits), snr_db)
        if snr_db is not None:
            raise ValueError("snr_db is a soft-decision knob; hard channels use flip_prob")
        return bsc(gen, coded_bits, flip_prob)

    # ---------------------------- decode side ---------------------------- #

    def branch_metrics(self, received: torch.Tensor) -> torch.Tensor:
        """(..., T, n_out) received bits / channel values -> the per-step
        decoder input.

        Viterbi (conv) family: (..., T, M) branch-metric tables (to be
        minimized).  SISO (rsc) family: (..., T, n_out) per-coded-bit LLRs
        with the convention ``lambda = log P(0)/P(1)`` — soft channel values
        pass through (max-log is scale-invariant), hard bits map to +-1.
        Punctured positions are erasures (contribute 0) in both.
        """
        if self.family == "rsc":
            r = received.to(torch.float32)
            lam = r if self.soft else 1.0 - 2.0 * r
            if self.puncture is not None:
                lam = lam * pattern_mask(self.code, received.shape[-2], self.puncture_array,
                                         received.device)
            return lam
        if self.soft:
            if self.puncture is not None:
                mask = pattern_mask(self.code, received.shape[-2], self.puncture_array,
                                    received.device)
                received = received * mask  # erased positions correlate to 0
            return soft_branch_metrics(self.code, received)
        if self.puncture is not None:
            return punctured_hard_metrics(self.code, received, self.puncture_array)
        return hard_branch_metrics(self.code, received)

    def strip_flush(self, bits: torch.Tensor) -> torch.Tensor:
        """Drop the trailing flush bits from a (..., T) decode (no-op for
        unterminated specs)."""
        return bits[..., : bits.shape[-1] - self.n_flush] if self.n_flush else bits

    def describe(self) -> str:
        punct = "unpunctured" if self.puncture is None else f"punctured{self.puncture}"
        term = "terminated" if self.terminated else "open"
        if self.family == "rsc":
            head = (
                f"RSCCode(K={self.code.constraint}, fb={oct(self.code.feedback)}, "
                f"fwd={tuple(oct(g) for g in self.code.forward)}"
            )
        else:
            head = (
                f"ConvCode(K={self.code.constraint}, "
                f"polys={tuple(oct(g) for g in self.code.polys)}"
            )
        return f"{head}, S={self.code.n_states}) {self.metric}/{punct}/{term}"
