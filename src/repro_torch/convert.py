"""Bridge from the reference package's state to the port's.

The decoder has no learned weights; its parameters are the code tables
(rebuilt from constraint length + polynomials: ``(constraint, polys)`` of a
ConvCode, ``(constraint, feedback, forward)`` of an RSCCode), the
interleaver parameters (``(n, f1, f2)`` of a QPP interleaver, ``(rows,
cols)`` of a block interleaver), the folded metric operands (a
FusedMetricPlan's weight and bias) and the survivor words.  These helpers
take them as plain numpy arrays — what the reference's objects hold or
return — so both packages compute with the same operands without this
package importing the reference.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.trellis import ConvCode
from repro_torch.kernels.metrics import FusedMetricPlan
from repro_torch.siso.interleave import BlockInterleaver, QPPInterleaver
from repro_torch.siso.rsc import RSCCode


def code_from_arrays(constraint: int, polys: Sequence[int]) -> ConvCode:
    """The port's ConvCode for the reference's ``ConvCode(constraint, polys)``."""
    return ConvCode(int(constraint), tuple(int(g) for g in polys))


def rsc_code_from_arrays(constraint: int, feedback: int, forward: Sequence[int]) -> RSCCode:
    """The port's RSCCode for the reference's ``RSCCode(constraint, feedback,
    forward)``."""
    return RSCCode(int(constraint), int(feedback), tuple(int(g) for g in forward))


def qpp_from_arrays(n: int, f1: int, f2: int) -> QPPInterleaver:
    """The port's QPP interleaver for the reference's ``QPPInterleaver(n, f1,
    f2)``."""
    return QPPInterleaver(int(n), int(f1), int(f2))


def block_interleaver_from_arrays(rows: int, cols: int) -> BlockInterleaver:
    """The port's block interleaver for the reference's
    ``BlockInterleaver(rows, cols)``."""
    return BlockInterleaver(int(rows), int(cols))


def plan_from_arrays(
    code: ConvCode,
    metric: str,
    puncture,
    weight: np.ndarray,
    bias: np.ndarray,
) -> FusedMetricPlan:
    """A port FusedMetricPlan carrying the reference plan's (M, F) ``weight``
    and (M,) ``bias`` as given."""
    punct: Optional[tuple] = (
        None if puncture is None
        else tuple(tuple(int(v) for v in row) for row in np.asarray(puncture))
    )
    weight = np.asarray(weight, dtype=np.float32)
    bias = np.asarray(bias, dtype=np.float32)
    M = code.n_symbols
    if weight.ndim != 2 or weight.shape[0] != M or bias.shape != (M,):
        raise ValueError(f"weight must be ({M}, F) and bias ({M},), got "
                         f"{weight.shape} and {bias.shape}")
    return FusedMetricPlan(code=code, metric=metric, puncture=punct,
                           weight=weight, bias=bias)


def packed_from_reference(words: np.ndarray) -> torch.Tensor:
    """Reference kernel-layout survivor words, (W, S, B) uint32, -> the
    port's (W, B, S) int32 tensor holding the same 32 bits per word."""
    words = np.asarray(words)
    if words.dtype != np.uint32 or words.ndim != 3:
        raise ValueError(f"expected (W, S, B) uint32, got {words.shape} {words.dtype}")
    return torch.from_numpy(np.ascontiguousarray(words.transpose(0, 2, 1)).view(np.int32))


def packed_to_reference(packed: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`packed_from_reference`: (W, B, S) int32 -> (W, S, B)
    uint32 numpy."""
    if packed.dtype != torch.int32 or packed.dim() != 3:
        raise ValueError(f"expected (W, B, S) int32, got {tuple(packed.shape)} {packed.dtype}")
    return np.ascontiguousarray(packed.cpu().numpy().view(np.uint32).transpose(0, 2, 1))


def lm_params_from_arrays(tree, device) -> dict:
    """The reference's LM parameter tree, as nested dicts of numpy arrays
    (``np.asarray`` of each leaf), as the port's parameters on ``device``
    under the same keys: a copy, not a reshuffle (both stack the group
    dimension first)."""
    if isinstance(tree, dict):
        return {k: lm_params_from_arrays(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)
