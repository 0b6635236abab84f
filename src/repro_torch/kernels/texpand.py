"""``Texpand`` — the paper's custom instruction: one add-compare-select step
for every state of a batch of decoders, a CUDA kernel beside its plain
PyTorch version.

  ADD      cand_j = pm[2v + j] + bm[sym_j(s')]   (s' = u*S/2 + v)
  COMPARE  take1  = cand_1 < cand_0             (strict -> paper tie-break)
  SELECT   pm'    = take1 ? cand_1 : cand_0     (no clamp)

On a CUDA tensor :func:`texpand` launches ``csrc/texpand.cu`` (see its
header for the design); on a CPU tensor it runs :func:`texpand_plain`, which
follows the reference oracle (``kernels/ref.py:texpand_ref``): the one-hot
matmuls ``P_j @ pm + OH_j @ bm``, exact selections.  Each is counted under
``"texpand"`` in ``launch_counts`` / ``plain_counts``.

Layout: the reference's user layout, pm (B, S), bm (B, M) -> pm (B, S)
float32, bp (B, S) int32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import _build
from repro_torch.kernels.common import launch_counts, launch_guard, plain_counts, route
from repro_torch.roofline import op_cost

NAME = "texpand"


@functools.lru_cache(maxsize=None)
def _symbols(code: ConvCode, device: torch.device) -> torch.Tensor:
    """(S, 2) int32: the output symbol of the transition from predecessor
    2v + j into s' — the column the one-hot row ``OH_j[s']`` selects."""
    OH0, OH1 = code.branch_onehot_pair
    sym = np.stack([OH0.argmax(axis=1), OH1.argmax(axis=1)], axis=1).astype(np.int32)
    return torch.from_numpy(sym).to(device)


def texpand_plain(code: ConvCode, pm: torch.Tensor, bm: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`texpand`: the reference oracle's one-hot
    matmuls in the (B, S) user layout."""
    dev = pm.device
    P0, P1 = (torch.from_numpy(m).to(dev) for m in code.select_matrices)
    OH0, OH1 = (torch.from_numpy(m).to(dev) for m in code.branch_onehot_pair)
    cand0 = pm @ P0.T + bm @ OH0.T
    cand1 = pm @ P1.T + bm @ OH1.T
    take1 = cand1 < cand0
    return torch.where(take1, cand1, cand0), take1.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load("texpand")
    fn = lib.texpand_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def texpand(code: ConvCode, pm: torch.Tensor, bm: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused ACS step.

    Args:
      pm: (B, S) float32 path metrics.
      bm: (B, M) float32 branch metrics of this step.
    Returns:
      new_pm: (B, S) float32; bp: (B, S) int32 backpointer parity (ties -> 0).
    """
    S, M = code.n_states, code.n_symbols
    if pm.dim() != 2 or pm.shape[1] != S or pm.shape[0] < 1:
        raise ValueError(f"{NAME}: pm must be (B, {S}), got {tuple(pm.shape)}")
    if tuple(bm.shape) != (pm.shape[0], M):
        raise ValueError(f"{NAME}: bm must be ({pm.shape[0]}, {M}), got {tuple(bm.shape)}")
    for what, t in (("pm", pm), ("bm", bm)):
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: {what} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {what} must be contiguous")
    where = route(NAME, (pm, bm))
    B = pm.shape[0]
    with op_cost.kernel(NAME, op_cost.texpand_cost, B, S, M):
        if where == "cpu":
            plain_counts[NAME] += 1
            return texpand_plain(code, pm, bm)
        new_pm = torch.empty_like(pm)
        bp = torch.empty((B, S), dtype=torch.int32, device=pm.device)
        if where == "meta":
            return new_pm, bp
        lib, fn = _launcher()
        symbols = _symbols(code, pm.device)
        with launch_guard(pm):
            err = fn(pm.data_ptr(), bm.data_ptr(), symbols.data_ptr(), new_pm.data_ptr(),
                     bp.data_ptr(), B, S, M, torch.cuda.current_stream(pm.device).cuda_stream)
        _build.raise_on_error(lib, "texpand_error_string", NAME, err)
        launch_counts[NAME] += 1
        return new_pm, bp
