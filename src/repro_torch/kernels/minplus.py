"""The batched (min,+) matrix product — a CUDA kernel beside its plain
PyTorch version — and the (min,+) state-map algebra of the tiled seams.

``minplus_matmul(a, b, init)`` computes ``C[n,i,j] = min(init, min_k
a[n,i,k] + b[n,k,j])`` in float32.  On a CUDA tensor it launches
``csrc/minplus.cu`` (see its header for the design: a square kernel for
I = K = J = S a power of two from 2 to 128 on 16-byte aligned matrices, the
general kernel for every other product; :func:`kernel_variant` says which
one takes given operands); on a CPU tensor it runs
:func:`minplus_matmul_plain`, the Pallas body ``_minplus_kernel`` of the
reference step for step (an accumulator from ``init``, min-reduced over
k-blocks).  Each is counted under ``"minplus_matmul"`` in ``launch_counts`` /
``plain_counts``.  ``init = 1e30`` is the reference's Pallas function;
``init = +inf`` is the unclamped jnp product (``core.viterbi.minplus_matmul``)
that the block-parallel decoder's associative scan combines chunk transfer
matrices with.  Every entry is one add and an exact min, so the product is
bit-exact in any reduction order; NaN propagates as in ``jnp.min``.

State-map algebra: a span of trellis steps is summarized by its (S, S)
*state map* M[i, j] = best metric of any path that enters the span in state
i and leaves it in state j.  Maps compose in the (min,+) semiring
(``compose_maps``), ``identity_map`` is the semiring unit, and
``prefix_maps`` left-folds a stack of per-tile maps into exclusive prefixes —
prefix p applied to the initial metric vector is *exactly* the full-length
forward path metrics at tile p's entry seam.  Each compose is one add and an
exact min per element, then the clamp to NEG_UNREACHABLE, in the reference's
order, so the maps equal the reference's bit for bit.  ``seam_argmin`` pins
the tie-break: the lowest state index among minimizers.  The tiled seam
composes a handful of maps with this plain algebra, not with the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.trellis import NEG_UNREACHABLE
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    launch_counts, launch_guard, on_card, plain_counts, route)
from repro_torch.roofline import op_cost

NAME = "minplus_matmul"

#: k per step of the plain version's accumulation: the reference's block_k
PLAIN_BLOCK_K = 128


def minplus_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                         init: float = NEG_UNREACHABLE) -> torch.Tensor:
    """Plain version of :func:`minplus_matmul`: the Pallas body step for
    step — an accumulator from ``init``, then per k-block the (min,+)
    partial product and ``acc = min(acc, part)`` (torch.amin and
    torch.minimum propagate NaN as jnp.min and jnp.minimum do)."""
    K, J = b.shape[-2], b.shape[-1]
    acc = torch.full(a.shape[:-1] + (J,), init, dtype=torch.float32, device=a.device)
    for k0 in range(0, K, PLAIN_BLOCK_K):
        ka = a[..., :, k0:k0 + PLAIN_BLOCK_K, None]  # (..., I, bk, 1)
        kb = b[..., None, k0:k0 + PLAIN_BLOCK_K, :]  # (..., 1, bk, J)
        acc = torch.minimum(acc, (ka + kb).amin(dim=-2))
    return acc


#: the arguments every entry of csrc/minplus.cu starts with: a, b, c, N0,
#: N1, the four batch strides, I, K, J
_OPERAND_TYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 4
                  + [ctypes.c_int] * 3)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load("minplus")
    fn = lib.minplus_matmul_launch
    fn.argtypes = _OPERAND_TYPES + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    variant = lib.minplus_matmul_variant
    variant.argtypes = _OPERAND_TYPES
    variant.restype = ctypes.c_int
    return lib, fn, variant


def _batch_strides(what: str, t: torch.Tensor) -> Tuple[int, int]:
    """Element strides of ``t``'s two batch levels; raises unless each
    matrix is row-major with contiguous rows (the batch may be strided)."""
    rows, cols = t.shape[-2:]
    if (cols > 1 and t.stride(-1) != 1) or (rows > 1 and t.stride(-2) != cols):
        raise ValueError(f"{NAME}: {what} must hold row-major matrices with contiguous rows, "
                         f"got strides {t.stride()}")
    return t.stride(0), t.stride(1)


def _check(a: torch.Tensor, b: torch.Tensor):
    """(batch, I, K, J, a4, b4, a's strides, b's strides) of a valid
    product; raises on any other."""
    if a.dim() not in (3, 4) or b.dim() != a.dim():
        raise ValueError(f"{NAME}: a and b must both be 3-D or 4-D, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    batch, (I, K), J = a.shape[:-2], a.shape[-2:], b.shape[-1]
    if b.shape[:-2] != batch or b.shape[-2] != K or min(I, K, J) < 1:
        raise ValueError(f"{NAME}: shapes {tuple(a.shape)} x {tuple(b.shape)} do not make a "
                         "batched (I, K) x (K, J) product with I, K, J >= 1")
    for what, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: {what} must be torch.float32, got {t.dtype}")
    a4, b4 = (a, b) if a.dim() == 4 else (a[:, None], b[:, None])
    return batch, I, K, J, a4, b4, _batch_strides("a", a4), _batch_strides("b", b4)


def kernel_variant(a: torch.Tensor, b: torch.Tensor) -> str:
    """Which kernel :func:`minplus_matmul` launches on these CUDA operands:
    ``"square S=<S>"`` or ``"general"`` — decided, as the launch decides it,
    from the shape and the alignment (``minplus_matmul_variant`` of
    ``csrc/minplus.cu``).  Launches nothing."""
    _, I, K, J, a4, b4, sa, sb = _check(a, b)
    if not on_card(NAME, (a, b)):
        raise ValueError(f"{NAME}: kernel_variant takes CUDA operands")
    # the output is a fresh allocation, so aligned: 0 stands in for it
    _, _, variant = _launcher()
    with launch_guard(a):
        S = variant(a4.data_ptr(), b4.data_ptr(), 0, *a4.shape[:2], *sa, *sb, I, K, J)
    return f"square S={S}" if S else "general"


def minplus_matmul(a: torch.Tensor, b: torch.Tensor,
                   init: float = NEG_UNREACHABLE) -> torch.Tensor:
    """Batched (min,+) product ``C[..., i, j] = min(init, min_k a[..., i, k]
    + b[..., k, j])``.

    Args:
      a: (N, I, K) or (N0, N1, I, K) float32; b: (N, K, J) or (N0, N1, K, J).
        The batch dims may be strided views (the slices an associative scan
        takes along its axis); each matrix must have contiguous rows.
      init: the accumulator's start: 1e30 (the reference's Pallas function)
        or +inf (the unclamped product of the block-parallel decoder).
    Returns:
      (N, I, J) or (N0, N1, I, J) float32, contiguous.  An empty batch
      returns an empty tensor without a launch.
    """
    batch, I, K, J, a4, b4, sa, sb = _check(a, b)
    where = route(NAME, (a, b))
    if batch.numel() == 0:
        return torch.empty(batch + (I, J), dtype=torch.float32, device=a.device)
    with op_cost.kernel(NAME, op_cost.minplus_cost, batch.numel(), I, K, J):
        if where == "cpu":
            plain_counts[NAME] += 1
            return minplus_matmul_plain(a, b, init)
        out = torch.empty(batch + (I, J), dtype=torch.float32, device=a.device)
        if where == "meta":
            return out
        N0, N1 = a4.shape[:2]
        lib, fn, _ = _launcher()
        with launch_guard(a):
            err = fn(a4.data_ptr(), b4.data_ptr(), out.data_ptr(), N0, N1, *sa, *sb, I, K, J,
                     init, torch.cuda.current_stream(a.device).cuda_stream)
        _build.raise_on_error(lib, "minplus_error_string", NAME, err)
        launch_counts[NAME] += 1
        return out


def identity_map(n_states: int, batch_shape: tuple = (), device="cpu") -> torch.Tensor:
    """The (min,+) unit: 0 on the diagonal, +inf (NEG_UNREACHABLE) off it."""
    eye = torch.eye(n_states, dtype=torch.bool, device=device)
    unit = torch.where(eye, 0.0, NEG_UNREACHABLE).to(torch.float32)
    return unit.expand(tuple(batch_shape) + (n_states, n_states))


def compose_maps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sequence a's span followed by b's: ``c[i,j] = min_k a[i,k] + b[k,j]``,
    clamped so stacked unreachable (BIG + BIG) entries stay at the semiring
    +inf.  a, b: (..., S, S) with matching batch dims."""
    c = (a[..., :, :, None] + b[..., None, :, :]).amin(dim=-2)
    return torch.clamp(c, max=NEG_UNREACHABLE)


def compose_maps_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`compose_maps` through :func:`minplus_matmul` from 1e30 (the
    clamp is the accumulator's start), the same bits: the kernel on CUDA
    operands, its plain version on the CPU.  a, b: (N, S, S)."""
    return minplus_matmul(a, b, NEG_UNREACHABLE)


def prefix_maps(mats: torch.Tensor, compose=compose_maps):
    """Exclusive (min,+) prefixes of a stack of per-tile state maps.

    mats: (P, ..., S, S), tile 0 first.  Returns ``(excl, total)`` where
    ``excl[p] = mats[0] ∘ ... ∘ mats[p-1]`` (the identity at p = 0) and
    ``total`` composes all P maps — a left fold, the reference's association
    order.  ``compose`` is one step of the fold: :func:`compose_maps`, or
    :func:`compose_maps_kernel` (same bits) for (P, N, S, S) stacks.
    """
    S = mats.shape[-1]
    acc = identity_map(S, mats.shape[1:-2], mats.device)
    excl = []
    for m in mats:
        excl.append(acc)  # the *exclusive* prefix
        acc = compose(acc, m)
    return torch.stack(excl), acc


def tile_entry_metrics(excl: torch.Tensor, init_state: int = 0) -> torch.Tensor:
    """Forward path metrics entering each tile, for paths that start the
    full sequence in ``init_state``: excl (P, ..., S, S) -> (P, ..., S)."""
    return excl[..., init_state, :]


def seam_argmin(metrics: torch.Tensor) -> torch.Tensor:
    """Winning state on a seam metric vector (..., S) -> (...) int32; ties go
    to the LOWEST state index (torch.argmin's first-occurrence rule, as
    jnp.argmin's and the open-trellis frontier's)."""
    return torch.argmin(metrics, dim=-1).to(torch.int32)
