"""Collectives over a single-controller mesh, and the sequence-parallel
Viterbi decoder built on them.  (The LM's data-parallel train step reduces
its gradients with ``all_reduce``; ``psum_scalar`` sums per-shard scalars;
tensor-parallel serving reduces its row-parallel products with
``all_reduce``, gathers split heads, partials and experts with
``all_gather(dim=)``, its vocab-split logits with ``gather(dim=)``, and
hands each step's tokens to its shards with ``broadcast``.)

The Viterbi forward pass is a product in the (min,+) semiring, which is
associative, so a length-T decode splits across the ``model`` mesh axis:

  1. each shard computes its T/n chunk's (S, S) transfer matrix;
  2. one all-gather of the n matrices (n·S² floats a stream, independent
     of T);
  3. the exclusive (min,+) prefixes, a left fold over the shards;
  4. each shard re-scans its chunk from the metrics entering it to recover
     its survivors, and one walk over the stitched survivors gives the bits.

The reference runs this under ``shard_map``.  Here the mesh has one
controlling process (parallel/mesh.py), so the shard function is a Python
loop over ``mesh.shard_devices(axis)`` that launches each shard's kernels on
its device: in-specs and out-specs become slicing and concatenation,
``axis_index`` the loop index, and ``all_gather`` the function below — every
transfer between shards goes through this module.  Axes other than ``axis``
replicate in the reference (each replica computes the same values); here
each ``axis`` shard runs once, at index 0 of the other axes.

On the card the steps are the kernels #4 (``viterbi_scan_packed_window``,
through ``ops.chunk_transfer_maps``), #11 (``minplus_matmul`` from 1e30,
which is ``compose_maps``), #3 (``viterbi_scan_packed_carry``) when a shard's
length is a multiple of 32 or else #7 (``viterbi_scan_carry``) and the pack,
and #2 (``traceback_packed``); on a CPU mesh their plain versions.  Bits and
metrics equal the reference's bit for bit, soft metrics included: every add
is one float32 add, every min exact, and the fold keeps the reference's
association.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.trellis import ConvCode
from repro_torch.decode.spec import CodecSpec
from repro_torch.kernels import minplus as _minplus
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import viterbi_scan as _vscan
from repro_torch.kernels.common import PACK_BITS
from repro_torch.roofline.op_cost import tensor_bytes


#: collective name -> calls, so a hot-path check can show a path made no
#: transfer between shards (analysis/hotpaths.py)
calls: Counter = Counter()
#: collective name -> bytes of its results on one device (a gather's stacked
#: tensor, a shift's received tensor, a reduction's value), which
#: roofline/analysis.collective_bytes reads
nbytes: Counter = Counter()


def mesh_axis_size(mesh, axis: str) -> int:
    """Size of a named mesh axis, 0 when the mesh lacks it or is None (the
    planner branches on this)."""
    if mesh is None:
        return 0
    return int(mesh.shape.get(axis, 0))


def _shard_devices(mesh, axis: str, per_shard: Sequence[torch.Tensor], what: str):
    devices = mesh.shard_devices(axis)
    if len(per_shard) != len(devices):
        raise ValueError(f"{what} over {axis}={len(devices)} got {len(per_shard)} tensors")
    return devices


def gather(mesh, axis: str, per_shard: Sequence[torch.Tensor], device=None,
           dim: Optional[int] = None) -> torch.Tensor:
    """The shards' tensors (one per index of ``axis``, each on its shard's
    device) stacked along a new leading axis on ``device`` — the mesh's
    first shard's by default: one copy from each other device.  With
    ``dim`` they are concatenated along that dimension instead (the blocks
    of a split dimension, in shard order)."""
    calls["gather"] += 1
    devices = _shard_devices(mesh, axis, per_shard, "gather")
    out = _stack_on(per_shard, devices[0] if device is None else device, dim)
    nbytes["gather"] += tensor_bytes(out)
    return out


def _stack_on(per_shard: Sequence[torch.Tensor], device, dim: Optional[int] = None):
    dev = torch.device(device)
    parts = [t.to(dev) for t in per_shard]
    return torch.stack(parts) if dim is None else torch.cat(parts, dim=dim)


def all_gather(mesh, axis: str, per_shard: Sequence[torch.Tensor],
               dim: Optional[int] = None) -> List[torch.Tensor]:
    """:func:`gather` onto every shard's device: entry i of the result lies
    on shard i's device.  Shards that share a device share one stacked (or,
    with ``dim``, concatenated) tensor."""
    calls["all_gather"] += 1
    devices = _shard_devices(mesh, axis, per_shard, "all_gather")
    stacked: Dict[torch.device, torch.Tensor] = {}
    for dev in devices:
        if dev not in stacked:
            stacked[dev] = _stack_on(per_shard, dev, dim)
    nbytes["all_gather"] += tensor_bytes(stacked[devices[0]])
    return [stacked[dev] for dev in devices]


def broadcast(mesh, axis: str, x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` (on any device) on every shard's device of ``axis``: entry i of
    the result lies on shard i's device, shards that share a device share
    one tensor (``x`` itself on its own device)."""
    calls["broadcast"] += 1
    copies: Dict[torch.device, torch.Tensor] = {}
    devices = mesh.shard_devices(axis)
    for dev in devices:
        if dev not in copies:
            copies[dev] = x if x.device == dev else x.to(dev)
    nbytes["broadcast"] += tensor_bytes(x)
    return [copies[dev] for dev in devices]


def ring_shift(mesh, axis: str, per_shard: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each shard's tensor handed to the next shard of ``axis``, on its
    device, the last one's to the first — ``jax.lax.ppermute`` with the
    ring permutation ``[(i, (i + 1) % n)]``: entry i of the result is shard
    i - 1's tensor."""
    calls["ring_shift"] += 1
    devices = _shard_devices(mesh, axis, per_shard, "ring_shift")
    n = len(devices)
    nbytes["ring_shift"] += tensor_bytes(per_shard[0])
    return [per_shard[(i - 1) % n].to(dev) for i, dev in enumerate(devices)]


def reduce_across_shards(mesh, axis: str, per_shard, op: str = "sum") -> torch.Tensor:
    """Reduce a per-shard leading-axis array to a mesh-global value.

    ``per_shard``: (n_shards·k, ...) with rows [i·k, (i+1)·k) owned by shard
    i; ``op``: 'sum' | 'max' | 'min'.  Each shard reduces its rows on its
    device, the partial results are all-gathered, and the reduced (...)
    value is returned on the first shard's device (the reference returns it
    replicated on every shard).  A sum keeps the input's dtype, as jnp's.
    """
    calls["reduce_across_shards"] += 1
    try:
        local = {
            "sum": lambda x: torch.sum(x, dim=0, dtype=x.dtype),
            "max": lambda x: torch.amax(x, dim=0),
            "min": lambda x: torch.amin(x, dim=0),
        }[op]
    except KeyError:
        raise ValueError(f"op must be 'sum', 'max' or 'min', got {op!r}") from None
    devices = mesh.shard_devices(axis)
    rows = torch.as_tensor(per_shard)
    n = len(devices)
    if rows.dim() == 0 or rows.shape[0] % n:
        raise ValueError(f"per_shard's leading axis {tuple(rows.shape)[:1]} does not divide "
                         f"over {axis}={n}")
    k = rows.shape[0] // n
    partial = [local(rows[i * k:(i + 1) * k].to(dev)) for i, dev in enumerate(devices)]
    out = local(_stack_on(partial, devices[0]))
    nbytes["reduce_across_shards"] += tensor_bytes(out)
    return out


def sum_across_shards(mesh, axis: str, per_shard) -> torch.Tensor:
    """reduce_across_shards with op='sum'."""
    return reduce_across_shards(mesh, axis, per_shard, op="sum")


_REDUCERS = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def all_reduce(mesh, axis, per_shard: Sequence[Optional[torch.Tensor]],
               op: str = "sum") -> List[torch.Tensor]:
    """``jax.lax.psum`` (``pmax``, ``pmin``) over ``axis``: one tensor per
    shard, each on its shard's device (None: the shard holds no part),
    reduced; entry i of the result is the reduced tensor on shard i's
    device.  Shards that share a device share one result.

    Reduce, then broadcast: each device first reduces its own shards'
    tensors in shard order; the first device then adds each other device's
    part in device order, received one at a time (a device holds the
    result and at most one received tensor); the result is then copied to
    every other device.  So every device ends with the same bits, which
    keeps replicas that update from them equal.
    """
    calls["all_reduce"] += 1
    out = _reduce_broadcast(mesh, axis, per_shard, op)
    nbytes["all_reduce"] += tensor_bytes(out[0])
    return out


def _reduce_broadcast(mesh, axis, per_shard, op: str) -> List[torch.Tensor]:
    try:
        fn = _REDUCERS[op]
    except KeyError:
        raise ValueError(f"op must be 'sum', 'max' or 'min', got {op!r}") from None
    devices = _shard_devices(mesh, axis, per_shard, "all_reduce")
    local: Dict[torch.device, Optional[torch.Tensor]] = {}
    fresh = set()  # devices whose part is a buffer of this call's own
    for t, dev in zip(per_shard, devices):
        part = local.get(dev)
        if t is None:
            local.setdefault(dev, None)
        elif part is None:
            local[dev] = t
        elif dev in fresh:
            _accumulate(part, t, op)
        else:
            local[dev] = fn(part, t)
            fresh.add(dev)
    order = list(local)
    home = order[0]
    total, own = local[home], home in fresh
    for dev in order[1:]:
        if local[dev] is None:
            continue
        received = local[dev].to(home)
        if total is None:
            total, own = received, True
        elif own:
            _accumulate(total, received, op)
        else:
            total, own = fn(total, received), True
        del received
    if total is None:
        raise ValueError("all_reduce: no shard holds a part")
    results = {home: total}
    for dev in order[1:]:
        results[dev] = total.to(dev)
    return [results[dev] for dev in devices]


def _accumulate(acc: torch.Tensor, t: torch.Tensor, op: str) -> None:
    if op == "sum":
        acc.add_(t)
    else:
        torch.maximum(acc, t, out=acc) if op == "max" else torch.minimum(acc, t, out=acc)


def psum_scalar(mesh, axis, per_shard: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
    """The sum of the shards' scalars (0-dim tensors, one per shard of
    ``axis``), on every shard's device: :func:`all_reduce` of scalars."""
    calls["psum_scalar"] += 1
    out = _reduce_broadcast(mesh, axis, per_shard, "sum")
    nbytes["psum_scalar"] += tensor_bytes(out[0])
    return out


def viterbi_decode_seqparallel(
    code: Union[ConvCode, CodecSpec],
    bm_tables: torch.Tensor,
    mesh,
    axis: str = "model",
    terminated: Optional[bool] = None,
    capture: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-parallel Viterbi over the ``axis`` shards of ``mesh``.

    bm_tables: (B, T, M) with T divisible by the axis size (raises
    ValueError before any work otherwise).  ``code`` may be a ConvCode or a
    CodecSpec, whose ``terminated`` flag is the default when ``terminated``
    is omitted.  Returns (bits (B, T) int32, metric (B,) float32) on the
    first shard's device, equal to the sequential decoder's.

    ``capture``: an optional dict that receives the operands and results of
    every kernel launch, so each can be held against its plain version on
    exactly what the decode gave it — ``pass1`` and ``mats`` (each shard's
    windowed-scan arguments and (B, S, S) matrix), ``gathered`` and
    ``folds`` ({device: the (n, B, S, S) stack it folded} and {device:
    (the exclusive prefixes (n, B, S, S), the total)}), ``rescan`` and
    ``pieces`` (each shard's re-scan arguments and survivors), ``packed``
    (the stitched words) and ``walk`` (the traceback's arguments).
    """
    spec = CodecSpec.of(code)
    code = spec.code
    if terminated is None:
        terminated = spec.terminated
    devices = mesh.shard_devices(axis)
    n = len(devices)
    B, T, M = bm_tables.shape
    S = code.n_states
    if T % n:
        raise ValueError(f"seqparallel: T={T} does not divide over {axis}={n} shards")
    if S > _vscan.MAX_STATES:
        raise ValueError(f"seqparallel: S={S} exceeds the scan kernels' "
                         f"{_vscan.MAX_STATES} states")
    C = T // n
    home = devices[0]
    bm = bm_tables.to(torch.float32)
    # in-spec P(None, axis, None): shard i takes steps [i·C, (i+1)·C)
    local = [bm[:, i * C:(i + 1) * C].to(dev).contiguous() for i, dev in enumerate(devices)]

    # 1-2. each shard's transfer matrix (one whole chunk: no upload),
    # gathered onto every shard
    hi = np.array([C], np.int32)
    caps = [{} if capture is not None else None for _ in devices]
    mats = [_ops.chunk_transfer_maps(code, x, hi, cap)[:, 0] for x, cap in zip(local, caps)]
    gathered = all_gather(mesh, axis, mats)
    del mats

    # 3. the fold, once per distinct device (the reference folds on every
    # shard, to the same values)
    folds: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
    for dev, stack in zip(devices, gathered):
        if dev not in folds:
            folds[dev] = _minplus.prefix_maps(stack, compose=_minplus.compose_maps_kernel)

    # 4. each shard's re-scan from row 0 of its exclusive prefix: whole
    # packed words when C is a multiple of 32, else unpacked selects
    whole = C % PACK_BITS == 0
    rescan, pieces = zip(*(_ops.rescan_chunks(code, folds[dev][0][i][:, 0, :], x, whole)
                           for i, (dev, x) in enumerate(zip(devices, local))))
    del local
    # out-spec P(axis, ...): the survivors stitched along time on the home
    # device
    stitched = torch.cat([p.to(home) for p in pieces], dim=0)
    if capture is not None:
        capture.update(pass1=[c["pass1"] for c in caps], mats=[c["mats"] for c in caps],
                       gathered={dev: gathered[devices.index(dev)] for dev in folds},
                       folds=folds, rescan=list(rescan), pieces=list(pieces))
    del rescan, pieces, gathered
    out = _ops.walk_survivors(code, stitched, whole, folds[home][1][:, 0, :], terminated, T,
                              capture)
    if capture is not None:
        capture["packed"] = capture["walk"][1]
    return out
