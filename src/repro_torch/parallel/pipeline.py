"""GPipe-style pipeline parallelism over a ``stage`` mesh axis.

The schedule is the classic fill/steady/drain: with n stages and M
microbatches, step t has stage s processing microbatch t - s, and each
stage's output hops to the next stage through ``collectives.ring_shift``
(the counterpart of the reference's ``ppermute``).  The mesh is
single-controller (parallel/mesh.py), so the reference's ``shard_map`` over
a ``scan`` becomes a host loop over the M + n - 1 steps that runs each
stage's layer on its device; a stage computes only at its steps that hold a
microbatch, which are the only steps the result reads.

Bubble fraction = (n-1)/(M+n-1) — reported by :func:`bubble_fraction` so
launch configs can budget microbatches.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_map

from repro_torch.parallel.collectives import ring_shift


def bubble_fraction(n_stages: int, microbatches: int) -> float:
    return (n_stages - 1) / (microbatches + n_stages - 1)


def pipeline_apply(
    layer_fn: Callable,
    stage_params,
    x_mb: torch.Tensor,
    *,
    mesh,
    axis: str = "stage",
) -> torch.Tensor:
    """Run ``layer_fn(params_s, h)`` across the pipeline stages of ``axis``.

    Args:
      stage_params: pytree whose leaves have leading dim n_stages; stage s's
        slice is placed on stage s's device.
      x_mb: (M, mb, ...) microbatched input.
    Returns:
      (M, mb, ...) outputs of the last stage, on the mesh's first device.
    """
    devices = mesh.shard_devices(axis)
    n, M = len(devices), x_mb.shape[0]
    params = [tree_map(lambda a, s=s, d=d: a[s].to(d), stage_params)
              for s, d in enumerate(devices)]
    xs = x_mb.to(devices[0])  # only stage 0 reads the input
    # the activation each stage received at the last hop
    h_in = [torch.zeros_like(xs[0], device=d) for d in devices]
    out = []
    for t in range(M + n - 1):
        # stage s holds microbatch t - s; an idle stage passes its input on
        ys = [layer_fn(params[s], xs[t] if s == 0 else h_in[s]) if 0 <= t - s < M else h_in[s]
              for s in range(n)]
        if t >= n - 1:
            out.append(ys[n - 1].to(devices[0]))
        h_in = ring_shift(mesh, axis, ys)
    return torch.stack(out)
