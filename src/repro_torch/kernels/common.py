"""Shared kernel policy: survivor packing width, the kernel-or-plain rule,
the launch counters, and the distinct weight rows the scan kernels take.

Kernel or plain version.  Every kernel wrapper decides by the device of the
tensors it is given: a CUDA tensor launches the hand-written kernel (or the
wrapper raises — there is no fallback), a CPU tensor runs the plain PyTorch
version.  Anything that composes more than one kernel (the decode entry
points in ops.py) moves its inputs to ONE device up front, so every kernel
of that decode sees the same device and takes the same side of the rule —
one decode can never split across the kernel and the plain version.  A
``meta`` tensor takes a third route, a shape function: the wrapper returns
empty ``meta`` outputs of the kernel's shapes and dtypes and runs nothing,
so a decode can be costed (``roofline/op_cost.py``) without a device.

Costs.  Every wrapper runs inside ``roofline.op_cost.kernel`` with its
kernel's operation and byte formula: a cost counter that is active records
the same entry on every route and ignores the ops the wrapper dispatches.

Launch device.  A wrapper launches inside :func:`launch_guard` of its
operands, so the kernel runs on their card and on that card's stream
whatever card the caller has current (a mesh's shards may lie on any card).

Counters.  ``launch_counts[name]`` rises by one where a wrapper launches its
kernel and nowhere else; ``plain_counts[name]`` where a wrapper runs its
plain version.  A run proves it went through the kernels by zeroing both
(``reset_counts``) before it and reading them after.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np
import torch

#: Survivor bits packed per word along the time axis (32-bit words).
PACK_BITS = 32

#: kernel name -> launches of the hand-written kernel
launch_counts: Counter = Counter()
#: kernel name -> calls of the plain PyTorch version
plain_counts: Counter = Counter()


def reset_counts() -> None:
    """Zero every launch and plain-version counter."""
    launch_counts.clear()
    plain_counts.clear()


def route(name: str, tensors: Sequence[torch.Tensor]) -> str:
    """``"cuda"`` when ``tensors`` lie on a CUDA device (launch the kernel),
    ``"cpu"`` on the CPU (run the plain version), ``"meta"`` on the meta
    device (return empty outputs of the kernel's shapes).  Raises when they
    are spread over more than one device or lie on any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def on_card(name: str, tensors: Sequence[torch.Tensor]) -> bool:
    """True when ``tensors`` lie on a CUDA device, False on the CPU; raises
    on any other device (``meta`` included) or on several."""
    where = route(name, tensors)
    if where == "meta":
        raise ValueError(f"{name}: takes CUDA or CPU operands, got meta")
    return where == "cuda"


def launch_guard(t: torch.Tensor):
    """The context a kernel launch runs in: ``t``'s card made current, so
    the launch, its stream and the launcher's per-device set-up (shared
    memory opt-ins, SM counts) all belong to the card its operands lie on."""
    return torch.cuda.device(t.device)


def resolve_device(device) -> torch.device:
    """The device a decode runs on.  ``"cuda"`` without a usable card raises:
    a decode asked for the card never carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def distinct_rows(*tables: np.ndarray) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The distinct rows of (S, F) tables, in order of first appearance, and
    for each table the (S,) int32 index of each of its rows among them."""
    index: dict = {}
    maps = []
    for w in tables:
        # a host list of row indices: no device read
        maps.append(np.array([index.setdefault(row.tobytes(), len(index)) for row in w],  # repr-lint: allow[RPR003]
                             dtype=np.int32))
    F = tables[0].shape[1]
    rows = np.frombuffer(b"".join(index), dtype=np.float32).reshape(len(index), F).copy()
    return rows, maps
