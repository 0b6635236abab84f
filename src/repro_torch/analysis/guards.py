"""Runtime sanitizer guards for hot-path code.

:func:`sanitized` bundles the port's runtime checks as one context manager,
the counterparts of the reference's bundle (``repro/analysis/guards.py``):

  * host syncs — on the card, ``torch.cuda.set_sync_debug_mode("warn")``
    with its warnings captured and counted: every blocking copy (device to
    host, and a host-to-device copy from pageable memory) and every scalar
    read.  On the CPU a read is zero-copy and invisible to the dispatcher
    (as a JAX array's is on the CPU), so there the guard counts the Python
    routes a tensor takes to the host instead: ``Tensor.item / tolist /
    numpy / __float__ / __int__ / __bool__`` and ``np.asarray / np.array``
    of a tensor.  Each sync is recorded with its caller line.
  * NaNs — the counterpart of ``debug_nans``: raise ``FloatingPointError``
    at the first op whose floating output holds a NaN.  The check's own
    reads are not counted as the path's syncs.  The hand-written kernels
    run outside the dispatcher; a NaN they write surfaces at the next op
    that reads it.
  * rebuilds — the counterpart of recompiles: CUDA library builds and loads
    (``kernels/_build.events``) and misses of the per-weight caches
    (``kernels/viterbi_scan.row_builds``).  A steady-state call adds none.
  * transfers — the counterpart of the transfer guard: an op that mixes
    host and device tensors (a CPU index tensor in a CUDA op: an implicit
    copy; a 0-dim host tensor is a scalar passed by value, not a transfer)
    raises, outside :meth:`SanitizerReport.allow_transfers`.
    Explicit copies (``.to()``, ``copy_``) are legal, as ``device_put`` is
    under the reference's guard; host-to-device ones are counted in
    ``uploads`` (the scheduler's page-locked staging is one).

The patches are process-wide, so the guard is **not** reentrant or
thread-safe — it is a test/check harness, not a production wrapper.
Nesting raises.  Do not capture a CUDA graph inside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from collections import Counter
from typing import Iterator, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.op_lint import COPY_OPS, _tensors, caller_site, placed, site_key
from repro_torch.kernels import _build
from repro_torch.kernels import viterbi_scan as _vscan
from repro_torch.kernels.common import resolve_device

__all__ = ["SanitizerReport", "SanitizerSnapshot", "TransferError", "rebuild_count",
           "sanitized"]

_lock = threading.Lock()
_active = False

#: the Tensor methods through which a value reaches the host
_HOST_METHODS = ("item", "tolist", "numpy", "__float__", "__int__", "__bool__")
#: the warning ``set_sync_debug_mode("warn")`` issues at each synchronizing
#: call (its first use in a process also warns that the mode is a prototype:
#: that one is not a sync)
_SYNC_WARNING = "called a synchronizing CUDA operation"
#: factory ops whose output is uninitialised memory (not a NaN source)
_UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


def rebuild_count() -> int:
    """Process-wide CUDA library builds and loads plus weight-cache misses."""
    return sum(_build.events.values()) + sum(_vscan.row_builds.values())


class TransferError(RuntimeError):
    """An implicit host<->device transfer inside a guarded region."""


@dataclasses.dataclass(frozen=True)
class SanitizerSnapshot:
    """Point-in-time copy of the live counters."""

    host_syncs: int
    rebuilds: int
    uploads: int


class SanitizerReport:
    """Filled in while a :func:`sanitized` region runs.

    ``host_syncs`` (with ``sync_sites``: caller line -> count),
    ``uploads`` and ``rebuilds`` are live counters — readable mid-region and
    final once the region exits (``rebuilds`` freezes at its exit value)."""

    def __init__(self, device: str, transfer_guard: Optional[str], debug_nans: bool,
                 rebuild_base: int):
        self.device = device
        self.transfer_guard = transfer_guard
        self.debug_nans = debug_nans
        self.host_syncs = 0
        self.sync_sites: Counter = Counter()
        self.uploads = 0
        self._rebuild_base = rebuild_base
        self._frozen_rebuilds: Optional[int] = None
        self._allow_depth = 0
        self._internal = 0  # > 0 while the guard's own checks read values

    @property
    def rebuilds(self) -> int:
        if self._frozen_rebuilds is not None:
            return self._frozen_rebuilds
        return rebuild_count() - self._rebuild_base

    def _freeze(self) -> None:
        self._frozen_rebuilds = rebuild_count() - self._rebuild_base

    def snapshot(self) -> SanitizerSnapshot:
        return SanitizerSnapshot(host_syncs=self.host_syncs, rebuilds=self.rebuilds,
                                 uploads=self.uploads)

    def _count_sync(self, where: str) -> None:
        self.host_syncs += 1
        self.sync_sites[site_key(where)] += 1

    @contextlib.contextmanager
    def allow_transfers(self) -> Iterator[None]:
        """A sanctioned control-plane window (setup, admission, drain): the
        transfer guard is suspended while the counters keep running."""
        self._allow_depth += 1
        try:
            yield
        finally:
            self._allow_depth -= 1

    @contextlib.contextmanager
    def _quiet(self) -> Iterator[None]:
        """The guard's own reads: neither counted nor flagged as syncs."""
        self._internal += 1
        mode = torch.cuda.get_sync_debug_mode() if self.device == "cuda" else 0
        if mode:
            torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            if mode:
                torch.cuda.set_sync_debug_mode(mode)
            self._internal -= 1


class _RuntimeGuard(TorchDispatchMode):
    """The NaN check and the transfer guard, op by op."""

    def __init__(self, report: SanitizerReport):
        super().__init__()
        self.report = report

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rep = self.report
        name = func._schema.name.split("::", 1)[-1]
        ins = placed(name, _tensors((args, kwargs)))
        out = func(*args, **kwargs)
        outs = _tensors(out)
        devices = {t.device.type for t in ins + outs}
        if len(devices) > 1 and "cpu" in devices:
            if name in COPY_OPS:
                if all(t.device.type != "cpu" for t in outs):
                    rep.uploads += 1
            elif rep.transfer_guard is not None and not rep._allow_depth:
                raise TransferError(
                    f"implicit host<->device transfer: {name} on {sorted(devices)} "
                    f"at {caller_site()} (disallowed; use allow_transfers() for setup)")
        # a view produces no value (its base was checked where it was
        # written, or is uninitialised memory about to be written)
        if rep.debug_nans and not func.is_view and name not in _UNINITIALISED:
            with rep._quiet():
                for t in outs:
                    if (t.is_floating_point() and t.device.type in ("cpu", "cuda")
                            and bool(torch.isnan(t).any())):
                        raise FloatingPointError(
                            f"NaN produced by {name} at {caller_site()}")
        return out


class _HostSyncHooks:
    """Count the Python routes a CPU tensor takes to the host (module doc)."""

    _MISSING = object()

    def __init__(self, report: SanitizerReport):
        self.report = report
        self._depth = 0
        self._saved = {}

    def _counting(self, orig, is_target):
        hooks = self

        def counting(obj, *args, **kwargs):
            outer = hooks._depth == 0
            hooks._depth += 1
            try:
                if outer and is_target(obj) and not hooks.report._internal:
                    hooks.report._count_sync(caller_site())
                return orig(obj, *args, **kwargs)
            finally:
                hooks._depth -= 1

        counting._orig = orig
        return counting

    def __enter__(self):
        def is_tensor(obj):
            return isinstance(obj, torch.Tensor)

        for name in _HOST_METHODS:
            self._saved[name] = torch.Tensor.__dict__.get(name, self._MISSING)
            setattr(torch.Tensor, name, self._counting(getattr(torch.Tensor, name), is_tensor))
        self._np = (np.asarray, np.array)
        np.asarray = self._counting(np.asarray, is_tensor)
        np.array = self._counting(np.array, is_tensor)
        return self

    def __exit__(self, *exc):
        for name, saved in self._saved.items():
            if saved is self._MISSING:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, saved)
        np.asarray, np.array = self._np
        return False


@contextlib.contextmanager
def _card_sync_warnings(report: SanitizerReport) -> Iterator[None]:
    """``set_sync_debug_mode("warn")`` with each synchronizing call's warning
    counted at its caller line (read from the live stack, while the warning
    is being issued), and reset in a ``finally``."""
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=f".*{_SYNC_WARNING}")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if _SYNC_WARNING in str(message):
                if not report._internal:
                    report._count_sync(caller_site())
                return
            shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)


@contextlib.contextmanager
def sanitized(
    transfer_guard: Optional[str] = "disallow",
    debug_nans: bool = True,
    count_host_syncs: bool = True,
    device="cuda",
) -> Iterator[SanitizerReport]:
    """Run the enclosed block under the full sanitizer bundle on ``device``
    (the card by default — raises without one; ``"cpu"`` counts the CPU's
    host routes).  Yields a live :class:`SanitizerReport`::

        with sanitized() as rep:
            tick()                       # warm: may build
            base = rep.snapshot()
            tick()                       # steady state
        assert rep.rebuilds == base.rebuilds          # nothing rebuilt
        assert rep.host_syncs - base.host_syncs == 1  # the one sync

    ``transfer_guard=None`` / ``debug_nans=False`` / ``count_host_syncs=
    False`` disable individual layers."""
    global _active
    dev = resolve_device(device).type
    with _lock:
        if _active:
            raise RuntimeError("sanitized() does not nest")
        _active = True
    report = SanitizerReport(dev, transfer_guard, debug_nans, rebuild_count())
    try:
        with contextlib.ExitStack() as stack:
            if count_host_syncs:
                if dev == "cuda":
                    stack.enter_context(_card_sync_warnings(report))
                else:
                    stack.enter_context(_HostSyncHooks(report))
            if debug_nans or transfer_guard is not None:
                stack.enter_context(_RuntimeGuard(report))
            yield report
    finally:
        report._freeze()
        with _lock:
            _active = False
