"""Op-trace contract lint for the decode hot paths — the port's counterpart
of the reference's jaxpr lint.

A jaxpr is the list of equations one call of a jitted function runs.  Eager
PyTorch has no such object, so the counterpart is recorded: every aten op
dispatched during ONE call of the hot path, captured with a
``TorchDispatchMode``, each with its dtypes, devices and the first caller
frame inside ``repro_torch`` as its source line.  The reference's
"equations" count becomes the count of dispatched ops.

The hand-written kernels are launched through ``ctypes`` and never pass
through the dispatcher: the launch counters (``kernels/common.py``) cover
them, not this trace.  The checks keep the reference's kinds:

  float64      a float64 tensor anywhere — a violation of its own kind.
  dtype        a floating dtype outside ``metric_dtype`` +
               ``extra_float_dtypes``.
  collective   a ``c10d`` / ``_c10d_functional`` op not in
               ``allowed_collectives``.
  host-sync    the counterpart of a host callback: ``_local_scalar_dense``
               (``.item()``, ``float()``, ``int()``, ``bool()`` of a tensor)
               or a copy from the path's device to the host, outside the
               contract's ``sync_sites``.
  outputs      more tensor outputs than ``max_outputs``.
  device       new, card-specific (the transfer guard's counterpart): an op
               that runs on another device than the path's, or mixes host
               and device tensors, after the inputs were placed.  An
               explicit copy from the host to the path's device is an upload
               (counted in the trace, not a violation — as ``device_put`` is
               legal under the reference's guard).
"""
from __future__ import annotations

import dataclasses
import sys
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: dispatcher namespaces of the collectives (torch.distributed's ops)
COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional", "c10d_functional"})
#: ops that read a device value into a Python scalar
HOST_SYNC_OPS = frozenset({"_local_scalar_dense"})
#: ops that copy a tensor, possibly across devices
COPY_OPS = frozenset({"_to_copy", "copy_", "_copy_from", "_copy_from_and_resize"})
#: ops that compute nothing on the host: wrapping host data as a tensor
#: (``torch.tensor``, ``from_numpy``, a Python scalar in ``x[i] = v``),
#: detaching it, and staging it in page-locked memory for an upload
HOST_WRAP_OPS = frozenset({"lift_fresh", "lift_fresh_copy", "detach", "alias",
                           "_pin_memory", "is_pinned"})

_FLOATS = frozenset({torch.float16, torch.bfloat16, torch.float32, torch.float64,
                     torch.float8_e4m3fn, torch.float8_e5m2})

_TORCH_DIR = torch.__file__.rsplit("/", 1)[0] + "/"
_ANALYSIS_DIR = __file__.rsplit("/", 1)[0] + "/"
#: frames of the warnings machinery (a sync on the card is counted while its
#: warning is issued) are never a caller
_WARNINGS_FILE = warnings.__file__


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class Contract:
    """Declarative hot-path contract, checked op by op.

    Attributes:
      name: contract label used in reports (usually the backend name).
      metric_dtype: the one floating dtype the path may compute in; any other
        floating dtype (beyond ``extra_float_dtypes``) is a ``dtype``
        violation.  float64 is always a violation of its own kind.
      extra_float_dtypes: additional tolerated float dtypes.
      allowed_collectives: collectives this path may run: ``c10d`` op names
        and the mesh collectives of parallel/collectives.py by function name
        (``all_gather``, ``gather``, ...), whose calls ``check_hot_paths``
        counts; empty for every path that makes no transfer between shards.
      max_host_syncs: the path's host-sync bound on the card: the blocking
        copies and scalar reads one call makes, found by reading the code.
      sync_sites: where those syncs are, as ``"repro_torch/<file>.py:<line>"``
        — a host sync the trace sees anywhere else is a violation.
      max_outputs: bound on the tensors the path returns (None = unbounded).
      kernels: the hand-written kernels one call must launch on the card.
    """

    name: str
    metric_dtype: str = "float32"
    extra_float_dtypes: Tuple[str, ...] = ()
    allowed_collectives: frozenset = frozenset()
    max_host_syncs: int = 0
    sync_sites: Tuple[str, ...] = ()
    max_outputs: Optional[int] = None
    kernels: Tuple[str, ...] = ()

    def allowed_floats(self) -> frozenset:
        return frozenset((self.metric_dtype,) + self.extra_float_dtypes)


@dataclasses.dataclass(frozen=True)
class ContractViolation:
    """One broken guarantee: which contract, what kind, where."""

    contract: str
    kind: str        # "host-sync" | "collective" | "float64" | "dtype" | "outputs" | "device"
    op: str
    detail: str
    where: str       # "repro_torch/<file>.py:<line> (function)" of the op's caller

    def __str__(self) -> str:
        loc = f" at {self.where}" if self.where else ""
        return f"{self.contract}: {self.kind} violation — {self.detail} (op {self.op!r}){loc}"


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched op: its name, the dtypes and devices of its tensor
    arguments and results, and the caller line."""

    name: str
    namespace: str
    in_devices: Tuple[str, ...]
    out_devices: Tuple[str, ...]
    dtypes: Tuple[str, ...]
    where: str
    computes: bool = True  # False for HOST_WRAP_OPS and views


def caller_site() -> str:
    """``"repro_torch/<file>.py:<line> (function)"`` of the innermost frame
    of the live stack inside ``repro_torch`` (outside this analysis
    package), else of the innermost frame outside torch and the analysis
    package; "" when there is none."""
    frame = sys._getframe(1)
    fallback = ""
    while frame is not None:
        fname = frame.f_code.co_filename.replace("\\", "/")
        if (not fname.startswith(_ANALYSIS_DIR) and fname != _WARNINGS_FILE
                and not fname.startswith(_TORCH_DIR)):
            if "/repro_torch/" in fname:
                rel = "repro_torch/" + fname.rsplit("/repro_torch/", 1)[1]
                return f"{rel}:{frame.f_lineno} ({frame.f_code.co_name})"
            if not fallback and not fname.startswith("<"):
                fallback = f"{fname.rsplit('/', 1)[-1]}:{frame.f_lineno} ({frame.f_code.co_name})"
        frame = frame.f_back
    return fallback


def site_key(where: str) -> str:
    """``"repro_torch/x.py:12"`` of a ``caller_site`` string."""
    return where.split(" ", 1)[0]


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def placed(name: str, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors whose device matters to op ``name``: all of a copy's; for
    any other op a 0-dim host tensor is a scalar passed by value
    (``pm[..., 0] = 0.0`` dispatches ``fill_`` with one), not data moved
    between devices."""
    if name in COPY_OPS:
        return tensors
    return [t for t in tensors if not (t.dim() == 0 and t.device.type == "cpu")]


class OpRecorder(TorchDispatchMode):
    """Records every op dispatched while it is active (see module doc)."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::", 1)[-1]
        ins, outs = placed(name, _tensors((args, kwargs))), _tensors(out)
        self.ops.append(OpRecord(
            name=name,
            namespace=func.namespace,
            in_devices=tuple(sorted({str(t.device.type) for t in ins})),
            out_devices=tuple(sorted({str(t.device.type) for t in outs})),
            dtypes=tuple(sorted({_dtype_name(t.dtype) for t in ins + outs})),
            where=caller_site(),
            computes=not (func.is_view or name in HOST_WRAP_OPS),
        ))
        return out


def _is_host_sync(op: OpRecord, device: Optional[str]) -> bool:
    """A scalar read, or a copy from the path's device to the host."""
    if op.name in HOST_SYNC_OPS:
        return True
    return (op.name in COPY_OPS and device not in (None, "cpu")
            and device in op.in_devices and op.out_devices == ("cpu",))


def _is_upload(op: OpRecord, device: Optional[str]) -> bool:
    """An explicit copy from the host onto the path's device."""
    return (op.name in COPY_OPS and device not in (None, "cpu")
            and "cpu" in op.in_devices and op.out_devices == (device,))


def check_ops(ops: Sequence[OpRecord], contract: Contract,
              device: Optional[str] = None) -> List[ContractViolation]:
    """Every op of ``ops`` that breaks ``contract`` on a path whose inputs
    lie on ``device`` (a device type; None skips the device check)."""
    out: List[ContractViolation] = []
    allowed_floats = contract.allowed_floats()
    sites = {site_key(s) for s in contract.sync_sites}

    def flag(kind, op, detail):
        out.append(ContractViolation(contract=contract.name, kind=kind, op=op.name,
                                     detail=detail, where=op.where))

    for op in ops:
        if op.namespace in COLLECTIVE_NAMESPACES and op.name not in contract.allowed_collectives:
            flag("collective", op, "collective outside the contract allowlist")
        for dt in op.dtypes:
            if dt == "float64":
                flag("float64", op, "float64 value leaked into the hot path")
            elif getattr(torch, dt) in _FLOATS and dt not in allowed_floats:
                flag("dtype", op, f"{dt} value outside the declared metric dtype "
                                  f"{contract.metric_dtype!r}")
        if _is_host_sync(op, device):
            if site_key(op.where) not in sites:
                flag("host-sync", op, "host sync outside the contract's sync sites")
            continue
        if device is None or _is_upload(op, device):
            continue
        devices = set(op.in_devices) | set(op.out_devices)
        if devices == {"cpu"} and not op.computes:
            continue  # host data wrapped or viewed on its way up or back
        if devices and devices != {device}:
            flag("device", op, f"op on {sorted(devices)} in a path on {device!r}")
    return out


@dataclasses.dataclass
class OpTrace:
    """The ops one call dispatched and what it returned."""

    ops: List[OpRecord]
    outputs: object
    device: Optional[str]

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def uploads(self) -> int:
        return sum(_is_upload(op, self.device) for op in self.ops)


def _path_device(args) -> Optional[str]:
    devices = {t.device.type for t in _tensors(args)}
    if len(devices) > 1:
        raise ValueError(f"hot-path inputs on several devices: {sorted(devices)}")
    return devices.pop() if devices else None


def trace_contract(
    fn: Callable,
    args: Sequence,
    contract: Contract,
    device: Optional[str] = None,
) -> Tuple[OpTrace, List[ContractViolation]]:
    """Run ``fn(*args)`` once under an op recorder and check the ops against
    ``contract``.  ``device``: the path's device type (None: the device of
    the tensor arguments, which must be one).  Returns the trace (its ops
    and outputs) and the violations."""
    dev = device if device is not None else _path_device(args)
    with OpRecorder() as rec:
        result = fn(*args)
    violations = check_ops(rec.ops, contract, dev)
    n_out = len(_tensors(result))
    if contract.max_outputs is not None and n_out > contract.max_outputs:
        violations.append(ContractViolation(
            contract=contract.name, kind="outputs", op="<call>",
            detail=f"{n_out} outputs exceed the contract bound {contract.max_outputs}",
            where="",
        ))
    return OpTrace(ops=rec.ops, outputs=result, device=dev), violations
