"""Static analysis & runtime contracts for the port's decode hot paths — the
counterparts of ``repro.analysis``.

Four layers:

  * :mod:`repro_torch.analysis.op_lint` — declarative :class:`Contract`\\ s
    checked op by op against the aten ops one call dispatches (float64,
    dtype policy, collectives, host syncs, output bounds, ops off the
    path's device).
  * :mod:`repro_torch.analysis.repo_lint` — AST rules RPR001–RPR005 (no
    print, no raw device literal at a call site, hot-path host-sync hygiene,
    registry/test coverage, explicit backend family), with line-scoped
    ``# repr-lint: allow[...]`` pragmas.
  * :mod:`repro_torch.analysis.guards` — the :func:`sanitized` runtime
    bundle (host-sync counter, NaN check, rebuild counter, transfer guard).
  * :mod:`repro_torch.analysis.hotpaths` — one catalog entry per registered
    decoder, run under all of the above (on the card by default).

CLI: ``python -m repro_torch.analysis src/repro_torch`` (add ``--trace`` to
also run every registered hot path).  Exit status 0 means clean.

Not ported, because they check what only a jaxpr has: the sub-jaxpr walk
(scan/while/cond/shard_map bodies — eager PyTorch runs those as Python
loops, whose ops the trace records one by one), ``jax.monitoring``'s
backend-compile events (no compiler runs here: ``rebuilds`` counts the CUDA
library builds instead), and the abstract trace on ShapeDtypeStructs (an op
trace needs a real call).
"""
from repro_torch.analysis.guards import (
    SanitizerReport,
    SanitizerSnapshot,
    TransferError,
    rebuild_count,
    sanitized,
)
from repro_torch.analysis.hotpaths import (
    HotPath,
    check_hot_paths,
    flatten_violations,
    hot_path_catalog,
    problems,
)
from repro_torch.analysis.op_lint import (
    COLLECTIVE_NAMESPACES,
    HOST_SYNC_OPS,
    Contract,
    ContractViolation,
    check_ops,
    trace_contract,
)
from repro_torch.analysis.repo_lint import (
    CARD_TEST_EXEMPT,
    RULES,
    LintViolation,
    count_pragmas,
    find_pragmas,
    lint_paths,
)

__all__ = [
    "CARD_TEST_EXEMPT",
    "COLLECTIVE_NAMESPACES",
    "Contract",
    "ContractViolation",
    "HOST_SYNC_OPS",
    "HotPath",
    "LintViolation",
    "RULES",
    "SanitizerReport",
    "SanitizerSnapshot",
    "TransferError",
    "check_hot_paths",
    "check_ops",
    "count_pragmas",
    "find_pragmas",
    "flatten_violations",
    "hot_path_catalog",
    "lint_paths",
    "problems",
    "rebuild_count",
    "sanitized",
    "trace_contract",
]
