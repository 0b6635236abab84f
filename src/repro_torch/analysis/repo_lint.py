"""Repo-rule AST linter for the port: the conventions ruff can't express.

Rules (RPR = "repro rule"), the reference's five re-pointed at
``src/repro_torch`` and at PyTorch's idioms:

  RPR001  no ``print()`` in ``src/repro_torch/`` — report through
          ``repro_torch.obs.log`` so output is level-gated and silenceable.
  RPR002  no raw ``device="cpu"`` / ``device="cuda"`` literal passed at a
          call site inside ``src/repro_torch/``.  The port resolves ONE
          device a decode (``kernels/common.py``: the kernel-or-plain rule
          follows the tensors' device); a literal at a call site pins one
          step to a device independently of the rest of the decode — the
          split-decode hazard the resolve-once policy exists to prevent.
          Forward the caller's device or resolve it through
          ``resolve_device``.  A default in a signature is not a call site;
          tests and scripts are not library code.
  RPR003  no host-sync idioms inside the hot-path scopes (all of
          ``stream/window.py``, the scheduler's ``step``/``_step_traced``,
          every ``kernels/`` module): the reference's ``np.asarray`` /
          ``np.array`` / ``float()`` / ``.item()`` /
          ``.block_until_ready()`` / ``jax.device_get``, and torch's
          ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
          ``torch.cuda.synchronize()`` and ``int()`` / ``bool()`` of an
          expression the AST can tell is a tensor (a ``torch.*`` call or a
          tensor reduction method).  The ONE sanctioned sync a scheduler
          tick (the committed bits' copy) carries an inline
          ``repr-lint: allow[RPR003]`` pragma; so does each host-only use,
          with its reason.
  RPR004  every ``register_decoder`` name must be on the port's coverage:
          ``EXPECTED_BACKENDS`` of the CPU parity file
          (tests/test_torch_decode.py) and ``CARD_BACKENDS`` of the card
          tests (tests/test_torch_gpu.py) — or carry a reasoned exemption in
          ``CARD_TEST_EXEMPT``.  The port keeps no golden files, so the card
          leg takes the place of the reference's golden-BER leg.
  RPR005  every registry backend must declare its code family explicitly:
          ``capabilities=BackendCapabilities(family="...", ...)``.

Suppression: append ``# repr-lint: allow[RPRnnn]`` (comma-separate several
codes) to the flagged line, with a justification.  Pragmas are line-scoped.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: rule code -> one-line description
RULES: Dict[str, str] = {
    "RPR001": "no print() in src/repro_torch — use repro_torch.obs.log",
    "RPR002": "no raw device=\"cpu\"/\"cuda\" literals at call sites — forward "
              "the caller's device or resolve it through resolve_device",
    "RPR003": "no host-sync idioms (np.asarray/np.array/float()/.item()/"
              ".tolist()/.cpu()/.numpy()/torch.cuda.synchronize()/int() or "
              "bool() of a tensor) in hot-path scopes",
    "RPR004": "every register_decoder name must ride the CPU parity grid "
              "(EXPECTED_BACKENDS) and the card tests (CARD_BACKENDS)",
    "RPR005": "registry backends must declare BackendCapabilities.family "
              "explicitly",
}

#: registry names exempt from RPR004's card-test leg, each with the reason
#: (the parity-grid leg still applies to them)
CARD_TEST_EXEMPT: Dict[str, str] = {}

#: hot-path scopes for RPR003: (path suffix or directory part, function names
#: or None for the whole module) — the per-tick device loop of the port.
HOT_PATH_SCOPES: Tuple[Tuple[str, Optional[frozenset]], ...] = (
    ("repro_torch/stream/window.py", None),
    ("repro_torch/stream/scheduler.py", frozenset({"step", "_step_traced"})),
    ("repro_torch/kernels/", None),
)

_PRAGMA_RE = re.compile(r"#\s*repr-lint:\s*allow\[([A-Z0-9,\s]+)\]")

#: attribute names whose call is a device->host sync idiom
_SYNC_ATTRS = frozenset({"item", "block_until_ready", "tolist", "cpu", "numpy"})
_NP_SYNC_FUNCS = frozenset({"asarray", "array"})
#: tensor methods whose result the AST can tell is a tensor
_TENSOR_REDUCTIONS = frozenset({
    "sum", "any", "all", "max", "min", "amax", "amin", "argmax", "argmin",
    "count_nonzero", "mean", "norm", "prod",
})
_DEVICE_LITERALS = ("cpu", "cuda")


@dataclasses.dataclass(frozen=True)
class LintViolation:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def find_pragmas(source: str) -> Dict[int, Set[str]]:
    """{line number: {rule codes allowed on that line}}."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(text)
        if m:
            out[i] = {c.strip() for c in m.group(1).split(",") if c.strip()}
    return out


def _is_name(node: ast.AST, name: str) -> bool:
    return isinstance(node, ast.Name) and node.id == name


def _attr_of(node: ast.AST, attrs: frozenset, modules: Tuple[str, ...]) -> Optional[str]:
    """'asarray' if node is np.asarray / numpy.asarray (etc.), else None."""
    if (
        isinstance(node, ast.Attribute)
        and node.attr in attrs
        and isinstance(node.value, ast.Name)
        and node.value.id in modules
    ):
        return node.attr
    return None


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for that attribute chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_tensor_expr(node: ast.AST) -> bool:
    """True where the AST alone shows ``node`` is a tensor: a ``torch.*``
    call, a tensor reduction method call, or a comparison / unary op / bool
    op over one."""
    if isinstance(node, ast.Call):
        if _dotted(node.func).startswith("torch."):
            return True
        return isinstance(node.func, ast.Attribute) and node.func.attr in _TENSOR_REDUCTIONS
    if isinstance(node, ast.UnaryOp):
        return _is_tensor_expr(node.operand)
    if isinstance(node, ast.Compare):
        return _is_tensor_expr(node.left) or any(_is_tensor_expr(c) for c in node.comparators)
    if isinstance(node, ast.BinOp):
        return _is_tensor_expr(node.left) or _is_tensor_expr(node.right)
    return False


class _FileLinter(ast.NodeVisitor):
    """Per-file rules: RPR001, RPR002, RPR003, RPR005."""

    def __init__(self, rel: str, source: str, in_src: bool):
        self.rel = rel
        self.in_src = in_src
        self.pragmas = find_pragmas(source)
        self.violations: List[LintViolation] = []
        self._func_stack: List[str] = []
        posix = rel.replace("\\", "/")
        self._hot_funcs: Optional[frozenset] = None
        self._hot_module = False
        for scope, funcs in HOT_PATH_SCOPES:
            if posix.endswith(scope) or (scope.endswith("/") and scope in posix):
                if funcs is None:
                    self._hot_module = True
                else:
                    self._hot_funcs = funcs

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if rule in self.pragmas.get(line, set()):
            return
        self.violations.append(LintViolation(
            rule=rule, path=self.rel, line=line,
            col=getattr(node, "col_offset", 0), message=message,
        ))

    def _in_hot_scope(self) -> bool:
        if self._hot_module:
            return True
        if self._hot_funcs is not None:
            return any(f in self._hot_funcs for f in self._func_stack)
        return False

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        if self.in_src:
            self._check_print(node)
            self._check_device_literal(node)
            self._check_register_decoder(node)
        if self._in_hot_scope():
            self._check_host_sync(node)
        self.generic_visit(node)

    def _check_print(self, node: ast.Call) -> None:
        if _is_name(node.func, "print"):
            self._flag("RPR001", node, "print() in library code — use repro_torch.obs.log")

    def _check_device_literal(self, node: ast.Call) -> None:
        for kw in node.keywords:
            if (
                kw.arg == "device"
                and isinstance(kw.value, ast.Constant)
                and isinstance(kw.value.value, str)
                and kw.value.value.split(":")[0] in _DEVICE_LITERALS
            ):
                self._flag("RPR002", node,
                           f"raw device={kw.value.value!r} literal — forward the "
                           "caller's device or resolve it through resolve_device")

    def _check_host_sync(self, node: ast.Call) -> None:
        np_fn = _attr_of(node.func, _NP_SYNC_FUNCS, ("np", "numpy"))
        if np_fn is not None:
            self._flag("RPR003", node, f"np.{np_fn}() host sync in a hot-path scope")
            return
        if _is_name(node.func, "float") and node.args:
            self._flag("RPR003", node, "float() host sync in a hot-path scope")
            return
        for conv in ("int", "bool"):
            if _is_name(node.func, conv) and node.args and _is_tensor_expr(node.args[0]):
                self._flag("RPR003", node, f"{conv}() of a tensor: host sync in a hot-path scope")
                return
        if _dotted(node.func) == "torch.cuda.synchronize":
            self._flag("RPR003", node, "torch.cuda.synchronize() in a hot-path scope")
            return
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _SYNC_ATTRS:
                self._flag("RPR003", node,
                           f".{node.func.attr}() host sync in a hot-path scope")
            elif _dotted(node.func) == "jax.device_get":
                self._flag("RPR003", node, "jax.device_get() host sync in a hot-path scope")

    def _check_register_decoder(self, node: ast.Call) -> None:
        if not _is_name(node.func, "register_decoder"):
            return
        caps = next((kw.value for kw in node.keywords if kw.arg == "capabilities"), None)
        if caps is None:
            self._flag("RPR005", node,
                       "register_decoder without capabilities= — declare "
                       "BackendCapabilities(family=...)")
            return
        if (isinstance(caps, ast.Call)
                and (_is_name(caps.func, "BackendCapabilities")
                     or (isinstance(caps.func, ast.Attribute)
                         and caps.func.attr == "BackendCapabilities"))
                and not any(kw.arg == "family" for kw in caps.keywords)):
            self._flag("RPR005", node,
                       "BackendCapabilities without an explicit family= — the "
                       "planner routes by family")
        # capabilities bound to a variable: out of static reach, skipped


def _iter_py_files(paths: Sequence[Path]) -> Iterable[Path]:
    for p in paths:
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def _repo_root(start: Path) -> Optional[Path]:
    cur = start.resolve()
    if cur.is_file():
        cur = cur.parent
    for cand in (cur, *cur.parents):
        if (cand / "pyproject.toml").exists():
            return cand
    return None


def registered_decoder_names(src_root: Path) -> Dict[str, Tuple[str, int]]:
    """{backend name: (file, line)} for every ``register_decoder("name", ...)``
    call site under ``src_root``."""
    out: Dict[str, Tuple[str, int]] = {}
    for path in _iter_py_files([src_root]):
        try:
            tree = ast.parse(path.read_text())
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and _is_name(node.func, "register_decoder")
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                out[node.args[0].value] = (str(path), node.lineno)
    return out


def _string_tuple(tree: ast.Module, name: str) -> List[str]:
    """The strings of a module-level ``NAME = ("a", "b", ...)``."""
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and _is_name(node.targets[0], name)
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            return [e.value for e in node.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return []


def check_backend_coverage(root: Path) -> List[LintViolation]:
    """RPR004 — cross-file: the port's registry names vs its test coverage."""
    src_root = root / "src" / "repro_torch"
    grid_path = root / "tests" / "test_torch_decode.py"
    card_path = root / "tests" / "test_torch_gpu.py"
    if not (src_root.exists() and grid_path.exists() and card_path.exists()):
        return []  # partial checkout (e.g. linting a single file): skip
    names = registered_decoder_names(src_root)
    expected = set(_string_tuple(ast.parse(grid_path.read_text()), "EXPECTED_BACKENDS"))
    on_card = set(_string_tuple(ast.parse(card_path.read_text()), "CARD_BACKENDS"))
    out: List[LintViolation] = []
    for name, (path, line) in sorted(names.items()):
        rel = _relpath(Path(path), root)
        if name not in expected:
            out.append(LintViolation(
                rule="RPR004", path=rel, line=line, col=0,
                message=f"backend {name!r} missing from tests/test_torch_decode.py "
                        "EXPECTED_BACKENDS (the CPU parity grid)",
            ))
        if name not in on_card and name not in CARD_TEST_EXEMPT:
            out.append(LintViolation(
                rule="RPR004", path=rel, line=line, col=0,
                message=f"backend {name!r} has no card test (CARD_BACKENDS in "
                        "tests/test_torch_gpu.py) and no CARD_TEST_EXEMPT entry",
            ))
    return out


def _relpath(path: Path, root: Optional[Path]) -> str:
    try:
        return str(path.resolve().relative_to(root)) if root else str(path)
    except ValueError:
        return str(path)


def lint_paths(
    paths: Sequence[Path],
    repo_rules: bool = True,
) -> Tuple[List[LintViolation], int]:
    """Lint every .py under ``paths``.  Returns (violations, files checked).

    ``repo_rules``: also run the cross-file rule (RPR004) against the repo
    root inferred from the first path (skipped when no pyproject/tests are
    reachable, e.g. linting a loose file)."""
    paths = [Path(p) for p in paths]
    root = _repo_root(paths[0]) if paths else None
    violations: List[LintViolation] = []
    n_files = 0
    for path in _iter_py_files(paths):
        try:
            source = path.read_text()
            tree = ast.parse(source)
        except (SyntaxError, UnicodeDecodeError) as e:
            violations.append(LintViolation(
                rule="RPR000", path=_relpath(path, root), line=1, col=0,
                message=f"unparseable: {e}",
            ))
            continue
        n_files += 1
        in_src = "src/repro_torch/" in str(path.resolve()).replace("\\", "/")
        linter = _FileLinter(_relpath(path, root), source, in_src)
        linter.visit(tree)
        violations.extend(linter.violations)
    if repo_rules and root is not None:
        violations.extend(check_backend_coverage(root))
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return violations, n_files


def count_pragmas(paths: Sequence[Path]) -> Dict[str, int]:
    """{rule: number of allow[] pragmas} across ``paths``, so a creeping
    pragma count is visible."""
    out: Dict[str, int] = {}
    for path in _iter_py_files([Path(p) for p in paths]):
        try:
            source = path.read_text()
        except (OSError, UnicodeDecodeError):
            continue
        for codes in find_pragmas(source).values():
            for code in codes:
                out[code] = out.get(code, 0) + 1
    return out
