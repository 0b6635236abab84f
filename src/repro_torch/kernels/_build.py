"""Build the CUDA sources under ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so ``nvcc`` takes seconds, not minutes).  All
sources compile at once, one ``nvcc`` process each.  The libraries land in
``_build/<hash>/`` beside this package, keyed by a hash of every source and
of the flags, so an edited source rebuilds and an unchanged one loads as is.
``_build/`` is listed in ``.gitignore``.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import logging
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, List

log = logging.getLogger(__name__)

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE / "_build"

#: "compile" (one nvcc run of a source) and "load" (one library loaded) —
#: a steady-state call adds neither (analysis.guards counts them as rebuilds)
events: Counter = Counter()

#: Hopper with its arch-specific features (the ``a``), exact float math (no
#: --use_fast_math), and ptxas's register / shared-memory report.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Library:
    """One built source: where it is, how it was built, what nvcc said."""

    name: str
    path: Path
    command: List[str]
    log_path: Path

    @property
    def compiler_output(self) -> str:
        return self.log_path.read_text() if self.log_path.exists() else ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of repro_torch need the CUDA toolkit to build"
    )


def _sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build_dir() -> Path:
    """``_build/<hash of sources and flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, path in _sources().items():
        h.update(name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build_all() -> Dict[str, Library]:
    """Compile every source that has no library yet (all in parallel) and
    return ``{name: Library}``.  Raises with nvcc's output when one fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    libs: Dict[str, Library] = {}
    running = []
    for name, src in _sources().items():
        so = out_dir / f"lib{name}.so"
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        libs[name] = Library(name, so, cmd, out_dir / f"{name}.log")
        if so.exists():
            continue
        log.info("building %s: %s", name, " ".join(cmd))
        events["compile"] += 1
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((libs[name], tmp, proc))
    failed = []
    for lib, tmp, proc in running:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(lib.command)}\n{text}")
            continue
        lib.log_path.write_text(text)
        os.replace(tmp, lib.path)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    lib = ctypes.CDLL(str(build_all()[name].path))
    events["load"] += 1
    return lib


def raise_on_error(lib: ctypes.CDLL, error_string: str, kernel: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error code other than 0."""
    if err != 0:
        fn = getattr(lib, error_string)
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{kernel}: CUDA launch failed ({err}): {fn(err).decode()}")
