"""Structured stdlib-logging wrapper for scripts and launch entry points.

Benchmarks and launchers used to report through bare ``print()`` — not
level-gated, not grep-able, impossible to silence in CI pipelines that only
want the JSON artifact.  This wrapper keeps the human-readable line but
routes it through ``logging`` with a ``key=value`` structured suffix:

    log = get_logger("bench.stream", quiet=args.quiet)
    log.info("online sustained", bits_per_s=123456, p95_s=0.41)
    # -> "online sustained bits_per_s=123456 p95_s=0.41"

``quiet=True`` gates the logger to WARNING, so ``--quiet`` script runs emit
nothing on stdout but still surface failures.  Handlers are installed once
per logger name and never propagate, so importing a benchmark module twice
(CI does, via the schema check) cannot double every line.
"""
from __future__ import annotations

import logging
import sys
from typing import Optional, TextIO


def kv(**fields) -> str:
    """Render fields as a ``k=v`` line fragment.  Floats compact to 6
    significant digits; strings with spaces are repr-quoted."""
    parts = []
    for k, v in fields.items():
        if isinstance(v, float):
            parts.append(f"{k}={v:.6g}")
        elif isinstance(v, str) and (" " in v or not v):
            parts.append(f"{k}={v!r}")
        else:
            parts.append(f"{k}={v}")
    return " ".join(parts)


class ObsLogger:
    """Thin wrapper: ``info("msg", key=val)`` == message + kv suffix."""

    def __init__(self, logger: logging.Logger):
        self._logger = logger

    def _emit(self, level: int, msg: str, fields) -> None:
        if fields and self._logger.isEnabledFor(level):
            msg = f"{msg} {kv(**fields)}" if msg else kv(**fields)
        self._logger.log(level, msg)

    def debug(self, msg: str = "", **fields) -> None:
        self._emit(logging.DEBUG, msg, fields)

    def info(self, msg: str = "", **fields) -> None:
        self._emit(logging.INFO, msg, fields)

    def warning(self, msg: str = "", **fields) -> None:
        self._emit(logging.WARNING, msg, fields)

    def error(self, msg: str = "", **fields) -> None:
        self._emit(logging.ERROR, msg, fields)

    def setLevel(self, level) -> None:
        self._logger.setLevel(level)


def get_logger(
    name: str,
    quiet: bool = False,
    stream: Optional[TextIO] = None,
) -> ObsLogger:
    """Level-gated structured logger writing plain lines to ``stream``
    (default stdout — scripts are reporting tools, their output IS stdout).

    Args:
      name: dotted logger name (``bench.stream``, ``launch.dryrun``).
      quiet: gate to WARNING — the ``--quiet`` flag every script exposes.
      stream: override the output stream (tests capture with StringIO).
    """
    logger = logging.getLogger(f"repro_torch.{name}")
    logger.propagate = False
    # one handler per logger, replaced (not appended) on reconfiguration so
    # repeated get_logger calls never multiply output lines
    handler = logging.StreamHandler(stream or sys.stdout)
    handler.setFormatter(logging.Formatter("%(message)s"))
    logger.handlers[:] = [handler]
    logger.setLevel(logging.WARNING if quiet else logging.INFO)
    return ObsLogger(logger)
