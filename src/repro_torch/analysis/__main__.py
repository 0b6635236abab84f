"""``python -m repro_torch.analysis [paths...]`` — run the repo-rule linter
(and, with ``--trace``, every registered hot path under its contract and the
sanitizer, on the card unless ``--device cpu``).  Exit status: 0 clean, 1
violations, 2 usage error.

One line per violation, a final ``summary`` line with counts.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.repo_lint import RULES, count_pragmas, lint_paths
from repro_torch.obs.log import get_logger


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-rule linter (RPR001-RPR005) + hot-path contract checks",
    )
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"],
                        help="files or directories to lint (default: src/repro_torch)")
    parser.add_argument("--trace", action="store_true",
                        help="also run every registered hot path under its contract "
                             "and the sanitizer")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where --trace runs the hot paths (default: the card)")
    parser.add_argument("--no-repo-rules", action="store_true",
                        help="skip the cross-file rule (RPR004 registry/test coverage)")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)
    log = get_logger("analysis.cli", quiet=args.quiet)

    paths = [Path(p) for p in args.paths]
    missing = [p for p in paths if not p.exists()]
    if missing:
        log.error("no such path", paths=",".join(map(str, missing)))
        return 2

    violations, n_files = lint_paths(paths, repo_rules=not args.no_repo_rules)
    for v in violations:
        log.warning(str(v))

    n_problems = 0
    n_paths = 0
    if args.trace:
        from repro_torch.analysis.hotpaths import check_hot_paths, problems

        report = check_hot_paths(device=args.device)
        n_paths = len(report)
        for name, entry in sorted(report.items()):
            found = problems(entry, args.device)
            n_problems += len(found)
            for p in found:
                log.warning(f"{name}: {p}")
            log.info("traced", path=name, backend=entry["backend"], ops=entry["ops"],
                     host_syncs=entry["host_syncs"], bound=entry["max_host_syncs"],
                     uploads=entry["uploads"], rebuilds=entry["rebuilds"],
                     launches=sum(entry["launches"].values()),
                     plain=sum(entry["plain"].values()), problems=len(found))

    log.info(
        "summary",
        files=n_files,
        rules=len(RULES),
        lint_violations=len(violations),
        hot_paths_traced=n_paths,
        contract_problems=n_problems,
        pragmas=sum(count_pragmas(paths).values()),
    )
    return 1 if (violations or n_problems) else 0


if __name__ == "__main__":
    sys.exit(main())
