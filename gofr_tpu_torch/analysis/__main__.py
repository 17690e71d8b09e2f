"""graftcheck CLI: ``python -m gofr_tpu_torch.analysis [paths...]``.

Exit 0 = no unsuppressed findings beyond the committed baseline;
exit 1 = new findings (printed one per line as ``path:line: RULE msg``)
or unparseable files.

Modes beyond the plain scan:

- ``--sarif out.sarif`` — also write a SARIF 2.1.0 artifact for CI.
- ``--timings`` — per-rule wall-clock summary on stderr.
- ``--changed-only BASE`` — analyze only files changed vs the git rev
  ``BASE`` (plus untracked), reusing cached findings for the rest.
- ``--pragma-audit`` — report stale ``# graftcheck: ignore`` pragmas.
- ``--local`` — module-local v1 analysis (no project graph); the
  regression tests pin what interprocedural mode buys over this.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

from gofr_tpu_torch.analysis import engine
from gofr_tpu_torch.analysis.rules import ALL_RULES, default_rules


def _changed_files(base: str) -> set:
    """Repo-relative posix paths of *.py files changed vs ``base``,
    plus untracked ones — the working-tree delta a pre-commit run
    cares about."""
    changed = set()
    for args in (["git", "diff", "--name-only", base, "--"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        proc = subprocess.run(
            args, cwd=engine.ROOT, capture_output=True, text=True,
            check=False)
        if proc.returncode != 0:
            raise SystemExit(
                f"graftcheck: git failed: {' '.join(args)}: "
                f"{proc.stderr.strip()}")
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line.endswith(".py"):
                changed.add(pathlib.PurePosixPath(line).as_posix())
    return changed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gofr_tpu_torch.analysis",
        description="graftcheck: serving-aware static analysis "
                    "(rule catalog: docs/references/static-analysis-torch.md)")
    parser.add_argument(
        "paths", nargs="*", type=pathlib.Path,
        help="files/directories to scan (default: the gofr_tpu_torch package)")
    parser.add_argument(
        "--baseline", type=pathlib.Path, default=engine.DEFAULT_BASELINE,
        help="grandfathered-findings file "
             "(default: scripts/graftcheck_torch_baseline.json)")
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline: report every unsuppressed finding")
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline from the current findings and exit 0")
    parser.add_argument(
        "--select", default="",
        help="comma-separated rule ids to run (default: all)")
    parser.add_argument(
        "--docs", type=pathlib.Path, default=None,
        help="metrics catalog for GT005 "
             "(default: docs/quick-start/observability.md)")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit")
    parser.add_argument(
        "--sarif", type=pathlib.Path, default=None, metavar="OUT",
        help="also write a SARIF 2.1.0 report to OUT")
    parser.add_argument(
        "--timings", action="store_true",
        help="print per-rule wall-clock timings to stderr")
    parser.add_argument(
        "--cache", type=pathlib.Path, default=engine.DEFAULT_CACHE,
        metavar="PATH",
        help="incremental cache file (default: .graftcheck_torch_cache.json; "
             "safe to delete anytime)")
    parser.add_argument(
        "--no-cache", action="store_true",
        help="disable the incremental cache for this run")
    parser.add_argument(
        "--changed-only", default=None, metavar="BASE",
        help="analyze only files changed vs git rev BASE (plus "
             "untracked), reusing cached findings for the rest; "
             "cross-file rules (GT005/GT013) are skipped in this mode")
    parser.add_argument(
        "--pragma-audit", action="store_true",
        help="report stale '# graftcheck: ignore' pragmas and exit "
             "(1 if any are stale)")
    parser.add_argument(
        "--local", action="store_true",
        help="module-local analysis: disable the cross-module project "
             "graph (v1 behavior)")
    opts = parser.parse_args(argv)

    if opts.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.rule_id}  {cls.title}")
        return 0

    select = [token.strip() for token in opts.select.split(",")
              if token.strip()] or None
    options = {}
    if opts.docs is not None:
        options["docs_catalog"] = opts.docs
    rules = default_rules(select=select, **options)
    paths = opts.paths or [engine.PACKAGE]
    interprocedural = not opts.local

    if opts.pragma_audit:
        stale = engine.audit_pragmas(
            paths=paths, rules=rules, interprocedural=interprocedural)
        for pragma in stale:
            print(pragma.render(), file=sys.stderr)
        if stale:
            print(f"graftcheck: {len(stale)} stale pragma(s)",
                  file=sys.stderr)
            return 1
        print("graftcheck: pragma audit OK — every pragma still "
              "suppresses a live finding")
        return 0

    restrict = None
    if opts.changed_only is not None:
        restrict = _changed_files(opts.changed_only)

    cache_path = None if opts.no_cache else opts.cache
    baseline = {} if (opts.no_baseline or opts.write_baseline) \
        else engine.load_baseline(opts.baseline)
    report = engine.run(paths=paths, rules=rules, baseline=baseline,
                        interprocedural=interprocedural,
                        cache_path=cache_path, restrict=restrict)

    if opts.write_baseline:
        engine.write_baseline(opts.baseline, report.new_findings)
        print(f"graftcheck: wrote {len(report.new_findings)} grandfathered "
              f"finding(s) to {opts.baseline}")
        return 0

    if opts.sarif is not None:
        from gofr_tpu_torch.analysis.sarif import write_sarif
        write_sarif(opts.sarif, report, rules)

    for error in report.parse_errors:
        print(error, file=sys.stderr)
    for finding in report.new_findings:
        print(finding.render(), file=sys.stderr)
    if opts.timings and report.timings:
        total = sum(report.timings.values())
        print("graftcheck: timings (s):", file=sys.stderr)
        for name, secs in sorted(report.timings.items(),
                                 key=lambda kv: -kv[1]):
            print(f"  {name:<14} {secs:8.3f}", file=sys.stderr)
        print(f"  {'total':<14} {total:8.3f}", file=sys.stderr)
    if report.from_cache:
        print("graftcheck: warm cache hit — report reconstructed "
              "without parsing", file=sys.stderr)
    if report.stale_baseline:
        # informational: the debt shrank — tighten the pin so it can't grow
        print(f"graftcheck: note: {len(report.stale_baseline)} baseline "
              f"entr{'y is' if len(report.stale_baseline) == 1 else 'ies are'}"
              f" stale (fixed?) — regenerate with --write-baseline",
              file=sys.stderr)
    if report.exit_code:
        print(f"graftcheck: {len(report.new_findings)} new finding(s) "
              f"({report.files_scanned} files, "
              f"{len(report.baselined)} baselined, "
              f"{report.suppressed} pragma-suppressed)", file=sys.stderr)
        return 1
    print(f"graftcheck: OK ({report.files_scanned} files, "
          f"{report.cached_files} from cache, "
          f"{len(report.baselined)} baselined, "
          f"{report.suppressed} pragma-suppressed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
