"""palmlint CLI — ``python -m repro_torch.analysis [paths…]``.

Exit codes: 0 clean (suppressed findings allowed), 1 unannotated findings,
2 usage error. ``--format github`` emits GitHub Actions error
annotations so CI findings land on the PR diff.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from . import checkers  # noqa: F401  (registers the rule families)
from .base import CHECKERS, RULES, Finding, Module, Project, parse_module, run_project

_SKIP_DIRS = {".git", "__pycache__", ".venv", "node_modules",
              "palmlint_fixtures", "torch_palmlint_fixtures"}


def collect_files(paths: Sequence[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(
                f for f in path.rglob("*.py")
                if not (set(f.parts) & _SKIP_DIRS)))
        elif path.suffix == ".py":
            files.append(path)
    return files


def build_project(files: Sequence[Path],
                  root: Optional[Path] = None
                  ) -> tuple[Project, List[Finding]]:
    root = root or Path.cwd()
    modules: List[Module] = []
    errors: List[Finding] = []
    for f in files:
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        mod, err = parse_module(f, rel)
        if err is not None:
            errors.append(err)
        else:
            modules.append(mod)
    return Project(modules), errors


def lint_source(source: str, path: str = "<string>",
                select: Optional[Sequence[str]] = None,
                extra_modules: Sequence[Module] = ()) -> List[Finding]:
    """Lint a raw source string (the seeded-regression test entry point).
    Returns only LIVE findings; ``# palmlint: ignore`` still applies."""
    import ast as _ast
    tree = _ast.parse(source, filename=path)
    from .base import _parse_ignores
    mod = Module(path=path, source=source, tree=tree,
                 ignores=_parse_ignores(source))
    project = Project([mod, *extra_modules])
    live, _ = run_project(project, select)
    return [f for f in live if f.path == path]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="palmlint",
        description="repo-specific invariant checks (concurrency, "
                    "snapshot immutability, trace safety, collective "
                    "divergence, precision, TF32)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--select", action="append", default=None,
                    metavar="RULE", help="run only these rules "
                    "(repeatable); default: all")
    ap.add_argument("--format", choices=["text", "github"], default="text")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print findings silenced by "
                         "`# palmlint: ignore[rule]` annotations")
    args = ap.parse_args(argv)

    if args.list_rules:
        width = max(len(n) for n in RULES)
        for name in sorted(RULES):
            print(f"{name:<{width}}  {RULES[name]}")
        return 0

    files = collect_files(args.paths or ["src/repro_torch"])
    if not files:
        print(f"palmlint: no python files under {args.paths}",
              file=sys.stderr)
        return 2
    project, parse_errors = build_project(files)
    try:
        live, suppressed = run_project(project, args.select)
    except ValueError as e:
        print(f"palmlint: {e}", file=sys.stderr)
        return 2
    live = sorted(parse_errors + live)

    for f in live:
        print(f.render(args.format))
    if args.show_suppressed:
        for f in suppressed:
            print(f"suppressed: {f.render('text')}")
    n_rules = len(args.select) if args.select else len(CHECKERS)
    print(f"palmlint: {len(files)} files, {n_rules} rules, "
          f"{len(live)} finding(s), {len(suppressed)} suppressed",
          file=sys.stderr)
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
