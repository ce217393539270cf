"""palmlint for the port — repo-specific static analysis + runtime sanitizer.

Static side (stdlib-only, runs in a bare lint job):

    python -m repro_torch.analysis src/repro_torch   # lint, exit 1 on findings
    python -m repro_torch.analysis --list-rules

Runtime side (torch/numpy land, opt-in):

    REPRO_SANITIZE=1 python ...   # lock-order + snapshot tripwires, armed
                                  # when repro_torch.core is imported

The static entry points are re-exported here; :mod:`.sanitize` is NOT
imported eagerly because it touches ``repro_torch.core`` (numpy/torch) and
the lint gate must work without either installed.
"""
from .base import CHECKERS, RULES, Finding, Module, Project, run_project
from .cli import build_project, collect_files, lint_source, main

__all__ = [
    "CHECKERS", "RULES", "Finding", "Module", "Project", "run_project",
    "build_project", "collect_files", "lint_source", "main",
]
