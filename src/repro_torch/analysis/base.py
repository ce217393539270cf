"""palmlint core — the repo-specific static-analysis framework, the
port's own copy (``repro_torch`` imports nothing of ``repro``).

The engine's correctness rests on invariants that used to live only in
prose (CONTRIBUTING.md "Concurrency invariants"): registry state mutates
only under the registry lock, published snapshots are immutable, jitted
screen passes stay pure, and the f32-screen / f64-certify precision split
is the whole exactness argument. This package machine-checks them.

Architecture:

* :class:`Module` — one parsed source file: AST, line table, and the
  per-line ``# palmlint: ignore[rule]`` annotations.
* :class:`Project` — every module under analysis plus cross-module
  indexes (functions by name, classes by name) so checkers that walk the
  call graph (trace-safety) resolve callees beyond file boundaries.
* :class:`Checker` — one rule family. Checkers register themselves in
  :data:`CHECKERS` via :func:`register` and implement
  ``check(project) -> Iterable[Finding]``.
* :func:`run_project` — runs the selected checkers and splits the
  results into live findings and annotation-suppressed ones.

Everything here is stdlib-only (``ast`` + ``re``): the lint gate must run
in a bare lint job, before numpy or torch is installed.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Type

#: rule id -> one-line description (the ``--list-rules`` catalog)
RULES: Dict[str, str] = {}

#: ``# palmlint: ignore[rule]`` / ``ignore[rule-a, rule-b]`` / ``ignore[*]``
_IGNORE_RE = re.compile(r"#\s*palmlint:\s*ignore\[([^\]]+)\]")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location."""

    path: str  # project-relative posix path
    line: int  # 1-based
    col: int  # 0-based (ast convention)
    rule: str
    message: str

    def render(self, fmt: str = "text") -> str:
        if fmt == "github":  # GitHub Actions error annotation
            return (f"::error file={self.path},line={self.line},"
                    f"col={self.col + 1},title=palmlint[{self.rule}]::"
                    f"{self.message}")
        return f"{self.path}:{self.line}:{self.col + 1}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class Module:
    """One parsed source file plus its ignore annotations."""

    path: str  # project-relative posix path
    source: str
    tree: ast.Module
    #: line (1-based) -> set of suppressed rule ids ("*" = all)
    ignores: Dict[int, set]

    @property
    def is_core(self) -> bool:
        return "/core/" in f"/{self.path}"

    @property
    def is_kernels(self) -> bool:
        return "/kernels/" in f"/{self.path}"

    @property
    def is_launch(self) -> bool:
        return "/launch/" in f"/{self.path}"


@dataclasses.dataclass
class FunctionInfo:
    """One function/method definition, indexed for call-graph walks."""

    module: Module
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    name: str  # bare name ("<lambda>" for lambdas)
    qualname: str  # Class.method or module-level name
    class_name: Optional[str] = None


def _parse_ignores(source: str) -> Dict[int, set]:
    out: Dict[int, set] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _IGNORE_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        if rules:
            out[i] = rules
    return out


def parse_module(path: Path, rel: str) -> Tuple[Optional[Module], Optional[Finding]]:
    """Parse one file; a syntax error becomes a ``parse-error`` finding
    (the gate must fail loudly on unparseable sources, not skip them)."""
    source = path.read_text(encoding="utf-8")
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return None, Finding(rel, e.lineno or 1, (e.offset or 1) - 1,
                             "parse-error", f"cannot parse: {e.msg}")
    return Module(path=rel, source=source, tree=tree,
                  ignores=_parse_ignores(source)), None


class Project:
    """Every module under analysis + cross-module lookup indexes."""

    def __init__(self, modules: Sequence[Module]):
        self.modules = list(modules)
        #: bare function/method name -> [FunctionInfo, ...]
        self.functions: Dict[str, List[FunctionInfo]] = {}
        #: class name -> (module, ClassDef) of the FIRST definition
        self.classes: Dict[str, Tuple[Module, ast.ClassDef]] = {}
        for mod in self.modules:
            self._index(mod)

    def _index(self, mod: Module) -> None:
        # every def is indexed — including functions nested inside other
        # functions (dryrun's local `build`/`query` closures are jit roots);
        # class_name is set only for direct class-body methods
        def visit(node: ast.AST, class_ctx: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    self.classes.setdefault(child.name, (mod, child))
                    visit(child, child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    qual = (f"{class_ctx}.{child.name}" if class_ctx
                            else child.name)
                    self.functions.setdefault(child.name, []).append(
                        FunctionInfo(mod, child, child.name, qual,
                                     class_ctx))
                    visit(child, None)  # defs nested in a method are plain
                else:
                    visit(child, class_ctx)

        visit(mod.tree, None)

    def resolve_call(self, name: str, mod: Module,
                     class_name: Optional[str] = None) -> Optional[FunctionInfo]:
        """Best-effort callee resolution by bare name.

        Preference order: a method of the caller's own class, a definition
        in the caller's own module, then a project-wide UNIQUE definition.
        Ambiguous names resolve to nothing — a missed edge only weakens
        the check, a wrong edge fabricates findings."""
        cands = self.functions.get(name, [])
        if not cands:
            return None
        if class_name is not None:
            own = [f for f in cands if f.class_name == class_name]
            if len(own) == 1:
                return own[0]
        local = [f for f in cands if f.module is mod]
        if len(local) == 1:
            return local[0]
        if len(cands) == 1:
            return cands[0]
        return None


class Checker:
    """Base class for one rule family; subclasses self-register."""

    name: str = ""
    description: str = ""

    def check(self, project: Project) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError


CHECKERS: Dict[str, Type[Checker]] = {}


def register(cls: Type[Checker]) -> Type[Checker]:
    assert cls.name, "checker must define a rule name"
    CHECKERS[cls.name] = cls
    RULES[cls.name] = cls.description
    return cls


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------
def attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name of an attribute/name chain: ``self._lock``,
    ``np.random.default_rng`` — None when the chain has non-name parts
    (calls, subscripts) in the middle."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    """The final callee name of a call: ``f`` for both ``f(x)`` and
    ``a.b.f(x)``."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def annotation_names(node: Optional[ast.AST]) -> set:
    """Every bare name appearing in an annotation (handles Optional[X],
    string annotations, subscripts)."""
    out: set = set()
    if node is None:
        return out
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return out
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def iter_functions(tree: ast.Module):
    """Yield (node, class_name) for every function/method def (one level
    of class nesting; nested defs yield with their enclosing class)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield item, node.name
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, None


def suppressed(finding: Finding, module: Module) -> bool:
    rules = module.ignores.get(finding.line)
    return bool(rules) and ("*" in rules or finding.rule in rules)


def run_project(project: Project,
                select: Optional[Sequence[str]] = None
                ) -> Tuple[List[Finding], List[Finding]]:
    """Run the (selected) checkers; returns (live, suppressed) findings,
    both sorted by location."""
    names = list(select) if select else sorted(CHECKERS)
    unknown = [n for n in names if n not in CHECKERS]
    if unknown:
        raise ValueError(f"unknown rule(s): {', '.join(unknown)}; "
                         f"known: {', '.join(sorted(CHECKERS))}")
    by_path = {m.path: m for m in project.modules}
    live: List[Finding] = []
    quiet: List[Finding] = []
    for name in names:
        for f in CHECKERS[name]().check(project):
            (quiet if suppressed(f, by_path[f.path]) else live).append(f)
    return sorted(live), sorted(quiet)
