"""snapshot-immutability — published snapshots and plans are read-only.

The epoch machinery only works because a published ``RunSet`` —
and everything a query derives from it: the ``QueryPlan``, its
``*Source`` entries — is immutable. A reader holding epoch N must see
epoch N forever; a PP hack (temporarily overwriting ``t_min`` /
``t_max`` on runs inside a pinned snapshot) is exactly the bug class this
rule exists to keep dead.

Flags, outside the owning class's constructors:

* attribute assignment on a value known to be a protected type
  (``snap.epoch = …``, ``plan.k = …``);
* in-place container mutation on a protected value's fields
  (``plan.sources.append(…)``, ``snap.levels[0] = …``);
* attribute assignment on loop variables drawn *out of* a protected
  value's containers (``for run in snap.levels[i]: run.t_min = …`` —
  snapshot contents are as frozen as the snapshot);
* ``object.__setattr__`` frozen-dataclass bypasses on protected values;
* a protected class declared as a dataclass without ``frozen=True`` when
  the catalog says it must be frozen (``RunSet``).

Type inference is deliberately local and conservative: parameter
annotations, ``x: RunSet`` annotated assigns, direct constructor calls
(``x = QueryPlan(…)``), and a small producer map of registry/index
methods known to return snapshots or plans. A value the checker cannot
type is never flagged.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional

from .base import (
    Checker, Finding, Module, Project, attr_chain, call_name,
    iter_functions, register,
)

#: type names whose instances must never mutate after construction.
#: The set includes the decision-record family: the autotuner's
#: feedback loop and the BENCH adaptation traces assume published
#: decisions never change after the fact.
def _is_protected_type(name: str) -> bool:
    return (name in {"RunSet", "QueryPlan", "SourceOps",
                     "Recommendation", "TierDecision", "RationaleEntry",
                     "DecisionRecord", "Knobs", "WorkloadKey",
                     "GatewayStats"}
            or name.endswith("Source"))


#: methods whose return value is a protected type (producer map)
PRODUCERS: Dict[str, str] = {
    "current": "RunSet",   # RunRegistry.current()
    "pin": "RunSet",       # RunRegistry.pin() -> pinned snapshot
    "plan": "QueryPlan",   # CLSM.plan()
}

#: container methods that mutate their receiver in place
MUTATOR_METHODS = {
    "append", "extend", "insert", "remove", "pop", "clear", "sort",
    "reverse", "update", "setdefault", "popitem", "add", "discard",
}

CONSTRUCTORS = {"__init__", "__post_init__", "__new__"}

#: classes the catalog requires to be frozen dataclasses
MUST_BE_FROZEN = {"RunSet", "Recommendation", "TierDecision",
                  "RationaleEntry", "DecisionRecord", "Knobs",
                  "WorkloadKey", "GatewayStats"}


def _dataclass_frozen(cls: ast.ClassDef) -> Optional[bool]:
    """True/False if ``cls`` is a dataclass (frozen or not); None if it is
    not decorated as a dataclass at all."""
    for dec in cls.decorator_list:
        chain = attr_chain(dec.func if isinstance(dec, ast.Call) else dec)
        if chain not in {"dataclass", "dataclasses.dataclass"}:
            continue
        if not isinstance(dec, ast.Call):
            return False
        for kw in dec.keywords:
            if kw.arg == "frozen":
                return isinstance(kw.value, ast.Constant) and \
                    kw.value.value is True
        return False
    return None


class _FnScope:
    """Per-function type environment: var name -> protected type name, and
    var name -> 'contents of <type>' for values drawn out of snapshots."""

    def __init__(self):
        self.types: Dict[str, str] = {}
        self.contents: Dict[str, str] = {}

    def learn(self, name: str, type_name: Optional[str]):
        if type_name and _is_protected_type(type_name):
            self.types[name] = type_name
        else:
            # reassignment to an untyped value clears the binding
            self.types.pop(name, None)
            self.contents.pop(name, None)


def _outer_annotation(node: Optional[ast.AST]) -> Optional[str]:
    """The *outermost* type name of an annotation, unwrapping string
    annotations and ``Optional[X]`` / ``Final[X]``. Containers OF a
    protected type (``List[RationaleEntry]``, ``Dict[Knobs, _Arm]``) stay
    untyped on purpose: the container is mutable even when its elements
    are frozen — only a value whose own type is protected is guarded."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(node, ast.Subscript):
        head = attr_chain(node.value)
        if head and head.split(".")[-1] in {"Optional", "Final"}:
            return _outer_annotation(node.slice)
        return None
    if isinstance(node, (ast.Name, ast.Attribute)):
        chain = attr_chain(node)
        return chain.split(".")[-1] if chain else None
    return None


def _infer_value_type(value: ast.AST) -> Optional[str]:
    """Protected type name of an expression, if statically knowable."""
    if isinstance(value, ast.Call):
        name = call_name(value)
        if name and _is_protected_type(name):
            return name
        if name in PRODUCERS:
            return PRODUCERS[name]
        if name == "replace":  # dataclasses.replace(snap, …) keeps the type
            if value.args:
                return _infer_value_type(value.args[0])
    elif isinstance(value, ast.Name):
        return None  # handled via the scope env by the caller
    return None


@register
class SnapshotImmutabilityChecker(Checker):
    name = "snapshot-immutability"
    description = ("RunSet / QueryPlan / *Source values (and snapshot "
                   "contents) must not be mutated outside their "
                   "constructors; declared-frozen dataclasses stay frozen")

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.modules:
            yield from self._check_frozen_decls(mod)
            for fn, class_name in iter_functions(mod.tree):
                yield from self._check_function(mod, fn, class_name)

    # ------------------------------------------------- class declarations
    def _check_frozen_decls(self, mod: Module):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name in MUST_BE_FROZEN:
                frozen = _dataclass_frozen(node)
                if frozen is False:
                    yield Finding(
                        mod.path, node.lineno, node.col_offset, self.name,
                        f"{node.name} must be declared "
                        f"@dataclass(frozen=True) — published snapshots "
                        f"are immutable by contract")

    # ------------------------------------------------------ function body
    def _check_function(self, mod: Module, fn, class_name: Optional[str]):
        in_ctor = (class_name is not None
                   and _is_protected_type(class_name)
                   and fn.name in CONSTRUCTORS)
        scope = _FnScope()
        # parameters: annotations type them; `self` in a protected class's
        # non-constructor methods is itself protected
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            name = _outer_annotation(a.annotation)
            if name is not None and _is_protected_type(name):
                scope.types[a.arg] = name
        if class_name is not None and _is_protected_type(class_name) \
                and not in_ctor:
            scope.types["self"] = class_name
        yield from self._walk(mod, fn.body, scope)

    def _walk(self, mod: Module, stmts, scope: _FnScope):
        for stmt in stmts:
            yield from self._check_stmt(mod, stmt, scope)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub and not isinstance(stmt, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef)):
                    yield from self._walk(mod, sub, scope)
            for h in getattr(stmt, "handlers", []) or []:
                yield from self._walk(mod, h.body, scope)

    def _root_binding(self, node: ast.AST, scope: _FnScope):
        """(root var name, protected type, via) for an expression rooted at
        a typed variable; via='contents' when the var holds snapshot
        contents rather than the snapshot itself."""
        while isinstance(node, (ast.Subscript, ast.Attribute)):
            node = node.value
        if isinstance(node, ast.Name):
            if node.id in scope.types:
                return node.id, scope.types[node.id], "value"
            if node.id in scope.contents:
                return node.id, scope.contents[node.id], "contents"
        return None

    def _check_stmt(self, mod: Module, stmt: ast.stmt, scope: _FnScope):
        # --- learn types from assignments / for-loops first -------------
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                          ast.Name):
            name = _outer_annotation(stmt.annotation)
            prot = name if (name is not None
                            and _is_protected_type(name)) else None
            scope.learn(stmt.target.id, prot)
        elif isinstance(stmt, ast.Assign):
            t = _infer_value_type(stmt.value)
            if t is None and isinstance(stmt.value, ast.Name):
                t = scope.types.get(stmt.value.id)  # alias
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    scope.learn(tgt.id, t)
        elif isinstance(stmt, ast.For):
            # for run in snap.levels[i] / plan.sources: run is CONTENTS
            binding = self._root_binding(stmt.iter, scope)
            if binding and isinstance(stmt.target, ast.Name):
                scope.contents[stmt.target.id] = binding[1]

        # --- flag mutations ---------------------------------------------
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        for tgt in targets:
            elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]
            for el in elts:
                if not isinstance(el, (ast.Attribute, ast.Subscript)):
                    continue
                binding = self._root_binding(el, scope)
                if binding is None:
                    continue
                var, tname, via = binding
                # idempotent lazy caches on snapshot CONTENTS (`run._norms2`,
                # `run._dev_view`) are the one sanctioned write: underscore
                # attrs, same-value-on-race memoization
                if via == "contents" and isinstance(el, ast.Attribute) \
                        and el.attr.startswith("_"):
                    continue
                what = (f"contents of a pinned {tname} snapshot"
                        if via == "contents" else f"a {tname}")
                yield Finding(
                    mod.path, el.lineno, el.col_offset, self.name,
                    f"mutation of {what} (`{var}`) outside its "
                    f"constructor — published snapshots/plans are "
                    f"immutable; build a new object instead")
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            chain = attr_chain(call.func)
            # object.__setattr__(snap, …): frozen-dataclass bypass
            if chain == "object.__setattr__" and call.args:
                arg0 = call.args[0]
                if isinstance(arg0, ast.Name) and arg0.id in scope.types:
                    yield Finding(
                        mod.path, call.lineno, call.col_offset, self.name,
                        f"object.__setattr__ on a "
                        f"{scope.types[arg0.id]} (`{arg0.id}`) bypasses "
                        f"the frozen-dataclass contract")
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr in MUTATOR_METHODS:
                binding = self._root_binding(f.value, scope)
                if binding is not None:
                    var, tname, via = binding
                    what = (f"contents of a pinned {tname} snapshot"
                            if via == "contents" else f"a {tname}")
                    yield Finding(
                        mod.path, call.lineno, call.col_offset, self.name,
                        f"in-place .{f.attr}() on {what} (`{var}`) — "
                        f"published snapshots/plans are immutable")
        if isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                    binding = self._root_binding(tgt, scope)
                    if binding is not None:
                        var, tname, _ = binding
                        yield Finding(
                            mod.path, tgt.lineno, tgt.col_offset, self.name,
                            f"del on a {tname} (`{var}`) — published "
                            f"snapshots/plans are immutable")
