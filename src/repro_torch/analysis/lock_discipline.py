"""lock-discipline — guarded classes mutate their state only under lock.

The concurrency story is: every class shared between the serving
threads and the ingest worker serializes its mutable state behind one
instance lock. This checker makes that lexical: inside the guarded
classes, any write to ``self.*`` (attribute assignment, augmented
assignment, subscript store like ``self.stats["hits"] += 1``, or a
mutating container call like ``self.log.append(...)``) must sit inside a
``with self._lock:`` / ``with self._cond:`` block.

Exemptions, matching the repo's real conventions:

* ``__init__`` / ``__post_init__`` / ``__new__`` — construction happens
  before the object is shared.
* methods whose name ends in ``_locked`` — the caller-holds-lock
  convention (``RunRegistry._reap_locked`` and friends). The caller's own
  ``with self._lock`` is still checked at the call site's scope.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from .base import Checker, Finding, Module, Project, attr_chain, register

#: classes whose instances are shared across threads behind an instance lock
GUARDED_CLASSES = {
    "RunRegistry", "IngestPipeline", "VerifyEngine", "DiskModel", "RawStore",
    "FileStore", "WriteAheadLog", "StorageEngine", "ReadaheadPool", "Gateway",
    "AutoTuner",
}

#: lock attributes whose ``with`` blocks count as holding the lock
LOCK_ATTRS = {"_lock", "_cond"}

#: container methods that mutate their receiver in place
MUTATOR_METHODS = {
    "append", "extend", "insert", "remove", "pop", "clear", "sort",
    "reverse", "update", "setdefault", "popitem", "add", "discard",
}

CONSTRUCTORS = {"__init__", "__post_init__", "__new__"}


def _self_root(node: ast.AST) -> str | None:
    """Dotted ``self.…`` chain of a write target, unwrapping subscripts:
    ``self.stats["hits"]`` -> ``self.stats``; returns None for non-self."""
    while isinstance(node, ast.Subscript):
        node = node.value
    chain = attr_chain(node)
    if chain and chain.startswith("self."):
        return chain
    return None


def _is_lock_with(stmt: ast.With) -> bool:
    for item in stmt.items:
        chain = attr_chain(item.context_expr)
        if chain and chain.startswith("self.") and \
                chain.split(".")[-1] in LOCK_ATTRS:
            return True
    return False


@register
class LockDisciplineChecker(Checker):
    name = "lock-discipline"
    description = ("writes to RunRegistry/IngestPipeline/VerifyEngine/"
                   "DiskModel/RawStore state must happen under `with "
                   "self._lock` (or in a `*_locked` caller-holds-lock "
                   "helper / constructor)")

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef) and \
                        node.name in GUARDED_CLASSES:
                    yield from self._check_class(mod, node)

    def _check_class(self, mod: Module, cls: ast.ClassDef):
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if item.name in CONSTRUCTORS or item.name.endswith("_locked"):
                continue
            yield from self._check_body(mod, cls, item, item.body,
                                        locked=False)

    def _check_body(self, mod: Module, cls: ast.ClassDef, fn,
                    stmts: List[ast.stmt], locked: bool):
        for stmt in stmts:
            if isinstance(stmt, ast.With):
                inner = locked or _is_lock_with(stmt)
                yield from self._check_body(mod, cls, fn, stmt.body, inner)
                continue
            if not locked:
                yield from self._check_stmt(mod, cls, fn, stmt)
            # recurse into compound statements, preserving lock state
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    yield from self._check_body(mod, cls, fn, sub, locked)
            for h in getattr(stmt, "handlers", []) or []:
                yield from self._check_body(mod, cls, fn, h.body, locked)

    def _check_stmt(self, mod: Module, cls: ast.ClassDef, fn, stmt: ast.stmt):
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        for tgt in targets:
            # tuple unpacking: a, self.x = ... checks each element
            elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]
            for el in elts:
                chain = _self_root(el)
                if chain is None:
                    continue
                yield Finding(
                    mod.path, el.lineno, el.col_offset, self.name,
                    f"{cls.name}.{fn.name} writes `{chain}` outside "
                    f"`with self._lock` (guarded class state)")
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr in MUTATOR_METHODS:
                chain = _self_root(f.value)
                if chain is not None:
                    yield Finding(
                        mod.path, call.lineno, call.col_offset, self.name,
                        f"{cls.name}.{fn.name} mutates `{chain}` via "
                        f".{f.attr}() outside `with self._lock` "
                        f"(guarded class state)")
        if isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                chain = _self_root(tgt)
                if chain is not None:
                    yield Finding(
                        mod.path, tgt.lineno, tgt.col_offset, self.name,
                        f"{cls.name}.{fn.name} deletes from `{chain}` "
                        f"outside `with self._lock` (guarded class state)")
