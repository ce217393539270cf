"""trace-safety and collective-divergence — the port's launch wrappers and
SPMD bodies.

The reference's roots (``jax.jit`` / ``shard_map`` / ``pallas_call``)
have no counterpart in the port: nothing is traced, every call runs
eagerly. The port has two kinds of root instead, and a rule for each.

``trace-safety`` keeps the kernel launch wrappers free of host hazards:
every function reachable, through the project-local call graph, from a
launch wrapper in ``kernels/`` (a function named ``_launch*``, or one that
counts its launch with ``LAUNCHES[...] += 1``) must not take an instance
lock (a launch wrapper runs inside the verify engine's lock and the
gateway's dispatcher: a second lock there is a lock-order hazard) nor draw
host RNG (a kernel's inputs come from its caller, seeded).

``collective-divergence`` guards the SPMD bodies: every rank must reach
each collective alike, in the same order, or the group hangs. A function
*reaches a collective* when it calls one (``dist.all_gather``,
``dist.all_reduce``, ``dist.all_to_all_single``, ``dist.barrier``, … a
functional collective, or a ``DTensor``'s ``redistribute`` /
``full_tensor``) or calls, through the call graph, a function that does.
In such a function a branch on **rank-local data** — ``dist.get_rank()``
and friends, a local tensor's values (``.item()``, ``.tolist()``,
``.any()``, ``.all()``), a file's existence (``exists``, ``isfile``, …),
or a name assigned from one of them — is flagged when

* the branch itself reaches a collective (some ranks call it, others do
  not), or
* it returns, raises, breaks or continues while a collective follows it
  in the function (or in the loop around it): the ranks that leave skip
  a collective the others wait in.

An ``assert`` on rank-local data before a collective is the same early
exit. Branches that only write (rank 0 saving a file after the gathers)
are what SPMD code does, and are not flagged.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .base import (
    Checker, Finding, FunctionInfo, Module, Project, attr_chain, call_name,
    register,
)

#: host RNG chains (a torch.Generator passed in is the seeded way)
_RNG_PREFIXES = ("np.random.", "numpy.random.", "random.")

_LOCKISH = {"_lock", "_cond"}

#: torch.distributed collectives, by name, under these owners
COLLECTIVES = {
    "all_gather", "all_gather_into_tensor", "all_gather_object",
    "all_gather_tensor", "all_reduce", "all_to_all", "all_to_all_single",
    "barrier", "monitored_barrier", "broadcast", "broadcast_object_list",
    "gather", "gather_object", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "scatter", "scatter_object_list", "send",
    "recv",
}
_DIST_OWNERS = {"dist", "torch.distributed", "funcol", "c10d",
                "torch.distributed._functional_collectives"}
#: DTensor methods that communicate whatever the receiver is
DTENSOR_COLLECTIVES = {"redistribute", "full_tensor"}

#: calls whose result differs from rank to rank
RANK_LOCAL_CALLS = {"get_rank", "get_local_rank", "get_coordinate",
                    "item", "tolist", "exists", "isfile", "isdir",
                    "is_file", "is_dir"}
#: tensor methods reading a local tensor's values (method calls only:
#: the builtins ``any(...)``/``all(...)`` over Python data are not)
_VALUE_METHODS = {"any", "all"}
_RANK_NAMES = {"rank", "local_rank"}

_ESCAPES = (ast.Return, ast.Raise, ast.Break, ast.Continue)
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _resolve_edge(project: Project, node: ast.Call, mod: Module,
                  class_name: Optional[str]) -> Optional[FunctionInfo]:
    """Call-graph edge resolution: bare-name calls resolve to *functions*
    (never methods), local-first; ``self.f()`` resolves within the
    caller's own class; any other attribute call resolves only when the
    name maps to exactly one definition project-wide and that definition
    is a plain function (``shardctx.constrain``). A missed edge only
    weakens a check; a wrong one fabricates findings."""
    f = node.func
    if isinstance(f, ast.Name):
        cands = [c for c in project.functions.get(f.id, [])
                 if c.class_name is None]
        local = [c for c in cands if c.module is mod]
        if len(local) == 1:
            return local[0]
        if len(cands) == 1:
            return cands[0]
        return None
    if isinstance(f, ast.Attribute):
        all_cands = project.functions.get(f.attr, [])
        owner = attr_chain(f.value)
        if owner == "self" and class_name is not None:
            own = [c for c in all_cands if c.class_name == class_name]
            if len(own) == 1:
                return own[0]
            return None
        # ``torch.gather`` is not the project's ``gather``: only a module
        # the caller imports from the project is followed
        if owner not in _project_aliases(mod):
            return None
        if len(all_cands) == 1 and all_cands[0].class_name is None:
            return all_cands[0]
    return None


_ALIASES: Dict[int, Set[str]] = {}


def _project_aliases(mod: Module) -> Set[str]:
    """Names a module binds to the project's own modules: relative imports
    and imports of ``repro_torch``."""
    key = id(mod.tree)
    if key not in _ALIASES:
        out: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and (
                    node.level or (node.module or "").startswith("repro_torch")):
                out.update(a.asname or a.name for a in node.names)
            elif isinstance(node, ast.Import):
                out.update(a.asname or a.name for a in node.names
                           if a.name.startswith("repro_torch"))
        _ALIASES[key] = out
    return _ALIASES[key]


def _all_functions(project: Project) -> List[FunctionInfo]:
    return [fi for infos in project.functions.values() for fi in infos]


def _counts_launch(fn: ast.AST) -> bool:
    """``LAUNCHES[...] += 1`` in the body: the wrapper's launch counter."""
    for node in ast.walk(fn):
        if isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Subscript) \
                and attr_chain(node.target.value) in {"LAUNCHES", "ops.LAUNCHES"}:
            return True
    return False


def is_collective(node: ast.Call) -> bool:
    name = call_name(node)
    if name in DTENSOR_COLLECTIVES and isinstance(node.func, ast.Attribute):
        return True
    if name in COLLECTIVES and isinstance(node.func, ast.Attribute):
        owner = attr_chain(node.func.value) or ""
        return owner in _DIST_OWNERS or owner.startswith("torch.distributed")
    return False


def reaching(project: Project) -> Set[int]:
    """ids of the function nodes that reach a collective (a fixed point
    over the call graph)."""
    funcs = _all_functions(project)
    calls: Dict[int, List[FunctionInfo]] = {}
    reach: Set[int] = set()
    for fi in funcs:
        callees = []
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            if is_collective(node):
                reach.add(id(fi.node))
            callee = _resolve_edge(project, node, fi.module, fi.class_name)
            if callee is not None:
                callees.append(callee)
            # a project function passed as an argument is called there
            # (``_canonical(tree, _host)``)
            for arg in node.args:
                if isinstance(arg, ast.Name):
                    callee = _resolve_edge(project, ast.Call(arg, [], []), fi.module, None)
                    if callee is not None:
                        callees.append(callee)
        calls[id(fi.node)] = callees
    changed = True
    while changed:
        changed = False
        for fi in funcs:
            if id(fi.node) not in reach and any(
                    id(c.node) in reach for c in calls[id(fi.node)]):
                reach.add(id(fi.node))
                changed = True
    return reach


@register
class TraceSafetyChecker(Checker):
    name = "trace-safety"
    description = ("functions reachable from a kernel launch wrapper "
                   "(`_launch*`, or one counting LAUNCHES) must not take "
                   "instance locks or draw host RNG")

    def check(self, project: Project) -> Iterable[Finding]:
        roots = self._find_roots(project)
        seen: Set[Tuple[str, int, int]] = set()
        for info, root in self._reach(project, roots):
            for f in self._scan(info, root):
                key = (f.path, f.line, f.col)
                if key not in seen:
                    seen.add(key)
                    yield f

    def _find_roots(self, project: Project) -> List[Tuple[FunctionInfo, str]]:
        return [(fi, fi.qualname) for fi in _all_functions(project)
                if fi.module.is_kernels and (fi.name.startswith("_launch")
                                             or _counts_launch(fi.node))]

    def _reach(self, project: Project, roots):
        seen: Dict[int, Tuple[FunctionInfo, str]] = {}
        queue = list(roots)
        while queue:
            info, root = queue.pop()
            if id(info.node) in seen:
                continue
            seen[id(info.node)] = (info, root)
            for node in ast.walk(info.node):
                if isinstance(node, ast.Call):
                    callee = _resolve_edge(project, node, info.module,
                                           info.class_name)
                    if callee is not None and id(callee.node) not in seen:
                        queue.append((callee, root))
        return list(seen.values())

    def _scan(self, info: FunctionInfo, root: str) -> Iterable[Finding]:
        mod = info.module
        where = (f"`{info.qualname}` (reachable from launch wrapper "
                 f"`{root}`)")
        for node in ast.walk(info.node):
            if isinstance(node, ast.With):
                for item in node.items:
                    chain = attr_chain(item.context_expr)
                    if chain and chain.split(".")[-1] in _LOCKISH:
                        yield Finding(
                            mod.path, item.context_expr.lineno,
                            item.context_expr.col_offset, self.name,
                            f"{where} acquires `{chain}` — a launch runs "
                            f"under its caller's locks; another lock here "
                            f"is a lock-order hazard")
            elif isinstance(node, ast.Call):
                chain = attr_chain(node.func) or ""
                name = call_name(node)
                if name in {"acquire", "release"} and any(
                        part in _LOCKISH for part in chain.split(".")):
                    yield Finding(
                        mod.path, node.lineno, node.col_offset, self.name,
                        f"{where} calls `{chain}()` — a launch wrapper "
                        f"must not touch instance locks")
                elif chain.startswith(_RNG_PREFIXES) or name == "default_rng":
                    yield Finding(
                        mod.path, node.lineno, node.col_offset, self.name,
                        f"{where} draws host RNG (`{chain or name}`) — a "
                        f"kernel's inputs come from its caller, seeded")


def _rank_local(expr: ast.AST, tainted: Set[str], rank_fns=frozenset()) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            name = call_name(sub)
            if name in RANK_LOCAL_CALLS or name in rank_fns:
                return True
            if name in _VALUE_METHODS and isinstance(sub.func, ast.Attribute):
                return True
        elif isinstance(sub, ast.Name) and (sub.id in tainted
                                            or sub.id in _RANK_NAMES):
            return True
    return False


def _rank_functions(project: Project) -> Set[str]:
    """Names of the project's functions that return rank-local data
    (``_rank()`` returning ``dist.get_rank()``)."""
    return {fi.name for fi in _all_functions(project)
            if any(isinstance(n, ast.Return) and n.value is not None
                   and not isinstance(n.value, ast.Tuple)  # which element?
                   and _rank_local(n.value, set()) for n in ast.walk(fi.node))}


def _tainted(fn: ast.AST, rank_fns=frozenset()) -> Set[str]:
    """Names assigned from rank-local expressions (to a fixed point)."""
    out: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign)) and node.value is not None \
                    and _rank_local(node.value, out, rank_fns):
                tgts = node.targets if isinstance(node, ast.Assign) else [node.target]
                for tgt in tgts:
                    if isinstance(tgt, (ast.Tuple, ast.List)):
                        # element by element where the value is spelled out
                        pairs = (zip(tgt.elts, node.value.elts)
                                 if isinstance(node.value, ast.Tuple)
                                 and len(node.value.elts) == len(tgt.elts)
                                 else ((el, node.value) for el in tgt.elts))
                    else:
                        pairs = [(tgt, node.value)]
                    for el, val in pairs:
                        if isinstance(el, ast.Name) and el.id not in out \
                                and _rank_local(val, out, rank_fns):
                            out.add(el.id)
                            changed = True
    return out


def _walk_here(nodes) -> Iterable[ast.AST]:
    """Every node under ``nodes``, not entering nested function bodies."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        yield node
        stack.extend(c for c in ast.iter_child_nodes(node) if not isinstance(c, _FUNCS))


@register
class CollectiveDivergenceChecker(Checker):
    name = "collective-divergence"
    description = ("in a function that reaches a collective, no branch on "
                   "rank-local data (rank, a local tensor's values, a "
                   "file's existence) may reach a collective or leave "
                   "before one")

    def check(self, project: Project) -> Iterable[Finding]:
        reach = reaching(project)
        rank_fns = _rank_functions(project)
        for fi in _all_functions(project):
            if id(fi.node) in reach:
                yield from self._check_fn(project, fi, reach, rank_fns)

    def _check_fn(self, project: Project, fi: FunctionInfo, reach: Set[int],
                  rank_fns: Set[str]):
        fn = fi.node
        body = fn.body if isinstance(fn.body, list) else [fn.body]

        def coll_calls(nodes) -> List[ast.Call]:
            out = []
            for node in _walk_here(nodes):
                if isinstance(node, ast.Call):
                    callee = _resolve_edge(project, node, fi.module, fi.class_name)
                    if is_collective(node) or (callee is not None
                                               and id(callee.node) in reach):
                        out.append(node)
            return out

        colls = coll_calls(body)
        if not colls:
            return
        tainted = _tainted(fn, rank_fns)
        parents: Dict[int, ast.AST] = {}
        for node in _walk_here(body):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node
        for node in _walk_here(body):
            if not isinstance(node, (ast.If, ast.While, ast.Assert)) or \
                    not _rank_local(node.test, tainted, rank_fns):
                continue
            end = getattr(node, "end_lineno", node.lineno)
            later = any(c.lineno > end for c in colls) or self._in_coll_loop(
                node, parents, coll_calls)
            if isinstance(node, ast.Assert):
                if later:
                    yield self._finding(fi, node, "asserts on rank-local data "
                                        "before a collective: the ranks it "
                                        "fails on leave the others waiting")
                continue
            branch = node.body + node.orelse
            if coll_calls(branch):
                yield self._finding(fi, node, "branches on rank-local data "
                                    "around a collective: only some ranks "
                                    "call it")
            elif later and any(isinstance(n, _ESCAPES) for n in _walk_here(branch)):
                yield self._finding(fi, node, "leaves early on rank-local data "
                                    "before a collective: the other ranks "
                                    "wait in it")

    @staticmethod
    def _in_coll_loop(node, parents, coll_calls) -> bool:
        cur = parents.get(id(node))
        while cur is not None:
            if isinstance(cur, (ast.For, ast.While, ast.AsyncFor)) and \
                    coll_calls(cur.body):
                return True
            cur = parents.get(id(cur))
        return False

    def _finding(self, fi: FunctionInfo, node: ast.AST, what: str) -> Finding:
        return Finding(fi.module.path, node.lineno, node.col_offset, self.name,
                       f"`{fi.qualname}` {what}")
