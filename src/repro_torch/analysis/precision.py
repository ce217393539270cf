"""precision-discipline and tf32 — keep the f32-screen / f64-certify split
honest, in torch's spellings.

The exactness argument is a precision contract: the device screen runs in
f32 (fast, error bounded by the ``4 n u |q||x|`` matmul term) and
everything on the certify/re-rank side runs in f64 (the diff form, immune
to cancellation). ``precision-discipline`` checks five rules:

1. **f64 into a screen matmul** — a value cast to float64
   (``.to(torch.float64)``, ``.double()``) flowing into a matmul/einsum
   inside a ``*screen*`` function silently doubles the screen's bandwidth
   and defeats the f32 kernel path.
2. **f32 reaching certify/re-rank without an explicit cast** — every
   matmul/einsum inside a ``*rerank*``/``*certify*`` function must make
   its precision explicit: a float64 cast on an operand (``.double()``,
   ``.to(torch.float64)``, ``.astype(np.float64)``) or a ``dtype=…float64``
   kwarg on the reduction itself.
3. **dtype-less tensor constructors in ``core/``/``kernels/``** — bare
   ``torch.zeros/ones/empty/full/arange`` take the dtype from
   ``torch.get_default_dtype()`` (or from the fill value), process-wide
   state the call does not show; hot-path modules must spell the dtype.
4. **un-upcast low-precision operands in certify/re-rank matmuls** — a
   value derived from bf16/int8 storage (``torch.bfloat16``,
   ``.bfloat16()``, ``torch.int8``) that reaches a ``*rerank*``/``*certify*``
   matmul without an explicit float64 upcast poisons the exact side with
   quantization error the certificate cannot see.
5. **dtype-less casts in quantization helpers** — inside ``*quant*``
   functions, ``.astype(...)`` and ``.to(...)`` must spell a concrete
   dtype (``torch.int8``, ``np.int8``, …). A cast that inherits a dtype
   dynamically (``x.to(dt)``, ``x.to(y.dtype)``) makes the stored
   precision, and therefore the certificate's error term, depend on
   runtime state the bound derivation never sees. ``.to(device)`` is a
   move, not a cast, and is not flagged.

``tf32`` is the port's own rule: no code in ``core/``, ``kernels/`` or
``launch/`` turns TF32 on (``torch.backends.cuda.matmul.allow_tf32 = …``
or ``torch.backends.cudnn.allow_tf32 = …`` set to anything but ``False``,
or ``torch.set_float32_matmul_precision`` with anything but
``"highest"``). TF32 rounds the f32 screen's inputs to 10 mantissa bits:
the screen's error bound, and with it the exact tier, would no longer
hold.
"""
from __future__ import annotations

import ast
from typing import Iterable, Set

from .base import (
    Checker, Finding, Module, Project, attr_chain, call_name, iter_functions,
    register,
)

#: torch constructors that must carry an explicit dtype in core/ and kernels/
DTYPE_REQUIRED = {"zeros", "ones", "arange", "empty", "full"}
_ARRAY_MODULES = {"torch"}

MATMUL_CALLEES = {"dot", "matmul", "einsum", "dot_general", "tensordot",
                  "mm", "bmm"}

_SCREEN_MARKERS = ("screen",)
_CERTIFY_MARKERS = ("rerank", "re_rank", "certify")
_QUANT_MARKERS = ("quant",)

#: float64 spellings: ``torch.float64``, ``torch.double``, ``np.float64``,
#: ``"float64"``; and the ``.double()`` cast
_F64_TOKENS = ("float64", "double")

#: storage dtypes of the mixed-precision arena tier — values tainted by
#: these must be explicitly upcast before the f64 certify/re-rank side
_LOWP_TOKENS = ("bfloat16", "int8")

#: concrete dtype spellings accepted as the argument of a cast in a
#: quantization helper (rule 5) — anything else is a dynamic dtype
_DTYPE_TOKENS = {
    "float16", "float32", "float64", "bfloat16", "half", "float", "double",
    "int8", "int16", "int32", "int64", "long", "int",
    "uint8", "uint16", "uint32", "uint64", "bool_", "bool",
}


def _mentions(node: ast.AST, tokens) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in tokens:
            return True
        if isinstance(sub, ast.Name) and sub.id in tokens:
            return True
        if isinstance(sub, ast.Constant) and sub.value in tokens:
            return True
    return False


def _expr_mentions_f64(node: ast.AST) -> bool:
    return _mentions(node, _F64_TOKENS)


def _expr_mentions_lowp(node: ast.AST) -> bool:
    return _mentions(node, _LOWP_TOKENS)


def _tainted_locals(fn: ast.AST, mentions) -> Set[str]:
    """Names assigned from expressions that ``mentions`` (casts,
    constructors) — the checker's one-function dataflow."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and mentions(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _operands(node: ast.AST):
    """Matmul operand expressions of a call or ``@`` binop."""
    if isinstance(node, ast.BinOp):
        return [node.left, node.right]
    if isinstance(node, ast.Call):
        return list(node.args)
    return []


def _operand_is(expr: ast.AST, names: Set[str], mentions) -> bool:
    if mentions(expr):
        return True
    root = expr
    while isinstance(root, (ast.Attribute, ast.Subscript)):
        root = root.value
    return isinstance(root, ast.Name) and root.id in names


def _dtype_kwarg_f64(node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        for kw in node.keywords:
            if kw.arg == "dtype" and _expr_mentions_f64(kw.value):
                return True
    return False


def _marked(name: str, markers) -> bool:
    low = name.lower()
    return any(m in low for m in markers)


def _matmuls(fn):
    for node in ast.walk(fn):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            yield node
        elif isinstance(node, ast.Call) and call_name(node) in MATMUL_CALLEES:
            yield node


def _spelled(arg: ast.AST) -> bool:
    return any((isinstance(sub, ast.Attribute) and sub.attr in _DTYPE_TOKENS)
               or (isinstance(sub, ast.Constant) and sub.value in _DTYPE_TOKENS)
               for sub in ast.walk(arg)) or (
        isinstance(arg, ast.Name) and arg.id in _DTYPE_TOKENS)


def _dynamic_dtype(arg: ast.AST) -> bool:
    """A ``.to(...)`` argument that reads as a dtype held in a variable:
    a name or attribute chain mentioning ``dtype`` (``dt``, ``dtype``,
    ``ref.dtype``); a device (``dev``, ``x.device``) is not."""
    chain = attr_chain(arg) or ""
    last = chain.split(".")[-1]
    return "dtype" in last or last in {"dt", "dty"}


@register
class PrecisionChecker(Checker):
    name = "precision-discipline"
    description = ("no f64 into screen-side matmuls, explicit f64 casts on "
                   "the certify/re-rank path (and no un-upcast bf16/int8 "
                   "reaching it), explicit dtypes on torch constructors in "
                   "core/ and kernels/ and on casts in quant helpers")

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.modules:
            if mod.is_core or mod.is_kernels:
                yield from self._check_constructors(mod)
            for fn, _cls in iter_functions(mod.tree):
                if _marked(fn.name, _SCREEN_MARKERS) and \
                        not _marked(fn.name, _CERTIFY_MARKERS):
                    yield from self._check_screen(mod, fn)
                if _marked(fn.name, _CERTIFY_MARKERS):
                    yield from self._check_certify(mod, fn)
                if _marked(fn.name, _QUANT_MARKERS):
                    yield from self._check_quant_casts(mod, fn)

    # ------------------------------------------------- rule 3: bare dtypes
    def _check_constructors(self, mod: Module):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute)
                    and f.attr in DTYPE_REQUIRED):
                continue
            if attr_chain(f.value) not in _ARRAY_MODULES:
                continue
            # torch's dtype is keyword-only
            if not any(kw.arg == "dtype" for kw in node.keywords):
                yield Finding(
                    mod.path, node.lineno, node.col_offset, self.name,
                    f"dtype-less torch.{f.attr}(…) in a hot-path module — "
                    f"the dtype follows torch's process-wide default; "
                    f"spell it (e.g. dtype=torch.float32)")

    # ---------------------------------------- rule 1: f64 into the screen
    def _check_screen(self, mod: Module, fn):
        f64_names = _tainted_locals(fn, _expr_mentions_f64)
        for mm in _matmuls(fn):
            if _dtype_kwarg_f64(mm):
                continue  # einsum(…, dtype=f64) is the certify side's idiom
            if isinstance(mm, ast.Call):
                owner = attr_chain(mm.func.value) if isinstance(
                    mm.func, ast.Attribute) else None
                if owner in {"np", "numpy"}:
                    # host-side screens ARE the provably exact fallback —
                    # np matmuls in f64 are their whole point; the f32
                    # contract governs the device (torch) screen
                    continue
            for op in _operands(mm):
                if isinstance(op, ast.Constant):
                    continue  # einsum subscript strings
                if _operand_is(op, f64_names, _expr_mentions_f64):
                    yield Finding(
                        mod.path, op.lineno, op.col_offset, self.name,
                        f"float64 operand in a screen-side matmul "
                        f"(`{fn.name}`) — the screen runs in f32; f64 "
                        f"doubles bandwidth and defeats the kernel path")

    # -------------------------------- rule 2: implicit f32 into certify
    # ------------------------- rule 4: un-upcast bf16/int8 into certify
    def _check_certify(self, mod: Module, fn):
        f64_names = _tainted_locals(fn, _expr_mentions_f64)
        lowp_names = _tainted_locals(fn, _expr_mentions_lowp)
        for mm in _matmuls(fn):
            if _dtype_kwarg_f64(mm):
                continue  # dtype=f64 upcasts every input before reducing
            ops = [op for op in _operands(mm)
                   if not isinstance(op, ast.Constant)]
            if ops and not any(_operand_is(op, f64_names, _expr_mentions_f64)
                               for op in ops):
                yield Finding(
                    mod.path, mm.lineno, mm.col_offset, self.name,
                    f"matmul on the certify/re-rank path (`{fn.name}`) "
                    f"with no explicit float64 cast — f32 accumulation "
                    f"here is the cancellation bug the f64 re-rank "
                    f"exists to prevent")
            for op in ops:
                if _operand_is(op, lowp_names, _expr_mentions_lowp) and \
                        not _operand_is(op, f64_names, _expr_mentions_f64):
                    yield Finding(
                        mod.path, op.lineno, op.col_offset, self.name,
                        f"bf16/int8 operand in a certify/re-rank matmul "
                        f"(`{fn.name}`) without a float64 upcast — "
                        f"quantized storage may feed the screen, never "
                        f"the exact side; re-rank from the f32 host "
                        f"mirror and upcast explicitly")

    # --------------------- rule 5: dynamic dtypes in quantization casts
    def _check_quant_casts(self, mod: Module, fn):
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            meth = node.func.attr
            if meth == "astype" and node.args:
                dynamic = not _spelled(node.args[0])
            elif meth == "to":
                dynamic = any(kw.arg == "dtype" and not _spelled(kw.value)
                              for kw in node.keywords) or any(
                    _dynamic_dtype(a) for a in node.args)
            else:
                continue
            if dynamic:
                yield Finding(
                    mod.path, node.lineno, node.col_offset, self.name,
                    f"dtype-less cast in a quantization helper "
                    f"(`{fn.name}`) — `.{meth}(…)` here must spell a "
                    f"concrete dtype (torch.int8, torch.bfloat16, …); a "
                    f"dynamic dtype makes the stored precision, and the "
                    f"certificate's error term, runtime-dependent")


@register
class TF32Checker(Checker):
    name = "tf32"
    description = ("no code in core/, kernels/ or launch/ turns TF32 on "
                   "(allow_tf32 set to anything but False, or "
                   "set_float32_matmul_precision other than \"highest\")")

    def check(self, project: Project) -> Iterable[Finding]:
        for mod in project.modules:
            if mod.is_core or mod.is_kernels or mod.is_launch:
                yield from self._check_module(mod)

    def _check_module(self, mod: Module):
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                value = node.value
                for tgt in targets:
                    if isinstance(tgt, ast.Attribute) and tgt.attr == "allow_tf32" \
                            and not (isinstance(value, ast.Constant)
                                     and value.value is False):
                        yield Finding(
                            mod.path, tgt.lineno, tgt.col_offset, self.name,
                            f"`{attr_chain(tgt) or 'allow_tf32'}` set to "
                            f"something but False — TF32 rounds the f32 "
                            f"screen's inputs to 10 mantissa bits and voids "
                            f"its error bound")
            elif isinstance(node, ast.Call) and \
                    call_name(node) == "set_float32_matmul_precision":
                arg = node.args[0] if node.args else next(
                    (kw.value for kw in node.keywords), None)
                if not (isinstance(arg, ast.Constant) and arg.value == "highest"):
                    yield Finding(
                        mod.path, node.lineno, node.col_offset, self.name,
                        "set_float32_matmul_precision(…) with anything but "
                        "\"highest\" lets f32 matmuls run in TF32 or bf16 — "
                        "the f32 screen's error bound no longer holds")
