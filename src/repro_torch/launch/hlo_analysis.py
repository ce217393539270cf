"""Cost counters for a step of the port: FLOPs, bytes, collectives and live
memory, counted on the aten ops the step runs.

There is no HLO here (the file keeps its counterpart's name). A callable
runs once under :class:`CostMode`, a ``TorchDispatchMode``, on fake tensors
(``FakeTensorMode``: shapes and dtypes, no data, no device work), and every
aten op it dispatches is counted as it runs, so Python loops (microbatches,
the flash attention's chunks) and ``torch.utils.checkpoint``'s recompute
are counted as many times as they run. The rules are the reference's:

* **FLOPs**: exactly 2*B*M*N*K for every ``mm``/``bmm``/``addmm``/
  ``baddbmm``/``einsum``/``matmul`` product (the last two reach the mode
  whole only under inference mode, else as the first ones) and 2 x output
  elements x kernel reduction size for a
  convolution; 1 flop per output element for every other op; views and
  dtype casts are free.
* **bytes**: every op writes its outputs once (views and casts are free; an
  in-place slice update, ``index_copy_``/``index_put_`` or a scatter
  stores its update only); total = 2 x stores (written once, read once
  downstream) + the callable's arguments read once.

Under a ``DTensor`` step the mode sees each op twice over. First at the
``DTensor`` level, with *global* shapes: FLOPs and stores are counted
there, global, and a caller divides by the ranks as the reference divides
its jaxpr's counts. Then the op's local work: the local ops on this rank's
shards and the ``c10d_functional`` collectives that ``DTensor`` issues to
redistribute, seen by an inner mode. The collectives are recorded with
their local output bytes (per device), under the reference's names; the
local tensors each op allocates are tracked while they live, which gives
the peak live local bytes (the port's own figure for temporaries; XLA's
``memory_analysis`` has no counterpart here).
"""
from __future__ import annotations

import collections
import math
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from .specs import _is_dtensor_call, call_replicating

aten = torch.ops.aten

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")

_PRODUCTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
_CONVS = {aten.convolution, aten._convolution}
# free: views, casts and copies with no arithmetic (XLA fuses or aliases them)
_FREE = {aten._to_copy, aten.clone, aten.detach, aten.lift_fresh, aten.alias,
         aten._unsafe_view, aten.expand, aten.contiguous, aten.empty_like,
         aten.empty, aten.empty_strided, aten.new_empty, aten.copy}
# (op, position of the update that an in-place or scatter form stores)
_UPDATES = {aten.index_put_: 2, aten.index_put: 2, aten._index_put_impl_: 2,
            aten.index_copy_: 3, aten.index_copy: 3, aten.slice_scatter: 1,
            aten.select_scatter: 1, aten.copy_: 1, aten.scatter_: 3,
            aten.scatter: 3, aten.scatter_add_: 3, aten.scatter_add: 3,
            aten.index_add_: 3, aten.index_add: 3}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _einsum_flops(eq: str, operands) -> float:
    """2 x the product of every index's size of a two-operand contraction
    (the reference's 2*B*M*N*K)."""
    terms = eq.replace(" ", "").split("->")[0].split(",")
    sizes = {}
    for term, t in zip(terms, operands):
        for ch, n in zip(term, t.shape):
            sizes[ch] = n
    return 2.0 * math.prod(sizes.values())


def op_flops(func, args, out) -> float:
    """The FLOPs of one aten op (shapes of ``args`` and ``out``)."""
    packet = func.overloadpacket
    # under inference mode the composite einsum and matmul reach the mode
    # whole instead of as the bmm/mm they decompose into
    if packet is aten.einsum and len(args[1]) == 2:
        return _einsum_flops(args[0], args[1])
    if packet is aten.matmul:
        return 2.0 * sum(t.numel() for t in _tensors(out)) * args[0].shape[-1]
    if packet in _PRODUCTS:
        a, b = (args[1], args[2]) if packet in (aten.addmm, aten.baddbmm) else args[:2]
        batch = a.shape[0] if a.ndim == 3 else 1
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        return 2.0 * batch * m * n * k
    if packet in _CONVS:
        w = args[1]
        red = math.prod(w.shape[1:]) if w.ndim else 1  # (Cout, Cin/groups, *k)
        return 2.0 * sum(t.numel() for t in _tensors(out)) * red
    if func.is_view or packet in _FREE or packet in _UPDATES:
        return 0.0
    return float(sum(t.numel() for t in _tensors(out)))


def op_stores(func, args, out) -> float:
    """The bytes one aten op stores."""
    packet = func.overloadpacket
    if func.is_view or packet in _FREE:
        return 0.0
    if packet in _UPDATES:
        upd = args[_UPDATES[packet]] if len(args) > _UPDATES[packet] else None
        return float(_nbytes(upd)) if isinstance(upd, torch.Tensor) else 0.0
    return float(sum(_nbytes(t) for t in _tensors(out)))


def _collective_kind(func) -> str | None:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d_functional", "c10d",
                  "_c10d_functional_autograd"):
        return None
    name = func.overloadpacket.__name__
    if "wait" in name or name in ("barrier", "monitored_barrier"):
        return None
    for key, kind in (("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
                      ("allreduce", "all-reduce"), ("all_gather", "all-gather"),
                      ("allgather", "all-gather"), ("all_to_all", "all-to-all"),
                      ("alltoall", "all-to-all")):
        if key in name:
            return kind
    return "collective-permute"  # broadcast, scatter, point to point


class _Local(TorchDispatchMode):
    """The inner mode: lets ``DTensor`` run, and sees its local work."""

    def __init__(self, owner: "CostMode"):
        super().__init__()
        self.owner = owner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_call(types):
            return NotImplemented  # DTensor runs, and its local ops come back here
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self.owner._local(func, args, out)
        return out


class CostMode(TorchDispatchMode):
    """Counts what the ops run under it cost (see the module docstring).

    ``flops`` and ``stores`` are global (``DTensor``-level shapes, and plain
    ops as they run); ``collectives`` maps the reference's names to
    ``{"count", "bytes"}`` per device; ``live`` / ``peak`` are the local
    bytes allocated under the mode and alive, now and at most; ``refused``
    counts the ``DTensor`` ops that ran replicated
    (``specs.call_replicating``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.stores = 0.0
        self.products = 0.0
        self.collectives: dict = {}
        self.live = 0
        self.peak = 0
        self.refused = collections.Counter()
        self._inner = _Local(self)

    def _count(self, func, args, out):
        f = op_flops(func, args, out)
        self.flops += f
        if func.overloadpacket in _PRODUCTS or func.overloadpacket in _CONVS or (
                func.overloadpacket in (aten.einsum, aten.matmul) and f):
            self.products += f
        self.stores += op_stores(func, args, out)

    def _release(self, n: int):
        self.live -= n

    def _local(self, func, args, out):
        kind = _collective_kind(func)
        if kind is not None:
            res = _tensors(out) if func.namespace != "c10d" else _tensors(args[0])
            d = self.collectives.setdefault(kind, {"count": 0, "bytes": 0.0})
            d["count"] += 1
            d["bytes"] += float(sum(_nbytes(t) for t in res))
        if func.is_view:
            return
        for i, t in enumerate(_tensors(out)):
            ret = func._schema.returns
            if i < len(ret) and ret[i].alias_info is not None:
                continue  # in place: the buffer exists already
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._release, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if _is_dtensor_call(types):
            gathered: list = []
            with self._inner:
                out = call_replicating(func, args, kwargs, self.refused, gathered)
            if gathered:
                d = self.collectives.setdefault("all-gather", {"count": 0, "bytes": 0.0})
                d["count"] += len(gathered)
                d["bytes"] += float(sum(gathered))
            self._count(func, args, out)
            return out
        out = func(*args, **kwargs)
        self._count(func, args, out)
        self._local(func, args, out)
        return out

    def result(self, arg_bytes: float = 0.0) -> dict:
        return {"flops": self.flops, "product_flops": self.products,
                "bytes": 2.0 * self.stores + arg_bytes,
                "collectives": {k: dict(v) for k, v in self.collectives.items()},
                "collective_bytes": float(sum(v["bytes"] for v in self.collectives.values())),
                "peak_live_bytes": self.peak, "refused": dict(self.refused)}


def _fake_args(mode: FakeTensorMode, args):
    return tree_map(lambda t: t if not isinstance(t, torch.Tensor) or is_fake(t)
                    or isinstance(t, DTensor) else mode.from_tensor(t), args)


def cost(fn, *args) -> dict:
    """Run ``fn(*args)`` once on fake tensors (real tensor arguments are
    replaced by fakes of their shapes) under :class:`CostMode`; returns its
    ``result``, the arguments' bytes read once."""
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        args = _fake_args(fake, args)
        arg_bytes = float(sum(_nbytes(t) for t in _tensors(args)))
        with CostMode() as mode:
            fn(*args)
    return mode.result(arg_bytes)


def count_flops(fn, *args) -> float:
    """Global FLOPs of ``fn(*args)``, every loop trip and recompute included."""
    return cost(fn, *args)["flops"]


def count_bytes(fn, *args) -> float:
    """Memory traffic of ``fn(*args)``: 2 x stores + arguments once."""
    return cost(fn, *args)["bytes"]


def analyze_collectives(fn, *args) -> dict:
    """Every collective ``fn(*args)`` issues (a ``DTensor`` step's
    redistributions included): ``{"collectives": {name: {"count",
    "bytes"}}, "collective_bytes": per device}``."""
    out = cost(fn, *args)
    return {"collectives": out["collectives"], "collective_bytes": out["collective_bytes"]}
