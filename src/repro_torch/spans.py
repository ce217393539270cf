"""Host spans: names for the port's host work, on the device trace's clock.

``span(name)`` wraps one stretch of host work on the query or ingest path.
While torch's profiler is not recording it returns one shared null
context: one flag read, nothing allocated. While the profiler records, the
stretch becomes a ``record_function`` range named ``coconut.<name>`` in the
profiler's own session, so it lies on the same clock as the card's records,
and its time adds to in-memory totals per name (:func:`totals`).

A span wraps host work only: it ends before the first call that queues a
launch or a copy (``.to(device)``, ``copy_``, ``.cpu()``, a
``kernels.ops`` wrapper). The profiler copies a range that encloses device
work onto the device timeline, where it would read as device activity; a
range that encloses none names an idle stretch of the card exactly. Where
host and device work alternate, the spans cover the host parts and the
device parts stay between them, named by their torch operators.

The public entry points (``CTree.knn_batch``, ``CLSM.knn_batch``,
``StreamingIndex.ingest`` and ``window_knn_batch``) are marked with
:func:`request`: while the profiler records, the spans under the outermost
one on a thread carry its request number in the range's arguments.

There is no other switch: profile any process that uses the port
(``torch.profiler.profile``, then ``export_chrome_trace``) to see them.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

PREFIX = "coconut."

_NULL = contextlib.nullcontext()
_LOCAL = threading.local()  # .stack: open spans; .request: the request number
_LOCK = threading.Lock()  # the totals: async ingest spans on its worker
_TOTALS: dict = {}  # name -> [calls, total ns, self ns, bytes]
_REQUESTS = itertools.count(1)


class _Span:
    __slots__ = ("name", "nbytes", "range", "t0", "child_ns")

    def __init__(self, name: str, nbytes: int):
        self.name, self.nbytes = name, nbytes

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        req = getattr(_LOCAL, "request", None)
        self.range = record_function(PREFIX + self.name,
                                     None if req is None else f"request={req}")
        self.range.__enter__()
        self.child_ns = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        stack = _LOCAL.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += dt
        self.range.__exit__(*exc)
        with _LOCK:
            t = _TOTALS.get(self.name)
            if t is None:
                t = _TOTALS[self.name] = [0, 0, 0, 0]
            t[0] += 1
            t[1] += dt
            t[2] += dt - self.child_ns
            t[3] += int(self.nbytes)
        return False


def span(name: str, nbytes: int = 0):
    """A context naming a stretch of host work ``coconut.<name>`` while the
    profiler records; ``nbytes`` adds to the name's byte total."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, nbytes)


def add_bytes(nbytes: int) -> None:
    """Add ``nbytes`` to the byte total of the innermost span open on this
    thread, for work whose size is known only once it is done (nothing
    while the profiler is off: no span is open then)."""
    stack = getattr(_LOCAL, "stack", None)
    if stack:
        stack[-1].nbytes += nbytes


def request(fn):
    """Mark a public entry point: while the profiler records, the spans
    under its outermost call on a thread carry one request number."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if (not _profiler._is_profiler_enabled
                or getattr(_LOCAL, "request", None) is not None):
            return fn(*args, **kwargs)
        _LOCAL.request = next(_REQUESTS)
        try:
            return fn(*args, **kwargs)
        finally:
            _LOCAL.request = None
    return entry


def totals() -> dict:
    """A snapshot: name -> {"calls", "total_ns", "self_ns", "bytes"}; self
    time leaves out the spans nested inside on the same thread."""
    with _LOCK:
        return {name: dict(zip(("calls", "total_ns", "self_ns", "bytes"), t))
                for name, t in _TOTALS.items()}


def reset() -> None:
    with _LOCK:
        _TOTALS.clear()
