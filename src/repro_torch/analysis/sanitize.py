"""Runtime sanitizer of the port — ``REPRO_SANITIZE=1`` turns invariants
into traps.

The static checkers prove what is lexically visible; this module catches
what only shows up with real threads interleaving:

* **Ranked locks** — the registry lock (rank 0) and the engine lock
  (rank 1) have one legal order: registry → engine (``pin``'s epilogue
  reaps retired runs under the registry lock and calls
  ``VerifyEngine.release_view``). A thread acquiring rank 0 while holding
  rank 1 is one scheduler tick from deadlock; the wrapper raises at the
  acquisition site instead. Each wrapper also records its owning thread,
  so failures name who held what.
* **Snapshot seals** — ``SortedRun`` / ``QueryPlan`` / ``*Source`` objects
  get a ``__setattr__`` tripwire armed when ``__init__`` returns: any
  later public-attribute write raises immediately at the mutation site
  (underscore attributes stay writable — ``run._norms2`` and
  ``run._dev_view`` are idempotent lazy caches). ``RunSet`` is a frozen
  dataclass already; its tripwire just rebrands the failure so stress
  logs say *snapshot mutated* instead of a bare ``FrozenInstanceError``.

Imported lazily (this module touches ``repro_torch.core``, i.e.
numpy/torch — the static lint gate must not pull it in).
``repro_torch.core`` auto-installs it at import when ``REPRO_SANITIZE=1``;
tests call :func:`install` / :func:`uninstall` directly.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

_tls = threading.local()


class SanitizerError(RuntimeError):
    """An invariant violation caught by the runtime sanitizer."""


def _held() -> List["RankedLock"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class RankedLock:
    """RLock wrapper asserting a global acquisition order by rank."""

    def __init__(self, rank: int, name: str):
        self.rank = rank
        self.name = name
        self.owner: Optional[str] = None  # owning thread name (debugging)
        self._inner = threading.RLock()
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        stack = _held()
        worst = next((h for h in stack
                      if h is not self and h.rank > self.rank), None)
        if worst is not None:
            raise SanitizerError(
                f"lock-order inversion: thread "
                f"{threading.current_thread().name!r} acquires "
                f"{self.name!r} (rank {self.rank}) while holding "
                f"{worst.name!r} (rank {worst.rank}) — the legal order "
                f"is registry -> engine, never the reverse")
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            stack.append(self)
            self._depth += 1
            self.owner = threading.current_thread().name
        return ok

    def release(self) -> None:
        stack = _held()
        # drop the most recent entry for this lock (re-entrant holds)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._depth -= 1
        if self._depth == 0:
            self.owner = None
        self._inner.release()

    def __enter__(self) -> "RankedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


_SEALED_FLAG = "_palm_sealed"


def _seal_class(cls) -> Dict[str, object]:
    """Arm a post-``__init__`` mutation tripwire on ``cls``. Returns the
    originals needed to disarm it."""
    orig_init = cls.__init__
    orig_setattr = cls.__setattr__

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        object.__setattr__(self, _SEALED_FLAG, True)

    def setattr_(self, name, value):
        if getattr(self, _SEALED_FLAG, False) and not name.startswith("_"):
            raise SanitizerError(
                f"sanitizer: mutation of sealed {cls.__name__}.{name} "
                f"after construction — published snapshots/plans are "
                f"immutable (build a new object)")
        orig_setattr(self, name, value)

    cls.__init__ = init
    cls.__setattr__ = setattr_
    return {"init": orig_init, "setattr": orig_setattr}


def _brand_frozen(cls) -> Dict[str, object]:
    """Rebrand a frozen dataclass's mutation error as a sanitizer trap."""
    orig_setattr = cls.__setattr__

    def setattr_(self, name, value):
        raise SanitizerError(
            f"sanitizer: mutation of {cls.__name__}.{name} — published "
            f"snapshots are immutable (frozen dataclass); a reader "
            f"pinned at this epoch must see it unchanged forever")

    cls.__setattr__ = setattr_
    return {"setattr": orig_setattr}


_state: Optional[dict] = None


def install() -> None:
    """Arm the sanitizer (idempotent). Wraps the registry/engine locks of
    new AND already-existing instances, and seals the snapshot types."""
    global _state
    if _state is not None:
        return
    from ..core import ctree, plan, run_registry, verify_engine

    st: dict = {"inits": {}, "seals": {}}

    def _ranked_init(cls, rank: int, name: str):
        orig = cls.__init__

        def init(self, *a, **kw):
            orig(self, *a, **kw)
            self._lock = RankedLock(rank, name)

        cls.__init__ = init
        st["inits"][cls] = orig

    _ranked_init(run_registry.RunRegistry, 0, "RunRegistry._lock")
    _ranked_init(verify_engine.VerifyEngine, 1, "VerifyEngine._lock")
    # the engines are process-wide singletons (one a device) that may
    # predate install()
    for eng in list(verify_engine._ENGINES.values()):
        eng._lock = RankedLock(1, "VerifyEngine._lock")

    for cls in (ctree.SortedRun, plan.QueryPlan, plan.SourceOps,
                plan.DenseSource, plan.BlockSource, plan.RangeSource,
                plan.GroupSource):
        st["seals"][cls] = _seal_class(cls)
    st["seals"][run_registry.RunSet] = _brand_frozen(run_registry.RunSet)
    _state = st


def uninstall() -> None:
    """Disarm the sanitizer and restore the original classes. Locks
    already swapped onto live instances keep working (a RankedLock is a
    superset of an RLock), they just stop asserting new inversions on
    classes restored here."""
    global _state
    if _state is None:
        return
    for cls, orig in _state["inits"].items():
        cls.__init__ = orig
    for cls, saved in _state["seals"].items():
        if "init" in saved:
            cls.__init__ = saved["init"]
        cls.__setattr__ = saved["setattr"]
    _state = None


def installed() -> bool:
    return _state is not None
