"""The device-resident verification engine — the executor's default backend.

The heavy half of candidate verification stays on the device, the way
hardware-conscious exact-search engines (ParIS+/MESSI) keep their
distance/select pipeline on the compute units:

* **Device arenas** (:class:`DeviceView`): each verifiable table (a
  materialized run, the raw store) is uploaded ONCE — centered by its mean
  (squared ED is translation-invariant, and centering kills the
  ``|x|^2 - 2<q, x>`` f32 cancellation) — together with cached centered
  squared norms. Capacities sit on the {2^k, 3*2^(k-1)} ladder, so growing
  stores extend in place with one ``copy_`` of the new rows instead of a
  re-upload. Row ``cap - 1`` is never written: it is the permanent sentinel
  that pads every gather, so an extend that lands while another thread's
  pass still holds the older view cannot turn that pass's padding into a
  real row.
* **Mixed-precision storage tier**: an arena's *storage* dtype is
  independent of its *compute* dtype. Tables are optionally stored as
  **bf16** or **int8 with per-row scales**, selected per view
  (``build_view(dtype=...)``), per engine (``VerifyEngine(dtype=...)``), or
  process-wide via the ``REPRO_SCREEN_DTYPE`` env var. The kernels upcast
  to f32 in registers; the host mirror keeps the original f32 rows, so the
  f64 re-rank — and therefore the answers — never see quantized data.
* **Fused screen+select**: a verification pass is one call into
  :func:`repro_torch.kernels.ops.screen_select` (or ``screen_select_quant``):
  the kernel reads the pass's candidate rows straight from the arena
  through the row list, screens them in f32 against the cached norms and
  keeps a top-s slate per query. Only the slate crosses back to the host.
* **The device is explicit**: an engine, and every arena it builds, lives
  on one device, ``"cuda"`` unless the caller says otherwise. Asking for
  CUDA on a machine without a card raises; nothing drops to the CPU.

Exactness contract: the f32 screen's only error sources are the cross
product, bounded by the classical ``4 n u |q||x|`` term for any summation
order of true f32 arithmetic (the kernels use no TF32 or tensor-core
product), and — for quantized arenas — the storage rounding
``x_stored = x + e`` with ``|e| <= qerr``, which moves a screened distance
by at most ``2 (|q| + |x|) qerr``. After the host re-ranks the slate in f64
against the exact f32 mirror, a query is *certified* iff its kth exact
distance clears the slate's worst screen distance by twice the summed
bound. Queries that fail fall back to the provably exact host screen, so
the device path returns the same answers as the host engine on every
input and every storage dtype.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

import numpy as np
import torch

from .. import spans
from ..kernels import ops as kops
from .host_screen import SLACK, rerank_slate, rescreen, uncertified

# passes smaller than this verify on the host: below the floor the launch
# overhead rivals the whole NumPy screen, so the device path would lose
# (the same trade the entry-level MINDIST screen makes). Answers are
# identical either way — both tails are exact.
MIN_DEVICE_CANDIDATES = 1024

# batches at or below this stay on the host tail: the BLAS sgemv screen
# beats the fused device pass until the batch amortizes the launch — the
# same m <= 8 boundary where the executor already switches traversal policy
# (entry-level MINDIST screen, one-block seed rounds).
MIN_DEVICE_BATCH = 9

# large query batches screen in chunks of this many rows, which also caps
# the batch-bucket ladder at one signature per chunk shape
_CHUNK_M = 64

# ----------------------------------------------------------- storage dtypes
_SCREEN_DTYPES = {
    "f32": torch.float32,
    "bf16": torch.bfloat16,
    "int8": torch.int8,
}
_DTYPE_ALIASES = {
    "f32": "f32", "float32": "f32", "fp32": "f32",
    "bf16": "bf16", "bfloat16": "bf16",
    "int8": "int8", "i8": "int8",
}


def resolve_screen_dtype(name: Optional[str] = None) -> str:
    """Canonicalize a storage-dtype selector.

    ``None``/``""``/``"auto"`` resolve through the ``REPRO_SCREEN_DTYPE``
    env var (default ``f32``)."""
    if name in (None, "", "auto"):
        name = os.environ.get("REPRO_SCREEN_DTYPE", "f32") or "f32"
    canon = _DTYPE_ALIASES.get(str(name).lower())
    if canon is None:
        raise ValueError(
            f"unknown screen dtype {name!r}: expected f32 | bf16 | int8")
    return canon


def resolve_device(device="cuda") -> torch.device:
    """The engine's device, validated: ``"cuda"`` (the default everywhere)
    needs a card and raises without one — nothing falls back to the CPU.
    Tests and host-only callers pass ``device="cpu"`` explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: expected cuda or cpu")
    return dev


def _quantize_rows(rows: np.ndarray, dtype: str):
    """Quantize centered f32 rows for arena storage.

    Returns ``(stored, scale, xn2, qerr)``: the stored values as a CPU
    tensor in the target dtype, the per-row f32 scales (int8 only, else
    ``None``), the squared norms of the *stored* values as f32 (so the
    screen is self-consistent with what the device holds), and ``qerr`` —
    the worst per-row L2 distance between stored and original values,
    measured exactly in f64 (0.0 for f32). bf16 rounds to nearest even
    through ``torch``, bit for bit the rounding of ml_dtypes' bfloat16."""
    r = rows.shape[0]
    if dtype == "f32":
        return (torch.from_numpy(rows), None, np.einsum("nd,nd->n", rows, rows),
                0.0)
    if dtype == "bf16":
        stored = torch.from_numpy(rows).to(torch.bfloat16)
        scale = None
        deq = stored.to(torch.float64).numpy()
    else:  # int8: symmetric per-row scale, zero rows get scale 1
        amax = np.max(np.abs(rows), axis=1) if r else np.zeros(0, np.float32)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        codes = np.clip(np.rint(rows / scale[:, None]), -127, 127).astype(np.int8)
        stored = torch.from_numpy(codes)
        deq = codes.astype(np.float64) * scale[:, None].astype(np.float64)
    xn2 = np.einsum("nd,nd->n", deq, deq).astype(np.float32)
    err = deq - rows.astype(np.float64)
    err2 = np.einsum("nd,nd->n", err, err)
    qerr = float(np.sqrt(err2.max())) if r else 0.0
    return stored, scale, xn2, qerr


@dataclasses.dataclass
class DeviceView:
    """One table's device arena: centered series + cached norms, bucketed
    capacity. Rows ``>= n`` are zero with a BIG_NORM2 norm until an extend
    fills them; row ``cap - 1`` is never written (the gather sentinel).
    The stored table may be quantized (``dtype``); ``host`` is always the
    original f32 mirror the exact re-rank reads."""

    host: np.ndarray  # (N, d) original host mirror (exact re-rank source)
    mu: np.ndarray  # (d,) f32 centering offset (fixed for the arena's life)
    table: torch.Tensor  # (cap, d) centered, storage dtype
    xn2: torch.Tensor  # (cap,) f32 stored |x|^2; unwritten rows carry BIG_NORM2
    n: int  # valid rows
    cap: int  # ladder capacity, always >= n + 1
    xn2max: float  # max stored |x|^2 over valid rows (certificate term)
    dtype: str = "f32"  # arena storage dtype: f32 | bf16 | int8
    scale: Optional[torch.Tensor] = None  # (cap,) f32 per-row scales (int8)
    qerr: float = 0.0  # worst per-row quantization L2 error (certificate)
    nbytes: int = 0  # device footprint: table + norms + scales

    @property
    def device(self) -> torch.device:
        return self.table.device

    @property
    def sentinel(self) -> int:
        """The never-written row that pads gathers."""
        return self.cap - 1


def view_from_arrays(host, mu, table, xn2, scale, n, cap, xn2max, dtype,
                     qerr, device="cuda") -> DeviceView:
    """A :class:`DeviceView` from another arena's fields as numpy arrays
    (bf16 tables as their uint16 bit patterns), so two implementations can
    screen the identical arena."""
    dev = resolve_device(device)
    table = np.array(table, copy=True)  # writable: torch shares the buffer
    if dtype == "bf16":
        t = torch.from_numpy(table.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(table)
    t = t.to(dev)
    xn2_t = torch.from_numpy(np.array(xn2, np.float32, copy=True)).to(dev)
    scale_t = None
    if scale is not None:
        scale_t = torch.from_numpy(np.array(scale, np.float32, copy=True)).to(dev)
    return DeviceView(
        host=np.ascontiguousarray(host, np.float32), mu=np.asarray(mu, np.float32),
        table=t, xn2=xn2_t, n=int(n), cap=int(cap), xn2max=float(xn2max),
        dtype=dtype, scale=scale_t, qerr=float(qerr),
        nbytes=_footprint(t, xn2_t, scale_t))


def _footprint(table: torch.Tensor, xn2: torch.Tensor, scale) -> int:
    """An arena's device bytes: table, norms and int8 scales."""
    return (table.numel() * table.element_size() + xn2.numel() * 4
            + (0 if scale is None else scale.numel() * 4))


def _center_rows(host: np.ndarray, mu: np.ndarray, lo: int, dtype: str):
    """The host half of an arena write: rows ``[lo:]`` of the f32 table
    ``host`` centered by ``mu`` and quantized (:func:`_quantize_rows`).
    Returns ``(stored, scale, xn2, xn2max, qerr)``, ``xn2max`` the largest
    stored squared norm (0.0 for no rows)."""
    stored, scale, xn2, qerr = _quantize_rows(
        np.subtract(host[lo:], mu[None, :]), dtype)
    return stored, scale, xn2, float(xn2.max()) if xn2.size else 0.0, qerr


def _write_rows(view: DeviceView, lo: int, rows) -> int:
    """The device half of an arena write: rows from
    :func:`_center_rows` copied into the arena's table, norms and int8
    scales from row ``lo`` on. Returns the bytes copied."""
    stored, scale, xn2 = rows[:3]
    hi = lo + xn2.shape[0]
    # host to arena slice: no device-side copy of the rows is made
    view.table[lo:hi].copy_(stored)
    view.xn2[lo:hi].copy_(torch.from_numpy(xn2))
    nbytes = stored.numel() * stored.element_size() + xn2.nbytes
    if scale is not None:
        view.scale[lo:hi].copy_(torch.from_numpy(scale))
        nbytes += scale.nbytes
    return nbytes


def _bucket_rows(n: int, lo: int = 64) -> int:
    """Candidate/row-count bucket: the {2^k, 3*2^(k-1)} ladder (min ``lo``).

    Half-octave steps cap the padded-work overhead at 33% while keeping the
    number of distinct pass shapes bounded — two per octave."""
    n = max(lo, n)
    p2 = kops.candidate_bucket(n, lo)
    mid = 3 * (p2 // 4)
    return mid if n <= mid else p2


def _bucket_batch(m: int) -> int:
    """Power-of-two bucket (min 8) for query-batch sizes."""
    return kops.candidate_bucket(m, 8)


def _screen_pass(view: DeviceView, rows, xn2, qc: torch.Tensor, s: int):
    """One fused screen+select over the arena: the candidate rows (or the
    whole table when ``rows`` is None) against the queries ``qc``. Returns
    (slate d2, candidate positions) on the view's device."""
    if view.scale is None:
        vals, pidx, _ = kops.screen_select(qc, view.table, xn2, s, rows=rows)
    else:
        vals, pidx, _ = kops.screen_select_quant(qc, view.table, view.scale, xn2,
                                                 s, rows=rows)
    return vals, pidx


class VerifyEngine:
    """Verification engine for one device: arenas, launch bookkeeping and
    stats.

    ``dtype`` sets the default storage dtype for arenas built through this
    engine (``None`` resolves ``REPRO_SCREEN_DTYPE``); individual views can
    override it via ``build_view(dtype=...)``."""

    def __init__(self, dtype: Optional[str] = None, device="cuda"):
        # guards the stats and the signature set: query threads verify
        # concurrently under async ingest
        self._lock = threading.RLock()
        self.device = resolve_device(device)
        self.dtype = resolve_screen_dtype(dtype)
        # (batch bucket, row bucket or full-table cap, slate, dtype) of every
        # pass shape seen: "traces" counts first launches at a new shape
        self._signatures: set = set()
        self.stats = {
            "calls": 0,  # fused verification passes launched
            "screened": 0,  # queries through the device screen (per pass)
            "traces": 0,  # first launches at a new pass signature
            "hits": 0,  # launches at an already-seen signature
            "h2d_bytes": 0,  # host->device: arena uploads + rows + queries
            "d2h_bytes": 0,  # device->host: downloaded slates
            "uploads": 0,  # arena builds/extends
            "fallbacks": 0,  # queries re-screened on host (cert failures)
            "released_arenas": 0,  # arenas retired by the run registry
            "released_bytes": 0,  # device bytes those arenas held
            "arena_bytes": 0,  # live device arena footprint (all dtypes)
            "arena_dtype": self.dtype,  # the engine's default storage dtype
            "batch_hist": {},  # served batch bucket -> pass count (monotonic)
        }

    def _count(self, **deltas) -> None:
        """Add to the engine's counters (under its lock)."""
        with self._lock:
            for key, v in deltas.items():
                self.stats[key] += v

    # ------------------------------------------------------------- arenas
    def build_view(self, host_table: np.ndarray,
                   dtype: Optional[str] = None) -> DeviceView:
        """Upload a table into a fresh bucketed arena (one h2d copy),
        optionally quantized to the requested storage dtype."""
        sd = self.dtype if dtype in (None, "") else resolve_screen_dtype(dtype)
        with spans.span("arena.build", np.asarray(host_table).nbytes):
            host = np.ascontiguousarray(host_table, np.float32)
            n, d = host.shape
            cap = _bucket_rows(n + 1)
            mu = host.mean(axis=0).astype(np.float32) if n else np.zeros(
                d, np.float32)
            rows = _center_rows(host, mu, 0, sd)
        dev = self.device
        table = torch.zeros((cap, d), dtype=_SCREEN_DTYPES[sd], device=dev)
        xn2 = torch.full((cap,), kops.BIG_NORM2, dtype=torch.float32, device=dev)
        scale = (torch.ones((cap,), dtype=torch.float32, device=dev)
                 if sd == "int8" else None)
        xn2max, qerr = rows[3:]
        view = DeviceView(
            host=host, mu=mu, table=table, xn2=xn2, n=n, cap=cap,
            xn2max=xn2max, dtype=sd, scale=scale, qerr=qerr,
            nbytes=_footprint(table, xn2, scale))
        _write_rows(view, 0, rows)
        self._count(uploads=1, h2d_bytes=view.nbytes, arena_bytes=view.nbytes)
        return view

    def extend_view(self, view: DeviceView, host_table: np.ndarray) -> DeviceView:
        """Grow an arena to cover an append-only table's new rows.

        While the new rows fit the capacity (with the chunk's ladder padding
        and the sentinel row to spare) they are written in place with one
        ``copy_``, in the arena's storage dtype; an overflowing arena is
        rebuilt at the next rung. Rows below the old ``n`` and the sentinel
        row are never touched, so a pass still holding the older view
        screens exactly what it planned. Existing int8 scales are never
        rewritten."""
        n_new = host_table.shape[0]
        if n_new <= view.n:
            return view
        grow = n_new - view.n
        pad = _bucket_rows(grow) - grow  # the reference's chunk bucketing
        if n_new + pad + 1 > view.cap:
            nv = self.build_view(host_table, dtype=view.dtype)
            self._count(arena_bytes=-view.nbytes)  # the overflowing arena
            return nv
        with spans.span("arena.extend", grow * host_table.shape[1] * 4):
            host = np.ascontiguousarray(host_table, np.float32)
            rows = _center_rows(host, view.mu, view.n, view.dtype)
        self._count(uploads=1, h2d_bytes=_write_rows(view, view.n, rows))
        xn2max, qerr = rows[3:]
        # in place: capacity (and footprint) fixed
        return dataclasses.replace(
            view, host=host, n=n_new, xn2max=max(view.xn2max, xn2max),
            qerr=max(view.qerr, qerr))

    def release_view(self, view: DeviceView) -> None:
        """Retire an arena: the registry calls this once no pinned epoch
        can still verify against the table (deferred retirement). The
        device memory is freed when the last in-flight pass drops its
        reference — releasing is accounting plus dropping the owner's
        handle, never a forced deallocation under a live reader."""
        self._count(released_arenas=1, released_bytes=view.nbytes,
                    arena_bytes=-view.nbytes)

    # ----------------------------------------------------- the fused pass
    def _signature(self, mb: int, bb: int, cap: int, s: int, dtype: str):
        rows = ("full", cap) if bb >= cap else bb
        return (mb, rows, s, dtype)

    def _stage(self, view: DeviceView, trows: np.ndarray, Qc: np.ndarray,
               s: int):
        """The host half of a pass: queries and rows padded to their
        buckets (a full pass takes a row mask instead), counted in the
        stats. Returns (queries, row list or None, mask or None)."""
        m = Qc.shape[0]
        mb = _bucket_batch(m)
        qpad = np.zeros((mb, Qc.shape[1]), np.float32)
        qpad[:m] = Qc
        bb = max(_bucket_rows(trows.size), _bucket_rows(s, 8))
        mask = rows_h = None
        if bb >= view.cap:
            # full-coverage pass: the gathered bucket would be table-sized
            # anyway, so screen the resident table with the masked-out rows'
            # norms set to the sentinel
            mask = np.zeros(view.cap, bool)
            mask[trows] = True
            h2d = mask.nbytes + qpad.nbytes
        else:
            rows_h = np.full(bb, view.sentinel, np.int32)  # pad: the sentinel
            rows_h[: trows.size] = trows
            h2d = rows_h.nbytes + qpad.nbytes
        sig = self._signature(mb, bb, view.cap, s, view.dtype)
        with self._lock:
            self.stats["calls"] += 1
            self.stats["screened"] += m
            hist = self.stats["batch_hist"]
            hist[mb] = hist.get(mb, 0) + 1
            if sig in self._signatures:
                self.stats["hits"] += 1
            else:
                self._signatures.add(sig)
                self.stats["traces"] += 1
            self.stats["h2d_bytes"] += h2d
        return qpad, rows_h, mask

    def _launch(self, view: DeviceView, qpad: np.ndarray, rows_h, mask,
                s: int, m: int):
        """Launch the fused pass over the staged queries and rows, download
        the slate. Returns host (vals (m, s) f32, slate positions (m, s))."""
        dev = view.device
        qc = torch.from_numpy(qpad).to(dev)
        if mask is not None:
            mask_t = torch.from_numpy(mask).to(dev)
            xn2 = torch.where(mask_t, view.xn2,
                              torch.full_like(view.xn2, kops.BIG_NORM2))
            vals, pidx = _screen_pass(view, None, xn2, qc, s)
        else:
            vals, pidx = _screen_pass(view, torch.from_numpy(rows_h), view.xn2,
                                      qc, s)
        vals, pidx = vals[:m].cpu().numpy(), pidx[:m].cpu().numpy()
        self._count(d2h_bytes=vals.nbytes + pidx.nbytes)
        return vals, pidx

    @staticmethod
    def _slate_rows(view: DeviceView, vals: np.ndarray, pidx: np.ndarray,
                    rows_h) -> np.ndarray:
        """Slate positions -> table rows (a full pass screens rows in
        order), -1 where a slot holds no real row."""
        invalid = pidx < 0
        srows = (pidx if rows_h is None
                 else rows_h[np.maximum(pidx, 0)]).astype(np.int64)
        # sentinel/masked-out rows surface only when the slate outsizes
        # the candidates; their BIG screen value or row index flags them
        return np.where(invalid | (srows >= view.n) | (vals >= 1e29), -1,
                        srows)

    def screen_topk(
        self,
        view: DeviceView,
        trows: np.ndarray,
        Q: np.ndarray,
        k: int,
        *,
        exact: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k of ``Q`` against the table rows ``trows``.

        One fused device pass selects a k+slack slate; the host re-ranks it
        in f64 (diff form — immune to cancellation, against the exact f32
        mirror) and, for the exact tier, certifies every query against the
        screen error bound — the classical f32 product term plus, for
        quantized arenas, the storage-rounding term — falling back to the
        provably exact host screen where certification fails. Returns
        ((m, kk) d2 ascending f32, (m, kk) rows into ``view.host``, -1
        padded), kk = min(k, |trows|) — the same contract as the host
        screens."""
        trows = np.ascontiguousarray(trows, np.int64)
        m = Q.shape[0]
        if m > _CHUNK_M:  # bounded query tiles (answers unchanged: every
            parts = [  # query's slate is independent)
                self.screen_topk(view, trows, Q[i : i + _CHUNK_M], k,
                                 exact=exact)
                for i in range(0, m, _CHUNK_M)
            ]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        with spans.span("verify.stage"):
            u = trows.size
            s = min(k + SLACK, u)
            Qc = np.asarray(Q, np.float32) - view.mu[None, :]
            qpad, rows_h, mask = self._stage(view, trows, Qc, s)
        v_screen, pidx = self._launch(view, qpad, rows_h, mask, s, m)
        with spans.span("verify.rerank"):
            srows = self._slate_rows(view, v_screen, pidx, rows_h)
            nv, nrows = rerank_slate(Q, view.host, srows, k)
            if s >= u:
                return nv, nrows  # the slate IS the candidate set: always exact
            qn = np.sqrt(np.einsum("mn,mn->m", Qc, Qc, dtype=np.float64))
            bad = uncertified(nv, srows, v_screen[:, -1], qn,
                              np.sqrt(max(view.xn2max, 0.0)), Q.shape[1],
                              view.qerr)
        if bad.size:
            self._count(fallbacks=int(bad.size))
            with spans.span("verify.fallback"):
                # approximate tiers keep their slack-screen semantics
                rescreen(nv, nrows, bad, Q, view.host[trows], k, rows=trows,
                         exact=exact)
        return nv, nrows

    # ------------------------------------------------------------ warm-up
    def prewarm(self, d: int, m: int, k: int, caps: list[int],
                dtype: Optional[str] = None) -> int:
        """Walk the pass ladder up front: every (arena capacity, candidate
        bucket) signature the serving batch/k shape can produce, for the
        storage dtype, is registered so steady-state traffic counts only
        hits; on CUDA the kernel library is built here, not in the first
        served batch. Returns the number of new signatures."""
        sd = self.dtype if dtype in (None, "") else resolve_screen_dtype(dtype)
        if self.device.type == "cuda":
            from ..kernels import _build

            _build.library()
        s = k + SLACK
        mb = _bucket_batch(min(m, _CHUNK_M))
        new = 0
        with self._lock:
            for cap in sorted({_bucket_rows(c + 1) for c in caps}):
                b = _bucket_rows(min(s, cap))
                sigs = []
                while b < cap:  # the gather ladder below full coverage
                    sigs.append(self._signature(mb, b, cap, min(s, b), sd))
                    b = _bucket_rows(b + 1)
                sigs.append(self._signature(mb, cap, cap, s, sd))
                for sig in sigs:
                    if sig not in self._signatures:
                        self._signatures.add(sig)
                        new += 1
            self.stats["traces"] += new
        return new


_ENGINES: dict = {}
_ENGINES_LOCK = threading.Lock()


def get_engine(device="cuda") -> VerifyEngine:
    """The process-wide engine of a device (arenas are cached on the data
    owners; the engine owns the launch bookkeeping + stats)."""
    dev = resolve_device(device)
    with _ENGINES_LOCK:
        eng = _ENGINES.get(dev)
        if eng is None:
            eng = _ENGINES[dev] = VerifyEngine(device=dev)
        return eng
