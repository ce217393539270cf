"""Public wrappers around the hand-written kernels.

Dispatch follows the device of the tensors: a CUDA tensor goes to the CUDA
kernel (``csrc/screen_fused.cu`` for the f32, bf16 and int8 screens,
``topk_ed`` and ``min_ed``, ``csrc/summarize.cu`` for ``paa`` and
``sax_pack``,
``csrc/lower_bound.cu`` for ``mindist``; built on first use by
:mod:`._build`) or the call raises; a CPU tensor goes to the plain PyTorch
version in :mod:`.ref`. There is no fallback from one to the other.

Each kernel has a launch count in :data:`LAUNCHES`, raised by one where the
wrapper launches it and nowhere else, so a run can show that its main path
went through the kernel.

Contract (the reference's ``kernels.ops`` wrappers): the screen is
``|q|^2 + xn2 - 2 q.x`` over precomputed candidate norms (``topk_ed`` and
``min_ed`` sum ``|x|^2`` from the rows in the tile), the slate is the top-k
in lexicographic (d2, candidate) order, slots that no candidate can fill
come back as ``(inf, -1)``, ``k > n`` pads the tail that way, and an empty
batch returns without a launch. A slate has no cap: one kernel pass holds
``pass_slate()`` entries, and a longer slate is taken in passes
(:func:`slate_in_passes`), each pass a launch. The reference zero-pads
``d`` to a multiple of 128 for the TPU's lanes and pads candidate counts to
power-of-two buckets for its jit cache; the CUDA kernels take any ``d`` and
``n``, so neither padding is made, and the results are those of an
unpadded launch.

The summarize front (``paa`` -> ``sax_and_keys``) returns sortable keys as
int64 tensors holding the uint32 word values (torch has no ``<<`` for uint32
on the CPU); :func:`keys_to_host` hands them to the host index as numpy
uint32. Like the reference's ``ops.summarize``, it does not z-normalize,
whatever ``cfg.znorm`` says.

Shapes only: ``paa``, ``sax_and_keys`` (so ``summarize``) and ``mindist``
given a ``FakeTensor`` (the dry run's, ``launch/dryrun.py``) run their
plain versions on it, which compute the kernel's output shapes and dtypes
from the fake inputs, count as the aten ops they are, and launch nothing.
A real tensor, on the CPU or the card, never takes that branch.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from .. import spans
from ..core.summarization import SummarizationConfig, breakpoints
from . import ref

# sentinel |x|^2 for pad candidates: dominates any real screened distance
# without overflowing the f32 d2 arithmetic
BIG_NORM2 = 1e30

# launches of each CUDA kernel since the last reset
LAUNCHES = {"screen_select": 0, "screen_select_quant": 0, "topk_ed": 0,
            "paa": 0, "sax_pack": 0, "min_ed": 0, "mindist": 0}

_SM_COUNT: dict = {}
_BREAKPOINTS: dict = {}  # (card_bits, device) -> breakpoint_table


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pass_slate() -> int:
    """The most slate entries one pass of the CUDA slate kernels (the three
    screens and topk_ed) holds, as the built library defines it; a longer
    slate takes several passes."""
    from . import _build

    return _build.layout()["screen"]["pass_slate"]


def candidate_bucket(e: int, min_bucket: int = 64) -> int:
    """The power-of-two candidate bucket (min ``min_bucket``) ``e`` pads to
    — the shared shape discipline of every bucketed launcher."""
    return 1 << max(min_bucket.bit_length() - 1, (max(1, e) - 1).bit_length())


def _splits(device: torch.device, n: int, m: int, s: int,
            layout: dict) -> tuple[int, int]:
    """Cut the candidate axis over blocks: about four blocks per SM in all,
    each split a whole number of the kernel's tiles, and at most 32768
    partial slate entries per query for the merge. Returns (chunk,
    n_splits)."""
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(device).multi_processor_count
    tile = layout["tile"]
    tiles = math.ceil(n / tile)
    m_blocks = math.ceil(m / layout["query_block"])
    want = max(1, min(tiles, (4 * _SM_COUNT[device]) // m_blocks, 32768 // s))
    chunk = math.ceil(tiles / want) * tile
    return chunk, math.ceil(n / chunk)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_rows(rows: torch.Tensor, n_table: int) -> torch.Tensor:
    if rows.dim() != 1:
        raise ValueError(f"rows must be 1-D, got shape {tuple(rows.shape)}")
    if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= n_table):
        raise IndexError(f"rows out of range for a table of {n_table} rows")
    return rows


def _empty(m: int, k: int, q: torch.Tensor, n: int):
    """The no-launch cases: an empty batch, or no candidates at all."""
    dev = q.device
    qn2 = (q * q).sum(-1) if n == 0 else torch.zeros(0, dtype=torch.float32, device=dev)
    return (
        torch.full((m, k), math.inf, dtype=torch.float32, device=dev),
        torch.full((m, k), -1, dtype=torch.int32, device=dev),
        qn2,
    )


def _finish(vals, idxs, n: int, k: int):
    """Map never-filled slots to (inf, -1) and pad the slate to k columns."""
    invalid = (idxs >= n) | (idxs < 0)
    vals = torch.where(invalid, torch.full_like(vals, math.inf), vals)
    idxs = torch.where(invalid, torch.full_like(idxs, -1), idxs)
    kk = vals.shape[1]
    if kk < k:
        m = vals.shape[0]
        vals = torch.cat([vals, vals.new_full((m, k - kk), math.inf)], dim=1)
        idxs = torch.cat([idxs, idxs.new_full((m, k - kk), -1)], dim=1)
    return vals, idxs


def _screen(name: str, q, x, scale, xn2, k: int, rows):
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, x {tuple(x.shape)}")
    if q.dtype != torch.float32 or xn2.dtype != torch.float32:
        raise TypeError("q and xn2 must be float32")
    if scale is not None and scale.dtype != torch.float32:
        raise TypeError("scale must be float32")
    devices = {t.device for t in (q, x, xn2, scale) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = q.device
    if rows is not None:
        rows = _check_rows(rows, x.shape[0])
    m = q.shape[0]
    n = x.shape[0] if rows is None else rows.shape[0]
    if m == 0 or n == 0:
        return _empty(m, k, q, n)
    kk = max(1, min(k, n))
    if dev.type == "cpu":
        if rows is not None:
            r = rows.long()
            x, xn2 = x[r], xn2[r]
            scale = None if scale is None else scale[r]
        if scale is None:
            vals, idxs, qn2 = ref.screen_select_ref(q, x, xn2, kk)
        else:
            vals, idxs, qn2 = ref.screen_select_quant_ref(q, x, scale, xn2, kk)
        vals, idxs = _finish(vals, idxs, n, k)
        return vals, idxs, qn2
    if dev.type != "cuda":
        raise ValueError(f"no screen_select for device {dev}")
    return _launch_screen(name, q, x, scale, xn2, k, kk, rows, n)


def slate_in_passes(step, kk: int, width: int):
    """The top-``kk`` slate in passes of at most ``width`` entries.

    ``step(s, floor)`` returns ((m, s) d2, (m, s) ids, (m,) |q|^2): the
    first ``s`` entries lexicographically after ``floor`` ((m,) d2 and (m,)
    ids of the previous pass's last entry; None for the first pass). The
    passes are concatenated. This is the one-shot slate exactly, because
    (d2, position) is a strict total order and a candidate's d2 is the same
    arithmetic in every pass."""
    vals, idxs, qn2, floor = [], [], None, None
    for start in range(0, kk, width):
        v, i, q2 = step(min(width, kk - start), floor)
        qn2 = q2 if qn2 is None else qn2
        vals.append(v)
        idxs.append(i)
        floor = (v[:, -1].contiguous(), i[:, -1].contiguous())
    if len(vals) == 1:
        return vals[0], idxs[0], qn2
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1), qn2


_SCREEN_DTYPES = {"screen_select": {torch.float32: 0, torch.bfloat16: 1},
                  "screen_select_quant": {torch.int8: None},
                  "topk_ed": {torch.float32: None}}


def _launch_screen(name, q, x, scale, xn2, k, kk, rows, n):
    """The CUDA kernel of the three screens (f32 and bf16 tables for
    screen_select, int8 for screen_select_quant) and of topk_ed (f32 rows
    taken in order, ``|x|^2`` summed in the tile): one launch per pass,
    whose last block of each query block merges the partial slates itself;
    in passes of ``pass_slate`` entries where the slate is longer."""
    from . import _build  # builds the library on first use

    def buffers(s):
        """A pass's cut of the candidates and its outputs (allocated, not
        written)."""
        chunk, n_splits = _splits(dev, n, m, s, layout)
        # partial slates and per-query thresholds (8 bytes an entry), then a
        # ticket counter per query block (4 bytes)
        scratch = torch.empty((m * n_splits * s + m + math.ceil(m_blocks / 2),),
                              dtype=torch.int64, device=dev)
        return (chunk, n_splits, scratch,
                torch.empty((m, s), dtype=torch.float32, device=dev),
                torch.empty((m, s), dtype=torch.int32, device=dev))

    # the host's part of the launch: checks, buffers, the first pass's cut
    with spans.span("ops.prepare"):
        if x.dtype not in _SCREEN_DTYPES[name]:
            kinds = " or ".join(str(t).removeprefix("torch.") for t in _SCREEN_DTYPES[name])
            raise TypeError(f"{name} takes {kinds} tables, not {x.dtype}")
        for t, what in ((x, "x"), (xn2, "xn2"), (scale, "scale")):
            if t is not None and not t.is_contiguous():
                raise ValueError(f"{what} must be contiguous")
        layout = _build.layout()["screen"]
        dev = q.device
        m, d = q.shape
        qn2 = torch.empty((m,), dtype=torch.float32, device=dev)
        stream = _stream(dev)
        lib = _build.library()
        m_blocks = math.ceil(m / layout["query_block"])
        width = layout["pass_slate"]
        ready = {min(kk, width): buffers(min(kk, width))}
    # the queries made contiguous and the row list moved to the card as int32
    q = q.contiguous()
    if rows is not None:
        rows = rows.to(device=dev, dtype=torch.int32, non_blocking=True).contiguous()
    rows_ptr = None if rows is None else rows.data_ptr()

    def one_pass(s, floor):
        chunk, n_splits, scratch, out_v, out_i = ready.pop(s, None) or buffers(s)
        fv, fi = (None, None) if floor is None else (floor[0].data_ptr(),
                                                     floor[1].data_ptr())
        tail = (n, s, chunk, n_splits, fv, fi, scratch.data_ptr(), qn2.data_ptr(),
                out_v.data_ptr(), out_i.data_ptr(), stream)
        if name == "screen_select":
            rc = lib.coconut_screen_select(_SCREEN_DTYPES[name][x.dtype], q.data_ptr(), m, d,
                                           x.data_ptr(), xn2.data_ptr(), rows_ptr, *tail)
        elif name == "screen_select_quant":
            rc = lib.coconut_screen_select_quant(q.data_ptr(), m, d, x.data_ptr(),
                                                 scale.data_ptr(), xn2.data_ptr(), rows_ptr,
                                                 *tail)
        else:
            rc = lib.coconut_topk_ed(q.data_ptr(), m, d, x.data_ptr(), *tail)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
        LAUNCHES[name] += 1
        return out_v, out_i, qn2

    out_v, out_i, qn2 = slate_in_passes(one_pass, kk, width)
    vals, idxs = _finish(out_v, out_i, n, k)
    return vals, idxs, qn2


def screen_select(
    q: torch.Tensor,
    x: torch.Tensor,
    xn2: torch.Tensor,
    k: int,
    *,
    rows: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused verification launch: f32 screen over candidates with
    PRECOMPUTED squared norms, in-kernel top-k slate, and the per-query
    |q|^2 certificate term.

    q: (m, d) f32, x: (N, d) f32 or bf16 (upcast to f32 in registers), xn2:
    (N,) f32. ``rows`` (n,) picks the candidates as table rows — the kernel
    gathers them itself, so no (n, d) copy is made; without it the
    candidates are the N table rows. Returns ((m, k) f32 d2 ascending,
    (m, k) int32 candidate positions (into ``rows`` when given), (m,) f32
    |q|^2). Ties break toward the smaller candidate position; unfillable
    slots are (inf, -1)."""
    return _screen("screen_select", q, x, None, xn2, k, rows)


def screen_select_quant(
    q: torch.Tensor,
    x: torch.Tensor,
    scale: torch.Tensor,
    xn2: torch.Tensor,
    k: int,
    *,
    rows: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`screen_select` over an int8 table with per-row f32 scales.

    ``xn2`` holds the squared norms of the DEQUANTIZED rows, so the screen
    is self-consistent with what is stored; the scale multiplies the cross
    term after the product (``<q, s v> = s <q, v>``). Same candidate, tie
    and padding contract as :func:`screen_select`."""
    return _screen("screen_select_quant", q, x, scale, xn2, k, rows)


# ---------------------------------------------------------------------------
# top-k squared ED with norms computed in the kernel (the kernel backend)
# ---------------------------------------------------------------------------
def _check_pair(q: torch.Tensor, x: torch.Tensor) -> torch.device:
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, x {tuple(x.shape)}")
    if q.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"q and x must be float32, not {q.dtype} and {x.dtype}")
    if q.device != x.device:
        raise ValueError(f"q on {q.device}, x on {x.device}")
    return q.device


def topk_ed(q: torch.Tensor, x: torch.Tensor,
            k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query k smallest squared EDs and candidate rows, ascending.

    q: (m, d) f32, x: (n, d) f32 -> ((m, k) f32, (m, k) int32). The kernel
    sums ``|x|^2`` from the rows it reads. Ties break toward the smaller
    candidate index; with fewer than k candidates the tail is (inf, -1)."""
    dev = _check_pair(q, x)
    m, n = q.shape[0], x.shape[0]
    if m == 0 or n == 0:  # no launch: an empty batch, or no candidates
        return (torch.full((m, k), math.inf, dtype=torch.float32, device=dev),
                torch.full((m, k), -1, dtype=torch.int32, device=dev))
    kk = max(1, min(k, n))
    if dev.type == "cpu":
        vals, idxs = ref.topk_ed_ref(q, x, kk)
        return _finish(vals, idxs, n, k)
    if dev.type != "cuda":
        raise ValueError(f"no topk_ed for device {dev}")
    vals, idxs, _ = _launch_screen("topk_ed", q, x.contiguous(), None, None, k, kk, None, n)
    return vals, idxs


def topk_ed_bucketed(q: torch.Tensor, x: torch.Tensor,
                     k: int) -> tuple[np.ndarray, np.ndarray]:
    """:func:`topk_ed` as the query executor calls it, with host results:
    ((m, kk) f32 d2, (m, kk) int64 rows into ``x``), kk = min(k, |x|), never
    filled slots (inf, -1); no candidates gives (m, k) of (inf, -1). The
    reference pads the candidate count to a power-of-two bucket for its jit
    cache; the CUDA kernel needs no padding, so none is made."""
    m, e = q.shape[0], x.shape[0]
    if e == 0:  # no candidates: every requested slot is explicit padding
        return np.full((m, k), np.inf, np.float32), np.full((m, k), -1, np.int64)
    v, i = topk_ed(q, x, min(k, e))
    return v.cpu().numpy(), i.cpu().numpy().astype(np.int64)


def min_ed(q: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query minimum squared ED over the candidate rows, and its row.

    q: (m, d) f32, x: (n, d) f32 -> ((m,) f32, (m,) int32). The kernel sums
    ``|x|^2`` from the rows it reads, as :func:`topk_ed` does, and answers
    with the first entry of the same lexicographic (d2, row) order: a tie
    keeps the lower row. An empty batch gives empty outputs and no
    candidates (inf, -1), both without a launch."""
    dev = _check_pair(q, x)
    m, n = q.shape[0], x.shape[0]
    if m == 0:
        return (torch.zeros((0,), dtype=torch.float32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    if n == 0:
        return (torch.full((m,), math.inf, dtype=torch.float32, device=dev),
                torch.full((m,), -1, dtype=torch.int32, device=dev))
    if dev.type == "cpu":
        return ref.min_ed_ref(q, x)
    if dev.type != "cuda":
        raise ValueError(f"no min_ed for device {dev}")
    return _launch_min_ed(q.contiguous(), x.contiguous())


def _launch_min_ed(q: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel of :func:`min_ed`: the fused screen's body with a min
    epilogue, one launch over the splits of ``topk_ed``'s pass at k = 1."""
    from . import _build

    dev = q.device
    m, n = q.shape[0], x.shape[0]
    chunk, n_splits = _splits(dev, n, m, 1, _build.layout()["screen"])
    best = torch.empty((m,), dtype=torch.int64, device=dev)  # 64-bit (d2, row) keys
    out_v = torch.empty((m,), dtype=torch.float32, device=dev)
    out_i = torch.empty((m,), dtype=torch.int32, device=dev)
    rc = _build.library().coconut_min_ed(q.data_ptr(), m, q.shape[1], x.data_ptr(), n,
                                         chunk, n_splits, best.data_ptr(), out_v.data_ptr(),
                                         out_i.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"min_ed kernel launch failed with CUDA error {rc}")
    LAUNCHES["min_ed"] += 1
    return out_v, out_i


# ---------------------------------------------------------------------------
# the summarize front: PAA -> SAX symbols -> interleaved sortable keys
# ---------------------------------------------------------------------------
def paa(x: torch.Tensor, cfg: SummarizationConfig) -> torch.Tensor:
    """(B, n) f32 -> (B, w) f32 PAA segment means, summed left to right."""
    w = cfg.n_segments
    if x.dim() != 2 or x.shape[1] % w:
        raise ValueError(f"x of shape {tuple(x.shape)} does not split into {w} segments")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, not {x.dtype}")
    dev, b = x.device, x.shape[0]
    if b == 0:  # empty batch: no launch
        return torch.zeros((0, w), dtype=torch.float32, device=dev)
    if dev.type == "cpu" or is_fake(x):
        return ref.paa_ref(x, w)
    if dev.type != "cuda":
        raise ValueError(f"no paa for device {dev}")
    from . import _build

    x = x.contiguous()
    out = torch.empty((b, w), dtype=torch.float32, device=dev)
    rc = _build.library().coconut_paa(x.data_ptr(), b, x.shape[1], w,
                                      out.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"paa kernel launch failed with CUDA error {rc}")
    LAUNCHES["paa"] += 1
    return out


def breakpoint_table(card_bits: int, dev: torch.device) -> torch.Tensor:
    """The 2^c - 1 sorted SAX breakpoints as an f32 tensor on ``dev``."""
    key = (card_bits, dev)
    if key not in _BREAKPOINTS:
        table = torch.from_numpy(breakpoints(card_bits)).to(dev)
        if is_fake(table):  # made under a FakeTensorMode: not kept
            return table
        _BREAKPOINTS[key] = table
    return _BREAKPOINTS[key]


def sax_and_keys(p: torch.Tensor,
                 cfg: SummarizationConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """PAA (B, w) f32 -> (symbols (B, w) int32, sortable keys (B, nw) int64
    holding the uint32 word values)."""
    w, c, nw = cfg.n_segments, cfg.card_bits, cfg.key_words
    if p.dim() != 2 or p.shape[1] != w:
        raise ValueError(f"p of shape {tuple(p.shape)}, want (B, {w})")
    if p.dtype != torch.float32:
        raise TypeError(f"p must be float32, not {p.dtype}")
    dev, b = p.device, p.shape[0]
    if b == 0:  # empty batch: no launch
        return (torch.zeros((0, w), dtype=torch.int32, device=dev),
                torch.zeros((0, nw), dtype=torch.int64, device=dev))
    bps = breakpoint_table(c, dev)
    if dev.type == "cpu" or is_fake(p):
        return ref.sax_pack_ref(p, bps, c, nw)
    if dev.type != "cuda":
        raise ValueError(f"no sax_pack for device {dev}")
    from . import _build

    layout = _build.layout()
    if nw > layout["max_key_words"] or bps.numel() > layout["max_breakpoints"]:
        raise ValueError(f"{nw} key words or {bps.numel()} breakpoints exceed the "
                         "sax_pack kernel's limits")
    p = p.contiguous()
    sym = torch.empty((b, w), dtype=torch.int32, device=dev)
    keys = torch.empty((b, nw), dtype=torch.int64, device=dev)  # zero-extended words
    rc = _build.library().coconut_sax_pack(p.data_ptr(), b, w, bps.data_ptr(),
                                           bps.numel(), c, nw, sym.data_ptr(),
                                           keys.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"sax_pack kernel launch failed with CUDA error {rc}")
    LAUNCHES["sax_pack"] += 1
    return sym, keys


def summarize(x: torch.Tensor, cfg: SummarizationConfig
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Series (B, n) -> (PAA (B, w), symbols (B, w), keys (B, nw)): one
    ``paa`` launch, then one ``sax_pack`` launch. No z-normalization."""
    p = paa(x, cfg)
    sym, keys = sax_and_keys(p, cfg)
    return p, sym, keys


def keys_to_host(keys: torch.Tensor) -> np.ndarray:
    """Sortable keys held in int64 -> the host index's numpy uint32 words."""
    return keys.cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# the pruning front: MINDIST_PAA_SAX lower bounds
# ---------------------------------------------------------------------------
def mindist(q_paa: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            cfg: SummarizationConfig) -> torch.Tensor:
    """Squared MINDIST_PAA_SAX lower bounds of one query PAA (w,) against B
    regions lo/hi (B, w), all f32 -> (B,) f32: ``seg_len * sum_s max(lo -
    q, q - hi, 0)^2``, the segments added left to right. An empty batch
    returns without a launch."""
    if q_paa.dim() != 1 or lo.dim() != 2 or lo.shape != hi.shape or \
            lo.shape[1] != q_paa.shape[0]:
        raise ValueError(f"shape mismatch: q_paa {tuple(q_paa.shape)}, lo "
                         f"{tuple(lo.shape)}, hi {tuple(hi.shape)}")
    if {q_paa.dtype, lo.dtype, hi.dtype} != {torch.float32}:
        raise TypeError("q_paa, lo and hi must be float32")
    devices = {q_paa.device, lo.device, hi.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev, (b, w) = lo.device, lo.shape
    if b == 0:  # empty batch: no launch
        return torch.zeros((0,), dtype=torch.float32, device=dev)
    if dev.type == "cpu" or is_fake(lo):
        return ref.mindist_ref(q_paa, lo, hi, cfg.segment_len)
    if dev.type != "cuda":
        raise ValueError(f"no mindist for device {dev}")
    from . import _build

    q_paa, lo, hi = q_paa.contiguous(), lo.contiguous(), hi.contiguous()
    vec = int(w % 4 == 0 and lo.data_ptr() % 16 == 0 and hi.data_ptr() % 16 == 0)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    rc = _build.library().coconut_mindist(q_paa.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                                          b, w, float(cfg.segment_len), vec,
                                          out.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"mindist kernel launch failed with CUDA error {rc}")
    LAUNCHES["mindist"] += 1
    return out
