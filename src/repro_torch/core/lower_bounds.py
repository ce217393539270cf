"""Lower-bound distances used for pruning in exact search.

MINDIST_PAA_SAX(q, x) <= ED(q, x): the classic iSAX guarantee chain —
PAA lower-bounds ED (Keogh), and the SAX region of x contains paa(x), so the
point-to-region distance lower-bounds the PAA distance.

Everything here is numpy (host search engine); the device twin lives in
``kernels/ref.py`` and ``kernels/lb_kernel.py``.
"""
from __future__ import annotations

import numpy as np

from .summarization import SummarizationConfig, breakpoints, paa, sax_region


def ed2(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Squared Euclidean distance. q: (n,) or (m, n); x: (..., n)."""
    d = x - q
    return np.sum(d * d, axis=-1)


def topk_ed2(q: np.ndarray, x: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Batched k smallest squared EDs per query — the host twin of the
    ``kernels.ops.topk_ed`` device path (same matmul form, float64
    accumulation so it keeps the scalar ``ed2`` path's accuracy).

    q: (m, n), x: (N, n) -> ((m, kk) f32 ascending, (m, kk) int64 candidate
    rows) with kk = min(k, N)."""
    q64 = np.asarray(q, np.float64)
    x64 = np.asarray(x, np.float64)
    d2 = (
        np.sum(q64 * q64, axis=-1)[:, None]
        + np.sum(x64 * x64, axis=-1)[None, :]
        - 2.0 * q64 @ x64.T
    )
    d2 = np.maximum(d2, 0.0).astype(np.float32)  # (m, N)
    kk = min(k, x64.shape[0])
    part = np.argpartition(d2, kk - 1, axis=1)[:, :kk] if kk < d2.shape[1] else (
        np.broadcast_to(np.arange(kk), (d2.shape[0], kk))
    )
    pv = np.take_along_axis(d2, part, axis=1)
    o = np.argsort(pv, axis=1, kind="stable")
    return (
        np.take_along_axis(pv, o, axis=1),
        np.take_along_axis(part, o, axis=1).astype(np.int64),
    )


def mindist_paa_sax2(q_paa: np.ndarray, sym: np.ndarray, cfg: SummarizationConfig) -> np.ndarray:
    """Squared MINDIST between a query's PAA and candidates' SAX regions.

    q_paa: (w,) or (m, 1, w) broadcastable against sym's leading dims
    sym:   (..., w) int SAX symbols
    returns squared lower bound on ED (same leading shape as sym/broadcast).
    """
    lo, hi = sax_region(sym, cfg)
    below = np.maximum(lo - q_paa, 0.0)
    above = np.maximum(q_paa - hi, 0.0)
    d = np.maximum(below, above)
    return cfg.segment_len * np.sum(d * d, axis=-1, dtype=np.float64).astype(np.float32)


def mindist_region2(
    q_paa: np.ndarray,
    min_sym: np.ndarray,
    max_sym: np.ndarray,
    cfg: SummarizationConfig,
) -> np.ndarray:
    """Squared MINDIST between a query's PAA and a *range* of SAX symbols
    (zone map of a block / LSM run / iSAX subtree node).

    The region per segment is [region_lo(min_sym), region_hi(max_sym)], which
    contains every entry's region, so this lower-bounds every entry's
    MINDIST and hence every entry's true ED.
    """
    bps = breakpoints(cfg.card_bits)
    big = np.float32(1e30)
    lo_edges = np.concatenate([[-big], bps]).astype(np.float32)
    hi_edges = np.concatenate([bps, [big]]).astype(np.float32)
    lo = lo_edges[min_sym]
    hi = hi_edges[max_sym]
    below = np.maximum(lo - q_paa, 0.0)
    above = np.maximum(q_paa - hi, 0.0)
    d = np.maximum(below, above)
    return cfg.segment_len * np.sum(d * d, axis=-1, dtype=np.float64).astype(np.float32)


def query_paa(q: np.ndarray, cfg: SummarizationConfig) -> np.ndarray:
    """PAA of a query (convenience; honors cfg.znorm)."""
    return np.asarray(paa(q, cfg))
