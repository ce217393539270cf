"""The host's share of verification: the exact and slack screens, the f64
slate re-rank and the exactness certificate.

Every verification path ends here. The host backend screens with
:func:`screen_topk_exact` or :func:`screen_topk_slack`; the device engine
and the mesh re-rank their slates with :func:`rerank_slate`, certify them
with :func:`uncertified` and re-screen what fails with :func:`rescreen`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# slate slack beyond k: absorbs f32 near-tie reordering
SLACK = 8


def rerank_slate(
    Q: np.ndarray, X: np.ndarray, rows: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Exact f64 re-rank of per-query candidate slates.

    ``rows`` is (m, s) row indices into ``X`` (negative = invalid slot).
    Returns ((m, kk) d2 ascending f32, (m, kk) rows, -1 padded), kk =
    min(k, |X|) — the common tail of every screening backend, so returned
    distances are exact however the slate was selected."""
    invalid = rows < 0
    sel = np.where(invalid, 0, rows)
    diff = X[sel].astype(np.float64) - Q[:, None, :].astype(np.float64)
    d2 = np.einsum("mkn,mkn->mk", diff, diff)
    d2 = np.where(invalid, np.inf, d2.astype(np.float32))
    kk = min(k, X.shape[0])
    o = np.argsort(d2, axis=1, kind="stable")[:, :kk]
    return (
        np.take_along_axis(d2, o, axis=1),
        np.take_along_axis(np.where(invalid, -1, rows), o, axis=1),
    )


def screen_topk_exact(
    Q: np.ndarray, data: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Provably exact top-k: one shared f32 sgemm screen, then f64 re-rank
    of everything inside the error-bound-widened kth radius.

    The screen's only error source is the f32 cross product, whose
    classical bound (2 n u |q||x|) widens the kth-best radius — selection
    stays provably sufficient however ill-conditioned the data. The f64
    re-rank of the selected tail is centered by the tail mean (squared ED
    is translation-invariant), so the matmul form stays accurate even
    under catastrophic cancellation (a common offset much larger than the
    spread); the centering is tail-sized, i.e. free."""
    m = Q.shape[0]
    u = data.shape[0]
    kk = min(k, u)
    x32 = np.ascontiguousarray(data, np.float32)
    g = x32 @ Q.T  # (U, m) f32 sgemm — the shared heavy pass
    xsq = np.einsum("un,un->u", x32, x32, dtype=np.float64)
    qsq = np.einsum("mn,mn->m", Q, Q, dtype=np.float64)
    d2a = qsq[:, None] + xsq[None, :] - 2.0 * g.T  # (m, U) f64-ish
    if kk < u:
        part = np.argpartition(d2a, kk - 1, axis=1)[:, :kk]
    else:
        part = np.broadcast_to(np.arange(kk), (m, kk)).copy()
    kth = np.take_along_axis(d2a, part, axis=1).max(axis=1)  # (m,)
    qn = np.sqrt(qsq)
    xn_max = float(np.sqrt(xsq.max()))
    bound = 4.0 * data.shape[1] * np.finfo(np.float32).eps * qn * xn_max
    cand = d2a <= (kth + 2.0 * bound)[:, None]  # (m, U)
    sel = np.nonzero(cand.any(axis=0))[0]  # (S,) small tail
    x64 = data[sel].astype(np.float64)
    mu = x64.mean(axis=0) if sel.size else 0.0  # tail-sized centering
    x64 -= mu
    q64 = Q.astype(np.float64) - mu
    d2e = (
        np.einsum("mn,mn->m", q64, q64)[:, None]
        + np.einsum("sn,sn->s", x64, x64)[None, :]
        # this matmul IS the exact f64 re-rank tail, not the f32 screen
        - 2.0 * (q64 @ x64.T)  # palmlint: ignore[precision-discipline]
    )  # (m, S) exact (centered, so the matmul form cannot cancel)
    d2e = np.maximum(d2e, 0.0).astype(np.float32)
    kks = min(kk, d2e.shape[1])
    if kks < d2e.shape[1]:
        p2 = np.argpartition(d2e, kks - 1, axis=1)[:, :kks]
    else:
        p2 = np.broadcast_to(np.arange(kks), (m, kks)).copy()
    nv = np.take_along_axis(d2e, p2, axis=1)
    o = np.argsort(nv, axis=1, kind="stable")
    return (
        np.take_along_axis(nv, o, axis=1),
        sel[np.take_along_axis(p2, o, axis=1)].astype(np.int64),
    )


def screen_topk_slack(
    Q: np.ndarray,
    data: np.ndarray,
    k: int,
    xsq: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Slack top-k: rank by one f32 sgemm screen (|q|^2 is constant per
    row, so the screen orders by |x|^2 - 2<q, x> only), then exactly
    re-rank the k + SLACK slate in f64 — the host twin of the kernel path,
    with cached squared norms (``xsq``) so nothing union-sized is
    recomputed."""
    m = Q.shape[0]
    u = data.shape[0]
    if xsq is None:
        x32 = np.asarray(data, np.float32)
        xsq = np.einsum("un,un->u", x32, x32)
    d2a = Q @ data.T  # (m, U) f32 sgemm — the heavy pass
    np.multiply(d2a, -2.0, out=d2a)
    np.add(d2a, xsq[None, :], out=d2a)
    ksel = min(k + SLACK, u)
    if ksel < u:
        part = np.argpartition(d2a, ksel - 1, axis=1)[:, :ksel]
    else:
        part = np.broadcast_to(np.arange(u), (m, u)).copy()
    diff = data[part].astype(np.float64) - Q.astype(np.float64)[:, None, :]
    d2e = np.einsum("mkn,mkn->mk", diff, diff).astype(np.float32)
    kk = min(k, u)
    o = np.argsort(d2e, axis=1, kind="stable")[:, :kk]
    return (
        np.take_along_axis(d2e, o, axis=1),
        np.take_along_axis(part, o, axis=1).astype(np.int64),
    )


def uncertified(
    nv: np.ndarray, slate_rows: np.ndarray, worst: np.ndarray,
    qn: np.ndarray, xnmax: float, d: int, qerr: float = 0.0,
) -> np.ndarray:
    """The queries whose f32-screened slate may have lost a true neighbour.

    ``nv`` is the slate re-ranked in f64 (k columns: only a slate narrower
    than its candidates needs a certificate), ``slate_rows`` its rows (-1 =
    unfilled), ``worst`` each query's worst screen d2 on the slate, ``qn``
    and ``xnmax`` the centered query norms and largest row norm. A row
    screened out has true d2 >= worst - 2*bound, bound the f32 product
    term ``4 d u |q||x|`` plus, for rows stored quantized to within
    ``qerr``, ``2(|q| + |x|) qerr``: a query whose exact kth distance
    clears that margin provably lost nothing."""
    bound = 4.0 * d * np.finfo(np.float32).eps * qn * xnmax
    if qerr > 0.0:
        bound = bound + 2.0 * (qn + xnmax) * qerr
    kth = nv[:, -1]
    certified = (slate_rows >= 0).all(axis=1) & (
        np.where(np.isfinite(kth), kth, 0.0) <= worst - 2.0 * bound
    )
    return np.nonzero(~certified)[0]


def rescreen(
    nv: np.ndarray, nrows: np.ndarray, bad: np.ndarray, Q: np.ndarray,
    data: np.ndarray, k: int, *, rows: Optional[np.ndarray] = None,
    exact: bool = True,
) -> None:
    """Write the host screen of the queries ``bad`` over ``data`` into
    their slots of the re-ranked slate (``nv``, ``nrows``), padded with
    (inf, -1) to its width. ``rows`` maps rows of ``data`` to the slate's
    rows (identity when None). ``exact=False`` screens with the slack
    screen, as the approximate tiers do."""
    screen = screen_topk_exact if exact else screen_topk_slack
    ev, er = screen(Q[bad], data, k)
    pad = nv.shape[1] - ev.shape[1]
    if pad > 0:
        ev = np.concatenate(
            [ev, np.full((bad.size, pad), np.inf, ev.dtype)], axis=1)
        er = np.concatenate(
            [er, np.full((bad.size, pad), -1, er.dtype)], axis=1)
    nv[bad] = ev
    nrows[bad] = er if rows is None else np.where(
        er >= 0, rows[np.maximum(er, 0)], -1)
