"""The plain reference: what each cell's answers have to be.

Independent of the program: it reads the inputs again from the seed
(``gen.RowStream``) and works every answer out from them, in float64, in
blocks of rows so that it fits beside nothing else on the card.

* ``exact_topk``: the k nearest rows of each query over a row range; it
  also computes the TF32 control, the same answers in float32 with the
  products in TF32.
* ``true_d2``: float64 distances of named rows, for judging an answer.
"""
from __future__ import annotations

import numpy as np
import torch


def _topk_merge(best_d, best_i, d, i, k):
    cd = torch.cat([best_d, d], dim=1)
    ci = torch.cat([best_i, i], dim=1)
    o = torch.topk(cd, k, dim=1, largest=False, sorted=True).indices
    return torch.gather(cd, 1, o), torch.gather(ci, 1, o)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x.to(torch.float64 if precision == "float64" else torch.float32)


def _d2(q: torch.Tensor, x: torch.Tensor, xn: torch.Tensor, precision: str):
    """Squared distances ``|q|^2 + |x|^2 - 2 q.x`` of each row of ``q`` to
    each row of ``x`` (``xn`` its squared norms), both cast by ``_cast``.

    ``precision`` is ``"float64"`` (the reference) or ``"tf32"`` (the
    control: float32 with the product in TF32, the card's tensor cores; on
    the CPU the inputs rounded to TF32)."""
    if precision == "float64":
        g = q @ x.T
    elif x.device.type == "cuda":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            g = q @ x.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    else:
        g = _tf32(q) @ _tf32(x).T
    return (q * q).sum(dim=1, keepdim=True) + xn[None, :] - 2.0 * g


def exact_topk(Q: np.ndarray, blocks, k: int, q_block: int = 1024,
               precision: str = "float64"):
    """Exact k nearest of each query over rows given as ``blocks``: an
    iterable of (first row id, (r, d) float32 tensor on the device).
    Returns ((m, k) float64 squared distances ascending, (m, k) int64 ids)
    as numpy arrays; ``precision`` as in ``_d2``."""
    m = Q.shape[0]
    best_d = best_i = None
    for base, xb in blocks:
        dev = xb.device
        x = _cast(xb, precision)
        xn = (x * x).sum(dim=1)
        if best_d is None:
            best_d = torch.full((m, k), float("inf"), dtype=torch.float64,
                                device=dev)
            best_i = torch.full((m, k), -1, dtype=torch.int64, device=dev)
        for a in range(0, m, q_block):
            q = _cast(torch.from_numpy(np.ascontiguousarray(Q[a:a + q_block])).to(dev),
                      precision)
            d = _d2(q, x, xn, precision)
            kk = min(k, d.shape[1])
            v, j = torch.topk(d, kk, dim=1, largest=False, sorted=True)
            best_d[a:a + q_block], best_i[a:a + q_block] = _topk_merge(
                best_d[a:a + q_block], best_i[a:a + q_block], v, j + base, k)
    return best_d.cpu().numpy(), best_i.cpu().numpy()


def true_d2(Q: np.ndarray, ids: np.ndarray, X: torch.Tensor) -> np.ndarray:
    """Float64 squared distances of each query to the rows of ``X`` its
    answer names, (m, k); ``nan`` where an id names no row."""
    out = np.full(ids.shape, np.nan)
    ok = (ids >= 0) & (ids < X.shape[0])
    rows_of = lambda i: X[torch.from_numpy(i).to(X.device)]
    if ok.any():
        x = rows_of(ids[ok]).to(torch.float64)
        q = torch.from_numpy(np.ascontiguousarray(Q)).to(x.device, torch.float64)
        qi = torch.from_numpy(np.nonzero(ok)[0]).to(x.device)
        diff = x - q[qi]
        out[ok] = (diff * diff).sum(dim=1).cpu().numpy()
    return out
