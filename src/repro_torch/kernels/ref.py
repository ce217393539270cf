"""Plain PyTorch versions of the hand-written kernels.

Each function is the semantic ground truth of its CUDA kernel: the CPU path
runs it, and ``chip_smoke.py`` holds the kernel against it on the card.

Selection is lexicographic on (d2, candidate index): a stable sort by d2,
then the first k. ``torch.topk`` is not used: it does not promise which of
tied candidates it keeps (``torch.topk(-torch.zeros(8), 3)`` returns indices
``[6, 5, 4]``), and the slate must keep the lower index. The slate versions
take the kernels' optional per-query ``floor``: then the slate is the first
k entries lexicographically after it, as one pass of a longer slate.
"""
from __future__ import annotations

from typing import Optional

import torch

EMPTY_ID = 2**31 - 1  # the id of a slot no candidate fills

Floor = Optional[tuple[torch.Tensor, torch.Tensor]]


def _check_ieee_f32() -> None:
    """The engine's certificate bounds the error of a true f32 product. A
    TF32 product keeps 10 mantissa bits and voids it, so the plain screen
    refuses to run while PyTorch may route f32 products through TF32."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is set: the screen needs "
            "true f32 products (the certificate bound assumes f32 rounding)")


def _lex_topk(d2: torch.Tensor, k: int,
              floor: Floor = None) -> tuple[torch.Tensor, torch.Tensor]:
    """First k of each row in (d2, index) order; with ``floor`` ((m,) d2,
    (m,) index), the first k after it, slots past the end (inf,
    EMPTY_ID)."""
    sv, si = torch.sort(d2, dim=1, stable=True)
    if floor is None:
        return sv[:, :k], si[:, :k].to(torch.int32)
    fv = floor[0].to(sv.dtype)[:, None]
    fi = floor[1].to(si.dtype)[:, None]
    # the sorted row starts with every entry at or before the floor
    start = ((sv < fv) | ((sv == fv) & (si <= fi))).sum(1, keepdim=True)
    pos = start + torch.arange(k, device=d2.device)[None, :]
    inside = pos < d2.shape[1]
    pos = pos.clamp_max(d2.shape[1] - 1)
    return (torch.where(inside, sv.gather(1, pos), torch.inf),
            torch.where(inside, si.gather(1, pos), EMPTY_ID).to(torch.int32))


def screen_select_ref(
    q: torch.Tensor, x: torch.Tensor, xn2: torch.Tensor, k: int, floor: Floor = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused screen+select: matmul-form d2 with PRECOMPUTED candidate norms
    (the verification engine's cached |x|^2), lexicographic (d2, index)
    top-k, plus the per-query |q|^2 certificate term.

    q: (m, d), x: (n, d) f32 or bf16 (upcast), xn2: (n,), 1 <= k <= n ->
    ((m, k) f32 ascending, (m, k) int32, (m,) f32)."""
    _check_ieee_f32()
    q = q.to(torch.float32)
    qn2 = (q * q).sum(-1)
    g = q @ x.to(torch.float32).T
    d2 = qn2[:, None] + xn2.to(torch.float32)[None, :] - 2.0 * g
    sv, si = _lex_topk(d2, k, floor)
    return sv, si, qn2


def screen_select_quant_ref(
    q: torch.Tensor, x: torch.Tensor, scale: torch.Tensor, xn2: torch.Tensor,
    k: int, floor: Floor = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 screen: upcast the stored values to f32, apply the per-row
    scale to the cross term AFTER the product (the kernel's order), and use
    the precomputed dequantized norms.

    q: (m, d) f32, x: (n, d) int8, scale: (n,) f32, xn2: (n,), 1 <= k <= n
    -> ((m, k) f32 ascending, (m, k) int32, (m,) f32)."""
    _check_ieee_f32()
    q = q.to(torch.float32)
    g = (q @ x.to(torch.float32).T) * scale.to(torch.float32)[None, :]
    qn2 = (q * q).sum(-1)
    d2 = qn2[:, None] + xn2.to(torch.float32)[None, :] - 2.0 * g
    sv, si = _lex_topk(d2, k, floor)
    return sv, si, qn2


def topk_ed_ref(q: torch.Tensor, x: torch.Tensor, k: int,
                floor: Floor = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query k smallest squared EDs and candidate rows: matmul-form d2
    with |x|^2 summed from the rows themselves, lexicographic (d2, index)
    top-k.

    q: (m, d), x: (n, d) f32, 1 <= k <= n -> ((m, k) f32 ascending,
    (m, k) int32)."""
    _check_ieee_f32()
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    d2 = (q * q).sum(-1)[:, None] + (x * x).sum(-1)[None, :] - 2.0 * (q @ x.T)
    return _lex_topk(d2, k, floor)


def min_ed_ref(q: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query minimum squared ED and its row: the first entry of
    :func:`topk_ed_ref`'s lexicographic (d2, index) order, so a tie keeps
    the lower row. q: (m, d), x: (n, d) f32, n >= 1 -> ((m,) f32, (m,)
    int32)."""
    v, i = topk_ed_ref(q, x, 1)
    return v[:, 0], i[:, 0]


def mindist_ref(q_paa: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                seg_len: int) -> torch.Tensor:
    """Squared MINDIST_PAA_SAX lower bound of one query PAA against regions:
    ``seg_len * sum_s max(lo - q, q - hi, 0)^2``, the segments added left to
    right in f32, each square and each sum rounded on its own (the kernel's
    order, so the two agree bit for bit). q_paa: (w,), lo/hi: (B, w) ->
    (B,) f32."""
    _check_ieee_f32()
    q = q_paa.to(torch.float32)[None, :]
    lo = lo.to(torch.float32)
    hi = hi.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=lo.device)
    dseg = torch.maximum(torch.maximum(lo - q, zero), torch.maximum(q - hi, zero))
    acc = torch.zeros(lo.shape[0], dtype=torch.float32, device=lo.device)
    for s in range(lo.shape[1]):
        acc = acc + dseg[:, s] * dseg[:, s]
    return acc * float(seg_len)


def paa_ref(x: torch.Tensor, n_segments: int) -> torch.Tensor:
    """PAA segment means, (B, n) -> (B, w) f32, summed in one fixed order:
    left to right within each segment, then divided by the segment length.
    The CUDA kernel adds in the same order, so the two agree bit for bit
    (a PAA value within an ulp of a SAX breakpoint would otherwise take
    either symbol, depending on the order)."""
    x = x.to(torch.float32)
    b, n = x.shape
    seg = x.reshape(b, n_segments, n // n_segments)
    acc = seg[:, :, 0].clone()
    for j in range(1, seg.shape[2]):
        acc += seg[:, :, j]
    # a tensor divisor: PyTorch's CUDA division by a scalar multiplies by
    # its reciprocal, which rounds differently when the length is not a
    # power of two
    return acc / torch.full_like(acc, float(seg.shape[2]))


def sax_pack_ref(p: torch.Tensor, bps: torch.Tensor, card_bits: int,
                 n_words: int) -> tuple[torch.Tensor, torch.Tensor]:
    """SAX symbols and interleaved sortable keys.

    The symbol of a PAA value is the count of breakpoints <= the value. Key
    bit ``pos = b * w + s`` (``b`` from the MSB of the symbol, ``s`` the
    segment) is bit ``31 - pos % 32`` of word ``pos // 32``. p: (B, w) f32,
    bps: (2^c - 1,) sorted -> ((B, w) int32 symbols, (B, n_words) int64
    keys holding the uint32 word values: torch has no ``<<`` for uint32 on
    the CPU)."""
    p = p.to(torch.float32)
    sym = (p[:, :, None] >= bps.to(torch.float32)[None, None, :]).sum(-1)
    b, w = sym.shape
    shifts = torch.arange(card_bits - 1, -1, -1, device=p.device)
    bits = (sym[:, None, :] >> shifts[None, :, None]) & 1  # (B, c, w)
    flat = bits.reshape(b, card_bits * w)
    flat = torch.nn.functional.pad(flat, (0, n_words * 32 - card_bits * w))
    weights = torch.ones((), dtype=torch.int64, device=p.device) << torch.arange(
        31, -1, -1, device=p.device)
    keys = (flat.reshape(b, n_words, 32) * weights).sum(-1)
    return sym.to(torch.int32), keys
