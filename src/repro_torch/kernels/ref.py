"""Plain PyTorch versions of the hand-written kernels.

Each function is the semantic ground truth of its CUDA kernel: the CPU path
runs it, and ``chip_smoke.py`` holds the kernel against it on the card.

Selection is lexicographic on (d2, candidate index): a stable sort by d2,
then the first k. ``torch.topk`` is not used: it does not promise which of
tied candidates it keeps (``torch.topk(-torch.zeros(8), 3)`` returns indices
``[6, 5, 4]``), and the slate must keep the lower index.
"""
from __future__ import annotations

import torch


def _check_ieee_f32() -> None:
    """The engine's certificate bounds the error of a true f32 product. A
    TF32 product keeps 10 mantissa bits and voids it, so the plain screen
    refuses to run while PyTorch may route f32 products through TF32."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is set: the screen needs "
            "true f32 products (the certificate bound assumes f32 rounding)")


def _lex_topk(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """First k of each row in (d2, index) order."""
    sv, si = torch.sort(d2, dim=1, stable=True)
    return sv[:, :k], si[:, :k].to(torch.int32)


def screen_select_ref(
    q: torch.Tensor, x: torch.Tensor, xn2: torch.Tensor, k: int
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
    sv, si = _lex_topk(d2, k)
    return sv, si, qn2


def screen_select_quant_ref(
    q: torch.Tensor, x: torch.Tensor, scale: torch.Tensor, xn2: torch.Tensor,
    k: int
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
    sv, si = _lex_topk(d2, k)
    return sv, si, qn2


def topk_ed_ref(q: torch.Tensor, x: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query k smallest squared EDs and candidate rows: matmul-form d2
    with |x|^2 summed from the rows themselves, lexicographic (d2, index)
    top-k.

    q: (m, d), x: (n, d) f32, 1 <= k <= n -> ((m, k) f32 ascending,
    (m, k) int32)."""
    _check_ieee_f32()
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    d2 = (q * q).sum(-1)[:, None] + (x * x).sum(-1)[None, :] - 2.0 * (q @ x.T)
    return _lex_topk(d2, k)


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
