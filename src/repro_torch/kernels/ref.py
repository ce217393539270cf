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
