"""Public wrappers around the hand-written screen+select kernels.

Dispatch follows the device of the tensors: a CUDA tensor goes to the CUDA
kernel (``csrc/screen_select.cu``, built on first use by :mod:`._build`) or
the call raises; a CPU tensor goes to the plain PyTorch version in
:mod:`.ref`. There is no fallback from one to the other.

Each kernel has a launch count in :data:`LAUNCHES`, raised by one where the
wrapper launches it and nowhere else, so a run can show that its main path
went through the kernel.

Contract (the reference's ``kernels.ops`` wrappers): the screen is
``|q|^2 + xn2 - 2 q.x`` over precomputed candidate norms, the slate is the
top-k in lexicographic (d2, candidate) order, slots that no candidate can
fill come back as ``(inf, -1)``, and ``k > n`` pads the tail that way. The
reference zero-pads ``d`` to a multiple of 128 for the TPU's lanes; the CUDA
kernel takes any ``d`` and needs no padding.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import ref

# sentinel |x|^2 for pad candidates: dominates any real screened distance
# without overflowing the f32 d2 arithmetic
BIG_NORM2 = 1e30

# launches of each CUDA kernel since the last reset
LAUNCHES = {"screen_select": 0, "screen_select_quant": 0}

_SM_COUNT: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def max_slate() -> int:
    """The largest slate (k) the CUDA kernels hold, as the built library
    defines it; the wrappers refuse more on a CUDA tensor."""
    from . import _build

    return _build.layout()["max_slate"]


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
    return _launch(name, q, x, scale, xn2, k, kk, rows, n)


def _launch(name, q, x, scale, xn2, k, kk, rows, n):
    """The CUDA kernels: partial slates over candidate splits, then a merge."""
    from . import _build  # builds the library on first use

    layout = _build.layout()
    if kk > layout["max_slate"]:
        raise ValueError(f"slate of {kk} exceeds the kernels' maximum "
                         f"{layout['max_slate']}")
    for t, what in ((x, "x"), (xn2, "xn2"), (scale, "scale")):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    dev = q.device
    q = q.contiguous()
    m, d = q.shape
    if rows is not None:
        rows = rows.to(device=dev, dtype=torch.int32, non_blocking=True).contiguous()
    chunk, n_splits = _splits(dev, n, m, kk, layout)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    part_v = torch.empty((m, n_splits, kk), **f32)
    part_i = torch.empty((m, n_splits, kk), **i32)
    qn2 = torch.empty((m,), **f32)
    out_v = torch.empty((m, kk), **f32)
    out_i = torch.empty((m, kk), **i32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows_ptr = None if rows is None else rows.data_ptr()
    lib = _build.library()
    tail = (rows_ptr, n, kk, chunk, n_splits, part_v.data_ptr(), part_i.data_ptr(),
            qn2.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), stream)
    if name == "screen_select":
        code = {torch.float32: 0, torch.bfloat16: 1}.get(x.dtype)
        if code is None:
            raise TypeError(f"screen_select takes f32 or bf16 tables, not {x.dtype}")
        rc = lib.coconut_screen_select(code, q.data_ptr(), m, d, x.data_ptr(),
                                       xn2.data_ptr(), *tail)
    else:
        if x.dtype != torch.int8:
            raise TypeError(f"screen_select_quant takes int8 tables, not {x.dtype}")
        rc = lib.coconut_screen_select_quant(q.data_ptr(), m, d, x.data_ptr(),
                                             scale.data_ptr(), xn2.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1
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
