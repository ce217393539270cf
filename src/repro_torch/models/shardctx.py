"""Activation-sharding context.

The launch layer installs (mesh, dp-axes) here before it runs a sharded
step; model code then pins the placements the reference's GSPMD lowering
gives and ``DTensor``'s own propagation would not: the activations at the
reference's sites and at the attention and residual joins
(:func:`constrain`, which pins the gradient too), FSDP weights gathered
where they are used (:func:`gather`), a sequence-split KV cache written in
the shard that owns the slot (:func:`write_slot`), a vocab-split
embedding looked up on local shards (:func:`embed`). When no context is
installed (unit tests, the single-card paths) each returns its argument
itself or runs the plain op, so model code stays mesh-agnostic; the
split-only helpers act where :func:`split` says a dim is split over more
than one rank, so a one-rank mesh runs the plain arithmetic too.

A spec is one entry per tensor dimension, as a ``PartitionSpec`` is: a mesh
axis name, a tuple of them (several mesh dimensions sharding the same tensor
dimension, in mesh order), or ``None``. :func:`placements` turns it into
one ``DTensor`` placement per mesh dimension.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_CTX: Optional[dict] = None

DP = "__dp__"  # placeholder resolved to the data-parallel axis tuple


def set_ctx(mesh, dp_axes: tuple) -> None:
    global _CTX
    _CTX = {"mesh": mesh, "dp": tuple(dp_axes)}


def clear_ctx() -> None:
    global _CTX
    _CTX = None


@contextlib.contextmanager
def ctx(mesh, dp_axes: tuple):
    set_ctx(mesh, dp_axes)
    try:
        yield
    finally:
        clear_ctx()


def axis_sizes(mesh) -> dict:
    """{axis name: size}; ``mesh`` is a ``DeviceMesh`` or anything with
    ``mesh_dim_names`` and ``shape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def placements(spec, mesh) -> tuple:
    """One placement per mesh dimension: ``Shard(d)`` on each mesh dimension
    that ``spec`` names at tensor dimension ``d``, ``Replicate()`` on the
    others."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def resolve(shape, spec, mesh, dp: tuple) -> tuple:
    """``spec`` with ``DP`` replaced by the dp axes and every entry whose
    axes do not divide its dimension dropped to ``None``."""
    sizes = axis_sizes(mesh)
    resolved = []
    for dim, s in enumerate(spec):
        if s == DP:
            s = dp if len(dp) > 1 else dp[0]
        if s is None:
            resolved.append(None)
            continue
        axes = (s,) if isinstance(s, str) else tuple(s)
        total = 1
        for a in axes:
            total *= sizes[a]
        resolved.append(s if shape[dim] % total == 0 else None)
    return tuple(resolved)


class _PlaceGrad(torch.autograd.Function):
    """The identity, whose gradient is redistributed to ``want`` on its way
    back (a gradient summed over ranks is all-reduced where its value was
    pinned, as GSPMD pins both)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def constrain(x, *spec):
    """Pin x's placements (DP placeholder -> dp axes), and its gradient's
    under autograd. Returns ``x`` itself without a context; axes referring
    to dims that don't divide are dropped. A ``DTensor`` is redistributed
    to the spec's placements; a plain tensor under a context stays the
    plain tensor it is (nothing places it: it is the same on every rank)."""
    if _CTX is None or not isinstance(x, DTensor):
        return x
    mesh = _CTX["mesh"]
    want = placements(resolve(x.shape, spec, mesh, _CTX["dp"]), mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    if x.requires_grad:
        x = _PlaceGrad.apply(x, want)
    return x


def split(x, dim: int) -> bool:
    """Under a context, ``x`` is a ``DTensor`` whose dimension ``dim`` is
    split over more than one rank (a sequence-sharded cache)."""
    if _CTX is None or not isinstance(x, DTensor):
        return False
    return any(isinstance(p, Shard) and p.dim == dim and x.device_mesh.size(i) > 1
               for i, p in enumerate(x.placements))


def local_range(x: DTensor, dim: int) -> tuple:
    """(first index, length) of this rank's block of ``x`` along ``dim``:
    each mesh dimension that shards ``dim`` cuts the block left so far into
    ``torch.chunk``'s pieces, in mesh order."""
    mesh = x.device_mesh
    start, size = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            piece = -(-size // mesh.size(i))
            lo = min(mesh.get_local_rank(i) * piece, size)
            start, size = start + lo, min(piece, size - lo)
    return start, size


def write_slot(cache: DTensor, dim: int, slot: int, value) -> None:
    """``cache`` indexed ``slot`` along ``dim`` = ``value`` (of size 1 along
    ``dim``), in place, where ``dim`` is split over ranks: the rank whose
    shard holds the slot writes it into its local tensor, the others
    write nothing, and nothing is gathered (the reference's
    ``dynamic_update_slice`` of a sharded cache). ``value`` is first placed
    as the cache is, with ``dim`` replicated."""
    mesh = cache.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in cache.placements]
    if not isinstance(value, DTensor):  # the same on every rank
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    if tuple(value.placements) != tuple(want):
        value = value.redistribute(mesh, want)
    start, size = local_range(cache, dim)
    i = slot - start
    if 0 <= i < size:
        cache.to_local().select(dim, i).copy_(value.to_local().select(dim, 0))


def _axes(names) -> set:
    out = set()
    for a in names:
        out.update(_CTX["dp"] if a == DP else (a,))
    return out


def gather(w, *axes):
    """``w`` replicated over the named mesh axes (``DP`` for the dp axes)
    where it is used: the FSDP gather of a weight before its product. The
    backward reduce-scatters the gradient back to ``w``'s placements.
    Returns ``w`` itself without a context."""
    if _CTX is None or not isinstance(w, DTensor):
        return w
    names = _axes(axes)
    mesh = w.device_mesh
    want = tuple(Replicate() if n in names and isinstance(p, Shard) else p
                 for n, p in zip(mesh.mesh_dim_names, w.placements))
    return w if want == tuple(w.placements) else w.redistribute(mesh, want)


def divides(n: int, axis: str) -> bool:
    """``axis`` (its size under the context) divides ``n``; true without
    a context."""
    return _CTX is None or n % axis_sizes(_CTX["mesh"]).get(axis, 1) == 0


def embed(table, ids):
    """``table[ids]``. Where the table's rows (the vocab) are split over
    ranks, indexing would reshard the whole table; instead each rank looks
    up the ids that fall in its block, zero elsewhere, and the partial rows
    are all-reduced (the reference's GSPMD lowering of the gather). The
    table's gradient stays on the rank that owns each row."""
    if not split(table, 0):
        return table[ids]
    mesh = table.device_mesh
    if not isinstance(ids, DTensor):  # the same on every rank
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    ids = constrain(ids, DP, *(None,) * (ids.ndim - 1))
    batch = [isinstance(p, Shard) for p in ids.placements]
    rows_split = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    lo, size = local_range(table, 0)
    idx = ids.to_local() - lo
    inside = (idx >= 0) & (idx < size)
    local = table.to_local(grad_placements=[
        Partial() if b else p for b, p in zip(batch, table.placements)])
    rows = local[idx.clamp(0, max(size - 1, 0))] * inside[..., None].to(local.dtype)
    places = [Partial() if r else Shard(0) if b else Replicate()
              for r, b in zip(rows_split, batch)]
    shape = tuple(ids.shape) + (table.shape[1],)
    out = DTensor.from_local(rows, mesh, places, run_check=False, shape=shape,
                             stride=tuple(math.prod(shape[d + 1:]) for d in range(len(shape))))
    return constrain(out, DP, *(None,) * ids.ndim)
