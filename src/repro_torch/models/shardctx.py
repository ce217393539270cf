"""Activation-sharding context.

The launch layer installs (mesh, dp-axes) here before it runs a sharded
step; model code then pins the placements of the few activations the
sharding propagation would leave elsewhere (the embedding gather's output,
the logits, the loss's f32 logits) with :func:`constrain`. When no context
is installed (unit tests, the single-card paths) every ``constrain`` returns
its argument itself, so model code stays mesh-agnostic.

A spec is one entry per tensor dimension, as a ``PartitionSpec`` is: a mesh
axis name, a tuple of them (several mesh dimensions sharding the same tensor
dimension, in mesh order), or ``None``. :func:`placements` turns it into
one ``DTensor`` placement per mesh dimension.
"""
from __future__ import annotations

import contextlib
from typing import Optional

from torch.distributed.tensor import DTensor, Replicate, Shard

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


def constrain(x, *spec):
    """Pin x's placements (DP placeholder -> dp axes). Returns ``x`` itself
    without a context; axes referring to dims that don't divide are
    dropped. A ``DTensor`` is redistributed to the spec's placements; a
    plain tensor under a context stays the plain tensor it is (nothing
    places it: it is the same on every rank)."""
    if _CTX is None or not isinstance(x, DTensor):
        return x
    mesh = _CTX["mesh"]
    want = placements(resolve(x.shape, spec, mesh, _CTX["dp"]), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
