"""Production mesh definitions on ``torch.distributed``.

Single pod: (16, 16) = 256 ranks, axes ("data", "model").
Multi pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model") — the
"pod" axis joins "data" for batch sharding, so the gradient reduction
crosses the links between pods, proving the pod axis actually shards.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
default process group: torchrun's NCCL group of 256 or 512 ranks, or the
dry run's ``"fake"`` group of that size (``launch/dryrun.py``). Defined as
functions, not module constants, so importing this module touches no
process group and no CUDA state.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.distributed import _ensure_group
from ..core.verify_engine import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The production mesh over the default group, which must hold 256
    (512 with ``multi_pod``) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(n: int | None = None, name: str = "data", device="cuda") -> DeviceMesh:
    """A 1-D mesh over every rank of the group (tests, the one-card smoke).
    Without a group, a one-rank group is made first, as
    ``core.distributed`` makes one: NCCL on the card, gloo on the CPU."""
    dev = resolve_device(device)
    _ensure_group(dev)
    n = n or dist.get_world_size()
    return init_device_mesh(dev.type, (n,), mesh_dim_names=(name,))


def dp_axes(multi_pod: bool) -> tuple:
    return ("pod", "data") if multi_pod else ("data",)


# NVIDIA H100 80GB HBM3, 700 W (the SXM part's data sheet) for the roofline
# terms. The collective term assumes nodes of 8 cards: a 16-wide mesh axis
# spans two nodes, so its ring crosses the node boundary, where each card
# has one 400 Gb/s NDR InfiniBand link. NVLink's 900 GB/s holds only inside
# a node, and the slowest link a collective crosses paces all of it.
PEAK_FLOPS_BF16 = 989e12  # dense bf16 FLOP/s per card
HBM_BW = 3.35e12  # bytes/s per card
ICI_BW = 50e9  # bytes/s per card across nodes (400 Gb/s NDR)

