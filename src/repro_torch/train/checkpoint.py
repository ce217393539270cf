"""Atomic checkpoints in the reference's layout, byte for byte.

Layout: <dir>/step_<N>/ with one .npy per tree leaf plus manifest.json
(leaf names, shapes, dtypes, step, the number of devices at save time).
Leaves are named by their tree path joined with "_" and ordered as the
reference orders them (dict keys sorted, lists in order), so a
checkpoint written by either package restores in the other. bf16 leaves
are stored as their uint16 bit patterns. Writes go to a temp dir that is
atomically renamed, so a crash mid-save never corrupts the latest
checkpoint; ``latest_step`` only sees complete directories. An async mode
hands the host copy to a writer thread so the training loop does not stall.

Sharded trees: ``save`` takes ``DTensor`` leaves. Every rank gathers each
one whole (``full_tensor``, a collective) on the caller's thread, never on
the writer thread, and only rank 0 writes, so the files are the same as
an unsharded save's. ``restore(..., shardings=)`` places each leaf with
``distribute_tensor`` on the mesh and placements given for it: a
checkpoint saved under one mesh shape restores onto another (elastic
restore).

A tree is made of dicts, lists and tensors (or numpy arrays). A module
stands for its parameters, and a dict keyed by the port's parameter names
(``groups.g.j.attn.wq``, as the optimizer's states are) for the
reference's tree of them, groups stacked: that is the layout on disk.
``restore`` gives such nodes back as dicts keyed by parameter name.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.weights import port_named, reference_tree, tensor_to_numpy


def _is_named(node) -> bool:
    """A module, or a dict keyed by the port's parameter names."""
    return isinstance(node, nn.Module) or (
        isinstance(node, dict) and any("." in str(k) for k in node))


def _canonical(tree, leaf):
    """``tree`` in the reference's layout, ``leaf`` applied to every tensor
    before groups are stacked."""
    if _is_named(tree):
        named = dict(tree.named_parameters()) if isinstance(tree, nn.Module) else tree
        return reference_tree({k: leaf(v) for k, v in named.items()})
    if isinstance(tree, dict):
        return {k: _canonical(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_canonical(v, leaf) for v in tree]
    return None if tree is None else leaf(tree)


def _flatten_with_paths(tree, prefix=()) -> list:
    """(name, leaf) pairs in the reference's order: dict keys sorted, lists
    in order, None holding no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten_with_paths(v, prefix + (i,))]
    if tree is None:
        return []
    return [("_".join(str(p) for p in prefix), tree)]


def _rebuild(like, canonical, loaded: dict, prefix=()):
    """``like``'s structure over the loaded leaves (by name); a module or a
    parameter-name dict comes back as a dict keyed by parameter name."""
    if _is_named(like):
        return port_named(_rebuild(canonical, canonical, loaded, prefix))
    if isinstance(like, dict):
        return {k: _rebuild(v, canonical[k], loaded, prefix + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_rebuild(v, canonical[i], loaded, prefix + (i,)) for i, v in enumerate(like)]
    return None if like is None else loaded["_".join(str(p) for p in prefix)]


def _first_leaf(tree):
    if isinstance(tree, nn.Module):
        return next(tree.parameters())
    if isinstance(tree, (dict, list, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            leaf = _first_leaf(v)
            if leaf is not None:
                return leaf
        return None
    return tree


def _to_storable(leaf) -> tuple[np.ndarray, str]:
    """A host array of the leaf's bits and the name of its dtype (bf16 as
    uint16 patterns under the name "bfloat16")."""
    if isinstance(leaf, torch.Tensor):
        name = "bfloat16" if leaf.dtype == torch.bfloat16 else None
        arr = tensor_to_numpy(leaf)
    else:
        arr = np.asarray(leaf)
        name = "bfloat16" if arr.dtype.name == "bfloat16" else None
        if name:
            arr = arr.view(np.uint16)
    return arr, name or arr.dtype.name


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _host(t):
    """A leaf's host copy (a ``DTensor`` gathered whole first: every rank
    must call this for it)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu() if isinstance(t, torch.Tensor) else t


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[dict] = None,
         async_write: bool = False):
    """Save a tree checkpoint. Blocks unless async_write (then returns the
    writer thread; the host copy is taken before it starts). With
    ``DTensor`` leaves every rank calls this, and only rank 0 writes
    (other ranks return None)."""
    leaves = _flatten_with_paths(_canonical(tree, _host))
    host = []
    for name, leaf in leaves:
        arr, dtype_name = _to_storable(leaf)
        host.append((name, arr, dtype_name))
    manifest = {
        "step": int(step),
        "leaves": [
            {"name": n, "shape": list(a.shape), "dtype": d}
            for n, a, d in host
        ],
        "n_devices": _world_size(),
        "extra": extra or {},
    }

    def write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        for name, arr, _ in host:
            np.save(os.path.join(tmp, f"{name}.npy"), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if _rank() != 0:
        return None
    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                steps.append(int(d[5:]))
    return max(steps) if steps else None


def _is_sharding(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], DeviceMesh)


def _distribute(tree, shardings):
    """Each leaf of ``tree`` placed by its ``(mesh, placements)`` in the
    matching tree ``shardings`` (dicts by key, lists in order)."""
    if _is_sharding(shardings):
        return distribute_tensor(tree, shardings[0], list(shardings[1]))
    if isinstance(tree, dict):
        return {k: _distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_distribute(v, s) for v, s in zip(tree, shardings)]
    return tree


def restore(ckpt_dir: str, step: int, like: Any, *, device=None,
            shardings: Any = None) -> tuple[Any, dict]:
    """Restore into the structure of ``like``, whose leaves are tensors
    (``meta`` tensors for shapes and dtypes only). Each leaf is cast to its
    ``like`` leaf's dtype and placed on ``device`` (default: the device of
    ``like``'s first leaf, which must then not be ``meta``). With
    ``shardings`` (a tree of ``(mesh, placements)`` matching the returned
    tree: a module's or parameter-name dict's node keyed by parameter name)
    each leaf comes back a ``DTensor`` placed on that mesh instead; use this
    to restore onto another mesh than the one that saved.

    Returns (tree, manifest_extra)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if shardings is not None:
        device = "cpu"  # distribute_tensor moves each leaf to its mesh
    elif device is None:
        device = _first_leaf(like).device
    device = torch.device(device)
    if device.type == "meta":
        raise ValueError("restoring onto meta: pass the device to place the leaves on")
    canonical = _canonical(like, lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"))
    dtype_by_name = {l["name"]: l["dtype"] for l in manifest["leaves"]}
    loaded = {}
    for name, ref_leaf in _flatten_with_paths(canonical):
        arr = _from_storable(np.load(os.path.join(d, f"{name}.npy")),
                             dtype_by_name[name])
        if list(arr.shape) != list(ref_leaf.shape):
            raise ValueError(
                f"checkpoint leaf {name} shape {tuple(arr.shape)} != expected "
                f"{tuple(ref_leaf.shape)}"
            )
        loaded[name] = arr.to(dtype=ref_leaf.dtype).to(device)
    tree = _rebuild(like, canonical, loaded)
    if shardings is not None:
        tree = _distribute(tree, shardings)
    return tree, manifest.get("extra", {})


def restore_latest(ckpt_dir: str, like: Any, *, device=None, shardings: Any = None):
    """Returns (step, tree, extra) or None when no checkpoint exists."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    tree, extra = restore(ckpt_dir, step, like, device=device, shardings=shardings)
    return step, tree, extra
