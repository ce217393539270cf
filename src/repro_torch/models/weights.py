"""Carry weights across the two packages' layouts: the reference's
``init_params`` tree, with numpy leaves, becomes the port's
``Transformer``, and back.

The reference stacks each pattern position's parameters over the groups
(``tree["groups"][j][name]`` has a leading axis of ``n_groups``); the port
holds one block a layer (``groups.g.j.name``), so the groups are unstacked
on the way in and stacked on the way out. bf16 leaves arrive as numpy
arrays of the ``bfloat16`` extension dtype, which ``torch.from_numpy``
refuses: they cross as their 16-bit patterns (recognised by the dtype's
name, with no import of the package that defines it), and leave as
``uint16`` patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from .transformer import ModelConfig, Transformer


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One leaf: numpy (bf16 included) -> a tensor of the same dtype and bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> Transformer:
    """The port's model holding the reference's parameters ``tree`` (numpy
    leaves; ``groups`` stacked as the reference stacks them) on ``device``."""
    device = torch.device(device)
    stacked = tree["groups"]
    groups = [[_map(stacked[j], lambda a, g=g: a[g]) for j in range(len(cfg.pattern))]
              for g in range(cfg.n_groups)]
    out = {k: v for k, v in tree.items() if k != "groups"}
    out = _map(out, lambda a: tensor_from_numpy(a, device))
    out["groups"] = _map(groups, lambda a: tensor_from_numpy(a, device))
    return Transformer(cfg, out)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One leaf: a tensor -> a host numpy array of its bits (bf16 as uint16
    patterns)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _lists(tree):
    """Nested dicts whose keys are all ints -> lists in key order."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[k] for k in sorted(out)]
    return out


def reference_tree(named: dict) -> dict:
    """Tensors keyed by the port's parameter names (``named_parameters``:
    ``groups.g.j.attn.wq``) -> the reference's tree under the same names,
    each pattern position's ``groups`` leaves stacked over the groups."""
    tree: dict = {}
    stacked: dict = {}
    for name, t in named.items():
        keys = [int(k) if k.isdigit() else k for k in name.split(".")]
        if keys[0] == "groups":  # groups.g.j.rest -> groups.j.rest, stacked over g
            stacked.setdefault(tuple(keys[2:]), []).append((keys[1], t))
            continue
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    for keys, items in stacked.items():
        node = tree.setdefault("groups", {})
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.stack([t for _, t in sorted(items, key=lambda e: e[0])])
    return _lists(tree)


def port_named(tree: dict) -> dict:
    """The inverse of ``reference_tree``: the reference's tree -> leaves
    keyed by the port's parameter names (``groups`` leaves unstacked into
    views of the stacked ones)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [i])
        elif node is not None:
            if path[0] == "groups":
                for g in range(node.shape[0]):
                    out[".".join(map(str, ["groups", g, path[1], *path[2:]]))] = node[g]
            else:
                out[".".join(map(str, path))] = node

    walk(tree, [])
    return out


def params_to_numpy(model) -> dict:
    """The inverse of ``params_from_numpy``: the model's parameters as the
    reference's tree (groups stacked) of numpy leaves, bf16 as uint16
    patterns."""
    named = {k: v.detach().cpu() for k, v in model.named_parameters()}
    return _map(reference_tree(named), tensor_to_numpy)
