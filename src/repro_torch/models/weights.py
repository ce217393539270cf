"""Carry the reference's weights across: its ``init_params`` tree, with
numpy leaves, becomes the port's ``Transformer``.

The reference stacks each pattern position's parameters over the groups
(``tree["groups"][j][name]`` has a leading axis of ``n_groups``); the port
holds one block a layer, so the groups are unstacked. bf16 leaves arrive as
numpy arrays of the ``bfloat16`` extension dtype, which ``torch.from_numpy``
refuses: they cross as their 16-bit patterns (recognised by the dtype's
name, with no import of the package that defines it).
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
