"""Gradient compression with error feedback — bandwidth relief for the
cross-node gradient all-reduce at scale.

* int8: per-tensor symmetric quantization. The all-reduce then moves 1/4 of
  the bytes; the quantization error is fed back into the next step's
  gradient (error feedback a la 1-bit SGD), which keeps convergence.
* topk: keep the largest `frac` fraction of entries per tensor (magnitude),
  accumulate the rest in the error buffer.

Both are pure functions grads -> (decompressed grads, new error state) over
dicts of tensors keyed alike, so they compose with any optimizer. The
compress -> decompress round trip models the information loss of the
compressed representation that would cross the interconnect.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def _int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    amax = g.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def _topk_roundtrip(g: torch.Tensor, frac: float = 0.1) -> torch.Tensor:
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(g.abs() >= thresh, g, 0.0)


def make_compressor(kind: Optional[str]) -> Optional[Callable]:
    if kind is None:
        return None

    if kind == "int8":
        rt = _int8_roundtrip
    elif kind == "topk":
        rt = _topk_roundtrip
    else:
        raise ValueError(f"unknown compression {kind}")

    def compress(grads: dict, err: dict):
        out, new_err = {}, {}
        for name, g in grads.items():
            gf = g.float() + err[name]
            out[name] = rt(gf)
            new_err[name] = gf - out[name]
        return out, new_err

    return compress
