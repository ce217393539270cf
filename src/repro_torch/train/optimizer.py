"""AdamW with warmup-cosine schedule, global-norm clipping, and optional
gradient compression hooks: the reference's own update, written out in
plain tensor ops (not PyTorch's built-in AdamW, whose update order, bias
correction and fused kernels differ). Moment states are f32; the update is
computed in f32 and cast back to each parameter's dtype.

Parameters, gradients and the moment states are dicts keyed by parameter
name (a module stands for its ``named_parameters``). ``update`` writes the
new parameters and states in place. The schedule, the clipping scale and
the bias corrections are f32 tensors on the parameters' device, computed
as the reference computes them in f32, so a step never waits on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .compression import make_compressor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    compression: Optional[str] = None  # None | "int8" | "topk"


def _named(params) -> dict:
    return dict(params.named_parameters()) if hasattr(params, "named_parameters") else params


def _f32(value, device) -> torch.Tensor:
    """A step number (int or tensor) as an f32 scalar tensor on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.full((), value, dtype=torch.float32, device=device)


class AdamW:
    def __init__(self, cfg: AdamWConfig):
        self.cfg = cfg
        self.compressor = make_compressor(cfg.compression)

    def init(self, params) -> dict:
        def zeros():
            return {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in _named(params).items()}

        state = {"m": zeros(), "v": zeros()}
        if self.compressor is not None:
            state["err"] = zeros()
        return state

    def schedule(self, step, device="cpu") -> torch.Tensor:
        c = self.cfg
        step = _f32(step, device)
        warm = torch.clamp(step / max(c.warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return c.learning_rate * warm * (c.min_lr_frac + (1 - c.min_lr_frac) * cos)

    @torch.no_grad()
    def update(self, params, grads: dict, state: dict, step):
        """Returns (params, state, grad_norm): the parameters and states
        updated in place; the norm is the one before clipping."""
        c = self.cfg
        named = _named(params)
        device = next(iter(named.values())).device
        if self.compressor is not None:
            grads, state["err"] = self.compressor(grads, state["err"])
        # global-norm clip
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
        scale = torch.clamp(c.grad_clip / (gnorm + 1e-9), max=1.0)
        lr = self.schedule(step, device)
        t = _f32(step + 1, device)
        bc1 = 1.0 - torch.pow(c.beta1, t)
        bc2 = 1.0 - torch.pow(c.beta2, t)
        m_all, v_all = state["m"], state["v"]
        for name, p in named.items():
            g = grads[name].float() * scale
            m = c.beta1 * m_all[name] + (1 - c.beta1) * g
            v = c.beta2 * v_all[name] + (1 - c.beta2) * g * g
            mh = m / bc1
            vh = v / bc2
            step_ = lr * (mh / (torch.sqrt(vh) + c.eps) + c.weight_decay * p.float())
            p.copy_((p.float() - step_).to(p.dtype))
            m_all[name].copy_(m)
            v_all[name].copy_(v)
        return params, state, gnorm
