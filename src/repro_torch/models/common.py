"""Shared model building blocks: norms, RoPE, init, dtype policy.

Init draws from an explicit ``torch.Generator`` on an explicit device (the
generator takes the place of the reference's key splitter). On the
``meta`` device nothing is drawn or allocated: shapes only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PARAM_DTYPE = torch.bfloat16
COMPUTE_DTYPE = torch.bfloat16


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # variance in f32 for stability; the normalize/scale multiplies stay in
    # x.dtype, as in the reference
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e6) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd) with hd even; positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    if positions.ndim == 1:
        ang = positions[:, None].float() * freqs[None, :]  # (S, half)
        ang = ang[None, :, None, :]  # (1, S, 1, half)
    else:
        ang = positions[..., None].float() * freqs  # (B, S, half)
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def randn(gen, device, shape) -> torch.Tensor:
    """Standard normal f32 draws from ``gen`` (shapes only on ``meta``)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


def rand(gen, device, shape) -> torch.Tensor:
    """Uniform [0, 1) f32 draws from ``gen`` (shapes only on ``meta``)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.rand(shape, generator=gen, dtype=torch.float32, device=device)


def dense_init(gen, device, shape, in_axis: int = 0, dtype=PARAM_DTYPE) -> torch.Tensor:
    std = shape[in_axis] ** -0.5
    return (randn(gen, device, shape) * std).to(dtype)


def embed_init(gen, device, shape, dtype=PARAM_DTYPE) -> torch.Tensor:
    return (randn(gen, device, shape) * 0.02).to(dtype)


def zeros(device, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def swiglu(x: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    """SwiGLU MLP: (x@w1).silu * (x@w3) @ w2."""
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2
