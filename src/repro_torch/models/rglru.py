"""RG-LRU recurrent block (RecurrentGemma / Griffin).

    r_t = sigmoid(W_a a_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x a_t + b_x)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t  (c = 8)
    h_t = exp(log a_t) * h_{t-1} + sqrt(1 - exp(2 log a_t)) * (i_t * a_t)

The elementwise linear recurrence is evaluated with a log-depth
(Hillis-Steele) inclusive scan over time: ceil(log2 S) rounds of the
associative combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``, the
counterpart of the reference's ``lax.associative_scan`` (the same operator;
the tree of partial products differs, so f32 results agree to rounding).
The block is: in-proj (x + gate branches), causal depthwise conv1d
(width 4), RG-LRU, gated out-proj.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init, randn, zeros

RGLRU_C = 8.0
CONV_W = 4


def rglru_init(gen, device, d_model: int, d_rnn: int):
    return {
        "w_in": dense_init(gen, device, (d_model, d_rnn)),
        "w_gate": dense_init(gen, device, (d_model, d_rnn)),
        "conv_w": randn(gen, device, (CONV_W, d_rnn)) * 0.1,
        "conv_b": zeros(device, (d_rnn,)),
        "w_a": dense_init(gen, device, (d_rnn, d_rnn)),
        "b_a": zeros(device, (d_rnn,)),
        "w_x": dense_init(gen, device, (d_rnn, d_rnn)),
        "b_x": zeros(device, (d_rnn,)),
        "lam": torch.full((d_rnn,), 0.7, dtype=torch.float32, device=device),
        "w_out": dense_init(gen, device, (d_rnn, d_model)),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def _causal_conv(x, w, b, tail):
    """Depthwise causal conv1d. x: (B, S, R); tail: (B, CONV_W-1, R) history."""
    xc = torch.cat([tail.to(x.dtype), x], dim=1)  # (B, S+3, R)
    out = sum(
        xc[:, i:i + x.shape[1], :] * w[i][None, None, :].to(x.dtype)
        for i in range(CONV_W)
    )
    return out + b[None, None, :].to(x.dtype), xc[:, -(CONV_W - 1):, :]


def _rglru_gates(p, a):
    af = a.float()
    r = torch.sigmoid(af @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(af @ p["w_x"].float() + p["b_x"])
    log_a = -RGLRU_C * F.softplus(p["lam"])[None, None, :] * r
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * af)
    return log_a, gated


def linear_scan(coef, x):
    """Inclusive scan of h_t = coef_t * h_{t-1} + x_t along axis 1 (h_{-1}
    = 0), in log-depth rounds."""
    a, b = coef, x
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_block(p, x, h0, conv_tail):
    """x: (B, S, D); h0: (B, R) f32; conv_tail: (B, 3, R).

    Returns (out (B, S, D), h_last, new_conv_tail)."""
    a = x @ p["w_in"]  # (B, S, R)
    gate = _gelu(x @ p["w_gate"])
    a, new_tail = _causal_conv(a, p["conv_w"], p["conv_b"], conv_tail)
    log_a, gated = _rglru_gates(p, a)

    # fold h0 into the first element, then scan the recurrence
    coef = torch.exp(log_a)  # (B, S, R) f32
    first = gated[:, 0, :] + coef[:, 0, :] * h0.float()
    gated = torch.cat([first[:, None], gated[:, 1:]], dim=1)
    h = linear_scan(coef, gated)
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    return out, h[:, -1, :], new_tail


def rglru_decode(p, x, h0, conv_tail):
    """Single-token step. x: (B, 1, D)."""
    a = x @ p["w_in"]
    gate = _gelu(x @ p["w_gate"])
    a, new_tail = _causal_conv(a, p["conv_w"], p["conv_b"], conv_tail)
    log_a, gated = _rglru_gates(p, a)
    h = torch.exp(log_a[:, 0]) * h0.float() + gated[:, 0]
    out = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    return out, h, new_tail
