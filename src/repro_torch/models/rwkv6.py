"""RWKV6 "Finch" — attention-free time mixing with data-dependent decay.

The *chunked* formulation of the per-token recurrence

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

evaluated in chunks of length C: within a chunk the pairwise decay
factorizes per channel, exp(cum_{i-1} - cum_j) = exp(cum_{i-1}) *
exp(-cum_j), so intra-chunk work becomes two (C x C x hd) matmuls, and the
inter-chunk state is carried across chunks in a Python loop of (hd x hd)
updates. Log-decay is clamped to >= LOG_DECAY_MIN per step so exp(-cum_j)
stays inside float32 at C=16 (|cum| <= 56 < 88), as in the reference.

Static token-shift mixing coefficients (no ddlerp LoRA on the mix
weights); decay LoRA retained (the data-dependent part that defines Finch).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init, rand, randn, zeros

CHUNK = 16
LOG_DECAY_MIN = -3.5
DECAY_LORA = 64


def rwkv6_init(gen, device, d_model: int, head_dim: int, d_ff: int):
    h = d_model // head_dim
    return {
        "ln_tm": zeros(device, (d_model,)),
        "mu": rand(gen, device, (5, d_model)) * 0.1,
        "wr": dense_init(gen, device, (d_model, d_model)),
        "wk": dense_init(gen, device, (d_model, d_model)),
        "wv": dense_init(gen, device, (d_model, d_model)),
        "wg": dense_init(gen, device, (d_model, d_model)),
        "w0": zeros(device, (d_model,)) - 0.6,  # base log-log decay
        "w_lora_a": dense_init(gen, device, (d_model, DECAY_LORA), dtype=torch.float32),
        "w_lora_b": randn(gen, device, (DECAY_LORA, d_model)) * 0.01,
        "u": zeros(device, (h, head_dim)),
        "gn_scale": zeros(device, (d_model,)),
        "wo": dense_init(gen, device, (d_model, d_model)),
        "ln_cm": zeros(device, (d_model,)),
        "mu_cm": rand(gen, device, (2, d_model)) * 0.1,
        "cm_k": dense_init(gen, device, (d_model, d_ff)),
        "cm_v": dense_init(gen, device, (d_ff, d_model)),
        "cm_r": dense_init(gen, device, (d_model, d_model)),
    }


def _token_shift(x, x_prev):
    """x: (B, S, D); x_prev: (B, D) last token of the previous segment."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _log_decay(p, xw):
    ld = -torch.exp(
        p["w0"].float() + torch.tanh(xw.float() @ p["w_lora_a"]) @ p["w_lora_b"]
    )
    return torch.clamp_min(ld, LOG_DECAY_MIN)  # (B, S, D) in (LOG_DECAY_MIN, 0)


def _group_norm(x, scale, h):
    """Per-head RMS norm of the (B, S, H, hd) wkv output, flattened scale."""
    b, s, hh, hd = x.shape
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + 1e-6)
    return (out.reshape(b, s, hh * hd) * (1.0 + scale)).to(x.dtype)


def _out_proj(p, out, dtype):
    # the wkv path is f32 and ``wo`` is a bf16 parameter: the reference's
    # matmul promotes to f32 before casting back
    return (out @ p["wo"].to(out.dtype)).to(dtype)


def rwkv6_time_mix(p, x, head_dim: int, state, x_prev):
    """Chunked WKV6. x: (B, S, D); state: (B, H, hd, hd) f32; x_prev: (B, D).

    Returns (out (B, S, D), new_state, new_x_prev)."""
    b, s, d = x.shape
    h = d // head_dim
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + mu[i][None, None, :] * (xs - x) for i in range(5))
    r = (xr @ p["wr"]).reshape(b, s, h, head_dim)
    k = (xk @ p["wk"]).reshape(b, s, h, head_dim)
    v = (xv @ p["wv"]).reshape(b, s, h, head_dim)
    g = xg @ p["wg"]
    ld = _log_decay(p, xw).reshape(b, s, h, head_dim)  # log decay per channel

    # pad S to a chunk multiple
    pad = (-s) % CHUNK
    if pad:
        def zpad(a):
            return torch.cat([a, a.new_zeros((b, pad) + a.shape[2:])], dim=1)
        r, k, v, ld = zpad(r), zpad(k), zpad(v), zpad(ld)
    sp = s + pad
    nb = sp // CHUNK
    rc = r.reshape(b, nb, CHUNK, h, head_dim).float()
    kc = k.reshape(b, nb, CHUNK, h, head_dim).float()
    vc = v.reshape(b, nb, CHUNK, h, head_dim).float()
    ldc = ld.reshape(b, nb, CHUNK, h, head_dim)

    cum = torch.cumsum(ldc, dim=2)  # inclusive per-chunk cumulative log decay
    cum_prev = cum - ldc  # exclusive
    r_t = rc * torch.exp(cum_prev)  # r~_i = r_i * exp(cum_{i-1})
    k_t = kc * torch.exp(-cum)  # k~_j = k_j * exp(-cum_j)
    # intra-chunk scores: A_ij = r~_i . k~_j for j < i, diag via bonus u
    scores = torch.einsum("bnihd,bnjhd->bnhij", r_t, k_t)
    tri = torch.ones((CHUNK, CHUNK), dtype=torch.bool, device=x.device).tril(-1)
    scores = torch.where(tri[None, None, None], scores, 0.0)
    diag = torch.einsum("bnihd,bnihd->bnhi", rc * p["u"][None, None], kc)
    eye = torch.eye(CHUNK, dtype=torch.float32, device=x.device)
    scores = scores + eye[None, None, None] * diag[..., :, None]
    intra = torch.einsum("bnhij,bnjhd->bnihd", scores, vc)

    # inter-chunk: carry the (hd x hd) state across chunks
    decay_all = torch.exp(cum[:, :, -1])  # (b, nb, h, hd) total chunk decay
    k_hat = kc * torch.exp(cum[:, :, -1:, :, :] - cum)  # decay from j to chunk end
    s0 = state.float()
    inter = []
    for n in range(nb):
        inter.append(torch.einsum("bihd,bhde->bihe", r_t[:, n], s0))  # r~ @ S0
        s0 = decay_all[:, n][..., None] * s0 + torch.einsum(
            "bjhd,bjhe->bhde", k_hat[:, n], vc[:, n])
    inter = torch.stack(inter, dim=1)  # (b, nb, C, h, hd)

    wkv = (intra + inter).reshape(b, sp, h, head_dim)[:, :s]
    out = _group_norm(wkv, p["gn_scale"], h) * F.silu(g)
    return _out_proj(p, out, x.dtype), s0, x[:, -1, :]


def rwkv6_time_mix_decode(p, x, head_dim: int, state, x_prev):
    """Single-token WKV6 step. x: (B, 1, D)."""
    b, _, d = x.shape
    h = d // head_dim
    mu = p["mu"].to(x.dtype)
    xs = x_prev[:, None, :]
    xr, xk, xv, xw, xg = (x + mu[i][None, None, :] * (xs - x) for i in range(5))
    r = (xr @ p["wr"]).reshape(b, h, head_dim).float()
    k = (xk @ p["wk"]).reshape(b, h, head_dim).float()
    v = (xv @ p["wv"]).reshape(b, h, head_dim).float()
    g = xg @ p["wg"]
    w = torch.exp(_log_decay(p, xw)[:, 0].reshape(b, h, head_dim))
    sf = state.float()
    kv = torch.einsum("bhd,bhe->bhde", k, v)
    o = torch.einsum("bhd,bhde->bhe", r, sf + p["u"][None, :, :, None] * kv)
    new_state = w[..., None] * sf + kv
    o = o[:, None].reshape(b, 1, h, head_dim)
    out = _group_norm(o, p["gn_scale"], h) * F.silu(g)
    return _out_proj(p, out, x.dtype), new_state, x[:, -1, :]


def rwkv6_channel_mix(p, x, x_prev):
    """RWKV channel mix (the FFN). x: (B, S, D); x_prev: (B, D)."""
    xs = _token_shift(x, x_prev)
    mu = p["mu_cm"].to(x.dtype)
    xk = x + mu[0][None, None] * (xs - x)
    xr = x + mu[1][None, None] * (xs - x)
    k = torch.square(torch.relu(xk @ p["cm_k"]))
    return torch.sigmoid(xr @ p["cm_r"]) * (k @ p["cm_v"]), x[:, -1, :]
