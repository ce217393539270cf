"""Attention variants: GQA (full/causal/bidirectional), sliding-window
(block-banded, sub-quadratic), MLA (latent compressed, with the absorbed
matmul form for decode), and single-token decode paths over KV caches.

Shapes follow (B, S, H, hd); KV caches are (B, S_max, kv, hd) for global
attention and (B, W, kv, hd) ring buffers for sliding windows. Plain torch
matmuls and einsums, computed as the reference computes them (chunking,
dtypes and masks included): the reference runs these outside any Pallas
kernel. ``pos`` is a Python int, the number of valid tokens.
"""
from __future__ import annotations

import dataclasses

import torch

from . import shardctx
from .common import COMPUTE_DTYPE, dense_init, rms_norm, rope, zeros

NEG_INF = -2.0e38


def _gqa_scores(q, k):
    """q: (B, Sq, H, hd), k: (B, Sk, kv, hd) -> (B, kv, H/kv, Sq, Sk)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    q = q.reshape(b, sq, kvh, h // kvh, hd)
    return torch.einsum("bqkgh,bskh->bkgqs", q, k) / (hd ** 0.5)


def _gqa_out(p, v):
    """p: (B, kv, H/kv, Sq, Sk), v: (B, Sk, kv, hd) -> (B, Sq, H*hd)."""
    b, kvh, g, sq, sk = p.shape
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return o.reshape(b, sq, kvh * g * v.shape[-1])


def _softmax(s):
    return torch.softmax(s.float(), dim=-1).to(COMPUTE_DTYPE)


def naive_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Reference full attention: materializes the (Sq, Sk) score matrix."""
    sq, sk = q.shape[1], k.shape[1]
    s = _gqa_scores(q, k)
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, NEG_INF)
    return _gqa_out(_softmax(s), v)


def flash_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                    k_chunk: int = 1024) -> torch.Tensor:
    """Chunked attention with running softmax (flash-style).

    Queries go through a Python loop of q-chunks; for a causal mask, chunk
    i only reads keys [0, (i+1)*qc), so the causal FLOPs are exact. Keys
    stream through an inner loop with the (m, l, acc) running-softmax
    carry, so peak memory is O(qc * kc) instead of O(S^2).
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    kvh = k.shape[2]
    hd_v = v.shape[-1]  # may differ from hd (MLA: qk 96, v 64)
    g = h // kvh
    scale = hd ** -0.5
    qc = min(q_chunk, sq)
    if sq % qc or sq != sk:
        raise ValueError(f"flash_attention needs sq == sk, a multiple of the "
                         f"q chunk: {(sq, sk, qc)}")
    nq = sq // qc
    dev = q.device

    out_chunks = []
    for i in range(nq):
        qi = q[:, i * qc:(i + 1) * qc].reshape(b, qc, kvh, g, hd)
        klen = (i + 1) * qc if causal else sk
        kc = min(k_chunk, klen)
        nk = klen // kc
        q_pos = i * qc + torch.arange(qc, device=dev)
        m = torch.full((b, kvh, g, qc), -torch.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kvh, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g, qc, hd_v), dtype=torch.float32, device=dev)
        for j in range(nk):
            kj = k[:, j * kc:(j + 1) * kc]
            vj = v[:, j * kc:(j + 1) * kc]
            s = torch.einsum("bqkgh,bskh->bkgqs", qi, kj).float() * scale
            if causal:
                k_pos = j * kc + torch.arange(kc, device=dev)
                mask = k_pos[None, :] <= q_pos[:, None]  # (qc, kc)
                s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(COMPUTE_DTYPE), vj).float()
            m = m_new
        o = (acc / l.clamp_min(1e-30)[..., None]).to(COMPUTE_DTYPE)
        # (b, kvh, g, qc, hd_v) -> (b, qc, H*hd_v)
        out_chunks.append(o.movedim(3, 1).reshape(b, qc, h * hd_v))
    return torch.cat(out_chunks, dim=1)


FLASH_MIN_SEQ = 2048


def gqa_attention(q, k, v, *, causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """Full attention; bidirectional when causal=False. impl: auto routes
    long sequences through the chunked flash path (exact same math)."""
    sq, sk = q.shape[1], k.shape[1]
    use_flash = (
        impl == "flash"
        or (impl == "auto" and sq == sk and sq >= FLASH_MIN_SEQ and sq % 1024 == 0)
    )
    if use_flash:
        return flash_attention(q, k, v, causal=causal)
    return naive_attention(q, k, v, causal=causal)


def sliding_attention(q, k, v, window: int) -> torch.Tensor:
    """Causal sliding-window attention, block-banded formulation.

    Token t attends to keys in (t - window, t]. Sequences are chunked into
    window-sized blocks; each query block attends to its own block (causal)
    and the previous block (banded): 2*W*S score work instead of S^2.
    """
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    w = window
    pad = (-s) % w
    if pad:
        zq = q.new_zeros((b, pad, h, hd))
        zk = k.new_zeros((b, pad, kvh, hd))
        q = torch.cat([q, zq], 1)
        k = torch.cat([k, zk], 1)
        v = torch.cat([v, zk.to(v.dtype)], 1)
    sp = s + pad
    nb = sp // w
    qb = q.reshape(b, nb, w, h, hd)
    kb = k.reshape(b, nb, w, kvh, hd)
    vb = v.reshape(b, nb, w, kvh, hd)
    # keys for block i: [block i-1, block i]
    k_prev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    kcat = torch.cat([k_prev, kb], dim=2)  # (b, nb, 2w, kv, hd)
    v_prev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    vcat = torch.cat([v_prev, vb], dim=2)
    qg = qb.reshape(b, nb, w, kvh, h // kvh, hd)
    scores = torch.einsum("bnqkgh,bnskh->bnkgqs", qg, kcat) / (hd ** 0.5)
    # query local pos i (global w*n + i) sees key local pos j (global
    # w*(n-1) + j) when 0 <= w + i - j < window
    dev = q.device
    qi = torch.arange(w, device=dev)[:, None]
    kj = torch.arange(2 * w, device=dev)[None, :]
    rel = qi + w - kj  # how far the key is behind the query (0 = self)
    mask = (rel >= 0) & (rel < w)
    # the first block's "previous block" is padding: mask out j < w at n == 0
    nidx = torch.arange(nb, device=dev)[:, None, None]
    valid_prev = (nidx > 0) | (kj[None] >= w)
    full_mask = mask[None] & valid_prev  # (nb, w, 2w)
    scores = scores.masked_fill(~full_mask[None, :, None, None], NEG_INF)
    p = _softmax(scores)
    o = torch.einsum("bnkgqs,bnskh->bnqkgh", p, vcat)
    o = o.reshape(b, sp, h * hd)
    return o[:, :s]


def _decode_split(q, k_cache, v_cache, valid) -> torch.Tensor:
    """One-token decode over a cache whose slots are split over ranks
    (context-parallel, as the reference's GSPMD lowering runs it): each
    rank scores its own slots; only the scores' max, their exp-sum and the
    partial context cross the mesh, never the cache. The result is the
    softmax-weighted context over all slots, in another summation order."""
    dp = shardctx.DP
    q = shardctx.constrain(q, dp, None, None, None)
    s = _gqa_scores(q, k_cache).float()  # (B, kv, g, 1, S), S split
    s = s.masked_fill(~valid, NEG_INF)
    m = shardctx.constrain(s.amax(dim=-1, keepdim=True), dp, None, None, None, None)
    e = torch.exp(s - m)
    l = shardctx.constrain(e.sum(dim=-1, keepdim=True), dp, None, None, None, None)
    o = torch.einsum("bkgqs,bskh->bkgqh", e.to(COMPUTE_DTYPE), v_cache).float()
    o = shardctx.constrain(o, dp, None, None, None, None)
    o = (o / l).to(COMPUTE_DTYPE)  # (B, kv, g, 1, hd)
    b, kvh, g, sq, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, kvh * g * hd)


def decode_attention(q, k_cache, v_cache, pos: int) -> torch.Tensor:
    """One-token decode over a (B, S_max, kv, hd) cache; pos = #valid tokens
    *after* writing the current token (attends to [0, pos)). Under a
    sharding context, a cache split over ranks along its slots is read
    context-parallel (:func:`_decode_split`)."""
    if shardctx.split(k_cache, 1):
        valid = torch.arange(k_cache.shape[1], device=q.device) < pos
        return _decode_split(q, k_cache, v_cache, valid)
    s = _gqa_scores(q, k_cache)  # (B, kv, g, 1, S_max)
    valid = torch.arange(k_cache.shape[1], device=q.device) < pos
    s = s.masked_fill(~valid, NEG_INF)
    return _gqa_out(_softmax(s), v_cache)


def decode_sliding_attention(q, k_ring, v_ring, pos: int, window: int) -> torch.Tensor:
    """One-token decode over a (B, W, kv, hd) ring buffer (slot = t % W);
    a ring split over ranks is read as :func:`decode_attention` reads a
    split cache."""
    slot_t = torch.arange(window, device=q.device)
    # global time of ring slot j given the count `pos` (token t = pos-1
    # lives at slot (pos-1) % W): time = pos-1 - ((pos-1 - j) % W)
    t_of_slot = (pos - 1) - torch.remainder(pos - 1 - slot_t, window)
    valid = (t_of_slot >= 0) & (t_of_slot >= pos - window)
    if shardctx.split(k_ring, 1):
        return _decode_split(q, k_ring, v_ring, valid)
    s = _gqa_scores(q, k_ring)  # (B, kv, g, 1, W)
    s = s.masked_fill(~valid, NEG_INF)
    return _gqa_out(_softmax(s), v_ring)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MLADims:
    q_lora: int = 768
    kv_lora: int = 256
    rope_dim: int = 32
    nope_dim: int = 64
    v_dim: int = 64


def mla_init(gen, device, d_model: int, n_heads: int, dims: MLADims):
    h = n_heads
    return {
        "q_down": dense_init(gen, device, (d_model, dims.q_lora)),
        "q_norm": zeros(device, (dims.q_lora,)),
        "q_up": dense_init(gen, device, (dims.q_lora, h * (dims.nope_dim + dims.rope_dim))),
        "kv_down": dense_init(gen, device, (d_model, dims.kv_lora + dims.rope_dim)),
        "kv_norm": zeros(device, (dims.kv_lora,)),
        "kv_up": dense_init(gen, device, (dims.kv_lora, h * (dims.nope_dim + dims.v_dim))),
        "wo": dense_init(gen, device, (h * dims.v_dim, d_model)),
    }


def mla_qkv(p, x, positions, dims: MLADims, n_heads: int, theta: float):
    """Project x -> (q_nope, q_rope, c_kv, k_rope). Shapes:
    q_*: (B, S, H, *), c_kv: (B, S, kv_lora), k_rope: (B, S, rope_dim)."""
    b, s, _ = x.shape
    h = n_heads
    q = rms_norm(x @ p["q_down"], p["q_norm"])
    q = (q @ p["q_up"]).reshape(b, s, h, dims.nope_dim + dims.rope_dim)
    q_nope, q_rope = q[..., :dims.nope_dim], q[..., dims.nope_dim:]
    q_rope = rope(q_rope, positions, theta)
    ckv = x @ p["kv_down"]
    c_kv, k_rope = ckv[..., :dims.kv_lora], ckv[..., dims.kv_lora:]
    c_kv = rms_norm(c_kv, p["kv_norm"])
    k_rope = rope(k_rope[:, :, None, :], positions, theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_attention(p, x, positions, dims: MLADims, n_heads: int, theta: float,
                  impl: str = "auto"):
    """Training/prefill MLA (non-absorbed: materialize k, v per head)."""
    b, s, _ = x.shape
    h = n_heads
    q_nope, q_rope, c_kv, k_rope = mla_qkv(p, x, positions, dims, n_heads, theta)
    kv = (c_kv @ p["kv_up"]).reshape(b, s, h, dims.nope_dim + dims.v_dim)
    k_nope, v = kv[..., :dims.nope_dim], kv[..., dims.nope_dim:]
    k_rope_h = k_rope[:, :, None, :].expand(b, s, h, dims.rope_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope_h], -1)
    o = gqa_attention(q, k, v, causal=True, impl=impl)  # kv == h heads here
    return o @ p["wo"], (c_kv, k_rope)


def mla_decode(p, x, positions, cache_ckv, cache_krope, pos: int, dims: MLADims,
               n_heads: int, theta: float):
    """Absorbed-form decode: attention runs in the compressed kv_lora space,
    so the cache is (B, S, kv_lora) + (B, S, rope_dim).

    scores = q_nope @ W_uk . c_kv  +  q_rope . k_rope
    ctx    = softmax @ c_kv ; out = (ctx @ W_uv) @ wo

    The new token is written into the caches in place, at slot pos-1 (into
    the one shard that holds it, where the slots are split over ranks).
    """
    b, s1, _ = x.shape  # s1 == 1
    h = n_heads
    q_nope, q_rope, c_kv_new, k_rope_new = mla_qkv(p, x, positions, dims, n_heads, theta)
    if shardctx.split(cache_ckv, 1):
        shardctx.write_slot(cache_ckv, 1, pos - 1, c_kv_new)
        shardctx.write_slot(cache_krope, 1, pos - 1, k_rope_new)
    else:
        cache_ckv[:, pos - 1] = c_kv_new[:, 0]
        cache_krope[:, pos - 1] = k_rope_new[:, 0]
    # kv_up columns are head-major [nope | v] blocks: reshape before splitting
    w_u = p["kv_up"].reshape(dims.kv_lora, h, dims.nope_dim + dims.v_dim)
    w_uk = w_u[..., :dims.nope_dim]
    w_uv = w_u[..., dims.nope_dim:]
    q_abs = torch.einsum("bqhn,chn->bqhc", q_nope, w_uk)  # (B, 1, H, kv_lora)
    s_nope = torch.einsum("bqhc,bsc->bhqs", q_abs, cache_ckv)
    s_rope = torch.einsum("bqhr,bsr->bhqs", q_rope, cache_krope)
    scale = (dims.nope_dim + dims.rope_dim) ** -0.5
    scores = (s_nope + s_rope) * scale  # (B, H, 1, S)
    valid = torch.arange(cache_ckv.shape[1], device=x.device) < pos
    scores = scores.masked_fill(~valid, NEG_INF)
    pr = _softmax(scores)
    ctx = torch.einsum("bhqs,bsc->bqhc", pr, cache_ckv)  # (B, 1, H, kv_lora)
    o = torch.einsum("bqhc,chv->bqhv", ctx, w_uv).reshape(b, s1, h * dims.v_dim)
    return o @ p["wo"], cache_ckv, cache_krope
