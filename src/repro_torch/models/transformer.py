"""Composable decoder/encoder stack covering all 10 assigned architectures.

A model is a layer *pattern* (e.g. gemma3 = 5x local + 1x global attention;
recurrentgemma = rec, rec, local-attn) repeated over the depth. The
reference stacks each pattern position's parameters over the groups and
scans them; here every layer is a block of its own (``groups[g][j]`` is
layer ``first_dense + g * len(pattern) + j``) and the groups run in a
Python loop; with ``remat`` each group runs under activation
checkpointing, as the reference wraps its scan body in ``jax.checkpoint``.
Layers outside a whole number of groups live in ``prefix`` (e.g.
DeepSeek-MoE's dense layer 0) and ``tail`` (remainder).

Layer kinds: "attn" (global GQA / MLA), "local" (block-banded sliding
window), "rec" (RG-LRU), "rwkv" (WKV6 chunked). The MLP is dense SwiGLU or
MoE per config. Caches keep the reference's layout (``groups`` holds, per
pattern position, tensors stacked over the groups) and are written in
place by ``decode_step``; ``pos`` is a Python int.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import shardctx
from .attention import (
    MLADims,
    decode_attention,
    decode_sliding_attention,
    gqa_attention,
    mla_attention,
    mla_decode,
    mla_init,
    sliding_attention,
)
from .common import COMPUTE_DTYPE, dense_init, embed_init, rms_norm, rope, swiglu, zeros
from .moe import MoEDims, moe_init, moe_mlp
from .rglru import CONV_W, rglru_block, rglru_decode, rglru_init
from .rwkv6 import (
    rwkv6_channel_mix,
    rwkv6_init,
    rwkv6_time_mix,
    rwkv6_time_mix_decode,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    pattern: tuple = ("attn",)
    window: int = 0  # sliding-window size for "local" layers
    moe: Optional[MoEDims] = None
    first_dense: int = 0  # leading layers with dense MLP (DeepSeek-MoE)
    d_ff_dense: int = 0
    mla: Optional[MLADims] = None
    encoder_only: bool = False
    frontend: str = "none"  # none | vision | audio
    n_vis_tokens: int = 0
    d_frontend: int = 0
    rope_theta: float = 1e4
    d_rnn: int = 0
    norm_eps: float = 1e-6
    attention_impl: str = "auto"  # auto | flash | naive
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 128) * 128

    @property
    def layer_kinds(self) -> list:
        """Kind of every layer, prefix layers first."""
        kinds = []
        for i in range(self.n_layers - self.first_dense):
            kinds.append(self.pattern[i % len(self.pattern)])
        return ["attn"] * self.first_dense + kinds

    @property
    def n_groups(self) -> int:
        return (self.n_layers - self.first_dense) // len(self.pattern)

    @property
    def tail_kinds(self) -> tuple:
        rem = (self.n_layers - self.first_dense) % len(self.pattern)
        return self.pattern[:rem]

    def n_params(self) -> int:
        """Total parameter count, of a model built on the meta device (no
        allocation)."""
        model = init_params(self, None, torch.device("meta"))
        return sum(p.numel() for p in model.parameters())

    def n_params_active(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        total = self.n_params()
        if self.moe is None:
            return total
        e, k = self.moe.n_experts, self.moe.top_k
        n_moe_layers = self.n_layers - self.first_dense
        per_expert = 3 * self.d_model * self.moe.d_expert
        return total - n_moe_layers * (e - k) * per_expert


# ---------------------------------------------------------------------------
# the model as modules
# ---------------------------------------------------------------------------
class Params(nn.Module):
    """A tree of parameters under the reference's names: a dict becomes a
    ``Params``, a list an ``nn.ModuleList``, a tensor a parameter, frozen
    (serving needs no gradient; the trainer turns gradients on with
    ``requires_grad_(True)``). ``p["attn"]["wq"]`` and ``"moe" in p`` read
    as they do on the reference's dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if value is None:
                continue
            if isinstance(value, dict):
                self.add_module(name, Params(value))
            elif isinstance(value, list):
                self.add_module(name, _module_list(value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _module_list(items: list) -> nn.ModuleList:
    return nn.ModuleList(_module_list(v) if isinstance(v, list) else Params(v)
                         for v in items)


class Transformer(Params):
    """``embed``, optional ``w_front``, ``prefix``, ``groups`` (one block a
    layer, ``groups[g][j]``), ``tail``, ``final_norm`` and ``lm_head``."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, batch: dict, **kw):
        return forward(self, self.cfg, batch, **kw)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def _mlp_init(gen, device, cfg: ModelConfig, layer_idx: int):
    if cfg.moe is not None and layer_idx >= cfg.first_dense:
        return {"moe": moe_init(gen, device, cfg.d_model, cfg.moe)}
    d_ff = cfg.d_ff_dense if (cfg.first_dense and layer_idx < cfg.first_dense) else cfg.d_ff
    return {
        "w1": dense_init(gen, device, (cfg.d_model, d_ff)),
        "w3": dense_init(gen, device, (cfg.d_model, d_ff)),
        "w2": dense_init(gen, device, (d_ff, cfg.d_model)),
    }


def _layer_init(gen, device, cfg: ModelConfig, kind: str, layer_idx: int):
    d, hd = cfg.d_model, cfg.hd
    if kind == "rwkv":
        return {"rwkv": rwkv6_init(gen, device, d, hd, cfg.d_ff)}
    p = {"ln1": zeros(device, (d,)), "ln2": zeros(device, (d,))}
    if kind == "rec":
        p["rec"] = rglru_init(gen, device, d, cfg.d_rnn or d)
    elif cfg.mla is not None:
        p["attn"] = mla_init(gen, device, d, cfg.n_heads, cfg.mla)
    else:
        p["attn"] = {
            "wq": dense_init(gen, device, (d, cfg.n_heads * hd)),
            "wk": dense_init(gen, device, (d, cfg.n_kv * hd)),
            "wv": dense_init(gen, device, (d, cfg.n_kv * hd)),
            "wo": dense_init(gen, device, (cfg.n_heads * hd, d)),
        }
    p["mlp"] = _mlp_init(gen, device, cfg, layer_idx)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device="cuda") -> Transformer:
    """Random init drawn from ``generator`` on ``device`` (a generator of
    that device; ``None`` on the meta device, where only shapes are made)."""
    device = torch.device(device)
    gen = generator
    tree: dict = {"embed": embed_init(gen, device, (cfg.vocab_padded, cfg.d_model))}
    if cfg.frontend in ("vision", "audio"):
        tree["w_front"] = dense_init(gen, device, (cfg.d_frontend, cfg.d_model))
    kinds = cfg.layer_kinds
    tree["prefix"] = [_layer_init(gen, device, cfg, kinds[i], i)
                      for i in range(cfg.first_dense)]
    base = cfg.first_dense
    plen = len(cfg.pattern)
    tree["groups"] = [
        [_layer_init(gen, device, cfg, cfg.pattern[j], base + g * plen + j)
         for j in range(plen)]
        for g in range(cfg.n_groups)
    ]
    tail_base = base + cfg.n_groups * plen
    tree["tail"] = [_layer_init(gen, device, cfg, k, tail_base + j)
                    for j, k in enumerate(cfg.tail_kinds)]
    tree["final_norm"] = zeros(device, (cfg.d_model,))
    tree["lm_head"] = dense_init(gen, device, (cfg.d_model, cfg.vocab_padded))
    return Transformer(cfg, tree)


# ---------------------------------------------------------------------------
# full-sequence layer forward (prefill)
# ---------------------------------------------------------------------------
def _mlp_fwd(p, cfg: ModelConfig, x):
    if "moe" in p:
        out, aux = moe_mlp(p["moe"], x, cfg.moe)
        return out, aux["lb_loss"]
    w1, w3, w2 = (shardctx.gather(p[n], shardctx.DP) for n in ("w1", "w3", "w2"))
    return shardctx.constrain(swiglu(x, w1, w3, w2), shardctx.DP, None, None), 0.0


def _attn_weights(ap) -> dict:
    """The attention's projections as this layer uses them: under a
    sharding context each is gathered over the dp axes where it is used
    (FSDP, again in the remat recompute)."""
    return {n: shardctx.gather(ap[n], shardctx.DP) for n in ("wq", "wk", "wv", "wo")}


def _heads(y, cfg: ModelConfig, n: int):
    """(B, S, n * hd) -> (B, S, n, hd). Under a context whose "model" axis
    the heads do not divide, the projection is first gathered over it, as
    the reference's GSPMD lowering gathers q, k and v (``DTensor`` splits no
    sharded dim into heads that do not divide it): attention then runs
    whole on each rank's batch."""
    if not (shardctx.divides(cfg.n_heads, "model") and shardctx.divides(cfg.n_kv, "model")):
        y = shardctx.constrain(y, shardctx.DP, None, None)
    return y.reshape(y.shape[0], y.shape[1], n, cfg.hd)


def _pad_cache_s(arr, cache_len):
    """Pad a (B, S, ...) cache tensor with zeros up to cache_len slots."""
    if cache_len is None or arr.shape[1] >= cache_len:
        return arr
    pad = arr.new_zeros((arr.shape[0], cache_len - arr.shape[1]) + arr.shape[2:])
    return torch.cat([arr, pad], dim=1)


def _layer_fwd(p, cfg: ModelConfig, kind: str, x, positions, want_cache: bool,
               cache_len=None):
    """Returns (x, lb_loss, cache_entry_or_None)."""
    eps = cfg.norm_eps
    cache = None
    if kind == "rwkv":
        rp = p["rwkv"]
        b, s, d = x.shape
        h = d // cfg.hd
        state0 = torch.zeros((b, h, cfg.hd, cfg.hd), dtype=torch.float32, device=x.device)
        xprev0 = x.new_zeros((b, d))
        tm, state, xtm = rwkv6_time_mix(rp, rms_norm(x, rp["ln_tm"], eps), cfg.hd,
                                        state0, xprev0)
        x = x + tm
        cm, xcm = rwkv6_channel_mix(rp, rms_norm(x, rp["ln_cm"], eps), xprev0)
        x = x + cm
        if want_cache:
            cache = {"state": state, "xtm": xtm, "xcm": xcm}
        return x, 0.0, cache

    h_in = rms_norm(x, p["ln1"], eps)
    if kind == "rec":
        b, s, _ = x.shape
        r = cfg.d_rnn or cfg.d_model
        out, h_last, tail = rglru_block(
            p["rec"], h_in,
            torch.zeros((b, r), dtype=torch.float32, device=x.device),
            h_in.new_zeros((b, CONV_W - 1, r)))
        x = x + out
        if want_cache:
            cache = {"h": h_last, "tail": tail}
    elif cfg.mla is not None and kind == "attn":
        out, (c_kv, k_rope) = mla_attention(
            p["attn"], h_in, positions, cfg.mla, cfg.n_heads, cfg.rope_theta,
            impl=cfg.attention_impl,
        )
        x = x + out
        if want_cache:
            cache = {
                "ckv": _pad_cache_s(c_kv.to(COMPUTE_DTYPE), cache_len),
                "krope": _pad_cache_s(k_rope.to(COMPUTE_DTYPE), cache_len),
            }
    else:
        ap = _attn_weights(p["attn"])
        b, s, _ = x.shape
        q = _heads(h_in @ ap["wq"], cfg, cfg.n_heads)
        k = _heads(h_in @ ap["wk"], cfg, cfg.n_kv)
        v = _heads(h_in @ ap["wv"], cfg, cfg.n_kv)
        if not cfg.encoder_only:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        if kind == "local":
            o = sliding_attention(q, k, v, cfg.window)
        else:
            o = gqa_attention(q, k, v, causal=not cfg.encoder_only,
                              impl=cfg.attention_impl)
        x = x + shardctx.constrain(o @ ap["wo"], shardctx.DP, None, None)
        if want_cache:
            if kind == "local":
                w = cfg.window
                # ring-buffer layout: token t at slot t % w; keep last w tokens
                ring_k = k.new_zeros((b, w, cfg.n_kv, cfg.hd))
                ring_v = torch.zeros_like(ring_k)
                take = min(w, s)
                tpos = torch.arange(s - take, s, device=x.device)
                ring_k[:, tpos % w] = k[:, tpos]
                ring_v[:, tpos % w] = v[:, tpos]
                cache = {"k": ring_k, "v": ring_v}
            else:
                cache = {"k": _pad_cache_s(k, cache_len), "v": _pad_cache_s(v, cache_len)}
    m_in = rms_norm(x, p["ln2"], eps)
    mo, lb = _mlp_fwd(p["mlp"], cfg, m_in)
    x = x + mo
    return x, lb, cache


def _embed_inputs(params, cfg: ModelConfig, batch: dict):
    """Token/frontend embedding -> (x (B, S, D), positions (S,))."""
    if cfg.frontend == "audio":
        x = batch["features"].to(COMPUTE_DTYPE) @ params["w_front"]
    elif cfg.frontend == "vision":
        te = shardctx.embed(params["embed"], batch["tokens"])
        pe = batch["patches"].to(COMPUTE_DTYPE) @ params["w_front"]
        x = torch.cat([pe, te], dim=1)
    else:
        x = shardctx.embed(params["embed"], batch["tokens"])
    x = x.to(COMPUTE_DTYPE)
    x = shardctx.constrain(x, shardctx.DP, None, None)
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions


def _stack_groups(caches: list) -> list:
    """Per-layer cache entries of the groups -> the reference's layout: per
    pattern position, each tensor stacked over the groups."""
    return [{key: torch.stack([g[j][key] for g in caches]) for key in caches[0][j]}
            for j in range(len(caches[0]))]


def _group_fwd(group, cfg: ModelConfig, x, lb_total, positions, want_cache: bool,
               cache_len):
    """One group's pattern of layers (the reference's scan body)."""
    caches = []
    for j, kind in enumerate(cfg.pattern):
        x, lb, c = _layer_fwd(group[j], cfg, kind, x, positions, want_cache, cache_len)
        lb_total = lb_total + lb
        caches.append(c)
    return x, lb_total, caches


def forward(params, cfg: ModelConfig, batch: dict, *, want_cache: bool = False,
            remat: bool = False, cache_len=None):
    """Full-sequence forward. Returns (hidden (B,S,D), lb_loss, cache|None).

    remat: recompute each group's activations in the backward pass instead
    of keeping them (prefix and tail layers keep theirs, as in the
    reference). cache_len: total KV-cache slots to allocate when want_cache
    (must exceed the prompt length by the number of decode steps that will
    follow)."""
    x, positions = _embed_inputs(params, cfg, batch)
    lb_total = 0.0
    kinds = cfg.layer_kinds
    prefix_cache, group_cache, tail_cache = [], [], []
    for i, p in enumerate(params["prefix"]):
        x, lb, c = _layer_fwd(p, cfg, kinds[i], x, positions, want_cache, cache_len)
        lb_total = lb_total + lb
        prefix_cache.append(c)
    for group in params["groups"]:
        args = (group, cfg, x, lb_total, positions, want_cache, cache_len)
        if remat:
            x, lb_total, caches = checkpoint(_group_fwd, *args, use_reentrant=False)
        else:
            x, lb_total, caches = _group_fwd(*args)
        group_cache.append(caches)
    for j, p in enumerate(params["tail"]):
        x, lb, c = _layer_fwd(p, cfg, cfg.tail_kinds[j], x, positions, want_cache,
                              cache_len)
        lb_total = lb_total + lb
        tail_cache.append(c)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache = None
    if want_cache:
        cache = {
            "prefix": prefix_cache,
            "groups": _stack_groups(group_cache) if group_cache else None,
            "tail": tail_cache,
            "pos": x.shape[1],
        }
    lb_total = torch.as_tensor(lb_total, dtype=torch.float32, device=x.device)
    return x, lb_total, cache


def logits_fn(params, cfg: ModelConfig, hidden) -> torch.Tensor:
    """LM head with vocab padding masked out. hidden: (..., D) -> (..., Vp)."""
    logits = (hidden @ shardctx.gather(params["lm_head"], shardctx.DP)).float()
    spec = (shardctx.DP,) + (None,) * (logits.ndim - 2) + ("model",)
    logits = shardctx.constrain(logits, *spec)
    if cfg.vocab_padded != cfg.vocab:
        pad_mask = torch.where(
            torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab, 0.0, -1e9
        ).float()
        logits = logits + pad_mask
    return logits


# ---------------------------------------------------------------------------
# decode (single token) over a cache
# ---------------------------------------------------------------------------
def make_cache(cfg: ModelConfig, batch_size: int, s_max: int, device="cuda"):
    """Zero-initialized cache for decode; mirrors the parameter structure."""
    b, hd, kv = batch_size, cfg.hd, cfg.n_kv
    device = torch.device(device)

    def z(shape, dtype=COMPUTE_DTYPE):
        return torch.zeros(shape, dtype=dtype, device=device)

    def entry(kind, lead=()):
        if kind == "rwkv":
            h = cfg.d_model // hd
            return {
                "state": z(lead + (b, h, hd, hd), torch.float32),
                "xtm": z(lead + (b, cfg.d_model)),
                "xcm": z(lead + (b, cfg.d_model)),
            }
        if kind == "rec":
            r = cfg.d_rnn or cfg.d_model
            return {"h": z(lead + (b, r), torch.float32),
                    "tail": z(lead + (b, CONV_W - 1, r))}
        if cfg.mla is not None and kind == "attn":
            return {"ckv": z(lead + (b, s_max, cfg.mla.kv_lora)),
                    "krope": z(lead + (b, s_max, cfg.mla.rope_dim))}
        w = cfg.window if kind == "local" else s_max
        return {"k": z(lead + (b, w, kv, hd)), "v": z(lead + (b, w, kv, hd))}

    kinds = cfg.layer_kinds
    return {
        "prefix": [entry(kinds[i]) for i in range(cfg.first_dense)],
        "groups": ([entry(k, (cfg.n_groups,)) for k in cfg.pattern]
                   if cfg.n_groups else None),
        "tail": [entry(k) for k in cfg.tail_kinds],
        "pos": 0,
    }


def _layer_decode(p, cfg: ModelConfig, kind: str, x, cache, pos: int, positions):
    """One-token layer step. x: (B, 1, D); positions: (1,) = pos - 1.
    Returns (x, new_cache_entry); attention caches are written in place."""
    eps = cfg.norm_eps
    if kind == "rwkv":
        rp = p["rwkv"]
        tm, state, xtm = rwkv6_time_mix_decode(
            rp, rms_norm(x, rp["ln_tm"], eps), cfg.hd, cache["state"], cache["xtm"])
        x = x + tm
        cm, xcm = rwkv6_channel_mix(rp, rms_norm(x, rp["ln_cm"], eps), cache["xcm"])
        x = x + cm
        return x, {"state": state, "xtm": xtm, "xcm": xcm}

    h_in = rms_norm(x, p["ln1"], eps)
    if kind == "rec":
        out, h, tail = rglru_decode(p["rec"], h_in, cache["h"], cache["tail"])
        x = x + out
        new_cache = {"h": h, "tail": tail}
    elif cfg.mla is not None and kind == "attn":
        out, ckv, krope = mla_decode(
            p["attn"], h_in, positions, cache["ckv"], cache["krope"], pos,
            cfg.mla, cfg.n_heads, cfg.rope_theta,
        )
        x = x + out
        new_cache = {"ckv": ckv, "krope": krope}
    else:
        ap = _attn_weights(p["attn"])
        q = _heads(h_in @ ap["wq"], cfg, cfg.n_heads)
        k = _heads(h_in @ ap["wk"], cfg, cfg.n_kv)
        v = _heads(h_in @ ap["wv"], cfg, cfg.n_kv)
        if not cfg.encoder_only:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        kc, vc = cache["k"], cache["v"]
        if kind == "local":
            w = cfg.window
            slot = (pos - 1) % w
        else:
            slot = pos - 1
        if shardctx.split(kc, 1):  # slots split over ranks: the owner writes
            shardctx.write_slot(kc, 1, slot, k)
            shardctx.write_slot(vc, 1, slot, v)
        else:
            kc[:, slot] = k[:, 0]
            vc[:, slot] = v[:, 0]
        if kind == "local":
            o = decode_sliding_attention(q, kc, vc, pos, w)
        else:
            o = decode_attention(q, kc, vc, pos)
        x = x + shardctx.constrain(o @ ap["wo"], shardctx.DP, None, None)
        new_cache = {"k": kc, "v": vc}
    m_in = rms_norm(x, p["ln2"], eps)
    mo, _ = _mlp_fwd(p["mlp"], cfg, m_in)
    return x + mo, new_cache


def _store(entry: dict, new: dict) -> None:
    """Write a layer's new cache tensors into its entry (in place)."""
    for key, value in new.items():
        if value is not entry[key]:
            entry[key].copy_(value)


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, cache: dict, token: torch.Tensor):
    """Decode one token. token: (B, 1) int. Returns (logits (B, Vp), cache);
    the cache is updated in place and returned."""
    pos = cache["pos"] + 1  # number of tokens including this one
    x = shardctx.embed(params["embed"], token).to(COMPUTE_DTYPE)  # (B, 1, D)
    positions = torch.full((1,), pos - 1, dtype=torch.long, device=x.device)
    kinds = cfg.layer_kinds
    for i, p in enumerate(params["prefix"]):
        x, c = _layer_decode(p, cfg, kinds[i], x, cache["prefix"][i], pos, positions)
        _store(cache["prefix"][i], c)
    for g, group in enumerate(params["groups"]):
        for j, kind in enumerate(cfg.pattern):
            entry = {key: t[g] for key, t in cache["groups"][j].items()}
            x, c = _layer_decode(group[j], cfg, kind, x, entry, pos, positions)
            _store(entry, c)
    for j, p in enumerate(params["tail"]):
        x, c = _layer_decode(p, cfg, cfg.tail_kinds[j], x, cache["tail"][j], pos,
                             positions)
        _store(cache["tail"][j], c)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, cfg, x[:, 0, :])
    cache["pos"] = pos
    return logits, cache


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch: dict, *, cache_len=None):
    """Process a full prompt; returns (last-token logits, cache).

    cache_len defaults to prompt_len + 64 slots of decode headroom."""
    if cache_len is None:
        s = batch["features"].shape[1] if "features" in batch else batch["tokens"].shape[1]
        if cfg.frontend == "vision":
            s += cfg.n_vis_tokens
        cache_len = s + 64
    hidden, _, cache = forward(params, cfg, batch, want_cache=True, cache_len=cache_len)
    logits = logits_fn(params, cfg, hidden[:, -1, :])
    return logits, cache
