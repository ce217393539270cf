"""Mixture-of-Experts MLP with capacity-based dispatch.

Router: softmax top-k with renormalized gates, in f32. Dispatch: tokens
are sorted by expert id, each expert processes up to C = ceil(T*K/E *
capacity_factor) tokens (overflow dropped, counted in aux), computed as
one grouped einsum (E, C, D) x (E, D, F). Optional shared experts
(DeepSeek-MoE) run densely on every token. The dispatch is the
reference's index for index: top-k keeps the lower expert id on ties, the
sort by expert is stable, slot ``cap`` is the trash slot and row ``t`` the
dummy token.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from .common import dense_init


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.5


def moe_init(gen, device, d_model: int, dims: MoEDims):
    e, fe = dims.n_experts, dims.d_expert
    p = {
        "router": dense_init(gen, device, (d_model, e), dtype=torch.float32),
        "w1": dense_init(gen, device, (e, d_model, fe)),
        "w3": dense_init(gen, device, (e, d_model, fe)),
        "w2": dense_init(gen, device, (e, fe, d_model)),
    }
    if dims.n_shared:
        fs = dims.n_shared * fe
        p["shared_w1"] = dense_init(gen, device, (d_model, fs))
        p["shared_w3"] = dense_init(gen, device, (d_model, fs))
        p["shared_w2"] = dense_init(gen, device, (fs, d_model))
    return p


def top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, the lower index first on ties (as
    ``lax.top_k``): a stable descending sort, whose tie order is defined."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(gate_idx: torch.Tensor, gate_vals: torch.Tensor, e: int, cap: int):
    """The dispatch of (T, K) routed tokens into (E, cap) expert slots:
    (disp, gates, flat expert ids, kept assignments)."""
    t, k = gate_idx.shape
    dev = gate_idx.device
    # flatten (token, k) assignments and sort by expert
    flat_e = gate_idx.reshape(-1)  # (T*K,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_g = gate_vals.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st_, sg = flat_e[order], flat_t[order], flat_g[order]
    start = torch.searchsorted(se, torch.arange(e, device=dev), side="left")
    pos = torch.arange(t * k, device=dev) - start[se]
    keep = pos < cap
    slot = pos.clamp_max(cap)  # slot `cap` is trash
    # dispatch indices (E, C): token feeding each expert slot (t = dummy row)
    disp = torch.full((e, cap + 1), t, dtype=torch.long, device=dev)
    disp[se, slot] = torch.where(keep, st_, t)
    disp = disp[:, :cap]
    gates = torch.zeros((e, cap + 1), dtype=torch.float32, device=dev)
    gates[se, slot] = torch.where(keep, sg, 0.0)
    gates = gates[:, :cap]
    return disp, gates, flat_e, keep


def _routed(gate_idx, gate_vals, e: int, cap: int):
    """``_route``; on ``DTensor``s (a sharded step) it runs on every rank
    over the gate ids and values replicated, and returns replicated
    ``DTensor``s: ``DTensor`` has no sharding rule for ``searchsorted`` or
    for writing the slots into a tensor made here."""
    if not isinstance(gate_idx, DTensor):
        return _route(gate_idx, gate_vals, e, cap)
    mesh = gate_idx.device_mesh
    rep = [Replicate()] * mesh.ndim
    outs = _route(gate_idx.redistribute(mesh, rep).to_local(),
                  gate_vals.redistribute(mesh, rep).to_local(), e, cap)
    return tuple(DTensor.from_local(o, mesh, rep, run_check=False) for o in outs)


def moe_mlp(p, x: torch.Tensor, dims: MoEDims) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (B, S, D). Returns (out, aux) with load-balance loss."""
    b, s, d = x.shape
    t = b * s
    e, k = dims.n_experts, dims.top_k
    dev = x.device
    xf = x.reshape(t, d)
    logits = xf.float() @ p["router"]  # (T, E), f32
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)  # (T, K)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # capacity floor min(t, 8) keeps tiny decode batches drop-free
    cap = max(math.ceil(t * k / e * dims.capacity_factor), min(t, 8))
    disp, gates, flat_e, keep = _routed(gate_idx, gate_vals, e, cap)

    xpad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xin = xpad[disp]  # (E, C, D)
    h = F.silu(torch.einsum("ecd,edf->ecf", xin, p["w1"])) * torch.einsum(
        "ecd,edf->ecf", xin, p["w3"])
    eo = torch.einsum("ecf,efd->ecd", h, p["w2"])  # (E, C, D)
    eo = eo * gates[..., None].to(eo.dtype)
    # combine: scatter-add expert outputs back to tokens
    out = eo.new_zeros((t + 1, d)).index_add_(
        0, disp.reshape(-1), eo.reshape(e * cap, d))[:t]

    if dims.n_shared:
        sh = F.silu(xf @ p["shared_w1"]) * (xf @ p["shared_w3"])
        out = out + sh @ p["shared_w2"]

    # load-balance aux (Switch-style) + overflow fraction
    me = probs.mean(0)  # (E,)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.ones(t * k, dtype=torch.float32, device=dev)) / (t * k)
    aux = {
        "lb_loss": e * torch.sum(me * ce),
        "overflow_frac": 1.0 - keep.float().mean(),
    }
    return out.reshape(b, s, d), aux
