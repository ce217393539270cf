"""Distributed Coconut on ``torch.distributed`` — the sample-sort build, the
prune-then-verify query and the queries x runs batch screen over a device
mesh.

The programs are SPMD, as one ``shard_map`` program is on every device of a
JAX mesh: every rank runs the same code on the same (replicated) inputs,
takes its own shard by its mesh coordinate, and the ranks meet only in
collectives. The mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`
with named axes; a collective over an axis runs on that axis's process
group (``mesh.get_group(name)``). NCCL carries the collectives on the card,
gloo on the CPU (the multi-rank tests). Without a process group, the first
mesh made here creates a one-rank group on the device it is given, from an
in-process ``HashStore`` (no port, no rendezvous file); :func:`teardown` is
the one place that group is destroyed. A CUDA mesh never falls back to
gloo or the CPU: a missing card, a failed NCCL group or a group of
another backend raises. The collectives run on every group, one-rank
groups included, so the one card's mesh runs the code a mesh of many
cards runs.

The paper's two-pass *external sort* becomes a *sample-sort* across the
mesh:

  1. local summarize + sortable keys (``ops.summarize``: the ``paa`` and
     ``sax_pack`` kernels);
  2. sample local keys, ``all_gather`` the samples, derive range splitters;
  3. bucket every entry by splitter range and exchange buckets with one
     ``all_to_all_single`` per payload (fixed capacity + sentinel padding);
  4. a local lexicographic sort on (invalid, key words), stable, so equal
     keys keep their arrival order.

The result is globally sorted and contiguously sharded: shard i holds a key
range that precedes shard i+1's. Bucketing uses the most significant key
word only, so equal-word ties stay on one shard.

Queries follow prune-then-verify: the query batch's PAA (``ops.paa``), one
``ops.mindist`` launch per query against every local entry's SAX region,
the top-V candidates per query by bound, their true distances in plain
torch, and one ``all_gather`` with a stable re-select for the global top-k.

Key words are uint32 values held in int64 tensors (torch has no uint32
arithmetic on the CPU); the sentinel word is ``0xFFFFFFFF``. Selection is
lexicographic on (value, position) throughout, as ``lax.top_k`` keeps the
lower index among ties: stable sorts, never ``torch.topk``.
"""
from __future__ import annotations

import atexit
import dataclasses
import datetime
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..kernels import ops
from .summarization import SummarizationConfig
from .verify_engine import resolve_device

SENTINEL = 0xFFFFFFFF  # the uint32 key word of a padding slot, held in int64
# a collective that waits longer than this raises instead of hanging
GROUP_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class DistBuildConfig:
    summarization: SummarizationConfig
    samples_per_shard: int = 64
    capacity_slack: float = 2.0  # bucket capacity = local_n/n_shards * slack
    materialized: bool = True  # carry raw series through the exchange


# --------------------------------------------------------------------------
# meshes and process groups
# --------------------------------------------------------------------------
_MESHES: dict = {}  # device type -> the default (queries, runs) mesh
_OWN_GROUP = {"made": False, "atexit": False}


def _ensure_group(dev: torch.device) -> None:
    """A process group for ``dev``'s collectives: the caller's if one
    exists and its backend is ``dev``'s (NCCL for cuda, gloo for cpu),
    else a one-rank group made here; a group of the other backend raises."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dev.type} mesh needs a {backend} process group, "
                               f"not the {dist.get_backend()} group that exists")
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                            timeout=GROUP_TIMEOUT)
    _OWN_GROUP["made"] = True
    if not _OWN_GROUP["atexit"]:
        atexit.register(teardown)
        _OWN_GROUP["atexit"] = True


def teardown() -> None:
    """Forget the cached meshes and destroy the process group this module
    made (a caller's own group is left alone)."""
    _MESHES.clear()
    if _OWN_GROUP["made"] and dist.is_initialized():
        dist.destroy_process_group()
    _OWN_GROUP["made"] = False


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device="cuda") -> DeviceMesh:
    """A named mesh over every rank of the process group on ``device``'s
    type, the group made first if there is none."""
    dev = resolve_device(device)
    _ensure_group(dev)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axis_names))


def default_batch_mesh(device="cuda") -> DeviceMesh:
    """The default (queries, runs) serving mesh over every rank: the query
    axis gets the largest power of two <= sqrt(world size) that divides the
    world size, the runs axis the rest. One rank gives (1, 1); eight give
    (2, 4)."""
    dev = resolve_device(device)
    if dev.type not in _MESHES:
        _ensure_group(dev)
        n = dist.get_world_size()
        qs = 1
        while (qs * 2) * (qs * 2) <= n and n % (qs * 2) == 0:
            qs *= 2
        _MESHES[dev.type] = make_mesh((qs, n // qs), ("q", "r"), dev)
    return _MESHES[dev.type]


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    """Where this rank's shards live: the CPU, or its current card."""
    return resolve_device(mesh.device_type)


def _axes_group(mesh: DeviceMesh, axes: Sequence[str]):
    """(process group, this rank's shard index) of the one mesh axis in
    ``axes`` (the reference flattens several; every caller names one)."""
    if len(axes) != 1:
        raise ValueError(f"shard over one mesh axis, not {tuple(axes)}")
    return mesh.get_group(axes[0]), mesh.get_local_rank(axes[0])


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """``all_gather`` over ``group``: (group size,) + t.shape, in group rank
    order."""
    size = dist.get_world_size(group)
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t, group=group)
    return torch.stack(out)


def _lex_first(v: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of each row's k smallest values, lower position first
    among ties (``lax.top_k`` of the negated values)."""
    return torch.sort(v, dim=1, stable=True).indices[:, :k]


# --------------------------------------------------------------------------
# the sample-sort build
# --------------------------------------------------------------------------
def _lex_sort_perm(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The stable lexicographic order of rows under ``keys`` (first key
    most significant): stable sorts from the last key to the first."""
    perm = torch.arange(keys[0].shape[0], dtype=torch.int64, device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def build_local(series: torch.Tensor, ids: torch.Tensor, cfg: DistBuildConfig,
                group) -> dict:
    """SPMD body of the sample-sort build over ``group``. series (ln, n)
    is this rank's shard, ids (ln,) its global ids.

    Returns this rank's sorted shard: ``invalid`` (nsh * cap,) int32,
    ``keys`` (nsh * cap, nw) int64 words, ``ids`` int32, ``sym`` (.., w)
    int32, ``series`` (materialized), ``n_valid`` (1,) and ``overflow``
    (the entries every rank dropped for want of bucket capacity, summed).
    The concatenation of the shards in rank order is globally key-sorted."""
    scfg = cfg.summarization
    dev = series.device
    ln = series.shape[0]
    nsh = dist.get_world_size(group)
    _, sym, keys = ops.summarize(series, scfg)
    w0 = keys[:, 0].contiguous()

    # --- splitters from gathered samples (pass 1 of the "external sort")
    stride = max(1, ln // cfg.samples_per_shard)
    samp = w0[::stride][: min(cfg.samples_per_shard, ln)]
    allsamp = _gather(samp, group).reshape(-1)
    ssorted = torch.sort(allsamp).values
    qidx = (torch.arange(1, nsh, dtype=torch.int64, device=dev) * allsamp.shape[0]) // nsh
    splitters = ssorted[qidx]  # (nsh-1,)

    # --- bucket by most-significant key word (ties stay together)
    bucket = torch.searchsorted(splitters, w0, right=True)
    cap = max(1, int(ln / nsh * cfg.capacity_slack))
    order = torch.sort(bucket, stable=True).indices
    sbucket = bucket[order]
    start = torch.searchsorted(sbucket, torch.arange(nsh, dtype=torch.int64, device=dev))
    pos = torch.arange(ln, dtype=torch.int64, device=dev) - start[sbucket]
    overflow = (pos >= cap).sum()
    slot = pos.clamp_max(cap)  # slot `cap` is the shared trash slot

    def scatter(payload, fill):
        buf = torch.full((nsh, cap + 1) + tuple(payload.shape[1:]), fill,
                         dtype=payload.dtype, device=dev)
        # writes to the trash slot collide; that slot is dropped below
        buf[sbucket, slot] = payload[order]
        return buf[:, :cap].contiguous()

    parts = [scatter(keys, SENTINEL), scatter(ids.to(torch.int32), -1),
             scatter(sym.to(torch.int32), 0),
             scatter(torch.zeros(ln, dtype=torch.int32, device=dev), 1)]
    if cfg.materialized:
        parts.append(scatter(series.to(torch.float32), 0.0))

    # --- one all_to_all bucket exchange (pass 2: the "merge" traffic)
    rn = nsh * cap
    recv = []
    for pt in parts:
        out = torch.empty_like(pt)
        dist.all_to_all_single(out, pt, group=group)
        recv.append(out.reshape((rn,) + tuple(pt.shape[2:])))
    rkeys, rids, rsym, rinval = recv[:4]

    # --- local sort on (invalid, w0, ..., w_{nw-1}): the invalid flag pushes
    # the sentinels to the end; (invalid, w0) fit one int64 key
    nw = rkeys.shape[1]
    first = rinval.to(torch.int64) * (1 << 32) + rkeys[:, 0]
    perm = _lex_sort_perm([first] + [rkeys[:, i] for i in range(1, nw)])
    total = overflow.to(torch.int64)
    dist.all_reduce(total, group=group)
    out = {
        "invalid": rinval[perm],
        "keys": rkeys[perm],
        "ids": rids[perm],
        "sym": rsym[perm],
        "n_valid": (rinval == 0).sum().to(torch.int32)[None],
        "overflow": total,
    }
    if cfg.materialized:
        out["series"] = recv[4][perm]
    return out


def sax_regions(sym: torch.Tensor, scfg: SummarizationConfig):
    """The (lo, hi) breakpoint region of every SAX symbol in ``sym`` (B, w),
    each (B, w) f32 on ``sym``'s device; the outer edges are -+1e30."""
    dev = sym.device
    bps = ops.breakpoint_table(scfg.card_bits, dev)
    big = torch.full((1,), 1e30, dtype=torch.float32, device=dev)
    sym = sym.long()
    return (torch.cat([-big, bps])[sym].contiguous(),
            torch.cat([bps, big])[sym].contiguous())


def query_local(index: dict, queries: torch.Tensor, cfg: DistBuildConfig, group, *,
                k: int = 10, verify_budget: int = 128):
    """SPMD body of the prune-then-verify query over ``group``.

    index: this rank's shard from :func:`build_local` (materialized).
    queries: (m, n), the same on every rank. Returns ((m, k) d2 ascending,
    (m, k) global ids), the same on every rank."""
    scfg = cfg.summarization
    dev = index["series"].device
    queries = queries.to(device=dev, dtype=torch.float32).contiguous()
    m = queries.shape[0]
    qp = ops.paa(queries, scfg)  # (m, w)
    lo, hi = sax_regions(index["sym"], scfg)  # (ln, w)
    inval = index["invalid"].bool()

    # the pruning front: one mindist launch per query against every region
    lb2 = torch.stack([ops.mindist(qp[i].contiguous(), lo, hi, scfg)
                       for i in range(m)]) if m else lo.new_zeros((0, lo.shape[0]))
    lb2 = lb2.masked_fill(inval[None, :], math.inf)

    v = min(verify_budget, lo.shape[0])
    cand = _lex_first(lb2, v)  # (m, v) local candidate positions
    diff = index["series"][cand] - queries[:, None, :]  # (m, v, n)
    d2 = (diff * diff).sum(-1)
    d2 = d2.masked_fill(inval[cand], math.inf)
    kk = min(k, v)
    nidx = _lex_first(d2, kk)
    local_d2 = d2.gather(1, nidx)
    local_ids = index["ids"][cand].gather(1, nidx)

    # global reduce: gather every shard's top-k and re-select
    gd2 = _gather(local_d2, group)  # (nsh, m, kk)
    gids = _gather(local_ids, group)
    nsh = gd2.shape[0]
    gd2 = gd2.permute(1, 0, 2).reshape(m, nsh * kk)
    gids = gids.permute(1, 0, 2).reshape(m, nsh * kk)
    fidx = _lex_first(gd2, min(k, nsh * kk))
    return gd2.gather(1, fidx), gids.gather(1, fidx)


# --------------------------------------------------------------------------
# entry points over a mesh
# --------------------------------------------------------------------------
def _as_tensor(a, dev, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)


def make_build_fn(mesh: DeviceMesh, axes: Sequence[str], cfg: DistBuildConfig):
    """``build(series, ids)`` with the (N, n) series and (N,) ids given
    whole on every rank and sharded over the mesh axis ``axes``: each rank
    builds its shard of the N / n_shards rows at its index, and every rank
    returns the whole result, the shards concatenated in shard order
    (``overflow`` a scalar)."""
    group, shard = _axes_group(mesh, axes)
    dev = _mesh_device(mesh)

    def build(series, ids) -> dict:
        nsh = dist.get_world_size(group)
        n_rows = series.shape[0]
        if n_rows % nsh:
            raise ValueError(f"{n_rows} series do not split into {nsh} shards")
        ln = n_rows // nsh
        local = _as_tensor(series[shard * ln:(shard + 1) * ln], dev, torch.float32)
        lids = _as_tensor(ids[shard * ln:(shard + 1) * ln], dev, torch.int32)
        out = build_local(local.contiguous(), lids, cfg, group)
        return {name: t if name == "overflow" else
                _gather(t, group).reshape((-1,) + tuple(t.shape[1:]))
                for name, t in out.items()}

    return build


def make_query_fn(mesh: DeviceMesh, axes: Sequence[str], cfg: DistBuildConfig, *,
                  k: int = 10, verify_budget: int = 128):
    """``query(index, queries)`` over a whole index from
    :func:`make_build_fn` (each rank asks its own shard) with the queries
    replicated; every rank returns the same ((m, k) d2, (m, k) ids)."""
    group, shard = _axes_group(mesh, axes)
    dev = _mesh_device(mesh)

    def query(index: dict, queries):
        nsh = dist.get_world_size(group)
        rows = index["invalid"].shape[0] // nsh
        local = {name: t[shard * rows:(shard + 1) * rows].to(dev)
                 for name, t in index.items() if name not in ("overflow", "n_valid")}
        return query_local(local, _as_tensor(queries, dev, torch.float32), cfg, group,
                           k=k, verify_budget=verify_budget)

    return query


def valid_entries(index: dict) -> tuple[np.ndarray, np.ndarray]:
    """Host-side extraction of the valid (non-sentinel) entries of a
    sample-sorted build, in global key order — the bridge from the
    distributed build to the mesh batch screen: the returned (series, ids)
    feed :func:`mesh_topk_candidates` directly, with each build shard's
    contiguous key range landing on one runs-axis shard."""
    keep = ~index["invalid"].bool().cpu().numpy()
    return (index["series"].cpu().numpy()[keep],
            index["ids"].cpu().numpy()[keep].astype(np.int64))


# --------------------------------------------------------------------------
# mesh-sharded batch serving: queries x runs 2-D screening for the executor
# --------------------------------------------------------------------------
def mesh_topk_candidates(Q, X, ksel: int, *, mesh: DeviceMesh = None, device="cuda"):
    """Screen a query batch against a candidate table on the device mesh.

    Q (m, n) f32 queries, X (C, n) f32 candidates, both the same on every
    rank. The query batch is sharded over the mesh's first axis (``m``
    padded with zero rows to a multiple of it) and the candidates over the
    second, in contiguous shards of ceil(C / runs) rows (a 1-D mesh screens
    every candidate on each query shard). Each rank screens its (query
    shard, candidate shard) tile with one ``topk_ed`` launch; the
    per-shard slates fold with one ``all_gather`` over the runs axis and a
    stable re-select, and one more ``all_gather`` over the query axis gives
    every rank the whole slate. Returns ((m, ksel) d2 f32, (m, ksel) rows
    into X, -1 = invalid) as host arrays — callers re-rank the slate
    exactly in f64 (``execute._rerank_slate``), so the f32 screen never
    decides final distances. Without ``mesh``, :func:`default_batch_mesh`
    of ``device``. No candidate row is padded: the kernel takes any
    count."""
    Q = np.asarray(Q, np.float32)
    X = np.asarray(X, np.float32)
    m, n = Q.shape
    c = X.shape[0]
    if m == 0 or c == 0:  # the same on every rank: no collective is skipped alone
        return np.zeros((m, 0), np.float32), np.full((m, 0), -1, np.int64)
    mesh = mesh if mesh is not None else default_batch_mesh(device)
    names = tuple(mesh.mesh_dim_names)
    if len(names) > 2:
        raise ValueError(f"mesh {names}: one query axis and at most one runs axis")
    qs = mesh.size(0)
    runs = len(names) == 2
    rs = mesh.size(1) if runs else 1
    ksel = min(ksel, c)
    dev = _mesh_device(mesh)
    iq = mesh.get_local_rank(names[0])
    ir = mesh.get_local_rank(names[1]) if runs else 0
    mq = -(-m // qs)
    e = -(-c // rs)
    qt = torch.zeros((mq, n), dtype=torch.float32)
    mine = Q[iq * mq:(iq + 1) * mq]
    qt[: mine.shape[0]] = torch.from_numpy(np.ascontiguousarray(mine))
    x = torch.from_numpy(np.ascontiguousarray(X[ir * e:(ir + 1) * e])).to(dev)
    kk = min(ksel, e)
    v, i = ops.topk_ed(qt.to(dev), x, kk)  # (mq, kk); short shards pad (inf, -1)
    gi = torch.where(i >= 0, i.to(torch.int64) + ir * e, -1)
    if runs:  # fold the shard slates: (rs, mq, kk) -> (mq, ksel)
        av = _gather(v, mesh.get_group(names[1])).permute(1, 0, 2).reshape(mq, rs * kk)
        ai = _gather(gi, mesh.get_group(names[1])).permute(1, 0, 2).reshape(mq, rs * kk)
        fi = _lex_first(av, ksel)
        v, gi = av.gather(1, fi), ai.gather(1, fi)
    # every rank gets the whole (m, ksel) slate
    v = _gather(v, mesh.get_group(names[0])).reshape(qs * mq, ksel)
    gi = _gather(gi, mesh.get_group(names[0])).reshape(qs * mq, ksel)
    d2 = v[:m].cpu().numpy()
    rows = gi[:m].cpu().numpy()
    return d2, np.where(rows >= c, -1, rows)
