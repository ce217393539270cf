"""Multi-pod dry run: trace every (architecture x input-shape x mesh) cell
against the production meshes as one rank of them, prove memory fit, and
extract the roofline terms (FLOPs and bytes from the cost counters,
collective bytes from the collectives the step issues).

It runs as its own process, as one rank (rank 0) of a ``"fake"`` process
group of 256 or 512 ranks, which answers every collective without
communicating: ``PYTHONPATH=src python -m repro_torch.launch.dryrun --arch
all --shape all --mesh both --out results/dryrun`` (``--device cpu`` on a
host without a card). Parameters, AdamW state, batch and cache are
``DTensor``s placed by ``launch/specs.py``, on fake tensors
(``FakeTensorMode``: shapes and dtypes, no memory, no device work), and one
step runs under ``implicit_replication()`` and ``hlo_analysis.CostMode``.

The layers of a group are the same shapes group after group, so a step's
costs are affine in the number of groups. A model of more than three
groups is traced twice, with two groups and with three (every other loop
of the step counted as it runs: the microbatches, the attention's chunks,
the remat recompute), and its costs are carried to the full depth along
that line (the first group differs: its input is the embedding's);
``traced_groups`` in the result says so. Memory: ``args_bytes`` is the sum
of the local shard bytes of every input at full depth (from the specs);
``temp_bytes`` is the peak of the local bytes the step allocates and holds
at once (the counting mode's, carried to full depth the same way). These
are the port's own figures; XLA's ``memory_analysis`` has no counterpart
here.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import ARCH_IDS, SHAPES, cell_is_skipped, get_config
from ..core.distributed import DistBuildConfig, build_local, query_local
from ..core.summarization import SummarizationConfig
from ..core.verify_engine import resolve_device
from ..models import shardctx
from ..models.steps import TrainConfig, make_decode_step, make_prefill_step, make_train_step
from ..models.transformer import ModelConfig, init_params, make_cache
from ..train.optimizer import AdamW, AdamWConfig
from .hlo_analysis import CostMode
from .mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16, dp_axes, make_production_mesh
from .specs import (
    batch_specs,
    cache_specs,
    drop_axis_specs,
    param_specs,
    placements,
    rebuild,
    zero1_hooks,
)


def model_flops(cfg: ModelConfig, shape, n_params_active: int) -> float:
    """Analytic MODEL_FLOPS for the useful-compute ratio: matmul params x 2
    per token (x3 for train), plus attention context and recurrent-state
    terms."""
    kinds = cfg.layer_kinds
    hd, h = cfg.hd, cfg.n_heads
    s = shape.seq_len
    per_tok_attn = 0.0
    for k in kinds:
        if k == "attn":
            ctx = s if shape.kind == "decode" else s / 2
            per_tok_attn += 4 * ctx * h * hd
        elif k == "local":
            ctx = min(cfg.window, s)
            per_tok_attn += 4 * ctx * h * hd
        elif k == "rwkv":
            per_tok_attn += 4 * cfg.d_model * hd  # state outer-products
        elif k == "rec":
            r = cfg.d_rnn or cfg.d_model
            per_tok_attn += 6 * r  # elementwise recurrence
    if shape.kind == "decode":
        tokens = shape.global_batch  # one new token per sequence
    else:
        tokens = shape.global_batch * s
    mult = 3.0 if shape.kind == "train" else 1.0
    return mult * tokens * (2 * n_params_active + per_tok_attn)


def abstract_batch(cfg: ModelConfig, shape, device="meta") -> dict:
    """Empty stand-ins (``meta`` by default) for a cell's batch."""
    b, s = shape.global_batch, shape.seq_len

    def e(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    if cfg.frontend == "audio":
        return {"features": e((b, s, cfg.d_frontend), torch.float32),
                "targets": e((b, s), torch.int32), "mask": e((b, s), torch.bool)}
    if cfg.frontend == "vision":
        return {"tokens": e((b, s - cfg.n_vis_tokens), torch.int32),
                "patches": e((b, cfg.n_vis_tokens, cfg.d_frontend), torch.float32)}
    return {"tokens": e((b, s), torch.int32)}


def input_specs(arch: str, shape_name: str, device="meta") -> dict:
    """Empty stand-ins for every model input of a cell."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        cache = make_cache(cfg, shape.global_batch, shape.seq_len, device=device)
        token = torch.empty((shape.global_batch, 1), dtype=torch.int32, device=device)
        return {"cache": cache, "token": token}
    return {"batch": abstract_batch(cfg, shape, device)}


def _grad_accum_for(cfg: ModelConfig, shape) -> int:
    """Bound per-microbatch tokens so rematted activations fit HBM."""
    tokens = shape.global_batch * shape.seq_len
    target = 131072  # tokens per microbatch (global)
    g = max(1, tokens // target)
    while shape.global_batch % g:
        g -= 1
    return g


def _pad_heads(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Pad the attention head count up to a multiple of the TP axis so
    head-sharded layouts are even (the reference's TPU adaptation, kept so
    the ``opt`` variant computes what the reference's does): ragged head
    counts force resharding gathers; padding trades a few % extra
    attention FLOPs for their removal."""
    h = cfg.n_heads
    hp = -(-h // tp) * tp
    if hp == h or not any(k in ("attn", "local") for k in cfg.layer_kinds):
        return cfg
    if cfg.mla is not None:
        return dataclasses.replace(cfg, n_heads=hp, n_kv=hp, head_dim=cfg.hd)
    if hp % cfg.n_kv:
        return cfg  # GQA grouping wouldn't stay integral; keep as is
    return dataclasses.replace(cfg, n_heads=hp, head_dim=cfg.hd)


# ---------------------------------------------------------------------------
# placing stand-ins on the mesh
# ---------------------------------------------------------------------------
def local_shape(shape, spec, mesh) -> tuple:
    """The shape of this rank's shard of a tensor of ``shape`` under
    ``spec`` (the specs shard dividing dims only)."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    out = list(shape)
    for d, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else tuple(e or ())):
            out[d] = -(-out[d] // sizes[a])
    return tuple(out)


def local_bytes(tensors_and_specs, mesh) -> int:
    """Sum of this rank's shard bytes of (tensor, spec) pairs."""
    return sum(math.prod(local_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in tensors_and_specs)


def _fake_dtensor(t: torch.Tensor, spec, mesh, device) -> DTensor:
    """An empty ``DTensor`` of ``t``'s global shape and dtype placed by
    ``spec``, its local shard a fake tensor on ``device`` (run under the
    ``FakeTensorMode``)."""
    local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype, device=device)
    stride = tuple(math.prod(t.shape[d + 1:]) for d in range(t.ndim))
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=t.shape, stride=stride)


def _pairs(tree, spec_tree):
    """(tensor, spec) leaf pairs of a tree and its spec tree."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _pairs(tree[k], spec_tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v, s in zip(tree, spec_tree) for x in _pairs(v, s)]
    return [(tree, spec_tree)] if isinstance(tree, torch.Tensor) else []


def _place_tree(tree, spec_tree, mesh, device):
    if isinstance(tree, dict):
        return {k: _place_tree(v, spec_tree[k], mesh, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_place_tree(v, s, mesh, device) for v, s in zip(tree, spec_tree)]
    if not isinstance(tree, torch.Tensor):
        return tree
    return _fake_dtensor(tree, spec_tree, mesh, device)


def _depth(cfg: ModelConfig, groups: int) -> ModelConfig:
    """``cfg`` with ``groups`` groups (prefix and tail layers kept)."""
    rem = len(cfg.tail_kinds)
    return dataclasses.replace(
        cfg, n_layers=cfg.first_dense + groups * len(cfg.pattern) + rem)


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------
def lower_cell(arch: str, shape_name: str, multi_pod: bool, variant: str = "baseline",
               device="cuda") -> dict:
    """Trace one cell on the production mesh over the default group (a
    fake group of 256 or 512 ranks; see :func:`fake_group`)."""
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=_device_type(device))
    with shardctx.ctx(mesh, dp_axes(multi_pod)):
        return _lower_cell(arch, shape_name, multi_pod, variant, device, mesh)


def _device_type(device) -> str:
    return resolve_device(device).type


def _trace(cfg, shape, kind, variant, mesh, multi_pod, device):
    """One traced step of ``cfg`` (whatever its depth): the counting
    mode's result, the step's wall time and the output/alias bytes."""
    dev = resolve_device(device)
    meta_model = init_params(cfg, None, "meta")
    pspecs = param_specs(meta_model, mesh)
    if variant == "opt" and kind == "decode":
        pspecs = drop_axis_specs(pspecs, "data")
    fake = torch._subclasses.fake_tensor.FakeTensorMode(allow_non_fake_inputs=True)
    # serving steps run under inference mode, whose views of a DTensor made
    # outside it fail: their stand-ins are made inside it
    serving = torch.inference_mode() if kind != "train" else contextlib.nullcontext()
    with fake, serving:
        params = rebuild(meta_model, lambda name, p: _fake_dtensor(p, pspecs[name], mesh, dev))
        t0 = time.perf_counter()
        if kind == "train":
            opt = AdamW(AdamWConfig())
            state = opt.init(params)
            tcfg = TrainConfig(grad_accum=_grad_accum_for(cfg, shape), remat=True)
            param_gather = grad_constrain = None
            if variant == "opt":
                param_gather, grad_constrain = zero1_hooks(meta_model, pspecs, mesh)
            step = make_train_step(cfg, tcfg, opt, param_gather, grad_constrain)
            babs = abstract_batch(cfg, shape)
            batch = _place_tree(babs, batch_specs(babs, mesh, multi_pod), mesh, dev)
            args = (params, state, batch, 0)
            extra = {"grad_accum": tcfg.grad_accum}
        elif kind == "prefill":
            step = make_prefill_step(cfg)
            babs = abstract_batch(cfg, shape)
            args = (params, _place_tree(babs, batch_specs(babs, mesh, multi_pod), mesh, dev))
            extra = {}
        else:
            step = make_decode_step(cfg)
            cache = make_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
            token = torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")
            args = (params, _place_tree(cache, cache_specs(cache, mesh, multi_pod), mesh, dev),
                    _place_tree(token, batch_specs(token, mesh, multi_pod), mesh, dev))
            extra = {}
        ins = {id(t) for t in _leaves(args)}
        with implicit_replication(), CostMode() as mode:
            out = step(*args)
        seconds = time.perf_counter() - t0
        outs = _leaves(out)
        out_bytes = sum(_local_nbytes(t) for t in outs)
        alias = sum(_local_nbytes(t) for t in outs if id(t) in ins)
    return mode.result(), seconds, out_bytes, alias, extra


def _leaves(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local_nbytes(t) -> int:
    t = t.to_local() if isinstance(t, DTensor) else t
    return t.numel() * t.element_size()


def _carry(r1: dict, r2: dict, groups: int):
    """Costs at ``groups`` groups from those at two and three (the first
    group's input comes from the embedding, placed otherwise than a group's
    output, so the line starts at the second)."""
    def line(a, b):
        return a + (groups - 2) * (b - a)

    out = {k: line(r1[k], r2[k]) for k in ("flops", "product_flops", "bytes")}
    # the peak is not exactly affine (when the collector frees the autograd
    # graph's cycles moves it): never under the deeper trace's
    out["peak_live_bytes"] = max(r2["peak_live_bytes"],
                                 line(r1["peak_live_bytes"], r2["peak_live_bytes"]))
    colls = {}
    for k in sorted(set(r1["collectives"]) | set(r2["collectives"])):
        a = r1["collectives"].get(k, {"count": 0, "bytes": 0.0})
        b = r2["collectives"].get(k, {"count": 0, "bytes": 0.0})
        colls[k] = {"count": int(line(a["count"], b["count"])),
                    "bytes": float(line(a["bytes"], b["bytes"]))}
    out["collectives"] = colls
    out["collective_bytes"] = float(sum(v["bytes"] for v in colls.values()))
    out["refused"] = {k: int(line(r1["refused"].get(k, 0), r2["refused"].get(k, 0)))
                      for k in set(r1["refused"]) | set(r2["refused"])}
    return out


def _lower_cell(arch: str, shape_name: str, multi_pod: bool, variant: str, device,
                mesh) -> dict:
    """variant: "baseline" = FSDP+TP everywhere; "opt" = ZeRO-1 gather-once
    weights for train, TP-only param sharding for decode, and TP-even head
    padding (the reference's two variants)."""
    cfg = get_config(arch)
    if variant == "opt":
        cfg = _pad_heads(cfg, 16)
    shape = SHAPES[shape_name]
    n_dev = mesh.size()
    kind = shape.kind

    # memory of the inputs at full depth, from the specs
    meta_model = init_params(cfg, None, "meta")
    pspecs = param_specs(meta_model, mesh)
    if variant == "opt" and kind == "decode":
        pspecs = drop_axis_specs(pspecs, "data")
    named = dict(meta_model.named_parameters())
    inputs = [(p, pspecs[k]) for k, p in named.items()]
    if kind == "train":
        inputs += [(torch.empty(p.shape, dtype=torch.float32, device="meta"), pspecs[k])
                   for _ in ("m", "v") for k, p in named.items()]
        babs = abstract_batch(cfg, shape)
        inputs += _pairs(babs, batch_specs(babs, mesh, multi_pod))
    elif kind == "prefill":
        babs = abstract_batch(cfg, shape)
        inputs += _pairs(babs, batch_specs(babs, mesh, multi_pod))
    else:
        spec = input_specs(arch, shape_name)
        cache = make_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
        inputs += _pairs(cache, cache_specs(cache, mesh, multi_pod))
        inputs += _pairs(spec["token"], batch_specs(spec["token"], mesh, multi_pod))
    args_bytes = local_bytes(inputs, mesh)

    groups = cfg.n_groups
    traced = [groups] if groups <= 3 else [2, 3]
    runs = [_trace(_depth(cfg, g), shape, kind, variant, mesh, multi_pod, device)
            for g in traced]
    res = runs[0][0] if len(runs) == 1 else _carry(runs[0][0], runs[1][0], groups)
    t_lower = sum(r[1] for r in runs)
    _, _, out_b, alias_b, extra = runs[-1]
    extra["variant"] = variant

    n_act = cfg.n_params_active()
    n_tot = cfg.n_params()
    mf = model_flops(cfg, shape, n_act)
    flops_dev = res["flops"] / n_dev
    bytes_dev = (res["bytes"]) / n_dev
    coll_bytes = res["collective_bytes"]
    temp = int(res["peak_live_bytes"])
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev,
        "lower_s": round(t_lower, 2),  # the traced steps' wall time
        "compile_s": 0.0,  # nothing is compiled: the step runs eagerly
        "n_params": n_tot,
        "n_params_active": n_act,
        "traced_groups": traced,
        "mem_per_device": {
            "args_bytes": args_bytes,
            "temp_bytes": temp,
            "output_bytes": out_b,
            "alias_bytes": alias_b,
            "total_gb": round((args_bytes + temp + out_b - alias_b) / 1e9, 3),
        },
        "cost_per_device": {"flops": flops_dev, "bytes": bytes_dev},
        "flops_global_jaxpr": res["flops"],  # the global count (the reference's key)
        "product_flops_global": res["product_flops"],
        "collectives": res["collectives"],
        "collective_bytes_per_device": coll_bytes,
        "replicated_ops": res["refused"],
        "roofline_s": {
            "compute": flops_dev / PEAK_FLOPS_BF16,
            "memory": bytes_dev / HBM_BW,
            "collective": coll_bytes / ICI_BW,
        },
        "model_flops_total": mf,
        "useful_flops_ratio": round(mf / max(res["flops"], 1.0), 4),
        **extra,
    }
    terms = result["roofline_s"]
    result["bottleneck"] = max(terms, key=terms.get)
    return result


# ---------------------------------------------------------------------------
# Coconut cells: the paper's own pipeline on the production mesh
# ---------------------------------------------------------------------------
COCONUT_CELLS = {
    "coconut-build": {"n_series": 1 << 26, "series_len": 256},
    # exchange summaries+ids only (non-materialized), raw series stay put —
    # queries fetch verified candidates by id instead.
    "coconut-build-nonmat": {"n_series": 1 << 26, "series_len": 256,
                             "materialized": False},
    "coconut-query": {"n_series": 1 << 26, "series_len": 256, "m": 16, "k": 10,
                      "verify_budget": 256},
}


def lower_coconut(cell: str, multi_pod: bool, device="cuda", n_series: int | None = None
                  ) -> dict:
    """Trace one rank's SPMD body of a Coconut cell over the whole default
    group (the index sharded over every mesh axis: one flat range). The
    counts are this rank's own (local shapes), so per device as they are;
    ``n_series`` overrides the cell's size (tests)."""
    spec = COCONUT_CELLS[cell]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=_device_type(device))
    dev = resolve_device(device)
    n_dev = mesh.size()
    group = dist.group.WORLD
    scfg = SummarizationConfig(series_len=spec["series_len"], n_segments=16, card_bits=8)
    dcfg = DistBuildConfig(summarization=scfg, capacity_slack=2.0,
                           materialized=spec.get("materialized", True))
    n, sl = n_series or spec["n_series"], spec["series_len"]
    ln = n // n_dev
    fake = torch._subclasses.fake_tensor.FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        if cell.startswith("coconut-build"):
            args = (torch.empty((ln, sl), dtype=torch.float32, device=dev),
                    torch.empty((ln,), dtype=torch.int32, device=dev))

            def body(series, ids):
                return build_local(series, ids, dcfg, group)
        else:
            cap = int(ln / n_dev * dcfg.capacity_slack)
            rn = n_dev * cap  # this rank's rows of the exchanged index
            e = lambda shp, dt: torch.empty(shp, dtype=dt, device=dev)  # noqa: E731
            index = {"invalid": e((rn,), torch.int32), "keys": e((rn, 4), torch.int64),
                     "ids": e((rn,), torch.int32), "sym": e((rn, 16), torch.int32),
                     "n_valid": e((1,), torch.int32), "overflow": e((), torch.int64),
                     "series": e((rn, sl), torch.float32)}
            args = (index, e((spec["m"], sl), torch.float32))

            def body(index, queries):
                return query_local(index, queries, dcfg, group, k=spec["k"],
                                   verify_budget=spec["verify_budget"])
        arg_bytes = float(sum(_local_nbytes(t) for t in _leaves(args)))
        t0 = time.perf_counter()
        with CostMode() as mode:
            out = body(*args)
        t_lower = time.perf_counter() - t0
        out_b = sum(_local_nbytes(t) for t in _leaves(out))
    res = mode.result(arg_bytes)
    flops_dev, bytes_dev = res["flops"], res["bytes"]
    coll_bytes = res["collective_bytes"]
    result = {
        "arch": cell, "shape": f"{n >> 20}M x {sl}",
        "mesh": "2x16x16" if multi_pod else "16x16", "n_devices": n_dev,
        "lower_s": round(t_lower, 2), "compile_s": 0.0,
        "mem_per_device": {
            "args_bytes": int(arg_bytes),
            "temp_bytes": int(res["peak_live_bytes"]),
            "output_bytes": out_b,
            "total_gb": round((arg_bytes + res["peak_live_bytes"] + out_b) / 1e9, 3),
        },
        "cost_per_device": {"flops": flops_dev, "bytes": bytes_dev},
        "collectives": res["collectives"],
        "collective_bytes_per_device": coll_bytes,
        "roofline_s": {
            "compute": flops_dev / PEAK_FLOPS_BF16,
            "memory": bytes_dev / HBM_BW,
            "collective": coll_bytes / ICI_BW,
        },
    }
    result["bottleneck"] = max(result["roofline_s"], key=result["roofline_s"].get)
    return result


# ---------------------------------------------------------------------------
# the process: a fake group per mesh
# ---------------------------------------------------------------------------
def fake_group(world: int, device="cuda") -> None:
    """Make this process rank 0 of a ``"fake"`` group of ``world`` ranks
    (destroying the group there is). The fake store lives in torch's
    testing package: it is imported here, when a dry run starts."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    resolve_device(device)
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _line(tag: str, res: dict) -> str:
    r, m, c = res["roofline_s"], res["mem_per_device"], res["cost_per_device"]
    colls = " ".join(f"{k}={v['bytes']:.4g}B/{v['count']}"
                     for k, v in sorted(res["collectives"].items())) or "none"
    return (f"OK {tag}: traced={res['lower_s']}s mem={m['total_gb']}GB/dev "
            f"(args {m['args_bytes']} temp {m['temp_bytes']}) "
            f"flops/dev={c['flops']:.4g} bytes/dev={c['bytes']:.4g} coll[{colls}] "
            f"compute={r['compute']:.4f}s memory={r['memory']:.4f}s "
            f"coll={r['collective']:.4f}s -> {res['bottleneck']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--coconut", action="store_true", help="also run coconut cells")
    ap.add_argument("--variant", default="baseline", choices=["baseline", "opt"])
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors: cuda (default; raises without "
                         "a card) or cpu")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    cells = []
    for a in archs:
        for s in shapes:
            reason = cell_is_skipped(a, s)
            if reason:
                print(f"SKIP {a} x {s}: {reason}")
                continue
            cells.append((a, s))
    if args.list:
        for a, s in cells:
            print(f"{a} x {s}")
        return

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    try:
        for multi_pod in meshes:
            fake_group(512 if multi_pod else 256, args.device)
            mesh_tag = "multi" if multi_pod else "single"
            if args.variant != "baseline":
                mesh_tag += f"_{args.variant}"
            for a, s in cells:
                tag = f"{a}__{s}__{mesh_tag}"
                try:
                    res = lower_cell(a, s, multi_pod, args.variant, args.device)
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(res, f, indent=1)
                    print(_line(tag, res), flush=True)
                except Exception as e:  # noqa: BLE001 — report and continue
                    failures += 1
                    print(f"FAIL {tag}: {type(e).__name__}: {str(e)[:300]}", flush=True)
            if args.coconut:
                for cell in COCONUT_CELLS:
                    tag = f"{cell}__{mesh_tag}"
                    try:
                        res = lower_coconut(cell, multi_pod, args.device)
                        with open(os.path.join(args.out, tag + ".json"), "w") as f:
                            json.dump(res, f, indent=1)
                        print(_line(tag, res), flush=True)
                    except Exception as e:  # noqa: BLE001
                        failures += 1
                        print(f"FAIL {tag}: {type(e).__name__}: {str(e)[:300]}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"dry-run complete; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
