"""The port's dry run lowering every cell (``repro_torch.launch.dryrun``):
``lower_cell`` for every arch and kind (smoke configs cut to one group,
smoke shapes cut to 32 tokens) and ``lower_coconut`` at a small ``n``, on a
4-rank fake mesh (2, 2) standing in for the production mesh. Each returns
the reference's result keys, ``args_bytes`` the local shard bytes of the
inputs (computed here from the specs and the shapes), a collective in
every FSDP train step; a model of more than three groups carried from two
traces gives what a trace at its full depth gives; the Coconut cells
launch no kernel. No JAX: the reference's result keys are written out.
"""
import dataclasses
from unittest import mock

import pytest
import torch

from repro_torch import configs as pconfigs
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as pdryrun
from repro_torch.launch import specs as pspecs
from repro_torch.models import shardctx
from repro_torch.models import transformer as pt

ARCH_IDS = pconfigs.ARCH_IDS


# ------------------------------------------------------------------ lowering
@pytest.fixture(scope="module")
def fake_mesh():
    """A 4-rank fake group, its (2, 2) mesh standing in for the production
    mesh, smoke configs of one group and smoke shapes; the group is
    destroyed after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    assert not dist.is_initialized()
    pdryrun.fake_group(4, "cpu")

    def mesh(multi_pod=False, device_type="cuda"):
        return init_device_mesh(device_type, (2, 2), mesh_dim_names=("data", "model"))

    def cfg(arch):
        return pdryrun._depth(pconfigs.get_config(arch, smoke=True), 1)

    with mock.patch.object(pdryrun, "make_production_mesh", mesh), \
            mock.patch.object(pdryrun, "get_config", cfg), \
            mock.patch.object(pdryrun, "SHAPES", LOWER_SHAPES):
        yield mesh(device_type="cpu")
    dist.destroy_process_group()


# the smoke shapes cut to 32 tokens (the lowering runs on fake tensors:
# the sizes change nothing it checks)
LOWER_SHAPES = {k: dataclasses.replace(v, seq_len=32)
                for k, v in pconfigs.SMOKE_SHAPES.items()}
REF_KEYS = {"arch", "shape", "mesh", "n_devices", "lower_s", "compile_s", "n_params",
            "n_params_active", "mem_per_device", "cost_per_device", "flops_global_jaxpr",
            "collectives", "collective_bytes_per_device", "roofline_s",
            "model_flops_total", "useful_flops_ratio", "bottleneck", "variant"}
MEM_KEYS = {"args_bytes", "temp_bytes", "output_bytes", "alias_bytes", "total_gb"}


def _shard_bytes(t, spec, sizes) -> int:
    n = t.numel() * t.element_size()
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n //= sizes[a]
    return n


def _input_bytes(arch, shape_name, variant, sizes) -> int:
    cfg = pdryrun.get_config(arch)
    if variant == "opt":
        cfg = pdryrun._pad_heads(cfg, 16)
    shape = LOWER_SHAPES[shape_name]
    stub = type("M", (), {"mesh_dim_names": tuple(sizes), "shape": tuple(sizes.values())})
    model = pt.init_params(cfg, None, "meta")
    ps = pspecs.param_specs(model, stub)
    if variant == "opt" and shape.kind == "decode":
        ps = pspecs.drop_axis_specs(ps, "data")
    named = dict(model.named_parameters())
    total = sum(_shard_bytes(p, ps[k], sizes) for k, p in named.items())
    if shape.kind == "train":
        total += sum(2 * _shard_bytes(p.float(), ps[k], sizes) for k, p in named.items())
    if shape.kind != "decode":
        batch = pdryrun.abstract_batch(cfg, shape)
        bs = pspecs.batch_specs(batch, stub, False)
        return total + sum(_shard_bytes(t, bs[k], sizes) for k, t in batch.items())
    cache = pt.make_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    leaves = pdryrun._pairs(cache, pspecs.cache_specs(cache, stub, False))
    token = torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")
    leaves.append((token, pspecs.batch_specs(token, stub, False)))
    return total + sum(_shard_bytes(t, s, sizes) for t, s in leaves)


CELLS = [(a, s) for a in ARCH_IDS for s in pconfigs.SMOKE_SHAPES
         if not pconfigs.cell_is_skipped(a, s)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_lower_cell_on_a_fake_mesh(fake_mesh, arch, shape):
    variant = "opt" if CELLS.index((arch, shape)) % 2 else "baseline"
    res = pdryrun.lower_cell(arch, shape, False, variant, "cpu")
    assert REF_KEYS <= set(res) and MEM_KEYS <= set(res["mem_per_device"])
    assert res["n_devices"] == 4 and res["variant"] == variant
    assert res["mem_per_device"]["args_bytes"] == _input_bytes(
        arch, shape, variant, {"data": 2, "model": 2})
    assert res["cost_per_device"]["flops"] > 0 and res["useful_flops_ratio"] > 0
    assert res["bottleneck"] in ("compute", "memory", "collective")
    kind = LOWER_SHAPES[shape].kind
    if kind == "train":
        assert res["grad_accum"] >= 1
        if variant == "baseline":  # FSDP: the weights are gathered
            assert sum(v["count"] for v in res["collectives"].values()) >= 1


def test_lower_cell_carries_costs_over_the_groups(fake_mesh):
    """A model of more than three groups is traced at two and three, and its
    costs carried to the full depth: equal to a trace at the full depth."""
    cfg = dataclasses.replace(pconfigs.get_config("smollm-360m", smoke=True), n_layers=5)
    with mock.patch.object(pdryrun, "get_config", lambda a: cfg):
        carried = pdryrun.lower_cell("smollm-360m", "prefill_32k", False, "baseline", "cpu")
    assert carried["traced_groups"] == [2, 3]
    shape = LOWER_SHAPES["prefill_32k"]
    with shardctx.ctx(fake_mesh, ("data",)):
        full, *_ = pdryrun._trace(cfg, shape, "prefill", "baseline", fake_mesh, False, "cpu")
    assert carried["flops_global_jaxpr"] == full["flops"]
    assert carried["collectives"] == full["collectives"]


@pytest.mark.parametrize("cell", sorted(pdryrun.COCONUT_CELLS))
def test_lower_coconut_on_a_fake_mesh(fake_mesh, cell):
    ops.reset_launches()
    res = pdryrun.lower_coconut(cell, False, "cpu", n_series=4 * 512)
    assert {"arch", "shape", "mesh", "n_devices", "lower_s", "compile_s", "mem_per_device",
            "cost_per_device", "collectives", "collective_bytes_per_device",
            "roofline_s", "bottleneck"} <= set(res)
    assert res["cost_per_device"]["flops"] > 0
    kinds = set(res["collectives"])
    assert ("all-to-all" in kinds) if "build" in cell else ("all-gather" in kinds)
    assert not any(ops.LAUNCHES.values())


def test_analyze_collectives_records_a_redistribution(fake_mesh):
    """A shard gathered whole on the (2, 2) mesh: one all-gather a mesh
    dim it was sharded over, its local output bytes each."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.hlo_analysis import analyze_collectives

    def gather(x):
        d = DTensor.from_local(x, fake_mesh, [Shard(0), Shard(1)], run_check=False)
        return d.redistribute(fake_mesh, [Replicate(), Replicate()])

    out = analyze_collectives(gather, torch.empty(8, 16))  # a (16, 32) f32 tensor
    assert set(out["collectives"]) == {"all-gather"}
    assert out["collectives"]["all-gather"]["count"] == 2
    # gathered over one mesh dim, then the other: 8x32, then 16x32, f32
    assert out["collectives"]["all-gather"]["bytes"] == (8 * 32 + 16 * 32) * 4
    assert out["collective_bytes"] == out["collectives"]["all-gather"]["bytes"]
