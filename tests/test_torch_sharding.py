"""The port's sharded launch layer (``repro_torch.launch.specs``,
``repro_torch.models.shardctx``, ``repro_torch.launch.mesh``) against the
reference's, and a sharded train step against the unsharded one.

* Specs: for all ten archs' full configs on stub meshes of (16, 16) and
  (2, 16, 16) (axis names and sizes only: neither package needs a device
  for its specs), every port parameter's spec is the reference leaf's spec
  without its stacked groups dim; cache, batch and drop-axis specs and the
  ``opt`` variant's head padding equal the reference's. Exact.
* Placements: on 8 gloo ranks (a (2, 4) and a (2, 2, 2) mesh, each with a
  tuple-axis spec) each rank's local shard is the block that the
  reference's ``NamedSharding(...).devices_indices_map`` gives the same
  device coordinate in an 8-device subprocess of its own.
* ``constrain``: the argument itself without a context; with one, the
  reference's resolution (DP placeholder, non-dividing axes dropped).
* A sharded ``opt`` train step on a one-rank gloo mesh is bit for bit the
  unsharded step; on 4 gloo ranks (2, 2), in the f32 tier, the loss and grad
  norm agree within F32_RTOL, the AdamW moments within F32_TOL of each
  leaf's largest value, and the parameters within F32_TOL where the
  update's sign is settled, elsewhere within 2 lr
  (``tests/test_torch_train.py``'s rules for AdamW steps).
"""
import os
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as rconfigs  # noqa: E402
from repro.launch import dryrun as rdryrun  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro.models import shardctx as rshardctx  # noqa: E402
from repro.models import transformer as rt  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.launch import dryrun as pdryrun  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import specs as pspecs  # noqa: E402
from repro_torch.models import shardctx  # noqa: E402
from repro_torch.models.transformer import init_params, make_cache  # noqa: E402
from test_torch_distributed import _run_all  # noqa: E402

TESTS = Path(__file__).resolve().parent
ARCH_IDS = rconfigs.ARCH_IDS
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
F32_RTOL = 1e-5  # the loss and the grad norm, 4 ranks against one
# the AdamW moments and parameters: tests/test_torch_train.py's f32 bound
# (summation order only); rwkv6's embedding moment, a scatter-add summed
# over the ranks in another order, measured 3.1e-5 of its largest value
F32_TOL = 1e-4


def _stubs(sizes: dict):
    """(reference stub, port stub) meshes of these axes and sizes."""
    ref = types.SimpleNamespace(axis_names=tuple(sizes),
                                devices=np.empty(tuple(sizes.values())))
    port = types.SimpleNamespace(mesh_dim_names=tuple(sizes), shape=tuple(sizes.values()))
    return ref, port


def _key(entry):
    return getattr(entry, "key", getattr(entry, "idx", None))


def _ref_flat(tree) -> dict:
    """The reference's spec tree by path tuple."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(_key(p) for p in path): tuple(spec) for path, spec in flat}


def _entry(e):
    return tuple(e) if isinstance(e, list) else e


def _port_flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, node in tree.items()
                for k, v in _port_flat(node, prefix + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, node in enumerate(tree)
                for k, v in _port_flat(node, prefix + (i,)).items()}
    return {} if tree is None else {prefix: tuple(_entry(e) for e in tree)}


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference_without_the_stacked_dim(arch, mesh_name):
    rmesh, pm = _stubs(MESHES[mesh_name])
    rcfg, pcfg = rconfigs.get_config(arch), pconfigs.get_config(arch)
    abstract = jax.eval_shape(lambda: rt.init_params(rcfg, jax.random.PRNGKey(0)))
    want = _ref_flat(rspecs.param_specs(abstract, rmesh))
    model = init_params(pcfg, None, "meta")
    got = pspecs.param_specs(model, pm)
    assert len(got) == sum(
        abstract_leaf.shape[0] if path[0] == "groups" else 1
        for path, abstract_leaf in _flat_abstract(abstract).items())
    for name, spec in got.items():
        keys = [int(k) if k.isdigit() else k for k in name.split(".")]
        if keys[0] == "groups":  # groups.g.j.rest <- groups.j.rest, stacked
            ref = want[("groups", keys[2], *keys[3:])]
            assert ref[0] is None, name
            ref = ref[1:]
        else:
            ref = want[tuple(keys)]
        assert tuple(spec) == ref, name
    # the optimizer's moments mirror them, and dropping "data" agrees
    assert pspecs.opt_specs({"m": 0, "v": 0}, got) == {"m": got, "v": got}
    dropped = _ref_flat(rspecs.drop_axis_specs(rspecs.param_specs(abstract, rmesh), "data"))
    for name, spec in pspecs.drop_axis_specs(got, "data").items():
        keys = [int(k) if k.isdigit() else k for k in name.split(".")]
        ref = (dropped[("groups", keys[2], *keys[3:])][1:] if keys[0] == "groups"
               else dropped[tuple(keys)])
        assert tuple(spec) == ref, name


def _flat_abstract(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(_key(p) for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_batch_and_drop_specs_equal_the_reference(arch, mesh_name):
    rmesh, pm = _stubs(MESHES[mesh_name])
    multi = mesh_name == "multi"
    rcfg, pcfg = rconfigs.get_config(arch), pconfigs.get_config(arch)
    for shape_name in ("train_4k", "prefill_32k"):
        shape = rconfigs.SHAPES[shape_name]
        want = _ref_flat(rspecs.batch_specs(rdryrun.abstract_batch(rcfg, shape), rmesh, multi))
        got = _port_flat(pspecs.batch_specs(pdryrun.abstract_batch(pcfg, shape), pm, multi))
        assert got == want, shape_name
    if rconfigs.cell_is_skipped(arch, "decode_32k"):
        return
    shape = rconfigs.SHAPES["decode_32k"]
    rcache = jax.eval_shape(lambda: rt.make_cache(rcfg, shape.global_batch, shape.seq_len))
    want = _ref_flat(rspecs.cache_specs(rcache, rmesh, multi))
    pcache = make_cache(pcfg, shape.global_batch, shape.seq_len, device="meta")
    got = _port_flat(pspecs.cache_specs(pcache, pm, multi))
    assert got == want
    assert _port_flat(pspecs.drop_axis_specs(pspecs.cache_specs(pcache, pm, multi), "data")) \
        == _ref_flat(rspecs.drop_axis_specs(rspecs.cache_specs(rcache, rmesh, multi), "data"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_variant_head_padding_equals_the_reference(arch):
    want = rdryrun._pad_heads(rconfigs.get_config(arch), 16)
    got = pdryrun._pad_heads(pconfigs.get_config(arch), 16)
    for f in ("n_heads", "n_kv", "head_dim", "d_model", "n_layers"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.hd == want.hd


def test_mesh_constants_are_the_h100s_and_dp_axes_the_reference():
    assert (pmesh.PEAK_FLOPS_BF16, pmesh.HBM_BW, pmesh.ICI_BW) == (989e12, 3.35e12, 50e9)
    for multi in (False, True):
        from repro.launch.mesh import dp_axes

        assert pmesh.dp_axes(multi) == dp_axes(multi)


def test_placements_map_specs_to_shards_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    _, pm = _stubs(MESHES["multi"])
    assert shardctx.placements(pspecs.P(("pod", "data"), "model"), pm) == (
        Shard(0), Shard(0), Shard(1))
    assert shardctx.placements(pspecs.P(None, "data"), pm) == (
        Replicate(), Shard(1), Replicate())
    assert pspecs.to_shardings({"w": pspecs.P("model", None)}, pm)["w"] == (
        pm, (Replicate(), Replicate(), Shard(0)))


# ------------------------------------------------------------------ constrain
SPECS = [(shardctx.DP, None, None), (shardctx.DP, None, "model"), ("model", "data"),
         (None, ("pod", "data")), (shardctx.DP,)]
SHAPES = [(32, 7, 48), (3, 16, 64), (16, 16, 2), (5, 64, 4)]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_constrain_resolves_specs_as_the_reference(mesh_name, monkeypatch):
    rmesh, pm = _stubs(MESHES[mesh_name])
    dp = pmesh.dp_axes(mesh_name == "multi")
    monkeypatch.setattr(rshardctx, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, sh: sh)
    for shape in SHAPES:
        for spec in SPECS:
            if "pod" in str(spec) and mesh_name != "multi":
                continue
            spec = spec[:len(shape)]
            with rshardctx.ctx(rmesh, dp):
                want = rshardctx.constrain(np.empty(shape), *spec)
            got = shardctx.resolve(shape, spec, pm, dp)
            assert tuple(_entry(e) for e in got) == tuple(want), (shape, spec)


def test_constrain_without_a_context_returns_its_argument(one_rank):
    x = torch.ones(4, 3)
    assert shardctx.constrain(x, shardctx.DP, None) is x
    mesh = one_rank.make_mesh((1, 1), ("data", "model"), "cpu")
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    assert shardctx.constrain(d, shardctx.DP, "model") is d
    with shardctx.ctx(mesh, ("data",)):
        assert shardctx.constrain(x, shardctx.DP, None) is x  # plain stays plain
        got = shardctx.constrain(d, shardctx.DP, "model")
        assert tuple(got.placements) == (Shard(0), Shard(1))
        assert torch.equal(got.full_tensor(), x)


def test_host_mesh_is_one_axis_over_the_world(one_rank):
    import torch.distributed as dist

    mesh = pmesh.make_host_mesh(device="cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert tuple(mesh.mesh_dim_names) == ("data",) and tuple(mesh.shape) == (1,)
    assert tuple(pmesh.make_host_mesh(1, "model", "cpu").mesh_dim_names) == ("model",)


@pytest.fixture
def one_rank():
    import torch.distributed as dist

    from repro_torch.core import distributed as PD

    assert not dist.is_initialized()
    torch.set_num_threads(1)
    yield PD
    PD.teardown()
    assert not dist.is_initialized()


# ------------------------------------------------------------------ placements
PLACEMENT_CASES = {
    "2x4": ((2, 4), ("data", "model"), [((8, 12), ("data", "model")),
                                        ((16, 3), (("data", "model"), None))]),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model"), [((8, 6), (("pod", "data"), "model")),
                                                    ((4, 3, 2), ("model", None, "data"))]),
}

REF_PLACEMENTS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
sys.path.insert(0, sys.argv[1])
from test_torch_sharding import PLACEMENT_CASES
out = {}
for name, (shape, axes, cases) in PLACEMENT_CASES.items():
    mesh = make_mesh(shape, axes)
    coords = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
    for i, (tshape, spec) in enumerate(cases):
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tshape)
        for dev, sl in idx.items():
            rank = int(np.ravel_multi_index(coords[dev.id], shape))
            out[f"{name}_{i}_{rank}"] = np.array(
                [[s.start or 0, tshape[d] if s.stop is None else s.stop]
                 for d, s in enumerate(sl)])
np.savez(os.path.join(sys.argv[2], "ref.npz"), **out)
"""

PORT_PLACEMENTS = r"""
import datetime, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
torch.set_num_threads(1)
rank, out = int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "rendezvous"),
                        rank=rank, world_size=8, timeout=datetime.timedelta(seconds=60))
from repro_torch.models.shardctx import placements
from test_torch_sharding import PLACEMENT_CASES
got = {}
for name, (shape, axes, cases) in PLACEMENT_CASES.items():
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    for i, (tshape, spec) in enumerate(cases):
        full = torch.arange(int(np.prod(tshape)), dtype=torch.float32).reshape(tshape)
        got[f"{name}_{i}"] = distribute_tensor(full, mesh, placements(spec, mesh)).to_local().numpy()
np.savez(os.path.join(out, f"rank{rank}.npz"), **got)
dist.barrier()
dist.destroy_process_group()
"""


def test_local_shards_are_the_reference_devices_blocks():
    with tempfile.TemporaryDirectory(prefix="coconut-placements-") as d:
        _run_all([[REF_PLACEMENTS, str(TESTS), d]], "the reference's placements")
        _run_all([[PORT_PLACEMENTS, str(TESTS), str(r), d] for r in range(8)],
                 "the port's 8-rank placements")
        with np.load(os.path.join(d, "ref.npz")) as f:
            ref = dict(f)
        ranks = []
        for r in range(8):
            with np.load(os.path.join(d, f"rank{r}.npz")) as f:
                ranks.append(dict(f))
    for name, (_, _, cases) in PLACEMENT_CASES.items():
        for i, (tshape, _) in enumerate(cases):
            full = np.arange(int(np.prod(tshape)), dtype=np.float32).reshape(tshape)
            for r in range(8):
                block = full[tuple(slice(a, b) for a, b in ref[f"{name}_{i}_{r}"])]
                np.testing.assert_array_equal(ranks[r][f"{name}_{i}"], block,
                                              err_msg=f"{name} case {i} rank {r}")


# ------------------------------------------------------------------ train steps
def two_steps(arch, mesh=None, f32=False):
    """Two smoke train steps (grad_accum 2, remat) from one seed's weights,
    unsharded or with parameters, AdamW state and batch ``DTensor``s placed
    by the specs on ``mesh`` under the ``opt`` variant's ZeRO-1 hooks.
    Returns (metrics, {name: whole tensor} of parameters and states)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models.steps import TrainConfig, make_train_step
    from repro_torch.train.optimizer import AdamW, AdamWConfig

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    cfg = pconfigs.get_config(arch, smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    if f32:
        model.float()
    opt = AdamW(AdamWConfig(learning_rate=1e-3, warmup_steps=2, total_steps=4))
    hooks = (None, None)
    if mesh is not None:
        ps = pspecs.param_specs(model, mesh)
        pspecs.distribute_model(model, ps, mesh)
        hooks = pspecs.zero1_hooks(model, ps, mesh)
    state = opt.init(model)
    step = make_train_step(cfg, TrainConfig(grad_accum=2, remat=True), opt, *hooks)
    pipe = TokenPipeline(PipelineConfig(global_batch=4, seq_len=32, seed=3), cfg)
    metrics = []
    for s in range(2):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch(s).items()}
        if mesh is None:
            model, state, m = step(model, state, batch, s)
        else:
            batch = pspecs.distribute_tree(batch, pspecs.batch_specs(batch, mesh, False), mesh)
            with shardctx.ctx(mesh, ("data",)), implicit_replication(), \
                    pspecs.ReplicateRefused():
                model, state, m = step(model, state, batch, s)
        metrics.append({k: float(whole(v)) for k, v in m.items()})
    leaves = {k: whole(p).float() for k, p in model.named_parameters()}
    leaves.update({f"{k}.{n}": whole(t) for k, tree in state.items() for n, t in tree.items()})
    return metrics, leaves


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-3b"])
def test_sharded_step_on_one_rank_is_bitwise_the_unsharded(arch, one_rank):
    want = two_steps(arch)
    mesh = one_rank.make_mesh((1, 1), ("data", "model"), "cpu")
    got = two_steps(arch, mesh)
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    for name, t in want[1].items():
        assert torch.equal(got[1][name], t), name


RANK_STEPS = r"""
import datetime, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, arch, out = int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "rendezvous"),
                        rank=rank, world_size=4, timeout=datetime.timedelta(seconds=60))
from repro_torch.models import attention, common, transformer
for m in (attention, common, transformer):
    for name in ("COMPUTE_DTYPE", "PARAM_DTYPE"):
        if hasattr(m, name):
            setattr(m, name, torch.float32)
from torch.distributed.device_mesh import init_device_mesh
from test_torch_sharding import two_steps
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
metrics, leaves = two_steps(arch, mesh, f32=True)
if rank == 0:
    np.savez(os.path.join(out, "sharded.npz"),
             metrics=np.array([[m["loss"], m["grad_norm"]] for m in metrics]),
             **{k: v.numpy() for k, v in leaves.items()})
dist.barrier()
dist.destroy_process_group()
"""


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-3b"])
def test_sharded_step_on_four_ranks_agrees_in_f32(arch, monkeypatch):
    from repro_torch.models import attention, common, transformer

    for m in (attention, common, transformer):
        for name in ("COMPUTE_DTYPE", "PARAM_DTYPE"):
            if hasattr(m, name):
                monkeypatch.setattr(m, name, torch.float32)
    metrics, want = two_steps(arch, f32=True)
    with tempfile.TemporaryDirectory(prefix="coconut-sharded-") as d:
        _run_all([[RANK_STEPS, str(TESTS), str(r), arch, d] for r in range(4)],
                 f"the sharded {arch} step on 4 ranks")
        with np.load(os.path.join(d, "sharded.npz")) as f:
            got = dict(f)
    np.testing.assert_allclose(got["metrics"],
                               [[m["loss"], m["grad_norm"]] for m in metrics], rtol=F32_RTOL)
    lr = 1e-3
    for name, w in want.items():
        w, g = w.numpy(), got[name]
        if name.startswith(("m.", "v.")):  # gradient statistics: summation order only
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= F32_TOL * scale, name
            continue
        # a parameter: where its first moment is settled (beyond 1e-3 of its
        # leaf's largest) the update's sign is too; elsewhere AdamW moves a
        # weight by about lr sign(g), a sign inside the summation noise
        m = want[f"m.{name}"].numpy()
        settled = np.abs(m) > 1e-3 * max(float(np.abs(m).max()), 1e-30)
        err = np.abs(g - w)
        assert float(err[settled].max(initial=0.0)) <= F32_TOL, name
        assert float(err.max(initial=0.0)) <= 2 * lr, name

