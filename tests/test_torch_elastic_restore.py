"""Elastic checkpoint restore on the port (``repro_torch.train.checkpoint``
with ``shardings``), the counterpart of ``tests/test_elastic_restore.py``:
save under one mesh shape, restore under another (scale up), compute.

A 64 x 64 f32 leaf sharded ("data", "model") on a (2, 2) mesh of 4 gloo
ranks is saved (every rank gathers it, rank 0 writes), then restored on 8
gloo ranks as (8,) sharded ("data", None): the values bit for bit, each
rank's shard its 8 rows, a matmul on the restored ``DTensor`` finite. The
same 8 ranks restore, bit for bit, a checkpoint that the reference saved
under its 2 x 2 mesh of 4 forced host devices. Every run is a set of
processes of its own (``tests/test_torch_distributed.py``'s ``_run_all``).
"""
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest

from test_torch_distributed import _run_all

TESTS = Path(__file__).resolve().parent

SAVE = r"""
import datetime, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
torch.set_num_threads(1)
rank, out = int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "rendezvous-a"),
                        rank=rank, world_size=4, timeout=datetime.timedelta(seconds=60))
from repro_torch.launch.specs import P
from repro_torch.models.shardctx import placements
from repro_torch.train import checkpoint as ckpt
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
w = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)
w_a = distribute_tensor(w, mesh, placements(P("data", "model"), mesh))
assert w_a.to_local().shape == (32, 32)
ckpt.save(os.path.join(out, "port"), 7, {"w": w_a})
dist.barrier()
dist.destroy_process_group()
"""

RESTORE = r"""
import datetime, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
torch.set_num_threads(1)
rank, out = int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "rendezvous-b"),
                        rank=rank, world_size=8, timeout=datetime.timedelta(seconds=60))
from repro_torch.launch.specs import P, to_shardings
from repro_torch.train import checkpoint as ckpt
mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
like = {"w": torch.empty((64, 64), dtype=torch.float32, device="meta")}
shardings = to_shardings({"w": P("data", None)}, mesh)
got = {}
for name in ("port", "reference"):
    restored, _ = ckpt.restore(os.path.join(out, name), 7, like, shardings=shardings)
    w = restored["w"]
    assert isinstance(w, DTensor) and w.device_mesh.size() == 8
    full = w.full_tensor()
    prod = (w @ w.T).sum().full_tensor()
    got[f"{name}_local"] = w.to_local().numpy()
    got[f"{name}_full"] = full.numpy()
    got[f"{name}_matmul"] = prod.numpy()
np.savez(os.path.join(out, f"rank{rank}.npz"), **got)
dist.barrier()
dist.destroy_process_group()
"""

REFERENCE_SAVE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
from repro.train import checkpoint as ckpt
mesh = make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
w = jnp.arange(64 * 64, dtype=jnp.float32).reshape(64, 64)
ckpt.save(os.path.join(sys.argv[1], "reference"), 7,
          {"w": jax.device_put(w, NamedSharding(mesh, P("data", "model")))})
"""


@pytest.fixture(scope="module")
def restored():
    pytest.importorskip("jax")
    with tempfile.TemporaryDirectory(prefix="coconut-elastic-") as d:
        _run_all([[REFERENCE_SAVE, d]], "the reference's save")
        _run_all([[SAVE, str(TESTS), str(r), d] for r in range(4)], "the port's 4-rank save")
        files = {p.name: p.read_bytes() for p in (Path(d) / "port" / "step_00000007").iterdir()}
        ref_files = {p.name: p.read_bytes()
                     for p in (Path(d) / "reference" / "step_00000007").iterdir()}
        _run_all([[RESTORE, str(TESTS), str(r), d] for r in range(8)],
                 "the port's 8-rank restore")
        ranks = []
        for r in range(8):
            with np.load(os.path.join(d, f"rank{r}.npz")) as f:
                ranks.append(dict(f))
    return ranks, files, ref_files


W = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)


@pytest.mark.parametrize("saved_by", ["port", "reference"])
def test_restore_onto_another_mesh_is_bitwise(restored, saved_by):
    ranks, _, _ = restored
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"{saved_by}_full"], W)
        np.testing.assert_array_equal(got[f"{saved_by}_local"], W[8 * r:8 * (r + 1)],
                                      err_msg=f"rank {r}: not its 8 rows")


@pytest.mark.parametrize("saved_by", ["port", "reference"])
def test_restored_leaf_computes_under_the_new_mesh(restored, saved_by):
    ranks, _, _ = restored
    want = float((W.astype(np.float64) @ W.T.astype(np.float64)).sum())
    for got in ranks:
        value = float(got[f"{saved_by}_matmul"])
        assert np.isfinite(value) and abs(value - want) <= 1e-5 * abs(want)


def test_sharded_save_writes_the_reference_layout(restored):
    _, files, ref_files = restored
    assert sorted(files) == sorted(ref_files) == ["manifest.json", "w.npy"]
    assert files["w.npy"] == ref_files["w.npy"]  # the leaf byte for byte
    port, ref = json.loads(files["manifest.json"]), json.loads(ref_files["manifest.json"])
    assert port["leaves"] == ref["leaves"] and port["step"] == ref["step"] == 7
    assert port["n_devices"] == 4  # the world that saved it
