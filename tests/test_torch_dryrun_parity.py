"""The port's dry run against the reference's, cell for cell.

The reference lowers a cell under GSPMD (``python -m repro.launch.dryrun``,
run here in a subprocess on the CPU); the port traces it on fake tensors
under ``DTensor`` with the placements the reference's lowering gives: a
sequence-sharded KV cache read context-parallel and written in the one
shard that owns the slot, FSDP weights gathered where they are used,
vocab-parallel embedding and loss (``python -m repro_torch.launch.dryrun
--device cpu``). Counts, per device:

* ``decode_32k`` on (16, 16): the arguments are the reference's (less its
  4-byte int32 ``pos``, a Python int in the port); the collective bytes
  within 2x of the reference's either way, with the same number of
  all-gathers and all-reduces; the memory at most 2x the reference's. The
  reference's memory is larger by XLA-CPU temporaries of the whole cache
  (f32 copies of the two stacked bf16 caches and their stacking copies,
  `PERF.md` §5), which the port's in-place bf16 write does not make, so
  the memory is held from above only.
* The port's count is the same in two runs (two processes): the ops
  ``DTensor`` runs to plan an op, on global-shape stand-ins and cached per
  process, are not counted, and the collector does not run mid-trace.
* The context-parallel decode attention and cache write against the
  unsharded decode: bit for bit on a one-rank group (the whole smoke
  model's decode step), and on 4 gloo ranks within a bound derived from
  the changed summation order.
* ``train_4k`` (marked ``slow``): all-reduce bytes at most 2x the
  reference's. ``prefill_32k`` traces for over ten minutes on a CPU host
  and is compared by ``scripts/dryrun_parity.py`` (``PERF.md``), not here.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import _run_all

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
ARCH = "smollm-360m"
POS_SCALAR = 4  # the reference's int32 scalar argument (cache["pos"], step)
TIMEOUT = 900


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def _dryruns(shapes: str, out: Path, n_port: int = 1) -> tuple:
    """The reference's cells and ``n_port`` runs of the port's, each in a
    process of its own, all at once; returns (reference, [port, ...]) as
    {shape: result}."""
    cmds = [[sys.executable, "-m", "repro.launch.dryrun", "--arch", ARCH, "--shape",
             shapes, "--mesh", "single", "--out", str(out / "ref")]]
    cmds += [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
              "--shape", shapes, "--mesh", "single", "--device", "cpu",
              "--out", str(out / f"port{i}")] for i in range(n_port)]
    procs = [subprocess.Popen(c, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    def load(d):
        return {s: json.loads((out / d / f"{ARCH}__{s}__single.json").read_text())
                for s in shapes.split(",")}

    return load("ref"), [load(f"port{i}") for i in range(n_port)]


def _coll(res: dict, kind: str) -> float:
    return res["collectives"].get(kind, {}).get("bytes", 0.0)


@pytest.fixture(scope="module")
def decode_cells():
    with tempfile.TemporaryDirectory(prefix="coconut-parity-") as d:
        ref, ports = _dryruns("decode_32k", Path(d), n_port=2)
    return ref["decode_32k"], [p["decode_32k"] for p in ports]


def test_decode_32k_arguments_are_the_reference_s(decode_cells):
    ref, (port, _) = decode_cells
    assert port["mem_per_device"]["args_bytes"] + POS_SCALAR == \
        ref["mem_per_device"]["args_bytes"]


def test_decode_32k_collectives_within_2x_of_the_reference(decode_cells):
    ref, (port, _) = decode_cells
    ratio = port["collective_bytes_per_device"] / ref["collective_bytes_per_device"]
    assert 0.5 <= ratio <= 2.0, (port["collectives"], ref["collectives"])
    # the same layout: one all-gather per FSDP weight a layer, the same
    # all-reduces (the cache is never gathered)
    for kind in ("all-gather", "all-reduce"):
        assert port["collectives"][kind]["count"] == ref["collectives"][kind]["count"]


def test_decode_32k_memory_at_most_2x_the_reference(decode_cells):
    ref, (port, _) = decode_cells
    mem = port["mem_per_device"]
    assert mem["total_gb"] <= 2.0 * ref["mem_per_device"]["total_gb"]
    assert mem["total_gb"] * 1e9 >= mem["args_bytes"]


def test_decode_32k_counts_are_the_same_run_to_run(decode_cells):
    _, (a, b) = decode_cells
    assert a["mem_per_device"] == b["mem_per_device"]
    assert a["collectives"] == b["collectives"]
    assert a["cost_per_device"] == b["cost_per_device"]


@pytest.mark.slow
def test_train_4k_all_reduce_within_2x_of_the_reference():
    """train_4k (about 2 minutes here): all-reduce bytes and memory at most
    2x the reference's, the same number of all-gathers (one an FSDP weight a
    layer, forward and recompute)."""
    with tempfile.TemporaryDirectory(prefix="coconut-parity-") as d:
        ref, (port,) = _dryruns("train_4k", Path(d))
    r, p = ref["train_4k"], port["train_4k"]
    assert _coll(p, "all-reduce") <= 2.0 * _coll(r, "all-reduce")
    assert p["collectives"]["all-gather"]["count"] == r["collectives"]["all-gather"]["count"]
    assert r["mem_per_device"]["args_bytes"] - p["mem_per_device"]["args_bytes"] == POS_SCALAR
    assert p["mem_per_device"]["total_gb"] <= 2.0 * r["mem_per_device"]["total_gb"]


# ---------------------------------------------------------------------------
# the context-parallel decode attention and cache write
# ---------------------------------------------------------------------------
B, S, KV, G, HD, W = 2, 64, 2, 3, 16, 32
POS = 37  # slot 36: the third of four 16-slot shards
RING_POS = 45  # ring slot 12 of 32: the second of four 8-slot shards


def _inputs():
    rng = np.random.default_rng(26)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return {"q": f(B, 1, KV * G, HD), "k": f(B, 1, KV, HD), "v": f(B, 1, KV, HD),
            "kc": f(B, S, KV, HD), "vc": f(B, S, KV, HD),
            "kr": f(B, W, KV, HD), "vr": f(B, W, KV, HD)}


def _plain(x):
    """The unsharded decode: today's write and attention."""
    from repro_torch.models.attention import decode_attention, decode_sliding_attention

    kc, vc, kr, vr = (x[n].clone() for n in ("kc", "vc", "kr", "vr"))
    kc[:, POS - 1] = x["k"][:, 0]
    vc[:, POS - 1] = x["v"][:, 0]
    slot = (RING_POS - 1) % W
    kr[:, slot] = x["k"][:, 0]
    vr[:, slot] = x["v"][:, 0]
    return {"o": decode_attention(x["q"], kc, vc, POS),
            "o_ring": decode_sliding_attention(x["q"], kr, vr, RING_POS, W),
            "kc": kc, "vc": vc, "kr": kr, "vr": vr}


def _split(x, mesh):
    """The same on ``mesh`` ("data", "model"): caches and rings split over
    "model" along their slots, batch over "data", under a context."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import specs
    from repro_torch.models import shardctx
    from repro_torch.models.attention import decode_attention, decode_sliding_attention

    cache_pl = [Shard(0), Shard(1)]
    rep = [Replicate(), Replicate()]
    d = {n: distribute_tensor(x[n].clone(), mesh, cache_pl) for n in ("kc", "vc", "kr", "vr")}
    q, k, v = (distribute_tensor(x[n], mesh, rep) for n in ("q", "k", "v"))
    with shardctx.ctx(mesh, ("data",)), implicit_replication(), specs.ReplicateRefused():
        assert shardctx.split(d["kc"], 1) == (mesh.size(1) > 1)
        if mesh.size(1) > 1:
            shardctx.write_slot(d["kc"], 1, POS - 1, k)
            shardctx.write_slot(d["vc"], 1, POS - 1, v)
            shardctx.write_slot(d["kr"], 1, (RING_POS - 1) % W, k)
            shardctx.write_slot(d["vr"], 1, (RING_POS - 1) % W, v)
        else:  # the transformer's own branch on an unsplit cache
            d["kc"][:, POS - 1] = k[:, 0]
            d["vc"][:, POS - 1] = v[:, 0]
            d["kr"][:, (RING_POS - 1) % W] = k[:, 0]
            d["vr"][:, (RING_POS - 1) % W] = v[:, 0]
        o = decode_attention(q, d["kc"], d["vc"], POS)
        o_ring = decode_sliding_attention(q, d["kr"], d["vr"], RING_POS, W)
    out = {"o": o, "o_ring": o_ring, **d}
    return {n: t.full_tensor() for n, t in out.items()}


def test_split_decode_on_one_rank_is_bitwise_the_unsharded(monkeypatch):
    """A one-rank (1, 1) mesh: the attention and the writes run on
    ``DTensor``s, bit for bit the plain decode; and the smoke model's whole
    decode step, parameters and cache placed by the specs, bit for bit."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as PD
    from repro_torch.launch import specs
    from repro_torch.models import shardctx
    from repro_torch.models.attention import COMPUTE_DTYPE
    from repro_torch.models.transformer import decode_step, init_params, make_cache, prefill
    from torch.distributed.tensor.experimental import implicit_replication

    assert not dist.is_initialized()
    torch.set_num_threads(1)
    try:
        mesh = PD.make_mesh((1, 1), ("data", "model"), "cpu")
        x = {n: t.to(COMPUTE_DTYPE) for n, t in _inputs().items()}
        want, got = _plain(x), _split(x, mesh)
        for name, t in want.items():
            assert torch.equal(got[name], t), name

        cfg = get_config(ARCH, smoke=True)
        model = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        tokens = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab, (2, 8)).astype(np.int64))
        _, cache = prefill(model, cfg, {"tokens": tokens}, cache_len=16)
        nxt = tokens[:, -1:]
        want_logits, want_cache = decode_step(model, cfg, _clone(cache), nxt)
        ps = specs.param_specs(model, mesh)
        specs.distribute_model(model, ps, mesh)
        # serving runs under inference mode, whose views of a DTensor made
        # outside it fail: the placed cache is made inside it
        with torch.inference_mode():
            dcache = specs.distribute_tree(_clone(cache), specs.cache_specs(cache, mesh, False),
                                           mesh)
            token = specs.distribute_tree(nxt, specs.batch_specs(nxt, mesh, False), mesh)
            with shardctx.ctx(mesh, ("data",)), implicit_replication(), \
                    specs.ReplicateRefused():
                logits, dcache = decode_step(model, cfg, dcache, token)
        assert torch.equal(logits.full_tensor(), want_logits)
        for j, entry in enumerate(want_cache["groups"]):
            for key, t in entry.items():
                assert torch.equal(dcache["groups"][j][key].full_tensor(), t), (j, key)
    finally:
        PD.teardown()


def _clone(cache):
    if isinstance(cache, dict):
        return {k: _clone(v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_clone(v) for v in cache]
    return cache.clone() if isinstance(cache, torch.Tensor) else cache


RANK_SPLIT = r"""
import datetime, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, out = int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "rendezvous"),
                        rank=rank, world_size=4, timeout=datetime.timedelta(seconds=60))
from repro_torch.models import attention
attention.COMPUTE_DTYPE = torch.float32
from torch.distributed.device_mesh import init_device_mesh
from test_torch_dryrun_parity import _inputs, _split
mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
got = _split(_inputs(), mesh)
if rank == 0:
    np.savez(os.path.join(out, "split.npz"), **{k: v.numpy() for k, v in got.items()})
dist.barrier()
dist.destroy_process_group()
"""


def test_split_decode_on_four_ranks_within_the_summation_bound(monkeypatch):
    """(1, 4) gloo mesh, f32: the writes land bit for bit; the attention
    outputs agree within the bound of the changed summation order. Both
    sides sum the same S (or W) terms p_j v_j (and the softmax's S terms)
    in f32, in different orders: each sum is within (S + 2) u sum|p_j v_j|
    <= (S + 2) u max|v| of the exact one (u = 2^-24; the exp's and the
    final division's roundings add 2u), so the two differ by at most
    2 (S + 4) u max|v|."""
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "COMPUTE_DTYPE", torch.float32)
    x = _inputs()
    want = _plain(x)
    with tempfile.TemporaryDirectory(prefix="coconut-split-") as d:
        _run_all([[RANK_SPLIT, str(TESTS), str(r), d] for r in range(4)],
                 "the split decode on 4 ranks")
        with np.load(os.path.join(d, "split.npz")) as f:
            got = dict(f)
    for name in ("kc", "vc", "kr", "vr"):
        np.testing.assert_array_equal(got[name], want[name].numpy(), err_msg=name)
    u = 2.0 ** -24
    for name, n, vmax in (("o", S, float(want["vc"].abs().max())),
                          ("o_ring", W, float(want["vr"].abs().max()))):
        err = float(np.abs(got[name] - want[name].numpy()).max())
        assert err <= 2 * (n + 4) * u * vmax, (name, err)
