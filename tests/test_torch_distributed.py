"""The port's mesh and distributed module against the reference's.

The reference runs its four ``tests/test_mesh_batch.py`` sections, its
sample-sort build (an overflowing case included) and its prune-then-verify
query on 8 forced host devices, in a subprocess of its own (jax pins the
device count at first init), and saves what it answered. The port runs the
same sections on the same numpy inputs twice: on 8 gloo ranks, each a
process of its own meeting the others through a file rendezvous (the
default batch mesh is then (2, 4), the build mesh 1-D over 8), and on one
rank inside the test process, whose one-rank group is torn down after. Each
8-rank run and each reference run is one subprocess set with a timeout, and
a rank that fails ends the others at once.

What must hold: the port's ``shard="mesh"`` answers equal, bit for bit, the
port's single-device answers and the reference's mesh answers, with the
reference's stats; the build's shards equal the reference's shard for
shard (the reference's ``lax.sort`` keeps equal keys in arrival order on
the CPU, so ids compare bit for bit too); the query equals the
reference's within rtol 1e-4 (its distances are summed in another order),
its ids pointing at series of those distances.
"""
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
RANKS = 8
TIMEOUT = 300  # seconds for one multi-process run, start to end
SECTIONS = ("ctree", "window", "adversarial", "composed")
BUILD_SLACK = {"slack3": 3.0, "overflow": 0.75}
BUDGETS = (2048, 64)
N_BUILD = 8 * 256


# ---------------------------------------------------------------------------
# the inputs, the same numpy arrays for both packages
# ---------------------------------------------------------------------------
def _walks(rng, n, d=64):
    return rng.standard_normal((n, d)).astype(np.float32).cumsum(axis=1)


def inputs() -> dict:
    rng = np.random.default_rng(0)
    out = {"ctree_X": _walks(rng, 3000), "ctree_Q": _walks(rng, 13)}
    out["window_X"] = [_walks(rng, 300) for _ in range(10)]
    out["window_Q"] = _walks(rng, 7)
    Xa = (3000.0 + 0.01 * rng.standard_normal((3000, 64))).astype(np.float32)
    out["adversarial_X"] = Xa
    out["adversarial_Q"] = Xa[rng.integers(0, 3000, 9)] + 0.001 * rng.standard_normal(
        (9, 64)).astype(np.float32)
    out["build_X"] = _walks(rng, N_BUILD)
    out["composed_Q"] = _walks(rng, 5)
    out["query_Q"] = _walks(rng, 3)
    return out


def _answers(pkg, dist_mod, rerank, mesh_of, build_mesh, kw) -> dict:
    """Every section, as ``pkg`` answers it; ``kw`` carries the port's
    ``device="cpu"``. Returns numpy arrays by name."""
    inp = inputs()
    cfg = pkg.SummarizationConfig(series_len=64, n_segments=8, card_bits=6)
    out = {}

    def both(name, ask):
        for mode, shard in (("single", None), ("mesh", "mesh")):
            v, g, st = ask(shard)
            out[f"{name}_{mode}_d2"], out[f"{name}_{mode}_ids"] = v, g
            out[f"{name}_{mode}_stats"] = np.array(
                [st.blocks_pruned, st.blocks_visited, st.entries_pruned,
                 st.entries_verified])

    for name in ("ctree", "adversarial"):
        X, Q = inp[f"{name}_X"], inp[f"{name}_Q"]
        raw = pkg.RawStore(64, **kw)
        ct = pkg.CTree(pkg.CTreeConfig(summarization=cfg, block_size=256,
                                       materialized=True, **kw))
        ct.bulk_build(X, raw.append(X))
        both(name, lambda shard: ct.knn_batch(Q, k=5, raw=raw, shard=shard))
    idx = pkg.StreamingIndex(pkg.StreamConfig(
        scheme="BTP", summarization=cfg, buffer_entries=512, growth_factor=3,
        block_size=128, **kw))
    for b, x in enumerate(inp["window_X"]):
        idx.ingest(x, np.full(300, b, np.int64))
    both("window", lambda shard: idx.window_knn_batch(inp["window_Q"], 2, 8, k=4,
                                                      shard=shard))
    out["batch_mesh_shape"] = np.array(mesh_of())

    scfg = pkg.SummarizationConfig(series_len=64, n_segments=8, card_bits=8)
    X = inp["build_X"]
    ids = np.arange(N_BUILD, dtype=np.int32)
    for case, slack in BUILD_SLACK.items():
        dcfg = dist_mod.DistBuildConfig(summarization=scfg, capacity_slack=slack)
        built = dist_mod.make_build_fn(build_mesh, ("data",), dcfg)(X, ids)
        for key, val in built.items():
            out[f"build_{case}_{key}"] = np.asarray(val)
        if case == "slack3":
            series, gids = dist_mod.valid_entries(built)
            Qd = inp["composed_Q"]
            _, rows = dist_mod.mesh_topk_candidates(Qd, series, 5 + 8, **kw)
            nv, nrows = rerank(Qd, series, rows, 5)
            out["composed_mesh_d2"], out["composed_mesh_ids"] = nv, gids[nrows]
            for v in BUDGETS:
                d2, qids = dist_mod.make_query_fn(build_mesh, ("data",), dcfg, k=5,
                                                  verify_budget=v)(built, inp["query_Q"])
                out[f"query_{v}_d2"], out[f"query_{v}_ids"] = np.asarray(d2), np.asarray(qids)
    return {k: np.asarray(v) for k, v in out.items()}


def port_answers() -> dict:
    """The port's answers on this process's group (or a one-rank group
    made for the call, on the CPU)."""
    import torch.distributed as dist

    import repro_torch.core as P
    from repro_torch.core import distributed as PD
    from repro_torch.core.host_screen import rerank_slate

    world = dist.get_world_size() if dist.is_initialized() else 1
    build_mesh = PD.make_mesh((world,), ("data",), "cpu")
    mesh = lambda: tuple(PD.default_batch_mesh("cpu").mesh.shape)  # noqa: E731
    return _answers(P, PD, rerank_slate, mesh, build_mesh, {"device": "cpu"})


def reference_answers(devices: int) -> dict:
    """The reference's answers on the first ``devices`` forced host devices
    (run under ``--xla_force_host_platform_device_count=8``)."""
    import jax
    import jax.numpy as jnp

    import repro.core as R
    from repro.compat import make_mesh
    from repro.core import distributed as RD
    from repro.core.execute import _rerank_slate

    batch_mesh = RD.default_batch_mesh() if devices == RANKS else make_mesh(
        (1, 1), ("q", "r"), devices=jax.devices()[:1])

    class Dist:  # the reference's module with jnp inputs and this mesh
        DistBuildConfig = RD.DistBuildConfig
        valid_entries = staticmethod(RD.valid_entries)

        @staticmethod
        def make_build_fn(mesh, axes, cfg):
            fn = RD.make_build_fn(mesh, axes, cfg)
            return lambda X, ids: fn(jnp.asarray(X), jnp.asarray(ids))

        @staticmethod
        def make_query_fn(mesh, axes, cfg, **kw):
            fn = RD.make_query_fn(mesh, axes, cfg, **kw)
            return lambda built, Q: fn(built, jnp.asarray(Q))

        @staticmethod
        def mesh_topk_candidates(Q, X, ksel):
            return RD.mesh_topk_candidates(Q, X, ksel, mesh=batch_mesh)

    class Core:  # knn_batch(shard="mesh") on this mesh
        SummarizationConfig, RawStore, StreamConfig, CTreeConfig = (
            R.SummarizationConfig, R.RawStore, R.StreamConfig, R.CTreeConfig)

        class CTree(R.CTree):
            def knn_batch(self, *a, **kw):
                return super().knn_batch(*a, mesh=batch_mesh, **kw)

        class StreamingIndex(R.StreamingIndex):
            def window_knn_batch(self, *a, **kw):
                return super().window_knn_batch(*a, mesh=batch_mesh, **kw)

    build_mesh = make_mesh((devices,), ("data",), devices=jax.devices()[:devices])
    shape = lambda: tuple(batch_mesh.devices.shape)  # noqa: E731
    return _answers(Core, Dist, _rerank_slate, shape, build_mesh, {})


# ---------------------------------------------------------------------------
# running the packages
# ---------------------------------------------------------------------------
REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import numpy as np
from test_torch_distributed import reference_answers
for devices in (8, 1):
    np.savez(os.path.join(sys.argv[2], f"ref{devices}.npz"), **reference_answers(devices))
"""

RANK_SCRIPT = r"""
import datetime, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "rendezvous"),
                        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
from test_torch_distributed import port_answers
np.savez(os.path.join(out, f"rank{rank}.npz"), **port_answers())
dist.barrier()
dist.destroy_process_group()
"""


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(TESTS)]),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _run_all(argvs, what):
    """Start one process per argv, wait for all of them within TIMEOUT; on
    the first failure (or the timeout) kill the rest and fail."""
    procs = [subprocess.Popen([sys.executable, "-c", *argv], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for argv in argvs]
    deadline = time.monotonic() + TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                for p in procs:
                    p.kill()
                log = (bad[0] if bad else procs[0]).communicate()[0]
                pytest.fail(f"{what}: {'a process failed' if bad else 'timed out'}:\n"
                            f"{log[-3000:]}")
            time.sleep(0.05)
        for p in procs:
            log = p.communicate()[0]
            if p.returncode != 0:
                pytest.fail(f"{what}: exit {p.returncode}:\n{log[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _load(path):
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def workdir():
    with tempfile.TemporaryDirectory(prefix="coconut-dist-") as d:
        yield Path(d)


@pytest.fixture(scope="module")
def reference(workdir):
    pytest.importorskip("jax")
    _run_all([[REF_SCRIPT, str(TESTS), str(workdir)]], "the reference's 8-device run")
    return {n: _load(workdir / f"ref{n}.npz") for n in (RANKS, 1)}


@pytest.fixture(scope="module")
def port(workdir):
    """The port's answers on 8 gloo ranks (rank 0's, after checking that
    every rank returned the same) and on one in-process rank."""
    import torch.distributed as dist

    from repro_torch.core import distributed as PD

    out = workdir / "ranks"
    out.mkdir()
    _run_all([[RANK_SCRIPT, str(TESTS), str(r), str(RANKS), str(out)]
              for r in range(RANKS)], f"the port's {RANKS}-rank run")
    ranks = [_load(out / f"rank{r}.npz") for r in range(RANKS)]
    for r, got in enumerate(ranks[1:], 1):
        for key, val in ranks[0].items():
            np.testing.assert_array_equal(got[key], val, err_msg=f"rank {r}: {key}")
    assert not dist.is_initialized()
    torch.set_num_threads(1)
    try:
        one = port_answers()
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        PD.teardown()
    assert not dist.is_initialized()  # no group left in the worker
    return {RANKS: ranks[0], 1: one}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
WORLDS = (RANKS, 1)


@pytest.mark.parametrize("world", WORLDS)
def test_default_batch_mesh_splits_queries_by_sqrt_of_the_world(world, port,
                                                                 reference):
    want = (2, 4) if world == RANKS else (1, 1)
    assert tuple(port[world]["batch_mesh_shape"]) == want
    assert tuple(reference[world]["batch_mesh_shape"]) == want


@pytest.mark.parametrize("section", SECTIONS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_answers_equal_single_device_and_reference(world, section, port,
                                                        reference):
    got, ref = port[world], reference[world]
    for part in ("d2", "ids"):
        mesh = got[f"{section}_mesh_{part}"]
        np.testing.assert_array_equal(mesh, ref[f"{section}_mesh_{part}"])
        if section != "composed":
            np.testing.assert_array_equal(mesh, got[f"{section}_single_{part}"])
    inp = inputs()
    if section in ("adversarial", "composed"):  # and the f64 brute force
        X = (inp["adversarial_X"] if section == "adversarial" else inp["build_X"])
        Q = inp[f"{section}_Q"].astype(np.float64)
        bf = np.sort(((X.astype(np.float64)[None] - Q[:, None]) ** 2).sum(-1), axis=1)
        np.testing.assert_allclose(got[f"{section}_mesh_d2"], bf[:, :5], rtol=1e-5)


@pytest.mark.parametrize("section", SECTIONS[:3])
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_stats_equal_reference(world, section, port, reference):
    np.testing.assert_array_equal(port[world][f"{section}_mesh_stats"],
                                  reference[world][f"{section}_mesh_stats"])


@pytest.mark.parametrize("case", sorted(BUILD_SLACK))
@pytest.mark.parametrize("world", WORLDS)
def test_build_shards_equal_reference(world, case, port, reference):
    got, ref = port[world], reference[world]
    pre = f"build_{case}_"
    assert int(got[pre + "overflow"]) == int(ref[pre + "overflow"])
    assert (int(got[pre + "overflow"]) > 0) == (case == "overflow")
    np.testing.assert_array_equal(got[pre + "n_valid"], ref[pre + "n_valid"])
    assert int(got[pre + "n_valid"].sum()) == N_BUILD - int(got[pre + "overflow"])
    for key in ("keys", "invalid", "ids", "sym", "series"):
        mine = np.split(got[pre + key], world)
        theirs = np.split(ref[pre + key].astype(got[pre + key].dtype), world)
        for shard, (a, b) in enumerate(zip(mine, theirs)):
            np.testing.assert_array_equal(a, b, err_msg=f"shard {shard}: {key}")
    inval = got[pre + "invalid"]
    valid = [tuple(r) for r in got[pre + "keys"][inval == 0]]
    assert valid == sorted(valid)  # globally sorted across the shards
    assert (got[pre + "keys"][inval == 1] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("world", WORLDS)
def test_query_equals_reference_within_f32(world, budget, port, reference):
    got, ref = port[world], reference[world]
    d2, ids = got[f"query_{budget}_d2"], got[f"query_{budget}_ids"]
    np.testing.assert_allclose(d2, ref[f"query_{budget}_d2"], rtol=1e-4)
    inp = inputs()
    X, Q = inp["build_X"].astype(np.float64), inp["query_Q"].astype(np.float64)
    via_ids = ((X[ids] - Q[:, None]) ** 2).sum(-1)  # ids point at their d2
    np.testing.assert_allclose(d2, via_ids, rtol=1e-4)
    if budget >= N_BUILD:  # every entry verified: the exact answer
        bf = np.sort(((X[None] - Q[:, None]) ** 2).sum(-1), axis=1)[:, :5]
        np.testing.assert_allclose(d2, bf, rtol=1e-4)


# ---------------------------------------------------------------------------
# one rank in this process: the group, the kernels' wrappers, refusals
# ---------------------------------------------------------------------------
@pytest.fixture
def one_rank():
    import torch.distributed as dist

    from repro_torch.core import distributed as PD

    assert not dist.is_initialized()
    torch.set_num_threads(1)
    yield PD
    PD.teardown()
    assert not dist.is_initialized()


def test_world_size_one_group_is_made_once_and_torn_down(one_rank):
    import torch.distributed as dist

    mesh = one_rank.default_batch_mesh("cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert one_rank.default_batch_mesh("cpu") is mesh
    assert tuple(mesh.mesh_dim_names) == ("q", "r") and tuple(mesh.mesh.shape) == (1, 1)
    one_rank.teardown()
    assert not dist.is_initialized()
    assert one_rank.default_batch_mesh("cpu") is not mesh  # made again


def test_mesh_path_goes_through_the_kernel_wrappers(one_rank, monkeypatch):
    """One topk_ed call per (query shard, runs shard) tile; the build's
    summarize front and the query's paa + one mindist a query."""
    from repro_torch.core import SummarizationConfig
    from repro_torch.kernels import ops

    calls = {n: 0 for n in ("topk_ed", "paa", "sax_and_keys", "mindist")}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    rng = np.random.default_rng(5)
    X, Q = _walks(rng, 512), _walks(rng, 6)
    d2, rows = one_rank.mesh_topk_candidates(Q, X, 13, device="cpu")
    assert calls["topk_ed"] == 1 and d2.shape == rows.shape == (6, 13)
    want = np.argsort(((X[None].astype(np.float64) - Q[:, None]) ** 2).sum(-1),
                      axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(np.sort(rows[:, :5], axis=1), np.sort(want, axis=1))
    cfg = one_rank.DistBuildConfig(SummarizationConfig(64, 8, 8))
    mesh = one_rank.make_mesh((1,), ("data",), "cpu")
    built = one_rank.make_build_fn(mesh, ("data",), cfg)(X, np.arange(512))
    assert calls["paa"] == 1 and calls["sax_and_keys"] == 1
    one_rank.make_query_fn(mesh, ("data",), cfg, k=3)(built, Q)
    assert calls["paa"] == 2 and calls["mindist"] == Q.shape[0]


def test_one_rank_mesh_runs_the_collectives_of_many(one_rank, monkeypatch):
    """A one-rank group takes no shortcut: the screen gathers over the runs
    axis and the query axis, the build gathers its samples, exchanges its
    five payloads with all_to_all_single and sums its overflow, and the
    query gathers its two slates, as on a mesh of many ranks."""
    import torch.distributed as dist

    from repro_torch.core import SummarizationConfig

    calls = {n: 0 for n in ("all_gather", "all_to_all_single", "all_reduce")}
    for name in calls:
        real = getattr(dist, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(dist, name, counted)
    rng = np.random.default_rng(6)
    X, Q = _walks(rng, 256), _walks(rng, 5)
    one_rank.mesh_topk_candidates(Q, X, 7, device="cpu")
    assert calls == {"all_gather": 4, "all_to_all_single": 0, "all_reduce": 0}
    cfg = one_rank.DistBuildConfig(SummarizationConfig(64, 8, 8))
    mesh = one_rank.make_mesh((1,), ("data",), "cpu")
    built = one_rank.make_build_fn(mesh, ("data",), cfg)(X, np.arange(256))
    # the samples, then the six result tensors but overflow
    assert calls == {"all_gather": 4 + 1 + 6, "all_to_all_single": 5, "all_reduce": 1}
    one_rank.make_query_fn(mesh, ("data",), cfg, k=3)(built, Q)
    assert calls == {"all_gather": 11 + 2, "all_to_all_single": 5, "all_reduce": 1}


def test_a_group_of_another_backend_raises(one_rank):
    """A CUDA mesh never goes ahead over a gloo group that exists."""
    import torch.distributed as dist

    one_rank.default_batch_mesh("cpu")
    with pytest.raises(RuntimeError, match="needs a nccl process group, not the gloo"):
        one_rank._ensure_group(torch.device("cuda"))
    assert dist.get_backend() == "gloo"


def test_empty_inputs_return_before_any_collective(one_rank):
    for m, c in ((0, 5), (3, 0)):
        d2, rows = one_rank.mesh_topk_candidates(np.zeros((m, 8), np.float32),
                                                 np.zeros((c, 8), np.float32), 4,
                                                 device="cpu")
        assert d2.shape == rows.shape == (m, 0)
    import torch.distributed as dist

    assert not dist.is_initialized()  # no mesh was needed


def test_a_cuda_mesh_without_a_card_raises_and_makes_no_group(one_rank):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA mesh resolves")
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="no CUDA device"):
        one_rank.default_batch_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        one_rank.mesh_topk_candidates(np.ones((2, 8), np.float32),
                                      np.ones((4, 8), np.float32), 2)
    assert not dist.is_initialized()
